"""Window arithmetic: what a window counts, by hand."""
from benchlib import window
from benchlib.window import Timeline


def lines():
    return [
        # due before the window, tokens inside it
        Timeline(0, due=0.0, admitted=0.5, tokens=[9.0, 10.5, 11.0],
                 finished=11.0),
        # due in the window, finished
        Timeline(1, due=10.5, admitted=10.6, tokens=[11.0, 12.0],
                 finished=12.0),
        # due in the window, still decoding at the close (20.0)
        Timeline(2, due=12.0, admitted=12.0, tokens=[13.0, 15.0]),
        # due in the window, no first token by the close
        Timeline(3, due=18.0),
        # due after the close: not attempted
        Timeline(4, due=21.0),
    ]


def test_due_in_and_ttft_count_the_unfinished():
    ls = lines()
    assert [t.rid for t in window.due_in(ls, 10.0, 20.0)] == [1, 2, 3]
    assert window.ttfts(ls, 10.0, 20.0) == [0.5, 1.0, 2.0]


def test_queue_waits_count_the_unadmitted():
    w = window.queue_waits(lines(), 10.0, 20.0)
    assert [round(x, 9) for x in w] == [0.1, 0.0, 2.0]


def test_gaps_end_in_the_window_and_the_open_gap_counts():
    g = sorted(window.token_gaps(lines(), 10.0, 20.0))
    # rid 0: 9.0->10.5 ends in the window, 10.5->11.0; rid 1: 1.0;
    # rid 2: 2.0 and the open 15.0->20.0
    assert g == [0.5, 1.0, 1.5, 2.0, 5.0]


def test_tokens_in_the_window():
    assert window.tokens_in(lines(), 10.0, 20.0) == 6


def test_train_rate_is_over_whole_steps():
    ends = [1.5, 2.5, 3.5]
    assert window.steps_rate(ends, 1.0, 100) == 300 / 2.5
    assert window.steps_rate([], 1.0, 100) is None


def test_percentile_is_linear():
    assert window.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == 4.8
    assert window.percentile([], 95) is None


def test_wallclock_stamps_on_its_own_clock():
    t = iter([1.0, 2.0, 3.0])
    c = window.WallClock(clock=lambda: next(t))
    c.due(7, 0.5)
    c.on_admit(7, 123.0)
    c.on_token(7, 456.0)
    c.on_finish(7, 789.0)
    tl = c.lines[7]
    assert (tl.admitted, tl.tokens, tl.finished) == (1.0, [2.0], 3.0)
