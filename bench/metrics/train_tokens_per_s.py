"""train_tokens_per_s: tokens of the window's train steps over the window,
which runs from its opening to the end of its last whole step."""
from benchlib.window import steps_rate


def read(ctx):
    if ctx.train is None:
        return None
    r = ctx.train
    return steps_rate(r.step_ends, r.t_open, r.tokens_per_step)
