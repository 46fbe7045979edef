"""Whole runs on the CPU at a small size: a mix, a configuration, a cell
and a metric added as new files and entries are found without an edit,
a sound run is correct, and every fault the cells can have is caught."""
import json
import time

import pytest

import tiny
from benchlib import harness, spec

SEED = 2 ** 31 + 7


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    # a metric of its own, added as a file and an entry
    (root / "bench/metrics/requests_done_per_s.py").write_text(
        "def read(ctx):\n"
        "    r = ctx.serve\n"
        "    if r is None:\n"
        "        return None\n"
        "    return len(r.done) / (r.t_close - r.t_open)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({
        "name": "requests_done_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, name, fault=None, seed=SEED):
    return harness.run_cell(root, spec.cell(root, name), seed, 1.0, False,
                            "cpu", time.perf_counter(), log=lambda m: None,
                            fault=fault)


def test_added_cells_are_found_and_run_correct(root):
    s = run(root, "tiny.serve")
    assert s["correct"], s["checks"]
    assert s["attempted"] > 0 and s["failed"] == 0
    assert set(s["metrics"]) == {"setup_s", "output_tokens_per_s",
                                 "requests_done_per_s"}
    assert list(s)[-1] == "checks"
    t = run(root, "tiny.train")
    assert t["correct"], t["checks"]
    assert set(t["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert t["device"]["platform"] == "cpu"


def test_the_real_cells_are_listed():
    names = [w["name"] for w in json.loads(
        (tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]
    for name in names:
        c = spec.cell(tiny.ROOT, name)
        assert c.limits["numbers"]
        assert any(m.name == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_a_token_altered_where_it_is_produced_is_caught(root):
    r = run(root, "tiny.serve", fault="token")
    assert not r["correct"]
    assert r["checks"]["served_gap_max"]["value"] > 0.5


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_are_caught(root, fault):
    r = run(root, "tiny.train", fault=fault)
    assert not r["correct"]


class _Tracer:
    """Stands in for the profiler on the CPU: notes when it starts and
    gives one kernel over the stretch it covered."""
    starts: list = []

    def __init__(self, torch_mod):
        pass

    def start(self):
        self.t0 = time.perf_counter()
        _Tracer.starts.append(self.t0)

    def stop(self):
        from benchlib.trace import Trace
        t1 = time.perf_counter()
        a, b = self.t0 * 1e6, t1 * 1e6
        return Trace((a, b), [("matmul_bf16_wgmma_kernel", a, 0.5 * (a + b))],
                     [], (self.t0, t1))


@pytest.mark.parametrize("name", ["tiny.serve", "tiny.train"])
def test_a_traced_run_profiles_only_after_the_close(root, monkeypatch, name):
    from benchlib import serve, train
    runs = []
    for mod in (serve, train):
        monkeypatch.setattr(mod, "Tracer", _Tracer)
        inner = mod.run

        def kept(*a, _inner=inner, **k):
            out = _inner(*a, **k)
            runs.append(out[0])
            return out
        monkeypatch.setattr(mod, "run", kept)
    _Tracer.starts.clear()
    r = harness.run_cell(root, spec.cell(root, name), SEED, 1.0, True,
                         "cpu", time.perf_counter(), log=lambda m: None)
    run_, = runs
    close = run_.t_close if name == "tiny.serve" else run_.step_ends[-1]
    assert len(_Tracer.starts) == 1 and _Tracer.starts[0] >= close
    assert r["correct"], r["checks"]
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    assert r["breakdown"]["device_ops"]
