"""The controls at a small size on the CPU: the reference computed in
float8 (the precision below the configurations' bf16) in the program's
place fails the limits that sound runs of the program meet.  The same
control runs at the cells' own sizes on the card through
``bench/tools/calibrate.py``."""
import numpy as np
import pytest
import torch

import tiny
from benchlib import check, program, serve, spec, traffic, train
from reference import qwen as ref

SEEDS = [11, 12, 13, 2 ** 31 + 7]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("seed", [20, 21, 22, 23])
def test_served_control_fails(root, seed):
    """The first 12 requests of the seed's stream, served to the end."""
    cell = spec.cell(root, "tiny.serve")
    mdl = program.model(cell.config, "cpu", torch.bfloat16)
    params = program.params(mdl, seed, "cpu")
    sched, engine, clock = serve.engine_for(mdl, params, cell.mix,
                                            cell.mix["page_size"])
    for r in traffic.serve_stream(cell.mix, 256, seed, 1.0)[:12]:
        clock.due(r.rid, 0.0)
        engine.waiting.append(serve._request(r))
    while engine.step():
        pass
    done = [(r.rid, np.asarray(r.prompt), list(r.out)) for r in engine.done]
    assert len(done) == 12
    w = program.reference_weights(params, mdl)
    limit = cell.limits["numbers"]["served_gap_max"]["limit"]
    assert check.served_gap(cell.config, w, done, "cpu")[
        "served_gap_max"] <= limit
    assert check.served_gap(cell.config, w, done, "cpu", mm=ref.fp8_mm)[
        "served_gap_max"] > limit


@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_fails(root, seed):
    cell = spec.cell(root, "tiny.train")
    mdl = program.model(cell.config, "cpu", torch.float32)
    ctl = train.reference_readings(cell, mdl, seed, "cpu", mm=ref.fp8_mm,
                                   keep_first=True)
    refr = train.reference_readings(cell, mdl, seed, "cpu",
                                    others={"control": ctl.pop("first_grad")})
    numbers = check.train_numbers(ctl, refr, refr["grad_diff"]["control"])
    verdicts = {v["name"]: v["ok"]
                for v in check.verdict(numbers, cell.limits)}
    assert not verdicts["grad_diff"]


def test_calibration_reads_every_number(root):
    """bench/tools/calibrate.py's readings, at this size on the CPU."""
    import importlib.util
    path = tiny.BENCH / "tools" / "calibrate.py"
    spec_ = importlib.util.spec_from_file_location("calibrate", path)
    cal = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cal)
    s = cal.serve_seed(spec.cell(root, "tiny.serve"), 20, 1.0, 16, True,
                       "cpu")
    assert s["program"]["sample_tokens"] > 0
    assert s["control"]["sample_tokens"] == s["program"]["sample_tokens"]
    t = cal.train_seed(spec.cell(root, "tiny.train"), 11, "cpu")
    assert set(t) >= {"program", "control", "half_batch"}
    assert t["half_batch"]["grad_gap"] > t["program"]["grad_gap"]
