"""BENCHMARK.json against the benchmark's contract: its keys, names and
limits, and the files every entry is found by."""
import json
import re

import pytest

from tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("bench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf
        assert 1 <= len(c["why"]) <= 200


def test_workloads_and_files():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "bench/mixes" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench/limits" / f"{w['name']}.json").exists()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH[section]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if section == "end_to_end" \
            else {"layer", "moves"}
        assert set(m) <= allowed and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            mv = e2e[m["moves"]]
            assert set(m["workloads"]) <= set(mv.get("workloads", cells))
    if section == "end_to_end":
        assert e2e["setup_s"]["bound"] <= 0.25
        for cell in cells:
            reported = [m for m in BENCH["end_to_end"]
                        if cell in m.get("workloads", cells)]
            assert len(reported) >= 2
            assert any(cell in m.get("workloads", cells)
                       for m in BENCH["per_layer"])


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
