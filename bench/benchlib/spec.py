"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root
of the checkout names the cells, configurations and metrics; a cell's
traffic mix is ``bench/mixes/<traffic>.json``, its limits
``bench/limits/<cell>.json``, a configuration the file its entry names,
and a per-layer metric ``bench/metrics/<metric>.py``.  Adding a cell,
mix, configuration or metric adds files and entries; nothing here
changes."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional


@dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _metric(entry: Dict) -> Metric:
    return Metric(entry["name"], entry["unit"], entry.get("workloads"))


def cell(root: Path, name: str) -> Cell:
    """The cell ``name`` with its configuration, mix, limits and the
    metrics it reports.  Raises KeyError for a cell BENCHMARK.json does
    not list."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    out = Cell(name=name, chips=int(entry["chips"]),
               config=load_json(root / conf["file"]),
               mix=load_json(root / "bench" / "mixes"
                             / f"{entry['traffic']}.json"),
               limits=load_json(root / "bench" / "limits" / f"{name}.json"))
    out.end_to_end = [m for m in map(_metric, bench["end_to_end"])
                      if m.applies(name)]
    out.per_layer = [m for m in map(_metric, bench["per_layer"])
                     if m.applies(name)]
    return out


def reader(root: Path, metric: str) -> Callable:
    """``read(ctx)`` of ``bench/metrics/<metric>.py``: the metric's
    value from the run's spans, counters and trace, or None where the
    run gave it nothing to read."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmetric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
