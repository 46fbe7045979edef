"""What the benchmark loads: no module whose top-level name, compared
whole, is JAX's or the JAX package's; and the refusals of bench/run.py."""
import json
import os
import subprocess
import sys

from tiny import BENCH, ROOT

RUN_TINY = r"""
import json, sys, tempfile, time
from pathlib import Path
sys.path[:0] = [{src!r}, {bench!r}, {tests!r}]
import run
import tiny
from benchlib import harness, spec
root = tiny.make_root(Path(tempfile.mkdtemp(dir={tmp!r})))
for name in ("tiny.serve", "tiny.train"):
    harness.run_cell(root, spec.cell(root, name), 3, 0.5, False, "cpu",
                     time.perf_counter(), log=lambda m: None)
print(json.dumps(run.banned_modules()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = RUN_TINY.format(src=str(ROOT / "src"), bench=str(BENCH),
                           tests=str(BENCH / "tests"), tmp=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    tops = set(json.loads(lines[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_banned_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert not {"jaxfoo", "repro_torch_like"} & set(run.banned_modules())
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro" in run.banned_modules()


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "codeqwen7b.code.open", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra], capture_output=True, text=True,
        timeout=300, cwd=cwd, env=env)


def test_without_a_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
