"""The port stands alone: no module of ``src/repro_torch`` or
``examples_torch`` and not ``chip_smoke.py`` imports JAX or the JAX
package, and the entry points run on the card unless the caller asks for
the CPU by name."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import serve, train
from repro_torch.models.transformer import Model

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples_torch").glob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")


def test_entry_points_raise_without_a_card(no_card):
    cfg = get_arch("gemma-2b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma-2b", "--smoke", "--requests", "1"])
    assert Model(cfg, device="cpu").device.type == "cpu"


def test_train_cli_raises_without_a_card(no_card, tmp_path):
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "8", "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    assert not (tmp_path / "ck").exists()
    losses = train.main(argv + ["--device", "cpu"])
    assert len(losses) == 1


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(no_card, tmp_path, where):
    """No result and a non-zero exit without CUDA, and also from a
    directory that holds chip_smoke.py and nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
