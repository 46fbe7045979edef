"""The port's examples (``examples_torch/``, the JAX ``examples/``'
names) run on the CPU at ``--device cpu``: each is loaded in this
process and its ``main`` called with flags that keep it short."""
import importlib.util
from pathlib import Path

import torch

torch.set_num_threads(1)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"
NAMES = ("quickstart", "stencil_pipeline", "long_context_decode",
         "serve_batch", "train_lm", "fault_tolerant_training")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_jax_example_has_a_port_that_defaults_to_the_card():
    jax_names = {p.stem for p in (EXAMPLES.parent / "examples").glob("*.py")}
    assert jax_names == set(NAMES)
    for name in NAMES:
        assert 'default="cuda"' in (EXAMPLES / f"{name}.py").read_text()


def test_quickstart(capsys):
    out = _load("quickstart").main(["--device", "cpu"])
    assert set(out["errors"]) == {"T0_NAIVE", "T1_PIPELINED",
                                  "T3_REPLICATED"}
    assert max(out["errors"].values()) < 0.5     # bf16 rounding of 256 sums
    assert "h100-sxm" in capsys.readouterr().out


def test_stencil_pipeline():
    out = _load("stencil_pipeline").main(["--device", "cpu"])
    assert out["errors"] == {1: 0.0, 4: 0.0}
    ms = list(out["stages_ms"].values())
    assert ms[0] > ms[1] > ms[2] > 0


def test_long_context_decode():
    out = _load("long_context_decode").main(["--device", "cpu"])
    assert out["cache_bytes"][64] == out["cache_bytes"][4096]


def test_serve_batch():
    rep = _load("serve_batch").main(["--device", "cpu"])
    assert len(rep["done"]) == 8 and rep["new_tokens"] == 8 * 16


def test_train_lm(tmp_path):
    losses = _load("train_lm").main(["--steps", "2", "--device", "cpu",
                                     "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2


def test_fault_tolerant_training():
    assert _load("fault_tolerant_training").main(
        ["--steps", "6", "--fail-at", "3,5", "--save-every", "2",
         "--device", "cpu"])
