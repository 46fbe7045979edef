"""One short run of a cell on the card, through ``bench/run.py`` as the
driver calls it (skips without a card)."""
import json
import subprocess
import sys

import pytest

from tiny import ROOT


@pytest.mark.chip
def test_a_short_training_run_is_correct(card):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen2moe.train.2k",
         "--seed", str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"setup_s", "train_tokens_per_s"}
