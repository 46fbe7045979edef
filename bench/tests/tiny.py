"""Tiny configurations, mixes and limits for the CPU tests, and a root
directory holding them beside a copy of the benchmark's own files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

DENSE = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-06,
    "as_run": {"rms_norm_eps": 1e-06},
    "program": {"arch": {
        "name": "tiny-dense", "family": "dense", "n_layers": 2,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 128, "vocab_size": 256, "pattern": [["attn", "mlp"]],
        "activation": "swiglu", "qkv_bias": True, "rope_theta": 10000.0,
        "kv_cache": "paged"}},
}

MOE = {
    "hidden_size": 64, "intermediate_size": 128,
    "moe_intermediate_size": 32, "shared_expert_intermediate_size": 64,
    "num_experts": 8, "num_experts_per_tok": 2, "norm_topk_prob": False,
    "router_aux_loss_coef": 0.001, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
    "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-06,
    "as_run": {"norm_topk_prob": True, "capacity_factor": 1.25},
    "program": {"arch": {
        "name": "tiny-moe", "family": "moe", "n_layers": 2, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 4, "head_dim": 16, "d_ff": 128,
        "vocab_size": 256, "pattern": [["attn", "moe"]], "n_experts": 8,
        "top_k": 2, "d_expert": 32, "n_shared_experts": 2,
        "shared_d_expert": 64, "capacity_factor": 1.25,
        "activation": "swiglu", "qkv_bias": True, "rope_theta": 10000.0}},
}

SERVE_MIX = {
    "kind": "serve_open", "slots": 4, "max_len": 128, "page_size": 16,
    "prefix_cache": False, "token_budget": 0, "rate_per_s": 30.0,
    "block": 8,
    "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.5, "min": 8,
               "max": 100},
    "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 2,
               "max": 20},
    "lead_in_s": 0.5, "trace_s": 1, "check": {"min_tokens": 30,
                                              "max_requests": 4},
}

TRAIN_MIX = {
    "kind": "train", "batch": 2, "seq_len": 32,
    "tokens": {"dist": "zipf", "exponent": 1.1},
    "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                  "weight_decay": 0.1, "grad_clip": 1.0,
                  "warmup_steps": 100, "total_steps": 10000,
                  "min_lr_ratio": 0.1},
    "checked_steps": 3, "trace_s": 1,
}

# set from CPU readings at these sizes: served gap 0.002 to 0.016 over
# seeds 20 to 31 (12 requests each, run to completion), the float8
# control 0.070 to 0.249 on the same tokens.  Training over seeds 11-15
# and 2**31 + 7: grad gap at most 0.012 (a half batch at least 0.071),
# change gap at most 0.003 (a half batch at least 0.113), the first
# gradient's relative difference 0.011 to 0.035 (the float8 control 0.107
# to 0.236, a half batch at least 0.56)
SERVE_LIMITS = {"numbers": {"served_gap_max": {"limit": 0.03}}}
TRAIN_LIMITS = {"numbers": {"grad_gap": {"limit": 0.03},
                            "change_gap": {"limit": 0.03},
                            "grad_diff": {"limit": 0.07}}}


def make_root(tmp: Path, cells=("tiny.serve", "tiny.train")) -> Path:
    """A checkout-like root: the benchmark's files copied, plus a tiny
    configuration, mix and limits for each of ``cells`` added as new files
    and entries."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, conf, mix, lim in (
            ("tiny.serve", ("tiny-dense", DENSE), ("tiny.open", SERVE_MIX),
             SERVE_LIMITS),
            ("tiny.train", ("tiny-moe", MOE), ("tiny.train", TRAIN_MIX),
             TRAIN_LIMITS)):
        if name not in cells:
            continue
        cfile = f"bench/configs/{conf[0]}.json"
        (root / cfile).write_text(json.dumps(conf[1]))
        (root / "bench/mixes" / f"{mix[0]}.json").write_text(
            json.dumps(mix[1]))
        (root / "bench/limits" / f"{name}.json").write_text(json.dumps(lim))
        bench["configs"].append({"name": conf[0], "source": "tests",
                                 "file": cfile, "reduced": [],
                                 "why": "tests"})
        bench["workloads"].append({"name": name, "config": conf[0],
                                   "traffic": mix[0], "chips": 1,
                                   "why": "tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" not in m:
                continue
            kind = m["workloads"][0].split(".")[-1]
            if (name == "tiny.serve") == (kind == "open"):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
