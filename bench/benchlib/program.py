"""The program under test, ``repro_torch``, as the benchmark drives it:
its configuration from the ``program`` block of a configuration file, a
model on the device, and the benchmark's own weights laid into the
model's parameter tree.  This is the only module of the benchmark that
imports the program, and it does so inside functions."""
from __future__ import annotations

from typing import Dict, List

import torch

from . import weights as W


def arch(config: Dict):
    """The program's ``ArchConfig`` from the file's ``program.arch``."""
    from repro_torch.configs.base import ArchConfig
    fields = dict(config["program"]["arch"])
    for key in ("pattern", "prefix"):
        if key in fields:
            fields[key] = tuple(tuple(k) for k in fields[key])
    return ArchConfig(**fields)


def model(config: Dict, device, param_dtype: torch.dtype):
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.models.transformer import Model
    return Model(arch(config), dt=DtypePolicy(param=param_dtype),
                 device=device)


def params(mdl, seed: int, device):
    """The benchmark's weights in the model's tree."""
    return W.make_tree(mdl.param_specs(), seed, device)


def layer_views(tree, mdl) -> List[Dict]:
    """The reference's per-layer weights (see ``reference/qwen.py``):
    views into the program's tree, layer i of a stacked period indexed."""
    lay = mdl.layout
    out = []

    def one(p, i=None):
        def at(t):
            return t if i is None else t[i]
        w = {"ln1": at(p["ln1"]["scale"]), "ln2": at(p["ln2"]["scale"])}
        w.update({k: at(v) for k, v in p["attn"].items()})
        if "mlp" in p:
            w["mlp"] = {k: at(v) for k, v in p["mlp"].items()}
        else:
            m = p["moe"]
            w["moe"] = {k: at(m[k]) for k in ("router", "wg", "wu", "wd")}
            w["moe"]["shared"] = {k: at(v) for k, v in m["shared"].items()}
        return w
    out += [one(p) for p in tree["prefix"]]
    for i in range(lay.n_periods):
        out += [one(tree["stack"][j], i) for j in range(len(lay.period))]
    out += [one(p) for p in tree["tail"]]
    return out


def reference_weights(tree, mdl) -> Dict:
    return {"embed": tree["embed"], "head": tree["head"],
            "final_norm": tree["final_norm"]["scale"],
            "layers": layer_views(tree, mdl)}


def build_library() -> None:
    """Build (or find built) the program's kernel library."""
    from repro_torch.kernels import cuda
    cuda.build()


def counters() -> Dict:
    from repro_torch.kernels import dispatch
    return {"launches": {k: v for k, v in dispatch.launch_counts().items()
                         if v},
            "routes": {k: v for k, v in dispatch.route_counts().items()
                       if v},
            "matmul_macs": dispatch.matmul_macs()}


def reset_counters() -> None:
    from repro_torch.kernels import dispatch
    dispatch.reset_launch_counts()
    dispatch.reset_stats()


def plans(log) -> int:
    """Load the program's tuned plans from its default path."""
    from repro_torch.tune.cache import default_cache_path, preload
    n = preload()
    log(f"plans loaded={n} from {default_cache_path()}")
    return n


def plans_and_page(config: Dict, max_len: int, log) -> int:
    """Load the program's plans and return the page size its pick gives
    for this cell's pools."""
    from repro_torch.core.quant import kv_dtype_of
    from repro_torch.launch.serve import pick_page_size
    plans(log)
    a = arch(config)
    page = pick_page_size(hkv=a.n_kv_heads,
                          dtype=kv_dtype_of(a.kv_dtype, torch.bfloat16),
                          max_len=max_len)
    log(f"page_size={page} (pick_page_size)")
    return page
