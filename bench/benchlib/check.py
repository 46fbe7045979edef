"""The comparisons that decide ``correct``, against the plain reference
under ``bench/reference`` (float32, TF32 off).

Serving: the reference runs once over each sampled request's prompt and
its served tokens; a served token's gap is how far the reference's logit
of that token lies below the reference's best at that position, and the
number compared is the widest gap.

Training: the reference follows the program's first steps from the same
weights and batches.  By the worst leaf: the gap between the norms of
the first clipped gradient, and of the parameters' change after the
checked steps, each over the reference's norm of that leaf or of the
median leaf, whichever is larger; leaves whose reference gradient is
under a thousandth of the median leaf's are left out of the change (they
move by round-off alone).  Over all leaves: the first clipped gradient's
relative difference ||g - g_ref|| / ||g_ref||; and the median over leaves
of each leaf's ||g - g_ref|| over max(its reference norm, the median
leaf's), and that of the attention's value projection (the leaf whose
reading the float8 control exceeds most; see ``PERF.md``).  The widest gap between
the two sides' losses is reported beside them."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from reference import qwen as ref


def served_gap(config: Dict, weights: Dict, picked, device: str,
               mm=ref.fp32_mm) -> Dict:
    """Widest gap (logits) over the served tokens of ``picked`` [(rid,
    prompt, out)], with ``mm`` the reference's product (``fp8_mm``: the
    control, whose own first choice is scored instead of the served
    token)."""
    ref.exact_fp32()
    sp = ref.spec_of(config)

    def layer(i):
        return _float(weights["layers"][i])
    widest, tokens = 0.0, 0
    control = mm is not ref.fp32_mm
    for _, prompt, out in picked:
        if not out:
            continue
        seq = np.concatenate([prompt, np.asarray(out[:-1], np.int64)])
        toks = torch.as_tensor(seq, device=device)
        rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out),
                            device=device)
        lg = ref.logits_at(weights, toks, rows, sp, layer_fn=layer)
        if control:
            low = ref.logits_at(weights, toks, rows, sp, mm=mm,
                                layer_fn=layer)
            chosen = low.argmax(-1)
        else:
            chosen = torch.as_tensor(out, device=device).long()
        gap = lg.max(-1).values - lg.gather(-1, chosen[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        tokens += len(out)
        del lg
    return {"served_gap_max": widest, "sample_tokens": tokens,
            "sample_requests": len(picked)}


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()


def leaf_gap(prog: Sequence[float], refn: Sequence[float],
             keep: Sequence[bool]) -> float:
    """The worst leaf's |prog - ref| over max(ref norm of the leaf, the
    median leaf's ref norm)."""
    med = float(np.median([r for r, k in zip(refn, keep) if k]))
    return max(abs(p - r) / max(r, med)
               for p, r, k in zip(prog, refn, keep) if k)


def train_numbers(prog: Dict, refr: Dict, grad_diff=None,
                  leaf_diffs=None) -> Dict:
    """The numbers from the program's readings (losses, grad_norms,
    change_norms by leaf) and the reference's (losses, grad_norms,
    raw_grad_norms, change_norms), with the first gradient's relative
    difference over all leaves, and the median leaf's, where they were
    read."""
    loss = max(abs(a - b) for a, b in zip(prog["losses"], refr["losses"]))
    n = len(refr["grad_norms"])
    g = leaf_gap(prog["grad_norms"], refr["grad_norms"], [True] * n)
    med = float(np.median(refr["raw_grad_norms"]))
    moving = [r >= 1e-3 * med for r in refr["raw_grad_norms"]]
    c = leaf_gap(prog["change_norms"], refr["change_norms"], moving)
    out = {"loss_gap": loss, "grad_gap": g, "change_gap": c,
           "leaves_left_out": n - sum(moving)}
    if grad_diff is not None:
        out["grad_diff"] = grad_diff
    if leaf_diffs is not None:
        out["grad_diff_median_leaf"] = float(np.median(leaf_diffs))
        wv = [d for d, name in zip(leaf_diffs, refr["leaf_names"])
              if name.endswith("attn/wv")]
        if wv:
            out["grad_diff_attn_wv"] = max(wv)
    return out


def verdict(numbers: Dict, limits: Dict) -> List[Dict]:
    """One entry a number the cell's limits file names: its value, its
    limit, and whether it holds (a number that is not finite fails)."""
    out = []
    for name, lim in limits["numbers"].items():
        v = numbers.get(name)
        ok = v is not None and bool(np.isfinite(v)) and v <= lim["limit"]
        out.append({"name": name, "value": v, "limit": lim["limit"],
                    "ok": ok})
    return out
