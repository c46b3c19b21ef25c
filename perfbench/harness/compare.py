"""The numbers ``correct`` is decided by, and their limits.

Each kind computes its numbers (plain names, one value each) by comparing
the program's outputs with the plain reference; ``limits/<workload>.json``
holds each number's limit with the two readings it was set from.  A run
is correct when every number is finite and at or under its limit.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64 sums."""
    g, w = got.double(), want.double()
    den = torch.linalg.vector_norm(w).item()
    num = torch.linalg.vector_norm(g - w).item()
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def token_gap(got_logits: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """The widest gap, over rows, by which the reference's logit of the
    program's greedy token lies below the reference's best."""
    tok = got_logits.float().argmax(dim=-1, keepdim=True)
    ref = ref_logits.double()
    gap = ref.max(dim=-1).values - ref.gather(-1, tok).squeeze(-1)
    return float(gap.max().item())


def worst_leaf_gap(got: Mapping[str, float], want: Mapping[str, float],
                   keep: Optional[Mapping[str, bool]] = None) -> float:
    """max over leaves of |got - want| / max(want, the median leaf's
    want): norms compared by leaf, not the norm of their difference."""
    names = [k for k in want if keep is None or keep[k]]
    if not names:
        return math.inf
    vals = sorted(want[k] for k in names)
    med = vals[len(vals) // 2]
    worst = 0.0
    for k in names:
        g = got.get(k, math.nan)
        den = max(want[k], med)
        gap = abs(g - want[k]) / den if den > 0 else abs(g - want[k])
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def judge(numbers: Mapping[str, float], limits: Mapping[str, dict]
          ) -> Dict[str, dict]:
    """Each number the limits file names, beside its limit (a missing or
    non-finite number is not correct); a number it does not name is a
    reading only (the file says why)."""
    out = {}
    for k, lim in limits.get("checks", {}).items():
        v = numbers.get(k, math.inf)
        ok = math.isfinite(v) and v <= lim["limit"]
        out[k] = {"value": v, "limit": lim["limit"], "ok": bool(ok)}
    return out
