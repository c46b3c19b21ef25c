"""Seeded weights, made by the benchmark on the device in a few large calls.

A configuration's ``init`` section maps a leaf's last name (``in_proj``,
``wq``, ``scale``, ...) to a rule:

* ``["normal_fan_in", axes]``: normal draws over sqrt of the product of
  the shape along ``axes`` (the fan-in);
* ``["normal", std]``;
* ``["uniform", lo, hi]``;
* ``["log_uniform_value", lo, hi]``: log of a uniform draw in [lo, hi]
  (Mamba2's ``A_log``);
* ``["inv_softplus_log_uniform", lo, hi]``: softplus^-1 of a draw that is
  log-uniform in [lo, hi] (Mamba2's ``dt_bias``).

The normal leaves of one dtype are views into one flat buffer, filled by
a few ``randn`` calls of at most ``CHUNK`` values; the others (a few
small leaves a layer) are drawn one by one after it.  The same seed on the
same device type gives the same tensors, so the reference can make them
again after the program's state is freed.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch

CHUNK = 1 << 27          # float32 values a randn call draws

Leaf = Tuple[str, Tuple[int, ...], torch.dtype]


def rule_for(name: str, rules: Mapping[str, Sequence]) -> Sequence:
    """The rule of the longest dotted suffix of ``name`` found in
    ``rules``."""
    parts = name.split(".")
    for i in range(len(parts)):
        key = ".".join(parts[i:])
        if key in rules:
            return rules[key]
    raise KeyError(f"no init rule for leaf {name!r}")


def make_weights(leaves: Iterable[Leaf], rules: Mapping[str, Sequence],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    leaves = list(leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    normal = [(n, s, d) for n, s, d in leaves
              if rule_for(n, rules)[0] in ("normal", "normal_fan_in")]
    for dtype in sorted({d for _, _, d in normal}, key=str):
        group = [(n, s) for n, s, d in normal if d == dtype]
        total = sum(math.prod(s) for _, s in group)
        flat = torch.empty(total, dtype=dtype, device=device)
        for a in range(0, total, CHUNK):
            b = min(total, a + CHUNK)
            flat[a:b] = torch.randn(b - a, generator=gen,
                                    dtype=torch.float32, device=device)
        off = 0
        for n, s in group:
            k = math.prod(s)
            leaf = flat[off:off + k].view(s)
            off += k
            rule = rule_for(n, rules)
            if rule[0] == "normal":
                std = float(rule[1])
            else:
                std = 1.0 / math.sqrt(math.prod(s[a] for a in rule[1]))
            leaf.mul_(std)
            out[n] = leaf
    for n, s, d in leaves:
        if n in out:
            continue
        rule = rule_for(n, rules)
        u = torch.rand(s, generator=gen, dtype=torch.float32, device=device)
        lo, hi = float(rule[1]), float(rule[2])
        if rule[0] == "uniform":
            t = lo + (hi - lo) * u
        elif rule[0] == "log_uniform_value":
            t = torch.log(lo + (hi - lo) * u)
        elif rule[0] == "inv_softplus_log_uniform":
            v = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
            t = v + torch.log(-torch.expm1(-v))
        else:
            raise ValueError(f"unknown init rule {rule!r} for {n!r}")
        out[n] = t.to(d)
    return {n: out[n] for n, _, _ in leaves}
