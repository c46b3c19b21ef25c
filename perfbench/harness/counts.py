"""The yardstick's counting functions: the work a model needs, from the
configuration's sizes and the shapes of a call, whatever implements it.

Operations are the multiply-adds (two each) of every linear map: the
projections, the depthwise convolution, the contractions of attention
and of the SSD, the head.  Elementwise work (norms, activations,
exponentials, the softmax) is not counted.  Attention counts the causal
half of its score matrix, S (S + 1) / 2 pairs, at the real head_dim
(112 is not padded to 128).  The SSD counts its chunked form at the
configuration's chunk Q: in each chunk C B^T and the intra-chunk product
over the Q (Q + 1) / 2 causal pairs, the chunk's state, the output from
the entering state and the state's pass to the next chunk.  Bytes count
each input read once and each output written once.  A training step
counts three forward passes (forward, and twice its products in the
backward); the recompute of ``remat`` is not counted.

These functions read only the configuration's ``model`` section (a plain
dict) and shapes; nothing of the program.  A family's whole-model counts
are in ``families/<family>.py`` and a port kernel's in
``kernels/<kernel>.py``, each found by its name: a new family or kernel
arrives as a file of its own.
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, List, Mapping, Optional

from . import core

BF16, F32 = 2, 4
FAMILIES = core.BENCH_DIR / "families"
KERNELS = core.BENCH_DIR / "kernels"


def ssm_dims(m: Mapping[str, Any]):
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    h = di // s["head_dim"]
    return di, h, s["head_dim"], s["d_state"], s["conv_width"], s["chunk"]


def ssd_call(b: int, s: int, h: int, p: int, n: int, q: int
             ) -> Dict[str, float]:
    """One SSD call over (b, s, h, p) x, B and C of (b, s, n), chunk q
    (s a multiple of q): its operations and bytes (x, B, C, y in bf16;
    dt, A, the entering and the final state in float32)."""
    nc = s // q
    pairs = q * (q + 1) // 2
    per_chunk = (2 * pairs * n                       # C B^T (heads share it)
                 + h * (2 * pairs * p                # (G o L) (dt x)
                        + 2 * q * p * n              # the chunk's state
                        + 2 * q * n * p              # C state_in
                        + 2 * p * n))                # the state's pass
    flops = b * nc * per_chunk
    nbytes = (BF16 * (2 * b * s * h * p + 2 * b * s * n)
              + F32 * (b * s * h + h + 2 * b * h * p * n))
    return {"flops": float(flops), "bytes": float(nbytes)}


def flash_call(bg: int, r: int, s: int, d: int, causal: bool = True
               ) -> Dict[str, float]:
    """One attention call of ``bg`` key groups of ``r`` query heads over
    ``s`` positions at head_dim ``d`` (bf16): q k^T and p v over the
    causal pairs."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * 2 * bg * r * pairs * d
    nbytes = BF16 * (2 * bg * r * s * d + 2 * bg * s * d)
    return {"flops": float(flops), "bytes": float(nbytes)}


def family(m: Mapping[str, Any]) -> ModuleType:
    """The counts of the configuration's family, ``families/<family>.py``:
    ``forward_flops(m, batch, seq, logits_rows)``, ``n_params(m)`` and
    ``layers(m)`` (how many layers of each kind a forward pass runs, by
    the names the kernels' files give as ``LAYER``)."""
    path = FAMILIES / f"{m['family']}.py"
    if not path.exists():
        raise ValueError(f"no count for family {m['family']!r} ({path})")
    return core.load_module(path)


def kernel(name: str) -> ModuleType:
    """A port kernel's file, ``kernels/<name>.py``: its device kernels'
    names in a trace (``NAMES``), the kind of layer that calls it
    (``LAYER``) and the work of one such layer (``layer_work(m, batch,
    seq)``)."""
    return core.load_module(KERNELS / f"{name}.py")


def kernel_names() -> List[str]:
    return sorted(p.stem for p in KERNELS.glob("*.py"))


def forward_flops(m: Mapping[str, Any], batch: int, seq: int,
                  logits_rows: int) -> float:
    """Operations of one forward pass over (batch, seq) tokens, the head
    applied to ``logits_rows`` rows (batch for a prefill's last
    position, batch * seq for training)."""
    return float(family(m).forward_flops(m, batch, seq, logits_rows))


def train_step_flops(m: Mapping[str, Any], batch: int, seq: int) -> float:
    """Three forward passes, the head over every position."""
    return 3.0 * forward_flops(m, batch, seq, batch * seq)


def n_params(m: Mapping[str, Any]) -> int:
    """The parameters the configuration holds (tied head counted once)."""
    return int(family(m).n_params(m))


def kernel_work(m: Mapping[str, Any], name: str, batch: int, seq: int
                ) -> Optional[Dict[str, float]]:
    """The work of kernel ``name`` in one forward pass over (batch, seq)
    tokens: its layer's work times the layers of that kind the family
    runs; None where the model has no such layer."""
    k = kernel(name)
    n = family(m).layers(m).get(k.LAYER, 0)
    if n == 0:
        return None
    w = k.layer_work(m, batch, seq)
    return {"flops": n * float(w["flops"]), "bytes": n * float(w["bytes"])}
