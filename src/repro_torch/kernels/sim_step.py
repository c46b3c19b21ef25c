"""Fused sim-step kernel: up to ``chunk`` engine steps per launch on Hopper.

Replaces the TPU kernel ``repro/kernels/sim_step.py::_sim_step_kernel``
(entry ``fused_chunk`` -> ``_fused_call``), which advances a block of cells
through the engine's branchless step ``_attempt`` -> ``_replica_draw`` ->
``_apply`` (4-iteration Lambert W inside) with the carried state held on
chip and a while-loop that stops once the block's cells are all finished.

The CUDA version (``csrc/sim_step.cu``) runs one thread per cell with the
34-double carried state in registers; parameters are read from global
memory, and the per-step draws are read coalesced from ``[chunk, n_draw,
B]``.  Each warp leaves the step loop as soon as all 32 of its cells are
finished (``__all_sync``).

What bounds it on an H100: by the data-sheet rates (3.35 TB/s, 34 TFLOP/s
FP64) the bytes it must move set the bound at the fleet grid's shape --
the draws (24 to 48 bytes per cell-step), the parameters and the state
outweigh the few hundred FP64 operations of each cell-step.  Measured, it
runs about a hundred times above that bound: 10,000 cells fill about 2.4
warps per SM, so the latency of the dependent FP64 chains and of the
double-precision ``exp``/``log`` subroutines sets its time.  Neither
reading has been confirmed by a profile.  The design keeps the state out
of device memory for the whole chunk (one read and one write per launch),
reads each draw once, and stops finished warps early; some flag variants
spill registers, which this first version accepts (the build's
``-Xptxas -v`` report is recorded in PERF.md).

Contract: bit-for-bit equal to :func:`fused_chunk_ref`, the plain torch
version (a loop of the port's ``_attempt`` / ``_apply`` that applies the
same per-warp early exit), on every ``_State`` field.  The build uses
``-fmad=false`` and the kernel evaluates the same IEEE operations in the
same order as PyTorch's elementwise kernels (NaN-propagating min/max, true
division, ``x**2`` as ``x*x``).

``fused_chunk`` launches the kernel for CUDA tensors (or raises) and runs
``fused_chunk_ref`` for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.device import F64
from repro_torch.sim import engine as _eng
from repro_torch.sim.draws import n_draws

LAUNCHES = 0
WARP = 32
_BLOCK = 128

# Rows of the packed [n, B] float64 parameter tensor (the [B] fields of
# _Params, in _Params order) -- the kernel's ParamRow enum lists the same.
PARAM_ROWS = (
    "pol", "regime", "g_period", "g_fanout", "g_weight", "fixed_T",
    "prior_mu", "prior_v", "prior_count", "window", "log_decay",
    "min_interval", "max_interval", "k", "work", "V", "T_d", "watch",
    "max_wall", "t0", "scen_kind", "trace_min_gap", "store_on", "R",
    "repair", "td_up1", "td_cap", "td_srv", "img_bytes", "hsum_job",
    "hsum_watch", "speed", "store_mix", "shock_rate", "shock_pkill",
    "shock_dwatch", "shock_f", "shocked", "pm_on",
)
# The [B, 4] tables, packed as [n, B, 4] (kernel enum Tab4).
TAB4 = ("scen_p", "cls_n", "cls_h", "cls_td1", "cls_f", "pm_nc", "pm_rate",
        "pm_shock")
_STATE_BOOL = ("in_restore", "finished", "censored", "seen_ckpt",
               "seen_restore")
_STATE_COL = ("ema_d", "ema_T", "mu0", "td_obs")      # [B, 1]
_STATE_CLS = ("pm_d", "pm_T", "pm_mu0")               # [B, 4]


def state_rows() -> Tuple[str, ...]:
    """Row names of the packed [n, B] state (kernel enum StateRow)."""
    rows = []
    for f in _eng._State._fields:
        if f in _STATE_CLS:
            rows += [f"{f}{c}" for c in range(_eng._CLS_CAP)]
        else:
            rows.append(f)
    return tuple(rows)


STATE_ROWS = state_rows()


def pack_state(s: _eng._State) -> torch.Tensor:
    rows = []
    for f, x in zip(s._fields, s):
        if f in _STATE_CLS:
            rows += [x[:, c] for c in range(x.shape[1])]
        elif f in _STATE_COL:
            rows.append(x[:, 0])
        else:
            rows.append(x.to(F64))
    return torch.stack(rows).contiguous()


def unpack_state(buf: torch.Tensor) -> _eng._State:
    out, r = {}, 0
    for f in _eng._State._fields:
        if f in _STATE_CLS:
            out[f] = buf[r:r + _eng._CLS_CAP].T.contiguous()
            r += _eng._CLS_CAP
            continue
        row = buf[r]
        r += 1
        if f in _STATE_BOOL:
            out[f] = row != 0.0
        elif f in _STATE_COL:
            out[f] = row[:, None].clone()
        else:
            out[f] = row.clone()
    return _eng._State(**out)


def _warp_live(finished: torch.Tensor) -> torch.Tensor:
    """[n_warps] bool: the warp holds at least one unfinished cell."""
    B = finished.shape[0]
    n_w = -(-B // WARP)
    pad = torch.ones(n_w * WARP - B, dtype=torch.bool, device=finished.device)
    return ~torch.cat([finished, pad]).view(n_w, WARP).all(dim=1)


def fused_chunk_ref(s: _eng._State, p: _eng._Params, draws: torch.Tensor, *,
                    macro_threshold: float, any_store: bool, any_het: bool,
                    any_shock: bool, any_pm: bool,
                    cell_steps: torch.Tensor | None = None):
    """Plain torch version of the kernel: ``draws.shape[0]`` steps of
    ``_attempt`` / ``_apply``, with the kernel's per-warp early exit (a
    warp whose 32 cells are all finished at the start of a step keeps its
    state).  Returns the new state and the steps taken per warp.

    ``cell_steps``, if given, is a [B] integer tensor to which each step
    adds 1 for every cell that was unfinished at its start (the cell-steps
    the data needs, as opposed to the warp-steps the kernel runs)."""
    live_w = _warp_live(s.finished)
    taken = torch.zeros(live_w.shape[0], dtype=torch.int32,
                        device=live_w.device)
    for i in range(draws.shape[0]):
        live_w = _warp_live(s.finished)
        if not bool(live_w.any()):
            break
        live = live_w.repeat_interleave(WARP)[:s.t.shape[0]]
        if cell_steps is not None:
            cell_steps += ~s.finished
        d = draws[i]
        u_pm, z_pm = (d[3], d[4:6].T) if any_pm else (None, None)
        pre = _eng._attempt(s, p, d[2], any_store, any_het, any_shock)
        new = _eng._apply(s, p, pre, d[0], d[1], u_pm, z_pm,
                          macro_threshold, any_pm)
        s = _eng._State(*(torch.where(live if x.dim() == 1 else live[:, None],
                                      n, x) for n, x in zip(new, s)))
        taken += live_w.to(torch.int32)
    return s, taken


def _check(s: _eng._State, p: _eng._Params, draws: torch.Tensor,
           any_pm: bool) -> None:
    dev = draws.device
    B = s.t.shape[0]
    for name, x in list(zip(s._fields, s)) + list(zip(p._fields, p)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, draws on {dev}")
        if x.is_floating_point() and x.dtype != F64:
            raise ValueError(f"{name} must be float64, got {x.dtype}")
        if x.shape[0] != B:
            raise ValueError(f"{name} has {x.shape[0]} cells, expected {B}")
    for f in _STATE_COL:
        if getattr(s, f).shape != (B, 1):
            raise ValueError(
                f"{f} must be [B, 1]: the kernel takes batches whose "
                f"estimator fits one peer column (no per-peer-form cells)")
    if draws.dtype != F64 or draws.dim() != 3 or not draws.is_contiguous():
        raise ValueError("draws must be a contiguous float64 [chunk, n, B]")
    if draws.shape[1] != n_draws(any_pm) or draws.shape[2] != B:
        raise ValueError(f"draws must be [chunk, {n_draws(any_pm)}, {B}], "
                         f"got {list(draws.shape)}")


def _lib():
    from repro_torch.kernels import build

    lib = build.load("sim_step")
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.sim_step_launch.argtypes = [
            P, P, P, P, ctypes.c_int, P, P, ctypes.c_int, P, P, P,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
        lib.sim_step_launch.restype = ctypes.c_int
        lib.sim_step_error_string.argtypes = [ctypes.c_int]
        lib.sim_step_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def pack_params(p: _eng._Params) -> tuple:
    """The kernel's parameter operands: the [n, B] rows of PARAM_ROWS, the
    [n, B, 4] tables of TAB4, and the [B, 32] / [B, L] tables."""
    return (torch.stack([getattr(p, f).to(F64) for f in PARAM_ROWS]),
            torch.stack([getattr(p, f) for f in TAB4]).contiguous(),
            p.hmean_peer.contiguous(), p.shock_dpeer.contiguous(),
            p.trace_t.contiguous(), p.trace_mtbf.contiguous())


def launch(params: tuple, state: torch.Tensor, draws: torch.Tensor,
           taken: torch.Tensor, *, macro_threshold: float, any_store: bool,
           any_het: bool, any_shock: bool, any_pm: bool) -> None:
    """One kernel launch on packed operands (``pack_params``,
    ``pack_state``): advances ``state`` in place and writes the steps taken
    per warp to ``taken``.  Raises if the launch fails.  An empty batch or
    chunk launches nothing and is not counted."""
    global LAUNCHES
    pf, p4, hmean, sdpeer, trace_t, trace_mtbf = params
    B = state.shape[1]
    if B == 0 or draws.shape[0] == 0:
        return
    lib = _lib()
    stream = torch.cuda.current_stream(draws.device).cuda_stream
    rc = lib.sim_step_launch(
        pf.data_ptr(), p4.data_ptr(), hmean.data_ptr(), sdpeer.data_ptr(),
        hmean.shape[1], trace_t.data_ptr(), trace_mtbf.data_ptr(),
        trace_t.shape[1], state.data_ptr(), draws.data_ptr(),
        taken.data_ptr(), B, draws.shape[0], draws.shape[1],
        float(macro_threshold), int(any_store), int(any_het),
        int(any_shock), int(any_pm), stream)
    if rc != 0:
        raise RuntimeError(f"sim_step kernel launch failed: "
                           f"{lib.sim_step_error_string(rc).decode()}")
    LAUNCHES += 1


def fused_chunk(s: _eng._State, p: _eng._Params, draws: torch.Tensor, *,
                macro_threshold: float, any_store: bool, any_het: bool,
                any_shock: bool, any_pm: bool):
    """Advance the batch by up to ``draws.shape[0]`` steps.

    CUDA tensors: one launch of the CUDA kernel (raises if it cannot be
    built or launched).  CPU tensors: :func:`fused_chunk_ref`.  Returns the
    new state and the steps taken per warp of 32 cells.
    """
    kw = dict(macro_threshold=macro_threshold, any_store=any_store,
              any_het=any_het, any_shock=any_shock, any_pm=any_pm)
    if draws.device.type == "cpu" and s.t.device.type == "cpu":
        return fused_chunk_ref(s, p, draws, **kw)
    if draws.device.type != "cuda":
        raise ValueError(f"fused_chunk takes CPU or CUDA tensors, got "
                         f"{draws.device}")
    _check(s, p, draws, any_pm)
    state = pack_state(s)
    taken = torch.zeros(-(-s.t.shape[0] // WARP), dtype=torch.int32,
                        device=draws.device)
    launch(pack_params(p), state, draws, taken, **kw)
    return unpack_state(state), taken
