"""Fused sim-step kernel: up to ``chunk`` engine steps per launch on Hopper.

Replaces the TPU kernel ``repro/kernels/sim_step.py::_sim_step_kernel``
(entry ``fused_chunk`` -> ``_fused_call``, draws from ``gen_draws``), which
advances a block of cells through the engine's branchless step
``_attempt`` -> ``_replica_draw`` -> ``_apply`` (4-iteration Lambert W
inside) with the carried state held on chip and a while-loop that stops
once the block's cells are all finished.

The CUDA version (``csrc/sim_step.cu``) runs one thread per cell with the
34-double carried state in registers.  Each thread reads its cell's
parameters once a launch into the block's shared memory, with the values
that do not change across steps computed there once.  The draws come from
one of two routes, picked by the draw source alone:

* a :class:`~repro_torch.sim.draws.PhiloxDraws` source -- the kernel
  generates the draws itself from the cells' seeds and the step index
  (:func:`launch_philox`), bit for bit what ``PhiloxDraws.next`` gives:
  each block of 32 cells has a second warp that draws the next steps into
  shared memory while the first steps the cells; the source's counter
  moves as if the draws had been made;
* any other source (the numpy parity source) -- pre-generated
  ``[chunk, n_draw, B]`` draws read from device memory (:func:`launch`),
  in blocks of 32 threads.

Each warp leaves the step loop as soon as all 32 of its cells are
finished (``__all_sync``).  :func:`run_shards` is the engine's loop over
the shards of a cell batch (:func:`run_chunks` the one-shard case): on the
card it packs each shard's parameters and state once, keeps the packed
state on the shard's device across chunks, reads completion from its
``finished`` row -- one count a chunk, summed over the shards -- and
unpacks once at the end.

What bounds it on an H100: at the fleet grid's shape the few hundred FP64
operations of each cell-step set the bound, ahead of the in-kernel
generator's 32-bit integer operations and the bytes of the parameters and
the state; measured, it runs far above that bound, because 10,000 cells
fill about 2.4 warps per SM and the latency of each cell's dependent FP64
chain sets its time (PERF.md).

Contract: bit-for-bit equal to :func:`fused_chunk_ref`, the plain torch
version (a loop of the port's ``_attempt`` / ``_apply`` that applies the
same per-warp early exit) fed the same draws, on every ``_State`` field and
the steps taken per warp.  The build uses ``-fmad=false`` and the kernel
evaluates the same IEEE operations in the same order as PyTorch's
elementwise kernels (NaN-propagating min/max, true division, ``x**2`` as
``x*x``).

CUDA tensors go to the kernel (or the call raises); CPU tensors run
``fused_chunk_ref`` on the source's ``next`` draws.  ``LAUNCHES`` counts
kernel launches of both routes, ``LAUNCHES_BY_ROUTE`` those of each and
``LAUNCHES_BY_VARIANT`` those of each flag variant.

Like the reference's Pallas kernel, the kernel takes only batches whose
estimator fits one peer column (``peer_axis == 1``); ``_check_state`` and
the launch functions reject a per-peer batch with ``ValueError``, and
``fused_chunk_ref`` (with its ``obs`` rows) is the only step for it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.device import F64
from repro_torch.kernels import build
from repro_torch.launch import cost_analysis as CA
from repro_torch.sim import engine as _eng
from repro_torch.sim.draws import PhiloxDraws, n_draws

LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"philox": 0, "pregenerated": 0}
LAUNCHES_BY_VARIANT: dict = {}  # flag variant (see ``variant``) -> launches
WARP = 32
PLAIN_SPAN = 8    # plain steps between host reads of completion


def variant(any_store: bool, any_het: bool, any_shock: bool,
            any_pm: bool) -> str:
    """The kernel instantiation of a flag set, as its (store, het, shock,
    pm) bits, e.g. ``"1000"`` for a store batch."""
    return "".join(str(int(f)) for f in (any_store, any_het, any_shock,
                                          any_pm))

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
FINISHED_ROW = STATE_ROWS.index("finished")


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
                    any_shock: bool, any_pm: bool, peer_axis: int = 1,
                    obs: torch.Tensor | None = None,
                    cell_steps: torch.Tensor | None = None):
    """Plain torch version of the kernel: ``draws.shape[0]`` steps of
    ``_attempt`` / ``_apply``, with the kernel's per-warp early exit (a
    warp whose 32 cells are all finished at the start of a step keeps its
    state).  Returns the new state and the steps taken per warp.

    The steps run ``PLAIN_SPAN`` at a time through :func:`_masked_steps`,
    which reads no tensor's value on the host; between spans one host read
    of ``finished`` ends the chunk once every cell is finished (the
    kernel's warps leave their loop on the card).  A step after that would
    change nothing, so the result is the same as running every step.

    It also steps batches the kernel does not take: with the state's peer
    axis ``peer_axis`` > 1 (the per-peer form), ``obs`` holds the per-peer
    observation rows ``[chunk, 2, B, peer_axis]`` (``next_obs`` of the
    draw source).

    ``cell_steps``, if given, is a [B] integer tensor to which each step
    adds 1 for every cell that was unfinished at its start (the cell-steps
    the data needs, as opposed to the warp-steps the kernel runs)."""
    if s.ema_d.shape[1] != peer_axis:
        raise ValueError(f"the state's peer axis is {s.ema_d.shape[1]}, "
                         f"expected {peer_axis}")
    if peer_axis > 1 and (obs is None or obs.shape[0] != draws.shape[0]):
        raise ValueError("a per-peer batch needs obs rows for every step")
    kw = dict(macro_threshold=macro_threshold, any_store=any_store,
              any_het=any_het, any_shock=any_shock, any_pm=any_pm,
              peer_axis=peer_axis)
    taken = torch.zeros(-(-s.t.shape[0] // WARP), dtype=torch.int32,
                        device=s.t.device)
    for i in range(0, draws.shape[0], PLAIN_SPAN):
        if bool(s.finished.all()):
            break
        j = i + PLAIN_SPAN
        s = _masked_steps(s, p, draws[i:j],
                          None if obs is None else obs[i:j], taken,
                          cell_steps, **kw)
    return s, taken


def _masked_steps(s: _eng._State, p: _eng._Params, draws: torch.Tensor,
                  obs, taken: torch.Tensor, cell_steps, *,
                  macro_threshold: float, any_store: bool, any_het: bool,
                  any_shock: bool, any_pm: bool, peer_axis: int):
    """The step body of :func:`fused_chunk_ref`: ``draws.shape[0]`` steps,
    each applied only to the warps that hold an unfinished cell at its
    start; adds each warp's steps to ``taken`` (and each unfinished cell's
    to ``cell_steps``).  It reads no tensor's value on the host."""
    for i in range(draws.shape[0]):
        live_w = _warp_live(s.finished)
        live = live_w.repeat_interleave(WARP)[:s.t.shape[0]]
        if cell_steps is not None:
            cell_steps += ~s.finished
        d = draws[i]
        u_pm, z_pm = (d[3], d[4:6].T) if any_pm else (None, None)
        u3, z3 = (obs[i, 0], obs[i, 1]) if peer_axis > 1 else (None, None)
        pre = _eng._attempt(s, p, d[2], any_store, any_het, any_shock)
        new = _eng._apply(s, p, pre, d[0], d[1], u_pm, z_pm,
                          macro_threshold, any_pm, u3, z3)
        s = _eng._State(*(torch.where(live if x.dim() == 1 else live[:, None],
                                      n, x) for n, x in zip(new, s)))
        taken += live_w.to(torch.int32)
    return s


def _check_state(s: _eng._State, p: _eng._Params, dev: torch.device) -> None:
    B = s.t.shape[0]
    for name, x in list(zip(s._fields, s)) + list(zip(p._fields, p)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.is_floating_point() and x.dtype != F64:
            raise ValueError(f"{name} must be float64, got {x.dtype}")
        if x.shape[0] != B:
            raise ValueError(f"{name} has {x.shape[0]} cells, expected {B}")
    for f in _STATE_COL:
        if getattr(s, f).shape != (B, 1):
            raise ValueError(f"{f} must be [B, 1]: {_PER_PEER_REFUSED}")


_PER_PEER_REFUSED = (
    "the sim_step kernel takes batches whose estimator fits one peer "
    "column (peer_axis 1: no per-peer-form cells); step a per-peer batch "
    "with the plain version (run_cells(step='scan'))")


def _check(s: _eng._State, p: _eng._Params, draws: torch.Tensor,
           any_pm: bool) -> None:
    _check_state(s, p, draws.device)
    _check_draws(draws, s.t.shape[0], any_pm)


def _check_draws(draws: torch.Tensor, B: int, any_pm: bool) -> None:
    if draws.dtype != F64 or draws.dim() != 3 or not draws.is_contiguous():
        raise ValueError("draws must be a contiguous float64 [chunk, n, B]")
    if draws.shape[1] != n_draws(any_pm) or draws.shape[2] != B:
        raise ValueError(f"draws must be [chunk, {n_draws(any_pm)}, {B}], "
                         f"got {list(draws.shape)}")


def _check_seeds(seeds: torch.Tensor, B: int, step0: int) -> None:
    if seeds.dtype != torch.int64 or seeds.shape != (B,) or \
            not seeds.is_contiguous():
        raise ValueError(f"seeds must be a contiguous int64 [{B}]")
    if step0 < 0:
        raise ValueError(f"step0 must be >= 0, got {step0}")


def _lib():
    lib = build.load("sim_step")
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sim_step_launch.argtypes = [
            P, P, P, P, I, P, P, I, P, P, P, LL, P, LL, I, I,
            ctypes.c_double, I, I, I, I, P]
        lib.sim_step_launch.restype = I
        lib.sim_step_philox_draws.argtypes = [P, LL, I, I, P, LL, P]
        lib.sim_step_philox_draws.restype = I
        lib.sim_step_error_string.argtypes = [I]
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


def _launch(params: tuple, state: torch.Tensor, taken: torch.Tensor, *,
            draws, seeds, step0: int, n: int, macro_threshold: float,
            any_store: bool, any_het: bool, any_shock: bool,
            any_pm: bool, peer_axis: int = 1) -> None:
    global LAUNCHES
    if peer_axis != 1:
        raise ValueError(_PER_PEER_REFUSED)
    pf, p4, hmean, sdpeer, trace_t, trace_mtbf = params
    B = state.shape[1]
    if B == 0 or n == 0:
        return
    lib = _lib()
    rc = build.launch(
        lib.sim_step_launch, state.device,
        pf.data_ptr(), p4.data_ptr(), hmean.data_ptr(), sdpeer.data_ptr(),
        hmean.shape[1], trace_t.data_ptr(), trace_mtbf.data_ptr(),
        trace_t.shape[1], state.data_ptr(),
        None if draws is None else draws.data_ptr(),
        None if seeds is None else seeds.data_ptr(), step0,
        taken.data_ptr(), B, n, n_draws(any_pm), float(macro_threshold),
        int(any_store), int(any_het), int(any_shock), int(any_pm))
    if rc != 0:
        raise RuntimeError(f"sim_step kernel launch failed: "
                           f"{lib.sim_step_error_string(rc).decode()}")
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE["pregenerated" if seeds is None else "philox"] += 1
    # its bytes to a cost counter: the state read and written, the draws
    CA.report_kernel(nbytes=2 * CA.nbytes(state) + (
        0 if draws is None else CA.nbytes(draws)))
    key = variant(any_store, any_het, any_shock, any_pm)
    LAUNCHES_BY_VARIANT[key] = LAUNCHES_BY_VARIANT.get(key, 0) + 1


def launch(params: tuple, state: torch.Tensor, draws: torch.Tensor,
           taken: torch.Tensor, **flags) -> None:
    """One kernel launch on packed operands (``pack_params``,
    ``pack_state``) with pre-generated ``[chunk, n_draw, B]`` draws:
    advances ``state`` in place and writes the steps taken per warp to
    ``taken``.  Raises if the launch fails.  An empty batch or chunk
    launches nothing and is not counted."""
    _check_draws(draws, state.shape[1], flags["any_pm"])
    _launch(params, state, taken, draws=draws, seeds=None, step0=0,
            n=draws.shape[0], **flags)


def launch_philox(params: tuple, state: torch.Tensor, seeds: torch.Tensor,
                  step0: int, n: int, taken: torch.Tensor, **flags) -> None:
    """One kernel launch that draws in the kernel: steps ``step0 .. step0 +
    n - 1`` of each cell's Philox stream (``seeds``: the [B] int64 seeds of
    a :class:`PhiloxDraws`), 32 cells and a generating warp a block.
    Otherwise as :func:`launch`."""
    _check_seeds(seeds, state.shape[1], step0)
    _launch(params, state, taken, draws=None, seeds=seeds, step0=step0,
            n=n, **flags)


def philox_draws(src: PhiloxDraws, step0: int, n: int) -> torch.Tensor:
    """The kernel's own generator on its own: the draws of steps ``step0 ..
    step0 + n - 1``, ``[n, n_draw, B]`` (a check of the in-kernel route;
    CPU tensors: ``src.at``, its plain version)."""
    if src.device.type == "cpu":
        return src.at(step0, n)
    _check_seeds(src.seeds, src.seeds.shape[0], step0)
    return _launch_philox_draws(src.seeds, step0, n, src.any_pm)


def _launch_philox_draws(seeds: torch.Tensor, step0: int, n: int,
                         any_pm: bool) -> torch.Tensor:
    B = seeds.shape[0]
    out = torch.empty(n, n_draws(any_pm), B, dtype=F64, device=seeds.device)
    if B == 0 or n == 0:
        return out
    lib = _lib()
    rc = build.launch(lib.sim_step_philox_draws, seeds.device,
                      seeds.data_ptr(), step0, n, int(any_pm),
                      out.data_ptr(), B)
    if rc != 0:
        raise RuntimeError(f"philox_draws kernel launch failed: "
                           f"{lib.sim_step_error_string(rc).decode()}")
    return out


def _taken(B: int, device) -> torch.Tensor:
    return torch.zeros(-(-B // WARP), dtype=torch.int32, device=device)


def fused_chunk(s: _eng._State, p: _eng._Params, draws: torch.Tensor, *,
                macro_threshold: float, any_store: bool, any_het: bool,
                any_shock: bool, any_pm: bool, peer_axis: int = 1):
    """Advance the batch by up to ``draws.shape[0]`` steps on pre-generated
    draws.

    CUDA tensors: one launch of the CUDA kernel (raises if it cannot be
    built or launched).  CPU tensors: :func:`fused_chunk_ref`.  Returns the
    new state and the steps taken per warp of 32 cells.  A per-peer batch
    (``peer_axis`` > 1) raises ``ValueError`` on every device.
    """
    kw = dict(macro_threshold=macro_threshold, any_store=any_store,
              any_het=any_het, any_shock=any_shock, any_pm=any_pm,
              peer_axis=peer_axis)
    if peer_axis != 1:
        raise ValueError(_PER_PEER_REFUSED)
    if draws.device.type == "cpu" and s.t.device.type == "cpu":
        return fused_chunk_ref(s, p, draws, **kw)
    if draws.device.type != "cuda":
        raise ValueError(f"fused_chunk takes CPU or CUDA tensors, got "
                         f"{draws.device}")
    _check(s, p, draws, any_pm)
    state = pack_state(s)
    taken = _taken(s.t.shape[0], draws.device)
    launch(pack_params(p), state, draws, taken, **kw)
    return unpack_state(state), taken


class _Shard:
    """One shard of a lockstep run: its state, parameters and draw source on
    its own device.  On the kernel route it keeps the packed parameters, the
    packed state and its ``taken`` buffer for the whole run."""

    def __init__(self, s: _eng._State, p: _eng._Params, src, plain: bool,
                 kw: dict):
        self.kw = kw
        self.kernel = not plain and s.t.device.type == "cuda"
        self.src = src
        if not self.kernel:
            self.s, self.p = s, p
            self.per_peer = kw.get("peer_axis", 1) > 1
            return
        _check_state(s, p, s.t.device)
        self.params, self.state = pack_params(p), pack_state(s)
        self.taken = _taken(s.t.shape[0], s.t.device)
        self.philox = isinstance(src, PhiloxDraws)

    def step(self, n: int) -> None:
        if not self.kernel:
            obs = self.src.next_obs(n) if self.per_peer else None
            self.s, _ = fused_chunk_ref(self.s, self.p, self.src.next(n),
                                        obs=obs, **self.kw)
        elif self.philox:
            launch_philox(self.params, self.state, self.src.seeds,
                          self.src.skip(n), n, self.taken, **self.kw)
        else:
            launch(self.params, self.state, self.src.next(n), self.taken,
                   **self.kw)

    def unfinished(self) -> torch.Tensor:
        """The shard's count of unfinished cells, a 0-dim tensor on its
        device (no host sync)."""
        if self.kernel:
            return (self.state[FINISHED_ROW] == 0.0).sum()
        return (~self.s.finished).sum()

    def result(self) -> _eng._State:
        return unpack_state(self.state) if self.kernel else self.s


def run_shards(shards, *, chunk: int, max_steps: int,
               macro_threshold: float, plain: bool = False, **flags):
    """Step every shard -- a ``(state, params, draw source)`` triple on its
    own device -- ``chunk`` steps at a time, in lockstep, until every cell
    of every shard is finished or ``max_steps`` steps have run; returns the
    shards' final states and the steps run (the same for every shard).

    Each chunk launches every shard's chunk on that shard's device and
    stream, then reduces one global unfinished count: each shard's count,
    summed on the first shard's device (the reference's ``psum`` of its
    sharded chunk), read by the host once a chunk.

    A shard of CUDA tensors (``plain`` false) runs the kernel, with its
    parameters and state packed once, the packed state kept on its device
    across chunks and one unpack at the end; a :class:`PhiloxDraws` source
    draws in the kernel, any other hands over its pre-generated draws.  A
    shard of CPU tensors, or ``plain``: :func:`fused_chunk_ref` on
    ``src.next`` draws (and ``src.next_obs`` rows for a per-peer batch,
    ``peer_axis`` > 1, which only this route takes).
    """
    kw = dict(macro_threshold=macro_threshold, **flags)
    run = [_Shard(s, p, src, plain, kw) for s, p, src in shards]
    dev0 = shards[0][0].t.device
    steps = 0
    while steps < max_steps:
        n = min(chunk, max_steps - steps)
        for sh in run:
            sh.step(n)
        steps += n
        if int(sum(sh.unfinished().to(dev0) for sh in run)) == 0:
            break
    return [sh.result() for sh in run], steps


def run_chunks(s: _eng._State, p: _eng._Params, src, *, chunk: int,
               max_steps: int, macro_threshold: float, plain: bool = False,
               **flags):
    """:func:`run_shards` of one shard: step the batch ``chunk`` steps at a
    time until every cell is finished or ``max_steps`` steps have run;
    returns the final state and the steps run."""
    (s,), steps = run_shards([(s, p, src)], chunk=chunk, max_steps=max_steps,
                             macro_threshold=macro_threshold, plain=plain,
                             **flags)
    return s, steps
