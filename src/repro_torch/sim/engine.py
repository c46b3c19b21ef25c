"""Batched cycle-level Monte-Carlo engine, ported to torch (float64).

This is the torch port of ``repro.sim.engine``: the same cell model, the
same packed per-cell parameters (:class:`_Params`) and carried state
(:class:`_State`, same field names and order), and the same branchless
step ``_attempt`` -> ``_replica_draw`` -> ``_apply``.  The model, its
approximations (expectation-fed pooled estimator, macro-stepped failure
bursts), the heterogeneous-fleet, store, shock and class-pooled ("pm")
columns are documented in the reference module's docstring; every formula
here is written operation for operation as there, so that the port can be
held to the reference's numpy backend step by step.

Three things differ from the reference:

* **Execution.** :func:`run_cells` is a chunked host loop
  (:func:`repro_torch.kernels.sim_step.run_shards`) that advances the
  batch -- or its shards over a device mesh, in lockstep -- ``chunk``
  steps at a time through the hand-written CUDA kernel on
  the card (``step="fused"``, the default) or through its plain torch
  version :func:`repro_torch.kernels.sim_step.fused_chunk_ref`
  (``step="scan"``, and always for CPU tensors).  The kernel draws the
  Philox stream itself; the plain version and the numpy parity source
  take pre-generated ``[chunk, n_draw, B]`` float64 tensors from
  :mod:`repro_torch.sim.draws`.
* **Draw sources.** ``draws="philox"`` is a device Philox4x32-10 stream
  keyed by each cell's seed; ``draws="numpy"`` replays the reference numpy
  backend's per-seed ``default_rng`` streams so trajectories are
  comparable cell by cell with ``repro.sim.run_cells(backend="numpy")``.
* **The per-peer form.** A batch with isolated/gossip cells at k <= 32
  (under ``peer_form="auto"``) carries its estimator state on a peer axis
  of width ``_PEER_CAP`` and draws per-peer observation noise; the CUDA
  kernel serves only batches whose estimator fits one peer column (as the
  reference's Pallas kernel does), so such a batch runs the plain torch
  step (``step="scan"``, on any device) and ``step="fused"`` raises
  ``ValueError``.  :func:`batch_step` names the step a batch allows.

Division by a Python constant goes through :func:`repro_torch.device.div`
so that it is IEEE true division on every device (CUDA's elementwise
division by a host scalar multiplies by its reciprocal instead), which is
what numpy and the CUDA kernel compute.
"""
from __future__ import annotations

import math
from dataclasses import InitVar, dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.failure import warn_deprecated_alias
from repro_torch.core.lambertw import lambertw0
from repro_torch.device import F64, div, resolve_device
from repro_torch.p2p.store import R_MAX as _R_MAX
from repro_torch.p2p.store import StoreSpec
from repro_torch.p2p.transfer import striped_restore_seconds
from repro_torch.sim.job import SimResult
from repro_torch.sim.scenarios import (
    DIURNAL,
    DOUBLING,
    FLASH_CROWD,
    TRACE,
    PeerClassMix,
    Scenario,
    ShockSpec,
    hazard_kernel,
    resolve_shock,
)

_E = math.e
_POLICY_IDS = {"fixed": 0, "adaptive": 1, "oracle": 2}
_REGIME_IDS = {"pooled": 0, "isolated": 1, "gossip": 2}
DEFAULT_CHUNK = 256
"""Engine steps per kernel launch (``run_cells(chunk=...)``).

The host loop checks global completion between chunks; inside a chunk the
kernel stops each warp of 32 cells as soon as all of them are finished.
"""
_LW_ITERS = 4  # Halley iterations for the per-step W0 (cubic convergence:
               # 3 reaches 1e-14 over the paper's argument range; one spare)
_MACRO_CAP = 1e9  # absolute bound on failures folded into one macro step
_PEER_CAP = 32    # peer-axis width for the per-peer estimator FORM (the
                  # exact small-k reference; class-pooled moments carry any
                  # larger k).  Fixed (not the batch max) so a cell's
                  # observation noise is invariant to batch composition.
_FANOUT_CAP = 8   # static unroll bound for the gossip pull loop
_POIS_TERMS = 16  # inverse-CDF unroll terms for per-peer death sampling
_POIS_SWITCH = 6.0  # switch to the clipped-normal approximation above this
                    # mean (P[X > 16 | lam = 6] ~ 1e-4, clip bias < 1%)
_CLS_CAP = 4      # max peer classes whose replica holders a store cell can
                  # carry (per-class availability columns in the step); also
                  # the class axis of the class-pooled estimator moments
_CPU_LANES = 64   # a batch on the CPU is padded to a multiple of this many
                  # cells (born finished): PyTorch's CPU kernels take
                  # exp/log on whole SIMD vectors (SLEEF) and a loop's tail
                  # through libm, which round differently in the last bit,
                  # so a cell's bits would depend on its place in the batch
_EXACT_AGG_MAX = 4096  # watch sizes up to this use exact per-slot class
                       # aggregates in _pack; larger fleets take the O(1)
                       # closed forms (O(1/n) quota discretization error)


@dataclass(frozen=True)
class PolicyConfig:
    """Which interval rule a cell runs, plus the adaptive policy's knobs.

    Mirrors the fields of :class:`AdaptiveCheckpointController` /
    :class:`FixedIntervalPolicy` / :class:`OraclePolicy` so a cell spec is a
    complete, hashable description of the policy.

    ``regime`` selects how the adaptive estimator shares information among
    the k job peers (module docstring): ``"pooled"`` (centralized upper
    bound, the default), ``"isolated"`` (per-peer estimators, no
    exchange), or ``"gossip"`` (per-peer estimators that exchange
    estimates every ``gossip_period`` seconds with ``gossip_fanout`` ring
    neighbours, blend weight ``gossip_weight`` — paper Sec 3.1.4).  Only
    meaningful for ``kind="adaptive"``; fixed and oracle policies do not
    estimate.
    """

    kind: str = "adaptive"  # "fixed" | "adaptive" | "oracle"
    fixed_T: float = 600.0
    prior_mu: float = 1.0 / (4 * 3600.0)
    prior_v: float = 10.0
    prior_count: int = 4
    window: int = 32
    min_interval: float = 1.0
    max_interval: float = 24 * 3600.0
    regime: str = "pooled"  # "pooled" | "isolated" | "gossip"
    gossip_period: float = 600.0
    gossip_fanout: int = 2
    gossip_weight: float = 0.5
    # Deprecated cell-spelling aliases (repro.policy migration notes).
    min_iv: InitVar[Optional[float]] = None
    max_iv: InitVar[Optional[float]] = None

    def __post_init__(self, min_iv: Optional[float] = None,
                      max_iv: Optional[float] = None) -> None:
        if min_iv is not None:
            warn_deprecated_alias("min_iv", "min_interval")
            object.__setattr__(self, "min_interval", float(min_iv))
        if max_iv is not None:
            warn_deprecated_alias("max_iv", "max_interval")
            object.__setattr__(self, "max_interval", float(max_iv))
        if self.kind not in _POLICY_IDS:
            raise ValueError(f"unknown policy kind {self.kind!r}")
        if self.kind == "fixed" and self.fixed_T <= 0:
            raise ValueError("fixed_T must be positive")
        if self.regime not in _REGIME_IDS:
            raise ValueError(f"unknown estimator regime {self.regime!r}")
        if self.regime != "pooled" and self.kind != "adaptive":
            raise ValueError(
                f"regime {self.regime!r} requires kind='adaptive' "
                f"(fixed/oracle policies do not estimate)")
        if self.gossip_period <= 0:
            raise ValueError("gossip_period must be positive")
        if not 1 <= self.gossip_fanout <= _FANOUT_CAP:
            raise ValueError(f"gossip_fanout must be in [1, {_FANOUT_CAP}]")
        if not 0.0 <= self.gossip_weight <= 1.0:
            raise ValueError("gossip_weight must be in [0, 1]")


@dataclass(frozen=True)
class CellSpec:
    """One simulation cell: a job under a scenario, policy, and seed.

    ``shock`` overrides the correlated-churn shock resolved from the
    scenario/mix (:func:`repro.sim.scenarios.resolve_shock`) — workflow
    stages use it to subject one stage to a shock wave the rest of the
    DAG does not see.
    """

    scenario: Scenario
    policy: PolicyConfig
    seed: int = 0
    k: int = 16
    work: float = 24 * 3600.0
    V: float = 20.0
    T_d: float = 50.0
    watch: Optional[int] = None  # default min(4k, n_slots), like simulate_job
    n_slots: int = 128
    max_wall_time: float = float("inf")
    t0: float = 0.0  # wall-clock offset (workflow stages start mid-scenario)
    store: Optional[StoreSpec] = None  # endogenous T_d from the P2P store
    mix: Optional[PeerClassMix] = None  # heterogeneous fleet composition
    shock: Optional[ShockSpec] = None  # correlated-churn override


def _cell_shock(c: CellSpec) -> Optional[ShockSpec]:
    """The effective shock of a cell: the explicit override, else whichever
    of scenario/mix declares one (ambiguity raises in resolve_shock)."""
    return c.shock if c.shock is not None else resolve_shock(c.scenario, c.mix)


@dataclass(frozen=True)
class BatchResult:
    """Struct-of-arrays result for a cell batch (shapes all [B])."""

    wall_time: np.ndarray
    work_required: np.ndarray
    n_checkpoints: np.ndarray
    n_failures: np.ndarray
    wasted_work: np.ndarray
    checkpoint_time: np.ndarray
    restore_time: np.ndarray
    completed: np.ndarray
    server_bytes: np.ndarray       # I/O imposed on the work-pool server
    n_server_restores: np.ndarray  # restores served by the server fallback
    n_peer_restores: np.ndarray    # restores served from peer replicas
    n_steps: int  # engine steps executed (diagnostic / benchmark)

    def __len__(self) -> int:
        return int(self.wall_time.shape[0])

    def result(self, i: int) -> SimResult:
        """The i-th cell as the reference simulator's :class:`SimResult`."""
        return SimResult(
            wall_time=float(self.wall_time[i]),
            work_required=float(self.work_required[i]),
            n_checkpoints=int(self.n_checkpoints[i]),
            n_failures=int(self.n_failures[i]),
            wasted_work=float(self.wasted_work[i]),
            checkpoint_time=float(self.checkpoint_time[i]),
            restore_time=float(self.restore_time[i]),
            completed=bool(self.completed[i]),
            server_bytes=float(self.server_bytes[i]),
            n_server_restores=int(self.n_server_restores[i]),
            n_peer_restores=int(self.n_peer_restores[i]),
        )


class _Params(NamedTuple):
    """Packed per-cell constants (all shape [B] except the trace tables)."""

    pol: np.ndarray          # policy kind id
    regime: np.ndarray       # estimator regime id (pooled/isolated/gossip)
    g_period: np.ndarray     # gossip exchange period (s)
    g_fanout: np.ndarray     # gossip ring partners per round (float for jit)
    g_weight: np.ndarray     # blend weight of remote estimates
    fixed_T: np.ndarray
    prior_mu: np.ndarray
    prior_v: np.ndarray
    prior_count: np.ndarray
    window: np.ndarray       # estimator window K (adaptive macro-burst cap)
    log_decay: np.ndarray    # log(1 - 1/window): estimator decay per death
    min_interval: np.ndarray
    max_interval: np.ndarray
    k: np.ndarray
    work: np.ndarray
    V: np.ndarray
    T_d: np.ndarray
    watch: np.ndarray
    max_wall: np.ndarray
    t0: np.ndarray
    scen_kind: np.ndarray
    scen_p: np.ndarray       # [B, 4]
    trace_t: np.ndarray      # [B, L]
    trace_mtbf: np.ndarray   # [B, L]
    trace_min_gap: np.ndarray
    store_on: np.ndarray     # bool: T_d is endogenous (P2P store cell)
    R: np.ndarray            # replica count (float for jit)
    repair: np.ndarray       # holder re-replication time
    td_up1: np.ndarray       # img / peer_uplink  (one-source restore)
    td_cap: np.ndarray       # img / peer_downlink (striping floor)
    td_srv: np.ndarray       # img / server_share (all-replicas-lost)
    img_bytes: np.ndarray    # checkpoint image size (server accounting)
    hsum_job: np.ndarray     # sum of hazard multipliers over the k job slots
    hsum_watch: np.ndarray   # same over the watch neighbourhood
    hmean_peer: np.ndarray   # [B, _PEER_CAP] mean multiplier per peer's share
    speed: np.ndarray        # job compute speed (work units per wall second)
    store_mix: np.ndarray    # bool: replica holders carry per-class columns
    cls_n: np.ndarray        # [B, _CLS_CAP] holder count per class
    cls_h: np.ndarray        # [B, _CLS_CAP] hazard multiplier per class
    cls_td1: np.ndarray      # [B, _CLS_CAP] one-source restore per class (s)
    shock_rate: np.ndarray   # correlated shock epochs per second
    shock_pkill: np.ndarray  # P(an epoch kills >= 1 job peer)
    shock_dwatch: np.ndarray  # E[watched deaths per epoch] = f * n_scope_watch
    shock_dpeer: np.ndarray  # [B, _PEER_CAP] E[deaths/epoch] per peer's share
    shock_f: np.ndarray      # holder kill fraction (homogeneous store cells)
    cls_f: np.ndarray        # [B, _CLS_CAP] holder kill fraction per class
    shocked: np.ndarray      # bool: rate > 0 (disables macro-stepping)
    pm_on: np.ndarray        # bool: estimator carried in class-pooled form
    pm_nc: np.ndarray        # [B, _CLS_CAP] non-decision peers per class
    pm_rate: np.ndarray      # [B, _CLS_CAP] mean watch-share hazard mult of
                             # a class-c peer (fleet mean for huge fleets)
    pm_shock: np.ndarray     # [B, _CLS_CAP] E[shock deaths/epoch] seen by a
                             # class-c peer's watch share


class _State(NamedTuple):
    """Per-cell mutable simulation state (floats for jit).

    All arrays are shape [B] except the estimator state: ``ema_d`` /
    ``ema_T`` / ``mu0`` / ``td_obs`` carry a trailing peer axis of width
    ``_PEER_CAP`` when any cell in the batch runs the per-peer form
    (width 1 otherwise), and the class-pooled moments ``pm_d`` / ``pm_T``
    / ``pm_mu0`` carry a trailing class axis of width ``_CLS_CAP`` (inert
    zeros for cells not in that form).  Peer slot 0 is the *decision
    peer*: the job's checkpoint interval is computed from its estimates
    in every regime and both forms.
    """

    t: np.ndarray            # absolute wall clock (starts at t0)
    done: np.ndarray         # committed work
    in_restore: np.ndarray   # bool
    finished: np.ndarray     # bool
    censored: np.ndarray     # bool
    n_ckpt: np.ndarray
    n_fail: np.ndarray
    wasted: np.ndarray
    ckpt_time: np.ndarray
    restore_time: np.ndarray
    ema_d: np.ndarray        # [B, P] decayed observed-death count (estimator)
    ema_T: np.ndarray        # [B, P] decayed observed exposure (slot-seconds)
    mu0: np.ndarray          # [B, P] per-peer prior center (gossip re-seeds)
    seen_ckpt: np.ndarray    # bool: V has been measured
    seen_restore: np.ndarray  # bool: T_d has been measured
    td_obs: np.ndarray       # [B, P] last observed restore duration
    next_g: np.ndarray       # wall time of the next gossip round
    n_round: np.ndarray      # gossip rounds done (drives the cyclic schedule)
    sv_bytes: np.ndarray     # server I/O imposed so far
    n_srv: np.ndarray        # restores served by the server fallback
    n_peer: np.ndarray       # restores served from peer replicas
    pm_d: np.ndarray         # [B, _CLS_CAP] class-mean decayed death count
    pm_T: np.ndarray         # [B, _CLS_CAP] class-mean decayed exposure
    pm_mu0: np.ndarray       # [B, _CLS_CAP] class prior center (gossip
                             # rounds re-seed it at the merged estimate)
    pm_v: np.ndarray         # population variance of the k-1 non-decision
                             # peers' point estimates (class-pooled form)


def _scope_weight(sk: ShockSpec, mix: Optional[PeerClassMix]) -> float:
    """Fraction of slots a shock's scope covers under the mix's quota
    assignment — the O(1) closed form of ``mean(scope_mask)`` (exact up to
    the O(1/n) quota discretization the mask itself carries).  Replicates
    ``scope_mask``'s scope validation so huge fleets fail identically."""
    if sk.scope == "all":
        return 1.0
    if mix is None:
        raise ValueError(
            f"class-scoped shock {sk.scope!r} needs a PeerClassMix")
    names = [pc.name for pc in mix.classes]
    if sk.scope not in names:
        raise ValueError(
            f"shock scope {sk.scope!r} names no class of the mix "
            f"{sorted(names)}")
    return float(mix.weights[names.index(sk.scope)])


def _pack(cells: Sequence[CellSpec], peer_form: str = "auto") -> _Params:
    B = len(cells)
    if B == 0:
        raise ValueError("need at least one cell")
    if peer_form not in ("auto", "perpeer", "pm"):
        raise ValueError(f"unknown peer_form {peer_form!r}")
    f = lambda vals: np.asarray(vals, dtype=np.float64)
    watch = [min(4 * c.k, c.n_slots) if c.watch is None
             else min(c.watch, c.n_slots) for c in cells]
    # Which estimator form carries each non-pooled cell (module docstring):
    # per-peer rows up to _PEER_CAP, class-pooled moments beyond — or force
    # one form batch-wide with peer_form ("perpeer" keeps the historical
    # hard cap; "pm" is how the parity suite pits the forms against each
    # other at small k).
    pm_on_l = []
    for c in cells:
        nonpooled = c.policy.regime != "pooled"
        if peer_form == "pm":
            pm = nonpooled
        else:
            pm = nonpooled and c.k > _PEER_CAP
            if pm and peer_form == "perpeer":
                raise ValueError(
                    f"per-peer estimator form supports k <= {_PEER_CAP}, "
                    f"got k={c.k} (use peer_form='auto' or 'pm' for the "
                    f"class-pooled form)")
        if (pm and c.mix is not None and not c.mix.is_trivial
                and len(c.mix) > _CLS_CAP):
            raise ValueError(
                f"class-pooled estimator supports mixes of <= {_CLS_CAP} "
                f"classes, got {len(c.mix)}")
        pm_on_l.append(pm)
    for c in cells:
        if c.k > c.n_slots:
            raise ValueError(f"job needs {c.k} slots but network has {c.n_slots}")
        if (c.mix is not None and c.store is not None
                and not c.mix.is_trivial and len(c.mix) > _CLS_CAP):
            raise ValueError(
                f"store cells support mixes of <= {_CLS_CAP} classes, "
                f"got {len(c.mix)}")
    # Heterogeneous-fleet aggregates.  Trivial mixes (every multiplier 1.0)
    # take the exact homogeneous values — hsum_job == float(k) etc. — so a
    # single-baseline-class mix is bit-identical to no mix at all.
    hsum_job = np.empty(B)
    hsum_watch = np.empty(B)
    hmean_peer = np.ones((B, _PEER_CAP))
    speed = np.ones(B)
    store_mix = np.zeros(B, dtype=bool)
    cls_n = np.zeros((B, _CLS_CAP))
    cls_h = np.ones((B, _CLS_CAP))
    cls_td1 = np.ones((B, _CLS_CAP))
    for i, c in enumerate(cells):
        mix = c.mix
        if mix is None or mix.is_trivial:
            hsum_job[i] = float(c.k)
            hsum_watch[i] = float(watch[i])
            continue
        if watch[i] <= _EXACT_AGG_MAX:
            hm = np.asarray(mix.hazard_mults(watch[i]))
            hsum_job[i] = math.fsum(hm[:c.k])
            hsum_watch[i] = math.fsum(hm)
            speed[i] = mix.mean_speed(c.k)
            for j in range(min(c.k, _PEER_CAP)):
                hmean_peer[i, j] = float(np.mean(hm[j::c.k]))
        else:
            # Fleet-scale closed forms: the quota assignment puts weight
            # w_c of any long slot range in class c (±1 slot), so every
            # aggregate collapses to a weight-dot — O(#classes) instead of
            # O(watch) Python, with O(1/watch) discretization error.
            w = np.asarray(mix.weights)
            hbar = float(w @ [pc.hazard_mult for pc in mix.classes])
            hsum_job[i] = c.k * hbar
            hsum_watch[i] = watch[i] * hbar
            speed[i] = float(w @ [pc.speed for pc in mix.classes])
            hmean_peer[i, :min(c.k, _PEER_CAP)] = hbar
        if c.store is not None and c.store.R > 0:
            store_mix[i] = True
            for cls_idx in mix.assign(c.store.R):
                cls_n[i, cls_idx] += 1.0
            for ci, pc in enumerate(mix.classes):
                cls_h[i, ci] = pc.hazard_mult
                cls_td1[i, ci] = c.store.td_up1 / pc.uplink_mult
    # Correlated-churn shock columns (DESIGN.md Sec 8).  All-zero for
    # unshocked cells, and every consumer folds them in as additive terms
    # that are exactly 0.0 then — the basis of the shock_rate=0
    # bit-identity contract.
    shock_rate = np.zeros(B)
    shock_pkill = np.zeros(B)
    shock_dwatch = np.zeros(B)
    shock_dpeer = np.zeros((B, _PEER_CAP))
    shock_f = np.zeros(B)
    cls_f = np.zeros((B, _CLS_CAP))
    shocked = np.zeros(B, dtype=bool)
    for i, c in enumerate(cells):
        sk = _cell_shock(c)
        if sk is None:
            continue
        shock_rate[i] = sk.rate
        shocked[i] = sk.rate > 0.0
        if watch[i] <= _EXACT_AGG_MAX:
            # Validates class scopes against the cell's mix; the mask over
            # the watch prefix also covers the k job slots (prefix
            # assignment).
            mask = sk.scope_mask(c.mix, watch[i])
            shock_pkill[i] = sk.job_kill_prob(sum(mask[:c.k]))
            shock_dwatch[i] = sk.kill_frac * sum(mask)
            dpeer = [sk.kill_frac * sum(mask[j::c.k])
                     for j in range(min(c.k, _PEER_CAP))]
        else:
            # Closed forms again (see the hazard aggregates above): a scope
            # covers weight-w_scope of any long slot range, so per-share
            # in-scope counts are w_scope * share size.
            w_scope = _scope_weight(sk, c.mix)
            shock_pkill[i] = sk.job_kill_prob(c.k * w_scope)
            shock_dwatch[i] = sk.kill_frac * watch[i] * w_scope
            dpeer = [sk.kill_frac * (watch[i] / c.k) * w_scope
                     for j in range(min(c.k, _PEER_CAP))]
        if c.policy.regime == "pooled":
            shock_dpeer[i, :] = shock_dwatch[i]  # only peer slot 0 is live
        else:
            # Exact in-scope count of peer j's slot share j::k (fleet-mean
            # share above the exact-aggregate cutoff).
            shock_dpeer[i, :len(dpeer)] = dpeer
        if c.store is not None and c.store.R > 0:
            # A class scope on a TRIVIAL multi-class mix (identical
            # baseline classes used as partition groups) still shocks only
            # part of the holder fleet — the homogeneous shock_f column
            # cannot express that, so such cells take the per-class path
            # too (cls_h/cls_td1 are all-1.0 there, so the only difference
            # from homogeneous is the scoped kill fraction — matching the
            # scope-masked per-event oracle).
            partial = (sk.scope != "all" and c.mix is not None
                       and len(c.mix) > 1)
            if partial or (c.mix is not None and not c.mix.is_trivial):
                if len(c.mix) > _CLS_CAP:
                    raise ValueError(
                        f"store cells support mixes of <= {_CLS_CAP} "
                        f"classes, got {len(c.mix)}")
                if not store_mix[i]:  # trivial mix skipped the columns
                    store_mix[i] = True
                    for cls_idx in c.mix.assign(c.store.R):
                        cls_n[i, cls_idx] += 1.0
                    for ci, pc in enumerate(c.mix.classes):
                        cls_h[i, ci] = pc.hazard_mult
                        cls_td1[i, ci] = c.store.td_up1 / pc.uplink_mult
                for ci, pc in enumerate(c.mix.classes):
                    if sk.scope in ("all", pc.name):
                        cls_f[i, ci] = sk.kill_frac
            else:
                # Homogeneous holders (no mix, or a scope covering the
                # whole single-class fleet): one fleet-wide kill fraction.
                shock_f[i] = sk.kill_frac
    # Class-pooled estimator columns (module docstring; DESIGN.md Sec 9).
    # pm_nc/pm_rate/pm_shock describe the k-1 non-decision peers grouped by
    # peer class: how many, the mean class multiplier of each one's watch
    # share, and the shock-death intensity its share sees.  Small fleets
    # compute them exactly from the quota assignment (so the pm form sees
    # the same per-share composition the per-peer form samples from);
    # fleet-scale cells take the weight-dot closed forms.
    pm_on = np.asarray(pm_on_l, dtype=bool)
    pm_nc = np.zeros((B, _CLS_CAP))
    pm_rate = np.ones((B, _CLS_CAP))
    pm_shock = np.zeros((B, _CLS_CAP))
    for i, c in enumerate(cells):
        if not pm_on_l[i]:
            continue
        sk = _cell_shock(c)
        f_kill = sk.kill_frac if sk is not None else 0.0
        mix = c.mix
        if mix is None or len(mix) == 1:
            # One exchangeable class.  With no class structure the scope is
            # "all" (scope_mask validates that), so the mean in-scope count
            # of a non-decision share is exact: the decision peer holds
            # ceil(watch/k) of the watch slots and the rest split the
            # remainder evenly in distribution.
            pm_nc[i, 0] = c.k - 1
            if mix is not None:
                pm_rate[i, 0] = mix.classes[0].hazard_mult
            pm_shock[i, 0] = (f_kill * (watch[i] - math.ceil(watch[i] / c.k))
                              / max(c.k - 1, 1))
        elif c.k <= _EXACT_AGG_MAX and watch[i] <= _EXACT_AGG_MAX:
            asg = mix.assign(c.k)
            hm = np.asarray(mix.hazard_mults(watch[i]))
            msk = (np.asarray(sk.scope_mask(mix, watch[i]), dtype=np.float64)
                   if sk is not None else None)
            for ci in range(len(mix)):
                js = [j for j in range(1, c.k) if asg[j] == ci]
                pm_nc[i, ci] = len(js)
                if js:
                    pm_rate[i, ci] = float(np.mean(
                        [np.mean(hm[j::c.k]) for j in js]))
                    if msk is not None:
                        pm_shock[i, ci] = f_kill * float(np.mean(
                            [msk[j::c.k].sum() for j in js]))
        else:
            # Fleet-scale closed forms: shares homogenize to the fleet-mean
            # multiplier and in-scope fraction, class counts to the quota
            # weights (normalized so they sum to exactly k-1).
            w = np.asarray(mix.weights)
            hbar = float(w @ [pc.hazard_mult for pc in mix.classes])
            w_scope = _scope_weight(sk, mix) if sk is not None else 0.0
            for ci in range(len(mix)):
                pm_nc[i, ci] = w[ci] * (c.k - 1)
                pm_rate[i, ci] = hbar
                pm_shock[i, ci] = f_kill * (watch[i] / c.k) * w_scope
    L = max(2, max(len(c.scenario.trace_t) for c in cells))
    trace_t = np.zeros((B, L))
    trace_mtbf = np.ones((B, L))
    min_gap = np.full(B, np.inf)
    for i, c in enumerate(cells):
        tt, tm = c.scenario.trace_t, c.scenario.trace_mtbf
        if tt:
            n = len(tt)
            trace_t[i, :n] = tt
            trace_mtbf[i, :n] = tm
            trace_t[i, n:] = tt[-1] + np.arange(1, L - n + 1)  # keep ascending
            trace_mtbf[i, n:] = tm[-1]
            if n > 1:
                min_gap[i] = float(np.min(np.diff(tt)))
    return _Params(
        pol=np.asarray([_POLICY_IDS[c.policy.kind] for c in cells], dtype=np.int64),
        regime=np.asarray([_REGIME_IDS[c.policy.regime] for c in cells],
                          dtype=np.int64),
        g_period=f([c.policy.gossip_period for c in cells]),
        g_fanout=f([c.policy.gossip_fanout for c in cells]),
        g_weight=f([c.policy.gossip_weight for c in cells]),
        fixed_T=f([c.policy.fixed_T for c in cells]),
        prior_mu=f([c.policy.prior_mu for c in cells]),
        prior_v=f([c.policy.prior_v for c in cells]),
        prior_count=f([c.policy.prior_count for c in cells]),
        window=f([c.policy.window for c in cells]),
        log_decay=f([math.log1p(-1.0 / c.policy.window) for c in cells]),
        min_interval=f([c.policy.min_interval for c in cells]),
        max_interval=f([c.policy.max_interval for c in cells]),
        k=f([c.k for c in cells]),
        work=f([c.work for c in cells]),
        V=f([c.V for c in cells]),
        T_d=f([c.T_d for c in cells]),
        watch=f(watch),
        max_wall=f([c.max_wall_time for c in cells]),
        t0=f([c.t0 for c in cells]),
        scen_kind=np.asarray([c.scenario.kind for c in cells], dtype=np.int64),
        scen_p=f([c.scenario.params for c in cells]),
        trace_t=trace_t,
        trace_mtbf=trace_mtbf,
        trace_min_gap=min_gap,
        store_on=np.asarray([c.store is not None for c in cells], dtype=bool),
        R=f([c.store.R if c.store else 0 for c in cells]),
        repair=f([c.store.t_repair if c.store else 1.0 for c in cells]),
        td_up1=f([c.store.td_up1 if c.store else c.T_d for c in cells]),
        td_cap=f([c.store.td_cap if c.store else c.T_d for c in cells]),
        td_srv=f([c.store.td_server if c.store else c.T_d for c in cells]),
        img_bytes=f([c.store.transfer.img_bytes if c.store else 0.0
                     for c in cells]),
        hsum_job=hsum_job,
        hsum_watch=hsum_watch,
        hmean_peer=hmean_peer,
        speed=speed,
        store_mix=store_mix,
        cls_n=cls_n,
        cls_h=cls_h,
        cls_td1=cls_td1,
        shock_rate=shock_rate,
        shock_pkill=shock_pkill,
        shock_dwatch=shock_dwatch,
        shock_dpeer=shock_dpeer,
        shock_f=shock_f,
        cls_f=cls_f,
        shocked=shocked,
        pm_on=pm_on,
        pm_nc=pm_nc,
        pm_rate=pm_rate,
        pm_shock=pm_shock,
    )



# --------------------------------------------------------------------------- #
# Packed batch on the device.                                                  #
# --------------------------------------------------------------------------- #

def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.int64, device=device)
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                           dtype=F64, device=device)


def from_reference(params, state=None, *, device):
    """Carry a packed batch across: ``repro``'s ``_Params`` (and optionally
    ``_State``) as numpy arrays, in ``repro``'s field order, become this
    port's tensors on ``device``.  Float fields become float64, integer
    fields int64, bool fields bool.  Returns ``_Params`` or
    ``(_Params, _State)``."""
    dev = resolve_device(device)
    p = _Params(*(_tensor(a, dev) for a in params))
    if state is None:
        return p
    return p, _State(*(_tensor(a, dev) for a in state))


def _init_state(p: _Params, n_peer: int) -> _State:
    B = p.k.shape[0]
    dev = p.k.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=F64, device=dev)

    def false():
        return torch.zeros(B, dtype=torch.bool, device=dev)

    return _State(t=p.t0.clone(), done=zeros(B), in_restore=false(),
                  finished=false(), censored=false(), n_ckpt=zeros(B),
                  n_fail=zeros(B), wasted=zeros(B), ckpt_time=zeros(B),
                  restore_time=zeros(B),
                  ema_d=zeros(B, n_peer), ema_T=zeros(B, n_peer),
                  mu0=zeros(B, n_peer) + p.prior_mu[:, None],
                  seen_ckpt=false(), seen_restore=false(),
                  td_obs=zeros(B, n_peer) + p.T_d[:, None],
                  next_g=p.t0 + p.g_period, n_round=zeros(B),
                  sv_bytes=zeros(B), n_srv=zeros(B), n_peer=zeros(B),
                  pm_d=zeros(B, _CLS_CAP), pm_T=zeros(B, _CLS_CAP),
                  pm_mu0=zeros(B, _CLS_CAP) + p.prior_mu[:, None],
                  pm_v=zeros(B))


# --------------------------------------------------------------------------- #
# The branchless step (torch; mirrors repro.sim.engine op for op).             #
# --------------------------------------------------------------------------- #

def _sum4(x: torch.Tensor) -> torch.Tensor:
    """Sum over the class axis in a fixed left-to-right order (the CUDA
    kernel adds the four columns in the same order)."""
    return x[:, 0] + x[:, 1] + x[:, 2] + x[:, 3]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _opt_interval(mu, k, V, T_d):
    """Vectorized 1/lambda* (paper Sec 3.2.3), inf at the V->0 branch point."""
    kmu = k * mu
    arg = div((V * kmu - T_d * kmu - 1.0) / (T_d * kmu + 1.0), _E)
    x = lambertw0(arg, iters=_LW_ITERS) + 1.0
    return torch.where(x > 0.0, x / kmu, math.inf)


def _coherence(t, p: _Params):
    """How far ahead the hazard can be treated as locally constant."""
    p1, p2, p3 = p.scen_p[:, 1], p.scen_p[:, 2], p.scen_p[:, 3]
    inf = math.inf
    c_doub = div(p1, 8.0)
    c_diur = div(p2, 32.0)
    c_flash = torch.where(t < p2, p2 - t,
                          torch.where(t < p2 + p3, p2 + p3 - t, inf))
    c_trace = div(p.trace_min_gap, 4.0)
    return torch.where(p.scen_kind == DOUBLING, c_doub,
           torch.where(p.scen_kind == DIURNAL, c_diur,
           torch.where(p.scen_kind == FLASH_CROWD, c_flash,
           torch.where(p.scen_kind == TRACE, c_trace, inf))))


def _trunc_exp_moments(kmu, L, q):
    """Mean/variance of X ~ Exp(kmu) conditioned on X < L; q = exp(-kmu L)."""
    inv = 1.0 / kmu
    ratio = q / torch.clamp_min(1.0 - q, 1e-300)
    m = inv - L * ratio
    ex2 = 2.0 * inv * inv - (L * L + 2.0 * L * inv) * ratio
    v = torch.clamp_min(ex2 - m * m, 0.0)
    return m, v


def _replica_draw(mu, u2, p: _Params, any_het: bool, any_shock: bool,
                  kmu_bg, srate):
    """Endogenous restore law (``repro.sim.engine._replica_draw``): sample
    the surviving replica count m ~ Binomial(R, A) (or its shock mixture)
    by an R_MAX-term inverse-CDF unroll and turn it into this attempt's
    restore duration.  Returns (td_rest, from_server, td_expect)."""
    A_hom = torch.clamp(1.0 / (1.0 + mu * p.repair
                               + (p.shock_rate * p.shock_f) * p.repair),
                        1e-12, 1.0 - 1e-12)
    A = A_hom
    td_up1 = p.td_up1
    A2_mix = td2_mix = None
    if any_het:
        A_c = (1.0 / (1.0 + (mu * p.repair)[:, None] * p.cls_h
                      + (p.shock_rate * p.repair)[:, None] * p.cls_f))
        nA = p.cls_n * A_c
        sumA = _sum4(nA)
        A_mix = torch.clamp(sumA / torch.clamp_min(p.R, 1.0),
                            1e-12, 1.0 - 1e-12)
        td_mix = sumA / torch.clamp_min(_sum4(nA / p.cls_td1), 1e-300)
        A = torch.where(p.store_mix, A_mix, A)
        td_up1 = torch.where(p.store_mix, td_mix, td_up1)
        if any_shock:
            nA2 = nA * (1.0 - p.cls_f)
            sumA2 = _sum4(nA2)
            A2_mix = torch.clamp(sumA2 / torch.clamp_min(p.R, 1.0),
                                 0.0, 1.0 - 1e-12)
            td2_mix = sumA2 / torch.clamp_min(_sum4(nA2 / p.cls_td1), 1e-300)
    if any_shock:
        q = srate / torch.clamp_min(kmu_bg + srate, 1e-300)
        A2 = A_hom * (1.0 - p.shock_f)
        if any_het:
            A2 = torch.where(p.store_mix, A2_mix, A2)
            td_up1 = torch.where(p.store_mix,
                                 (1.0 - q) * td_up1 + q * td2_mix, td_up1)
        ratio_b = A2 / (1.0 - A2)
        pmf_b = (1.0 - A2) ** p.R
    ratio = A / (1.0 - A)
    pmf_a = (1.0 - A) ** p.R
    pmf = (1.0 - q) * pmf_a + q * pmf_b if any_shock else pmf_a  # P(m = 0)
    cdf = pmf
    m = torch.zeros_like(mu)
    etd = pmf * p.td_srv                      # E[td] accumulator: m=0 term
    for j in range(_R_MAX):
        m = m + (u2 > cdf)
        pmf_a = torch.clamp_min(div(pmf_a * (p.R - j), j + 1.0) * ratio, 0.0)
        if any_shock:
            pmf_b = torch.clamp_min(div(pmf_b * (p.R - j), j + 1.0) * ratio_b,
                                    0.0)
            pmf = (1.0 - q) * pmf_a + q * pmf_b
        else:
            pmf = pmf_a
        cdf = cdf + pmf
        etd = etd + pmf * striped_restore_seconds(j + 1.0, td_up1, p.td_cap,
                                                  p.td_srv)
    m = torch.minimum(m, p.R)                 # guard pmf underflow at A ~ 1
    td_endo = striped_restore_seconds(m, td_up1, p.td_cap, p.td_srv)
    td_rest = torch.where(p.store_on, td_endo, p.T_d)
    from_server = p.store_on & (m < 1.0)
    td_expect = torch.where(p.store_on, etd, p.T_d)
    return td_rest, from_server, td_expect


def _attempt(s: _State, p: _Params, u2, any_store: bool, any_het: bool,
             any_shock: bool):
    """Pre-sampling half of a step (``repro.sim.engine._attempt``)."""
    mu = hazard_kernel(s.t, p.scen_kind, p.scen_p, p.trace_t, p.trace_mtbf)
    kmu_bg = p.hsum_job * mu
    srate = p.shock_rate * p.shock_pkill
    kmu = kmu_bg + srate
    active = ~s.finished
    censor_now = active & (s.t - p.t0 > p.max_wall)
    att = active & ~censor_now

    if any_store:
        td_rest, from_server, td_expect = _replica_draw(
            mu, u2, p, any_het, any_shock, kmu_bg, srate)
    else:
        td_rest, from_server, td_expect = p.T_d, p.store_on, p.T_d

    mu_hat = ((s.ema_d[:, 0] + p.prior_count)
              / (s.ema_T[:, 0] + p.prior_count / s.mu0[:, 0]))
    V_hat = torch.where(s.seen_ckpt, p.V, p.prior_v)
    td_known = torch.where(p.store_on, s.td_obs[:, 0], p.T_d)
    Td_hat = torch.where(s.seen_restore, td_known, V_hat)
    mu_true = mu * (p.hsum_job / p.k) + srate / p.k
    iv2 = _opt_interval(
        torch.stack([mu_hat, mu_true]), p.k,
        torch.stack([torch.clamp_min(V_hat, 1e-6), p.V]),
        torch.stack([Td_hat, td_expect]))
    iv_adaptive = _clip(iv2[0], p.min_interval, p.max_interval)
    iv_oracle = _clip(iv2[1], p.min_interval, p.max_interval)
    interval = torch.where(p.pol == 0, p.fixed_T,
                           torch.where(p.pol == 1, iv_adaptive, iv_oracle))
    interval = torch.clamp_min(interval, 1e-3)

    remaining = torch.clamp_min(p.work - s.done, 0.0)
    work_target = torch.minimum(interval * p.speed, remaining)
    is_final = work_target >= remaining
    cycle_len = work_target / p.speed + torch.where(is_final, 0.0, p.V)
    attempt_len = torch.where(s.in_restore, td_rest, cycle_len)
    return (mu, kmu, attempt_len, work_target, is_final, cycle_len,
            censor_now, att, td_rest, from_server)


def _sample_counts(lam, u3, z3):
    """Observed-death counts ~ Poisson(lam), branchless
    (``repro.sim.engine._sample_counts``)."""
    lam_s = torch.clamp_max(lam, _POIS_SWITCH)
    pmf = torch.exp(-lam_s)
    cdf = pmf
    d = torch.zeros_like(lam)
    for j in range(_POIS_TERMS):
        d = d + (u3 > cdf)
        pmf = div(pmf * lam_s, j + 1.0)
        cdf = cdf + pmf
    d_norm = torch.clamp_min(lam + torch.sqrt(torch.clamp_min(lam, 0.0)) * z3,
                             0.0)
    return torch.where(lam > _POIS_SWITCH, d_norm, d)


def _pool_update(s: _State, p: _Params, t, elapsed, mu, finished, u_pm, z_pm):
    """One class-pooled estimator step (``repro.sim.engine._pool_update``).

    Returns the decision row (ema_d0, ema_T0, mu0_0), the class moments
    (pm_d, pm_T, pm_mu0, pm_v) and the gossip clock (round_inc, next_g)."""
    a = p.prior_count
    share = p.watch / p.k
    kw = torch.clamp_min(p.k - 1.0, 1.0)
    nw = p.pm_nc / kw[:, None]

    lam0 = (share * p.hmean_peer[:, 0] * mu
            + p.shock_rate * p.shock_dpeer[:, 0]) * elapsed
    d0 = _sample_counts(lam0, u_pm, z_pm[:, 0])
    beta0 = torch.exp(d0 * p.log_decay)
    ema_d0 = s.ema_d[:, 0] * beta0 + d0
    ema_T0 = s.ema_T[:, 0] * beta0 + share * elapsed

    lam_c = (share[:, None] * p.pm_rate * mu[:, None]
             + p.shock_rate[:, None] * p.pm_shock) * elapsed[:, None]
    beta_c = torch.exp(lam_c * p.log_decay[:, None])
    pm_d = s.pm_d * beta_c + lam_c
    pm_T = s.pm_T * beta_c + share[:, None] * elapsed[:, None]

    den_old = _sum4(nw * (s.pm_T + a[:, None] / s.pm_mu0))
    den_new = _sum4(nw * (pm_T + a[:, None] / s.pm_mu0))
    lam_bar = _sum4(nw * lam_c)
    beta_bar = _sum4(nw * beta_c)
    pm_v = ((beta_bar ** 2 * s.pm_v * den_old ** 2 + lam_bar)
            / torch.clamp_min(den_new, 1e-300) ** 2)

    due = ((p.regime == _REGIME_IDS["gossip"]) & ~finished & (t >= s.next_g)
           & p.pm_on)
    mu_hat0 = (ema_d0 + a) / (ema_T0 + a / s.mu0[:, 0])
    mu_c = (pm_d + a[:, None]) / (pm_T + a[:, None] / s.pm_mu0)
    mbar = _sum4(nw * mu_c)
    N = kw
    fpc = (torch.clamp_min(N - p.g_fanout, 0.0)
           / (torch.clamp_min(N - 1.0, 1.0) * p.g_fanout))
    w = p.g_weight
    rem0 = mbar + z_pm[:, 1] * torch.sqrt(torch.clamp_min(pm_v, 0.0) * fpc)
    merged0 = (1.0 - w) * mu_hat0 + w * torch.clamp_min(rem0, 1e-300)
    mall = (mu_hat0 + (p.k - 1.0) * mbar) / torch.clamp_min(p.k, 1.0)
    merged_c = (1.0 - w)[:, None] * mu_c + (w * mall)[:, None]
    contract = (1.0 - w) ** 2 + w ** 2 * fpc

    ema_d0 = torch.where(due, 0.0, ema_d0)
    ema_T0 = torch.where(due, 0.0, ema_T0)
    mu0_0 = torch.where(due, merged0, s.mu0[:, 0])
    pm_d = torch.where(due[:, None], 0.0, pm_d)
    pm_T = torch.where(due[:, None], 0.0, pm_T)
    pm_mu0 = torch.where(due[:, None], merged_c, s.pm_mu0)
    pm_v = torch.where(due, contract * pm_v, pm_v)
    next_g = torch.where(due, t + p.g_period, s.next_g)
    return (ema_d0, ema_T0, mu0_0, pm_d, pm_T, pm_mu0, pm_v,
            due.to(F64), next_g)


def _gossip_mix(s_t, ema_d, ema_T, mu0, n_round, next_g, finished,
                peer_act, p: _Params):
    """One epidemic exchange round for cells whose gossip clock is due
    (``repro.sim.engine._gossip_mix``): each peer pulls the mu point
    estimates of ``g_fanout`` ring neighbours at the circulant offsets
    1 + (round * fanout + f) mod (k - 1), blends merged = (1 - w) * local
    + w * remote_mean and re-seeds its window at the merged value."""
    due = (p.regime == _REGIME_IDS["gossip"]) & ~finished & (s_t >= next_g)
    P = ema_d.shape[1]
    mu_hat = (ema_d + p.prior_count[:, None]) / (
        ema_T + p.prior_count[:, None] / mu0)
    idx = torch.arange(P, dtype=F64, device=ema_d.device)[None, :]
    kk = torch.clamp_min(p.k, 1.0)[:, None]
    km1 = torch.clamp_min(p.k - 1.0, 1.0)
    rem_mu = torch.zeros_like(mu_hat)
    for f in range(_FANOUT_CAP):
        off = 1.0 + torch.remainder(n_round * p.g_fanout + f, km1)
        # Clamp to the materialized peer axis: per-peer cells always have
        # j < k <= P; this only guards class-pooled cells riding a mixed
        # batch, whose result is overridden anyway.
        j = torch.clamp_max(torch.remainder(idx + off[:, None], kk),
                            float(P - 1)).to(torch.int64)
        in_f = (f < p.g_fanout)[:, None]
        rem_mu = rem_mu + torch.where(in_f, torch.gather(mu_hat, 1, j), 0.0)
    w = p.g_weight[:, None]
    merged_mu = (1.0 - w) * mu_hat + w * rem_mu / p.g_fanout[:, None]
    upd = due[:, None] & peer_act
    return (torch.where(upd, 0.0, ema_d),
            torch.where(upd, 0.0, ema_T),
            torch.where(upd, merged_mu, mu0),
            n_round + due,
            torch.where(due, s_t + p.g_period, next_g))


def _apply(s: _State, p: _Params, pre, u, z, u_pm, z_pm,
           macro_threshold: float, any_pm: bool, u3=None, z3=None) -> _State:
    """Post-sampling half: advance each cell by one (macro-)attempt
    (``repro.sim.engine._apply``; the peer axis is the state's).

    ``u`` is a uniform (failure time, or geometric failure count for macro
    cells), ``z`` a standard normal (macro burst duration); ``u_pm`` [B] /
    ``z_pm`` [B, 2] (None unless ``any_pm``) drive the class-pooled form;
    ``u3`` / ``z3`` [B, P] (needed when the state's peer axis P > 1) drive
    the per-peer observation sampling of non-pooled regimes.
    """
    (mu, kmu, attempt_len, work_target, is_final, cycle_len, censor_now, att,
     td_rest, from_server) = pre
    p_surv = torch.exp(-kmu * cycle_len)

    # ---------------- macro path: a whole failure burst ------------------ #
    r = torch.exp(-kmu * p.T_d)
    m_a, v_a = _trunc_exp_moments(kmu, cycle_len, p_surv)
    m_r, v_r = _trunc_exp_moments(kmu, p.T_d, r)
    retries = 1.0 / torch.clamp_min(r, 1e-300) - 1.0
    mean_restore = p.T_d + retries * m_r
    var_restore = (retries * v_r
                   + (retries / torch.clamp_min(r, 1e-300)) * m_r * m_r)
    pair_m = m_a + mean_restore
    pair_v = v_a + v_r + var_restore
    M_want = torch.floor(torch.log(torch.clamp_min(u, 1e-300))
                         / torch.clamp_max(torch.log1p(-p_surv), -1e-300))
    horizon = torch.minimum(_coherence(s.t, p),
                            0.5 * (p.t0 + p.max_wall - s.t) + pair_m)
    horizon = torch.minimum(horizon, torch.where(
        p.pol == 1, p.window / torch.clamp_min(p.hsum_watch * mu, 1e-300),
        math.inf))
    M_cap = torch.floor(horizon / torch.clamp_min(pair_m, 1e-300))
    M = torch.clamp(torch.minimum(M_want, M_cap), 0.0, _MACRO_CAP)
    macro = (att & ~s.in_restore & ~p.store_on & ~p.shocked
             & (p_surv < macro_threshold)
             & torch.isfinite(kmu) & (kmu > 0.0) & (M >= 1.0))
    capped = macro & (M < M_want)
    m_ok = macro & ~capped
    burst = torch.clamp_min(M * pair_m + z * torch.sqrt(M * pair_v), 0.0)
    burst_waste = torch.minimum(M * m_a, burst)

    # ---------------- regular path: one attempt, exact ------------------- #
    reg = att & ~macro
    t_fail = -torch.log1p(-u) / kmu
    fail = t_fail < attempt_len
    dt = torch.where(reg, torch.minimum(t_fail, attempt_len), 0.0)
    ws = reg & ~s.in_restore & ~fail
    wf = reg & ~s.in_restore & fail
    rs = reg & s.in_restore & ~fail
    rf = reg & s.in_restore & fail
    interior = (ws | m_ok) & ~is_final

    where = torch.where
    t = s.t + where(ws, cycle_len,
              where(wf | rf, dt,
              where(rs, td_rest,
              where(macro, burst + where(m_ok, cycle_len, 0.0), 0.0))))
    done = where(ws | m_ok, where(is_final, p.work, s.done + work_target),
                 s.done)
    n_ckpt = s.n_ckpt + interior
    ckpt_time = s.ckpt_time + where(interior, p.V, 0.0)
    n_fail = s.n_fail + wf + where(macro, M, 0.0)
    wasted = s.wasted + where(wf, dt, 0.0) + where(macro, burst_waste, 0.0)
    restore_time = (s.restore_time + where(rf, dt, where(rs, td_rest, 0.0))
                    + where(macro, burst - burst_waste, 0.0))
    in_restore = (s.in_restore | wf) & ~rs
    finished = s.finished | censor_now | ((ws | m_ok) & is_final)
    censored = s.censored | censor_now
    seen_ckpt = s.seen_ckpt | interior
    seen_restore = s.seen_restore | rs | m_ok | capped
    td_obs = where(rs[:, None], td_rest[:, None], s.td_obs)
    srv_ckpt = interior & p.store_on & (p.R < 1.0)
    srv_rest = rs & from_server
    srv_part = rf & from_server
    frac = where(srv_part, dt / torch.clamp_min(td_rest, 1e-300), 0.0)
    sv_bytes = (s.sv_bytes + where(srv_ckpt | srv_rest, p.img_bytes, 0.0)
                + frac * p.img_bytes)
    n_srv = s.n_srv + srv_rest
    n_peer = s.n_peer + (rs & p.store_on & ~from_server)

    elapsed = t - s.t
    peer_axis = s.ema_d.shape[1]
    if peer_axis == 1:
        # Estimator: pooled expectation feed into peer slot 0.
        d = ((p.hsum_watch * mu + p.shock_rate * p.shock_dwatch)
             * elapsed)[:, None]
        expo = (p.watch * elapsed)[:, None]
        beta = torch.exp(d * p.log_decay[:, None])
        ema_d = s.ema_d * beta + d
        ema_T = s.ema_T * beta + expo
        mu0, n_round, next_g = s.mu0, s.n_round, s.next_g
    else:
        # Per-peer form: pooled cells keep the expectation feed in slot 0;
        # isolated/gossip cells Poisson-sample each peer's watch/k share.
        pooled = p.regime == _REGIME_IDS["pooled"]
        peer_act = (torch.arange(peer_axis, dtype=F64,
                                 device=elapsed.device)[None, :]
                    < torch.where(pooled, 1.0, p.k)[:, None])
        rate_slot = torch.where(pooled, p.watch, p.watch / p.k)
        rate_death = torch.where(pooled[:, None], p.hsum_watch[:, None],
                                 (p.watch / p.k)[:, None]
                                 * p.hmean_peer[:, :peer_axis])
        lam = (rate_death * (mu * elapsed)[:, None]
               + (p.shock_rate * elapsed)[:, None]
               * p.shock_dpeer[:, :peer_axis]) * peer_act
        d = torch.where(pooled[:, None], lam, _sample_counts(lam, u3, z3))
        beta = torch.exp(d * p.log_decay[:, None])
        ema_d = torch.where(peer_act, s.ema_d * beta + d, s.ema_d)
        ema_T = torch.where(peer_act,
                            s.ema_T * beta + rate_slot[:, None]
                            * elapsed[:, None], s.ema_T)
        ema_d, ema_T, mu0, n_round, next_g = _gossip_mix(
            t, ema_d, ema_T, s.mu0, s.n_round, s.next_g, finished,
            peer_act, p)

    pm_d, pm_T, pm_mu0, pm_v = s.pm_d, s.pm_T, s.pm_mu0, s.pm_v
    if any_pm:
        (ema_d0, ema_T0, mu0_0, pmd, pmT, pmm, pmv, rinc, next_g_pm) = \
            _pool_update(s, p, t, elapsed, mu, finished, u_pm, z_pm)
        # Class-pooled cells override their decision row (peer slot 0).
        col0 = p.pm_on[:, None] & (torch.arange(
            peer_axis, device=elapsed.device)[None, :] == 0)
        ema_d = where(col0, ema_d0[:, None], ema_d)
        ema_T = where(col0, ema_T0[:, None], ema_T)
        mu0 = where(col0, mu0_0[:, None], mu0)
        pm_d = where(p.pm_on[:, None], pmd, pm_d)
        pm_T = where(p.pm_on[:, None], pmT, pm_T)
        pm_mu0 = where(p.pm_on[:, None], pmm, pm_mu0)
        pm_v = where(p.pm_on, pmv, pm_v)
        n_round = where(p.pm_on, s.n_round + rinc, n_round)
        next_g = where(p.pm_on, next_g_pm, next_g)

    return _State(t=t, done=done, in_restore=in_restore, finished=finished,
                  censored=censored, n_ckpt=n_ckpt, n_fail=n_fail,
                  wasted=wasted, ckpt_time=ckpt_time, restore_time=restore_time,
                  ema_d=ema_d, ema_T=ema_T, mu0=mu0, seen_ckpt=seen_ckpt,
                  seen_restore=seen_restore, td_obs=td_obs, next_g=next_g,
                  n_round=n_round, sv_bytes=sv_bytes,
                  n_srv=n_srv, n_peer=n_peer,
                  pm_d=pm_d, pm_T=pm_T, pm_mu0=pm_mu0, pm_v=pm_v)


# --------------------------------------------------------------------------- #
# Public entry point.                                                          #
# --------------------------------------------------------------------------- #

def _per_peer(c: CellSpec, peer_form: str) -> bool:
    """The cell's estimator needs the per-peer form (``_pack``'s rule)."""
    return (c.policy.regime != "pooled" and peer_form != "pm"
            and c.k <= _PEER_CAP)


def batch_step(cells: Sequence[CellSpec], peer_form: str = "auto") -> str:
    """The step a batch's estimator form allows: ``"scan"`` (the plain
    torch step) when any cell needs the per-peer form, else ``"fused"``
    (the CUDA kernel on the card)."""
    return "scan" if any(_per_peer(c, peer_form) for c in cells) else "fused"


def batch_flags(cells: Sequence[CellSpec], p: _Params) -> dict:
    """The static flags of a packed batch, as ``repro``'s run_cells derives
    them: ``any_store``, ``any_het``, ``any_shock``, ``any_pm`` and the
    width of the estimator's peer axis, ``peer_axis`` (``_PEER_CAP`` when
    any cell needs the per-peer form, else 1)."""
    return dict(any_store=any(c.store is not None for c in cells),
                any_het=bool(np.asarray(p.store_mix).any()),
                any_shock=any(_cell_shock(c) is not None for c in cells),
                any_pm=bool(np.asarray(p.pm_on).any()),
                peer_axis=_PEER_CAP if any(
                    c.policy.regime != "pooled" and not pm
                    for c, pm in zip(cells, p.pm_on)) else 1)


def _cell_shards(mesh, device, B: int):
    """The devices the cell batch shards over and its padded size ``Bp``
    (the reference's ``_run_jax``): ``mesh`` "auto" takes
    :func:`~repro_torch.distributed.mesh.cell_mesh` when the run is on CUDA
    and more than one card is present, ``None`` never shards, a ``Mesh``
    shards over its data axes as ``resolve_rules(mesh, {"cell": Bp})``
    resolves them, ``Bp`` being ``B`` rounded up to a multiple of the mesh's
    size.  Returns ``([device], B)`` for an unsharded run."""
    from repro_torch.distributed.mesh import Mesh, cell_mesh
    from repro_torch.distributed.sharding import resolve_rules

    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None or a Mesh, got "
                             f"{mesh!r}")
        dev = resolve_device(device)
        mesh = (cell_mesh() if dev.type == "cuda"
                and torch.cuda.device_count() > 1 else None)
        if mesh is None:
            return [dev], B
    elif mesh is None:
        return [resolve_device(device)], B
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be 'auto', None or a Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh.devices is None:
        raise ValueError("run_cells needs a mesh with devices, got an "
                         "abstract one")
    if device is not None:
        want = torch.device(device)
        if any(d.type != want.type or (want.index is not None
                                       and d.index != want.index)
               for d in mesh.devices):
            raise ValueError(f"device {want} disagrees with the mesh's "
                             f"devices {[str(d) for d in mesh.devices]}")
    Bp = -(-B // mesh.size) * mesh.size
    axes = resolve_rules(mesh, {"cell": Bp}).physical("cell")
    if axes is None:
        return [mesh.devices[0]], B
    return mesh.devices_along(axes), Bp


def run_cells(cells: Sequence[CellSpec], *, device=None,
              max_steps: int = 400_000, macro_threshold: float = 0.05,
              peer_form: str = "auto", chunk: int = DEFAULT_CHUNK,
              step: str = "fused", draws: str = "philox",
              mesh="auto") -> BatchResult:
    """Simulate every cell to completion (or censoring) and return a batch.

    ``device``: ``None`` runs on CUDA (and raises without a card);
    ``"cpu"`` runs the plain torch step on the CPU.
    ``max_steps`` bounds the attempt loop; cells still running when it is
    exhausted are reported censored at their current wall clock.
    ``macro_threshold``: cycle survival probability below which failure
    bursts are macro-stepped; 0 disables.
    ``peer_form``: "auto" | "perpeer" | "pm" (see
    ``repro.sim.engine.run_cells``).
    ``chunk``: engine steps per kernel launch; the host checks completion
    between chunks.
    ``step``: "fused" (the CUDA kernel of
    :mod:`repro_torch.kernels.sim_step`, with the parameters and the state
    packed once a run; its plain version on CPU tensors) or "scan" (the
    plain torch step on any device).  A batch that needs the per-peer form
    runs only with "scan" (:func:`batch_step`); "fused" raises
    ``ValueError`` for it on every device, as the reference does.
    ``draws``: "philox" (device stream; the fused step on the card draws
    it inside the kernel) or "numpy" (replays the reference numpy backend's
    streams, pre-generated; :mod:`repro_torch.sim.draws`).
    ``mesh``: cell-batch sharding -- "auto" (over
    :func:`~repro_torch.distributed.mesh.cell_mesh`, every card, when the
    run is on CUDA and more than one card is present; else unsharded),
    ``None`` (unsharded), or a :class:`~repro_torch.distributed.mesh.Mesh`
    whose data axes the ``cell`` logical axis is resolved against (a
    ``device`` that disagrees with its devices raises).  The batch is
    padded to a multiple of the mesh's size with copies of the last cell,
    born finished; the packed batch is split contiguously, one shard a
    data position, each with its own draw source on its device (both
    sources are keyed per cell, so a cell's trajectory does not depend on
    its shard), and the shards step in lockstep
    (:func:`repro_torch.kernels.sim_step.run_shards`).  The result is the
    unsharded run's, field for field and in ``n_steps``.  A batch (or
    shard) on the CPU is padded further to a multiple of ``_CPU_LANES``
    cells, born finished, so that every cell takes the same SIMD path
    whatever its place in the batch.
    """
    from repro_torch.kernels import sim_step
    from repro_torch.sim.draws import make_draws

    if step not in ("scan", "fused"):
        raise ValueError(f"unknown step {step!r}")
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    p_np = _pack(cells, peer_form)
    flags = batch_flags(cells, p_np)
    if step == "fused" and flags["peer_axis"] != 1:
        raise ValueError(
            "step='fused' supports batches with no per-peer-form cells "
            "(pooled or class-pooled estimators only); use step='scan'")
    B = len(cells)
    devs, Bp = _cell_shards(mesh, device, B)
    seeds = np.asarray([c.seed for c in cells], dtype=np.int64)
    per = Bp // len(devs)
    shards, keep = [], []
    for j, dev in enumerate(devs):
        # cells j*per .. (j+1)*per - 1 of the batch padded to Bp, then (on
        # the CPU) to a multiple of _CPU_LANES; every copy of the last cell
        # is born finished
        n = per + (-per % _CPU_LANES if dev.type == "cpu" else 0)
        idx = j * per + np.arange(n)
        born = (idx >= B) | (np.arange(n) >= per)
        idx = np.minimum(idx, min((j + 1) * per, B) - 1)
        p = from_reference(_Params(*(a[idx] for a in p_np)), device=dev)
        s = _init_state(p, flags["peer_axis"])
        if born.any():
            s = s._replace(finished=s.finished | torch.as_tensor(
                born, device=dev))
        shards.append((s, p, make_draws(draws, seeds[idx], flags["any_pm"],
                                        dev, flags["peer_axis"])))
        keep.append(per)
    states, steps = sim_step.run_shards(
        shards, chunk=chunk, max_steps=max_steps,
        macro_threshold=float(macro_threshold), plain=step == "scan",
        **flags)
    return _result([_State(*(x[:n] for x in s)) for s, n in zip(states, keep)],
                   p_np, steps)


def _result(states: Sequence[_State], p: _Params, steps: int) -> BatchResult:
    """The batch's result from its shards' final states, in order (the
    padding past ``p``'s cells sliced off)."""
    B = p.k.shape[0]
    h = _State(*(np.concatenate([x.cpu().numpy() for x in xs])[:B]
                 for xs in zip(*states)))
    completed = ~(h.censored | ~h.finished)
    return BatchResult(
        wall_time=h.t - p.t0,
        work_required=p.work / p.speed,
        n_checkpoints=h.n_ckpt.astype(np.int64),
        n_failures=h.n_fail.astype(np.int64),
        wasted_work=h.wasted,
        checkpoint_time=h.ckpt_time,
        restore_time=h.restore_time,
        completed=completed,
        server_bytes=h.sv_bytes,
        n_server_restores=h.n_srv.astype(np.int64),
        n_peer_restores=h.n_peer.astype(np.int64),
        n_steps=steps,
    )
