"""Streaming checkpoint-interval service (the port of
``repro/serve/policy_service.py``): the paper's controller serving clients.

Clients submit failure / repair observations and receive per-client Eq. 11
intervals.  Three request flows, as the reference:

* **calibrate** -- synthetic lifetimes with a KNOWN mu through exactly the
  estimator path a client's observations take; reports the estimate's
  relative error and the interval an oracle with the true mu would commit.
* **query** -- one-shot: a batch of :class:`~repro_torch.policy.
  PolicyRequest` bundles in, one :class:`~repro_torch.policy.PolicyDecision`
  each out.  No state survives the call.
* **session** -- long-lived telemetry: each client streams observations
  over many requests and the service keeps incremental estimator state per
  client, resumable across restarts via :mod:`repro_torch.ckpt.store`
  atomic snapshots (the reference's format: either service restores the
  other's snapshots).

Device state
------------
The struct-of-arrays session state (:class:`_ClientBatch`) lives on the
service's device (``device=None``: CUDA, raising without a card;
``"cpu"``): float64/int64/bool tensors ``[clients]``, the windowed form's
ring buffers ``[clients, max_window]`` and the moment form's ``(m_d,
m_T)``.  Concurrent requests fold through one vectorized update per event
column, masked rather than compacted, so no step waits on the host.  Every
operation is the reference's numpy operation in the same order, so the
decisions are **bit-identical** to the reference service and to
:class:`~repro_torch.core.adaptive.AdaptiveCheckpointController`:

* the windowed estimator sums each client's ring in deque order, one
  sequential vector add per age (never ``torch.sum``, whose order differs);
* divisions by a constant go through :func:`repro_torch.device.div`
  (dividing a CUDA tensor by a Python float multiplies by its reciprocal);
* the moment form's death decay ``beta = exp(log1p(-1/window))`` is taken
  on the host, as the reference takes it (CUDA's ``exp`` is not numpy's);
* the Eq. 11 W0 solve stays the host :class:`~repro_torch.core.lambertw.
  LambertWCache` (exact keys are bitwise by construction): the device
  computes the argument vector, one copy per batch feeds the cache, and
  one copy brings the decisions back.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lambertw import LambertWCache
from repro_torch.core.utilization import optimal_interval_scalar
from repro_torch.device import F64, div, resolve_device
from repro_torch.policy import PolicyDecision, PolicyRequest

_E = math.e
_F8 = np.float64
_I8 = np.int64
_TORCH = {_F8: torch.float64, _I8: torch.int64, np.bool_: torch.bool}

# Struct-of-arrays session state: (name, dtype).  ``buf`` ([cap, W]) is
# handled separately.  Order is the snapshot schema (the reference's).
_FIELDS: Tuple[Tuple[str, type], ...] = (
    ("k", _F8), ("prior_mu", _F8), ("prior_v", _F8), ("prior_count", _F8),
    ("window", _I8), ("alpha", _F8),
    ("min_interval", _F8), ("max_interval", _F8),
    ("start", _I8), ("count", _I8), ("cens", _F8),
    ("anchor", _F8), ("dirty", np.bool_),
    ("v_val", _F8), ("v_wt", _F8),
    ("td", _F8), ("has_td", np.bool_),
    ("n_failures", _I8), ("n_checkpoints", _I8),
    ("m_d", _F8), ("m_T", _F8), ("log_decay", _F8),
)
# The knobs a row is opened with (pinned for the session's lifetime).
_KNOBS = ("k", "prior_mu", "prior_v", "prior_count", "alpha",
          "min_interval", "max_interval", "log_decay")


def _log_decay(window: int) -> float:
    return math.log1p(-1.0 / window) if window > 1 else -1e9


@dataclass(frozen=True)
class DecisionBatch:
    """Array-form decisions (the bulk/bench path; no per-client objects);
    host numpy arrays."""

    interval: np.ndarray
    mu: np.ndarray
    V: np.ndarray
    T_d: np.ndarray
    n_failures: np.ndarray
    clamped: np.ndarray

    def to_decisions(self, clients: Sequence[str]) -> List[PolicyDecision]:
        return [PolicyDecision(interval=float(self.interval[i]),
                               mu=float(self.mu[i]), V=float(self.V[i]),
                               T_d=float(self.T_d[i]),
                               n_failures=int(self.n_failures[i]),
                               clamped=bool(self.clamped[i]),
                               client=str(clients[i]))
                for i in range(self.interval.shape[0])]


@dataclass(frozen=True)
class CalibrationReport:
    """The calibrate flow's answer: estimator fidelity on known truth."""

    mu_true: float
    mu_hat: float
    rel_error: float          # |mu_hat - mu_true| / mu_true
    interval: float           # what the estimator path commits
    interval_oracle: float    # Eq. 11 at the TRUE mu, same V/T_d/clamps
    n_observations: int
    decision: PolicyDecision


class _ClientBatch:
    """Per-client estimator state as device tensors, rows grown by
    amortized doubling.

    The windowed form mirrors ``AdaptiveCheckpointController`` operation by
    operation (comments cite the scalar source) so decisions are bitwise
    equal; the moment form mirrors the engine's decayed estimator law.
    ``rows`` arguments are int64 tensors on the device, unique within a
    call; a masked update (``act``) leaves every other row's state as it
    was.
    """

    def __init__(self, estimator: str = "windowed", max_window: int = 256,
                 device=None):
        if estimator not in ("windowed", "moment"):
            raise ValueError(f"unknown estimator form {estimator!r}")
        if max_window < 1:
            raise ValueError("max_window must be >= 1")
        self.estimator = estimator
        self.device = resolve_device(device)
        self.W = int(max_window) if estimator == "windowed" else 1
        self.n = 0
        self._cap = 0
        self.buf = torch.empty((0, self.W), dtype=F64, device=self.device)
        for name, dt in _FIELDS:
            setattr(self, name, torch.empty(0, dtype=_TORCH[dt],
                                            device=self.device))
        # exp(log_decay) per row, taken on the host (the moment form's beta)
        self.beta = torch.empty(0, dtype=F64, device=self.device)

    def _put(self, a) -> torch.Tensor:
        """A host array on the device (a C-contiguous, writable copy first
        where the array is neither)."""
        return torch.from_numpy(np.require(a, requirements="CW")).to(
            self.device)

    # ------------------------------------------------------------------ #
    # Row allocation                                                     #
    # ------------------------------------------------------------------ #
    def _ensure(self, extra: int) -> None:
        need = self.n + extra
        if need <= self._cap:
            return
        cap = max(1024, 1 << (need - 1).bit_length())

        def grow(old: torch.Tensor) -> torch.Tensor:
            g = torch.zeros((cap,) + tuple(old.shape[1:]), dtype=old.dtype,
                            device=self.device)
            g[: self.n] = old[: self.n]
            return g

        self.buf = grow(self.buf)
        for name, _ in _FIELDS:
            setattr(self, name, grow(getattr(self, name)))
        self.beta = grow(self.beta)
        self._cap = cap

    def _open(self, b: int, knobs: Dict[str, np.ndarray],
              window: np.ndarray) -> np.ndarray:
        self._ensure(b)
        lo = self.n
        self.n += b
        stacked = self._put(np.stack([np.broadcast_to(
            np.asarray(knobs[name], dtype=_F8), (b,)) for name in _KNOBS]))
        for i, name in enumerate(_KNOBS):
            getattr(self, name)[lo:lo + b] = stacked[i]
        self.window[lo:lo + b] = self._put(
            np.broadcast_to(np.asarray(window, dtype=_I8), (b,)))
        self.beta[lo:lo + b] = self._put(np.exp(np.broadcast_to(
            np.asarray(knobs["log_decay"], dtype=_F8), (b,))))
        return np.arange(lo, lo + b, dtype=_I8)

    def _check_window(self, window: int) -> None:
        if self.estimator == "windowed" and window > self.W:
            raise ValueError(
                f"window={window} exceeds the service max_window={self.W}")

    def add_rows(self, reqs: Sequence[PolicyRequest]) -> np.ndarray:
        """New rows parameterized by each request's knobs (pinned at open)."""
        for r in reqs:
            self._check_window(r.window)
        knobs = {"k": [r.k for r in reqs],
                 "prior_mu": [r.prior_mu for r in reqs],
                 "prior_v": [r.prior_v for r in reqs],
                 "prior_count": [float(r.prior_count) for r in reqs],
                 "alpha": [r.ema_alpha for r in reqs],
                 "min_interval": [r.min_interval for r in reqs],
                 "max_interval": [r.max_interval for r in reqs],
                 "log_decay": [_log_decay(r.window) for r in reqs]}
        return self._open(len(reqs), knobs, [r.window for r in reqs])

    def add_rows_uniform(self, b: int, tpl: PolicyRequest) -> np.ndarray:
        """``b`` new rows all sharing one template's knobs (the bulk path --
        skips per-client request construction entirely)."""
        self._check_window(tpl.window)
        knobs = {"k": tpl.k, "prior_mu": tpl.prior_mu,
                 "prior_v": tpl.prior_v,
                 "prior_count": float(tpl.prior_count),
                 "alpha": tpl.ema_alpha, "min_interval": tpl.min_interval,
                 "max_interval": tpl.max_interval,
                 "log_decay": _log_decay(tpl.window)}
        return self._open(b, knobs, tpl.window)

    # ------------------------------------------------------------------ #
    # Vectorized event folding (one masked update per event column)      #
    # ------------------------------------------------------------------ #
    def ingest_failures(self, rows: torch.Tensor, mat: np.ndarray,
                        counts: np.ndarray) -> None:
        """``mat[i, :counts[i]]`` are row i's lifetimes, oldest first."""
        m = mat.shape[1]
        if m == 0 or counts.size == 0:
            return
        if not np.all(np.isfinite(mat)):
            raise ValueError("failure lifetimes must be finite")
        valid = np.arange(m)[None, :] < counts[:, None]
        if np.any(mat[valid] <= 0):
            raise ValueError("failure lifetimes must be positive")
        m = min(m, int(counts.max()))
        mat_d = self._put(mat[:, :m])
        cnt_d = self._put(counts)
        for j in range(m):
            act = cnt_d > j
            x = mat_d[:, j]
            if self.estimator == "windowed":
                # FailureRateEstimator.observe_failure: append + popleft
                # beyond window == ring overwrite of the oldest slot.
                w = self.window[rows]
                start = self.start[rows]
                count = self.count[rows]
                full = count == w
                pos = torch.where(full, start, (start + count) % w)
                old = self.buf[rows, pos]
                self.buf[rows, pos] = torch.where(act, x, old)
                self.start[rows] = torch.where(act & full, (start + 1) % w,
                                               start)
                self.count[rows] = torch.where(
                    act, torch.where(full, w, count + 1), count)
            else:
                # Engine law: one death decays the moments by beta then
                # adds (1 death, lifetime seconds of exposure).
                beta = self.beta[rows]
                md, mT = self.m_d[rows], self.m_T[rows]
                self.m_d[rows] = torch.where(act, md * beta + 1.0, md)
                self.m_T[rows] = torch.where(act, mT * beta + x, mT)
                self.count[rows] = self.count[rows] + act.to(torch.int64)
            # observe_failure: _anchor_dirty = True
            self.dirty[rows] = self.dirty[rows] | act
            self.n_failures[rows] = self.n_failures[rows] + act.to(torch.int64)

    def ingest_overheads(self, rows: torch.Tensor, mat: np.ndarray,
                         counts: np.ndarray) -> None:
        m = min(mat.shape[1], int(counts.max()) if counts.size else 0)
        if m == 0:
            return
        mat_d = self._put(mat[:, :m])
        cnt_d = self._put(counts)
        a = self.alpha[rows]
        for j in range(m):
            act = cnt_d > j
            # observe_checkpoint_overhead: _Ema.update(max(x, 0.0))
            x = torch.clamp_min(mat_d[:, j], 0.0)
            vv, vw = self.v_val[rows], self.v_wt[rows]
            self.v_val[rows] = torch.where(act, (1.0 - a) * vv + a * x, vv)
            self.v_wt[rows] = torch.where(act, (1.0 - a) * vw + a, vw)
            self.n_checkpoints[rows] = self.n_checkpoints[rows] \
                + act.to(torch.int64)

    def ingest_restores(self, rows: torch.Tensor, last: np.ndarray) -> None:
        """``last[i]`` is row i's most recent restore (NaN = none)."""
        if not np.any(~np.isnan(last)):
            return
        t = self._put(last)
        act = ~torch.isnan(t)
        # observe_restore: T_d is last-value
        self.td[rows] = torch.where(act, t, self.td[rows])
        self.has_td[rows] = self.has_td[rows] | act

    def ingest_tick(self, rows: torch.Tensor, now: np.ndarray,
                    peers) -> None:
        """Right-censored exposure, AdaptiveCheckpointController.tick law.
        ``peers`` is a host array (checked positive) or a device tensor of
        the rows' own ``k``."""
        act_h = ~np.isnan(now)
        if not act_h.any():
            return
        if isinstance(peers, np.ndarray) and np.any(peers[act_h] <= 0):
            raise ValueError("exposure_peers must be positive")
        t = self._put(now)
        n = peers if torch.is_tensor(peers) else self._put(peers)
        act = ~torch.isnan(t)
        anchor0 = self.anchor[rows]
        dirty = self.dirty[rows]
        b1 = act & (dirty | (t < anchor0))        # re-arm (+ clock reset)
        b2 = act & ~b1 & (t > anchor0)            # fold fresh exposure
        self.anchor[rows] = torch.where(b1, t, anchor0)
        self.dirty[rows] = dirty & ~b1
        expo = (t - anchor0) * n
        cens = self.cens[rows]
        self.cens[rows] = torch.where(b1, torch.zeros_like(cens),
                                      torch.where(b2, expo, cens))

    # ------------------------------------------------------------------ #
    # Decisions                                                          #
    # ------------------------------------------------------------------ #
    def _mu(self, rows: torch.Tensor) -> torch.Tensor:
        c = self.count[rows]
        cnt = c.to(F64)
        pc = self.prior_count[rows]
        pm = self.prior_mu[rows]
        if self.estimator == "windowed":
            # sum(self._lifetimes) is a SEQUENTIAL left-to-right float sum
            # in deque (age) order; mirror it term by term so the total is
            # bitwise the controller's.  Ring slot of age j is
            # (start + j) % window; slots with j >= count contribute +0.0.
            acc = torch.zeros(rows.shape[0], dtype=F64, device=self.device)
            maxc = int(c.max()) if rows.shape[0] else 0
            start = self.start[rows]
            w = self.window[rows]
            for j in range(maxc):
                pos = (start + j) % w
                acc = acc + torch.where(c > j, self.buf[rows, pos], 0.0)
            # estimate(): total = sum(lifetimes) + sum(censored); then the
            # Gamma-prior pseudo-observations when prior_count > 0.
            total = acc + self.cens[rows]
            num = cnt + pc
            den = total + pc / pm
        else:
            # Engine decision law; censored exposure folds transiently.
            num = self.m_d[rows] + pc
            den = (self.m_T[rows] + self.cens[rows]) + pc / pm
        den1 = torch.where(den > 0, den, 1.0)
        if self.estimator == "moment":
            return num / den1  # prior built into moments
        return torch.where(cnt > 0, num / den1, pm)

    def decide(self, rows: torch.Tensor, cache: LambertWCache) -> DecisionBatch:
        mu = self._mu(rows)
        # V property: EMA value once initialized (weight > 0), else prior_v.
        vw = self.v_wt[rows]
        init = vw > 0
        V = torch.where(init, self.v_val[rows] / torch.where(init, vw, 1.0),
                        self.prior_v[rows])
        # T_d property: last observed restore, else V (Sec 3.1.3).
        T_d = torch.where(self.has_td[rows], self.td[rows], V)
        # checkpoint_interval(): optimal_interval_scalar(mu, k, max(V,1e-6), T_d)
        Vc = torch.clamp_min(V, 1e-6)
        kmu = self.k[rows] * mu
        a = Vc * kmu
        b = T_d * kmu
        arg = div(((a - b) - 1.0) / (b + 1.0), _E)
        w = self._put(cache.solve_many(arg.cpu().numpy()))
        x = w + 1.0
        pos = x > 0.0
        raw = torch.where(pos, x / torch.where(pos, kmu, 1.0), math.inf)
        iv = torch.minimum(torch.maximum(raw, self.min_interval[rows]),
                           self.max_interval[rows])
        out = torch.stack([iv, mu, V, T_d, (iv != raw).to(F64),
                           self.n_failures[rows].to(F64)]).cpu().numpy()
        return DecisionBatch(interval=out[0], mu=out[1], V=out[2],
                             T_d=out[3], n_failures=out[5].astype(_I8),
                             clamped=out[4] != 0.0)

    # ------------------------------------------------------------------ #
    # Snapshot schema (the reference's leaves, dtypes and order)         #
    # ------------------------------------------------------------------ #
    def state_tree(self) -> Dict[str, np.ndarray]:
        tree = {name: getattr(self, name)[: self.n].cpu().numpy().copy()
                for name, _ in _FIELDS}
        tree["buf"] = self.buf[: self.n].cpu().numpy().copy()
        return tree

    def load_state_tree(self, tree: Dict[str, np.ndarray]) -> None:
        n = int(tree["k"].shape[0])
        self.W = int(tree["buf"].shape[1]) if n else self.W
        self.n = 0
        self._cap = 0
        self.buf = torch.empty((0, self.W), dtype=F64, device=self.device)
        for name, dt in _FIELDS:
            setattr(self, name, torch.empty(0, dtype=_TORCH[dt],
                                            device=self.device))
        self.beta = torch.empty(0, dtype=F64, device=self.device)
        self._ensure(n)
        self.n = n
        self.buf[:n] = self._put(tree["buf"])
        for name, _ in _FIELDS:
            getattr(self, name)[:n] = self._put(tree[name])
        self.beta[:n] = self._put(np.exp(np.asarray(tree["log_decay"],
                                                    dtype=_F8)))


def _pad(seqs: Sequence[Tuple[float, ...]]) -> Tuple[np.ndarray, np.ndarray]:
    counts = np.asarray([len(s) for s in seqs], dtype=_I8)
    m = int(counts.max()) if len(seqs) else 0
    mat = np.zeros((len(seqs), m), dtype=_F8)
    for i, s in enumerate(seqs):
        if s:
            mat[i, : len(s)] = s
    return mat, counts


class PolicyService:
    """The checkpoint-interval server: calibrate / query / session flows.

    In-process object; :mod:`repro_torch.launch.serve_policy` wraps it in a
    CLI and a JSON-lines TCP front end.  ``device`` holds the session
    state (``None``: CUDA); ``lw_key_bits`` selects the Lambert-W cache
    mode (None = exact/bitwise, small = fleet-throughput).
    """

    def __init__(self, *, estimator: str = "windowed", max_window: int = 256,
                 lw_key_bits: Optional[int] = None,
                 snapshot_root: Optional[str] = None,
                 snapshot_shards: int = 2, device=None):
        self.state = _ClientBatch(estimator=estimator, max_window=max_window,
                                  device=device)
        self.device = self.state.device
        self.lw_cache = LambertWCache(key_bits=lw_key_bits)
        self.snapshot_root = snapshot_root
        self.snapshot_shards = int(snapshot_shards)
        self._sessions: Dict[str, int] = {}
        self._snap_step = 0
        self.counters = {"calibrate": 0, "query": 0, "session": 0,
                         "decisions": 0}

    def _rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, dtype=_I8)).to(self.device)

    # ------------------------------------------------------------------ #
    # query flow (organic, one-shot)                                     #
    # ------------------------------------------------------------------ #
    def query(self, requests: Sequence[PolicyRequest]) -> List[PolicyDecision]:
        """One decision per request; no state survives the call."""
        self.counters["query"] += len(requests)
        if not requests:
            return []
        tmp = _ClientBatch(estimator=self.state.estimator,
                           max_window=max(self.state.W,
                                          max(r.window for r in requests)),
                           device=self.device)
        rows = self._rows(tmp.add_rows(requests))
        self._fold(tmp, rows, requests)
        batch = tmp.decide(rows, self.lw_cache)
        self.counters["decisions"] += len(requests)
        return batch.to_decisions([r.client for r in requests])

    # ------------------------------------------------------------------ #
    # session flow (streaming organic)                                   #
    # ------------------------------------------------------------------ #
    def session(self, requests: Sequence[PolicyRequest]) -> List[PolicyDecision]:
        """Fold each request into its client's live state, decide for all.

        Unknown clients open a session with the request's knobs (pinned for
        the session's lifetime; later knob fields are ignored).  Duplicate
        clients within one batch fold in arrival order.
        """
        self.counters["session"] += len(requests)
        if not requests:
            return []
        # Arrival-order passes: the i-th occurrence of a client goes in
        # pass i, so duplicate rows never collide inside one vector op.
        passes: List[List[int]] = []
        seen: Dict[str, int] = {}
        for i, r in enumerate(requests):
            p = seen.get(r.client, 0)
            seen[r.client] = p + 1
            while len(passes) <= p:
                passes.append([])
            passes[p].append(i)
        for idxs in passes:
            reqs = [requests[i] for i in idxs]
            fresh = [r for r in reqs if r.client not in self._sessions]
            if fresh:
                rows = self.state.add_rows(fresh)
                for r, row in zip(fresh, rows.tolist()):
                    self._sessions[r.client] = row
            rows = self._rows([self._sessions[r.client] for r in reqs])
            self._fold(self.state, rows, reqs)
        all_rows = self._rows([self._sessions[r.client] for r in requests])
        batch = self.state.decide(all_rows, self.lw_cache)
        self.counters["decisions"] += len(requests)
        return batch.to_decisions([r.client for r in requests])

    def session_update_arrays(
        self, clients: Sequence[str], *,
        failures: Optional[np.ndarray] = None,
        failure_counts: Optional[np.ndarray] = None,
        checkpoint_overheads: Optional[np.ndarray] = None,
        restores: Optional[np.ndarray] = None,
        now: Optional[np.ndarray] = None,
        exposure_peers: Optional[np.ndarray] = None,
        template: Optional[PolicyRequest] = None,
    ) -> DecisionBatch:
        """Bulk session update straight from host arrays (the wire/bench
        path).

        ``failures`` is ``[B, m]`` (``failure_counts`` marks the valid
        prefix per row, default all m); ``checkpoint_overheads`` ``[B]`` or
        ``[B, m]``; ``restores`` ``[B]`` with NaN = no restore; ``now``
        ``[B]`` (NaN = no tick) with optional ``exposure_peers``.  Unknown
        clients open sessions with ``template``'s knobs.  Returns array
        decisions -- no per-client Python objects on this path.
        """
        self.counters["session"] += len(clients)
        template = template if template is not None else PolicyRequest()
        fresh = [c for c in clients if c not in self._sessions]
        if fresh:
            rows = self.state.add_rows_uniform(len(fresh), template)
            self._sessions.update(zip(fresh, rows.tolist()))
        sess = self._sessions
        rows_h = np.fromiter((sess[c] for c in clients), dtype=_I8,
                             count=len(clients))
        if np.unique(rows_h).shape[0] != rows_h.shape[0]:
            raise ValueError("duplicate clients in one array batch; use "
                             "session() for arrival-order folding")
        b = rows_h.shape[0]
        rows = self._rows(rows_h)
        if failures is not None:
            mat = np.ascontiguousarray(np.asarray(failures, dtype=_F8))
            counts = (np.full(b, mat.shape[1], dtype=_I8)
                      if failure_counts is None
                      else np.asarray(failure_counts, dtype=_I8))
            self.state.ingest_failures(rows, mat, counts)
        if checkpoint_overheads is not None:
            o = np.asarray(checkpoint_overheads, dtype=_F8)
            if o.ndim == 1:
                o = o[:, None]
            self.state.ingest_overheads(rows, o,
                                        np.full(b, o.shape[1], dtype=_I8))
        if restores is not None:
            self.state.ingest_restores(rows, np.asarray(restores, dtype=_F8))
        if now is not None:
            t = np.asarray(now, dtype=_F8)
            if t.ndim == 0:
                t = np.full(b, float(t), dtype=_F8)
            peers = (self.state.k[rows] if exposure_peers is None
                     else np.broadcast_to(
                         np.asarray(exposure_peers, dtype=_F8), (b,)).copy())
            self.state.ingest_tick(rows, t, peers)
        self.counters["decisions"] += b
        return self.state.decide(rows, self.lw_cache)

    def end_session(self, client: str) -> bool:
        """Forget a client's session (its row is retired, not reused)."""
        return self._sessions.pop(client, None) is not None

    # ------------------------------------------------------------------ #
    # calibrate flow (synthetic, known truth)                            #
    # ------------------------------------------------------------------ #
    def calibrate(self, mu_true: float, *, n_observations: int = 64,
                  seed: int = 0,
                  template: Optional[PolicyRequest] = None) -> CalibrationReport:
        """Synthetic Exp(mu_true) lifetimes through the real estimator path."""
        if mu_true <= 0:
            raise ValueError("mu_true must be positive")
        if n_observations < 1:
            raise ValueError("need at least one synthetic observation")
        self.counters["calibrate"] += 1
        template = template if template is not None else PolicyRequest()
        rng = np.random.default_rng(seed)
        lifetimes = rng.exponential(scale=1.0 / mu_true, size=n_observations)
        req = replace(template, failures=tuple(float(x) for x in lifetimes),
                      client=template.client or "calibrate")
        dec = self.query([req])[0]
        oracle = optimal_interval_scalar(mu_true, req.k, max(dec.V, 1e-6),
                                         dec.T_d, cache=self.lw_cache)
        oracle = min(max(oracle, req.min_interval), req.max_interval)
        return CalibrationReport(
            mu_true=float(mu_true), mu_hat=dec.mu,
            rel_error=abs(dec.mu - mu_true) / mu_true,
            interval=dec.interval, interval_oracle=oracle,
            n_observations=n_observations, decision=dec)

    # ------------------------------------------------------------------ #
    # Snapshot / resume (ckpt.store atomic contract)                     #
    # ------------------------------------------------------------------ #
    def snapshot(self, root: Optional[str] = None) -> str:
        """Atomically persist all session state; returns the ckpt dir."""
        from repro_torch.ckpt.store import save_pytree

        root = root or self.snapshot_root
        if root is None:
            raise ValueError("no snapshot root configured")
        tree = self.state.state_tree()
        meta = {"estimator": self.state.estimator, "W": self.state.W,
                "counters": self.counters, "snap_step": self._snap_step,
                "sessions": sorted(self._sessions.items(),
                                   key=lambda kv: kv[1])}
        tree["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8).copy()
        self._snap_step += 1
        return save_pytree(root, self._snap_step - 1, tree,
                           n_shards=self.snapshot_shards)

    @classmethod
    def restore_latest(cls, root: str, *,
                       lw_key_bits: Optional[int] = None,
                       snapshot_shards: int = 2,
                       device=None) -> "PolicyService":
        """Rebuild a service on ``device`` from the newest committed
        snapshot under root (written by this service or the reference's)."""
        from repro_torch.ckpt.store import latest_checkpoint, load_pytree

        got = latest_checkpoint(root)
        if got is None:
            raise FileNotFoundError(f"no committed snapshot under {root}")
        _, path = got
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like = {name: np.zeros(meta["shape"], dtype=np.dtype(meta["dtype"]))
                for name, meta in manifest["leaves"].items()}
        tree = {k: v.numpy() for k, v in load_pytree(path, like).items()}
        meta = json.loads(tree.pop("meta_json").tobytes().decode())
        svc = cls(estimator=meta["estimator"], max_window=meta["W"],
                  lw_key_bits=lw_key_bits, snapshot_root=root,
                  snapshot_shards=snapshot_shards, device=device)
        svc.state.load_state_tree(tree)
        svc.counters = dict(meta["counters"])
        svc._snap_step = int(meta["snap_step"])
        svc._sessions = {c: int(r) for c, r in meta["sessions"]}
        return svc

    # ------------------------------------------------------------------ #
    # Introspection                                                      #
    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        return {
            "estimator": self.state.estimator,
            "device": str(self.device),
            "n_sessions": len(self._sessions),
            "n_rows": self.state.n,
            **self.counters,
            "lw_hits": self.lw_cache.hits,
            "lw_misses": self.lw_cache.misses,
            "lw_hit_rate": self.lw_cache.hit_rate,
            "lw_entries": len(self.lw_cache),
        }

    # ------------------------------------------------------------------ #
    # Shared folding of typed requests                                   #
    # ------------------------------------------------------------------ #
    def _fold(self, state: _ClientBatch, rows: torch.Tensor,
              reqs: Sequence[PolicyRequest]) -> None:
        # Canonical event order (repro_torch.policy): failures -> overheads
        # -> restores -> tick.  The three estimators touch disjoint state,
        # so only within-type order matters and it is preserved.
        mat, counts = _pad([r.failures for r in reqs])
        state.ingest_failures(rows, mat, counts)
        mat, counts = _pad([r.checkpoint_overheads for r in reqs])
        state.ingest_overheads(rows, mat, counts)
        state.ingest_restores(rows, np.asarray(
            [r.restores[-1] if r.restores else np.nan for r in reqs],
            dtype=_F8))
        state.ingest_tick(
            rows,
            np.asarray([np.nan if r.now is None else r.now for r in reqs],
                       dtype=_F8),
            np.asarray([r.k if r.exposure_peers is None else r.exposure_peers
                        for r in reqs], dtype=_F8))


# --------------------------------------------------------------------------- #
# Traffic generation: the engine's scenario registry as a load generator      #
# --------------------------------------------------------------------------- #

def synthetic_stream(scenario_name: str = "constant", *,
                     n_clients: int, n_rounds: int = 4,
                     obs_per_round: int = 2, seed: int = 0,
                     mix: Optional[str] = None, round_spacing: float = 3600.0,
                     V: float = 20.0, T_d: float = 50.0,
                     scenario_kwargs: Optional[dict] = None):
    """Yield per-round observation arrays (host numpy) for ``n_clients``
    synthetic clients, the reference's stream draw for draw.

    Each round r happens at ``t_r = (r+1) * round_spacing`` on the named
    scenario's clock: every client observes ``obs_per_round`` lifetimes
    drawn Exp(mu(t_r) * hazard_mult(class)) -- classes assigned by the
    ``mix`` preset's deterministic quota rule when given -- one jittered
    checkpoint-overhead sample around V, a restore observation around T_d
    every other round, and a tick at t_r.
    """
    from repro_torch.sim.scenarios import peer_class_mix, scenario

    scen = scenario(scenario_name, **(scenario_kwargs or {}))
    hmult = np.ones(n_clients, dtype=_F8)
    if mix is not None:
        mults = np.asarray(peer_class_mix(mix).hazard_mults(
            min(n_clients, 4096)), dtype=_F8)
        hmult = mults[np.arange(n_clients) % mults.shape[0]]
    rng = np.random.default_rng(seed)
    for r in range(n_rounds):
        t_r = (r + 1) * round_spacing
        mu_r = 1.0 / scen.mtbf(t_r)
        lifetimes = rng.exponential(1.0, size=(n_clients, obs_per_round)) \
            / (mu_r * hmult)[:, None]
        overheads = V * (0.8 + 0.4 * rng.random(n_clients))
        restores = np.full(n_clients, np.nan, dtype=_F8)
        if r % 2 == 1:
            restores = T_d * (0.7 + 0.6 * rng.random(n_clients))
        yield {"failures": lifetimes, "checkpoint_overheads": overheads,
               "restores": restores, "now": np.full(n_clients, t_r,
                                                    dtype=_F8)}
