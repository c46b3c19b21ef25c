"""The P2P checkpoint store: spec for the batched engine + per-event oracle.

:class:`StoreSpec` is the complete, hashable description a simulation cell
carries: replication factor, re-replication (repair) time, and the
:class:`~repro.p2p.transfer.TransferModel`.  The batched engine packs its
derived scalars (``td_up1``, ``td_cap``, ``td_server``) and samples the
surviving-replica count in closed form — m ~ Binomial(R, availability) —
so the batched step stays branch-free.

:class:`P2PCheckpointStore` is the per-event counterpart driving the heap
reference simulator (:func:`repro.sim.job.simulate_job`): an exact
:class:`~repro.p2p.overlay.ReplicaSetProcess` evolves individual holder
deaths and repairs, and every restore reads the *actual* surviving count.
The engine's closed form must reproduce its statistics
(tests/test_p2p.py), the same parity discipline the engine already holds
against the heap for the churn process itself.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np

from repro_torch.p2p.overlay import ReplicaSetProcess, availability
from repro_torch.p2p.transfer import TransferModel

if TYPE_CHECKING:  # pragma: no cover - annotation only (avoids an import
    # cycle: repro.sim.engine imports this module at package-init time)
    from repro_torch.sim.scenarios import PeerClassMix, ShockClock, ShockSpec

# The batched engine unrolls the Binomial(R, A) inverse-CDF over a fixed
# number of terms; R beyond this adds no meaningful availability anyway
# (loss probability is already (mu*t_repair)^R).
R_MAX = 8


@dataclass(frozen=True)
class StoreSpec:
    """Replica placement + transfer description carried by a simulation cell.

    ``R = 0`` is the server-only baseline: no peer replicas, every restore
    (and every checkpoint upload) hits the work-pool server.
    """

    R: int = 3
    t_repair: float = 600.0            # recruit replacement + re-copy image
    transfer: TransferModel = field(default_factory=TransferModel)

    def __post_init__(self) -> None:
        if not 0 <= self.R <= R_MAX:
            raise ValueError(f"R must be in [0, {R_MAX}]")
        if self.t_repair <= 0:
            raise ValueError("t_repair must be positive")

    # Packed scalars for the vectorized engine: restore from m sources is
    # max(td_up1 / m, td_cap), i.e. img / min(m*uplink, downlink).
    @property
    def td_up1(self) -> float:
        return self.transfer.img_bytes / self.transfer.peer_uplink

    @property
    def td_cap(self) -> float:
        return self.transfer.img_bytes / self.transfer.peer_downlink

    @property
    def td_server(self) -> float:
        return self.transfer.server_seconds()

    def availability(self, mu: float) -> float:
        return availability(mu, self.t_repair)

    def availability_at(self, mu):
        """Vectorized holder availability 1/(1 + mu*t_repair) (mu array-ok)."""
        return 1.0 / (1.0 + mu * self.t_repair)


class P2PCheckpointStore:
    """Per-event replica store for the heap reference simulator.

    Tracks individual holder deaths/repairs via
    :class:`ReplicaSetProcess` and accounts the server I/O each job
    imposes: checkpoint uploads when R=0 (server-only mode) and fallback
    restores when every peer replica is lost.
    """

    def __init__(self, spec: StoreSpec, mtbf_fn: Callable[[float], float],
                 rng: np.random.Generator, t0: float = 0.0,
                 mix: Optional["PeerClassMix"] = None,
                 shock: Optional["ShockSpec"] = None,
                 shock_clock: Optional["ShockClock"] = None):
        """``mix`` (a :class:`repro.sim.scenarios.PeerClassMix`) makes the
        holder fleet heterogeneous: holder slot classes come from the mix's
        deterministic assignment over the R slots, each class scales the
        holder hazard, and restores stripe over the *surviving* holders'
        class uplinks (DESIGN.md Sec 7).  This is the exact Poisson-binomial
        per-event oracle for the batched engine's mean-field law.

        ``shock`` subjects the holders to correlated mass-kill epochs
        (DESIGN.md Sec 8); pass the job network's ``shock_clock`` so
        replica losses coincide with the job failures that trigger
        restores — the correlation the engine's shock-mixture survivor law
        models in closed form.  Class scopes resolve through ``mix``.
        """
        self.spec = spec
        holder_mults = holder_ups = None
        if mix is not None and not mix.is_trivial and spec.R > 0:
            holder_mults = mix.hazard_mults(spec.R)
            holder_ups = mix.uplink_mults(spec.R)
        self._holder_ups = holder_ups
        scope_mask = (shock.scope_mask(mix, spec.R)
                      if shock is not None else None)
        self.holders = ReplicaSetProcess(spec.R, mtbf_fn, spec.t_repair,
                                         rng, t0=t0, slot_mults=holder_mults,
                                         shock=shock, shock_clock=shock_clock,
                                         scope_mask=scope_mask)
        self.server_bytes = 0.0
        self.n_server_restores = 0
        self.n_peer_restores = 0
        self._last_from_server = False
        self._last_td = 0.0

    def restore_seconds_at(self, t: float) -> float:
        """Endogenous T_d for a restore attempt starting at wall time ``t``.

        Reads the exact surviving replica count (and, for a class-aware
        store, exactly *which* holders survive — their class uplinks set
        the stripe bandwidth); the attempt's source and duration are
        remembered so :meth:`commit_restore` / :meth:`abort_restore` can
        account it per attempt.
        """
        if self._holder_ups is not None:
            alive = self.holders.alive_slots(t)
            self._last_from_server = not alive
            self._last_td = self.spec.transfer.restore_seconds_from(
                [self._holder_ups[i] for i in alive])
        else:
            m = self.holders.n_alive(t)
            self._last_from_server = m == 0
            self._last_td = self.spec.transfer.restore_seconds(m)
        return self._last_td

    def commit_restore(self) -> None:
        """The in-flight restore completed (no churn interrupted it)."""
        if self._last_from_server:
            self.n_server_restores += 1
            self.server_bytes += self.spec.transfer.img_bytes
        else:
            self.n_peer_restores += 1

    def abort_restore(self, elapsed: float) -> None:
        """The in-flight restore was interrupted by churn after ``elapsed``
        seconds.  A server-fallback attempt still moved elapsed/td of the
        image through the shared pipe — server I/O is billed per ATTEMPT,
        not per success, or heavy churn (where retries concentrate) would
        be exactly where the server load is undercounted."""
        if self._last_from_server and self._last_td > 0.0:
            frac = min(max(elapsed, 0.0) / self._last_td, 1.0)
            self.server_bytes += self.spec.transfer.img_bytes * frac

    def commit_checkpoint(self) -> None:
        """A checkpoint was written.  Server-only mode uploads the image to
        the work-pool server; with peer replicas the image goes to holders
        and costs the server nothing."""
        if self.spec.R == 0:
            self.server_bytes += self.spec.transfer.img_bytes
