"""Bandwidth/transfer model for checkpoint images (peer uplinks vs server).

Anderson & Fedak quantify the volunteer fleet's aggregate storage and
network capacity: individually slow peer uplinks, in aggregate dwarfing
the project server's shared pipe.  This module turns those capacities into
restore/fetch times:

* fetching from m surviving peer replicas stripes the image across their
  uplinks, capped by the restoring peer's downlink:
  ``t = img / min(m * peer_uplink, peer_downlink)``;
* falling back to the work-pool server pays for the shared pipe: the
  server's capacity is divided among ``server_load`` concurrent flows
  (checkpoint uploads, input downloads, other jobs' restores), so one
  restore gets ``server_capacity / (1 + server_load)``.

These two laws are what make the paper's restore time T_d *endogenous*:
the engine derives every restore's duration from the surviving replica
count and this model instead of treating T_d as an exogenous constant.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.device import div


@dataclass(frozen=True)
class TransferModel:
    """Link capacities and image size, all in bytes / bytes-per-second."""

    img_bytes: float = 200e6        # checkpoint image size
    peer_uplink: float = 5e6        # one holder's serving bandwidth
    peer_downlink: float = 50e6     # restoring peer's receive cap
    server_capacity: float = 100e6  # work-pool server's shared pipe
    server_load: float = 20.0       # concurrent flows sharing that pipe

    def __post_init__(self) -> None:
        if min(self.img_bytes, self.peer_uplink, self.peer_downlink,
               self.server_capacity) <= 0:
            raise ValueError("sizes and bandwidths must be positive")
        if self.server_load < 0:
            raise ValueError("server_load must be non-negative")

    # ------------------------------------------------------------------ #
    @property
    def server_share(self) -> float:
        """Bandwidth one flow gets from the contended server pipe."""
        return self.server_capacity / (1.0 + self.server_load)

    def server_seconds(self) -> float:
        """Restore duration from the server (the m=0 fallback)."""
        return self.img_bytes / self.server_share

    def peer_seconds(self, m: int) -> float:
        """Restore duration striped across m >= 1 surviving replicas."""
        if m < 1:
            raise ValueError("need at least one surviving replica")
        return self.img_bytes / min(m * self.peer_uplink, self.peer_downlink)

    def restore_seconds(self, m: int) -> float:
        """Endogenous T_d for a restore finding m surviving replicas."""
        return self.peer_seconds(m) if m >= 1 else self.server_seconds()

    def restore_seconds_from(self, uplink_mults) -> float:
        """Endogenous T_d striped over a *heterogeneous* surviving set.

        ``uplink_mults`` are the surviving holders' class uplink multipliers
        (DESIGN.md Sec 7): holder i serves at ``uplink_mults[i] *
        peer_uplink``, the stripe is capped by the restoring peer's
        downlink, and an empty set falls back to the server.  With all
        multipliers 1.0 this is exactly :meth:`restore_seconds` of the
        count.

        The zero-survivor branch must stay total (DESIGN.md Sec 8): a
        correlated shock routinely empties the whole surviving set, and the
        restore then *must* come back as the finite server-fallback time —
        never a divide-by-zero or inf that would wedge the retry loop.  The
        ``not total > 0`` form also routes a NaN aggregate to the fallback.
        """
        total = math.fsum(uplink_mults) * self.peer_uplink
        if not total > 0.0:
            return self.server_seconds()
        return self.img_bytes / min(total, self.peer_downlink)

    def expected_restore_seconds(self, R: int, avail: float) -> float:
        """E[T_d] under m ~ Binomial(R, avail) — the oracle policy's view."""
        if not 0.0 <= avail <= 1.0:
            raise ValueError("avail must be a probability")
        return sum(
            math.comb(R, m) * avail ** m * (1.0 - avail) ** (R - m)
            * self.restore_seconds(m)
            for m in range(R + 1)
        )


def striped_restore_seconds(m, td_up1, td_cap, td_server):
    """Vectorized :meth:`TransferModel.restore_seconds` on torch tensors:
    peer-uplink striping ``max(td_up1/m, td_cap)`` for m >= 1, server
    fallback for m = 0.  ``m`` is a float64 tensor of surviving counts, or
    a Python float (the engine's unrolled expectation terms ``j + 1``).
    Mirrors ``repro.p2p.transfer.striped_restore_seconds``.
    """
    if isinstance(m, torch.Tensor):
        td_m = torch.maximum(td_up1 / torch.clamp_min(m, 1.0), td_cap)
        return torch.where(m >= 1.0, td_m, td_server)
    td_m = torch.maximum(div(td_up1, max(float(m), 1.0)), td_cap)
    return td_m if m >= 1.0 else td_server
