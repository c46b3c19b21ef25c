"""Per-step noise for the batched engine: two draw sources.

Both yield ``[chunk, n_draw, B]`` float64 tensors, one row per step, with
draw rows ``u`` (uniform: failure time / macro failure count), ``z``
(standard normal: macro burst duration), ``u2`` (uniform: surviving
replica count) and, when the batch holds class-pooled cells, ``u_pm`` and
``z_pm[0]``, ``z_pm[1]`` (the ``_PM_STREAM`` noise of the decision row
and the gossip pull).

* :class:`PhiloxDraws` -- the fast source.  Philox4x32-10 written in plain
  torch integer ops on the device, keyed by (cell seed, stream tag) and
  counted by step, so a cell's draws depend only on its own seed: cells
  sharing a seed share their churn noise (common random numbers across
  the policies of a comparison), and a cell's realization never depends
  on the rest of the batch.  Every 32x32-bit product is split into 16-bit
  halves so that all intermediates stay below 2**63 in int64.  Uniforms
  carry 53 random bits in [0, 1); normals come from Box-Muller.  It is
  held to the reference only statistically (3-sigma agreement of means).
* :class:`NumpyDraws` -- the parity source.  It replays the reference
  numpy backend's per-unique-seed ``default_rng`` streams
  (``repro.sim.engine._run_numpy``) on the host in ``_RNG_BLOCK`` blocks,
  in the same order (``u``, ``z``, ``u2``; then ``u_pm`` and ``z_pm[2]``
  from the ``_PM_STREAM`` generator), so trajectories can be compared cell
  by cell with ``repro.sim.run_cells(backend="numpy")``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import F64

_RNG_BLOCK = 256          # parity source: draws pregenerated per seed
_PM_STREAM = 0x706D6573   # per-seed tag of the class-pooled noise stream
_MAIN_STREAM = 0x6D61696E  # per-seed tag ("main") of the churn noise stream

_MASK32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_TWO_PI = 2.0 * math.pi
_INV_2_53 = 1.0 / 9007199254740992.0


def n_draws(any_pm: bool) -> int:
    """Draw rows per step: u, z, u2 (+ u_pm, z_pm0, z_pm1)."""
    return 6 if any_pm else 3


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` (a < 2**32, m < 2**32) with
    every intermediate below 2**63."""
    p_lo = (a & 0xFFFF) * m            # < 2**48
    p_hi = (a >> 16) * m               # < 2**48
    s = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return ((p_hi >> 16) + (s >> 32)) & _MASK32, s & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcasting)."""
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def _u53(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """53-bit uniform in [0, 1) from two 32-bit words."""
    return (hi * 2097152 + (lo >> 11)).to(F64) * _INV_2_53


class PhiloxDraws:
    """Fast device source: step ``i`` of cell ``b`` is Philox of the counter
    (i lo, i hi, block, 0) under the key (seed lo, seed hi ^ stream tag)."""

    def __init__(self, seeds: Sequence[int], any_pm: bool, device):
        sd = torch.as_tensor(np.asarray(list(seeds), dtype=np.int64),
                             dtype=torch.int64, device=device)
        self.device = sd.device
        self.any_pm = any_pm
        self.step = 0
        k0 = sd & _MASK32
        hi = (sd >> 32) & _MASK32
        self._keys = [(k0, hi ^ _MAIN_STREAM)]
        if any_pm:
            self._keys.append((k0, hi ^ _PM_STREAM))

    def _uniforms(self, key, steps: torch.Tensor, block: int):
        k0, k1 = key
        c0 = (steps & _MASK32)[:, None]
        c1 = (steps >> 32)[:, None]
        c2 = torch.full_like(c0, block)
        c3 = torch.zeros_like(c0)
        w0, w1, w2, w3 = philox4x32(c0, c1, c2, c3, k0[None, :], k1[None, :])
        return _u53(w0, w1), _u53(w2, w3)

    def next(self, n: int) -> torch.Tensor:
        steps = torch.arange(self.step, self.step + n, dtype=torch.int64,
                             device=self.device)
        self.step += n
        u, u2 = self._uniforms(self._keys[0], steps, 0)
        a, b = self._uniforms(self._keys[0], steps, 1)
        z = torch.sqrt(-2.0 * torch.log1p(-a)) * torch.cos(_TWO_PI * b)
        rows = [u, z, u2]
        if self.any_pm:
            u_pm, a = self._uniforms(self._keys[1], steps, 0)
            b, _ = self._uniforms(self._keys[1], steps, 1)
            r = torch.sqrt(-2.0 * torch.log1p(-a))
            rows += [u_pm, r * torch.cos(_TWO_PI * b),
                     r * torch.sin(_TWO_PI * b)]
        return torch.stack(rows, dim=1).contiguous()


class NumpyDraws:
    """Parity source: the reference numpy backend's streams, replayed."""

    def __init__(self, seeds: Sequence[int], any_pm: bool, device):
        uniq, inv = np.unique(np.asarray(list(seeds), dtype=np.int64),
                              return_inverse=True)
        self._inv = inv
        self.device = torch.device(device)
        self.any_pm = any_pm
        self._gens = [np.random.default_rng(int(sd)) for sd in uniq]
        self._pm_gens = ([np.random.default_rng(np.random.SeedSequence(
            [int(sd), _PM_STREAM])) for sd in uniq] if any_pm else None)
        self._blocks = None
        self._j = _RNG_BLOCK

    def _refill(self) -> None:
        # Per-generator order as in the reference: random, standard_normal,
        # random; then the pm generator's random and standard_normal((2, N)).
        u = np.stack([g.random(_RNG_BLOCK) for g in self._gens])
        z = np.stack([g.standard_normal(_RNG_BLOCK) for g in self._gens])
        u2 = np.stack([g.random(_RNG_BLOCK) for g in self._gens])
        rows = [u, z, u2]
        if self._pm_gens is not None:
            upm = np.stack([g.random(_RNG_BLOCK) for g in self._pm_gens])
            zpm = np.stack([g.standard_normal((2, _RNG_BLOCK))
                            for g in self._pm_gens])
            rows += [upm, zpm[:, 0], zpm[:, 1]]
        self._blocks = np.stack(rows, axis=0)[:, self._inv]  # [n_draw, B, N]
        self._j = 0

    def next(self, n: int) -> torch.Tensor:
        out = np.empty((n, n_draws(self.any_pm), self._inv.shape[0]))
        filled = 0
        while filled < n:
            if self._j == _RNG_BLOCK:
                self._refill()
            take = min(n - filled, _RNG_BLOCK - self._j)
            out[filled:filled + take] = np.moveaxis(
                self._blocks[:, :, self._j:self._j + take], 2, 0)
            filled += take
            self._j += take
        return torch.as_tensor(out, dtype=F64, device=self.device)


def make_draws(kind: str, seeds: Sequence[int], any_pm: bool, device):
    if kind == "philox":
        return PhiloxDraws(seeds, any_pm, device)
    if kind == "numpy":
        return NumpyDraws(seeds, any_pm, device)
    raise ValueError(f"unknown draw source {kind!r} (philox | numpy)")
