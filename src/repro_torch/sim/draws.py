"""Per-step noise for the batched engine: two draw sources.

Both yield ``[chunk, n_draw, B]`` float64 tensors (:meth:`next`), one row
per step, with draw rows ``u`` (uniform: failure time / macro failure
count), ``z`` (standard normal: macro burst duration), ``u2`` (uniform:
surviving replica count) and, when the batch holds class-pooled cells,
``u_pm`` and ``z_pm[0]``, ``z_pm[1]`` (the ``_PM_STREAM`` noise of the
decision row and the gossip pull).

A source made with ``peer_axis > 1`` (a batch with per-peer-form cells:
isolated/gossip at k <= 32) also yields the per-peer observation noise
(:meth:`next_obs`): a second float64 tensor ``[chunk, 2, B, peer_axis]``
whose rows are ``u3`` (uniform) and ``z3`` (standard normal) of each peer
slot.  It comes from a stream of its own, tagged ``_OBS_STREAM`` and with
its own step counter, so the main (and pm) rows of every batch are the
same whether or not the batch needs it.  Only a source asked for it makes
it.

* :class:`PhiloxDraws` -- the fast source.  Philox4x32-10 written in plain
  torch integer ops on the device, keyed by (cell seed, stream tag) and
  counted by step, so a cell's draws depend only on its own seed: cells
  sharing a seed share their churn noise (common random numbers across
  the policies of a comparison), and a cell's realization never depends
  on the rest of the batch.  Every 32x32-bit product is split into 16-bit
  halves so that all intermediates stay below 2**63 in int64.  Uniforms
  carry 53 random bits in [0, 1); normals come from Box-Muller.  It is
  held to the reference only statistically (3-sigma agreement of means).
  It is also the plain version of the CUDA sim-step kernel's own
  generator: on the card the fused step draws in the kernel from the
  seeds and the step index (:meth:`PhiloxDraws.skip` advances the counter
  as :meth:`PhiloxDraws.next` would), bit for bit equal to
  :meth:`PhiloxDraws.at`.
* :class:`NumpyDraws` -- the parity source.  It replays the reference
  numpy backend's per-unique-seed ``default_rng`` streams
  (``repro.sim.engine._run_numpy``) on the host in ``_RNG_BLOCK`` blocks,
  in the same order (``u``, ``z``, ``u2``; then ``u_pm`` and ``z_pm[2]``
  from the ``_PM_STREAM`` generator), so trajectories can be compared cell
  by cell with ``repro.sim.run_cells(backend="numpy")``; the observation
  rows replay the ``_OBS_STREAM`` generator ``default_rng(SeedSequence(
  [seed, _OBS_STREAM]))``, a ``random((peer_axis, _RNG_BLOCK))`` then a
  ``standard_normal((peer_axis, _RNG_BLOCK))`` block a refill.

The Philox observation rows of step ``i`` are Philox of the counter (i
lo, i hi, block, 0) under the key (seed lo, seed hi ^ ``_OBS_STREAM``),
blocks ``0 .. peer_axis - 1``: the first half of the blocks gives the
``u3`` of peer slots ``2b`` and ``2b + 1``, the second half the
Box-Muller pairs (cos, sin) of ``z3``.  Their Box-Muller transform uses
only integer operations and IEEE +, -, *, / (:func:`_log`, :func:`_sqrt`,
:func:`_sincos_2pi`), never a math library, so the rows are the same bits
on the card and on the CPU.  (The main rows' normals use torch's ``log1p``,
``sqrt``, ``cos`` and ``sin``, whose CUDA and CPU versions differ in the
last bit; the CUDA kernel's generator makes the same calls.)
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
_OBS_STREAM = 0x6F627376   # per-seed tag ("obsv") of the per-peer noise

_MASK32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_TWO_PI = 2.0 * math.pi
_INV_2_53 = 1.0 / 9007199254740992.0


# Device-independent transcendental functions for the observation rows:
# integer bit operations and IEEE +, -, *, / only (separate torch ops, so
# no fused multiply-add), which round the same on every device.
_MANT = 0xFFFFFFFFFFFFF
_ONE_BITS = 0x3FF0000000000000
_SQRT2 = 1.4142135623730951
_LN2_HI = 6.93147180369123816490e-01   # fdlibm's split of log(2)
_LN2_LO = 1.90821492927058770002e-10
_LOG_COEFFS = tuple(1.0 / k for k in range(23, 0, -2))   # atanh series
_SIN_COEFFS = tuple((-1.0) ** j / math.factorial(2 * j + 1)
                    for j in range(9, -1, -1))
_COS_COEFFS = tuple((-1.0) ** j / math.factorial(2 * j)
                    for j in range(9, -1, -1))


def _split(x: torch.Tensor):
    """x = m * 2**e with m in [1, 2), for positive normal float64 x."""
    bits = x.contiguous().view(torch.int64)
    return (((bits & _MANT) | _ONE_BITS).view(F64), (bits >> 52) - 1023)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e as float64, for integer e in the normal range."""
    return ((e + 1023) << 52).view(F64)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def _log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float64 x (within a few ulp):
    log(x) = e log(2) + 2 atanh(s), s = (m - 1) / (m + 1), m in
    (sqrt(2)/2, sqrt(2)]."""
    m, e = _split(x)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int64)).to(F64)
    f = m - 1.0                      # exact (Sterbenz)
    t = f / (f + 2.0)
    return (e * _LN2_HI + (2.0 * t * _horner(t * t, _LOG_COEFFS)
                           + e * _LN2_LO))


def _sqrt(y: torch.Tensor) -> torch.Tensor:
    """Square root of non-negative float64 y (0 or normal): Newton's
    iteration on the mantissa scaled to [1, 4)."""
    pos = y > 0.0
    m, e = _split(torch.where(pos, y, 1.0))
    odd = (e & 1).to(torch.bool)
    m = torch.where(odd, m * 2.0, m)
    e = e - odd.to(torch.int64)
    r = (m + 1.0) * 0.5
    for _ in range(5):
        r = (r + m / r) * 0.5
    return torch.where(pos, r * _pow2(e >> 1), 0.0)


def _sincos_2pi(b: torch.Tensor):
    """(sin, cos) of 2 pi b for b in [0, 1): exact quadrant and octant
    reduction of 4b, then Taylor series on [0, pi/4]."""
    q = torch.floor(b * 4.0)
    f = b * 4.0 - q                  # exact
    swap = f > 0.5
    g = torch.where(swap, 1.0 - f, f)
    phi = g * (0.5 * math.pi)
    p2 = phi * phi
    sp = phi * _horner(p2, _SIN_COEFFS)
    cp = _horner(p2, _COS_COEFFS)
    s1, c1 = torch.where(swap, cp, sp), torch.where(swap, sp, cp)
    sin = torch.where(q == 0.0, s1, torch.where(q == 1.0, c1, torch.where(
        q == 2.0, -s1, -c1)))
    cos = torch.where(q == 0.0, c1, torch.where(q == 1.0, -s1, torch.where(
        q == 2.0, -c1, s1)))
    return sin, cos


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

    def __init__(self, seeds: Sequence[int], any_pm: bool, device,
                 peer_axis: int = 1):
        sd = torch.as_tensor(np.asarray(list(seeds), dtype=np.int64),
                             dtype=torch.int64, device=device)
        self.seeds = sd
        self.device = sd.device
        self.any_pm = any_pm
        self.peer_axis = _check_peer_axis(peer_axis)
        self.step = 0
        self.obs_step = 0
        self._keys = None

    def keys(self):
        """The (k0, k1) key words of the main stream (and the pm stream),
        made on first use: a run that draws in the kernel never needs them."""
        if self._keys is None:
            k0 = self.seeds & _MASK32
            hi = (self.seeds >> 32) & _MASK32
            self._keys = [(k0, hi ^ _MAIN_STREAM)]
            if self.any_pm:
                self._keys.append((k0, hi ^ _PM_STREAM))
        return self._keys

    def _uniforms(self, key, steps: torch.Tensor, block: int):
        k0, k1 = key
        c0 = (steps & _MASK32)[:, None]
        c1 = (steps >> 32)[:, None]
        c2 = torch.full_like(c0, block)
        c3 = torch.zeros_like(c0)
        w0, w1, w2, w3 = philox4x32(c0, c1, c2, c3, k0[None, :], k1[None, :])
        return _u53(w0, w1), _u53(w2, w3)

    def next(self, n: int) -> torch.Tensor:
        """The draws of the next ``n`` steps, ``[n, n_draw, B]``."""
        return self.at(self.skip(n), n)

    def skip(self, n: int) -> int:
        """Advance the counter by ``n`` steps without drawing; returns the
        first step skipped (where a generator in the kernel starts)."""
        step0 = self.step
        self.step += n
        return step0

    def at(self, step0: int, n: int) -> torch.Tensor:
        """The draws of steps ``step0 .. step0 + n - 1`` (the counter does
        not move)."""
        steps = torch.arange(step0, step0 + n, dtype=torch.int64,
                             device=self.device)
        keys = self.keys()
        u, u2 = self._uniforms(keys[0], steps, 0)
        a, b = self._uniforms(keys[0], steps, 1)
        z = torch.sqrt(-2.0 * torch.log1p(-a)) * torch.cos(_TWO_PI * b)
        rows = [u, z, u2]
        if self.any_pm:
            u_pm, a = self._uniforms(keys[1], steps, 0)
            b, _ = self._uniforms(keys[1], steps, 1)
            r = torch.sqrt(-2.0 * torch.log1p(-a))
            rows += [u_pm, r * torch.cos(_TWO_PI * b),
                     r * torch.sin(_TWO_PI * b)]
        return torch.stack(rows, dim=1).contiguous()

    def next_obs(self, n: int) -> torch.Tensor:
        """The observation rows of the next ``n`` steps, ``[n, 2, B, P]``
        (a counter of their own)."""
        step0 = self.obs_step
        self.obs_step += n
        return self.obs_at(step0, n)

    def obs_at(self, step0: int, n: int) -> torch.Tensor:
        """The observation rows of steps ``step0 .. step0 + n - 1``."""
        P = self.peer_axis
        if P == 1:
            raise ValueError("this source was made without per-peer rows "
                             "(peer_axis=1)")
        steps = torch.arange(step0, step0 + n, dtype=torch.int64,
                             device=self.device)
        k0 = (self.seeds & _MASK32)[None, None, :]
        k1 = ((self.seeds >> 32) & _MASK32 ^ _OBS_STREAM)[None, None, :]
        c0 = (steps & _MASK32)[:, None, None]
        c1 = (steps >> 32)[:, None, None]
        c2 = torch.arange(P, dtype=torch.int64, device=self.device)[
            None, :, None]
        w0, w1, w2, w3 = philox4x32(c0, c1, c2, torch.zeros_like(c0), k0, k1)
        a, b = _u53(w0, w1), _u53(w2, w3)            # [n, P blocks, B]
        h = P // 2
        u3 = torch.stack((a[:, :h], b[:, :h]), dim=2).reshape(n, P, -1)
        r = _sqrt(-2.0 * _log(1.0 - a[:, h:]))      # 1 - a is exact
        sin, cos = _sincos_2pi(b[:, h:])
        z3 = torch.stack((r * cos, r * sin), dim=2).reshape(n, P, -1)
        return torch.stack((u3, z3), dim=1).transpose(2, 3).contiguous()


def _check_peer_axis(peer_axis: int) -> int:
    peer_axis = int(peer_axis)
    if peer_axis < 1 or (peer_axis > 1 and peer_axis % 2):
        raise ValueError(f"peer_axis must be 1 or even, got {peer_axis}")
    return peer_axis


class NumpyDraws:
    """Parity source: the reference numpy backend's streams, replayed."""

    def __init__(self, seeds: Sequence[int], any_pm: bool, device,
                 peer_axis: int = 1):
        uniq, inv = np.unique(np.asarray(list(seeds), dtype=np.int64),
                              return_inverse=True)
        self._inv = inv
        self.device = torch.device(device)
        self.any_pm = any_pm
        self.peer_axis = _check_peer_axis(peer_axis)
        self._gens = [np.random.default_rng(int(sd)) for sd in uniq]
        self._pm_gens = ([np.random.default_rng(np.random.SeedSequence(
            [int(sd), _PM_STREAM])) for sd in uniq] if any_pm else None)
        # Made only for batches with per-peer cells, as the reference does.
        self._obs_gens = ([np.random.default_rng(np.random.SeedSequence(
            [int(sd), _OBS_STREAM])) for sd in uniq]
            if self.peer_axis > 1 else None)
        self._blocks = self._obs_blocks = None
        self._j = self._obs_j = _RNG_BLOCK

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

    def next_obs(self, n: int) -> torch.Tensor:
        """The observation rows of the next ``n`` steps, ``[n, 2, B, P]``."""
        if self._obs_gens is None:
            raise ValueError("this source was made without per-peer rows "
                             "(peer_axis=1)")
        P = self.peer_axis
        out = np.empty((n, 2, self._inv.shape[0], P))
        filled = 0
        while filled < n:
            if self._obs_j == _RNG_BLOCK:
                # Per generator: random((P, N)), then standard_normal((P, N)).
                blk = [(g.random((P, _RNG_BLOCK)),
                        g.standard_normal((P, _RNG_BLOCK)))
                       for g in self._obs_gens]
                self._obs_blocks = np.asarray(blk)[self._inv]  # [B, 2, P, N]
                self._obs_j = 0
            take = min(n - filled, _RNG_BLOCK - self._obs_j)
            out[filled:filled + take] = np.moveaxis(
                self._obs_blocks[..., self._obs_j:self._obs_j + take], 3,
                0).transpose(0, 2, 1, 3)
            filled += take
            self._obs_j += take
        return torch.as_tensor(out, dtype=F64, device=self.device)


def make_draws(kind: str, seeds: Sequence[int], any_pm: bool, device,
               peer_axis: int = 1):
    if kind == "philox":
        return PhiloxDraws(seeds, any_pm, device, peer_axis)
    if kind == "numpy":
        return NumpyDraws(seeds, any_pm, device, peer_axis)
    raise ValueError(f"unknown draw source {kind!r} (philox | numpy)")
