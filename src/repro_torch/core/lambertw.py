"""Lambert W function (principal branch W0) in torch, plus host copies.

The paper's optimal checkpoint rate (Section 3.2.3) is

    lambda* = k*mu / ( W0[ (V*k*mu - T_d*k*mu - 1) / (T_d*k*mu + 1) * e^-1 ] + 1 )

:func:`lambertw0` is the torch port of ``repro.core.lambertw.lambertw0``:
fixed-iteration Halley from a piecewise initial guess, float32 or float64,
with the same f32-safe guards (the ``maximum(z, 3)`` clamp on the
asymptotic lane and the ``finfo.tiny`` denominator guard).  The numpy and
pure-Python solvers (:func:`lambertw0_numpy`, :class:`LambertWCache`,
:func:`lambertw0_scalar`) are verbatim copies of the reference's, kept here
so the port imports nothing of ``repro``.

W0 is defined on [-1/e, inf) with range [-1, inf).  Near the branch point
the guess is the series in p = sqrt(2(ez + 1)) (Corless et al. 1996,
eq. 4.22).
"""
from __future__ import annotations

import torch

_E = 2.718281828459045235360287471352662498
_BRANCH = -1.0 / _E

# Series around the branch point z = -1/e:  W0(z) = -1 + p - p^2/3 + 11 p^3/72 - ...
_SERIES_COEFFS = (-1.0, 1.0, -1.0 / 3.0, 11.0 / 72.0, -43.0 / 540.0, 769.0 / 17280.0)


def _initial_guess(z: torch.Tensor) -> torch.Tensor:
    """Piecewise initial guess for Halley iteration."""
    c = _SERIES_COEFFS
    p = torch.sqrt(torch.clamp_min(2.0 * (_E * z + 1.0), 0.0))
    w_branch = c[0] + p * (c[1] + p * (c[2] + p * (c[3] + p * (c[4] + p * c[5]))))
    # Asymptotic lane, only selected for z >= 3: clamp the unselected lanes
    # there so float32 never forms log(0).
    logz = torch.log(torch.clamp_min(z, 3.0))
    w_large = logz - torch.log(logz)
    w_mid = z * (1.0 - z)
    return torch.where(z < -0.25, w_branch,
                       torch.where(z < 1.0, w_mid,
                                   torch.where(z < 3.0, 0.5 * torch.log1p(z),
                                               w_large)))


def lambertw0(z, iters: int = 12) -> torch.Tensor:
    """Principal branch W0(z) for z >= -1/e, elementwise (float32/float64).

    Arguments an ulp below -1/e are treated as the branch point.  The
    engine step calls this with ``iters=4``.
    """
    z = torch.as_tensor(z)
    if not z.is_floating_point():
        z = z.to(torch.float64)
    zc = torch.clamp_min(z, _BRANCH)
    w = _initial_guess(zc)
    # Smallest normal of the working dtype (a 1e-300 guard underflows to 0
    # in float32).
    tiny = float(torch.finfo(z.dtype).tiny)
    for _ in range(iters):
        ew = torch.exp(w)
        f = w * ew - zc
        wp1 = w + 1.0
        # Halley: w' = w - f / (ew*(w+1) - (w+2) f / (2 (w+1)))
        denom = ew * wp1 - (w + 2.0) * f / (
            2.0 * torch.where(torch.abs(wp1) < 1e-12, 1e-12, wp1))
        w = w - f / torch.where(torch.abs(denom) < tiny, tiny, denom)
    # Exact at the branch point (avoids 0/0 artifacts there).
    return torch.where(zc <= _BRANCH, -1.0, w)


def lambertw0_numpy(z, iters: int = 16):
    """Vectorized numpy W0 — same algorithm as :func:`lambertw0`.

    A host-side vectorized solver for whole cell batches (the reference
    engine's numpy backend uses it; validated against the torch version
    in tests).
    """
    import numpy as np

    z = np.asarray(z, dtype=np.float64)
    zc = np.maximum(z, _BRANCH)
    # Initial guess (same piecewise logic as the torch version).
    p = np.sqrt(np.maximum(2.0 * (_E * zc + 1.0), 0.0))
    w_branch = _SERIES_COEFFS[0] + p * (
        _SERIES_COEFFS[1]
        + p * (_SERIES_COEFFS[2] + p * (_SERIES_COEFFS[3] + p * (_SERIES_COEFFS[4] + p * _SERIES_COEFFS[5])))
    )
    logz = np.log(np.maximum(zc, 1e-300))
    w_large = logz - np.log(np.maximum(logz, 1e-300))
    w_mid = zc * (1.0 - zc)
    w = np.where(zc < -0.25, w_branch,
                 np.where(zc < 1.0, w_mid,
                          np.where(zc < 3.0, 0.5 * np.log1p(zc), w_large)))
    for _ in range(iters):
        ew = np.exp(w)
        f = w * ew - zc
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * np.where(np.abs(wp1) < 1e-12, 1e-12, wp1))
        w = w - f / np.where(np.abs(denom) < 1e-300, 1e-300, denom)
    return np.where(zc <= _BRANCH, -1.0, w)


class LambertWCache:
    """Quantized-key memoization of W0 solves (the Eq. 11 hot path).

    The policy service and the runtime controller solve W0 at arguments
    clustered just above the branch point z = -1/e (V -> 0 maps exactly
    onto it), where dW/dz diverges — so keys are built from the offset
    ``d = z - (-1/e)``, whose *relative* resolution bounds the relative
    error of the resulting interval (W0+1 ~ sqrt(2e*d) near the branch).

    ``key_bits`` keeps that many leading mantissa bits of ``d``:

    * ``None`` (default) — **exact**: the key is the full bit pattern of
      z and the solve runs at z itself, so the cache is bitwise
      transparent — it can only return exactly what
      :func:`lambertw0_scalar` would.  This is the mode the adaptive
      controller uses; repeated queries at unchanged estimates hit.
    * ``key_bits = B`` — **quantized**: z is snapped to its bucket's
      representative (low ``52 - B`` mantissa bits of ``d`` zeroed) and
      the solve runs AT the snapped argument.  The map z -> W is then a
      pure function of the key: a *hit returns bitwise the same float a
      cold evaluation of the same z would* — order- and history-
      independent — at the price of a relative interval error bounded by
      ~``2**-B`` (the policy service's fleet throughput mode; B=12 =>
      ~2e-4).

    ``hits`` / ``misses`` count solves served from the table vs computed
    fresh; ``max_entries`` bounds the table (cleared wholesale when full
    — the workloads are either small-support or quantized).
    """

    def __init__(self, key_bits: int | None = None,
                 max_entries: int = 1 << 18) -> None:
        if key_bits is not None and not 1 <= key_bits <= 52:
            raise ValueError("key_bits must be in [1, 52] or None (exact)")
        self.key_bits = key_bits
        self.max_entries = int(max_entries)
        self._drop = 0 if key_bits is None else 52 - key_bits
        self._table: dict = {}
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ #
    # Key / representative construction                                  #
    # ------------------------------------------------------------------ #
    def snap(self, z: float) -> float:
        """The representative argument actually solved for ``z``'s bucket."""
        import struct

        z = float(z)
        if z < _BRANCH:
            z = _BRANCH
        if self._drop == 0:
            return z
        d = z - _BRANCH
        bits = struct.unpack("<q", struct.pack("<d", d))[0]
        bits &= ~((1 << self._drop) - 1)
        return struct.unpack("<d", struct.pack("<q", bits))[0] + _BRANCH

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def __len__(self) -> int:
        return len(self._table)

    def clear(self) -> None:
        self._table.clear()

    def _room(self, incoming: int = 1) -> None:
        if len(self._table) + incoming > self.max_entries:
            self._table.clear()

    # ------------------------------------------------------------------ #
    # Solves                                                             #
    # ------------------------------------------------------------------ #
    def solve(self, z: float) -> float:
        """Scalar W0(z) through the cache (bitwise = cold solve of z)."""
        import struct

        z = float(z)
        if z < _BRANCH:
            z = _BRANCH
        if self._drop == 0:
            rep = z
            key = struct.unpack("<q", struct.pack("<d", z))[0]
        else:
            d = struct.unpack("<q", struct.pack("<d", z - _BRANCH))[0]
            key = d & ~((1 << self._drop) - 1)
            rep = struct.unpack("<d", struct.pack("<q", key))[0] + _BRANCH
        got = self._table.get(key)
        if got is not None:
            self.hits += 1
            return got
        self.misses += 1
        val = lambertw0_scalar(rep)
        self._room()
        self._table[key] = val
        return val

    def solve_many(self, z) -> "np.ndarray":  # noqa: F821 - doc type
        """Vectorized W0 through the cache.

        Unique keys are looked up / solved once (scalar solver, so results
        are bitwise identical to :meth:`solve` / :func:`lambertw0_scalar`
        at the representative); duplicates fan back out by inverse index.
        """
        import numpy as np

        z = np.ascontiguousarray(np.asarray(z, dtype=np.float64))
        shape = z.shape
        z = np.maximum(z.ravel(), _BRANCH)
        if self._drop == 0:
            keys = z.view(np.int64)
            reps = z
        else:
            d = np.ascontiguousarray(z - _BRANCH)
            keys = d.view(np.int64) & ~np.int64((1 << self._drop) - 1)
            reps = keys.view(np.float64) + _BRANCH
        uniq, first, inv = np.unique(keys, return_index=True,
                                     return_inverse=True)
        vals = np.empty(uniq.shape[0], dtype=np.float64)
        table = self._table
        n_new = 0
        self._room(uniq.shape[0])
        for j, key in enumerate(uniq.tolist()):
            got = table.get(key)
            if got is None:
                got = lambertw0_scalar(float(reps[first[j]]))
                table[key] = got
                n_new += 1
            vals[j] = got
        self.misses += n_new
        self.hits += z.shape[0] - n_new
        return vals[inv].reshape(shape)


_DEFAULT_CACHE = LambertWCache()  # exact keys: bitwise-transparent memo


def default_cache() -> LambertWCache:
    """The process-wide exact cache the scalar Eq. 11 path routes through."""
    return _DEFAULT_CACHE


def lambertw0_cached(z: float) -> float:
    """Scalar W0 through the default exact cache (bitwise = lambertw0_scalar)."""
    return _DEFAULT_CACHE.solve(z)


def lambertw0_scalar(z: float, iters: int = 64, tol: float = 1e-14) -> float:
    """Pure-Python scalar W0 — fast path for the runtime controller.

    The tensor version costs per-call dispatch; the discrete-event
    simulator and the training-loop controller call this hundreds of times
    per second, so they use this math-module implementation (validated
    against the torch version and scipy in tests).
    """
    import math

    z = float(z)
    if z < _BRANCH:
        z = _BRANCH
    if z == _BRANCH:
        return -1.0
    # Initial guess (same piecewise logic as the torch version).
    if z < -0.25:
        p = math.sqrt(max(2.0 * (_E * z + 1.0), 0.0))
        w = (_SERIES_COEFFS[0] + p * (_SERIES_COEFFS[1] + p * (_SERIES_COEFFS[2]
             + p * (_SERIES_COEFFS[3] + p * (_SERIES_COEFFS[4] + p * _SERIES_COEFFS[5])))))
    elif z < 1.0:
        w = z * (1.0 - z)
    elif z < 3.0:
        w = 0.5 * math.log1p(z)
    else:
        lz = math.log(z)
        w = lz - math.log(lz)
    for _ in range(iters):
        ew = math.exp(w)
        f = w * ew - z
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * (wp1 if abs(wp1) > 1e-12 else 1e-12))
        if denom == 0.0:
            break
        step = f / denom
        w -= step
        if abs(step) <= tol * max(abs(w), 1.0):
            break
    return w
