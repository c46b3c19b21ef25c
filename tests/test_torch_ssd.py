"""The port's SSD modules against the JAX package, on the CPU.

* ``repro_torch.kernels.ssd_scan.ssd_scan`` (on CPU tensors: its plain
  version) against the TPU kernel ``repro.kernels.ops.ssd_scan`` run in
  Pallas interpret mode and against the sequential oracle
  ``repro.kernels.ref.ssd_scan_ref``, at the shapes of
  ``tests/test_kernels.py``, with and without an initial state.
  Tolerances are those of ``tests/test_kernels.py``: 1e-4 in float32,
  3e-2 in bfloat16 (y is rounded to bfloat16 once, after float32 sums
  taken in another order).
* ``ssd_chunked`` (with its zero padding), ``ssd_recurrent_step`` and
  ``_causal_conv`` of ``repro_torch.models.ssm`` against their JAX
  counterparts, in float32 at 1e-4.

Inputs come from ``np.random.default_rng`` and reach both sides as the
same numbers (bfloat16 inputs are rounded once, by JAX, and handed across
exactly).  The kernel itself is held to the plain version on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro.kernels import ref as R_ref
from repro.models import ssm as R_ssm
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ref as T_ref
from repro_torch.kernels import ssd_scan as TK
from repro_torch.models import ssm as T_ssm

SHAPES = [(2, 64, 2, 16, 16, 16),
          (1, 128, 4, 32, 64, 32),
          (2, 256, 1, 64, 128, 64)]


def _inputs(b, s, h, p, n, dtype, seed, with_init):
    """(jax arrays, torch tensors) of x, dt, A, B, C, initial state, made
    the way tests/test_kernels.py makes them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    init = (rng.standard_normal((b, h, p, n)).astype(np.float32)
            if with_init else None)
    jx, jB, jC = (jnp.asarray(a, dtype) for a in (x, B, C))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx, tB, tC = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  for a in (jx, jB, jC))
    jax_in = (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
              None if init is None else jnp.asarray(init))
    torch_in = (tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                None if init is None else torch.from_numpy(init))
    return jax_in, torch_in


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_ssd_scan_matches_tpu_kernel_and_oracle(b, s, h, p, n, chunk,
                                                      dtype, with_init):
    (jx, jdt, jA, jB, jC, jinit), (tx, tdt, tA, tB, tC, tinit) = _inputs(
        b, s, h, p, n, dtype, 3, with_init)
    before = TK.LAUNCHES
    y, st = T_ops.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk,
                           initial_state=tinit)
    assert TK.LAUNCHES == before          # CPU tensors: no kernel launch
    assert y.dtype == tx.dtype and st.dtype == torch.float32
    assert tuple(y.shape) == (b, s, h, p) and tuple(st.shape) == (b, h, p, n)
    y_k, st_k = R_ops.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                               initial_state=jinit, interpret=True)
    y_r, st_r = R_ref.ssd_scan_ref(jx, jdt, jA, jB, jC, initial_state=jinit)
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-4
    for want_y, want_st in ((y_k, st_k), (y_r, st_r)):
        _close(y, want_y, tol)
        _close(st, want_st, tol)


@pytest.mark.parametrize("with_init", [False, True])
def test_port_oracle_matches_reference_oracle(with_init):
    (jx, jdt, jA, jB, jC, jinit), (tx, tdt, tA, tB, tC, tinit) = _inputs(
        2, 48, 3, 16, 32, jnp.float32, 5, with_init)
    y, st = T_ref.ssd_scan_ref(tx, tdt, tA, tB, tC, initial_state=tinit)
    y_r, st_r = R_ref.ssd_scan_ref(jx, jdt, jA, jB, jC, initial_state=jinit)
    _close(y, y_r, 1e-4)
    _close(st, st_r, 1e-4)


def test_ssd_scan_keeps_the_chunk_contract():
    _, (tx, tdt, tA, tB, tC, _) = _inputs(1, 48, 2, 16, 16, jnp.float32, 6,
                                          False)
    with pytest.raises(ValueError, match="chunk"):
        TK.ssd_scan(tx, tdt, tA, tB, tC, chunk=32)      # 48 % 32 != 0
    # s < chunk: one chunk of length s, as the TPU kernel does
    y, st = TK.ssd_scan(tx, tdt, tA, tB, tC, chunk=256)
    y1, st1 = TK.ssd_scan_plain(tx, tdt, tA, tB, tC, chunk=48)
    assert torch.equal(y, y1) and torch.equal(st, st1)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16), (12, 16)])
def test_ssd_chunked_matches_reference(s, chunk, with_init):
    (jx, jdt, jA, jB, jC, jinit), (tx, tdt, tA, tB, tC, tinit) = _inputs(
        2, s, 2, 16, 32, jnp.float32, 7, with_init)
    y, st = T_ssm.ssd_chunked(tx, tdt, tA, tB, tC, chunk, initial_state=tinit)
    y_r, st_r = R_ssm.ssd_chunked(jx, jdt, jA, jB, jC, chunk,
                                  initial_state=jinit)
    _close(y, y_r, 1e-4)
    _close(st, st_r, 1e-4)


def test_ssd_recurrent_step_matches_reference():
    rng = np.random.default_rng(8)
    b, h, p, n = 3, 4, 16, 32
    x = rng.standard_normal((b, h, p), dtype=np.float32)
    dt = rng.uniform(0.01, 0.2, (b, h)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = rng.standard_normal((b, n), dtype=np.float32)
    C = rng.standard_normal((b, n), dtype=np.float32)
    state = rng.standard_normal((b, h, p, n), dtype=np.float32)
    args = (x, dt, A, B, C, state)
    y, st = T_ssm.ssd_recurrent_step(*(torch.from_numpy(a) for a in args))
    y_r, st_r = R_ssm.ssd_recurrent_step(*(jnp.asarray(a) for a in args))
    _close(y, y_r, 1e-4)
    _close(st, st_r, 1e-4)


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("S", [1, 7])
def test_causal_conv_matches_reference(S, with_carry):
    rng = np.random.default_rng(9)
    Bsz, Cd, W = 2, 24, 4
    seq = rng.standard_normal((Bsz, S, Cd), dtype=np.float32)
    w = rng.standard_normal((W, Cd), dtype=np.float32)
    bias = rng.standard_normal(Cd, dtype=np.float32)
    carry = (rng.standard_normal((Bsz, W - 1, Cd), dtype=np.float32)
             if with_carry else None)
    out, new = T_ssm._causal_conv(
        torch.from_numpy(seq), torch.from_numpy(w), torch.from_numpy(bias),
        None if carry is None else torch.from_numpy(carry))
    out_r, new_r = R_ssm._causal_conv(
        jnp.asarray(seq), jnp.asarray(w), jnp.asarray(bias),
        None if carry is None else jnp.asarray(carry))
    _close(out, out_r, 1e-4)
    np.testing.assert_array_equal(new.numpy(), np.asarray(new_r))


def test_cuda_source_declares_the_wrapper_limits():
    """The C entry refuses what the wrapper's checks refuse."""
    from pathlib import Path

    cu = (Path(TK.__file__).resolve().parent / "csrc"
          / "ssd_scan.cu").read_text()
    assert f"constexpr int kMaxP = {TK.MAX_P};" in cu
    assert f"constexpr int kMaxN = {TK.MAX_N};" in cu
    assert "cudaGetLastError()" in cu


# --------------------------------------------------------------------------- #
# The tensor-core kernels' design (bf16 x / B / C)
# --------------------------------------------------------------------------- #

def _parts(a: torch.Tensor):
    """A float32 operand as the three bf16 operands the kernels issue:
    hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid)."""
    hi = a.to(torch.bfloat16).float()
    mid = (a - hi).to(torch.bfloat16).float()
    return hi, mid, (a - hi - mid).to(torch.bfloat16).float()


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a float32, b of bf16 values: one product per part."""
    hi, mid, lo = _parts(a)
    return hi @ b + mid @ b + lo @ b


def _tc_model(x, dt, A, B, C, *, chunk, initial_state=None):
    """The three passes of the tensor-core route in torch ops: per chunk
    the cumulative decay and the local state (dt x e^{cum_Q - cum})^T B
    with the decay-weighted x split in three bf16 parts; the state passed
    from chunk to chunk in float32; then y = (G o L o dt) x + e^{cum} C
    state_in^T with G = C B^T (bf16 operands, exact in float32), the
    masked scores and the state split in three parts."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xf, Bf, Cf = x.float(), B.float(), C.float()
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    state = (torch.zeros(b, h, p, n) if initial_state is None
             else initial_state.clone())
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, Bc, Cc = xf[:, sl], Bf[:, sl], Cf[:, sl]      # (b,Q,h,p), (b,Q,n)
        cum = torch.cumsum(dt[:, sl] * A, dim=1)            # (b,Q,h)
        w = dt[:, sl] * torch.exp(cum[:, -1:] - cum)        # (b,Q,h)
        wx = (xc * w[..., None]).permute(0, 2, 3, 1)        # (b,h,p,Q)
        local = _split_mm(wx, Bc[:, None])                  # (b,h,p,n)
        G = Cc @ Bc.transpose(1, 2)                         # (b,Q,Q)
        ch = cum.transpose(1, 2)                            # (b,h,Q)
        L = torch.exp(torch.where(tri, ch[..., :, None] - ch[..., None, :],
                                  0.0))
        M = torch.where(tri, G[:, None] * L * dt[:, sl].transpose(1, 2)[
            :, :, None, :], 0.0)                            # (b,h,Q,Q)
        y_intra = _split_mm(M, xc.permute(0, 2, 1, 3))      # (b,h,Q,p)
        y_inter = sum(Cc[:, None] @ part.transpose(-1, -2)
                      for part in _parts(state))            # (b,h,Q,p)
        y_inter = y_inter * torch.exp(ch)[..., None]
        ys.append((y_intra + y_inter).permute(0, 2, 1, 3))
        state = state * torch.exp(cum[:, -1])[..., None, None] + local
    return torch.cat(ys, dim=1).to(x.dtype), state


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 1, 64, 128, 64),      # tests/test_kernels.py's bf16 shape
    (1, 512, 2, 64, 128, 256),     # two chunks at mamba2-130m's widths
    (2, 128, 3, 32, 64, 128),
    (1, 192, 2, 16, 64, 64),
])
def test_tensor_core_design_matches_tpu_kernel_and_oracle(b, s, h, p, n,
                                                          chunk, with_init):
    """The chunk-parallel design with three-part splits holds y at 1e-2 (one
    bf16 rounding) and the final state at 1e-4 against the TPU kernel in
    interpret mode and the sequential oracle, as S1 holds the kernel."""
    (jx, jdt, jA, jB, jC, jinit), (tx, tdt, tA, tB, tC, tinit) = _inputs(
        b, s, h, p, n, jnp.bfloat16, 11, with_init)
    assert TK.route(tx.dtype, p, n, chunk) == "mma"
    y, st = _tc_model(tx, tdt, tA, tB, tC, chunk=chunk,
                      initial_state=tinit)
    assert y.dtype == torch.bfloat16
    y_k, st_k = R_ops.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                               initial_state=jinit, interpret=True)
    y_r, st_r = R_ref.ssd_scan_ref(jx, jdt, jA, jB, jC, initial_state=jinit)
    for want_y, want_st in ((y_k, st_k), (y_r, st_r)):
        _close(y, want_y, 1e-2)
        _close(st, want_st, 1e-4)


def test_one_bf16_rounding_of_the_state_would_break_its_bound():
    """Why the float32 operands are split: with the state product's
    operand rounded once to bf16 (2^-9 relative) the final state leaves
    the 1e-4 bound that the three-part split (~2^-25) keeps."""
    _, (tx, tdt, tA, tB, tC, _) = _inputs(1, 512, 2, 64, 128, jnp.bfloat16,
                                          12, False)
    want = TK.ssd_scan_plain(tx, tdt, tA, tB, tC, chunk=256)[1]
    split = _tc_model(tx, tdt, tA, tB, tC, chunk=256)[1]
    rounded = torch.zeros_like(want)
    for c in range(2):
        sl = slice(c * 256, (c + 1) * 256)
        cum = torch.cumsum(tdt[:, sl] * tA, dim=1)
        w = tdt[:, sl] * torch.exp(cum[:, -1:] - cum)
        wx = (tx[:, sl].float() * w[..., None]).permute(0, 2, 3, 1)
        local = wx.to(torch.bfloat16).float() @ tB[:, None, sl].float()
        rounded = rounded * torch.exp(cum[:, -1])[..., None, None] + local
    bound = 1e-4 + 1e-4 * want.abs()
    assert bool(((split - want).abs() <= bound).all())
    assert not bool(((rounded - want).abs() <= bound).all())


@pytest.mark.parametrize("dtype,p,n,chunk,want", [
    (torch.bfloat16, 64, 128, 256, "mma"),     # mamba2-130m serving
    (torch.bfloat16, 64, 128, 128, "mma"),     # a prompt shorter than Q
    (torch.bfloat16, 32, 64, 64, "mma"),
    (torch.bfloat16, 64, 128, 512, "simt"),    # chunk past 256
    (torch.bfloat16, 64, 128, 96, "simt"),     # chunk off the 64 grid
    (torch.bfloat16, 128, 128, 256, "simt"),   # p > 64
    (torch.bfloat16, 24, 128, 256, "simt"),    # p not a multiple of 16
    (torch.bfloat16, 64, 32, 256, "simt"),     # n not 64 or 128
    (torch.float32, 64, 128, 256, "simt"),     # the float32 parity paths
    (torch.float32, 16, 16, 32, "simt"),
])
def test_route_names_the_kernel(dtype, p, n, chunk, want):
    assert TK.route(dtype, p, n, chunk) == want


def test_mamba2_serving_takes_the_tensor_core_route():
    """mamba2-130m's serving config reaches the tensor-core kernels; its
    float32 SMOKE parity runs stay on SIMT."""
    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_config("mamba2-130m")
    assert cfg.use_flash_kernel
    s = cfg.ssm
    dt = getattr(torch, cfg.compute_dtype)
    assert TK.route(dt, s.head_dim, s.d_state, s.chunk) == "mma"
    smoke = get_smoke_config("mamba2-130m").ssm
    assert TK.route(torch.float32, smoke.head_dim, smoke.d_state,
                    smoke.chunk) == "simt"


def test_cuda_source_declares_the_tensor_core_limits():
    """The tensor-core C entry refuses what ``route`` does not send it, and
    its products run on the tensor cores from cp.async-loaded tiles."""
    from pathlib import Path

    cu = (Path(TK.__file__).resolve().parent / "csrc"
          / "ssd_scan.cu").read_text()
    assert f"constexpr int kMaxQ = {TK.TC_MAX_Q};" in cu
    assert f"constexpr int kRowTile = {TK.TC_ROW_TILE};" in cu
    for n in TK.TC_N:
        assert f"if (N == {n})" in cu
    assert "P % 16 != 0" in cu
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in cu
    assert "cp.async.cg.shared.global" in cu and "ldmatrix" in cu
