"""The port's flash-attention modules against the JAX package, on the CPU.

* ``repro_torch.kernels.ops.flash_attention`` (on CPU tensors: its plain
  version ``flash_attention_plain``) against the TPU kernel
  ``repro.kernels.ops.flash_attention`` run in Pallas interpret mode and
  against the oracle ``repro.kernels.ref.flash_attention_ref``, at the
  shapes and tolerances of ``tests/test_kernels.py`` (float32 2e-5,
  bfloat16 2e-2: the output is rounded to bfloat16 once, after float32
  sums taken in another order), its softcap/non-causal case and its
  block-size invariance, and at prompt lengths off the 64-row tile grid.
* Rows that see no key (Sq > Skv under the causal mask): the plain version
  gives 0 there, as the Pallas kernel does where such rows fill its q
  blocks, held to the Pallas kernel at 1e-6; the JAX oracle gives the mean
  of v there, and the port's ``ref.flash_attention_ref`` follows it.
* The plain version differentiates on the CPU; the kernel's refusal under
  autograd on CUDA tensors is held in ``test_torch_cuda.py``.

Inputs come from ``np.random.default_rng`` and reach both sides as the
same numbers (bfloat16 inputs are rounded once, by JAX, and handed across
exactly).  The kernel itself is held to the plain version on the card in
``test_torch_cuda.py`` and ``chip_smoke.py`` (A1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro.kernels import ref as R_ref
from repro_torch.kernels import flash_attention as TK
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ref as T_ref

F32_TOL, BF16_TOL = 2e-5, 2e-2


def _inputs(bg, r, sq, skv, d, dtype, seed):
    """(jax arrays, torch tensors) of q, k, v with the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((bg, r, sq, d), (bg, skv, d), (bg, skv, d))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in jx]
    return jx, tx


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bg,r,sq,skv,d", [
    (2, 1, 128, 128, 64),
    (1, 4, 256, 256, 128),   # GQA: 4 q-heads per kv head
    (2, 2, 128, 384, 64),    # decode-style: kv longer than q
    (1, 1, 512, 512, 128),
])
def test_plain_flash_matches_tpu_kernel_and_oracle(bg, r, sq, skv, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(bg, r, sq, skv, d, dtype, 1)
    scale = d ** -0.5
    before = TK.LAUNCHES
    out = T_ops.flash_attention(tq, tk, tv, scale=scale)
    assert TK.LAUNCHES == before           # CPU tensors: no kernel launch
    assert out.dtype == tq.dtype and tuple(out.shape) == (bg, r, sq, d)
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    _close(out, R_ops.flash_attention(jq, jk, jv, scale=scale,
                                      interpret=True), tol)
    _close(out, R_ref.flash_attention_ref(jq, jk, jv, scale=scale), tol)
    # the port's oracle is the JAX oracle's port
    _close(T_ref.flash_attention_ref(tq, tk, tv, scale=scale),
           R_ref.flash_attention_ref(jq, jk, jv, scale=scale), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_softcap_and_noncausal(causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 2, 128, 128, 64, jnp.float32, 2)
    out = T_ops.flash_attention(tq, tk, tv, scale=0.125, causal=causal,
                                softcap=50.0)
    _close(out, R_ops.flash_attention(jq, jk, jv, scale=0.125, causal=causal,
                                      softcap=50.0, interpret=True), F32_TOL)
    _close(out, R_ref.flash_attention_ref(jq, jk, jv, scale=0.125,
                                          causal=causal, softcap=50.0),
           F32_TOL)
    _close(T_ref.flash_attention_ref(tq, tk, tv, scale=0.125, causal=causal,
                                     softcap=50.0),
           R_ref.flash_attention_ref(jq, jk, jv, scale=0.125, causal=causal,
                                     softcap=50.0), F32_TOL)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128),
                                   (256, 256)])
def test_plain_flash_block_size_invariance(bq, bk):
    """The block sizes are the Pallas kernel's tiling: the port accepts
    them and its result does not depend on them; each Pallas tiling
    agrees with it at 1e-5 (``tests/test_kernels.py``'s invariance
    bound)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 1, 256, 256, 64, jnp.float32, 3)
    out = T_ops.flash_attention(tq, tk, tv, scale=0.125, block_q=bq,
                                block_kv=bk)
    assert torch.equal(out, T_ops.flash_attention(tq, tk, tv, scale=0.125))
    _close(out, R_ops.flash_attention(jq, jk, jv, scale=0.125, block_q=bq,
                                      block_kv=bk, interpret=True), 1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bg,r,sq,skv,d", [
    (2, 1, 24, 24, 16),      # olmo SMOKE prompt lengths, head_dim 16
    (2, 2, 40, 40, 16),
    (1, 3, 100, 100, 64),    # GQA, off the 64-row tile grid
    (2, 1, 40, 104, 32),     # kv longer than q, both off the grid
])
def test_plain_flash_off_the_tile_grid(bg, r, sq, skv, d, dtype):
    """Lengths that are not multiples of 64: the Pallas kernel takes them
    with one block of the whole length (block = min(128, length))."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(bg, r, sq, skv, d, dtype, 4)
    scale = d ** -0.5
    out = T_ops.flash_attention(tq, tk, tv, scale=scale)
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    _close(out, R_ops.flash_attention(jq, jk, jv, scale=scale,
                                      interpret=True), tol)
    _close(out, R_ref.flash_attention_ref(jq, jk, jv, scale=scale), tol)


@pytest.mark.parametrize("sq,skv,block", [(32, 16, 16), (128, 64, 64)])
def test_rows_with_no_visible_key_give_zero_as_the_tpu_kernel(sq, skv,
                                                             block):
    """Sq > Skv, causal: the first Sq - Skv rows see no key.  Their q
    blocks run no kv block in the Pallas kernel, which writes 0 (l == 0);
    the plain version writes exact 0 and matches the kernel at 1e-6
    everywhere.  The JAX oracle instead gives the mean of v on those rows
    (a reference-side disagreement, ROADMAP Queue 3), and the port's
    oracle follows it."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 1, sq, skv, 16, jnp.float32, 5)
    out = T_ops.flash_attention(tq, tk, tv, scale=0.25)
    pallas = R_ops.flash_attention(jq, jk, jv, scale=0.25, block_q=block,
                                   block_kv=block, interpret=True)
    _close(out, pallas, 1e-6)
    dead = sq - skv
    assert bool((out[:, :, :dead] == 0).all())
    assert not bool((out[:, :, dead:] == 0).all())
    mean_v = tv.mean(dim=1)
    oracle = T_ref.flash_attention_ref(tq, tk, tv, scale=0.25)
    _close(oracle, R_ref.flash_attention_ref(jq, jk, jv, scale=0.25), 1e-6)
    torch.testing.assert_close(oracle[0, 0, :dead],
                               mean_v.expand(dead, -1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[:, :, dead:], oracle[:, :, dead:],
                               rtol=1e-6, atol=1e-6)


def test_plain_flash_differentiates_on_cpu():
    """Under grad the CPU path is the plain version, which autograd
    differentiates: its gradients are those of the oracle's softmax."""
    _, (tq, tk, tv) = _inputs(1, 2, 24, 24, 16, jnp.float32, 6)
    args = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = T_ops.flash_attention(*args, scale=0.25, softcap=30.0)
    assert out.requires_grad
    g = torch.autograd.grad(out.square().sum(), args)
    ref_args = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    ref = T_ref.flash_attention_ref(*ref_args, scale=0.25, softcap=30.0)
    g_ref = torch.autograd.grad(ref.square().sum(), ref_args)
    for a, b in zip(g, g_ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("change,match", [
    (dict(d=48), "head_dim in"),
    (dict(kv_dtype=torch.float16), "dtype"),
    (dict(skv_shape=(2, 8, 24, 16)), "must be"),
    (dict(softcap=-1.0), "softcap"),
])
def test_kernel_operand_checks(change, match):
    """What the kernel refuses, checked before any launch (device-free)."""
    d = change.get("d", 16)
    q = torch.zeros(2, 1, 24, d)
    k = torch.zeros(change.get("skv_shape", (2, 24, d)),
                    dtype=change.get("kv_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        TK._check(q, k, k, change.get("softcap"))
    TK._check(torch.zeros(2, 1, 24, 16), torch.zeros(2, 24, 16),
              torch.zeros(2, 24, 16), None)


# --------------------------------------------------------------------------- #
# The tensor-core kernel's rounding design (bf16, head_dim 64 and 128)
# --------------------------------------------------------------------------- #

def _tc_model(q, k, v, *, scale, causal=True, softcap=None, keys=128):
    """The arithmetic of the wgmma kernel in torch ops: q k^T of bf16
    values summed in float32 (exact products), the online softmax over
    tiles of ``keys`` keys (m from -1e30, float32 l of the unrounded p), p
    rounded to bf16 before p v (the TPU's default-precision dot rounds the
    same operand), float32 accumulation, division by 1 where l = 0, one
    rounding of the output to bf16."""
    BG, R, Sq, D = q.shape
    Skv = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((BG, R, Sq, 1), TK.NEG_INF)
    l = torch.zeros((BG, R, Sq, 1))
    acc = torch.zeros((BG, R, Sq, D))
    vis_all = TK._visible(Sq, Skv, q.device) if causal else torch.ones(
        Sq, Skv, dtype=torch.bool)
    for k0 in range(0, Skv, keys):
        s = torch.einsum("brsd,btd->brst", qf, kf[:, k0:k0 + keys]) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(vis_all[:, k0:k0 + keys], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pb = p.to(torch.bfloat16).float()
        acc = acc * corr + torch.einsum("brst,btd->brsd", pb,
                                        vf[:, k0:k0 + keys])
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(torch.bfloat16)


@pytest.mark.parametrize("bg,r,sq,skv,d,causal,softcap,block", [
    (2, 1, 128, 128, 64, True, None, 128),   # tests/test_kernels.py's shapes
    (1, 4, 256, 256, 128, True, None, 128),
    (2, 2, 128, 384, 64, True, None, 128),
    (1, 1, 512, 512, 128, True, None, 128),
    (1, 1, 1000, 1000, 64, True, None, 200),  # off the 128-row grid
    (1, 2, 100, 300, 128, True, None, 100),   # Sq < Skv, off grid
    (1, 2, 200, 72, 64, True, None, 8),       # Sq > Skv: rows with no key
    (1, 2, 128, 128, 64, True, 50.0, 128),    # softcap
    (1, 2, 128, 128, 128, False, 50.0, 128),  # softcap, no mask
])
def test_tensor_core_rounding_design_matches_tpu_kernel(bg, r, sq, skv, d,
                                                        causal, softcap,
                                                        block):
    """The wgmma route's arithmetic (bf16 p before p v) stays within the
    bf16 bound of the TPU kernel in interpret mode (``block``: its tiling,
    which must divide the lengths; at Sq > Skv the rows with no key fill
    whole q blocks, where the TPU kernel gives 0) and of the port's plain
    version; rows that see no key are exactly 0."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(bg, r, sq, skv, d, jnp.bfloat16, 7)
    scale = d ** -0.5
    kw = dict(scale=scale, causal=causal, softcap=softcap)
    got = _tc_model(tq, tk, tv, **kw)
    assert TK.route(tq.dtype, d) == "wgmma"
    _close(got, R_ops.flash_attention(jq, jk, jv, interpret=True,
                                      block_q=block, block_kv=block, **kw),
           BF16_TOL)
    _close(got, TK.flash_attention_plain(tq, tk, tv, **kw).float(), BF16_TOL)
    dead = max(sq - skv, 0) if causal else 0
    assert bool((got[:, :, :dead] == 0).all())
    assert not bool((got[:, :, dead:] == 0).all())


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "wgmma"),        # olmo-1b and the dense configs
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 16, "simt"),
    (torch.float32, 128, "simt"),          # the float32 parity paths
    (torch.float32, 64, "simt"),
    (torch.float32, 16, "simt"),
])
def test_route_names_the_kernel_by_dtype_and_head_dim(dtype, d, want):
    assert TK.route(dtype, d) == want


def test_olmo_prefill_takes_the_tensor_core_route():
    """olmo-1b's serving config (bf16 compute, head_dim 128) reaches the
    tensor-core kernel; its float32 SMOKE parity runs stay on SIMT."""
    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_config("olmo-1b")
    assert cfg.use_flash_kernel
    dt = getattr(torch, cfg.compute_dtype)
    assert TK.route(dt, cfg.attention.head_dim) == "wgmma"
    smoke = get_smoke_config("olmo-1b")
    assert TK.route(torch.float32, smoke.attention.head_dim) == "simt"


def test_strides_of_unit_axes_are_normalised():
    """A size-1 axis may carry any stride in torch; the tensor maps take the
    contiguous one, and the alignment rule ignores the arbitrary one."""
    t = torch.zeros(4, 1, 24, 64).as_strided((4, 1, 24, 64),
                                             (24 * 64, 3, 64, 1))
    assert TK._strides(t) == (24 * 64, 24 * 64, 64, 1)
    assert TK._rows(t) is t
    odd = torch.zeros(3, 24, 72)[..., :64]           # rows 144 B apart
    assert TK._rows(odd) is odd
    odd_bf16 = torch.zeros(3, 24, 68, dtype=torch.bfloat16)[..., :64]
    assert TK._rows(odd_bf16).is_contiguous()        # 136 B: copied


def test_cuda_source_declares_the_wrapper_limits():
    """The C entries refuse what the wrapper does not route to them, and
    the bf16 kernel is built from wgmma and TMA."""
    from pathlib import Path

    cu = (Path(TK.__file__).resolve().parent / "csrc"
          / "flash_attention.cu").read_text()
    for d in TK.HEAD_DIMS:
        assert f"case {d}:" in cu
    for d in TK.TC_HEAD_DIMS:
        assert f"if (D == {d})" in cu
    assert "constexpr int kTcKeys = 128;" in cu
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in cu
    assert "cp.async.bulk.tensor" in cu and "mbarrier.try_wait" in cu
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in cu
    assert cu.count("cudaGetLastError()") >= 2
