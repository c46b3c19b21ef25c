"""The port's int8 block quantization and gradient compression against the
JAX package, on the CPU.

* ``repro_torch.kernels.ckpt_quant`` (on CPU tensors: the kernels' plain
  versions) against the TPU kernels ``repro.kernels.ops.quantize_blocks``
  / ``dequantize_blocks`` run in Pallas interpret mode: codes, scales and
  dequantized values bit for bit (the scale is ``amax * float32(1/127)``
  on both sides), float32 and bfloat16 in, float32 and bfloat16 out, with
  an all-zero block, exact .5 ties and 1, 3, 256 and 512 blocks.
* the same against the oracles ``repro.kernels.ref.quantize_blocks_ref``
  / ``dequantize_blocks_ref`` at ``tests/test_kernels.py``'s tolerances:
  codes equal, scales and values within 1e-6 relative (the oracle divides
  by 127), round-trip error <= scale / 2.
* ``repro_torch.train.compress.compress_grads`` against
  ``repro.train.compress.compress_grads(..., interpret=True)`` over three
  steps of error feedback on one mapping in the port's leaf layout (the
  mamba2 SMOKE parameters' names, shapes and dtypes): outputs and error
  state bit for bit, ``compressed_bytes`` equal.

Inputs are made with ``np.random.default_rng`` and reach both sides as the
same numbers.  The CUDA kernels are held to these plain versions on the
card in ``test_torch_cuda.py`` and ``chip_smoke.py`` (T1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro.kernels import ref as R_ref
from repro.train import compress as R_comp
import repro_torch.configs as T_cfg
from repro_torch.kernels import ckpt_quant as TQ
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ref as T_ref
from repro_torch.models import init_params
from repro_torch.train import compress as T_comp

BLOCK = 512


def quant_input(n_blocks: int, block: int, seed: int) -> np.ndarray:
    """float32 (n_blocks * block,): normal blocks at mixed scales, with the
    edge cases where there is room: block 0 all zero, block 1 exact ties
    (amax 127 gives scale 1.0 exactly, and the other values are k + 0.5),
    block 2 near the float32 range."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_blocks, block))
         * np.exp(rng.uniform(-8, 8, (n_blocks, 1)))).astype(np.float32)
    if n_blocks >= 3:
        x[0] = 0.0
        x[1] = rng.integers(-127, 127, block) + 0.5
        x[1, 0] = 127.0
        x[2] = rng.uniform(-3e38, 3e38, block)
    return x.reshape(-1)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bfloat16 rounded
    once, by JAX, and handed across exactly)."""
    if dtype == "bfloat16":
        j = jnp.asarray(x, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j, np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("n_blocks", [1, 3, 256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_bitwise(dtype, n_blocks):
    jx, tx = _pair(quant_input(n_blocks, BLOCK, seed=n_blocks), dtype)
    qr, sr = R_ops.quantize_blocks(jx, block=BLOCK, interpret=True)
    before = dict(TQ.LAUNCHES)
    qt, st = T_ops.quantize_blocks(tx, block=BLOCK)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        xr = R_ops.dequantize_blocks(qr, sr, block=BLOCK, dtype=jdt,
                                     interpret=True)
        xt = T_ops.dequantize_blocks(qt, st, block=BLOCK, dtype=tdt)
        assert xt.dtype == tdt
        np.testing.assert_array_equal(_np(xt), np.asarray(xr, np.float32))
    assert TQ.LAUNCHES == before           # CPU tensors launch no kernel


@pytest.mark.parametrize("n,block", [(4096, 512), (2048, 128), (8192, 256)])
def test_plain_matches_reference_oracle(n, block):
    x = (np.random.default_rng(7).standard_normal(n) * 3.0).astype(np.float32)
    jx, tx = _pair(x, "float32")
    qr, sr = R_ref.quantize_blocks_ref(jx, block)
    qt, st = TQ.quantize_blocks_plain(tx, block)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=1e-6)
    xt = TQ.dequantize_blocks_plain(qt, st, block)
    np.testing.assert_allclose(
        xt.numpy(), np.asarray(R_ref.dequantize_blocks_ref(qr, sr, block)),
        rtol=1e-6)
    # the port's own oracle is the JAX oracle, operation for operation
    qo, so = T_ref.quantize_blocks_ref(tx, block)
    np.testing.assert_array_equal(qo.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(so.numpy(), np.asarray(sr))
    np.testing.assert_array_equal(
        T_ref.dequantize_blocks_ref(qo, so, block).numpy(),
        np.asarray(R_ref.dequantize_blocks_ref(qr, sr, block)))
    # round trip within half a step of each block
    err = np.abs(x - xt.numpy())
    assert (err <= np.repeat(st.numpy(), block) / 2 + 1e-7).all()


def test_zero_block_and_ties():
    x = np.zeros((2, 256), np.float32)
    x[1] = np.arange(256) % 254 - 126.5
    x[1, 0] = 127.0                       # scale exactly 1.0
    q, s = TQ.quantize_blocks_plain(torch.from_numpy(x.reshape(-1)), 256)
    assert s.tolist() == [1.0, 1.0]
    assert (q[:256] == 0).all()
    want = np.round(x[1])                 # numpy rounds half to even too
    want[0] = 127.0
    np.testing.assert_array_equal(q[256:].numpy(), want.astype(np.int8))
    assert (TQ.dequantize_blocks_plain(q, s, 256)[:256] == 0).all()


def nan_inf_input(block: int, seed: int) -> np.ndarray:
    """Three blocks: one holding a NaN, one holding +inf and -inf, one
    holding a NaN and an inf."""
    x = np.random.default_rng(seed).standard_normal((3, block)).astype(
        np.float32)
    x[0, 5] = np.nan
    x[1, 7], x[1, 9] = np.inf, -np.inf
    x[2, 1], x[2, 2] = np.inf, np.nan
    return x.reshape(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_and_inf_blocks_match_pallas_kernel(dtype):
    """A NaN absmax takes the scale 1.0, an inf absmax an inf scale, a NaN
    quotient the code 0: the Pallas kernel's results, bit for bit."""
    jx, tx = _pair(nan_inf_input(BLOCK, seed=11), dtype)
    qr, sr = R_ops.quantize_blocks(jx, block=BLOCK, interpret=True)
    qt, st = T_ops.quantize_blocks(tx, block=BLOCK)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))
    assert st.tolist() == [1.0, np.inf, 1.0]
    assert qt[5] == 0 and (qt[BLOCK:2 * BLOCK] == 0).all()
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        xr = R_ops.dequantize_blocks(qr, sr, block=BLOCK, dtype=jdt,
                                     interpret=True)
        xt = T_ops.dequantize_blocks(qt, st, block=BLOCK, dtype=tdt)
        np.testing.assert_array_equal(_np(xt), np.asarray(xr, np.float32))


@pytest.mark.parametrize("block,n", [(500, 1000), (16, 32), (8192, 8192),
                                     (512, 1000)])
def test_wrappers_reject_what_the_kernels_do_not_take(block, n):
    with pytest.raises(ValueError):
        T_ops.quantize_blocks(torch.zeros(n), block=block)
    with pytest.raises(ValueError):
        T_ops.dequantize_blocks(torch.zeros(n, dtype=torch.int8),
                                torch.ones(max(n // block, 1)), block=block)


def _grad_tree(seed: int):
    """One random gradient per mamba2 SMOKE parameter (the port's names,
    shapes and dtypes: bfloat16 weights, float32 a_log/dt_bias/d_skip), as
    (name -> jax array, name -> torch tensor)."""
    cfg = T_cfg.get_smoke_config("mamba2-130m")
    model = init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for name, p in model.named_parameters():
        g = (rng.standard_normal(tuple(p.shape))
             * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
        dtype = "bfloat16" if p.dtype == torch.bfloat16 else "float32"
        j[name], t[name] = _pair(g, dtype)
    return j, t


def test_compress_grads_matches_reference_over_three_steps():
    j0, t0 = _grad_tree(0)
    err_j = R_comp.init_error_feedback(j0)
    err_t = T_comp.init_error_feedback(t0)
    assert set(err_t) == set(t0)
    for step in range(3):
        jg, tg = _grad_tree(10 + step)
        out_j, err_j = R_comp.compress_grads(jg, err_j, interpret=True)
        out_t, err_t = T_comp.compress_grads(tg, err_t)
        for name in tg:
            assert out_t[name].dtype == tg[name].dtype
            assert tuple(out_t[name].shape) == tuple(tg[name].shape)
            np.testing.assert_array_equal(
                _np(out_t[name]), np.asarray(out_j[name], np.float32),
                err_msg=f"step {step} {name}")
            np.testing.assert_array_equal(
                err_t[name].numpy(), np.asarray(err_j[name]),
                err_msg=f"step {step} {name} error state")
    assert T_comp.compressed_bytes(t0) == R_comp.compressed_bytes(j0)


def test_compress_leaf_error_bounded_by_half_a_step():
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (37, 29)).astype(np.float32))              # 1,073: padded to 3 blocks
    codes, scales, err = T_comp.compress_leaf(g, torch.zeros_like(g))
    assert codes.shape == (3 * BLOCK,) and scales.shape == (3,)
    bound = torch.repeat_interleave(scales, BLOCK)[:g.numel()] / 2
    assert (err.reshape(-1).abs() <= bound * (1 + 2.0 ** -20)).all()
