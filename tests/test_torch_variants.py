"""The port's dense variants and its full config registry against the JAX
package, on the CPU.

The four dense configs this slice serves -- gemma2-27b (alternating
local/global windows, attention and final logit softcaps, ``(1 + scale)``
rmsnorms, post-block norms, GELU-gated MLP), stablelm-1.6b (LayerNorm
with bias, partial RoPE, an untied head), starcoder2-3b (LayerNorm, plain
GELU, a sliding window, 2 KV heads) and qwen2-vl-7b (M-RoPE, an untied
head) -- at SMOKE size with the JAX package's ``init_params`` carried
across by ``from_reference``:

* the model: ``forward`` without a cache, ``prefill`` of 24- and 40-token
  prompts (40 is wider than the SMOKE window of 32, so gemma2's and
  starcoder2's local layers leave the kernel's route) and 8 teacher-forced
  ``decode_step``s, logits and KV cache, with ``use_flash_kernel`` on and
  off; qwen2-vl with three distinct M-RoPE position streams; greedy
  decoding token for token;
* each layer option against its JAX function: the norms, partial RoPE,
  M-RoPE with distinct streams, the untied head and the logit softcap;
* the int8 KV cache: codes and scales bitwise against the JAX package on
  identical K/V, a decode step over one cache, the prefill's codes;
* the registry: all ten configs field for field but for
  ``use_flash_kernel``, the (arch x shape) cells, the input stand-ins,
  ``params_struct`` of all ten configs at full size (both abstract: no
  weights allocated; the moe configs' float32 routers and the parameter
  counts of gemma2, the moe configs, zamba2, whose shared block is one
  unstacked subtree, and whisper, whose ``enc_blocks`` and ``cross`` are
  stacked) and ``cache_struct``; every family of the registry is ported;
* seeded draws: a seed still gives the CPU's draws bit for bit.

The JAX serving functions run jitted, as the JAX package's entry point
runs them (XLA compiles ``amax / 127.0`` to the product with the float32
reciprocal, which the port writes out).  Tolerances: float32 at 1e-4
(products summed in another order, a few ulps through two to four
layers); bfloat16 at 5e-2 (``tests/test_models_smoke.py``'s), because XLA
and torch round bfloat16 intermediates at different places.  Inputs come
from ``np.random.default_rng``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R_cfg
import repro.models as R_models
from repro.models import layers as R_layers
from repro.serve import step as R_step
import repro_torch.configs as T_cfg
import repro_torch.models as T_models
from repro_torch.launch import serve as T_launch
from repro_torch.models import layers as T_layers
from repro_torch.models import model as T_model
from repro_torch.serve import step as T_step

ARCHS = ("gemma2-27b", "stablelm-1.6b", "starcoder2-3b", "qwen2-vl-7b")
PORTED = ("mamba2-130m", "olmo-1b") + ARCHS + ("olmoe-1b-7b",
                                                "deepseek-moe-16b",
                                                "zamba2-7b",
                                                "whisper-large-v3")
BATCH, N_DECODE = 2, 8
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
QUANT_TOL = 0.15       # tests/test_kv_quant.py: int8 K/V against the full forward

R_prefill = jax.jit(R_models.prefill, static_argnums=(2, 3),
                    static_argnames=("cache_dtype",))
R_decode = jax.jit(R_models.decode_step, static_argnums=(3,))


def _cfgs(arch: str, dtype: str = "float32", kernel: bool = False, **change):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **change)
    return (R_cfg.get_smoke_config(arch).replace(**kw),
            T_cfg.get_smoke_config(arch).replace(use_flash_kernel=kernel,
                                                 **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _torch(tree):
    return {k: T_model._tensor(np.asarray(v)) for k, v in tree.items()}


def _x(shape, dtype: str, seed: int):
    """(jax array, torch tensor) of standard normals in ``dtype``."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32), getattr(jnp, dtype))
    return a, T_model._tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str, seed: int = 0):
    """The JAX parameters (numpy) of the SMOKE config."""
    rcfg, _ = _cfgs(arch, dtype)
    return _np_tree(R_models.init_params(jax.random.key(seed), rcfg))


def _tokens(vocab: int, n: int, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, n),
                                                dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference_serve(arch: str, dtype: str, prompt: int):
    """The JAX package's prefill and N_DECODE teacher-forced decode steps
    (jitted): the logits of each and the caches after the prefill and
    after the last step."""
    rcfg, _ = _cfgs(arch, dtype)
    params = jax.tree.map(jnp.asarray, _reference(arch, dtype))
    toks = _tokens(rcfg.vocab, prompt + N_DECODE)
    logits, cache = R_prefill(params, jnp.asarray(toks[:, :prompt]), rcfg,
                              prompt + N_DECODE,
                              cache_dtype=getattr(jnp, dtype))
    first = _np_tree(cache["kv"])
    out = [np.asarray(logits)]
    for i in range(N_DECODE):
        logits, cache = R_decode(params, cache,
                                 jnp.asarray(toks[:, prompt + i:][:, :1]),
                                 rcfg)
        out.append(np.asarray(logits))
    return out, first, _np_tree(cache["kv"])


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("norm", ["rmsnorm", "rmsnorm_one", "layernorm",
                                  "layernorm_nobias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype, norm):
    """Each norm's initial parameters equal the JAX package's, and the norm
    applied with random scale and bias (so that both enter) matches it."""
    rcfg, tcfg = _cfgs("olmo-1b", dtype, norm=norm)
    ref = _np_tree(R_layers.init_norm(jax.random.key(0), rcfg, 64))
    own = T_layers.init_norm(None, tcfg, 64)
    assert set(own) == set(ref)
    for k, v in T_layers.init_norm(torch.Generator(), tcfg, 64).items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      ref[k].astype(np.float32))
    rng = np.random.default_rng(3)
    p = {k: jnp.asarray(rng.standard_normal(64).astype(np.float32),
                        getattr(jnp, dtype)) for k in ref}
    jx, tx = _x((2, 5, 64), dtype, 0)
    jx, tx = jx * 3 + 1, tx * 3 + 1
    got = T_layers.apply_norm(_torch(_np_tree(p)), tx, tcfg)
    assert got.dtype == tx.dtype
    _close(got, R_layers.apply_norm(p, jx, rcfg), TOLS[dtype])


@pytest.mark.parametrize("pct", [0.25, 0.5, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_rope_matches_reference(dtype, pct):
    """The first int(D pct) dims, rounded down to even, rotate; the rest
    pass through unchanged (0.3 of 16 is 4)."""
    jx, tx = _x((2, 4, 12, 16), dtype, 1)
    pos = np.arange(12)[None, :] + 5
    got = T_layers.apply_rope(tx, torch.from_numpy(pos), 10000.0, pct)
    _close(got, R_layers.apply_rope(jx, jnp.asarray(pos), 10000.0, pct),
           TOLS[dtype])
    d_rot = int(16 * pct) // 2 * 2
    assert torch.equal(got[..., d_rot:], tx[..., d_rot:])
    assert not torch.equal(got[..., :d_rot], tx[..., :d_rot])


@pytest.mark.parametrize("sections,theta", [((2, 3, 3), 10000.0),
                                            ((16, 24, 24), 1e6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_matches_reference_with_distinct_streams(dtype, sections,
                                                       theta):
    """Three different position streams (t, h, w), each driving its own
    section of the frequency slots; with equal streams M-RoPE is RoPE."""
    hd = 2 * sum(sections)
    jx, tx = _x((2, 4, 10, hd), dtype, 2)
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 50, (2, 3, 10))
    assert not (pos[:, 0] == pos[:, 1]).all()
    got = T_layers.apply_rope(tx, torch.from_numpy(pos), theta,
                              mrope_sections=sections)
    _close(got, R_layers.apply_rope(jx, jnp.asarray(pos), theta,
                                    mrope_sections=sections), TOLS[dtype])
    plain = T_layers.apply_rope(tx, torch.from_numpy(pos[:, 0]), theta)
    assert not torch.equal(got, plain)
    same = np.repeat(pos[:, :1], 3, axis=1)
    torch.testing.assert_close(
        T_layers.apply_rope(tx, torch.from_numpy(same), theta,
                            mrope_sections=sections), plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="sections"):
        T_layers.apply_rope(tx, torch.from_numpy(pos), theta,
                            mrope_sections=(1, 1, 1))


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_head_and_logit_softcap_match_reference(cap, tie):
    """The tied embedding or the untied (d_model, vocab) unembedding, and
    tanh(logits / cap) * cap."""
    rcfg, tcfg = _cfgs("stablelm-1.6b", tie_embeddings=tie,
                       logit_softcap=cap)
    p = _np_tree(R_layers.init_embedding(jax.random.key(5), rcfg))
    assert set(T_layers.init_embedding(None, tcfg)) == set(p)
    assert ("unembed" in p) == (not tie)
    jx, tx = _x((2, 3, 64), "float32", 6)
    jx, tx = jx * 500, tx * 500           # logits past the cap
    got = T_layers.logits_from_hidden(_torch(p), tx, tcfg)
    want = R_layers.logits_from_hidden(
        jax.tree.map(jnp.asarray, p), jx, rcfg)
    _close(got, want, 1e-4)
    if cap is not None:
        assert float(got.abs().max()) <= cap
        assert float(got.abs().max()) > 0.9 * cap


@pytest.mark.parametrize("arch,scaled", [("gemma2-27b", True),
                                         ("stablelm-1.6b", False),
                                         ("starcoder2-3b", False),
                                         ("qwen2-vl-7b", False)])
def test_embedding_scaling_follows_the_config(arch, scaled):
    """sqrt(d_model) scales gemma2's tied rmsnorm_one embeddings; LayerNorm
    models and qwen2-vl's untied rmsnorm embeddings stay unscaled."""
    rcfg, tcfg = _cfgs(arch)
    tok = torch.randn(tcfg.vocab, tcfg.d_model,
                      generator=torch.Generator().manual_seed(0))
    toks = torch.tensor([[1, 2, 3]])
    got = T_layers.embed_tokens({"tok": tok}, toks, tcfg)
    torch.testing.assert_close(got, tok[toks] * (8.0 if scaled else 1.0))
    _close(got, R_layers.embed_tokens({"tok": jnp.asarray(tok.numpy())},
                                      jnp.asarray(toks.numpy()), rcfg), 1e-6)


# --------------------------------------------------------------------------- #
# The int8 KV cache
# --------------------------------------------------------------------------- #

def _selection(d: int, n: int, hd: int, start: int) -> np.ndarray:
    """(d, n, hd) weights whose product picks dims start.. of the input:
    every output is one input times 1, exact in any summation order."""
    w = np.zeros((d, n * hd), np.float32)
    w[start + np.arange(n * hd), np.arange(n * hd)] = 1.0
    return w.reshape(d, n, hd)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("arch", ["gemma2-27b", "stablelm-1.6b"])
def test_int8_cache_codes_and_scales_bitwise_on_identical_kv(arch, stacked):
    """K and V projections that pick input dims (so both frameworks compute
    the same K/V bits) and no rotation: the codes and scales the port
    writes -- a prefill at 0, then 3 tokens behind it -- equal the JAX
    package's bit for bit, in the per-layer and the stacked (L, ...) cache
    forms, and the attention outputs agree within 1e-4."""
    rcfg, tcfg = _cfgs(arch, kv_cache_quant=True)
    rcfg = rcfg.replace(attention=dataclasses.replace(rcfg.attention,
                                                      rope=None))
    tcfg = tcfg.replace(attention=dataclasses.replace(tcfg.attention,
                                                      rope=None))
    a = rcfg.attention
    p = {k: v[0] for k, v in _reference(arch, "float32")["blocks"]["attn"]
         .items()}
    p["wk"] = _selection(64, a.n_kv_heads, a.head_dim, 0)
    p["wv"] = _selection(64, a.n_kv_heads, a.head_dim, 64 - a.n_kv_heads
                         * a.head_dim)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch(p)
    shape = ((rcfg.n_layers,) if stacked else ()) + (
        BATCH, a.n_kv_heads, 32, a.head_dim)
    jc = _np_tree(R_models.init_cache(rcfg, BATCH, 32)["kv"])
    jc = {k: jnp.asarray(v if stacked else v[0]) for k, v in jc.items()}
    tc = T_models.init_cache(tcfg, BATCH, 32, device="cpu")["kv"]
    tc = tc if stacked else {k: v[0].clone() for k, v in tc.items()}
    assert tuple(tc["k"].shape) == shape and tc["k"].dtype == torch.int8
    mha = jax.jit(R_layers.multi_head_attention,
                  static_argnames=("cfg", "layer_index", "cache_index"))
    for idx, n, seed in ((0, 20, 7), (20, 3, 8)):
        jx, tx = _x((BATCH, n, 64), "float32", seed)
        pos = np.arange(idx, idx + n)[None, :]
        kw = dict(layer_index=1 if stacked else None, cache_index=idx)
        got, _ = T_layers.multi_head_attention(
            tp, tx, tcfg, positions=torch.from_numpy(pos), cache=tc, **kw)
        want, jc = mha(jp, jx, cfg=rcfg, positions=jnp.asarray(pos),
                       cache=jc, **kw)
        _close(got, want, 1e-4)
        for k in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    assert int((tc["k_scale"] != 1).sum()) == BATCH * a.n_kv_heads * 23


@pytest.mark.parametrize("arch", ["gemma2-27b", "stablelm-1.6b"])
def test_int8_cache_decode_and_prefill_match_reference(arch):
    """tests/test_kv_quant.py's case in float32: a 23-token prefill into an
    int8 cache, then one decode step.  The decode step over the JAX
    package's own prefill cache gives its logits within 1e-4, leaves the
    other slots as they were and writes the new token's scales within
    1e-5 and its codes within one step (that token's K/V are each
    framework's own products).  The port's prefill writes the JAX
    package's codes except where a value lies on a rounding boundary
    (K/V differ in the last bits across frameworks): at most 0.1% of the
    codes differ, each by one step.  The decode logits are within
    QUANT_TOL of the float forward (test_kv_quant.py's bound)."""
    rcfg, tcfg = _cfgs(arch, kv_cache_quant=True)
    params = _reference(arch, "float32")
    jparams = jax.tree.map(jnp.asarray, params)
    model = T_models.from_reference(params, tcfg, device="cpu")
    toks = _tokens(rcfg.vocab, 24, seed=12)
    _, jc = R_prefill(jparams, jnp.asarray(toks[:, :-1]), rcfg, 32)
    tc = {"kv": {k: torch.from_numpy(np.array(v))
                 for k, v in _np_tree(jc["kv"]).items()}, "index": 23}
    assert tc["kv"]["k"].dtype == torch.int8
    assert tc["kv"]["k_scale"].dtype == torch.float32
    lt, tc = T_models.decode_step(model, tc, torch.from_numpy(toks[:, -1:])
                                  .long(), tcfg)
    before = _np_tree(jc["kv"])
    lr, jc = R_decode(jparams, jc, jnp.asarray(toks[:, -1:]), rcfg)
    _close(lt, lr, 1e-4)
    for k in ("k", "v", "k_scale", "v_scale"):
        got, want = tc["kv"][k].numpy(), np.asarray(jc["kv"][k])
        np.testing.assert_array_equal(got[:, :, :, :23],
                                      before[k][:, :, :, :23])
        np.testing.assert_array_equal(got[:, :, :, 24:], want[:, :, :, 24:])
        # the new token's K/V come from the two frameworks' own products
        np.testing.assert_allclose(got[:, :, :, 23], want[:, :, :, 23],
                                   rtol=1e-5, atol=1.0 if k in "kv" else 0)
    lp, own = T_models.prefill(model, torch.from_numpy(toks[:, :-1]).long(),
                               tcfg, 32)
    for k in ("k", "v"):
        got = own["kv"][k].numpy().astype(np.int32)
        want = np.asarray(jc["kv"][k])[:, :, :, :23].astype(np.int32)
        diff = np.abs(got[:, :, :, :23] - want)
        assert diff.max() <= 1 and diff.mean() <= 1e-3
        assert not got[:, :, :, 23:].any()
    full, _, _ = T_models.forward(
        model, {"tokens": torch.from_numpy(toks).long()},
        tcfg.replace(kv_cache_quant=False))
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=QUANT_TOL, atol=QUANT_TOL)
    assert bool(torch.isfinite(lp).all())


def test_int8_cache_structure_matches_reference():
    """Codes int8, scales float32 and set to 1, the same shapes as the JAX
    cache; the cache dtype does not enter; ~half a bf16 cache's bytes."""
    rcfg, tcfg = _cfgs("gemma2-27b", "bfloat16", kv_cache_quant=True)
    want = R_models.init_cache(rcfg, 2, 64, jnp.bfloat16)["kv"]
    got = T_models.init_cache(tcfg, 2, 64, torch.bfloat16, device="cpu")["kv"]
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    full = T_models.init_cache(tcfg.replace(kv_cache_quant=False), 2, 64,
                               device="cpu")["kv"]

    def nbytes(kv):
        return sum(t.numel() * t.element_size() for t in kv.values())
    assert nbytes(got) / nbytes(full) < 0.7


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_cache_matches_reference(arch, kernel):
    """40 tokens: past the SMOKE window of 32 (gemma2's and starcoder2's
    local layers take _attention_core, the rest the kernel's route)."""
    rcfg, tcfg = _cfgs(arch, kernel=kernel)
    params = _reference(arch, "float32")
    model = T_models.from_reference(params, tcfg, device="cpu")
    toks = _tokens(rcfg.vocab, 40, seed=13)
    lt, cache, _ = T_models.forward(model, {"tokens": torch.from_numpy(toks)
                                            .long()}, tcfg)
    lr, _, _ = R_models.forward(jax.tree.map(jnp.asarray, params),
                                {"tokens": jnp.asarray(toks)}, rcfg)
    assert cache is None and lt.dtype == torch.float32
    _close(lt, lr, TOLS["float32"])


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("prompt", [24, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, prompt, kernel):
    """float32 parameters, compute and KV cache: the prefill's last logits,
    8 teacher-forced decode steps' logits, and the KV cache after each
    phase, within 1e-4."""
    _, tcfg = _cfgs(arch, kernel=kernel)
    model = T_models.from_reference(_reference(arch, "float32"), tcfg,
                                    device="cpu")
    want, first, last = _reference_serve(arch, "float32", prompt)
    toks = torch.from_numpy(_tokens(tcfg.vocab, prompt + N_DECODE)).long()
    lt, ct = T_models.prefill(model, toks[:, :prompt], tcfg,
                              prompt + N_DECODE, cache_dtype=torch.float32)
    assert tuple(lt.shape) == (BATCH, 1, tcfg.vocab)
    _close(lt, want[0], TOLS["float32"])
    for k in ("k", "v"):
        assert tuple(ct["kv"][k].shape) == first[k].shape
        _close(ct["kv"][k], first[k], TOLS["float32"])
    for i in range(N_DECODE):
        lt, ct = T_models.decode_step(model, ct, toks[:, prompt + i:][:, :1],
                                      tcfg)
        _close(lt, want[i + 1], TOLS["float32"])
    for k in ("k", "v"):
        _close(ct["kv"][k], last[k], TOLS["float32"])
    assert ct["index"] == prompt + N_DECODE


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch):
    """The configs' own bfloat16 with the kernel knob on, 24 tokens."""
    _, tcfg = _cfgs(arch, "bfloat16", kernel=True)
    model = T_models.from_reference(_reference(arch, "bfloat16"), tcfg,
                                    device="cpu")
    want, _, last = _reference_serve(arch, "bfloat16", 24)
    toks = torch.from_numpy(_tokens(tcfg.vocab, 24 + N_DECODE)).long()
    lt, ct = T_models.prefill(model, toks[:, :24], tcfg, 24 + N_DECODE)
    _close(lt, want[0], TOLS["bfloat16"])
    for i in range(N_DECODE):
        lt, ct = T_models.decode_step(model, ct, toks[:, 24 + i:][:, :1],
                                      tcfg)
        _close(lt, want[i + 1], TOLS["bfloat16"])
    for k in ("k", "v"):
        assert ct["kv"][k].dtype == torch.bfloat16
        _close(ct["kv"][k], last[k], TOLS["bfloat16"])


@pytest.mark.parametrize("kernel", [True, False])
def test_mrope_positions_match_reference(kernel):
    """qwen2-vl with three distinct (B, 3, S) position streams through the
    prefill step and (B, 3, 1) ones through the serve step, as a vision
    tower would give them; text positions (none given) differ from them."""
    rcfg, tcfg = _cfgs("qwen2-vl-7b", kernel=kernel)
    params = _reference("qwen2-vl-7b", "float32")
    jparams = jax.tree.map(jnp.asarray, params)
    model = T_models.from_reference(params, tcfg, device="cpu")
    rng = np.random.default_rng(14)
    toks = _tokens(rcfg.vocab, 21, seed=15)
    pos = np.sort(rng.integers(0, 30, (BATCH, 3, 21)), axis=-1).astype(
        np.int32)
    pre = T_step.make_prefill_step(tcfg, max_seq=24,
                                   cache_dtype=torch.float32)
    srv = T_step.make_serve_step(tcfg)
    lt, ct = pre(model, {"tokens": torch.from_numpy(toks[:, :20]).long(),
                         "positions": torch.from_numpy(pos[:, :, :20])})
    lr, cr = R_prefill(jparams, jnp.asarray(toks[:, :20]), rcfg, 24,
                       positions=jnp.asarray(pos[:, :, :20]),
                       cache_dtype=jnp.float32)
    _close(lt, lr, 1e-4)
    for k in ("k", "v"):
        _close(ct["kv"][k], np.asarray(cr["kv"][k]), 1e-4)
    lt, ct = srv(model, ct, {"tokens": torch.from_numpy(toks[:, 20:]).long(),
                             "positions": torch.from_numpy(pos[:, :, 20:])})
    lr, cr = R_decode(jparams, cr, jnp.asarray(toks[:, 20:]), rcfg,
                      positions=jnp.asarray(pos[:, :, 20:]))
    _close(lt, lr, 1e-4)
    text, _ = T_models.prefill(model, torch.from_numpy(toks[:, :20]).long(),
                               tcfg, 24)
    assert not torch.allclose(text, pre(model, {
        "tokens": torch.from_numpy(toks[:, :20]).long(),
        "positions": torch.from_numpy(pos[:, :, :20])})[0], atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    _, tcfg = _cfgs(arch, kernel=True)
    rcfg, _ = _cfgs(arch)
    params = _reference(arch, "float32", seed=1)
    model = T_models.from_reference(params, tcfg, device="cpu")
    prompt = torch.from_numpy(_tokens(tcfg.vocab, 24, seed=16)).long()
    out = T_step.greedy_generate(model, tcfg, prompt, 6)
    ref = R_step.greedy_generate(jax.tree.map(jnp.asarray, params), rcfg,
                                 jnp.asarray(prompt.numpy()), 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_each_variant_on_cpu(arch, capsys):
    T_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "40", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 3 steps" in out


# --------------------------------------------------------------------------- #
# The registry
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", R_cfg.ARCH_IDS)
def test_configs_match_reference_but_for_the_kernel_knob(arch):
    """Field for field, CONFIG and SMOKE; the ported families' CONFIG turns
    the kernel on, everything else leaves it as the JAX package does."""
    for get in ("get_config", "get_smoke_config"):
        r = dataclasses.asdict(getattr(R_cfg, get)(arch))
        t = dataclasses.asdict(getattr(T_cfg, get)(arch))
        kr, kt = r.pop("use_flash_kernel"), t.pop("use_flash_kernel")
        assert r == t
        on = get == "get_config" and arch in PORTED
        assert (kr, kt) == (False, on)


def test_registry_cells_and_shapes_match_reference():
    assert T_cfg.ARCH_IDS == R_cfg.ARCH_IDS
    assert len(T_cfg.all_cells()) == 40
    assert [(a, dataclasses.asdict(s), ok) for a, s, ok in T_cfg.all_cells()] \
        == [(a, dataclasses.asdict(s), ok) for a, s, ok in R_cfg.all_cells()]
    assert [dataclasses.asdict(s) for s in T_cfg.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in R_cfg.ALL_SHAPES]
    assert set(T_cfg.SHAPES_BY_NAME) == set(R_cfg.SHAPES_BY_NAME)
    assert T_cfg.LONG_CONTEXT_ARCHS == R_cfg.LONG_CONTEXT_ARCHS
    assert sorted(T_cfg.__all__) == sorted(R_cfg.__all__)
    with pytest.raises(KeyError, match="unknown arch"):
        T_cfg.get_config("gemma3-27b")
    with pytest.raises(KeyError, match="unknown arch"):
        T_cfg.get_smoke_config("gemma3-27b")


@pytest.mark.parametrize("arch", R_cfg.ARCH_IDS)
def test_input_specs_match_reference(arch):
    for shape in R_cfg.ALL_SHAPES:
        want = R_cfg.input_specs(R_cfg.get_config(arch), shape)
        got = T_cfg.input_specs(T_cfg.get_config(arch),
                                T_cfg.SHAPES_BY_NAME[shape.name])
        assert set(got) == set(want)
        for k, (shp, dt) in got.items():
            assert shp == want[k].shape, (shape.name, k)
            assert str(dt).split(".")[-1] == want[k].dtype.name
    with pytest.raises(ValueError):
        T_cfg.input_specs(T_cfg.get_config(arch),
                            T_cfg.ShapeConfig("x", 8, 1, "score"))


def _flat_struct(tree, n_layers: int, n_enc_layers: int = 0) -> dict:
    """The JAX pytree of ShapeDtypeStructs under the port's parameter names
    (layer-stacked leaves split per layer: ``blocks`` and ``cross`` by
    ``n_layers``, ``enc_blocks`` by ``n_enc_layers``): name -> (shape,
    dtype name)."""
    stacked = {"blocks": n_layers, "cross": n_layers,
               "enc_blocks": n_enc_layers}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] in stacked:
            for i in range(stacked[keys[0]]):
                name = ".".join([keys[0], str(i)] + keys[1:])
                out[name] = (leaf.shape[1:], leaf.dtype.name)
        else:
            out[".".join(keys)] = (leaf.shape, leaf.dtype.name)
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_params_struct_matches_reference(arch):
    """The full config, abstractly on both sides (jax.eval_shape; the meta
    device): every parameter's name, shape and dtype."""
    rcfg, tcfg = R_cfg.get_config(arch), T_cfg.get_config(arch)
    want = _flat_struct(R_cfg.params_struct(rcfg), rcfg.n_layers,
                        rcfg.n_enc_layers)
    model = T_cfg.params_struct(tcfg)
    got = {k: (tuple(p.shape), str(p.dtype).split(".")[-1])
           for k, p in model.named_parameters()}
    assert got == want
    assert all(p.device.type == "meta" for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    want_n = {"gemma2-27b": 27_227_128_320, "olmoe-1b-7b": 6_919_096_320,
              "deepseek-moe-16b": 16_879_568_896,
              "zamba2-7b": 6_636_442_832,
              "whisper-large-v3": 1_534_809_600}
    if arch in want_n:
        assert n == want_n[arch]
    if tcfg.family == "hybrid":     # the 12-layer depth cut keeps 2 uses
        cut = T_cfg.params_struct(tcfg.replace(n_layers=12))
        assert sum(p.numel() for p in cut.parameters()) == 1_255_956_416
        assert got["shared.attn.wq"] == ((3584, 32, 112), "bfloat16")
    if tcfg.family == "moe":
        assert got["blocks.0.moe.router"][1] == "float32"
    if tcfg.family == "encdec":     # the 16 + 16 training cut
        cut = T_cfg.params_struct(tcfg.replace(n_layers=16, n_enc_layers=16))
        assert sum(p.numel() for p in cut.parameters()) == 800_601_600
        assert len(list(cut.parameters())) == 421
        assert got["cross.31.attn.wk"] == ((1280, 20, 64), "bfloat16")


@pytest.mark.parametrize("arch", PORTED)
def test_cache_struct_matches_reference(arch):
    for quant in (False, True):
        rcfg = R_cfg.get_config(arch).replace(kv_cache_quant=quant)
        tcfg = T_cfg.get_config(arch).replace(kv_cache_quant=quant)
        want = jax.tree_util.tree_flatten_with_path(
            R_cfg.cache_struct(rcfg, 8, 1056))[0]
        got = T_cfg.cache_struct(tcfg, 8, 1056)
        for path, leaf in want:
            keys = [p.key for p in path]
            if keys == ["index"]:
                assert got["index"] == 0
                continue
            t = functools.reduce(lambda d, k: d[k], keys, got)
            assert t.device.type == "meta"
            assert tuple(t.shape) == leaf.shape, keys
            assert str(t.dtype).split(".")[-1] == leaf.dtype.name, keys


def test_every_family_of_the_registry_is_ported():
    """Nothing is left unported: every arch's family builds, caches and
    serves (whisper-large-v3, the last, since the encdec family)."""
    assert set(PORTED) == set(R_cfg.ARCH_IDS)
    assert {T_cfg.get_config(a).family for a in R_cfg.ARCH_IDS} == set(
        T_model.FAMILIES)
    arch = "whisper-large-v3"
    cfg = T_cfg.get_smoke_config(arch)
    assert isinstance(T_models.init_params(0, cfg, device="cpu"),
                      T_models.EncDecLM)
    assert T_models.init_cache(cfg, 1, 8, device="cpu")["index"] == 0
    assert isinstance(T_cfg.params_struct(T_cfg.get_config(arch)),
                      T_models.EncDecLM)
    assert T_cfg.cache_struct(T_cfg.get_config(arch), 1, 8)[
        "cross_k"].device.type == "meta"
    T_launch.main(["--arch", arch, "--smoke", "--device", "cpu"])


# --------------------------------------------------------------------------- #
# Seeded draws
# --------------------------------------------------------------------------- #

def test_seeded_draws_are_the_cpu_draws_bit_for_bit():
    """The in-place draw equals the out-of-place inverse-CDF formula bit
    for bit on the CPU; a seed, a CPU generator and a generator made for
    the "cpu" device give the same model."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    for dtype in (torch.float32, torch.bfloat16):
        u = lo + (1.0 - 2.0 * lo) * torch.rand(
            (300, 7), generator=torch.Generator().manual_seed(3),
            dtype=torch.float32)
        x = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0)
        want = (x * 0.02).to(dtype)
        got = T_layers.truncated_normal_init(
            torch.Generator().manual_seed(3), (300, 7), 0.02, dtype)
        assert got.device.type == "cpu"
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))
    cfg = T_cfg.get_smoke_config("gemma2-27b")
    a = T_models.init_params(0, cfg, device="cpu")
    for gen in (torch.Generator().manual_seed(0),
                torch.Generator(device="cpu").manual_seed(0)):
        b = T_models.init_params(gen, cfg, device="cpu")
        for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(p, q), n
    names = [n for n, _ in a.named_parameters()]
    assert names[0] == "embed.tok"
    assert "blocks.3.post_mlp_norm.scale" in names
