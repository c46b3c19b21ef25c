"""The port's dense serving slice (olmo) against the JAX package, on the CPU.

The olmo SMOKE config (2 layers, d_model 64, 4 heads of 16, the
non-parametric LayerNorm, SiLU-gated MLP, tied embeddings) with the JAX
package's ``init_params`` carried across by ``from_reference``:

* the layers one by one: ``apply_norm``, ``apply_rope``,
  ``multi_head_attention`` without and with a cache (a prefill at 0 and
  one behind earlier tokens), ``apply_mlp`` for each activation;
* ``forward`` without a cache; ``prefill`` of a 24- and a 40-token prompt
  and 8 teacher-forced ``decode_step``s, logits and KV cache;
  ``greedy_generate`` against the JAX package's greedy loop;
* a GQA variant (kv 2 of 4 heads) with gemma2's attention softcap and an
  alternating sliding window, end to end.

Each with ``use_flash_kernel`` on (the port's prefill attention through
``kernels.ops.flash_attention``, on CPU tensors its plain version) and off
(``_attention_core``); the JAX package's dense stack never reads the knob.
Tolerances: float32 parameters and compute at 1e-4; bfloat16 at 5e-2
(``tests/test_models_smoke.py``'s), because XLA and torch round bfloat16
intermediates at different places.  Inputs come from
``np.random.default_rng``.
"""
import dataclasses
import functools
from unittest import mock

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
from repro_torch.kernels import flash_attention as TK
from repro_torch.kernels import ops as T_ops
from repro_torch.launch import serve as T_launch
from repro_torch.launch import train as T_launch_train
from repro_torch.models import layers as T_layers
from repro_torch.models import model as T_model
from repro_torch.serve import step as T_step
from repro_torch.train import step as T_train

ARCH = "olmo-1b"
BATCH, N_DECODE = 2, 8
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
# The KV cache in the compute dtype: a float32 model with a bfloat16 cache
# turns float32 noise into whole bfloat16 steps where a K or V value lies
# at a rounding boundary (one step moved a float32 attention output by
# 1.3e-4 here, on both routes alike).
CACHE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# GQA, attention softcap, alternating local/global layers with a window
# narrower than the prompts (gemma2's options, at SMOKE size)
GQA = dict(attention=R_cfg.AttentionConfig(
    n_heads=4, n_kv_heads=2, head_dim=16, rope=R_cfg.RopeConfig(),
    softcap=50.0, sliding_window=8, pattern="alternating"))


def _cfgs(dtype: str = "float32", kernel: bool = False, **change):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **change)
    rcfg = R_cfg.get_smoke_config(ARCH).replace(**kw)
    if "attention" in kw:
        kw["attention"] = T_cfg.AttentionConfig(**{
            **dataclasses.asdict(kw["attention"]),
            "rope": T_cfg.RopeConfig(**dataclasses.asdict(
                kw["attention"].rope))})
    tcfg = T_cfg.get_smoke_config(ARCH).replace(use_flash_kernel=kernel,
                                                **kw)
    return rcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _reference(dtype: str, seed: int, gqa: bool = False):
    """The JAX parameters (numpy) of the config."""
    rcfg, _ = _cfgs(dtype, **(GQA if gqa else {}))
    return _np_tree(R_models.init_params(jax.random.key(seed), rcfg))


def _layer0(params_np, part):
    return {k: v[0] for k, v in params_np["blocks"][part].items()}


def _torch(tree):
    return {k: T_model._tensor(np.asarray(v)) for k, v in tree.items()}


def _x(shape, dtype: str, seed: int):
    """(jax array, torch tensor) of standard normals in ``dtype``."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32), getattr(jnp, dtype))
    return a, T_model._tensor(np.asarray(a))


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonparametric_norm_matches_reference(dtype):
    rcfg, tcfg = _cfgs(dtype)
    assert T_layers.init_norm(None, tcfg, 64) == {}
    jx, tx = _x((2, 5, 64), dtype, 0)
    jx, tx = jx * 3 + 1, tx * 3 + 1
    got = T_layers.apply_norm({}, tx, tcfg)
    assert got.dtype == tx.dtype
    _close(got, R_layers.apply_norm({}, jx, rcfg), TOLS[dtype])


@pytest.mark.parametrize("offset", [0, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype, offset):
    """Interleaved pairs, float32 angles, at positions from 0 and behind
    earlier tokens."""
    jx, tx = _x((2, 4, 12, 16), dtype, 1)
    pos = np.arange(12)[None, :] + offset
    got = T_layers.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    _close(got, R_layers.apply_rope(jx, jnp.asarray(pos), 10000.0),
           TOLS[dtype])


@pytest.mark.parametrize("act", ["silu_gated", "gelu_gated", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(dtype, act):
    rcfg, tcfg = _cfgs(dtype, act=act)
    p = R_layers.init_mlp(jax.random.key(3), rcfg)
    jx, tx = _x((2, 5, 64), dtype, 2)
    got = T_layers.apply_mlp(_torch(_np_tree(p)), tx, tcfg)
    _close(got, R_layers.apply_mlp(p, jx, rcfg), TOLS[dtype])


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_reference(dtype, kernel, gqa):
    """Without a cache, then into a fresh cache at 0 (a prefill: the
    kernel's route with the knob on), then 3 tokens behind them (the plain
    route either way).  The port writes the cache in place."""
    change = GQA if gqa else {}
    rcfg, tcfg = _cfgs(dtype, kernel, **change)
    params = _reference(dtype, 4, gqa)
    jp, tp = _layer0(params, "attn"), _torch(_layer0(params, "attn"))
    jx, tx = _x((BATCH, 20, 64), dtype, 5)
    a = rcfg.attention
    pos = np.arange(20)[None, :]
    for local in (False, True) if gqa else (False,):
        got, none = T_layers.multi_head_attention(
            tp, tx, tcfg, positions=torch.from_numpy(pos),
            layer_is_local=local)
        want, _ = R_layers.multi_head_attention(
            jp, jx, rcfg, positions=jnp.asarray(pos), layer_is_local=local)
        assert none is None
        _close(got, want, TOLS[dtype])

    shape = (BATCH, a.n_kv_heads, 32, a.head_dim)
    jc = {"k": jnp.zeros(shape, getattr(jnp, dtype)),
          "v": jnp.zeros(shape, getattr(jnp, dtype))}
    tc = {"k": torch.zeros(shape, dtype=CACHE[dtype]),
          "v": torch.zeros(shape, dtype=CACHE[dtype])}
    got, tc2 = T_layers.multi_head_attention(
        tp, tx, tcfg, positions=torch.from_numpy(pos), cache=tc,
        cache_index=0)
    want, jc = R_layers.multi_head_attention(
        jp, jx, rcfg, positions=jnp.asarray(pos), cache=jc, cache_index=0)
    assert tc2 is tc
    _close(got, want, TOLS[dtype])
    for k in ("k", "v"):
        _close(tc[k], jc[k], TOLS[dtype])
    jy, ty = _x((BATCH, 3, 64), dtype, 6)
    pos = np.arange(20, 23)[None, :]
    got, _ = T_layers.multi_head_attention(
        tp, ty, tcfg, positions=torch.from_numpy(pos), cache=tc,
        cache_index=20)
    want, jc = R_layers.multi_head_attention(
        jp, jy, rcfg, positions=jnp.asarray(pos), cache=jc, cache_index=20)
    _close(got, want, TOLS[dtype])
    for k in ("k", "v"):
        _close(tc[k], jc[k], TOLS[dtype])


def test_flash_route():
    """The knob routes a prefill at 0 and a forward without a cache
    through ops.flash_attention (one call per layer, on the prompt's own
    K and V); decode, a prefill behind earlier tokens and the knob off run
    _attention_core; so does a layer whose sliding window is narrower
    than the prompt."""
    _, tcfg = _cfgs("float32", True)
    model = T_models.init_params(0, tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab, (BATCH, 24)))
    L = tcfg.n_layers
    before = TK.LAUNCHES
    with mock.patch.object(T_ops, "flash_attention",
                           wraps=T_ops.flash_attention) as fa:
        _, cache = T_models.prefill(model, toks, tcfg, 40)
        assert fa.call_count == L
        q, k, v = fa.call_args.args
        a = tcfg.attention
        assert tuple(q.shape) == (BATCH * a.n_kv_heads,
                                  a.n_heads // a.n_kv_heads, 24, a.head_dim)
        assert tuple(k.shape) == tuple(v.shape) == (BATCH * a.n_kv_heads, 24,
                                                    a.head_dim)
        T_models.decode_step(model, cache, toks[:, :1], tcfg)
        T_models.forward(model, {"tokens": toks[:, :8]}, tcfg, cache=cache)
        assert fa.call_count == L
        T_models.forward(model, {"tokens": toks}, tcfg)
        assert fa.call_count == 2 * L
        T_models.prefill(model, toks, tcfg.replace(use_flash_kernel=False),
                         40)
        assert fa.call_count == 2 * L
        _, gcfg = _cfgs("float32", True, **GQA)
        gmodel = T_models.init_params(0, gcfg, device="cpu")
        T_models.prefill(gmodel, toks, gcfg, 40)    # layer 0 local, window 8
        assert fa.call_count == 2 * L + 1
        T_models.prefill(gmodel, toks[:, :8], gcfg, 40)   # window >= prompt
        assert fa.call_count == 2 * L + 3
    assert TK.LAUNCHES == before          # CPU tensors: no kernel launch


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_without_cache_matches_reference(dtype, kernel):
    rcfg, tcfg = _cfgs(dtype, kernel)
    params = _reference(dtype, 2)
    model = T_models.from_reference(params, tcfg, device="cpu")
    toks = np.random.default_rng(13).integers(0, tcfg.vocab, (BATCH, 24))
    lt, cache, _ = T_models.forward(model, {"tokens": torch.from_numpy(toks)},
                                    tcfg)
    lr, _, _ = R_models.forward(jax.tree.map(jnp.asarray, params),
                                {"tokens": jnp.asarray(toks)}, rcfg)
    assert cache is None and lt.dtype == torch.float32
    _close(lt, lr, TOLS[dtype])


@pytest.mark.parametrize("dtype,kernel,prompt,gqa", [
    ("float32", True, 24, False), ("float32", False, 24, False),
    ("bfloat16", True, 24, False), ("bfloat16", False, 24, False),
    ("float32", True, 40, False), ("bfloat16", True, 40, False),
    ("float32", True, 40, True), ("float32", False, 40, True),
])
def test_prefill_and_decode_match_reference(dtype, kernel, prompt, gqa):
    rcfg, tcfg = _cfgs(dtype, kernel, **(GQA if gqa else {}))
    params = _reference(dtype, 0, gqa)
    jparams = jax.tree.map(jnp.asarray, params)
    model = T_models.from_reference(params, tcfg, device="cpu")
    toks = np.random.default_rng(11).integers(
        0, rcfg.vocab, (BATCH, prompt + N_DECODE), dtype=np.int32)
    max_seq = prompt + N_DECODE
    tol = TOLS[dtype]
    lt, ct = T_models.prefill(model, torch.from_numpy(toks[:, :prompt]).long(),
                              tcfg, max_seq, cache_dtype=CACHE[dtype])
    lr, cr = R_models.prefill(jparams, jnp.asarray(toks[:, :prompt]), rcfg,
                              max_seq, cache_dtype=getattr(jnp, dtype))
    assert tuple(lt.shape) == (BATCH, 1, rcfg.vocab)
    assert ct["index"] == int(cr["index"]) == prompt
    _close(lt, lr, tol)
    for k in ("k", "v"):
        assert ct["kv"][k].dtype == CACHE[dtype]
        assert tuple(ct["kv"][k].shape) == cr["kv"][k].shape
        _close(ct["kv"][k], cr["kv"][k], tol)
    for i in range(N_DECODE):
        tok = toks[:, prompt + i: prompt + i + 1]
        lt, ct = T_models.decode_step(model, ct, torch.from_numpy(tok).long(),
                                      tcfg)
        lr, cr = R_models.decode_step(jparams, cr, jnp.asarray(tok), rcfg)
        _close(lt, lr, tol)
    for k in ("k", "v"):
        _close(ct["kv"][k], cr["kv"][k], tol)
    assert ct["index"] == prompt + N_DECODE


@pytest.mark.parametrize("kernel", [True, False])
def test_serve_steps_and_greedy_match_reference(kernel):
    rcfg, tcfg = _cfgs("float32", kernel)
    params = _reference("float32", 1)
    model = T_models.from_reference(params, tcfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab, (BATCH, 24))).long()
    pre = T_step.make_prefill_step(tcfg, max_seq=32)
    srv = T_step.make_serve_step(tcfg)
    l1, c1 = pre(model, {"tokens": prompt})
    l2, c2 = T_models.prefill(model, prompt, tcfg, 32)
    assert torch.equal(l1, l2)
    tok = l1[:, -1].argmax(-1)[:, None]
    d1, _ = srv(model, c1, {"tokens": tok})
    d2, _ = T_models.decode_step(model, c2, tok, tcfg)
    assert torch.equal(d1, d2)
    out = T_step.greedy_generate(model, tcfg, prompt, 6)
    assert tuple(out.shape) == (BATCH, 6)
    assert torch.equal(out[:, :2], torch.cat([tok, d1[:, -1:].argmax(-1)],
                                             dim=1))
    ref = R_step.greedy_generate(jax.tree.map(jnp.asarray, params), rcfg,
                                 jnp.asarray(prompt.numpy()), 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_from_reference_full_config_shapes_and_dtypes():
    """The full olmo-1b pytree, built abstractly (no weights allocated),
    lands on the port's parameters name for name, shape for shape and
    dtype for dtype; the non-parametric norms carry no leaves."""
    rcfg = R_cfg.get_config(ARCH)
    tcfg = T_cfg.get_config(ARCH)
    abstract = jax.eval_shape(lambda k: R_models.init_params(k, rcfg),
                              jax.random.key(0))
    zeros = jax.tree.map(
        lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), abstract)
    model = T_models.from_reference(zeros, tcfg, device="meta")
    assert isinstance(model, T_models.DenseLM)
    got = dict(model.named_parameters())
    flat = T_model.reference_state(zeros, tcfg)
    assert set(got) == set(flat)
    assert len(got) == 1 + 7 * rcfg.n_layers
    assert "blocks.0.attn.wq" in got and "blocks.15.mlp.w_gate" in got
    for k, a in flat.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype).split(".")[-1] == a.dtype.name, k
        assert got[k].device.type == "meta"
    n = sum(p.numel() for p in got.values())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(abstract))
    assert n == 1_176_764_416
    own = T_models.init_params(0, T_cfg.get_smoke_config(ARCH), device="cpu")
    ref = T_model.reference_state(_reference("bfloat16", 0),
                                  T_cfg.get_smoke_config(ARCH))
    assert set(dict(own.named_parameters())) == set(ref)
    for k, p in own.named_parameters():
        assert tuple(p.shape) == ref[k].shape, k
        assert str(p.dtype).split(".")[-1] == ref[k].dtype.name, k


def test_configs_match_reference_but_for_the_kernel_knob():
    for get in ("get_config", "get_smoke_config"):
        r = dataclasses.asdict(getattr(R_cfg, get)(ARCH))
        t = dataclasses.asdict(getattr(T_cfg, get)(ARCH))
        kr, kt = r.pop("use_flash_kernel"), t.pop("use_flash_kernel")
        assert r == t
        assert (kr, kt) == ((False, True) if get == "get_config"
                            else (False, False))
    assert dataclasses.asdict(T_cfg.AttentionConfig()) == \
        dataclasses.asdict(R_cfg.AttentionConfig())
    assert dataclasses.asdict(T_cfg.RopeConfig()) == \
        dataclasses.asdict(R_cfg.RopeConfig())
    assert ARCH in T_cfg.ARCH_IDS


def test_embedding_scaling_follows_the_norm():
    """sqrt(d_model) scales tied embeddings under an rmsnorm (mamba2), not
    under olmo's non-parametric LayerNorm."""
    toks = torch.tensor([[1, 2, 3]])
    for arch, scaled in ((ARCH, False), ("mamba2-130m", True)):
        cfg = T_cfg.get_smoke_config(arch).replace(param_dtype="float32",
                                                   compute_dtype="float32")
        tok = torch.randn(cfg.vocab, cfg.d_model,
                          generator=torch.Generator().manual_seed(0))
        got = T_layers.embed_tokens({"tok": tok}, toks, cfg)
        want = tok[toks] * (cfg.d_model ** 0.5 if scaled else 1.0)
        torch.testing.assert_close(got, want)
        rcfg = R_cfg.get_smoke_config(arch).replace(param_dtype="float32",
                                                    compute_dtype="float32")
        _close(got, R_layers.embed_tokens({"tok": jnp.asarray(tok.numpy())},
                                          jnp.asarray(toks.numpy()), rcfg),
               1e-6)


# The encdec family, once refused here, builds from a dense config: the
# case keeps its id (the layer options the list once held are ported and
# held to the JAX package in tests/test_torch_variants.py, the moe family
# in tests/test_torch_moe.py, the hybrid family in
# tests/test_torch_hybrid.py, the encdec family in
# tests/test_torch_encdec.py).
@pytest.mark.parametrize("change", [
    pytest.param(dict(family="encdec", n_enc_layers=2, enc_seq=16),
                 id="change10"),
])
def test_encdec_family_builds_from_the_dense_config(change):
    cfg = T_cfg.get_smoke_config(ARCH).replace(**change)
    model = T_models.init_params(0, cfg, device="cpu")
    assert isinstance(model, T_models.EncDecLM)
    assert len(model.enc_blocks) == 2 and len(model.cross) == cfg.n_layers
    cache = T_models.init_cache(cfg, 1, 8, device="cpu")
    a = cfg.attention
    assert tuple(cache["cross_k"].shape) == (cfg.n_layers, 1, a.n_kv_heads,
                                             16, a.head_dim)
    assert tuple(cache["kv"]["k"].shape) == (cfg.n_layers, 1, a.n_kv_heads,
                                             8, a.head_dim)


@pytest.mark.parametrize("family", ["encdec"])
def test_training_takes_the_encdec_family(family):
    cfg = T_cfg.get_smoke_config(ARCH).replace(family=family, n_enc_layers=1,
                                               enc_seq=8)
    state = T_train.init_train_state(0, cfg, device="cpu")
    assert isinstance(state.params, T_models.EncDecLM)
    T_train.require_trainable(cfg)
    assert set(state.opt.master) == {k for k, _
                                     in state.params.named_parameters()}


def test_dense_training_refuses_the_flash_kernel(capsys):
    cfg = T_cfg.get_smoke_config(ARCH).replace(use_flash_kernel=True)
    with pytest.raises(ValueError, match="flash-attention kernel has no "
                                         "backward"):
        T_train.require_trainable(cfg)
    # the entry point trains the serving CONFIG with the knob off, says so
    assert not T_launch_train.training_config(
        T_cfg.get_config(ARCH)).use_flash_kernel
    assert "flash-attention kernel has no backward" in capsys.readouterr().out
    # the encdec arch needs frames, which SyntheticLM does not make
    with pytest.raises(ValueError, match="needs batch\\['frames'\\]"):
        T_launch_train.main(["--arch", "whisper-large-v3", "--smoke",
                             "--device", "cpu", "--steps", "1"])


def test_launch_serve_runs_olmo_on_cpu(capsys):
    T_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "24", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 3 steps" in out
