"""The port's encdec family (whisper) against the JAX package, on the CPU.

whisper-large-v3's SMOKE config (2 encoder and 2 decoder layers, d_model
64, 16 frames) with the JAX package's ``init_params`` (or
``init_train_state``) carried across:

* ``from_reference`` of every leaf (the layer-stacked ``enc_blocks`` and
  ``cross`` subtrees split per layer, ``enc_norm``) and
  ``train.step.from_reference`` of a JAX ``TrainState``, bit for bit;
* ``forward`` without a cache and ``loss_fn``: float32 at 1e-4, bfloat16
  at 5e-2 (``tests/test_models_smoke.py``'s bound), with the kernel knob
  off and on (on the CPU the knob runs the kernel's plain version);
* ``prefill`` with the frames and 8 teacher-forced ``decode_step``s
  against the JAX package's (jitted, as its entry point runs them) at 8-
  and 13-token prompts: logits, the self-attention K/V and the cached
  cross K/V; a 1-token prompt against the port's own forward (the JAX
  prefill of a 1-token prompt takes its decode branch and raises: ROADMAP
  Queue 3);
* the gradients against ``jax.value_and_grad``; ``remat`` "full" and
  "dots" give the gradients of "none", and "dots" saves the projections
  (the cross K/V's among them) and no score product; three
  ``make_train_step`` steps in 2 microbatches against the JAX package's,
  by ``tests/test_torch_train.py``'s rule;
* the flash route: a prefill calls the kernel's wrapper once an encoder
  layer (``causal=False``), and once a decoder layer for the
  self-attention (causal) and for the cross-attention (``causal=False``);
  decode calls it never;
* the entry points ``launch.serve``, ``launch.serve_example`` and
  ``launch.quickstart`` on the CPU, and ``launch.train``'s refusal.

Inputs are made with ``np.random.default_rng`` and reach both sides as the
same numbers.  Each JAX function is jitted once a module and the shapes
are SMOKE's, so the file stays short on the CPU.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R_cfg
import repro.models as R_models
from repro.data import synthetic as R_data
from repro.models import model as R_model
from repro.train import optimizer as R_opt
from repro.train import schedule as R_sched
from repro.train import step as R_step
import repro_torch.configs as T_cfg
import repro_torch.models as T_models
from repro_torch.kernels import ops as T_ops
from repro_torch.launch import quickstart as T_quickstart
from repro_torch.launch import serve as T_launch
from repro_torch.launch import serve_example as T_serve_example
from repro_torch.launch import train as T_launch_train
from repro_torch.models import model as T_model
from repro_torch.serve import step as T_serve
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

ARCH = "whisper-large-v3"
BATCH, N_DECODE, SEQ = 2, 8, 24
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
# tests/test_torch_train.py's Adam rule: elements whose gradient is at
# Adam's eps scale are held to 0.05 lr a step, and must stay under 2% of
# the parameters
ADAM_TINY_GRAD, ADAM_TINY_STEP, ADAM_TINY_SHARE = 1e-6, 0.05, 2e-2
LR, WD, N_STEPS = 1e-3, 0.1, 3

R_prefill = jax.jit(R_models.prefill, static_argnums=(2, 3),
                    static_argnames=("cache_dtype",))
R_decode = jax.jit(R_models.decode_step, static_argnums=(3,))
R_forward = jax.jit(R_model.forward, static_argnums=(2,))
R_loss = jax.jit(R_model.loss_fn, static_argnums=(2,))
_R_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(R_model.loss_fn, has_aux=True),
                            static_argnums=2)


def _cfgs(dtype: str = "float32", kernel: bool = False, **kw):
    """(JAX, port) SMOKE configs; the knob only on the port's side (the
    JAX package's encdec path never reads it)."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **kw)
    return (R_cfg.get_smoke_config(ARCH).replace(**kw),
            T_cfg.get_smoke_config(ARCH).replace(use_flash_kernel=kernel,
                                                 **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, tol: float, msg: str = "") -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _reference(dtype: str):
    """The JAX parameters (numpy) of the SMOKE config."""
    rcfg, _ = _cfgs(dtype)
    return _np_tree(R_models.init_params(jax.random.key(0), rcfg))


def _model(dtype: str, tcfg):
    return T_models.from_reference(_reference(dtype), tcfg, device="cpu")


def _frames(cfg, b: int = BATCH, seed: int = 21) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _tokens(vocab: int, n: int, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, n),
                                                dtype=np.int32)


def _batch(cfg, b: int = BATCH, s: int = SEQ, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                  # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels,
            "frames": _frames(cfg, b, seed + 100)}


def _torch_batch(batch):
    return T_step._to_device(batch, "cpu")


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _value_and_grad_ref(params, batch, rcfg):
    (loss, _), grads = _R_VALUE_AND_GRAD(params, _jax_batch(batch), rcfg)
    return float(loss), T_model.reference_state(_np_tree(grads), rcfg)


def _state(tcfg):
    params = _reference("float32")
    return T_step.from_reference((params, R_opt.init_adamw(params)), tcfg,
                                 device="cpu")


CACHE_PARTS = (("kv", "k"), ("kv", "v"), ("cross_k", None),
               ("cross_v", None))


def _part(cache, part, k):
    return cache[part] if k is None else cache[part][k]


@functools.lru_cache(maxsize=None)
def _reference_serve(dtype: str, prompt: int):
    """The JAX package's prefill with the frames and N_DECODE
    teacher-forced decode steps (jitted): the logits of each and the
    caches after the prefill and after the last step."""
    rcfg, _ = _cfgs(dtype)
    params = jax.tree.map(jnp.asarray, _reference(dtype))
    toks = _tokens(rcfg.vocab, prompt + N_DECODE)
    logits, cache = R_prefill(params, jnp.asarray(toks[:, :prompt]), rcfg,
                              prompt + N_DECODE,
                              frames=jnp.asarray(_frames(rcfg)),
                              cache_dtype=getattr(jnp, dtype))

    def parts(c):
        return {(p, k): np.asarray(_part(c, p, k)) for p, k in CACHE_PARTS}

    first, out = parts(cache), [np.asarray(logits)]
    for i in range(N_DECODE):
        logits, cache = R_decode(params, cache,
                                 jnp.asarray(toks[:, prompt + i:][:, :1]),
                                 rcfg)
        out.append(np.asarray(logits))
    return out, first, parts(cache)


def _serve(model, tcfg, toks: np.ndarray, prompt: int, dtype: str):
    """The port's prefill and N_DECODE teacher-forced decode steps: the
    logits of each and the caches after the prefill and after the last
    step (the port writes its caches in place)."""
    t = torch.from_numpy(toks).long()
    logits, cache = T_models.prefill(
        model, t[:, :prompt], tcfg, prompt + N_DECODE,
        frames=torch.from_numpy(_frames(tcfg)),
        cache_dtype=getattr(torch, dtype))
    first = {(p, k): _part(cache, p, k).clone() for p, k in CACHE_PARTS}
    out = [logits]
    for i in range(N_DECODE):
        logits, cache = T_models.decode_step(
            model, cache, t[:, prompt + i:prompt + i + 1], tcfg)
        out.append(logits)
    assert cache["index"] == prompt + N_DECODE
    return out, first, {(p, k): _part(cache, p, k) for p, k in CACHE_PARTS}


# --------------------------------------------------------------------------- #
# Parameters and the train state
# --------------------------------------------------------------------------- #

def test_from_reference_carries_every_leaf_and_the_train_state():
    rcfg, tcfg = _cfgs("bfloat16")
    params = _reference("bfloat16")
    rstate = (params, _np_tree(R_opt.init_adamw(jax.tree.map(jnp.asarray,
                                                             params))))
    st = T_step.from_reference(rstate, tcfg, device="cpu")
    assert isinstance(st.params, T_model.EncDecLM)
    want = T_model.reference_state(rstate[0], rcfg)
    names = [k for k, _ in st.params.named_parameters()]
    assert set(names) == set(want)
    # embed, enc_norm and final_norm (LayerNorm: scale and bias); 10
    # leaves a dense block (2 norms of 2, 4 projections, 2 MLP), 6 a
    # cross block
    L, E = rcfg.n_layers, rcfg.n_enc_layers
    assert len(names) == 1 + 2 + 2 + 10 * E + 10 * L + 6 * L
    assert {k for k in names if k.startswith("cross.0.")} == {
        f"cross.0.{k}" for k in ("norm.scale", "norm.bias", "attn.wq",
                                 "attn.wk", "attn.wv", "attn.wo")}
    assert {k for k in names if k.startswith("enc_norm.")} == {
        "enc_norm.scale", "enc_norm.bias"}
    assert f"enc_blocks.{E - 1}.mlp.w_up" in names
    for k, p in st.params.named_parameters():
        w = np.asarray(want[k])
        assert p.requires_grad and tuple(p.shape) == w.shape, k
        assert p.dtype == torch.bfloat16, k
        assert np.array_equal(p.detach().view(torch.int16).numpy(),
                              w.view(np.int16)), k
    # a stacked leaf lands in the right layer
    np.testing.assert_array_equal(
        st.params.cross[1].attn["wk"].detach().view(torch.int16).numpy(),
        params["cross"]["attn"]["wk"][1].view(np.int16))
    for part in ("master", "m", "v"):
        ref = T_model.reference_state(getattr(rstate[1], part), rcfg)
        for k, t in getattr(st.opt, part).items():
            assert np.array_equal(t.numpy(), ref[k]), (part, k)
    twin = st.clone()
    assert isinstance(twin.params, T_model.EncDecLM)
    assert twin.tree().keys() == st.tree().keys()
    fresh = T_step.init_train_state(0, tcfg, device="cpu")
    assert fresh.tree().keys() == st.tree().keys()


def test_encdec_with_post_block_norms_is_refused():
    """The JAX package's encoder and decoder layers apply no post-block
    norms, so the port refuses an encdec config that asks for them."""
    _, tcfg = _cfgs(post_block_norm=True)
    with pytest.raises(ValueError, match="post-block norms"):
        T_models.init_params(0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="post-block norms"):
        T_models.init_cache(tcfg, 1, 8, device="cpu")


# --------------------------------------------------------------------------- #
# forward and loss_fn
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype, kernel):
    rcfg, tcfg = _cfgs(dtype, kernel)
    batch = _batch(rcfg, seed=1)
    params = jax.tree.map(jnp.asarray, _reference(dtype))
    want, _, _ = R_forward(params, {k: jnp.asarray(batch[k])
                                    for k in ("tokens", "frames")}, rcfg)
    loss_r, _ = R_loss(params, _jax_batch(batch), rcfg)
    model = _model(dtype, tcfg)
    tb = _torch_batch(batch)
    with torch.no_grad():
        got, cache, aux = T_models.forward(
            model, {k: tb[k] for k in ("tokens", "frames")}, tcfg)
        loss, m = T_models.loss_fn(model, tb, tcfg)
    assert cache is None and aux == {} and got.dtype == torch.float32
    _close(got, want, TOLS[dtype])
    assert float(m["ce"]) == float(loss)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=TOLS[dtype],
                               atol=TOLS[dtype])
    with pytest.raises(ValueError, match="needs batch\\['frames'\\]"):
        T_models.forward(model, {"tokens": tb["tokens"]}, tcfg)


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype,prompt,kernel", [
    ("float32", 8, False), ("float32", 8, True), ("float32", 13, False),
    ("float32", 13, True), ("bfloat16", 13, True)])
def test_prefill_and_decode_match_reference(dtype, prompt, kernel):
    """Logits of the prefill and of each decode step, and the caches after
    the prefill and after the last step: the self-attention K/V of every
    decoder layer and the cross K/V, written once by the prefill."""
    rcfg, tcfg = _cfgs(dtype, kernel)
    want, first_r, last_r = _reference_serve(dtype, prompt)
    toks = _tokens(rcfg.vocab, prompt + N_DECODE)
    got, first, last = _serve(_model(dtype, tcfg), tcfg, toks, prompt, dtype)
    tol = TOLS[dtype]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, tol, f"logits of call {i}")
    for tag, mine, ref in (("prefill", first, first_r),
                           ("last step", last, last_r)):
        for key in mine:
            assert tuple(mine[key].shape) == ref[key].shape, key
            _close(mine[key], ref[key], tol, f"{tag} {key}")
    assert last[("cross_k", None)].dtype == getattr(torch, dtype)
    assert tuple(last[("cross_k", None)].shape) == (
        rcfg.n_layers, BATCH, rcfg.attention.n_kv_heads, rcfg.enc_seq,
        rcfg.attention.head_dim)
    # decode reads the cross K/V and never writes them
    for key in (("cross_k", None), ("cross_v", None)):
        assert torch.equal(first[key], last[key])


@pytest.mark.parametrize("prompt", [1, 8])
def test_prefill_and_decode_match_own_forward(prompt):
    """The serving path (kernel knob on: the plain version on the CPU)
    against the port's forward over the whole sequence, float32.  A
    1-token prompt (whisper's start-of-transcript) is a prefill because
    the frames are given; the JAX package's prefill of one token takes its
    decode branch and raises, so it is held to the port's own forward."""
    _, tcfg = _cfgs("float32", True)
    model = _model("float32", tcfg)
    toks = _tokens(tcfg.vocab, prompt + N_DECODE, seed=5)
    got, _, _ = _serve(model, tcfg, toks, prompt, "float32")
    with torch.no_grad():
        full, _, _ = T_models.forward(
            model, {"tokens": torch.from_numpy(toks).long(),
                    "frames": torch.from_numpy(_frames(tcfg))}, tcfg)
    for i, g in enumerate(got):
        torch.testing.assert_close(g[:, -1], full[:, prompt - 1 + i],
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="needs frames"):
        T_models.prefill(model, torch.from_numpy(toks[:, :prompt]).long(),
                         tcfg, 16)


def test_greedy_generate_and_the_step_factories_take_frames():
    _, tcfg = _cfgs("float32", True)
    model = _model("float32", tcfg)
    toks = torch.from_numpy(_tokens(tcfg.vocab, 8)).long()
    frames = torch.from_numpy(_frames(tcfg))
    out = T_serve.greedy_generate(model, tcfg, toks, 5, frames=frames)
    assert tuple(out.shape) == (BATCH, 5)
    pre = T_serve.make_prefill_step(tcfg, max_seq=13)
    srv = T_serve.make_serve_step(tcfg)
    logits, cache = pre(model, {"tokens": toks, "frames": frames})
    want = [logits[:, -1].argmax(-1)]
    for _ in range(4):
        logits, cache = srv(model, cache, {"tokens": want[-1][:, None]})
        want.append(logits[:, -1].argmax(-1))
    assert torch.equal(out, torch.stack(want, dim=1))


def test_serving_routes_the_flash_wrapper_per_attention():
    """With the knob on a prefill calls the flash wrapper once an encoder
    layer (unmasked, over the frames), and once a decoder layer for the
    self-attention (causal, over the prompt) and for the cross-attention
    (unmasked, the prompt's queries over the frames); decode calls it
    never.  Without the knob, never."""
    _, tcfg = _cfgs("float32", True)
    model = _model("float32", tcfg)
    toks = torch.from_numpy(_tokens(tcfg.vocab, 9)).long()
    frames = torch.from_numpy(_frames(tcfg))
    a, E, L = tcfg.attention, tcfg.n_enc_layers, tcfg.n_layers
    G, R, hd = a.n_kv_heads, a.n_heads // a.n_kv_heads, a.head_dim
    T, S = tcfg.enc_seq, 8
    enc = ((BATCH * G, R, T, hd), (BATCH * G, T, hd), False)
    self_ = ((BATCH * G, R, S, hd), (BATCH * G, S, hd), True)
    cross = ((BATCH * G, R, S, hd), (BATCH * G, T, hd), False)
    for knob, want in ((True, [enc] * E + [self_, cross] * L), (False, [])):
        cfg = tcfg.replace(use_flash_kernel=knob)
        with mock.patch.object(T_ops, "flash_attention",
                               wraps=T_ops.flash_attention) as fa:
            _, cache = T_models.prefill(model, toks[:, :S], cfg, 12,
                                        frames=frames)
            got = [(tuple(c.args[0].shape), tuple(c.args[1].shape),
                    c.kwargs["causal"]) for c in fa.call_args_list]
            assert got == want
            assert all(c.kwargs["scale"] == hd ** -0.5
                       for c in fa.call_args_list)
            T_models.decode_step(model, cache, toks[:, S:], cfg)
            assert fa.call_count == len(want)


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #

def _assert_grads_close(grads, want):
    assert set(grads) == set(want)
    for k, g in grads.items():
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()) + 1e-6,
            err_msg=k)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_grads_match_reference(remat):
    """Float32 loss within 1e-5 relative and every gradient (the encoder's
    and the cross-attention's among them) within 1e-4 max|g| + 1e-6 of
    the JAX package's."""
    rcfg, tcfg = _cfgs(remat=remat)
    batch = _batch(rcfg)
    loss_r, grads_r = _value_and_grad_ref(_reference("float32"), batch, rcfg)
    grads, metrics = T_step.compute_grads(_state(tcfg).params,
                                          _torch_batch(batch), tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), loss_r, rtol=1e-5)
    _assert_grads_close(grads, grads_r)
    assert all(float(grads[k].abs().max()) > 0 for k in grads
               if k.startswith(("enc_blocks.", "cross.")) and "bias" not in k)


def test_loss_matches_reference_bfloat16():
    rcfg, tcfg = _cfgs("bfloat16")
    batch = _batch(rcfg, seed=2)
    loss_r, _ = R_loss(jax.tree.map(jnp.asarray, _reference("bfloat16")),
                       _jax_batch(batch), rcfg)
    loss_t, _ = T_model.loss_fn(_model("bfloat16", tcfg), _torch_batch(batch),
                                tcfg)
    np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=5e-2,
                               atol=5e-2)


def _saved(tcfg, state, batch):
    """Gradients of one backward, the bytes its forward saved, the
    operand shapes of the products the dots policy saved and the
    functions run under a checkpoint."""
    from torch.utils.checkpoint import CheckpointPolicy

    nbytes, products, checkpointed = [0], [], []
    policy, real = T_model.remat_dots_policy, T_model._checkpointed

    def counting(ctx, func, *args, **kwargs):
        out = policy(ctx, func, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE:
            nbytes[0] += ctx.op_output.numel() * ctx.op_output.element_size()
            products.append(tuple(tuple(args[i].shape)
                                  for i in T_model._PRODUCTS[func]))
        return out

    def recording(remat, fn, *args, **kwargs):
        checkpointed.append(fn.__name__)
        return real(remat, fn, *args, **kwargs)

    def pack(t):
        nbytes[0] += t.numel() * t.element_size()
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_model, "_DOTS_CONTEXTS", functools.partial(
            T_model.create_selective_checkpoint_contexts, counting))
        mp.setattr(T_model, "_checkpointed", recording)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            grads, _ = T_step.compute_grads(state.params, batch, tcfg)
    return grads, nbytes[0], products, checkpointed


def test_remat_recomputes_each_block_and_layer_with_the_same_gradients():
    """remat 'full' and 'dots' give the gradients of 'none' bit for bit;
    every encoder block and every decoder layer runs under a checkpoint;
    'dots' saves the products with a parameter operand -- each layer's
    projections, the cross K/V's over the frames among them -- and no
    score or probability product."""
    _, tcfg = _cfgs()
    state = _state(tcfg)
    batch = _torch_batch(_batch(tcfg, seed=3))
    out = {remat: _saved(tcfg.replace(remat=remat), state, batch)
           for remat in ("none", "full", "dots")}
    for remat in ("full", "dots"):
        for k, g in out["none"][0].items():
            torch.testing.assert_close(out[remat][0][k], g, rtol=0, atol=0,
                                       msg=f"{remat} {k}")
    saved = {remat: out[remat][1] for remat in out}
    assert saved["full"] < saved["dots"] < saved["none"], saved
    E, L = tcfg.n_enc_layers, tcfg.n_layers
    assert out["none"][3] == []
    assert out["full"][3] == out["dots"][3] == (
        ["_apply_dense_block"] * E + ["_decoder_layer"] * L)
    d, f, a = tcfg.d_model, tcfg.d_ff, tcfg.attention
    H, G, hd = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim, a.head_dim
    B, T, S = BATCH, tcfg.enc_seq, SEQ
    # each saved product's (rows of the activation, weight's last two dims)
    got = [(shapes[0][-2], shapes[1][-2:]) for shapes in out["dots"][2]]
    wo = (a.n_heads * hd, d)    # wo: einsum lowers it to a bmm of batch 1
    enc = [(B * T, (d, H)), (B * T, (d, G)), (B * T, (d, G)), (B * T, wo),
           (B * T, (d, f)), (B * T, (f, d))]
    dec = [(B * S, (d, H)), (B * S, (d, G)), (B * S, (d, G)), (B * S, wo),
           (B * T, (d, G)), (B * T, (d, G)), (B * S, (d, H)), (B * S, wo),
           (B * S, (d, f)), (B * S, (f, d))]
    assert got == enc * E + dec * L, got
    assert out["none"][2] == out["full"][2] == []


def test_train_steps_match_reference_in_two_microbatches():
    """The batch's frames are sliced along the batch with the tokens, as
    the JAX package's reshape over the whole batch pytree slices them."""
    rcfg, tcfg = _cfgs()
    rstate = R_step.init_train_state(jax.random.key(0), rcfg)
    tstate = T_step.from_reference(_np_tree(rstate), tcfg, device="cpu")
    rstep = jax.jit(R_step.make_train_step(
        rcfg, R_opt.AdamWConfig(lr=LR, weight_decay=WD),
        R_sched.constant(1.0), n_microbatches=2))
    tstep = T_step.make_train_step(tcfg, T_opt.AdamWConfig(lr=LR,
                                                           weight_decay=WD),
                                   T_sched.constant(1.0), n_microbatches=2)
    data = R_data.SyntheticLM(R_data.DataConfig(vocab=rcfg.vocab, seq_len=SEQ,
                                                global_batch=4, seed=3))
    tiny = None
    for step in range(N_STEPS):
        batch = dict(data.batch_at(step), frames=_frames(rcfg, 4, 40 + step))
        g, _ = T_step.compute_grads(tstate.params, _torch_batch(batch), tcfg)
        small = {k: (v.abs() < ADAM_TINY_GRAD) & (v != 0)
                 for k, v in g.items()}
        tiny = small if tiny is None else {k: tiny[k] | small[k] for k in g}
        rstate, rm = rstep(rstate, _jax_batch(batch))
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {step}")
        assert float(tm["step"]) == float(rm["step"]) == step + 1
    want = T_model.reference_state(_np_tree(rstate.opt.master), rcfg)
    n_tiny = 0
    for k, t in tstate.opt.master.items():
        got, w, m = t.numpy(), want[k], tiny[k].numpy()
        n_tiny += int(m.sum())
        np.testing.assert_allclose(got[~m], w[~m], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(got[m], w[m], rtol=0,
                                   atol=ADAM_TINY_STEP * LR * N_STEPS,
                                   err_msg=f"{k}, gradients below "
                                           f"{ADAM_TINY_GRAD}")
    assert n_tiny < ADAM_TINY_SHARE * sum(t.numel() for t
                                          in tstate.opt.master.values())


def test_training_turns_the_flash_kernel_off_and_keeps_frames_float():
    _, tcfg = _cfgs()
    batch = T_step._to_device(_batch(tcfg), "cpu")
    assert batch["frames"].dtype == torch.float32
    assert batch["tokens"].dtype == batch["labels"].dtype == torch.int64
    bf = T_step._to_device({"frames": torch.zeros(1, 2, dtype=torch.bfloat16),
                            "tokens": np.zeros((1, 2), np.int32)}, "cpu")
    assert bf["frames"].dtype == torch.bfloat16
    assert bf["tokens"].dtype == torch.int64
    with pytest.raises(ValueError, match="flash-attention kernel has no "
                                         "backward"):
        T_step.require_trainable(T_cfg.get_config(ARCH))
    cfg = T_launch_train.training_config(T_cfg.get_config(ARCH))
    assert not cfg.use_flash_kernel


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #

def test_launch_entry_points_run_on_cpu(capsys):
    T_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "8", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 3 steps" in out
    frames = T_launch.audio_frames(T_cfg.get_smoke_config(ARCH), 2)
    assert frames.dtype == torch.bfloat16
    assert tuple(frames.shape) == (2, 16, 64)
    assert torch.equal(frames, T_launch.audio_frames(
        T_cfg.get_smoke_config(ARCH), 2))
    for arch in (ARCH, "gemma2-27b"):
        seqs = T_serve_example.main(["--arch", arch, "--device", "cpu",
                                     "--batch", "2", "--tokens", "5"])
        assert tuple(seqs.shape) == (2, 5)
        out = capsys.readouterr().out
        assert "prefill 2x16" in out and "decoded 5 tokens/seq" in out
    report = T_quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("step ") == 4 and "after churn at 2x" in out
    assert report.feasible and report.k == 256
    with pytest.raises(ValueError, match="needs batch\\['frames'\\]"):
        T_launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "1"])
