"""The port's hybrid family (zamba2) against the JAX package, on the CPU.

zamba2-7b's SMOKE config (5 Mamba2 layers, the shared transformer block
after every 2: two uses and one remainder layer) with the JAX package's
``init_params`` (or ``init_train_state``) carried across:

* ``from_reference`` of the parameters (the ``shared`` subtree under
  ``shared.<part>.<leaf>``) and ``train.step.from_reference`` of a JAX
  ``TrainState``, bit for bit;
* ``forward`` without a cache and ``loss_fn``: float32 at 1e-4, bfloat16
  at 5e-2 (``tests/test_models_smoke.py``'s bound), with the kernel knob
  off and on (on the CPU the knob runs the kernels' plain versions);
* ``prefill`` and 8 teacher-forced ``decode_step``s against the JAX
  package's (jitted, as its entry point runs them) at a 32-token prompt
  (one SMOKE chunk) and a 40-token one (off the chunk grid): logits, SSM
  state, conv carry and K/V at ``TOLS``; and against the port's own
  forward over the whole sequence;
* the gradients (the shared block's is the sum over its two uses) and
  three ``make_train_step`` steps in 2 microbatches against the JAX
  package's, by ``tests/test_torch_train.py``'s rule; ``remat`` "full"
  and "dots" give the gradients of "none", and only the Mamba2 blocks are
  recomputed; the weight-decay exclusions;
* the entry points with ``--arch zamba2-7b --smoke --device cpu``, and
  the flash route at head_dim 112 (``flash_attention.takes``).

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
from repro_torch.kernels import flash_attention as TK
from repro_torch.kernels import ssd_scan as TS
from repro_torch.launch import serve as T_launch
from repro_torch.launch import train as T_launch_train
from repro_torch.models import layers as T_layers
from repro_torch.models import model as T_model
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

ARCH = "zamba2-7b"
BATCH, N_DECODE, SEQ = 2, 8, 64
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
R_adamw = jax.jit(R_opt.adamw_update, static_argnums=(0,))
_R_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(R_model.loss_fn, has_aux=True),
                            static_argnums=2)


def _cfgs(dtype: str = "float32", kernel: bool = False, **kw):
    """(JAX, port) SMOKE configs; the knob only on the port's side (the
    JAX ``forward`` never passes it to the hybrid stack)."""
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


def _tokens(vocab: int, n: int, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, n),
                                                dtype=np.int32)


def _batch(cfg, b: int = BATCH, s: int = SEQ, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                  # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _value_and_grad_ref(params, batch, rcfg):
    (loss, _), grads = _R_VALUE_AND_GRAD(params, {k: jnp.asarray(v) for k, v
                                                  in batch.items()}, rcfg)
    return float(loss), T_model.reference_state(_np_tree(grads), rcfg)


def _state(tcfg):
    params = _reference("float32")
    return T_step.from_reference((params, R_opt.init_adamw(params)), tcfg,
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def _reference_serve(dtype: str, prompt: int):
    """The JAX package's prefill and N_DECODE teacher-forced decode steps
    (jitted): the logits of each and the caches after the prefill and
    after the last step."""
    rcfg, _ = _cfgs(dtype)
    params = jax.tree.map(jnp.asarray, _reference(dtype))
    toks = _tokens(rcfg.vocab, prompt + N_DECODE)
    logits, cache = R_prefill(params, jnp.asarray(toks[:, :prompt]), rcfg,
                              prompt + N_DECODE,
                              cache_dtype=getattr(jnp, dtype))
    first = _np_tree({"ssm": cache["ssm"], "kv": cache["kv"]})
    out = [np.asarray(logits)]
    for i in range(N_DECODE):
        logits, cache = R_decode(params, cache,
                                 jnp.asarray(toks[:, prompt + i:][:, :1]),
                                 rcfg)
        out.append(np.asarray(logits))
    return out, first, _np_tree({"ssm": cache["ssm"], "kv": cache["kv"]})


def _clone(cache):
    return {part: {k: v.clone() for k, v in cache[part].items()}
            for part in ("ssm", "kv")}


def _serve(model, tcfg, toks: np.ndarray, prompt: int, dtype: str):
    """The port's prefill and N_DECODE teacher-forced decode steps: the
    logits of each and the caches after the prefill and after the last
    step (the port writes its caches in place)."""
    t = torch.from_numpy(toks).long()
    logits, cache = T_models.prefill(model, t[:, :prompt], tcfg,
                                     prompt + N_DECODE,
                                     cache_dtype=getattr(torch, dtype))
    first = _clone(cache)
    out = [logits]
    for i in range(N_DECODE):
        logits, cache = T_models.decode_step(
            model, cache, t[:, prompt + i:prompt + i + 1], tcfg)
        out.append(logits)
    assert cache["index"] == prompt + N_DECODE
    return out, first, cache


# --------------------------------------------------------------------------- #
# Parameters and the train state
# --------------------------------------------------------------------------- #

def test_from_reference_carries_every_leaf_and_the_train_state():
    rcfg, tcfg = _cfgs("bfloat16")
    params = _reference("bfloat16")
    rstate = (params, _np_tree(R_opt.init_adamw(jax.tree.map(jnp.asarray,
                                                             params))))
    st = T_step.from_reference(rstate, tcfg, device="cpu")
    assert isinstance(st.params, T_model.HybridLM)
    want = T_model.reference_state(rstate[0], rcfg)
    names = [k for k, _ in st.params.named_parameters()]
    assert set(names) == set(want)
    assert len(names) == 2 + 9 + 9 * rcfg.n_layers   # embed, final, shared
    assert {k for k in names if k.startswith("shared.")} == {
        f"shared.{k}" for k in ("attn_norm.scale", "attn.wq", "attn.wk",
                                "attn.wv", "attn.wo", "mlp_norm.scale",
                                "mlp.w_up", "mlp.w_gate", "mlp.w_down")}
    for k, p in st.params.named_parameters():
        w = np.asarray(want[k])
        assert p.requires_grad and tuple(p.shape) == w.shape, k
        if p.dtype == torch.bfloat16:
            assert np.array_equal(p.detach().view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:                          # the SSM's float32 leaves
            assert np.array_equal(p.detach().numpy(), w), k
    for part in ("master", "m", "v"):
        ref = T_model.reference_state(getattr(rstate[1], part), rcfg)
        for k, t in getattr(st.opt, part).items():
            assert np.array_equal(t.numpy(), ref[k]), (part, k)
    twin = st.clone()
    assert isinstance(twin.params, T_model.HybridLM)
    assert twin.tree().keys() == st.tree().keys()
    fresh = T_step.init_train_state(0, tcfg, device="cpu")
    assert fresh.tree().keys() == st.tree().keys()


def test_hybrid_with_post_block_norms_is_refused():
    """The JAX package's shared block applies no post-block norms, so the
    port refuses a hybrid config that asks for them."""
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
    want, _, _ = R_forward(params, {"tokens": jnp.asarray(batch["tokens"])},
                           rcfg)
    loss_r, _ = R_loss(params, {k: jnp.asarray(v) for k, v
                                in batch.items()}, rcfg)
    model = _model(dtype, tcfg)
    tb = _torch_batch(batch)
    with torch.no_grad():
        got, cache, aux = T_models.forward(model, {"tokens": tb["tokens"]},
                                           tcfg)
        loss, m = T_models.loss_fn(model, tb, tcfg)
    assert cache is None and aux == {} and got.dtype == torch.float32
    _close(got, want, TOLS[dtype])
    assert float(m["ce"]) == float(loss)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=TOLS[dtype],
                               atol=TOLS[dtype])


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype,prompt,kernel", [
    ("float32", 32, False), ("float32", 32, True), ("float32", 40, False),
    ("float32", 40, True), ("bfloat16", 40, True)])
def test_prefill_and_decode_match_reference(dtype, prompt, kernel):
    """Logits of the prefill and of each decode step, and both caches after
    the prefill and after the last step: the SSM state and conv carry of
    every layer and the K/V of both uses of the shared block."""
    rcfg, tcfg = _cfgs(dtype, kernel)
    want, first_r, last_r = _reference_serve(dtype, prompt)
    toks = _tokens(rcfg.vocab, prompt + N_DECODE)
    got, first, last = _serve(_model(dtype, tcfg), tcfg, toks, prompt, dtype)
    tol = TOLS[dtype]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, tol, f"logits of call {i}")
    for tag, mine, ref in (("prefill", first, first_r),
                           ("last step", last, last_r)):
        for part, k in (("ssm", "state"), ("ssm", "conv"), ("kv", "k"),
                        ("kv", "v")):
            assert tuple(mine[part][k].shape) == ref[part][k].shape
            _close(mine[part][k], ref[part][k], tol, f"{tag} {part} {k}")
    assert last["ssm"]["state"].dtype == torch.float32
    assert last["kv"]["k"].dtype == getattr(torch, dtype)
    assert last["kv"]["k"].shape[0] == rcfg.n_layers // rcfg.shared_attn_every


def test_prefill_and_decode_match_own_forward():
    """The serving path (kernel knob on: the plain versions on the CPU)
    against the port's forward over the whole sequence, float32."""
    _, tcfg = _cfgs("float32", True)
    model = _model("float32", tcfg)
    prompt = 40
    toks = _tokens(tcfg.vocab, prompt + N_DECODE, seed=5)
    got, _, _ = _serve(model, tcfg, toks, prompt, "float32")
    with torch.no_grad():
        full, _, _ = T_models.forward(
            model, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    for i, g in enumerate(got):
        torch.testing.assert_close(g[:, -1], full[:, prompt - 1 + i],
                                   rtol=1e-4, atol=1e-4)


def test_serving_routes_both_kernels_once_a_layer_and_use():
    """With the knob on, a prefill calls the SSD wrapper once a Mamba2
    layer and the flash wrapper once a use of the shared block; decode
    calls neither.  Without it, neither."""
    from repro_torch.kernels import ops

    _, tcfg = _cfgs("float32", True)
    model = _model("float32", tcfg)
    toks = torch.from_numpy(_tokens(tcfg.vocab, 33)).long()
    for knob, n_ssd, n_fa in ((True, tcfg.n_layers, 2), (False, 0, 0)):
        cfg = tcfg.replace(use_flash_kernel=knob)
        with mock.patch.object(ops, "ssd_scan", wraps=ops.ssd_scan) as ssd, \
                mock.patch.object(ops, "flash_attention",
                                  wraps=ops.flash_attention) as fa:
            _, cache = T_models.prefill(model, toks[:, :32], cfg, 40)
            assert (ssd.call_count, fa.call_count) == (n_ssd, n_fa)
            T_models.decode_step(model, cache, toks[:, 32:], cfg)
            assert (ssd.call_count, fa.call_count) == (n_ssd, n_fa)


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


def test_grads_match_reference_the_shared_block_summed_over_its_uses():
    """Float32 loss within 1e-5 relative and every gradient within 1e-4
    max|g| + 1e-6 of the JAX package's; the shared block's gradient is the
    sum of its two uses' (autograd's sum over a parameter used twice), so
    it is not the gradient of either use alone."""
    rcfg, tcfg = _cfgs()
    batch = _batch(rcfg)
    loss_r, grads_r = _value_and_grad_ref(_reference("float32"), batch, rcfg)
    state = _state(tcfg)
    grads, metrics = T_step.compute_grads(state.params, _torch_batch(batch),
                                          tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), loss_r, rtol=1e-5)
    _assert_grads_close(grads, grads_r)
    shared = [k for k in grads if k.startswith("shared.")]
    assert len(shared) == 9 and all(float(grads[k].abs().max()) > 0
                                    for k in shared)
    # one use's gradient alone: the other use's weights detached
    uses, real = [], T_model._apply_dense_block

    def one_use(keep):
        calls = [0]

        def block(bp, x, cfg, **kw):
            i, calls[0] = calls[0], calls[0] + 1
            if i == keep:
                return real(bp, x, cfg, **kw)
            frozen = T_model.DenseBlock(cfg)
            frozen.load_state_dict({n: p.detach() for n, p
                                    in bp.named_parameters()}, assign=True)
            return real(frozen, x, cfg, **kw)
        return block

    for keep in (0, 1):
        with mock.patch.object(T_model, "_apply_dense_block", one_use(keep)):
            g, _ = T_step.compute_grads(state.params, _torch_batch(batch),
                                        tcfg)
        uses.append(g)
    for k in shared:
        torch.testing.assert_close(uses[0][k] + uses[1][k], grads[k],
                                   rtol=1e-5, atol=1e-7, msg=k)
        assert not torch.allclose(uses[0][k], grads[k], rtol=1e-3), k


def test_loss_matches_reference_bfloat16():
    rcfg, tcfg = _cfgs("bfloat16")
    batch = _batch(rcfg, seed=2)
    loss_r, _ = R_loss(jax.tree.map(jnp.asarray, _reference("bfloat16")),
                       {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    loss_t, _ = T_model.loss_fn(_model("bfloat16", tcfg), _torch_batch(batch),
                                tcfg)
    np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=5e-2,
                               atol=5e-2)


def _saved(tcfg, state, batch):
    """Gradients of one backward, the bytes its forward saved (autograd's
    saved-tensor hooks plus the selective checkpoint's own cache), the
    products the dots policy saved (operand shapes) and the modules run
    under a checkpoint."""
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
        checkpointed.append(type(fn).__name__)
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


def test_remat_recomputes_the_mamba_blocks_only_with_the_same_gradients():
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
    # every checkpoint wraps a Mamba2 block: the shared block runs plainly
    L = tcfg.n_layers
    assert out["none"][3] == []
    assert out["full"][3] == out["dots"][3] == ["Mamba2Block"] * L
    # the products dots saves: each Mamba2 block's in and out projection,
    # and no product of the shared block (it is not checkpointed)
    d, e = tcfg.d_model, T_model.SSM.mamba2_shapes(tcfg)["in_proj"][0][1]
    d_inner = tcfg.ssm.expand * d
    weights = [shapes[1][-2:] for shapes in out["dots"][2]]
    assert weights == [(d, e), (d_inner, d)] * L, out["dots"][2]
    assert out["none"][2] == out["full"][2] == []


def test_remat_dots_gradients_match_reference():
    rcfg, tcfg = _cfgs(remat="dots")
    batch = _batch(rcfg, seed=4)
    loss_r, grads_r = _value_and_grad_ref(_reference("float32"), batch, rcfg)
    grads, metrics = T_step.compute_grads(_state(tcfg).params,
                                          _torch_batch(batch), tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), loss_r, rtol=1e-5)
    _assert_grads_close(grads, grads_r)


def test_train_steps_match_reference_in_two_microbatches():
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
        batch = data.batch_at(step)
        # Adam's step turns float32 noise in a gradient at its eps scale
        # into a visible share of lr: such elements are held to
        # ADAM_TINY_STEP lr (the port's own gradients find them)
        g, _ = T_step.compute_grads(tstate.params, _torch_batch(batch), tcfg)
        small = {k: (v.abs() < ADAM_TINY_GRAD) & (v != 0)
                 for k, v in g.items()}
        tiny = small if tiny is None else {k: tiny[k] | small[k] for k in g}
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
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


def test_no_decay_leaves_are_the_reference_leaves():
    """With zero gradients only weight decay moves the master: the port
    moves the leaves the JAX package's path rule moves, and no other.  The
    conv biases start at zero, where decay moves nothing, so both sides
    start from biases of one: they decay."""
    rcfg, tcfg = _cfgs()
    params = jax.tree.map(np.copy, _reference("float32"))
    params["blocks"]["mixer"]["conv_b"][...] = 1.0
    jparams = jax.tree.map(jnp.asarray, params)
    master, _ = R_adamw(
        R_opt.AdamWConfig(lr=0.1), jax.tree.map(jnp.zeros_like, jparams),
        R_opt.init_adamw(jparams))
    before = T_model.reference_state(params, rcfg)
    after = T_model.reference_state(_np_tree(master), rcfg)
    want = {k for k in before if not np.array_equal(before[k], after[k])}
    state = T_step.from_reference((params, R_opt.init_adamw(params)), tcfg,
                                  device="cpu")
    tmaster, _ = T_opt.adamw_update(
        T_opt.AdamWConfig(lr=0.1),
        {k: torch.zeros_like(v) for k, v in state.opt.master.items()},
        state.opt)
    got = {k for k, v in tmaster.items()
           if not torch.equal(v, state.opt.master[k])}
    assert got == want
    assert "blocks.0.mixer.conv_b" in got and "shared.attn.wq" in got
    assert not any(s in k for k in got for s in ("norm", "a_log", "dt_bias",
                                                 "d_skip"))


# --------------------------------------------------------------------------- #
# Entry points and routes
# --------------------------------------------------------------------------- #

def test_launch_serve_and_train_run_zamba2_on_cpu(capsys):
    T_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "40", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 3 steps" in out
    report = T_launch_train.main(["--arch", ARCH, "--smoke", "--device",
                                  "cpu", "--steps", "2", "--batch", "2",
                                  "--seq", "32"])
    assert report.steps_completed == 2
    assert all(np.isfinite(report.losses))
    assert "steps=2" in capsys.readouterr().out
    # the serving CONFIG turns both kernels on; training turns them off
    assert T_cfg.get_config(ARCH).use_flash_kernel
    assert not T_launch_train.training_config(
        T_cfg.get_config(ARCH)).use_flash_kernel
    assert ("training runs ssd_chunked and _attention_core (the SSD kernel "
            "and the flash-attention kernel have no backward)"
            in capsys.readouterr().out)
    with pytest.raises(ValueError, match="have no backward"):
        T_step.require_trainable(T_cfg.get_config(ARCH))


@pytest.mark.parametrize("dtype,routed", [
    (torch.bfloat16, True), (torch.float32, False), (torch.float16, False)])
def test_flash_route_at_head_dim_112_follows_takes(dtype, routed):
    """bf16 at zamba2's head_dim 112 takes the tensor-core kernel (padded
    to 128); no kernel takes float32 or float16 there, so those run
    _attention_core by their shape."""
    tcfg = T_cfg.get_config(ARCH).replace(
        param_dtype=str(dtype).split(".")[-1],
        compute_dtype=str(dtype).split(".")[-1])
    assert tcfg.attention.head_dim == 112
    assert TK.takes(dtype, 112) == routed
    assert T_layers.flash_route(tcfg, causal=True, q_offset=0, seq=1024,
                                layer_is_local=False) == routed
    if routed:
        assert TK.route(dtype, 112) == "wgmma"
        assert TK.padded_head_dim(dtype, 112) == 128
    else:
        assert TK.padded_head_dim(dtype, 112) == 112
    assert TS.route(torch.bfloat16, 64, 64, 256) == "mma"
