"""The port's dense training against the JAX package, on the CPU.

The five dense configs (olmo-1b, gemma2-27b, stablelm-1.6b, starcoder2-3b,
qwen2-vl-7b) at SMOKE size with the JAX package's ``init_params`` (or
``init_train_state``) carried across, sequences of 64 tokens (wider than
the SMOKE window of 32, so gemma2's and starcoder2's local layers mask):

* ``loss_fn`` and its gradients against ``jax.value_and_grad(loss_fn)``:
  float32 loss within 1e-5 relative, each leaf's gradient within 1e-4
  max|g| + 1e-6 (``tests/test_torch_train.py``'s rule); bfloat16 loss
  within 5e-2 + 5e-2|b|;
* ``remat="dots"`` (torch's selective checkpointing with
  ``models.model.remat_dots_policy``): the gradients of ``"none"`` and of
  ``"full"`` bit for bit; it saves the outputs of the projections and
  nothing of attention, so its saved bytes lie between ``"full"``'s and
  ``"none"``'s; the JAX package's ``"dots"`` gradients equal the port's;
* three ``make_train_step`` steps against the JAX package's (jitted), 1
  and 2 microbatches, float32: losses within 1e-5 relative, the final
  master within 1e-5 relative + 1e-6 except elements of a tiny gradient,
  held to 0.05 lr a step (``tests/test_torch_train.py``'s Adam rule);
* the weight-decay exclusions: with zero gradients the port moves exactly
  the leaves the JAX package moves, for every dense config;
* the dense ``TrainState``: its tree, clone and load, and
  ``from_reference`` of a JAX dense ``TrainState``.

Inputs are made with ``np.random.default_rng`` and reach both sides as the
same numbers.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import repro.configs as R_cfg
import repro.models as R_models
from repro.data import synthetic as R_data
from repro.models import model as R_model
from repro.train import optimizer as R_opt
from repro.train import schedule as R_sched
from repro.train import step as R_step
import repro_torch.configs as T_cfg
from repro_torch.models import model as T_model
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

DENSE = ("olmo-1b", "gemma2-27b", "stablelm-1.6b", "starcoder2-3b",
         "qwen2-vl-7b")
SEQ = 64
# tests/test_torch_train.py's Adam rule (see ADAM_TINY_GRAD there).  The
# exempt elements must stay under ADAM_TINY_SHARE of the parameters:
# gemma2's softcapped logits and post-block norms give smaller gradients,
# and 2,886 of its 263,232 elements (1.1%) fall below 1e-6 at some step of
# the three (olmo: 1,145 of 147,456, 0.78%; mamba2 in its own test: under
# 1%).
ADAM_TINY_GRAD, ADAM_TINY_STEP, ADAM_TINY_SHARE = 1e-6, 0.05, 2e-2
LR, WD, N_STEPS = 1e-3, 0.1, 3


def _cfgs(arch: str, dtype: str = "float32", **kw):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **kw)
    return (R_cfg.get_smoke_config(arch).replace(**kw),
            T_cfg.get_smoke_config(arch).replace(**kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, b: int = 2, s: int = SEQ, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                  # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str, dtype: str):
    rcfg, _ = _cfgs(arch, dtype)
    return _np_tree(R_models.init_params(jax.random.key(0), rcfg))


_R_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(R_model.loss_fn, has_aux=True),
                            static_argnums=2)


def _value_and_grad_ref(params, batch, rcfg):
    (loss, _), grads = _R_VALUE_AND_GRAD(params, {k: jnp.asarray(v) for k, v
                                   in batch.items()}, rcfg)
    return float(loss), T_model.reference_state(_np_tree(grads), rcfg)


def _state(arch: str, tcfg):
    params = _reference_params(arch, "float32")
    return T_step.from_reference((params, R_opt.init_adamw(params)), tcfg,
                                 device="cpu")


def _assert_grads_close(grads, want):
    assert set(grads) == set(want)
    for k, g in grads.items():
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()) + 1e-6,
            err_msg=k)


# ----------------------------------------------------------------- loss_fn
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference_float32(arch):
    rcfg, tcfg = _cfgs(arch)
    batch = _batch(rcfg)
    loss_r, grads_r = _value_and_grad_ref(_reference_params(arch, "float32"),
                                          batch, rcfg)
    state = _state(arch, tcfg)
    grads, metrics = T_step.compute_grads(state.params, _torch_batch(batch),
                                          tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), loss_r, rtol=1e-5)
    _assert_grads_close(grads, grads_r)
    assert all(p.grad is None for p in state.params.parameters())


@pytest.mark.parametrize("arch", DENSE)
def test_loss_matches_reference_bfloat16(arch):
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    params = _reference_params(arch, "bfloat16")
    batch = _batch(rcfg, seed=1)
    loss_r, _ = R_model.loss_fn(jax.tree.map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                rcfg)
    model = T_model.from_reference(params, tcfg, device="cpu")
    loss_t, m = T_model.loss_fn(model, _torch_batch(batch), tcfg)
    assert float(m["ce"]) == float(loss_t)
    np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=5e-2,
                               atol=5e-2)


# ----------------------------------------------------------------- remat
def _saved(tcfg, state, batch):
    """Gradients of one backward and the bytes its forward saved: what
    autograd's saved-tensor hooks see, plus the outputs the selective
    checkpoint keeps in its own cache (which the hooks do not see), and
    the products the policy saved, as (operand shapes)."""
    nbytes, products = [0], []
    policy = T_model.remat_dots_policy

    def counting(ctx, func, *args, **kwargs):
        out = policy(ctx, func, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE:
            nbytes[0] += ctx.op_output.numel() * ctx.op_output.element_size()
            products.append(tuple(tuple(args[i].shape)
                                  for i in T_model._PRODUCTS[func]))
        return out

    def pack(t):
        nbytes[0] += t.numel() * t.element_size()
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_model, "_DOTS_CONTEXTS", functools.partial(
            T_model.create_selective_checkpoint_contexts, counting))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            grads, _ = T_step.compute_grads(state.params, batch, tcfg)
    return grads, nbytes[0], products


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b"])
def test_remat_dots_gives_the_gradients_of_none_and_saves_the_projections(
        arch):
    _, tcfg = _cfgs(arch)
    state = _state(arch, tcfg)
    batch = _torch_batch(_batch(tcfg, seed=2))
    out = {remat: _saved(tcfg.replace(remat=remat), state, batch)
           for remat in ("none", "full", "dots")}
    for remat in ("full", "dots"):
        for k, g in out["none"][0].items():
            torch.testing.assert_close(out[remat][0][k], g, rtol=0, atol=0,
                                       msg=f"{remat} {k}")
    saved = {remat: out[remat][1] for remat in out}
    assert saved["full"] < saved["dots"] < saved["none"], saved
    # seven projections a layer (q, k, v, o; up, gate, down): no product of
    # attention's scores or probabilities
    a, d, rows = tcfg.attention, tcfg.d_model, 2 * SEQ
    want = [((rows, d), (d, a.n_heads * a.head_dim)),
            ((rows, d), (d, a.n_kv_heads * a.head_dim)),
            ((rows, d), (d, a.n_kv_heads * a.head_dim)),
            ((1, rows, a.n_heads * a.head_dim), (1, a.n_heads * a.head_dim,
                                                 d)),
            ((rows, d), (d, tcfg.d_ff)), ((rows, d), (d, tcfg.d_ff)),
            ((rows, tcfg.d_ff), (tcfg.d_ff, d))]
    assert out["dots"][2] == want * tcfg.n_layers
    assert out["none"][2] == out["full"][2] == []


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b"])
def test_remat_dots_gradients_match_reference(arch):
    rcfg, tcfg = _cfgs(arch, remat="dots")
    batch = _batch(rcfg, seed=3)
    loss_r, grads_r = _value_and_grad_ref(_reference_params(arch, "float32"),
                                          batch, rcfg)
    grads, metrics = T_step.compute_grads(_state(arch, tcfg).params,
                                          _torch_batch(batch), tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), loss_r, rtol=1e-5)
    _assert_grads_close(grads, grads_r)


def test_remat_dots_policy_reads_the_operands():
    """A product with a parameter operand (or a view or cast of one) is
    saved whatever its aten name; a product of two activations is not."""
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter(torch.randn(4, 6, generator=g))
    x = torch.randn(3, 4, generator=g, requires_grad=True)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    save, redo = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    pol = functools.partial(T_model.remat_dots_policy, None)
    assert pol(mm, x * 2, w) == save
    assert pol(bmm, (x * 2)[None], w.reshape(1, 4, 6)) == save
    assert pol(mm, x * 2, w.double().float()) == save
    assert pol(bmm, (x * 2)[None], (x * 3).t()[None]) == redo
    assert pol(torch.ops.aten.add.Tensor, w, w) == redo


# ----------------------------------------------------------------- train step
@pytest.mark.parametrize("arch,n_micro", [("olmo-1b", 1), ("olmo-1b", 2),
                                          ("gemma2-27b", 2)])
def test_train_steps_match_reference(arch, n_micro):
    rcfg, tcfg = _cfgs(arch)
    rstate = R_step.init_train_state(jax.random.key(0), rcfg)
    tstate = T_step.from_reference(_np_tree(rstate), tcfg, device="cpu")
    assert all(p.requires_grad for p in tstate.params.parameters())
    rstep = jax.jit(R_step.make_train_step(
        rcfg, R_opt.AdamWConfig(lr=LR, weight_decay=WD),
        R_sched.constant(1.0), n_microbatches=n_micro))
    tstep = T_step.make_train_step(tcfg, T_opt.AdamWConfig(lr=LR,
                                                           weight_decay=WD),
                                   T_sched.constant(1.0),
                                   n_microbatches=n_micro)
    data = R_data.SyntheticLM(R_data.DataConfig(vocab=rcfg.vocab, seq_len=SEQ,
                                                global_batch=4, seed=3))
    tiny = None
    for step in range(N_STEPS):
        batch = data.batch_at(step)
        _, g = _value_and_grad_ref(rstate.params, batch, rcfg)
        small = {k: (np.abs(v) < ADAM_TINY_GRAD) & (v != 0)
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
        got, w, m = t.numpy(), want[k], tiny[k]
        n_tiny += int(m.sum())
        np.testing.assert_allclose(got[~m], w[~m], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(got[m], w[m], rtol=0,
                                   atol=ADAM_TINY_STEP * LR * N_STEPS,
                                   err_msg=f"{k}, gradients below "
                                           f"{ADAM_TINY_GRAD}")
    assert n_tiny < ADAM_TINY_SHARE * sum(t.numel() for t
                                          in tstate.opt.master.values())
    for k, p in tstate.params.named_parameters():
        torch.testing.assert_close(p.detach(), tstate.opt.master[k].to(p.dtype),
                                   rtol=0, atol=0)


# ----------------------------------------------------------------- optimizer
@pytest.mark.parametrize("arch", DENSE)
def test_no_decay_leaves_are_the_reference_leaves(arch):
    """With zero gradients only weight decay moves the master: the port
    moves the leaves the JAX package's path rule moves, and no other."""
    rcfg, tcfg = _cfgs(arch)
    params = _reference_params(arch, "float32")
    jparams = jax.tree.map(jnp.asarray, params)
    master, _ = R_opt.adamw_update(
        R_opt.AdamWConfig(lr=0.1), jax.tree.map(jnp.zeros_like, jparams),
        R_opt.init_adamw(jparams))
    before = T_model.reference_state(params, rcfg)
    after = T_model.reference_state(_np_tree(master), rcfg)
    want = {k for k in before if not np.array_equal(before[k], after[k])}
    state = _state(arch, tcfg)
    tmaster, _ = T_opt.adamw_update(
        T_opt.AdamWConfig(lr=0.1),
        {k: torch.zeros_like(v) for k, v in state.opt.master.items()},
        state.opt)
    got = {k for k, v in tmaster.items()
           if not torch.equal(v, state.opt.master[k])}
    assert got == want
    assert not any("norm" in k or "bias" in k for k in got)
    assert "embed.tok" in got


# ----------------------------------------------------------------- state
@pytest.mark.parametrize("arch", ["olmo-1b", "stablelm-1.6b"])
def test_dense_train_state_tree_clone_load_and_from_reference(arch):
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    rstate = _np_tree(R_step.init_train_state(jax.random.key(1), rcfg))
    st = T_step.from_reference(rstate, tcfg, device="cpu")
    assert isinstance(st.params, T_model.DenseLM)
    want = T_model.reference_state(rstate[0], rcfg)
    for k, p in st.params.named_parameters():
        assert p.requires_grad and p.dtype == torch.bfloat16
        assert np.array_equal(p.detach().view(torch.int16).numpy(),
                              np.asarray(want[k]).view(np.int16)), k
    for part in ("master", "m", "v"):
        ref = T_model.reference_state(getattr(rstate[1], part), rcfg)
        for k, t in getattr(st.opt, part).items():
            assert np.array_equal(t.numpy(), ref[k]), (part, k)
    tree = st.tree()
    n = len(list(st.params.parameters()))
    assert len(tree) == 4 * n + 1 and tree["opt/step"].dtype == torch.int32
    twin = st.clone()
    assert isinstance(twin.params, T_model.DenseLM)
    with torch.no_grad():
        next(st.params.parameters()).add_(1.0)
    assert not all(torch.equal(a, b) for a, b in
                   zip(st.tree().values(), twin.tree().values()))
    st.load_tree(twin.tree())
    for k, v in st.tree().items():
        assert torch.equal(v, twin.tree()[k]), k
    fresh = T_step.init_train_state(0, tcfg, device="cpu")
    assert fresh.tree().keys() == tree.keys()


def test_training_after_serving_under_inference_mode(monkeypatch):
    """A process that serves a model under ``torch.inference_mode`` and
    then trains it: the constants the forward divides by (gemma2's logit
    softcap) are cached on first use, and one made under inference mode
    must still take part in the backward."""
    from repro_torch import device as T_device

    monkeypatch.setattr(T_device, "_CONSTS", {})
    rcfg, tcfg = _cfgs("gemma2-27b")
    batch = _batch(rcfg, seed=4)
    state = _state("gemma2-27b", tcfg)
    with torch.inference_mode():
        T_model.forward(state.params, _torch_batch(batch), tcfg)
    loss_r, grads_r = _value_and_grad_ref(
        _reference_params("gemma2-27b", "float32"), batch, rcfg)
    grads, metrics = T_step.compute_grads(state.params, _torch_batch(batch),
                                          tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), loss_r, rtol=1e-5)
    _assert_grads_close(grads, grads_r)
