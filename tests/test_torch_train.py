"""The port's training substrate against the JAX package, on the CPU.

* schedules (``repro.train.schedule``): 1e-7 relative;
* ``adamw_update`` over three steps, gradient clipping active and not,
  weight-decay exclusions by name: master, m and v within 1e-6 relative
  + 1e-7 absolute (float32 sums in another order);
* ``loss_fn`` and its gradients on the mamba2 SMOKE config with the JAX
  package's ``init_params`` carried across: float32 loss within 1e-5
  relative and each leaf's gradient within 1e-4 max|g| + 1e-6; bfloat16
  loss within 5e-2 + 5e-2|b| (``tests/test_models_smoke.py``'s bound);
* ``make_train_step`` for three steps from ``from_reference`` of the same
  ``init_train_state``, 1 and 2 microbatches, float32: each step's loss
  within 1e-5 relative, the final master within 1e-5 relative + 1e-6
  (elements whose gradient is at Adam's eps scale within 0.05 lr a step:
  see ADAM_TINY_GRAD);
* ``SyntheticLM`` and ``Prefetcher``: bit for bit;
* the training entry points refuse ``use_flash_kernel=True``;
  ``remat='full'`` and ``remat='dots'`` give the gradients of ``'none'``.

Inputs are made with ``np.random.default_rng`` and reach both sides as the
same numbers.
"""

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
from repro_torch.data import synthetic as T_data
from repro_torch.models import model as T_model
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

ARCH = "mamba2-130m"


def _cfgs(dtype: str = "float32", **kw):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **kw)
    return (R_cfg.get_smoke_config(ARCH).replace(**kw),
            T_cfg.get_smoke_config(ARCH).replace(**kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, b: int = 4, s: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                  # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


# ----------------------------------------------------------------- schedules
@pytest.mark.parametrize("name,args", [
    ("constant", (0.5,)),
    ("linear_warmup_cosine", (10, 40, 0.1)),
    ("inverse_sqrt", (8,)),
])
def test_schedules_match_reference(name, args):
    fr, ft = getattr(R_sched, name)(*args), getattr(T_sched, name)(*args)
    for step in range(0, 60, 3):
        want = float(fr(jnp.asarray(step, jnp.int32)))
        got = ft(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-7)


# ----------------------------------------------------------------- AdamW
_NAMES = ("blocks.0.mixer.in_proj", "blocks.0.mixer.a_log",
          "blocks.0.mixer.norm_scale", "blocks.0.norm.scale", "embed.tok",
          "blocks.1.mixer.conv_b")


def _nest(flat):
    """A name -> array mapping as the JAX package's nested pytree (its key
    path joined by '/' holds the same substrings as the port's name)."""
    out = {}
    for name, a in flat.items():
        d = out
        *head, last = name.split(".")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = a
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # clip off / on
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(1)
    shapes = dict(zip(_NAMES, [(8, 12), (4,), (6,), (8,), (16, 8), (10,)]))
    master = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = R_opt.AdamWConfig(lr=1e-2, weight_decay=0.1)
    tcfg = T_opt.AdamWConfig(lr=1e-2, weight_decay=0.1)
    rs = R_opt.init_adamw(_nest({k: jnp.asarray(v) for k, v in master.items()}))
    ts = T_opt.init_adamw({k: torch.from_numpy(v) for k, v in master.items()})
    clipped = []
    for step in range(3):
        g = {k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
             for k, s in shapes.items()}
        clipped.append(float(T_opt.global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()})) > 1.0)
        lr_scale = np.float32(1.0 - 0.1 * step)
        _, rs = R_opt.adamw_update(cfg, _nest({k: jnp.asarray(v) for k, v
                                               in g.items()}), rs,
                                   jnp.asarray(lr_scale))
        _, ts = T_opt.adamw_update(tcfg, {k: torch.from_numpy(v) for k, v
                                          in g.items()}, ts,
                                   torch.tensor(lr_scale))
        assert int(ts.step) == int(rs.step) == step + 1
        for part in ("master", "m", "v"):
            want = _flat(_np_tree(getattr(rs, part)))
            for k, t in getattr(ts, part).items():
                np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6,
                                           atol=1e-7, err_msg=f"{part} {k}")
    assert all(clipped) == (grad_scale > 1) and any(clipped) == all(clipped)


def test_no_decay_names_are_excluded():
    """With zero gradients only weight decay moves the master: the excluded
    names (norm, scale, a_log, ...) stay, the others shrink."""
    w = {k: torch.ones(3) for k in _NAMES}
    st = T_opt.init_adamw(w)
    master, _ = T_opt.adamw_update(T_opt.AdamWConfig(lr=0.1),
                                   {k: torch.zeros(3) for k in _NAMES}, st)
    moved = {k for k, v in master.items() if not torch.equal(v, w[k])}
    assert moved == {"blocks.0.mixer.in_proj", "embed.tok",
                     "blocks.1.mixer.conv_b"}


# ----------------------------------------------------------------- loss_fn
def _value_and_grad_ref(params, batch, rcfg):
    fn = jax.jit(jax.value_and_grad(R_model.loss_fn, has_aux=True),
                 static_argnums=2)
    (loss, _), grads = fn(params, {k: jnp.asarray(v) for k, v
                                   in batch.items()}, rcfg)
    return float(loss), T_model.reference_state(_np_tree(grads), rcfg)


def test_loss_and_grads_match_reference_float32():
    rcfg, tcfg = _cfgs("float32")
    params = R_models.init_params(jax.random.key(0), rcfg)
    batch = _batch(rcfg)
    loss_r, grads_r = _value_and_grad_ref(params, batch, rcfg)
    state = T_step.from_reference((_np_tree(params), R_opt.init_adamw(params)),
                                  tcfg, device="cpu")
    grads, metrics = T_step.compute_grads(state.params, _torch_batch(batch),
                                          tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), loss_r, rtol=1e-5)
    assert set(grads) == set(grads_r)
    for k, g in grads.items():
        want = np.asarray(grads_r[k], np.float32)
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=1e-4 * float(np.abs(want).max()) + 1e-6, err_msg=k)
    assert all(p.grad is None for p in state.params.parameters())


def test_loss_matches_reference_bfloat16():
    rcfg, tcfg = _cfgs("bfloat16")
    params = R_models.init_params(jax.random.key(1), rcfg)
    batch = _batch(rcfg, seed=1)
    loss_r, _ = R_model.loss_fn(params, {k: jnp.asarray(v) for k, v
                                         in batch.items()}, rcfg)
    model = T_model.from_reference(_np_tree(params), tcfg, device="cpu")
    loss_t, m = T_model.loss_fn(model, _torch_batch(batch), tcfg)
    assert float(m["ce"]) == float(loss_t)
    np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=5e-2,
                               atol=5e-2)


def test_remat_full_gives_the_gradients_of_none():
    _, tcfg = _cfgs("float32")
    batch = _torch_batch(_batch(tcfg, seed=2))
    st = T_step.init_train_state(0, tcfg, device="cpu")
    out = [T_step.compute_grads(st.params, batch, tcfg.replace(remat=remat))[0]
           for remat in ("none", "full")]
    for k in out[0]:
        torch.testing.assert_close(out[1][k], out[0][k], rtol=0, atol=0)


def test_remat_dots_gives_the_gradients_of_none():
    _, tcfg = _cfgs("float32")
    batch = _torch_batch(_batch(tcfg, seed=2))
    st = T_step.init_train_state(0, tcfg, device="cpu")
    out = [T_step.compute_grads(st.params, batch, tcfg.replace(remat=remat))[0]
           for remat in ("none", "dots")]
    for k in out[0]:
        torch.testing.assert_close(out[1][k], out[0][k], rtol=0, atol=0)


# ----------------------------------------------------------------- train step
# Adam's step is about g / (|g| + eps), eps = 1e-8: where a gradient is
# small, the float32 noise of the two frameworks' gradients (cancellation,
# ~1e-7 of max|g|, far inside the 1e-4 gradient tolerance above) moves that
# element's step by a visible fraction of lr (measured: 2.6e-6 and 1.3e-5 on
# 2 of 100,904 elements).  Elements whose nonzero reference gradient falls
# below 1e-6 (100 eps) at some step (439 of 100,904; they must stay under
# 1% of the parameters) are held to ADAM_TINY_STEP of lr a step, absolute
# (20x a step's share of the largest measured gap, 1.3e-5 over 3 steps).
# Every other element is held at 1e-5 relative + 1e-6.
ADAM_TINY_GRAD = 1e-6
ADAM_TINY_STEP = 0.05
LR, WD, N_STEPS = 1e-3, 0.1, 3


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(n_micro):
    rcfg, tcfg = _cfgs("float32")
    ocfg = R_opt.AdamWConfig(lr=LR, weight_decay=WD)
    rstate = R_step.init_train_state(jax.random.key(0), rcfg)
    tstate = T_step.from_reference(_np_tree(rstate), tcfg, device="cpu")
    assert all(p.requires_grad for p in tstate.params.parameters())
    rstep = jax.jit(R_step.make_train_step(rcfg, ocfg, R_sched.constant(1.0),
                                           n_microbatches=n_micro))
    tstep = T_step.make_train_step(tcfg, T_opt.AdamWConfig(lr=LR,
                                                           weight_decay=WD),
                                   T_sched.constant(1.0),
                                   n_microbatches=n_micro)
    data = R_data.SyntheticLM(R_data.DataConfig(vocab=rcfg.vocab, seq_len=32,
                                                global_batch=4, seed=3))
    tiny = None
    for step in range(N_STEPS):
        batch = data.batch_at(step)
        _, g = _value_and_grad_ref(rstate.params, batch, rcfg)
        small = {k: (np.abs(v) < ADAM_TINY_GRAD) & (v != 0)
                 for k, v in g.items()}
        tiny = small if tiny is None else {k: tiny[k] | small[k] for k in g}
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
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
    assert n_tiny < 1e-2 * sum(t.numel() for t in tstate.opt.master.values())
    # the working parameters are the master cast to their dtype
    for k, p in tstate.params.named_parameters():
        torch.testing.assert_close(p.detach(), tstate.opt.master[k].to(p.dtype),
                                   rtol=0, atol=0)


def test_train_state_tree_clone_and_load():
    _, tcfg = _cfgs("bfloat16")
    st = T_step.init_train_state(0, tcfg, device="cpu")
    tree = st.tree()
    n = len(list(st.params.parameters()))
    assert len(tree) == 4 * n + 1 and tree["opt/step"].dtype == torch.int32
    twin = st.clone()
    with torch.no_grad():
        next(st.params.parameters()).add_(1.0)
    assert not all(torch.equal(a, b) for a, b in
                   zip(st.tree().values(), twin.tree().values()))
    st.load_tree(twin.tree())
    for k, v in st.tree().items():
        assert torch.equal(v, twin.tree()[k]), k


def test_training_refuses_the_ssd_kernel():
    _, tcfg = _cfgs("float32", use_flash_kernel=True)
    with pytest.raises(ValueError, match="use_flash_kernel=False"):
        T_step.make_train_step(tcfg, T_opt.AdamWConfig(), T_sched.constant())
    # grad_constraint (ZeRO-1, tests/test_torch_distributed.py) is taken:
    # an identity constraint, in the microbatch loop too, steps as none
    tcfg = tcfg.replace(use_flash_kernel=False)
    batch = _torch_batch(_batch(tcfg))
    out = []
    for kw in ({}, dict(grad_constraint=lambda g: g),
               dict(grad_constraint=lambda g: g, zero1_grads_in_scan=True)):
        step = T_step.make_train_step(tcfg, T_opt.AdamWConfig(),
                                      T_sched.constant(), n_microbatches=2,
                                      **kw)
        out.append(step(T_step.init_train_state(0, tcfg, "cpu"), batch)[0])
    for st in out[1:]:
        for k, v in out[0].tree().items():
            assert torch.equal(v, st.tree()[k]), k


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(vocab=256, seq_len=16, global_batch=4),
                                dict(vocab=50280, seq_len=64, global_batch=6,
                                     seed=9, zipf_a=1.1)])
def test_synthetic_stream_is_the_reference_stream(kw):
    for hosts in (1, 2):
        for host in range(hosts):
            r = R_data.SyntheticLM(R_data.DataConfig(**kw), host, hosts)
            t = T_data.SyntheticLM(T_data.DataConfig(**kw), host, hosts)
            for step in (0, 1, 7, 1000):
                a, b = r.batch_at(step), t.batch_at(step)
                for k in ("tokens", "labels"):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_yields_the_reference_batches():
    kw = dict(vocab=256, seq_len=8, global_batch=2, seed=4)
    want = iter(R_data.SyntheticLM(R_data.DataConfig(**kw)))
    pre = T_data.Prefetcher(iter(T_data.SyntheticLM(T_data.DataConfig(**kw))))
    for _ in range(5):
        a, b = next(want), next(pre)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    pre.close()
    with pytest.raises(ValueError):
        T_data.SyntheticLM(T_data.DataConfig(**kw), 0, 3)

    def boom():
        yield {"tokens": np.zeros(1)}
        raise RuntimeError("source failed")

    pre = T_data.Prefetcher(boom())
    next(pre)
    with pytest.raises(RuntimeError, match="source failed"):
        next(pre)


def test_ssd_chunked_gradients_stay_finite_where_the_mask_overflows():
    """Above the diagonal cum_i - cum_j can pass ~88 at a full chunk of 256
    (dt A summed over the chunk), where exp overflows.  Masking after the
    exp (the JAX package's ``ssd_chunked``) gives inf * 0 = NaN gradients
    there; the port masks before it.  The forward is unchanged: it equals
    the JAX one."""
    from repro.models import ssm as R_ssm
    from repro_torch.models import ssm as T_ssm

    rng = np.random.default_rng(5)
    b, s, h, p, n = 1, 256, 2, 8, 8
    arrays = dict(x=rng.standard_normal((b, s, h, p)),
                  dt=np.full((b, s, h), 0.5), B=rng.standard_normal((b, s, n)),
                  C=rng.standard_normal((b, s, n)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    A = np.array([-1.0, -2.0], np.float32)
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in arrays.items()}
    y, st = T_ssm.ssd_chunked(t["x"], t["dt"], torch.from_numpy(A), t["B"],
                              t["C"], chunk=256)
    (y.sum() + st.sum()).backward()
    assert all(bool(v.grad.isfinite().all()) for v in t.values())
    y_r, st_r = R_ssm.ssd_chunked(*(jnp.asarray(arrays[k]) for k in ("x", "dt")),
                                  jnp.asarray(A), jnp.asarray(arrays["B"]),
                                  jnp.asarray(arrays["C"]), chunk=256)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(st_r),
                               rtol=1e-4, atol=1e-4)
