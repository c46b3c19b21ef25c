"""The port's moe family against the JAX package, on the CPU.

The two moe SMOKE configs -- olmoe-1b-7b (8 experts, top-2) and
deepseek-moe-16b (8 routed experts, top-3, and 2 shared experts) -- with
the JAX package's ``init_moe`` / ``init_params`` / ``init_train_state``
carried across:

* ``apply_moe`` against ``repro.models.moe.apply_moe`` in float32 and
  bfloat16, at SMOKE's capacity factor 8.0 (no drops) and at 0.5 and 0.25
  (drops): the routes (``expert_ids`` and the within-capacity mask) equal,
  the output within 1e-5 (float32) or 5e-2 (bfloat16), the aux loss and
  the dropped share within 1e-6 relative;
* the seven behaviours of ``tests/test_moe.py`` on the port, and the
  indivisible group's refusal;
* ``from_reference`` of the parameters and of a ``TrainState`` (the
  router float32 in a bfloat16 model, bit for bit);
* ``forward`` and ``loss_fn`` against the JAX package's; ``prefill`` and
  teacher-forced ``decode_step``s against the JAX package's (jitted),
  logits, caches and a decode step's aux; prefill + decode against the
  port's own full forward;
* ``make_train_step`` with 2 microbatches against the JAX step: losses,
  the averaged moe metrics and the final master
  (``tests/test_torch_dense_train.py``'s rule);
* ``remat="dots"``: the gradients of ``"none"`` and ``"full"`` bit for bit,
  the projections, the router and the shared experts saved, the expert
  products (batched over the expert axis) recomputed, as
  ``checkpoint_dots_with_no_batch_dims`` does; the JAX package's
  ``"dots"`` gradients;
* the weight-decay exclusions; ``launch.serve`` and ``launch.train``.

Tolerances: float32 at 1e-4 for logits, 1e-5 for one moe block (products
summed in another order); bfloat16 at 5e-2 (``tests/test_models_smoke.py``'s),
because XLA and torch round bfloat16 intermediates at different places.
Inputs come from ``np.random.default_rng``.
"""
import dataclasses
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
from repro.models import moe as R_moe
from repro.train import optimizer as R_opt
from repro.train import schedule as R_sched
from repro.train import step as R_step
import repro_torch.configs as T_cfg
import repro_torch.models as T_models
from repro_torch.launch import serve as T_launch
from repro_torch.launch import train as T_launch_train
from repro_torch.models import model as T_model
from repro_torch.models import moe as T_moe
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
BATCH, N_DECODE, SEQ = 2, 4, 64
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
MOE_TOLS = {"float32": 1e-5, "bfloat16": 5e-2}
AUX_RTOL = 1e-6
# XLA compiles the dropped share's division by G·group·K to a product with
# the float32 reciprocal: one rounding near 1.0, 2^-25 at deepseek's 192
# claims, where the port divides exactly (0 drops give 0, not -3e-8)
AUX_ATOL = 2.0 ** -24
# bfloat16: two routers' probabilities this close may order differently
# (the router's input carries a bfloat16 rounding, 2^-8 relative)
NEAR_TIE = 2.0 ** -6
# tests/test_torch_dense_train.py's Adam rule
ADAM_TINY_GRAD, ADAM_TINY_STEP, ADAM_TINY_SHARE = 1e-6, 0.05, 2e-2
LR, WD, N_STEPS = 1e-3, 0.1, 3

R_prefill = jax.jit(R_models.prefill, static_argnums=(2, 3),
                    static_argnames=("cache_dtype",))
R_decode = jax.jit(R_models.decode_step, static_argnums=(3,))
R_forward = jax.jit(R_models.forward, static_argnums=(2,))


def _cfgs(arch: str, dtype: str = "float32", kernel: bool = False,
          cf=None, **kw):
    rc, tc = R_cfg.get_smoke_config(arch), T_cfg.get_smoke_config(arch)
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **kw)
    if cf is not None:
        return (rc.replace(moe=dataclasses.replace(rc.moe,
                                                   capacity_factor=cf), **kw),
                tc.replace(moe=dataclasses.replace(tc.moe,
                                                   capacity_factor=cf),
                           use_flash_kernel=kernel, **kw))
    return rc.replace(**kw), tc.replace(use_flash_kernel=kernel, **kw)


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


def _tokens(vocab: int, n: int, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, n),
                                                dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str, seed: int = 0):
    """The JAX parameters (numpy) of the SMOKE config."""
    rcfg, _ = _cfgs(arch, dtype)
    return _np_tree(R_models.init_params(jax.random.key(seed), rcfg))


class _Proxy:
    """A module with some attributes replaced."""

    def __init__(self, mod, **over):
        self._mod, self._over = mod, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(
            self._mod, name)


def _spy_reference_routes(monkeypatch) -> dict:
    """Record the JAX apply_moe's routes, also inside a scan: ``expert_ids``
    from its ``top_k``, the within-capacity mask from its dispatch
    einsum's first operand (host callbacks, in call order)."""
    seen = {"ids": [], "kept": []}

    def record(name, a):
        jax.debug.callback(lambda v: seen[name].append(np.asarray(v)), a,
                           ordered=True)

    def top_k(x, k):
        vals, ids = jax.lax.top_k(x, k)
        record("ids", ids)
        return vals, ids

    def einsum(spec, *ops, **kw):
        if spec == "gske,gskec->gsec":
            record("kept", ops[0].sum(-1) > 0)
        return jnp.einsum(spec, *ops, **kw)

    monkeypatch.setattr(R_moe, "jax", _Proxy(jax, lax=_Proxy(
        jax.lax, top_k=top_k)))
    monkeypatch.setattr(R_moe, "jnp", _Proxy(jnp, einsum=einsum))
    return seen


def _spy_port_routes(monkeypatch) -> list:
    seen, real = [], T_moe.route

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        seen.append(r)
        return r

    monkeypatch.setattr(T_moe, "route", spy)
    return seen


# --------------------------------------------------------------------------- #
# The layer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cf", [8.0, 0.5, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype, cf, monkeypatch):
    rcfg, tcfg = _cfgs(arch, dtype, cf=cf)
    params = _np_tree(R_moe.init_moe(jax.random.key(3), rcfg))
    jx, tx = _x((BATCH, SEQ, rcfg.d_model), dtype, 4)
    want = _spy_reference_routes(monkeypatch)
    got = _spy_port_routes(monkeypatch)
    out_r, aux_r = R_moe.apply_moe(jax.tree.map(jnp.asarray, params), jx,
                                   rcfg)
    out_t, aux_t = T_moe.apply_moe(_torch(params), tx, tcfg)
    (ids,), (kept,), (r,) = want["ids"], want["kept"], got
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    assert out_t.dtype == tx.dtype and out_t.shape == tx.shape
    _close(out_t, out_r, MOE_TOLS[dtype])
    for k in ("moe_aux_loss", "moe_dropped_frac"):
        assert aux_t[k].dtype == torch.float32
        np.testing.assert_allclose(float(aux_t[k]), float(aux_r[k]),
                                   rtol=AUX_RTOL, atol=AUX_ATOL, err_msg=k)
    dropped = float(aux_t["moe_dropped_frac"])
    assert (dropped == 0.0) if cf == 8.0 else (dropped > 0.0)
    assert dropped == 1.0 - float(r.kept.float().mean())


def _setup(arch: str, **moe):
    """tests/test_moe.py's setup on both sides: the JAX init_moe of the
    SMOKE config (bfloat16 parameters and compute), float32 input."""
    rcfg, tcfg = R_cfg.get_smoke_config(arch), T_cfg.get_smoke_config(arch)
    if moe:
        rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, **moe))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe))
    params = _np_tree(R_moe.init_moe(jax.random.key(0), rcfg))
    x = np.asarray(jax.random.normal(jax.random.key(1),
                                     (2, 64, rcfg.d_model), jnp.float32))
    return rcfg, tcfg, _torch(params), torch.from_numpy(x)


def _output_shape_and_aux():
    _, cfg, p, x = _setup("olmoe-1b-7b")
    out, aux = T_moe.apply_moe(p, x, cfg)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert float(aux["moe_aux_loss"]) > 0.0
    assert 0.0 <= float(aux["moe_dropped_frac"]) <= 1.0


def _capacity_monotone_in_factor():
    _, cfg, _, _ = _setup("olmoe-1b-7b")
    caps = [T_moe._capacity(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=f)), 64) for f in (0.5, 1.0, 2.0, 4.0)]
    assert caps == sorted(caps)
    rcfg = R_cfg.get_smoke_config("olmoe-1b-7b")
    assert caps == [R_moe._capacity(rcfg.replace(moe=dataclasses.replace(
        rcfg.moe, capacity_factor=f)), 64) for f in (0.5, 1.0, 2.0, 4.0)]


def _low_capacity_drops_tokens_high_capacity_does_not():
    _, tight, p, x = _setup("olmoe-1b-7b", capacity_factor=0.25)
    _, loose, _, _ = _setup("olmoe-1b-7b", capacity_factor=8.0)
    assert float(T_moe.apply_moe(p, x, tight)[1]["moe_dropped_frac"]) > 0.0
    assert float(T_moe.apply_moe(p, x, loose)[1]["moe_dropped_frac"]) == 0.0


def _shared_experts_always_contribute():
    _, cfg, p, x = _setup("deepseek-moe-16b")
    p = {k: torch.zeros_like(v) if k in ("w_up", "w_down", "w_gate") else v
         for k, v in p.items()}
    out, _ = T_moe.apply_moe(p, x, cfg)
    assert float(out.abs().max()) > 0.0


def _dropped_tokens_ride_residual():
    _, cfg, p, x = _setup("olmoe-1b-7b", capacity_factor=1e-6)
    out, aux = T_moe.apply_moe(p, x, cfg)
    assert float(aux["moe_dropped_frac"]) > 0.5
    assert float(out.norm()) < float(x.norm())


def _router_gates_normalized():
    _, cfg, p, x = _setup("olmoe-1b-7b")
    out1, _ = T_moe.apply_moe(p, x, cfg)
    out2, _ = T_moe.apply_moe(dict(p, router=p["router"] * 1.0), x, cfg)
    torch.testing.assert_close(out1, out2, rtol=1e-6, atol=0)


def _grads_flow_to_router_and_experts():
    _, cfg, p, x = _setup("olmoe-1b-7b")
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out, aux = T_moe.apply_moe(p, x, cfg)
    (out.square().sum() + aux["moe_aux_loss"]).backward()
    assert float(p["router"].grad.abs().sum()) > 0.0
    assert float(p["w_up"].grad.float().abs().sum()) > 0.0


def _indivisible_group_raises():
    _, cfg, p, _ = _setup("olmoe-1b-7b")
    with pytest.raises(ValueError, match="not divisible by group"):
        T_moe.apply_moe(p, torch.zeros(2, 40, cfg.d_model), cfg)


@pytest.mark.parametrize("behaviour", [
    _output_shape_and_aux, _capacity_monotone_in_factor,
    _low_capacity_drops_tokens_high_capacity_does_not,
    _shared_experts_always_contribute, _dropped_tokens_ride_residual,
    _router_gates_normalized, _grads_flow_to_router_and_experts,
    _indivisible_group_raises], ids=lambda f: f.__name__.strip("_"))
def test_moe_behaviours(behaviour):
    """tests/test_moe.py's seven tests on the port, and the refusal of a
    token count the group does not divide (the JAX package asserts)."""
    behaviour()


def test_routing_priority_is_k_slot_then_sequence():
    """Capacity goes to the first-choice claims of every token before any
    second choice, each in sequence order: with every token's top two the
    same two experts and C = 3, tokens 0-2 keep both claims and the rest
    keep none (the reference's cumsum over the (k, s) flattening)."""
    cfg = T_cfg.get_smoke_config("olmoe-1b-7b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                                              group_size=8))
    router = torch.zeros(cfg.d_model, 4)
    router[0, 2], router[0, 1] = 2.0, 1.0
    x = torch.zeros(1, 8, cfg.d_model)
    x[..., 0] = 1.0
    r = T_moe.route(router, x, cfg, 3)
    assert r.expert_ids[0, :, 0].tolist() == [2] * 8
    assert r.expert_ids[0, :, 1].tolist() == [1] * 8
    assert r.pos[0, :, 0].tolist() == list(range(8))
    assert r.kept[0].tolist() == [[True, True]] * 3 + [[False, False]] * 5


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_carries_the_moe_parameters_and_state(arch):
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    rstate = _np_tree(R_step.init_train_state(jax.random.key(1), rcfg))
    st = T_step.from_reference(rstate, tcfg, device="cpu")
    assert isinstance(st.params, T_model.DenseLM)
    want = T_model.reference_state(rstate[0], rcfg)
    names = dict(st.params.named_parameters())
    assert set(names) == set(want)
    assert names["blocks.1.moe.router"].dtype == torch.float32
    assert names["blocks.1.moe.w_up"].dtype == torch.bfloat16
    for k, p in names.items():
        assert p.requires_grad
        w = np.asarray(want[k])
        got = p.detach()
        if got.dtype == torch.bfloat16:
            got, w = got.view(torch.int16), w.view(np.int16)
        assert np.array_equal(got.numpy(), w), k
    for part in ("master", "m", "v"):
        ref = T_model.reference_state(getattr(rstate[1], part), rcfg)
        for k, t in getattr(st.opt, part).items():
            assert np.array_equal(t.numpy(), ref[k]), (part, k)
    model = T_models.from_reference(rstate[0], tcfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    twin = st.clone()
    for k, v in st.tree().items():
        assert torch.equal(v, twin.tree()[k]), k
    fresh = T_step.init_train_state(0, tcfg, device="cpu")
    assert fresh.tree().keys() == st.tree().keys()


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, kernel):
    rcfg, tcfg = _cfgs(arch, kernel=kernel)
    params = _reference(arch, "float32")
    model = T_models.from_reference(params, tcfg, device="cpu")
    toks = _tokens(rcfg.vocab, 33, seed=13)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jparams = jax.tree.map(jnp.asarray, params)
    lt, cache, aux_t = T_models.forward(
        model, {"tokens": torch.from_numpy(batch["tokens"]).long()}, tcfg)
    lr, _, aux_r = R_models.forward(jparams, {"tokens": jnp.asarray(
        batch["tokens"])}, rcfg)
    assert cache is None and lt.dtype == torch.float32
    _close(lt, lr, TOLS["float32"])
    assert set(aux_t) == set(aux_r) == {"moe_aux_loss", "moe_dropped_frac"}
    for k in aux_r:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_r[k]),
                                   rtol=AUX_RTOL, atol=AUX_ATOL, err_msg=k)
    loss_t, m_t = T_models.loss_fn(model, {k: torch.from_numpy(v).long()
                                           for k, v in batch.items()}, tcfg)
    loss_r, m_r = R_models.loss_fn(jparams, {k: jnp.asarray(v) for k, v
                                             in batch.items()}, rcfg)
    assert set(m_t) == set(m_r)
    for k in m_r:
        np.testing.assert_allclose(float(m_t[k]), float(m_r[k]), rtol=1e-5,
                                   atol=AUX_ATOL, err_msg=k)
    assert float(loss_t) == float(m_t["ce"] + m_t["moe_aux_loss"])


@functools.lru_cache(maxsize=None)
def _reference_serve(arch: str, dtype: str, prompt: int):
    """The JAX package's prefill and N_DECODE teacher-forced decode steps
    (jitted): the logits of each, the caches after the prefill and after
    the last step, and the aux of the first decode step's forward."""
    rcfg, _ = _cfgs(arch, dtype)
    params = jax.tree.map(jnp.asarray, _reference(arch, dtype))
    toks = _tokens(rcfg.vocab, prompt + N_DECODE)
    logits, cache = R_prefill(params, jnp.asarray(toks[:, :prompt]), rcfg,
                              prompt + N_DECODE,
                              cache_dtype=getattr(jnp, dtype))
    first = _np_tree(cache["kv"])
    _, _, aux = R_forward(params, {"tokens": jnp.asarray(
        toks[:, prompt:prompt + 1])}, rcfg, cache=cache)
    out = [np.asarray(logits)]
    for i in range(N_DECODE):
        logits, cache = R_decode(params, cache,
                                 jnp.asarray(toks[:, prompt + i:][:, :1]),
                                 rcfg)
        out.append(np.asarray(logits))
    return out, first, _np_tree(cache["kv"]), _np_tree(aux)


def _port_serve(arch, tcfg, dtype, prompt):
    model = T_models.from_reference(_reference(arch, dtype), tcfg,
                                    device="cpu")
    toks = torch.from_numpy(_tokens(tcfg.vocab, prompt + N_DECODE)).long()
    cdt = getattr(torch, dtype)
    logits, cache = T_models.prefill(model, toks[:, :prompt], tcfg,
                                     prompt + N_DECODE, cache_dtype=cdt)
    first = {k: v.clone() for k, v in cache["kv"].items()}
    _, _, aux = T_models.forward(model, {"tokens": toks[:, prompt:][:, :1]},
                                 tcfg, cache={"kv": {k: v.clone() for k, v
                                                     in cache["kv"].items()},
                                              "index": cache["index"]})
    out = [logits]
    for i in range(N_DECODE):
        logits, cache = T_models.decode_step(
            model, cache, toks[:, prompt + i:][:, :1], tcfg)
        out.append(logits)
    return out, first, cache["kv"], aux


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("prompt", [24, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, prompt, kernel):
    """float32: prefill logits and KV cache, N_DECODE teacher-forced decode
    steps' logits, the final cache, and a decode step's aux (the layers'
    values over n, summed), within 1e-4."""
    _, tcfg = _cfgs(arch, kernel=kernel)
    want, first_r, last_r, aux_r = _reference_serve(arch, "float32", prompt)
    got, first_t, last_t, aux_t = _port_serve(arch, tcfg, "float32", prompt)
    for g, w in zip(got, want):
        _close(g, w, TOLS["float32"])
    for k in ("k", "v"):
        _close(first_t[k], first_r[k], TOLS["float32"])
        _close(last_t[k], last_r[k], TOLS["float32"])
    assert set(aux_t) == set(aux_r)
    for k in aux_r:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_r[k]),
                                   rtol=AUX_RTOL, atol=AUX_ATOL, err_msg=k)


def _force_routes(monkeypatch, want_ids: list) -> list:
    """Make the port route as the reference did, call by call.  Each call
    first routes on its own, and every claim where its choice differs
    from the reference's must be a near tie: the port's probabilities of
    its own expert and of the reference's differ by at most NEAR_TIE of
    the larger (bfloat16 noise in the router's input moves them by about
    that much).  Returns the count of differing claims a call."""
    real, calls, flips = T_moe.route, iter(want_ids), []

    def forced(router, xt, cfg, C):
        own = real(router, xt, cfg, C)
        ids = torch.from_numpy(np.asarray(next(calls))).long()
        diff = (own.expert_ids != ids).nonzero().tolist()
        flips.append(len(diff))
        for g, s, k in diff:
            a = float(own.probs[g, s, own.expert_ids[g, s, k]])
            b = float(own.probs[g, s, ids[g, s, k]])
            assert abs(a - b) <= NEAR_TIE * max(a, b), (
                f"route ({g}, {s}, {k}): port expert "
                f"{int(own.expert_ids[g, s, k])} p={a:.6g}, reference "
                f"{int(ids[g, s, k])} p={b:.6g}: not a near tie")
        return T_moe.assign(own.probs, ids, C)

    monkeypatch.setattr(T_moe, "route", forced)
    return flips


@pytest.mark.parametrize("prompt", [24, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch, prompt, monkeypatch):
    """bfloat16 prefill and N_DECODE teacher-forced decode steps (the JAX
    side eager, so that its routes can be read): the port's own routes
    equal the reference's but at near ties; on the reference's routes (a
    flipped route moves its token by a whole expert's share, and the rest
    of its row with it) the logits and final KV cache within 5e-2."""
    rcfg, tcfg = _cfgs(arch, "bfloat16", kernel=True)
    want = _spy_reference_routes(monkeypatch)
    toks = _tokens(rcfg.vocab, prompt + N_DECODE)
    params = jax.tree.map(jnp.asarray, _reference(arch, "bfloat16"))
    lr, cr = R_models.prefill(params, jnp.asarray(toks[:, :prompt]), rcfg,
                              prompt + N_DECODE, cache_dtype=jnp.bfloat16)
    ref = [np.asarray(lr)]
    for i in range(N_DECODE):
        lr, cr = R_models.decode_step(params, cr, jnp.asarray(
            toks[:, prompt + i:][:, :1]), rcfg)
        ref.append(np.asarray(lr))
    jax.effects_barrier()
    assert len(want["ids"]) == (1 + N_DECODE) * rcfg.n_layers
    # _port_serve's forward of the first decode step (for its aux) routes
    # too, as that step does
    ids, n = want["ids"], rcfg.n_layers
    flips = _force_routes(monkeypatch, ids[:2 * n] + ids[n:])
    port, _, last_t, _ = _port_serve(arch, tcfg, "bfloat16", prompt)
    assert len(flips) == len(ids) + rcfg.n_layers
    for g, w in zip(port, ref):
        _close(g, w, TOLS["bfloat16"])
    for k in ("k", "v"):
        _close(last_t[k], cr["kv"][k], TOLS["bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_full_forward(arch):
    """At SMOKE's capacity factor 8.0 nothing drops, so prefill + decode
    equal the full forward position by position (tests/test_models_smoke.py
    holds the JAX package so); the prefill returns no aux."""
    _, tcfg = _cfgs(arch)
    model = T_models.from_reference(_reference(arch, "float32"), tcfg,
                                    device="cpu")
    toks = torch.from_numpy(_tokens(tcfg.vocab, 32, seed=5)).long()
    full, _, aux = T_models.forward(model, {"tokens": toks}, tcfg)
    assert float(aux["moe_dropped_frac"]) == 0.0
    cache = T_models.init_cache(tcfg, BATCH, 32, torch.float32, device="cpu")
    logits, cache, aux = T_models.forward(model, {"tokens": toks[:, :24]},
                                          tcfg, cache=cache)
    assert aux == {}
    torch.testing.assert_close(logits, full[:, :24], rtol=1e-4, atol=1e-4)
    for i in range(24, 32):
        logits, cache = T_models.decode_step(model, cache, toks[:, i:i + 1],
                                             tcfg)
        torch.testing.assert_close(logits[:, 0], full[:, i], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference_bfloat16(arch):
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    params = _reference(arch, "bfloat16")
    toks = _tokens(rcfg.vocab, 33, seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_r, m_r = R_model.loss_fn(jax.tree.map(jnp.asarray, params),
                                  {k: jnp.asarray(v) for k, v
                                   in batch.items()}, rcfg)
    model = T_model.from_reference(params, tcfg, device="cpu")
    loss_t, m_t = T_model.loss_fn(model, {k: torch.from_numpy(v).long()
                                          for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_allclose(float(m_t["moe_aux_loss"]),
                               float(m_r["moe_aux_loss"]), rtol=5e-2)


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #

def _state(arch: str, tcfg):
    params = _reference(arch, "float32")
    return T_step.from_reference((params, R_opt.init_adamw(params)), tcfg,
                                 device="cpu")


def _batch(cfg, b: int = 2, s: int = SEQ, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                  # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


_R_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(R_model.loss_fn, has_aux=True),
                            static_argnums=2)


def _value_and_grad_ref(params, batch, rcfg):
    (loss, _), grads = _R_VALUE_AND_GRAD(params, {k: jnp.asarray(v) for k, v
                                                  in batch.items()}, rcfg)
    return float(loss), T_model.reference_state(_np_tree(grads), rcfg)


def _assert_grads_close(grads, want):
    assert set(grads) == set(want)
    for k, g in grads.items():
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()) + 1e-6,
            err_msg=k)


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    rcfg, tcfg = _cfgs(arch, remat=remat)
    batch = _batch(rcfg)
    loss_r, grads_r = _value_and_grad_ref(_reference(arch, "float32"), batch,
                                          rcfg)
    grads, metrics = T_step.compute_grads(_state(arch, tcfg).params,
                                          _torch_batch(batch), tcfg)
    np.testing.assert_allclose(float(metrics["loss"]), loss_r, rtol=1e-5)
    _assert_grads_close(grads, grads_r)
    assert float(grads_r["blocks.0.moe.router"].std()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Three steps of 2 microbatches: losses and the averaged moe metrics
    within 1e-5 relative, the final master by the Adam rule.  The rule's
    tiny gradients are those of the gradient the step uses, the
    microbatches' mean (here the two microbatches' gradients of some
    expert weights cancel to float32 noise: +-0.0025 to 1e-8)."""
    rcfg, tcfg = _cfgs(arch)
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
        halves = [_value_and_grad_ref(rstate.params, {
            k: v[h * 2:(h + 1) * 2] for k, v in batch.items()}, rcfg)[1]
            for h in range(2)]
        g = {k: (halves[0][k] + halves[1][k]) / 2 for k in halves[0]}
        small = {k: (np.abs(v) < ADAM_TINY_GRAD) & (v != 0)
                 for k, v in g.items()}
        tiny = small if tiny is None else {k: tiny[k] | small[k] for k in g}
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        for k in ("loss", "ce", "moe_aux_loss", "moe_dropped_frac"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5,
                                       atol=AUX_ATOL,
                                       err_msg=f"{k}, step {step}")
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


def test_microbatched_step_averages_the_moe_metrics():
    _, tcfg = _cfgs("olmoe-1b-7b")
    assert set(T_step._zero_metrics(tcfg, "cpu")) == {
        "loss", "ce", "moe_aux_loss", "moe_dropped_frac"}
    dense = T_cfg.get_smoke_config("olmo-1b")
    assert set(T_step._zero_metrics(dense, "cpu")) == {"loss", "ce"}
    assert T_step.serving_kernel(T_cfg.get_config("olmoe-1b-7b")) == (
        "the flash-attention kernel has no backward", "_attention_core")


def _saved(tcfg, state, batch):
    """Gradients of one backward, the bytes its forward saved (autograd's
    saved tensors and the selective checkpoint's own cache) and the
    products the policy saved, as (operand shapes)."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_recomputes_the_expert_products(arch):
    """none, full and dots give the same gradients bit for bit; dots saves
    the four attention projections, the router's product and the shared
    experts' three, and recomputes the expert products (a batch dimension:
    the experts), so its saved bytes lie between full's and none's."""
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
    a, d, rows, m = tcfg.attention, tcfg.d_model, 2 * SEQ, tcfg.moe
    want = [((rows, d), (d, a.n_heads * a.head_dim)),
            ((rows, d), (d, a.n_kv_heads * a.head_dim)),
            ((rows, d), (d, a.n_kv_heads * a.head_dim)),
            ((1, rows, a.n_heads * a.head_dim), (1, a.n_heads * a.head_dim,
                                                 d)),
            ((rows, d), (d, m.n_experts))]
    if m.n_shared:
        sf = m.n_shared * (m.shared_dff or m.expert_dff)
        want += [((rows, d), (d, sf)), ((rows, d), (d, sf)),
                 ((rows, sf), (sf, d))]
    assert out["dots"][2] == want * tcfg.n_layers
    assert out["none"][2] == out["full"][2] == []


def test_remat_dots_policy_recomputes_batched_weights():
    """A weight operand with a batch dimension above 1 (the stacked
    experts) is recomputed; a batch of 1 (wo's einsum) is saved."""
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter(torch.randn(3, 4, 6, generator=g))
    x = torch.randn(3, 5, 4, generator=g, requires_grad=True)
    bmm = torch.ops.aten.bmm.default
    pol = functools.partial(T_model.remat_dots_policy, None)
    assert pol(bmm, x * 2, w) == CheckpointPolicy.PREFER_RECOMPUTE
    assert pol(bmm, x * 2, w.bfloat16().float()) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    assert pol(bmm, (x * 2)[:1], w[:1]) == CheckpointPolicy.MUST_SAVE


@pytest.mark.parametrize("arch", ARCHS)
def test_no_decay_leaves_are_the_reference_leaves(arch):
    """With zero gradients only weight decay moves the master: the router
    and the expert stacks decay, the norm scales do not, as the JAX path
    rule says."""
    rcfg, tcfg = _cfgs(arch)
    params = _reference(arch, "float32")
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
    assert {"blocks.0.moe.router", "blocks.0.moe.w_up",
            "blocks.1.moe.w_down"} <= got
    assert not any("norm" in k for k in got)


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_moe_on_cpu(arch, capsys):
    T_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "32", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 3 steps" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_moe_on_cpu(arch, capsys):
    report = T_launch_train.main(["--arch", arch, "--smoke", "--device",
                                  "cpu", "--steps", "4", "--seq", "32",
                                  "--batch", "4", "--microbatches", "2"])
    assert report.steps_completed == 4
    assert all(np.isfinite(report.losses))
    out = capsys.readouterr().out
    assert "steps=4" in out
