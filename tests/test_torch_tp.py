"""Tensor and expert parallelism over a mesh's model axis, on the CPU: the
dense and moe families.

A split model (``distributed.tensor_parallel``: one module a mesh
position, the Megatron layout of the rules) against the JAX package and
against the port's unsplit model, at SMOKE size, from the JAX package's
``init_params`` carried across by ``from_reference`` (seeded numpy
inputs):

* olmo, gemma2, stablelm, olmoe and deepseek split over (1, 2), (1, 4)
  and (2, 2) meshes of the CPU (gemma2's 2 KV heads at a model extent of
  4: the default rules' ``head_dim`` split, with its softcap, its local
  windows and its ``query_scale``), and over (2, 4) the layouts once
  refused: starcoder2 by a prefill cell's rules (``kv_seq``) and a decode
  cell's (``head_dim``), whisper by its heads (the encdec Megatron
  split): ``forward``, ``prefill`` and two teacher-forced
  ``decode_step``s against the JAX functions at float32 1e-4, and against
  the unsplit port at 1e-5 relative (logits and the gathered KV cache);
* moe routes bitwise equal on every shard and to the unsplit model's;
* one train step over (data 2, model 2) and (1, 2) against the unsplit
  step with as many microbatches, by T2's rule: the loss and grad_norm
  1e-5 relative; the gradients (read from the first moment, m = 0.1 ·
  clip · g) within 1e-4 max|g| + 1e-6; the whole step's master within
  the bound that follows Adam (``train.optimizer.master_gap_bound``: lr ·
  |Δm̂| / (√v̂ + eps) · 2 + 1e-5 |w| + 1e-6, Δm̂ the two states' measured
  first moments' difference), for every arch: an element of a gradient
  far below Adam's eps (deepseek's ``blocks.1.attn.wo`` holds one of
  1.2e-8, clipped to 1.5e-9) moves as far as its own float32 noise
  through the update can move it, and no further;
  the split state's checkpoint image is the unsplit image and loads back;
* ``logically_sharded`` raises on a whole tensor inside a sharding
  context and is a no-op outside one;
* the layout the port does not split (``kv_seq`` on the data axis of a
  dense model: batch 1 over (2, 2)) is refused, naming the axis (the ssm
  and hybrid families' splits: ``tests/test_torch_tp_ssm.py``; the
  context-parallel, head_dim and encdec splits in depth:
  ``tests/test_torch_tp_attn.py``);
* pieces keyed by position on a mesh that repeats one device, and the
  collectives' values and gradients.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R_cfg
import repro.models as R_models
from repro.train import optimizer as R_opt
import repro_torch.configs as T_cfg
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as T_mesh
from repro_torch.distributed import sharding as T_shard
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import model as T_model
from repro_torch.serve import step as T_serve
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

ARCHS = ("olmo-1b", "gemma2-27b", "stablelm-1.6b", "olmoe-1b-7b",
         "deepseek-moe-16b")
MESHES = ((1, 2), (1, 4), (2, 2))
# (arch, mesh, the cell whose rules the split takes: None for the default
# split_rules); gemma2's SMOKE config has 2 KV heads, so at a model extent
# of 4 the default rules put head_dim on the model axis
CASES = [(a, m, None) for a in ARCHS for m in MESHES] + [
    ("starcoder2-3b", (2, 4), "prefill"), ("starcoder2-3b", (2, 4), "decode"),
    ("whisper-large-v3", (2, 4), "prefill")]
BATCH, PROMPT, N_DECODE = 4, 12, 2
MAX_SEQ = 16            # a multiple of the model extents (the kv_seq rules)
JAX_TOL, SPLIT_RTOL = 1e-4, 1e-5

R_prefill = jax.jit(R_models.prefill, static_argnums=(2, 3),
                    static_argnames=("cache_dtype",))
R_decode = jax.jit(R_models.decode_step, static_argnums=(3,))


def _mesh(shape, dev="cpu"):
    return T_mesh.make_mesh(shape, ("data", "model"),
                            [dev] * int(np.prod(shape)))


def _cfgs(arch: str):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (R_cfg.get_smoke_config(arch).replace(**kw),
            T_cfg.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    rcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray,
                        R_models.init_params(jax.random.key(0), rcfg))


def _tokens(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, n),
                                                dtype=np.int32)


def _frames(cfg):
    """whisper's frames, None for a model without an encoder."""
    if cfg.family != "encdec":
        return None
    return np.random.default_rng(3).standard_normal(
        (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str):
    """The JAX forward, prefill and N_DECODE decode steps' logits and the
    last cache's K."""
    rcfg, _ = _cfgs(arch)
    params = jax.tree.map(jnp.asarray, _reference(arch))
    prompt = _tokens(rcfg.vocab, PROMPT, 1)
    forced = _tokens(rcfg.vocab, N_DECODE, 2)
    frames = _frames(rcfg)
    enc = {} if frames is None else {"frames": jnp.asarray(frames)}
    fwd, _, _ = R_models.forward(params, {"tokens": jnp.asarray(prompt),
                                          **enc}, rcfg)
    logits, cache = R_prefill(params, jnp.asarray(prompt), rcfg,
                              MAX_SEQ, cache_dtype=jnp.float32, **enc)
    out = [np.asarray(logits[:, -1])]
    for k in range(N_DECODE):
        logits, cache = R_decode(params, cache,
                                 jnp.asarray(forced[:, k:k + 1]), rcfg)
        out.append(np.asarray(logits[:, -1]))
    return (np.asarray(fwd), np.stack(out),
            np.asarray(cache["kv"]["k"]), prompt, forced)


def _port_run(model, cfg, prompt, forced):
    frames = _frames(cfg)
    enc = {} if frames is None else {"frames": torch.from_numpy(frames)}
    fwd, _, _ = T_model.forward(model, {"tokens": torch.from_numpy(
        prompt).long(), **enc}, cfg)
    pre = T_serve.make_prefill_step(cfg, MAX_SEQ, torch.float32)
    srv = T_serve.make_serve_step(cfg)
    logits, cache = pre(model, {"tokens": torch.from_numpy(prompt).long(),
                                **enc})
    out = [logits[:, -1]]
    for k in range(N_DECODE):
        logits, cache = srv(model, cache, {"tokens": torch.from_numpy(
            forced[:, k:k + 1]).long()})
        out.append(logits[:, -1])
    if getattr(model, "is_split", False):
        cache = model.gather_cache(cache)
    return fwd, torch.stack(out), cache["kv"]["k"]


def _rel_close(got, want):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=SPLIT_RTOL,
                               atol=SPLIT_RTOL * float(want.abs().max()))


@pytest.mark.parametrize("arch,shape,kind", CASES, ids=[
    f"{a}-{m[0]}x{m[1]}{'' if k is None else '-' + k}" for a, m, k in CASES])
def test_split_model_matches_jax_and_unsplit(arch, shape, kind):
    _, cfg = _cfgs(arch)
    whole = T_model.from_reference(_reference(arch), cfg, device="cpu")
    mesh = _mesh(shape)
    rules = None if kind is None else T_shard.resolve_rules(
        mesh, T_model.sharding_dims(cfg, BATCH, kv_seq=MAX_SEQ,
                                    q_seq=PROMPT if kind == "prefill" else 1))
    split = TP.split_model(whole, mesh, rules)
    assert len(split.pieces) == shape[0] * shape[1]
    layout = {"prefill": "kv_seq", "decode": "head_dim"}.get(kind)
    if arch == "whisper-large-v3":
        layout = "heads"
    elif arch == "gemma2-27b" and shape[1] == 4:
        layout = "head_dim"
    if layout is not None:
        assert split.attn_layout == layout
    r_fwd, r_logits, r_k, prompt, forced = _reference_run(arch)
    fwd, logits, k = _port_run(split, cfg, prompt, forced)
    for got, want in ((fwd, r_fwd), (logits, r_logits), (k, r_k)):
        np.testing.assert_allclose(got.numpy(), want, rtol=JAX_TOL,
                                   atol=JAX_TOL)
    w_fwd, w_logits, w_k = _port_run(whole, cfg, prompt, forced)
    for got, want in ((fwd, w_fwd), (logits, w_logits), (k, w_k)):
        _rel_close(got, want)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
@pytest.mark.parametrize("m", [2, 4])
def test_moe_routes_equal_on_every_shard(arch, m):
    from repro_torch.models import moe as MOE

    _, cfg = _cfgs(arch)
    whole = T_model.from_reference(_reference(arch), cfg, device="cpu")
    split = TP.split_model(whole, _mesh((1, m)))
    assert split.on_model("experts")
    real, seen = MOE.route, {"whole": [], "split": []}
    tokens = torch.from_numpy(_tokens(cfg.vocab, PROMPT, 3)).long()
    for name, model in (("whole", whole), ("split", split)):
        def spy(*a, _to=seen[name]):
            r = real(*a)
            _to.append(r)
            return r
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(MOE, "route", spy)
            T_model.forward(model, {"tokens": tokens}, cfg)
    assert len(seen["split"]) == m * len(seen["whole"]) == m * cfg.n_layers
    for i, want in enumerate(seen["whole"]):
        for r in seen["split"][i * m:(i + 1) * m]:
            assert torch.equal(r.expert_ids, want.expert_ids)
            assert torch.equal(r.kept, want.kept)


def _batch(cfg, b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                  # ignored positions
    return {"tokens": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(labels)}


def _state(arch, cfg):
    params = _reference(arch)
    return T_step.from_reference((params, R_opt.init_adamw(params)), cfg,
                                 device="cpu")


def _micro_mean_grads(state, cfg, batch, n):
    """The mean of the ``n`` microbatches' float32 gradients (the step's)."""
    b = batch["tokens"].shape[0] // n
    out = {}
    for i in range(n):
        g, _ = T_step.compute_grads(state.params, {
            k: v[i * b:(i + 1) * b].long() for k, v in batch.items()}, cfg)
        for k, t in g.items():
            out[k] = out[k] + t.float() if k in out else t.float()
    return {k: t / n for k, t in out.items()}


def _adam_master(want, got, opt, grad_norm):
    """T2's rule for a first step (see the module docstring): ``want`` and
    ``got`` the two states' images, ``grad_norm`` the reference step's.
    The first moments, m = (1 - b1) clip g, hold the split's gradients
    elementwise within (1 - b1) clip (1e-4 max|g| + 1e-6) of the
    reference's; the master is held by the bound that follows Adam from
    those moments."""
    step = int(want["opt/step"])
    assert step == 1
    clip = min(1.0, opt.grad_clip / float(grad_norm))
    keys = [k[len("opt/master/"):] for k in want if k.startswith("opt/master/")]
    for k in keys:
        m = want[f"opt/m/{k}"]
        bound = 1e-4 * float(m.abs().max()) + (1 - opt.b1) * clip * 1e-6
        assert float((got[f"opt/m/{k}"] - m).abs().max()) <= bound, k
        w = want[f"opt/master/{k}"]
        bound = T_opt.master_gap_bound(opt, step, w, want[f"opt/m/{k}"],
                                       got[f"opt/m/{k}"], want[f"opt/v/{k}"],
                                       opt.lr)
        assert ((got[f"opt/master/{k}"] - w).abs() <= bound).all(), k


STEP_CASES = [("olmo-1b", (2, 2), False), ("olmo-1b", (2, 2), True),
              ("olmo-1b", (1, 2), False), ("olmoe-1b-7b", (2, 2), False),
              ("deepseek-moe-16b", (2, 2), True),
              ("gemma2-27b", (2, 2), False)]


@pytest.mark.parametrize("arch,shape,in_scan", STEP_CASES, ids=[
    f"{a}-{m[0]}x{m[1]}{'-in_scan' if s else ''}" for a, m, s in STEP_CASES])
def test_split_step_by_t2_rule(arch, shape, in_scan):
    _, cfg = _cfgs(arch)
    opt = T_opt.AdamWConfig(lr=1e-3)
    batch = _batch(cfg)
    n_total = 4
    ref = _state(arch, cfg)
    grads = _micro_mean_grads(ref, cfg, batch, n_total)
    want, wm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                      n_microbatches=n_total)(ref, batch)
    split = T_step.shard_train_state(_state(arch, cfg), _mesh(shape))
    assert isinstance(split, T_step.SplitTrainState)
    step = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                  n_microbatches=n_total // shape[0],
                                  zero1_grads_in_scan=in_scan)
    got, gm = step(split, batch)
    for k in ("loss", "ce", "grad_norm"):
        torch.testing.assert_close(gm[k], wm[k], rtol=SPLIT_RTOL, atol=0)
    a, b = want.tree(), got.tree()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    # the moments against the gradients the reference step used
    clip = min(1.0, opt.grad_clip / float(wm["grad_norm"]))
    for k, g in grads.items():
        torch.testing.assert_close(a[f"opt/m/{k}"], (1 - opt.b1) * clip * g,
                                   rtol=1e-5, atol=1e-9)
    _adam_master(a, b, opt, wm["grad_norm"])


def test_split_state_image_loads_back_and_clones():
    arch = "olmo-1b"
    _, cfg = _cfgs(arch)
    split = T_step.shard_train_state(_state(arch, cfg), _mesh((2, 2)))
    # every (data, model) position's ZeRO piece is its own tensor
    for opt in split.opts:
        for k, leaf in opt.master.items():
            assert len(leaf.shards) == (1 if leaf.dim is None else 2), k
    image = split.tree()
    want = _state(arch, cfg).tree()
    assert image.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(image[k], v), k
    fresh = T_step.shard_train_state(T_step.init_train_state(1, cfg, "cpu"),
                                     _mesh((2, 2)))
    fresh.load_tree(image)
    for k, v in fresh.tree().items():
        assert torch.equal(v, want[k]), k
    twin = fresh.clone()
    assert all(torch.equal(x, y) for x, y in
               zip(twin.tree().values(), fresh.tree().values()))
    assert twin.opts[0].master["embed.tok"].shards[0].data_ptr() != \
        fresh.opts[0].master["embed.tok"].shards[0].data_ptr()


def test_pieces_are_keyed_by_position_on_one_device():
    _, cfg = _cfgs("olmo-1b")
    whole = T_model.init_params(0, cfg, device="cpu")
    split = TP.split_model(whole, _mesh((2, 2)))
    assert sorted(split.pieces) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    ptrs = [p.data_ptr() for m in split.modules() for p in m.parameters()]
    assert len(set(ptrs)) == len(ptrs)          # no two pieces share memory
    for (d, j), piece in split.pieces.items():
        wq = piece.blocks[0].attn["wq"]
        h = cfg.attention.n_heads // 2
        assert torch.equal(wq, whole.blocks[0].attn["wq"][:, j * h:(j + 1) * h])
        assert split.device(d, j) == torch.device("cpu")
    with torch.no_grad():
        split.pieces[(0, 1)].final_norm  # no leaves (non-parametric)
        split.pieces[(0, 0)].blocks[0].attn["wq"].add_(1.0)
    assert not torch.equal(split.pieces[(1, 0)].blocks[0].attn["wq"],
                           split.pieces[(0, 0)].blocks[0].attn["wq"])
    torch.testing.assert_close(split.gather().blocks[1].mlp["w_up"],
                               whole.blocks[1].mlp["w_up"], rtol=0, atol=0)


def test_logically_sharded_inside_a_context_only():
    _, cfg = _cfgs("olmo-1b")
    mesh = T_mesh.Mesh((1, 2), ("data", "model"))
    rules = T_shard.resolve_rules(mesh, T_model.sharding_dims(cfg, 4))
    H, hd = cfg.attention.n_heads, cfg.attention.head_dim
    whole = torch.zeros(4, H, 8, hd)
    spec = ("batch", "heads", "q_seq", "head_dim")
    assert T_shard.logically_sharded(whole, spec) is whole   # no context
    assert T_shard.current_rules() is None
    with T_shard.sharding_context(mesh, rules):
        assert T_shard.current_rules() is rules
        shard = torch.zeros(4, H // 2, 8, hd)
        assert T_shard.logically_sharded(shard, spec) is shard
        with pytest.raises(ValueError, match="heads"):
            T_shard.logically_sharded(whole, spec)
        # the unsplit model inside the context fails loudly
        model = T_model.init_params(0, cfg, device="cpu")
        with pytest.raises(ValueError, match="the model axis"):
            T_model.forward(model, {"tokens": torch.zeros(4, 8).long()},
                            cfg)
    assert T_shard.current_rules() is None


@pytest.mark.parametrize("arch,kind,axis", [
    ("olmo-1b", "decode", "kv_seq")])
def test_unsplit_layouts_are_refused(arch, kind, axis):
    """A dense model at batch 1 over (2, 2): the rules put ``kv_seq`` on
    the data axis, which the port splits for the hybrid family only (the
    layouts this test refused before -- ``kv_seq`` and ``head_dim`` on
    the model axis, the encdec family -- split now:
    ``test_split_model_matches_jax_and_unsplit``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D

    cfg = T_cfg.get_smoke_config(arch)
    mesh = T_mesh.Mesh((2, 2), ("data", "model"))
    s = 32
    rules = T_shard.resolve_rules(mesh, T_model.sharding_dims(
        cfg, 1, kv_seq=s, q_seq=1 if kind == "decode" else s))
    assert TP.unsupported_axes(cfg, rules) == [axis]
    with pytest.raises(NotImplementedError, match=axis):
        TP.split_model(T_model.model_class(cfg)(cfg), mesh, rules)
    rec = D.run_cell(arch, None, cfg_override=cfg, mesh=mesh,
                     shape=ShapeConfig("small", s, 1, kind))
    assert rec["status"] == "unsupported" and rec["axes"] == [axis]


def test_collectives_values_and_gradients():
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 4, generator=gen, requires_grad=True)
          for _ in range(3)]
    out = C.all_reduce(xs)
    want = (xs[0] + xs[1] + xs[2]).detach()
    assert all(torch.equal(o, want) for o in out)
    (out[0].sum() * 1 + out[2].sum() * 2).backward()
    assert all(torch.equal(x.grad, torch.full((3, 4), 3.0)) for x in xs)
    ys = [torch.randn(2, 3, generator=gen, requires_grad=True)
          for _ in range(2)]
    g = C.all_gather(ys, 1)
    assert all(torch.equal(t, torch.cat([y.detach() for y in ys], 1))
               for t in g)
    w = torch.randn(2, 6, generator=gen)
    (g[0] * w).sum().backward()
    assert torch.equal(ys[1].grad, w[:, 3:])
    zs = [torch.randn(4, 2, generator=gen, requires_grad=True)
          for _ in range(2)]
    r = C.reduce_scatter(zs, 0)
    tot = (zs[0] + zs[1]).detach()
    assert torch.equal(r[0], tot[:2]) and torch.equal(r[1], tot[2:])
    (r[1].sum()).backward()
    assert torch.equal(zs[0].grad[:2], torch.zeros(2, 2))
    assert torch.equal(zs[0].grad[2:], torch.ones(2, 2))
    # absent positions stand only on the meta device
    with pytest.raises(ValueError, match="meta"):
        C.all_reduce([torch.zeros(2)], extent=2)
    meta = C.all_gather([torch.empty(2, 3, device="meta")], 1, extent=4)
    assert meta[0].shape == (2, 12)
    assert C.reduce_scatter([torch.empty(8, device="meta")], 0,
                            extent=4)[0].shape == (2,)


def test_split_step_over_a_pod_axis():
    """(pod 2, data 1, model 2): the gradients all-reduced over the pods,
    the step by T2's rule against the unsplit step with as many
    microbatches, the image in the unsplit layout."""
    arch = "olmo-1b"
    _, cfg = _cfgs(arch)
    opt = T_opt.AdamWConfig(lr=1e-3)
    batch = _batch(cfg)
    ref = _state(arch, cfg)
    want, wm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                      n_microbatches=4)(ref, batch)
    mesh = T_mesh.make_mesh((2, 1, 2), ("pod", "data", "model"),
                            ["cpu"] * 4)
    split = T_step.shard_train_state(_state(arch, cfg), mesh)
    assert sorted(split.params.pieces) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    got, gm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                     n_microbatches=2)(split, batch)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(gm[k], wm[k], rtol=SPLIT_RTOL, atol=0)
    a, b = want.tree(), got.tree()
    assert a.keys() == b.keys()
    _adam_master(a, b, opt, wm["grad_norm"])
    # every pod's pieces hold the same new parameters
    for (d, j), piece in split.params.pieces.items():
        twin = split.params.pieces[(1 - d, j)]
        for (k, p), (_, q) in zip(piece.named_parameters(),
                                  twin.named_parameters()):
            assert torch.equal(p, q), k
