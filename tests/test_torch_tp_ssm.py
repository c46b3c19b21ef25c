"""The ssm and hybrid families split over a mesh's model axis, on the CPU.

mamba2-130m's and zamba2-7b's SMOKE configs (8 SSM heads of 16 channels;
the rules put ``inner`` on the model axis at extents 2 and 4, its gcd
being 8), from the JAX package's ``init_params`` carried across by
``from_reference``, float32, seeded numpy inputs:

* split over (1, 2), (1, 4) and (2, 2) meshes of the CPU (the mixer
  head-aligned: each shard z's, x's and dt's columns of its heads, B and C
  whole): ``forward``, ``prefill`` and two teacher-forced ``decode_step``s
  against the JAX functions at 1e-4 and against the unsplit port at 1e-5
  relative -- the logits, the gathered SSM state and conv carry, and
  zamba2's K/V;
* the replicated B/C conv carry bitwise equal on every shard, and each
  shard's SSD call (the kernel's wrapper, its plain version on the CPU)
  equal to ``ssd_chunked`` over the shard's heads; the shard's x, B and C
  views at zamba2-7b's widths pass to the kernel uncopied;
* replicas: a mamba2 SMOKE config whose vocabulary (258) and ``inner`` gcd
  (2) the model extent 4 does not divide runs the unsplit program on every
  position, bitwise, and its dry-run records on (2, 4) equal those on
  (2,) in FLOPs, bytes and collective bytes;
* one hybrid train step over (data 2, model 2) against the unsplit step
  with as many microbatches, by T2's rule with the master held to the
  bound that follows Adam (``train.optimizer.master_gap_bound``); the
  split state's image is the unsplit image, and loads back;
* zamba2's decode at batch 1 over (2, 2): the batch run whole by each
  data position, the shared block's K/V along the sequence over the data
  positions, each decode step's attention combining their partial
  softmaxes, against the unsplit port and JAX;
* the production cells ``decode_32k`` of both archs on meta: "ok",
  zamba2's cache bytes by hand, mamba2's record without a collective;
* an extent that does not divide the SSM heads is refused.
"""
import dataclasses
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
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import mesh as T_mesh
from repro_torch.distributed import sharding as T_shard
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ssd_scan as T_ssd_kernel
from repro_torch.launch import dryrun as D
from repro_torch.models import model as T_model
from repro_torch.models import ssm as T_ssm
from repro_torch.serve import step as T_serve
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

ARCHS = ("mamba2-130m", "zamba2-7b")
MESHES = ((1, 2), (1, 4), (2, 2))
CASES = [(a, m) for a in ARCHS for m in MESHES]
BATCH, PROMPT, N_DECODE = 4, 12, 2
JAX_TOL, SPLIT_RTOL = 1e-4, 1e-5

R_prefill = jax.jit(R_models.prefill, static_argnums=(2, 3),
                    static_argnames=("cache_dtype",))
R_decode = jax.jit(R_models.decode_step, static_argnums=(3,))
R_forward = jax.jit(R_models.forward, static_argnums=(2,))


def _mesh(shape):
    return T_mesh.make_mesh(shape, ("data", "model"),
                            ["cpu"] * int(np.prod(shape)))


def _cfgs(arch: str):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (R_cfg.get_smoke_config(arch).replace(**kw),
            T_cfg.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    rcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray,
                        R_models.init_params(jax.random.key(0), rcfg))


def _tokens(vocab, b, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, n),
                                                dtype=np.int32)


def _caches(cache) -> dict:
    """The cache's leaves by name (``ssm/state``, ``kv/k``, ...)."""
    return {f"{part}/{n}": np.asarray(t) for part in ("ssm", "kv")
            if part in cache for n, t in cache[part].items()}


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, batch: int = BATCH):
    """The JAX forward, prefill and N_DECODE decode steps' logits and the
    last cache's leaves."""
    rcfg, _ = _cfgs(arch)
    params = jax.tree.map(jnp.asarray, _reference(arch))
    prompt = _tokens(rcfg.vocab, batch, PROMPT, 1)
    forced = _tokens(rcfg.vocab, batch, N_DECODE, 2)
    fwd, _, _ = R_forward(params, {"tokens": jnp.asarray(prompt)}, rcfg)
    logits, cache = R_prefill(params, jnp.asarray(prompt), rcfg,
                              PROMPT + N_DECODE, cache_dtype=jnp.float32)
    out = [np.asarray(logits[:, -1])]
    for k in range(N_DECODE):
        logits, cache = R_decode(params, cache,
                                 jnp.asarray(forced[:, k:k + 1]), rcfg)
        out.append(np.asarray(logits[:, -1]))
    return np.asarray(fwd), np.stack(out), _caches(cache), prompt, forced


def _port_run(model, cfg, prompt, forced, keep=None):
    """Forward, prefill and teacher-forced decode of a whole or split
    model: (forward logits, the steps' last logits, the last cache's
    leaves in the unsplit layout).  ``keep`` receives the split cache."""
    fwd, _, _ = T_model.forward(model, {"tokens": torch.from_numpy(
        prompt).long()}, cfg)
    pre = T_serve.make_prefill_step(cfg, PROMPT + N_DECODE, torch.float32)
    srv = T_serve.make_serve_step(cfg)
    logits, cache = pre(model, {"tokens": torch.from_numpy(prompt).long()})
    out = [logits[:, -1]]
    for k in range(forced.shape[1]):
        logits, cache = srv(model, cache, {"tokens": torch.from_numpy(
            forced[:, k:k + 1]).long()})
        out.append(logits[:, -1])
    if getattr(model, "is_split", False):
        if keep is not None:
            keep.update(cache)
        cache = model.gather_cache(cache)
    return fwd, torch.stack(out), {k: torch.as_tensor(v) for k, v in
                                   _caches(cache).items()}


def _rel_close(got, want):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=SPLIT_RTOL,
                               atol=SPLIT_RTOL * float(want.abs().max()))


def _check_run(got, want_jax, want_whole):
    for g, w in zip(got[:2], want_jax[:2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=JAX_TOL, atol=JAX_TOL)
    assert got[2].keys() == want_jax[2].keys() == want_whole[2].keys()
    for k, g in got[2].items():
        np.testing.assert_allclose(g.numpy(), want_jax[2][k], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=k)
    for g, w in zip(got[:2], want_whole[:2]):
        _rel_close(g, w)
    for k, g in got[2].items():
        _rel_close(g, want_whole[2][k])


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in CASES])
def test_split_model_matches_jax_and_unsplit(arch, shape):
    _, cfg = _cfgs(arch)
    whole = T_model.from_reference(_reference(arch), cfg, device="cpu")
    split = TP.split_model(whole, _mesh(shape))
    assert split.ssm_split and not split.replicas
    r_fwd, r_logits, r_cache, prompt, forced = _reference_run(arch)
    kept = {}
    got = _port_run(split, cfg, prompt, forced, kept)
    _check_run(got, (r_fwd, r_logits, r_cache),
               _port_run(whole, cfg, prompt, forced))
    # the shards' B and C conv carries are the same to the bit
    n = cfg.ssm.d_state
    for d in split.data_indices():
        carries = [kept["pieces"][(d, j)]["ssm"]["conv"][..., -2 * n:]
                   for j, _ in split.group(d)]
        assert all(torch.equal(c, carries[0]) for c in carries[1:])


def test_shard_ssd_calls_are_ssd_chunked_on_their_heads():
    """With the kernel knob on, each shard makes one SSD call a layer over
    its heads; each call equals ``ssd_chunked`` on the same inputs."""
    _, cfg = _cfgs("zamba2-7b")
    cfg = cfg.replace(use_flash_kernel=True)
    whole = T_model.from_reference(_reference("zamba2-7b"), cfg,
                                   device="cpu")
    m = 4
    split = TP.split_model(whole, _mesh((1, m)))
    calls, real = [], T_ops.ssd_scan

    def spy(x, dt, A, B, C, **kw):
        y, st = real(x, dt, A, B, C, **kw)
        init = kw["initial_state"]          # a view of the cache: kept
        calls.append(((x, dt, A, B, C), dict(
            kw, initial_state=None if init is None else init.clone()), y,
            st))
        return y, st

    prompt = torch.from_numpy(_tokens(cfg.vocab, BATCH, 40, 5)).long()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_ops, "ssd_scan", spy)
        T_model.prefill(split, prompt, cfg, 48, cache_dtype=torch.float32)
    heads = T_ssm.ssm_dims(cfg)[1] // m
    assert len(calls) == m * cfg.n_layers
    for (x, dt, A, B, C), kw, y, st in calls:
        assert x.shape[2] == heads and A.shape == (heads,)
        want_y, want_st = T_ssm.ssd_chunked(
            x, dt, A, B, C, chunk=kw["chunk"],
            initial_state=kw["initial_state"])
        torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(st, want_st, rtol=1e-5, atol=1e-5)


def test_shard_views_pass_to_the_kernel_uncopied():
    """zamba2-7b at 16 shards: 7 heads of 64 channels and B, C of 64 each,
    576 conv channels; the x, B and C views of the conv output have the
    strides and alignment the tensor-core kernel reads in place."""
    cfg = T_cfg.get_config("zamba2-7b")
    dis, hs = T_ssm.shard_dims(cfg, 16)
    n = cfg.ssm.d_state
    assert (dis, hs) == (448, 7)
    out = torch.zeros(2, 256, dis + 2 * n, dtype=torch.bfloat16)
    x = out[..., :dis].reshape(2, 256, hs, cfg.ssm.head_dim)
    B, C = out[..., dis:dis + n], out[..., dis + n:]
    for v in (x, B, C):
        assert T_ssd_kernel._aligned(v) is v


def _replica_cfg():
    """mamba2 SMOKE with a vocabulary of 258 and 17 SSM states: ``inner``'s
    gcd is 2 and nothing of the model divides a model extent of 4."""
    cfg = T_cfg.get_smoke_config("mamba2-130m").replace(
        param_dtype="float32", compute_dtype="float32", vocab=258)
    return cfg.replace(ssm=dataclasses.replace(cfg.ssm, d_state=17))


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)])
def test_replicas_run_the_unsplit_program_bitwise(shape):
    cfg = _replica_cfg()
    whole = T_model.init_params(0, cfg, device="cpu")
    split = TP.split_model(whole, _mesh(shape))
    assert split.replicas and not split.ssm_split
    assert not split.on_model("vocab")
    prompt = torch.from_numpy(_tokens(cfg.vocab, BATCH, PROMPT, 1)).long()
    per = BATCH // shape[0]
    got = T_model._split_recurrent(
        split, split.data_indices(),
        {d: {"tokens": prompt[d * per:(d + 1) * per]}
         for d in split.data_indices()}, cfg)
    for d, logits in got.items():
        want, _, _ = T_model.forward(
            whole, {"tokens": prompt[d * per:(d + 1) * per]}, cfg)
        assert len(logits) == shape[1]
        assert all(torch.equal(lg, want) for lg in logits)
    if shape[0] == 1:           # and through the serving steps, caches too
        forced = _tokens(cfg.vocab, BATCH, N_DECODE, 2)
        w = _port_run(whole, cfg, prompt.numpy(), forced)
        s = _port_run(split, cfg, prompt.numpy(), forced)
        assert all(torch.equal(a, b) for a, b in zip(s[:2], w[:2]))
        assert all(torch.equal(s[2][k], w[2][k]) for k in w[2])


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_replica_records_equal_a_mesh_without_a_model_axis(kind):
    cfg = _replica_cfg()
    shape = ShapeConfig("small", 16, 8, kind)
    recs = [D.run_cell("mamba2-130m", None, cfg_override=cfg, shape=shape,
                       mesh=mesh, n_microbatches=2)
            for mesh in (T_mesh.Mesh((2, 4), ("data", "model")),
                         T_mesh.Mesh((2,), ("data",)))]
    assert all(r["status"] == "ok" for r in recs)
    a, b = recs[0]["cost"], recs[1]["cost"]
    for k in ("dot_flops", "bytes_accessed", "collective_bytes",
              "collective_counts"):
        assert a[k] == b[k], k
    assert "all-reduce" not in a["collective_bytes"] or kind == "train"
    assert recs[0]["memory_per_device"] == recs[1]["memory_per_device"]


def _batch(cfg, b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    return {"tokens": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(labels)}


def _state(arch, cfg):
    params = _reference(arch)
    return T_step.from_reference((params, R_opt.init_adamw(params)), cfg,
                                 device="cpu")


def test_hybrid_step_by_t2_rule_and_image():
    arch = "zamba2-7b"
    _, cfg = _cfgs(arch)
    opt = T_opt.AdamWConfig(lr=1e-3)
    batch = _batch(cfg)
    split = T_step.shard_train_state(_state(arch, cfg), _mesh((2, 2)))
    assert isinstance(split, T_step.SplitTrainState)
    # the image before the step is the unsplit state's, and loads back
    image, want0 = split.tree(), _state(arch, cfg).tree()
    assert image.keys() == want0.keys()
    assert all(torch.equal(image[k], v) for k, v in want0.items())
    fresh = T_step.shard_train_state(T_step.init_train_state(1, cfg, "cpu"),
                                     _mesh((2, 2)))
    fresh.load_tree(image)
    assert all(torch.equal(v, want0[k]) for k, v in fresh.tree().items())
    want, wm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                      n_microbatches=4)(_state(arch, cfg),
                                                        batch)
    got, gm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                     n_microbatches=2)(split, batch)
    for k in ("loss", "ce", "grad_norm"):
        torch.testing.assert_close(gm[k], wm[k], rtol=SPLIT_RTOL, atol=0)
    a, b = want.tree(), got.tree()
    assert a.keys() == b.keys()
    step = int(a["opt/step"])
    for k in a:
        if not k.startswith("opt/master/"):
            continue
        n = k[len("opt/master/"):]
        g = (a[f"opt/m/{n}"] / (1 - opt.b1)).abs()      # clip · |g|
        bound = (1 - opt.b1) * (1e-4 * float(g.max()) + 1e-6)
        assert float((b[f"opt/m/{n}"] - a[f"opt/m/{n}"]).abs().max()) \
            <= bound, n
        gap = T_opt.master_gap_bound(opt, step, a[k], a[f"opt/m/{n}"],
                                     b[f"opt/m/{n}"], a[f"opt/v/{n}"],
                                     opt.lr)
        assert ((b[k] - a[k]).abs() <= gap).all(), n
    # the head-aligned pieces' B and C columns stay equal on the shards
    for o in got.opts[1:]:
        for k, leaf in o.master.items():
            lay = got.params.layouts[k]
            for off, n in lay.shared():
                ours = leaf.gather().narrow(lay.dim, off, n)
                first = got.opts[0].master[k].gather().narrow(lay.dim, off, n)
                assert torch.equal(ours, first), k


def test_hybrid_decode_with_the_kv_sequence_over_data():
    arch = "zamba2-7b"
    _, cfg = _cfgs(arch)
    whole = T_model.from_reference(_reference(arch), cfg, device="cpu")
    split = TP.split_model(whole, _mesh((2, 2)))
    assert not split.batch_split(1) and split.seq_split(1, PROMPT + N_DECODE)
    r_fwd, r_logits, r_cache, prompt, forced = _reference_run(arch, 1)
    kept = {}
    got = _port_run(split, cfg, prompt, forced, kept)
    assert kept["seq_parts"] == 2
    assert kept["pieces"][(0, 0)]["kv"]["k"].shape[3] == \
        (PROMPT + N_DECODE) // 2
    _check_run(got, (r_fwd, r_logits, r_cache),
               _port_run(whole, cfg, prompt, forced))


def test_production_decode_cells_on_meta():
    rec = D.run_cell("zamba2-7b", "decode_32k", False)
    assert rec["status"] == "ok", rec
    assert {"inner", "heads", "kv_heads", "mlp", "vocab"} <= set(
        rec["model_axes"])
    cfg = T_cfg.get_config("zamba2-7b")
    dis, hs = T_ssm.shard_dims(cfg, 16)
    rows, s = 8, 32768
    kv = (cfg.n_layers // cfg.shared_attn_every) * rows * 2 * s * 112 * 2 * 2
    state = cfg.n_layers * rows * hs * 64 * cfg.ssm.d_state * 4
    conv = cfg.n_layers * rows * 3 * (dis + 2 * cfg.ssm.d_state) * 4
    assert rec["memory_per_device"]["cache_bytes"] == kv + state + conv
    rec = D.run_cell("mamba2-130m", "decode_32k", False)
    assert rec["status"] == "ok", rec
    assert rec["cost"]["collective_bytes"] == {}
    assert rec["cost"]["dot_flops"] > 0


def test_an_extent_that_does_not_divide_the_heads_is_refused():
    _, cfg = _cfgs("zamba2-7b")
    with pytest.raises(ValueError, match="SSM heads"):
        T_ssm.shard_dims(cfg, 3)
    mesh = T_mesh.make_mesh((1, 3), ("data", "model"), ["cpu"] * 3)
    rules = TP.split_rules(cfg, mesh)
    forced = T_shard.ShardingRules(dict(rules.table, inner=("model",)),
                                   rules.dims)
    model = T_model.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="SSM heads"):
        TP.split_model(model, mesh, forced)
