"""The last layouts over a model axis, on the CPU: context parallelism
(``kv_seq`` on the model axis), the ``head_dim`` split and the encdec
family's split (``models/parallel_attention.py``,
``distributed/tensor_parallel.py``).

* The combine against the whole call: the flash kernel's plain version
  over parts of the keys (each with its diagonal offset and its row
  statistics), combined by ``parallel_attention.combine``, equals the
  call over every key at float32 1e-6 -- causal, unmasked, softcap 50,
  empty parts and uneven parts; the plain form with statistics
  (``part_attention``) with a sliding window across the parts against
  ``_attention_core``.  The statistics against ``torch.logsumexp`` of the
  plain scores: m + log l, and a row that sees no key at m = -1e30, l = 0.
* Split models against the JAX package and the unsplit port, at SMOKE
  size from the JAX package's ``init_params`` (seeded numpy inputs):
  starcoder2 (a 40-token prompt, so its 32-token window is narrower than
  the prompt) and qwen2-vl (M-RoPE with three distinct position streams;
  at a model extent of 4 its sections (2, 3, 3) put a boundary inside
  shard 2) at (1, 4) and (2, 4); whisper at (1, 2) and (1, 4) (its heads
  divide: the Megatron split of the encdec family) and at (1, 8), also at
  ``enc_seq=20`` (uneven frame parts).  Each under the prefill cell's
  rules (``kv_seq``, or ``heads``) and the decode cell's (``head_dim``):
  ``forward``, ``prefill`` and two teacher-forced ``decode_step``s
  against the JAX functions at float32 1e-4, and against the unsplit
  port at 1e-5 relative (the logits, and the gathered caches).
* Serving across the two rule sets: a prefill under ``kv_seq``, the
  cache carried by ``gather_cache`` then ``split_cache`` to the
  ``head_dim`` split, decode there; ``split_cache`` inverts
  ``gather_cache`` bit for bit.
* Train steps over (1, 4) and (2, 4) (starcoder2, a 40-token sequence)
  and (1, 8) (whisper) under the train cell's ``kv_seq`` rules, against
  the unsplit step with as many microbatches by T2's rule, the master
  held to ``train.optimizer.master_gap_bound``.
* An int8 KV cache is refused under both new layouts.
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
from repro_torch.distributed import mesh as T_mesh
from repro_torch.distributed import sharding as T_shard
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as T_layers
from repro_torch.models import model as T_model
from repro_torch.models import parallel_attention as PA
from repro_torch.serve import step as T_serve
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

JAX_TOL, SPLIT_RTOL, COMBINE_TOL = 1e-4, 1e-5, 1e-6
BATCH, N_DECODE = 4, 2
# prompt and max_seq a config is served at: max_seq divides the model
# extents (the kv_seq rules need it), starcoder2's prompt is wider than
# its 32-token window
SERVE = {"starcoder2-3b": (40, 48), "qwen2-vl-7b": (12, 16),
         "whisper-large-v3": (8, 16)}

R_prefill = jax.jit(R_models.prefill, static_argnums=(2, 3),
                    static_argnames=("cache_dtype",))
R_decode = jax.jit(R_models.decode_step, static_argnums=(3,))
R_forward = jax.jit(R_models.forward, static_argnums=(2,))


# --------------------------------------------------------------- combine
def _qkv(bg, r, sq, skv, d, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(bg, r, sq, d, generator=g),
            torch.randn(bg, skv, d, generator=g),
            torch.randn(bg, skv, d, generator=g))


def _combined(q, k, v, sizes, **kw):
    """The plain flash version over key parts of ``sizes``, combined."""
    skv, sq = k.shape[1], q.shape[2]
    parts, start = [], 0
    for n in sizes:
        if n == 0:
            parts.append(FA.empty_stats(q))
        else:
            parts.append(FA.flash_attention_plain(
                q, k[:, start:start + n], v[:, start:start + n],
                off=skv - sq - start, stats=True, **kw))
        start += n
    out = PA.combine(parts, extent=len(sizes), origin=True)
    assert all(torch.equal(o, out[0]) for o in out[1:])
    return out[0]


@pytest.mark.parametrize("case,sizes,causal,softcap", [
    ("causal", (8, 8, 8, 8), True, None),
    ("unmasked", (8, 8, 8, 8), False, None),
    ("softcap", (6, 10, 8, 8), True, 50.0),
    ("empty", (20, 0, 12, 0), True, None),
    ("uneven", (3, 3, 3, 3, 2, 2, 2, 2), False, None)])
def test_parts_combine_to_the_whole_call(case, sizes, causal, softcap):
    q, k, v = _qkv(2, 3, 20, sum(sizes), 16, 5)
    if case == "softcap":
        q = q * 8.0                     # scores the softcap moves
    kw = dict(scale=0.25, causal=causal, softcap=softcap)
    want = FA.flash_attention_plain(q, k, v, **kw)
    got = _combined(q, k, v, sizes, **kw)
    torch.testing.assert_close(got, want, rtol=COMBINE_TOL, atol=COMBINE_TOL)


def test_window_parts_combine_to_the_plain_attention():
    """A 6-key window across parts of 5 keys, the queries at positions 20
    ... 39 (a step behind earlier tokens), against ``_attention_core``
    over every key."""
    g = torch.Generator().manual_seed(7)
    qg = torch.randn(2, 2, 2, 20, 16, generator=g)
    k, v = (torch.randn(2, 2, 40, 16, generator=g) for _ in range(2))
    kw = dict(scale=0.25, softcap=None, cdt=torch.float32)
    want = T_layers._attention_core(
        qg, k, v, causal=True, sliding_window=6, local_flag=True,
        q_offset=20, kv_valid=40, q_chunk=512, **kw)
    q_pos = torch.arange(20) + 20
    parts = [PA.part_attention(qg, k[:, :, s:s + 5], v[:, :, s:s + 5],
                               causal=True, window=6, q_pos=q_pos,
                               k_pos=torch.arange(5) + s, kv_valid=40, **kw)
             for s in range(0, 40, 5)]
    assert bool((parts[0][2] == 0).all())        # behind every window
    got = PA.combine(parts, extent=8, origin=True)[0]
    torch.testing.assert_close(got, want, rtol=COMBINE_TOL, atol=COMBINE_TOL)


@pytest.mark.parametrize("off", [0, -7, 5])
def test_statistics_are_the_rows_logsumexp(off):
    q, k, v = _qkv(2, 2, 12, 10, 16, 9)
    _, m, l = FA.flash_attention_plain(q, k, v, scale=0.3, softcap=50.0,
                                       off=off, stats=True)
    s = torch.tanh(torch.einsum("brsd,btd->brst", q, k) * 0.3 / 50.0) * 50.0
    vis = torch.arange(10)[None, :] <= torch.arange(12)[:, None] + off
    lse = torch.where(vis, s, -torch.inf).logsumexp(dim=-1)
    seen = vis.any(dim=-1).expand_as(l)
    torch.testing.assert_close((m + l.log())[seen], lse[seen], rtol=1e-6,
                               atol=1e-6)
    assert bool((l[~seen] == 0).all()) and bool((m[~seen] == -1e30).all())
    # part_attention gives the same statistics
    _, pm, pl = PA.part_attention(
        q.reshape(2, 1, 2, 12, 16), k[:, None], v[:, None], scale=0.3,
        softcap=50.0, causal=True, window=None, q_pos=torch.arange(12) + off,
        k_pos=torch.arange(10), kv_valid=None, cdt=torch.float32)
    torch.testing.assert_close(pm.reshape(m.shape), m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(pl.reshape(l.shape), l, rtol=1e-6, atol=1e-6)


def test_balanced_parts():
    assert PA.balanced_parts(1500, 16) == [
        (94 * j, 94) for j in range(12)] + [(1128 + 93 * j, 93)
                                             for j in range(4)]
    assert [n for _, n in PA.balanced_parts(3, 4)] == [1, 1, 1, 0]


# -------------------------------------------------- split models vs JAX
def _cfgs(arch: str, **kw):
    kw = dict(param_dtype="float32", compute_dtype="float32", **kw)
    return (R_cfg.get_smoke_config(arch).replace(**kw),
            T_cfg.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _reference(arch: str, enc_seq=None):
    rcfg, _ = _cfgs(arch, **_extra(enc_seq))
    return jax.tree.map(np.asarray,
                        R_models.init_params(jax.random.key(0), rcfg))


def _extra(enc_seq):
    return {} if enc_seq is None else {"enc_seq": enc_seq}


def _inputs(cfg, b: int = BATCH):
    """The prompt, the forced tokens, and for qwen2-vl the (B, 3, S)
    M-RoPE positions of both (three distinct streams), for whisper the
    frames."""
    prompt, max_seq = SERVE[_arch(cfg)]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (b, prompt + N_DECODE), dtype=np.int32)
    out = {"prompt": toks[:, :prompt], "forced": toks[:, prompt:]}
    if cfg.attention.rope is not None and \
            cfg.attention.rope.mrope_sections is not None:
        p = np.arange(prompt + N_DECODE)
        pos = np.stack([p, p // 3, p % 5])[None].repeat(b, 0)
        out["positions"] = pos.astype(np.int32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out, max_seq


def _arch(cfg) -> str:
    return {"starcoder2-smoke": "starcoder2-3b", "qwen2-vl-smoke":
            "qwen2-vl-7b", "whisper-smoke": "whisper-large-v3"}[cfg.name]


def _leaves(cache) -> dict:
    out = {f"kv/{n}": t for n, t in cache["kv"].items()}
    for n in ("cross_k", "cross_v"):
        if n in cache:
            out[n] = cache[n]
    return {k: np.asarray(v) for k, v in out.items()}


def _step_batch(inp, lo, hi, torch_side: bool):
    batch = {"tokens": np.concatenate([inp["prompt"], inp["forced"]],
                                      1)[:, lo:hi]}
    if "positions" in inp:
        batch["positions"] = inp["positions"][..., lo:hi]
    conv = (lambda a: torch.from_numpy(a).long()) if torch_side else \
        jnp.asarray
    return {k: conv(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, enc_seq=None):
    """The JAX forward, prefill and N_DECODE decode steps' logits and the
    last cache's leaves."""
    rcfg, _ = _cfgs(arch, **_extra(enc_seq))
    params = jax.tree.map(jnp.asarray, _reference(arch, enc_seq))
    inp, max_seq = _inputs(rcfg)
    S = inp["prompt"].shape[1]
    pre = _step_batch(inp, 0, S, False)
    fw = dict(pre)
    kw = {}
    if "frames" in inp:
        fw["frames"] = kw["frames"] = jnp.asarray(inp["frames"])
    if "positions" in pre:
        kw["positions"] = pre["positions"]
    fwd, _, _ = R_forward(params, fw, rcfg)
    logits, cache = R_prefill(params, pre["tokens"], rcfg, max_seq,
                              cache_dtype=jnp.float32, **kw)
    out = [np.asarray(logits[:, -1])]
    for t in range(N_DECODE):
        b = _step_batch(inp, S + t, S + t + 1, False)
        logits, cache = R_decode(params, cache, b["tokens"], rcfg,
                                 **({"positions": b["positions"]}
                                    if "positions" in b else {}))
        out.append(np.asarray(logits[:, -1]))
    return np.asarray(fwd), np.stack(out), _leaves(cache)


def _prefill(model, cfg, inp, max_seq):
    S = inp["prompt"].shape[1]
    batch = _step_batch(inp, 0, S, True)
    if "frames" in inp:
        batch["frames"] = torch.from_numpy(inp["frames"])
    return T_serve.make_prefill_step(cfg, max_seq, torch.float32)(model,
                                                                  batch)


def _decode(model, cfg, inp, cache, out):
    S = inp["prompt"].shape[1]
    srv = T_serve.make_serve_step(cfg)
    for t in range(N_DECODE):
        logits, cache = srv(model, cache, _step_batch(inp, S + t, S + t + 1,
                                                      True))
        out.append(logits[:, -1])
    return torch.stack(out), cache


def _port_run(model, cfg, inp, max_seq):
    S = inp["prompt"].shape[1]
    fw = _step_batch(inp, 0, S, True)
    if "frames" in inp:
        fw["frames"] = torch.from_numpy(inp["frames"])
    fwd, _, _ = T_model.forward(model, fw, cfg)
    logits, cache = _prefill(model, cfg, inp, max_seq)
    steps, cache = _decode(model, cfg, inp, cache, [logits[:, -1]])
    if getattr(model, "is_split", False):
        cache = model.gather_cache(cache)
    return fwd, steps, {k: torch.as_tensor(v)
                        for k, v in _leaves(cache).items()}


@functools.lru_cache(maxsize=None)
def _whole_run(arch: str, enc_seq=None):
    _, cfg = _cfgs(arch, **_extra(enc_seq))
    whole = T_model.from_reference(_reference(arch, enc_seq), cfg,
                                   device="cpu")
    inp, max_seq = _inputs(cfg)
    return _port_run(whole, cfg, inp, max_seq)


def _mesh(shape):
    return T_mesh.make_mesh(shape, ("data", "model"),
                            ["cpu"] * int(np.prod(shape)))


def _rules(cfg, mesh, kind: str, batch: int = BATCH):
    """The rules of a prefill (``q_seq`` the prompt) or decode cell
    (``q_seq`` 1) of ``cfg``'s serving sizes on ``mesh``."""
    prompt, max_seq = SERVE[_arch(cfg)]
    return T_shard.resolve_rules(mesh, T_model.sharding_dims(
        cfg, batch, kv_seq=max_seq, q_seq=prompt if kind == "prefill"
        else 1))


def _rel_close(got, want, msg=""):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=SPLIT_RTOL,
                               atol=SPLIT_RTOL * float(want.abs().max()),
                               msg=msg)


CASES = ([(a, m, k, None) for a in ("starcoder2-3b", "qwen2-vl-7b")
          for m in ((1, 4), (2, 4)) for k in ("prefill", "decode")]
         + [("whisper-large-v3", m, k, None) for m in ((1, 2), (1, 4))
            for k in ("prefill", "decode")]
         + [("whisper-large-v3", (1, 8), k, e)
            for k in ("prefill", "decode") for e in (None, 20)])
LAYOUT = {"prefill": "kv_seq", "decode": "head_dim"}


@pytest.mark.parametrize("arch,shape,kind,enc_seq", CASES, ids=[
    f"{a}-{m[0]}x{m[1]}-{k}{'' if e is None else f'-enc{e}'}"
    for a, m, k, e in CASES])
def test_split_model_matches_jax_and_unsplit(arch, shape, kind, enc_seq):
    _, cfg = _cfgs(arch, **_extra(enc_seq))
    whole = T_model.from_reference(_reference(arch, enc_seq), cfg,
                                   device="cpu")
    mesh = _mesh(shape)
    split = TP.split_model(whole, mesh, _rules(cfg, mesh, kind))
    heads = cfg.attention.n_heads % shape[1] == 0 and \
        cfg.attention.n_kv_heads % shape[1] == 0
    assert split.attn_layout == ("heads" if heads else LAYOUT[kind])
    assert split.on_model("mlp") and split.on_model("vocab")
    inp, max_seq = _inputs(cfg)
    got = _port_run(split, cfg, inp, max_seq)
    want = _reference_run(arch, enc_seq)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=JAX_TOL, atol=JAX_TOL)
    assert got[2].keys() == want[2].keys()
    for k, g in got[2].items():
        np.testing.assert_allclose(g.numpy(), want[2][k], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=k)
    w = _whole_run(arch, enc_seq)
    for g, x in zip(got[:2], w[:2]):
        _rel_close(g, x)
    for k, g in got[2].items():
        _rel_close(g, w[2][k], k)


@pytest.mark.parametrize("arch,shape", [("starcoder2-3b", (2, 4)),
                                        ("whisper-large-v3", (1, 8))])
def test_serving_across_the_two_rule_sets(arch, shape):
    """Prefill under the prefill cell's rules (kv_seq), carry the cache by
    ``gather_cache`` and ``split_cache`` to the decode cell's split
    (head_dim), decode there: the unsplit port's logits and cache."""
    _, cfg = _cfgs(arch)
    whole = T_model.from_reference(_reference(arch), cfg, device="cpu")
    mesh = _mesh(shape)
    pre = TP.split_model(whole, mesh, _rules(cfg, mesh, "prefill"))
    dec = TP.split_model(whole, mesh, _rules(cfg, mesh, "decode"))
    assert (pre.attn_layout, dec.attn_layout) == ("kv_seq", "head_dim")
    inp, max_seq = _inputs(cfg)
    logits, cache = _prefill(pre, cfg, inp, max_seq)
    gathered = pre.gather_cache(cache)
    again = pre.split_cache(gathered)
    for pos, piece in cache["pieces"].items():
        for k, t in _leaves(piece).items():
            assert np.array_equal(t, _leaves(again["pieces"][pos])[k]), k
    steps, cache = _decode(dec, cfg, inp, dec.split_cache(gathered),
                           [logits[:, -1]])
    w = _whole_run(arch)
    _rel_close(steps, w[1])
    for k, t in _leaves(dec.gather_cache(cache)).items():
        _rel_close(torch.as_tensor(t), w[2][k], k)


def test_int8_caches_are_refused_under_the_new_layouts():
    _, cfg = _cfgs("starcoder2-3b", kv_cache_quant=True)
    mesh = _mesh((1, 4))
    whole = T_model.init_params(0, cfg, device="cpu")
    for kind in ("prefill", "decode"):
        split = TP.split_model(whole, mesh, _rules(cfg, mesh, kind))
        with pytest.raises(ValueError, match="kv_cache_quant"):
            split.init_cache(BATCH, 48)


# ------------------------------------------------------------ train steps
def _train_batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    out = {"tokens": torch.from_numpy(toks[:, :-1]),
           "labels": torch.from_numpy(labels)}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return out


def _state(arch, cfg):
    params = _reference(arch)
    return T_step.from_reference((params, R_opt.init_adamw(params)), cfg,
                                 device="cpu")


STEP_CASES = [("starcoder2-3b", (1, 4), 40), ("starcoder2-3b", (2, 4), 40),
              ("whisper-large-v3", (1, 8), 8)]


@pytest.mark.parametrize("arch,shape,seq", STEP_CASES, ids=[
    f"{a}-{m[0]}x{m[1]}" for a, m, _ in STEP_CASES])
def test_split_step_by_t2_rule(arch, shape, seq):
    _, cfg = _cfgs(arch)
    opt = T_opt.AdamWConfig(lr=1e-3)
    batch = _train_batch(cfg, 4, seq)
    mesh = _mesh(shape)
    rules = T_shard.resolve_rules(mesh, T_model.sharding_dims(
        cfg, 4, kv_seq=seq, q_seq=seq))
    split = T_step.shard_train_state(_state(arch, cfg), mesh, rules=rules)
    assert split.params.attn_layout == "kv_seq"
    want, wm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                      n_microbatches=2)(_state(arch, cfg),
                                                        batch)
    got, gm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                     n_microbatches=2 // shape[0])(split,
                                                                   batch)
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
