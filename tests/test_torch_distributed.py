"""The port's device meshes, sharding rules, cell sharding and ZeRO-1, on
the CPU.

* ``resolve_rules`` and ``zero1_spec`` against the JAX package's on
  ``jax.sharding.AbstractMesh`` shapes (1, n), (n,), (16, 16) and
  (2, 16, 16), for hypothesis-drawn dimension sizes, specs and shapes:
  equal tables and specs;
* the logical spec tables (``param_logical_specs``,
  ``cache_logical_specs``, ``sharding_dims``) against JAX's for all ten
  configs: equal, a per-layer leaf taking the stacked leaf's spec without
  its leading "layers"; the names are ``named_parameters()`` on the meta
  device and each spec has its leaf's rank;
* ``run_cells`` on meshes of 2, 3 and 4 x ``cpu`` (3 takes the padding
  path), a (pod, data) mesh and a (data, model) mesh: every
  ``BatchResult`` field and ``n_steps`` bitwise the unsharded run's, with
  both draw sources, for pooled, class-pooled and per-peer cells (the
  last under ``step="scan"``); ``mesh="auto"`` on the CPU does not shard;
* ZeRO-1 at SMOKE (dense, moe, ssm, encdec): data extent n with m
  microbatches each against the unsharded step with n*m -- parameters,
  master, m and v bitwise where the norm does not clip, within 1e-6
  relative where it clips (above a floor of 1e-6 of each leaf's largest
  value); ``grad_norm`` within 1e-6 relative (a norm over sharded
  gradients adds per-piece partial sums);
* a sharded state's checkpoint image equals the unsharded one's, and
  ``load_tree`` writes it back into the pieces;
* every ctypes launch runs under ``torch.cuda.device`` of its tensors
  (recorders in place of the libraries and the device context);
* ZeRO-1 over a (data 2, model 2) mesh: the split step matches the
  unsplit step (``test_zero1_refuses_a_model_axis``, which once held the
  refusal of a model axis).
"""

import contextlib
import functools
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import repro.configs as R_cfg
from repro.distributed import sharding as R_shard
from repro.models import model as R_model
from repro.train import optimizer as R_opt
import repro_torch.configs as T_cfg
import repro_torch.p2p as T_p2p
import repro_torch.sim as T_sim
from repro_torch.ckpt import store
from repro_torch.distributed import mesh as T_mesh
from repro_torch.distributed import sharding as T_shard
from repro_torch.models import model as T_model
from repro_torch.sim import engine as TE
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

MESHES = {"(1, n)": lambda n: ((1, n), ("data", "model")),
          "(n,)": lambda n: ((n,), ("data",)),
          "(16, 16)": lambda n: ((16, 16), ("data", "model")),
          "(2, 16, 16)": lambda n: ((2, 16, 16), ("pod", "data", "model"))}
LOGICAL = ("batch", "heads", "kv_heads", "head_dim", "mlp", "experts",
           "vocab", "inner", "seq", "kv_seq", "q_seq", "embed", "cell")


def _meshes(kind: str, n: int):
    shape, axes = MESHES[kind](n)
    return AbstractMesh(shape, axes), T_mesh.Mesh(shape, axes)


# ------------------------------------------------------- rules and zero1
@settings(max_examples=60, deadline=None)
@given(kind=st.sampled_from(sorted(MESHES)), n=st.integers(1, 8),
       dims=st.dictionaries(st.sampled_from(LOGICAL),
                            st.sampled_from([0, 1, 2, 3, 4, 6, 8, 12, 16, 20,
                                             32, 48, 64, 100, 256, 4096]),
                            max_size=len(LOGICAL)),
       logical=st.lists(st.sampled_from(LOGICAL + (None,)), max_size=4))
def test_resolve_rules_match_reference(kind, n, dims, logical):
    am, tm = _meshes(kind, n)
    want = R_shard.resolve_rules(am, dims)
    got = T_shard.resolve_rules(tm, dims)
    assert got.table == want.table
    assert got.spec(tuple(logical)) == tuple(want.spec(tuple(logical)))


@st.composite
def _spec_and_shape(draw, axes):
    rank = draw(st.integers(1, 4))
    shape = tuple(draw(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 24, 32, 48,
                                        64, 96])) for _ in range(rank))
    where = {a: draw(st.sampled_from([None] + list(range(rank))))
             for a in axes}
    entries = []
    for i in range(draw(st.integers(0, rank))):
        on = tuple(a for a in axes if where[a] == i)
        entries.append(None if not on else on[0] if len(on) == 1 else on)
    return tuple(entries), shape


@settings(max_examples=80, deadline=None)
@given(data=st.data(), kind=st.sampled_from(sorted(MESHES)),
       n=st.integers(1, 8))
def test_zero1_spec_matches_reference(data, kind, n):
    am, tm = _meshes(kind, n)
    spec, shape = data.draw(_spec_and_shape(tm.axis_names))
    want = R_opt.zero1_spec(P(*spec), shape, am)
    got = T_opt.zero1_spec(spec, shape, tm)
    assert got == tuple(want), (spec, shape)


def test_zero1_state_shardings_widen_master_m_v():
    tm = T_mesh.Mesh((4,), ("data",))
    specs = {"a": (None, None), "b": (None,)}
    shapes = {"a": (8, 12), "b": (3,)}
    got = T_opt.zero1_state_shardings(specs, shapes, tm)
    assert got.step == () and got.master == got.m == got.v
    assert got.master == {"a": (None, "data"), "b": (None,)}


def _flat_reference_specs(tree, cfg) -> dict:
    """JAX's nested spec tree under the port's names: a stacked leaf's
    spec per layer, without its leading "layers"."""
    stacks = {"blocks": cfg.n_layers}
    if cfg.family == "encdec":
        stacks.update(enc_blocks=cfg.n_enc_layers, cross=cfg.n_layers)

    def flat(prefix, t):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(f"{prefix}{k}.", v)
            else:
                yield f"{prefix}{k}", v

    out = {}
    for part, sub in tree.items():
        if part in stacks:
            for name, spec in flat("", sub):
                assert spec[0] == "layers", (part, name, spec)
                for i in range(stacks[part]):
                    out[f"{part}.{i}.{name}"] = tuple(spec[1:])
        else:
            out.update(flat(f"{part}.", sub))
    return out


@pytest.mark.parametrize("arch", T_cfg.ARCH_IDS)
def test_spec_tables_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        rcfg, tcfg = getattr(R_cfg, get)(arch), getattr(T_cfg, get)(arch)
        got = T_model.param_logical_specs(tcfg)
        assert got == _flat_reference_specs(
            R_model.param_logical_specs(rcfg), rcfg)
        named = dict(T_model.model_class(tcfg)(tcfg).named_parameters())
        assert set(got) == set(named)
        assert all(len(got[k]) == p.dim() for k, p in named.items())
        for q in (dict(kv_cache_quant=True), {}):
            assert T_model.cache_logical_specs(tcfg.replace(**q)) == \
                R_model.cache_logical_specs(rcfg.replace(**q))
        for args in ((256,), (8, 4096, 4096), (1, 32768, 1)):
            assert T_model.sharding_dims(tcfg, *args) == \
                R_model.sharding_dims(rcfg, *args)


def test_tree_shardings_and_meshes():
    tm = T_mesh.Mesh((2, 4), ("data", "model"))
    rules = T_shard.resolve_rules(tm, {"batch": 8, "heads": 8,
                                       "kv_heads": 4})
    tree = {"x": ("batch", "heads"), "y": [("kv_heads",), (None, "batch")]}
    assert T_shard.tree_shardings(tm, rules, tree) == {
        "x": ("data", "model"), "y": [("model",), (None, "data")]}
    m = T_mesh.make_mesh((2, 3), ("pod", "data"), ["cpu"] * 6)
    m = T_mesh.make_mesh((2, 3), ("pod", "data"),
                         [f"cpu:{i}" for i in range(6)])
    assert m.size == 6
    assert m.devices_along(("data",)) == [torch.device("cpu", i)
                                          for i in range(3)]
    assert m.devices_along(("pod",)) == [torch.device("cpu", i)
                                         for i in (0, 3)]
    assert len(m.devices_along(("pod", "data"))) == 6
    assert T_mesh.data_axes(m) == ("pod", "data")
    assert T_mesh.axis_size(m, "model") == 1
    with pytest.raises(ValueError, match="needs 4 devices"):
        T_mesh.Mesh((4,), ("data",), ["cpu"] * 3)


def test_meshes_take_cards_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (T_mesh.cell_mesh, T_mesh.local_mesh_for_testing,
                  lambda: T_mesh.make_mesh((2,), ("data",))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


# ----------------------------------------------------------- cell sharding
def _pol(regime="pooled", **kw):
    return T_sim.PolicyConfig(kind=kw.pop("kind", "adaptive"), regime=regime,
                              prior_mu=1 / 4000.0, prior_v=20.0, **kw)


def _cell(pol, seed, scen=None, **kw):
    base = dict(k=16, work=1800.0, V=20.0, T_d=50.0, max_wall_time=72000.0)
    base.update(kw)
    return T_sim.CellSpec(
        scenario=scen or T_sim.scenario("constant", mtbf=20000.0),
        policy=pol, seed=seed, **base)


def _family(name):
    sc = T_sim.scenario
    if name == "pooled":
        mix = T_sim.PeerClassMix(
            (T_sim.PeerClass("stable"),
             T_sim.PeerClass("volatile", hazard_mult=3.0, speed=0.7)),
            (0.6, 0.4))
        return ([_cell(_pol(kind=kind, fixed_T=600.0), seed,
                       sc("diurnal", mtbf=20000.0, amplitude=0.5,
                          period=21600.0))
                 for kind in ("adaptive", "fixed", "oracle")
                 for seed in (0, 1)]
                + [_cell(_pol(), 2, store=T_p2p.StoreSpec(R=3), mix=mix),
                   _cell(_pol(), 3, shock=T_sim.ShockSpec(rate=2e-4,
                                                          kill_frac=0.3))])
    if name == "pm":                   # class-pooled: k above the peer cap
        quiet = sc("constant", mtbf=200000.0)
        return [_cell(_pol("gossip", gossip_period=600.0), seed, quiet, k=64,
                      n_slots=256) for seed in (4, 5, 4)] + [
            _cell(_pol("isolated"), 6, quiet, k=64, n_slots=256)]
    if name == "perpeer":
        return [_cell(_pol(reg, gossip_period=300.0), seed, k=k, work=900.0)
                for reg, k in (("gossip", 8), ("isolated", 16))
                for seed in (7, 8)] + [_cell(_pol(), 9, work=900.0)]
    raise KeyError(name)


_FIELDS = ("wall_time", "work_required", "n_checkpoints", "n_failures",
           "wasted_work", "checkpoint_time", "restore_time", "completed",
           "server_bytes", "n_server_restores", "n_peer_restores")


def _assert_same(a, b):
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.n_steps == b.n_steps


CHUNK = 16


def _run(cells, **kw):
    step = "scan" if TE.batch_step(cells) == "scan" else "fused"
    return TE.run_cells(cells, step=step, chunk=CHUNK, max_steps=4096, **kw)


@functools.lru_cache(maxsize=None)
def _unsharded(family: str, draws: str):
    out = _run(_family(family), device="cpu", draws=draws, mesh=None)
    assert out.completed.all() and out.n_steps < 4096
    return out


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("family", ["pooled", "pm", "perpeer"])
@pytest.mark.parametrize("draws", ["numpy", "philox"])
def test_sharded_cells_bitwise_the_unsharded_run(draws, family, n):
    mesh = T_mesh.make_mesh((n,), ("data",), ["cpu"] * n)
    _assert_same(_unsharded(family, draws),
                 _run(_family(family), draws=draws, mesh=mesh))


@pytest.mark.parametrize("shape,axes", [((2, 2), ("pod", "data")),
                                        ((2, 3), ("data", "model")),
                                        ((3,), ("model",))])
def test_sharded_cells_on_other_meshes(shape, axes):
    mesh = T_mesh.make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    _assert_same(_unsharded("pooled", "numpy"),
                 _run(_family("pooled"), device="cpu", draws="numpy",
                      mesh=mesh))


def test_cell_mesh_auto_and_refusals(monkeypatch):
    cells = _family("pm")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(T_mesh, "cell_mesh", lambda *a: pytest.fail(
        "mesh='auto' sharded a CPU run"))
    _assert_same(_unsharded("pm", "philox"),
                 _run(cells, device="cpu", mesh="auto"))
    mesh = T_mesh.make_mesh((2,), ("data",), ["cpu"] * 2)
    with pytest.raises(ValueError, match="disagrees"):
        _run(cells, device="meta", mesh=mesh)
    with pytest.raises(ValueError, match="abstract"):
        _run(cells, mesh=T_mesh.Mesh((2,), ("data",)))


def test_lockstep_loop_reads_one_count_a_chunk(monkeypatch):
    """Three shards, one host read of the summed unfinished count a
    chunk, every shard stepped the same number of chunks."""
    from repro_torch.kernels import sim_step as TK

    reads, steps = [], []
    real_int, real_step = int, TK._Shard.step
    monkeypatch.setattr(TK._Shard, "step", lambda self, n: (
        steps.append(id(self)), real_step(self, n))[1])
    monkeypatch.setitem(TK.run_shards.__globals__, "int",
                        lambda x: reads.append(1) or real_int(x))
    res = _run(_family("pooled"), draws="numpy",
               mesh=T_mesh.make_mesh((3,), ("data",), ["cpu"] * 3))
    chunks = res.n_steps // CHUNK
    assert len(reads) == chunks and len(steps) == 3 * chunks
    assert all(steps.count(s) == chunks for s in set(steps))


# ------------------------------------------------------------------ ZeRO-1
ZERO1_ARCHS = ("olmo-1b", "olmoe-1b-7b", "mamba2-130m", "whisper-large-v3")


def _zero1_cfg(arch):
    return T_cfg.get_smoke_config(arch).replace(
        param_dtype="float32", compute_dtype="float32",
        use_flash_kernel=False)


def _zero1_batch(cfg, b=8, s=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    out = {"tokens": torch.from_numpy(toks[:, :-1]),
           "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return out


def _sharded_step(cfg, opt, n, m, in_scan, batch, devices=None):
    mesh = T_mesh.make_mesh((n,), ("data",), devices or ["cpu"] * n)
    state = T_step.shard_train_state(T_step.init_train_state(0, cfg, "cpu"),
                                     mesh)
    c = T_opt.zero1_grad_constraint(mesh, T_step.zero1_specs(cfg, mesh)
                                    .master)
    step = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                  n_microbatches=m, grad_constraint=c,
                                  zero1_grads_in_scan=in_scan)
    return step(state, batch)


@pytest.mark.parametrize("clip", [1e6, 1e-3], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("arch", ZERO1_ARCHS)
def test_zero1_split_batch_equals_unsplit_batch(arch, clip):
    cfg = _zero1_cfg(arch)
    opt = T_opt.AdamWConfig(lr=1e-3, grad_clip=clip)
    batch = _zero1_batch(cfg)
    want, wm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                      n_microbatches=4)(
        T_step.init_train_state(0, cfg, "cpu"), batch)
    clipped = float(wm["grad_norm"]) > clip
    assert clipped == (clip < 1)
    for n, m, in_scan in ((2, 2, False), (2, 2, True), (4, 1, True)):
        got, gm = _sharded_step(cfg, opt, n, m, in_scan, batch)
        split = [k for k, v in got.opt.master.items() if v.dim is not None]
        assert split and all(len(got.opt.master[k].shards) == n
                             for k in split)
        assert len(got.modules()) == 1
        torch.testing.assert_close(gm["grad_norm"], wm["grad_norm"],
                                   rtol=1e-6, atol=0)
        for k in ("loss", "ce"):
            assert torch.equal(gm[k], wm[k]), k
        a, b = want.tree(), got.tree()
        assert a.keys() == b.keys()
        for k in a:
            if clipped:
                # 1e-6 relative, above a floor of 1e-6 of the leaf's
                # largest value: where w - lr*update cancels, one rounding
                # of the operands is a large share of the small result
                floor = 1e-6 * float(a[k].detach().abs().max())
                torch.testing.assert_close(b[k], a[k], rtol=1e-6, atol=floor)
            else:
                assert torch.equal(a[k], b[k]), (n, m, in_scan, k)


def test_zero1_whole_leaves_stay_on_the_first_data_device():
    """A leaf whose spec the data axis does not widen stays whole (one
    piece); every other leaf has a piece a data position."""
    cfg = _zero1_cfg("olmo-1b")
    mesh = T_mesh.make_mesh((3,), ("data",), ["cpu"] * 3)
    state = T_step.shard_train_state(T_step.init_train_state(0, cfg, "cpu"),
                                     mesh)
    specs = T_step.zero1_specs(cfg, mesh).master
    for k, v in state.opt.master.items():
        assert (v.dim is None) == ("data" not in specs[k]), k
        assert len(v.shards) == (1 if v.dim is None else 3)
    assert state.opt.step.device == torch.device("cpu")


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_zero1_checkpoint_image_is_the_unsharded_image(arch, tmp_path):
    cfg = _zero1_cfg(arch)
    opt = T_opt.AdamWConfig(lr=1e-3, grad_clip=1e6)
    batch = _zero1_batch(cfg)
    want, _ = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                     n_microbatches=4)(
        T_step.init_train_state(0, cfg, "cpu"), batch)
    got, _ = _sharded_step(cfg, opt, 4, 1, False, batch)
    a = store.save_pytree(str(tmp_path / "whole"), 1, want.tree())
    b = store.save_pytree(str(tmp_path / "sharded"), 1, got.tree())
    assert (open(f"{a}/manifest.json", "rb").read()
            == open(f"{b}/manifest.json", "rb").read())
    for s in range(4):
        with np.load(f"{a}/shard_{s}.npz") as x, \
                np.load(f"{b}/shard_{s}.npz") as y:
            assert x.files == y.files
            assert all(x[f].tobytes() == y[f].tobytes() for f in x.files)
    # restore the image into a fresh sharded state: into every piece
    fresh = T_step.shard_train_state(T_step.init_train_state(1, cfg, "cpu"),
                                     T_mesh.make_mesh((4,), ("data",),
                                                      ["cpu"] * 4))
    fresh.load_tree(store.load_pytree(b, fresh.tree()))
    for k, v in want.tree().items():
        assert torch.equal(fresh.tree()[k], v), k
    for k, v in fresh.opt.m.items():
        for piece, sl in v.slices(want.opt.m[k]):
            assert torch.equal(piece, sl), k
    twin = fresh.clone()
    assert all(torch.equal(x, y) for x, y in
               zip(twin.tree().values(), fresh.tree().values()))
    assert twin.opt.master[k].shards[0].data_ptr() != \
        fresh.opt.master[k].shards[0].data_ptr()


def test_zero1_refuses_a_model_axis():
    """Once a refusal (tensor parallelism was not ported), now the
    positive case it refused: ZeRO-1 over a (data 2, model 2) mesh splits
    each model piece's state over the data positions of its model index,
    and the step matches the unsplit step with as many microbatches: the
    loss and grad_norm to 1e-6 relative, every leaf of the image to 1e-5
    relative above a floor of 1e-6 of its largest value (a split model
    sums its partial products in another order), the first and second
    moments (the gradients) included; the master and the parameters
    within the bound that follows Adam from the measured first moments
    (``train.optimizer.master_gap_bound``, as ``tests/test_torch_tp.py``
    holds the split step): Adam's update turns the split's float32 noise
    in a gradient near its eps (1e-8) into a move of any share of lr (one
    embedding element moves 0.06 lr here), which that bound follows.
    An abstract mesh is still refused."""
    cfg = _zero1_cfg("olmo-1b")
    mesh = T_mesh.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert T_opt.data_devices(mesh, model_index=1) == [torch.device("cpu")] * 2
    opt = T_opt.AdamWConfig(lr=1e-3, grad_clip=1e6)
    batch = _zero1_batch(cfg)
    want, wm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                      n_microbatches=4)(
        T_step.init_train_state(0, cfg, "cpu"), batch)
    state = T_step.shard_train_state(T_step.init_train_state(0, cfg, "cpu"),
                                     mesh)
    assert isinstance(state, T_step.SplitTrainState)
    split = [k for k, v in state.opts[0].master.items() if v.dim is not None]
    assert split and all(len(state.opts[1].master[k].shards) == 2
                         for k in split)
    got, gm = T_step.make_train_step(cfg, opt, T_sched.constant(),
                                     n_microbatches=2)(state, batch)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(gm[k], wm[k], rtol=1e-6, atol=0)
    a, b = want.tree(), got.tree()
    assert a.keys() == b.keys()
    step = int(a["opt/step"])
    for k in a:
        w, g = a[k].detach(), b[k].detach()
        name = k.split("/")[-1]
        if k.startswith(("params/", "opt/master/")):
            bound = T_opt.master_gap_bound(
                opt, step, w, a[f"opt/m/{name}"], b[f"opt/m/{name}"],
                a[f"opt/v/{name}"], opt.lr)
            assert ((g - w).abs() <= bound).all(), k
            continue
        floor = 1e-6 * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=floor)
    with pytest.raises(ValueError, match="abstract"):
        T_opt.zero1_grad_constraint(T_mesh.Mesh((2,), ("data",)), {})


def test_shard_state_drops_each_whole_leaf():
    cfg = _zero1_cfg("olmo-1b")
    state = T_step.init_train_state(0, cfg, "cpu")
    opt = state.opt
    T_step.shard_train_state(state, T_mesh.make_mesh((2,), ("data",),
                                                     ["cpu"] * 2))
    assert not opt.master and not opt.m and not opt.v


# ------------------------------------------------- launches under a device
class _Recorder:
    """Stands in for a ctypes library: every launch function records the
    device current at its call and returns 0."""

    def __init__(self, current):
        self.calls, self._current = [], current

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda rc: b"recorded"
        if name.endswith("smem_bytes"):
            return lambda *a: 0

        def fn(*args):
            self.calls.append((name, self._current[-1]))
            return 0
        return fn


def test_every_launch_runs_under_its_tensors_device(monkeypatch):
    from repro_torch.kernels import (ckpt_quant, flash_attention, sim_step,
                                     ssd_scan)

    current = [None]

    @contextlib.contextmanager
    def device(d):
        current.append(torch.device(d))
        try:
            yield
        finally:
            current.pop()

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    lib = _Recorder(current)
    for mod in (ckpt_quant, flash_attention, sim_step, ssd_scan):
        monkeypatch.setattr(mod, "_lib", lambda: lib)
    f64 = dict(dtype=torch.float64)
    params = (torch.zeros(39, 40, **f64), torch.zeros(8, 40, 4, **f64),
              torch.zeros(40, 32, **f64), torch.zeros(40, 32, **f64),
              torch.zeros(40, 1, **f64), torch.zeros(40, 1, **f64))
    taken = torch.zeros(2, dtype=torch.int32)
    flags = dict(macro_threshold=0.05, any_store=False, any_het=False,
                 any_shock=False, any_pm=False)
    sim_step._launch(params, torch.zeros(40, 40, **f64), taken,
                     draws=torch.zeros(2, 3, 40, **f64), seeds=None, step0=0,
                     n=2, **flags)
    sim_step._launch_philox_draws(torch.zeros(40, dtype=torch.int64), 0, 2,
                                  False)
    ckpt_quant._launch_quantize(torch.zeros(1024), 2, 512)
    ckpt_quant._launch_dequantize(torch.zeros(1024, dtype=torch.int8),
                                  torch.ones(2), 2, 512, torch.float32)
    q, k = torch.zeros(2, 1, 8, 64), torch.zeros(2, 8, 64)
    for how in ("wgmma", "simt"):
        flash_attention._launch(q, k, k, how, scale=0.125, causal=True,
                                softcap=None)
    x, dt, B = torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2), \
        torch.zeros(1, 8, 4)
    for how in ("mma", "simt"):
        ssd_scan._launch(x, dt, torch.zeros(2), B, B, None, 8, how)
    names = [n for n, _ in lib.calls]
    assert names == ["sim_step_launch", "sim_step_philox_draws",
                     "ckpt_quantize_launch", "ckpt_dequantize_launch",
                     "flash_attention_tc_launch", "flash_attention_launch",
                     "ssd_scan_tc_launch", "ssd_scan_launch"]
    assert all(d == torch.device("cpu") for _, d in lib.calls), lib.calls
    assert current == [None]
