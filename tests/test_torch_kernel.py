"""The fused sim-step kernel module of the port.

On the CPU: ``fused_chunk`` runs its plain version ``fused_chunk_ref``
(and counts no launch); that plain version is held to the TPU kernel
``repro.kernels.sim_step.fused_chunk`` run in Pallas interpret mode, fed
the reference's own ``gen_draws`` draws (8 cells, chunk 16, every static
flag): counts exact, floats within 1e-9 relative (XLA's and torch's libm
differ by an ulp; the chunk compounds it).  The packed layouts the CUDA
source declares must match the wrapper's, and its Philox constants and
stream tags those of ``repro_torch.sim.draws`` (the kernel draws that
stream itself on the card).

The card test (marker ``cuda``) is in ``test_torch_cuda.py``, which
imports nothing of jax so that it runs on the GPU machine.
"""
import inspect
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.p2p as R_p2p
import repro.sim as R_sim
from repro.kernels import sim_step as RK
from repro.sim import engine as RE
import repro_torch.p2p as T_p2p
import repro_torch.sim as T_sim
from repro_torch.kernels import sim_step as TK
from repro_torch.sim import engine as TE
from repro_torch.sim.draws import PhiloxDraws

R = types.SimpleNamespace(sim=R_sim, p2p=R_p2p)
T = types.SimpleNamespace(sim=T_sim, p2p=T_p2p)
CU = (Path(TK.__file__).resolve().parent / "csrc" / "sim_step.cu").read_text()
FLAGS = dict(any_store=True, any_het=True, any_shock=True, any_pm=True)


def _eight(ns):
    """8 cells covering every static flag of the kernel."""
    sc, Cell, Pol = ns.sim.scenario, ns.sim.CellSpec, ns.sim.PolicyConfig
    mix = ns.sim.PeerClassMix((ns.sim.PeerClass("stable"),
                               ns.sim.PeerClass("volatile", hazard_mult=3.0,
                                                uplink_mult=0.5)), (0.5, 0.5))
    st = ns.p2p.StoreSpec(R=3)
    sk = ns.sim.ShockSpec(rate=5e-4, kill_frac=0.4)
    const = sc("constant", mtbf=3000.0)
    ad = Pol(kind="adaptive", prior_mu=1 / 3000.0, prior_v=20.0)
    gs = Pol(kind="adaptive", prior_mu=1 / 3000.0, prior_v=20.0,
             regime="gossip", gossip_period=300.0)
    kw = dict(work=3 * 3600.0, V=20.0, T_d=50.0, max_wall_time=1e6)
    return [
        Cell(scenario=const, policy=ad, seed=0, **kw),
        Cell(scenario=sc("doubling", mtbf0=3000.0, double_after=1800.0),
             policy=Pol(kind="fixed", fixed_T=2400.0), seed=1, **kw),
        Cell(scenario=sc("diurnal", mtbf=3000.0), policy=Pol(kind="oracle"),
             seed=2, **kw),
        Cell(scenario=const, policy=ad, seed=3, store=st, **kw),
        Cell(scenario=const, policy=Pol(kind="oracle"), seed=4, store=st,
             mix=mix, **kw),
        Cell(scenario=sc("trace", times=(0.0, 900.0), mtbfs=(3000.0, 800.0)),
             policy=ad, seed=5, store=st, shock=sk, **kw),
        Cell(scenario=const, policy=gs, seed=6, k=64, n_slots=256, **kw),
        Cell(scenario=sc("constant", mtbf=3000.0 * 1e5), policy=gs, seed=7,
             k=1_000_000, n_slots=4_000_000, **kw),
    ]


def _enum(name):
    body = re.search(r"enum %s \{(.*?)\};" % name, CU, re.S).group(1)
    toks = [t.strip() for t in body.replace("\n", " ").split(",")]
    return [t for t in toks if t and not t.startswith("N_")]


def test_cuda_source_layouts_match_wrapper():
    norm = lambda s: s.lower().replace("_", "")
    assert [norm(t[2:]) for t in _enum("ParamRow")] == \
        [norm(f) for f in TK.PARAM_ROWS]
    assert [norm(t[2:]) for t in _enum("Tab4")] == [norm(f) for f in TK.TAB4]
    assert [norm(t[2:]) for t in _enum("StateRow")] == \
        [norm(f) for f in TK.STATE_ROWS]
    p = TE._pack(_eight(T))
    assert set(TK.PARAM_ROWS) | set(TK.TAB4) | {
        "trace_t", "trace_mtbf", "hmean_peer", "shock_dpeer"} \
        == set(p._fields)
    for f in TK.PARAM_ROWS:
        assert getattr(p, f).ndim == 1, f
    assert len(TK.STATE_ROWS) == 34


def _const(name):
    return re.search(r"constexpr\s+\w+\s+%s\s*=\s*([^;]+);" % name,
                     CU).group(1).strip()


def test_cuda_source_philox_constants_match_draws():
    from repro_torch.sim import draws as D

    def hex32(text):
        return int(text.rstrip("uU"), 16)

    assert hex32(_const("kPhiloxM0")) == D._PHILOX_M0
    assert hex32(_const("kPhiloxM1")) == D._PHILOX_M1
    assert hex32(_const("kPhiloxW0")) == D._PHILOX_W0
    assert hex32(_const("kPhiloxW1")) == D._PHILOX_W1
    assert hex32(_const("kMainStream")) == D._MAIN_STREAM
    assert hex32(_const("kPmStream")) == D._PM_STREAM
    assert int(_const("kPhiloxRounds")) == inspect.signature(
        D.philox4x32).parameters["rounds"].default
    num, den = _const("kInv2p53").split("/")
    assert float(num) / float(den) == D._INV_2_53 == 2.0 ** -53
    assert float(_const("kTwoPi")) == D._TWO_PI


def test_philox_at_and_skip_follow_next():
    """``at`` is the counter-free form of ``next`` (what the kernel draws
    for a chunk), and ``skip`` moves the counter as ``next`` does."""
    seeds = [0, 5, 2**32 + 1, -3]
    a = PhiloxDraws(seeds, True, "cpu")
    b = PhiloxDraws(seeds, True, "cpu")
    first = a.next(5)
    assert b.skip(5) == 0 and b.step == a.step == 5
    assert torch.equal(b.at(0, 5), first)
    assert torch.equal(a.next(3), b.at(5, 3))
    assert torch.equal(TK.philox_draws(b, 5, 3), b.at(5, 3))
    assert not torch.equal(b.at(0, 3), b.at(2**32, 3))   # the counter's hi word


def test_run_chunks_on_cpu_is_the_plain_version_on_next():
    """CPU tensors: ``run_chunks`` steps ``fused_chunk_ref`` on the
    source's ``next`` draws (here across the counter's high word, in chunks
    that do not divide the run) and launches nothing."""
    p = TE.from_reference(TE._pack(_eight(T)), device="cpu")
    s = TE._init_state(p, 1)
    src = PhiloxDraws(range(8), True, "cpu")
    src.step = 2**32 - 7
    before = TK.LAUNCHES
    a, steps = TK.run_chunks(s, p, src, chunk=5, max_steps=16,
                             macro_threshold=0.05, **FLAGS)
    assert steps == 16 and src.step == 2**32 + 9 and TK.LAUNCHES == before
    b, _ = TK.fused_chunk_ref(s, p, src.at(2**32 - 7, 16),
                              macro_threshold=0.05, **FLAGS)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_pack_unpack_state_round_trip():
    p = TE.from_reference(TE._pack(_eight(T)), device="cpu")
    s = TE._init_state(p, 1)
    s, _ = TK.fused_chunk_ref(s, p, PhiloxDraws(range(8), True, "cpu").next(24),
                              macro_threshold=0.05, **FLAGS)
    back = TK.unpack_state(TK.pack_state(s))
    for name, a, b in zip(s._fields, s, back):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    p = TE.from_reference(TE._pack(_eight(T)), device="cpu")
    s = TE._init_state(p, 1)
    d = PhiloxDraws(range(8), True, "cpu").next(16)
    before = TK.LAUNCHES
    a, ta = TK.fused_chunk(s, p, d, macro_threshold=0.05, **FLAGS)
    b, tb = TK.fused_chunk_ref(s, p, d, macro_threshold=0.05, **FLAGS)
    assert TK.LAUNCHES == before
    assert torch.equal(ta, tb)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_wrapper_checks_inputs():
    p = TE.from_reference(TE._pack(_eight(T)), device="cpu")
    s = TE._init_state(p, 1)
    d = PhiloxDraws(range(8), True, "cpu").next(4)
    TK._check(s, p, d, any_pm=True)
    with pytest.raises(ValueError, match="draws"):
        TK._check(s, p, d[:, :3].contiguous(), any_pm=True)
    with pytest.raises(ValueError, match="float64"):
        TK._check(s, p, d.float(), any_pm=True)
    with pytest.raises(ValueError, match="float64"):
        TK._check(s._replace(t=s.t.float()), p, d, any_pm=True)
    with pytest.raises(ValueError, match=r"\[B, 1\]"):
        TK._check(s._replace(ema_d=torch.zeros(8, 32, dtype=torch.float64)),
                  p, d, any_pm=True)


def test_finished_warps_keep_their_state():
    """The per-warp early exit: a warp whose cells are all finished takes
    no step, so even the class-pooled variance (the one field a finished
    cell's step still moves) stays put."""
    cells = _eight(T)[6:7] * 40   # 40 pm cells: warps of 32 and 8
    p = TE.from_reference(TE._pack(cells), device="cpu")
    s = TE._init_state(p, 1)
    fin = torch.zeros(40, dtype=torch.bool)
    fin[32:] = True
    s = s._replace(finished=fin, pm_v=torch.full((40,), 0.25,
                                                 dtype=torch.float64))
    out, taken = TK.fused_chunk_ref(s, p, PhiloxDraws([6] * 40, True,
                                                      "cpu").next(5),
                                    macro_threshold=0.05, **FLAGS)
    assert taken.tolist() == [5, 0]
    assert torch.equal(out.pm_v[32:], s.pm_v[32:])
    assert torch.equal(out.t[32:], s.t[32:])
    assert not torch.equal(out.t[:32], s.t[:32])


def test_cell_steps_count_the_steps_each_cell_needs():
    """``cell_steps`` adds, per step, one for each cell unfinished at its
    start: the same count as stepping one step at a time."""
    cells = _eight(T) * 5
    p = TE.from_reference(TE._pack(cells), device="cpu")
    s = TE._init_state(p, 1)
    s = s._replace(finished=torch.arange(40) % 3 == 0)
    d = PhiloxDraws(range(40), True, "cpu").next(12)
    counted = torch.zeros(40, dtype=torch.int64)
    out, taken = TK.fused_chunk_ref(s, p, d, macro_threshold=0.05,
                                    cell_steps=counted, **FLAGS)
    want, step = torch.zeros(40, dtype=torch.int64), s
    for i in range(12):
        want += ~step.finished
        step, _ = TK.fused_chunk_ref(step, p, d[i:i + 1].contiguous(),
                                     macro_threshold=0.05, **FLAGS)
    assert torch.equal(counted, want)
    assert int(counted.sum()) < 40 * 12 and int(taken.max()) == 12
    assert torch.equal(out.t, step.t)


def test_empty_launch_is_not_counted():
    p = TE.from_reference(TE._pack(_eight(T)), device="cpu")
    s = TE._init_state(p, 1)
    before, by_route = TK.LAUNCHES, dict(TK.LAUNCHES_BY_ROUTE)
    TK.launch(TK.pack_params(p), TK.pack_state(s),
              torch.zeros(0, 6, 8, dtype=torch.float64),
              torch.zeros(1, dtype=torch.int32), macro_threshold=0.05,
              **FLAGS)
    TK.launch_philox(TK.pack_params(p), TK.pack_state(s),
                     torch.arange(8), 0, 0, torch.zeros(1, dtype=torch.int32),
                     macro_threshold=0.05, **FLAGS)
    assert TK.LAUNCHES == before and TK.LAUNCHES_BY_ROUTE == by_route


def test_plain_version_matches_pallas_kernel_interpret_mode():
    cells = _eight(R)
    seeds = [c.seed for c in cells]
    chunk = 16
    with jax.enable_x64(True):
        p = RE._pack(cells)
        pj = RE._Params(*(jnp.asarray(a) for a in p))
        s0 = RE._init_state(pj, jnp, 1)
        keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds,
                                                        dtype=jnp.uint32))
        _, (u, z, u2, u_pm, z_pm) = RK.gen_draws(keys, chunk, True)
        s1, _ = RK.fused_chunk(s0, keys, pj, macro_threshold=0.05, chunk=chunk,
                               interpret=True, **FLAGS)
        ref = RE._State(*(np.asarray(a) for a in s1))
        draws = np.stack([np.asarray(u), np.asarray(z), np.asarray(u2),
                          np.asarray(u_pm), np.asarray(z_pm)[..., 0],
                          np.asarray(z_pm)[..., 1]], axis=1)
    pt = TE.from_reference(p, device="cpu")
    got, _ = TK.fused_chunk_ref(TE._init_state(pt, 1), pt,
                                torch.as_tensor(draws, dtype=torch.float64),
                                macro_threshold=0.05, **FLAGS)
    assert bool(got.in_restore.any()) and float(got.n_fail.sum()) > 0
    for name, a, b in zip(ref._fields, ref, got):
        b = b.numpy()
        if a.dtype == bool or name in ("n_ckpt", "n_fail", "n_srv", "n_peer",
                                       "n_round"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=0.0,
                                       err_msg=name)
