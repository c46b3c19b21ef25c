"""The port's per-peer estimator form against ``repro.sim.engine`` on the
CPU.

Isolated and gossip cells at k <= 32 carry their estimator on a peer axis
of width 32 and draw per-peer observation noise (paper Sec 3.1.4).  The
port runs them through its plain torch step; the CUDA kernel refuses them,
as the reference's Pallas kernel does.

* ``_gossip_mix`` against the reference's with ``xp=np``: integer fields
  exact, floats within 1e-12 relative.
* One ``_attempt``/``_apply`` step at peer axis 32 from the same states and
  draws: the same tolerance.
* End to end with parity draws against ``run_cells(backend="numpy")``:
  counts exact, floats within 1e-9 relative (libm differences between
  numpy and torch, compounded over many steps).
* The parity source's observation rows are the reference's ``_OBS_STREAM``
  blocks; Philox means agree with the numpy backend within 3 sigma; pooled
  cells are unchanged beside per-peer cells; ``step="fused"`` refuses a
  per-peer batch.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.p2p as R_p2p
import repro.sim as R_sim
from repro.sim import engine as RE
import repro_torch.p2p as T_p2p
import repro_torch.sim as T_sim
from repro_torch.kernels import sim_step as TK
from repro_torch.sim import engine as TE
from repro_torch.sim.draws import NumpyDraws, PhiloxDraws

R = types.SimpleNamespace(sim=R_sim, p2p=R_p2p)
T = types.SimpleNamespace(sim=T_sim, p2p=T_p2p)

V, TD = 20.0, 50.0
MTBF = 4000.0
PRIOR_MU = 1.0 / (8.0 * MTBF)   # tests/test_gossip.py's optimistic prior
P = RE._PEER_CAP
_COUNTS = ("n_ckpt", "n_fail", "n_srv", "n_peer", "n_round")
_BOOLS = ("in_restore", "finished", "censored", "seen_ckpt", "seen_restore")


def _pol(ns, regime="isolated", **kw):
    base = dict(kind="adaptive", prior_mu=PRIOR_MU, prior_v=V)
    base.update(kw)
    if base["kind"] != "adaptive":
        return ns.sim.PolicyConfig(**base)
    return ns.sim.PolicyConfig(regime=regime, **base)


def _cell(ns, pol, seed=0, k=16, scen=None, **kw):
    base = dict(work=4 * 3600.0, V=V, T_d=TD, max_wall_time=40 * 3600.0)
    base.update(kw)
    scen = scen or ns.sim.scenario("constant", mtbf=MTBF)
    return ns.sim.CellSpec(scenario=scen, policy=pol, seed=seed, k=k, **base)


def _two_class(ns):
    return ns.sim.PeerClassMix(
        (ns.sim.PeerClass("stable"),
         ns.sim.PeerClass("volatile", hazard_mult=3.0, speed=0.7,
                          uplink_mult=0.5)), (0.6, 0.4))


def _gossip_grid(ns):
    """Gossip cells at k 2..32 and fanout 1..8 (fanout > k - 1 included),
    isolated and pooled cells, and class-pooled gossip cells (k = 64)."""
    cells = []
    for k in (2, 3, 8, 16, 32):
        for fan in (1, 2, 3, 8):
            cells.append(_cell(ns, _pol(ns, "gossip", gossip_period=300.0,
                                        gossip_fanout=fan,
                                        gossip_weight=0.3 + 0.05 * fan),
                               seed=k + fan, k=k))
    cells += [_cell(ns, _pol(ns, "isolated"), seed=1, k=8),
              _cell(ns, _pol(ns, "pooled"), seed=2),
              _cell(ns, _pol(ns, "gossip", gossip_fanout=5), seed=3, k=64,
                    n_slots=256),
              _cell(ns, _pol(ns, "gossip", gossip_fanout=1), seed=4, k=64,
                    n_slots=256)]
    return cells


def _step_families(ns):
    """Isolated, gossip, het, shock and store cells in one per-peer batch,
    beside pooled, fixed, oracle and class-pooled cells."""
    sk = ns.sim.ShockSpec(rate=2e-4, kill_frac=0.3)
    st = ns.p2p.StoreSpec(R=3)
    g = _pol(ns, "gossip", gossip_period=300.0, gossip_fanout=3)
    return [_cell(ns, _pol(ns, "isolated"), seed=0),
            _cell(ns, g, seed=1),
            _cell(ns, _pol(ns, "gossip", gossip_period=600.0,
                           gossip_fanout=8), seed=2, k=4),
            _cell(ns, g, seed=3, mix=_two_class(ns)),
            _cell(ns, _pol(ns, "isolated"), seed=4, shock=sk),
            _cell(ns, g, seed=5, shock=ns.sim.ShockSpec(
                rate=2e-4, kill_frac=0.5, scope="volatile"),
                mix=_two_class(ns)),
            _cell(ns, g, seed=6, store=st),
            _cell(ns, _pol(ns, "isolated"), seed=7, store=st,
                  mix=_two_class(ns)),
            _cell(ns, _pol(ns, "pooled"), seed=8, shock=sk),
            _cell(ns, _pol(ns, kind="fixed", fixed_T=1800.0), seed=9,
                  scen=ns.sim.scenario("constant", mtbf=1000.0)),
            _cell(ns, _pol(ns, kind="oracle"), seed=10),
            _cell(ns, g, seed=11, k=64, n_slots=256)]


def _tensor_state(s):
    return TE._State(*(TE._tensor(a, "cpu") for a in s))


def _assert_state_close(ref, got, rtol):
    for name, a, b in zip(ref._fields, ref, got):
        b = b.numpy()
        a = np.asarray(a)
        if name in _BOOLS:
            np.testing.assert_array_equal(a.astype(bool), b, err_msg=name)
        elif name in _COUNTS:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0.0,
                                       err_msg=name)


# ---------------------------------------------------------------- _gossip_mix
def test_gossip_mix_matches_reference():
    cells = _gossip_grid(R)
    p = RE._pack(cells)
    pt = TE.from_reference(p, device="cpu")
    np.testing.assert_array_equal(p.pm_on, TE._pack(_gossip_grid(T)).pm_on)
    B = len(cells)
    rng = np.random.default_rng(7)
    pooled = p.regime == RE._REGIME_IDS["pooled"]
    peer_act = np.arange(P)[None, :] < np.where(pooled, 1.0, p.k)[:, None]
    seen_due = seen_idle = 0
    for trial in range(6):
        ema_d = rng.gamma(2.0, 3.0, (B, P))
        ema_T = rng.uniform(1e3, 1e5, (B, P))
        mu0 = rng.uniform(1e-5, 1e-3, (B, P))
        n_round = rng.integers(0, 50, B).astype(np.float64)
        s_t = rng.uniform(0.0, 2e4, B)
        next_g = s_t + rng.choice([-10.0, 0.0, 10.0], B)
        finished = rng.random(B) < 0.2
        ref = RE._gossip_mix(s_t, ema_d, ema_T, mu0, n_round, next_g,
                             finished, peer_act, p, np)
        t = lambda a: torch.as_tensor(a)
        got = TE._gossip_mix(t(s_t), t(ema_d), t(ema_T), t(mu0), t(n_round),
                             t(next_g), t(finished), t(peer_act), pt)
        for name, a, b in zip(("ema_d", "ema_T", "mu0", "n_round", "next_g"),
                              ref, got):
            if name == "n_round":
                np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
            else:
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                           atol=0.0, err_msg=name)
        due = ref[3] != n_round
        seen_due += int(due.sum())
        seen_idle += int((~due).sum())
    assert seen_due > 20 and seen_idle > 20


# ---------------------------------------------------------------- one step
@pytest.mark.parametrize("macro_threshold", [0.0, 0.05])
def test_one_step_at_peer_axis_32_matches_reference(macro_threshold):
    cells = _step_families(R)
    p = RE._pack(cells)
    flags = TE.batch_flags(_step_families(T), TE._pack(_step_families(T)))
    assert flags == dict(any_store=True, any_het=True, any_shock=True,
                         any_pm=True, peer_axis=P)
    pt = TE.from_reference(p, device="cpu")
    B = len(cells)
    s = RE._init_state(p, np, P)
    rng = np.random.default_rng(99)
    rounds = 0.0
    with np.errstate(all="ignore"):
        for _ in range(80):
            u, u2, u_pm = rng.random(B), rng.random(B), rng.random(B)
            z, z_pm = rng.standard_normal(B), rng.standard_normal((B, 2))
            u3, z3 = rng.random((B, P)), rng.standard_normal((B, P))
            pre = RE._attempt(s, p, u2, np, RE._lw_numpy, True, True, True)
            nxt = RE._apply(s, p, pre, u, z, u3, z3, u_pm, z_pm,
                            macro_threshold, P, True, np)
            st = _tensor_state(s)
            t = lambda a: torch.as_tensor(a, dtype=torch.float64)
            tpre = TE._attempt(st, pt, t(u2), True, True, True)
            got = TE._apply(st, pt, tpre, t(u), t(z), t(u_pm), t(z_pm),
                            macro_threshold, True, t(u3), t(z3))
            _assert_state_close(nxt, got, rtol=1e-12)
            s = nxt
            rounds = float(s.n_round.sum())
    # The compared states include gossip rounds and sampled observations.
    assert rounds > 0 and float(np.abs(s.ema_d[:, 1:]).sum()) > 0


# ---------------------------------------------------------------- end to end
def _regime_cells(ns, n, regimes, scen, k=16, work=4 * 3600.0):
    return [_cell(ns, pol, seed=s, k=k, work=work, scen=scen,
                  max_wall_time=50 * work)
            for pol in regimes for s in range(n)]


def _family(ns, name):
    """tests/test_gossip.py's families (fewer seeds, shorter jobs) and a
    mixed pooled + fixed + isolated batch."""
    const = ns.sim.scenario("constant", mtbf=MTBF)
    if name == "ordering":
        return _regime_cells(ns, 4, [
            _pol(ns, "pooled"),
            _pol(ns, "gossip", gossip_period=300.0, gossip_fanout=3),
            _pol(ns, "isolated")], const)
    if name == "limits":
        return _regime_cells(ns, 3, [
            _pol(ns, "gossip", gossip_period=60.0, gossip_fanout=8,
                 gossip_weight=1.0),
            _pol(ns, "gossip", gossip_period=7200.0, gossip_fanout=1)],
            ns.sim.scenario("diurnal", mtbf=MTBF))
    if name == "heap_oracle":
        return _regime_cells(ns, 4, [
            _pol(ns, "gossip", gossip_period=600.0, gossip_fanout=2,
                 prior_v=10.0)], const, k=8)
    if name == "macro":
        return [_cell(ns, _pol(ns, reg, prior_mu=1.0 / (64.0 * 600.0)),
                      seed=s, work=900.0,
                      scen=ns.sim.scenario("constant", mtbf=600.0),
                      max_wall_time=40 * 3600.0)
                for reg in ("isolated", "gossip") for s in range(2)]
    if name == "mixed":
        kw = dict(work=2 * 3600.0)
        return ([_cell(ns, _pol(ns, "pooled"), seed=s, **kw)
                 for s in range(2)]
                + [_cell(ns, _pol(ns, kind="fixed", fixed_T=fT), seed=s, **kw)
                   for fT in (600.0, 3600.0) for s in range(2)]
                + [_cell(ns, _pol(ns, "isolated"), seed=s, k=k, **kw)
                   for s, k in ((0, 4), (1, 16), (2, 32))])
    raise KeyError(name)


def _assert_results_close(a, b, rtol):
    for f in ("n_checkpoints", "n_failures", "n_server_restores",
              "n_peer_restores", "completed"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for f in ("wall_time", "work_required", "wasted_work", "checkpoint_time",
              "restore_time", "server_bytes"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=rtol,
                                   atol=0.0, err_msg=f)


@pytest.mark.parametrize("families,macro_threshold", [
    (("ordering",), 0.05), (("limits", "heap_oracle"), 0.05),
    (("macro",), 0.0), (("macro",), 0.05), (("mixed",), 0.05),
    (("mixed",), 0.0)])
def test_end_to_end_parity_draws_match_numpy_backend(families,
                                                     macro_threshold):
    cells_r = [c for f in families for c in _family(R, f)]
    cells_t = [c for f in families for c in _family(T, f)]
    ref = R_sim.run_cells(cells_r, backend="numpy",
                          macro_threshold=macro_threshold)
    got = TE.run_cells(cells_t, device="cpu", draws="numpy", step="scan",
                       chunk=128, macro_threshold=macro_threshold)
    _assert_results_close(ref, got, rtol=1e-9)


def test_numpy_draws_obs_rows_are_the_reference_obs_stream():
    seeds = [3, 0, 3, 11, 2**33 + 1]
    src = NumpyDraws(seeds, False, "cpu", P)
    got = torch.cat([src.next_obs(n) for n in (100, 200, 300)]).numpy()
    assert got.shape == (600, 2, len(seeds), P)
    for b, sd in enumerate(seeds):
        g = np.random.default_rng(np.random.SeedSequence(
            [sd, RE._OBS_STREAM]))
        u3, z3 = [], []
        for _ in range(3):   # three _RNG_BLOCK refills cover 600 steps
            u3.append(g.random((P, RE._RNG_BLOCK)))
            z3.append(g.standard_normal((P, RE._RNG_BLOCK)))
        np.testing.assert_array_equal(got[:, 0, b],
                                      np.concatenate(u3, axis=1).T[:600])
        np.testing.assert_array_equal(got[:, 1, b],
                                      np.concatenate(z3, axis=1).T[:600])
    # The main rows do not depend on whether the source made obs rows.
    a = NumpyDraws(seeds, True, "cpu", P).next(300)
    b = NumpyDraws(seeds, True, "cpu").next(300)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        NumpyDraws(seeds, False, "cpu").next_obs(1)


def test_philox_obs_rows_depend_only_on_seed_and_step():
    src = PhiloxDraws([5, 9, 5, 2**40], True, "cpu", P)
    o = torch.cat([src.next_obs(3), src.next_obs(5)])
    assert o.shape == (8, 2, 4, P)
    assert torch.equal(o, src.obs_at(0, 8))
    assert torch.equal(o[:, :, 0], o[:, :, 2])          # same seed
    assert torch.equal(PhiloxDraws([9], False, "cpu", P).obs_at(0, 8)[:, :, 0],
                       o[:, :, 1])                        # batch-invariant
    u3, z3 = src.obs_at(0, 512)[:, 0], src.obs_at(0, 512)[:, 1]
    assert 0.0 <= float(u3.min()) and float(u3.max()) < 1.0
    assert abs(float(u3.mean()) - 0.5) < 0.01
    assert abs(float(z3.mean())) < 0.02 and abs(float(z3.std()) - 1.0) < 0.02
    # The obs stream is its own: the main rows are what a source without
    # it draws.
    assert torch.equal(PhiloxDraws([5, 9], True, "cpu", P).next(16),
                       PhiloxDraws([5, 9], True, "cpu").next(16))


def test_exact_transcendentals_track_numpy():
    """The per-peer Philox rows' log, square root and sin/cos of 2 pi b
    (integer and IEEE +, -, *, / operations only) stay within a few ulp
    of numpy's, over random and edge inputs."""
    from repro_torch.sim import draws as D

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.random(1 << 16), [2.0**-53, 0.5, 1.0 - 2.0**-53,
                                              1.0, 2.0**-52 * 3]])
    x = x[x > 0]
    t = torch.as_tensor(x)
    ref = np.log(x)
    got = D._log(t).numpy()
    ok = ref != 0.0
    assert np.max(np.abs(got - ref)[ok] / np.spacing(np.abs(ref[ok]))) <= 4
    assert got[~ok].tolist() == [0.0] * int((~ok).sum())
    y = -2.0 * ref
    assert np.max(np.abs(D._sqrt(torch.as_tensor(y)).numpy() - np.sqrt(y))
                  / np.spacing(np.maximum(np.sqrt(y), 1e-300))) <= 1
    assert float(D._sqrt(torch.zeros(1, dtype=torch.float64))) == 0.0
    b = x % 1.0
    sin, cos = D._sincos_2pi(torch.as_tensor(b))
    assert np.max(np.abs(sin.numpy() - np.sin(2 * np.pi * b))) < 2e-15
    assert np.max(np.abs(cos.numpy() - np.cos(2 * np.pi * b))) < 2e-15


# ---------------------------------------------------------------- philox
def test_philox_means_agree_with_numpy_backend():
    n = 32
    scen_r = R_sim.scenario("constant", mtbf=MTBF)
    scen_t = T_sim.scenario("constant", mtbf=MTBF)
    pol = dict(regime="gossip", gossip_period=300.0, gossip_fanout=3)
    a = R_sim.run_cells([_cell(R, _pol(R, **pol), seed=s, scen=scen_r,
                               work=2 * 3600.0) for s in range(n)],
                        backend="numpy")
    b = TE.run_cells([_cell(T, _pol(T, **pol), seed=s, scen=scen_t,
                            work=2 * 3600.0) for s in range(n)],
                     device="cpu", draws="philox", step="scan")
    se = np.sqrt(a.wall_time.var() / n + b.wall_time.var() / n)
    assert abs(a.wall_time.mean() - b.wall_time.mean()) <= 3.0 * se


def test_pooled_cells_are_unchanged_beside_per_peer_cells():
    """Composition invariance under Philox: pooled, fixed and oracle cells
    give the same results alone (peer axis 1, the kernel's form) as in a
    batch that also holds per-peer cells (peer axis 32)."""
    sc = T_sim.scenario
    pooled = [_cell(T, _pol(T, "pooled", kind=kind, fixed_T=900.0), seed=i,
                    scen=s)
              for i, (s, kind) in enumerate(
                  [(sc("constant", mtbf=MTBF), "adaptive"),
                   (sc("constant", mtbf=MTBF), "fixed"),
                   (sc("constant", mtbf=MTBF), "oracle"),
                   (sc("diurnal", mtbf=MTBF), "adaptive"),
                   (sc("constant", mtbf=2000.0), "adaptive")] * 2)]
    per_peer = [_cell(T, _pol(T, reg), seed=50 + i)
                for i, reg in enumerate(["isolated", "gossip"] * 3)]
    alone = TE.run_cells(pooled, device="cpu", chunk=64)
    mixed = TE.run_cells(pooled + per_peer, device="cpu", step="scan",
                         chunk=64)
    assert mixed.completed[len(pooled):].all()
    for f in ("wall_time", "n_failures", "n_checkpoints", "wasted_work",
              "restore_time", "checkpoint_time", "completed"):
        np.testing.assert_array_equal(getattr(alone, f),
                                      getattr(mixed, f)[:len(pooled)],
                                      err_msg=f)


# ---------------------------------------------------------------- guards
def test_fused_step_refuses_per_peer_batches():
    cells = [_cell(T, _pol(T, "gossip"), work=600.0),
             _cell(T, _pol(T, "pooled"), seed=1, work=600.0)]
    assert TE.batch_step(cells) == "scan"
    assert TE.batch_step(cells, peer_form="pm") == "fused"
    assert TE.batch_step(cells[1:]) == "fused"
    with pytest.raises(ValueError, match="per-peer"):
        TE.run_cells(cells, device="cpu", step="fused")
    p_np = TE._pack(cells)
    flags = TE.batch_flags(cells, p_np)
    p = TE.from_reference(p_np, device="cpu")
    s = TE._init_state(p, flags["peer_axis"])
    src = PhiloxDraws([0, 1], False, "cpu", P)
    with pytest.raises(ValueError, match="peer column"):
        TK.fused_chunk(s, p, src.next(4), macro_threshold=0.05, **flags)
    with pytest.raises(ValueError, match="peer column"):
        TK._check_state(s, p, torch.device("cpu"))   # the kernel's guard
    with pytest.raises(ValueError, match="obs rows"):
        TK.fused_chunk_ref(s, p, src.next(4), macro_threshold=0.05, **flags)
    out, _ = TK.fused_chunk_ref(s, p, src.next(4), obs=src.next_obs(4),
                                macro_threshold=0.05, **flags)
    assert out.ema_d.shape == (2, P)
