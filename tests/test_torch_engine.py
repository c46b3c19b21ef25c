"""The port's batched engine against ``repro.sim.engine`` on the CPU.

* Packing: the port's ``_pack`` equals the reference's field for field,
  bit for bit, and ``from_reference`` carries a packed batch across.
* One step: the port's ``_attempt`` + ``_apply`` against the reference's
  with ``xp=np`` from the same mid-run states and the same draws, for
  each static-flag combination: integer-valued fields exact, float fields
  within 1e-12 relative.
* End to end: ``run_cells(device="cpu", draws="numpy")`` against
  ``repro.sim.run_cells(backend="numpy")`` on a mixed grid: counts exact,
  floats within 1e-9 relative (libm differences between numpy and torch,
  compounded over many steps).
* Philox draws: 3-sigma agreement of means with the numpy backend, and a
  cell's result is the same alone and inside a batch.
* Guards: per-peer batches raise, entry points need a card unless asked
  for the CPU, and the package imports without jax or repro.
"""
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.p2p as R_p2p
import repro.sim as R_sim
from repro.sim import engine as RE
import repro_torch.p2p as T_p2p
import repro_torch.sim as T_sim
from repro_torch.sim import engine as TE

R = types.SimpleNamespace(sim=R_sim, p2p=R_p2p, eng=RE)
T = types.SimpleNamespace(sim=T_sim, p2p=T_p2p, eng=TE)
SRC = Path(__file__).resolve().parents[1] / "src"

V, TD = 20.0, 50.0
WORK = 4 * 3600.0
_COUNTS = ("n_ckpt", "n_fail", "n_srv", "n_peer", "n_round")
_BOOLS = ("in_restore", "finished", "censored", "seen_ckpt", "seen_restore")


def _scenarios(ns):
    sc = ns.sim.scenario
    return [sc("constant", mtbf=20000.0),
            sc("doubling", mtbf0=20000.0, double_after=2 * 3600.0),
            sc("diurnal", mtbf=20000.0, amplitude=0.5, period=6 * 3600.0),
            sc("flash_crowd", mtbf=20000.0, spike_mtbf=2000.0, at=3600.0,
               duration=1800.0),
            sc("trace", times=(0.0, 1800.0, 5400.0),
               mtbfs=(20000.0, 5000.0, 15000.0))]


def _cell(ns, scen, kind="adaptive", seed=0, **kw):
    pol_kw = dict(kind=kind, prior_mu=1 / 4000.0, prior_v=V, fixed_T=900.0)
    for key in ("regime", "gossip_period", "gossip_fanout", "fixed_T",
                "prior_mu"):
        if key in kw:
            pol_kw[key] = kw.pop(key)
    base = dict(k=16, work=WORK, V=V, T_d=TD, max_wall_time=10 * WORK)
    base.update(kw)
    return ns.sim.CellSpec(scenario=scen, policy=ns.sim.PolicyConfig(**pol_kw),
                           seed=seed, **base)


def _two_class(ns):
    return ns.sim.PeerClassMix(
        (ns.sim.PeerClass("stable"),
         ns.sim.PeerClass("volatile", hazard_mult=3.0, speed=0.7,
                          uplink_mult=0.5)), (0.6, 0.4))


def _family(ns, name):
    """Cells of one feature family, built identically in either package."""
    const = _scenarios(ns)[0]
    if name == "pooled":
        # Plus one livelocked cell (fixed T far above the job MTBF): it
        # macro-steps its failure bursts and ends censored.
        return ([_cell(ns, s, kind, seed, fixed_T=1800.0)
                 for s in _scenarios(ns)
                 for kind in ("adaptive", "fixed", "oracle")
                 for seed in (0, 1)]
                + [_cell(ns, ns.sim.scenario("constant", mtbf=4000.0),
                         "fixed", 0, fixed_T=3600.0)])
    if name == "store":
        st = ns.p2p.StoreSpec(R=3)
        return ([_cell(ns, const, kind, seed=2, store=st)
                 for kind in ("adaptive", "fixed", "oracle")]
                + [_cell(ns, const, "adaptive", seed=3,
                         store=ns.p2p.StoreSpec(R=0))])
    if name == "het":
        st = ns.p2p.StoreSpec(R=3)
        return [_cell(ns, const, kind, seed=4, store=st, mix=_two_class(ns))
                for kind in ("adaptive", "oracle")]
    if name == "shock":
        sk = ns.sim.ShockSpec(rate=2e-4, kill_frac=0.3)
        return [_cell(ns, const, kind, seed=5, shock=sk)
                for kind in ("adaptive", "oracle")]
    if name == "shock_store":
        sk = ns.sim.ShockSpec(rate=2e-4, kill_frac=0.3)
        return [_cell(ns, const, "adaptive", seed=6, shock=sk,
                      store=ns.p2p.StoreSpec(R=3)),
                _cell(ns, const, "oracle", seed=6,
                      shock=ns.sim.ShockSpec(rate=2e-4, kill_frac=0.5,
                                             scope="volatile"),
                      store=ns.p2p.StoreSpec(R=3), mix=_two_class(ns))]
    if name == "pm":
        return ([_cell(ns, const, seed=s, regime="gossip",
                       gossip_period=600.0, k=64, n_slots=256)
                 for s in (7, 8)]
                + [_cell(ns, ns.sim.scenario("constant", mtbf=250.0 * 1e6),
                         seed=9, regime="gossip", gossip_period=600.0,
                         prior_mu=1 / (250.0 * 1e6), k=1_000_000,
                         n_slots=4_000_000, work=1800.0),
                   _cell(ns, const, seed=10, regime="isolated", k=64,
                         n_slots=256, mix=_two_class(ns))])
    raise KeyError(name)


def _cells(ns, families):
    return [c for f in families for c in _family(ns, f)]


ALL = ("pooled", "store", "het", "shock", "shock_store", "pm")


# ---------------------------------------------------------------- packing
@pytest.mark.parametrize("families", [("pooled",), ("store",), ("het",),
                                      ("shock", "shock_store"), ("pm",), ALL])
def test_pack_matches_reference_bitwise(families):
    pr = RE._pack(_cells(R, families))
    pt = TE._pack(_cells(T, families))
    assert pr._fields == pt._fields
    for name, a, b in zip(pr._fields, pr, pt):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    carried = TE.from_reference(pr, device="cpu")
    for name, a, b in zip(pr._fields, pr, carried):
        assert b.dtype in (torch.float64, torch.int64, torch.bool), name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


# ---------------------------------------------------------------- one step
def _flags(families):
    cells = _cells(R, families)
    p = RE._pack(cells)
    return p, dict(any_store=any(c.store is not None for c in cells),
                   any_het=bool(p.store_mix.any()),
                   any_shock=any(RE._cell_shock(c) is not None
                                 for c in cells),
                   any_pm=bool(p.pm_on.any()))


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


@pytest.mark.parametrize("families", [
    ("pooled",), ("store",), ("het",), ("shock",), ("shock", "store"),
    ("shock_store",), ("pm",), ALL])
def test_one_step_matches_reference(families):
    p, flags = _flags(families)
    B = p.k.shape[0]
    pt = TE.from_reference(p, device="cpu")
    s = RE._init_state(p, np, 1)
    rng = np.random.default_rng(1234)
    seen = dict(in_restore=False, seen_ckpt=False, macro=False)
    with np.errstate(all="ignore"):
        for _ in range(60):
            u, u2, u_pm = rng.random(B), rng.random(B), rng.random(B)
            z, z_pm = rng.standard_normal(B), rng.standard_normal((B, 2))
            pre = RE._attempt(s, p, u2, np, RE._lw_numpy, flags["any_store"],
                              flags["any_het"], flags["any_shock"])
            nxt = RE._apply(s, p, pre, u, z, None, None, u_pm, z_pm, 0.05, 1,
                            flags["any_pm"], np)
            st = TE._State(*(TE._tensor(a, "cpu") for a in s))
            t = lambda a: torch.as_tensor(a, dtype=torch.float64)
            tpre = TE._attempt(st, pt, t(u2), flags["any_store"],
                               flags["any_het"], flags["any_shock"])
            got = TE._apply(st, pt, tpre, t(u), t(z), t(u_pm), t(z_pm), 0.05,
                            flags["any_pm"])
            _assert_state_close(nxt, got, rtol=1e-12)
            seen["in_restore"] |= bool(s.in_restore.any())
            seen["seen_ckpt"] |= bool(s.seen_ckpt.any())
            seen["macro"] |= bool(((nxt.n_fail - s.n_fail) > 1).any())
            s = nxt
    # The compared states cover restores, measured V and (outside store /
    # shocked-only batches, which never macro-step) failure bursts.
    assert seen["in_restore"] and seen["seen_ckpt"]
    if "pooled" in families:
        assert seen["macro"]


# ---------------------------------------------------------------- end to end
def _assert_results_close(a, b, rtol):
    for f in ("n_checkpoints", "n_failures", "n_server_restores",
              "n_peer_restores", "completed"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for f in ("wall_time", "work_required", "wasted_work", "checkpoint_time",
              "restore_time", "server_bytes"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=rtol,
                                   atol=0.0, err_msg=f)


def test_end_to_end_parity_draws_match_numpy_backend():
    cells_r, cells_t = _cells(R, ALL), _cells(T, ALL)
    assert 40 <= len(cells_t) <= 56
    ref = R_sim.run_cells(cells_r, backend="numpy")
    got = TE.run_cells(cells_t, device="cpu", draws="numpy", chunk=64)
    assert got.completed.any() and not got.completed.all()  # censoring too
    _assert_results_close(ref, got, rtol=1e-9)


def test_scan_and_fused_agree_on_cpu():
    pooled = _cells(T, ("pooled",))
    cells = [pooled[i] for i in (0, 2, 4, 18, 28)] + _cells(T, ("pm",))[2:3]
    a = TE.run_cells(cells, device="cpu", step="scan", chunk=32)
    b = TE.run_cells(cells, device="cpu", step="fused", chunk=13)
    _assert_results_close(a, b, rtol=0.0)


# ---------------------------------------------------------------- philox
@pytest.mark.parametrize("family,kw", [
    ("pooled", dict(k=16, work=2 * 3600.0)),
    ("pm", dict(k=64, n_slots=256, work=2 * 3600.0)),
])
def test_philox_means_agree_with_numpy_backend(family, kw):
    n = 32
    scen_r = R_sim.scenario("constant", mtbf=4000.0)
    scen_t = T_sim.scenario("constant", mtbf=4000.0)
    regime = dict(regime="gossip", gossip_period=600.0) if family == "pm" \
        else {}
    a = R_sim.run_cells([_cell(R, scen_r, seed=s, **regime, **kw)
                         for s in range(n)], backend="numpy")
    b = TE.run_cells([_cell(T, scen_t, seed=s, **regime, **kw)
                      for s in range(n)], device="cpu", draws="philox")
    se = np.sqrt(a.wall_time.var() / n + b.wall_time.var() / n)
    assert abs(a.wall_time.mean() - b.wall_time.mean()) <= 3.0 * se


def test_philox_cell_is_batch_composition_invariant():
    cells = _cells(T, ALL)[::4]
    batch = TE.run_cells(cells, device="cpu", chunk=32)
    for i in (0, len(cells) // 2, len(cells) - 1):
        alone = TE.run_cells([cells[i]], device="cpu", chunk=32)
        for f in ("wall_time", "n_failures", "n_checkpoints", "wasted_work",
                  "restore_time", "server_bytes"):
            assert getattr(alone, f)[0] == getattr(batch, f)[i], (i, f)


def test_philox_known_answer_and_uniform_range():
    from repro_torch.sim.draws import PhiloxDraws, philox4x32

    z = torch.zeros(1, dtype=torch.int64)
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    # Random123's published Philox4x32-10 known-answer vectors.
    assert [int(w) for w in philox4x32(z, z, z, z, z, z)] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert [int(w) for w in philox4x32(f, f, f, f, f, f)] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    d = PhiloxDraws(range(512), True, "cpu").next(16)
    assert d.shape == (16, 6, 512) and d.dtype == torch.float64
    for row in (0, 2, 3):
        assert 0.0 <= float(d[:, row].min()) and float(d[:, row].max()) < 1.0
        assert abs(float(d[:, row].mean()) - 0.5) < 0.01
    for row in (1, 4, 5):
        assert abs(float(d[:, row].mean())) < 0.03
        assert abs(float(d[:, row].std()) - 1.0) < 0.03


# ---------------------------------------------------------------- guards
def test_per_peer_batches_raise():
    cells = [_cell(T, _scenarios(T)[0], regime="isolated", k=16)]
    with pytest.raises(NotImplementedError, match="per-peer"):
        TE.run_cells(cells, device="cpu")
    TE.run_cells([_cell(T, _scenarios(T)[0], regime="isolated", k=16,
                        work=600.0)], device="cpu", peer_form="pm")


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cells = [_cell(T, _scenarios(T)[0])]
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.run_cells(cells)
    with pytest.raises(RuntimeError, match="CUDA"):
        T_sim.compare_grid([T_sim.GridEntry(_scenarios(T)[0], 4000.0, 900.0)],
                           seeds=(0,), work=600.0)
    with pytest.raises(ValueError):
        TE.run_cells(cells, device="cpu", step="nope")
    with pytest.raises(ValueError):
        TE.run_cells(cells, device="cpu", draws="nope")


def test_package_imports_without_jax_or_repro():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "assert all(sys.modules[n] is None for n in bad), bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
