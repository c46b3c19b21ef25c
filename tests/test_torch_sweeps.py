"""The rest of the port's ``sim/experiments.py`` against the reference on
the CPU: the server-offload, gossip-fidelity, heterogeneity and
correlated-churn sweeps, ``scenario_sweep``, ``compare`` and
``summarize``, each at a small size (2-3 seeds, 4 h of work) with the
numpy parity draws (``device="cpu", draws="numpy"``) against
``backend="numpy"``: the same rows in the same order, counts and strings
equal, floats within 1e-9 relative (numpy's and torch's libm differ by an
ulp; the runs compound it), the same CSV headers and the same row layout.
"""
import dataclasses
import math

import pytest

import repro.p2p as R_p2p
import repro.sim as R_sim
import repro_torch.p2p as T_p2p
import repro_torch.sim as T_sim
from repro_torch.sim import experiments as TX

RUN = dict(device="cpu", draws="numpy")
SMALL = dict(seeds=range(2), work=4 * 3600.0)


def _assert_rows_close(a, b, rtol=1e-9):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, float) and not isinstance(u, bool):
                assert math.isclose(v, u, rel_tol=rtol, abs_tol=0.0), \
                    (f.name, u, v)
            elif dataclasses.is_dataclass(u):
                _assert_rows_close([u], [v], rtol)
            else:
                assert u == v, (f.name, u, v)


def _assert_csv_alike(a, b):
    assert a[0] == b[0]                       # the header
    assert len(a) == len(b)
    for x, y in zip(a[1:], b[1:]):
        xs, ys = x.split(","), y.split(",")
        assert len(xs) == len(ys)
        for u, v in zip(xs, ys):
            try:
                assert math.isclose(float(u), float(v), rel_tol=1e-6,
                                    abs_tol=0.05)
            except ValueError:                # a name field
                assert u == v


def _three(ns, mtbf):
    sc = ns.scenario
    return [sc("constant", mtbf=mtbf), sc("diurnal", mtbf=mtbf, amplitude=0.6),
            sc("flash_crowd", mtbf=mtbf, spike_mtbf=900.0, at=3600.0,
               duration=3600.0)]


def test_server_offload_sweep_matches_reference():
    def run(sim, p2p, **kw):
        return sim.server_offload_sweep(
            _three(sim, 7200.0), R_values=(0, 3), mtbf0=7200.0,
            transfer=p2p.TransferModel(img_bytes=200e6, peer_uplink=5e6),
            **SMALL, **kw)

    a = run(R_sim, R_p2p, backend="numpy")
    b = run(T_sim, T_p2p, **RUN)
    _assert_rows_close(a, b)
    assert [(c.scenario, c.R) for c in b] == [
        (s, r) for s in ("constant", "diurnal", "flash_crowd") for r in (0, 3)]
    _assert_csv_alike(R_sim.offload_csv(a), T_sim.offload_csv(b))
    assert TX.OFFLOAD_CSV_HEADER == R_sim.experiments.OFFLOAD_CSV_HEADER


def test_gossip_fidelity_sweep_matches_reference():
    def run(sim, **kw):
        return sim.gossip_fidelity_sweep(
            _three(sim, 4000.0), periods=(300.0, 3600.0), fanouts=(1, 3),
            mtbf0=4000.0, seeds=range(2), work=4 * 3600.0, **kw)

    a = run(R_sim, backend="numpy")
    b = run(T_sim, **RUN)     # per-peer batch: the plain step (batch_step)
    _assert_rows_close(a, b)
    assert len(b) == 3 * 6 and b[0].regime == "pooled"
    _assert_csv_alike(R_sim.gossip_csv(a), T_sim.gossip_csv(b))
    assert TX.GOSSIP_CSV_HEADER == R_sim.experiments.GOSSIP_CSV_HEADER
    with pytest.raises(ValueError, match="per-peer"):
        T_sim.gossip_fidelity_sweep(_three(T_sim, 4000.0)[:1], periods=(),
                                    fanouts=(), seeds=range(1), work=600.0,
                                    step="fused", **RUN)


def test_heterogeneity_sweep_matches_reference():
    def run(sim, **kw):
        mixes = sim.experiments.default_mixes()[1:3]
        return sim.heterogeneity_sweep(_three(sim, 7200.0)[:2], mixes,
                                       mtbf0=7200.0, **SMALL, **kw)

    a = run(R_sim, backend="numpy")
    b = run(T_sim, **RUN)
    _assert_rows_close(a, b)
    assert [m.name for m in TX.default_mixes()] == \
        [m.name for m in R_sim.experiments.default_mixes()]
    _assert_csv_alike(R_sim.hetero_csv(a), T_sim.hetero_csv(b))


def test_correlated_churn_sweep_matches_reference():
    def run(sim, **kw):
        return sim.correlated_churn_sweep(
            _three(sim, 7200.0)[::2], shock_rates_per_hour=(0.0, 2.0),
            mtbf0=7200.0, **SMALL, **kw)

    a = run(R_sim, backend="numpy")
    b = run(T_sim, **RUN)
    _assert_rows_close(a, b)
    assert b[0].scope == "all" and b[0].kill_frac == 0.0
    _assert_csv_alike(R_sim.shock_csv(a), T_sim.shock_csv(b))


def test_scenario_sweep_compare_and_summarize_match_reference():
    def scens(sim):
        return [sim.scenario("constant", mtbf=7200.0),
                sim.scenario("diurnal", mtbf=7200.0),
                sim.scenario("constant", mtbf=4000.0)]

    a = R_sim.scenario_sweep(scens(R_sim), **SMALL, backend="numpy")
    b = T_sim.scenario_sweep(scens(T_sim), **SMALL, **RUN)
    assert list(a) == list(b) == ["constant#0", "diurnal", "constant#2"]
    _assert_rows_close(list(a.values()), list(b.values()))
    a = R_sim.compare(scenario=R_sim.scenario("constant", mtbf=4000.0),
                      mtbf0=4000.0, fixed_T=900.0, **SMALL, backend="numpy")
    b = T_sim.compare(scenario=T_sim.scenario("constant", mtbf=4000.0),
                      mtbf0=4000.0, fixed_T=900.0, **SMALL, **RUN)
    _assert_rows_close([a], [b])
    fa = R_sim.fig4_static(mtbfs=(4000.0,), fixed_intervals=(300.0, 3600.0),
                           **SMALL, backend="numpy")
    fb = T_sim.fig4_static(mtbfs=(4000.0,), fixed_intervals=(300.0, 3600.0),
                           **SMALL, **RUN)
    sa, sb = ([",".join(line.split()) for line in s.splitlines()]
              for s in (R_sim.summarize(fa), T_sim.summarize(fb)))
    assert len(sb) == 1 + 2
    _assert_csv_alike(sa, sb)


def test_paper_figs_entry_point_prints_every_csv(capsys):
    from repro_torch.launch import paper_figs

    paper_figs.main(["--fast", "--device", "cpu", "--draws", "numpy",
                     "--only", "fig5,offload"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == paper_figs.HEADER
    assert TX.OFFLOAD_CSV_HEADER in out
    assert sum(r.startswith("fig5_") for r in out) == 2 * 3 * 2
    with pytest.raises(SystemExit):
        paper_figs.main(["--only", "fig9", "--device", "cpu"])
