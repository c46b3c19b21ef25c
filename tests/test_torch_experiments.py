"""The port's Fig. 4/5 grids against ``repro.sim.experiments``.

With the parity draw source the port's batched grid replays the reference
numpy backend's trajectories, so every comparison row must agree within
1e-9 relative (libm differences over many steps); with Philox draws the
grid must keep the paper's shape (adaptive beats fixed intervals).
"""
import numpy as np
import pytest

import repro.sim as R_sim
import repro_torch.sim as T_sim

KW = dict(seeds=range(2), work=3 * 3600.0, k=16)
MTBFS = (4000.0, 14400.0)
INTERVALS = (300.0, 3600.0)


@pytest.mark.parametrize("fig", ["fig4_static", "fig4_dynamic",
                                 "fig5_v_sweep"])
def test_grid_with_parity_draws_matches_numpy_backend(fig):
    if fig == "fig5_v_sweep":
        args = dict(overheads=(5.0, 80.0), fixed_intervals=INTERVALS)
    else:
        args = dict(mtbfs=MTBFS, fixed_intervals=INTERVALS)
    ref = getattr(R_sim, fig)(backend="numpy", **args, **KW)
    got = getattr(T_sim, fig)(device="cpu", draws="numpy", chunk=64, **args,
                              **KW)
    assert sorted(ref) == sorted(got)
    for key in ref:
        for a, b in zip(ref[key], got[key]):
            assert (a.mtbf0, a.fixed_T) == (b.mtbf0, b.fixed_T)
            for f in ("adaptive_wall", "fixed_wall", "oracle_wall",
                      "relative_runtime", "oracle_gap"):
                assert getattr(b, f) == pytest.approx(getattr(a, f),
                                                      rel=1e-9), (key, f)
            assert a.adaptive.n_failures == b.adaptive.n_failures
            assert a.fixed.n_checkpoints == b.fixed.n_checkpoints


def test_fig5_td_sweep_with_philox_keeps_the_paper_shape():
    res = T_sim.fig5_td_sweep(downloads=(10.0, 200.0), fixed_intervals=(
        60.0, 3600.0), device="cpu", **KW)
    rel = np.array([c.relative_runtime for cs in res.values() for c in cs])
    gap = np.array([c.oracle_gap for cs in res.values() for c in cs])
    assert (rel > 100.0).all()
    assert (np.abs(gap - 1.0) < 0.05).all()
