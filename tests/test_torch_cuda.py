"""The CUDA sim-step kernel against its plain torch version, on the card.

Marked ``cuda``: it skips without a CUDA device (decided inside the test,
so every xdist worker collects the same tests).  Imports only torch and
the port, so it runs on a GPU machine without jax:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import sim_step as TK
from repro_torch.p2p import StoreSpec
from repro_torch.sim import (CellSpec, PeerClass, PeerClassMix, PolicyConfig,
                             ShockSpec, scenario)
from repro_torch.sim import engine as TE
from repro_torch.sim.draws import PhiloxDraws

FLAGS = dict(any_store=True, any_het=True, any_shock=True, any_pm=True)


def _cells(n):
    mix = PeerClassMix((PeerClass("stable"),
                        PeerClass("volatile", hazard_mult=3.0,
                                  uplink_mult=0.5)), (0.5, 0.5))
    const = scenario("constant", mtbf=3000.0)
    ad = PolicyConfig(kind="adaptive", prior_mu=1 / 3000.0, prior_v=20.0)
    gs = PolicyConfig(kind="adaptive", prior_mu=1 / 3000.0, prior_v=20.0,
                      regime="gossip", gossip_period=300.0)
    kw = dict(work=3 * 3600.0, V=20.0, T_d=50.0, max_wall_time=1e6)
    base = [
        CellSpec(scenario=const, policy=ad, **kw),
        CellSpec(scenario=scenario("doubling", mtbf0=3000.0,
                                   double_after=1800.0),
                 policy=PolicyConfig(kind="fixed", fixed_T=2400.0), **kw),
        CellSpec(scenario=scenario("diurnal", mtbf=3000.0),
                 policy=PolicyConfig(kind="oracle"), **kw),
        CellSpec(scenario=const, policy=ad, store=StoreSpec(R=3), **kw),
        CellSpec(scenario=const, policy=PolicyConfig(kind="oracle"),
                 store=StoreSpec(R=3), mix=mix, **kw),
        CellSpec(scenario=scenario("trace", times=(0.0, 900.0),
                                   mtbfs=(3000.0, 800.0)), policy=ad,
                 store=StoreSpec(R=3),
                 shock=ShockSpec(rate=5e-4, kill_frac=0.4), **kw),
        CellSpec(scenario=const, policy=gs, k=64, n_slots=256, **kw),
        CellSpec(scenario=scenario("flash_crowd", mtbf=3000.0 * 1e5),
                 policy=gs, k=1_000_000, n_slots=4_000_000, **kw),
    ]
    import dataclasses
    return [dataclasses.replace(base[i % len(base)], seed=i)
            for i in range(n)]


@pytest.mark.cuda
def test_kernel_equals_plain_version_bitwise_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cells = _cells(200)
    p = TE.from_reference(TE._pack(cells), device="cuda")
    s = TE._init_state(p, 1)
    src = PhiloxDraws([c.seed for c in cells], True, "cuda")
    before = TK.LAUNCHES
    for _ in range(6):   # cells start finishing after ~300 steps
        d = src.next(64)
        a, ta = TK.fused_chunk(s, p, d, macro_threshold=0.05, **FLAGS)
        b, tb = TK.fused_chunk_ref(s, p, d, macro_threshold=0.05, **FLAGS)
        torch.cuda.synchronize()
        assert torch.equal(ta, tb)
        for name, x, y in zip(a._fields, a, b):
            same = ((x == y) | (torch.isnan(x) & torch.isnan(y))
                    if x.is_floating_point() else x == y)
            assert bool(same.all()), name
        s = a
    assert TK.LAUNCHES == before + 6
    assert bool(s.finished.any())


def _main_path_cells(variant):
    """Cells of the kernel variants the main path runs: the Fig. 4 grids
    (pooled, no store/het/shock/pm) and the fleet grid (class-pooled)."""
    if variant == "pooled":
        return [CellSpec(scenario=scenario("constant", mtbf=m),
                         policy=pol, seed=i, k=16, work=3 * 3600.0,
                         n_slots=128, max_wall_time=1.5e5)
                for i, (m, pol) in enumerate(
                    (m, pol) for m in (4000.0, 7200.0) for pol in (
                        PolicyConfig(kind="adaptive", prior_mu=1 / m,
                                     prior_v=20.0),
                        PolicyConfig(kind="fixed", fixed_T=900.0),
                        PolicyConfig(kind="oracle")) for _ in range(12))]
    pol = PolicyConfig(kind="adaptive", prior_mu=1 / 2.5e8, prior_v=20.0,
                       regime="gossip", gossip_period=600.0, gossip_fanout=2)
    return [CellSpec(scenario=scenario("constant", mtbf=2.5e8), policy=pol,
                     seed=i, k=1_000_000, n_slots=4_000_000, work=1800.0)
            for i in range(72)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,flags", [
    ("pooled", (False, False, False, False)),
    ("pm", (False, False, False, True))])
def test_main_path_variants_equal_plain_version_on_card(variant, flags):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cells = _main_path_cells(variant)
    p_np = TE._pack(cells)
    got = TE.batch_flags(cells, p_np)
    assert tuple(got[f] for f in ("any_store", "any_het", "any_shock",
                                  "any_pm")) == flags
    p = TE.from_reference(p_np, device="cuda")
    s = TE._init_state(p, 1)
    src = PhiloxDraws([c.seed for c in cells], flags[3], "cuda")
    for _ in range(4):
        d = src.next(64)
        a, ta = TK.fused_chunk(s, p, d, macro_threshold=0.05, **got)
        b, tb = TK.fused_chunk_ref(s, p, d, macro_threshold=0.05, **got)
        torch.cuda.synchronize()
        assert torch.equal(ta, tb)
        for name, x, y in zip(a._fields, a, b):
            same = ((x == y) | (torch.isnan(x) & torch.isnan(y))
                    if x.is_floating_point() else x == y)
            assert bool(same.all()), name
        s = a
    assert bool(s.finished.any())
