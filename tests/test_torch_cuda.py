"""The port's CUDA kernels against their plain torch versions, and the
port's paths on the card against the CPU.

Marked ``cuda``: it skips without a CUDA device (decided inside the test,
so every xdist worker collects the same tests).  Imports only torch and
the port, so it runs on a GPU machine without jax:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import sim_step as TK
from repro_torch.kernels import ssd_scan as SSD
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


def _same(a, b):
    for name, x, y in zip(a._fields, a, b):
        same = ((x == y) | (torch.isnan(x) & torch.isnan(y))
                if x.is_floating_point() else x == y)
        assert bool(same.all()), name


def _philox_chunk(s, p, src, n, flags):
    """One launch of the in-kernel route on ``src``'s next ``n`` steps:
    the new state and the steps taken per warp."""
    state = TK.pack_state(s)
    taken = torch.zeros(-(-s.t.shape[0] // TK.WARP), dtype=torch.int32,
                        device="cuda")
    TK.launch_philox(TK.pack_params(p), state, src.seeds, src.skip(n), n,
                     taken, macro_threshold=0.05, **flags)
    return TK.unpack_state(state), taken


@pytest.mark.cuda
@pytest.mark.parametrize("any_pm", [False, True])
@pytest.mark.parametrize("step0", [0, 256, 2**32 - 3])
def test_in_kernel_generator_equals_philox_draws_on_card(any_pm, step0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    seeds = list(range(300)) + [2**32 + 7, 2**40 + 3, -1, -2**40, 2**63 - 1]
    src = PhiloxDraws(seeds, any_pm, "cuda")
    assert torch.equal(TK.philox_draws(src, step0, 8), src.at(step0, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,flags", [
    ("pooled", (False, False, False, False)),
    ("pm", (False, False, False, True))])
@pytest.mark.parametrize("step0", [0, 256, 2**32 - 3])
def test_in_kernel_route_equals_plain_version_on_card(variant, flags, step0):
    """The Philox route (draws made in the kernel) against the plain version
    fed ``PhiloxDraws.next`` from the same counter, on the main path's
    variants; from 2**32 - 3 the chunks cross the counter's high word and
    the seeds are >= 2**32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cells = _main_path_cells(variant)
    p_np = TE._pack(cells)
    got = TE.batch_flags(cells, p_np)
    assert tuple(got[f] for f in ("any_store", "any_het", "any_shock",
                                  "any_pm")) == flags
    p = TE.from_reference(p_np, device="cuda")
    s = TE._init_state(p, 1)
    seeds = [c.seed + (2**32 if step0 > 2**31 else 0) for c in cells]
    src_k = PhiloxDraws(seeds, flags[3], "cuda")
    src_r = PhiloxDraws(seeds, flags[3], "cuda")
    src_k.step = src_r.step = step0
    before, philox = TK.LAUNCHES, TK.LAUNCHES_BY_ROUTE["philox"]
    for n in (64, 7, 64, 1, 64):
        a, ta = _philox_chunk(s, p, src_k, n, got)
        b, tb = TK.fused_chunk_ref(s, p, src_r.next(n), macro_threshold=0.05,
                                   **got)
        torch.cuda.synchronize()
        assert torch.equal(ta, tb)
        _same(a, b)
        s = a
    assert src_k.step == src_r.step == step0 + 200
    assert TK.LAUNCHES == before + 5
    assert TK.LAUNCHES_BY_ROUTE["philox"] == philox + 5
    assert bool(s.finished.any())


@pytest.mark.cuda
def test_in_kernel_route_every_flag_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cells = _cells(200)
    p = TE.from_reference(TE._pack(cells), device="cuda")
    s = TE._init_state(p, 1)
    seeds = [c.seed + 2**33 for c in cells]
    src_k = PhiloxDraws(seeds, True, "cuda")
    src_r = PhiloxDraws(seeds, True, "cuda")
    src_k.step = src_r.step = 2**32 - 100
    for _ in range(6):
        a, ta = _philox_chunk(s, p, src_k, 64, FLAGS)
        b, tb = TK.fused_chunk_ref(s, p, src_r.next(64), macro_threshold=0.05,
                                   **FLAGS)
        torch.cuda.synchronize()
        assert torch.equal(ta, tb)
        _same(a, b)
        s = a
    assert bool(s.finished.any())


@pytest.mark.cuda
def test_pre_generated_route_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cells = _cells(300)
    p = TE.from_reference(TE._pack(cells), device="cuda")
    s = TE._init_state(p, 1)
    d = PhiloxDraws([c.seed for c in cells], True, "cuda").next(300)
    state = TK.pack_state(s)
    taken = torch.zeros(-(-300 // TK.WARP), dtype=torch.int32, device="cuda")
    pre = TK.LAUNCHES_BY_ROUTE["pregenerated"]
    TK.launch(TK.pack_params(p), state, d, taken, macro_threshold=0.05,
              **FLAGS)
    assert TK.LAUNCHES_BY_ROUTE["pregenerated"] == pre + 1
    b, tb = TK.fused_chunk_ref(s, p, d, macro_threshold=0.05, **FLAGS)
    torch.cuda.synchronize()
    assert torch.equal(taken, tb)
    _same(TK.unpack_state(state), b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["pooled", "pm"])
def test_run_cells_fused_equals_scan_on_card(variant):
    """run_cells on the card: the kernel path (parameters and state packed
    once, draws made in the kernel) equals the plain scan path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    import dataclasses

    import numpy as np

    cells = _main_path_cells(variant)
    by_route = dict(TK.LAUNCHES_BY_ROUTE)
    a = TE.run_cells(cells, step="fused", chunk=96)
    assert TK.LAUNCHES_BY_ROUTE["philox"] > by_route["philox"]
    assert TK.LAUNCHES_BY_ROUTE["pregenerated"] == by_route["pregenerated"]
    b = TE.run_cells(cells, step="scan", chunk=96)
    assert a.completed.any()
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def _perpeer_cells():
    """A small per-peer batch: gossip at fanout 1, 3 and 8 with k = 2 and
    16, isolated, pooled, a fixed cell that macro-steps, a heterogeneous
    gossip cell, a shocked isolated cell, a store gossip cell and a
    class-pooled cell."""
    import dataclasses

    mix = PeerClassMix((PeerClass("stable"),
                        PeerClass("volatile", hazard_mult=3.0, speed=0.7,
                                  uplink_mult=0.5)), (0.6, 0.4))
    sc = scenario("constant", mtbf=4000.0)
    ad = dict(kind="adaptive", prior_mu=1 / 32000.0, prior_v=20.0)
    kw = dict(work=2 * 3600.0, V=20.0, T_d=50.0, max_wall_time=20 * 3600.0)
    g = [PolicyConfig(regime="gossip", gossip_period=300.0, gossip_fanout=f,
                      **ad) for f in (1, 3, 8)]
    iso = PolicyConfig(regime="isolated", **ad)
    cells = [CellSpec(scenario=sc, policy=pol, k=k, **kw)
             for k in (2, 16) for pol in g + [iso]]
    cells += [
        CellSpec(scenario=sc, policy=PolicyConfig(**ad), **kw),
        CellSpec(scenario=scenario("constant", mtbf=1000.0),
                 policy=PolicyConfig(kind="fixed", fixed_T=3600.0), **kw),
        CellSpec(scenario=sc, policy=g[1], mix=mix, **kw),
        CellSpec(scenario=sc, policy=iso,
                 shock=ShockSpec(rate=2e-4, kill_frac=0.3), **kw),
        CellSpec(scenario=sc, policy=g[0], store=StoreSpec(R=3), **kw),
        CellSpec(scenario=sc, policy=g[0], k=64, n_slots=256, **kw)]
    return [dataclasses.replace(c, seed=i) for i, c in enumerate(cells)]


@pytest.mark.cuda
def test_per_peer_form_card_equals_cpu():
    """The per-peer form through the plain step on the card equals the CPU
    with parity draws (counts exact, floats within 1e-9 relative) and
    launches no kernel; the Philox per-peer rows are the same bits on the
    card and the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    import numpy as np

    cells = _perpeer_cells()
    assert TE.batch_step(cells) == "scan"
    before = TK.LAUNCHES
    a = TE.run_cells(cells, device="cuda", draws="numpy", step="scan")
    b = TE.run_cells(cells, device="cpu", draws="numpy", step="scan")
    assert TK.LAUNCHES == before
    for f in ("n_checkpoints", "n_failures", "n_server_restores",
              "n_peer_restores", "completed"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for f in ("wall_time", "wasted_work", "checkpoint_time", "restore_time",
              "server_bytes"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-9,
                                   atol=0.0, err_msg=f)
    with pytest.raises(ValueError, match="per-peer"):
        TE.run_cells(cells, step="fused")
    seeds = [c.seed for c in cells] + [2**32 + 7, -1]
    for step0 in (0, 2**32 - 3):
        x = PhiloxDraws(seeds, False, "cuda", 32).obs_at(step0, 64)
        y = PhiloxDraws(seeds, False, "cpu", 32).obs_at(step0, 64)
        assert torch.equal(x.cpu(), y), step0


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["offload", "gossip", "hetero", "shock"])
def test_sweeps_complete_on_card(sweep):
    """Each sweep on the card at a small size: every cell completes; the
    per-peer gossip batch launches no kernel, the other three launch the
    kernel's variant for their flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch import sim

    kw = dict(seeds=range(2), work=3 * 3600.0)
    before = dict(TK.LAUNCHES_BY_VARIANT)
    launches = TK.LAUNCHES
    if sweep == "offload":
        rows, variant = sim.server_offload_sweep(**kw), "1000"
    elif sweep == "gossip":
        rows, variant = sim.gossip_fidelity_sweep(**kw), None
    elif sweep == "hetero":
        rows, variant = sim.heterogeneity_sweep(**kw), "0000"
    else:
        rows, variant = sim.correlated_churn_sweep(**kw), "0010"
    assert rows and all(r.completed_frac == 1.0 for r in rows)
    if variant is None:
        assert TK.LAUNCHES == launches
    else:
        assert TK.LAUNCHES_BY_VARIANT.get(variant, 0) > before.get(variant, 0)


def _ssd_inputs(b, s, h, p, n, dtype, seed, with_init):
    """x, dt, A, B, C, initial state on the card, made as
    tests/test_kernels.py makes them, from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = normal(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(normal(b, s, h)) * 0.1
    A = -torch.exp(normal(h) * 0.3)
    B = (normal(b, s, n) * 0.5).to(dtype)
    C = (normal(b, s, n) * 0.5).to(dtype)
    init = normal(b, h, p, n) if with_init else None
    return x, dt, A, B, C, init


@pytest.mark.cuda
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", [
    (2, 64, 3, 64, 128, 256, torch.bfloat16),     # s < Q: one short chunk
    (2, 512, 4, 64, 128, 256, torch.bfloat16),    # two full chunks
    (2, 384, 3, 32, 64, 128, torch.bfloat16),     # three chunks, p 32, n 64
    (1, 96, 2, 16, 16, 32, torch.float32),        # small head, ragged tile
    (2, 512, 8, 64, 64, 256, torch.bfloat16),     # zamba2's p, n and Q
])
def test_ssd_kernel_matches_plain_version_on_card(b, s, h, p, n, chunk,
                                                  dtype, with_init):
    """y within 1e-2 (bf16: one rounding of y, 2^-8 relative, after float32
    sums in another order) or 1e-4 (float32), the final state within 1e-4.
    bf16 at these shapes takes the tensor-core kernels; the SIMT kernel is
    held to the same bounds on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    x, dt, A, B, C, init = _ssd_inputs(b, s, h, p, n, dtype, 21, with_init)
    Q = min(chunk, s)
    how = SSD.route(dtype, p, n, Q)
    assert how == ("mma" if dtype == torch.bfloat16 else "simt")
    before, by_route = SSD.LAUNCHES, dict(SSD.LAUNCHES_BY_ROUTE)
    y, st = SSD.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=init)
    y_p, st_p = SSD.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                   initial_state=init)
    torch.cuda.synchronize()
    assert SSD.LAUNCHES == before + 1
    assert SSD.LAUNCHES_BY_ROUTE[how] == by_route[how] + 1
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    outs = [(y, st)]
    if how != "simt":
        outs.append(SSD._launch(x, dt, A, B, C, init, Q, "simt"))
    for y, st in outs:
        torch.testing.assert_close(y.float(), y_p.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(st, st_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_kernel_reads_strided_slices_and_refuses_bad_operands():
    """The model hands the kernel slices of the conv output: the batch and
    sequence strides are free, the inner axes dense.  What it cannot take
    raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    b, s, h, p, n = 2, 128, 4, 64, 128
    x, dt, A, B, C, _ = _ssd_inputs(b, s, h, p, n, torch.bfloat16, 22, False)
    wide = torch.cat([x.reshape(b, s, h * p), B, C], dim=-1)
    xs = wide[..., :h * p].reshape(b, s, h, p)
    Bs, Cs = wide[..., h * p:h * p + n], wide[..., h * p + n:]
    assert not xs.is_contiguous() and not Bs.is_contiguous()
    y, st = SSD.ssd_scan(xs, dt, A, Bs, Cs, chunk=64)
    y_c, st_c = SSD.ssd_scan(x, dt, A, B, C, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(y, y_c) and torch.equal(st, st_c)
    before = SSD.LAUNCHES
    with pytest.raises(ValueError):
        SSD.ssd_scan(x, dt.double(), A, B, C, chunk=64)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     B, C, chunk=64)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x, dt, A, B, C, chunk=48)      # 128 % 48 != 0
    assert SSD.LAUNCHES == before


@pytest.mark.cuda
def test_ssd_kernel_refuses_autograd():
    """Before the repair the kernel path under autograd returned y and the
    final state with no grad_fn (the outputs are filled through ctypes), so
    x, dt, B and C got zero gradient from the scan and nothing said so.
    Now the wrapper raises; under no_grad it still launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    x, dt, A, B, C, _ = _ssd_inputs(1, 64, 2, 64, 128, torch.bfloat16, 23,
                                    False)
    with torch.no_grad():
        y, st = SSD.ssd_scan(x, dt, A, B, C, chunk=64)
    assert y.grad_fn is None and st.grad_fn is None   # what training saw
    x.requires_grad_(True)
    before = SSD.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        SSD.ssd_scan(x, dt, A, B, C, chunk=64)
    assert SSD.LAUNCHES == before
    with torch.no_grad():
        SSD.ssd_scan(x, dt, A, B, C, chunk=64)
    assert SSD.LAUNCHES == before + 1


def _quant_cases():
    """(name, float32 values, block): the edge cases of the kernels'
    contract.  Made on the CPU from a numpy seed, moved to the card."""
    import numpy as np

    rng = np.random.default_rng(31)
    ties = rng.integers(-127, 127, 512) + 0.5
    ties[0] = 127.0                                    # scale exactly 1.0
    ext = rng.uniform(-3e38, 3e38, 512)
    nonfinite = rng.standard_normal(3 * 512)
    nonfinite[[5, 512 + 7, 512 + 9, 1025, 1026]] = [np.nan, np.inf, -np.inf,
                                                    np.inf, np.nan]
    return [
        ("zero block", np.zeros(2 * 512), 512),
        ("ties", ties, 512),
        ("extremes", ext, 512),
        ("single block", rng.standard_normal(512), 512),
        ("3 blocks", rng.standard_normal(3 * 512) * 1e-20, 512),
        ("257 blocks", rng.standard_normal(257 * 512) * 50.0, 512),
        ("block 32", rng.standard_normal(7 * 32), 32),
        ("block 96", rng.standard_normal(5 * 96), 96),
        ("block 4096", rng.standard_normal(3 * 4096), 4096),
        ("nan and inf", nonfinite, 512),
    ]


def _equal(a, b) -> bool:
    """Equal values, a NaN equal to a NaN (the bits of a NaN may differ)."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_equal_plain_versions_bitwise_on_card(dtype):
    """Codes, scales and dequantized values (float32 and bfloat16 out): 0
    mismatching elements, on every edge case and on a misaligned input
    (the scalar-load path).  A block holding a NaN or an inf gives what the
    plain version gives (scale 1.0 or inf, NaN quotients coded 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import ckpt_quant as Q

    for name, values, block in _quant_cases():
        x = torch.as_tensor(values, dtype=torch.float32).to(dtype).cuda()
        for xin in (x, torch.cat([x[:1], x])[1:]):     # aligned, misaligned
            before = dict(Q.LAUNCHES)
            q, s = Q.quantize_blocks(xin, block)
            qp, sp = Q.quantize_blocks_plain(xin, block)
            torch.cuda.synchronize()
            assert torch.equal(q, qp), name
            assert torch.equal(s, sp), name
            for out in (torch.float32, torch.bfloat16):
                d = Q.dequantize_blocks(q, s, block, out)
                assert _equal(d, Q.dequantize_blocks_plain(q, s, block,
                                                           out)), name
            assert Q.LAUNCHES["quantize_blocks"] == \
                before["quantize_blocks"] + 1
            assert Q.LAUNCHES["dequantize_blocks"] == \
                before["dequantize_blocks"] + 2


def _flash_inputs(bg, r, sq, skv, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((bg, r, sq, d), (bg, skv, d), (bg, skv, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bg,r,sq,skv,d,causal,softcap", [
    (2, 1, 128, 128, 64, True, None),
    (1, 4, 256, 256, 128, True, None),     # GQA
    (2, 2, 128, 384, 64, True, None),      # Sq < Skv
    (1, 2, 128, 128, 64, False, 50.0),     # softcap, no mask
    (2, 3, 40, 100, 16, True, 50.0),       # off the tile grid, D 16
    (2, 1, 24, 24, 32, True, None),
    (3, 2, 1000, 1000, 128, True, None),   # off the 128-row grid
    (2, 2, 100, 300, 64, True, None),      # Sq < Skv, off grid
    (1, 2, 200, 72, 128, True, 50.0),      # Sq > Skv: rows with no key
    (1, 2, 130, 130, 64, False, None),     # no mask, one row past a tile
])
def test_flash_kernel_matches_plain_version_on_card(bg, r, sq, skv, d,
                                                    causal, softcap, dtype):
    """Within tests/test_kernels.py's tolerances (float32 2e-5, bfloat16
    2e-2: one rounding of the output after float32 sums in another
    order; the tensor-core route rounds p to bfloat16 before p v, as the
    TPU's default-precision dot does, and stays inside the same bound).
    bfloat16 at head_dim 64 and 128 takes the tensor-core kernel, the
    rest the SIMT kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(bg, r, sq, skv, d, dtype, 41)
    before = FA.LAUNCHES
    by_route = dict(FA.LAUNCHES_BY_ROUTE)
    out = FA.flash_attention(q, k, v, scale=d ** -0.5, causal=causal,
                             softcap=softcap)
    want = FA.flash_attention_plain(q, k, v, scale=d ** -0.5, causal=causal,
                                    softcap=softcap)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    how = FA.route(dtype, d)
    assert how == ("wgmma" if dtype == torch.bfloat16 and d >= 64
                   else "simt")
    assert FA.LAUNCHES_BY_ROUTE[how] == by_route[how] + 1
    dead = max(sq - skv, 0) if causal else 0
    assert bool((out[:, :, :dead] == 0).all())
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_kernel_zero_rows_and_strided_operands():
    """Sq > Skv, causal: the rows that see no key are exactly 0, as in the
    plain version.  Strided views (a transposed projection, a slice of a
    longer buffer) give the output of their contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(1, 2, 200, 72, 64, torch.float32, 42)
    out = FA.flash_attention(q, k, v, scale=0.125)
    want = FA.flash_attention_plain(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert bool((out[:, :, :128] == 0).all())
    assert bool((want[:, :, :128] == 0).all())
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    q, k, v = _flash_inputs(3, 2, 64, 96, 128, torch.bfloat16, 43)
    qs = q.transpose(0, 1).contiguous().transpose(0, 1)
    buf = torch.cat([k, v], dim=-1)
    ks, vs = buf[..., :128], buf[..., 128:]
    assert not qs.is_contiguous() and not ks.is_contiguous()
    torch.testing.assert_close(FA.flash_attention(qs, ks, vs, scale=0.1),
                               FA.flash_attention(q, k, v, scale=0.1),
                               rtol=0, atol=0)
    # the tensor-core route reads the same views through its tensor maps
    for d in (64, 128):
        q, k, v = _flash_inputs(3, 2, 200, 260, d, torch.bfloat16, 45)
        qs = q.transpose(0, 1).contiguous().transpose(0, 1)
        buf = torch.cat([k, v], dim=-1)
        ks, vs = buf[..., :d], buf[..., d:]
        assert FA.route(qs.dtype, d) == "wgmma"
        torch.testing.assert_close(FA.flash_attention(qs, ks, vs, scale=0.1),
                                   FA.flash_attention(q, k, v, scale=0.1),
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bg,r,sq,skv,d,causal,off,softcap", [
    (2, 2, 300, 94, 64, True, -200, None),    # whole q blocks see no key
    (2, 2, 300, 93, 128, True, -150, 50.0),   # a part of 93, softcap
    (1, 3, 256, 94, 64, False, None, None),   # an unmasked part of 94
    (1, 2, 1024, 264, 128, True, -264, None),  # a starcoder2-3b part
    (2, 1, 100, 93, 16, True, -7, None),      # the SIMT kernel at D 16
    (1, 2, 128, 130, 64, True, 40, None),     # a positive offset
])
def test_flash_kernel_offset_and_statistics_on_card(bg, r, sq, skv, d,
                                                    causal, off, softcap,
                                                    dtype):
    """A key part's call (``off``, ``stats``) against the plain version,
    by the bound of ``test_flash_kernel_matches_plain_version_on_card``
    on o and on the row statistics m and l; a row that sees no key gives
    exactly o = 0, m = -1e30 and l = 0.  The default offset gives the
    bits of an explicit ``Skv - Sq``, with or without statistics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(bg, r, sq, skv, d, dtype, 47)
    kw = dict(scale=d ** -0.5, causal=causal, softcap=softcap, off=off)
    modes = dict(FA.LAUNCHES_BY_MODE)
    o, m, l = FA.flash_attention(q, k, v, stats=True, **kw)
    wo, wm, wl = FA.flash_attention_plain(q, k, v, stats=True, **kw)
    torch.cuda.synchronize()
    assert FA.LAUNCHES_BY_MODE["stats"] == modes["stats"] + 1
    assert FA.LAUNCHES_BY_MODE["offset"] == modes["offset"] + (off
                                                               is not None)
    assert m.dtype == l.dtype == torch.float32 and m.shape == q.shape[:3]
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(o.float(), wo.float(), rtol=tol, atol=tol)
    empty = wl == 0
    if causal and off < 0:
        assert bool(empty[:, :, :-off].all())
    assert bool((o[empty] == 0).all()) and bool((l[empty] == 0).all())
    assert bool((m[empty] == FA.NEG_INF).all())
    torch.testing.assert_close(m, wm, rtol=tol, atol=tol)
    torch.testing.assert_close(l, wl, rtol=tol, atol=tol)
    base = dict(scale=d ** -0.5, causal=causal, softcap=softcap)
    plain = FA.flash_attention(q, k, v, **base)
    explicit = FA.flash_attention(q, k, v, off=skv - sq, stats=True, **base)
    assert torch.equal(plain, explicit[0])


@pytest.mark.cuda
def test_flash_kernel_refuses_autograd_and_bad_operands():
    """The kernel has no backward: under autograd the wrapper raises rather
    than return an output no gradient flows through; under no_grad it
    launches.  Operands it does not take raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(2, 1, 64, 64, 64, torch.bfloat16, 44)
    q.requires_grad_(True)
    before = FA.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, k, v, scale=0.125)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q.detach()[..., :48], k[..., :48], v[..., :48],
                           scale=0.125)
    assert FA.LAUNCHES == before
    with torch.no_grad():
        out = FA.flash_attention(q, k, v, scale=0.125)
    assert out.grad_fn is None and FA.LAUNCHES == before + 1


# --------------------------------------------------------------------------- #
# The workflow digital twin and the policy service on the card                #
# --------------------------------------------------------------------------- #

def _twin_dag(form, scale=1.0):
    from repro_torch.sim import Stage, WorkflowSpec, peer_class_mix

    spec = WorkflowSpec(stages=(
        Stage(name="prep", work=1800.0 * scale, k=8),
        Stage(name="train", work=2400.0 * scale, k=8, deps=("prep",),
              handoff=120.0),
        Stage(name="eval", work=900.0 * scale, k=8, deps=("train",),
              handoff=60.0)))
    scen = scenario("constant", mtbf=5400.0).with_shock(
        ShockSpec(rate=1 / 3600.0, kill_frac=0.3))
    kw = dict(policy=PolicyConfig(kind="adaptive", prior_mu=1 / 5400.0,
                                  prior_v=20.0), V=20.0, T_d=50.0)
    if form != "homogeneous":
        kw["store"] = StoreSpec(R=3)
    if form == "two_class":
        kw["mix"] = peer_class_mix("fast_core_volunteer_tail")
    return spec, scen, kw


@pytest.mark.cuda
@pytest.mark.parametrize("form,variant", [("homogeneous", "0010"),
                                          ("p2p", "1010"),
                                          ("two_class", "1110")])
def test_workflow_card_equals_cpu(form, variant):
    """W1 at 4 seeds: parity draws, the kernel's pre-generated route on the
    card against the plain step on the CPU -- counts and ``completed``
    exact, floats within 1e-9 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    import numpy as np

    from repro_torch.sim.workflow import simulate_workflow

    spec, scen, kw = _twin_dag(form)
    before = dict(TK.LAUNCHES_BY_VARIANT)
    a = simulate_workflow(spec, scen, seeds=range(4), device="cuda",
                          draws="numpy", **kw)
    launched = {k: v - before.get(k, 0)
                for k, v in TK.LAUNCHES_BY_VARIANT.items()
                if v - before.get(k, 0)}
    assert set(launched) == {variant}
    b = simulate_workflow(spec, scen, seeds=range(4), device="cpu",
                          draws="numpy", **kw)
    assert np.array_equal(a.completed, b.completed) and a.all_completed
    for sname in a.stages:
        sa, sb = a.stages[sname], b.stages[sname]
        for f in ("n_checkpoints", "n_failures", "n_server_restores",
                  "n_peer_restores", "completed"):
            assert np.array_equal(getattr(sa.sim, f), getattr(sb.sim, f))
        for x, y in ((sa.finish, sb.finish), (sa.sim.wasted_work,
                                              sb.sim.wasted_work),
                     (sa.handoff_waste, sb.handoff_waste),
                     (sa.server_bytes, sb.server_bytes)):
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=0)


def _variant_cells(variant):
    import dataclasses

    mix = PeerClassMix((PeerClass("stable"),
                        PeerClass("volatile", hazard_mult=3.0, speed=0.7,
                                  uplink_mult=0.5)), (0.6, 0.4))
    store, het, shock = (variant[i] == "1" for i in range(3))
    scen = scenario("diurnal", mtbf=4000.0) if not shock else \
        scenario("constant", mtbf=4000.0)
    kw = dict(work=1.5 * 3600.0, V=20.0, T_d=50.0, max_wall_time=1e6,
              policy=PolicyConfig(kind="adaptive", prior_mu=1 / 4000.0,
                                  prior_v=20.0),
              store=StoreSpec(R=3) if store else None,
              mix=mix if het else None,
              shock=ShockSpec(rate=3e-4, kill_frac=0.3) if shock else None)
    base = CellSpec(scenario=scen, **kw)
    return [dataclasses.replace(base, seed=i) for i in range(70)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["1010", "1100", "1110"])
@pytest.mark.parametrize("draws", ["philox", "numpy"])
def test_workflow_variants_equal_plain_version_on_card(variant, draws):
    """The variants the workflow path brings to the kernel, through
    run_cells with the kernel and with the plain step on the card, on both
    routes: every BatchResult field equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    import dataclasses

    import numpy as np

    from repro_torch.sim import run_cells

    cells = _variant_cells(variant)
    flags = TE.batch_flags(cells, TE._pack(cells))
    assert TK.variant(flags["any_store"], flags["any_het"],
                      flags["any_shock"], flags["any_pm"]) == variant
    route = "philox" if draws == "philox" else "pregenerated"
    before = TK.LAUNCHES_BY_ROUTE[route]
    a = run_cells(cells, step="fused", draws=draws, chunk=64)
    assert TK.LAUNCHES_BY_ROUTE[route] > before
    b = run_cells(cells, step="scan", draws=draws, chunk=64)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(x, y, equal_nan=isinstance(x, np.ndarray)
                              and x.dtype.kind == "f"), f.name
    assert a.completed.all()


@pytest.mark.cuda
def test_executor_on_card_resumes_bitwise_and_matches_cpu(tmp_path):
    """MixTask payloads on the card: a killed and resumed run's final
    payload is bitwise an uninterrupted run's, and within 1e-12 of the
    same run on the CPU (same control flow: the schedule's clock)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.exec import (ExecutorConfig, ExecutorKilled, KillSpec,
                                  MixTask, WorkflowExecutor)
    from repro_torch.sim.workflow import export_failure_schedule

    spec, scen, kw = _twin_dag("two_class", scale=0.5)
    sched = export_failure_schedule(spec, scen, seed=1, horizon_factor=60.0,
                                    mix=kw["mix"], store=kw["store"])
    outs, reps = {}, {}
    for dev in ("cuda", "cpu"):
        tasks = {s.name: MixTask(dim=64, salt=i, device=dev)
                 for i, s in enumerate(spec.stages)}
        like = tasks["eval"].init({"train": tasks["train"].init({})})
        knobs = dict(seconds_per_superstep=15.0, prior_mu=1 / 5400.0)
        ex = WorkflowExecutor(spec, tasks, sched, ExecutorConfig(
            root=str(tmp_path / f"{dev}_whole"), **knobs))
        reps[dev] = ex.run()
        outs[dev] = ex.output("eval", like)
        if dev == "cuda":
            cfg = ExecutorConfig(root=str(tmp_path / "killed"), **knobs)
            with pytest.raises(ExecutorKilled):
                WorkflowExecutor(spec, tasks, sched, cfg).run(
                    kill=KillSpec("train", after_supersteps=40))
            assert WorkflowExecutor(spec, tasks, sched, cfg).run(
                resume=True).completed
            got = WorkflowExecutor(spec, tasks, sched, cfg).output("eval",
                                                                   like)
            assert all(torch.equal(got[k], outs["cuda"][k]) for k in got)
            assert got["x"].device.type == "cuda"
    for n in reps["cuda"].stages:
        a, b = reps["cuda"].stages[n], reps["cpu"].stages[n]
        assert (a.executed_supersteps, a.n_failures, a.n_checkpoints,
                a.n_restores) == (b.executed_supersteps, b.n_failures,
                                  b.n_checkpoints, b.n_restores)
        assert a.waste == b.waste
    for k in outs["cpu"]:
        torch.testing.assert_close(outs["cuda"][k].cpu(), outs["cpu"][k],
                                   rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["windowed", "moment"])
def test_policy_service_card_equals_cpu(estimator):
    """P1 at small size: the session state on the card, decisions bitwise
    the CPU service's on a synthetic stream and a typed query batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    import numpy as np

    from repro_torch.policy import PolicyRequest
    from repro_torch.serve.policy_service import (PolicyService,
                                                  synthetic_stream)

    a = PolicyService(estimator=estimator, max_window=32, device="cuda")
    b = PolicyService(estimator=estimator, max_window=32, device="cpu")
    assert a.state.buf.device.type == "cuda"
    clients = [f"c{i}" for i in range(512)]
    tpl = PolicyRequest(k=8.0, window=32, prior_mu=1 / 7200.0)
    for batch in synthetic_stream("diurnal", n_clients=512, n_rounds=4,
                                  mix="boinc", seed=2):
        x = a.session_update_arrays(clients, template=tpl, **batch)
        y = b.session_update_arrays(clients, template=tpl, **batch)
        for f in ("interval", "mu", "V", "T_d", "n_failures", "clamped"):
            assert getattr(x, f).tobytes() == getattr(y, f).tobytes(), f
    reqs = [PolicyRequest(client=f"q{i}", k=float(4 + i),
                          failures=(1800.0 + 60.0 * i, 5400.0),
                          checkpoint_overheads=(15.0,), now=7200.0)
            for i in range(16)]
    assert [d.to_dict() for d in a.query(reqs)] == \
        [d.to_dict() for d in b.query(reqs)]
    assert np.isfinite([d.interval for d in a.query(reqs)]).all()


# --------------------------------------------------------------------------- #
# The dense variants on the card                                              #
# --------------------------------------------------------------------------- #

VARIANTS = ("gemma2-27b", "stablelm-1.6b", "starcoder2-3b", "qwen2-vl-7b")


@pytest.mark.cuda
@pytest.mark.parametrize("bg,r,d,softcap,scale", [
    (16, 2, 128, 50.0, 144 ** -0.5),   # gemma2: softcap 50, query_scale
    (32, 1, 64, None, 64 ** -0.5),     # stablelm: head_dim 64
    (4, 12, 128, None, 128 ** -0.5),   # starcoder2: 12 query heads a group
    (4, 7, 128, None, 128 ** -0.5),    # qwen2-vl: 7 query heads a group
])
def test_flash_kernel_at_the_variants_heads_on_card(bg, r, d, softcap,
                                                    scale):
    """The dense variants' head layouts on the tensor-core route (bf16),
    causal, 300 query rows (off the 128-row grid): within 2e-2 of the
    plain version, as the serving shapes are held in chip_smoke.py V1.
    With a softcap, q is scaled so the scores s = scale q.k have a
    standard deviation of 30 (|s| past the cap of 50; at unit inputs the
    softcap moves s by < 0.01 and a kernel without it would pass), and the
    softcap must move the plain output by 10x the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(bg, r, 300, 300, d, torch.bfloat16, 46)
    tol = 2e-2
    if softcap is not None:
        q = (q.float() * (30.0 / (scale * d ** 0.5))).to(q.dtype)
        capped = FA.flash_attention_plain(q, k, v, scale=scale,
                                          softcap=softcap).float()
        free = FA.flash_attention_plain(q, k, v, scale=scale).float()
        moved = ((free - capped).abs() / (tol + tol * capped.abs())).max()
        assert float(moved) >= 10.0
    assert FA.route(q.dtype, d) == "wgmma"
    before = FA.LAUNCHES_BY_ROUTE["wgmma"]
    out = FA.flash_attention(q, k, v, scale=scale, softcap=softcap)
    want = FA.flash_attention_plain(q, k, v, scale=scale, softcap=softcap)
    torch.cuda.synchronize()
    assert FA.LAUNCHES_BY_ROUTE["wgmma"] == before + 1
    torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                               atol=tol)


def _flash_layers(cfg, prompt: int) -> int:
    """How many of a prefill's layers take the flash kernel's route."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    return sum(L.flash_route(cfg, q_offset=0, seq=prompt,
                             layer_is_local=M._layer_is_local_static(cfg, i))
               for i in range(cfg.n_layers))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", VARIANTS)
def test_dense_variant_smoke_card_equals_cpu(arch):
    """V2 for one config: SMOKE in float32 (float32 KV cache) with the
    kernel on, prefill and 8 teacher-forced decode steps at 24- and
    40-token prompts, the card against the CPU: logits and caches within
    1e-4; the kernel launched once a layer whose window is not narrower
    than the prompt."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         compute_dtype="float32",
                                         use_flash_kernel=True)
    toks = torch.randint(0, cfg.vocab, (2, 48),
                         generator=torch.Generator().manual_seed(9))
    models = {dev: init_params(0, cfg, device=dev) for dev in ("cuda", "cpu")}
    for n in (24, 40):
        before = FA.LAUNCHES
        out = {}
        with torch.inference_mode():
            for dev, m in models.items():
                t = toks.to(dev)
                logits, cache = prefill(m, t[:, :n], cfg, n + 8,
                                        cache_dtype=torch.float32)
                seq = [logits]
                for i in range(8):
                    logits, cache = decode_step(m, cache, t[:, n + i:][:, :1],
                                                cfg)
                    seq.append(logits)
                out[dev] = (seq, cache)
        assert FA.LAUNCHES - before == _flash_layers(cfg, n)
        for a, b in zip(*(out[dev][0] for dev in ("cuda", "cpu"))):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        for k in ("k", "v"):
            torch.testing.assert_close(out["cuda"][1]["kv"][k].cpu(),
                                       out["cpu"][1]["kv"][k], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.cuda
def test_int8_cache_card_equals_cpu():
    """The int8 KV cache: quantize_kv gives the CPU's codes and scales bit
    for bit on the same K/V; gemma2 SMOKE (float32) decodes over the CPU's
    own prefill cache to the CPU's logits within 1e-4; the card's own
    prefill writes the CPU's codes within one step (a value on a rounding
    boundary may move across it with the last bits of the products)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.layers import quantize_kv

    g = torch.Generator().manual_seed(10)
    x = torch.randn(2, 2, 40, 16, generator=g) * 3
    x[0, 0, 3] = 0.0                      # an all-zero row: scale 1
    (qc, sc), (qg, sg) = quantize_kv(x), quantize_kv(x.cuda())
    assert torch.equal(qc, qg.cpu()) and torch.equal(sc, sg.cpu())
    cfg = get_smoke_config("gemma2-27b").replace(
        param_dtype="float32", compute_dtype="float32", kv_cache_quant=True,
        use_flash_kernel=True)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    cpu, card = init_params(0, cfg, device="cpu"), init_params(0, cfg,
                                                               device="cuda")
    with torch.inference_mode():
        _, cc = prefill(cpu, toks[:, :-1], cfg, 32)
        _, gc = prefill(card, toks[:, :-1].cuda(), cfg, 32)
        for k in ("k", "v"):
            d = (gc["kv"][k].cpu().int() - cc["kv"][k].int()).abs()
            assert int(d.max()) <= 1 and float(d.float().mean()) <= 1e-3
        moved = {"kv": {k: v.cuda() for k, v in cc["kv"].items()},
                 "index": cc["index"]}
        lc, _ = decode_step(cpu, cc, toks[:, -1:], cfg)
        lg, _ = decode_step(card, moved, toks[:, -1:].cuda(), cfg)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_card_generator_draws_on_its_device():
    """A CUDA torch.Generator draws the weights on the card: the same
    truncated normal (within [-2, 2] x scale, its standard deviation
    0.8796 x scale), and the model's parameters on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.layers import truncated_normal_init

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = truncated_normal_init(gen, (1000, 1000), 0.02, torch.float32)
    assert x.device.type == "cuda"
    assert float(x.abs().max()) <= 0.04
    assert abs(float(x.std()) / 0.02 - 0.8796) < 0.01
    assert abs(float(x.mean())) < 1e-4
    model = init_params(torch.Generator(device="cuda").manual_seed(0),
                        get_smoke_config("gemma2-27b"), device="cuda")
    assert all(p.device.type == "cuda" for p in model.parameters())


DENSE = ("olmo-1b",) + VARIANTS


def _dense_train_cfg(arch):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch).replace(param_dtype="float32",
                                          compute_dtype="float32",
                                          use_flash_kernel=False)


def _dense_batch(cfg, step: int = 0):
    from repro_torch.data import DataConfig, SyntheticLM

    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                                  seed=2)).batch_at(step)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_train_step_card_equals_cpu(arch):
    """One float32 SMOKE train step (64 tokens: the windows mask) from the
    same seeded weights on the card and the CPU: the loss within 1e-5
    relative, the gradients within 1e-4 max|g| + 1e-6, the master within
    1e-5 relative + 1e-6 except where the CPU gradient is below 1e-6
    (Adam's step near its eps; those within 0.05 lr, under 1% of them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (compute_grads, init_train_state,
                                        make_train_step)

    cfg = _dense_train_cfg(arch)
    batch = _dense_batch(cfg)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    states = {dev: init_train_state(0, cfg, dev) for dev in ("cuda", "cpu")}
    grads = {dev: compute_grads(st.params, {k: v.to(dev) for k, v
                                            in tb.items()}, cfg)[0]
             for dev, st in states.items()}
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k].cpu(), g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()) + 1e-6)
    lr = 1e-3
    out = {dev: make_train_step(cfg, AdamWConfig(lr=lr), constant(1.0))(
        st, batch) for dev, st in states.items()}
    loss = {dev: float(m["loss"]) for dev, (_, m) in out.items()}
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-5 * abs(loss["cpu"])
    n_tiny = 0
    for k, w in out["cpu"][0].opt.master.items():
        d = (out["cuda"][0].opt.master[k].cpu() - w).abs()
        tiny = (grads["cpu"][k].abs() < 1e-6) & (grads["cpu"][k] != 0)
        n_tiny += int(tiny.sum())
        assert bool((d[~tiny] <= 1e-5 * w.abs()[~tiny] + 1e-6).all()), k
        assert bool((d[tiny] <= 0.05 * lr).all()), k
    assert n_tiny < 1e-2 * sum(g.numel() for g in grads["cpu"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-27b"])
def test_remat_dots_on_card_gives_the_gradients_of_none(arch):
    """remat 'dots' (and 'full') on the card: bit for bit the gradients of
    'none'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state)

    cfg = _dense_train_cfg(arch)
    state = init_train_state(0, cfg, "cuda")
    batch = _to_device(_dense_batch(cfg, 1), "cuda")
    out = {r: compute_grads(state.params, batch, cfg.replace(remat=r))[0]
           for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        for k, g in out["none"].items():
            assert torch.equal(out[r][k], g), (r, k)


MOE = ("olmoe-1b-7b", "deepseek-moe-16b")


def _moe_cfg(arch, **change):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    cf = change.pop("capacity_factor", cfg.moe.capacity_factor)
    return cfg.replace(param_dtype="float32", compute_dtype="float32",
                       moe=dataclasses.replace(cfg.moe, capacity_factor=cf),
                       **change)


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_moe_smoke_card_equals_cpu(arch, cf, monkeypatch):
    """M1 for one config: SMOKE in float32 (float32 KV cache) with the
    kernel on, at capacity factor 8.0 and 0.5 (tokens drop), prefill of 32
    tokens and 4 teacher-forced decode steps, the card against the CPU:
    the routes (expert ids, within-capacity mask) equal on every layer and
    step, logits and caches within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import moe as MOE

    cfg = _moe_cfg(arch, capacity_factor=cf, use_flash_kernel=True)
    seen, real = [], MOE.route

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        seen.append(r)
        return r

    monkeypatch.setattr(MOE, "route", spy)
    toks = torch.randint(0, cfg.vocab, (2, 36),
                         generator=torch.Generator().manual_seed(12))
    out = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            m = init_params(0, cfg, device=dev)
            t, first = toks.to(dev), len(seen)
            logits, cache = prefill(m, t[:, :32], cfg, 36,
                                    cache_dtype=torch.float32)
            logs = [logits]
            for i in range(4):
                logits, cache = decode_step(m, cache, t[:, 32 + i:][:, :1],
                                            cfg)
                logs.append(logits)
            out[dev] = (logs, cache, seen[first:])
    (lg, cg, rg), (lc, cc, rc) = out["cuda"], out["cpu"]
    assert len(rg) == len(rc) == 5 * cfg.n_layers
    for a, b in zip(rg, rc):
        assert torch.equal(a.expert_ids.cpu(), b.expert_ids)
        assert torch.equal(a.kept.cpu(), b.kept)
    kept = torch.cat([r.kept.reshape(-1) for r in rc])
    assert bool(kept.all()) == (cf == 8.0)
    for a, b in zip(lg, lc):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        torch.testing.assert_close(cg["kv"][k].cpu(), cc["kv"][k], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE)
def test_moe_smoke_train_step_card_equals_cpu(arch):
    """One float32 SMOKE train step from the same seeded weights on the
    card and the CPU, held as the dense configs' are (T2's rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (compute_grads, init_train_state,
                                        make_train_step)

    cfg = _moe_cfg(arch, use_flash_kernel=False)
    batch = _dense_batch(cfg)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    states = {dev: init_train_state(0, cfg, dev) for dev in ("cuda", "cpu")}
    grads = {dev: compute_grads(st.params, {k: v.to(dev) for k, v
                                            in tb.items()}, cfg)[0]
             for dev, st in states.items()}
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k].cpu(), g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()) + 1e-6)
    lr = 1e-3
    out = {dev: make_train_step(cfg, AdamWConfig(lr=lr), constant(1.0))(
        st, batch) for dev, st in states.items()}
    for k in ("loss", "moe_aux_loss"):
        a, b = (float(out[dev][1][k]) for dev in ("cuda", "cpu"))
        assert abs(a - b) <= 1e-5 * abs(b), k
    n_tiny = 0
    for k, w in out["cpu"][0].opt.master.items():
        d = (out["cuda"][0].opt.master[k].cpu() - w).abs()
        tiny = (grads["cpu"][k].abs() < 1e-6) & (grads["cpu"][k] != 0)
        n_tiny += int(tiny.sum())
        assert bool((d[~tiny] <= 1e-5 * w.abs()[~tiny] + 1e-6).all()), k
        assert bool((d[tiny] <= 0.05 * lr).all()), k
    assert n_tiny < 1e-2 * sum(g.numel() for g in grads["cpu"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE)
def test_moe_backward_is_deterministic_and_remat_free_on_card(arch):
    """The dispatch and combine write unique slots (no atomic adds): on the
    card the backward run twice gives the same gradients bit for bit, and
    remat 'full' and 'dots' give those of 'none'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state)

    cfg = _moe_cfg(arch, use_flash_kernel=False)
    state = init_train_state(0, cfg, "cuda")
    batch = _to_device(_dense_batch(cfg, 1), "cuda")
    out = {r: compute_grads(state.params, batch,
                            cfg.replace(remat=r.split()[0]))[0]
           for r in ("none", "none again", "full", "dots")}
    for r in ("none again", "full", "dots"):
        for k, g in out["none"].items():
            assert torch.equal(out[r][k], g), (r, k)


HYBRID = "zamba2-7b"


@pytest.mark.cuda
def test_flash_kernel_at_head_dim_112_pads_and_keeps_the_callers_scale():
    """zamba2's head_dim 112 in bf16: padded to 128 for the tensor-core
    kernel and sliced back, within 2e-2 of the plain version at the
    caller's scale 1/sqrt(112); q is scaled so the scores have a standard
    deviation of 4, where the plain output at 1/sqrt(128) lies farther
    from the kernel's than the plain output at 1/sqrt(112) does, by more
    than the tolerance.  float32 at head_dim 112 is refused (no kernel
    takes it; the model runs _attention_core there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA

    d, tol = 112, 2e-2
    scale = d ** -0.5
    q, k, v = _flash_inputs(4, 2, 300, 300, d, torch.bfloat16, 47)
    q = (q.float() * (4.0 / (scale * d ** 0.5))).to(q.dtype)
    assert FA.route(q.dtype, d) == "wgmma"
    before = FA.LAUNCHES_BY_ROUTE["wgmma"]
    out = FA.flash_attention(q, k, v, scale=scale)
    right = FA.flash_attention_plain(q, k, v, scale=scale).float()
    wrong = FA.flash_attention_plain(q, k, v, scale=128 ** -0.5).float()
    torch.cuda.synchronize()
    assert FA.LAUNCHES_BY_ROUTE["wgmma"] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), right, rtol=tol, atol=tol)
    gap_right = float((out.float() - right).abs().max())
    gap_wrong = float((out.float() - wrong).abs().max())
    assert gap_wrong > gap_right + tol, (gap_right, gap_wrong)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(*(t.float() for t in (q, k, v)), scale=scale)


def _hybrid_cfg(**change):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(HYBRID).replace(param_dtype="float32",
                                            compute_dtype="float32",
                                            **change)


@pytest.mark.cuda
@pytest.mark.parametrize("prompt", [32, 40])
def test_hybrid_smoke_card_equals_cpu(prompt):
    """H1's serving check: zamba2 SMOKE in float32 with the kernels on
    (SIMT SSD, SIMT flash at head_dim 16), from the same CPU-drawn
    weights, prefill and 4 teacher-forced decode steps, the card against
    the CPU: logits, SSM state, conv carry and K/V within 1e-4; one SSD
    launch a Mamba2 layer and one flash launch a use of the shared block,
    in the prefill only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import decode_step, init_params, prefill

    cfg = _hybrid_cfg(use_flash_kernel=True)
    toks = torch.randint(0, cfg.vocab, (2, prompt + 4),
                         generator=torch.Generator().manual_seed(13))
    out = {}
    for dev in ("cuda", "cpu"):
        m = init_params(0, cfg, device=dev)
        t = toks.to(dev)
        ssd, fa = SSD.LAUNCHES, FA.LAUNCHES
        with torch.inference_mode():
            logits, cache = prefill(m, t[:, :prompt], cfg, prompt + 4,
                                    cache_dtype=torch.float32)
            logs = [logits]
            for i in range(4):
                logits, cache = decode_step(m, cache,
                                            t[:, prompt + i:][:, :1], cfg)
                logs.append(logits)
        n_uses = cfg.n_layers // cfg.shared_attn_every
        want = (cfg.n_layers, n_uses) if dev == "cuda" else (0, 0)
        assert (SSD.LAUNCHES - ssd, FA.LAUNCHES - fa) == want
        out[dev] = (logs, cache)
    (lg, cg), (lc, cc) = out["cuda"], out["cpu"]
    for a, b in zip(lg, lc):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    for part, k in (("ssm", "state"), ("ssm", "conv"), ("kv", "k"),
                    ("kv", "v")):
        torch.testing.assert_close(cg[part][k].cpu(), cc[part][k],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_hybrid_smoke_train_step_card_equals_cpu():
    """One float32 SMOKE train step from the same seeded weights on the
    card and the CPU, held as the dense configs' are (T2's rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (compute_grads, init_train_state,
                                        make_train_step)

    cfg = _hybrid_cfg()
    batch = _dense_batch(cfg)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    states = {dev: init_train_state(0, cfg, dev) for dev in ("cuda", "cpu")}
    grads = {dev: compute_grads(st.params, {k: v.to(dev) for k, v
                                            in tb.items()}, cfg)[0]
             for dev, st in states.items()}
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k].cpu(), g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()) + 1e-6)
    lr = 1e-3
    out = {dev: make_train_step(cfg, AdamWConfig(lr=lr), constant(1.0))(
        st, batch) for dev, st in states.items()}
    loss = {dev: float(m["loss"]) for dev, (_, m) in out.items()}
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-5 * abs(loss["cpu"])
    n_tiny = 0
    for k, w in out["cpu"][0].opt.master.items():
        d = (out["cuda"][0].opt.master[k].cpu() - w).abs()
        tiny = (grads["cpu"][k].abs() < 1e-6) & (grads["cpu"][k] != 0)
        n_tiny += int(tiny.sum())
        assert bool((d[~tiny] <= 1e-5 * w.abs()[~tiny] + 1e-6).all()), k
        assert bool((d[tiny] <= 0.05 * lr).all()), k
    assert n_tiny < 1e-2 * sum(g.numel() for g in grads["cpu"].values())


@pytest.mark.cuda
def test_hybrid_backward_is_deterministic_and_remat_free_on_card():
    """The shared block's gradient sums its two uses: on the card the
    backward run twice gives the same gradients bit for bit, and remat
    'full' and 'dots' (the Mamba2 blocks recomputed) give those of
    'none'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state)

    cfg = _hybrid_cfg()
    state = init_train_state(0, cfg, "cuda")
    batch = _to_device(_dense_batch(cfg, 1), "cuda")
    out = {r: compute_grads(state.params, batch,
                            cfg.replace(remat=r.split()[0]))[0]
           for r in ("none", "none again", "full", "dots")}
    for r in ("none again", "full", "dots"):
        for k, g in out["none"].items():
            assert torch.equal(out[r][k], g), (r, k)


# --------------------------------------------------------------------------- #
# The encdec family (whisper)
# --------------------------------------------------------------------------- #

ENCDEC = "whisper-large-v3"


@pytest.mark.cuda
@pytest.mark.parametrize("bg,r,sq,skv,d,dtype", [
    (4, 1, 1500, 1500, 64, torch.bfloat16),   # whisper's encoder
    (4, 1, 128, 1500, 64, torch.bfloat16),    # its cross-attention
    (3, 2, 37, 150, 16, torch.float32),       # SIMT, off the grid
    (3, 2, 150, 37, 16, torch.float32),       # Sq > Skv: every row sees all
])
def test_flash_kernel_unmasked_at_whispers_shapes_on_card(bg, r, sq, skv, d,
                                                          dtype):
    """The kernel's non-causal route: every key visible to every row,
    whatever Sq and Skv (1,500 keys: 11 full tiles of 128 and one of 92,
    whose columns past Skv must still be masked), within A1's tolerance
    of its plain version, bf16 also within 1e-2 relative RMS; no row is
    zero.  bf16 over 1,500 keys: the same check rejects the fault most
    likely there, the last tile's 36 zero-filled keys left visible (the
    plain attention over 1,536 keys, the padded ones zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(bg, r, sq, skv, d, dtype, 43)
    before = FA.LAUNCHES
    out = FA.flash_attention(q, k, v, scale=d ** -0.5, causal=False)
    want = FA.flash_attention_plain(q, k, v, scale=d ** -0.5, causal=False)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert bool((out.float().abs().amax(-1) > 0).all())
    if dtype == torch.bfloat16:
        def rel_rms(a):
            return float((a.float() - want.float()).square().mean().sqrt()
                         / want.float().square().mean().sqrt())

        assert rel_rms(out) <= 1e-2
        pad = -skv % 128
        planted = FA.flash_attention_plain(
            q, torch.nn.functional.pad(k, (0, 0, 0, pad)),
            torch.nn.functional.pad(v, (0, 0, 0, pad)), scale=d ** -0.5,
            causal=False)
        assert rel_rms(planted) > 1e-2
    # the causal call on the same inputs differs: the mask matters here
    causal = FA.flash_attention_plain(q, k, v, scale=d ** -0.5, causal=True)
    assert not torch.allclose(causal.float(), want.float(), rtol=tol,
                              atol=tol)


def _encdec_cfg(**change):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(ENCDEC).replace(param_dtype="float32",
                                            compute_dtype="float32", **change)


def _encdec_batch(cfg, step: int = 0):
    batch = _dense_batch(cfg, step)
    g = torch.Generator().manual_seed(50 + step)
    batch["frames"] = torch.randn((4, cfg.enc_seq, cfg.d_model),
                                  generator=g).numpy()
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("prompt", [8, 13])
def test_encdec_smoke_card_equals_cpu(prompt):
    """E1's serving check: whisper SMOKE in float32 with the kernel on
    (the SIMT kernel at head_dim 16, unmasked in the encoder and the
    cross-attention), from the same CPU-drawn weights and frames, prefill
    and 4 teacher-forced decode steps, the card against the CPU: logits,
    self K/V and cross K/V within 1e-4; 6 flash launches a prefill (2
    encoder, 2 self, 2 cross), none in decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import decode_step, init_params, prefill

    cfg = _encdec_cfg(use_flash_kernel=True)
    g = torch.Generator().manual_seed(14)
    toks = torch.randint(0, cfg.vocab, (2, prompt + 4), generator=g)
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g)
    out = {}
    for dev in ("cuda", "cpu"):
        m = init_params(0, cfg, device=dev)
        t = toks.to(dev)
        fa = FA.LAUNCHES_BY_ROUTE["simt"]
        with torch.inference_mode():
            logits, cache = prefill(m, t[:, :prompt], cfg, prompt + 4,
                                    frames=frames.to(dev),
                                    cache_dtype=torch.float32)
            n_pre = FA.LAUNCHES_BY_ROUTE["simt"] - fa
            logs = [logits]
            for i in range(4):
                logits, cache = decode_step(m, cache,
                                            t[:, prompt + i:][:, :1], cfg)
                logs.append(logits)
        want = 2 * cfg.n_layers + cfg.n_enc_layers if dev == "cuda" else 0
        assert n_pre == FA.LAUNCHES_BY_ROUTE["simt"] - fa == want
        out[dev] = (logs, cache)
    (lg, cg), (lc, cc) = out["cuda"], out["cpu"]
    for a, b in zip(lg, lc):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    for a, b in ((cg["kv"]["k"], cc["kv"]["k"]), (cg["kv"]["v"], cc["kv"]["v"]),
                 (cg["cross_k"], cc["cross_k"]),
                 (cg["cross_v"], cc["cross_v"])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_encdec_smoke_train_step_card_equals_cpu():
    """One float32 SMOKE train step on a batch with frames, from the same
    seeded weights on the card and the CPU, held as the dense configs'
    are (T2's rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import constant
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state, make_train_step)

    cfg = _encdec_cfg()
    batch = _encdec_batch(cfg)
    states = {dev: init_train_state(0, cfg, dev) for dev in ("cuda", "cpu")}
    grads = {dev: compute_grads(st.params, _to_device(batch, dev), cfg)[0]
             for dev, st in states.items()}
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k].cpu(), g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()) + 1e-6)
    lr = 1e-3
    out = {dev: make_train_step(cfg, AdamWConfig(lr=lr), constant(1.0),
                                n_microbatches=2)(st, batch)
           for dev, st in states.items()}
    loss = {dev: float(m["loss"]) for dev, (_, m) in out.items()}
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-5 * abs(loss["cpu"])
    n_tiny = 0
    for k, w in out["cpu"][0].opt.master.items():
        d = (out["cuda"][0].opt.master[k].cpu() - w).abs()
        tiny = (grads["cpu"][k].abs() < 1e-6) & (grads["cpu"][k] != 0)
        n_tiny += int(tiny.sum())
        assert bool((d[~tiny] <= 1e-5 * w.abs()[~tiny] + 1e-6).all()), k
        assert bool((d[tiny] <= 0.05 * lr).all()), k
    assert n_tiny < 1e-2 * sum(g.numel() for g in grads["cpu"].values())


@pytest.mark.cuda
def test_encdec_backward_is_deterministic_and_remat_free_on_card():
    """On the card the backward run twice gives the same gradients bit for
    bit, and remat 'full' and 'dots' (each encoder block and decoder layer
    recomputed) give those of 'none'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.train.step import (_to_device, compute_grads,
                                        init_train_state)

    cfg = _encdec_cfg()
    state = init_train_state(0, cfg, "cuda")
    batch = _to_device(_encdec_batch(cfg, 1), "cuda")
    out = {r: compute_grads(state.params, batch,
                            cfg.replace(remat=r.split()[0]))[0]
           for r in ("none", "none again", "full", "dots")}
    for r in ("none again", "full", "dots"):
        for k, g in out["none"].items():
            assert torch.equal(out[r][k], g), (r, k)


# ------------------------------------------------ cell sharding and ZeRO-1
def _mesh(devices):
    from repro_torch.distributed import make_mesh

    return make_mesh((len(devices),), ("data",), devices)


def _fields_equal(a, b, sl=slice(None)):
    import numpy as np

    for f in ("wall_time", "work_required", "n_checkpoints", "n_failures",
              "wasted_work", "checkpoint_time", "restore_time", "completed",
              "server_bytes", "n_server_restores", "n_peer_restores"):
        assert np.array_equal(getattr(a, f)[sl], getattr(b, f)[sl]), f


@pytest.mark.cuda
@pytest.mark.parametrize("draws", ["philox", "numpy"])
def test_sharded_cells_bitwise_on_one_card(draws):
    """C1 at a small size: extents 1-4 of cuda:0 (3 pads), the kernel on
    both routes, bitwise the unsharded run, shards x chunks launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cells = _cells(70)
    kw = dict(draws=draws, chunk=64, max_steps=512)
    want = TE.run_cells(cells, mesh=None, **kw)
    chunks = -(-want.n_steps // 64)
    for n in (1, 2, 3, 4):
        before = TK.LAUNCHES
        got = TE.run_cells(cells, mesh=_mesh(["cuda:0"] * n), **kw)
        _fields_equal(want, got)
        assert got.n_steps == want.n_steps
        assert TK.LAUNCHES - before == n * chunks


@pytest.mark.cuda
def test_sharded_perpeer_cells_bitwise_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    pol = PolicyConfig(kind="adaptive", prior_mu=1 / 3000.0, prior_v=20.0,
                       regime="gossip", gossip_period=300.0)
    cells = [CellSpec(scenario=scenario("constant", mtbf=3000.0),
                      policy=pol, k=k, seed=s, work=3600.0, V=20.0, T_d=50.0)
             for k in (4, 16) for s in range(3)]
    kw = dict(step="scan", chunk=32, max_steps=96)
    want = TE.run_cells(cells, mesh=None, **kw)
    before = TK.LAUNCHES
    _fields_equal(want, TE.run_cells(cells, mesh=_mesh(["cuda:0"] * 4),
                                     **kw))
    assert TK.LAUNCHES == before


@pytest.mark.cuda
def test_cells_over_the_card_and_the_cpu():
    """C2 at a small size: the card's shard bitwise, the CPU's within
    phase 4's rule (counts exact, floats 1e-9 relative)."""
    import numpy as np

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cells = _cells(40)
    kw = dict(draws="numpy", chunk=64, max_steps=256)
    want = TE.run_cells(cells, mesh=None, **kw)
    got = TE.run_cells(cells, mesh=_mesh(["cuda:0", "cpu"]), **kw)
    _fields_equal(want, got, slice(0, 20))
    for f in ("n_checkpoints", "n_failures", "completed"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), f
    for f in ("wall_time", "wasted_work", "restore_time", "server_bytes"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-9, atol=0)


def _zero1(cfg, opt, batch, devices, m, in_scan):
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import schedule as SCH
    from repro_torch.train import step as STEP

    mesh = _mesh(devices)
    state = STEP.shard_train_state(STEP.init_train_state(0, cfg, devices[0]),
                                   mesh)
    c = OPT.zero1_grad_constraint(mesh, STEP.zero1_specs(cfg, mesh).master)
    return STEP.make_train_step(cfg, opt, SCH.constant(1.0),
                                n_microbatches=m, grad_constraint=c,
                                zero1_grads_in_scan=in_scan)(state, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b"])
def test_zero1_split_batch_equals_unsplit_batch_on_card(arch):
    """Z1 at SMOKE: data extent n x m microbatches against n*m unsharded
    on cuda:0 -- bitwise unclipped, 1e-6 relative (above 1e-6 of the
    leaf's largest value) clipped."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import schedule as SCH
    from repro_torch.train import step as STEP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         compute_dtype="float32",
                                         use_flash_kernel=False)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=8, seed=4)).batch_at(0)
    for clip in (1e6, 1e-3):
        opt = OPT.AdamWConfig(lr=1e-3, grad_clip=clip)
        want, wm = STEP.make_train_step(cfg, opt, SCH.constant(1.0),
                                        n_microbatches=4)(
            STEP.init_train_state(0, cfg, "cuda"), batch)
        for n, m, in_scan in ((2, 2, False), (2, 2, True), (4, 1, True)):
            got, gm = _zero1(cfg, opt, batch, ["cuda:0"] * n, m, in_scan)
            torch.testing.assert_close(gm["grad_norm"], wm["grad_norm"],
                                       rtol=1e-6, atol=0)
            a, b = want.tree(), got.tree()
            for k in a:
                if clip < 1:
                    floor = 1e-6 * float(a[k].detach().abs().max())
                    torch.testing.assert_close(b[k], a[k], rtol=1e-6,
                                               atol=floor)
                else:
                    assert torch.equal(a[k], b[k]), (n, m, in_scan, k)


@pytest.mark.cuda
def test_zero1_over_the_card_and_the_cpu():
    """A replica and half the state on each of (cuda:0, cpu): the step
    within T2's master rule of the unsharded step on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import schedule as SCH
    from repro_torch.train import step as STEP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    cfg = get_smoke_config("olmo-1b").replace(
        param_dtype="float32", compute_dtype="float32", use_flash_kernel=False)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=8, seed=4)).batch_at(0)
    opt = OPT.AdamWConfig(lr=1e-3, grad_clip=1e6)
    want, wm = STEP.make_train_step(cfg, opt, SCH.constant(1.0),
                                    n_microbatches=2)(
        STEP.init_train_state(0, cfg, "cuda"), batch)
    got, gm = _zero1(cfg, opt, batch, ["cuda:0", "cpu"], 1, True)
    assert len({id(r) for r in got.replicas}) == 2
    assert {str(t.device) for v in got.opt.master.values()
            for t in v.shards} == {"cuda:0", "cpu"}
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-5 * abs(
        float(wm["loss"]))
    g, _ = STEP.compute_grads(STEP.init_train_state(0, cfg, "cuda").params,
                              STEP._to_device(batch, "cuda"), cfg)
    tiny_n, total = 0, 0
    for k, w in want.opt.master.items():
        d = (got.opt.master[k].gather("cuda") - w).abs()
        tiny = (g[k].abs() < 1e-6) & (g[k] != 0)
        assert not bool(((d > 1e-5 * w.abs() + 1e-6) & ~tiny).any()), k
        assert not tiny.any() or float(d[tiny].max()) <= 0.05 * opt.lr, k
        tiny_n, total = tiny_n + int(tiny.sum()), total + w.numel()
    assert tiny_n < 1e-2 * total


@pytest.mark.cuda
def test_every_kernel_launches_on_its_tensors_card():
    """With two or more cards, each kernel on tensors of the last card (the
    current device left at cuda:0) against its plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from repro_torch.kernels import ckpt_quant as Q
    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    assert torch.cuda.current_device() == 0
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(4096, generator=g, device=dev)
    q, s = Q.quantize_blocks(x, 512)
    qp, sp = Q.quantize_blocks_plain(x, 512)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(Q.dequantize_blocks(q, s, 512),
                       Q.dequantize_blocks_plain(q, s, 512))
    qkv = [t.to(dev) for t in _flash_inputs(2, 2, 128, 128, 64,
                                            torch.bfloat16, 41)]
    torch.testing.assert_close(
        FA.flash_attention(*qkv, scale=0.125).float(),
        FA.flash_attention_plain(*qkv, scale=0.125).float(),
        rtol=2e-2, atol=2e-2)
    x, dt, A, B, C, _ = [t.to(dev) if t is not None else None for t in
                         _ssd_inputs(2, 512, 4, 64, 128, torch.bfloat16, 21,
                                     False)]
    y, st = SSD.ssd_scan(x, dt, A, B, C, chunk=256)
    y_p, st_p = SSD.ssd_scan_plain(x, dt, A, B, C, chunk=256)
    torch.testing.assert_close(y.float(), y_p.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(st, st_p, rtol=1e-4, atol=1e-4)
    cells = _cells(70)
    p = TE.from_reference(TE._pack(cells), device=dev)
    s0 = TE._init_state(p, 1)
    d = PhiloxDraws([c.seed for c in cells], True, dev).next(64)
    a, ta = TK.fused_chunk(s0, p, d, macro_threshold=0.05, **FLAGS)
    b, tb = TK.fused_chunk_ref(s0, p, d, macro_threshold=0.05, **FLAGS)
    assert torch.equal(ta, tb)
    for name, u, w in zip(a._fields, a, b):
        assert torch.equal(u, w) or bool(
            (torch.isnan(u) & torch.isnan(w) | (u == w)).all()), name
    assert torch.equal(TK.philox_draws(PhiloxDraws([c.seed for c in cells],
                                                   True, dev), 0, 8),
                       PhiloxDraws([c.seed for c in cells], True,
                                   dev).at(0, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("draws", ["philox", "numpy"])
def test_sharded_cells_over_every_card(draws):
    """mesh='auto' with two or more cards: one shard a card, bitwise the
    unsharded run on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    cells = _cells(70)
    kw = dict(draws=draws, chunk=64, max_steps=512)
    want = TE.run_cells(cells, mesh=None, **kw)
    n = torch.cuda.device_count()
    before = TK.LAUNCHES
    got = TE.run_cells(cells, mesh="auto", **kw)
    _fields_equal(want, got)
    assert got.n_steps == want.n_steps
    assert TK.LAUNCHES - before == n * -(-want.n_steps // 64)


@pytest.mark.cuda
def test_zero1_over_every_card():
    """A replica and a piece of the state on each card: bitwise the
    unsharded step on cuda:0 with as many microbatches (the norm does not
    clip)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import schedule as SCH
    from repro_torch.train import step as STEP

    n = torch.cuda.device_count()
    cfg = get_smoke_config("olmo-1b").replace(
        param_dtype="float32", compute_dtype="float32", use_flash_kernel=False)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=2 * n, seed=4)).batch_at(0)
    opt = OPT.AdamWConfig(lr=1e-3, grad_clip=1e6)
    want, _ = STEP.make_train_step(cfg, opt, SCH.constant(1.0),
                                   n_microbatches=n)(
        STEP.init_train_state(0, cfg, "cuda:0"), batch)
    got, _ = _zero1(cfg, opt, batch, [f"cuda:{i}" for i in range(n)], 1,
                    True)
    assert len({id(r) for r in got.replicas}) == n
    for k, v in want.tree().items():
        assert torch.equal(v, got.tree()[k].to(v.device)), k


# ------------------------------------------- tensor parallelism (TP1's)
def _tp_mesh(shape, dev):
    from repro_torch.distributed import mesh as MESH

    n = shape[0] * shape[1]
    return MESH.make_mesh(shape, ("data", "model"),
                          dev if isinstance(dev, list) else [dev] * n)


def _tp_serve(model, cfg, prompt, forced):
    from repro_torch.serve import step as SERVE

    pre = SERVE.make_prefill_step(cfg, prompt.shape[1] + forced.shape[1],
                                  torch.float32)
    srv = SERVE.make_serve_step(cfg)
    logits, cache = pre(model, {"tokens": prompt})
    out = [logits[:, -1]]
    for k in range(forced.shape[1]):
        logits, cache = srv(model, cache, {"tokens": forced[:, k:k + 1]})
        out.append(logits[:, -1])
    if getattr(model, "is_split", False):
        cache = model.gather_cache(cache)
    return torch.stack(out).cpu(), cache["kv"]["k"].cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,m", [("olmo-1b", 2), ("olmo-1b", 4),
                                    ("gemma2-27b", 2), ("olmoe-1b-7b", 2),
                                    ("olmoe-1b-7b", 4),
                                    ("deepseek-moe-16b", 2)])
def test_split_smoke_card_equals_cpu_and_unsplit(arch, m):
    """TP1: a SMOKE config in float32 with the kernel on, split over
    (1, m) of cuda:0: logits and the K cache within 1e-4 of the CPU's
    split run and of the card's unsplit run, the flash kernel launched
    once a layer and shard a prefill; moe routes equal on the shards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params
    from repro_torch.models import moe as MOE

    cfg = get_smoke_config(arch).replace(
        param_dtype="float32", compute_dtype="float32", use_flash_kernel=True)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (4, 32), generator=g)
    forced = torch.randint(0, cfg.vocab, (4, 3), generator=g)
    card = init_params(0, cfg, device="cuda")
    want = _tp_serve(card, cfg, prompt.cuda(), forced.cuda())
    split = TP.split_model(card, _tp_mesh((1, m), "cuda:0"))
    routes, real = [], MOE.route

    def spy(*a):
        routes.append(real(*a))
        return routes[-1]

    before = FA.LAUNCHES
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MOE, "route", spy)
        got = _tp_serve(split, cfg, prompt.cuda(), forced.cuda())
    host = _tp_serve(TP.split_model(init_params(0, cfg, device="cpu"),
                                    _tp_mesh((1, m), "cpu")), cfg, prompt,
                     forced)
    for a, b, c in zip(got, host, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    assert FA.LAUNCHES - before == m * _flash_layers(cfg, 32)
    for i in range(0, len(routes), m):
        for r in routes[i + 1:i + m]:
            assert torch.equal(r.expert_ids, routes[i].expert_ids)
            assert torch.equal(r.kept, routes[i].kept)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b"])
def test_split_train_step_card_equals_unsplit(arch):
    """TP1: one float32 SMOKE step over (data 2, model 2) of cuda:0
    against the unsplit step with 4 microbatches: the loss and grad_norm
    within 1e-5 relative, the image in the unsplit layout, its gradients
    (the first moments) within 1e-4 max|g| + 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import schedule as SCH
    from repro_torch.train import step as STEP

    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         compute_dtype="float32")
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg.vocab, (8, 32), generator=g)
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    opt = OPT.AdamWConfig(lr=1e-3)
    want, wm = STEP.make_train_step(cfg, opt, SCH.constant(1.0),
                                    n_microbatches=4)(
        STEP.init_train_state(0, cfg, "cuda"), batch)
    split = STEP.shard_train_state(STEP.init_train_state(0, cfg, "cuda"),
                                   _tp_mesh((2, 2), "cuda:0"))
    got, gm = STEP.make_train_step(cfg, opt, SCH.constant(1.0),
                                   n_microbatches=2)(split, batch)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(gm[k], wm[k], rtol=1e-5, atol=0)
    a, b = want.tree(), got.tree()
    assert a.keys() == b.keys()
    clip = min(1.0, opt.grad_clip / float(wm["grad_norm"]))
    for k, v in a.items():
        assert v.shape == b[k].shape and v.dtype == b[k].dtype, k
        if k.startswith("opt/m/"):
            g_max = float(v.abs().max()) / ((1 - opt.b1) * clip)
            bound = (1 - opt.b1) * clip * (1e-4 * g_max + 1e-6)
            assert float((b[k] - v).abs().max()) <= bound, k


@pytest.mark.cuda
def test_split_backward_is_deterministic_and_remat_free_on_card():
    """TP1: a split model's gradients with remat none, full and dots, and
    a second backward, bitwise the same on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import init_params
    from repro_torch.models import model as M

    cfg = get_smoke_config("olmoe-1b-7b").replace(
        param_dtype="float32", compute_dtype="float32")
    split = TP.split_model(init_params(0, cfg, device="cuda")
                           .requires_grad_(True), _tp_mesh((1, 2), "cuda:0"))
    tok = torch.randint(0, cfg.vocab, (4, 32),
                        generator=torch.Generator().manual_seed(5)).cuda()
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}

    def grads(remat):
        for p in split.modules():
            p.zero_grad(set_to_none=True)
        loss, _ = M._split_loss(split, batch, cfg.replace(remat=remat), 0)
        loss.backward()
        return [p.grad.clone() for p in split.parameters()]

    ref = grads("none")
    for r in ("full", "dots", "none"):
        assert all(torch.equal(a, b) for a, b in zip(ref, grads(r))), r


@pytest.mark.cuda
def test_split_model_over_every_card():
    """A split over (1, n) of n distinct cards (n >= 2): the logits and K
    cache equal the unsplit run on cuda:0 within 1e-4."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import init_params

    n = 2 if torch.cuda.device_count() < 4 else 4
    cfg = get_smoke_config("olmo-1b").replace(
        param_dtype="float32", compute_dtype="float32", use_flash_kernel=True)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (4, 32), generator=g).cuda()
    forced = torch.randint(0, cfg.vocab, (4, 3), generator=g).cuda()
    card = init_params(0, cfg, device="cuda:0")
    want = _tp_serve(card, cfg, prompt, forced)
    split = TP.split_model(card, _tp_mesh((1, n), [f"cuda:{i}"
                                                   for i in range(n)]))
    assert {split.device(0, j) for j in range(n)} == {
        torch.device("cuda", i) for i in range(n)}
    got = _tp_serve(split, cfg, prompt, forced)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _ssm_serve(model, cfg, prompt, forced):
    """A prefill and teacher-forced decode steps: the logits stacked and
    the SSM state (the unsplit layout), on the CPU; for a split model also
    whether every shard's B and C conv carry is the same to the bit."""
    from repro_torch.serve import step as SERVE

    pre = SERVE.make_prefill_step(cfg, prompt.shape[1] + forced.shape[1],
                                  torch.float32)
    srv = SERVE.make_serve_step(cfg)
    logits, cache = pre(model, {"tokens": prompt})
    out = [logits[:, -1]]
    for k in range(forced.shape[1]):
        logits, cache = srv(model, cache, {"tokens": forced[:, k:k + 1]})
        out.append(logits[:, -1])
    same = True
    if getattr(model, "is_split", False):
        n = cfg.ssm.d_state
        bc = [cache["pieces"][(0, j)]["ssm"]["conv"][..., -2 * n:]
              for j in range(model.extent)]
        same = all(torch.equal(x, bc[0]) for x in bc[1:])
        cache = model.gather_cache(cache)
    return torch.stack(out).cpu(), cache["ssm"]["state"].cpu(), same


@pytest.mark.cuda
@pytest.mark.parametrize("arch,m", [("mamba2-130m", 2), ("zamba2-7b", 2),
                                    ("zamba2-7b", 4)])
def test_split_ssm_smoke_card_equals_cpu_and_unsplit(arch, m):
    """TP1: a mamba2 or zamba2 SMOKE config in float32 with the kernels on,
    split over its SSM heads on (1, m) of cuda:0: logits and the gathered
    SSM state within 1e-4 of the CPU's split run and of the card's
    unsplit run, one SIMT SSD launch a layer and shard a prefill, the B/C
    conv carries bitwise equal on the shards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import init_params

    cfg = get_smoke_config(arch).replace(
        param_dtype="float32", compute_dtype="float32", use_flash_kernel=True)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (4, 32), generator=g)
    forced = torch.randint(0, cfg.vocab, (4, 3), generator=g)
    card = init_params(0, cfg, device="cuda")
    want = _ssm_serve(card, cfg, prompt.cuda(), forced.cuda())
    split = TP.split_model(card, _tp_mesh((1, m), "cuda:0"))
    assert split.ssm_split
    before = SSD.LAUNCHES_BY_ROUTE["simt"]
    got = _ssm_serve(split, cfg, prompt.cuda(), forced.cuda())
    assert SSD.LAUNCHES_BY_ROUTE["simt"] - before == m * cfg.n_layers
    host = _ssm_serve(TP.split_model(init_params(0, cfg, device="cpu"),
                                     _tp_mesh((1, m), "cpu")), cfg, prompt,
                      forced)
    for a, b, c in zip(got[:2], host[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    assert got[2] and host[2]


@pytest.mark.cuda
def test_split_replicas_are_the_unsplit_program_on_card():
    """mamba2 SMOKE over a model extent of 3, which divides neither its
    vocabulary (256) nor its ``inner`` gcd (8): every model position runs
    the unsplit program, its logits and state bitwise the unsplit
    run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; see README)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import init_params

    cfg = get_smoke_config("mamba2-130m").replace(
        param_dtype="float32", compute_dtype="float32", use_flash_kernel=True)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (4, 32), generator=g).cuda()
    forced = torch.randint(0, cfg.vocab, (4, 3), generator=g).cuda()
    card = init_params(0, cfg, device="cuda")
    split = TP.split_model(card, _tp_mesh((1, 3), "cuda:0"))
    assert split.replicas
    want, got = _ssm_serve(card, cfg, prompt, forced), \
        _ssm_serve(split, cfg, prompt, forced)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
