"""The paper's evaluation on the port: the Fig. 4/5 grids and the four
sweeps, printed as CSV.

    PYTHONPATH=src python -m repro_torch.launch.paper_figs [--fast] \
        [--device cpu] [--draws philox|numpy] [--engine batched|reference] \
        [--only fig4,fig5,offload,gossip,hetero,shock]

Runs on CUDA unless ``--device cpu`` is given (and raises where there is
no card).  The Fig. 4/5 rows carry ``benchmarks/paper_figs.py``'s header,
settings and row format; ``--engine reference`` runs them on the
per-event heap simulator instead of the batched engine.  The sweeps
(server offload, gossip fidelity, heterogeneity, correlated churn) always
run on the batched engine and print their own CSVs, at the settings of
``benchmarks/server_offload.py``, ``gossip_fidelity.py``,
``heterogeneity.py`` and ``correlated_churn.py`` (copied below).  The
seconds of each part go to standard error.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List

from repro_torch.device import resolve_device
from repro_torch.p2p.transfer import TransferModel
from repro_torch.sim import (
    correlated_churn_sweep,
    fig4_dynamic,
    fig4_static,
    fig5_td_sweep,
    fig5_v_sweep,
    gossip_csv,
    gossip_fidelity_sweep,
    hetero_csv,
    heterogeneity_sweep,
    offload_csv,
    peer_class_mix,
    scenario,
    server_offload_sweep,
    shock_csv,
)

# benchmarks/paper_figs.py
HEADER = ("figure,param,fixed_T_seconds,relative_runtime_pct,"
          "adaptive_hours,fixed_hours,oracle_gap")
KW = dict(seeds=range(4), work=12 * 3600.0, k=16)
FAST_KW = dict(seeds=range(2), work=4 * 3600.0, k=16)
INTERVALS = (300.0, 900.0, 3600.0)
FAST_INTERVALS = (300.0, 3600.0)

# benchmarks/gossip_fidelity.py
GOSSIP_MTBF = 4000.0
GOSSIP_PERIODS = (300.0, 3600.0)
GOSSIP_FANOUTS = (1, 3)
GOSSIP_KW = dict(seeds=range(16), work=12 * 3600.0, k=16,
                 prior_mtbf_factor=8.0)
GOSSIP_FAST_KW = dict(seeds=range(4), work=6 * 3600.0, k=16,
                      prior_mtbf_factor=8.0)

# benchmarks/server_offload.py, heterogeneity.py, correlated_churn.py
MTBF = 7200.0
R_VALUES = (0, 3)
TRANSFER = TransferModel(img_bytes=200e6, peer_uplink=5e6, peer_downlink=50e6,
                         server_capacity=100e6, server_load=20.0)
OFFLOAD_KW = dict(seeds=range(8), work=12 * 3600.0, k=16)
OFFLOAD_FAST_KW = dict(seeds=range(3), work=4 * 3600.0, k=16)
HETERO_FIXED_T = 300.0
HETERO_KW = dict(seeds=range(8), work=12 * 3600.0, k=16)
HETERO_FAST_KW = dict(seeds=range(3), work=4 * 3600.0, k=16)
KILL_FRAC = 0.35
SHOCK_FIXED_T = 900.0
RATES = (0.0, 0.5, 1.0, 2.0)
FAST_RATES = (0.0, 1.0, 2.0)
SHOCK_KW = dict(seeds=range(8), work=12 * 3600.0, k=16)
SHOCK_FAST_KW = dict(seeds=range(4), work=6 * 3600.0, k=16)

PARTS = ("fig4", "fig5", "offload", "gossip", "hetero", "shock")


def _scenarios(mtbf: float):
    """The sweeps' three scenarios (every sweep benchmark uses these)."""
    return [scenario("constant", mtbf=mtbf),
            scenario("diurnal", mtbf=mtbf, amplitude=0.6),
            scenario("flash_crowd", mtbf=mtbf, spike_mtbf=900.0,
                     at=2 * 3600.0, duration=2 * 3600.0)]


def _fig_rows(figure: str, results) -> List[str]:
    rows = []
    for key, comps in sorted(results.items()):
        for c in comps:
            rows.append(
                f"{figure},{key:.0f},{c.fixed_T:.0f},{c.relative_runtime:.1f},"
                f"{c.adaptive_wall / 3600:.2f},{c.fixed_wall / 3600:.2f},"
                f"{c.oracle_gap:.3f}")
    return rows


def fig4(fast: bool, run_kw: dict) -> List[str]:
    kw, ivals = (FAST_KW, FAST_INTERVALS) if fast else (KW, INTERVALS)
    mtbfs = (4000.0, 7200.0, 14400.0)
    return (_fig_rows("fig4_left_mtbf", fig4_static(
                mtbfs=mtbfs, fixed_intervals=ivals, **kw, **run_kw))
            + _fig_rows("fig4_right_doubling", fig4_dynamic(
                mtbfs=mtbfs, fixed_intervals=ivals, **kw, **run_kw)))


def fig5(fast: bool, run_kw: dict) -> List[str]:
    kw, ivals = (FAST_KW, FAST_INTERVALS) if fast else (KW, INTERVALS)
    return (_fig_rows("fig5_left_ckpt_overhead", fig5_v_sweep(
                overheads=(5.0, 20.0, 80.0), fixed_intervals=ivals, **kw,
                **run_kw))
            + _fig_rows("fig5_right_download", fig5_td_sweep(
                downloads=(10.0, 50.0, 200.0), fixed_intervals=ivals, **kw,
                **run_kw)))


def offload(fast: bool, run_kw: dict) -> List[str]:
    return offload_csv(server_offload_sweep(
        _scenarios(MTBF), R_values=R_VALUES, transfer=TRANSFER, mtbf0=MTBF,
        **(OFFLOAD_FAST_KW if fast else OFFLOAD_KW), **run_kw))


def gossip(fast: bool, run_kw: dict) -> List[str]:
    return gossip_csv(gossip_fidelity_sweep(
        _scenarios(GOSSIP_MTBF),
        periods=GOSSIP_PERIODS[:1] if fast else GOSSIP_PERIODS,
        fanouts=GOSSIP_FANOUTS[-1:] if fast else GOSSIP_FANOUTS,
        mtbf0=GOSSIP_MTBF, **(GOSSIP_FAST_KW if fast else GOSSIP_KW),
        **run_kw))


def hetero(fast: bool, run_kw: dict) -> List[str]:
    mixes = [peer_class_mix("homogeneous"), peer_class_mix("boinc"),
             peer_class_mix("two_class", frac_volatile=0.5, hazard_ratio=6.0,
                            speed_ratio=1.5)]
    if not fast:
        mixes.insert(2, peer_class_mix("fast_core_volunteer_tail"))
    return hetero_csv(heterogeneity_sweep(
        _scenarios(MTBF), mixes, fixed_T=HETERO_FIXED_T, mtbf0=MTBF,
        **(HETERO_FAST_KW if fast else HETERO_KW), **run_kw))


def shock(fast: bool, run_kw: dict) -> List[str]:
    return shock_csv(correlated_churn_sweep(
        _scenarios(MTBF), shock_rates_per_hour=FAST_RATES if fast else RATES,
        kill_frac=KILL_FRAC, fixed_T=SHOCK_FIXED_T, mtbf0=MTBF,
        **(SHOCK_FAST_KW if fast else SHOCK_KW), **run_kw))


RUNNERS: Dict[str, Callable[[bool, dict], List[str]]] = dict(
    fig4=fig4, fig5=fig5, offload=offload, gossip=gossip, hetero=hetero,
    shock=shock)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="the benchmarks' smoke settings")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--draws", default="philox", choices=("philox", "numpy"))
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "reference"),
                    help="engine of the Fig. 4/5 grids (the sweeps run on "
                         "the batched engine)")
    ap.add_argument("--only", default=",".join(PARTS),
                    help=f"comma-separated subset of {','.join(PARTS)}")
    args = ap.parse_args(argv)
    parts = [p for p in args.only.split(",") if p]
    unknown = sorted(set(parts) - set(PARTS))
    if unknown:
        ap.error(f"unknown parts {unknown} (choose from {','.join(PARTS)})")

    dev = resolve_device(args.device)
    batched = dict(device=str(dev), draws=args.draws)
    figs = batched if args.engine == "batched" else dict(engine="reference")
    if any(p in ("fig4", "fig5") for p in parts):
        print(HEADER, flush=True)
    for part in PARTS:
        if part not in parts:
            continue
        t0 = time.monotonic()
        rows = RUNNERS[part](args.fast,
                             figs if part in ("fig4", "fig5") else batched)
        print("\n".join(rows), flush=True)
        print(f"# {part}: {len(rows)} lines in {time.monotonic() - t0:.2f} s "
              f"on {dev}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
