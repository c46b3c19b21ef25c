"""Readings the limits of ``correct`` are set from, in one process on the
card at the cell's own size: the program's numbers over a dozen seeds or
more (sound runs: set-up, a short window, the check), the control's (the
reference in fp8 in the program's place) and each planted fault's
(``harness/faults.py``) over a few more.  Not part of a benchmark run.

    python3 perfbench/calibrate.py --workload <name> --seeds 101-112 \
        --control-seeds 201-203 --faults --seconds 6 --out <file.jsonl>
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from harness import core, faults, runner  # noqa: E402


def _seeds(text):
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch

    cell = core.load_cell(args.workload)
    jobs = [("program", s, None) for s in _seeds(args.seeds)] if args.seeds \
        else []
    if args.control_seeds:
        cs = _seeds(args.control_seeds)
        jobs += [("control", s, None) for s in cs]
        if args.faults:
            jobs += [("fault", s, f) for f in
                     faults.FAULTS[cell.traffic["kind"]] for s in cs]
    with open(args.out, "a") as out:
        for what, seed, fault in jobs:
            t0 = time.time()
            if fault is None:
                r = runner.run_cell(cell, seed, args.seconds, False,
                                    precision="fp8" if what == "control"
                                    else "float32")
            else:
                with faults.planted(cell.kind, fault):
                    r = runner.run_cell(cell, seed, args.seconds, False)
            row = {"workload": args.workload, "what": what, "fault": fault,
                   "seed": seed, "seconds": time.time() - t0,
                   "attempted": r["attempted"], "metrics": r["metrics"],
                   "numbers": {k: c["value"] for k, c in r["checks"].items()},
                   "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
            out.flush()
            del r
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
