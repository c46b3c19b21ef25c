"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for.  The cell, its configuration, traffic, metrics and limits are found
by the names in ``BENCHMARK.json``.  Prints the compared numbers beside
their limits as the last lines of standard error and one JSON object as
the last line of standard output; exits 1 without a result where CUDA or
the cards are missing, and 3 where a JAX module was loaded.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".perfbench_cache"
# every build and kernel cache inside the checkout, at fixed paths (the
# port builds its CUDA sources into src/repro_torch/kernels/_build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import core, runner

    cell = core.load_cell(args.workload)
    import repro_torch  # noqa: F401  (the program under test)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = runner.run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), device="cuda",
                             t_start=T_START)
    bad = sorted(set(result["_forbidden_modules"])
                 | set(core.forbidden_loaded()))
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
