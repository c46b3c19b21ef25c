"""A run of a cell at its ``smoke`` sizes on the CPU: the whole of
``run.py`` but the look for a card, for rehearsals and the tests.

    python3 perfbench/harness/smoke.py <workload> [seed] [trace] [precision]
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core, runner  # noqa: E402

# At SMOKE sizes (bf16 on a 2-layer model) the program's readings are not
# the card's at full size, which the limits were set from: a sound SMOKE
# run is held to these instead, each a few times what it reads.
SMOKE_TOL = {"logits_rel_rms": 0.03, "token_gap": 0.1, "state_rel_rms": 0.03,
             "conv_rel_rms": 0.03, "k_rel_rms": 0.03, "v_rel_rms": 0.03,
             "loss_gap": 2e-4, "grad_gap": 5e-3, "change_gap": 5e-3}


def smoke_run(workload: str, seed: int = 12345, seconds: float = 0.05,
              traced: bool = False, precision: str = "float32"
              ) -> Dict[str, Any]:
    return runner.run_cell(core.load_cell(workload), seed, seconds, traced,
                           device="cpu", scale="smoke", precision=precision)


if __name__ == "__main__":
    a = sys.argv[1:]
    runner.emit(smoke_run(a[0], int(a[1]) if len(a) > 1 else 12345, 0.5,
                          bool(int(a[2])) if len(a) > 2 else False,
                          a[3] if len(a) > 3 else "float32"))
