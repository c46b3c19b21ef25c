"""On the card (marked ``cuda``; skips without one): each cell at its
SMOKE sizes through the whole run, untraced and traced, agrees with the
reference, and the traced run reads its device metrics; at the cell's
own size the control is not correct.

    python3 -m pytest -q -m cuda perfbench/test_perfbench_card.py
"""
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from harness import core, runner  # noqa: E402
from harness.smoke import SMOKE_TOL  # noqa: E402

SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_smoke_cell_on_card(card, workload, traced):
    cell = core.load_cell(workload)
    r = runner.run_cell(cell, 2 ** 31 + 5, 0.5, traced, device=card,
                        scale="smoke")
    assert r["failed"] == 0
    for k, c in r["checks"].items():
        assert c["value"] <= SMOKE_TOL[k], (k, c)
    assert r["device"]["platform"] == "gpu"
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    if traced:
        assert r["device"]["busy_s"] > 0
        assert any(n.startswith("idle_share") for n in r["metrics"])
    else:
        assert set(r["metrics"]) == names
    assert set(r["metrics"]) <= names


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_at_cell_size_is_not_correct(card, workload):
    """The control -- the reference in fp8 in the program's place -- at
    the cell's own size fails its limits (one seed; ``calibrate.py`` reads
    three or more)."""
    cell = core.load_cell(workload)
    r = runner.run_cell(cell, 2 ** 31 + 901, 8.0, False, device=card,
                        precision="fp8")
    values = [c["value"] for c in r["checks"].values()]
    assert all(v is not None and v < float("inf") for v in values), values
    assert not r["correct"], r["checks"]
