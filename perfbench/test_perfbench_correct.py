"""The check that decides ``correct``, driven end to end at SMOKE size on
the CPU (``harness.smoke``: the whole run but the look for a card), with
each cell's own limits:

* a sound run of the program agrees with the plain reference (prefill
  logits and cache, the train steps' losses, gradients and changes);
* the control -- the reference in fp8, the precision below the
  configuration's bfloat16, put in the program's place -- is not correct;
* the timed path broken underneath is not correct, once for each fault
  the cell can have: an answer altered where it is produced (prefill), a
  step that returns its state unchanged and half of the batch left out
  with the mean over the rest (training).  The cells run on one card, so
  no exchange between cards can be left out.
"""
import sys
from pathlib import Path
from unittest import mock

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from harness import core, faults  # noqa: E402
from harness.smoke import SMOKE_TOL, smoke_run  # noqa: E402

PREFILL = ["mamba2-2.7b.prefill-2k", "olmo-1b.prefill-2k"]
TRAIN = ["olmo-1b.train-2k"]
SEED = 2 ** 31 + 77


@pytest.mark.parametrize("workload", PREFILL + TRAIN)
def test_sound_run_matches_reference(workload):
    r = smoke_run(workload, SEED)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == set(core.load_cell(workload)
                                   .limits["checks"])
    for k, c in r["checks"].items():
        assert c["value"] <= SMOKE_TOL[k], (k, c)


@pytest.mark.parametrize("workload", PREFILL + TRAIN)
def test_control_reads_far_above_the_program(workload):
    """The control (the reference in fp8 in the program's place) reads at
    least three times the sound run on some number, at the same seed; on
    the card at the cell's size it is not correct
    (``test_perfbench_card.py``)."""
    sound = smoke_run(workload, SEED)["checks"]
    control = smoke_run(workload, SEED, precision="fp8")["checks"]
    assert any(control[k]["value"] >= 3 * max(sound[k]["value"], 1e-12)
               for k in sound), (sound, control)


@pytest.mark.parametrize("workload,fault",
                         [(w, f) for w in PREFILL + TRAIN
                          for f in faults.FAULTS[core.load_cell(w)
                                                 .traffic["kind"]]])
def test_broken_timed_path_is_not_correct(workload, fault):
    cell = core.load_cell(workload)
    with faults.planted(cell.kind, fault):
        r = smoke_run(workload, SEED)
    assert not r["correct"], (fault, r["checks"])


def test_no_compared_request_is_not_correct():
    cell = core.load_cell("olmo-1b.prefill-2k")
    with mock.patch.object(cell.kind.Bench, "unit",
                           lambda self, i: {"t0": 0.0, "t_call": 0.0,
                                            "t1": 0.0, "tokens": 1,
                                            "ok": True}):
        r = smoke_run("olmo-1b.prefill-2k", SEED)
    assert not r["correct"]


def test_failed_unit_is_not_correct():
    cell = core.load_cell("mamba2-2.7b.prefill-2k")
    real = cell.kind.Bench.unit

    def nan_reply(self, i):
        rec = real(self, i)
        rec["ok"] = False
        return rec

    with mock.patch.object(cell.kind.Bench, "unit", nan_reply):
        r = smoke_run("mamba2-2.7b.prefill-2k", SEED)
    assert r["failed"] == r["attempted"] and not r["correct"]
