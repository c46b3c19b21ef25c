"""The last line has the contract's shape, and ``run.py`` refuses to run
without the cards its cell asks for."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from harness import core, runner  # noqa: E402
from harness.smoke import smoke_run  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _emitted(result, capsys):
    runner.emit(result)
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", ["olmo-1b.train-2k",
                                      "mamba2-2.7b.prefill-2k"])
def test_last_line_shape(workload, traced, capsys):
    line, err = _emitted(smoke_run(workload, 99, traced=traced), capsys)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(line)
    assert isinstance(line["correct"], bool)
    assert isinstance(line["attempted"], int) and line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    cell = core.load_cell(workload)
    want = cell.per_layer if traced else cell.end_to_end
    for name, m in line["metrics"].items():
        spec = next(x for x in want if x["name"] == name)
        assert m["unit"] == spec["unit"] and isinstance(m["value"], float)
    if traced:
        # the CPU has no device trace: the device readers find nothing
        assert "window_s" in line["device"] and "busy_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        for k in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][k]) <= 10
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
    # each compared number beside its limit, last on standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for (k, c), row in zip(line["checks"].items(), tail):
        assert set(c) == {"value", "limit"}
        assert row.startswith(f"check {k} = ")


def test_non_finite_numbers_are_null(capsys):
    line, _ = _emitted({"correct": False, "attempted": 1, "failed": 1,
                        "metrics": {}, "device": {},
                        "checks": {"x": {"value": float("inf"),
                                         "limit": 1.0}}}, capsys)
    assert line["checks"]["x"]["value"] is None


def _run_py(args, cwd, env=None):
    return subprocess.run([sys.executable, str(cwd / "perfbench" / "run.py"),
                           *args], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_no_card_no_result():
    """Without CUDA (or with too few cards) run.py exits non-zero and
    prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run_py(["--workload", SPEC["workloads"][0]["name"], "--seed", "1",
                 "--seconds", "1", "--trace", "0"], ROOT, env)
    assert r.returncode != 0
    assert not r.stdout.strip()


def test_benchmark_files_alone_do_not_run(tmp_path):
    """In a directory holding only BENCHMARK.json and the files under
    paths (no program), run.py exits non-zero with no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in SPEC["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run_py(["--workload", SPEC["workloads"][0]["name"], "--seed", "1",
                 "--seconds", "1", "--trace", "0"], tmp_path, env)
    assert r.returncode != 0
    assert not r.stdout.strip()
    assert "repro_torch" in r.stderr
