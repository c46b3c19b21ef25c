"""BENCHMARK.json against the benchmark's contract, and every file it
names present: a configuration, traffic mix, kind, metric reader and
limits file for each entry."""
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head_size|expand|experts_per_tok")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths():
    assert set(SPEC) == KEYS["top"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(c) for c in cmd)
    named = [c for c in cmd if "/" in c]
    assert all(any(c.startswith(p + "/") for p in SPEC["paths"])
               for c in named)
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == KEYS["config"]
    assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
    assert c["source"].startswith("https://")
    assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
    f = json.loads((ROOT / c["file"]).read_text())
    assert f["name"] == c["name"] and f["source"] == c["source"]
    assert f["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16
    for k in c["reduced"]:
        assert NAME.match(k) and not WIDTH.search(k)
    assert (HERE / "reference" / f"{f['reference']}.py").exists()
    assert sum(w["config"] == c["name"] for w in SPEC["workloads"]) >= 1
    files = [x["file"] for x in SPEC["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_entry(w):
    assert set(w) == KEYS["workload"]
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert w["config"] in {c["name"] for c in SPEC["configs"]}
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert (HERE / "kinds" / f"{traffic['kind']}.py").exists()
    assert (HERE / "limits" / f"{w['name']}.json").exists()
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = [m for m in SPEC["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = [m for m in SPEC["per_layer"]
             if w["name"] in m.get("workloads", [w["name"]])
             and m["moves"] in names]
    assert layer


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in SPEC[k]]
    assert len(names) == len(set(names))
    workloads = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    for m in SPEC[kind]:
        assert set(m) - {"workloads"} == KEYS[kind], m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= workloads
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _line(m["layer"]) and m["moves"] in e2e
            if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                assert m["unit"] == "%"
    assert "setup_s" in e2e


def test_layers_named_in_perf_md():
    """Each per-layer metric's layer is one of PERF.md's layers."""
    text = (ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert f"**{m['layer']}**" in text, m["layer"]
