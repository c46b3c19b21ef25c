"""The spec, the files it names, seeds and plug-in loading.

A cell (``workloads`` entry of ``BENCHMARK.json``) names a configuration
and a traffic mix.  The configuration's file holds the model's sizes; the
traffic file names its ``kind``, a driver in ``kinds/<kind>.py``; each
metric is read by ``metrics/<name>.py``; each cell's limits for
``correct`` are in ``limits/<workload>.json``.  Adding a cell, a mix or a
metric adds files; no file here changes.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC_PATH = ROOT / "BENCHMARK.json"

# top-level module names that may not be loaded in a run (compared whole:
# ``repro_torch`` is the port, ``repro`` the JAX package)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def sub_seed(seed: int, *tags: Any) -> int:
    """A 64-bit seed for one use of ``seed`` (weights, request i, ...):
    any whole number, negative or above 2**63, gives a valid one."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little")


def load_module(path: Path) -> ModuleType:
    """Import a plug-in file by its path (its name may hold dots)."""
    rel = path.relative_to(BENCH_DIR) if path.is_relative_to(BENCH_DIR) \
        else path
    name = "perfbench_plugin_" + "".join(
        c if c.isalnum() else "_" for c in str(rel))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the spec, with the files it names read in."""

    name: str
    chips: int
    config: Dict[str, Any]        # the configuration's file
    traffic: Dict[str, Any]       # the traffic mix's file
    limits: Dict[str, Any]        # limits/<workload>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def kind(self) -> ModuleType:
        return load_module(BENCH_DIR / "kinds" / f"{self.traffic['kind']}.py")


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, spec_path: Path = SPEC_PATH) -> Cell:
    spec = read_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    c = configs[w["config"]]
    config = read_json(ROOT / c["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{workload}.json"
    limits = read_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, workload)
             and m["moves"] in moved]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layer)


def _merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def scaled(section: Dict[str, Any], scale: str) -> Dict[str, Any]:
    """A configuration or traffic file, with its ``smoke`` overrides
    merged in for the CPU tests (``scale == "smoke"``)."""
    out = {k: v for k, v in section.items() if k != "smoke"}
    return _merge(out, section.get("smoke", {})) if scale == "smoke" \
        else out


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules present in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` from a (scaled) configuration's
    ``model`` section, the nested groups as its dataclasses."""
    from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                          RopeConfig, SSMConfig)

    m = dict(config["model"])
    att = dict(m.get("attention", {}))
    rope = att.get("rope")
    att["rope"] = RopeConfig(**rope) if rope is not None else None
    m["attention"] = AttentionConfig(**att)
    if m.get("ssm") is not None:
        m["ssm"] = SSMConfig(**m["ssm"])
    return ModelConfig(**m)
