"""The port's linter (``repro_torch.analysis``) held against the reference
linter (``repro.analysis``) on the CPU.

* Parity on the shared rules (R001-R003, A001, A002, B001, S000): every
  reference fixture, and the port's package, give the same findings under
  both linters.
* The torch rules (T001-T005) and the torch forms of R001/R002: a bad
  fixture under ``tests/lint_fixtures/torch/`` yields its finding, a good
  one (carrying the traps of today's tree) yields none, and a seeded
  violation in a mirror of ``src/repro_torch`` trips ``lint_paths``.
* The CLI (``python -m repro_torch.launch.reprolint``) and the self-check:
  the port's default paths are violation-free and every suppression there
  carries a justification.
"""
import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro import analysis as R
from repro.analysis.core import _fallback_toml_table as ref_toml_table
from repro_torch import analysis as T
from repro_torch.analysis.core import (LintReport, _fallback_toml_table,
                                       parse_suppressions, path_matches)

ROOT = Path(__file__).resolve().parent.parent
REF_FIXTURES = Path(__file__).parent / "lint_fixtures"
FIXTURES = REF_FIXTURES / "torch"
SHARED = ("R001", "R002", "R003", "A001", "A002", "B001", "S000")
T_RULES = ("T001", "T002", "T003", "T004", "T005")
# rule id -> path a torch fixture pretends to live at (T001/T002: the file
# whose configured step body is ``_masked_steps``; T003 a kernel wrapper;
# T004 a bitwise path; the rest anywhere in the package).
PRETEND = {
    "T001": "src/repro_torch/kernels/sim_step.py",
    "T002": "src/repro_torch/kernels/sim_step.py",
    "T003": "src/repro_torch/kernels/fixture.py",
    "T004": "src/repro_torch/core/fixture.py",
    "T005": "src/repro_torch/fixture.py",
    "R003": "src/repro_torch/sim/fixture.py",
}
TORCH_FIXTURE_RULES = T_RULES + ("R001", "R002")


def _key(f):
    return (f.rule, f.line, f.col, f.severity, f.suppressed)


def _ref_rel(name: str) -> str:
    rule = name.split("_")[0].upper()
    return {"R003": "src/repro/sim/fixture.py",
            "J003": "src/repro/kernels/fixture.py"}.get(rule,
                                                        f"src/repro/{name}")


def _port_rel(name: str) -> str:
    return PRETEND.get(name.split("_")[0].upper(), f"src/repro_torch/{name}")


def _lint_torch_fixture(rule_id: str, kind: str):
    """Lint ``torch/<rule>_<kind>.py`` at its pretend path; for T001/T002
    every top-level function of the fixture is a step body."""
    src = (FIXTURES / f"{rule_id.lower()}_{kind}.py").read_text()
    rel = _port_rel(f"{rule_id.lower()}_{kind}.py")
    cfg = T.LintConfig()
    if rule_id in ("T001", "T002"):
        cfg = dataclasses.replace(cfg, step_bodies=tuple(
            f"{rel}::{n.name}" for n in ast.parse(src).body
            if isinstance(n, ast.FunctionDef)))
    return T.lint_source(src, rel, cfg)


@pytest.fixture(scope="module")
def default_report():
    """The port's linter over its default paths, once for the module."""
    return T.lint_paths(T.default_paths(ROOT), ROOT)


@pytest.fixture(scope="module")
def ref_port_report():
    """The reference linter over ``src/repro_torch``."""
    return R.lint_paths(["src/repro_torch"], ROOT)


# --------------------------------------------------------------------------- #
# Parity on the shared rules                                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(p.name for p in
                                        REF_FIXTURES.glob("*.py")))
def test_shared_rules_match_the_reference_on_its_fixtures(name):
    src = (REF_FIXTURES / name).read_text(encoding="utf-8")
    ref = [_key(f) for f in R.lint_source(src, _ref_rel(name), R.LintConfig())
           if f.rule in SHARED]
    got = [_key(f) for f in T.lint_source(src, _port_rel(name), T.LintConfig())
           if f.rule in SHARED]
    assert got == ref
    rule = name.split("_")[0].upper()
    if rule in SHARED and name.endswith("_bad.py"):
        assert any(k[0] == rule and not k[4] for k in got), name


def test_shared_rules_match_the_reference_on_the_port(default_report,
                                                      ref_port_report):
    """R003 aside (the reference scopes it to ``src/repro``), both linters
    find the same things in ``src/repro_torch``."""
    shared = set(SHARED) - {"R003"}

    def keys(findings):
        return sorted((f.path,) + _key(f) for f in findings
                      if f.rule in shared
                      and f.path.startswith("src/repro_torch/"))

    assert keys(default_report.findings) == keys(ref_port_report.findings)
    n_port = len(list((ROOT / "src/repro_torch").rglob("*.py")))
    assert ref_port_report.files_scanned == n_port


def test_suppressions_parse_as_the_reference_parses_them():
    for rel in T.default_paths(ROOT):
        for f in T.core.iter_py_files([rel], ROOT, T.LintConfig()):
            src = f.read_text(encoding="utf-8")
            assert [dataclasses.astuple(s) for s in parse_suppressions(src)] \
                == [dataclasses.astuple(s)
                    for s in R.core.parse_suppressions(src)], f


def test_r003_without_its_allow_list_flags_exactly_the_timing_sites():
    others = tuple(r for r in T.RULES if r != "R003")
    report = T.lint_paths(["src/repro_torch"], ROOT,
                          T.LintConfig(r003_allow=(), disable=others))
    flagged = {f.path for f in report.findings if f.rule == "R003"}
    assert flagged == set(T.LintConfig().r003_allow)


def test_pyproject_supplies_only_the_shared_keys():
    cfg = T.LintConfig.from_pyproject(ROOT)
    assert "tests/lint_fixtures" in cfg.exclude
    assert cfg.report_only == ("B001",)
    assert cfg.r003_paths == T.LintConfig().r003_paths
    assert all(p.startswith("src/repro_torch/")
               for p in cfg.r003_paths + cfg.r003_allow + cfg.kernel_globs)
    text = (ROOT / "pyproject.toml").read_text(encoding="utf-8")
    assert _fallback_toml_table(text) == ref_toml_table(text)


def test_rule_registry_metadata():
    assert set(SHARED) - {"S000"} | set(T_RULES) == set(T.RULES)
    for rid, rule in T.RULES.items():
        assert rule.summary and rule.invariant, rid
    assert T.RULES["B001"].severity == "info"
    assert not any(r.startswith("J") for r in T.RULES)
    assert "J001" in R.RULES and "T001" not in R.RULES


# --------------------------------------------------------------------------- #
# The torch rules against their fixtures                                      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rule_id", TORCH_FIXTURE_RULES)
def test_torch_bad_fixture_fails(rule_id):
    findings = [f for f in _lint_torch_fixture(rule_id, "bad")
                if f.rule == rule_id and not f.suppressed]
    src = (FIXTURES / f"{rule_id.lower()}_bad.py").read_text().splitlines()
    marked = {i for i, line in enumerate(src, 1) if f"# {rule_id}" in line}
    assert marked and marked <= {f.line for f in findings}, findings
    for f in findings:
        assert f.message and f.severity == "error"


@pytest.mark.parametrize("rule_id", TORCH_FIXTURE_RULES)
def test_torch_good_fixture_passes(rule_id):
    active = [f for f in _lint_torch_fixture(rule_id, "good")
              if not f.suppressed]
    assert active == [], active


def test_the_reference_misses_what_the_torch_forms_catch():
    """R001/R002 as the reference has them see neither the global torch
    RNG nor a shared torch.Generator."""
    for rule_id in ("R001", "R002"):
        src = (FIXTURES / f"{rule_id.lower()}_bad.py").read_text()
        assert not [f for f in R.lint_source(src, f"src/repro/{rule_id}.py")
                    if f.rule == rule_id]


def test_step_body_named_but_missing_is_reported():
    findings = T.lint_source("def other(x):\n    return x\n",
                             "src/repro_torch/train/step.py")
    assert [f.rule for f in findings] == ["T001"]
    assert "compute_grads" in findings[0].message


def test_default_step_bodies_exist_in_the_tree():
    for entry in T.LintConfig().step_bodies:
        path, _, fn = entry.partition("::")
        tree = ast.parse((ROOT / path).read_text(encoding="utf-8"))
        assert any(isinstance(n, ast.FunctionDef) and n.name == fn
                   for n in ast.walk(tree)), entry


def test_taint_model_reads_metadata_as_no_value():
    fn = ast.parse(
        "def f(s, p, flag: bool, cfg: 'ModelConfig', k: Optional[int]):\n"
        "    n = s.shape[0]\n"
        "    m = len(p)\n"
        "    v = s.sum()\n"
        "    w = v if flag else p\n").body[0]
    taint = T.rules_torch.tainted_names(fn, T.LintConfig())
    assert taint == {"s", "p", "v", "w"}


def test_path_matching_covers_dirs_and_globs():
    assert path_matches("src/repro_torch/core/lambertw.py",
                        T.LintConfig().div_paths)
    assert path_matches("src/repro_torch/kernels/sim_step.py",
                        T.LintConfig().kernel_globs)
    assert not path_matches("src/repro_torch/sim/experiments.py",
                            T.LintConfig().div_paths)


# --------------------------------------------------------------------------- #
# Seeded violations in a mirror of the package trip lint_paths              #
# --------------------------------------------------------------------------- #

# (rule, fixture, where it goes in the mirror)
SEEDED = [(r, FIXTURES / f"{r.lower()}_bad.py",
           PRETEND.get(r, f"src/repro_torch/{r.lower()}_torch_bad.py"))
          for r in TORCH_FIXTURE_RULES] + [
    (r, REF_FIXTURES / f"{r.lower()}_bad.py",
     PRETEND.get(r, f"src/repro_torch/{r.lower()}_bad.py"))
    for r in SHARED if r != "S000"]


@pytest.mark.parametrize("rule_id,fixture,rel", SEEDED,
                         ids=[f"{r}-{f.parent.name}" for r, f, _ in SEEDED])
def test_seeded_violation_in_a_port_mirror_is_caught(rule_id, fixture, rel,
                                                     tmp_path):
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True)
    shutil.copy(fixture, dst)
    shutil.copy(ROOT / "pyproject.toml", tmp_path / "pyproject.toml")
    report = T.lint_paths(T.default_paths(tmp_path), tmp_path)
    assert report.files_scanned == 1
    assert any(f.rule == rule_id and not f.suppressed
               for f in report.findings)
    assert report.exit_code == (0 if rule_id == "B001" else 1)


def test_report_only_rules_never_gate():
    findings = T.lint_source("def f(tm):\n    tm.restore_seconds(2)\n",
                             "src/repro_torch/x.py")
    assert [f.rule for f in findings] == ["B001"]
    rep = LintReport(findings=findings, files_scanned=1, config=T.LintConfig())
    assert rep.exit_code == 0


# --------------------------------------------------------------------------- #
# Self-check and CLI                                                          #
# --------------------------------------------------------------------------- #

def test_port_is_violation_free(default_report):
    assert default_report.files_scanned >= 95
    gating = default_report.gating
    assert gating == [], "\n".join(str(f) for f in gating)
    for f in default_report.findings:
        if f.suppressed:
            assert f.justification, f
        assert f.rule != "T005", f


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.reprolint", *args],
        capture_output=True, text=True, cwd=ROOT, env=env)


def test_cli_clean_tree_exits_zero_and_writes_json(tmp_path):
    out = tmp_path / "report.json"
    proc = _run_cli("--json", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["exit_code"] == 0 and doc["n_gating"] == 0
    assert doc["files_scanned"] >= 95
    assert set(T_RULES) <= set(doc["rules"])
    assert "invariant" in doc["rules"]["T003"]


def test_cli_gates_on_violations(tmp_path):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "evil.py").write_text(
        "def f():\n    import jax\n    return jax\n")
    proc = _run_cli("--root", str(tmp_path))
    assert proc.returncode == 1
    assert "T005" in proc.stdout


def test_cli_list_rules():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for rid in ("R001", "R002", "R003", "A001", "B001") + T_RULES:
        assert rid in proc.stdout
