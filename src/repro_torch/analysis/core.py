"""reprolint core for the port: findings, suppressions, config, and the
lint runner.

The port (``src/repro_torch``) rests on contracts of its own beside the
reference's: dedicated RNG streams are drawn from explicitly seeded
generators (a ``torch.Generator`` here, never the global torch RNG), the
bitwise paths divide by a device tensor (``device.div``) rather than a
Python float, every ctypes kernel launch goes through
``kernels/build.py::launch`` so it lands on the operands' device, the
step bodies read no tensor's value on the host, and nothing of the port
imports ``jax`` or the JAX package.  This package turns those contracts
into AST rules over the port's files, with the reference's API
(``repro.analysis``), its suppression syntax and its shared rules
(R001-R003, A001, A002, B001, S000).  Its CLI is
``python -m repro_torch.launch.reprolint``; the tier-1 self-check is
``tests/test_torch_reprolint.py``.

Suppressions
------------
A finding is silenced *only* by an inline comment carrying a
justification::

    foo = np.random.rand()  # reprolint: ignore[R001] -- demo of the legacy API

The comment may sit on the finding's line or alone on the line directly
above.  An ``ignore`` without the ``-- <why>`` tail does **not** suppress
anything and is itself reported (rule S000): an unexplained exemption is
exactly the silent convention-drift this tool exists to prevent.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "Rule", "LintConfig", "LintReport", "RULES", "register_rule",
    "lint_source", "lint_paths", "parse_suppressions", "Suppression",
    "DEFAULT_PATHS", "default_paths",
]

# What the CLI and the chip check lint when given no paths: the package,
# its tests and its two scripts at the repo root.
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py",
                 "tp_noise_probe.py")


# --------------------------------------------------------------------------- #
# Findings and rules                                                          #
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str          # POSIX-relative to the lint root
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str
    severity: str = "error"        # "error" gates; "info" is report-only
    suppressed: bool = False
    justification: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered contract check.

    ``check(tree, source, relpath, config)`` returns raw findings; the
    runner applies suppressions, config disables, and report-only
    downgrades afterwards, so rules stay pure AST logic.
    """

    id: str
    summary: str
    invariant: str      # the repo invariant this rule guards (docs/DESIGN)
    check: Callable[[ast.AST, str, str, "LintConfig"], List[Finding]]
    severity: str = "error"


RULES: Dict[str, Rule] = {}


def register_rule(id: str, summary: str, invariant: str,
                  severity: str = "error"):
    """Decorator registering a rule's check function under ``id``."""
    def deco(fn):
        RULES[id] = Rule(id=id, summary=summary, invariant=invariant,
                         check=fn, severity=severity)
        return fn
    return deco


# --------------------------------------------------------------------------- #
# Configuration ([tool.reprolint] in pyproject.toml)                          #
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class LintConfig:
    """The port's knobs.  ``exclude``, ``disable`` and ``report_only`` are
    read from ``[tool.reprolint]`` in pyproject.toml, the table the
    reference linter reads too; the rest are the port's own defaults.

    Path entries are POSIX-relative to the lint root; a directory entry
    covers everything beneath it.
    """

    exclude: Tuple[str, ...] = ("tests/lint_fixtures",)
    disable: Tuple[str, ...] = ()
    report_only: Tuple[str, ...] = ("B001",)
    # R003: virtual-time subsystems where wall-clock / stdlib-random calls
    # are forbidden, and the measurement sites within them: the trainer's
    # step and restore seconds, the executor's resume latency and real
    # seconds, the superstep loop's real seconds -- each reported beside,
    # never folded into, the virtual-time accounting.
    r003_paths: Tuple[str, ...] = (
        "src/repro_torch/sim", "src/repro_torch/exec", "src/repro_torch/p2p",
        "src/repro_torch/serve", "src/repro_torch/runtime")
    r003_allow: Tuple[str, ...] = (
        "src/repro_torch/runtime/trainer.py",
        "src/repro_torch/exec/executor.py",
        "src/repro_torch/exec/superstep.py")
    # A001: extra files allowed to use the deprecated spellings (the shim
    # *definitions* are recognized structurally and need no entry here).
    a001_allow: Tuple[str, ...] = ()
    # T003: the kernel wrappers.
    kernel_globs: Tuple[str, ...] = ("src/repro_torch/kernels/*.py",)
    # T001/T002: the step bodies, as "path::function" -- the counterparts
    # of the reference's traced bodies: the engine step (its lax.scan
    # body), the sim-step kernel's plain chunk (its lax.while_loop), the
    # layer bodies (its layer scans) and the microbatch body.
    step_bodies: Tuple[str, ...] = tuple(
        f"src/repro_torch/sim/engine.py::{fn}" for fn in (
            "_attempt", "_replica_draw", "_apply", "_pool_update",
            "_gossip_mix", "_sample_counts")) + (
        "src/repro_torch/kernels/sim_step.py::_masked_steps",
        "src/repro_torch/models/model.py::_apply_dense_block",
        "src/repro_torch/models/model.py::_apply_ssm_block",
        "src/repro_torch/models/model.py::_mamba_layer",
        "src/repro_torch/models/model.py::_decoder_layer",
        "src/repro_torch/train/step.py::compute_grads")
    # T001/T002: annotations of positional parameters that hold no tensor
    # (besides bool/int/float/str), so branching on them is legal.
    config_types: Tuple[str, ...] = ("ModelConfig", "CellSpec", "PolicyConfig")
    # T004: the bitwise paths, which divide through ``device.div``.
    div_paths: Tuple[str, ...] = (
        "src/repro_torch/sim/engine.py", "src/repro_torch/kernels/sim_step.py",
        "src/repro_torch/core")
    # T005: the files that make up the port and must import neither jax
    # nor the JAX package (its tests import both on purpose).
    port_paths: Tuple[str, ...] = ("src/repro_torch", "chip_smoke.py",
                                   "tp_noise_probe.py")

    @staticmethod
    def from_pyproject(root: Path) -> "LintConfig":
        """The defaults, with ``exclude``, ``disable`` and ``report-only``
        taken from ``[tool.reprolint]`` where the table sets them (its
        other keys scope the reference linter to ``src/repro``)."""
        data = _read_pyproject_table(root / "pyproject.toml")
        if not data:
            return LintConfig()
        def tup(key, default):
            v = data.get(key)
            if v is None:
                return default
            if isinstance(v, str):
                v = [v]
            return tuple(str(x) for x in v)
        return LintConfig(
            exclude=tup("exclude", LintConfig.exclude),
            disable=tup("disable", ()),
            report_only=tup("report-only", LintConfig.report_only),
        )


def _read_pyproject_table(path: Path) -> dict:
    if not path.is_file():
        return {}
    text = path.read_text(encoding="utf-8")
    try:
        import tomllib  # py >= 3.11
    except ModuleNotFoundError:
        try:
            import tomli as tomllib  # pytest dependency on py < 3.11
        except ModuleNotFoundError:
            return _fallback_toml_table(text)
    try:
        return tomllib.loads(text).get("tool", {}).get("reprolint", {})
    except Exception:
        return _fallback_toml_table(text)


def _fallback_toml_table(text: str) -> dict:
    """Minimal ``[tool.reprolint]`` reader (string / string-list values
    only) for environments with no TOML parser at all."""
    out: dict = {}
    in_table = False
    pending_key = None
    pending: List[str] = []
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("["):
            in_table = line == "[tool.reprolint]"
            continue
        if not in_table or not line or line.startswith("#"):
            continue
        if pending_key is not None:
            pending.append(line)
            if "]" in line:
                out[pending_key] = re.findall(r'"([^"]*)"', " ".join(pending))
                pending_key, pending = None, []
            continue
        m = re.match(r'^([A-Za-z0-9_-]+)\s*=\s*(.*)$', line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith("[") and "]" not in val:
            pending_key, pending = key, [val]
        elif val.startswith("["):
            out[key] = re.findall(r'"([^"]*)"', val)
        elif val.startswith('"'):
            out[key] = val.strip('"')
    return out


def path_matches(relpath: str, entries: Sequence[str]) -> bool:
    """True when ``relpath`` equals an entry, sits under a directory
    entry, or matches a glob entry."""
    for e in entries:
        e = e.rstrip("/")
        if relpath == e or relpath.startswith(e + "/"):
            return True
        if fnmatch.fnmatch(relpath, e):
            return True
    return False


# --------------------------------------------------------------------------- #
# Suppressions                                                                #
# --------------------------------------------------------------------------- #

_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*ignore\[([A-Za-z0-9,\s]+)\]\s*(?:--\s*(\S.*))?")


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int                  # line the comment physically sits on
    rules: Tuple[str, ...]
    justification: str
    standalone: bool           # comment-only line -> applies to next line


def parse_suppressions(source: str) -> List[Suppression]:
    out = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        just = (m.group(2) or "").strip()
        standalone = text.strip().startswith("#")
        out.append(Suppression(line=i, rules=rules, justification=just,
                               standalone=standalone))
    return out


def _apply_suppressions(findings: List[Finding], sups: List[Suppression],
                        relpath: str) -> List[Finding]:
    """Mark suppressed findings; emit S000 for justification-free ignores."""
    by_line: Dict[int, List[Suppression]] = {}
    for s in sups:
        by_line.setdefault(s.line, []).append(s)
        if s.standalone:
            by_line.setdefault(s.line + 1, []).append(s)

    out = []
    for f in findings:
        matched = None
        for s in by_line.get(f.line, ()):
            if f.rule in s.rules or "ALL" in s.rules:
                matched = s
                break
        if matched is not None and matched.justification:
            f = dataclasses.replace(f, suppressed=True,
                                    justification=matched.justification)
        out.append(f)
    for s in sups:
        if not s.justification:
            out.append(Finding(
                rule="S000", path=relpath, line=s.line, col=0,
                message="suppression without a justification "
                        "(write `# reprolint: ignore[RULE] -- why`); "
                        "nothing is suppressed",
                severity="error"))
    return out


# --------------------------------------------------------------------------- #
# Runner                                                                      #
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class LintReport:
    findings: List[Finding]
    files_scanned: int
    config: LintConfig

    @property
    def gating(self) -> List[Finding]:
        """Findings that fail the lint gate (exit code 1)."""
        return [f for f in self.findings
                if not f.suppressed and f.severity == "error"
                and f.rule not in self.config.report_only]

    @property
    def exit_code(self) -> int:
        return 1 if self.gating else 0

    def to_dict(self) -> dict:
        return {
            "files_scanned": self.files_scanned,
            "n_findings": len(self.findings),
            "n_gating": len(self.gating),
            "exit_code": self.exit_code,
            "findings": [f.to_dict() for f in self.findings],
        }


def lint_source(source: str, relpath: str,
                config: Optional[LintConfig] = None,
                rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint one file's text as if it lived at ``relpath`` under the root.

    The path matters: R003's subsystem scoping and the T rules' paths key
    off it — which is also what lets tests drive a fixture "as"
    ``src/repro_torch/sim/whatever.py``.
    """
    config = config or LintConfig()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="E000", path=relpath, line=e.lineno or 1,
                        col=e.offset or 0,
                        message=f"syntax error: {e.msg}")]
    selected = rules if rules is not None else [
        rid for rid in RULES if rid not in config.disable]
    findings: List[Finding] = []
    for rid in selected:
        rule = RULES[rid]
        for f in rule.check(tree, source, relpath, config):
            if f.severity == "error" and rule.severity == "info":
                f = dataclasses.replace(f, severity="info")
            findings.append(f)
    findings = _apply_suppressions(findings, parse_suppressions(source),
                                   relpath)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_py_files(paths: Sequence[str], root: Path,
                  config: LintConfig) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = (root / p) if not Path(p).is_absolute() else Path(p)
        if path.is_file() and path.suffix == ".py":
            files.append(path)
        elif path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
    seen = set()
    out = []
    for f in files:
        rel = _relpath(f, root)
        if rel in seen or path_matches(rel, config.exclude):
            continue
        seen.add(rel)
        out.append(f)
    return out


def default_paths(root: Path) -> List[str]:
    """:data:`DEFAULT_PATHS` under ``root``, globs expanded (in order)."""
    out: List[str] = []
    for p in DEFAULT_PATHS:
        if any(ch in p for ch in "*?["):
            out.extend(sorted(_relpath(f, root) for f in root.glob(p)))
        else:
            out.append(p)
    return out


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def lint_paths(paths: Sequence[str], root: Path,
               config: Optional[LintConfig] = None) -> LintReport:
    """Lint every ``.py`` under ``paths`` (files or directories)."""
    # Import for side effect: rule registration.
    from repro_torch.analysis import rules_accounting  # noqa: F401
    from repro_torch.analysis import rules_api         # noqa: F401
    from repro_torch.analysis import rules_rng         # noqa: F401
    from repro_torch.analysis import rules_torch       # noqa: F401

    config = config or LintConfig.from_pyproject(root)
    findings: List[Finding] = []
    files = iter_py_files(paths, root, config)
    for f in files:
        src = f.read_text(encoding="utf-8")
        findings.extend(lint_source(src, _relpath(f, root), config))
    return LintReport(findings=findings, files_scanned=len(files),
                      config=config)
