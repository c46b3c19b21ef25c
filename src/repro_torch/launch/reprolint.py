"""reprolint CLI for the port — gate its determinism and torch contracts.

    python -m repro_torch.launch.reprolint
    python -m repro_torch.launch.reprolint --json report.json src/repro_torch
    python -m repro_torch.launch.reprolint --list-rules

With no paths it lints ``src/repro_torch``, every ``tests/test_torch_*.py``,
``chip_smoke.py`` and ``tp_noise_probe.py`` under ``--root`` (default: the
checkout this module lives in).  Exit code 1 when any non-suppressed,
non-report-only finding survives; 0 on a clean tree.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import RULES, LintConfig, default_paths, lint_paths
from repro_torch.analysis.report import render_human, render_json

_ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (relative to --root; "
                         "default: the port's package, tests and scripts)")
    ap.add_argument("--root", default=str(_ROOT),
                    help="repo root (pyproject.toml location)")
    ap.add_argument("--json", metavar="FILE",
                    help="also write the machine-readable report here "
                         "('-' for stdout)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="list suppressed findings with their justifications")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule, its summary and the invariant "
                         "it guards, then exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, rule in sorted(RULES.items()):
            gate = "report-only" if rule.severity == "info" else "gating"
            print(f"{rid} [{gate}] {rule.summary}")
            print(f"     guards: {rule.invariant}")
        return 0

    root = Path(args.root)
    report = lint_paths(args.paths or default_paths(root), root,
                        LintConfig.from_pyproject(root))
    # With --json - the JSON owns stdout; keep it parseable by moving the
    # human rendering to stderr.
    human_out = sys.stderr if args.json == "-" else sys.stdout
    render_human(report, human_out, show_suppressed=args.show_suppressed)
    if args.json == "-":
        render_json(report, sys.stdout)
    elif args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            render_json(report, fh)
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
