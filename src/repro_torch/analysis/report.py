"""Human and JSON rendering of a lint run."""
from __future__ import annotations

import json
from typing import IO

from repro_torch.analysis.core import RULES, LintReport


def render_human(report: LintReport, out: IO[str],
                 show_suppressed: bool = False) -> None:
    shown = 0
    for f in report.findings:
        if f.suppressed and not show_suppressed:
            continue
        shown += 1
        out.write(str(f) + "\n")
        if f.suppressed and f.justification:
            out.write(f"    justified: {f.justification}\n")
    n_sup = sum(1 for f in report.findings if f.suppressed)
    n_info = sum(1 for f in report.findings
                 if not f.suppressed and (f.severity == "info"
                                          or f.rule in report.config.report_only))
    gating = report.gating
    out.write(
        f"reprolint: {report.files_scanned} files, "
        f"{len(gating)} gating finding(s), {n_info} report-only, "
        f"{n_sup} suppressed\n")
    if gating:
        by_rule: dict = {}
        for f in gating:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        for rid in sorted(by_rule):
            rule = RULES.get(rid)
            summary = rule.summary if rule else ""
            out.write(f"  {rid} x{by_rule[rid]}: {summary}\n")


def render_json(report: LintReport, out: IO[str]) -> None:
    doc = report.to_dict()
    doc["rules"] = {
        rid: {"summary": r.summary, "invariant": r.invariant,
              "severity": r.severity}
        for rid, r in sorted(RULES.items())
    }
    json.dump(doc, out, indent=2, sort_keys=False)
    out.write("\n")
