"""Accounting rules (B-family, heuristic / report-only).

Server I/O is billed per *attempt*, not per success, and
every layer (engine store cells, workflow hand-off fetches, the
executor's endogenous restores) preserves that law.  The one mechanical
way to break it is to compute a restore duration and drop it on the
floor — the transfer happened in the model, but no counter moved.  B001
flags restore-path calls whose result is discarded.  It is heuristic
(the binding between a duration and its counter is a dataflow property),
so it reports without gating: ``report-only`` in ``[tool.reprolint]``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis import astutil
from repro_torch.analysis.core import Finding, LintConfig, register_rule

# Methods/functions whose return value IS the billed quantity: a restore
# or fetch duration (seconds) or an expectation of one.
_BILLED = {
    "restore_seconds", "restore_seconds_from", "restore_seconds_at",
    "peer_seconds", "server_seconds", "expected_restore_seconds",
    "striped_restore_seconds",
}


@register_rule(
    "B001",
    summary="restore-path result discarded (transfer modeled, never billed)",
    invariant="server/peer I/O is billed per attempt: every "
              "restore-duration computed by TransferModel / the store "
              "must fold into a waste/time/bytes counter; a discarded "
              "result is a transfer the accounting never saw",
    severity="info",
)
def b001_unbilled_restore(tree, source, relpath, config) -> List[Finding]:
    out = []
    for node in astutil.walk(tree):
        if not isinstance(node, ast.Expr) or not isinstance(node.value,
                                                            ast.Call):
            continue
        name = astutil.call_name(node.value)
        if name is None:
            continue
        if name.split(".")[-1] in _BILLED:
            out.append(Finding(
                rule="B001", path=relpath, line=node.lineno,
                col=node.col_offset, severity="info",
                message=f"result of `{name}(...)` is discarded — the "
                        "modeled transfer is never folded into a billed "
                        "counter (restore_time / handoff_waste / "
                        "server_bytes)"))
    return out
