"""API-hygiene rules (A-family).

The policy surface is unified: canonical ``min_interval`` /
``max_interval`` spellings everywhere (the old engine-cell ``min_iv`` /
``max_iv`` survive only as DeprecationWarning InitVar shims), and
``tick(now, exposure_peers=None)`` as the one policy cadence hook (it
folds right-censored exposure; ``exposure_peers`` carries fractional
host-equivalents).  A policy subclass that drops
``exposure_peers`` silently loses hazard-weighted estimator exposure —
the estimator then converges to the wrong mu with no test failing.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis import astutil
from repro_torch.analysis.core import Finding, LintConfig, path_matches, register_rule

_DEPRECATED = {"min_iv", "max_iv"}


def _shim_lines(tree: ast.AST) -> set:
    """Lines forming the deprecation-shim definitions themselves.

    The shim pattern: an ``InitVar``-annotated dataclass field
    named ``min_iv``/``max_iv`` plus the ``__post_init__`` that folds it
    into the canonical field.  Those are the *definitions* of the
    deprecated aliases and the one place the spellings may appear.
    """
    lines = set()
    for node in astutil.walk(tree):
        if isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.target.id in _DEPRECATED \
                and "InitVar" in ast.dump(node.annotation):
            lines.update(range(node.lineno, (node.end_lineno or node.lineno) + 1))
        elif isinstance(node, astutil.FuncNode) \
                and node.name == "__post_init__":
            params = {a.arg for a in node.args.args + node.args.kwonlyargs}
            if params & _DEPRECATED:
                lines.update(range(node.lineno,
                                   (node.end_lineno or node.lineno) + 1))
    return lines


@register_rule(
    "A001",
    summary="deprecated min_iv/max_iv spelling outside the shims",
    invariant="canonical interval-bound spellings are min_interval/"
              "max_interval; the deprecated aliases exist only as "
              "InitVar shims (and the tests that pin their "
              "DeprecationWarning, which carry inline justifications)",
)
def a001_no_deprecated_spellings(tree, source, relpath,
                                 config) -> List[Finding]:
    if path_matches(relpath, config.a001_allow):
        return []
    shim = _shim_lines(tree)
    out = []

    def flag(node: ast.AST, spelled: str, how: str) -> None:
        if node.lineno in shim:
            return
        out.append(Finding(
            rule="A001", path=relpath, line=node.lineno,
            col=node.col_offset,
            message=f"deprecated spelling `{spelled}` ({how}); use "
                    f"`{'min_interval' if spelled == 'min_iv' else 'max_interval'}`"))

    for node in astutil.walk(tree):
        if isinstance(node, ast.Name) and node.id in _DEPRECATED:
            flag(node, node.id, "identifier")
        elif isinstance(node, ast.Attribute) and node.attr in _DEPRECATED:
            flag(node, node.attr, "attribute")
        elif isinstance(node, ast.arg) and node.arg in _DEPRECATED:
            flag(node, node.arg, "parameter")
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in _DEPRECATED:
                    flag(kw.value, kw.arg, "keyword argument")
    return out


@register_rule(
    "A002",
    summary="tick() override that drops the exposure_peers parameter",
    invariant="tick(now, exposure_peers=None) is the policy cadence hook: "
              "exposure_peers carries fractional hazard-"
              "weighted host-equivalents into the estimator's censored-"
              "exposure law; an override without it silently starves the "
              "estimator of exposure and mis-estimates mu",
)
def a002_tick_signature(tree, source, relpath, config) -> List[Finding]:
    out = []
    for node in astutil.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for item in node.body:
            if not isinstance(item, astutil.FuncNode) or item.name != "tick":
                continue
            a = item.args
            names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
            if "exposure_peers" in names or a.kwarg is not None:
                continue
            out.append(Finding(
                rule="A002", path=relpath, line=item.lineno,
                col=item.col_offset,
                message=f"`{node.name}.tick(...)` drops `exposure_peers`; "
                        "the canonical hook is `tick(self, now, "
                        "exposure_peers=None)` — without it the "
                        "controller's censored-exposure folding is "
                        "silently skipped for this policy"))
    return out
