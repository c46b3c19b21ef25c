"""Shared AST helpers for reprolint rules (a copy of ``repro.analysis.astutil``)."""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)
ScopeNode = FuncNode + (ast.Lambda,)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk(tree: ast.AST) -> List[ast.AST]:
    """``list(ast.walk(tree))``, made once per tree: every rule of one
    ``lint_source`` call walks the same module, so they share the list."""
    nodes = getattr(tree, "_reprolint_nodes", None)
    if nodes is None:
        nodes = list(ast.walk(tree))
        tree._reprolint_nodes = nodes
    return nodes


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def iter_scopes(tree: ast.AST) -> Iterator[ast.AST]:
    """Module plus every function/lambda, each visited once."""
    yield tree
    for node in walk(tree):
        if isinstance(node, ScopeNode):
            yield node


def scope_body_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """Walk a scope's nodes WITHOUT descending into nested scopes.

    Nested functions/lambdas are their own scopes (they get their own
    ``iter_scopes`` visit), so per-scope rules like key-reuse counting
    never double-attribute a nested draw to the parent.
    """
    if isinstance(scope, ast.Lambda):
        roots: List[ast.AST] = [scope.body]
    elif isinstance(scope, FuncNode) or isinstance(scope, ast.Module):
        roots = list(scope.body)
    else:
        roots = []
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, ScopeNode):
            continue  # nested scope: yielded as a node, never descended
        stack.extend(ast.iter_child_nodes(node))


def names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def positional_params(fn: ast.AST) -> List[str]:
    """Positional (incl. pos-or-kw) parameter names, minus self/cls.

    Keyword-only parameters are deliberately excluded: in this codebase
    they carry statically-bound flags (``functools.partial`` pre-binding,
    jit static args), while traced operands arrive positionally.
    """
    if not isinstance(fn, ScopeNode):
        return []
    a = fn.args
    names = [p.arg for p in list(a.posonlyargs) + list(a.args)]
    if a.vararg is not None:
        names.append(a.vararg.arg)
    return [n for n in names if n not in ("self", "cls")]


def local_function_defs(tree: ast.AST) -> dict:
    """name -> FunctionDef for every def in the module (any nesting)."""
    return {node.name: node for node in walk(tree)
            if isinstance(node, FuncNode)}


def parent_map(tree: ast.AST) -> dict:
    return {child: parent for parent in walk(tree)
            for child in ast.iter_child_nodes(parent)}
