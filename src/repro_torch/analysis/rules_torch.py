"""Torch rules (T-family): the port's counterparts of the JAX-purity rules.

The reference keeps its step bodies pure by construction: a ``lax.scan``
or ``lax.while_loop`` body is traced once, so Python control flow on a
traced value fails or freezes a branch, and the J rules find those
bodies through the constructs that trace them.  The port runs eagerly:
the same Python ``if`` on a tensor's value quietly works, at the price
of a host sync each step on CUDA and of a branch that the CUDA kernel it
mirrors does not take.  The port has no construct to find its step
bodies by, so the config names them (``LintConfig.step_bodies``, as
``"path::function"``), and T001/T002 check those bodies.

Taint model: the positional parameters of a step body hold tensors,
except those annotated with a Python scalar type (``bool``, ``int``,
``float``, ``str``) or a config type (``LintConfig.config_types``): the
port passes its static flags and configs positionally too, which is why
the reference's "every positional parameter" model does not fit it.
Names assigned from a tainted value are tainted; a read through a
tensor's metadata (``.shape``, ``.ndim``, ``.dtype``, ``.device``,
``.is_cuda``, ``.dim()``, ``.numel()``, ``.size()``, ``len()``,
``isinstance``, ``is None``) reads no value and neither taints nor
flags.

T003-T005 are file rules: the kernel-launch contract of the wrappers,
true division on the bitwise paths, and the port's independence from
``jax`` and the JAX package.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import List, Set

from repro_torch.analysis import astutil
from repro_torch.analysis.core import Finding, LintConfig, path_matches, register_rule

_SCALAR_TYPES = {"bool", "int", "float", "str"}
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_META_METHODS = {"dim", "numel", "size"}
_META_FUNCS = {"len", "isinstance"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_CONCRETIZERS = {"bool", "int", "float"}
_FORBIDDEN_TOPS = {"jax", "jaxlib", "repro"}
# Library functions a wrapper may call directly: they run on the host only
# (no launch, no device), e.g. ``ssd_scan_smem_bytes``.
_HOST_ENTRY_POINTS = ("*_error_string", "*_smem_bytes")


# --------------------------------------------------------------------------- #
# Step bodies and their taint                                                 #
# --------------------------------------------------------------------------- #

def _configured_bodies(tree: ast.AST, relpath: str, config: LintConfig):
    """(function nodes, names the config gives for this file but the file
    does not define)."""
    wanted = []
    for entry in config.step_bodies:
        path, _, fn = entry.partition("::")
        if fn and path_matches(relpath, (path,)):
            wanted.append(fn)
    if not wanted:
        return [], []
    defs = [n for n in astutil.walk(tree) if isinstance(n, astutil.FuncNode)]
    found = [n for n in defs if n.name in wanted]
    missing = [w for w in wanted if not any(n.name == w for n in found)]
    return found, missing


def _static_annotation(ann, config: LintConfig) -> bool:
    """The annotation names a type that holds no tensor."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Constant) and ann.value is None:
        return True
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (_static_annotation(ann.left, config)
                and _static_annotation(ann.right, config))
    if isinstance(ann, ast.Subscript):
        head = (astutil.dotted(ann.value) or "").split(".")[-1]
        args = ann.slice.elts if isinstance(ann.slice, ast.Tuple) \
            else [ann.slice]
        return head in ("Optional", "Union") and all(
            _static_annotation(a, config) for a in args)
    name = astutil.dotted(ann)
    return name is not None and name.split(".")[-1] in (
        _SCALAR_TYPES | set(config.config_types))


def _tensor_params(fn: ast.AST, config: LintConfig) -> Set[str]:
    a = fn.args
    ann = {p.arg: p.annotation for p in list(a.posonlyargs) + list(a.args)}
    return {n for n in astutil.positional_params(fn)
            if not _static_annotation(ann.get(n), config)}


def value_reads(node: ast.AST, taint: Set[str]) -> Set[str]:
    """Tainted names that ``node`` reads for their value (a read through
    a tensor's metadata does not count)."""
    out: Set[str] = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Name):
            if n.id in taint:
                out.add(n.id)
            continue
        if isinstance(n, astutil.ScopeNode):
            continue
        if isinstance(n, ast.Attribute) and n.attr in _META_ATTRS:
            continue
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name) and f.id in _META_FUNCS:
                continue
            if isinstance(f, ast.Attribute) and f.attr in _META_METHODS:
                stack.extend(n.args)
                stack.extend(k.value for k in n.keywords)
                continue
        if isinstance(n, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return out


def _bound_names(target: ast.AST) -> List[str]:
    """Names an assignment target binds (a subscripted name counts: its
    container now holds the value)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _bound_names(e)]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    if isinstance(target, ast.Subscript):
        return _bound_names(target.value)
    return []


def _bindings(node: ast.AST):
    """(targets, value) pairs that ``node`` binds."""
    if isinstance(node, ast.Assign):
        return [(t, node.value) for t in node.targets]
    if isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
        return [(node.target, node.value)] if node.value is not None else []
    if isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
        return [(node.target, node.iter)]
    if isinstance(node, ast.withitem) and node.optional_vars is not None:
        return [(node.optional_vars, node.context_expr)]
    return []


def tainted_names(fn: ast.AST, config: LintConfig) -> Set[str]:
    """The step body's tensor parameters and every name assigned from a
    value read of one, to a fixed point (flow-insensitive)."""
    taint = _tensor_params(fn, config)
    pairs = [b for node in astutil.scope_body_nodes(fn)
             for b in _bindings(node)]
    changed = True
    while changed:
        changed = False
        for target, value in pairs:
            if not value_reads(value, taint):
                continue
            for name in _bound_names(target):
                if name not in taint:
                    taint.add(name)
                    changed = True
    return taint


def _missing_body_findings(missing, relpath) -> List[Finding]:
    return [Finding(
        rule="T001", path=relpath, line=1, col=0,
        message=f"step body `{name}` is named in step_bodies but not "
                "defined in this file; a renamed body would go unchecked "
                "-- update LintConfig.step_bodies")
        for name in missing]


@register_rule(
    "T001",
    summary="Python control flow on a tensor's value in a step body",
    invariant="step bodies are branchless in Python, as the reference's "
              "scan/while_loop bodies must be: an `if`/`while`/`assert` "
              "on a tensor's value syncs with the host every step on CUDA "
              "and takes a branch that the CUDA kernel it mirrors does "
              "not -- use torch.where / masking",
)
def t001_no_python_branch_on_tensor(tree, source, relpath,
                                    config) -> List[Finding]:
    bodies, missing = _configured_bodies(tree, relpath, config)
    out = _missing_body_findings(missing, relpath)
    kinds = {ast.If: "if", ast.While: "while",
             ast.IfExp: "conditional expression", ast.Assert: "assert"}
    for fn in bodies:
        taint = tainted_names(fn, config)
        for node in astutil.scope_body_nodes(fn):
            tests = []
            if type(node) in kinds:
                tests = [(node.test, kinds[type(node)], node)]
            elif isinstance(node, ast.comprehension):
                tests = [(t, "comprehension filter", t) for t in node.ifs]
            for test, kind, at in tests:
                hit = value_reads(test, taint)
                if hit:
                    out.append(Finding(
                        rule="T001", path=relpath, line=at.lineno,
                        col=at.col_offset,
                        message=f"Python `{kind}` on the value of "
                                f"{sorted(hit)} inside step body "
                                f"`{fn.name}`; mask with torch.where so the "
                                "body stays branchless and sync-free"))
    return out


@register_rule(
    "T002",
    summary="host round-trip (.item()/.cpu()/bool()/np.asarray) in a step body",
    invariant="step bodies never leave the device: .item()/.tolist()/"
              ".cpu()/.numpy(), bool()/int()/float() or np.asarray of a "
              "tensor's value copies it to the host and syncs the stream "
              "every step, where the reference's traced body cannot",
)
def t002_no_host_roundtrip(tree, source, relpath, config) -> List[Finding]:
    bodies, _ = _configured_bodies(tree, relpath, config)
    out = []
    for fn in bodies:
        taint = tainted_names(fn, config)
        for node in astutil.scope_body_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node) or ""
            parts = name.split(".")
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS \
                    and value_reads(f.value, taint):
                what = f"`.{f.attr}()`"
            elif name in _CONCRETIZERS and any(
                    value_reads(a, taint) for a in node.args):
                what = f"`{name}()`"
            elif len(parts) == 2 and parts[0] in ("np", "numpy") \
                    and parts[1] in ("asarray", "array") and any(
                        value_reads(a, taint) for a in node.args):
                what = f"`{name}`"
            else:
                continue
            out.append(Finding(
                rule="T002", path=relpath, line=node.lineno,
                col=node.col_offset,
                message=f"{what} of a tensor's value inside step body "
                        f"`{fn.name}` copies it to the host and syncs the "
                        "stream every step"))
    return out


# --------------------------------------------------------------------------- #
# File rules                                                                  #
# --------------------------------------------------------------------------- #

def _is_load(call: ast.Call, loaders: Set[str]) -> bool:
    name = astutil.call_name(call) or ""
    return name == "build.load" or name.endswith(".build.load") \
        or name in loaders


def _loader_functions(tree: ast.AST) -> Set[str]:
    """Module functions that return a built library (``_lib``), to a
    fixed point: a function that calls ``build.load`` or a loader and
    returns a value."""
    defs = [n for n in astutil.walk(tree) if isinstance(n, astutil.FuncNode)]
    loaders: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for fn in defs:
            if fn.name in loaders:
                continue
            body = list(astutil.scope_body_nodes(fn))
            calls = any(isinstance(n, ast.Call) and _is_load(n, loaders)
                        for n in body)
            returns = any(isinstance(n, ast.Return) and n.value is not None
                          for n in body)
            if calls and returns:
                loaders.add(fn.name)
                changed = True
    return loaders


@register_rule(
    "T003",
    summary="kernel library entry point called other than through build.launch",
    invariant="every ctypes launch goes through kernels/build.py::launch, "
              "which makes the operands' device current and passes its "
              "stream: the CUDA runtime launches on its current device, "
              "which need not be the one a shard lives on (cuda:1)",
)
def t003_launch_through_build(tree, source, relpath,
                              config) -> List[Finding]:
    if not path_matches(relpath, config.kernel_globs):
        return []
    loaders = _loader_functions(tree)
    out = []
    for scope in astutil.iter_scopes(tree):
        nodes = list(astutil.scope_body_nodes(scope))
        libs = set()
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call) \
                    and _is_load(node.value, loaders):
                for t in node.targets:
                    libs.update(_bound_names(t))
        for node in nodes:
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            base = node.func.value
            if not ((isinstance(base, ast.Name) and base.id in libs)
                    or (isinstance(base, ast.Call)
                        and _is_load(base, loaders))):
                continue
            entry = node.func.attr
            if any(fnmatch.fnmatch(entry, g) for g in _HOST_ENTRY_POINTS):
                continue
            out.append(Finding(
                rule="T003", path=relpath, line=node.lineno,
                col=node.col_offset,
                message=f"`{entry}(...)` of a built kernel library is "
                        "called directly; launch it as "
                        f"`build.launch(lib.{entry}, device, ...)` so the "
                        "operands' device is current and its stream is "
                        "passed"))
    return out


def _literal(node: ast.AST) -> bool:
    """A numeric literal, or an expression of numeric literals."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp):
        return _literal(node.operand)
    if isinstance(node, ast.BinOp):
        return _literal(node.left) and _literal(node.right)
    return False


@register_rule(
    "T004",
    summary="division by a numeric literal on a bitwise path",
    invariant="on CUDA, `tensor / python_float` multiplies by the "
              "reciprocal (one more rounding than numpy's and the "
              "kernel's true division); the bitwise paths divide through "
              "device.div(x, c), which divides by a device tensor",
)
def t004_true_division(tree, source, relpath, config) -> List[Finding]:
    if not path_matches(relpath, config.div_paths):
        return []
    out = []
    for node in astutil.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                and _literal(node.right) and not _literal(node.left):
            at = node
        elif isinstance(node, ast.AugAssign) \
                and isinstance(node.op, ast.Div) and _literal(node.value):
            at = node
        else:
            continue
        out.append(Finding(
            rule="T004", path=relpath, line=at.lineno, col=at.col_offset,
            message="division by a numeric literal on a bitwise path: on "
                    "CUDA a tensor divided by a Python number is "
                    "multiplied by its reciprocal; write "
                    "`device.div(x, c)`"))
    return out


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in _FORBIDDEN_TOPS


@register_rule(
    "T005",
    summary="import of jax or the JAX package in a port file",
    invariant="the port runs where there is no JAX: it imports torch and "
              "numpy, never jax or repro (not even a module there that "
              "does not import JAX); a lazy import inside a function "
              "escapes the import-time guard of the tests",
)
def t005_no_jax_imports(tree, source, relpath, config) -> List[Finding]:
    if not path_matches(relpath, config.port_paths):
        return []
    out = []
    for node in astutil.walk(tree):
        mods: List[str] = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            mods = [node.module]
        elif isinstance(node, ast.Call) \
                and astutil.call_name(node) in ("importlib.import_module",
                                                "__import__") \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            mods = [node.args[0].value]
        for m in mods:
            if _forbidden(m):
                out.append(Finding(
                    rule="T005", path=relpath, line=node.lineno,
                    col=node.col_offset,
                    message=f"`{m}` imported in a port file; the port "
                            "keeps its own copy of what it needs and "
                            "imports no jax and nothing of `repro`"))
    return out
