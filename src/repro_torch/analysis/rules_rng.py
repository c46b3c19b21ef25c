"""RNG-discipline rules (R-family), with the port's torch forms.

The determinism story rests on three conventions:

* every random draw comes from an explicitly seeded
  ``np.random.Generator`` / JAX key / ``torch.Generator`` -- never the
  legacy numpy global state or the global torch RNG;
* subsystems get **dedicated child streams** spawned (``SeedSequence`` /
  ``Generator.spawn`` / ``jax.random.split``/``fold_in``, or a
  ``torch.Generator`` of their own) from their parent, never draws
  interleaved on a shared stream: attaching a subsystem must leave every
  existing draw bit-identical;
* the virtual-time subsystems never read the wall clock or the stdlib
  ``random`` module, so realizations replay bit-identically.

R001 and R002 keep the reference's numpy and JAX forms unchanged and add
a torch form each; R003 is the reference's rule as it is.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.core import Finding, LintConfig, path_matches, register_rule

# Legacy np.random module-level entry points that hit the hidden global
# RandomState.  Everything else on np.random (default_rng, SeedSequence,
# Generator, the BitGenerator classes) is seeded-construction machinery.
_NP_LEGACY_OK = {
    "default_rng", "SeedSequence", "Generator", "BitGenerator",
    "PCG64", "PCG64DXSM", "MT19937", "Philox", "SFC64",
}

# jax.random functions that CONSUME a key (drawing),
# vs. ones that DERIVE new independent streams.
_JAX_DRAWS = {
    "uniform", "normal", "randint", "bernoulli", "categorical", "choice",
    "permutation", "truncated_normal", "bits", "exponential", "gamma",
    "beta", "poisson", "laplace", "gumbel", "cauchy", "dirichlet",
    "multivariate_normal", "rademacher", "t", "maxwell", "loggamma",
    "ball", "orthogonal", "binomial", "geometric", "rayleigh", "wald",
    "weibull_min", "double_sided_maxwell", "generalized_normal",
}
_JAX_DERIVES = {"split", "fold_in", "clone", "key", "PRNGKey", "wrap_key_data"}

# np.random.Generator drawing methods (``spawn`` is the derivation idiom).
_GEN_DRAWS = {
    "random", "uniform", "normal", "standard_normal", "exponential",
    "integers", "choice", "shuffle", "permutation", "permuted", "poisson",
    "binomial", "gamma", "beta", "weibull", "lognormal", "geometric",
    "pareto", "multivariate_normal", "standard_exponential",
    "standard_gamma", "chisquare", "dirichlet", "f", "gumbel",
    "hypergeometric", "laplace", "logistic", "lognormal", "logseries",
    "multinomial", "negative_binomial", "noncentral_chisquare",
    "noncentral_f", "power", "rayleigh", "standard_cauchy", "standard_t",
    "triangular", "vonmises", "wald", "zipf", "bytes",
}

_WALLCLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
}
_DATETIME_ATTRS = {"now", "utcnow", "today"}
_STDLIB_RANDOM_FNS = {
    "random", "uniform", "randint", "randrange", "choice", "choices",
    "shuffle", "sample", "seed", "gauss", "normalvariate", "expovariate",
    "betavariate", "gammavariate", "lognormvariate", "paretovariate",
    "vonmisesvariate", "weibullvariate", "triangular", "getrandbits",
    "randbytes",
}

# torch functions that draw from a generator (the global RNG unless
# ``generator=`` names one), and the in-place tensor draws.
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
}
_TORCH_INPLACE_DRAWS = {
    "uniform_", "normal_", "exponential_", "geometric_", "random_",
    "bernoulli_", "cauchy_", "log_normal_",
}
_TORCH_GLOBAL_SEEDS = {
    "torch.manual_seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.random.manual_seed",
}
# Callees that take a generator as an argument without drawing from it.
_NOT_A_HELPER = {"print", "isinstance", "id", "type", "repr", "str"}


@register_rule(
    "R001",
    summary="draw from a global RNG (np.random module level, or torch's "
            "without generator=)",
    invariant="every draw comes from an explicitly seeded Generator; "
              "module-level np.random.* calls and torch draws without "
              "generator= share mutable global state across components "
              "and break seed isolation, and torch.manual_seed reseeds "
              "every component's stream at once",
)
def r001_no_global_random(tree, source, relpath, config) -> List[Finding]:
    out = []
    for node in astutil.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node)
        parts = name.split(".") if name is not None else []
        if len(parts) >= 3 and parts[-3] in ("np", "numpy") \
                and parts[-2] == "random" and parts[-1] not in _NP_LEGACY_OK:
            out.append(Finding(
                rule="R001", path=relpath, line=node.lineno,
                col=node.col_offset,
                message=f"`{name}(...)` draws from the process-global "
                        "RandomState; construct a seeded "
                        "`np.random.default_rng(seed)` (or spawn a child "
                        "stream from an existing Generator) instead"))
            continue
        bad = _torch_global_draw(node, name, parts)
        if bad is not None:
            out.append(Finding(
                rule="R001", path=relpath, line=node.lineno,
                col=node.col_offset,
                message=f"{bad}; draw from an explicitly seeded "
                        "`torch.Generator(device).manual_seed(seed)` "
                        "passed as `generator=`"))
    return out


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _torch_global_draw(call: ast.Call, name, parts: List[str]):
    """What is wrong with this call, when it uses the global torch RNG
    (``name``/``parts``: its dotted callee, None/[] for ``f(x).m(...)``)."""
    if name in _TORCH_GLOBAL_SEEDS:
        return f"`{name}(...)` reseeds the global torch RNG"
    if _has_generator(call):
        return None
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_DRAWS:
        return f"`{name}(...)` draws from the global torch RNG"
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _TORCH_INPLACE_DRAWS:
        return f"`.{call.func.attr}(...)` draws from the global torch RNG"
    return None


def _jax_draw_key_name(call: ast.Call):
    """(key_name, fn_name) when this call draws from a bare-Name key."""
    name = astutil.call_name(call)
    if name is None:
        return None
    parts = name.split(".")
    fn = parts[-1]
    if fn not in _JAX_DRAWS:
        return None
    if not (("random" in parts[:-1]) or ("jrandom" in parts[:-1])
            or ("jr" in parts[:-1])):
        return None
    args = list(call.args)
    key_arg = args[0] if args else None
    for kw in call.keywords:
        if kw.arg == "key":
            key_arg = kw.value
    if isinstance(key_arg, ast.Name):
        return key_arg.id, fn
    return None


def _comprehension_names(scope: ast.AST) -> Set[int]:
    """ids of the Name nodes in ``scope`` that refer to a comprehension's
    own variable (``_ok(g) for g in gaps``): a comprehension is a scope of
    its own, so such a name is not the enclosing scope's generator."""
    out: Set[int] = set()
    comps = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
    for node in astutil.scope_body_nodes(scope):
        if not isinstance(node, comps):
            continue
        bound = {n.id for g in node.generators for n in ast.walk(g.target)
                 if isinstance(n, ast.Name)}
        out.update(id(n) for n in ast.walk(node)
                   if isinstance(n, ast.Name) and n.id in bound)
    return out


@register_rule(
    "R002",
    summary="parent stream drawn where a spawned child stream is required",
    invariant="dedicated streams are SPAWNED (Generator.spawn / "
              "SeedSequence children / jax.random.split+fold_in / a "
              "torch.Generator of the subsystem's own), never drawn from a "
              "shared parent: attaching a subsystem must leave every "
              "existing draw bit-identical, and a JAX key consumed twice "
              "yields correlated noise",
)
def r002_stream_discipline(tree, source, relpath, config) -> List[Finding]:
    out = []
    for scope in astutil.iter_scopes(tree):
        # (a) JAX: the same bare key Name consumed by >= 2 draw calls in
        # one scope.  split/fold_in derive and are exempt.
        seen: Dict[str, ast.Call] = {}
        # (b) numpy: a Generator Name both drawn from locally and handed
        # to a helper in the same scope — the helper must get a spawned
        # child or own the stream outright.
        drawn_from: Dict[str, ast.Call] = {}
        passed_to: List[Tuple[str, ast.Call, str]] = []
        # (c) torch: a Generator Name drawn from (``generator=g``) and
        # handed to a helper in the same scope.
        torch_drawn: Dict[str, List[ast.Name]] = {}
        torch_passed: List[Tuple[ast.Name, ast.Call, str]] = []
        for node in astutil.scope_body_nodes(scope):
            if not isinstance(node, ast.Call):
                continue
            hit = _jax_draw_key_name(node)
            if hit is not None:
                key, fn = hit
                if key in seen:
                    out.append(Finding(
                        rule="R002", path=relpath, line=node.lineno,
                        col=node.col_offset,
                        message=f"JAX key `{key}` is consumed by more than "
                                f"one draw in this scope (again by "
                                f"`{fn}`); split/fold_in a fresh subkey "
                                "per draw — reusing a key yields "
                                "correlated, order-fragile noise"))
                else:
                    seen[key] = node
            name = astutil.call_name(node)
            for kw in node.keywords:
                if kw.arg == "generator" and isinstance(kw.value, ast.Name):
                    torch_drawn.setdefault(kw.value.id, []).append(kw.value)
            if name is None:
                continue
            parts = name.split(".")
            if len(parts) == 2 and parts[1] in _GEN_DRAWS \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name):
                drawn_from.setdefault(parts[0], node)
            if parts[-1] not in _GEN_DRAWS and name != "print":
                for a in node.args:
                    if isinstance(a, ast.Name):
                        passed_to.append((a.id, node, name))
                for kw in node.keywords:
                    if isinstance(kw.value, ast.Name):
                        passed_to.append((kw.value.id, node, name))
            if name not in _NOT_A_HELPER:
                for a in node.args:
                    if isinstance(a, ast.Name):
                        torch_passed.append((a, node, name))
                for kw in node.keywords:
                    if kw.arg != "generator" and isinstance(kw.value,
                                                            ast.Name):
                        torch_passed.append((kw.value, node, name))
        flagged = set()
        for nm, call, callee in passed_to:
            if nm in drawn_from and not callee.endswith(".spawn"):
                flagged.add((nm, id(call)))
                out.append(Finding(
                    rule="R002", path=relpath, line=call.lineno,
                    col=call.col_offset,
                    message=f"`{nm}` is drawn from in this scope AND passed "
                            f"into `{callee}(...)`; the helper must receive "
                            f"a spawned child stream (`{nm}.spawn(1)[0]` / "
                            "a SeedSequence child), or own the stream "
                            "exclusively — interleaving draws on a shared "
                            "parent breaks replay bit-identity"))
        shadowed: Set[int] = set()
        if any(a.id in torch_drawn for a, _, _ in torch_passed):
            shadowed = _comprehension_names(scope)
        drawn = {nm for nm, refs in torch_drawn.items()
                 if any(id(r) not in shadowed for r in refs)}
        for a, call, callee in torch_passed:
            nm = a.id
            if nm in drawn and id(a) not in shadowed \
                    and (nm, id(call)) not in flagged:
                flagged.add((nm, id(call)))
                out.append(Finding(
                    rule="R002", path=relpath, line=call.lineno,
                    col=call.col_offset,
                    message=f"torch generator `{nm}` is drawn from in this "
                            f"scope (`generator={nm}`) AND passed into "
                            f"`{callee}(...)`; give the helper a generator "
                            "of its own (seeded from a child seed) — "
                            "interleaving draws on a shared generator "
                            "breaks replay bit-identity"))
    return out


@register_rule(
    "R003",
    summary="wall clock / stdlib random inside a virtual-time subsystem",
    invariant="sim/exec/p2p/serve/runtime advance on virtual time and "
              "seeded streams only, so every realization replays "
              "bit-identically (executor/digital-twin contract, DESIGN.md "
              "Sec 10); measured wall-clock diagnostics live on the "
              "[tool.reprolint] r003-allow list",
)
def r003_no_wallclock(tree, source, relpath, config) -> List[Finding]:
    if not path_matches(relpath, config.r003_paths):
        return []
    if path_matches(relpath, config.r003_allow):
        return []
    out = []
    for node in astutil.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node)
        if name is None:
            continue
        parts = name.split(".")
        bad = None
        if name in _WALLCLOCK:
            bad = f"`{name}()` reads the wall clock"
        elif parts[-1] in _DATETIME_ATTRS and "datetime" in parts[:-1] or \
                (parts[-1] in _DATETIME_ATTRS and parts[:-1] == ["date"]):
            bad = f"`{name}()` reads the wall clock"
        elif len(parts) == 2 and parts[0] == "random" \
                and parts[1] in _STDLIB_RANDOM_FNS:
            bad = f"`{name}()` draws from the stdlib global RNG"
        if bad is not None:
            out.append(Finding(
                rule="R003", path=relpath, line=node.lineno,
                col=node.col_offset,
                message=f"{bad} inside a virtual-time subsystem; thread "
                        "virtual `now` / a seeded stream through instead "
                        "(or add this file to `r003-allow` with a comment "
                        "saying what real duration it measures)"))
    return out
