"""reprolint for the port -- AST-enforced determinism, RNG-stream and torch
contracts of ``src/repro_torch`` (the counterpart of ``repro.analysis``).

Rule families:

* **R** — RNG discipline: R001 no global RNG draws (legacy
  ``np.random.*``; torch draws without ``generator=``,
  ``torch.manual_seed``), R002 spawn-child-stream idiom (no parent-stream
  draws / JAX key reuse / a ``torch.Generator`` both drawn from and
  handed to a helper), R003 no wall clock / stdlib ``random`` in
  virtual-time subsystems.
* **T** — torch contracts: T001 no Python control flow on a tensor's
  value in a step body, T002 no host round-trips in a step body, T003
  kernel libraries launch only through ``build.launch``, T004 no
  division by a numeric literal on the bitwise paths, T005 no import of
  jax or the JAX package in a port file.
* **A** — API hygiene: A001 canonical ``min_interval``/``max_interval``
  spellings, A002 ``tick`` overrides keep ``exposure_peers``.
* **B** — accounting (report-only): B001 restore-path results must be
  billed.
* **S** — the linter's own contract: S000 suppressions need a
  justification.

Run ``python -m repro_torch.launch.reprolint`` from the repo root (with
``src`` on the path); ``exclude``/``disable``/``report-only`` come from
``[tool.reprolint]`` in pyproject.toml, everything else from
:class:`LintConfig`'s defaults.
"""
from repro_torch.analysis.core import (  # noqa: F401
    DEFAULT_PATHS, Finding, LintConfig, LintReport, RULES, default_paths,
    lint_paths, lint_source, register_rule,
)
from repro_torch.analysis import (  # noqa: F401  (rule registration side effect)
    rules_accounting, rules_api, rules_rng, rules_torch,
)
from repro_torch.analysis.report import render_human, render_json  # noqa: F401
