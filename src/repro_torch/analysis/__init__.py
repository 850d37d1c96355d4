"""Invariant-aware static checker, runtime sanitizer and work counting for
the port.

Two enforcement layers over ONE shared invariant catalog
(``analysis/invariants.py``, the same rule ids, titles and static /
dynamic split as the JAX package's):

- ``analysis/lint.py`` — AST-based static pass (``python -m
  repro_torch.analysis.lint src/repro_torch``) with the rules R001-R005
  and R008 aimed at the port's tree.
- ``analysis/sanitize.py`` — runtime sanitizer (``REPRO_SANITIZE=1``,
  installed by ``api.factory.build_stack``) that wraps the stack's event
  log and cross-checks the same invariants dynamically (R001, R005-R007).

Work counting: ``analysis/hlo_cost.py`` counts the FLOPs and bytes of the
aten ops a program dispatches, and records each factory kernel's work
from its registered ``cost``; ``analysis/model_flops.py`` gives the
analytic model FLOPs to hold that count against.

See docs/ANALYSIS_TORCH.md for the rule catalog and suppression syntax.
Pure stdlib at import: importing this package pulls in neither torch nor
the modules it checks.
"""
from repro_torch.analysis.invariants import CATALOG, Invariant  # noqa: F401
