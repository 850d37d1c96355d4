"""DEPRECATED shim: ``repro_torch.launch.serve`` was two identities in one
name, as ``src/repro/launch/serve.py`` is.

The MODEL-inference launcher is ``repro_torch.launch.serve_model`` (same
``main``, same flags); the LEDGER node service is
``repro_torch.launch.serve_node`` over ``repro_torch.serve``.  This module
re-exports the model launcher for one release so that
``from repro_torch.launch.serve import main`` keeps working — see
docs/MIGRATION.md.
"""
from __future__ import annotations

import warnings

from repro_torch.launch.serve_model import main  # noqa: F401  (re-export)

warnings.warn(
    "repro_torch.launch.serve is deprecated: the model-inference launcher "
    "moved to repro_torch.launch.serve_model; the node service is "
    "repro_torch.launch.serve_node (see docs/MIGRATION.md)",
    DeprecationWarning, stacklevel=2)

if __name__ == "__main__":
    main()
