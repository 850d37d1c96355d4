"""Swappable kernel factory for the port's ledger and FL ops.

Call sites ask the factory for an op instead of hard-wiring one form:

    from repro_torch.kernels.factory import get_kernel
    roots = get_kernel("batch_seal")(words, starts)

Impl keys:

  * ``"cuda"``  — the wrapper: the hand-written CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  The default.
  * ``"torch"`` — the plain PyTorch version, on any device.

Selection: an explicit ``impl=`` wins; else the ``REPRO_TORCH_KERNEL_IMPL``
environment variable; else ``"auto"``, the op's default.  The ledger ops
(``batch_seal``, ``rollup_digest``, ``rollup_chunk_digests``,
``dirty_fold``) take and return int32 tensors carrying u32 bits, with
identical bits from every impl.  The FL ops (``weighted_agg``, Eq. 1, and
``model_distance``, Eq. 4) take float32 or bfloat16 and agree to float32
rounding.  Every impl returns its result on the input's device.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_DEFAULTS: Dict[str, str] = {}
_LOADED = False


def register_kernel(op: str, impl: str, fn: Callable, *,
                    default: bool = False) -> Callable:
    """Register ``fn`` as implementation ``impl`` of ``op``."""
    _REGISTRY.setdefault(op, {})[impl] = fn
    if default or op not in _DEFAULTS:
        _DEFAULTS[op] = impl
    return fn


def _load() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import model_distance as md
    from repro_torch.kernels import rollup_digest as rd
    from repro_torch.kernels import weighted_agg as wa
    for op, plain, wrapper in (
            ("batch_seal", bs.batch_seal_torch, bs.batch_seal),
            ("rollup_digest", rd.rollup_digest_torch, rd.rollup_digest),
            ("rollup_chunk_digests", rd.rollup_chunk_digests_torch,
             rd.rollup_chunk_digests),
            ("dirty_fold", df.dirty_fold_torch, df.dirty_fold),
            ("weighted_agg", wa.weighted_agg_torch, wa.weighted_agg),
            ("model_distance", md.model_distance_torch,
             md.model_distance)):
        register_kernel(op, "torch", plain)
        register_kernel(op, "cuda", wrapper, default=True)


def available_impls(op: str) -> Tuple[str, ...]:
    _load()
    return tuple(sorted(_REGISTRY.get(op, {})))


def get_kernel(op: str, impl: str | None = None) -> Callable:
    """Resolve ``op`` to one implementation (see module docstring)."""
    _load()
    try:
        table = _REGISTRY[op]
    except KeyError:
        raise KeyError(f"unknown kernel op {op!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None
    choice = impl or os.environ.get("REPRO_TORCH_KERNEL_IMPL") or "auto"
    if choice == "auto":
        choice = _DEFAULTS[op]
    try:
        return table[choice]
    except KeyError:
        raise KeyError(f"kernel op {op!r} has no impl {choice!r}; "
                       f"available: {sorted(table)}") from None
