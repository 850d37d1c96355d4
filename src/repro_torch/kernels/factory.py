"""Swappable kernel factory for the port's ledger, FL and attention ops.

Call sites ask the factory for an op instead of hard-wiring one form:

    from repro_torch.kernels.factory import get_kernel
    roots = get_kernel("batch_seal")(words, starts)

Impl keys:

  * ``"cuda"``  — the wrapper: the hand-written CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  The default.
  * ``"torch"`` — the plain PyTorch version, on any device.
  * ``"mesh"``  — ``shard_seal`` only: the lane rows split over the shard
    mesh (launch/mesh.py), each block through the op's default impl on
    its own device.

Selection: an explicit ``impl=`` wins; else the ``REPRO_TORCH_KERNEL_IMPL``
environment variable; else ``"auto"``, the op's default.  The ledger ops
(``batch_seal``, ``rollup_digest``, ``rollup_chunk_digests``,
``dirty_fold``) take and return int32 tensors carrying u32 bits, with
identical bits from every impl, and so does ``shard_seal`` (the fused
fabric's K-lane ``batch_seal``: a (K, W) word grid and (K, B) starts to
(K, B) digests); ``block_pack`` (the fused loop's block
packing) takes float64 times and int64 gas cumsums and returns int64 stop
pointers, identical from every impl.  The FL ops (``weighted_agg``, Eq. 1, and
``model_distance``, Eq. 4) take float32 or bfloat16 and agree to float32
rounding; so do ``flash_attention`` (the prefill's causal GQA attention,
``(q, k, v, causal=True)``) and its gradient ``flash_attention_bwd``
(``(q, k, v, o, lse, do, causal=True)`` -> ``(dq, dk, dv)``), ``gmm``
(the MoE FFN's expert products, ``(xe, w)``) and its gradient
``gmm_bwd`` (``(xe, w, dy)`` -> ``(dx, dw)``), and ``slstm_scan`` (the
sLSTM time scan, ``(wx, r_gates, h, c, n, m)``) and its gradient
``slstm_scan_bwd`` (the saved forward and the outputs' gradients ->
``(dwx, dr_gates, dh0, dc0, dn0, dm0)``), and ``ssm_scan`` (the Mamba
selective scan, ``(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)`` -> ``(out,
h)``) and its gradient ``ssm_scan_bwd`` (those, the forward's saved
states and the outputs' gradients -> ``(dx, ddt_pre, ddt_bias, dBm, dCm,
dA_log, dD, dh0)``).  Every impl returns its result on the input's device.

Work: every op registers one pure ``cost(*args, **kw) -> (flops,
bytes)``, its work at those arguments whatever implements it (``kernel_cost``;
each kernel module defines its op's next to the kernel).  Every impl is
wrapped by ``counted``: while a work counter is active
(``analysis/hlo_cost.counting``), a call records its op's cost once and the
aten ops inside it are not counted, so a program counts the same whether
an op resolves to the CUDA kernel or to the plain version.  With no
counter active the wrapper reads one module global and calls through.

Fake forms: under ``FakeTensorMode`` (the dry run, ``launch/dryrun.py``)
the model path's wrappers (``flash_attention``, ``gmm``, ``slstm_scan``,
``ssm_scan`` and their gradients) take their kernel's route on fake
tensors whatever their device, and the launch is replaced by its fake
form: the same outputs, scratch and copies, and where autograd records
the same saved tensors, allocated as fake tensors, and no launch and no
launch count.  Their plain versions never run on fake tensors (the plain
``flash_attention`` alone would build an S x S score matrix).
"""
from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_DEFAULTS: Dict[str, str] = {}
_COSTS: Dict[str, Callable] = {}
_LOADED = False
#: the innermost active work counter (``analysis/hlo_cost.counting``), or
#: None; read at every call of a counted impl
_COUNTER = None


def counted(op: str) -> Callable:
    """Decorate an impl of ``op`` (a kernel wrapper or a plain version):
    while a work counter is active the call goes through
    ``counter.kernel(op, fn, args, kw)``, which records ``op``'s
    registered cost once; otherwise it calls ``fn`` directly.  The check
    happens at call time, so callers may hold on to the impl."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kw):
            counter = _COUNTER
            if counter is None:
                return fn(*args, **kw)
            return counter.kernel(op, fn, args, kw)
        return call
    return wrap


def register_kernel(op: str, impl: str, fn: Callable, *,
                    default: bool = False) -> Callable:
    """Register ``fn`` as implementation ``impl`` of ``op``."""
    _REGISTRY.setdefault(op, {})[impl] = fn
    if default or op not in _DEFAULTS:
        _DEFAULTS[op] = impl
    return fn


def register_cost(op: str, cost: Callable) -> Callable:
    """Register ``cost(*args, **kw) -> (flops, bytes)`` as ``op``'s work."""
    _COSTS[op] = cost
    return cost


def kernel_cost(op: str) -> Callable:
    """``op``'s registered ``cost``: its FLOPs (integer operations for the
    ledger ops) and bytes moved (each input read once, each output written
    once) at the arguments of a call."""
    _load()
    try:
        return _COSTS[op]
    except KeyError:
        raise KeyError(f"unknown kernel op {op!r}; "
                       f"registered: {sorted(_COSTS)}") from None


def _load() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import block_pack as bp
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import model_distance as md
    from repro_torch.kernels import rollup_digest as rd
    from repro_torch.kernels import shard_lanes as sl
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.kernels import weighted_agg as wa
    for op, plain, wrapper, cost in (
            ("batch_seal", bs.batch_seal_torch, bs.batch_seal,
             bs.batch_seal_cost),
            ("shard_seal", sl.shard_seal_torch, sl.shard_seal,
             sl.shard_seal_cost),
            ("rollup_digest", rd.rollup_digest_torch, rd.rollup_digest,
             rd.rollup_digest_cost),
            ("rollup_chunk_digests", rd.rollup_chunk_digests_torch,
             rd.rollup_chunk_digests, rd.rollup_chunk_digests_cost),
            ("dirty_fold", df.dirty_fold_torch, df.dirty_fold,
             df.dirty_fold_cost),
            ("weighted_agg", wa.weighted_agg_torch, wa.weighted_agg,
             wa.weighted_agg_cost),
            ("model_distance", md.model_distance_torch,
             md.model_distance, md.model_distance_cost),
            ("block_pack", bp.block_pack_torch, bp.block_pack,
             bp.block_pack_cost),
            ("flash_attention", fa.flash_attention_torch,
             fa.flash_attention, fa.flash_attention_cost),
            ("flash_attention_bwd", fa.flash_attention_bwd_torch,
             fa.flash_attention_bwd, fa.flash_attention_bwd_cost),
            ("gmm", gm.gmm_torch, gm.gmm, gm.gmm_cost),
            ("gmm_bwd", gm.gmm_bwd_torch, gm.gmm_bwd, gm.gmm_bwd_cost),
            ("slstm_scan", ss.slstm_scan_torch, ss.slstm_scan,
             ss.slstm_scan_cost),
            ("slstm_scan_bwd", ss.slstm_scan_bwd_torch, ss.slstm_scan_bwd,
             ss.slstm_scan_bwd_cost),
            ("ssm_scan", sm.ssm_scan_torch, sm.ssm_scan, sm.ssm_scan_cost),
            ("ssm_scan_bwd", sm.ssm_scan_bwd_torch, sm.ssm_scan_bwd,
             sm.ssm_scan_bwd_cost)):
        register_kernel(op, "torch", plain)
        register_kernel(op, "cuda", wrapper, default=True)
        register_cost(op, cost)
    register_kernel("shard_seal", "mesh", sl.shard_seal_mesh)


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
