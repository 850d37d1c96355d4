"""Work counting for the port: the FLOPs and bytes a program dispatches.

The JAX package's ``analysis/hlo_cost.py`` walks compiled HLO text.  The
port has no HLO: eager torch dispatches one aten op at a time, so this
module counts the dispatched aten ops under a ``TorchDispatchMode``,
with the HLO walker's conventions, unfused:

  * products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, einsum's products,
    convolutions, SDPA): 2 · out elements · contracted size
    (``torch.utils.flop_counter``'s formulas); bytes in + out
  * elementwise ops (aten's ``pointwise`` tag): 1 FLOP an output element,
    and for exp, log, tanh, sigmoid, sqrt, rsqrt, sin, cos, pow, erf (and
    expm1, log1p and the activations silu, gelu, softplus, elu) one
    transcendental too; bytes in + out
  * reductions (aten's ``reduction`` tag): 1 FLOP an input element; bytes
    in + out
  * dtype casts: no FLOPs; bytes in + out, also in ``convert_bytes``
  * views (``view``, a reshape without a copy, ``expand``, ``slice``,
    ``transpose``, ``t``, ``as_strided``, ``detach``, ...): nothing
  * gathers (``index``, ``gather``, ``embedding``, ...) move twice their
    output; scatters (``index_put_``, ``index_add_``, ``scatter_add_``,
    ...) twice their update, a FLOP an update element
  * fills and factories write their output; ``empty`` moves nothing;
    anything else moves its inputs and outputs, no FLOPs
  * softmax and log-softmax: 5 FLOPs an element (max, subtract, exp,
    sum, divide), one transcendental; their backward 4; layer norm 7
    (mean, subtract, square, sum, scale, and the affine multiply-add)

Eager torch runs every loop trip, so there is no trip count to recover;
a backward that runs inside the count is counted, ``torch.utils.
checkpoint``'s recompute included; under ``torch.func.vmap`` the mode
sees the batched ops, so a vmapped program over n rows counts n rows.

The factory's kernels: every impl the factory registers is wrapped by
``kernels.factory.counted``.  While a count runs, a call of one records
its op's registered ``cost`` once (FLOPs and bytes, whatever implements
it), lists the launch in ``custom_calls`` by op name and shape, and the
aten ops inside it are not counted.  So a program counts the same whether
the factory resolves an op to the CUDA kernel or to the plain version —
the plain ``flash_attention`` computes the whole S x S score matrix, the
count takes the causal work.  The CUDA kernels launch through ``ctypes``,
which no dispatch mode sees; this is how they are counted at all.

``collective_*`` stay 0: the port is one process.

    cost = analyze(fn, *args, **kw)          # run fn once, counted
    with counting() as cost:                 # or count any block
        ...
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log10", "tanh", "sigmoid",
                   "sqrt", "rsqrt", "sin", "cos", "pow", "erf", "expm1",
                   "log1p", "silu", "gelu", "softplus", "elu"}
#: reshapes that return a fresh tensor header over the same memory
_VIEWS = {"_unsafe_view", "_reshape_alias"}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "resize_", "set_"}
_FILLS = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
          "fill_", "zero_", "new_zeros", "new_ones", "new_full", "arange",
          "scalar_tensor", "rand", "randn", "randint", "rand_like",
          "randn_like", "normal", "normal_", "uniform_", "bernoulli",
          "bernoulli_", "randperm"}
_CASTS = {"_to_copy", "copy_", "to"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "masked_select"}
_SCATTERS = {"index_put_", "index_put", "_index_put_impl_", "index_add_",
             "index_add", "scatter_", "scatter", "scatter_add_",
             "scatter_add", "scatter_reduce_", "scatter_reduce",
             "index_copy_", "index_copy", "masked_scatter_"}
#: (FLOPs, transcendentals) an input element of the fused aten ops
_FUSED = {"_softmax": (5, 1), "_log_softmax": (5, 1),
          "_softmax_backward_data": (4, 0),
          "_log_softmax_backward_data": (4, 1),
          "native_layer_norm": (7, 0)}


@dataclasses.dataclass
class CompCost:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    convert_bytes: float = 0.0   # dtype casts (bf16 <-> f32 and the like)
    collective_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    custom_calls: List[str] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)

    def add(self, other: "CompCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.transcendentals += other.transcendentals * mult
        self.bytes += other.bytes * mult
        self.convert_bytes += other.convert_bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        self.collective_wire_bytes += other.collective_wire_bytes * mult
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + v * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0.0) + v * mult
        self.custom_calls.extend(other.custom_calls)
        self.warnings.extend(other.warnings)

    def launches(self, op: str) -> int:
        """Calls of the factory op ``op`` the count recorded."""
        return sum(1 for c in self.custom_calls if c.split(" ", 1)[0] == op)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape_text(args) -> str:
    return " ".join(f"{tuple(t.shape)}:{str(t.dtype)[6:]}"
                    for t in _tensors(args))


def _count_op(cost: CompCost, func, args, kwargs, out) -> None:
    """Add one dispatched aten op to ``cost`` (the module docstring's
    conventions)."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _VIEWS or name in _NO_BYTES:
        return
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    in_b, out_b = sum(map(_nbytes, ins)), sum(map(_nbytes, outs))
    out_elems = sum(t.numel() for t in outs)
    if func.overloadpacket in flop_registry:
        cost.flops += flop_registry[func.overloadpacket](
            *args, **kwargs, out_val=out)
        cost.bytes += in_b + out_b
    elif name in _FILLS:
        cost.bytes += out_b
    elif name in _CASTS:
        cost.bytes += in_b + out_b
        if len({t.dtype for t in ins + outs}) > 1:
            cost.convert_bytes += in_b + out_b
    elif name in _GATHERS:
        cost.bytes += 2 * out_b
    elif name in _SCATTERS:
        upd = ins[-1] if ins else None
        if upd is not None:
            cost.bytes += 2 * _nbytes(upd)
            cost.flops += upd.numel()
    elif name in _FUSED:
        per, trans = _FUSED[name]
        n = ins[0].numel() if ins else 0
        cost.flops += per * n
        cost.transcendentals += trans * n
        cost.bytes += in_b + out_b
    elif torch.Tag.pointwise in func.tags:
        cost.flops += out_elems
        if name.rstrip("_") in _TRANSCENDENTAL:
            cost.transcendentals += out_elems
        cost.bytes += in_b + out_b
    elif torch.Tag.reduction in func.tags:
        cost.flops += ins[0].numel() if ins else 0
        cost.bytes += in_b + out_b
    else:                               # data movement: copies, cat, ...
        cost.bytes += in_b + out_b


class _Counter(TorchDispatchMode):
    """One active count: the aten ops dispatched under it, and the
    factory's kernels called under it (``kernel``)."""

    def __init__(self, outer: "_Counter" = None):
        super().__init__()
        self.cost = CompCost()
        self.outer = outer
        self.paused = 0

    def _chain(self) -> List["_Counter"]:
        out, c = [], self
        while c is not None:
            out.append(c)
            c = c.outer
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            _count_op(self.cost, func, args, kwargs, out)
        return out

    def kernel(self, op: str, fn, args, kw):
        """Call ``fn``, an impl of factory op ``op``: record the op's
        registered cost once in this count and every enclosing one, with
        their aten counts paused inside the call."""
        if self.paused:                 # an impl calling another impl
            return fn(*args, **kw)
        from repro_torch.kernels.factory import kernel_cost
        chain = self._chain()
        for c in chain:
            c.paused += 1
        try:
            flops, n_bytes = kernel_cost(op)(*args, **kw)
            out = fn(*args, **kw)
        finally:
            for c in chain:
                c.paused -= 1
        call = f"{op} {_shape_text((args, kw))}"
        for c in chain:
            c.cost.flops += flops
            c.cost.bytes += n_bytes
            c.cost.custom_calls.append(call)
        return out


@contextlib.contextmanager
def counting():
    """Count the work of the block: yields the ``CompCost`` it fills."""
    from repro_torch.kernels import factory
    counter = _Counter(factory._COUNTER)
    factory._COUNTER = counter
    try:
        with counter:
            yield counter.cost
    finally:
        factory._COUNTER = counter.outer


def analyze(fn, *args, **kw) -> CompCost:
    """Run ``fn(*args, **kw)`` once under ``counting`` and return its
    cost."""
    with counting() as cost:
        fn(*args, **kw)
    return cost
