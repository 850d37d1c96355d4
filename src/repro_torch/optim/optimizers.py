"""Optimizers of the port: plain functions over dicts of tensors.

``make_optimizer(spec)`` returns an ``Optimizer(init, update)`` pair:
``init(params) -> state`` and ``update(grads, state, params) ->
(new_params, new_state, grad_norm)``.  Both are pure functions of their
arguments (no in-place writes), so a cohort lifts ``update`` over its
stacked per-trainer state with ``torch.func.vmap``.  Leaves are visited in
sorted key order, the order the JAX package's pytrees flatten them in.

Ported: ``sgdm`` with global-norm gradient clipping, the FL protocol's
optimizer.  ``adamw`` and ``adafactor`` serve the model substrate and are
not ported yet (ROADMAP.md, queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str = "adamw"
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "bfloat16"
    # adafactor
    factored_min: int = 128     # factor only dims >= this


class Optimizer(NamedTuple):
    init: Callable
    update: Callable          # (grads, state, params) -> (params, state, gn)


def _leaves(tree: Dict[str, torch.Tensor]):
    return [tree[k] for k in sorted(tree)]


def _global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    sq = [torch.sum(torch.square(leaf.to(torch.float32)))
          for leaf in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, gn


def make_optimizer(spec: OptimizerSpec) -> Optimizer:
    if spec.name == "sgdm":
        return _sgdm(spec)
    if spec.name in ("adamw", "adafactor"):
        raise NotImplementedError(
            f"optimizer {spec.name!r} is not ported yet (ROADMAP.md, queue 1 "
            "item 10)")
    raise ValueError(spec.name)


def _sgdm(spec: OptimizerSpec) -> Optimizer:
    """SGD with momentum; the momentum is kept in ``spec.moment_dtype``."""
    mdt = _DTYPES[spec.moment_dtype]

    def init(params):
        return {"m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                      for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=next(iter(params.values())).device)}

    def update(grads, state, params):
        grads, gn = _clip_by_global_norm(grads, spec.grad_clip)
        new_p, new_m = {}, {}
        for k in sorted(params):
            p, m = params[k], state["m"][k]
            m32 = spec.beta1 * m.to(torch.float32) + grads[k].to(
                torch.float32)
            new_p[k] = (p.to(torch.float32) - spec.lr * m32).to(p.dtype)
            new_m[k] = m32.to(mdt)
        return new_p, {"m": new_m, "step": state["step"] + 1}, gn

    return Optimizer(init, update)
