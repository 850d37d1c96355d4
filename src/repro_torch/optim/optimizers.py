"""Optimizers of the port: plain functions over dicts of tensors.

``make_optimizer(spec)`` returns an ``Optimizer(init, update)`` pair:
``init(params) -> state`` and ``update(grads, state, params) ->
(new_params, new_state, grad_norm)``.  Both are pure functions of their
arguments (no in-place writes), so a cohort lifts ``update`` over its
stacked per-trainer state with ``torch.func.vmap``.  Leaves are visited in
sorted key order, the order the JAX package's pytrees flatten them in.

* adamw     — bfloat16 moments by default, decoupled weight decay.
* adafactor — factored second moment (beta1 = 0) with the rms-1 update
              clip; takes ``groups`` (below) to see the JAX tree's leaves.
* sgdm      — plain momentum (the FL protocol's optimizer).

Each clips the gradients to ``grad_clip`` by their global norm first.

``groups`` (adafactor only): ``{key: (leaf, j)}``, where ``leaf`` names the
JAX package's leaf that holds ``key`` and ``j`` its index along that
leaf's stacked period axis (``None`` for a leaf that is not stacked).
The JAX package stacks a block's weight over ``n_periods``, so its
adafactor takes the factored test on the stacked shape and its update
clip's RMS over every layer of the leaf at once; ``groups`` makes the
port do the same (``models.transformer.param_groups``).  Without it every
key is a leaf of its own, as a plain dict tree is in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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


def make_optimizer(spec: OptimizerSpec,
                   groups: Optional[Dict[str, Tuple[str, Optional[int]]]]
                   = None) -> Optimizer:
    if spec.name == "adamw":
        return _adamw(spec)
    if spec.name == "adafactor":
        return _adafactor(spec, groups)
    if spec.name == "sgdm":
        return _sgdm(spec)
    raise ValueError(spec.name)


def _step_of(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)


# -- AdamW ---------------------------------------------------------------------
def _adamw(spec: OptimizerSpec) -> Optimizer:
    mdt = _DTYPES[spec.moment_dtype]

    def init(params):
        return {"m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                      for k, p in params.items()},
                "step": _step_of(params)}

    def update(grads, state, params):
        grads, gn = _clip_by_global_norm(grads, spec.grad_clip)
        step = state["step"] + 1
        b1, b2 = spec.beta1, spec.beta2
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)
        new_p, new_m, new_v = {}, {}, {}
        for k in sorted(params):
            p = params[k]
            g32 = grads[k].to(torch.float32)
            m32 = b1 * state["m"][k].to(torch.float32) + (1 - b1) * g32
            v32 = b2 * state["v"][k].to(torch.float32) + (1 - b2) * \
                torch.square(g32)
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + spec.eps)
            p32 = p.to(torch.float32)
            p32 = p32 - spec.lr * (delta + spec.weight_decay * p32)
            new_p[k], new_m[k], new_v[k] = p32.to(p.dtype), m32.to(mdt), \
                v32.to(mdt)
        return new_p, {"m": new_m, "v": new_v, "step": step}, gn

    return Optimizer(init, update)


# -- Adafactor -----------------------------------------------------------------
def _factored(shape, min_dim) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _members(groups, params) -> Dict[str, list]:
    """JAX leaf -> its keys in period order ([key] for an unstacked one)."""
    out: Dict[str, list] = {}
    for k in sorted(params):
        leaf, j = groups[k] if groups is not None else (k, None)
        out.setdefault(leaf, []).append((-1 if j is None else j, k))
    for leaf, keys in out.items():
        keys.sort()
        stacked = keys[0][0] >= 0
        if [j for j, _ in keys] != (list(range(len(keys))) if stacked
                                    else [-1]):
            raise ValueError(f"adafactor's groups give leaf {leaf!r} the "
                             f"periods {[j for j, _ in keys]}")
        out[leaf] = (stacked, [k for _, k in keys])
    return out


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` laid out as ``ref`` where both are DTensors (a gradient as its
    weight lies, a new second moment as the old): a stacked leaf keeps
    its weights' layout, and a partial statistic is reduced while it is
    small, before it meets the leaf."""
    placements = getattr(ref, "placements", None)
    if placements is None or tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(ref.device_mesh, placements)


def _gather(tree, stacked: bool, keys: list, like=None) -> torch.Tensor:
    ts = [tree[k] if like is None else _like(tree[k], like[k])
          for k in keys]
    return torch.stack(ts) if stacked else ts[0]


def _adafactor(spec: OptimizerSpec, groups=None) -> Optimizer:
    """The JAX package's adafactor, on its leaves: a stacked leaf is
    gathered from its per-layer keys for the update and cut apart after."""

    def init(params):
        v = {}
        for leaf, (stacked, keys) in _members(groups, params).items():
            p = params[keys[0]]
            shape = ((len(keys),) if stacked else ()) + tuple(p.shape)
            if _factored(shape, spec.factored_min):
                v[leaf] = {"vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                             device=p.device),
                           "vc": torch.zeros(shape[:-2] + shape[-1:],
                                             dtype=torch.float32,
                                             device=p.device)}
            else:
                v[leaf] = {"v": torch.zeros(shape, dtype=torch.float32,
                                            device=p.device)}
        return {"v": v, "step": _step_of(params)}

    def update(grads, state, params):
        grads, gn = _clip_by_global_norm(grads, spec.grad_clip)
        step = state["step"] + 1
        decay = 1.0 - step.to(torch.float32) ** -0.8   # beta2 schedule
        new_p, new_v = {}, {}
        for leaf, (stacked, keys) in _members(groups, params).items():
            p = _gather(params, stacked, keys)
            g32 = _gather(grads, stacked, keys, params).to(torch.float32)
            g2 = torch.square(g32) + 1e-30
            v = state["v"][leaf]
            if "vr" in v:
                vr = _like(decay * v["vr"] + (1 - decay) * g2.mean(-1),
                           v["vr"])
                vc = _like(decay * v["vc"] + (1 - decay) * g2.mean(-2),
                           v["vc"])
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                       min=1e-30))
                new_v[leaf] = {"vr": vr, "vc": vc}
            else:
                new_v[leaf] = {"v": _like(decay * v["v"] + (1 - decay) * g2,
                                          v["v"])}
                denom = new_v[leaf]["v"]
            delta = _like(g32 * torch.rsqrt(denom + 1e-30), p)
            # update clipping (adafactor rms-1 rule), over the whole leaf
            rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
            delta = delta / torch.clamp(rms, min=1.0)
            p32 = p.to(torch.float32)
            p32 = (p32 - spec.lr * (delta + spec.weight_decay * p32)).to(
                p.dtype)
            for j, k in enumerate(keys):
                new_p[k] = p32[j] if stacked else p32
        return new_p, {"v": new_v, "step": step}, gn

    return Optimizer(init, update)


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


def spec_for_config(cfg) -> OptimizerSpec:
    return OptimizerSpec(name=cfg.optimizer)
