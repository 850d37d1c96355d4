"""The training step of the model substrate, and the dry run's cells.

``build_train_step(model, opt)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm"})`` over a flat dict of
weights (``Model.train_params``), as the JAX package's
``build_train_step`` does over its tree.  PyTorch runs eagerly: the step
is a function, not a jitted cell.

A *cell* is (architecture x input shape x mesh).  ``build_cell(cfg,
shape, mesh)`` gives its step over DTensor leaves laid out by the
model's specs (``Model.params_pspecs``, ``opt_state_pspecs``,
``Model.input_pspecs``, ``Model.decode_state_pspecs``), in the JAX
package's three kinds:

  * ``train``: ``build_train_step`` on the flat dict of weights;
  * ``prefill``: ``(params, batch) -> (last logits, caches)``;
  * ``decode``: ``(params, state, batch) -> (logits, state)``, one token
    written into the seq_len-deep state in place at the host ``pos``
    ``seq_len - 1``, as the port's decode does.

``Cell.args`` are stand-ins: each leaf a DTensor whose local shard is an
empty tensor on the mesh's device (fake, and so never allocated, under
``FakeTensorMode``: the dry run, ``launch/dryrun.py``).  ``place`` lays
real full tensors out by the same specs (a run on a real mesh), scattered
from rank 0; ``shard`` lays out a tensor every rank holds whole, each
rank copying out its own shard (the launcher's batches and weights).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.sharding.specs import P, is_spec


def value_and_grad(model, params: Dict[str, torch.Tensor], batch,
                   remat=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, gradients) of ``model.loss`` at ``params``, the gradients
    keyed as ``params``; the weights themselves are not written.  A
    weight the loss does not reach raises, except an encoder-decoder's
    ``encdec.unread`` weights (whisper's ``wi_up``), whose gradient is
    zero, as JAX gives it."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = model.loss(leaves, batch, remat)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    missing = [k for k, g in zip(leaves, grads) if g is None]
    if missing:
        from repro_torch.models import encdec
        if not (getattr(getattr(model, "cfg", None), "enc_dec", False)
                and all(map(encdec.unread, missing))):
            raise RuntimeError(f"the loss does not reach {missing}")
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def build_train_step(model, opt):
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        new_params, new_opt_state, gn = opt.update(grads, opt_state, params)
        return new_params, new_opt_state, {"loss": loss, "grad_norm": gn}
    return train_step


# -----------------------------------------------------------------------------
# Cells
# -----------------------------------------------------------------------------
class Cell(NamedTuple):
    step: Callable
    args: tuple          # DTensor stand-ins, one tree a step argument
    model: Any
    kind: str
    specs: tuple         # the spec trees of ``args``


def opt_state_pspecs(opt_name: str, pspecs, params_shape, groups=None):
    """Optimizer-state specs mirroring the weights' (``pspecs``, a flat
    dict), in ``optim.optimizers``' layouts: ``m`` (and ``v``) for sgdm
    and adamw; adafactor's ``v`` keyed by the JAX leaf (``groups``:
    ``Model.param_groups``), a stacked leaf's spec with its leading
    ``None``, its factored ``vr`` the spec without the last dim and
    ``vc`` without the one before."""
    if opt_name in ("adamw", "sgdm"):
        st = {"m": dict(pspecs), "step": P()}
        if opt_name == "adamw":
            st["v"] = dict(pspecs)
        return st
    if opt_name == "adafactor":
        from repro_torch.optim.optimizers import (OptimizerSpec, _factored,
                                                  _members)
        v = {}
        for leaf, (stacked, keys) in _members(groups, params_shape).items():
            spec = tuple(pspecs[keys[0]])
            shape = tuple(params_shape[keys[0]].shape)
            if stacked:
                spec, shape = (None,) + spec, (len(keys),) + shape
            spec = spec + (None,) * (len(shape) - len(spec))
            if _factored(shape, OptimizerSpec().factored_min):
                v[leaf] = {"vr": P(*spec[:-1]),
                           "vc": P(*(spec[:-2] + spec[-1:]))}
            else:
                v[leaf] = {"v": P(*spec)}
        return {"v": v, "step": P()}
    raise ValueError(opt_name)


def _tree_map(fn, spec_tree, tree):
    if is_spec(spec_tree):
        return fn(spec_tree, tree)
    return {k: _tree_map(fn, s, tree[k]) for k, s in spec_tree.items()}


def stand_in(ctx, shape_tree, spec_tree, device, make=torch.empty):
    """A DTensor a leaf of ``shape_tree`` (tensors, e.g. on ``meta``),
    laid out by ``spec_tree`` (sanitized for each shape), its local shard
    ``make(local_shape)`` on ``device`` (empty; ``torch.zeros`` for
    zeros); non-tensor leaves (a decode step's ``pos``) as they are."""
    def one(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return ctx.distribute(
            lambda local: make(local, dtype=leaf.dtype, device=device),
            tuple(leaf.shape), spec)
    return _tree_map(one, spec_tree, shape_tree)


def _local_slices(mesh, placements, shape) -> tuple:
    """This rank's slice of each dim of a tensor of global ``shape`` laid
    out by ``placements`` on ``mesh``, in even shards (as ``MeshCtx.fit``
    leaves them): each mesh dim that shards a tensor dim cuts what the
    mesh dims before it left of that dim, in mesh-dim order, as DTensor
    cuts it."""
    from torch.distributed.tensor import Shard
    start, size = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            size[p.dim] //= mesh.size(i)
            start[p.dim] += coord[i] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def shard(ctx, full, spec, device=None, *, rows=None):
    """``full`` (a tensor or a numpy array, whole and the same on every
    rank) as a DTensor laid out by ``spec`` (fitted to its shape): each
    rank copies out its own shard, to ``device``, with no collective
    (``place`` scatters from rank 0 instead).  With ``rows`` = n the
    tensor is ``full`` stacked n times (a trainer stack of one start),
    made without the stack."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.specs import _contiguous_strides
    shape = tuple(full.shape) if rows is None else (rows,) + tuple(full.shape)
    pl = ctx.placements(spec, shape)
    idx = _local_slices(ctx.mesh, pl, shape)
    if rows is None:
        local = torch.as_tensor(full[idx], device=device).clone()
    else:
        part = torch.as_tensor(full[idx[1:]], device=device)
        local = part.unsqueeze(0).expand(
            (idx[0].stop - idx[0].start,) + tuple(part.shape)).clone()
    return DTensor.from_local(local, ctx.mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def init_params_sharded(model, pspecs, seed: int = 0, *, rows=None):
    """``model.init_params(seed)``'s weights as DTensors laid out by
    ``pspecs`` (``Model.params_pspecs``; with ``rows`` = n each weight
    stacked n times, laid out by ``fl.round.trainerify_pspecs``' specs),
    whose local shards are this rank's alone: the constructor draws every
    leaf whole on the model's device, from the same generator with the
    same calls as ``init_params``, and each leaf, as it is registered, is
    cut to this rank's shard (``shard``) and the whole freed.  So the
    gathered weights (each row of the stack) equal ``init_params(seed)``
    bit for bit, and a rank's peak is its shards plus the leaves one
    constructor call draws together (one MoE expert stack,
    ``models.moe.moe_param_draws``).  The leaves' registration order is
    read from a ``meta`` build."""
    from torch import nn
    from torch.nn.modules.module import \
        register_module_parameter_registration_hook as on_register
    seen: list = []
    handle = on_register(lambda module, name, p: seen.append((module, name)))
    try:
        meta = model._mod.init_params_shape(model.cfg)
    finally:
        handle.remove()
    prefix = {m: f"{n}." if n else "" for n, m in meta.named_modules()}
    order = iter([prefix[m] + name for m, name in seen])
    out = {}

    def keep(module, name, p):
        k = next(order)
        out[k] = shard(model.ctx, p.detach(), pspecs[k], p.device,
                       rows=rows)
        return nn.Parameter(torch.empty(0, dtype=p.dtype, device=p.device),
                            requires_grad=False)
    handle = on_register(keep)
    try:
        model.init_params(seed)
    finally:
        handle.remove()
    return {k: out[k] for k, _ in meta.named_parameters()}


def place(ctx, tree, spec_tree):
    """Full tensors (on the mesh's device) laid out as DTensors by
    ``spec_tree`` (sanitized for each shape); non-tensor leaves as they
    are."""
    from torch.distributed.tensor import distribute_tensor

    def one(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, ctx.mesh, ctx.placements(spec, t.shape))
    return _tree_map(one, spec_tree, tree)


def build_cell(cfg, shape, mesh, *, device=None,
               stand_ins: bool = True) -> Cell:
    """The cell's step and stand-ins on ``mesh`` (``device``: the
    stand-ins' device, default the mesh's).  ``stand_ins=False`` leaves
    ``args`` None, for a run that places real tensors (``place``)."""
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer, spec_for_config
    dev = torch.device(device) if device is not None else mesh_device(mesh)
    model = build_model(cfg, dev, mesh=mesh)
    ctx = model.ctx
    pshape = model.params_shape()
    pspecs = model.params_pspecs(pshape)
    batch_shape = model.input_specs(shape)
    bspecs = model.input_pspecs(shape)

    if shape.kind == "train":
        groups = model.param_groups(pshape)
        opt = make_optimizer(spec_for_config(cfg), groups=groups)
        oshape = opt.init(pshape)
        ospecs = opt_state_pspecs(cfg.optimizer, pspecs, pshape, groups)
        specs = (pspecs, ospecs, bspecs)
        args = tuple(stand_in(ctx, t, s, dev)
                     for t, s in zip((pshape, oshape, batch_shape), specs)) \
            if stand_ins else None
        return Cell(build_train_step(model, opt), args, model, "train",
                    specs)

    if shape.kind == "prefill":
        def step(params, batch):
            return model.prefill(params, batch)
        specs = (pspecs, bspecs)
        args = tuple(stand_in(ctx, t, s, dev)
                     for t, s in zip((pshape, batch_shape), specs)) \
            if stand_ins else None
        return Cell(step, args, model, "prefill", specs)

    # decode: one token against a seq_len-deep cache
    sshape = model.decode_state_shape(shape.global_batch, shape.seq_len)
    sspecs = model.decode_state_pspecs(shape.global_batch, shape.seq_len)

    def step(params, state, batch):
        return model.decode(params, state, batch)
    specs = (pspecs, sspecs, bspecs)
    args = tuple(stand_in(ctx, t, s, dev)
                 for t, s in zip((pshape, sshape, batch_shape), specs)) \
        if stand_ins else None
    return Cell(step, args, model, "decode", specs)
