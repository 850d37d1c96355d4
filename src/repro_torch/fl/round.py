"""The rollup round on the model substrate, as the JAX package's
``fl/round.py`` runs it on its mesh: T trainers each take H local
optimizer steps ("off-chain"), then ONE reputation-weighted merge (Eq. 1),
ONE distance pass (Eq. 4) and a digest commit the round, and every
trainer restarts from the merged weights.

Layout: ``params_T`` is a flat dict of weights (``Model.train_params``)
whose leaves carry a leading trainer axis T, and so is every leaf of
``opt_T``.  One card runs the trainers in turn (a ctypes kernel launch
cannot be vmapped): trainer t's H steps run on views of row t, and its
new weights are written into row t of one (T, P) stack (P = the weights'
count, leaves in sorted key order, in the weights' dtype; float32 where
the leaves' dtypes differ).  Eq. 1 is one ``weighted_agg`` launch on that
stack, Eq. 4 one ``model_distance`` launch of it against the merged
weights: the kernels' functions are exactly the JAX round's (sum s·w /
max(Σs, 1e-12) accumulated in float32, cast to the leaf's dtype; the L2
norm over all leaves in float32).  The stack's index runs to T·P, past
2^31 at full width (630M weights, T = 4); the FL kernels take int64 sizes
and strides and index in int64 (``csrc/fl.cu``).

``commit_compression="int8"``: each trainer contributes its delta against
the round's start, quantized per leaf in blocks of 256
(``optim/compression.py``); Eq. 1 merges the dequantized deltas, a
(T, P) float32 stack, and the merged weights are the start plus that.

``replicate`` gives a start (weights or optimizer state) its trainer
axis.  ``digest_tree`` is the JAX package's stand-in digest: the
wraparound SUM of the xor-mixed float32 words of every leaf, not an xor
(ROADMAP.md §3, a reference caveat), in int64 masked to 32 bits; plain
PyTorch, not the ``rollup_digest`` kernel.

The mesh form (``build_fl_round_cell``) is the JAX package's: the
trainers are the mesh's data (x pod) groups.  ``params_T`` and ``opt_T``
are DTensors whose trainer axis lies over those axes
(``trainerify_pspecs``), so each group holds one trainer's replica,
sharded within the group over ``model``.  The replica takes its H local
steps with the group's own batches (a ``MeshCtx`` with no DP axes: no op
of a local step crosses the data axes); the commit is one
``weighted_psum_tree`` over the DP axes (float32 all-reduces of s·w and
of s, not the ``weighted_agg`` kernel); Eq. 4 is computed on each rank's
shards and summed over ``model``, and the T distances lie over the DP
axes as the JAX round's ``P(dp)`` output does; the digest is the sum mod
2^32 of every rank's mixed words (a sum, so the words' positions do not
matter), summed over ``model``, with the seed added once.  ``stack_shape``
gives a tree of ``meta`` tensors its trainer axis.  ``init_params_T``
draws a trainer stack's weights leaf by leaf, each rank keeping only its
own row's shards.  The trainers-in-turn ``build_fl_round`` above stays
the one-card form.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.kernels.factory import get_kernel
from repro_torch.kernels.rollup_digest import MASK, MIX_SEED, mix_u32
from repro_torch.launch.steps import init_params_sharded, value_and_grad
from repro_torch.optim.compression import dequantize_int8, quantize_int8
from repro_torch.sharding.specs import P, is_spec

Tree = Dict[str, torch.Tensor]


class FLRoundSpec(NamedTuple):
    n_trainers: int         # the mesh's data axis (1 on one card)
    h_local_steps: int = 8
    local_batch: int = 16
    # commit payload compression: "none" | "int8" (per-block-quantized
    # deltas against the round's start)
    commit_compression: str = "none"


def _mixed_sum(leaves, device=None) -> torch.Tensor:
    """Sum mod 2^32 of every float32 word's xor-mix, as an int64 0-d
    tensor on ``device`` (default the first leaf's; 0 for no leaves)."""
    acc = torch.zeros((), dtype=torch.int64,
                      device=device if device is not None
                      else leaves[0].device)
    for leaf in leaves:
        bits = leaf.to(torch.float32).reshape(-1).view(torch.int32).to(
            torch.int64) & MASK
        acc = (acc + mix_u32(bits).sum()) & MASK
    return acc


def digest_tree(tree) -> torch.Tensor:
    """The u32 digest of every leaf (nested dicts too) as an int64 0-d
    tensor: ``DIGEST_SEED`` plus, mod 2^32, each float32 word's xor-mix
    ``(w ^ (w >> 16)) * 0x85EBCA6B``.  A sum, so the leaves' order does
    not matter."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            leaves.append(node)
    walk(tree)
    return (_mixed_sum(leaves) + MIX_SEED) & MASK


def replicate(tree, n: int):
    """Every leaf (nested dicts too) given a leading trainer axis of n
    copies: expanded views, which the round only reads."""
    if isinstance(tree, dict):
        return {k: replicate(v, n) for k, v in tree.items()}
    return tree.expand((n,) + tree.shape)


def _row(tree: Tree, t: int) -> Tree:
    return {k: v[t] for k, v in tree.items()}


def _opt_row(state, t: int):
    if isinstance(state, dict):
        return {k: _opt_row(v, t) for k, v in state.items()}
    return state[t]


def _opt_stack(states: list):
    if isinstance(states[0], dict):
        return {k: _opt_stack([s[k] for s in states]) for k in states[0]}
    return torch.stack(states)


def _flat_dtype(tree: Tree) -> torch.dtype:
    dtypes = {v.dtype for v in tree.values()}
    return dtypes.pop() if len(dtypes) == 1 else torch.float32


def _unflat(flat: torch.Tensor, like: Tree) -> Tree:
    """(…, P) cut into ``like``'s (per-trainer) leaf shapes and dtypes."""
    out, at = {}, 0
    for k in sorted(like):
        shape = like[k].shape
        n = shape.numel()
        out[k] = flat[..., at: at + n].reshape(flat.shape[:-1] + shape).to(
            like[k].dtype)
        at += n
    return out


def build_fl_round(model, opt, spec: FLRoundSpec):
    """Returns ``fl_round(params_T, opt_T, scores, batches) -> (params_T,
    opt_T, metrics)``.

    params_T, opt_T: leaves (T, ...) (see the module docstring).
    batches: ``{"tokens", "labels": (T, H, local_B, S)}`` int tensors.
    scores: (T,) trainer reputation scores.
    metrics: ``{"loss": mean local loss, "distances": (T,) Eq. 4,
    "digest": digest_tree of the merged weights}``.
    """
    def local_steps(params: Tree, opt_state, trainer_batch):
        """H sequential local optimizer steps for ONE trainer."""
        losses = []
        for h in range(trainer_batch["tokens"].shape[0]):
            batch = {k: v[h] for k, v in trainer_batch.items()}
            loss, grads = value_and_grad(model, params, batch)
            params, opt_state, _ = opt.update(grads, opt_state, params)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean()

    def fl_round(params_T: Tree, opt_T, scores: torch.Tensor, batches):
        T = next(iter(params_T.values())).shape[0]
        like = _row(params_T, 0)
        P = sum(v.numel() for v in like.values())
        dev = like[next(iter(like))].device
        flat_dtype = _flat_dtype(like)
        stack = torch.empty(T, P, dtype=flat_dtype, device=dev)
        # ---- off-chain: H local steps, one trainer at a time --------------
        states, losses = [], []
        for t in range(T):
            p_t, o_t, loss_t = local_steps(
                _row(params_T, t), _opt_row(opt_T, t),
                {k: v[t] for k, v in batches.items()})
            at = 0
            for k in sorted(p_t):
                n = p_t[k].numel()
                stack[t, at: at + n] = p_t[k].reshape(-1)
                at += n
            states.append(o_t)
            losses.append(loss_t)
            del p_t
        new_T = _unflat(stack, like)
        s = scores.to(device=dev, dtype=torch.float32)
        # ---- commit: Eq. 1, one weighted_agg launch -----------------------
        if spec.commit_compression == "int8":
            deq = torch.empty(T, P, dtype=torch.float32, device=dev)
            at = 0
            for k in sorted(like):
                n = like[k].numel()
                for t in range(T):
                    delta = (new_T[k][t].to(torch.float32)
                             - params_T[k][t].to(torch.float32)).reshape(-1)
                    q, scale = quantize_int8(delta)
                    deq[t, at: at + n] = dequantize_int8(q, scale, (n,))
                at += n
            md = _unflat(get_kernel("weighted_agg")(deq, s), {
                k: v.to(torch.float32) for k, v in like.items()})
            merged = {k: (params_T[k][0].to(torch.float32) + md[k]).to(
                like[k].dtype) for k in like}
        elif spec.commit_compression == "none":
            merged = _unflat(get_kernel("weighted_agg")(stack, s), like)
        else:
            raise ValueError(f"commit_compression "
                             f"{spec.commit_compression!r}")
        # ---- prove: Eq. 4, one model_distance launch, and the digest ------
        merged_flat = torch.cat([merged[k].reshape(-1).to(flat_dtype)
                                 for k in sorted(merged)])
        distances = get_kernel("model_distance")(stack, merged_flat)
        digest = digest_tree(merged)
        # ---- execute: every trainer restarts from the merged weights ------
        params_T = {k: v.expand((T,) + v.shape) for k, v in merged.items()}
        metrics = {"loss": torch.stack(losses).mean(),
                   "distances": distances, "digest": digest}
        return params_T, _opt_stack(states), metrics

    return fl_round


# -----------------------------------------------------------------------------
# The mesh form (the JAX package's build_fl_round_cell)
# -----------------------------------------------------------------------------
def trainerify_pspecs(pspecs, dp_axes=("data",)):
    """Prepend the trainer (dp-sharded) dim to every spec.

    The dp axes now carry the trainer dim, so they are stripped from the
    inner per-weight specs (the weights within one trainer shard over TP
    only)."""
    drop = set(dp_axes)

    def strip(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a not in drop)
            return kept if kept else None
        return None if entry in drop else entry

    def one(s):
        if is_spec(s):
            return P(tuple(dp_axes), *(strip(e) for e in s))
        return {k: one(v) for k, v in s.items()}
    return one(pspecs)


def stack_shape(tree, n: int):
    """A tree of tensors (``meta`` ones: shapes and dtypes) with a leading
    axis of n on every leaf, as ``meta`` tensors."""
    if isinstance(tree, dict):
        return {k: stack_shape(v, n) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                       device="meta")


def init_params_T(model, pspecs_T, n: int, seed: int = 0) -> Tree:
    """``model.init_params(seed)``'s weights stacked n times, as DTensors
    laid out by ``pspecs_T`` (``trainerify_pspecs``), whose local shards
    are this rank's alone (``launch.steps.init_params_sharded`` with
    ``rows`` = n): the gathered stack's rows equal ``init_params(seed)``
    bit for bit."""
    return init_params_sharded(model, pspecs_T, seed, rows=n)


def _shift(p):
    """A placement of a trainer-stacked dim's neighbour, for one row."""
    from torch.distributed.tensor import Shard
    return Shard(p.dim - 1) if isinstance(p, Shard) else p


def _to_trainer(t, sub, rest):
    """This rank's row of a trainer-stacked DTensor (T over the DP
    axes): a DTensor on the trainer's sub-mesh ``sub`` (its ``rest``
    mesh dims), each dim as it lay there; the local tensor where the
    trainer has the card to itself (``sub`` None)."""
    from torch.distributed.tensor import DTensor
    local = t.to_local()[0]
    if sub is None:
        return local
    return DTensor.from_local(local, sub,
                              tuple(_shift(t.placements[i]) for i in rest),
                              run_check=False)


def _from_trainer(x, like, sub, rest):
    """The inverse of ``_to_trainer``: the trainer's ``x`` (laid out
    again as ``like``'s row) as this rank's row of a stack laid out as
    ``like``."""
    from torch.distributed.tensor import DTensor
    if sub is not None:
        x = x.redistribute(sub, tuple(_shift(like.placements[i])
                                      for i in rest)).to_local()
    return DTensor.from_local(x[None], like.device_mesh, like.placements,
                              run_check=False)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def build_fl_round_cell(model, opt, spec: FLRoundSpec, mesh, seq_len: int,
                        trainer_axes=None, device=None,
                        stand_ins: bool = True):
    """The mesh round's cell: ``Cell(step, args, model, "fl_round",
    specs)`` (``launch/steps.Cell``), its step ``fl_round(params_T, opt_T,
    scores, batches) -> (params_T, opt_T, metrics)`` over DTensors laid
    out by ``specs`` and ``args`` their stand-ins (``stand_in``; None with
    ``stand_ins=False``, for a run that lays out real tensors).

    ``model`` gives the config and the weights' specs (a ``Model`` on
    ``mesh``); ``opt`` is made with its ``param_groups``.
    ``trainer_axes``: the mesh axes carrying the trainer dim, default the
    DP axes (TP within a trainer); all the mesh's axes for the paper's
    pure-DP regime (one trainer a card, its weights whole on it, and the
    commit the round's only collective)."""
    import dataclasses

    from repro_torch.core.aggregation import weighted_psum_tree
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.launch.steps import (Cell, build_train_step,
                                          opt_state_pspecs, stand_in)
    from repro_torch.models.model import Model
    from repro_torch.sharding.specs import MeshCtx
    cfg = model.cfg
    dev = torch.device(device) if device is not None else mesh_device(mesh)
    dp = tuple(trainer_axes or model.ctx.dp_axes or ("data",))
    ctx = model.ctx
    T = 1
    for a in dp:
        T *= ctx.sizes[a]
    H, B = spec.h_local_steps, spec.local_batch
    pshape = model.params_shape()
    pspecs = model.params_pspecs(pshape)
    groups = model.param_groups(pshape)
    pspecs_T = trainerify_pspecs(pspecs, dp)
    oshape = opt.init(pshape)
    ospecs_T = trainerify_pspecs(
        opt_state_pspecs(cfg.optimizer, pspecs, pshape, groups), dp)
    batches = {k: torch.empty((T, H, B, seq_len), dtype=torch.int32,
                              device="meta") for k in ("tokens", "labels")}
    b_spec = {k: P(dp, None, None, None) for k in batches}
    specs = (pspecs_T, ospecs_T, P(dp), b_spec)
    args = (stand_in(ctx, stack_shape(pshape, T), pspecs_T, dev),
            stand_in(ctx, stack_shape(oshape, T), ospecs_T, dev),
            stand_in(ctx, torch.empty((T,), device="meta"), P(dp), dev),
            stand_in(ctx, batches, b_spec, dev)) if stand_ins else None

    # a trainer's model, on its sub-mesh (the axes the trainers do not
    # take; none in the pure-DP regime): no DP axes and no FSDP
    names = tuple(ctx.sizes)
    rest = tuple(i for i, a in enumerate(names) if a not in dp)
    sub = mesh[tuple(names[i] for i in rest)] if rest else None
    local_model = Model(cfg, dev, mesh=sub)
    if sub is not None:
        local_model.ctx = MeshCtx(sub, dataclasses.replace(cfg.sharding,
                                                           fsdp=False),
                                  dp_axes=())
    train_step = build_train_step(local_model, opt)
    dp_groups = tuple(ctx.group(a) for a in dp)
    rest_groups = tuple(ctx.group(names[i]) for i in rest)

    def over_rest(t):
        from repro_torch.core.aggregation import _all_reduce
        return _all_reduce(t, rest_groups) if rest_groups else t

    def owned(x) -> bool:
        """Whether this rank counts its shard of trainer weight ``x`` in
        a sum over the sub-mesh: a shard replicated over an axis counts
        on that axis's first rank only."""
        if sub is None:
            return True
        from torch.distributed.tensor import Replicate
        return all(sub.get_local_rank(a) == 0 for a, p in zip(
            sub.mesh_dim_names, x.placements) if isinstance(p, Replicate))

    def fl_round(params_T, opt_T, scores, batches):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        params = {k: _to_trainer(v, sub, rest) for k, v in params_T.items()}
        state = _map(lambda t: _to_trainer(t, sub, rest), opt_T)
        start = {k: v.to_local() if sub is not None else v
                 for k, v in params.items()}
        tok = {k: v.to_local()[0] for k, v in batches.items()}
        # ---- off-chain: this group's trainer, H local steps --------------
        losses = []
        for h in range(H):
            batch = {k: v[h] if sub is None else DTensor.from_local(
                v[h], sub, (Replicate(),) * sub.ndim, run_check=False)
                for k, v in tok.items()}
            params, state, m = train_step(params, state, batch)
            loss = m["loss"]
            losses.append(loss if sub is None else loss.to_local())
        # ---- commit: Eq. 1, all-reduces over the DP axes -----------------
        s = scores.to_local()[0].to(torch.float32)
        if sub is not None:
            params = {k: v.redistribute(sub, tuple(
                _shift(params_T[k].placements[i]) for i in rest))
                for k, v in params.items()}
        local = {k: v.to_local() if sub is not None else v
                 for k, v in params.items()}
        if spec.commit_compression == "int8":
            from repro_torch.core.aggregation import tree_add
            deltas = {}
            for k, v in local.items():
                delta = (v.to(torch.float32)
                         - start[k].to(torch.float32)).reshape(-1)
                q, scale = quantize_int8(delta)
                deltas[k] = dequantize_int8(q, scale, delta.shape).reshape(
                    v.shape)
            md = weighted_psum_tree(deltas, s, dp_groups)
            merged = {k: v.to(local[k].dtype) for k, v in tree_add(
                {k: t.to(torch.float32) for k, t in start.items()},
                md).items()}
        elif spec.commit_compression == "none":
            merged = weighted_psum_tree(local, s, dp_groups)
        else:
            raise ValueError(f"commit_compression "
                             f"{spec.commit_compression!r}")
        # ---- prove: Eq. 4 on this rank's shards, and the digest ----------
        mine = [k for k in sorted(local) if owned(params[k])]
        d2 = sum(((local[k].to(torch.float32)
                   - merged[k].to(torch.float32)) ** 2).sum() for k in mine)
        dist = torch.sqrt(over_rest(torch.as_tensor(
            d2, dtype=torch.float32, device=dev)))
        digest = (over_rest(_mixed_sum([merged[k] for k in mine], dev))
                  + MIX_SEED) & MASK
        # ---- execute: every trainer restarts from the merged weights -----
        new_T = {k: DTensor.from_local(merged[k][None], mesh,
                                       params_T[k].placements,
                                       run_check=False) for k in merged}
        opt_out = _map(lambda x, like: _from_trainer(x, like, sub, rest),
                       state, opt_T)
        dp_pl = tuple(Shard(0) if a in dp else Replicate() for a in names)
        loss_T = DTensor.from_local(torch.stack(losses).mean().reshape(1),
                                    mesh, dp_pl, run_check=False)
        metrics = {"loss": loss_T.mean(),
                   "distances": DTensor.from_local(
                       dist.reshape(1), mesh, dp_pl, run_check=False),
                   "digest": digest}
        return new_T, opt_out, metrics

    return Cell(fl_round, args, local_model, "fl_round", specs)
