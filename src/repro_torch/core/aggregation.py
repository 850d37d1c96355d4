"""Reputation-weighted aggregation (paper Eq. 1): w_g = sum(s_i w_i) / sum(s_i).

Parameter trees are dicts of tensors; a stacked tree carries a leading
trainer axis on every leaf.  Eq. 1 always runs through the kernel
factory's ``weighted_agg`` op (the CUDA kernel on the card, its plain
version on the CPU), on the whole tree flattened to one ``(n, P)`` float32
tensor: one launch per round.  Leaves are taken in sorted key order, the
order the JAX package's pytrees flatten them in.

``weighted_average_tree_mega`` is the cross-task megastep's form: T
stacked trees merged in one task-axis ``weighted_agg`` launch, row t equal
to ``weighted_average_tree`` on task t alone.  ``weighted_psum_tree`` is
the mesh path's form (``fl/round.build_fl_round_cell``): each data-axis
group holds one trainer's weights, and the merge is all-reduces over
those groups, as the JAX package's ``weighted_psum_tree`` does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.factory import get_kernel

Tree = Dict[str, torch.Tensor]


def tree_flat(tree: Tree) -> torch.Tensor:
    """(P,) float32: every leaf flattened, in sorted key order."""
    return torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in sorted(tree)])


def tree_flat_stacked(tree: Tree, lead: int = 1) -> torch.Tensor:
    """(n, P) float32 for a tree whose leaves carry a leading trainer
    axis: the batched counterpart of ``tree_flat``; ``lead`` leading axes
    in general (2: a (T, n, P) flat of T stacked trees)."""
    return torch.cat([tree[k].reshape(tree[k].shape[:lead] + (-1,)).to(
        torch.float32) for k in sorted(tree)], dim=lead)


def tree_unflat(flat: torch.Tensor, like: Tree, lead: int = 1) -> Tree:
    """Inverse of ``tree_flat``: cut the last axis of ``flat`` into
    ``like``'s leaf shapes and dtypes, where ``like``'s leaves carry
    ``lead`` leading axes before the leaf's own shape.  ``flat`` may carry
    leading axes of its own (a ``(T, P)`` flat gives ``(T, ...)`` leaves)."""
    out, at = {}, 0
    for k in sorted(like):
        shape = like[k].shape[lead:]
        size = shape.numel()
        out[k] = flat[..., at: at + size].reshape(
            flat.shape[:-1] + shape).to(like[k].dtype)
        at += size
    return out


def weighted_average_flat(stacked: torch.Tensor,
                          scores: torch.Tensor) -> torch.Tensor:
    """stacked: (n, P) trainer weights; scores: (n,) -> (P,)."""
    return get_kernel("weighted_agg")(stacked, scores)


def weighted_average_tree(stacked_tree: Tree, scores: torch.Tensor) -> Tree:
    """Eq. 1 over a stacked tree, as one ``weighted_agg`` launch on the
    flattened tree.  The JAX package's jitted twin,
    ``weighted_average_tree_jit``, is this same function here."""
    flat = weighted_average_flat(tree_flat_stacked(stacked_tree), scores)
    return tree_unflat(flat, stacked_tree)


weighted_average_tree_jit = weighted_average_tree


def weighted_average_tree_mega(stacked_trees: Tree, scores: torch.Tensor,
                               flat: torch.Tensor | None = None) -> Tree:
    """T Eq. 1 merges in one ``weighted_agg`` launch: leaves carry
    ``(T, n, ...)`` and ``scores`` is ``(T, n)``; returns leaves
    ``(T, ...)``.  Row t is bit-identical to ``weighted_average_tree`` on
    task t alone (each task's sums keep the unbatched order).  ``flat``:
    the trees' ``tree_flat_stacked(..., lead=2)``, where the caller has it
    already."""
    if flat is None:
        flat = tree_flat_stacked(stacked_trees, lead=2)
    return tree_unflat(weighted_average_flat(flat, scores), stacked_trees,
                       lead=2)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over every rank of ``group`` (a process group, or
    several, reduced one after another)."""
    from torch.distributed import _functional_collectives as funcol
    groups = tuple(group) if isinstance(group, (tuple, list)) else (group,)
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g))
    return t


def weighted_psum_tree(local_tree: Tree, score: torch.Tensor,
                       group) -> Tree:
    """Mesh path of Eq. 1: ``local_tree`` is this rank's shards of its
    trainer's weights, ``score`` that trainer's score (a 0-d tensor),
    ``group`` the process group(s) whose ranks hold the other trainers
    (the DP axes).  Returns sum(s·w) / max(sum(s), 1e-12): float32
    all-reduces of ``x·s`` and of ``s``, cast back to each leaf's dtype;
    the same on every rank of the group (the rollup's commit)."""
    s = score.to(torch.float32)
    denom = torch.clamp(_all_reduce(s, group), min=1e-12)
    return {k: (_all_reduce(x.to(torch.float32) * s, group) / denom).to(
        x.dtype) for k, x in local_tree.items()}


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {k: a[k] - b[k] for k in a}


def tree_add(a: Tree, b: Tree) -> Tree:
    return {k: a[k] + b[k] for k in a}
