"""Reputation-weighted aggregation (paper Eq. 1): w_g = sum(s_i w_i) / sum(s_i).

Parameter trees are dicts of tensors; a stacked tree carries a leading
trainer axis on every leaf.  Eq. 1 always runs through the kernel
factory's ``weighted_agg`` op (the CUDA kernel on the card, its plain
version on the CPU), on the whole tree flattened to one ``(n, P)`` float32
tensor: one launch per round.  Leaves are taken in sorted key order, the
order the JAX package's pytrees flatten them in.

``weighted_average_tree_mega`` (the cross-task megastep) and
``weighted_psum_tree`` (the mesh path) are not ported yet (ROADMAP.md).
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


def tree_flat_stacked(tree: Tree) -> torch.Tensor:
    """(n, P) float32 for a tree whose leaves carry a leading trainer
    axis: the batched counterpart of ``tree_flat``."""
    return torch.cat([tree[k].reshape(tree[k].shape[0], -1).to(torch.float32)
                      for k in sorted(tree)], dim=1)


def tree_unflat(flat: torch.Tensor, like: Tree) -> Tree:
    """Inverse of ``tree_flat``: cut ``flat`` into ``like``'s leaf shapes
    and dtypes (``like``'s leaves may carry a leading axis; its shape
    after that axis is the leaf's)."""
    out, at = {}, 0
    for k in sorted(like):
        shape = like[k].shape[1:]
        size = shape.numel()
        out[k] = flat[at: at + size].reshape(shape).to(like[k].dtype)
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
