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
PyTorch, not the ``rollup_digest`` kernel.  ``trainerify_pspecs``, ``stack_shape`` and
``build_fl_round_cell`` serve the JAX package's mesh and dry-run
(ROADMAP.md queue 1 item 10(f)).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.kernels.factory import get_kernel
from repro_torch.kernels.rollup_digest import MASK, MIX_SEED, mix_u32
from repro_torch.launch.steps import value_and_grad
from repro_torch.optim.compression import dequantize_int8, quantize_int8

Tree = Dict[str, torch.Tensor]


class FLRoundSpec(NamedTuple):
    n_trainers: int         # the mesh's data axis (1 on one card)
    h_local_steps: int = 8
    local_batch: int = 16
    # commit payload compression: "none" | "int8" (per-block-quantized
    # deltas against the round's start)
    commit_compression: str = "none"


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
    acc = torch.tensor(MIX_SEED, dtype=torch.int64, device=leaves[0].device)
    for leaf in leaves:
        bits = leaf.to(torch.float32).reshape(-1).view(torch.int32).to(
            torch.int64) & MASK
        acc = (acc + mix_u32(bits).sum()) & MASK
    return acc


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
