"""Mixture-of-Experts FFN: top-k routing and capacity-based dispatch, with
the expert products through the factory's ``gmm`` op (the CUDA kernel on
the card), in the JAX package's layouts and casts.

  * Router logits in float32 (the router is float32 in every model
    dtype), softmax, top-k, the k weights renormalised.
  * Dispatch per batch row (``build_dispatch``): each (token, expert) pair
    takes the next slot of its expert's queue, in token order; pairs past
    the capacity are dropped.  Empty slots point at token 0 with weight 0.
  * The gathered tokens are laid out ``(E, B·C, d)`` directly, the batch
    folded into C, so each expert product is ONE ``gmm`` launch: three per
    MoE layer.
  * ``silu(h) * u`` and ``ye * slot_w`` in the model dtype; the combine
    adds in the model dtype, as the JAX package's scatter-add does, in a
    fixed order (``combine``): each token's slot rows in ascending expert
    order, one add per rank from zeros, the order in which a serial
    scatter-add over the (expert, slot) table meets them.  No atomics, so
    the card gives one answer every run.

The whole FFN is one ``ctx.local`` region (``sharding.specs.MeshCtx``;
with the default ``NO_MESH``, every row and expert).  Under a mesh it is
the JAX package's expert parallelism: each rank routes its batch rows over
every expert (the router replicated), gathers and multiplies only the
slots of its own experts (``moe_wg``, ``moe_wu``, ``moe_wo`` over the EP
axis, ``model``), and combines them into a partial sum over that axis,
which the residual's constraint reduces (one reduction a layer, in the
model dtype, as the JAX package keeps the payload).  The decode step's
form (``moe_ffn_single``) routes the whole decode batch as one row, as
the JAX package does, so its region takes every row.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.factory import get_kernel
from repro_torch.models.layers import dense_init
from repro_torch.sharding.specs import NO_MESH, P


def moe_param_draws(cfg, dtype: torch.dtype,
                    generator: torch.Generator | None, device):
    """``init_moe_params``' (name, tensor) pairs, each drawn only when it
    is asked for: a caller that keeps a shard of each (the launchers'
    sharded init, ``launch.steps.init_params_sharded``) holds one expert
    stack whole at a time."""
    m = cfg.moe
    d, ff, E = cfg.d_model, m.expert_d_ff, m.n_experts
    yield "router", dense_init((d, E), torch.float32, generator, device)
    yield "moe_wg", dense_init((E, d, ff), dtype, generator, device)
    yield "moe_wu", dense_init((E, d, ff), dtype, generator, device)
    yield "moe_wo", dense_init((E, ff, d), dtype, generator, device)


def init_moe_params(cfg, dtype: torch.dtype,
                    generator: torch.Generator | None,
                    device) -> Dict[str, torch.Tensor]:
    """``router`` (d, E) float32; ``moe_wg``, ``moe_wu`` (E, d, ff) and
    ``moe_wo`` (E, ff, d) in ``dtype`` (uninitialised with no
    generator)."""
    return dict(moe_param_draws(cfg, dtype, generator, device))


def capacity(cfg, seq_len: int) -> int:
    m = cfg.moe
    c = int(seq_len * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def route_topk(router_logits: torch.Tensor, top_k: int):
    """router_logits (..., E) -> (weights (..., k) float32, idx (..., k)
    int64)."""
    gates = torch.softmax(router_logits.to(torch.float32), dim=-1)
    w, idx = torch.topk(gates, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx


def build_dispatch(idx: torch.Tensor, w: torch.Tensor, n_experts: int,
                   cap: int):
    """Per-row dispatch tables, every row of the batch at once.

    idx, w: (B, S, k).  Returns (slot_token (B, E, C) int64 token ids,
    slot_weight (B, E, C) float32): the JAX ``build_dispatch`` on each
    row.  A pair's slot is its rank in its expert's queue (a stable sort
    by expert keeps token order); pairs at rank >= cap go to one dummy
    slot past the table, which is cut off."""
    slot_token, slot_w, _ = _dispatch(idx, w, n_experts, cap)
    return slot_token, slot_w


def _dispatch(idx: torch.Tensor, w: torch.Tensor, n_experts: int, cap: int):
    """``build_dispatch``'s tables and, per pair (B, S, k), its row in the
    expert products' (E, B, C) layout, ``(expert * B + b) * cap + rank``,
    or ``n_experts * B * cap`` (past the rows) where it was dropped."""
    B, S, k = idx.shape
    dev = idx.device
    flat_expert = idx.reshape(B, S * k)
    flat_token = torch.arange(S, device=dev).repeat_interleave(k)
    flat_w = w.reshape(B, S * k).to(torch.float32)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    sorted_expert = flat_expert.gather(1, order)
    sorted_token = flat_token[order]
    sorted_w = flat_w.gather(1, order)
    positions = torch.arange(S * k, device=dev).expand(B, S * k)
    seg_start = torch.full((B, n_experts), S * k, dtype=torch.int64,
                           device=dev).scatter_reduce(
        1, sorted_expert, positions, "amin")
    rank = positions - seg_start.gather(1, sorted_expert)
    keep = rank < cap
    dummy = n_experts * cap
    slot = torch.where(keep, sorted_expert * cap + rank, dummy)
    slot_token = torch.zeros(B, dummy + 1, dtype=torch.int64,
                             device=dev).scatter(1, slot, sorted_token)
    slot_w = torch.zeros(B, dummy + 1, dtype=torch.float32,
                         device=dev).scatter(
        1, slot, torch.where(keep, sorted_w, 0.0))
    row = torch.where(keep, (sorted_expert * B + torch.arange(
        B, device=dev)[:, None]) * cap + rank, dummy * B)
    pair_row = torch.empty_like(row).scatter_(1, order, row)
    return (slot_token[:, :-1].reshape(B, n_experts, cap),
            slot_w[:, :-1].reshape(B, n_experts, cap),
            pair_row.reshape(B, S, k))


def combine(table: torch.Tensor, pair_row: torch.Tensor) -> torch.Tensor:
    """The expert outputs back at their tokens, in a fixed order.

    table: (E·B·C + 1, d), the weighted slot rows in the (E, B, C) layout
    and a zero row last; pair_row: (B, S, k) from ``_dispatch``.  Returns
    (B, S, d) in the table's dtype: per token, from zeros, its kept slot
    rows added one at a time in ascending expert order (dropped pairs read
    the zero row, last), each add rounded to the dtype.  A serial
    scatter-add of the (expert, slot) table adds a token's rows in that
    order, with zero rows for the empty slots, which change no sum."""
    B, S, k = pair_row.shape
    rows = pair_row.sort(dim=-1).values                 # by expert, then b
    picked = table.index_select(0, rows.reshape(-1)).reshape(B, S, k, -1)
    y = torch.zeros_like(picked[:, :, 0])
    for r in range(k):
        y = y + picked[:, :, r]
    return y


def _experts(cfg, p, x: torch.Tensor, e0: int = 0) -> torch.Tensor:
    """The FFN on x (B, S, d) with the experts ``e0 .. e0 + E_l - 1`` that
    ``p``'s expert weights hold (E_l of them: every expert where e0 = 0
    and E_l = E): the routing over every expert, the products and the
    combine over those; a token's other slots add nothing."""
    m = cfg.moe
    B, S, d = x.shape
    E, cap = m.n_experts, capacity(cfg, S)
    El = p["moe_wg"].shape[0]
    logits = x.to(torch.float32) @ p["router"]
    w, idx = route_topk(logits, m.top_k)                        # (B, S, k)
    slot_token, slot_w, pair_row = _dispatch(idx, w, E, cap)    # (B, E, C)

    # rows of x in (E, B, C) order: xe is (E_l, B·C, d) with no permute
    rows = (slot_token + torch.arange(B, device=x.device)[:, None, None] * S
            ).transpose(0, 1)[e0:e0 + El].reshape(-1)
    xe = x.reshape(B * S, d).index_select(0, rows).reshape(El, B * cap, d)
    gmm = get_kernel("gmm")
    h = F.silu(gmm(xe, p["moe_wg"])) * gmm(xe, p["moe_wu"])
    ye = gmm(h, p["moe_wo"])                                    # (E_l, B·C, d)
    ye = ye * slot_w.transpose(0, 1)[e0:e0 + El].reshape(
        El, B * cap, 1).to(ye.dtype)
    if El != E:         # the other experts' slots: the zero row, last
        n = El * B * cap
        pair_row = pair_row - e0 * B * cap
        pair_row = torch.where((pair_row >= 0) & (pair_row < n), pair_row, n)
    # the weighted slot rows, and a zero row for the dropped pairs
    return combine(torch.cat([ye.reshape(-1, d), ye.new_zeros(1, d)]),
                   pair_row)


def _expert_shards(cfg, ctx, p, x: torch.Tensor, rows_spec: P):
    """``_experts`` over each rank's rows (``rows_spec``, (B, S, d)) and
    experts (over the EP axis where E divides evenly): partial sums over
    that axis."""
    ep = ctx.fit(P(ctx.ep_axis), (cfg.moe.n_experts,))[0]
    w = P(ep, None, None)

    def fn(x, router, wg, wu, wo):
        e0 = ctx.rank(ep) * wg.shape[0] if ep is not None else 0
        return _experts(cfg, {"router": router, "moe_wg": wg, "moe_wu": wu,
                              "moe_wo": wo}, x, e0)

    return ctx.local(fn, (rows_spec, P(None, None), w, w, w), rows_spec,
                     out_partial=(ep,) if ep is not None else ())(
        x, p["router"], p["moe_wg"], p["moe_wu"], p["moe_wo"])


def moe_ffn(cfg, p, x: torch.Tensor, ctx=NO_MESH) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    rows = ctx.fit(P(ctx.dp_axes or None, None, None), (B, S, 1))
    return ctx.act_btd(_expert_shards(cfg, ctx, p, x, rows))


def moe_ffn_single(cfg, p, x: torch.Tensor, ctx=NO_MESH) -> torch.Tensor:
    """Decode-time MoE for (B, 1, d): the batch is the token row, (1, B,
    d), so the weights are read once for the whole decode batch."""
    B = x.shape[0]
    y = _expert_shards(cfg, ctx, p, x.reshape(1, B, -1), P(None, None, None))
    return y.reshape(B, 1, -1)
