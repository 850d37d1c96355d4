"""Grouped-query attention of the decoder LMs: the prefill path and the
KV-cache decode path, with the JAX package's layouts and casts; and
whisper's encoder (bidirectional) and cross attention.

  * Prefill (``attention_block``): projections, optional QKV bias and QK
    norm, RoPE (or M-RoPE on (3, B, S) positions), then the factory's
    ``flash_attention`` op (the CUDA kernel on the card) for every
    sequence length, and the output projection.
    The JAX package takes a dense path up to ``2 * chunk`` tokens and a
    blocked one beyond; both compute this same function.
  * Decode (``decode_attention_block``): one new token against a
    ``(B, S_max, Hkv, dh)`` cache, in float32, with the query heads grouped
    by kv head, so the cache is not broadcast over the group.  The cache is
    updated in place (the JAX serve loop donates it).

  * Whisper (``bidir_attention_block``, ``cross_attention_block``,
    ``encode_cross_kv``): the encoder's self attention, unmasked and with
    no RoPE, and the decoder's cross attention, its queries the decoder's
    tokens (Sq) and its keys and values the encoder output's projections
    (Skv = the encoder's frames, cached in the decode state), both through
    the factory's ``flash_attention`` op with ``causal=False``: the
    training forward, the prefill and the decode step's Sq = 1.

The per-layer parameters ``p`` are a mapping of tensors (``wq``, ``wk``,
``wv``, ``wo``; ``bq``, ``bk``, ``bv`` with ``qkv_bias`` and not for cross
attention; ``q_norm``, ``k_norm`` with ``qk_norm``).

Each block takes a ``ctx`` (``sharding.specs.MeshCtx``; the default
``NO_MESH`` is one device, where the constraints are no-ops and each
``ctx.local`` region runs on the whole tensors).  Under a mesh the
weights and activations are DTensors.  The projections and norms run as
DTensor ops; the query heads are constrained over ``model``
(``act_heads``, the JAX package's constraint; the keys and values too
where the residual stream is sequence-parallel), and RoPE and the
``flash_attention`` kernel run in a ``ctx.local`` region on each rank's
shard: its batch rows, its query heads (over ``model`` where they divide
evenly) and the kv heads those read (``_local_kv``).  The decode step's
region writes the token into the rank's part of the cache, whose seq dim
lies over ``model`` (KV-SP), and combines the ranks' softmax pieces by
all-reduces of their maxima, sums and outputs over ``model``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from repro_torch.kernels.factory import get_kernel
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       rms_norm)
from repro_torch.sharding.specs import NO_MESH, P

NEG_INF = -1e30


def init_attn_params(cfg, dtype: torch.dtype,
                     generator: torch.Generator | None,
                     device, cross: bool = False) -> Dict[str, torch.Tensor]:
    """Projections from ``dense_init`` (uninitialised with no generator),
    biases zeros (none for ``cross`` attention), QK norm scales ones."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {name: dense_init(shape, dtype, generator, device)
         for name, shape in (("wq", (d, qd)), ("wk", (d, kvd)),
                             ("wv", (d, kvd)), ("wo", (qd, d)))}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros(qd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(kvd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(kvd, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.head_dim, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(cfg.head_dim, dtype=dtype, device=device)
    return p


def _heads(ctx, t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, S, n·dh) -> (B, S, n, dh).  Under a mesh where the heads do not
    split evenly over the TP axis, the flat dim is gathered first (a
    shard would cut a head)."""
    B, S, _ = t.shape
    if n % ctx.size(ctx.tp_axis):
        t = ctx.constrain(t, P(ctx.dp_axes or None, None, None))
    return t.reshape(B, S, n, dh)


def _project(cfg, p: Mapping[str, torch.Tensor], x: torch.Tensor, ctx):
    """q (B, S, H, dh), k and v (B, S, Hkv, dh): the projections, biases
    and QK norm, before RoPE."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _heads(ctx, q, H, dh)
    k = _heads(ctx, k, Hkv, dh)
    v = _heads(ctx, v, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _rope(cfg, t: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_variant == "rope":
        return apply_rope(t, positions, cfg.rope_theta)
    if cfg.rope_variant == "mrope":
        return apply_mrope(t, positions, cfg.rope_theta)
    return t


# ---------------------------------------------------------------------------
# Each rank's heads (every head with no mesh)
# ---------------------------------------------------------------------------
def heads_spec(ctx, B: int, H: int) -> P:
    """(B, S, H, dh) activations: batch over the DP axes, heads over
    ``model`` (``act_heads``), each where it divides evenly."""
    return ctx.fit(P(ctx.dp_axes or None, None, ctx.tp_axis, None),
                   (B, 1, H, 1))


def _local_kv(t: torch.Tensor, h0: int, n_heads: int,
              n_rep: int) -> torch.Tensor:
    """The kv heads (of ``t``, (B, S, Hkv, dh), every kv head) that query
    heads ``h0 .. h0 + n_heads - 1`` read, laid out so that the kernel's
    grouping (query head i reads kv head ``i // (n_heads / kv heads)``)
    pairs them right: whole groups as they are, one shared kv head, or
    else one kv head a query head."""
    Hkv = t.shape[2]
    if n_heads == Hkv * n_rep:
        return t
    g0, g1 = h0 // n_rep, (h0 + n_heads - 1) // n_rep + 1
    if (h0 % n_rep == 0 and n_heads % n_rep == 0) or g1 - g0 == 1:
        return t[:, :, g0:g1]
    idx = torch.arange(h0, h0 + n_heads, device=t.device) // n_rep
    return t.index_select(2, idx)


def _attend(cfg, ctx, q, k, v, positions, causal: bool,
            return_kv: bool = False):
    """``flash_attention`` over each rank's batch rows and query heads,
    RoPE first where ``positions`` is given; with ``return_kv`` also the
    rotated k and v, every kv head."""
    B, _, H, _ = q.shape
    n_rep = H // k.shape[2]
    qs = heads_spec(ctx, B, H)
    kvs = P(qs[0], None, None, None)
    tp = qs[2]
    mrope = cfg.rope_variant == "mrope"
    ps = P(None, qs[0], None) if mrope else P(qs[0], None)

    def fn(q, k, v, pos):
        if pos is not None:
            q, k = _rope(cfg, q, pos), _rope(cfg, k, pos)
        h0 = ctx.rank(tp) * q.shape[2] if tp is not None else 0
        o = get_kernel("flash_attention")(
            q, _local_kv(k, h0, q.shape[2], n_rep),
            _local_kv(v, h0, q.shape[2], n_rep), causal=causal)
        return (o, k, v) if return_kv else o

    out = (qs, kvs, kvs) if return_kv else qs
    return ctx.local(fn, (qs, kvs, kvs, ps), out)(q, k, v, positions)


def attention_block(cfg, p: Mapping[str, torch.Tensor], x: torch.Tensor,
                    positions: torch.Tensor, return_cache: bool = False,
                    ctx=NO_MESH):
    """Causal self-attention sub-block: (B, S, d) -> (B, S, d), or
    ``(out, (k, v))`` with ``return_cache`` (the prefill keeps the
    projected K/V as its cache)."""
    q, k, v = _project(cfg, p, ctx.full_seq(x), ctx)
    # the SP -> TP switch, once a layer: q heads-sharded before the
    # kernel; k and v too where the residual stream is seq-sharded
    q = ctx.act_heads(q)
    if ctx.sp_axis is not None:
        k, v = ctx.act_heads(k), ctx.act_heads(v)
    o = _attend(cfg, ctx, q, k, v, positions, True, return_kv=return_cache)
    if return_cache:
        o, k, v = o
    out = _output(cfg, p, ctx.act_heads(o), ctx)
    return (out, (k, v)) if return_cache else out


def init_kv_cache(cfg, batch: int, max_len: int, n_layers: int,
                  dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_positions(cfg, B: int, pos: int, device) -> torch.Tensor:
    shape = (3, B, 1) if cfg.rope_variant == "mrope" else (B, 1)
    return torch.full(shape, pos, dtype=torch.int32, device=device)


def _decode_scores(q, cache_k, pos: int, s0: int = 0):
    """float32 scores (B, Hkv, n_rep, S) of the token's query heads, grouped
    by kv head, against cache rows ``s0 ..``; rows past ``pos`` set to
    NEG_INF."""
    B, _, H, dh = q.shape
    Hkv, S = cache_k.shape[2], cache_k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, dh).to(torch.float32)
    s = torch.einsum("bkrd,bskd->bkrs", qg,
                     cache_k.to(torch.float32)) * dh ** -0.5
    valid = torch.arange(s0, s0 + S, device=q.device) <= pos
    return torch.where(valid, s, NEG_INF), valid


def cache_spec(ctx, B: int, S: int) -> P:
    """One layer's (B, S, Hkv, dh) self-attention cache: the decode
    state's spec (``sharding.specs.state_spec``) without its layer dim."""
    kv_seq = "model" if ctx.policy.kv_seq_shard else None
    return ctx.fit(P(ctx.dp_axes or None, kv_seq, None, None), (B, S, 1, 1))


def decode_attention_block(cfg, p: Mapping[str, torch.Tensor],
                           x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos: int,
                           ctx=NO_MESH) -> torch.Tensor:
    """One-token decode: x (B, 1, d); cache_{k,v} (B, S_max, Hkv, dh),
    written at ``pos`` in place.  Returns out (B, 1, d).  The token's
    position is ``pos``, in all three streams under M-RoPE (the JAX
    package's decode).  The projections run as they come (DTensor ops
    under a mesh), then one ``ctx.local`` region on each rank's batch
    rows, every head, and its rows of the cache."""
    B = x.shape[0]
    q, k, v = _project(cfg, p, x, ctx)
    cs = cache_spec(ctx, B, cache_k.shape[1])
    dp, seq = cs[0], cs[1]
    rows = P(dp, None, None, None)

    def fn(q, k, v, ck, cv):
        positions = _decode_positions(cfg, q.shape[0], pos, q.device)
        q, k = _rope(cfg, q, positions), _rope(cfg, k, positions)
        S = ck.shape[1]
        s0 = ctx.rank(seq) * S if seq is not None else 0
        if seq is None or s0 <= pos < s0 + S:
            ck[:, pos - s0] = k[:, 0]
            cv[:, pos - s0] = v[:, 0]
        s, valid = _decode_scores(q, ck, pos, s0)
        if seq is None:
            attn = torch.softmax(s, dim=-1)
            o = torch.einsum("bkrs,bskd->bkrd", attn, cv.to(torch.float32))
        else:
            # the softmax over every rank's rows: the ranks' maxima, then
            # their sums and outputs rescaled to the common maximum
            from torch.distributed import _functional_collectives as funcol
            group = ctx.group(seq)
            m = funcol.all_reduce(s.amax(-1), "max", group)
            e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
            den = funcol.all_reduce(e.sum(-1), "sum", group)
            o = funcol.all_reduce(
                torch.einsum("bkrs,bskd->bkrd", e, cv.to(torch.float32)),
                "sum", group) / den[..., None]
        return o.reshape(q.shape[0], 1, cfg.q_dim).to(x.dtype)

    o = ctx.local(fn, (rows, rows, rows, cs, cs), P(dp, None, None))(
        q, k, v, cache_k, cache_v)
    return o @ p["wo"]


# ---------------------------------------------------------------------------
# Whisper: the encoder's attention and the decoder's cross attention
# ---------------------------------------------------------------------------
def _output(cfg, p: Mapping[str, torch.Tensor], o: torch.Tensor, ctx):
    """(B, S, H, dh) -> (B, S, d): the heads flattened, then ``wo``.
    Under a mesh where the heads do not split evenly over the TP axis the
    flat dim's gradient is gathered before it reaches the heads (a shard
    would cut a head)."""
    B, S, H = o.shape[:3]
    flat = o.reshape(B, S, cfg.q_dim)
    if H % ctx.size(ctx.tp_axis):
        flat = ctx.constrain(flat, P(ctx.dp_axes or None, None, None))
    return flat @ p["wo"]


def cross_attention_block(cfg, p: Mapping[str, torch.Tensor],
                          x: torch.Tensor, enc_k: torch.Tensor,
                          enc_v: torch.Tensor, ctx=NO_MESH) -> torch.Tensor:
    """x (B, S, d) against the encoder's keys and values ``enc_k``,
    ``enc_v`` (B, S_enc, Hkv, dh) (``encode_cross_kv``): no mask, the
    output rounded once to x's dtype, then ``wo``."""
    q = _heads(ctx, x @ p["wq"], cfg.n_heads, cfg.head_dim)
    o = _attend(cfg, ctx, ctx.act_heads(q), enc_k, enc_v, None, False)
    return _output(cfg, p, o, ctx)


def encode_cross_kv(cfg, p: Mapping[str, torch.Tensor],
                    enc_out: torch.Tensor, ctx=NO_MESH):
    """The decoder's cross-attention K and V (B, S_enc, Hkv, dh) from the
    encoder output (B, S_enc, d)."""
    return tuple(_heads(ctx, enc_out @ p[w], cfg.n_kv_heads, cfg.head_dim)
                 for w in ("wk", "wv"))


def bidir_attention_block(cfg, p: Mapping[str, torch.Tensor],
                          x: torch.Tensor, ctx=NO_MESH) -> torch.Tensor:
    """The encoder's self attention: the projections with no RoPE, every
    frame attending to every frame."""
    q, k, v = _project(cfg, p, x, ctx)
    o = _attend(cfg, ctx, ctx.act_heads(q), k, v, None, False)
    return _output(cfg, p, o, ctx)
