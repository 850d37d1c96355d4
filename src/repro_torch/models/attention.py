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
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from repro_torch.kernels.factory import get_kernel
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       rms_norm)

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


def _project_qkv(cfg, p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, rope: bool = True):
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope and cfg.rope_variant == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif rope and cfg.rope_variant == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(cfg, p: Mapping[str, torch.Tensor], x: torch.Tensor,
                    positions: torch.Tensor, return_cache: bool = False):
    """Causal self-attention sub-block: (B, S, d) -> (B, S, d), or
    ``(out, (k, v))`` with ``return_cache`` (the prefill keeps the
    projected K/V as its cache)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = get_kernel("flash_attention")(q, k, v, causal=True)
    B, S, _ = x.shape
    out = (o.reshape(B * S, cfg.q_dim) @ p["wo"]).reshape(B, S, cfg.d_model)
    if return_cache:
        return out, (k, v)
    return out


def init_kv_cache(cfg, batch: int, max_len: int, n_layers: int,
                  dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention_block(cfg, p: Mapping[str, torch.Tensor],
                           x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos: int) -> torch.Tensor:
    """One-token decode: x (B, 1, d); cache_{k,v} (B, S_max, Hkv, dh),
    written at ``pos`` in place.  Returns out (B, 1, d).  The token's
    position is ``pos``, in all three streams under M-RoPE (the JAX
    package's decode)."""
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shape = (3, B, 1) if cfg.rope_variant == "mrope" else (B, 1)
    positions = torch.full(shape, pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    S = cache_k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, dh).to(torch.float32)
    s = torch.einsum("bkrd,bskd->bkrs", qg,
                     cache_k.to(torch.float32)) * dh ** -0.5
    valid = torch.arange(S, device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    attn = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrs,bskd->bkrd", attn, cache_v.to(torch.float32))
    return o.reshape(B, 1, cfg.q_dim).to(x.dtype) @ p["wo"]


# ---------------------------------------------------------------------------
# Whisper: the encoder's attention and the decoder's cross attention
# ---------------------------------------------------------------------------
def _output(cfg, p: Mapping[str, torch.Tensor], o: torch.Tensor):
    """(B, S, H, dh) -> (B, S, d): the heads flattened, then ``wo``."""
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.q_dim) @ p["wo"]


def cross_attention_block(cfg, p: Mapping[str, torch.Tensor],
                          x: torch.Tensor, enc_k: torch.Tensor,
                          enc_v: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) against the encoder's keys and values ``enc_k``,
    ``enc_v`` (B, S_enc, Hkv, dh) (``encode_cross_kv``): no mask, the
    output rounded once to x's dtype, then ``wo``."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    o = get_kernel("flash_attention")(q, enc_k, enc_v, causal=False)
    return _output(cfg, p, o)


def encode_cross_kv(cfg, p: Mapping[str, torch.Tensor],
                    enc_out: torch.Tensor):
    """The decoder's cross-attention K and V (B, S_enc, Hkv, dh) from the
    encoder output (B, S_enc, d)."""
    B, S, _ = enc_out.shape
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    return (enc_out @ p["wk"]).reshape(shape), \
        (enc_out @ p["wv"]).reshape(shape)


def bidir_attention_block(cfg, p: Mapping[str, torch.Tensor],
                          x: torch.Tensor) -> torch.Tensor:
    """The encoder's self attention: the projections with no RoPE, every
    frame attending to every frame."""
    q, k, v = _project_qkv(cfg, p, x, None, rope=False)
    o = get_kernel("flash_attention")(q, k, v, causal=False)
    return _output(cfg, p, o)
