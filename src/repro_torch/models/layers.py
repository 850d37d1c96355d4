"""Common layers of the token LMs: initializers, norms, the SwiGLU MLP and
rotary embeddings, with the JAX package's layouts and casts.

Norms, RoPE and M-RoPE (qwen2-vl's three position streams) compute in
float32 and cast back to the input's dtype; matrices are stored ``(in,
out)``, so a projection is ``x @ w``.  Under a mesh (``ctx``, a
``sharding.specs.MeshCtx``) the norms and products take DTensors as they
come; RoPE runs inside the callers' ``ctx.local`` regions, on local
shards.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._build import is_fake
from repro_torch.sharding.specs import NO_MESH


def truncated_normal_init(shape, scale: float, dtype: torch.dtype,
                          generator: torch.Generator,
                          device) -> torch.Tensor:
    """A standard normal cut at +-2, times ``scale``: drawn in float32 on
    ``device`` from ``generator``, then cast to ``dtype``.  ``trunc_normal_``
    takes its bounds in absolute units, so they are +-2 * scale."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, mean=0.0, std=scale, a=-2.0 * scale,
                                b=2.0 * scale, generator=generator)
    return out.to(dtype)


def dense_init(shape, dtype: torch.dtype, generator: torch.Generator | None,
               device) -> torch.Tensor:
    """Fan-in scaled init for ``(in, out)`` matrices: fan_in is
    ``shape[-2]`` (for the embedding table, the vocabulary).  With no
    ``generator`` the matrix is left uninitialised, to be loaded."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return truncated_normal_init(shape, shape[-2] ** -0.5, dtype, generator,
                                 device)


# -- norms ---------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, scale)
    return rms_norm(x, scale)


# -- SwiGLU MLP ----------------------------------------------------------------
def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, ctx=NO_MESH) -> torch.Tensor:
    """``(silu(x @ wg) * (x @ wu)) @ wd``; under a mesh the hidden
    ``ctx.act_ffn``-constrained (TP on ff), as in the JAX package."""
    return ctx.act_ffn(F.silu(x @ wg) * (x @ wu)) @ wd


# -- rotary embeddings -----------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_inv_cached(head_dim: int, theta: float, device: torch.device):
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def _rope_inv(head_dim: int, theta: float, device: torch.device,
              like: torch.Tensor = None):
    """``rope_freqs`` on ``device``, copied there once: a copy from host
    memory waits for the device, and RoPE runs twice in every layer.  For
    a fake tensor (the dry run) a fresh table of the active fake mode."""
    if like is not None and is_fake(like):
        return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)
    return _rope_inv_cached(head_dim, theta, device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, dh) rotated by the angles ``ang`` (B, S, dh/2): its two
    halves as the real and imaginary parts, in float32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int."""
    inv = _rope_inv(x.shape[-1], theta, x.device, x)
    return _rotate(x, positions.to(torch.float32)[..., None] * inv)


def mrope_sections(head_dim: int, sections=(16, 24, 24)) -> list:
    """M-RoPE's frequency bands a stream (temporal, height, width):
    ``sections`` are halves of qwen2-vl's dh / 2 = 64, scaled to
    ``head_dim`` (each at least 1); the third takes the rest."""
    half = head_dim // 2
    base = sum(sections)
    sec = [max(1, (s * half) // base) for s in sections]
    sec[2] = half - sec[0] - sec[1]
    return sec


def _streams(head_dim: int, device) -> torch.Tensor:
    return torch.cat([torch.full((n,), i, dtype=torch.int64)
                      for i, n in enumerate(mrope_sections(head_dim))]
                     ).to(device)


_streams_cached = functools.lru_cache(maxsize=32)(_streams)


def _mrope_streams(head_dim: int, device: torch.device,
                   like: torch.Tensor = None) -> torch.Tensor:
    """(dh/2,) int64: the position stream that drives each band (fresh,
    not cached, for a fake tensor)."""
    if like is not None and is_fake(like):
        return _streams(head_dim, device)
    return _streams_cached(head_dim, device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """M-RoPE (qwen2-vl): x (B, S, H, dh); positions3 (3, B, S) int, the
    temporal, height and width streams, each driving its
    ``mrope_sections`` of the frequencies."""
    inv = _rope_inv(x.shape[-1], theta, x.device, x)
    stream = _mrope_streams(x.shape[-1], x.device, x)
    pos = positions3.to(torch.float32)[stream].movedim(0, -1)  # (B, S, dh/2)
    return _rotate(x, pos * inv)


def positions_for(cfg, batch: int, seq: int, offset: int = 0,
                  device=None) -> torch.Tensor:
    """(batch, seq) int32 positions ``offset .. offset + seq - 1``; for
    M-RoPE the same in each of the three streams, (3, batch, seq)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    pos = pos[None, :].expand(batch, seq)
    if cfg.rope_variant == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos
