"""Update compression for the rollup commit payload, as the JAX package's
``optim/compression.py``:

  * int8 quantization with per-block scales (blocks of ``BLOCK`` values
    of the flattened tensor, the last one zero-padded), optionally with
    stochastic rounding: the JAX package draws its uniforms from a key,
    the port from a ``torch.Generator``, so the two round differently;
  * top-k sparsification with error feedback: the residual re-enters the
    next commit.

Trees are dicts of tensors, nested or flat; every function keeps the
tree's keys.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

BLOCK = 256


def quantize_int8(x: torch.Tensor, generator: Optional[torch.Generator]
                  = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8: (q (n_blocks, BLOCK) int8, scale
    (n_blocks,) float32); uniforms in [-0.5, 0.5) before the rounding
    where a ``generator`` is given."""
    flat = x.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    y = blocks / scale
    if generator is not None:
        y = y + (torch.rand(y.shape, generator=generator,
                            device=generator.device) - 0.5).to(y.device)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


def _leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _build(pairs):
    root: dict = {}
    for path, leaf in pairs:
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return root


def quantize_tree(tree, generator: Optional[torch.Generator] = None):
    """Every leaf quantized: ({"q": tree, "scale": tree}, info), where
    ``info`` carries each leaf's shape and dtype for ``dequantize_tree``."""
    leaves = list(_leaves(tree))
    qs = [(path, quantize_int8(leaf, generator)) for path, leaf in leaves]
    info = {path: (tuple(leaf.shape), leaf.dtype) for path, leaf in leaves}
    return {"q": _build((p, q) for p, (q, _) in qs),
            "scale": _build((p, s) for p, (_, s) in qs)}, info


def dequantize_tree(packed, info):
    qs = dict(_leaves(packed["q"]))
    ss = dict(_leaves(packed["scale"]))
    return _build((path, dequantize_int8(qs[path], ss[path], shape, dtype))
                  for path, (shape, dtype) in info.items())


# -- top-k + error feedback ----------------------------------------------------
def topk_sparsify(x: torch.Tensor, frac: float = 0.01):
    """Keep the largest-|.| ``frac`` of the entries (ties at the threshold
    kept too): (sparse x, kept mask)."""
    flat = x.to(torch.float32).reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = flat.abs() >= thresh
    return (flat * mask).reshape(x.shape).to(x.dtype), mask.reshape(x.shape)


def ef_compress_tree(update_tree, residual_tree, frac: float = 0.01):
    """Error-feedback top-k: compress (update + residual), carry the rest."""
    kept, resid = [], []
    res = dict(_leaves(residual_tree))
    for path, u in _leaves(update_tree):
        r = res[path]
        tot = u.to(torch.float32) + r.to(torch.float32)
        k, _ = topk_sparsify(tot, frac)
        kept.append((path, k.to(u.dtype)))
        resid.append((path, (tot - k.to(torch.float32)).to(r.dtype)))
    return _build(kept), _build(resid)


def init_residual(params):
    return _build((path, torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))
                  for path, p in _leaves(params))
