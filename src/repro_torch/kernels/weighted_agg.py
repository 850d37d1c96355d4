"""Reputation-weighted aggregation, paper Eq. 1:

    out[p] = sum_n s[n] * w[n, p] / max(sum_n s[n], 1e-12)

over a stacked ``(n, P)`` float32 or bfloat16 tensor of trainer models and
``(n,)`` scores, accumulated in float32 and returned in the input's dtype.
The FL path hands it the whole parameter tree flattened to one ``(n, P)``
tensor (``core/aggregation.tree_flat_stacked``): columns are independent,
so one launch per round gives what one launch per leaf would.

Kernel: replaces the Pallas ``_kernel`` of
``src/repro/kernels/weighted_agg.py:22`` (called through ``weighted_agg``,
``pallas_call`` at ``:42``).  Bound: the bytes moved, (n·P + P) elements
plus 4·n bytes of scores, over the card's memory rate; 2·n·P float
operations are far below the compute rate.  Design (``csrc/fl.cu``): one
thread per column p, neighbouring threads on neighbouring columns so every
row read is coalesced, a grid-stride loop over P, the n rows walked in
order into a float32 sum; each block sums the scores once.  The TPU
wrapper padded P to its tile; the CUDA kernel masks the tail instead, so
no padded copy is made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import check_cuda

#: dtype flags of the launchers in csrc/fl.cu
DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


def weighted_agg_torch(stacked: torch.Tensor,
                       scores: torch.Tensor) -> torch.Tensor:
    """Plain version: (n, P), (n,) -> (P,) in ``stacked``'s dtype."""
    s = scores.to(torch.float32)
    denom = torch.clamp(s.sum(), min=1e-12)
    return ((stacked.to(torch.float32) * s[:, None]).sum(0) / denom).to(
        stacked.dtype)


def weighted_agg(stacked: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """(P,) Eq. 1 average of the rows of ``stacked`` weighted by
    ``scores``: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor."""
    if stacked.dim() != 2 or scores.shape != stacked.shape[:1]:
        raise ValueError(f"weighted_agg takes (n, P) and (n,), got "
                         f"{tuple(stacked.shape)} and {tuple(scores.shape)}")
    if stacked.device.type == "cpu":
        return weighted_agg_torch(stacked, scores)
    dev = check_cuda(stacked, scores)
    if stacked.dtype not in DTYPE_FLAG:
        raise TypeError(f"weighted_agg takes float32 or bfloat16, got "
                        f"{stacked.dtype}")
    w = stacked.contiguous()
    s = scores.to(torch.float32).contiguous()
    n, p = w.shape
    out = torch.empty(p, dtype=w.dtype, device=dev)
    if p:
        _build.launch("fl_weighted_agg", dev, w.data_ptr(), s.data_ptr(), n,
                      p, DTYPE_FLAG[w.dtype], out.data_ptr())
        weighted_agg.launches += 1
    return out


weighted_agg.launches = 0
