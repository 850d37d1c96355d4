"""Reputation-weighted aggregation, paper Eq. 1:

    out[p] = sum_n s[n] * w[n, p] / max(sum_n s[n], 1e-12)

over a stacked ``(n, P)`` float32 or bfloat16 tensor of trainer models and
``(n,)`` scores, accumulated in float32 and returned in the input's dtype.
The FL path hands it the whole parameter tree flattened to one ``(n, P)``
tensor (``core/aggregation.tree_flat_stacked``): columns are independent,
so one launch per round gives what one launch per leaf would.  The
cross-task megastep hands it T such stacks at once, ``(T, n, P)`` with
``(T, n)`` scores -> ``(T, P)``: row t is bit-identical to the call on
task t alone, in both versions.

Kernel: replaces the Pallas ``_kernel`` of
``src/repro/kernels/weighted_agg.py:22`` (called through ``weighted_agg``,
``pallas_call`` at ``:42``).  Bound: the bytes moved, (n·P + P) elements
plus 4·n bytes of scores, over the card's memory rate; 2·n·P float
operations are far below the compute rate.  Design (``csrc/fl.cu``): one
thread per column p, neighbouring threads on neighbouring columns so every
row read is coalesced, a grid-stride loop over P, the n rows walked in
order into a float32 sum; each block sums the scores once.  The task axis
is the grid's y axis, one launch for all T tasks, each task's sums in the
order of an unbatched launch.  The TPU wrapper padded P to its tile; the
CUDA kernel masks the tail instead, so no padded copy is made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import check_cuda

#: dtype flags of the launchers in csrc/fl.cu
DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


def weighted_agg_torch(stacked: torch.Tensor,
                       scores: torch.Tensor) -> torch.Tensor:
    """Plain version: (n, P), (n,) -> (P,), or (T, n, P), (T, n) -> (T, P),
    in ``stacked``'s dtype."""
    s = scores.to(torch.float32)
    denom = torch.clamp(s.sum(-1), min=1e-12)
    return ((stacked.to(torch.float32) * s[..., None]).sum(-2)
            / denom[..., None]).to(stacked.dtype)


def weighted_agg(stacked: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Eq. 1 average of the rows of ``stacked`` weighted by ``scores``:
    (n, P), (n,) -> (P,), or T tasks at once, (T, n, P), (T, n) -> (T, P).
    The plain version for a CPU tensor, the CUDA kernel (one launch) for a
    CUDA tensor."""
    if stacked.dim() not in (2, 3) or scores.shape != stacked.shape[:-1]:
        raise ValueError(f"weighted_agg takes (n, P) and (n,), or (T, n, P) "
                         f"and (T, n), got {tuple(stacked.shape)} and "
                         f"{tuple(scores.shape)}")
    if stacked.device.type == "cpu":
        return weighted_agg_torch(stacked, scores)
    dev = check_cuda(stacked, scores)
    if stacked.dtype not in DTYPE_FLAG:
        raise TypeError(f"weighted_agg takes float32 or bfloat16, got "
                        f"{stacked.dtype}")
    w = stacked.contiguous()
    s = scores.to(torch.float32).contiguous()
    n_tasks = w.shape[0] if w.dim() == 3 else 1
    n, p = w.shape[-2:]
    out = torch.empty(w.shape[:-2] + (p,), dtype=w.dtype, device=dev)
    if p and n_tasks:
        _build.launch("fl_weighted_agg", dev, w.data_ptr(), s.data_ptr(),
                      n_tasks, n, p, DTYPE_FLAG[w.dtype], out.data_ptr())
        weighted_agg.launches += 1
    return out


weighted_agg.launches = 0
