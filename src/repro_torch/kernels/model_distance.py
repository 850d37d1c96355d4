"""Per-trainer model distance, paper Eq. 4:

    D[i] = || l[i, :] - g[:] ||_2

over a stacked ``(n, P)`` float32 or bfloat16 tensor of local models and
the ``(P,)`` global model, accumulated in float32; ``(n,)`` float32 out.

Kernel: replaces the Pallas ``_kernel`` of
``src/repro/kernels/model_distance.py:18`` (called through
``model_distance``, ``pallas_call`` at ``:41``).  Bound: the bytes moved,
(n·P + P) elements read plus 4·n bytes written, over the card's memory
rate; 3·n·P float operations are far below the compute rate.  Design
(``csrc/fl.cu``): the TPU grid carried each row's sum across its
sequential P axis in the output block; on Hopper one block owns one row
and loops over P itself, with 16-byte loads where the row and g share an
alignment, a warp then block reduction in float32, and one write per row.
No atomics, so the result is the same on every run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG


def model_distance_torch(local: torch.Tensor,
                         global_: torch.Tensor) -> torch.Tensor:
    """Plain version: (n, P), (P,) -> (n,) float32 L2 distances."""
    d = local.to(torch.float32) - global_.to(torch.float32)[None]
    return torch.sqrt((d * d).sum(1))


def model_distance(local: torch.Tensor,
                   global_: torch.Tensor) -> torch.Tensor:
    """(n,) float32 distances of the rows of ``local`` from ``global_``:
    the plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor."""
    if local.dim() != 2 or global_.shape != local.shape[1:]:
        raise ValueError(f"model_distance takes (n, P) and (P,), got "
                         f"{tuple(local.shape)} and {tuple(global_.shape)}")
    if local.device.type == "cpu":
        return model_distance_torch(local, global_)
    dev = check_cuda(local, global_)
    if local.dtype not in DTYPE_FLAG or global_.dtype != local.dtype:
        raise TypeError(f"model_distance takes float32 or bfloat16 of one "
                        f"dtype, got {local.dtype} and {global_.dtype}")
    loc, glob = local.contiguous(), global_.contiguous()
    n, p = loc.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _build.launch("fl_model_distance", dev, loc.data_ptr(),
                      glob.data_ptr(), n, p, DTYPE_FLAG[loc.dtype],
                      out.data_ptr())
        model_distance.launches += 1
    return out


model_distance.launches = 0
