"""Expert-grouped matmul (the MoE FFN's expert products):

    xe (E, C, d) x w (E, d, f)  ->  (E, C, f) in xe's dtype

multiplied and summed in float32, rounded once to the input's dtype
(``ref.gmm_ref``'s semantics); float32 or bfloat16 in, any E, C, d, f.
``models.moe`` folds the batch into C: ``(E, B·C, d)``, one launch per
expert product.

Kernel: replaces the Pallas ``_kernel`` of ``src/repro/kernels/gmm.py:18``
(``pallas_call`` at ``:43``), which padded C and f to its blocks; the CUDA
kernel (``csrc/moe.cu``) masks the tails of its tiles instead.  Bound:
operations, 2·E·C·d·f over the bf16 tensor-core peak, at the prefill's
C of thousands of rows; bytes, the weights E·d·f once, at the decode's C of
a few tokens.  Design, three forms that all sum in float32: at C > 32,
a thread block per (expert, 128 x 128 output tile) stages x and w tiles
in shared memory and multiplies bfloat16 on the tensor cores (WMMA) and
float32 on the CUDA cores (in full float32, no TF32); at the decode's C
<= 32, a block streams a 256-column slab of the weights once from device
memory into registers for up to 8 rows of x.  ``wgmma``, TMA and a
pipeline of tiles are later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG

# How far the kernel may sit from the plain version.  Both multiply in
# float32 and round once to the output's dtype, summing in another order:
# in float32 that order moves a result by a few float32 steps of the
# partial sums, which the largest output bounds (``atol_of_max``); in
# bfloat16 the two float32 sums may straddle a rounding point, one
# bfloat16 step, at most 2^-7 of the value.
KERNEL_TOL = {torch.float32: dict(rtol=1e-5, atol_of_max=1e-5),
              torch.bfloat16: dict(rtol=2 ** -7, atol_of_max=1e-5)}


def kernel_tol(want: torch.Tensor) -> dict:
    """``assert_close`` tolerances of a kernel result against ``want``,
    the plain version's (see ``KERNEL_TOL``)."""
    tol = KERNEL_TOL[want.dtype]
    scale = float(want.abs().max()) if want.numel() else 0.0
    return dict(rtol=tol["rtol"], atol=tol["atol_of_max"] * scale)


def gmm_torch(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: an einsum in float32, then a cast."""
    _check_shapes(xe, w)
    return torch.einsum("ecd,edf->ecf", xe.to(torch.float32),
                        w.to(torch.float32)).to(xe.dtype)


def gmm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor."""
    _check_shapes(xe, w)
    if xe.device.type == "cpu":
        return gmm_torch(xe, w)
    return _launch(xe, w)


gmm.launches = 0


def _check_shapes(xe, w) -> None:
    if xe.dim() != 3 or w.dim() != 3 or w.shape[0] != xe.shape[0] \
            or w.shape[1] != xe.shape[2]:
        raise ValueError(f"gmm takes xe (E, C, d) and w (E, d, f), got "
                         f"{tuple(xe.shape)}, {tuple(w.shape)}")


def _launch(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dev = check_cuda(xe, w)
    if xe.dtype not in DTYPE_FLAG or w.dtype != xe.dtype:
        raise TypeError(f"gmm takes float32 or bfloat16 of one dtype, got "
                        f"{xe.dtype}, {w.dtype}")
    E, C, d = xe.shape
    f = w.shape[2]
    if E > 65535 or C >= 1 << 20:
        raise ValueError(f"the gmm kernel takes E <= 65535 and C < 2^20, "
                         f"got E {E}, C {C}")
    xe, w = xe.contiguous(), w.contiguous()
    out = torch.empty(E, C, f, dtype=xe.dtype, device=dev)
    if out.numel() == 0:
        return out
    if d == 0:
        return out.zero_()
    _build.launch("moe_gmm", dev, xe.data_ptr(), w.data_ptr(), E, C, d, f,
                  DTYPE_FLAG[xe.dtype], out.data_ptr())
    gmm.launches += 1
    return out
