"""Expert-grouped matmul (the MoE FFN's expert products):

    xe (E, C, d) x w (E, d, f)  ->  (E, C, f) in xe's dtype

multiplied and summed in float32, rounded once to the input's dtype
(``ref.gmm_ref``'s semantics); float32 or bfloat16 in, any E, C, d, f.
``models.moe`` folds the batch into C: ``(E, B·C, d)``, one launch per
expert product.

Kernel: replaces the Pallas ``_kernel`` of ``src/repro/kernels/gmm.py:18``
(``pallas_call`` at ``:43``), which padded C and f to its blocks; the CUDA
kernels (``csrc/moe.cu``) read tails as zeros and mask them on the write.
Bound: operations, 2·E·C·d·f over the bf16 tensor-core peak, at the
prefill's C of thousands of rows; bytes, the weights E·d·f once, at the
decode's C of a few tokens.  Five forms, all summing in float32, chosen by
``form`` from the dtype, C and whether TMA can read the rows (a multiple
of 16 bytes, on 16-byte boundaries):

  * ``wgmma`` (bfloat16, C > 32, TMA rows; the prefill): 128 x 256 output
    tiles, a producer warpgroup (one thread issues) streaming TMA loads of
    x and w through a 4-stage ring, two consumer warpgroups on ``wgmma``;
  * ``wmma`` (bfloat16, C > 32, rows TMA cannot take): WMMA on 128 x 128
    tiles staged by all threads;
  * ``simt`` (float32, C > 32): the CUDA cores in full float32 (no TF32);
  * ``stream`` (bfloat16, C <= 32, TMA rows; the decode): d split over
    blocks, each streaming a 512 x 256 slab of w through a TMA ring into
    ``wgmma`` on a 64-row tile, its float32 partial sums added in order by
    a second pass (no atomics);
  * ``skinny`` (C <= 32 otherwise): a block streams a 256-column slab of
    w into registers for up to 8 rows of x.

The kernels have no backward: training through the expert products is
ROADMAP.md queue 1 item 10(d), and a backward through them raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted
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


def gmm_cost(xe: torch.Tensor, w: torch.Tensor) -> Tuple[int, int]:
    """(FLOPs, bytes) of the grouped product: 2·E·C·d·f; x, w read once
    and the output written once, in x's dtype."""
    E, C, d = xe.shape
    f = w.shape[2]
    return 2 * E * C * d * f, xe.element_size() * (E * C * d + E * d * f
                                                   + E * C * f)


@counted("gmm")
def gmm_torch(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: an einsum in float32, then a cast."""
    _check_shapes(xe, w)
    return torch.einsum("ecd,edf->ecf", xe.to(torch.float32),
                        w.to(torch.float32)).to(xe.dtype)


@counted("gmm")
def gmm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor (no backward through the kernel)."""
    _check_shapes(xe, w)
    if xe.device.type == "cpu":
        return gmm_torch(xe, w)
    return _KernelGmm.apply(xe, w)


gmm.launches = 0
gmm.last_form = None                # the form of the latest launch
gmm.form_launches = {}              # launches by form

# the forms, as csrc/moe.cu's Form numbers them
FORMS = {"simt": 0, "wmma": 1, "wgmma": 2, "skinny": 3, "stream": 4}
SKINNY_C = 32                       # csrc/moe.cu kSkinnyC
DECODE_SPLIT = 512                  # rows of d a stream block, kDSplit


def form(dtype: torch.dtype, C: int, d: int, f: int, aligned: bool) -> str:
    """The kernel's form for a launch: bfloat16 with TMA rows (d and f
    multiples of 8 values, ``aligned``: both tensors on 16 bytes) takes
    ``wgmma`` above ``SKINNY_C`` rows and ``stream`` up to it; otherwise
    ``wmma`` (bfloat16) or ``simt`` (float32) above it, ``skinny`` up to
    it."""
    tma = dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0 and aligned
    if C <= SKINNY_C:
        return "stream" if tma else "skinny"
    if tma:
        return "wgmma"
    return "wmma" if dtype == torch.bfloat16 else "simt"


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
    chosen = form(xe.dtype, C, d, f,
                  xe.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    part = None
    if chosen == "stream":
        splits = -(-d // DECODE_SPLIT)
        part = torch.empty(splits, E, C, f, dtype=torch.float32, device=dev)
    _build.launch("moe_gmm", dev, xe.data_ptr(), w.data_ptr(), E, C, d, f,
                  DTYPE_FLAG[xe.dtype], FORMS[chosen],
                  part.data_ptr() if part is not None else None,
                  out.data_ptr())
    gmm.launches += 1
    gmm.last_form = chosen
    gmm.form_launches[chosen] = gmm.form_launches.get(chosen, 0) + 1
    return out


class _KernelGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xe, w):
        return _launch(xe, w)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the gmm CUDA kernel has no backward: training through the "
            "expert products is ROADMAP.md queue 1 item 10(d)")
