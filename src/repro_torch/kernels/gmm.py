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

The gradient (``gmm_bwd``: dx = dy·wᵀ and dw = xᵀ·dy, the same float32
sums and one rounding) is its own kernel (``csrc/moe_bwd.cu``): the JAX
package has no Pallas backward (it differentiates jnp), so it replaces no
TPU kernel.  Bound: operations, 4·E·C·d·f.  Three forms, chosen by
``bwd_form`` from the dtype and whether TMA can read the rows (the
forward's rule):

  * ``wgmma`` (bfloat16, TMA rows; moonshot's training products): the
    forward's pipeline, both products in ONE persistent launch (a block an
    SM walks dx's tiles, then dw's, its producer loading the next tile
    during the epilogue): 128 x 256 tiles, a TMA producer, a 4-stage
    mbarrier ring, two consumer warpgroups on ``wgmma m64n256k16``; the
    transposed operands read as they lie, by the hardware (w's rows
    K-major for dx; x M-major, through wgmma's A-transpose bit, for dw);
  * ``wmma`` (bfloat16, rows TMA cannot take): WMMA on 128 x 128 tiles,
    each transposed operand staged as it lies;
  * ``simt`` (float32): the CUDA cores in full float32 (no TF32).

dw's sum over C is split over blocks only where its output tiles alone
leave the card short of them (``bwd_chunk``, by the form's tile), the
splits added in order by a second pass (no atomics).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted, get_kernel
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


def gmm_bwd_cost(xe: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                 ) -> Tuple[int, int]:
    """(FLOPs, bytes) of the gradient: the two products, 4·E·C·d·f; x, w
    and dy read once, dx and dw written once, in x's dtype."""
    E, C, d = xe.shape
    f = w.shape[2]
    n_bytes = xe.element_size() * (2 * E * C * d + 2 * E * d * f + E * C * f)
    return 4 * E * C * d * f, n_bytes


@counted("gmm")
def gmm_torch(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: an einsum in float32, then a cast."""
    _check_shapes(xe, w)
    return torch.einsum("ecd,edf->ecf", xe.to(torch.float32),
                        w.to(torch.float32)).to(xe.dtype)


@counted("gmm")
def gmm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor; its backward the ``gmm_bwd`` kernel."""
    _check_shapes(xe, w)
    if xe.device.type == "cpu" and not _build.is_fake(xe):
        return gmm_torch(xe, w)
    return _KernelGmm.apply(xe, w)


@counted("gmm_bwd")
def gmm_bwd_torch(xe: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """Plain version of the gradient (autograd's through ``gmm_torch``):
    dx = dy·wᵀ and dw = xᵀ·dy as float32 einsums, each cast once to its
    input's dtype."""
    _check_bwd_shapes(xe, w, dy)
    f32 = torch.float32
    g = dy.to(f32)
    dx = torch.einsum("ecf,edf->ecd", g, w.to(f32))
    dw = torch.einsum("ecd,ecf->edf", xe.to(f32), g)
    return dx.to(xe.dtype), dw.to(w.dtype)


@counted("gmm_bwd")
def gmm_bwd(xe: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """The gradient of ``gmm``: the plain version for CPU tensors, the
    ``csrc/moe_bwd.cu`` kernels (one count in ``launches``) for CUDA
    tensors.  Returns (dx, dw)."""
    _check_bwd_shapes(xe, w, dy)
    if xe.device.type == "cpu" and not _build.is_fake(xe):
        return gmm_bwd_torch(xe, w, dy)
    return _launch_bwd(xe, w, dy)


gmm.launches = 0
gmm.last_form = None                # the form of the latest launch
gmm.form_launches = {}              # launches by form
gmm_bwd.launches = 0
gmm_bwd.last_chunk = None           # the latest launch's rows a dw split
gmm_bwd.last_form = None            # the form of the latest launch
gmm_bwd.form_launches = {}          # launches by form

# dw's split of its sum over C (csrc/moe_bwd.cu): enough tiles to fill the
# card twice over, each split at least BWD_MIN_ROWS rows of C, a multiple
# of the form's k slice
BWD_TILES = {"wgmma": (128, 256), "wmma": (128, 128), "simt": (128, 128)}
BWD_K = {"wgmma": 64, "wmma": 32, "simt": 32}   # rows of C a k slice
BWD_TARGET_BLOCKS = 2 * 132
BWD_MIN_ROWS = 256
# the backward's forms, as csrc/moe_bwd.cu's Form numbers them
BWD_FORMS = {"simt": 0, "wmma": 1, "wgmma": 2}


def bwd_chunk(E: int, C: int, d: int, f: int, form: str = "wmma") -> int:
    """Rows of C a split of dw's sum takes: C itself (one split) where
    dw's E·⌈d/TM⌉·⌈f/TN⌉ output tiles of the form (``BWD_TILES``: 128 x
    256 for ``wgmma``, 128 x 128 for the others) already give
    ``BWD_TARGET_BLOCKS``; else C over as many splits as make up the
    difference, at most ⌊C / BWD_MIN_ROWS⌋ and 65535 / E, rounded up to a
    multiple of the form's k slice (``BWD_K``; so each split takes at
    least ``BWD_MIN_ROWS`` rows).  A pure function of the shape and the
    form, so a shape always sums in one order."""
    tm, tn = BWD_TILES[form]
    tiles = E * -(-d // tm) * -(-f // tn)
    splits = min(-(-BWD_TARGET_BLOCKS // max(tiles, 1)), C // BWD_MIN_ROWS,
                 65535 // max(E, 1))
    if splits <= 1:
        return max(C, 1)
    chunk = -(-C // splits)
    chunk = -(-chunk // BWD_K[form]) * BWD_K[form]
    return C if chunk >= C else chunk


def bwd_form(dtype: torch.dtype, d: int, f: int, aligned: bool) -> str:
    """The backward kernel's form: ``wgmma`` for bfloat16 where TMA can
    read the rows (d and f multiples of 8 values, ``aligned``: x, w and dy
    on 16 bytes; the forward's rule), else ``wmma`` (bfloat16) or
    ``simt`` (float32).  Decided by the shape alone, never after a
    failure."""
    if dtype == torch.bfloat16:
        return "wgmma" if d % 8 == 0 and f % 8 == 0 and aligned else "wmma"
    return "simt"


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


def _check_bwd_shapes(xe, w, dy) -> None:
    _check_shapes(xe, w)
    want = (xe.shape[0], xe.shape[1], w.shape[2])
    if tuple(dy.shape) != want:
        raise ValueError(f"gmm_bwd takes dy (E, C, f) = {want}, got "
                         f"{tuple(dy.shape)}")


def _launch(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    fake = _build.is_fake(xe)
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
    chosen = form(xe.dtype, C, d, f, fake or (
        xe.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0))
    part = None
    if chosen == "stream":
        splits = -(-d // DECODE_SPLIT)
        part = torch.empty(splits, E, C, f, dtype=torch.float32, device=dev)
    if fake:
        return out
    _build.launch("moe_gmm", dev, xe.data_ptr(), w.data_ptr(), E, C, d, f,
                  DTYPE_FLAG[xe.dtype], FORMS[chosen],
                  part.data_ptr() if part is not None else None,
                  out.data_ptr())
    gmm.launches += 1
    gmm.last_form = chosen
    gmm.form_launches[chosen] = gmm.form_launches.get(chosen, 0) + 1
    return out


def _launch_bwd(xe: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                chunk: int | None = None):
    """(dx, dw) by ``csrc/moe_bwd.cu`` in the form ``bwd_form`` picks;
    ``chunk`` forces dw's rows a split (default ``bwd_chunk``)."""
    fake = _build.is_fake(xe)
    dev = check_cuda(xe, w, dy)
    if xe.dtype not in DTYPE_FLAG or w.dtype != xe.dtype:
        raise TypeError(f"gmm_bwd takes float32 or bfloat16 of one dtype, "
                        f"got {xe.dtype}, {w.dtype}")
    E, C, d = xe.shape
    f = w.shape[2]
    if C >= 1 << 20 or d >= 1 << 23 or f >= 1 << 23:
        raise ValueError(f"the gmm_bwd kernel takes C < 2^20 and d, f < "
                         f"2^23, got C {C}, d {d}, f {f}")
    xe, w = xe.contiguous(), w.contiguous()
    dy = dy.to(xe.dtype).contiguous()
    dx = torch.empty_like(xe)
    dw = torch.empty_like(w)
    if E == 0 or d == 0 or f == 0 or C == 0:
        # empty products: dx sums over f, dw over C
        return dx.zero_(), dw.zero_()
    chosen = bwd_form(xe.dtype, d, f, fake or all(t.data_ptr() % 16 == 0
                                                  for t in (xe, w, dy)))
    chunk = bwd_chunk(E, C, d, f, chosen) if chunk is None else chunk
    splits = -(-C // chunk)
    if chunk < 1 or (chunk < C and chunk % 32) or E * splits > 65535:
        raise ValueError(f"gmm_bwd's split takes a multiple of 32 rows of C "
                         f"(or C) with E x splits <= 65535, got chunk "
                         f"{chunk} of C {C}, E {E}")
    part = torch.empty(splits, E, d, f, dtype=torch.float32, device=dev) \
        if splits > 1 else None
    if fake:
        return dx, dw
    _build.launch("moe_gmm_bwd", dev, xe.data_ptr(), w.data_ptr(),
                  dy.data_ptr(), E, C, d, f, DTYPE_FLAG[xe.dtype],
                  BWD_FORMS[chosen], chunk,
                  part.data_ptr() if part is not None else None,
                  dx.data_ptr(), dw.data_ptr())
    gmm_bwd.launches += 1
    gmm_bwd.last_chunk = chunk
    gmm_bwd.last_form = chosen
    gmm_bwd.form_launches[chosen] = gmm_bwd.form_launches.get(chosen, 0) + 1
    return dx, dw


class _KernelGmm(torch.autograd.Function):
    """The forward kernel, and the ``gmm_bwd`` kernel as its backward."""

    @staticmethod
    def forward(ctx, xe, w):
        ctx.save_for_backward(xe, w)
        return _launch(xe, w)

    @staticmethod
    def backward(ctx, grad):
        xe, w = ctx.saved_tensors
        return get_kernel("gmm_bwd")(xe, w, grad)
