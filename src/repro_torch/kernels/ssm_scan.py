"""The Mamba selective scan (jamba's recurrent token mixer), after the
mixer's three products:

    x (B, S, di), dt_pre (B, S, di) float32, dt_bias (di,), Bm, Cm (B, S, ds)
    float32, A_log (di, ds) float32, D (di,) float32, h0 (B, di, ds) float32
    or None  ->  out (B, S, di) in x's dtype, h (B, di, ds) float32

Each step t, in float32 (``x32`` = x as float32):

    dt  = softplus(dt_pre[t] + dt_bias)        (JAX's logaddexp(v, 0) form)
    h   = exp(dt ⊗ A) ⊙ h + (dt · x32[t]) ⊗ Bm[t],   A = -exp(A_log)
    out = h · Cm[t] + D ⊙ x32[t]

which is ``mamba_mix`` of ``src/repro/models/mamba.py:61-111`` once its
products are taken (``dt_pre = (x32 @ x_dt) @ dt_proj``, ``Bm = x32 @ x_B``,
``Cm = x32 @ x_C``; ``models.mamba`` takes them in float32 ``torch.matmul``,
as the JAX package leaves them to XLA).  S = 1 is the decode step
(``mamba.py:80-86``), the same launch.

Kernel: replaces no Pallas kernel.  The JAX package scans with
``jax.lax.associative_scan`` inside chunks of 128 steps
(``src/repro/models/mamba.py:46``) and ``lax.scan`` over the chunks; plain
PyTorch has neither, and a plain port must loop the steps from Python (a
few launches a step and a layer) or build (B, 128, di, ds) float32
tensors a chunk (537 MB at jamba's width and batch 4).  The CUDA kernel
(``csrc/ssm.cu`` ``ssm_scan_kernel``) is one launch a call: a thread a
(batch row, channel) keeps its ``DS`` states, the channel's A and D in
registers; a block takes ``CHANNELS`` channels of one batch row, grid
(ceil(di / CHANNELS), B).  The steps go in tiles of ``TILE`` through two
shared-memory buffers: while a tile runs, the block's ``cp.async`` copies
bring the next tile's x and dt_pre columns and B and C rows; a tile first
takes its ``TILE`` softplus values, then the steps, each decay one
multiply and one SFU ``ex2``.  It is built for ds = ``DS`` (16: jamba's,
and every config's) and refuses another; di must be a multiple of 8
(16-byte pieces of its rows).

Bound: the exponentials.  Each (b, t, channel) takes ds of them for the
decays and one for the softplus, on the SFUs at ``SFU_PER_CLOCK`` an SM a
clock (``exp_count``; 4.6e9 at jamba's prefill (4, 4,096, 16,384, 16),
about 1.1 ms at the H100's 1.98 GHz boost clock); its bytes (x and out in
the model's dtype, dt_pre in float32: 8 bytes a (b, t, channel) in
bfloat16, 2.15 GB there) take 0.64 ms at 3.35 TB/s, and its float32
arithmetic (``ssm_scan_cost``'s FLOPs) 0.4 ms at the CUDA cores' 67
TFLOP/s.  ``bound_ms`` takes the largest.

Autograd: the card has no backward kernel for the scan yet (ROADMAP.md
queue 1 item 12); a call on CUDA tensors of which one requires grad,
where autograd records, raises ``NotImplementedError`` rather than fall
back.  On the CPU the plain version differentiates as any PyTorch code.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG

DS = 16                             # csrc/ssm.cu kDs: the state size built
CHANNELS = 128                      # channels (threads) a block, kChannels
TILE = 16                           # steps a tile, kTile
ALIGN = 8                           # di a multiple of this (16-byte rows)
# float32 operations a (b, t, channel, state): the decay's product,
# dt·x times B, the update's multiply-add, and h·C's multiply-add
FLOPS_PER_STATE = 6
# the SFUs' exponentials an SM a clock on Hopper (sm_90), and the H100
# SXM's boost clock
SFU_PER_CLOCK = 16
SM_COUNT = 132
BOOST_HZ = 1.98e9
CUDA_CORE_FLOPS = 67e12             # H100 SXM float32 off the tensor cores
HBM_BYTES_PER_S = 3.35e12
# How far the kernel may sit from the plain version: both follow the
# same float32 recurrence step for step, but the kernel fuses the update
# and h·C into multiply-adds, takes each decay as the SFU's 2^(dt · A
# log2 e) (2 ulp, A log2 e rounded once, a decay under 2^-126 flushed to
# 0) and the softplus's expf / log1pf from CUDA's library;
# the decays exp(dt·A) < 1 damp each step's rounding, so the gap stays at
# a few float32 steps of the output (bfloat16 outputs: one bfloat16 step)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)


def kernel_tol(want: torch.Tensor) -> dict:
    """``assert_close`` tolerances of a kernel result against ``want``, the
    plain version's: ``KERNEL_TOL``, and one bfloat16 step (rtol 2^-7)
    where the output rounds to bfloat16."""
    return dict(KERNEL_TOL, rtol=2 ** -7) \
        if want.dtype == torch.bfloat16 else dict(KERNEL_TOL)
BACKWARD_ENTRY = ("the ssm_scan backward kernel, ROADMAP.md queue 1 item "
                  "12 (training jamba on the card waits for it)")


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(v, 0)``: max(v, 0) + log1p(exp(-|v|))
    (not ``F.softplus``'s threshold form)."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


def _check_shapes(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0) -> None:
    if x.dim() != 3:
        raise ValueError(f"ssm_scan takes x (B, S, di), got {tuple(x.shape)}")
    B, S, di = x.shape
    ds = A_log.shape[-1]
    want = {"dt_pre": (dt_pre, (B, S, di)), "dt_bias": (dt_bias, (di,)),
            "Bm": (Bm, (B, S, ds)), "Cm": (Cm, (B, S, ds)),
            "A_log": (A_log, (di, ds)), "D": (D, (di,))}
    if h0 is not None:
        want["h0"] = (h0, (B, di, ds))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} is {tuple(t.shape)}, "
                             f"want {shape}")


def ssm_scan_cost(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0=None
                  ) -> Tuple[int, int]:
    """(FLOPs, bytes) of the scan: ``FLOPS_PER_STATE`` float32 operations a
    (b, t, channel, state); x, dt_pre, Bm, Cm, the weights and h0 read
    once, out and the last state written once."""
    B, S, di = x.shape
    ds = A_log.shape[-1]
    flops = FLOPS_PER_STATE * B * S * di * ds
    state = 4 * B * di * ds
    n_bytes = (2 * x.element_size() * B * S * di + 4 * B * S * di
               + 2 * 4 * B * S * ds + 4 * di * (ds + 2)
               + dt_bias.element_size() * di
               + state * (2 if h0 is not None else 1))
    return flops, n_bytes


def exp_count(x, A_log) -> int:
    """Exponentials a call takes: ds decays and the softplus's one for
    every (b, t, channel)."""
    B, S, di = x.shape
    return B * S * di * (A_log.shape[-1] + 1)


def bound_ms(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0=None) -> dict:
    """The least time an H100 could take for the call: the exponentials
    over the SFUs' rate, the FLOPs over the CUDA cores' float32 rate and
    the bytes over the memory rate, the largest (``bound_by``
    "operations" unless the bytes win)."""
    flops, n_bytes = ssm_scan_cost(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    exps_ms = exp_count(x, A_log) / (SFU_PER_CLOCK * SM_COUNT * BOOST_HZ) \
        * 1e3
    ops_ms = max(exps_ms, flops / CUDA_CORE_FLOPS * 1e3)
    mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, mem_ms), "exps_ms": exps_ms,
            "flops_ms": flops / CUDA_CORE_FLOPS * 1e3, "bytes_ms": mem_ms,
            "bound_by": "operations" if ops_ms > mem_ms else "bytes"}


@counted("ssm_scan")
def ssm_scan_torch(x, dt_pre, dt_bias, Bm, Cm, A_log, D,
                   h0: Optional[torch.Tensor] = None):
    """Plain version: a sequential loop over the steps in float32 (the
    CPU's path and the tests' reference; never the card's main path)."""
    _check_shapes(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    B, S, di = x.shape
    x32 = x.to(torch.float32)
    dt = softplus(dt_pre.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))
    h = torch.zeros(B, di, A.shape[-1], dtype=torch.float32,
                    device=x.device) if h0 is None else h0.to(torch.float32)
    Bf, Cf = Bm.to(torch.float32), Cm.to(torch.float32)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + (dt[:, t] * x32[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else torch.zeros_like(x32)
    out = y + D.to(torch.float32) * x32
    return out.to(x.dtype), h


def _launch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0):
    """One launch of ``csrc/ssm.cu``'s kernel on CUDA tensors."""
    dev = check_cuda(x, dt_pre, dt_bias, Bm, Cm, A_log, D,
                     *([h0] if h0 is not None else []))
    B, S, di = x.shape
    if A_log.shape[-1] != DS:
        raise ValueError(f"the ssm_scan kernel is built for ds = {DS}, got "
                         f"{A_log.shape[-1]}")
    if di % ALIGN:
        raise ValueError(f"the ssm_scan kernel takes di a multiple of "
                         f"{ALIGN}, got {di}")
    if x.dtype not in DTYPE_FLAG:
        raise TypeError(f"ssm_scan takes x in float32 or bfloat16, got "
                        f"{x.dtype}")

    def f32(t):
        t = t.to(torch.float32).contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    x = x.contiguous()
    x = x if x.data_ptr() % 16 == 0 else x.clone()
    args = [f32(t) for t in (dt_pre, dt_bias, Bm, Cm, A_log, D)]
    h0 = f32(h0) if h0 is not None else None
    out = torch.empty_like(x)
    h = torch.empty(B, di, DS, dtype=torch.float32, device=dev)
    if B and di:
        _build.launch("ssm_scan", dev, x.data_ptr(),
                      *(t.data_ptr() for t in args),
                      h0.data_ptr() if h0 is not None else None, B, S, di,
                      DS, DTYPE_FLAG[x.dtype], out.data_ptr(), h.data_ptr())
        ssm_scan.launches += 1
    return out, h


@counted("ssm_scan")
def ssm_scan(x, dt_pre, dt_bias, Bm, Cm, A_log, D,
             h0: Optional[torch.Tensor] = None):
    """The selective scan: (out (B, S, di) in x's dtype, last state (B, di,
    ds) float32).  The plain version for CPU tensors, one launch of the
    CUDA kernel for CUDA tensors (raising where autograd records: the
    backward kernel is still to come)."""
    _check_shapes(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    if x.device.type == "cpu":
        return ssm_scan_torch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)):
        raise NotImplementedError(f"ssm_scan has no backward on the card "
                                  f"yet: {BACKWARD_ENTRY}")
    return _launch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)


ssm_scan.launches = 0
