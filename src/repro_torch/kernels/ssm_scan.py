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
(batch row, channel) keeps its ``DS`` states in registers with the
channel's A and D; a block takes ``CHANNELS`` channels of one batch row,
grid (ceil(di / CHANNELS), B).  The steps go in tiles of ``TILE`` through
two shared-memory buffers: while a tile runs, the block's ``cp.async``
copies bring the next tile's x and dt_pre columns and B and C rows; each
step takes its softplus by one SFU ``ex2`` and a polynomial for log1p,
then each decay by one multiply and one SFU ``ex2``; a tile's outputs
leave as 16-byte stores.  ``tools/bwd_split.py`` times the layouts it
was chosen from (2 or 4 threads a channel, other blocks and tiles).  It
is built for ds = ``DS`` (16: jamba's, and every config's) and refuses
another; di must be a multiple of 8 (16-byte pieces of its rows).

Bound: the exponentials.  Each (b, t, channel) takes ds of them for the
decays and one for the softplus, on the SFUs at ``SFU_PER_CLOCK`` an SM a
clock (``exp_count``; 4.6e9 at jamba's prefill (4, 4,096, 16,384, 16),
about 1.1 ms at the H100's 1.98 GHz boost clock); its bytes (x and out in
the model's dtype, dt_pre in float32: 8 bytes a (b, t, channel) in
bfloat16, 2.15 GB there) take 0.64 ms at 3.35 TB/s, and its float32
arithmetic (``ssm_scan_cost``'s FLOPs) 0.4 ms at the CUDA cores' 67
TFLOP/s.  ``bound_ms`` takes the largest.

The gradient, ``ssm_scan_bwd`` (``csrc/ssm_bwd.cu``), replaces no TPU
kernel either (the JAX package differentiates its associative scan).
Where autograd records on the card (``_KernelSsm``), the forward also
writes the state entering every ``CHUNK``-th step, ``ckpt`` (B, ceil(S /
CHUNK), di, ds) float32 (``ssm_checkpoints_torch`` is its plain version);
the backward kernel walks the chunks from the last, recomputes each
chunk's states from its entry into registers, and runs the recurrence
back (``ssm_scan_bwd_torch`` spells out the formulas).  A thread takes
``BWD_THREAD_CHANNELS`` channels of one batch row by ``DS / BWD_LANES``
states, so that the sums over the states (u, the A·q sum) and over the
channels (dBm, dCm) begin in its registers; ``BWD_LANES`` threads share a
channel and ``BWD_CHANNELS`` channels a block.  The channel sums go out as
per-block partials and the sums over the batch rows (dA_log, dD,
ddt_bias) as per-row partials, both added in a fixed order by a second
small kernel: no atomics, two launches bit-equal.  The spacing ``CHUNK``
is the backward's: 8 steps of a thread's 16 (channel, state) pairs fit its
registers, 16 would not.  Bound (``bwd_bound_ms``): what the gradient
itself needs from saved states, whatever the kernel does: each decay and
the softplus's exponential once, the step back's float32 FLOPs, its
inputs read and outputs written once, the saved states at a spacing of
``BOUND_CHUNK`` (not the kernel's denser spacing, recomputed states,
second decays or partial sums), the largest.  On the CPU autograd
differentiates the plain loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted, get_kernel
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG

DS = 16                             # csrc/ssm.cuh kDs: the state size built
CHUNK = 8                           # steps between saved states, kChunk
# the spacing of saved states that the backward's bound counts (the
# first backward kernel's); the kernel's denser CHUNK is its design's
# cost, not the gradient's
BOUND_CHUNK = 16
CHANNELS = 64                       # csrc/ssm.cu kChannels, a block's
TILE = 16                           # steps a tile, kTile
# csrc/ssm_bwd.cu's layout: threads a channel (kGroups), channels a thread
# (kCh), warps a block (kWarps), channels a block (kChannels)
BWD_LANES = 4
BWD_THREAD_CHANNELS = 4
BWD_WARPS = 2
BWD_CHANNELS = BWD_WARPS * 32 // BWD_LANES * BWD_THREAD_CHANNELS
ALIGN = 8                           # di a multiple of this (16-byte rows)
# float32 operations a (b, t, channel, state): the decay's product,
# dt·x times B, the update's multiply-add, and h·C's multiply-add
FLOPS_PER_STATE = 6
# the gradient's: the step back (the decay's product, g's multiply-add,
# dC's and dB's products, u's multiply-add, q's two products, A·q's and
# dA's multiply-adds, the carry's product: 14) and the sums of dB and dC
# over the channels (2); the kernel's recomputed states (4 more) are its
# design's, not the gradient's
BWD_FLOPS_PER_STATE = 16
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
# 0) and the softplus's exp(-|v|) the same way and its log1p by a
# polynomial within 2.5e-7 of it relative; the decays exp(dt·A) < 1 damp
# each step's rounding, so the gap stays at a few float32 steps of the
# output (bfloat16 outputs: one bfloat16 step)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
# How far the backward kernel may sit from the plain backward on the same
# inputs: both take the reverse recurrence in float32, the kernel from
# states it recomputes by the forward kernel's arithmetic, its decays on
# the SFU as the forward's; the carry g passes back through the decays <
# 1, which damp a step's rounding as in the forward.  The sums over many
# terms are taken in other orders: dBm and dCm over the di channels
# (16,384 at jamba's width) and dA_log, dD and ddt_bias over the B·S steps
# (8,192 at jamba's training scan), whose float32 rounding grows as the
# square root of the terms while the terms' signs cancel the sum to the
# same order: rtol 1e-3, and 1e-4 of the largest gradient of its tensor
# (dx in bfloat16: one bfloat16 step)
KERNEL_BWD_TOL = dict(rtol=1e-3, atol_of_max=1e-4)


def kernel_tol(want: torch.Tensor) -> dict:
    """``assert_close`` tolerances of a kernel result against ``want``, the
    plain version's: ``KERNEL_TOL``, and one bfloat16 step (rtol 2^-7)
    where the output rounds to bfloat16."""
    return dict(KERNEL_TOL, rtol=2 ** -7) \
        if want.dtype == torch.bfloat16 else dict(KERNEL_TOL)


def kernel_bwd_tol(want: torch.Tensor) -> dict:
    """``assert_close`` tolerances of a backward-kernel result against
    ``want``, the plain backward's (see ``KERNEL_BWD_TOL``)."""
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    rtol = max(KERNEL_BWD_TOL["rtol"],
               2 ** -7 if want.dtype == torch.bfloat16 else 0.0)
    return dict(rtol=rtol, atol=KERNEL_BWD_TOL["atol_of_max"] * scale)


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


def n_chunks(S: int) -> int:
    """Saved states of a scan of S steps: one entering every CHUNK-th."""
    return -(-S // CHUNK)


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


def _bound(exps: int, flops: int, n_bytes: int) -> dict:
    """The largest of the exponentials over the SFUs' rate, the FLOPs over
    the CUDA cores' float32 rate and the bytes over the memory rate
    (``bound_by`` "operations" unless the bytes win)."""
    exps_ms = exps / (SFU_PER_CLOCK * SM_COUNT * BOOST_HZ) * 1e3
    flops_ms = flops / CUDA_CORE_FLOPS * 1e3
    ops_ms = max(exps_ms, flops_ms)
    mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, mem_ms), "exps_ms": exps_ms,
            "flops_ms": flops_ms, "bytes_ms": mem_ms,
            "bound_by": "operations" if ops_ms > mem_ms else "bytes"}


def bound_ms(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0=None) -> dict:
    """The least time an H100 could take for the call (``_bound`` of
    ``exp_count`` and ``ssm_scan_cost``)."""
    return _bound(exp_count(x, A_log),
                  *ssm_scan_cost(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0))


def ssm_scan_bwd_cost(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt, dout,
                      dh_last) -> Tuple[int, int]:
    """(FLOPs, bytes) the gradient needs: ``BWD_FLOPS_PER_STATE`` float32
    operations a (b, t, channel, state); x, dt_pre, dout, Bm, Cm, the
    saved states at a spacing of ``BOUND_CHUNK`` (537 MB at jamba's
    training scan; the kernel's ``ckpt``, at ``CHUNK``, is twice that),
    the weights, h0 and dh_last read once; dx, ddt_pre, dBm, dCm, the
    weights' gradients and dh0 written once.  The kernel's partial sums
    and its denser saved states are its design's and not counted."""
    B, S, di = x.shape
    ds = A_log.shape[-1]
    flops = BWD_FLOPS_PER_STATE * B * S * di * ds
    state = 4 * B * di * ds
    saved = 4 * B * -(-S // BOUND_CHUNK) * di * ds
    n_bytes = (x.element_size() * B * S * di * 3 + 4 * B * S * di * 2
               + 4 * B * S * ds * 4 + saved
               + 2 * (4 * di * (ds + 2) + dt_bias.element_size() * di)
               + state * ((2 if h0 is not None else 0)
                          + (1 if dh_last is not None else 0)))
    return flops, n_bytes


def bwd_exp_count(x, A_log) -> int:
    """Exponentials the gradient needs: each of the ds decays once (the
    kernel takes them twice, recomputing the chunk's states, then on the
    step back: its design's cost) and one for the softplus and its
    sigmoid, for every (b, t, channel)."""
    B, S, di = x.shape
    return B * S * di * (A_log.shape[-1] + 1)


def bwd_bound_ms(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt, dout,
                 dh_last=None) -> dict:
    """The least time an H100 could take for the gradient (``_bound`` of
    ``bwd_exp_count`` and ``ssm_scan_bwd_cost``)."""
    return _bound(bwd_exp_count(x, A_log),
                  *ssm_scan_bwd_cost(x, dt_pre, dt_bias, Bm, Cm, A_log, D,
                                     h0, ckpt, dout, dh_last))


def _states(x, dt_pre, dt_bias, Bm, A_log, h0):
    """(dt, A, x32, Bf, every state h_0 .. h_S) of the plain recurrence in
    float32, h_0 the entering state."""
    B, S, di = x.shape
    x32 = x.to(torch.float32)
    dt = softplus(dt_pre.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))
    h = torch.zeros(B, di, A.shape[-1], dtype=torch.float32,
                    device=x.device) if h0 is None else h0.to(torch.float32)
    Bf = Bm.to(torch.float32)
    hs = [h]
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x32[:, t])[..., None] * Bf[:, t, None, :]
        hs.append(h)
    return dt, A, x32, Bf, hs


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


def ssm_checkpoints_torch(x, dt_pre, dt_bias, Bm, A_log, h0=None
                          ) -> torch.Tensor:
    """Plain version of the states the forward kernel saves where autograd
    records: (B, ceil(S / CHUNK), di, ds) float32, entry j the state
    entering step j·CHUNK."""
    with torch.no_grad():
        hs = _states(x, dt_pre, dt_bias, Bm, A_log, h0)[-1]
    B, S, di = x.shape
    if not S:
        return torch.empty(B, 0, di, A_log.shape[-1], device=x.device)
    return torch.stack(hs[:-1:CHUNK], 1)


@counted("ssm_scan_bwd")
def ssm_scan_bwd_torch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt, dout,
                       dh_last=None):
    """Plain version of the gradient: the explicit reverse scan in float32,
    every state recomputed from h0 (``ckpt``, the kernel's saved states,
    is not read).  With g_t = dL/dh_t, from dh_last (or zeros), and
    decay_t = exp(dt_t·A):

        g_t   = dout_t ⊗ C_t + decay_{t+1} ⊙ g_{t+1}
        u_t   = g_t · B_t;  dx_t = dt_t u_t + D dout_t
        ddt_t = x_t u_t + Σ_n A decay_t g_t h_{t-1};  ddt_pre = ddt sigmoid(v)
        dBm_t = Σ_c g_t dt_t x_t;  dCm_t = Σ_c dout_t h_t
        dA_log = A Σ_{b,t} dt_t decay_t g_t h_{t-1};  dD = Σ dout x;
        ddt_bias = Σ ddt_pre;  dh0 = decay_0 ⊙ g_0

    Returns (dx, ddt_pre, ddt_bias, dBm, dCm, dA_log, dD, dh0), each in
    its input's dtype (dh0 float32, None without h0)."""
    _check_shapes(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    B, S, di = x.shape
    ds = A_log.shape[-1]
    dt, A, x32, Bf, hs = _states(x, dt_pre, dt_bias, Bm, A_log, h0)
    v = dt_pre.to(torch.float32) + dt_bias.to(torch.float32)
    Cf, dy = Cm.to(torch.float32), dout.to(torch.float32)
    G = torch.zeros(B, di, ds, device=x.device) if dh_last is None \
        else dh_last.to(torch.float32)
    dA = torch.zeros(di, ds, device=x.device)
    dx = torch.empty(B, S, di, device=x.device)
    ddt = torch.empty(B, S, di, device=x.device)
    dBm = torch.empty(B, S, ds, device=x.device)
    dCm = torch.empty(B, S, ds, device=x.device)
    for t in reversed(range(S)):
        decay = torch.exp(dt[:, t, :, None] * A)
        g = dy[:, t, :, None] * Cf[:, t, None, :] + G
        dCm[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy[:, t])
        dBm[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x32[:, t])
        u = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        q = decay * g * hs[t]
        dx[:, t] = dt[:, t] * u + D.to(torch.float32) * dy[:, t]
        ddt[:, t] = x32[:, t] * u + (q * A).sum(-1)
        dA += (dt[:, t, :, None] * q).sum(0)
        G = decay * g
    ddt_pre = ddt * torch.sigmoid(v)
    return (dx.to(x.dtype), ddt_pre.to(dt_pre.dtype),
            ddt_pre.sum((0, 1)).to(dt_bias.dtype), dBm.to(Bm.dtype),
            dCm.to(Cm.dtype), (dA * A).to(A_log.dtype),
            (dy * x32).sum((0, 1)).to(D.dtype),
            G if h0 is not None else None)


def _refuse(x, A_log) -> None:
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


def _f32(t):
    """float32, contiguous, on a 16-byte boundary (the kernels' copies)."""
    return _aligned(t.to(torch.float32))


def _aligned(t):
    t = t.contiguous()
    if _build.is_fake(t):                   # no address: taken as aligned
        return t
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt: bool = False):
    """One launch of ``csrc/ssm.cu``'s kernel on CUDA tensors: (out, h),
    and with ``ckpt`` the saved states (B, ceil(S / CHUNK), di, ds)
    float32 too; on fake tensors the same allocations and no launch."""
    fake = _build.is_fake(x)
    dev = check_cuda(
        x, dt_pre, dt_bias, Bm, Cm, A_log, D,
        *([h0] if h0 is not None else []))
    _refuse(x, A_log)
    B, S, di = x.shape
    x = _aligned(x)
    args = [_f32(t) for t in (dt_pre, dt_bias, Bm, Cm, A_log, D)]
    h0 = _f32(h0) if h0 is not None else None
    out = torch.empty_like(x)
    h = torch.empty(B, di, DS, dtype=torch.float32, device=dev)
    saved = torch.empty(B, n_chunks(S), di, DS, dtype=torch.float32,
                        device=dev) if ckpt else None
    if B and di and not fake:
        _build.launch("ssm_scan", dev, x.data_ptr(),
                      *(t.data_ptr() for t in args), _ptr(h0), B, S, di,
                      DS, DTYPE_FLAG[x.dtype], out.data_ptr(), h.data_ptr(),
                      _ptr(saved))
        ssm_scan.launches += 1
    return (out, h, saved) if ckpt else (out, h)


def bwd_scratch_shapes(B: int, S: int, di: int) -> dict:
    """The backward kernel's float32 scratch: ``part_bc``, each block's
    dBm | dCm terms a step (a block takes ``BWD_CHANNELS`` channels), and
    ``part_ch``, each row's dA, dD and ddt_bias terms a channel."""
    return {"part_bc": (B, S, -(-di // BWD_CHANNELS), 2 * DS),
            "part_ch": (B, di, DS + 2)}


def _launch_bwd(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt, dout,
                dh_last):
    """``csrc/ssm_bwd.cu`` on CUDA tensors (its two kernels counted as one
    launch): (dx in x's dtype, ddt_pre, ddt_bias, dBm, dCm, dA_log, dD
    float32, dh0 float32 or None); on fake tensors the same allocations
    and no launch."""
    fake = _build.is_fake(x)
    dev = check_cuda(
        x, dt_pre, dt_bias, Bm, Cm, A_log, D, ckpt, dout,
        *(t for t in (h0, dh_last) if t is not None))
    _refuse(x, A_log)
    B, S, di = x.shape
    if tuple(ckpt.shape) != (B, n_chunks(S), di, DS) or \
            tuple(dout.shape) != (B, S, di):
        raise ValueError(f"ssm_scan_bwd takes the saved states (B, ceil(S / "
                         f"{CHUNK}), di, ds) and dout (B, S, di), got "
                         f"{tuple(ckpt.shape)}, {tuple(dout.shape)}")
    f32 = dict(dtype=torch.float32, device=dev)
    x = _aligned(x)
    dout = _aligned(dout.to(x.dtype))
    args = [_f32(t) for t in (dt_pre, dt_bias, Bm, Cm, A_log, D, ckpt)]
    dh_last = _f32(dh_last) if dh_last is not None else None
    scratch = bwd_scratch_shapes(B, S, di)
    part_bc = torch.empty(scratch["part_bc"], **f32)
    part_ch = torch.empty(scratch["part_ch"], **f32)
    dx = torch.empty_like(x)
    outs = [torch.empty(B, S, di, **f32), torch.empty(B, S, DS, **f32),
            torch.empty(B, S, DS, **f32), torch.empty(di, DS, **f32),
            torch.empty(di, **f32), torch.empty(di, **f32)]
    dh0 = torch.empty(B, di, DS, **f32) if h0 is not None else None
    if fake:
        ddt_pre, dBm, dCm, dA_log, dD, ddt_bias = outs
        return dx, ddt_pre, ddt_bias, dBm, dCm, dA_log, dD, dh0
    _build.launch("ssm_scan_bwd", dev, x.data_ptr(),
                  *(t.data_ptr() for t in args), dout.data_ptr(),
                  _ptr(dh_last), B, S, di, DS, DTYPE_FLAG[x.dtype],
                  part_bc.data_ptr(), part_ch.data_ptr(), dx.data_ptr(),
                  *(t.data_ptr() for t in outs), _ptr(dh0))
    ssm_scan_bwd.launches += 1
    ddt_pre, dBm, dCm, dA_log, dD, ddt_bias = outs
    return dx, ddt_pre, ddt_bias, dBm, dCm, dA_log, dD, dh0


class _KernelSsm(torch.autograd.Function):
    """The forward kernel saving its chunks' entering states, and the
    ``ssm_scan_bwd`` kernel as its backward."""

    @staticmethod
    def forward(ctx, x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0):
        out, h, ckpt = _launch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0,
                               ckpt=True)
        ctx.save_for_backward(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt)
        return out, h

    @staticmethod
    def backward(ctx, dout, dh):
        x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(x)
        grads = get_kernel("ssm_scan_bwd")(x, dt_pre, dt_bias, Bm, Cm,
                                           A_log, D, h0, ckpt, dout, dh)
        return tuple(None if g is None else g.to(t.dtype)
                     for g, t in zip(grads, (x, dt_pre, dt_bias, Bm, Cm,
                                             A_log, D, h0)))


@counted("ssm_scan")
def ssm_scan(x, dt_pre, dt_bias, Bm, Cm, A_log, D,
             h0: Optional[torch.Tensor] = None):
    """The selective scan: (out (B, S, di) in x's dtype, last state (B, di,
    ds) float32).  The plain version for CPU tensors, one launch of the
    CUDA kernel for CUDA tensors; where autograd records, through
    ``_KernelSsm`` (the saved states, and the ``ssm_scan_bwd`` kernel as
    its backward)."""
    _check_shapes(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    if x.device.type == "cpu" and not _build.is_fake(x):
        return ssm_scan_torch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)):
        return _KernelSsm.apply(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    return _launch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)


@counted("ssm_scan_bwd")
def ssm_scan_bwd(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt, dout,
                 dh_last=None):
    """The gradient of ``ssm_scan``: the plain version for CPU tensors, the
    ``csrc/ssm_bwd.cu`` kernel (one count in ``launches`` a call) for CUDA
    tensors.  Returns (dx, ddt_pre, ddt_bias, dBm, dCm, dA_log, dD, dh0)
    as ``ssm_scan_bwd_torch`` does."""
    _check_shapes(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
    if x.device.type == "cpu" and not _build.is_fake(x):
        return ssm_scan_bwd_torch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0,
                                  ckpt, dout, dh_last)
    dx, ddt_pre, ddt_bias, dBm, dCm, dA_log, dD, dh0 = _launch_bwd(
        x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt, dout, dh_last)
    return (dx, ddt_pre.to(dt_pre.dtype), ddt_bias.to(dt_bias.dtype),
            dBm.to(Bm.dtype), dCm.to(Cm.dtype), dA_log.to(A_log.dtype),
            dD.to(D.dtype), dh0)


ssm_scan.launches = 0
ssm_scan_bwd.launches = 0
