"""The sLSTM time scan (the xLSTM's sequential recurrence):

    wx (B, S, 4d), r_gates (nh, dh, 4·dh), state h, c, n, m (B, d) float32
        ->  y (B, S, d) float32, (h, c, n, m) at the end

``wx`` holds the input's gate pre-activations, gate-major ([zi | ii | ff |
oo], each d wide), in the model's dtype; ``r_gates`` the block-diagonal
recurrent weights, per head [zi | ii | ff | oo] each dh wide, in wx's
dtype.  Each step adds the per-head ``h @ r_gates`` (in float32,
rearranged to the gate-major layout) to ``wx[:, t]`` and applies
``slstm_cell``, the stabilised exponential-gate update of the JAX
package's ``xlstm._slstm_cell``; any S (decode's S = 1 included).

Kernel: replaces the Pallas ``_kernel`` of
``src/repro/kernels/slstm_scan.py:25`` (``pallas_call`` at ``:93``), which
asserts ``S % block_t == 0`` and takes the block-diagonal weights expanded
to a dense (d, 4d) (``expand_block_diag``; kept here for the test that
holds the port to the JAX kernel), 3/4 zeros.  The CUDA kernel
(``csrc/slstm.cu``) takes ``r_gates`` as it is.  Bound: operations, the
recurrence's 8·B·S·d·dh float32 FLOPs over the float32 rate (above the
bytes of wx, y and the state), along a chain of S dependent steps.
Design: ONE cooperative launch for the whole scan, d / U blocks of U
state dimensions (128 at xlstm-1.3b), each keeping its weights in shared
memory and its state in registers, a grid barrier per step, h exchanged through a
double-buffered array in device memory.  The blocks must all be resident
at once: the launcher checks that and refuses otherwise (no fallback).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

MAX_BATCH = 16
THREADS = 512                       # csrc/slstm.cu kThreads
SMEM_LIMIT = 232_448                # bytes of shared memory a block can use
# How far the kernel may sit from the plain version: both compute in
# float32, the recurrent sums in another order and exp / tanh / log1p
# from other libraries; the state stays bounded (|h| <= 1, n and c grow
# at most by one a step), so the gap stays at float32 rounding of the
# sums, times the steps that carry it.
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)


def slstm_cell(r: torch.Tensor, carry: State, wx_t: torch.Tensor):
    """One step: r (nh, dh, 4·dh) float32, carry 4 x (B, d) float32, wx_t
    (B, 4d).  Returns (new carry, h)."""
    nh, dh = r.shape[0], r.shape[1]
    d = nh * dh
    h, c, n, m = carry
    rec = torch.einsum("bhd,hde->bhe", h.reshape(-1, nh, dh), r)
    rec = rec.reshape(-1, nh, 4, dh).transpose(1, 2).reshape(-1, 4 * d)
    zi, ii, ff, oo = (wx_t.to(torch.float32) + rec).chunk(4, dim=-1)
    logf = F.logsigmoid(ff)
    m_new = torch.maximum(logf + m, ii)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(ii - m_new)
    c_new = fw * c + iw * torch.tanh(zi)
    n_new = fw * n + iw
    h_new = torch.sigmoid(oo) * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new), h_new


def slstm_scan_torch(wx: torch.Tensor, r_gates: torch.Tensor, h, c, n, m):
    """Plain version: a per-step loop of ``slstm_cell``."""
    _check_shapes(wx, r_gates, h, c, n, m)
    r = r_gates.to(torch.float32)
    carry = (h, c, n, m)
    ys = []
    for t in range(wx.shape[1]):
        carry, h_t = slstm_cell(r, carry, wx[:, t])
        ys.append(h_t)
    B, d = h.shape
    y = torch.stack(ys, 1) if ys else torch.empty(B, 0, d, device=h.device)
    return y, carry


def slstm_scan(wx: torch.Tensor, r_gates: torch.Tensor, h, c, n, m):
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor (no backward through the kernel)."""
    _check_shapes(wx, r_gates, h, c, n, m)
    if wx.device.type == "cpu":
        return slstm_scan_torch(wx, r_gates, h, c, n, m)
    y, *carry = _KernelScan.apply(wx, r_gates, h, c, n, m)
    return y, tuple(carry)


slstm_scan.launches = 0


def expand_block_diag(r_gates: torch.Tensor) -> torch.Tensor:
    """(nh, dh, 4·dh) block-diagonal weights -> the dense (d, 4d) with the
    same action (``h @ out`` is the gate-major recurrence), the JAX
    kernel's input."""
    nh, dh, _ = r_gates.shape
    d = nh * dh
    out = r_gates.new_zeros(d, 4 * d)
    for hd in range(nh):
        for g in range(4):
            out[hd * dh:(hd + 1) * dh, g * d + hd * dh:g * d + (hd + 1) * dh] \
                = r_gates[hd, :, g * dh:(g + 1) * dh]
    return out


def _check_shapes(wx, r_gates, *state) -> None:
    ok = wx.dim() == 3 and r_gates.dim() == 3 \
        and r_gates.shape[2] == 4 * r_gates.shape[1]
    if ok:
        B, _, d4 = wx.shape
        d = r_gates.shape[0] * r_gates.shape[1]
        ok = d4 == 4 * d and all(s.shape == (B, d) for s in state)
    if not ok:
        raise ValueError(f"slstm_scan takes wx (B, S, 4d), r_gates (nh, dh, "
                         f"4dh) and h, c, n, m (B, d) with d = nh dh, got "
                         f"{tuple(wx.shape)}, {tuple(r_gates.shape)}, "
                         f"{[tuple(s.shape) for s in state]}")
    if any(s.dtype != torch.float32 for s in state):
        raise TypeError(f"slstm_scan's state is float32, got "
                        f"{[s.dtype for s in state]}")


def plan(B: int, dh: int) -> Tuple[int, int]:
    """(U, shared-memory bytes) of one launch of B rows: U state dimensions
    a block, the largest power of two up to 16 dividing dh.  Raises
    ``ValueError`` for a batch one launch cannot hold."""
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"the slstm_scan kernel takes 1 to {MAX_BATCH} "
                         f"batch rows, got {B}")
    U = 16
    while dh % U:
        U //= 2
    J = 4 * U
    smem = 4 * (dh * J + B * dh + (THREADS // J) * B * J)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the slstm_scan kernel holds a head of {dh} "
                         f"dimensions x {B} rows in {smem} bytes of shared "
                         f"memory, over the {SMEM_LIMIT} a block can use")
    return U, smem


def _launch(wx, r_gates, h, c, n, m):
    """The scan of every row, in launches of up to ``MAX_BATCH`` rows."""
    if wx.shape[0] <= MAX_BATCH:
        return _launch_rows(wx, r_gates, h, c, n, m)
    parts = [_launch_rows(wx[i:i + MAX_BATCH], r_gates,
                          *(t[i:i + MAX_BATCH] for t in (h, c, n, m)))
             for i in range(0, wx.shape[0], MAX_BATCH)]
    return (torch.cat([y for y, _ in parts]),
            tuple(torch.cat(ts) for ts in zip(*(st for _, st in parts))))


def _launch_rows(wx, r_gates, h, c, n, m):
    dev = check_cuda(wx, r_gates, h, c, n, m)
    if wx.dtype not in DTYPE_FLAG or r_gates.dtype != wx.dtype:
        raise TypeError(f"slstm_scan takes wx and r_gates in float32 or "
                        f"bfloat16 of one dtype, got {wx.dtype}, "
                        f"{r_gates.dtype}")
    B, S, _ = wx.shape
    nh, dh, _ = r_gates.shape
    d = nh * dh
    if S == 0:
        return (torch.empty(B, 0, d, device=dev),
                (h.clone(), c.clone(), n.clone(), m.clone()))
    U, _ = plan(B, dh)
    wx, r_gates = wx.contiguous(), r_gates.contiguous()
    c, n, m = c.contiguous(), n.contiguous(), m.contiguous()
    hbuf = torch.empty(2, B, d, dtype=torch.float32, device=dev)
    hbuf[0].copy_(h)
    y = torch.empty(B, S, d, dtype=torch.float32, device=dev)
    out = [torch.empty(B, d, dtype=torch.float32, device=dev)
           for _ in range(4)]
    _build.launch("slstm_scan", dev, wx.data_ptr(), r_gates.data_ptr(),
                  hbuf.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(),
                  B, S, nh, dh, U, DTYPE_FLAG[wx.dtype], y.data_ptr(),
                  *(t.data_ptr() for t in out))
    slstm_scan.launches += 1
    return y, tuple(out)


class _KernelScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wx, r_gates, h, c, n, m):
        y, carry = _launch(wx, r_gates, h, c, n, m)
        return (y, *carry)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the slstm_scan CUDA kernel has no backward: training through "
            "the scan is ROADMAP.md queue 1 item 10(d)")
