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
holds the port to the JAX kernel), 3/4 zeros.  The CUDA kernels
(``csrc/slstm.cu``) take ``r_gates`` as it is, the whole scan in ONE
launch, in one of two forms that ``form`` picks from the shape:

  * ``cluster`` (bfloat16, dh a multiple of 64 up to 512; xlstm-1.3b):
    one thread-block cluster of dh / 32 blocks per head (the heads are
    independent) and per 16 batch rows, no grid barrier.  The recurrent
    product runs on the tensor cores (mma.sync, bfloat16 in, float32
    sums): h is split into ``PIECES`` bfloat16 pieces (``split_pieces``;
    two leave under 2^-16 of |h|, three would sum back to it exactly),
    each product exact (``slstm_cluster_torch`` mirrors the arithmetic).
    The weights stay in registers; h goes to every block of the cluster
    by bulk copies into its shared memory, each block waiting on its own
    mbarrier for the copies it needs, no barrier across the cluster a
    step.
  * ``grid`` (everything else: float32, narrow heads): one cooperative
    launch per ``MAX_BATCH`` rows of d / U blocks of U state dimensions,
    the weights in shared memory as float32, the state in registers, a
    grid barrier a step, h exchanged through a double-buffered array in
    device memory.  The blocks must all be resident at once: the launcher
    checks that and refuses otherwise (no fallback).

Bound: operations, the recurrence's 8·B·S·d·dh FLOPs as ``PIECES`` bfloat16
products over the tensor-core rate (the cluster form) or in float32 over
the CUDA cores' (the grid form), above the bytes of wx, y and the state;
and the chain of S dependent steps.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

MAX_BATCH = 16                      # rows of one grid-form launch
THREADS = 512                       # csrc/slstm.cu kThreads
SMEM_LIMIT = 232_448                # bytes of shared memory a block can use
# the forms, as csrc/slstm.cu numbers them
FORMS = {"grid": 0, "cluster": 1}
CLUSTER_DIMS = 32                   # state dimensions a cluster-form block
CLUSTER_DH = 64                     # its heads: a multiple of this ..
MAX_CLUSTER = 16                    # .. in at most this many blocks
K_GROUPS = 4                        # the cluster form's K split, kKGroups
PIECES = 2                          # bfloat16 pieces of h, kPieces
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
    rec = torch.einsum("bhd,hde->bhe", carry[0].reshape(-1, nh, dh), r)
    return _cell_update(rec, carry, wx_t)


def _cell_update(rec: torch.Tensor, carry: State, wx_t: torch.Tensor):
    """The cell after its recurrent product ``rec`` (B, nh, 4·dh)."""
    nh, dh4 = rec.shape[1], rec.shape[2]
    d = nh * dh4 // 4
    _, c, n, m = carry
    rec = rec.reshape(-1, nh, 4, dh4 // 4).transpose(1, 2).reshape(-1, 4 * d)
    zi, ii, ff, oo = (wx_t.to(torch.float32) + rec).chunk(4, dim=-1)
    logf = F.logsigmoid(ff)
    m_new = torch.maximum(logf + m, ii)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(ii - m_new)
    c_new = fw * c + iw * torch.tanh(zi)
    n_new = fw * n + iw
    h_new = torch.sigmoid(oo) * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new), h_new


def slstm_scan_cost(wx: torch.Tensor, r_gates: torch.Tensor, h, c, n, m
                    ) -> Tuple[int, int]:
    """(FLOPs, bytes) of the scan: the recurrence's h @ r, 8·B·S·d·dh
    (B x d x 4·dh multiply-adds a step), counted as ``PIECES`` products
    in bfloat16 (h, float32, carried as that many bfloat16 pieces) and as
    one in float32; wx and r read once, y written and the float32 state
    read and written once.  The gates' elementwise work is not counted."""
    B, S = wx.shape[0], wx.shape[1]
    nh, dh = r_gates.shape[0], r_gates.shape[1]
    d = nh * dh
    flops = 8 * B * S * d * dh
    if wx.dtype == torch.bfloat16:
        flops *= PIECES
    n_bytes = (wx.element_size() * B * S * 4 * d
               + r_gates.element_size() * nh * dh * 4 * dh
               + 4 * (B * S * d + 8 * B * d))
    return flops, n_bytes


@counted("slstm_scan")
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


def split_pieces(h: torch.Tensor, pieces: int = PIECES
                 ) -> Tuple[torch.Tensor, ...]:
    """float32 h as ``pieces`` bfloat16 values (held in float32), as the
    cluster form splits it: each piece the nearest bfloat16 to what the
    pieces before it leave (those remainders are exact in float32).  Three
    sum back to h exactly; two leave under 2^-16 of |h|."""
    out, rest = [], h
    for _ in range(pieces):
        out.append(rest.to(torch.bfloat16).to(torch.float32))
        rest = rest - out[-1]
    return tuple(out)


def slstm_cluster_torch(wx: torch.Tensor, r_gates: torch.Tensor, h, c, n,
                        m):
    """Plain mirror of the cluster form's arithmetic: the recurrent
    product from h's ``PIECES`` bfloat16 pieces against r's bfloat16,
    each in float32, summed as the kernel groups it (where dh allows, K
    in ``K_GROUPS`` groups, group g the ``CLUSTER_DIMS``-wide slices s
    with s % K_GROUPS == g, each over its k16 steps with the smallest
    piece first; then the groups in order), then the same cell.  The
    kernel takes a group's slices in the order they reach the block, the
    mirror in ascending order: the float32 sums differ by that order only.
    For the CPU tests: it shows that the split and the grouping keep the
    scan within ``KERNEL_TOL`` of ``slstm_scan_torch``."""
    _check_shapes(wx, r_gates, h, c, n, m)
    if r_gates.dtype != torch.bfloat16:
        raise TypeError(f"the cluster form takes r_gates in bfloat16, got "
                        f"{r_gates.dtype}")
    r = r_gates.to(torch.float32)
    nh, dh = r.shape[0], r.shape[1]
    if dh % CLUSTER_DH == 0:
        slices = range(0, dh, CLUSTER_DIMS)
        groups = [[(s, s + CLUSTER_DIMS) for s in slices
                   if s // CLUSTER_DIMS % K_GROUPS == g]
                  for g in range(K_GROUPS)]
    else:
        groups = [[(0, dh)]]
    carry = (h, c, n, m)
    ys = []
    for t in range(wx.shape[1]):
        pieces = [p.reshape(-1, nh, dh) for p in split_pieces(carry[0])]
        rec = torch.zeros(h.shape[0], nh, 4 * dh, device=h.device)
        for group in groups:
            acc = torch.zeros_like(rec)
            for s0, s1 in group:
                for k0 in range(s0, s1, 16):
                    k1 = min(k0 + 16, s1)
                    for piece in reversed(pieces):
                        acc = acc + torch.einsum(
                            "bhk,hke->bhe", piece[..., k0:k1], r[:, k0:k1])
            rec = rec + acc
        carry, h_t = _cell_update(rec, carry, wx[:, t])
        ys.append(h_t)
    B, d = h.shape
    y = torch.stack(ys, 1) if ys else torch.empty(B, 0, d, device=h.device)
    return y, carry


@counted("slstm_scan")
def slstm_scan(wx: torch.Tensor, r_gates: torch.Tensor, h, c, n, m):
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor (no backward through the kernel)."""
    _check_shapes(wx, r_gates, h, c, n, m)
    if wx.device.type == "cpu":
        return slstm_scan_torch(wx, r_gates, h, c, n, m)
    y, *carry = _KernelScan.apply(wx, r_gates, h, c, n, m)
    return y, tuple(carry)


slstm_scan.launches = 0
slstm_scan.last_form = None         # the form of the latest launch
slstm_scan.form_launches = {}       # launches by form


def form(dtype: torch.dtype, B: int, nh: int, dh: int) -> str:
    """The kernel's form for a scan: ``cluster`` for bfloat16 where a head
    splits into at most ``MAX_CLUSTER`` blocks of ``CLUSTER_DIMS``
    dimensions (dh a multiple of 64 up to 512; a block's shared memory,
    104 KB at 16 rows and dh 512, then fits); ``grid`` otherwise.
    Decided by the shape alone, never after a failure."""
    if dtype == torch.bfloat16 and dh % CLUSTER_DH == 0 \
            and dh // CLUSTER_DIMS <= MAX_CLUSTER and nh >= 1 \
            and 1 <= -(-B // MAX_BATCH) <= 65535:
        return "cluster"
    return "grid"


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


def _launch(wx, r_gates, h, c, n, m, chosen=None):
    """The scan of every row in the form ``form`` picks (or ``chosen``):
    one cluster-form launch, or grid-form launches of up to
    ``MAX_BATCH`` rows."""
    if chosen is None:
        chosen = form(wx.dtype, wx.shape[0], *r_gates.shape[:2])
    if chosen == "cluster":
        return _launch_cluster(wx, r_gates, h, c, n, m)
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
                  B, S, nh, dh, U, DTYPE_FLAG[wx.dtype], FORMS["grid"],
                  y.data_ptr(), *(t.data_ptr() for t in out))
    _count("grid")
    return y, tuple(out)


def _launch_cluster(wx, r_gates, h, c, n, m):
    dev = check_cuda(wx, r_gates, h, c, n, m)
    B, S, _ = wx.shape
    nh, dh, _ = r_gates.shape
    if form(wx.dtype, B, nh, dh) != "cluster" or r_gates.dtype != wx.dtype:
        raise ValueError(f"the cluster form takes bfloat16 wx and r_gates "
                         f"with dh a multiple of 64 up to 512, got "
                         f"{wx.dtype}, {r_gates.dtype}, dh {dh}")
    d = nh * dh
    if S == 0:
        return (torch.empty(B, 0, d, device=dev),
                (h.clone(), c.clone(), n.clone(), m.clone()))
    wx, r_gates = wx.contiguous(), r_gates.contiguous()
    h, c, n, m = (t.contiguous() for t in (h, c, n, m))
    y = torch.empty(B, S, d, dtype=torch.float32, device=dev)
    out = [torch.empty(B, d, dtype=torch.float32, device=dev)
           for _ in range(4)]
    _build.launch("slstm_scan", dev, wx.data_ptr(), r_gates.data_ptr(),
                  h.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(),
                  B, S, nh, dh, 0, DTYPE_FLAG[wx.dtype], FORMS["cluster"],
                  y.data_ptr(), *(t.data_ptr() for t in out))
    _count("cluster")
    return y, tuple(out)


def cluster_capacity(device: torch.device, B: int, nh: int, dh: int) -> int:
    """How many cluster-form clusters for B rows the card can hold at once
    (``cudaOccupancyMaxActiveClusters``); the launcher refuses the form
    where this is 0."""
    out = ctypes.c_int(0)
    _build.launch("slstm_cluster_capacity", device, B, nh, dh,
                  ctypes.addressof(out))
    return out.value


def _count(chosen: str) -> None:
    slstm_scan.launches += 1
    slstm_scan.last_form = chosen
    slstm_scan.form_launches[chosen] = \
        slstm_scan.form_launches.get(chosen, 0) + 1


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
