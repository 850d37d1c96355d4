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

Where autograd records (``slstm_scan`` with an input that requires grad),
either form also writes each step's (c, n, m), float32, ``states`` (B, 3,
S, d): the backward needs every step's state and cannot run the
recurrence backwards, and a forward replay would cost a second scan.

The gradient, ``slstm_scan_bwd`` (``csrc/slstm_bwd.cu``), replaces no TPU
kernel (the JAX package differentiates its jnp recurrence,
``src/repro/models/xlstm.py:219-277``): ONE launch that walks t from S - 1
down to 0, following autograd's formula of the cell back (``_cell_bwd``:
the max's tie split in half, the clamp's cut, both exps) to the gate
gradients dgates_t (float32, written out) and the carries dc, dn, dm,
and adding dh_{t-1} = dgates_t · r_headᵀ.  Two forms, by ``bwd_form``:

  * ``cluster`` (the forward's rule: bfloat16, dh a multiple of 64 up to
    512; xlstm-1.3b): the forward's cluster form run backwards, a cluster
    of dh / 32 blocks a head for each ``BWD_ROWS`` batch rows, no grid
    barrier.  A block keeps r's block slice in registers; dh_{t-1}'s
    product takes dgates_t as two bfloat16 pieces (``split_pieces``) on
    mma.sync, and its shares meet in a reduce-scatter over distributed
    shared memory (bulk copies, one mbarrier a receive buffer), added in
    rank order.  The gates are recomputed off the chain from h's two
    pieces, by the warps with no row of the cell while it runs and by the
    rest while the exchange does; every step's inputs come in by bulk
    copies three steps ahead.  ``slstm_cluster_bwd_torch`` mirrors the
    arithmetic on the CPU.
  * ``grid`` (everything else: float32, narrow heads): one cooperative
    launch a ``MAX_BATCH`` rows, d / U blocks of U state dimensions, a
    grid barrier a step; each step a block recomputes its gates from
    h_{t-1} and its r columns in shared memory (float32), and adds its
    gate columns' share of dh_{t-1} for every dimension of its head into a
    double-buffered scratch, which the owners sum in block order after
    the barrier.

dwx is dgates in wx's dtype; dr_gates = Σ_t h_{t-1}ᵀ dgates_t per head is
one batched ``torch.matmul`` after the scan (the JAX package's is an
einsum's autodiff, no Pallas kernel).  Bound: operations, dh_{t-1}'s
product and dr's, 16·B·S·d·dh; and the S dependent steps.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted, get_kernel
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

MAX_BATCH = 16                      # rows of one grid-form launch
THREADS = 512                       # csrc/slstm.cu kThreads
SMEM_LIMIT = 232_448                # bytes of shared memory a block can use
# the forms, as csrc/slstm.cu and csrc/slstm_bwd.cu number them
FORMS = BWD_FORMS = {"grid": 0, "cluster": 1}
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
# How far the backward kernel may sit from the plain backward on the same
# saved forward: both follow autograd's formula in float32, the products
# (the gates' recomputation, dh_rec's share sums) in another order and
# exp / tanh / log1p from other libraries.  The carries pass back through
# fw <= 1 and the gates' derivatives, so a step's gap of a few float32
# steps stays near that size over the scan: rtol 1e-3, and 1e-4 of the
# largest gradient of its tensor (dwx in bfloat16: one bfloat16 step).
KERNEL_BWD_TOL = dict(rtol=1e-3, atol_of_max=1e-4)


def kernel_bwd_tol(want: torch.Tensor) -> dict:
    """``assert_close`` tolerances of a backward-kernel result against
    ``want``, the plain backward's (see ``KERNEL_BWD_TOL``)."""
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    rtol = max(KERNEL_BWD_TOL["rtol"],
               2 ** -7 if want.dtype == torch.bfloat16 else 0.0)
    return dict(rtol=rtol, atol=KERNEL_BWD_TOL["atol_of_max"] * scale)


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


def slstm_scan_bwd_cost(wx, r_gates, h, c, n, m, y, states, dy, dhN, dcN,
                        dnN, dmN) -> Tuple[int, int]:
    """(FLOPs, bytes) of the gradient: dh_{t-1} = dgates_t · r_headᵀ and
    dr_gates = Σ_t h_{t-1}ᵀ dgates_t, 16·B·S·d·dh, counted as ``PIECES``
    products in bfloat16 as the forward's are (the gates' recomputation is
    this design's, not the function's); wx, r, y, the saved states, dy
    and the eight state tensors read once, dwx, dr and the four initial
    state gradients written once."""
    B, S = wx.shape[0], wx.shape[1]
    nh, dh = r_gates.shape[0], r_gates.shape[1]
    d = nh * dh
    flops = 16 * B * S * d * dh
    if wx.dtype == torch.bfloat16:
        flops *= PIECES
    n_bytes = (2 * wx.element_size() * B * S * 4 * d
               + 2 * r_gates.element_size() * nh * dh * 4 * dh
               + 4 * (5 * B * S * d + 12 * B * d))
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


def slstm_states_torch(wx: torch.Tensor, r_gates: torch.Tensor, h, c, n,
                       m):
    """``slstm_scan_torch`` that also returns every step's (c, n, m), as
    the kernels write them where autograd records: (y, final state,
    states (B, 3, S, d) float32)."""
    _check_shapes(wx, r_gates, h, c, n, m)
    r = r_gates.to(torch.float32)
    carry = (h, c, n, m)
    ys, st = [], []
    for t in range(wx.shape[1]):
        carry, h_t = slstm_cell(r, carry, wx[:, t])
        ys.append(h_t)
        st.append(torch.stack(carry[1:], 1))
    B, d = h.shape
    if not ys:
        empty = torch.empty(B, 0, d, device=h.device)
        return empty, carry, torch.empty(B, 3, 0, d, device=h.device)
    return torch.stack(ys, 1), carry, torch.stack(st, 2)


def _cell_bwd(r: torch.Tensor, prev: State, wx_t: torch.Tensor, dh, dc, dn,
              dm):
    """One step back through ``slstm_cell`` as autograd takes it: the
    gates recomputed from ``prev`` = (h, c, n, m) at t - 1, then the
    gradients of h_t (``dh``) and of the carries (c, n, m)_t through every
    op of ``_cell_update`` (``_gates_bwd``).  Returns (dgates (B, 4d)
    gate-major float32, dc, dn, dm at t - 1)."""
    h, c, n, m = prev
    nh, dh4 = r.shape[0], r.shape[2]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(-1, nh, dh4 // 4), r)
    rec = rec.reshape(-1, nh, 4, dh4 // 4).transpose(1, 2).reshape(
        rec.shape[0], -1)
    return _gates_bwd(wx_t.to(torch.float32) + rec, c, n, m, dh, dc, dn, dm)


def _gates_bwd(gates: torch.Tensor, c, n, m, dh, dc, dn, dm):
    """The cell back from its gate-major pre-activations ``gates`` (B, 4d)
    and the state (c, n, m) at t - 1: ``torch.maximum`` splits a tie's
    gradient in half, ``torch.clamp`` passes none below 1e-6, and both
    exps pass theirs, though h does not depend on m in exact arithmetic.
    Returns (dgates, dc, dn, dm at t - 1)."""
    zi, ii, ff, oo = gates.chunk(4, dim=-1)
    t1 = F.logsigmoid(ff) + m
    m_new = torch.maximum(t1, ii)
    fw = torch.exp(t1 - m_new)
    iw = torch.exp(ii - m_new)
    z = torch.tanh(zi)
    c_new = fw * c + iw * z
    n_new = fw * n + iw
    s = torch.sigmoid(oo)
    ncl = torch.clamp(n_new, min=1e-6)
    dq = dh / ncl
    dn = dn + torch.where(n_new >= 1e-6, -dh * (s * c_new) / (ncl * ncl),
                          0.0)
    dc = dc + dq * s
    doo = dq * c_new * s * (1 - s)
    dfw = dc * c + dn * n
    diw = dc * z + dn
    dzi = dc * iw * (1 - z * z)
    de1, de2 = dfw * fw, diw * iw
    dmn = dm - de1 - de2
    share = torch.where(t1 == ii, 0.5 * dmn, dmn)
    dt1 = de1 + torch.where(t1 >= ii, share, 0.0)
    dii = de2 + torch.where(ii >= t1, share, 0.0)
    dff = dt1 * torch.sigmoid(-ff)
    return torch.cat([dzi, dii, dff, doo], -1), dc * fw, dn * fw, dt1


def dr_gates(h0: torch.Tensor, y: torch.Tensor, dgates: torch.Tensor,
             nh: int) -> torch.Tensor:
    """dr_gates (nh, dh, 4·dh) float32 = Σ_{b,t} h_{t-1}ᵀ dgates_t per head:
    h_{t-1} is h0 and y's rows before the last, dgates (B, S, 4d) the
    gate-major gate gradients; one batched matmul."""
    B, S, d = y.shape
    dh = d // nh
    h_prev = torch.cat([h0[:, None].to(torch.float32), y[:, :-1]], 1)
    hh = h_prev.reshape(B * S, nh, dh).permute(1, 2, 0)
    gh = dgates.reshape(B * S, 4, nh, dh).permute(2, 0, 1, 3).reshape(
        nh, B * S, 4 * dh)
    return torch.matmul(hh, gh)


@counted("slstm_scan_bwd")
def slstm_scan_bwd_torch(wx, r_gates, h, c, n, m, y, states, dy, dhN, dcN,
                         dnN, dmN):
    """Plain version of the gradient: a reverse loop of ``_cell_bwd`` from
    the saved forward (y, and ``states`` (B, 3, S, d), every step's (c, n,
    m)) and the gradients of y and of the final (h, c, n, m) ->
    (dwx in wx's dtype, dr_gates in r's, dh0, dc0, dn0, dm0)."""
    _check_shapes(wx, r_gates, h, c, n, m)
    r = r_gates.to(torch.float32)
    B, S, d4 = wx.shape
    dgates = torch.empty(B, S, d4, dtype=torch.float32, device=wx.device)
    dh_rec = torch.zeros_like(h)
    dc, dn, dm = dcN, dnN, dmN
    nh, dh = r.shape[0], r.shape[1]
    for t in reversed(range(S)):
        prev = (y[:, t - 1], *states[:, :, t - 1].unbind(1)) if t \
            else (h, c, n, m)
        dh_t = dy[:, t] + dh_rec + (dhN if t == S - 1 else 0.0)
        g, dc, dn, dm = _cell_bwd(r, prev, wx[:, t], dh_t, dc, dn, dm)
        dgates[:, t] = g
        gh = g.reshape(B, 4, nh, dh).transpose(1, 2).reshape(B, nh, 4 * dh)
        dh_rec = torch.einsum("bhe,hde->bhd", gh, r).reshape(B, -1)
    if S == 0:
        dh_rec = dhN
    return (dgates.to(wx.dtype), dr_gates(h, y, dgates, nh).to(r_gates.dtype),
            dh_rec, dc, dn, dm)


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


def slstm_cluster_bwd_torch(wx, r_gates, h, c, n, m, y, states, dy, dhN,
                            dcN, dnN, dmN):
    """Plain mirror of the backward cluster form's arithmetic (the same
    arguments and results as ``slstm_scan_bwd_torch``): each step's gates
    recomputed from h_{t-1}'s ``PIECES`` bfloat16 pieces against r's
    bfloat16, in float32, grouped as the kernel's warps take K in
    16-dimension m-tiles (warp w < 4 the m-tile w, warp 4 + w the m-tiles
    w + 4, .., w + 28 and those warp w lends it, w + 8, w + 16 and w + 24;
    each piece summed over them, then piece 0 + piece 1, then the warps in
    order, then added to wx); the same cell back; dh_{t-1} from dgates_t's
    two bfloat16 pieces against r, each block's share over its 128 gate
    columns (gate g of its ``CLUSTER_DIMS`` dimensions) as piece 0 +
    piece 1, the shares added in rank order.  Heads the kernel does not
    take (dh not a multiple of 64) run as one block and one m-tile.  For
    the CPU tests: it shows that the pieces and the grouping keep the
    gradient within ``kernel_bwd_tol`` of ``slstm_scan_bwd_torch``."""
    _check_shapes(wx, r_gates, h, c, n, m)
    if r_gates.dtype != torch.bfloat16:
        raise TypeError(f"the cluster form takes r_gates in bfloat16, got "
                        f"{r_gates.dtype}")
    r = r_gates.to(torch.float32)
    nh, dh = r.shape[0], r.shape[1]
    B, S, d4 = wx.shape
    d = d4 // 4
    width = CLUSTER_DIMS if dh % CLUSTER_DH == 0 else dh   # dims a block
    tile = 16 if dh % CLUSTER_DH == 0 else dh              # dims an m-tile
    cs = dh // width
    n_tiles = dh // tile
    # warp w < 4: its m-tile w; warp 4 + w: its own four, then the three
    # warp w lends (w + 8, w + 16, w + 24)
    warps = [[m for m in (w,) if m < n_tiles] for w in range(4)] + \
        [[m for m in (w + 4, w + 12, w + 20, w + 28, w + 8, w + 16, w + 24)
          if m < n_tiles] for w in range(4)]
    warps = [tiles for w, tiles in enumerate(warps) if w < min(8, n_tiles)]
    # r's columns in the blocks' order: [head][block][i][gate g, dim u]
    rb = r.reshape(nh, dh, 4, cs, width).permute(0, 3, 1, 2, 4).reshape(
        nh, cs, dh, 4 * width)
    dgates = torch.empty(B, S, d4, dtype=torch.float32, device=wx.device)
    dc, dn, dm = dcN, dnN, dmN
    rec = torch.zeros_like(h)
    for t in reversed(range(S)):
        prev_h = y[:, t - 1] if t else h
        c_p, n_p, m_p = states[:, :, t - 1].unbind(1) if t else (c, n, m)
        pieces = [p.reshape(B, nh, dh) for p in split_pieces(prev_h)]
        acc = torch.zeros(B, nh, 4 * dh, device=wx.device)
        for tiles in warps:
            part = None
            for piece in pieces:
                pp = torch.zeros_like(acc)
                for mi in tiles:
                    k = slice(mi * tile, (mi + 1) * tile)
                    pp = pp + torch.einsum("bhk,hke->bhe", piece[..., k],
                                           r[:, k])
                part = pp if part is None else part + pp
            acc = acc + part
        acc = acc.reshape(B, nh, 4, dh).transpose(1, 2).reshape(B, d4)
        dh_t = dy[:, t] + rec + (dhN if t == S - 1 else 0.0)
        g, dc, dn, dm = _gates_bwd(wx[:, t].to(torch.float32) + acc, c_p,
                                   n_p, m_p, dh_t, dc, dn, dm)
        dgates[:, t] = g
        gb = g.reshape(B, 4, nh, cs, width).permute(0, 2, 3, 1, 4).reshape(
            B, nh, cs, 4 * width)
        p0, p1 = split_pieces(gb)
        share = torch.einsum("bhkc,hkic->bhki", p0, rb) \
            + torch.einsum("bhkc,hkic->bhki", p1, rb)
        total = torch.zeros(B, nh, dh, device=wx.device)
        for k in range(cs):
            total = total + share[:, :, k]
        rec = total.reshape(B, d)
    if S == 0:
        rec = dhN
    return (dgates.to(wx.dtype), dr_gates(h, y, dgates, nh).to(r_gates.dtype),
            rec, dc, dn, dm)


@counted("slstm_scan")
def slstm_scan(wx: torch.Tensor, r_gates: torch.Tensor, h, c, n, m):
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor; its backward the ``slstm_scan_bwd`` kernel."""
    _check_shapes(wx, r_gates, h, c, n, m)
    if wx.device.type == "cpu" and not _build.is_fake(wx):
        return slstm_scan_torch(wx, r_gates, h, c, n, m)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (wx, r_gates, h, c, n, m)):
        y, *carry = _KernelScan.apply(wx, r_gates, h, c, n, m)
        return y, tuple(carry)
    return _launch(wx, r_gates, h, c, n, m)


@counted("slstm_scan_bwd")
def slstm_scan_bwd(wx, r_gates, h, c, n, m, y, states, dy, dhN, dcN, dnN,
                   dmN):
    """The gradient of ``slstm_scan``: the plain version for CPU tensors,
    the ``csrc/slstm_bwd.cu`` kernel (one count in ``launches`` a launch:
    one in the cluster form, one a ``MAX_BATCH`` rows in the grid form)
    for CUDA tensors, then dr_gates by one batched matmul.  Returns (dwx,
    dr_gates, dh0, dc0, dn0, dm0)."""
    _check_shapes(wx, r_gates, h, c, n, m)
    if wx.device.type == "cpu" and not _build.is_fake(wx):
        return slstm_scan_bwd_torch(wx, r_gates, h, c, n, m, y, states, dy,
                                    dhN, dcN, dnN, dmN)
    dgates, *dstate = _launch_bwd(wx, r_gates, h, c, n, m, y, states, dy,
                                  dhN, dcN, dnN, dmN)
    dr = dr_gates(h, y, dgates, r_gates.shape[0])
    return (dgates.to(wx.dtype), dr.to(r_gates.dtype), *dstate)


slstm_scan.launches = 0
slstm_scan.last_form = None         # the form of the latest launch
slstm_scan.form_launches = {}       # launches by form
slstm_scan_bwd.launches = 0
slstm_scan_bwd.last_form = None     # the form of the latest launch
slstm_scan_bwd.form_launches = {}   # launches by form


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


BWD_ROWS = 4                        # batch rows a backward cluster


def bwd_form(dtype: torch.dtype, B: int, nh: int, dh: int) -> str:
    """The backward kernel's form: ``cluster`` where the forward's
    cluster form runs (bfloat16, dh a multiple of 64 up to 512), for any
    B (a grid row of clusters a ``BWD_ROWS`` rows); ``grid`` otherwise.
    Decided by the shape alone, never after a failure."""
    if dtype == torch.bfloat16 and dh % CLUSTER_DH == 0 \
            and dh // CLUSTER_DIMS <= MAX_CLUSTER and nh >= 1 \
            and 1 <= -(-B // BWD_ROWS) <= 65535:
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


def _check_states(wx, states) -> None:
    B, S, d4 = wx.shape
    want = (B, 3, S, d4 // 4)
    if tuple(states.shape) != want or states.dtype != torch.float32:
        raise ValueError(f"slstm_scan's saved states are {want} float32, "
                         f"got {tuple(states.shape)} {states.dtype}")


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


def bwd_plan(B: int, dh: int) -> Tuple[int, int]:
    """(U, shared-memory bytes) of one backward launch of B rows: U as
    ``plan``'s; the block keeps its r columns (rows padded by one value,
    so that a warp's rows fall on 32 banks), h_{t-1} of its head, the
    product's partial sums and its gate gradients.  Raises ``ValueError``
    for a batch one launch cannot hold."""
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"the slstm_scan_bwd kernel takes 1 to {MAX_BATCH} "
                         f"batch rows, got {B}")
    U = 16
    while dh % U:
        U //= 2
    J = 4 * U
    smem = 4 * (dh * (J + 1) + B * dh + (THREADS // J) * B * J + B * J)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the slstm_scan_bwd kernel holds a head of {dh} "
                         f"dimensions x {B} rows in {smem} bytes of shared "
                         f"memory, over the {SMEM_LIMIT} a block can use")
    return U, smem


def _launch(wx, r_gates, h, c, n, m, chosen=None, states=None):
    """The scan of every row in the form ``form`` picks (or ``chosen``):
    one cluster-form launch, or grid-form launches of up to
    ``MAX_BATCH`` rows; each step's (c, n, m) into ``states`` (B, 3, S, d)
    float32 where given."""
    if chosen is None:
        chosen = form(wx.dtype, wx.shape[0], *r_gates.shape[:2])
    if states is not None:
        _check_states(wx, states)
    if chosen == "cluster":
        return _launch_cluster(wx, r_gates, h, c, n, m, states)
    if wx.shape[0] <= MAX_BATCH:
        return _launch_rows(wx, r_gates, h, c, n, m,
                            **({} if states is None else {"states": states}))
    parts = [_launch_rows(wx[i:i + MAX_BATCH], r_gates,
                          *(t[i:i + MAX_BATCH] for t in (h, c, n, m)),
                          **({} if states is None
                             else {"states": states[i:i + MAX_BATCH]}))
             for i in range(0, wx.shape[0], MAX_BATCH)]
    return (torch.cat([y for y, _ in parts]),
            tuple(torch.cat(ts) for ts in zip(*(st for _, st in parts))))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch_rows(wx, r_gates, h, c, n, m, states=None):
    fake = _build.is_fake(wx)
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
    if fake:
        return y, tuple(out)
    _build.launch("slstm_scan", dev, wx.data_ptr(), r_gates.data_ptr(),
                  hbuf.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(),
                  B, S, nh, dh, U, DTYPE_FLAG[wx.dtype], FORMS["grid"],
                  y.data_ptr(), *(t.data_ptr() for t in out), _ptr(states))
    _count("grid")
    return y, tuple(out)


def _launch_cluster(wx, r_gates, h, c, n, m, states=None):
    fake = _build.is_fake(wx)
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
    if fake:
        return y, tuple(out)
    _build.launch("slstm_scan", dev, wx.data_ptr(), r_gates.data_ptr(),
                  h.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(),
                  B, S, nh, dh, 0, DTYPE_FLAG[wx.dtype], FORMS["cluster"],
                  y.data_ptr(), *(t.data_ptr() for t in out), _ptr(states))
    _count("cluster")
    return y, tuple(out)


def _launch_bwd(wx, r_gates, h, c, n, m, y, states, dy, dhN, dcN, dnN, dmN):
    """(dgates (B, S, 4d) float32, dh0, dc0, dn0, dm0) by
    ``csrc/slstm_bwd.cu`` in the form ``bwd_form`` picks: one cluster-form
    launch, or a grid-form cooperative launch a ``MAX_BATCH`` rows."""
    fake = _build.is_fake(wx)
    dev = check_cuda(
        wx, r_gates, h, c, n, m, y, states, dy, dhN, dcN, dnN, dmN)
    if wx.dtype not in DTYPE_FLAG or r_gates.dtype != wx.dtype:
        raise TypeError(f"slstm_scan_bwd takes wx and r_gates in float32 or "
                        f"bfloat16 of one dtype, got {wx.dtype}, "
                        f"{r_gates.dtype}")
    _check_states(wx, states)
    B, S, d4 = wx.shape
    nh, dh, _ = r_gates.shape
    d = d4 // 4
    f32 = dict(dtype=torch.float32, device=dev)
    grads = [t.to(torch.float32).contiguous() for t in (dy, dhN, dcN, dnN,
                                                         dmN)]
    if tuple(grads[0].shape) != (B, S, d) or any(
            tuple(t.shape) != (B, d) for t in grads[1:]):
        raise ValueError(f"slstm_scan_bwd takes dy (B, S, d) and the final "
                         f"state's gradients (B, d), got "
                         f"{[tuple(t.shape) for t in grads]}")
    dgates = torch.empty(B, S, d4, **f32)
    if S == 0:
        return (dgates, grads[1].clone(), grads[2].clone(), grads[3].clone(),
                grads[4].clone())
    chosen = bwd_form(wx.dtype, B, nh, dh)
    wx, r_gates = wx.contiguous(), r_gates.contiguous()
    ins = [t.contiguous() for t in (h, c, n, m, y, states)]
    outs = [torch.empty(B, d, **f32) for _ in range(4)]
    if fake:
        if chosen != "cluster":
            U, _ = bwd_plan(min(B, MAX_BATCH), dh)
            torch.empty(2, d // U, min(B, MAX_BATCH), dh, **f32)
        return (dgates, *outs)
    if chosen == "cluster":
        # the bulk copies read every input from 16-byte boundaries
        wx, *ins = [t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (wx, *ins)]
        grads = [t if t.data_ptr() % 16 == 0 else t.clone() for t in grads]
        r_gates = r_gates if r_gates.data_ptr() % 4 == 0 else r_gates.clone()
        _build.launch("slstm_scan_bwd", dev, wx.data_ptr(),
                      r_gates.data_ptr(), *(t.data_ptr() for t in ins),
                      *(t.data_ptr() for t in grads), B, S, nh, dh, 0,
                      DTYPE_FLAG[wx.dtype], BWD_FORMS["cluster"], None,
                      dgates.data_ptr(), *(t.data_ptr() for t in outs))
        _count_bwd("cluster")
        return (dgates, *outs)
    U, _ = bwd_plan(min(B, MAX_BATCH), dh)
    dpart = torch.empty(2, d // U, min(B, MAX_BATCH), dh, **f32)
    for i in range(0, B, MAX_BATCH):
        rows = slice(i, i + MAX_BATCH)
        b = len(range(B)[rows])
        _build.launch("slstm_scan_bwd", dev, wx[rows].data_ptr(),
                      r_gates.data_ptr(), *(t[rows].data_ptr() for t in ins),
                      *(t[rows].data_ptr() for t in grads), b, S, nh, dh, U,
                      DTYPE_FLAG[wx.dtype], BWD_FORMS["grid"],
                      dpart.data_ptr(), dgates[rows].data_ptr(),
                      *(t[rows].data_ptr() for t in outs))
        _count_bwd("grid")
    return (dgates, *outs)


def bwd_cluster_capacity(device: torch.device, B: int, nh: int,
                         dh: int) -> int:
    """How many backward cluster-form clusters for B rows the card can
    hold at once (``cudaOccupancyMaxActiveClusters``); the launcher
    refuses the form where this is 0."""
    out = ctypes.c_int(0)
    _build.launch("slstm_bwd_cluster_capacity", device, B, nh, dh,
                  ctypes.addressof(out))
    return out.value


def cluster_capacity(device: torch.device, B: int, nh: int, dh: int) -> int:
    """How many cluster-form clusters for B rows the card can hold at once
    (``cudaOccupancyMaxActiveClusters``); the launcher refuses the form
    where this is 0."""
    out = ctypes.c_int(0)
    _build.launch("slstm_cluster_capacity", device, B, nh, dh,
                  ctypes.addressof(out))
    return out.value


def _count_bwd(chosen: str) -> None:
    slstm_scan_bwd.launches += 1
    slstm_scan_bwd.last_form = chosen
    slstm_scan_bwd.form_launches[chosen] = \
        slstm_scan_bwd.form_launches.get(chosen, 0) + 1


def _count(chosen: str) -> None:
    slstm_scan.launches += 1
    slstm_scan.last_form = chosen
    slstm_scan.form_launches[chosen] = \
        slstm_scan.form_launches.get(chosen, 0) + 1


class _KernelScan(torch.autograd.Function):
    """The forward kernel writing each step's state, and the
    ``slstm_scan_bwd`` kernel as its backward."""

    @staticmethod
    def forward(ctx, wx, r_gates, h, c, n, m):
        B, S, d4 = wx.shape
        states = torch.empty(B, 3, S, d4 // 4, dtype=torch.float32,
                             device=wx.device)
        y, carry = _launch(wx, r_gates, h, c, n, m, states=states)
        ctx.save_for_backward(wx, r_gates, h, c, n, m, y, states)
        return (y, *carry)

    @staticmethod
    def backward(ctx, dy, *dfinal):
        wx, r_gates, h, c, n, m, y, states = ctx.saved_tensors
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip((dy, *dfinal), (y, h, c, n, m))]
        return get_kernel("slstm_scan_bwd")(wx, r_gates, h, c, n, m, y,
                                            states, *grads)
