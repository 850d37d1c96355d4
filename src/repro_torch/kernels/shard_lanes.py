"""Shard-lane seal: K shards' segmented xor-fold digests in one call.

The fused fabric loop (``core/fused.py`` over ``core/shards.ShardedRollup``)
needs every shard lane's per-batch tx roots and per-seal update digests:
K independent ``batch_seal`` folds.  The K lanes become the rows of one
``(K, W)`` word grid and ONE call folds every lane's segments (factory op
``shard_seal``; the JAX package's ``src/repro/kernels/shard_lanes.py``,
which has no Pallas form).

Call contract, ``shard_seal(words, starts, n_seg, n_words) -> (K, B)``:

  * ``words``   (K, W) int32 carrying u32 bits: row ``k``'s word buffer in
    its first ``n_words[k]`` columns (what lies after is never folded);
  * ``starts``  (K, B) int64: row ``k``'s segment starts in its first
    ``n_seg[k]`` columns, strictly increasing and ``< n_words[k]``
    (segments are non-empty); padded columns hold ``n_words[k]``;
  * ``n_seg``, ``n_words`` (K,) int64;
  * output (K, B) int32: row ``k``'s segment digests in its first
    ``n_seg[k]`` columns, ``engine.xor_fold_digest_segments`` of the row
    bit for bit; every other column holds ``MIX_SEED`` (the digest of an
    empty segment).

Impls: ``shard_seal_torch`` (the plain version: a 2-D log-step prefix xor
along the rows, digests by prefix difference, used on the CPU and by the
tests), ``shard_seal`` (the wrapper: the plain version for CPU tensors,
the CUDA kernel for CUDA tensors, one launch a call, counted in
``launches``) and ``shard_seal_mesh`` (the lane rows split in contiguous
blocks over ``launch/mesh.make_shard_mesh``, as
``sharding/specs.shard_lane_spec`` says; each block through the wrapper on
its own device, the results gathered on the first; one block on one
card).

Kernel (``shard_seal_span_kernel`` in ``csrc/fold.cu``): ``batch_seal``'s
equal spans of words (``batch_seal_span_kernel``: the same device
function, ``seal_span``) with a lane axis.  ``blockIdx.y`` is the lane,
``blockIdx.x`` the span; every lane takes one span, ``plan(K·W)``'s, and
the blocks past a lane's words leave at once.  A lane keeps its own carry
records and its own ticket: the tickets are a buffer of K words that the
wrapper zeroes for each call (one ``torch.zeros``), so no counter is shared
with another launch (``batch_seal``'s ``g_seal_ticket`` is one word of
the library).  Block 0 of each lane writes the lane's padded columns.
Bound: ``4·ΣW_k + 8·ΣB_k + 4·K·B`` bytes (words read, starts read, digests
written).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.batch_seal import plan
from repro_torch.kernels.rollup_digest import (MIX_SEED, check_cuda, mix_u32,
                                               to_i32, to_u32)


def _lanes(n, k: int, device) -> torch.Tensor:
    """A (K,) int64 tensor of per-lane counts on ``device``."""
    t = torch.as_tensor(n, dtype=torch.int64).reshape(-1)
    if t.numel() != k:
        raise ValueError(f"{t.numel()} lane counts for {k} lanes")
    return t.to(device).contiguous()


def _grid_words(words: torch.Tensor) -> torch.Tensor:
    """A (K, W) word grid as int32 bits with unit column stride."""
    if words.dim() != 2:
        raise ValueError("words must be a (K, W) grid")
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    elif words.dtype != torch.int32:
        raise ValueError(f"words must be int32 or uint32, not {words.dtype}")
    return words if words.stride(1) == 1 or words.shape[1] <= 1 \
        else words.contiguous()


def shard_seal_torch(words: torch.Tensor, starts: torch.Tensor, n_seg,
                     n_words) -> torch.Tensor:
    """Plain version: (K, B) int32 digests by a prefix xor along each
    row (int64 values masked to 32 bits; words past ``n_words[k]`` fold
    as zero)."""
    words = _grid_words(words)
    starts = starts.to(torch.int64)
    K, W = words.shape
    B = starts.shape[1]
    dev = words.device
    n_seg, n_words = _lanes(n_seg, K, dev), _lanes(n_words, K, dev)
    col = torch.arange(W, device=dev)
    prefix = torch.where(col[None] < n_words[:, None],
                         mix_u32(to_u32(words)), 0)
    step = 1
    while step < W:                         # Hillis-Steele, along the rows
        prefix = torch.cat([prefix[:, :step],
                            prefix[:, step:] ^ prefix[:, :-step]], dim=1)
        step *= 2
    # p[:, i] = xor of the first i mixed words of the row
    p = torch.cat([prefix.new_zeros(K, 1), prefix], dim=1)
    j = torch.arange(B, device=dev)[None]
    real = j < n_seg[:, None]
    nxt = torch.cat([starts[:, 1:], starts.new_zeros(K, 1)], dim=1)
    ends = torch.where(j + 1 < n_seg[:, None], nxt, n_words[:, None])
    lo = torch.where(real, starts, 0).clamp(0, W)
    hi = torch.where(real, ends, 0).clamp(0, W)
    out = MIX_SEED ^ p.gather(1, hi) ^ p.gather(1, lo)
    return to_i32(torch.where(real, out, MIX_SEED))


def shard_seal(words: torch.Tensor, starts: torch.Tensor, n_seg,
               n_words) -> torch.Tensor:
    """(K, B) int32 digests of every lane's segments: the plain version
    for CPU tensors, one launch of the CUDA kernel for CUDA tensors."""
    words = _grid_words(words)
    starts = starts.to(torch.int64)
    if starts.dim() != 2 or starts.shape[0] != words.shape[0]:
        raise ValueError("starts must be a (K, B) grid over the same lanes")
    if words.device.type == "cpu":
        return shard_seal_torch(words, starts, n_seg, n_words)
    dev = check_cuda(words, starts)
    K, W = words.shape
    B = starts.shape[1]
    if B == 0 or K == 0:
        return torch.empty(K, B, dtype=torch.int32, device=dev)
    if starts.stride(1) != 1:
        starts = starts.contiguous()
    n_seg, n_words = _lanes(n_seg, K, dev), _lanes(n_words, K, dev)
    out = _launch(words, starts, n_seg, n_words, plan(max(1, K * W)).span)
    shard_seal.launches += 1
    return out


def _launch(words, starts, n_seg, n_words, span: int) -> torch.Tensor:
    """The kernel at ``span`` words a block (a multiple of
    ``batch_seal.MIN_SPAN``)."""
    K, W = words.shape
    B = starts.shape[1]
    dev = words.device
    out = torch.empty(K, B, dtype=torch.int32, device=dev)
    lane_blocks = max(1, -(-W // span))
    # a SealCarry record (three 8-byte words) a block of each lane, never
    # read unwritten; a ticket a lane, zeroed for this launch
    carry = torch.empty(3 * K * lane_blocks, dtype=torch.int64, device=dev)
    tickets = torch.zeros(K, dtype=torch.int32, device=dev)
    _build.launch("fold_shard_seal", dev, words.data_ptr(), words.stride(0),
                  starts.data_ptr(), starts.stride(0), n_seg.data_ptr(),
                  n_words.data_ptr(), K, B, W, span, carry.data_ptr(),
                  tickets.data_ptr(), out.data_ptr())
    return out


shard_seal.launches = 0


def shard_seal_mesh(words: torch.Tensor, starts: torch.Tensor, n_seg,
                    n_words, *, mesh=None) -> torch.Tensor:
    """The fold with the lane rows split over a shard mesh
    (``make_shard_mesh`` on the words' device by default): rows padded to
    a multiple of the mesh size by empty lanes, each contiguous block
    folded on its own device by the factory's ``shard_seal`` impl, the
    blocks gathered in order on the mesh's first device."""
    from repro_torch.kernels.factory import get_kernel
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.sharding.specs import shard_lane_spec
    words = _grid_words(words)
    starts = starts.to(torch.int64)
    if mesh is None:
        mesh = make_shard_mesh(device=words.device)
    K, W = words.shape
    n_seg = _lanes(n_seg, K, words.device)
    n_words = _lanes(n_words, K, words.device)
    spec = shard_lane_spec()
    kp = spec.padded_rows(K, mesh.size)
    if kp != K:                             # empty lanes: a row of seeds
        pad = kp - K
        words = torch.cat([words, words.new_zeros(pad, W)])
        starts = torch.cat([starts, starts.new_zeros(pad, starts.shape[1])])
        n_seg = torch.cat([n_seg, n_seg.new_zeros(pad)])
        n_words = torch.cat([n_words, n_words.new_zeros(pad)])
    fold = get_kernel("shard_seal")
    if fold is shard_seal_mesh:             # a block folds on one device
        fold = shard_seal
    home = mesh.devices[0]
    outs = [fold(*(t[lo:hi].to(d) for t in (words, starts, n_seg, n_words))
                 ).to(home)
            for (lo, hi), d in zip(spec.blocks(K, mesh.size), mesh.devices)]
    return torch.cat(outs)[:K]

