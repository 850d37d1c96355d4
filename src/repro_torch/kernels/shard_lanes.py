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

Kernel (``shard_seal_cluster_kernel`` in ``csrc/shard.cu``; the JAX
package's ``_lane_fold`` at ``src/repro/kernels/shard_lanes.py:79`` has no
Pallas form): a thread-block cluster a lane, grid ``(C, K)``, ``C`` from
``plan_clusters`` (a power of two up to 16, about a block for every two
SMs).  Block ``r`` owns the ``r``-th of ``C`` equal ranges of the lane's
16-byte cover: one producer thread bulk-copies the starts an evenly cut
lane would put in the range (a search takes over where they do not
bracket it), then streams the range's words through a ring of 16 KB
stages; two groups of 256 walkers take the stages in turn, a run of 4
vectors a thread; a warp joins its 32 runs by a scan of shuffles, writes
the segments that start and end in its chunk of ``CHUNK_VECS`` vectors and
xors the chunk's first and last pieces into the segments' shared-memory
accumulators; the block then writes its segments that ended in the range.
The piece of the segment begun before each range, and of the one still
open at its end, meet in rank 0's shared memory (distributed shared
memory, one cluster barrier), where a prefix xor over the cluster writes
the segments that cross ranges.  No scratch, no fill, no counter: one
launch a call, refused (never run another way) where no cluster of ``C``
blocks fits the card.  ``shard_seal_mirror`` repeats the ranges, chunks
and join on the CPU.  Bound: ``4·ΣW_k + 8·ΣB_k + 4·K·B`` bytes (words
read, starts read, digests written).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted
from repro_torch.kernels.rollup_digest import (MIX_SEED, OPS_PER_WORD,
                                               check_cuda, mix_u32, to_i32,
                                               to_u32)

MAX_CLUSTER = 16                    # blocks a lane at most, kMaxCluster
STAGE_VECS = 1024                   # 16-byte vectors a ring stage ..
CHUNK_VECS = 128                    # .. and a warp's 32 runs, kChunkWords / 4


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


def shard_seal_cost(words: torch.Tensor, starts: torch.Tensor, n_seg,
                    n_words) -> Tuple[int, int]:
    """(operations, bytes) of one K-lane seal at this run's lanes: each
    lane's ``n_words`` read once and mixed, 8 bytes of start read a real
    segment, the (K, B) digests written.  Reads ``n_seg`` and ``n_words``
    where they lie (one sync on the card)."""
    K, B = starts.shape[0], starts.shape[1]
    sum_w = int(torch.as_tensor(n_words).sum())
    sum_b = int(torch.as_tensor(n_seg).sum())
    return OPS_PER_WORD * sum_w, 4 * sum_w + 8 * sum_b + 4 * K * B


@counted("shard_seal")
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


def plan_clusters(k: int, sms: int = 132) -> int:
    """Blocks a lane for ``k`` lanes on a card of ``sms`` SMs: the largest
    power of two up to ``MAX_CLUSTER`` that keeps ``k`` clusters to a
    block for every two SMs (at least 1).  A block's two walker groups
    keep an SM's share of the bandwidth busy; at 8 lanes on an H100, 8
    blocks a lane ran both fused fabric calls faster than 16
    (tools/shard_split.py)."""
    c = 1
    while 2 * c <= MAX_CLUSTER and k * 2 * c <= sms // 2:
        c *= 2
    return c


@counted("shard_seal")
def shard_seal(words: torch.Tensor, starts: torch.Tensor, n_seg,
               n_words) -> torch.Tensor:
    """(K, B) int32 digests of every lane's segments: the plain version
    for CPU tensors, one launch of the CUDA kernel for CUDA tensors
    (``plan_clusters`` blocks a lane, kept in ``last_clusters``)."""
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
    shard_seal.last_clusters = plan_clusters(K, _sm_count(dev))
    out = _launch(words, starts, n_seg, n_words, shard_seal.last_clusters)
    shard_seal.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(words, starts, n_seg, n_words, clusters: int) -> torch.Tensor:
    """The kernel at ``clusters`` blocks a lane (a power of two up to
    ``MAX_CLUSTER``; ``plan_clusters`` picks it, a test forces it)."""
    K, W = words.shape
    B = starts.shape[1]
    out = torch.empty(K, B, dtype=torch.int32, device=words.device)
    _build.launch("fold_shard_seal", words.device, words.data_ptr(),
                  words.stride(0), starts.data_ptr(), starts.stride(0),
                  n_seg.data_ptr(), n_words.data_ptr(), K, B, W, clusters,
                  out.data_ptr())
    return out


shard_seal.launches = 0
shard_seal.last_clusters = None


def shard_seal_mirror(words: torch.Tensor, starts: torch.Tensor, n_seg,
                      n_words, clusters: Optional[int] = None
                      ) -> torch.Tensor:
    """The kernel's ranges, chunks and cluster join on the CPU, at
    ``clusters`` blocks a lane (``plan_clusters``' by default).  Block
    ``r`` of lane ``k`` owns vectors ``[r·RV, (r+1)·RV)`` of the row's
    16-byte cover (its misalignment read from the row's address, as the
    kernel reads it), ``RV = ceil(V / C)``.  A segment is written by a
    warp where it starts and ends in one warp's chunk of ``CHUNK_VECS``
    vectors (chunks tile each block's ring stages of ``STAGE_VECS``
    vectors from its first), by its block where it starts and ends in the
    block's range, else by rank 0's join as ``seed ^`` its piece in the
    block where it starts ``^ P[e] ^ P[r]``: ``P`` the prefix xor over the
    cluster of each block's piece of the segment begun before its range,
    ``e`` the block of the segment's last word.  Raises if a block would
    leave the join more than one open segment."""
    words = _grid_words(words).cpu()
    starts = starts.to(torch.int64).cpu()
    K, _ = words.shape
    B = starts.shape[1]
    n_seg = _lanes(n_seg, K, "cpu").numpy()
    n_words = _lanes(n_words, K, "cpu").numpy()
    c = plan_clusters(K) if clusters is None else clusters
    if c < 1 or c > MAX_CLUSTER or c & (c - 1):
        raise ValueError(f"{c} blocks a lane: not a power of two up to "
                         f"{MAX_CLUSTER}")
    out = np.full((K, B), MIX_SEED, np.uint32)
    mult = np.uint32(0x85EBCA6B)
    for k in range(K):
        n, nb = int(n_words[k]), int(n_seg[k])
        if nb < 1:
            continue
        row = words[k]
        h0 = (row.data_ptr() & 15) >> 2
        w = row[:n].numpy().view(np.uint32)
        mixed = (w ^ (w >> np.uint32(16))) * mult
        # prefix[i]: xor of the first i mixed words
        prefix = np.concatenate([[np.uint32(0)],
                                 np.bitwise_xor.accumulate(mixed)])
        st = starts[k, :nb].numpy()
        en = np.append(st[1:], n)
        v_total = (h0 + n + 3) // 4
        rv = -(-v_total // c)
        v_lo = np.minimum(np.arange(c) * rv, v_total)
        r_lo = np.where(v_lo == 0, 0, np.minimum(4 * v_lo - h0, n))
        r_hi = np.minimum(4 * np.minimum(v_lo + rv, v_total) - h0, n)

        def block(p):                       # the block of lane word p
            return (p + h0) // 4 // rv

        # chunks tile each block's vectors from its first (rv need not be
        # a multiple of CHUNK_VECS): (block, block vector // CHUNK_VECS)
        def chunk_in_block(p):
            v = (p + h0) // 4
            return block(p), (v - v_lo[block(p)]) // CHUNK_VECS

        def piece(b, lo, hi):               # words [lo, hi) cut to block b
            lo = np.maximum(lo, r_lo[b])
            hi = np.minimum(hi, r_hi[b])
            return np.where(hi > lo, prefix[np.maximum(hi, lo)] ^
                            prefix[lo], np.uint32(0))
        b_s, chunk_s = chunk_in_block(st)
        b_e, chunk_e = chunk_in_block(en - 1)
        # the segment begun before each range: k_lo(r) = starts below r_lo
        k_lo = np.searchsorted(st, r_lo)
        before = k_lo - 1
        first = np.where(
            k_lo > 0, piece(np.arange(c), st[np.maximum(before, 0)],
                            en[np.maximum(before, 0)]), np.uint32(0))
        p_join = np.bitwise_xor.accumulate(first)
        digest = np.zeros(nb, np.uint32)
        warp = (b_s == b_e) & (chunk_s == chunk_e)
        in_block = (b_s == b_e) & ~warp
        joined = b_s != b_e
        for mask in (warp, in_block):       # the block's own words
            digest[mask] = piece(b_s[mask], st[mask], en[mask])
        digest[joined] = (piece(b_s[joined], st[joined], en[joined])
                          ^ p_join[b_e[joined]] ^ p_join[b_s[joined]])
        # a block leaves one open segment at most: the last that starts
        # in it
        if np.bincount(b_s[joined], minlength=c).max(initial=0) > 1:
            raise AssertionError("a block leaves two open segments")
        out[k, :nb] = np.uint32(MIX_SEED) ^ digest
    return torch.from_numpy(out.view(np.int32))


@counted("shard_seal")
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

