"""Rollup validity digest: the xor-mix fold of a whole buffer or its chunks.

``rollup_digest`` folds a buffer to one u32 word (the per-seal update
digest); ``rollup_chunk_digests`` gives one word per ``chunk``-word chunk
(the state commitment).  A digest is ``SEED ^ xor_j mix(w_j)`` with
``mix(w) = (w ^ (w >> 16)) * 0x85EBCA6B mod 2^32``.

Words cross every boundary of the port as ``int32`` tensors that carry the
u32 bits; float32 input is bitcast.  Each op has two forms:

* the plain PyTorch version (``*_torch``): the mix in int64 masked to 32
  bits, the multiply split into the constant's 16-bit halves so that no
  product passes 2^48, and the xor reduction by pairwise halving over zero
  padding (zero words mix to zero);
* the wrapper, which runs the plain version for a CPU tensor and launches
  the CUDA kernel in ``csrc/fold.cu`` for a CUDA tensor, counting each
  launch in its ``launches`` attribute.

``rollup_digest`` kernel: replaces the Pallas ``_kernel`` of
``src/repro/kernels/rollup_digest.py:16``.  Bound: 4·P bytes read over the
card's memory rate.  At a seal's size (~200,900 words) a launch costs more
than its bytes, so one call is one launch where ``plan`` allows: a cluster
of 16 blocks of 1,024 threads folds the buffer in one grid-stride pass
(four 16-byte loads in flight a thread), a warp then block xor, and rank 0
xors the blocks' words through distributed shared memory and writes the
digest, seed included.  A large buffer (``plan(n) > 1``) takes several
clusters, each writing a partial word into scratch, and a one-warp launch
folds them with the seed.  No atomics and no fill; xor is associative, so
every partition gives the same bits (``rollup_digest_mirror`` spells the
partition out).

``rollup_chunk_digests`` kernel (``chunk_digests_kernel``): replaces
``_chunk_kernel`` (``src/repro/kernels/rollup_digest.py:76``).  Bound: 4·P
bytes read plus one word written per chunk; on the node path 2,883,584
words in 1,408 chunks of 2,048, 11.5 MB.  What holds a read of that size
at the memory's rate is the bytes in flight on every SM, so it folds as
``dirty_fold`` does, with the same device function (``fold_chunk`` in
``csrc/fold.cu``) and the same ``form``: a warp a chunk up to
``WARP_CHUNK_MAX`` words (four 16-byte loads in flight a lane, a shuffle
xor, no shared memory or barrier), 8 warps a block; a block of
``BLOCK_WARPS`` warps a chunk above (``chunk_warps``).  Chunk i is the
group's index in the grid, so no id tensor is read; the ragged tail
chunk is masked in the kernel, so no padded copy of the buffer is made,
and any word alignment folds (scalar loads off the 16-byte grid).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted

MIX_MULT = 0x85EBCA6B
MIX_SEED = 0x9E3779B9
MASK = 0xFFFFFFFF
SEED_I32 = MIX_SEED - (1 << 32)           # the seed's bits as an int32
_MULT_HI, _MULT_LO = MIX_MULT >> 16, MIX_MULT & 0xFFFF


# -- plain helpers shared by every fold of the port --------------------------

def as_words(buf: torch.Tensor) -> torch.Tensor:
    """A 1-D buffer as contiguous int32 words carrying u32 bits: int32 and
    uint32 pass through, anything else is cast to float32 and bitcast."""
    buf = buf.reshape(-1)
    if buf.dtype == torch.int32:
        return buf.contiguous()
    if buf.dtype == torch.uint32:
        return buf.contiguous().view(torch.int32)
    return buf.to(torch.float32).contiguous().view(torch.int32)


def to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & MASK


def to_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values (any range) -> int32 carrying their low 32 bits."""
    v = values & MASK
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def mix_u32(v: torch.Tensor) -> torch.Tensor:
    """THE xor-mix on int64 values in [0, 2^32): ``(v ^ (v >> 16)) *
    MIX_MULT mod 2^32``, multiplying by the constant's 16-bit halves."""
    x = v ^ (v >> 16)
    return (x * _MULT_LO + (((x * _MULT_HI) & 0xFFFF) << 16)) & MASK


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """Xor over the last axis by pairwise halving (zero padding to a power
    of two; an empty axis reduces to 0)."""
    n = x.shape[-1]
    width = 1 << max(0, n - 1).bit_length()
    if width != n:
        pad = x.new_zeros(*x.shape[:-1], width - n)
        x = torch.cat([x, pad], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """The tensors' one device, a CUDA device: a kernel's launch takes
    nothing else.  Fake tensors (the kernels' fake forms, which launch
    nothing) may lie on any device."""
    dev = tensors[0].device
    if dev.type != "cuda" and not _build.is_fake(tensors[0]):
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


# -- rollup_digest: whole buffer -> one word ---------------------------------

#: integer operations to mix and fold one word: shift, xor, multiply,
#: xor-reduce
OPS_PER_WORD = 4


def rollup_digest_cost(buf: torch.Tensor) -> Tuple[int, int]:
    """(operations, bytes) of one digest over ``buf``, whatever computes
    it: every word read once and mixed, one word written."""
    n = buf.numel()
    return OPS_PER_WORD * n, 4 * n + 4


@counted("rollup_digest")
def rollup_digest_torch(buf: torch.Tensor) -> torch.Tensor:
    """Plain version: 0-d int32 digest of the whole buffer."""
    mixed = mix_u32(to_u32(as_words(buf)))
    return to_i32(MIX_SEED ^ xor_reduce(mixed))


DIGEST_BLOCK = 1024                 # threads a block, kDigestBlock
DIGEST_CLUSTER = 16                 # blocks a cluster, kDigestCluster
SPLIT_WORDS = 1 << 20               # above this, several clusters ..
MAX_CLUSTERS = 8                    # .. up to this many


def plan(n: int) -> int:
    """Clusters of the ``rollup_digest`` launch for ``n`` words: 1 (one
    launch, the digest written by the cluster) up to ``SPLIT_WORDS``;
    above, one cluster a ``SPLIT_WORDS`` words up to ``MAX_CLUSTERS``, and
    a second launch folding their partial words."""
    return max(1, min(MAX_CLUSTERS, -(-n // SPLIT_WORDS)))


def rollup_digest_mirror(words: torch.Tensor, clusters: int) -> torch.Tensor:
    """The kernel's partition of the words in plain PyTorch: each word
    goes to the one thread ``fold_span4`` (``csrc/fold.cu``) gives it, at
    the buffer's real alignment; each block xors its threads' words, each
    cluster its blocks', and the seed takes the clusters'.  Bit-equal to
    ``rollup_digest_torch`` when every word is folded exactly once."""
    words = as_words(words)
    n = words.numel()
    step = clusters * DIGEST_CLUSTER * DIGEST_BLOCK
    head = min(n, ((16 - words.data_ptr() % 16) % 16) // 4)
    body = (n - head) // 4 * 4
    j = torch.arange(n, dtype=torch.int64)
    thread = torch.where(j < head, j, torch.where(
        j < head + body, torch.div(j - head, 4, rounding_mode="floor") % step,
        j - head - body))
    block = torch.div(thread, DIGEST_BLOCK, rounding_mode="floor")
    mixed = mix_u32(to_u32(words.cpu()))
    n_blocks = clusters * DIGEST_CLUSTER
    # a block's xor, bit by bit: the parity of the bit over its words
    block_words = torch.zeros(n_blocks, dtype=torch.int64)
    for bit in range(32):
        ones = torch.bincount(block, weights=((mixed >> bit) & 1).to(
            torch.float64), minlength=n_blocks)
        block_words |= (ones.to(torch.int64) % 2) << bit
    cluster_words = xor_reduce(block_words.reshape(clusters, DIGEST_CLUSTER))
    return to_i32(MIX_SEED ^ xor_reduce(cluster_words))


@counted("rollup_digest")
def rollup_digest(buf: torch.Tensor) -> torch.Tensor:
    """0-d int32 digest of ``buf`` (int32 words, or float32 bitcast): one
    launch (two above ``SPLIT_WORDS``, see ``plan``) a call."""
    words = as_words(buf)
    if words.device.type == "cpu":
        return rollup_digest_torch(words)
    dev = check_cuda(words)
    if not words.numel():
        return torch.full((), SEED_I32, dtype=torch.int32, device=dev)
    out = _launch(words, plan(words.numel()))
    rollup_digest.launches += 1
    return out


def _launch(words: torch.Tensor, clusters: int) -> torch.Tensor:
    """The kernel over ``clusters`` clusters (``plan`` picks them)."""
    out = torch.empty((), dtype=torch.int32, device=words.device)
    parts = out if clusters == 1 else torch.empty(
        clusters, dtype=torch.int32, device=words.device)
    _build.launch("fold_rollup_digest", words.device, words.data_ptr(),
                  words.numel(), clusters, parts.data_ptr(), out.data_ptr())
    return out


rollup_digest.launches = 0


# -- rollup_chunk_digests: one word per chunk --------------------------------

BLOCK_WARPS = 8                     # block form: warps a chunk (kBlock / 32)
WARP_CHUNK_MAX = 2048               # words: a warp a chunk up to this


def form(chunk: int) -> str:
    """The chunk fold's form (``rollup_chunk_digests`` and ``dirty_fold``):
    ``"warp"`` (a warp a chunk) up to ``WARP_CHUNK_MAX`` words, else
    ``"block"`` (a block of ``BLOCK_WARPS`` warps a chunk)."""
    return "warp" if chunk <= WARP_CHUNK_MAX else "block"


def chunk_warps(chunk: int) -> int:
    """Warps folding one chunk in ``form(chunk)``: 1 or ``BLOCK_WARPS``."""
    return 1 if form(chunk) == "warp" else BLOCK_WARPS


def rollup_chunk_digests_cost(buf: torch.Tensor, chunk: int = 2048
                               ) -> Tuple[int, int]:
    """(operations, bytes) of the chunk digests of ``buf``: every word
    read once and mixed, one word written a chunk."""
    n = buf.numel()
    return OPS_PER_WORD * n, 4 * n + 4 * max(1, -(-n // chunk))


@counted("rollup_chunk_digests")
def rollup_chunk_digests_torch(buf: torch.Tensor,
                               chunk: int = 2048) -> torch.Tensor:
    """Plain version: (ceil(P/chunk),) int32 digests, zero-padded tail; an
    empty buffer gives the one digest of an empty chunk (the seed)."""
    v = to_u32(as_words(buf))
    pad = (-v.numel()) % chunk if v.numel() else chunk
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return to_i32(MIX_SEED ^ xor_reduce(mix_u32(v).reshape(-1, chunk)))


@counted("rollup_chunk_digests")
def rollup_chunk_digests(buf: torch.Tensor, chunk: int = 2048
                         ) -> torch.Tensor:
    """(ceil(P/chunk),) int32 digests, one per ``chunk``-word chunk."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    words = as_words(buf)
    if words.device.type == "cpu":
        return rollup_chunk_digests_torch(words, chunk)
    dev = check_cuda(words)
    if not words.numel():
        return torch.full((1,), SEED_I32, dtype=torch.int32, device=dev)
    out = _chunk_launch(words, chunk, chunk_warps(chunk))
    rollup_chunk_digests.launches += 1
    return out


def _chunk_launch(words: torch.Tensor, chunk: int,
                  warps: int) -> torch.Tensor:
    """The kernel with ``warps`` warps a chunk (1 or ``BLOCK_WARPS``)."""
    out = torch.empty(-(-words.numel() // chunk), dtype=torch.int32,
                      device=words.device)
    _build.launch("fold_chunk_digests", words.device, words.data_ptr(),
                  words.numel(), chunk, warps, out.data_ptr())
    return out


rollup_chunk_digests.launches = 0
