"""Dirty-chunk refold: xor-mix digests of the SELECTED chunks only.

The state commitment (``core/state.py``) caches its per-chunk digest
vector; after a window only the chunks covering rows that changed are
refolded, and this op is that refold: given the patched word buffer and
the ids of the dirty chunks, one digest per id, equal to
``rollup_chunk_digests(words, chunk)[chunk_ids]``.

Kernel (``dirty_fold_kernel`` in ``csrc/fold.cu``): replaces the Pallas
``_fold_kernel`` of ``src/repro/kernels/dirty_fold.py:107``.  Bound: the
words of the selected chunks read once (4 bytes each), the ids read and
one word written per id; on the node path 1,408 chunks of 2,048 words,
11.5 MB a window.  What holds a read of that size at the memory's rate is
the bytes in flight on every SM, so the design (``form``): one warp folds
one chunk (a 2,048-word chunk is 16 uint4 a lane, four loads in flight
a lane) and ends with a shuffle xor -- no shared memory, no
``__syncthreads`` -- 8 warps a block, so the node path's 1,408 ids take
176 blocks, all resident at once.  Chunks above ``WARP_CHUNK_MAX`` words
take a block of 8 warps each (a block xor).  Each warp or block reads its
own chunk id from the ``(D,)`` id tensor, so the gather happens in the
kernel's loads instead of as a gathered copy of the rows; an id outside
``[0, n_chunks)`` folds as an empty chunk (the seed).  Any word alignment:
the head and tail of a chunk off the 16-byte grid are scalar loads.  The
fold of a chunk (``fold_chunk`` in ``csrc/fold.cu``) and ``form`` are
shared with ``rollup_chunk_digests``, which folds every chunk in order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import (  # noqa: F401
    BLOCK_WARPS, MIX_SEED, WARP_CHUNK_MAX, as_words, check_cuda,
    chunk_warps, form, mix_u32, to_i32, to_u32, xor_reduce)


def dirty_fold_torch(words: torch.Tensor, chunk_ids: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """Plain version: (D,) int32 digests of chunks ``chunk_ids``."""
    ids = chunk_ids.to(torch.int64)
    if ids.numel() == 0:
        return torch.zeros(0, dtype=torch.int32, device=words.device)
    v = to_u32(as_words(words))
    pad = (-v.numel()) % chunk
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    rows = v.reshape(-1, chunk)[ids]
    return to_i32(MIX_SEED ^ xor_reduce(mix_u32(rows)))


def dirty_fold(words: torch.Tensor, chunk_ids: torch.Tensor,
               chunk: int) -> torch.Tensor:
    """(D,) int32 digests of the chunks named by ``chunk_ids``."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    words = as_words(words)
    ids = chunk_ids.reshape(-1).to(torch.int64).contiguous()
    if words.device.type == "cpu":
        return dirty_fold_torch(words, ids, chunk)
    dev = check_cuda(words, ids)
    if not ids.numel():
        return torch.empty(0, dtype=torch.int32, device=dev)
    out = _launch(words, ids, chunk, chunk_warps(chunk))
    dirty_fold.launches += 1
    return out


def _launch(words: torch.Tensor, ids: torch.Tensor, chunk: int,
            warps: int) -> torch.Tensor:
    """The kernel with ``warps`` warps a chunk (1 or ``BLOCK_WARPS``)."""
    out = torch.empty(ids.numel(), dtype=torch.int32, device=words.device)
    _build.launch("fold_dirty_chunks", words.device, words.data_ptr(),
                  words.numel(), chunk, ids.data_ptr(), ids.numel(), warps,
                  out.data_ptr())
    return out


dirty_fold.launches = 0
