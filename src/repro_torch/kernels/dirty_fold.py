"""Dirty-chunk refold: xor-mix digests of the SELECTED chunks only.

The state commitment (``core/state.py``) caches its per-chunk digest
vector; after a window only the chunks covering rows that changed are
refolded, and this op is that refold: given the patched word buffer and
the ids of the dirty chunks, one digest per id, equal to
``rollup_chunk_digests(words, chunk)[chunk_ids]``.

Kernel: replaces the Pallas ``_fold_kernel`` of
``src/repro/kernels/dirty_fold.py:107``.  Bound: the words of the selected
chunks read once (4 bytes each), the ids read and one word written per id.
Design: the block-per-chunk body of ``rollup_chunk_digests``, with each
block reading its own chunk id from the ``(D,)`` id tensor, so the gather
happens in the kernel's loads instead of as a gathered copy of the rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import (MIX_SEED, check_cuda,
                                               as_words, mix_u32, to_i32,
                                               to_u32, xor_reduce)


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
    out = torch.empty(ids.numel(), dtype=torch.int32, device=dev)
    if ids.numel():
        _build.launch("fold_dirty_chunks", dev, words.data_ptr(),
                      words.numel(), chunk, ids.data_ptr(), ids.numel(),
                      out.data_ptr())
        dirty_fold.launches += 1
    return out


dirty_fold.launches = 0
