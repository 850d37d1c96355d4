"""Batch seal: one xor-mix digest per word segment of a sealed tx stream.

``VectorRollup.seal`` folds the lane-sorted word buffer into one digest per
rollup batch: segment ``i`` is ``[starts[i], starts[i+1])``, the last one
ends at the end of the buffer.  Segments must be non-empty (seal batches
always are).

Plain version: a log-step prefix xor of the mixed words; a segment's
digest is the xor of two prefixes (xor is its own inverse).

Kernel: replaces the Pallas ``_seal_kernel`` of
``src/repro/kernels/batch_seal.py:59``.  Bound: 4·N bytes of words and
8 bytes of start per segment read, one word written per segment.  Design:
segments on the node path are one batch of 20 txs x 4 words, far too short
for a block, so one warp folds one segment (lanes stride it, a warp xor
reduce, lane 0 writes) and reads its bounds from ``starts`` itself: no
zero-padded tile of the segments is built.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import (MIX_SEED, check_cuda,
                                               as_words, mix_u32, to_i32,
                                               to_u32)


def batch_seal_torch(words: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
    """Plain version: (nb,) int32 segment digests by prefix xor."""
    starts = starts.to(torch.int64)
    prefix = mix_u32(to_u32(as_words(words)))
    n = prefix.numel()
    step = 1
    while step < n:                          # Hillis-Steele inclusive scan
        prefix = torch.cat([prefix[:step], prefix[step:] ^ prefix[:-step]])
        step *= 2
    # p[i] = xor of the first i mixed words
    p = torch.cat([prefix.new_zeros(1), prefix])
    ends = torch.cat([starts[1:], starts.new_tensor([n])])
    return to_i32(MIX_SEED ^ p[ends] ^ p[starts])


def batch_seal(words: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """(nb,) int32 digests of the segments that begin at ``starts``."""
    words = as_words(words)
    starts = starts.reshape(-1).to(torch.int64).contiguous()
    if words.device.type == "cpu":
        return batch_seal_torch(words, starts)
    dev = check_cuda(words, starts)
    out = torch.empty(starts.numel(), dtype=torch.int32, device=dev)
    if starts.numel():
        _build.launch("fold_batch_seal", dev, words.data_ptr(),
                      words.numel(), starts.data_ptr(), starts.numel(),
                      out.data_ptr())
        batch_seal.launches += 1
    return out


batch_seal.launches = 0
