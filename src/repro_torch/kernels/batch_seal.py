"""Batch seal: one xor-mix digest per word segment of a sealed tx stream.

``VectorRollup.seal`` folds the lane-sorted word buffer into one digest per
rollup batch: segment ``i`` is ``[starts[i], starts[i+1])``, the last one
ends at the end of the buffer.  Segments must be non-empty (seal batches
always are): starts strictly increasing, ``starts[0] >= 0`` and
``starts[-1] < n``; words before ``starts[0]`` belong to no segment.  The
fused window loop (``core/fused.py``) calls the same op twice on the whole
run's buffer: once with the batches' starts (segments of at most 80
words) and once with one segment a seal (some 200,000 words each).

Plain version: a log-step prefix xor of the mixed words; a segment's
digest is the xor of two prefixes (xor is its own inverse).

Kernel (``batch_seal_span_kernel`` in ``csrc/fold.cu``): replaces the
Pallas ``_seal_kernel`` of ``src/repro/kernels/batch_seal.py:59``.  Bound:
4·n bytes of words and 8 bytes of start per segment read, one word written
per segment.  Design: the grid splits the WORDS, not the segments, so any
mix of segment lengths runs in one launch of ``ceil(n / span)`` blocks
(``plan``) of ``SEAL_THREADS`` threads: block ``b`` stages words
``[b·span, (b+1)·span)`` with one 1-D bulk copy of their 16-byte cover
(the up to 3 words of the cover outside the span are masked, never
folded); while the copy runs it finds the starts inside its span by a
search of ``starts`` with all its threads (a probe a thread; one round at
50,040 segments, none where they all fit) and stages them in shared memory.
Each thread walks a contiguous run of the span, writes the segments that
start and end in it (seed included) and xors a piece of a longer segment
into the shared-memory slot of the first run edge after its start; the
thread at that edge writes it.  The piece of the segment begun before the
span (``first``) and the piece of the one running past it go to a carry
record; the last block to finish (a ``__threadfence``, then a ticket from
a counter that the same block resets to 0, so no fill launch is ever
needed) takes a prefix xor ``P`` of ``first`` over the spans and writes
each running segment as ``seed ^ piece ^ P[end span] ^ P[its span]``.  One
launch a call, no host sync, no fill.  The ticket counter is one word of
the library per device: calls on one device must not overlap, which holds
because the port launches every kernel on torch's current stream; do not
call ``batch_seal`` from two streams at once.  ``batch_seal_mirror``
repeats the spans, pieces and carries on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted
from repro_torch.kernels.rollup_digest import (MIX_SEED, OPS_PER_WORD,
                                               SEED_I32, check_cuda,
                                               as_words, mix_u32, to_i32,
                                               to_u32)

SEAL_THREADS = 256                  # threads a block, kSealThreads
MIN_SPAN = 4 * SEAL_THREADS         # words a span: one uint4 a thread ..
MAX_SPAN = 8 * MIN_SPAN             # .. up to eight (32 KB), kSealMaxSpan
TARGET_BLOCKS = 512                 # plan's span: about this many blocks


class Plan(NamedTuple):
    span: int                       # words a block
    blocks: int                     # ceil(n / span): the grid


def plan(n: int, span: Optional[int] = None) -> Plan:
    """The launch for ``n`` words: the smallest power-of-two span from
    ``MIN_SPAN`` to ``MAX_SPAN`` words that gives at most ``TARGET_BLOCKS``
    blocks (``span`` forces one, a multiple of ``MIN_SPAN``).  Span ``b``
    holds words ``[b·span, min(n, (b+1)·span))``, whatever the segments:
    a block stages the starts that fall in its span (at most
    ``min(span, nb)``) and the search's slack (the launcher sizes its
    shared memory from ``nb``)."""
    if span is None:
        span = MIN_SPAN
        while span < MAX_SPAN and span * TARGET_BLOCKS < n:
            span *= 2
    elif span % MIN_SPAN or not MIN_SPAN <= span <= MAX_SPAN:
        raise ValueError(f"span {span} is not a multiple of {MIN_SPAN} "
                         f"from {MIN_SPAN} to {MAX_SPAN}")
    return Plan(span, -(-n // span))


def batch_seal_cost(words: torch.Tensor,
                    starts: torch.Tensor) -> Tuple[int, int]:
    """(operations, bytes) of one seal: every word read once and mixed,
    8 bytes of start read and one word written a segment."""
    n = words.numel()
    return OPS_PER_WORD * n, 4 * n + 12 * starts.numel()


@counted("batch_seal")
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


def _xor_groups(group: torch.Tensor, values: torch.Tensor,
                size: int) -> torch.Tensor:
    """Xor of int64 u32 ``values`` by ``group`` id, bit by bit (the parity
    of each bit over the group)."""
    out = torch.zeros(size, dtype=torch.int64)
    for bit in range(32):
        ones = torch.bincount(group, weights=((values >> bit) & 1).to(
            torch.float64), minlength=size)
        out |= (ones.to(torch.int64) % 2) << bit
    return out


def _prefix_xor(values: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix xor of int64 u32 ``values``, bit by bit."""
    out = torch.zeros_like(values)
    for bit in range(32):
        out |= (((values >> bit) & 1).cumsum(0) % 2) << bit
    return out


def batch_seal_mirror(words: torch.Tensor, starts: torch.Tensor,
                      span: Optional[int] = None) -> torch.Tensor:
    """The kernel's spans, pieces and carries in plain PyTorch on the CPU
    (``span``: ``plan``'s by default, or any positive number of words).
    Each word goes to the piece of its span and segment; a segment whose
    start lies in a span is written from that span's piece when it ends
    there, else from the carries, as the last block writes it.  Raises
    if a segment would be written other than once."""
    words = as_words(words).cpu()
    starts = starts.reshape(-1).to(torch.int64).cpu()
    n, nb = words.numel(), starts.numel()
    if not n or not nb:                      # no launch (see batch_seal)
        return torch.full((nb,), SEED_I32, dtype=torch.int32)
    if span is None:
        span = plan(n).span
    blocks = -(-n // span)
    # pieces: xor of each (span, segment) run of words; both never
    # decrease along the buffer, so a run is one key
    pos = torch.arange(n, dtype=torch.int64)
    seg = torch.searchsorted(starts, pos, right=True) - 1
    keys, run = torch.unique_consecutive(
        torch.div(pos, span, rounding_mode="floor") * (nb + 1) + seg + 1,
        return_inverse=True)
    pieces = _xor_groups(run, mix_u32(to_u32(words)), keys.numel())

    def piece(b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        k = b * (nb + 1) + s + 1
        i = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
        return torch.where(keys[i] == k, pieces[i], 0)

    b = torch.arange(blocks, dtype=torch.int64)
    lo, hi = b * span, torch.clamp(b * span + span, max=n)
    k0 = torch.searchsorted(starts, lo)            # starts below the span
    m = torch.searchsorted(starts, hi) - k0        # starts inside it
    nxt = k0 + m
    end_last = torch.where(nxt < nb, starts[nxt.clamp(max=nb - 1)], n)
    runs_on = (m > 0) & (end_last > hi)
    first = torch.where(k0 > 0, piece(b, k0 - 1), 0)
    prefix = _prefix_xor(first)
    out = torch.zeros(nb, dtype=torch.int64)
    writes = torch.zeros(nb, dtype=torch.int64)
    # whole segments, written by the span they start in
    owner = torch.repeat_interleave(b, m)
    ids = k0[owner] + torch.arange(owner.numel()) - torch.repeat_interleave(
        torch.cumsum(m, 0) - m, m)
    whole = ~(runs_on[owner] & (ids == nxt[owner] - 1))
    out[ids[whole]] = piece(owner[whole], ids[whole])
    writes.index_add_(0, ids[whole], torch.ones_like(ids[whole]))
    # segments running past their span, written by the last block
    seg_on = (nxt - 1)[runs_on]
    end_block = torch.clamp(torch.div(end_last - 1, span,
                                      rounding_mode="floor"), max=blocks - 1)
    out[seg_on] = (piece(b[runs_on], seg_on) ^ prefix[runs_on]
                   ^ prefix[end_block[runs_on]])
    writes.index_add_(0, seg_on, torch.ones_like(seg_on))
    if bool((writes != 1).any()):
        raise AssertionError("a segment is written other than once")
    return to_i32(MIX_SEED ^ out)


@counted("batch_seal")
def batch_seal(words: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """(nb,) int32 digests of the segments that begin at ``starts``: one
    launch a call (``plan``)."""
    words = as_words(words)
    starts = starts.reshape(-1).to(torch.int64).contiguous()
    if words.device.type == "cpu":
        return batch_seal_torch(words, starts)
    dev = check_cuda(words, starts)
    if not starts.numel():
        return torch.empty(0, dtype=torch.int32, device=dev)
    if not words.numel():                    # every segment empty
        return torch.full((starts.numel(),), SEED_I32, dtype=torch.int32,
                          device=dev)
    out = _launch(words, starts, plan(words.numel()))
    batch_seal.launches += 1
    return out


def _launch(words: torch.Tensor, starts: torch.Tensor,
            p: Plan) -> torch.Tensor:
    """The kernel at plan ``p`` (``plan`` picks it; a forced span too)."""
    out = torch.empty(starts.numel(), dtype=torch.int32, device=words.device)
    # a SealCarry record a block (three 8-byte words), never read unwritten
    carry = torch.empty(3 * p.blocks, dtype=torch.int64, device=words.device)
    _build.launch("fold_batch_seal", words.device, words.data_ptr(),
                  words.numel(), starts.data_ptr(), starts.numel(), p.span,
                  carry.data_ptr(), out.data_ptr())
    return out


batch_seal.launches = 0
