"""The launch plans of the port's ``batch_seal`` and ``dirty_fold``
kernels, on the CPU: ``batch_seal_mirror`` (the kernel's spans, segment
pieces and carries, with the prefix xor the last block takes) bit-equal
(tolerance 0) to the JAX package's ``batch_seal_np`` on the grid of
tests/test_kernels.py, at plan's span and at small spans that make every
segment cross spans; a property over random segmentations (lengths of 1
word to 3 spans, views offset by 0-3 words, edges on span edges); plan's
spans at the three path shapes; ``dirty_fold``'s form by chunk.  The
kernels themselves are held against their plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro.kernels.batch_seal import batch_seal_np
from repro_torch.kernels import batch_seal as tbs
from repro_torch.kernels import dirty_fold as tdf

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # pragma: no cover
    from conftest import given, settings, st  # noqa: F401

torch.set_num_threads(1)


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                            .view(np.int32))


def _np(t):
    return t.numpy().view(np.uint32)


# -- batch_seal_mirror --------------------------------------------------------

@pytest.mark.parametrize("span", [None, 1, 7, 64, tbs.MIN_SPAN])
@pytest.mark.parametrize("n_words,n_segs,seed", [
    (4, 1, 0),
    (4096, 17, 1),
    (100_000, 257, 2),
    (128, 128, 3),                     # one word per segment
])
def test_batch_seal_mirror_matches_np(n_words, n_segs, seed, span):
    g = np.random.default_rng(seed)
    words = _u32(g, n_words)
    cuts = np.sort(g.choice(np.arange(1, n_words), n_segs - 1,
                            replace=False)) if n_segs > 1 else \
        np.empty(0, np.int64)
    starts = np.concatenate([[0], cuts]).astype(np.int64)
    got = tbs.batch_seal_mirror(_t(words), torch.from_numpy(starts), span)
    assert got.dtype == torch.int32 and got.shape == (n_segs,)
    np.testing.assert_array_equal(_np(got), batch_seal_np(words, starts))


@pytest.mark.parametrize("first", [1, 5, 1030])
def test_batch_seal_mirror_words_before_the_first_start(first):
    """Words before starts[0] belong to no segment."""
    g = np.random.default_rng(first)
    words = _u32(g, 3000)
    starts = np.array([first, first + 9, 2900], np.int64)
    for span in (None, 4, tbs.MIN_SPAN):
        got = tbs.batch_seal_mirror(_t(words), torch.from_numpy(starts), span)
        np.testing.assert_array_equal(_np(got), batch_seal_np(words, starts))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), span=st.sampled_from([1, 3, 8, 64]),
       offset=st.integers(0, 3), edges=st.booleans())
def test_batch_seal_mirror_property(seed, span, offset, edges):
    """Random segment lengths of 1 word to 3 spans (on span edges, or
    span - 1 / span / span + 1, when ``edges``), on a view offset by 0-3
    words: the mirror equals the numpy mirror at that span."""
    g = np.random.default_rng(seed)
    k = int(g.integers(1, 40))
    if edges:
        lengths = span * g.integers(1, 4, k) + g.integers(-1, 2, k)
        lengths = np.maximum(lengths, 1)
    else:
        lengths = g.integers(1, 3 * span + 1, k)
    n = int(lengths.sum())
    buf = _u32(g, n + offset)
    words = buf[offset:]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    got = tbs.batch_seal_mirror(_t(buf)[offset:], torch.from_numpy(starts),
                                span)
    np.testing.assert_array_equal(_np(got), batch_seal_np(words, starts))


# -- plan --------------------------------------------------------------------

@pytest.mark.parametrize("n,span,blocks", [
    (200_788, 1024, 197),                      # the stepped seal
    (4_001_576, 8192, 489),                    # the fused twin's two calls
    (1, 1024, 1),
    (1 << 30, tbs.MAX_SPAN, (1 << 30) // tbs.MAX_SPAN),
])
def test_batch_seal_plan(n, span, blocks):
    """Spans are equal and cover the buffer: blocks = ceil(n / span), the
    last span ragged; the span is a multiple of MIN_SPAN up to
    MAX_SPAN."""
    p = tbs.plan(n)
    assert (p.span, p.blocks) == (span, blocks)
    assert (p.blocks - 1) * p.span < n <= p.blocks * p.span
    assert p.span % tbs.MIN_SPAN == 0 and p.span <= tbs.MAX_SPAN


def test_batch_seal_plan_forced_span():
    assert tbs.plan(200_788, 4096) == tbs.Plan(4096, 50)
    for bad in (0, 512, tbs.MIN_SPAN + 1, 2 * tbs.MAX_SPAN):
        with pytest.raises(ValueError):
            tbs.plan(10_000, bad)


# -- dirty_fold's form --------------------------------------------------------

@pytest.mark.parametrize("chunk,form", [
    (1, "warp"), (2048, "warp"), (tdf.WARP_CHUNK_MAX, "warp"),
    (tdf.WARP_CHUNK_MAX + 1, "block"), (1 << 20, "block")])
def test_dirty_fold_form(chunk, form):
    assert tdf.form(chunk) == form
