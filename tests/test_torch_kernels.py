"""The port's four fold ops, plain PyTorch versions on the CPU, held bit for
bit (tolerance 0) against the JAX package's Pallas kernels in interpret
mode and against its numpy mirrors, on the grids of tests/test_kernels.py
and tests/test_state.py.  The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import xor_fold_digest
from repro.core.state import STATE_CHUNK_WORDS, chunk_fold_digests
from repro.kernels.batch_seal import batch_seal_np, batch_seal_pallas
from repro.kernels.dirty_fold import dirty_fold_np, dirty_fold_pallas
from repro.kernels.rollup_digest import (rollup_chunk_digests,
                                         rollup_digest, rollup_digest_jax)
from repro_torch.core import engine as teng
from repro_torch.kernels import batch_seal as tbs
from repro_torch.kernels import dirty_fold as tdf
from repro_torch.kernels import factory
from repro_torch.kernels import rollup_digest as trd

torch.set_num_threads(1)


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(words):
    """u32 numpy words -> the port's int32 word tensor (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                            .view(np.int32))


def _np(t):
    """The port's int32 word tensor -> u32 numpy."""
    return t.numpy().view(np.uint32)


# -- the shared helpers ------------------------------------------------------

def test_mix_matches_numpy_u32_arithmetic():
    rng = np.random.default_rng(0)
    w = np.concatenate([_u32(rng, 5000),
                        np.array([0, 1, 0xFFFF, 0x10000, 2**31 - 1, 2**31,
                                  2**32 - 1], np.uint32)])
    want = (w ^ (w >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    got = trd.mix_u32(trd.to_u32(_t(w))).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    # int32 round trip keeps the bits
    np.testing.assert_array_equal(
        _np(trd.to_i32(torch.from_numpy(w.astype(np.int64)))), w)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 1024])
def test_xor_reduce_any_width(n):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**32, (3, n), dtype=np.int64)
    want = np.bitwise_xor.reduce(v, axis=1) if n else np.zeros(3, np.int64)
    np.testing.assert_array_equal(trd.xor_reduce(torch.from_numpy(v)).numpy(),
                                  want)


# -- rollup_digest ------------------------------------------------------------

@pytest.mark.parametrize("P", [128, 10000, 65536])
def test_rollup_digest_f32_matches_pallas(P):
    rng = np.random.default_rng(P)
    buf = rng.normal(size=(P,)).astype(np.float32)
    want = int(rollup_digest(jnp.asarray(buf), block_p=2048,
                             interpret=True))
    got = trd.rollup_digest_torch(torch.from_numpy(buf))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) & trd.MASK == want
    # the wrapper takes the plain version for a CPU tensor
    assert int(trd.rollup_digest(torch.from_numpy(buf))) == int(got)


@pytest.mark.parametrize("n", [0, 1, 7, 513, 4096])
def test_rollup_digest_u32_matches_mirror(n):
    rng = np.random.default_rng(2024 + n)
    words = rng.integers(0, 2**32, n, dtype=np.uint32)
    want = xor_fold_digest(words)
    assert want == int(rollup_digest_jax(jnp.asarray(words)))
    assert int(trd.rollup_digest_torch(_t(words))) & trd.MASK == want
    assert teng.xor_fold_digest(_t(words)) == want
    # uint32 tensors are read as the same bits
    u = torch.from_numpy(words.astype(np.int64)).to(torch.uint32)
    assert int(trd.rollup_digest(u)) & trd.MASK == want


@pytest.mark.parametrize("n,clusters", [
    (0, 1), (1, 1), (200_900, 1), (trd.SPLIT_WORDS, 1),
    (trd.SPLIT_WORDS + 1, 2), (3 * trd.SPLIT_WORDS, 3),
    (8 * trd.SPLIT_WORDS + 1, trd.MAX_CLUSTERS),
    (100 * trd.SPLIT_WORDS, trd.MAX_CLUSTERS)])
def test_rollup_digest_plan(n, clusters):
    """One cluster (one launch) up to the split, then one a split's words,
    at most MAX_CLUSTERS."""
    assert trd.plan(n) == clusters


@pytest.mark.parametrize("n", [0, 1, 7, 513, 4096, 200_900,
                               trd.SPLIT_WORDS - 1, trd.SPLIT_WORDS + 1,
                               3 * trd.SPLIT_WORDS + 5])
def test_rollup_digest_partition_folds_every_word_once(n):
    """The kernel's partition (each word to one thread at the buffer's
    alignment, a xor a block, then a cluster, then the seed) gives the
    plain digest at every alignment and at one cluster and plan(n)'s:
    every word is folded exactly once."""
    rng = np.random.default_rng(n)
    words = _t(rng.integers(0, 2**32, n + 3, dtype=np.uint32))
    for start in (0, 1, 2, 3):
        buf = words[start: start + n]
        want = int(trd.rollup_digest_torch(buf))
        for clusters in sorted({1, trd.plan(n)}):
            assert int(trd.rollup_digest_mirror(buf, clusters)) == want


# -- rollup_chunk_digests -----------------------------------------------------

@pytest.mark.parametrize("n", [1, 128, 2048, 4097, 70000])
def test_chunk_digests_match_pallas(n):
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2**32, n, dtype=np.uint32)
    want = np.asarray(rollup_chunk_digests(jnp.asarray(words), chunk_p=2048,
                                           interpret=True))
    np.testing.assert_array_equal(chunk_fold_digests(words, 2048), want)
    got = trd.rollup_chunk_digests_torch(_t(words), 2048)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(trd.rollup_chunk_digests(_t(words))),
                                  want)


def test_chunk_digests_f32_bitcast_and_empty():
    rng = np.random.default_rng(5)
    buf = rng.normal(size=(5000,)).astype(np.float32)
    want = np.asarray(rollup_chunk_digests(jnp.asarray(buf), chunk_p=2048,
                                           interpret=True))
    np.testing.assert_array_equal(
        _np(trd.rollup_chunk_digests(torch.from_numpy(buf))), want)
    empty = trd.rollup_chunk_digests(torch.zeros(0, dtype=torch.int32))
    np.testing.assert_array_equal(_np(empty),
                                  chunk_fold_digests(np.zeros(0, np.uint32)))


@pytest.mark.parametrize("n,chunk,off", [
    (40 * 128 + 1, 128, 1), (40 * 2048 + 1, 2048, 2),
    (40 * 65_536 + 1, 65_536, 3), (11 * 20_000, 2048, 3)])
def test_chunk_digests_hard_cases(n, chunk, off):
    """The card's hard cases on the plain version: a ragged last chunk of
    one word, chunks of 128 to 65,536 words (the block form), a view
    offset by 1-3 words; bit-equal to the JAX package's numpy mirror."""
    rng = np.random.default_rng(chunk + off)
    words = _u32(rng, n + off)
    view = _t(words)[off:]
    want = chunk_fold_digests(words[off:], chunk)
    np.testing.assert_array_equal(
        _np(trd.rollup_chunk_digests_torch(view, chunk)), want)
    np.testing.assert_array_equal(_np(trd.rollup_chunk_digests(view, chunk)),
                                  want)


@pytest.mark.parametrize("chunk,form,warps", [
    (1, "warp", 1), (2048, "warp", 1),
    (trd.WARP_CHUNK_MAX + 1, "block", trd.BLOCK_WARPS),
    (65_536, "block", trd.BLOCK_WARPS)])
def test_chunk_digests_form(chunk, form, warps):
    """rollup_chunk_digests folds a chunk as dirty_fold does: one form
    function, a warp a chunk up to ``WARP_CHUNK_MAX`` words, a block of
    ``BLOCK_WARPS`` warps a chunk above."""
    assert tdf.form is trd.form and tdf.chunk_warps is trd.chunk_warps
    assert trd.form(chunk) == form
    assert trd.chunk_warps(chunk) == warps


# -- batch_seal ---------------------------------------------------------------

@pytest.mark.parametrize("n_words,n_segs,seed", [
    (4, 1, 0),
    (4096, 17, 1),
    (100_000, 257, 2),
    (128, 128, 3),                     # one word per segment
])
def test_batch_seal_matches_pallas(n_words, n_segs, seed):
    g = np.random.default_rng(seed)
    words = _u32(g, n_words)
    cuts = np.sort(g.choice(np.arange(1, n_words), n_segs - 1,
                            replace=False)) if n_segs > 1 else \
        np.empty(0, np.int64)
    starts = np.concatenate([[0], cuts]).astype(np.int64)
    want = batch_seal_np(words, starts)
    np.testing.assert_array_equal(
        batch_seal_pallas(words, starts, interpret=True), want)
    got = tbs.batch_seal_torch(_t(words), torch.from_numpy(starts))
    assert got.dtype == torch.int32 and got.shape == (n_segs,)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(tbs.batch_seal(_t(words), torch.from_numpy(starts))), want)


def test_batch_seal_single_segment_and_empty():
    g = np.random.default_rng(5)
    words = _u32(g, 777)
    one = tbs.batch_seal(_t(words), torch.zeros(1, dtype=torch.int64))
    assert int(one[0]) & trd.MASK == xor_fold_digest(words)
    none = tbs.batch_seal(_t(words), torch.zeros(0, dtype=torch.int64))
    assert none.shape == (0,) and none.dtype == torch.int32


# -- dirty_fold ---------------------------------------------------------------

@pytest.mark.parametrize("n_words,n_dirty,seed", [
    (1, 1, 0),
    (100, 1, 1),                       # single sub-chunk buffer
    (5_000, 2, 2),                     # padded tail chunk dirty
    (70_000, 7, 3),
    (300_000, 146, 4),                 # every chunk dirty (dup ids too)
])
def test_dirty_fold_matches_pallas(n_words, n_dirty, seed):
    g = np.random.default_rng(seed)
    words = _u32(g, n_words)
    n_chunks = -(-n_words // STATE_CHUNK_WORDS)
    ids = g.integers(0, n_chunks, n_dirty)
    want = chunk_fold_digests(words, STATE_CHUNK_WORDS)[ids]
    np.testing.assert_array_equal(
        dirty_fold_np(words, ids, STATE_CHUNK_WORDS), want)
    np.testing.assert_array_equal(
        dirty_fold_pallas(words, ids, STATE_CHUNK_WORDS, interpret=True),
        want)
    got = tdf.dirty_fold_torch(_t(words), torch.from_numpy(ids),
                               STATE_CHUNK_WORDS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(tdf.dirty_fold(_t(words), torch.from_numpy(ids),
                           STATE_CHUNK_WORDS)), want)


def test_dirty_fold_empty_ids():
    words = _t(np.arange(4096, dtype=np.uint32))
    none = torch.zeros(0, dtype=torch.int64)
    for impl in (tdf.dirty_fold_torch, tdf.dirty_fold):
        out = impl(words, none, STATE_CHUNK_WORDS)
        assert out.shape == (0,) and out.dtype == torch.int32


# -- factory ------------------------------------------------------------------

OPS = ("batch_seal", "rollup_digest", "rollup_chunk_digests", "dirty_fold")


@pytest.mark.parametrize("op", OPS)
def test_factory_impls_and_selection(op, monkeypatch):
    assert factory.available_impls(op) == ("cuda", "torch")
    monkeypatch.delenv("REPRO_TORCH_KERNEL_IMPL", raising=False)
    wrapper = factory.get_kernel(op, "cuda")
    plain = factory.get_kernel(op, "torch")
    assert factory.get_kernel(op) is wrapper
    assert plain.__name__ == wrapper.__name__ + "_torch"
    monkeypatch.setenv("REPRO_TORCH_KERNEL_IMPL", "torch")
    assert factory.get_kernel(op) is plain
    assert factory.get_kernel(op, "cuda") is wrapper    # explicit wins


def test_factory_errors():
    with pytest.raises(KeyError, match="unknown kernel op"):
        factory.get_kernel("shard_fold")
    with pytest.raises(KeyError, match="no impl"):
        factory.get_kernel("batch_seal", "pallas")


def test_cpu_tensors_never_launch():
    """On the CPU the wrappers run the plain versions: no launch counted."""
    before = [f.launches for f in (trd.rollup_digest, trd.rollup_chunk_digests,
                                   tdf.dirty_fold, tbs.batch_seal)]
    words = _t(np.arange(5000, dtype=np.uint32))
    trd.rollup_digest(words)
    trd.rollup_chunk_digests(words)
    tdf.dirty_fold(words, torch.tensor([0, 2]), STATE_CHUNK_WORDS)
    tbs.batch_seal(words, torch.tensor([0, 100]))
    after = [f.launches for f in (trd.rollup_digest, trd.rollup_chunk_digests,
                                  tdf.dirty_fold, tbs.batch_seal)]
    assert after == before
