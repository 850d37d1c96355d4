"""The launch plan of the port's ``shard_seal`` kernel, on the CPU:
``shard_seal_mirror`` (the kernel's ranges, warp chunks and cluster join)
bit-equal (tolerance 0) to the plain version ``shard_seal_torch`` and to
the JAX package's ``shard_seal_np`` at the hard cases of
``chip_smoke.shard_seal_cases`` for every block count 1, 2, 4, 8 and 16; a
property over random segmentations on views offset by 0-3 words, with
segment edges on the kernel's range, stage and chunk edges; and
``plan_clusters`` at the paths' 8 lanes and at 1, 2 and 64.  The kernel
itself is held against its plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.shard_lanes import shard_seal_np
from repro_torch.kernels import shard_lanes as sl

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # pragma: no cover
    from conftest import given, settings, st  # noqa: F401

torch.set_num_threads(1)

CLUSTERS = (1, 2, 4, 8, 16)


@functools.lru_cache(maxsize=None)
def _hard_cases():
    """{label: (args on the CPU, the plain version's digests)}: the plain
    version is held to shard_seal_np once a case."""
    cases = {}
    for label, lanes, off in chip_smoke.shard_seal_cases(
            np.random.default_rng(16)):
        args = chip_smoke.lane_grid(lanes, torch.device("cpu"), off)
        words, starts, n_seg, n_words = args
        want = sl.shard_seal_torch(*args)
        np.testing.assert_array_equal(
            want.numpy().view(np.uint32),
            shard_seal_np(np.ascontiguousarray(words.numpy()).view(np.uint32),
                          starts.numpy(), n_seg.numpy(), n_words.numpy()))
        cases[label] = (args, want)
    return cases


HARD_LABELS = [label for label, _, _ in chip_smoke.shard_seal_cases(
    np.random.default_rng(16))]


@pytest.mark.parametrize("clusters", CLUSTERS)
@pytest.mark.parametrize("label", HARD_LABELS)
def test_mirror_matches_plain_and_np(label, clusters):
    args, want = _hard_cases()[label]
    got = sl.shard_seal_mirror(*args, clusters=clusters)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_hard_cases_reach_the_kernels_paths():
    """The hard cases put segment edges on range and stage edges, and
    give a range more starts than the kernel's window (5,120) at 16
    blocks a lane; rows start off the 16-byte grid."""
    cases = _hard_cases()
    args, _ = cases["100,000 one-word segments"]
    assert int(args[2][0]) // 16 > 5120
    args, _ = cases["150,000 segments in 300,000 words"]
    assert int(args[2][0]) // 16 > 5120
    assert any((args[0][k].data_ptr() & 15) for k in range(2))
    words, starts, n_seg, n_words = cases["edges on range and stage edges"][0]
    for k in range(2):
        n = int(n_words[k])
        h0 = (words[k].data_ptr() & 15) >> 2
        cut = set(starts[k, : int(n_seg[k])].tolist())
        v = (h0 + n + 3) // 4
        for c in CLUSTERS:                     # every range edge starts one
            rv = -(-v // c)
            assert all(4 * lo - h0 in cut for lo in range(rv, v, rv))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), lanes=st.integers(1, 3),
       offset=st.integers(0, 3), clusters=st.sampled_from(CLUSTERS),
       edges=st.booleans())
def test_mirror_property(seed, lanes, offset, clusters, edges):
    """Random segmentations (1 word to some 20,000), the first start at
    0 or later, on a view offset by 0-3 words: with ``edges``, every word
    at a range, stage or chunk edge of this block count and its two
    neighbours on each side start segments.  The mirror equals the plain
    version and shard_seal_np."""
    g = np.random.default_rng(seed)
    rows = []
    for _ in range(lanes):
        n = int(g.integers(1, 40_000))
        lengths = np.minimum(10 ** g.uniform(0, 4.3, n), n).astype(np.int64)
        cuts = np.cumsum(np.maximum(lengths, 1))
        cuts = cuts[cuts < n]
        first = int(g.integers(0, 3)) if n > 3 else 0
        st_ = set(cuts.tolist()) | {first}
        if edges:
            st_ |= set(chip_smoke.edge_starts(n, g, 0).tolist())
        st_ = np.array(sorted(x for x in st_ if first <= x < n), np.int64)
        w = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        rows.append((w, st_))
    args = chip_smoke.lane_grid(rows, torch.device("cpu"), offset)
    words, starts, n_seg, n_words = args
    want = sl.shard_seal_torch(*args)
    np.testing.assert_array_equal(
        want.numpy().view(np.uint32),
        shard_seal_np(np.ascontiguousarray(words.numpy()).view(np.uint32),
                      starts.numpy(), n_seg.numpy(), n_words.numpy()))
    assert torch.equal(sl.shard_seal_mirror(*args, clusters=clusters), want)


@pytest.mark.parametrize("lanes,want", [(8, 8), (1, 16), (2, 16),
                                        (64, 1)])
def test_plan_clusters_at_the_paths_lanes(lanes, want):
    """8 lanes (the fused fabric and the FL run on 8 shards) take 8
    blocks a lane on an H100's 132 SMs: 64 blocks, one for every two
    SMs; 1 and 2 lanes the most a cluster holds; 64 lanes one."""
    assert sl.plan_clusters(lanes) == want
    assert sl.plan_clusters(lanes, sms=132) == want


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("lanes", [1, 2, 3, 5, 8, 16, 33, 64, 65535])
def test_plan_clusters_is_the_largest_fit(lanes, sms):
    """A power of two from 1 to MAX_CLUSTER; lanes x blocks at most half
    the SMs unless one block a lane; the next power of two would not
    fit."""
    c = sl.plan_clusters(lanes, sms)
    assert 1 <= c <= sl.MAX_CLUSTER and c & (c - 1) == 0
    assert c == 1 or lanes * c <= sms // 2
    assert c == sl.MAX_CLUSTER or lanes * 2 * c > sms // 2


def test_mirror_default_plan_and_refusals():
    """Without a block count the mirror takes plan_clusters'; a count
    that is no power of two up to 16 is refused; the kernel's chunks
    tile its stages."""
    args, want = _hard_cases()["K=8 unequal"]
    assert torch.equal(sl.shard_seal_mirror(*args), want)
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="power of two"):
            sl.shard_seal_mirror(*args, clusters=bad)
    assert sl.STAGE_VECS % sl.CHUNK_VECS == 0
