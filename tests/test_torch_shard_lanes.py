"""The port's ``shard_seal`` (kernels/shard_lanes.py) and the fabric's
partition function against the JAX package's, on the CPU.

``shard_seal_torch`` (the plain version the wrapper runs on the CPU) and
the ``mesh`` impl must equal ``shard_seal_np``, ``shard_seal_jax`` and
``shard_seal_shard_map`` (on the host's one-device mesh) bit for bit: K of
1, 3 and 8 lanes of unequal length, empty lanes, one-word segments,
padded columns holding ``MIX_SEED``; the ``mesh`` impl also over a
3-device CPU mesh (rows padded by empty lanes, blocks gathered in order);
and each lane's row equal to ``batch_seal`` on that lane.  The kernel
itself runs only on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch

from repro.core.state import MIX_SEED
from repro.core.state import account_owner as jax_account_owner
from repro.kernels.shard_lanes import (shard_seal_jax, shard_seal_np,
                                       shard_seal_shard_map)
from repro_torch.core.state import account_owner, account_owner_np
from repro_torch.kernels import factory
from repro_torch.kernels.batch_seal import batch_seal_torch
from repro_torch.kernels.shard_lanes import (shard_seal, shard_seal_mesh,
                                             shard_seal_torch)
from repro_torch.launch.mesh import (ShardMesh, make_shard_mesh,
                                     n_local_devices)
from repro_torch.sharding.specs import SHARD_LANE_AXIS, shard_lane_spec

torch.set_num_threads(1)


def _grid(g, n_words, n_seg, one_word=False):
    """A contract-shaped (words, starts) grid: row k holds ``n_words[k]``
    random words and ``n_seg[k]`` segments (all of one word where
    ``one_word``), padded starts = n_words[k]."""
    k = len(n_words)
    w = max(1, max(n_words))
    b = max(1, max(n_seg))
    words = np.zeros((k, w), np.uint32)
    starts = np.zeros((k, b), np.int64)
    for i, (nw, ns) in enumerate(zip(n_words, n_seg)):
        words[i, :nw] = g.integers(0, 2**32, nw, dtype=np.uint64)
        if ns:
            cuts = (np.arange(1, ns) if one_word else np.sort(g.choice(
                np.arange(1, nw), ns - 1, replace=False)))
            starts[i, :ns] = np.concatenate([[0], cuts])
        starts[i, ns:] = nw
    return words, starts, np.asarray(n_seg), np.asarray(n_words)


def _cases():
    g = np.random.default_rng(0)
    return {
        "k1": _grid(g, [500], [9]),
        "k1_one_segment": _grid(g, [4096], [1]),
        "k3_unequal": _grid(g, [300, 7, 1000], [5, 7, 40]),
        "k3_empty_lane": _grid(g, [0, 64, 129], [0, 3, 129],
                               one_word=False),
        "k8": _grid(g, [5, 900, 0, 1, 256, 2048, 33, 70],
                    [2, 30, 0, 1, 256, 1, 33, 9]),
        "k8_one_word": _grid(g, [64] * 8, [64] * 8, one_word=True),
    }


def _torch(words, starts):
    return torch.from_numpy(words.view(np.int32)), torch.from_numpy(starts)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_shard_seal_matches_jax(case):
    words, starts, n_seg, n_words = _cases()[case]
    want = shard_seal_np(words, starts, n_seg, n_words)
    np.testing.assert_array_equal(
        shard_seal_jax(words, starts.copy(), n_seg, n_words), want)
    np.testing.assert_array_equal(
        shard_seal_shard_map(words, starts.copy(), n_seg, n_words), want)
    tw, ts = _torch(words, starts)
    for impl in (shard_seal_torch, shard_seal, shard_seal_mesh,
                 factory.get_kernel("shard_seal"),
                 factory.get_kernel("shard_seal", "mesh")):
        got = impl(tw, ts, n_seg, n_words)
        assert got.dtype == torch.int32 and got.shape == starts.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    got = shard_seal_torch(tw, ts, n_seg, n_words).numpy().view(np.uint32)
    for k in range(len(n_seg)):
        assert (got[k, n_seg[k]:] == MIX_SEED).all()
        if n_seg[k]:
            row = batch_seal_torch(tw[k, : n_words[k]],
                                   ts[k, : n_seg[k]]).numpy()
            np.testing.assert_array_equal(got[k, : n_seg[k]],
                                          row.view(np.uint32))


def test_words_past_the_lane_never_fold():
    """What lies after ``n_words[k]`` in a row is not part of the lane
    (the fused fabric pads its grid with zeros, but any bits must do),
    and strided views fold as their contiguous copies."""
    words, starts, n_seg, n_words = _cases()["k3_unequal"]
    want = shard_seal_np(words, starts, n_seg, n_words)
    dirty = words.copy()
    for k, nw in enumerate(n_words):
        dirty[k, nw:] = 0xDEADBEEF
    tw, ts = _torch(dirty, starts)
    np.testing.assert_array_equal(
        shard_seal(tw, ts, n_seg, n_words).numpy().view(np.uint32), want)
    wide = torch.zeros(3, words.shape[1] + 3, dtype=torch.int32)
    wide[:, 3:] = torch.from_numpy(words.view(np.int32))
    got = shard_seal(wide[:, 3:], ts, torch.as_tensor(n_seg),
                     torch.as_tensor(n_words))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_mesh_impl_over_three_cpu_devices():
    """Rows pad to a multiple of the mesh size with empty lanes, each
    device folds a contiguous block, the blocks come back in order."""
    cpu = torch.device("cpu")
    mesh = ShardMesh(SHARD_LANE_AXIS, (cpu, cpu, cpu))
    for case in ("k1", "k3_unequal", "k8", "k8_one_word"):
        words, starts, n_seg, n_words = _cases()[case]
        tw, ts = _torch(words, starts)
        got = shard_seal_mesh(tw, ts, n_seg, n_words, mesh=mesh)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32),
            shard_seal_np(words, starts, n_seg, n_words))
    spec = shard_lane_spec()
    assert spec.axis == "shard"
    assert spec.padded_rows(8, 3) == 9
    assert spec.blocks(8, 3) == [(0, 3), (3, 6), (6, 9)]
    assert spec.blocks(2, 1) == [(0, 2)]


def test_mesh_and_factory_surface():
    assert n_local_devices() == 1          # no card here
    mesh = make_shard_mesh(device="cpu")
    assert mesh.axis == "shard" and mesh.devices == (torch.device("cpu"),)
    assert mesh.size == 1
    assert factory.available_impls("shard_seal") == ("cuda", "mesh",
                                                     "torch")
    words, starts, n_seg, n_words = _cases()["k3_unequal"]
    tw, ts = _torch(words, starts)
    with pytest.raises(ValueError, match="CUDA"):
        shard_seal(tw.to("meta"), ts.to("meta"), n_seg, n_words)
    with pytest.raises(ValueError, match="lane counts"):
        shard_seal(tw, ts, n_seg[:2], n_words)
    with pytest.raises(ValueError, match="grid"):
        shard_seal(tw[0], ts, n_seg, n_words)


def test_account_owner_matches_jax():
    ids = np.concatenate([np.arange(70_000), [2**31 - 1, 2**32 - 1]])
    for k in (1, 2, 3, 8, 64):
        want = jax_account_owner(ids, k)
        np.testing.assert_array_equal(account_owner_np(ids, k), want)
        got = account_owner(torch.from_numpy(ids), k)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            account_owner(torch.from_numpy(ids[:70_000].astype(np.int32)),
                          k).numpy(), want[:70_000])
