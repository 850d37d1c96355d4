"""The CUDA kernels against their plain PyTorch versions, on the card: the
fold kernels bit for bit, the FL kernels (Eq. 1 and Eq. 4, float32
accumulation in another order) at rtol 1e-5 / atol 1e-6 in float32 and
2e-2 in bfloat16.

Marked ``gpu``: they skip where no CUDA device is present (the skip is
decided in the fixture, so every worker collects the same tests).  This
file imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import batch_seal as bs
from repro_torch.kernels import dirty_fold as df
from repro_torch.kernels import model_distance as md
from repro_torch.kernels import rollup_digest as rd
from repro_torch.kernels import weighted_agg as wa

CHUNK = 2048


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(n, seed, device):
    g = np.random.default_rng(seed)
    w = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 3, 5, 128, 10_000, 65_536, 200_003])
def test_rollup_digest_kernel(cuda, n):
    w = _words(n, n, cuda)
    for buf in (w, w[1:]):               # aligned and unaligned starts
        before = rd.rollup_digest.launches
        got = rd.rollup_digest(buf)
        assert rd.rollup_digest.launches == before + (buf.numel() > 0)
        assert int(got) == int(rd.rollup_digest_torch(buf))
    f = torch.randn(4097, device=cuda)
    assert int(rd.rollup_digest(f)) == int(rd.rollup_digest_torch(f))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 100, 2048, 4097, 70_000, 300_001])
def test_chunk_digests_kernel(cuda, n):
    w = _words(n, n, cuda)
    for buf in (w, w[3:]):
        got = rd.rollup_chunk_digests(buf, CHUNK)
        torch.testing.assert_close(got, rd.rollup_chunk_digests_torch(
            buf, CHUNK), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_ids", [(1, 1), (5000, 2), (70_000, 7),
                                     (300_000, 146)])
def test_dirty_fold_kernel(cuda, n, n_ids):
    w = _words(n, n, cuda)
    g = np.random.default_rng(n_ids)
    ids = torch.from_numpy(g.integers(0, -(-n // CHUNK), n_ids)).to(cuda)
    torch.testing.assert_close(df.dirty_fold(w, ids, CHUNK),
                               df.dirty_fold_torch(w, ids, CHUNK),
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_segs", [(4, 1), (4096, 17), (100_000, 257),
                                      (128, 128), (200_000, 2_500)])
def test_batch_seal_kernel(cuda, n, n_segs):
    w = _words(n, n_segs, cuda)
    g = np.random.default_rng(n)
    cuts = np.sort(g.choice(np.arange(1, n), n_segs - 1, replace=False)) \
        if n_segs > 1 else np.empty(0, np.int64)
    starts = torch.from_numpy(np.concatenate([[0], cuts]).astype(
        np.int64)).to(cuda)
    torch.testing.assert_close(bs.batch_seal(w, starts),
                               bs.batch_seal_torch(w, starts),
                               rtol=0, atol=0)


def _fl_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,dtype", [
    (2, 256, torch.float32), (4, 1000, torch.float32),
    (16, 8192, torch.bfloat16), (64, 4096, torch.bfloat16),
    (3, 130, torch.float32), (64, 2410, torch.float32),
    (0, 7, torch.float32), (1, 1, torch.float32), (5, 0, torch.float32)])
def test_fl_kernels(cuda, n, p, dtype):
    g = torch.Generator().manual_seed(n * 1000 + p)
    w = torch.randn(n, p, generator=g).to(cuda, dtype)
    s = (torch.rand(n, generator=g) * 0.95 + 0.05).to(cuda)
    glob = torch.randn(p, generator=g).to(cuda, dtype)
    before = wa.weighted_agg.launches
    got = wa.weighted_agg(w, s)
    assert wa.weighted_agg.launches == before + (p > 0)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), wa.weighted_agg_torch(w, s)
                               .float(), **_fl_tol(dtype))
    for rows, ref in ((w, glob), (w[:, 1:], glob[1:])):   # unaligned rows
        d = md.model_distance(rows, ref)
        torch.testing.assert_close(d, md.model_distance_torch(rows, ref),
                                   **_fl_tol(dtype))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_fl_kernels_zero_scores_and_large_rows(cuda):
    w = torch.stack([torch.ones(256), 100.0 * torch.ones(256)]).to(cuda)
    s = torch.tensor([1.0, 0.0], device=cuda)
    torch.testing.assert_close(wa.weighted_agg(w, s),
                               torch.ones(256, device=cuda))
    torch.testing.assert_close(wa.weighted_agg(w, torch.zeros(2,
                                                              device=cuda)),
                               torch.zeros(256, device=cuda))
    big = torch.randn(8, 1 << 20, device=cuda)
    glob = torch.randn(1 << 20, device=cuda)
    torch.testing.assert_close(md.model_distance(big, glob),
                               md.model_distance_torch(big, glob),
                               rtol=1e-5, atol=1e-6)
