"""The CUDA kernels against their plain PyTorch versions, on the card: the
fold kernels and ``block_pack`` bit for bit (``rollup_digest`` on either
side of its ``plan`` split, one launch a call; ``batch_seal`` at its hard
cases -- the whole 16 MB buffer as one segment, one-word segments, power-
law lengths, starts off the 4-word grid, offset views, segment edges on
span edges, 20 segments of a 4M-word buffer -- at every span, one launch a
call; ``dirty_fold`` in both forms on offset views, with repeated and
out-of-range ids, at chunk 128 to 65,537), the FL kernels (Eq. 1 and
Eq. 4, float32 accumulation in another order) at rtol 1e-5 / atol 1e-6 in
float32 and 2e-2 in bfloat16, a task-axis Eq. 1 or Eq. 4 launch row for
row equal to the unbatched launches (Eq. 4 in both its forms, also
bit-equal to ``model_distance_mirror``), Eq. 1 bit-equal to
``weighted_agg_mirror`` at its hard cases (n of 1 to 1,000, P of 1 to 1M,
offset rows, bfloat16), ``rollup_chunk_digests`` in both
forms on offset views with a ragged one-word chunk; the default
``Scheduler`` (fused
loop and megastep) on the card against the stepped per-task path, and
settling its tasks in one ``model_distance`` launch; the attention
kernel against its plain version (rtol 1e-4 / atol 1e-5 in float32; in
bfloat16 one bfloat16 step, rtol 2^-7 / atol 1e-4: both sum in float32 and
round once), and the reduced dense LMs on the card against the CPU; the
MoE's ``gmm`` kernel against its plain version (``gmm.kernel_tol``: rtol
1e-5 float32, one bfloat16 step, plus 1e-5 of the largest output), the
sLSTM scan kernel against its plain version (``slstm_scan.KERNEL_TOL``),
in both forms (the cluster form at dh 64 / 128 / 512 and 1-33 rows, the
grid form also at batches split into launches of ``MAX_BATCH`` rows), and
the reduced MoE and xLSTM LMs on the card against the CPU.  The TMA /
wgmma forms of ``flash_attention`` and ``gmm`` where TMA's edges bite
(tails of a row past a tile, short boxes); a backward through ``gmm`` or
``slstm_scan`` raises; two card runs of the reduced moonshot's MoE FFN are
bit-equal; the object Rollup's digest buffers (4 to 84 words, offset
views) and the default ``AutoDFL()`` agent path on the card against the
CPU; ``shard_seal`` bit for bit at its hard cases (K of 1 to 64 lanes, an
empty lane, one-word segments, a 16 MB lane, power-law lengths, offset
views), one launch a call, equal to one ``batch_seal`` a lane and to its
mesh impl, and the 2-shard fabric's node path on the card against the
CPU (its fused twin in two ``shard_seal`` launches); the node service
(``repro_torch.serve``) on the vector and the 2-shard fabric backends on
the card against the CPU, replayed by ``replay_ops``.

Marked ``gpu``: they skip where no CUDA device is present (the skip is
decided in the fixture, so every worker collects the same tests).  This
file imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import batch_seal as bs
from repro_torch.kernels import block_pack as bp
from repro_torch.kernels import dirty_fold as df
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm as gm
from repro_torch.kernels import model_distance as md
from repro_torch.kernels import rollup_digest as rd
from repro_torch.kernels import slstm_scan as ss
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


def _seal_starts(lengths, first=0):
    return np.concatenate([[first], first + np.cumsum(lengths)[:-1]]).astype(
        np.int64)


def _seal_cases():
    """(name, n words, starts, view offset): the hard inputs of
    ``batch_seal``'s spans and carries."""
    g = np.random.default_rng(19)
    span = bs.MIN_SPAN
    power = []
    while sum(power) < 4_000_000:       # lengths ~ 1 / l from 1 to 10^6
        power.append(int(10 ** g.uniform(0, 6)))
    cases = [("whole 16 MB", 4 << 20, np.zeros(1, np.int64), 0),
             ("4,096 one-word segments", 4096, np.arange(4096), 0),
             ("power law", sum(power), _seal_starts(power), 0),
             ("20 segments of 4M words", 4_001_576,
              np.linspace(0, 4_001_576, 21)[:-1].astype(np.int64), 0),
             ("starts off the 4-word grid", 50_000,
              _seal_starts(g.integers(1, 80, 1000) * 4 + 1, 3), 0)]
    for off in (1, 2, 3):
        cases.append((f"view offset {off}", 200_788,
                      _seal_starts(g.integers(1, 81, 2600)), off))
    for length in (span - 1, span, span + 1, 2 * span, 3 * span + 1):
        k = 12 * bs.MAX_SPAN // length
        cases.append((f"segments of {length} words", k * length,
                      np.arange(k, dtype=np.int64) * length, 0))
    return [(name, n, starts[starts < n], off)
            for name, n, starts, off in cases]


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,starts,off", _seal_cases(),
                         ids=[c[0] for c in _seal_cases()])
def test_batch_seal_hard_cases(cuda, name, n, starts, off):
    """One launch a call, bit-equal to the plain version, at plan's span
    and at every span the kernel takes."""
    w = _words(n + off, n, cuda)[off:]
    st = torch.from_numpy(starts).to(cuda)
    want = bs.batch_seal_torch(w, st)
    before = bs.batch_seal.launches
    torch.testing.assert_close(bs.batch_seal(w, st), want, rtol=0, atol=0)
    assert bs.batch_seal.launches == before + 1
    for span in range(bs.MIN_SPAN, bs.MAX_SPAN + 1, bs.MIN_SPAN):
        got = bs._launch(w, st, bs.plan(n, span))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 2048, 65_536, 65_537])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_dirty_fold_forms(cuda, chunk, off):
    """Both forms on views offset by 0-3 words, repeated ids and ids out of
    range (the seed), bit-equal to the plain version."""
    n = 40 * chunk + 7
    w = _words(n + off, chunk + off, cuda)[off:]
    g = np.random.default_rng(chunk)
    n_chunks = -(-n // chunk)
    ids = torch.from_numpy(np.concatenate([
        g.integers(0, n_chunks, 300), [0, 0, n_chunks - 1]])).to(cuda)
    want = df.dirty_fold_torch(w, ids, chunk)
    before = df.dirty_fold.launches
    torch.testing.assert_close(df.dirty_fold(w, ids, chunk), want, rtol=0,
                               atol=0)
    assert df.dirty_fold.launches == before + 1
    for warps in (1, df.BLOCK_WARPS):
        torch.testing.assert_close(df._launch(w, ids, chunk, warps), want,
                                   rtol=0, atol=0)
    bad = torch.tensor([-1, n_chunks, 1 << 40], device=cuda)
    assert (df.dirty_fold(w, bad, chunk) == rd.SEED_I32).all()
    torch.cuda.synchronize()


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


def _pack_stream(n_txs, n_blocks, seed, gas_limit, device):
    g = np.random.default_rng(seed)
    tmax = np.maximum.accumulate(np.cumsum(g.exponential(0.02, n_txs)))
    gcum = np.cumsum(g.integers(21_000, 120_000, n_txs).astype(np.int64))
    times = np.cumsum(g.uniform(0.05, 1.5, n_blocks))
    n_vis = np.sort(g.integers(0, n_txs + 1, n_blocks)).astype(np.int64)
    return (*(torch.from_numpy(a).to(device)
              for a in (tmax, gcum, times, n_vis)), gas_limit)


@pytest.mark.gpu
@pytest.mark.parametrize("n_txs,n_blocks,seed,gas_limit", [
    (1, 1, 0, 9_000_000), (100, 7, 1, 9_000_000), (1000, 33, 2, 300_000),
    (513, 16, 3, 2**40), (64, 5, 4, 21_000), (0, 4, 5, 9_000_000),
    (60_000, 900, 6, 9_000_000),
    (200_000, 30_000, 7, 400_000),     # more blocks than a walk chunk
    (50_042, 820, 9, 9_000_000),       # the fused run's size: table staged
    (300_000, 820, 8, 9_000_000)])     # a table too large to stage
def test_block_pack_kernel(cuda, n_txs, n_blocks, seed, gas_limit):
    args = _pack_stream(n_txs, n_blocks, seed, gas_limit, cuda)
    want0 = bp.block_pack_torch(*args, 0)
    starts = [0] + ([int(want0[0])] if n_txs else [])
    for ptr0 in starts:
        before = bp.block_pack.launches
        got = bp.block_pack(*args, ptr0)
        assert bp.block_pack.launches == before + 1
        torch.testing.assert_close(got, bp.block_pack_torch(*args, ptr0),
                                   rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("T,n,P", [(1, 4, 1000), (3, 64, 2410),
                                   (32, 64, 2410), (5, 1, 7)])
def test_weighted_agg_task_axis_kernel(cuda, T, n, P):
    """Row t of the (T, n, P) launch is bit-equal to the (n, P) launch on
    task t, and within float32 tolerance of the plain version."""
    g = torch.Generator().manual_seed(T * 100 + n)
    w = torch.randn(T, n, P, generator=g).to(cuda)
    s = (torch.rand(T, n, generator=g) * 0.95 + 0.05).to(cuda)
    before = wa.weighted_agg.launches
    got = wa.weighted_agg(w, s)
    assert wa.weighted_agg.launches == before + 1
    for t in range(T):
        assert torch.equal(got[t], wa.weighted_agg(w[t], s[t]))
    torch.testing.assert_close(got, wa.weighted_agg_torch(w, s),
                               **_fl_tol(torch.float32))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("T,n,P,dtype", [
    (1, 64, 2410, torch.float32), (3, 64, 2411, torch.float32),
    (32, 64, 2410, torch.float32), (3, 5, 7, torch.bfloat16),
    (2, 9, 1, torch.float32), (3, 16, 2410, torch.bfloat16),
    (2, 3, 1 << 20, torch.float32), (3, 2, 100_003, torch.bfloat16),
    (1, 4, 6145, torch.float32)])
def test_model_distance_task_axis_kernel(cuda, T, n, P, dtype):
    """Both forms: row t of the (T, n, P) launch bit-equal to the (n, P)
    launch on task t and to the kernel's arithmetic in plain PyTorch
    (``model_distance_mirror``), on shifted views (rows and g one element
    off their 16-byte alignment) too; within tolerance of the plain
    version."""
    g = torch.Generator().manual_seed(T * 10 + n)
    w = torch.randn(T, n, P + 1, generator=g).to(cuda, dtype)
    glob = torch.randn(T, P + 1, generator=g).to(cuda, dtype)
    for rows, ref in ((w[..., :P], glob[..., :P]), (w[..., 1:], glob[..., 1:])):
        before = md.model_distance.launches
        got = md.model_distance(rows, ref)
        assert md.model_distance.launches == before + 1
        assert md.model_distance.last_form == md.form(P, dtype)
        assert got.shape == (T, n)
        for t in range(T):
            assert torch.equal(got[t], md.model_distance(rows[t], ref[t]))
        assert torch.equal(got.cpu(), md.model_distance_mirror(rows.cpu(),
                                                               ref.cpu()))
        torch.testing.assert_close(got, md.model_distance_torch(rows, ref),
                                   **_fl_tol(dtype))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_model_distance_refuses(cuda):
    w = torch.randn(2, 3, 8, device=cuda)
    with pytest.raises(ValueError, match="model_distance takes"):
        md.model_distance(w, torch.randn(3, 8, device=cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        md.model_distance(w.half(), torch.randn(2, 8, device=cuda).half())
    assert md.cluster_capacity(cuda, 1 << 20, torch.float32) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("n", [rd.SPLIT_WORDS - 1, rd.SPLIT_WORDS + 1,
                               3 * rd.SPLIT_WORDS + 5, 20 * rd.SPLIT_WORDS])
def test_rollup_digest_across_plan(cuda, n):
    """One launch a call on either side of ``plan``'s split, bit-equal to
    the plain version; every cluster count gives the same bits."""
    w = _words(n + 1, n, cuda)
    for buf in (w[:n], w[1:]):
        want = int(rd.rollup_digest_torch(buf))
        before = rd.rollup_digest.launches
        assert int(rd.rollup_digest(buf)) == want
        assert rd.rollup_digest.launches == before + 1
        for clusters in (1, 2, rd.MAX_CLUSTERS):
            assert int(rd._launch(buf, clusters)) == want
    torch.cuda.synchronize()


_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("n,P,off,dtype", [
    # check_fl_kernels' grid, the path shape and 1M wide
    (2, 256, 0, _F32), (4, 1000, 0, _F32), (16, 8192, 0, _BF16),
    (64, 4096, 0, _BF16), (3, 130, 0, _F32), (1, 1, 0, _F32),
    (0, 7, 0, _F32), (64, 2410, 0, _F32), (64, 1 << 20, 0, _F32),
    # n of 1, 7, 9 and 1,000; P of 1, 3 and 2,411; rows 1-3 elements off
    # their alignment; bfloat16 at the path shape
    (1, 2410, 0, _F32), (7, 2410, 0, _F32), (9, 2410, 0, _F32),
    (1000, 2410, 0, _F32), (64, 1, 0, _F32), (64, 3, 0, _F32),
    (64, 2411, 0, _F32), (64, 2410, 1, _F32), (64, 2410, 2, _F32),
    (64, 2410, 3, _F32), (64, 2410, 0, _BF16)])
def test_weighted_agg_matches_mirror(cuda, n, P, off, dtype):
    """The kernel bit-equal to ``weighted_agg_mirror`` and within tolerance
    of the plain version."""
    g = torch.Generator().manual_seed(n * 10 + P + off)
    w = torch.randn(n, P + off, generator=g).to(cuda, dtype)[:, off:]
    s = (torch.rand(n, generator=g) * 0.95 + 0.05).to(cuda)
    want = wa.weighted_agg_mirror(w, s)
    before = wa.weighted_agg.launches
    got = wa.weighted_agg(w, s)
    assert wa.weighted_agg.launches == before + 1
    assert torch.equal(got.cpu(), want)
    torch.testing.assert_close(got.float(), wa.weighted_agg_torch(w, s)
                               .float(), **_fl_tol(dtype))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("T,n,P,dtype", [
    (32, 64, 2410, _F32), (3, 9, 7, _F32), (2, 1000, 33, _F32),
    (4, 64, 2410, _BF16)])
def test_weighted_agg_task_axis_matches_mirror(cuda, T, n, P, dtype):
    """A (T, n, P) launch bit-equal to the mirror, on rows one element off
    their alignment too; row t bit-equal to the launch on task t."""
    g = torch.Generator().manual_seed(T * 100 + n + P)
    w = torch.randn(T, n, P + 1, generator=g).to(cuda, dtype)
    s = (torch.rand(T, n, generator=g) * 0.95 + 0.05).to(cuda)
    for rows in (w[..., :P], w[..., 1:]):
        got = wa.weighted_agg(rows, s)
        assert torch.equal(got.cpu(), wa.weighted_agg_mirror(rows, s))
        for t in range(T):
            assert torch.equal(got[t], wa.weighted_agg(rows[t], s[t]))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n,chunk", [(40 * 128 + 1, 128),
                                     (40 * 2048 + 1, 2048),
                                     (40 * 65_536 + 1, 65_536),
                                     (2_883_584, 2048)])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_chunk_digests_forms(cuda, n, chunk, off):
    """Every chunk on views offset by 0-3 words, a ragged last chunk of one
    word, the node path's shape, chunks of 128 to 65,536 words (the block
    form): one launch, bit-equal to the plain version, in either form."""
    w = _words(n + off, chunk + off, cuda)[off:]
    want = rd.rollup_chunk_digests_torch(w, chunk)
    before = rd.rollup_chunk_digests.launches
    torch.testing.assert_close(rd.rollup_chunk_digests(w, chunk), want,
                               rtol=0, atol=0)
    assert rd.rollup_chunk_digests.launches == before + 1
    for warps in (1, rd.BLOCK_WARPS):
        torch.testing.assert_close(rd._chunk_launch(w, chunk, warps), want,
                                   rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_default_fl_run_settles_in_one_launch(cuda):
    """The default Scheduler at 4 tasks x 16 trainers, every trainer
    good: every task is full and finishes in the last megastep window,
    so Eq. 4 takes ONE model_distance launch (the stepped path: 4)."""
    from repro_torch.api import FLTaskSpec, NodeSpec
    from repro_torch.data.synthetic import gaussian_clusters
    from repro_torch.fl.cohort import CohortKernels, VectorCohort
    from repro_torch.fl.dp import DPConfig
    from repro_torch.fl.scheduler import Scheduler
    from repro_torch.fl.server import AutoDFL
    from repro_torch.models.mlp import TinyMLP
    from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
    x, y = gaussian_clusters(512, 16, 10, seed=1)
    vx, vy = gaussian_clusters(50, 16, 10, seed=2)
    tx, ty = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)

    def bf(sel, rnd):
        i = np.random.default_rng(int(rnd)).integers(0, 512,
                                                     (len(sel), 2, 8))
        i = torch.from_numpy(i).to(cuda)
        return {"x": tx[i], "labels": ty[i]}
    model = TinyMLP(16, 8, 10, device=cuda)
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0))
    kern = CohortKernels(model, opt, DPConfig(noise_multiplier=0.05))

    def run(**knobs):
        node = AutoDFL(model, opt, 16, model.accuracy_fn(),
                       {"x": vx, "labels": vy},
                       spec=NodeSpec(trainer_funds=50.0), device=cuda)
        sch = Scheduler(node, seal_every=2, **knobs)
        for t in range(4):
            sch.add_task(FLTaskSpec(f"t{t}", rounds=2), VectorCohort(
                model, opt, bf, node.store, n_trainers=16, local_steps=2,
                seed=t, kernels=kern, device=cuda))
        before = md.model_distance.launches
        out = sch.run()
        return sch, out, md.model_distance.launches - before

    sd, od, default = run()
    ss, os_, stepped = run(fused=False, megabatch=False)
    assert sd.mega_windows > 0 and (default, stepped) == (1, 4)
    for t in od:
        np.testing.assert_array_equal(od[t].scores, os_[t].scores)
        np.testing.assert_allclose(od[t].reputations, os_[t].reputations,
                                   rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_default_scheduler_on_card_matches_stepped(cuda):
    """Scheduler() on the card takes the fused loop and the megastep
    (one block_pack launch, megastep windows) and gives the stepped
    per-task path's ledger exactly."""
    from repro_torch.api import FLTaskSpec, NodeSpec
    from repro_torch.data.synthetic import gaussian_clusters
    from repro_torch.fl.cohort import CohortKernels, VectorCohort
    from repro_torch.fl.dp import DPConfig
    from repro_torch.fl.scheduler import Scheduler
    from repro_torch.fl.server import AutoDFL
    from repro_torch.models.mlp import TinyMLP
    from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
    x, y = gaussian_clusters(512, 16, 10, seed=1)
    vx, vy = gaussian_clusters(50, 16, 10, seed=2)
    tx, ty = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)

    def bf(sel, rnd):
        i = np.random.default_rng(int(rnd)).integers(0, 512,
                                                     (len(sel), 2, 8))
        i = torch.from_numpy(i).to(cuda)
        return {"x": tx[i], "labels": ty[i]}
    model = TinyMLP(16, 8, 10, device=cuda)
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0))
    kern = CohortKernels(model, opt, DPConfig(noise_multiplier=0.05))

    def run(**knobs):
        node = AutoDFL(model, opt, 8, model.accuracy_fn(),
                       {"x": vx, "labels": vy},
                       spec=NodeSpec(trainer_funds=50.0), device=cuda)
        sch = Scheduler(node, seal_every=2, **knobs)
        for t in range(3):
            sch.add_task(FLTaskSpec(f"t{t}", rounds=2), VectorCohort(
                model, opt, bf, node.store, n_trainers=8, local_steps=2,
                seed=t, kernels=kern, device=cuda))
        out = sch.run()
        return node, sch, out

    packs = bp.block_pack.launches
    nd, sd, od = run()
    assert bp.block_pack.launches == packs + 1 and sd.mega_windows > 0
    ns, ss, os_ = run(fused=False, megabatch=False)
    assert ss.mega_windows == 0
    assert nd.protocol_calls == ns.protocol_calls
    assert nd.rollup.gas_log == ns.rollup.gas_log
    assert nd.chain.blocks == ns.chain.blocks
    assert [e.kind for e in nd.client().events(cursor=0)] == \
        [e.kind for e in ns.client().events(cursor=0)]
    for t in od:
        np.testing.assert_array_equal(od[t].scores, os_[t].scores)
        for k, v in od[t].global_params.items():
            torch.testing.assert_close(v, os_[t].global_params[k],
                                       rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()


def _qkv(B, S, H, Hkv, dh, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, n, dh, generator=g).to(device, dtype)
            for n in (H, Hkv, Hkv)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,dh,dtype", [
    (2, 256, 4, 2, 64, torch.float32), (1, 512, 8, 8, 32, torch.float32),
    (2, 256, 8, 2, 64, torch.bfloat16), (1, 128, 4, 1, 128, torch.float32),
    (2, 7, 4, 2, 16, torch.float32), (1, 4097, 4, 1, 128, torch.bfloat16),
    (2, 33, 4, 1, 80, torch.float32), (1, 200, 8, 2, 80, torch.bfloat16),
    (1, 1, 2, 1, 128, torch.float32), (3, 65, 6, 3, 40, torch.bfloat16)])
def test_flash_attention_kernel(cuda, B, S, H, Hkv, dh, dtype, causal):
    q, k, v = _qkv(B, S, H, Hkv, dh, dtype, S * dh + H, cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), fa.flash_attention_torch(
        q, k, v, causal).float(), **fa.KERNEL_TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_flash_attention_kernel_refuses(cuda):
    q, k, v = _qkv(1, 16, 2, 1, 32, torch.float32, 0, cuda)
    for t in (q, k, v):
        t.requires_grad_()
    out = fa.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="10\\(d\\)"):
        out.sum().backward()
    for dh in (136, 12):
        q, k, v = _qkv(1, 16, 2, 1, dh, torch.float32, 0, cuda)
        with pytest.raises(ValueError, match="head widths"):
            fa.flash_attention(q, k, v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [1, 8])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("B,S", [(2, 1), (2, 65), (2, 127), (1, 4097)])
def test_flash_attention_wgmma_edges(cuda, B, S, dh, hkv, causal):
    """The bfloat16 wgmma form where TMA's edges bite: S of 1, 65, 127
    and 4,097 (one row past a 128-row tile), dh 64 and 128, GQA 8:1 and
    1:1."""
    q, k, v = _qkv(B, S, 8, hkv, dh, torch.bfloat16, S + dh + hkv, cuda)
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.last_form == "wgmma"
    torch.testing.assert_close(got.float(), fa.flash_attention_torch(
        q, k, v, causal).float(), **fa.KERNEL_TOL[torch.bfloat16])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-0.5b", "qwen3-32b"])
def test_dense_lm_on_card_matches_cpu(cuda, arch):
    """Prefill (with the kernel) and decode on the card against the CPU,
    float32, one set of weights: rtol 1e-4 / atol 1e-4 (sums in another
    order, the kernel's exp against torch's)."""
    import dataclasses
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    cpu_model, card_model = build_model(cfg, "cpu"), build_model(cfg, cuda)
    cpu_params = cpu_model.init_params(0)
    card_params = tt.params_from_numpy(cfg, tt.params_to_numpy(cpu_params),
                                       device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    before = fa.flash_attention.launches
    outs = []
    for model, params in ((cpu_model, cpu_params), (card_model, card_params)):
        logits, caches = model.prefill(params, {"tokens": toks})
        state = model.init_decode_state(2, 72)
        for kv in ("k", "v"):
            state["b0"][kv][:, :, :70] = caches["b0"][kv]
        step, state = model.decode(params, state,
                                   {"tokens": toks[:, :1], "pos": 70})
        outs.append([logits, caches["b0"]["k"], caches["b0"]["v"], step,
                     state["b0"]["k"]])
    assert fa.flash_attention.launches == before + cfg.n_layers
    for a, b in zip(*outs):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,d,f,dtype", [
    (8, 96, 64, 200, torch.float32), (4, 128, 128, 512, torch.bfloat16),
    (1, 8, 32, 64, torch.float32), (3, 65, 40, 33, torch.float32),
    (2, 7, 24, 8, torch.bfloat16), (64, 8, 256, 176, torch.bfloat16),
    (5, 300, 130, 70, torch.bfloat16), (2, 1920, 64, 1408, torch.bfloat16),
    (3, 129, 37, 129, torch.float32), (3, 30, 72, 300, torch.bfloat16),
    (2, 33, 64, 128, torch.bfloat16), (2, 32, 1100, 40, torch.float32),
    (1, 1, 7, 5, torch.float32)])
def test_gmm_kernel(cuda, E, C, d, f, dtype):
    g = torch.Generator().manual_seed(E * C + f)
    xe = torch.randn(E, C, d, generator=g).to(cuda, dtype)
    w = torch.randn(E, d, f, generator=g).to(cuda, dtype)
    before = gm.gmm.launches
    got = gm.gmm(xe, w)
    assert gm.gmm.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (E, C, f)
    want = gm.gmm_torch(xe, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **gm.kernel_tol(want))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gmm_kernel_refuses(cuda):
    xe, w = torch.ones(2, 3, 8, device=cuda), torch.ones(2, 8, 4, device=cuda)
    with pytest.raises(TypeError):
        gm.gmm(xe.half(), w.half())
    with pytest.raises(ValueError):
        gm.gmm(xe, w.cpu())
    before = gm.gmm.launches
    assert float(gm.gmm(xe[:, :0], w).sum()) == 0.0
    assert gm.gmm.launches == before
    xe.requires_grad_()
    with pytest.raises(NotImplementedError, match="10\\(d\\)"):
        gm.gmm(xe, w).sum().backward()


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,d,f", [
    (2, 33, 72, 200), (2, 1921, 136, 200), (1, 1921, 64, 264),
    (3, 127, 1104, 200), (4, 8, 1104, 200), (3, 1, 64, 200),
    (2, 32, 520, 264), (64, 1920, 2048, 1408), (64, 8, 1408, 2048)])
def test_gmm_tma_forms(cuda, E, C, d, f):
    """The TMA forms (wgmma above 32 rows, stream up to it) where TMA's
    edges bite: C one row past a 128-row tile, f short of a 256-column
    tile, d short of a 64-deep slice or a 512-row split; and the moonshot
    products."""
    g = torch.Generator().manual_seed(E * C + d + f)
    xe = torch.randn(E, C, d, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(E, d, f, generator=g) * d ** -0.5).to(cuda,
                                                             torch.bfloat16)
    got = gm.gmm(xe, w)
    assert gm.gmm.last_form == ("stream" if C <= gm.SKINNY_C else "wgmma")
    want = gm.gmm_torch(xe, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **gm.kernel_tol(want))
    torch.cuda.synchronize()


def _slstm_inputs(B, S, nh, dh, dtype, device, seed=0, live=True):
    """wx, r_gates and a state: the initial one, or (``live``) the state
    the plain scan reaches after 5 steps of other inputs."""
    g = torch.Generator().manual_seed(seed)
    d = nh * dh
    wx = (0.5 * torch.randn(B, S, 4 * d, generator=g)).to(device, dtype)
    r = (torch.randn(nh, dh, 4 * dh, generator=g) * dh ** -0.5).to(device,
                                                                   dtype)
    state = [torch.zeros(B, d, device=device) for _ in range(3)] + \
        [torch.full((B, d), -1e30, device=device)]
    if live:
        warm = (0.5 * torch.randn(B, 5, 4 * d, generator=g)).to(device, dtype)
        state = list(ss.slstm_scan_torch(warm, r, *state)[1])
    return wx, r, state


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,nh,dh,dtype", [
    (2, 32, 4, 16, torch.float32), (1, 64, 4, 16, torch.float32),
    (3, 16, 4, 16, torch.bfloat16), (2, 1, 4, 16, torch.float32),
    (2, 37, 4, 16, torch.float32), (4, 20, 2, 12, torch.float32),
    (8, 64, 4, 512, torch.bfloat16), (16, 8, 4, 64, torch.float32),
    (5, 300, 8, 32, torch.float32), (8, 1, 4, 512, torch.bfloat16)])
def test_slstm_scan_kernel(cuda, B, S, nh, dh, dtype):
    for live in (False, True):
        wx, r, state = _slstm_inputs(B, S, nh, dh, dtype, cuda, S + dh, live)
        before = ss.slstm_scan.launches
        y, carry = ss.slstm_scan(wx, r, *state)
        assert ss.slstm_scan.launches == before + 1
        want_y, want_carry = ss.slstm_scan_torch(wx, r, *state)
        assert y.dtype == torch.float32 and y.shape == want_y.shape
        torch.testing.assert_close(y, want_y, **ss.KERNEL_TOL)
        for got, want in zip(carry, want_carry):
            torch.testing.assert_close(got, want, **ss.KERNEL_TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 512])
@pytest.mark.parametrize("B,S", [(1, 37), (8, 37), (16, 1), (17, 37),
                                 (33, 5), (1, 4096)])
def test_slstm_scan_cluster_form(cuda, B, S, dh):
    """The cluster form (bfloat16, dh a multiple of 64) against the plain
    version from the initial and a live state: one launch for every row,
    in the form ``form`` names."""
    assert ss.form(torch.bfloat16, B, 4, dh) == "cluster"
    assert ss.cluster_capacity(cuda, B, 4, dh) >= 1
    for live in (False, True):
        wx, r, state = _slstm_inputs(B, S, 4, dh, torch.bfloat16, cuda,
                                     B + S + dh, live)
        before = ss.slstm_scan.launches
        y, carry = ss.slstm_scan(wx, r, *state)
        assert ss.slstm_scan.launches == before + 1
        assert ss.slstm_scan.last_form == "cluster"
        want_y, want_carry = ss.slstm_scan_torch(wx, r, *state)
        torch.testing.assert_close(y, want_y, **ss.KERNEL_TOL)
        for got, want in zip(carry, want_carry):
            torch.testing.assert_close(got, want, **ss.KERNEL_TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_slstm_scan_kernel_refuses(cuda):
    # a batch over MAX_BATCH rows runs in launches of MAX_BATCH rows
    for B in (17, 32):
        wx, r, state = _slstm_inputs(B, 6, 4, 16, torch.float32, cuda)
        before = ss.slstm_scan.launches
        y, carry = ss.slstm_scan(wx, r, *state)
        assert ss.slstm_scan.launches == before + -(-B // ss.MAX_BATCH)
        want_y, want_carry = ss.slstm_scan_torch(wx, r, *state)
        for got, want in zip((y, *carry), (want_y, *want_carry)):
            torch.testing.assert_close(got, want, **ss.KERNEL_TOL)
    wx.requires_grad_()
    with pytest.raises(NotImplementedError, match="10\\(d\\)"):
        ss.slstm_scan(wx, r, *state)[0].sum().backward()
    wx, r, state = _slstm_inputs(16, 2, 1, 1024, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ss.slstm_scan(wx, r, *state)
    wx, r, state = _slstm_inputs(2, 2, 4, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        ss.slstm_scan(wx.half(), r.half(), *state)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,tol", [("moonshot-v1-16b-a3b", 1e-4),
                                      ("kimi-k2-1t-a32b", 1e-4),
                                      ("xlstm-1.3b", 1e-3)])
def test_moe_xlstm_lm_on_card_matches_cpu(cuda, arch, tol):
    """Prefill and decode on the card (through the gmm and slstm_scan
    kernels) against the CPU, float32, one set of weights: the MoE stacks
    at the dense stacks' 1e-4; xLSTM at 1e-3, since its eight
    exponential-gated layers amplify float32 rounding about tenfold over
    the dense stacks (tests/test_torch_xlstm.py)."""
    import dataclasses
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    cpu_model, card_model = build_model(cfg, "cpu"), build_model(cfg, cuda)
    cpu_params = cpu_model.init_params(0)
    card_params = tt.params_from_numpy(cfg, tt.params_to_numpy(cpu_params),
                                       device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    specs = tt.block_specs(cfg) * cfg.n_periods
    n_gmm = 3 * sum(f == "moe" for _, f in specs)
    n_scan = sum(m == "slstm" for m, _ in specs)
    outs = []
    for model, params in ((cpu_model, cpu_params), (card_model, card_params)):
        before = (gm.gmm.launches, ss.slstm_scan.launches)
        logits, caches = model.prefill(params, {"tokens": toks})
        state = model.init_decode_state(2, 72)
        for b, kv in caches.items():
            for name in ("k", "v"):
                state[b][name][:, :, :70] = kv[name]
        step, state = model.decode(params, state,
                                   {"tokens": toks[:, :1], "pos": 70})
        launched = (gm.gmm.launches - before[0],
                    ss.slstm_scan.launches - before[1])
        outs.append([logits, step] + [t for b in sorted(state)
                                      for _, t in sorted(state[b].items())])
    assert launched == (2 * n_gmm, 2 * n_scan)
    for a, b in zip(*outs):
        torch.testing.assert_close(b.cpu(), a, rtol=tol, atol=tol)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_moe_ffn_on_card_is_deterministic(cuda):
    """Two card runs of the reduced moonshot's MoE FFN (bfloat16, prefill
    and decode) on one set of weights and inputs are bit-equal: the
    combine adds in a fixed order."""
    import dataclasses
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(reduced_config(get_config(
        "moonshot-v1-16b-a3b")), dtype="bfloat16")
    g = torch.Generator(device=cuda).manual_seed(6)
    p = moe.init_moe_params(cfg, torch.bfloat16, g, cuda)
    x = torch.randn(4, 512, cfg.d_model, device=cuda, generator=g).to(
        torch.bfloat16)
    assert torch.equal(moe.moe_ffn(cfg, p, x), moe.moe_ffn(cfg, p, x))
    x1 = x[:, :1]
    assert torch.equal(moe.moe_ffn_single(cfg, p, x1),
                       moe.moe_ffn_single(cfg, p, x1))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8, 80, 84])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_rollup_digest_object_batch_sizes(cuda, n, off):
    """The object Rollup's digest buffers (4 words a tx: a one-tx flush
    remainder to a 21-tx batch) on views offset by 0-3 words: one launch,
    bit-equal to the plain version."""
    w = _words(n + 4, 1000 + n, cuda)[off: off + n]
    before = rd.rollup_digest.launches
    got = rd.rollup_digest(w)
    assert rd.rollup_digest.launches == before + 1
    assert int(got) == int(rd.rollup_digest_torch(w))


@pytest.mark.gpu
def test_object_agent_path_on_card_matches_cpu(cuda):
    """The default ``AutoDFL()`` (the object Chain and Rollup) with
    TrainingAgents, two tasks through run_task, on the card and on the
    CPU with the agents' noise drawn on the host: the ledger, selections,
    DON scores and state counters exact, reputations and parameters in
    tolerance; one rollup_digest launch a sealed batch; and no spec equals
    ``spec=NodeSpec.from_legacy()`` on the card, bit for bit."""
    from repro_torch.api import FLTaskSpec, NodeSpec
    from repro_torch.data.synthetic import gaussian_clusters
    from repro_torch.fl import client as fl_client
    from repro_torch.fl.server import AutoDFL
    from repro_torch.models.mlp import TinyMLP
    from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
    x, y = gaussian_clusters(512, 16, 10, seed=1)
    vx, vy = gaussian_clusters(50, 16, 10, seed=2)
    behaviors = ["good", "good", "malicious", "lazy"] * 2

    def host_noise(agent, kind, shapes):
        g = getattr(agent, "_host_generator", None)
        if g is None:
            g = agent._host_generator = torch.Generator().manual_seed(
                agent.seed)
        return {k: torch.randn(shapes[k], generator=g).to(agent.device)
                for k in sorted(shapes)}

    def run(dev, spec=None):
        model = TinyMLP(16, 8, 10, device=dev)
        opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1,
                                           grad_clip=5.0,
                                           moment_dtype="float32"))

        def bf(c, r):
            i = np.random.default_rng(c * 9973 + r).integers(0, 512, 8)
            return {"x": x[i], "labels": y[i]}
        kw = {"spec": spec} if spec is not None else {}
        node = AutoDFL(model, opt, 8, model.accuracy_fn(),
                       {"x": vx, "labels": vy}, device=dev, **kw)
        out = {}
        for t in range(2):
            agents = [fl_client.TrainingAgent(fl_client.ClientConfig(
                f"trainer{i}", b, local_steps=2), model, opt, node.store,
                bf, seed=i, device=dev) for i, b in enumerate(behaviors)]
            out[t] = node.run_task(FLTaskSpec(f"t{t}", rounds=2), agents)
        return node, out

    default_noise = fl_client.agent_noise
    fl_client.agent_noise = host_noise
    try:
        before = rd.rollup_digest.launches
        nc, oc = run(cuda)
        assert rd.rollup_digest.launches - before == len(nc.rollup.batches)
        nl, _ = run(cuda, NodeSpec.from_legacy())
        nh, oh = run(torch.device("cpu"))
    finally:
        fl_client.agent_noise = default_noise
    assert type(nc.rollup).__name__ == "Rollup"
    assert nc.rollup.gas_log == nl.rollup.gas_log
    assert [b.block_hash for b in nc.chain.blocks] == \
        [b.block_hash for b in nl.chain.blocks]
    assert nc.rollup.state_root() == nl.rollup.state_root()
    assert nc.protocol_calls == nh.protocol_calls
    assert nc.rollup.gas_log == nh.rollup.gas_log
    assert [(b.height, len(b.txs), b.gas_used) for b in nc.chain.blocks] == \
        [(b.height, len(b.txs), b.gas_used) for b in nh.chain.blocks]
    fc, fh = nc.rollup.state_arrays.to_numpy(), nh.rollup.state_arrays.to_numpy()
    for k in ("tasks_published", "submissions", "rep_events"):
        np.testing.assert_array_equal(fc[k], fh[k])
    for t in oh:
        assert nc.tsc.tasks[f"t{t}"].trainers == nh.tsc.tasks[f"t{t}"].trainers
        np.testing.assert_array_equal(oc[t].scores, oh[t].scores)
        np.testing.assert_allclose(oc[t].reputations, oh[t].reputations,
                                   rtol=1e-5, atol=1e-6)
        for k, v in oh[t].global_params.items():
            np.testing.assert_allclose(oc[t].global_params[k].cpu().numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()


def _lane_cases():
    """(name, lanes, view offset): shard_seal's hard inputs, each lane a
    (words, starts) pair on the host."""
    g = np.random.default_rng(22)

    def lane(n, n_segs=0, lengths=None, one_word=False):
        w = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        if lengths is not None:
            st = _seal_starts(lengths)
        elif one_word:
            st = np.arange(n, dtype=np.int64)
        elif n_segs:
            st = np.concatenate([[0], np.sort(g.choice(
                np.arange(1, n), n_segs - 1, replace=False))])
        else:
            st = np.zeros(0, np.int64)
        return w, np.asarray(st, np.int64)

    power = []
    while sum(power) < 1_000_000:
        power.append(int(10 ** g.uniform(0, 5)))
    unequal = [lane(int(n), int(s)) for n, s in
               zip(g.integers(1_000, 120_000, 8), g.integers(1, 500, 8))]
    return ([("K=1", [lane(200_000, 2_500)], 0),
             ("K=2 unequal", [lane(9_000, 40), lane(700_000, 9_000)], 0),
             ("K=8 unequal", unequal, 0),
             ("K=64", [lane(int(n), int(s)) for n, s in zip(
                 g.integers(100, 9_000, 64), g.integers(1, 60, 64))], 0),
             ("empty lane", [lane(5_000, 70), lane(0), lane(9_000, 1)], 0),
             ("4,096 one-word segments", [lane(4096, one_word=True)], 0),
             ("16 MB lane, one segment", [lane(4 << 20, 1)], 0),
             ("power law", [lane(sum(power), lengths=power)], 0)]
            + [(f"view offset {off}", unequal[:3], off)
               for off in (1, 2, 3)])


def _lane_grid(lanes, device, off):
    k = len(lanes)
    n_words = np.array([w.size for w, _ in lanes], np.int64)
    n_seg = np.array([len(s) for _, s in lanes], np.int64)
    words = np.zeros((k, max(1, int(n_words.max())) + off), np.uint32)
    starts = np.repeat(n_words[:, None], max(1, int(n_seg.max())), 1)
    for i, (w, st) in enumerate(lanes):
        words[i, off: off + w.size] = w
        starts[i, : len(st)] = st
    return (torch.from_numpy(words.view(np.int32)).to(device)[:, off:],
            torch.from_numpy(starts).to(device),
            torch.from_numpy(n_seg).to(device),
            torch.from_numpy(n_words).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("name,lanes,off", _lane_cases(),
                         ids=[c[0] for c in _lane_cases()])
def test_shard_seal_kernel(cuda, name, lanes, off):
    """One launch a call, bit-equal to the plain version and to one
    batch_seal a lane; padded columns hold the seed; the mesh impl equal
    to the wrapper."""
    from repro_torch.kernels import shard_lanes as sl
    args = _lane_grid(lanes, cuda, off)
    before = sl.shard_seal.launches
    got = sl.shard_seal(*args)
    assert sl.shard_seal.launches == before + 1
    torch.testing.assert_close(got, sl.shard_seal_torch(*args), rtol=0,
                               atol=0)
    words, starts, n_seg, n_words = args
    for k, ns in enumerate(n_seg.tolist()):
        assert (got[k, ns:] == rd.SEED_I32).all()
        if ns:
            torch.testing.assert_close(
                got[k, :ns], bs.batch_seal(words[k, : int(n_words[k])],
                                           starts[k, :ns]), rtol=0, atol=0)
    assert torch.equal(sl.shard_seal_mesh(*args), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_two_shard_fabric_node_card_matches_cpu(cuda):
    """The 2-shard fabric's node path (NodeClient, hash routing, windows
    of submit / seal / run_until, flush) and its fused twin, on the card
    against the CPU: gas log, digests, fabric roots, blocks, receipts and
    the state root, exactly; the fused twin folds its seals in two
    shard_seal launches."""
    from repro_torch.api import NodeClient, NodeSpec, ShardSpec
    from repro_torch.core.fused import FusedWindowLoop
    from repro_torch.core.workloads import make_workload
    from repro_torch.kernels import shard_lanes as sl
    spec = NodeSpec(shards=ShardSpec(count=2))

    def run(dev, fused):
        wl = make_workload("mixed", 2000.0, duration=5.0, seed=3,
                           n_senders=4000, device=dev)
        c = NodeClient.from_spec(spec, device=dev)
        loop = FusedWindowLoop(c.chain, c.target) if fused else None
        times = wl.txs.submit_time.cpu().numpy()
        rcpts = []
        for w in range(5):
            lo, hi = (int(i) for i in np.searchsorted(times, [w, w + 1.0]))
            batch = wl.txs.select(slice(lo, hi))
            if fused:
                loop.submit(c.target, batch)
                loop.seal()
                loop.pump(w + 1.0)
                loop.run_until(w + 1.0)
            else:
                rcpts += c.submit_arrays(batch)
                c.seal()
                c.run_until(w + 1.0)
        (loop or c).flush()
        (loop or c).run_until(60.0)
        if fused:
            loop.execute()
        fab = c.target
        return {"gas_log": fab.gas_log, "digests": fab.batch_digests,
                "update": fab.update_digest,
                "fabric_roots": fab.fabric_roots,
                "blocks": [(b.start, b.stop, b.block_hash)
                           for b in c.chain.blocks],
                "receipts": [vars(c.refresh(r)) for r in rcpts],
                "root": c.state_root()}

    card, cpu = run(cuda, False), run(torch.device("cpu"), False)
    assert card == cpu
    assert {r["status"] for r in card["receipts"]} == {"finalized"}
    before = sl.shard_seal.launches
    fused = run(cuda, True)
    assert sl.shard_seal.launches == before + 2
    assert fused["gas_log"] == cpu["gas_log"]
    assert fused["digests"] == cpu["digests"]
    assert fused["fabric_roots"] == cpu["fabric_roots"]
    torch.cuda.synchronize()


def _serve_script(n=600, duration=6.0, seed=0):
    """Submissions that walk every rung of the admission ladder (as in
    tests/test_torch_serve.py): intrinsic fees, offered fees above and
    below the floor, spam that drops its senders below the trust line."""
    rng = np.random.default_rng(seed)
    fns = np.where(rng.uniform(size=n) < 0.3, "calculateSubjectiveRep",
                   np.where(rng.uniform(size=n) < 0.5, "submitLocalModel",
                            "publishTask"))
    senders = [f"s{k}" for k in rng.integers(0, 40, n)]
    fees = np.where(rng.uniform(size=n) < 0.7, -1,
                    rng.integers(10_000, 120_000, n))
    times = np.sort(rng.uniform(0.0, duration, n))
    return [(str(f), s, None if fee < 0 else int(fee), float(t))
            for f, s, fee, t in zip(fns, senders, fees, times)]


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [None, 2])
def test_node_service_card_matches_cpu(cuda, shards):
    """The node service (repro_torch.serve) on the card against the CPU,
    on the vector and the 2-shard fabric backends: replies, admission log,
    op log, receipts, events, state root and L1 gas, exactly; replay_ops
    on the card reaches the served root; the service seals through
    batch_seal (each shard stepped), never shard_seal."""
    import asyncio
    from repro_torch.api import AdmissionSpec, NodeSpec, ServeSpec, ShardSpec
    from repro_torch.kernels import shard_lanes as sl
    from repro_torch.serve import NodeService, replay_ops
    node = NodeSpec(shards=None if shards is None else
                    ShardSpec(count=shards, fabric=True))
    spec = ServeSpec(node=node, window=0.5, admission=AdmissionSpec(
        rate_limit=4.0, burst=3.0, fee_floor=20_000, pool_cap=24))
    script = _serve_script()

    def run(dev):
        async def go():
            svc = await NodeService(spec, device=dev).start()

            async def one(part):
                return [await svc.submit(fn, s, fee=fee, at=at)
                        for fn, s, fee, at in part]
            replies = await asyncio.gather(*(one(script[i::4])
                                             for i in range(4)))
            await svc.close()
            return svc, replies
        svc, replies = asyncio.run(go())
        return svc, {
            "replies": replies, "log": svc.admission.log, "ops": svc.ops,
            "receipts": [svc.receipt(r) for r in sorted(svc.receipts)],
            "events": svc.events(cursor=0), "stats": svc.stats(),
            "root": svc.state_root(), "gas": svc.client.chain.total_gas}

    seals, shard_seals = bs.batch_seal.launches, sl.shard_seal.launches
    svc, card = run(cuda)
    assert bs.batch_seal.launches > seals
    assert sl.shard_seal.launches == shard_seals
    _, cpu = run(torch.device("cpu"))
    assert card == cpu
    assert card["stats"]["evicted"] > 0
    serial = replay_ops(node, svc.ops, device=cuda)
    assert serial.state_root() == card["root"]
    assert serial.chain.total_gas == card["gas"]
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["stepped", "fused"])
def test_sanitized_node_run_on_card(cuda, fused, monkeypatch):
    """REPRO_SANITIZE=1 through build_stack on the card, the node path
    stepped and through the fused loop: silent with checks made, the gas
    log, blocks, digests and WindowSettled roots equal to the unsanitized
    run, and the R001 refold launching rollup_chunk_digests on the card
    at every WindowSettled; then one injected R001 violation (a column
    write on the card that skips mark_dirty) raises."""
    from repro_torch.analysis.sanitize import ENV_FLAG, SanitizeViolation
    from repro_torch.api import NodeClient, NodeSpec
    from repro_torch.core.fused import FusedWindowLoop
    from repro_torch.core.workloads import make_workload
    wl = make_workload("mixed", 2000.0, duration=5.0, seed=3,
                       n_senders=4000, device=cuda)
    times = wl.txs.submit_time.cpu().numpy()

    def run(flag):
        monkeypatch.setenv(ENV_FLAG, flag)
        rd.rollup_chunk_digests.launches = 0
        c = NodeClient.from_spec(NodeSpec(), device=cuda)
        loop = FusedWindowLoop(c.chain, c.target) if fused else None
        for w in range(5):
            lo, hi = (int(i) for i in np.searchsorted(times, [w, w + 1.0]))
            batch = wl.txs.select(slice(lo, hi))
            if fused:
                loop.submit(c.target, batch)
                loop.seal()
                loop.pump(w + 1.0)
                loop.run_until(w + 1.0)
            else:
                c.submit_arrays(batch)
                c.seal()
                c.run_until(w + 1.0)
        (loop or c).flush()
        (loop or c).run_until(60.0)
        if fused:
            loop.execute()
        torch.cuda.synchronize()
        ru = c.target
        return c, rd.rollup_chunk_digests.launches, {
            "gas_log": ru.gas_log, "digests": ru.batch_digests,
            "blocks": [(b.start, b.stop, b.block_hash)
                       for b in c.chain.blocks],
            "settled": [e.state_root for e in c.events(
                kinds={"window_settled"})],
            "root": c.state_root()}

    _, plain_launches, plain = run("0")
    c, launches, sanitized = run("1")
    san = c.chain.events._sanitizer
    assert san.n_checks > 0
    assert sanitized == plain
    assert launches - plain_launches >= len(sanitized["settled"]) > 0
    assert c.target.state_arrays.balances.device.type == "cuda"
    c.target.state_arrays.balances[0] += 7.0
    c.submit("bgPing", "s0")
    with pytest.raises(SanitizeViolation) as exc:
        c.seal()
    assert exc.value.rule == "R001"
