"""The port's two FL ops, plain PyTorch versions on the CPU, against the JAX
package: Eq. 1 ``weighted_agg`` and Eq. 4 ``model_distance`` (also with
its task axis, task by task), held against the Pallas kernels in
interpret mode and against the ``kernels/ref.py`` oracles, on the grids
of tests/test_kernels.py; ``model_distance``'s form choice and its mirror
of the kernel's summation order; ``weighted_agg``'s mirror of its kernel's
order against a numpy emulation, and the grid its tile gives.  The
tolerances are that file's: rtol 1e-4 / atol 1e-5 in float32 and 2e-2 in
bfloat16 (the sums run in another order).  The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.aggregation import tree_flat as jax_tree_flat
from repro.core.aggregation import weighted_average_tree_jit
from repro.kernels import ref
from repro.kernels.model_distance import model_distance as jax_distance
from repro.kernels.weighted_agg import weighted_agg as jax_agg
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import factory
from repro_torch.kernels import model_distance as tmd
from repro_torch.kernels import weighted_agg as twa

torch.set_num_threads(1)

F32, BF16 = "float32", "bfloat16"


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == BF16 \
        else dict(rtol=1e-4, atol=1e-5)


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of dtype ``dt``
    (bfloat16 rounded once, on the numpy side)."""
    if dt == BF16:
        a = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(a), torch.from_numpy(
            a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("n,P,dt,block", [
    (2, 256, F32, 128),
    (4, 1000, F32, 512),       # padded tail on the TPU side
    (16, 8192, BF16, 2048),
    (64, 4096, BF16, 4096),
    (3, 130, F32, 512),        # P < block
    (64, 2410, F32, 4096),     # the FL path's shape
])
def test_weighted_agg_matches_pallas_and_ref(n, P, dt, block):
    rng = np.random.default_rng(n * 7 + P)
    wj, wt = _pair(rng.normal(size=(n, P)), dt)
    s = rng.uniform(0.05, 1.0, n).astype(np.float32)
    got = twa.weighted_agg_torch(wt, torch.from_numpy(s))
    assert got.dtype == wt.dtype and got.shape == (P,)
    pallas = jax_agg(wj, jnp.asarray(s), block_p=block, interpret=True)
    oracle = ref.weighted_agg_ref(wj, jnp.asarray(s))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dt))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dt))
    # the wrapper takes the plain version for a CPU tensor, and counts
    # no launch
    before = twa.weighted_agg.launches
    torch.testing.assert_close(twa.weighted_agg(wt, torch.from_numpy(s)),
                               got, rtol=0, atol=0)
    assert twa.weighted_agg.launches == before


def test_weighted_agg_zero_score_trainer_excluded():
    w = np.stack([np.ones(256), 100.0 * np.ones(256)]).astype(np.float32)
    s = np.array([1.0, 0.0], np.float32)
    got = twa.weighted_agg_torch(torch.from_numpy(w), torch.from_numpy(s))
    pallas = jax_agg(jnp.asarray(w), jnp.asarray(s), block_p=128,
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.ones(256), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-6)


@pytest.mark.parametrize("n,P", [(0, 7), (1, 1), (1, 300), (5, 0)])
def test_weighted_agg_empty_and_one_row(n, P):
    rng = np.random.default_rng(P)
    w = rng.normal(size=(n, P)).astype(np.float32)
    s = rng.uniform(0.1, 1.0, n).astype(np.float32)
    got = twa.weighted_agg_torch(torch.from_numpy(w), torch.from_numpy(s))
    want = ref.weighted_agg_ref(jnp.asarray(w), jnp.asarray(s))
    assert got.shape == (P,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(F32))


@pytest.mark.parametrize("n,P,dt", [
    (4, 1000, F32),
    (8, 5000, BF16),
    (1, 128, F32),
    (64, 2410, F32),           # the FL path's shape
])
def test_model_distance_matches_pallas_and_ref(n, P, dt):
    rng = np.random.default_rng(n + P)
    lj, lt = _pair(rng.normal(size=(n, P)), dt)
    gj, gt = _pair(rng.normal(size=(P,)), dt)
    got = tmd.model_distance_torch(lt, gt)
    assert got.dtype == torch.float32 and got.shape == (n,)
    pallas = jax_distance(lj, gj, block_p=512, interpret=True)
    oracle = ref.model_distance_ref(lj, gj)
    np.testing.assert_allclose(got.numpy(), _np(pallas), **_tol(dt))
    np.testing.assert_allclose(got.numpy(), _np(oracle), **_tol(dt))
    before = tmd.model_distance.launches
    torch.testing.assert_close(tmd.model_distance(lt, gt), got, rtol=0,
                               atol=0)
    assert tmd.model_distance.launches == before


@pytest.mark.parametrize("n,P", [(0, 9), (1, 1), (1, 513), (3, 0)])
def test_model_distance_empty_and_one_row(n, P):
    rng = np.random.default_rng(n * 3 + P)
    loc = rng.normal(size=(n, P)).astype(np.float32)
    glob = rng.normal(size=(P,)).astype(np.float32)
    got = tmd.model_distance_torch(torch.from_numpy(loc),
                                   torch.from_numpy(glob))
    want = ref.model_distance_ref(jnp.asarray(loc), jnp.asarray(glob))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(F32))


@pytest.mark.parametrize("T,n,P,dt", [
    (3, 4, 1000, F32), (2, 8, 5000, BF16), (32, 64, 2410, F32),
    (1, 5, 7, F32), (3, 2, 2411, BF16)])
def test_model_distance_task_axis_matches_pallas_per_task(T, n, P, dt):
    """(T, n, P) against (T, P) -> (T, n): row t equals the JAX kernel on
    task t (interpret mode) within the file's tolerance, and the unbatched
    plain call on task t bit for bit."""
    rng = np.random.default_rng(T * 1000 + P)
    lj, lt = _pair(rng.normal(size=(T, n, P)), dt)
    gj, gt = _pair(rng.normal(size=(T, P)), dt)
    got = tmd.model_distance_torch(lt, gt)
    assert got.dtype == torch.float32 and got.shape == (T, n)
    torch.testing.assert_close(tmd.model_distance(lt, gt), got, rtol=0,
                               atol=0)
    for t in range(T):
        pallas = jax_distance(lj[t], gj[t], block_p=512, interpret=True)
        np.testing.assert_allclose(got[t].numpy(), _np(pallas), **_tol(dt))
        assert torch.equal(got[t], tmd.model_distance_torch(lt[t], gt[t]))


@pytest.mark.parametrize("P,dt,want", [
    (0, F32, "row"), (1, F32, "row"), (2410, F32, "row"),
    (2411, BF16, "row"), (6144, F32, "row"), (6145, F32, "cluster"),
    (12_288, BF16, "row"), (12_289, BF16, "cluster"),
    (1 << 20, F32, "cluster"), (1 << 20, BF16, "cluster")])
def test_model_distance_form(P, dt, want):
    """The form follows the row's bytes alone (24,576 a row: the row
    form); the cluster form's blocks cover the row in whole chunks."""
    dtype = torch.bfloat16 if dt == BF16 else torch.float32
    assert tmd.form(P, dtype) == want
    if want == "cluster":
        blocks, span = tmd.cluster_span(P, dtype)
        chunk = tmd.CHUNK_BYTES // (2 if dt == BF16 else 4)
        assert 2 <= blocks <= tmd.MAX_CLUSTER and span % chunk == 0
        assert (blocks - 1) * span < P <= blocks * span


def _emulate(row: np.ndarray, glob: np.ndarray, lanes: int) -> np.float32:
    """The index-fixed order written out in numpy scalars: lane j adds
    (l_k - g_k)^2 for k = j (mod lanes) in increasing k, then the halving
    tree; one lane group's sum, before the square root."""
    acc = [np.float32(0)] * lanes
    for k in range(row.size):
        d = np.float32(row[k] - glob[k])
        acc[k % lanes] = np.float32(acc[k % lanes] + np.float32(d * d))
    v = np.array(acc, np.float32)
    while v.size > 1:
        v = (v[: v.size // 2] + v[v.size // 2:]).astype(np.float32)
    return v[0]


@pytest.mark.parametrize("P,dt", [(7, F32), (300, F32), (2410, F32),
                                  (2411, BF16), (9000, F32),
                                  (40_000, BF16)])
def test_model_distance_mirror_order(P, dt):
    """The kernel's mirror: the row form's strided lane sums and shuffle
    tree, or the cluster form's blocks (256 lanes, then 8 warps) added in
    rank order, as numpy scalars spell them; within float32 tolerance of
    the plain version; bit-equal for a row at any offset, batched or not."""
    rng = np.random.default_rng(P)
    _, lt = _pair(rng.normal(size=(3, 2, P + 1)), dt)
    _, gt = _pair(rng.normal(size=(3, P + 1)), dt)
    dtype = lt.dtype
    got = tmd.model_distance_mirror(lt[..., 1:], gt[..., 1:])
    row, glob = _np(lt[1, 0, 1:]), _np(gt[1, 1:])
    if tmd.form(P, dtype) == "row":
        want = _emulate(row, glob, tmd.ROW_LANES)
    else:
        blocks, span = tmd.cluster_span(P, dtype)
        want = np.float32(0)
        for r in range(blocks):
            part = _emulate(row[r * span:(r + 1) * span],
                            glob[r * span:(r + 1) * span], tmd.CLUSTER_LANES)
            want = part if r == 0 else np.float32(want + part)
    assert float(got[1, 0]) == float(np.float32(np.sqrt(np.float64(want))))
    torch.testing.assert_close(got, tmd.model_distance_torch(
        lt[..., 1:], gt[..., 1:]), rtol=1e-5, atol=1e-6)
    # the same rows copied to another offset, and one task alone
    moved = tmd.model_distance_mirror(lt[..., 1:].contiguous(),
                                      gt[..., 1:].contiguous())
    assert torch.equal(moved, got)
    assert torch.equal(tmd.model_distance_mirror(lt[2, :, 1:], gt[2, 1:]),
                       got[2])


def _emulate_agg(w: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Eq. 1 in the kernel's order, written out in numpy float32: rows in
    ``ROW_GROUPS`` groups of ceil(n / groups), each group summed from 0 in
    increasing row (a product and a sum rounded apiece), the group sums
    added in group order from 0; the score sum as 32 lane sums (lane j:
    s[j], s[j + 32], ...) and the halving tree, floored at 1e-12; one
    division."""
    n, P = w.shape
    size = -(-n // twa.ROW_GROUPS)
    total = np.zeros(P, np.float32)
    for r in range(twa.ROW_GROUPS):
        acc = np.zeros(P, np.float32)
        for i in range(r * size, min(n, (r + 1) * size)):
            acc = (acc + (np.float32(s[i]) * w[i]).astype(np.float32)
                   ).astype(np.float32)
        total = (total + acc).astype(np.float32)
    lanes = [np.float32(0)] * 32
    for i in range(n):
        lanes[i % 32] = np.float32(lanes[i % 32] + np.float32(s[i]))
    v = np.array(lanes, np.float32)
    while v.size > 1:
        v = (v[: v.size // 2] + v[v.size // 2:]).astype(np.float32)
    denom = np.maximum(v[0], np.float32(1e-12))
    return (total / denom).astype(np.float32)


@pytest.mark.parametrize("n,P,dt", [
    (1, 1, F32), (7, 3, F32), (9, 300, F32), (3, 130, F32),
    (64, 2410, F32),           # the FL path's shape
    (1000, 5, F32), (64, 2411, F32), (64, 2410, BF16), (16, 257, BF16)])
def test_weighted_agg_mirror_order(n, P, dt):
    """The kernel's mirror bit-equal to the order written out in numpy
    scalars (in bfloat16: float32 arithmetic, rounded once to bfloat16),
    and within tolerance (float32 rtol 1e-5 / atol 1e-6, bfloat16 2e-2) of
    the plain version and of the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n * 31 + P)
    wj, wt = _pair(rng.normal(size=(n, P)), dt)
    s = rng.uniform(0.05, 1.0, n).astype(np.float32)
    got = twa.weighted_agg_mirror(wt, torch.from_numpy(s))
    assert got.dtype == wt.dtype and got.shape == (P,)
    want = _emulate_agg(_np(wt), s)
    if dt == BF16:
        want = want.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(_np(got), want)
    tol = dict(rtol=2e-2, atol=2e-2) if dt == BF16 \
        else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(got), _np(twa.weighted_agg_torch(wt, torch.from_numpy(s))), **tol)
    pallas = jax_agg(wj, jnp.asarray(s), block_p=512, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)


@pytest.mark.parametrize("T,n,P,dt", [
    (3, 64, 2410, F32), (4, 9, 7, F32), (2, 1000, 3, F32),
    (3, 0, 5, F32), (2, 16, 300, BF16)])
def test_weighted_agg_mirror_task_axis_and_offsets(T, n, P, dt):
    """Row t of a (T, n, P) mirror bit-equal to the (n, P) mirror of task
    t; rows one element off their alignment equal the same rows moved in
    place: the order depends on n alone."""
    rng = np.random.default_rng(T * 1000 + n + P)
    _, wt = _pair(rng.normal(size=(T, n, P + 1)), dt)
    s = torch.from_numpy(rng.uniform(0.05, 1.0, (T, n)).astype(np.float32))
    for rows in (wt[..., :P], wt[..., 1:]):
        got = twa.weighted_agg_mirror(rows, s)
        assert got.shape == (T, P) and got.dtype == wt.dtype
        for t in range(T):
            assert torch.equal(got[t], twa.weighted_agg_mirror(rows[t], s[t]))
        assert torch.equal(twa.weighted_agg_mirror(rows.contiguous(), s), got)
    if n == 0:
        assert not twa.weighted_agg_mirror(wt, s).float().any()


@pytest.mark.parametrize("T,P,dt,blocks", [
    (32, 2410, F32, 608),      # the default FL path's task-axis launch
    (1, 2410, F32, 19),        # the stepped path's
    (1, 1 << 20, F32, 8192),   # 1M wide
    (1, 2410, BF16, 10), (3, 1, F32, 3)])
def test_weighted_agg_tile(T, P, dt, blocks):
    """The kernel's tile: 512 bytes of a row a block, a whole number of
    warps' columns, and the grid it gives at the paths' shapes."""
    dtype = torch.bfloat16 if dt == BF16 else torch.float32
    cols = twa.tile(dtype)
    assert cols * torch.empty((), dtype=dtype).element_size() \
        == twa.TILE_BYTES == 512
    assert cols % 32 == 0
    assert T * -(-P // cols) == blocks


def test_wrappers_check_shapes_and_factory_routes():
    w = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="weighted_agg takes"):
        twa.weighted_agg(w, torch.zeros(4))
    with pytest.raises(ValueError, match="model_distance takes"):
        tmd.model_distance(w, torch.zeros(3))
    for bad in ((torch.zeros(2, 3, 4), torch.zeros(4)),
                (torch.zeros(2, 3, 4), torch.zeros(3, 4)),
                (torch.zeros(4), torch.zeros(4)),
                (torch.zeros(1, 2, 3, 4), torch.zeros(1, 2, 4))):
        with pytest.raises(ValueError, match="model_distance takes"):
            tmd.model_distance(*bad)
    for op, plain, wrapper in (
            ("weighted_agg", twa.weighted_agg_torch, twa.weighted_agg),
            ("model_distance", tmd.model_distance_torch,
             tmd.model_distance)):
        assert factory.available_impls(op) == ("cuda", "torch")
        assert factory.get_kernel(op) is wrapper
        assert factory.get_kernel(op, "torch") is plain


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,dt", [(4, F32), (7, BF16), (64, F32)])
def test_flattened_tree_eq1_matches_per_leaf_jax(n, dt, use_pallas):
    """One (n, P) launch over the flattened tree == the JAX package's
    per-leaf Eq. 1, with its Pallas kernel and without."""
    rng = np.random.default_rng(n)
    shapes = {"w1": (32, 16), "b1": (16,), "w2": (16, 10), "b2": (10,)}
    tree_j, tree_t = {}, {}
    for k, shape in shapes.items():
        tree_j[k], tree_t[k] = _pair(rng.normal(size=(n, *shape)), dt)
    s = rng.uniform(0.05, 1.0, n).astype(np.float32)
    got = tagg.weighted_average_tree(tree_t, torch.from_numpy(s))
    want = weighted_average_tree_jit(tree_j, jnp.asarray(s),
                                     use_pallas=use_pallas)
    assert sorted(got) == sorted(want)
    for k in shapes:
        assert got[k].dtype == tree_t[k].dtype
        assert tuple(got[k].shape) == shapes[k]
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **_tol(dt))
    assert tagg.weighted_average_tree_jit is tagg.weighted_average_tree
    flat = tagg.tree_flat_stacked(tree_t)
    assert flat.shape == (n, 32 * 16 + 16 + 16 * 10 + 10)
    assert flat.dtype == torch.float32
    # tree_flat takes the leaves in the JAX package's (sorted) order
    one = {k: v[0] for k, v in tree_t.items()}
    np.testing.assert_array_equal(
        tagg.tree_flat(one).numpy(),
        np.asarray(jax_tree_flat(jax.tree.map(lambda v: v[0], tree_j)),
                   np.float32))
