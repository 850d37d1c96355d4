"""The port's two FL ops, plain PyTorch versions on the CPU, against the JAX
package: Eq. 1 ``weighted_agg`` and Eq. 4 ``model_distance``, held against
the Pallas kernels in interpret mode and against the ``kernels/ref.py``
oracles, on the grids of tests/test_kernels.py.  The tolerances are that
file's: rtol 1e-4 / atol 1e-5 in float32 and 2e-2 in bfloat16 (the sums
run in another order).  The CUDA kernels themselves are held against these
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


def test_wrappers_check_shapes_and_factory_routes():
    w = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="weighted_agg takes"):
        twa.weighted_agg(w, torch.zeros(4))
    with pytest.raises(ValueError, match="model_distance takes"):
        tmd.model_distance(w, torch.zeros(3))
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
