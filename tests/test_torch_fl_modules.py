"""The FL modules of the port on the CPU against the JAX package's, on the
same inputs made from a numpy seed: TinyMLP, sgdm, DP, Eq. 4 distances,
the Eq. 2-10 reputation update, the DON quorum, the task contract, the
blob store and the data generator.

Floats are held at rtol 1e-5 / atol 1e-6 (float32 sums taken in another
order); integers, selections and the numpy quorum exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reputation as jrep
from repro.core.escrow import Escrow as JaxEscrow
from repro.core.ledger import AccessControl as JaxACL
from repro.core.oracle import DONConfig as JaxDON
from repro.core.oracle import evaluate_quorum as jax_quorum
from repro.core.oracle import quorum_from_table as jax_quorum_table
from repro.core.storage import BlobStore as JaxStore
from repro.core.tasks import TaskContract as JaxTSC
from repro.data.synthetic import gaussian_clusters as jax_clusters
from repro.fl import dp as jdp
from repro.models.mlp import TinyMLP as JaxMLP
from repro.optim.optimizers import OptimizerSpec as JaxOptSpec
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro_torch.core import reputation as trep
from repro_torch.core.escrow import Escrow
from repro_torch.core.ledger import AccessControl
from repro_torch.core.oracle import (DONConfig, ValidationSlices,
                                     evaluate_quorum, quorum_from_table)
from repro_torch.core.storage import BlobStore
from repro_torch.core.tasks import TaskContract
from repro_torch.data.synthetic import gaussian_clusters
from repro_torch.fl import dp as tdp
from repro_torch.models.mlp import TinyMLP, params_from_numpy, \
    params_to_numpy
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
D_IN, D_H, N_CLS = 32, 16, 10


def _host(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close(got, want, **kw):
    got = {k: v.detach().numpy() for k, v in got.items()} \
        if isinstance(got, dict) else got.detach().numpy()
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       **(kw or TOL))
    else:
        np.testing.assert_allclose(got, np.asarray(want), **(kw or TOL))


@pytest.fixture(scope="module")
def mlp_pair():
    jm = JaxMLP(D_IN, D_H, N_CLS)
    tm = TinyMLP(D_IN, D_H, N_CLS, device="cpu")
    x, y = gaussian_clusters(64, D_IN, N_CLS, seed=5, noise=0.5)
    return jm, tm, x, y


def test_gaussian_clusters_same_streams():
    for kw in (dict(n=300, d=32, n_classes=10, seed=1, noise=0.5),
               dict(n=250, d=64, n_classes=10, seed=2)):
        xt, yt = gaussian_clusters(**kw)
        xj, yj = jax_clusters(**kw)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
        assert xt.dtype == np.float32 and yt.dtype == np.int32


def test_tiny_mlp_loss_grads_accuracy(mlp_pair):
    jm, tm, x, y = mlp_pair
    for seed in (0, 3):
        pj = jm.init_params(jax.random.key(seed))
        pt_ = params_from_numpy(_host(pj), "cpu")
        assert sorted(pt_) == ["b1", "b2", "w1", "w2"]
        assert tuple(pt_["w1"].shape) == (D_IN, D_H)
        _close(pt_, pj, rtol=0, atol=0)
        bj = {"x": jnp.asarray(x), "labels": jnp.asarray(y)}
        bt = {"x": torch.from_numpy(x), "labels": torch.from_numpy(y)}
        lj, gj = jax.value_and_grad(jm.loss)(pj, bj)
        gt, lt = torch.func.grad_and_value(tm.loss)(pt_, bt)
        _close(lt, lj)
        _close(gt, gj)
        _close(tm.logits(pt_, bt), jm.logits(pj, bj))
        # argmax ties break the same way; the mean rounds as JAX's does
        assert float(tm.accuracy_fn()(pt_, bt)) == \
            float(jm.accuracy_fn()(pj, bj))
        back = params_to_numpy(pt_)
        assert list(back) == sorted(back)
        for k in back:
            np.testing.assert_array_equal(back[k], np.asarray(pj[k]))
    # the port's own init: He-scaled w1, zero biases, from the seed alone
    a, b = tm.init_params(7), tm.init_params(7)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert float(a["b1"].abs().sum()) == 0.0
    assert abs(float(a["w1"].std()) - (2.0 / D_IN) ** 0.5) < 0.05


@pytest.mark.parametrize("grad_clip", [5.0, 0.05])
def test_sgdm_update_with_clipping(mlp_pair, grad_clip):
    """Two sgdm steps (bfloat16 momentum, the JAX default) with the
    global-norm clip active (0.05) and not (5.0)."""
    jm, tm, x, y = mlp_pair
    jo = jax_optimizer(JaxOptSpec(name="sgdm", lr=0.1, grad_clip=grad_clip))
    to = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1,
                                      grad_clip=grad_clip))
    pj = jm.init_params(jax.random.key(1))
    pt_ = params_from_numpy(_host(pj), "cpu")
    sj, st = jo.init(pj), to.init(pt_)
    assert st["m"]["w1"].dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in _host(pj).items()}
        pj, sj, gnj = jo.update(jax.tree.map(jnp.asarray, grads), sj, pj)
        pt_, st, gnt = to.update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, st, pt_)
        _close(gnt, gnj)
        _close(pt_, pj)
        _close({k: v.float() for k, v in st["m"].items()},
               {k: np.asarray(v, np.float32) for k, v in sj["m"].items()})
    assert int(st["step"]) == int(sj["step"]) == 2
    # adamw (queue 1 item 10(d)) on the same tree and gradients: one step,
    # within float32 noise plus lr * 2^-7 (its bfloat16 moments)
    jo = jax_optimizer(JaxOptSpec(name="adamw", lr=0.1, grad_clip=grad_clip))
    to = make_optimizer(OptimizerSpec(name="adamw", lr=0.1,
                                      grad_clip=grad_clip))
    pj, sj, gnj = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(pj),
                            pj)
    pt_, st, gnt = to.update({k: torch.from_numpy(v)
                              for k, v in grads.items()}, to.init(pt_), pt_)
    _close(gnt, gnj)
    for k, v in pt_.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(pj[k]), rtol=1e-5,
                                   atol=0.1 * 2 ** -7)
    assert st["v"]["w1"].dtype == torch.bfloat16 and int(st["step"]) == 1


def _update_tree(rng, scale):
    shapes = {"w1": (D_IN, D_H), "b1": (D_H,), "w2": (D_H, N_CLS),
              "b2": (N_CLS,)}
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("scale", [0.001, 0.5])
def test_clip_update_and_privatize_with_injected_noise(scale):
    """The JAX package draws its noise inside ``add_noise`` (one key per
    leaf in sorted order); the port takes standard normals as an argument.
    Feed the port the JAX draws and the results agree."""
    rng = np.random.default_rng(int(scale * 1000))
    upd = _update_tree(rng, scale)
    cfg_j = jdp.DPConfig(noise_multiplier=0.05)
    cfg_t = tdp.DPConfig(noise_multiplier=0.05)
    ut = {k: torch.from_numpy(v) for k, v in upd.items()}
    cj, nj = jdp.clip_update(jax.tree.map(jnp.asarray, upd), 1.0)
    ct, nt = tdp.clip_update(ut, 1.0)
    _close(nt, nj)
    _close(ct, cj)
    key = jax.random.key(11)
    pj, _ = jdp.privatize(key, jax.tree.map(jnp.asarray, upd), cfg_j)
    names = sorted(upd)
    keys = jax.random.split(key, len(names))
    noise = {k: torch.from_numpy(np.array(
        jax.random.normal(kk, upd[k].shape, jnp.float32)))
        for k, kk in zip(names, keys)}
    pt_, norm = tdp.privatize(ut, noise, cfg_t)
    _close(norm, nj)
    _close(pt_, pj)
    off = tdp.privatize(ut, noise, tdp.DPConfig(enabled=False))[0]
    _close(off, ct)


def test_model_distances_through_the_factory():
    rng = np.random.default_rng(2)
    local = rng.normal(size=(6, 2410)).astype(np.float32)
    glob = rng.normal(size=2410).astype(np.float32)
    got = trep.model_distances(torch.from_numpy(local),
                               torch.from_numpy(glob))
    _close(got, jrep.model_distances(jnp.asarray(local), jnp.asarray(glob)))


def _book_pair(rng, n):
    jb = jrep.init_book(n)
    # one earlier task for half of the trainers, so the histories differ
    part = (np.arange(n) % 2).astype(np.float32)
    jb, _ = jrep.end_of_task_update(
        jb, jnp.asarray(rng.uniform(0.2, 0.9, n), jnp.float32),
        jnp.full(n, 2.0), jnp.full(n, 3.0),
        jnp.asarray(rng.uniform(0.1, 2.0, n), jnp.float32),
        jnp.asarray(part))
    fields = {f.name: np.asarray(getattr(jb, f.name))
              for f in dataclasses.fields(jrep.TrainerBook)}
    return jb, trep.TrainerBook.from_numpy(fields, device="cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_end_of_multitask_update_eq2_to_10(k):
    rng = np.random.default_rng(k)
    n = 8
    jb, tb = _book_pair(rng, n)
    args = [rng.uniform(0.0, 1.0, (k, n)).astype(np.float32),        # score
            rng.integers(0, 4, (k, n)).astype(np.float32),            # done
            np.full((k, n), 3.0, np.float32),                         # total
            rng.uniform(0.05, 3.0, (k, n)).astype(np.float32),        # dist
            (rng.random((k, n)) < 0.7).astype(np.float32)]            # part
    params = jrep.ReputationParams()
    jb2, jd = jrep.end_of_multitask_update(jb, *args, params)
    tb2, td = trep.end_of_multitask_update(
        tb, *args, trep.ReputationParams())
    # thresholded quantities sit away from r_min in this data, so the
    # comparisons below cannot flip on a last-bit difference
    assert np.abs(np.asarray(jd["o_rep"]) - params.r_min).min() > 1e-5
    assert np.abs(np.asarray(jd["l_rep"]) - params.r_min).min() > 1e-5
    got, want = tb2.to_numpy(), {f.name: np.asarray(getattr(jb2, f.name))
                                 for f in dataclasses.fields(jrep.TrainerBook)}
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f].shape == want[f].shape, f
        np.testing.assert_allclose(got[f], want[f], **TOL, err_msg=f)
    for key in jd:
        assert td[key].shape == (k, n)
        _close(td[key], jd[key])


def test_book_round_trip_and_state_sync():
    from repro_torch.core.state import StateArrays
    tb = trep.init_book(5, device="cpu")
    jb = jrep.init_book(5)
    for f in dataclasses.fields(jrep.TrainerBook):
        np.testing.assert_array_equal(tb.to_numpy()[f.name],
                                      np.asarray(getattr(jb, f.name)))
    st = StateArrays(device="cpu")
    trep.sync_book_to_state(tb, st, [3, 1, 4, 0, 2])
    assert st.n == 5
    np.testing.assert_array_equal(st.reputation[:5].numpy(),
                                  np.full(5, 0.5, np.float32))


@pytest.fixture(scope="module")
def quorum_world():
    jm = JaxMLP(D_IN, D_H, N_CLS)
    tm = TinyMLP(D_IN, D_H, N_CLS, device="cpu")
    vx, vy = gaussian_clusters(100, D_IN, N_CLS, seed=2, noise=0.5)
    params = [jm.init_params(jax.random.key(i)) for i in range(4)]
    return jm, tm, vx, vy, params


@pytest.mark.parametrize("n_oracles", [5, 3, 7])
def test_evaluate_quorum_matches_jax(quorum_world, n_oracles):
    """Equal slices (5 x 20) take the double vmap; 3 and 7 oracles give a
    ragged last slice and one vmap per slice."""
    jm, tm, vx, vy, params = quorum_world
    cfg_j, cfg_t = JaxDON(n_oracles=n_oracles), DONConfig(n_oracles=n_oracles)
    stacked_j = jax.tree.map(lambda *xs: jnp.stack(xs), *params)
    stacked_t = {k: torch.from_numpy(np.array(v))
                 for k, v in stacked_j.items()}
    sj, rj = jax_quorum(jm.accuracy_fn(), stacked_j,
                        {"x": jnp.asarray(vx), "labels": jnp.asarray(vy)},
                        cfg_j)
    val = ValidationSlices({"x": vx, "labels": vy}, n_oracles, "cpu")
    assert (val.stacked is None) == (n_oracles != 5)
    st, rt = evaluate_quorum(tm.accuracy_fn(), stacked_t, None, cfg_t,
                             slices=val)
    np.testing.assert_array_equal(rt["table"], rj["table"])
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert rt["flagged_oracles"] == rj["flagged_oracles"]
    assert rt["quorum_ok"] == rj["quorum_ok"]
    # a list of per-trainer dicts, and the per-call loop, give the same
    listed = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
              for p in params]
    sl, rl = evaluate_quorum(tm.accuracy_fn(), listed,
                             {"x": vx, "labels": vy}, cfg_t, mode="loop")
    np.testing.assert_array_equal(rl["table"], rj["table"])
    np.testing.assert_array_equal(sl.numpy(), st.numpy())


def test_quorum_flags_bad_mouthing_oracle_and_auto_falls_back(quorum_world):
    jm, tm, vx, vy, params = quorum_world
    table = np.full((5, 4), 0.8)
    forged = {1: 0.0}
    sj, rj = jax_quorum_table(table, JaxDON(), forged)
    st, rt = quorum_from_table(table, DONConfig(), forged)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert rt["flagged_oracles"] == rj["flagged_oracles"] == [1]
    listed = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
              for p in params]
    acc = tm.accuracy_fn()

    def hostile(p, b):               # float() cannot run under vmap
        return float(acc(p, b))
    s_auto, _ = evaluate_quorum(hostile, listed, {"x": vx, "labels": vy},
                                DONConfig(n_oracles=3))
    s_loop, _ = evaluate_quorum(hostile, listed, {"x": vx, "labels": vy},
                                DONConfig(n_oracles=3), mode="loop")
    np.testing.assert_array_equal(s_auto.numpy(), s_loop.numpy())
    with pytest.raises(RuntimeError):
        evaluate_quorum(hostile, listed, {"x": vx, "labels": vy},
                        DONConfig(n_oracles=3), mode="batched")


def _contracts(pkg):
    acl_cls, esc_cls, store_cls, tsc_cls = pkg
    acl = acl_cls(["admin0", "admin1", "admin2"])
    tsc = tsc_cls(acl, esc_cls(), store_cls())
    ids = [f"trainer{i}" for i in range(5)]
    for t in ids:
        acl.grant("admin0", t, "trainer")
        tsc.escrow.fund(t, 10.0)
    acl.grant("admin0", "tp0", "task_publisher")
    tsc.escrow.fund("tp0", 100.0)
    tsc.publish_task("tp0", "t0", tsc.store.put({}), tsc.store.put({}),
                     1, 0.5, 6.0)
    return tsc, ids


@pytest.mark.parametrize("reps,n_select,min_rep,ban", [
    ([0.5, 0.5, 0.7, 0.5, 0.5], 3, 0.0, None),     # ties by index
    ([0.9, 0.1, 0.6, 0.95, 0.6], 10, 0.5, "trainer3"),
    ([0.5] * 5, 5, 0.0, None),
    (np.float32([0.4922295, 0.6069133, 0.20662598, 0.20662598, 0.6069133]),
     4, 0.0, None),
])
def test_select_trainers_ties_and_filters_match_jax(reps, n_select, min_rep,
                                                     ban):
    got = []
    for pkg in ((JaxACL, JaxEscrow, JaxStore, JaxTSC),
                (AccessControl, Escrow, BlobStore, TaskContract)):
        tsc, ids = _contracts(pkg)
        if ban:
            tsc.acl.ban("admin0", ban)
        got.append(tsc.select_trainers("t0", np.asarray(reps), n_select,
                                       min_rep=min_rep, trainer_ids=ids))
    assert got[1] == got[0]


def test_task_lifecycle_escrow_and_cids_match_jax():
    out = []
    for pkg in ((JaxACL, JaxEscrow, JaxStore, JaxTSC),
                (AccessControl, Escrow, BlobStore, TaskContract)):
        tsc, ids = _contracts(pkg)
        sel = tsc.select_trainers("t0", {t: 0.5 for t in ids}, 4)
        for t in sel:
            tsc.escrow.lock_collateral(t, "t0", 1.0)
        blob = {"b1": np.arange(3, dtype=np.float32),
                "w1": np.ones((2, 2), np.float32)}
        cid = tsc.store.put(blob)
        tsc.submit_local_model(sel[0], "t0", 0, cid)
        tsc.advance_round("t0")
        tsc.record_scores("t0", {sel[0]: 0.6, sel[1]: 0.3, sel[2]: 0.0,
                                 sel[3]: 1e-9})
        pay = tsc.close_task("t0")
        out.append((sel, cid, pay, dict(tsc.escrow.balances),
                    tsc.escrow.slashed_pool, tsc.tasks["t0"].state))
    assert out[1] == out[0]
    # tensors pickle as their numpy copies: the same cid
    store = BlobStore()
    assert store.put({"b1": torch.arange(3, dtype=torch.float32),
                      "w1": torch.ones(2, 2)}) == out[0][1]
    with pytest.raises(PermissionError):
        AccessControl(["a"]).grant("b", "u", "trainer")


def test_batched_batch_fn_stacks_like_jax():
    from repro.fl.cohort import batched_batch_fn as jax_batched
    from repro_torch.fl.cohort import batched_batch_fn
    x, y = gaussian_clusters(200, 8, 10, seed=3)

    def raw(c, r):
        i = np.random.default_rng((c * 9973 + r) % 2**31).integers(0, 200, 4)
        return {"x": x[i], "labels": y[i]}
    sel = np.array([3, 0, 2])
    got = batched_batch_fn(raw, 2, device="cpu")(sel, 5)
    want = jax_batched(raw, 2)(sel, 5)
    for k in want:
        assert tuple(got[k].shape) == (3, 2, *want[k].shape[2:])
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
