"""The rest of the port's public API against the JAX package's, on the CPU.

  * The deprecated ``NodeClient.subscribe`` shim (tests/test_api.py's two
    cases): it warns, fires the fabric's and the chain's callbacks, and
    their payloads equal the JAX package's on the same submissions; it
    refuses a rollup hook on a chain-only node, naming the capabilities.
  * ``build_node(spec, ...)`` builds what ``AutoDFL(..., spec=spec)``
    builds, and a run on each gives the same outputs; without
    ``spec.n_trainers`` both packages refuse it alike.
  * ``cross_verify_aggregate`` on the FL path's shape (64 trainers,
    TinyMLP(64, 32, 10): 2,410 parameters) from a numpy seed: the same
    ``agree`` as the JAX function, the aggregate within 1e-6 (float32
    sums in another order); an order-dependent or a stateful ``agg_fn``
    loses the quorum in both.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.api as jx
import repro_torch.api as pt
from repro.core.aggregation import weighted_average_tree as jax_agg
from repro.core.oracle import DONConfig as JaxDON
from repro.core.oracle import cross_verify_aggregate as jax_cross_verify
from repro_torch.core.aggregation import weighted_average_tree
from repro_torch.core.oracle import DONConfig, cross_verify_aggregate
from repro_torch.core.workloads import make_workload
from repro_torch.data.synthetic import gaussian_clusters
from repro_torch.fl.cohort import VectorCohort
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.models.mlp import TinyMLP
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

torch.set_num_threads(1)

AGG_TOL = dict(rtol=0, atol=1e-6)
# TinyMLP(64, 32, 10): the FL path's model, 2,410 parameters
MLP_SHAPES = {"w1": (64, 32), "b1": (32,), "w2": (32, 10), "b2": (10,)}


# -- the subscribe shim ---------------------------------------------------------

def _fabric_callbacks(api, **kw):
    client = api.NodeClient.from_spec(
        api.NodeSpec(shards=api.ShardSpec(count=2)), **kw)
    sealed, settled, windows = [], [], []
    with pytest.warns(DeprecationWarning, match="events"):
        client.subscribe("batch_sealed", sealed.append)
    with pytest.warns(DeprecationWarning):
        client.subscribe("session_settled", settled.append)
    with pytest.warns(DeprecationWarning):
        client.subscribe("window_settled", windows.append)
    for i in range(30):
        client.submit("submitLocalModel", f"t{i}")
    client.flush()
    return sealed, settled, windows


def test_legacy_subscribe_shim_still_fires_with_a_warning():
    sealed, settled, windows = _fabric_callbacks(pt, device="cpu")
    assert sealed and settled and windows
    assert all("shard" in e for e in sealed + settled)
    assert sum(e["n_txs"] for e in sealed) == 30
    assert "fabric_root" in windows[-1]
    assert (sealed, settled, windows) == _fabric_callbacks(jx)


def _chain_only(api, **kw):
    bare = api.NodeClient.from_spec(api.NodeSpec(rollup=None), **kw)
    caps = bare.capabilities()
    full = api.NodeClient.from_spec(api.NodeSpec(), **kw).capabilities()
    for i in range(10):
        bare.submit("publishTask", f"p{i}")
    bare.run_until(3.0)
    blocks = [(e.kind, dataclasses.asdict(e))
              for e in bare.events(kinds=("block_packed",))]
    seen = []
    with pytest.warns(DeprecationWarning):
        bare.subscribe("block_packed", seen.append)
    bare.run_until(4.0)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="capabilities") as err:
            bare.subscribe("batch_sealed", lambda e: None)
    return caps, full, blocks, seen, str(err.value)


def test_chain_only_nodes_emit_block_events_and_report_capabilities():
    caps, full, blocks, seen, refusal = _chain_only(pt, device="cpu")
    assert caps == frozenset({"block_packed", "fused_window_loop"})
    assert "aggregate_verified" in full and "block_packed" in full
    assert blocks and sum(e["n_txs"] for _, e in blocks) == 10
    assert all(e["block_hash"] for _, e in blocks)
    assert seen
    ref = _chain_only(jx)
    assert (caps, full, blocks, seen, refusal) == ref


# -- build_node -----------------------------------------------------------------

def _fl_world():
    x, y = gaussian_clusters(256, 16, 10, seed=1)
    vx, vy = gaussian_clusters(50, 16, 10, seed=2)
    model = TinyMLP(16, 8, 10, device="cpu")
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0))

    def batch_fn(sel, rnd):
        i = np.random.default_rng(rnd).integers(0, 256, (len(sel), 2, 4))
        return {"x": torch.from_numpy(x[i]),
                "labels": torch.from_numpy(y[i])}
    return model, opt, batch_fn, {"x": vx, "labels": vy}


def _fl_run(node, model, opt, batch_fn):
    sch = Scheduler(node, seal_every=1, background=make_workload(
        "poisson", 5.0, duration=3.0, seed=0, device="cpu"))
    for t in range(2):
        sch.add_task(pt.FLTaskSpec(f"t{t}", rounds=2), VectorCohort(
            model, opt, batch_fn, node.store,
            behaviors=["good", "malicious", "lazy"], local_steps=2, seed=t,
            device="cpu"))
    out = sch.run()
    return ({k: (r.scores.tolist(), r.reputations.tolist(), r.payouts,
                 {n: p.tolist() for n, p in r.global_params.items()})
             for k, r in out.items()},
            node.rollup.gas_log, node.rollup.state_root(),
            node.book.reputation.tolist())


def test_build_node_equals_autodfl_with_the_spec():
    model, opt, batch_fn, val = _fl_world()
    spec = pt.NodeSpec(n_trainers=3)
    node = pt.build_node(spec, model, opt, model.accuracy_fn(), val,
                         device="cpu")
    twin = AutoDFL(model, opt, 3, model.accuracy_fn(), val, spec=spec,
                   device="cpu")
    assert type(node) is type(twin) and node.spec == twin.spec == spec
    assert type(node.rollup) is type(twin.rollup)
    assert node.book.reputation.device == torch.device("cpu")
    assert _fl_run(node, model, opt, batch_fn) == \
        _fl_run(twin, model, opt, batch_fn)


def test_build_node_needs_n_trainers():
    model, opt, _, val = _fl_world()
    with pytest.raises(ValueError, match="n_trainers") as err:
        pt.build_node(pt.NodeSpec(), model, opt, model.accuracy_fn(), val,
                      device="cpu")
    with pytest.raises(ValueError) as ref:
        jx.build_node(jx.NodeSpec(), None, None, None, None)
    assert str(err.value) == str(ref.value)


# -- cross_verify_aggregate -----------------------------------------------------

def _stacked(seed, n=64):
    """n trainers' models as the FL path stacks them: one global model
    (weights at 1 / sqrt(fan-in), biases at 0) plus a local update of
    0.01 each.  With independent N(0, 1) rows instead, elements of the
    aggregate near 0 sit below what rtol 1e-4 and atol 1e-8 can hold
    across summation orders, and the quorum turns on rounding in both
    packages."""
    rng = np.random.default_rng(seed)
    tree = {}
    for k, s in MLP_SHAPES.items():
        g = (rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2
             else np.zeros(s))
        tree[k] = (g[None] + 0.01 * rng.normal(size=(n,) + s)).astype(
            np.float32)
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return tree, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_oracles", [3, 5])
def test_cross_verify_aggregate_matches_jax(seed, n_oracles):
    tree, scores = _stacked(seed)
    ref, agree = cross_verify_aggregate(
        weighted_average_tree, {k: torch.from_numpy(v)
                                for k, v in tree.items()},
        torch.from_numpy(scores), DONConfig(n_oracles=n_oracles), seed=seed)
    jref, jagree = jax_cross_verify(
        jax_agg, {k: jnp.asarray(v) for k, v in tree.items()},
        jnp.asarray(scores), JaxDON(n_oracles=n_oracles), seed=seed)
    assert agree == jagree == n_oracles
    assert sorted(ref) == sorted(jref)
    for k in ref:
        np.testing.assert_allclose(ref[k].numpy(), np.asarray(jref[k]),
                                   **AGG_TOL)
    # oracle 0 is the unpermuted aggregate, bit for bit
    plain = weighted_average_tree({k: torch.from_numpy(v)
                                   for k, v in tree.items()},
                                  torch.from_numpy(scores))
    for k in ref:
        assert torch.equal(ref[k], plain[k])


def _order_dependent(api):
    """Weights each row by its position too: a different aggregate on
    every permutation of the trainer axis."""
    def agg(stacked, scores):
        n = scores.shape[0]
        pos = (api.arange(n) + 1.0).astype(scores.dtype) \
            if api is jnp else torch.arange(n, dtype=scores.dtype) + 1.0
        w = scores * pos
        return {k: (v * w.reshape((n,) + (1,) * (v.ndim - 1))).sum(0)
                / w.sum() for k, v in stacked.items()}
    return agg


def _stateful(agg, add):
    calls = {"n": 0}

    def stateful(stacked, scores):       # result depends on call history
        calls["n"] += 1
        out = agg(stacked, scores)
        if calls["n"] > 1:
            out = {k: add(v, 0.1 * calls["n"]) for k, v in out.items()}
        return out
    return stateful


@pytest.mark.parametrize("kind", ["order", "stateful"])
def test_cross_verify_aggregate_quorum_fails_in_both(kind):
    tree, scores = _stacked(2)
    if kind == "order":
        fns = (_order_dependent(torch), _order_dependent(jnp))
    else:
        fns = (_stateful(weighted_average_tree, lambda v, c: v + c),
               _stateful(jax_agg, lambda v, c: jax.tree.map(
                   lambda leaf: leaf + c, v)))
    with pytest.raises(RuntimeError, match="quorum failed"):
        cross_verify_aggregate(fns[0], {k: torch.from_numpy(v)
                                        for k, v in tree.items()},
                               torch.from_numpy(scores),
                               DONConfig(n_oracles=5))
    with pytest.raises(RuntimeError, match="quorum failed"):
        jax_cross_verify(fns[1], {k: jnp.asarray(v) for k, v in tree.items()},
                         jnp.asarray(scores), JaxDON(n_oracles=5))
