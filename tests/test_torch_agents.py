"""The agent path of the port (fl/client.TrainingAgent, fl/cohort.
AgentCohort, the legacy ``AutoDFL`` constructor and ``run_task`` on the
object Chain and Rollup) against the JAX package's, on the CPU.

Both packages train TinyMLP(32, 16, 10) with sgdm on the same gaussian
clusters and batch indices (numpy streams); the port is handed the JAX
package's initial parameters (``params_from_numpy``) and its agents' DP
and fake-weight noise (``fl/client.agent_noise`` replaced by the JAX
package's per-agent ``jax.random`` split chain).  The object ledger hashes
float content on this path (the tx ids carry the payloads: model cids and
reputation values; the blocks' hashes and the Rollup's pre and post roots
carry the tx ids and the state dict), and torch and JAX agree on floats
only to a tolerance.  So:

  * exactly equal: protocol calls, the gas log, block stops (height,
    time, tx count, gas used), the typed event stream but for block
    hashes and state roots, selections, DON scores and the StateArrays
    counter fields;
  * within rtol 1e-5 / atol 1e-6 (tests/test_torch_fl_protocol.py's
    tolerance): global parameters, reputations, payouts and the
    reputation field of the state;
  * the port's own consistency only: the final state root equals the JAX
    ``StateArrays`` root of the port's fields;
  * not across packages: tx ids, cids, block hashes and the Rollup's pre
    and post roots.

The momentum is kept in float32 here (sgdm's default keeps it in
bfloat16): an agent carries its momentum over its rounds, and a last-bit
difference in a float32 gradient can flip a bfloat16 rounding, a step of
2^-8 relative, which the tolerance above is not meant to cover.  Every
thresholded quantity (Eq. 2's ``o_rep`` and Eq. 9's ``l_rep`` against
``r_min``) is asserted on the same side of its edge in both packages, so
no branch flipped on a last-bit difference.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jx
import repro_torch.api as pt
from repro.core.state import StateArrays as JaxState
from repro.data.synthetic import gaussian_clusters
from repro.fl.client import ClientConfig as JaxClientConfig
from repro.fl.client import TrainingAgent as JaxAgent
from repro.fl.dp import DPConfig as JaxDP
from repro.fl.partition import dirichlet_partition as jax_partition
from repro.fl.partition import skew_report as jax_skew_report
from repro.fl.scheduler import Scheduler as JaxScheduler
from repro.fl.server import AutoDFL as JaxNode
from repro.models.mlp import TinyMLP as JaxMLP
from repro.optim.optimizers import OptimizerSpec as JaxOptSpec
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro_torch.core.engine import VectorChain, VectorRollup
from repro_torch.core.fused import supports_fused
from repro_torch.core.ledger import Chain
from repro_torch.core.rollup import Rollup
from repro_torch.core.shards import ShardedRollup
from repro_torch.core.state import STATE_SCHEMA
from repro_torch.core.storage import BlobStore
from repro_torch.fl import client as tclient
from repro_torch.fl.cohort import (AgentCohort, CohortKernels,
                                   CohortSubmissions, VectorCohort)
from repro_torch.fl.dp import DPConfig
from repro_torch.fl.partition import dirichlet_partition, skew_report
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.models.mlp import TinyMLP, params_from_numpy
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

torch.set_num_threads(1)

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-6)
BEHAVIORS = ["good", "good", "malicious", "lazy"]
D_IN, D_H, N_CLS, LOCAL_STEPS, BATCH = 32, 16, 10, 2, 8
GAS_KEYS = ("n_txs", "commit", "verify", "execute", "total")


def jax_agent_noise(agent, kind, shapes):
    """The JAX package's draws for one agent round (``repro/fl/client.py``):
    one split of the agent's key per draw; the DP key split once more per
    leaf in sorted order, the fake-weight key shared by the leaves."""
    key = getattr(agent, "_jax_key", None)
    if key is None:
        key = jax.random.key(agent.seed)
    key, k = jax.random.split(key)
    agent._jax_key = key
    names = sorted(shapes)
    keys = (jax.random.split(k, len(names)) if kind == "dp"
            else [k] * len(names))
    return {nm: torch.from_numpy(np.array(jax.random.normal(
        kk, shapes[nm], jnp.float32))).to(agent.device)
        for nm, kk in zip(names, keys)}


@pytest.fixture(scope="module")
def world():
    tr_x, tr_y = gaussian_clusters(1024, D_IN, N_CLS, seed=1, noise=0.5)
    vx, vy = gaussian_clusters(100, D_IN, N_CLS, seed=2, noise=0.5)

    def idx(c, r):
        return np.random.default_rng((c * 9973 + r) % 2**31).integers(
            0, len(tr_x), BATCH)

    def jax_bf(c, r):
        i = idx(c, r)
        return {"x": jnp.asarray(tr_x[i]), "labels": jnp.asarray(tr_y[i])}

    def torch_bf(c, r):
        i = idx(c, r)
        return {"x": tr_x[i], "labels": tr_y[i]}
    jm = JaxMLP(D_IN, D_H, N_CLS)
    tm = TinyMLP(D_IN, D_H, N_CLS, device=CPU)
    jax_init = {s: {k: np.asarray(v) for k, v in
                    jm.init_params(jax.random.key(s)).items()}
                for s in range(3)}
    return dict(
        jm=jm, tm=tm, jax_bf=jax_bf, torch_bf=torch_bf,
        jo=jax_optimizer(JaxOptSpec(name="sgdm", lr=0.1, grad_clip=5.0,
                                    moment_dtype="float32")),
        to=make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0,
                                        moment_dtype="float32")),
        val_j={"x": jnp.asarray(vx), "labels": jnp.asarray(vy)},
        val_t={"x": vx, "labels": vy}, jax_init=jax_init)


def _jax_agents(w, store, behaviors=BEHAVIORS):
    return [JaxAgent(JaxClientConfig(f"trainer{i}", b,
                                     local_steps=LOCAL_STEPS,
                                     dp=JaxDP(noise_multiplier=0.05)),
                     w["jm"], w["jo"], store, w["jax_bf"], seed=i)
            for i, b in enumerate(behaviors)]


def _torch_agents(w, store, behaviors=BEHAVIORS):
    return [tclient.TrainingAgent(
        tclient.ClientConfig(f"trainer{i}", b, local_steps=LOCAL_STEPS,
                             dp=DPConfig(noise_multiplier=0.05)),
        w["tm"], w["to"], store, w["torch_bf"], seed=i, device=CPU)
        for i, b in enumerate(behaviors)]


def _inject(w, monkeypatch):
    monkeypatch.setattr(tclient, "agent_noise", jax_agent_noise)
    monkeypatch.setattr(w["tm"], "init_params", lambda seed: params_from_numpy(
        w["jax_init"][seed], CPU))


# -- one agent round ----------------------------------------------------------
@pytest.mark.parametrize("behavior", ["good", "malicious", "lazy"])
def test_agent_rounds_match_jax(world, monkeypatch, behavior):
    """Three rounds of one agent: participation bit-equal (the numpy
    stream), the submitted params and the optimizer state in tolerance."""
    _inject(world, monkeypatch)
    w = world
    ja = _jax_agents(w, None, [behavior])[0]
    ta = _torch_agents(w, None, [behavior])[0]
    ja.store = jx_store = type("S", (), {"put": lambda self, o: "cid"})()
    ta.store = BlobStore()
    del jx_store
    jp = jax.tree.map(jnp.asarray, w["jax_init"][0])
    tp = params_from_numpy(w["jax_init"][0], CPU)
    jo, to = w["jo"].init(jp), w["to"].init(tp)
    for rnd in range(3):
        jout = ja.train_round(jp, jo, 0, rnd)
        tout = ta.train_round(tp, to, 0, rnd)
        assert (jout is None) == (tout is None)
        if jout is None:
            continue
        assert list(tout["params"]) == sorted(tout["params"])
        for k, leaf in jout["params"].items():
            np.testing.assert_allclose(tout["params"][k].numpy(),
                                       np.asarray(leaf), **TOL)
        np.testing.assert_allclose(
            tout["opt_state"]["m"]["w1"].float().numpy(),
            np.asarray(jout["opt_state"]["m"]["w1"], np.float32), **TOL)
        if behavior != "malicious":
            assert tout["loss"] == pytest.approx(jout["loss"], rel=1e-5)
        assert ta.store.has(tout["cid"])
        jp = jout["params"]
        tp = tout["params"]
        jo, to = jout["opt_state"], tout["opt_state"]


# -- the sequential protocol run against the JAX package --------------------------
def _blocks(chain):
    return [(b.height, b.time, len(b.txs), b.gas_used) for b in chain.blocks]


def _events(node):
    out = []
    for e in node.client().events(cursor=0):
        d = dataclasses.asdict(e)
        d.pop("block_hash", None)
        d.pop("state_root", None)
        out.append(d)
    return out


def _fields(state):
    return {name: np.asarray(getattr(state, name)[: state.n])
            for name, _ in STATE_SCHEMA}


def _run(w, api, node_cls, agents_fn, mode, legacy, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        node = node_cls(w["jm" if api is jx else "tm"],
                        w["jo" if api is jx else "to"], len(BEHAVIORS),
                        (w["jm"] if api is jx else w["tm"]).accuracy_fn(),
                        w["val_j" if api is jx else "val_t"],
                        trainer_funds=50.0, **legacy, **kw)
    tasks = [api.FLTaskSpec(f"task{t}", rounds=2, init_seed=t)
             for t in range(2)]
    out = {}
    if mode == "run_task":
        for spec in tasks:
            out[spec.task_id] = node.run_task(
                spec, agents_fn(w, node.store), None)
    else:
        sch = (JaxScheduler if api is jx else Scheduler)(node, seal_every=1)
        for spec in tasks:
            sch.add_task(spec, agents_fn(w, node.store))
        out = sch.run()
    return node, out


@pytest.mark.parametrize("mode,legacy", [
    ("run_task", {}),
    ("run_task", {"use_rollup": False}),
    ("scheduler", {}),
    ("run_task", {"engine": "vector"}),
    ("scheduler", {"engine": "vector", "n_shards": 2}),
], ids=["object", "object-l1", "object-scheduler", "vector", "fabric"])
def test_sequential_agent_run_matches_jax(world, monkeypatch, mode, legacy):
    """``AutoDFL(...)`` from legacy kwargs (no spec: the object stack) and
    two tasks of TrainingAgents, through run_task or the Scheduler, on
    both packages."""
    _inject(world, monkeypatch)
    nj, oj = _run(world, jx, JaxNode, _jax_agents, mode, legacy)
    nt, ot = _run(world, pt, AutoDFL, _torch_agents, mode, legacy,
                  device=CPU)
    assert type(nt.chain).__name__ == type(nj.chain).__name__
    assert type(nt.rollup).__name__ == type(nj.rollup).__name__

    # ledger: exact, but for the float-hashing fields
    assert nt.protocol_calls == nj.protocol_calls
    assert nt.chain.total_gas == nj.chain.total_gas
    if nj.rollup is not None:
        assert nt.rollup.gas_log == nj.rollup.gas_log
    if isinstance(nt.chain, Chain):
        assert _blocks(nt.chain) == _blocks(nj.chain)
        assert [(t.fn, t.gas, t.submit_time) for t in nt.chain.mempool] == \
            [(t.fn, t.gas, t.submit_time) for t in nj.chain.mempool]
    else:
        assert [(b.height, b.n_txs, b.gas_used) for b in nt.chain.blocks] \
            == [(b.height, b.n_txs, b.gas_used) for b in nj.chain.blocks]
    assert _events(nt) == _events(nj)

    # per task: selections and scores exact; params, payouts in tolerance
    params = nj.rep_params
    assert sorted(ot) == sorted(oj)
    for tid in oj:
        assert nt.tsc.tasks[tid].trainers == nj.tsc.tasks[tid].trainers
        np.testing.assert_array_equal(ot[tid].scores, oj[tid].scores)
        for who, pay in oj[tid].payouts.items():
            np.testing.assert_allclose(ot[tid].payouts[who], pay, **TOL)
        for k, leaf in oj[tid].global_params.items():
            np.testing.assert_allclose(
                ot[tid].global_params[k].numpy(), np.asarray(leaf), **TOL)
        np.testing.assert_allclose(ot[tid].reputations,
                                   np.asarray(oj[tid].reputations), **TOL)
        diag = oj[tid].diagnostics[0]
        for key in ("o_rep", "l_rep"):
            got = np.asarray(ot[tid].diagnostics[0][key])
            want = np.asarray(diag[key])
            np.testing.assert_allclose(got, want, **TOL)
            for side in (np.greater, np.greater_equal):
                np.testing.assert_array_equal(side(got, params.r_min),
                                              side(want, params.r_min))

    # the account state: counters exact, reputation in tolerance, and the
    # port's root the JAX root of its own fields
    target = nt._target()
    ft, fj = _fields(nt.state_arrays), _fields(nj.state_arrays)
    js = JaxState(len(ft["balances"]))
    for name in ft:
        getattr(js, name)[: js.n] = ft[name]
    assert target.state_root() == js.root()
    for name in ft:
        if name == "reputation":
            np.testing.assert_allclose(ft[name], fj[name], **TOL)
        else:
            np.testing.assert_array_equal(ft[name], fj[name], err_msg=name)


# -- the legacy constructor -----------------------------------------------------
def test_default_constructor_builds_the_object_stack(world):
    """Fault 4 closed: no spec means NodeSpec.from_legacy(), the object
    Chain and Rollup, as in the JAX package."""
    w = world
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # no flags: no warning
        node = AutoDFL(w["tm"], w["to"], 4, w["tm"].accuracy_fn(),
                       w["val_t"], device=CPU)
    assert isinstance(node.chain, Chain) and isinstance(node.rollup, Rollup)
    assert node.spec == pt.NodeSpec.from_legacy()
    assert node.spec.chain.backend == "object"
    assert node.state_arrays is node.rollup.state_arrays
    assert node.state_arrays.device == torch.device(CPU)
    assert not supports_fused(node.chain, node.rollup)
    assert "fused_window_loop" not in node.client().capabilities()
    vec = AutoDFL(w["tm"], w["to"], 4, w["tm"].accuracy_fn(), w["val_t"],
                  spec=pt.NodeSpec(), device=CPU)
    assert isinstance(vec.chain, VectorChain)
    assert isinstance(vec.rollup, VectorRollup)


LEGACY_CONFIGS = [
    ({"engine": "object"}, pt.NodeSpec(chain=pt.ChainSpec(backend="object"))),
    ({"engine": "object", "use_rollup": False},
     pt.NodeSpec(chain=pt.ChainSpec(backend="object"), rollup=None)),
    ({"engine": "vector"}, pt.NodeSpec()),
    ({"engine": "vector", "use_rollup": False}, pt.NodeSpec(rollup=None)),
    ({"engine": "vector", "n_shards": 2},
     pt.NodeSpec(shards=pt.ShardSpec(count=2))),
]


@pytest.mark.parametrize("legacy,spec", LEGACY_CONFIGS,
                         ids=["obj", "obj-l1", "vec", "vec-l1", "fabric"])
def test_spec_node_equivalent_to_legacy_node(world, monkeypatch, legacy,
                                             spec):
    """tests/test_api.py:318 at one shard: the legacy kwargs and the spec
    they map to build nodes that run bit-identically."""
    _inject(world, monkeypatch)
    w = world
    with pytest.warns(DeprecationWarning, match="NodeSpec"):
        node_a = AutoDFL(w["tm"], w["to"], 4, w["tm"].accuracy_fn(),
                         w["val_t"], device=CPU, **legacy)
    node_b = AutoDFL(w["tm"], w["to"], 4, w["tm"].accuracy_fn(),
                     w["val_t"], spec=spec, device=CPU)
    assert node_a.spec == spec
    res = []
    for node in (node_a, node_b):
        res.append(node.run_task(pt.FLTaskSpec("t0", rounds=2),
                                 _torch_agents(w, node.store), None))
    assert node_a.chain.total_gas == node_b.chain.total_gas
    assert node_a.protocol_calls == node_b.protocol_calls
    assert node_a._target().state_root() == node_b._target().state_root()
    np.testing.assert_array_equal(res[0].scores, res[1].scores)
    np.testing.assert_array_equal(res[0].reputations, res[1].reputations)
    assert res[0].payouts == res[1].payouts
    if node_a.rollup is not None:
        assert [tuple(r[k] for k in GAS_KEYS) for r in node_a.rollup.gas_log] \
            == [tuple(r[k] for k in GAS_KEYS) for r in node_b.rollup.gas_log]


def test_legacy_kwargs_warn_but_work(world):
    w = world
    args = (w["tm"], w["to"], 4, w["tm"].accuracy_fn(), w["val_t"])
    with pytest.warns(DeprecationWarning, match="NodeSpec"):
        node = AutoDFL(*args, engine="vector", use_rollup=False, device=CPU)
    assert isinstance(node.chain, VectorChain) and node.rollup is None
    # the protocol constants stay silent
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        node = AutoDFL(*args, trainer_funds=3.0, seed=4, device=CPU)
    assert node.spec.trainer_funds == 3.0 and node.spec.seed == 4
    # n_shards > 1 builds the sharded fabric, as the JAX package does
    # (run against it in test_sequential_agent_run_matches_jax[fabric])
    with pytest.warns(DeprecationWarning, match="n_shards"):
        node = AutoDFL(*args, engine="vector", n_shards=2,
                       shard_route="least_loaded", device=CPU)
    assert isinstance(node.rollup, ShardedRollup)
    assert node.rollup.n_shards == 2 and node.rollup.route == "least_loaded"
    assert node.state_arrays is node.rollup.state
    with pytest.warns(DeprecationWarning):
        jnode = JaxNode(w["jm"], w["jo"], 4, w["jm"].accuracy_fn(),
                        w["val_j"], engine="vector", n_shards=2,
                        shard_route="least_loaded")
    assert node.spec.describe() == jnode.spec.describe()
    # spec= and legacy kwargs are exclusive, the defaulted ones included
    for kw in ({"engine": "vector"}, {"use_pallas_agg": True}, {"seed": 0},
               {"trainer_funds": 1.0}):
        with pytest.raises(ValueError, match="not both"):
            AutoDFL(*args, spec=pt.NodeSpec(), device=CPU, **kw)
    with pytest.raises(ValueError, match="contradicts"):
        AutoDFL(*args, spec=pt.NodeSpec(n_trainers=8), device=CPU)
    node = AutoDFL(*args, spec=pt.NodeSpec(), device=CPU)
    with pytest.raises(ValueError):
        node.run_task(pt.FLTaskSpec("t0", rounds=2), [], rounds=3)


# -- Scheduler over agents --------------------------------------------------------
@pytest.mark.parametrize("engine", ["object", "vector"])
def test_scheduler_single_task_equivalent_to_run_task(world, monkeypatch,
                                                      engine):
    """tests/test_scheduler.py:66: one task through the Scheduler equals
    run_task, bit for bit, on both engines."""
    _inject(world, monkeypatch)
    w = world
    spec = pt.NodeSpec(chain=pt.ChainSpec(backend=engine))
    args = (w["tm"], w["to"], 4, w["tm"].accuracy_fn(), w["val_t"])
    sys_a = AutoDFL(*args, spec=spec, device=CPU)
    res_a = sys_a.run_task("t0", _torch_agents(w, sys_a.store), None,
                           rounds=3)
    sys_b = AutoDFL(*args, spec=spec, device=CPU)
    sch = Scheduler(sys_b)
    sch.add_task("t0", _torch_agents(w, sys_b.store), rounds=3)
    res_b = sch.run()["t0"]
    np.testing.assert_array_equal(res_a.scores, res_b.scores)
    np.testing.assert_array_equal(res_a.reputations, res_b.reputations)
    assert res_a.payouts == res_b.payouts
    for k in res_a.global_params:
        assert torch.equal(res_a.global_params[k], res_b.global_params[k])
    assert sys_a.chain.total_gas == sys_b.chain.total_gas
    assert sys_a.protocol_calls == sys_b.protocol_calls
    assert [tuple(r[k] for k in GAS_KEYS) for r in sys_a.rollup.gas_log] == \
        [tuple(r[k] for k in GAS_KEYS) for r in sys_b.rollup.gas_log]
    assert sys_a.rollup.state_root() == sys_b.rollup.state_root()
    assert sch.mega_windows == 0


def test_scheduler_seal_every_works_on_object_engine(world, monkeypatch):
    _inject(world, monkeypatch)
    w = world
    node = AutoDFL(w["tm"], w["to"], 4, w["tm"].accuracy_fn(), w["val_t"],
                   device=CPU)
    sch = Scheduler(node, seal_every=1)
    sch.add_task("t0", _torch_agents(w, node.store), rounds=2)
    assert sch.run()["t0"] is not None
    assert node.rollup.gas_log and not node.rollup.pending
    windows = [e for e in node.client().events(cursor=0)
               if e.kind == "window_settled"]
    assert len(windows) == sch.n_windows + 1          # + the final flush


@pytest.mark.parametrize("engine", ["object", "vector"])
def test_stepped_fallbacks_for_agents(world, monkeypatch, engine):
    """tests/test_fused.py:137 and tests/test_mega.py:155-173: under the
    defaults an object stack runs the stepped ledger loop and agents step
    per task (no megastep); megabatch=True refuses them."""
    _inject(world, monkeypatch)
    w = world
    spec = pt.NodeSpec(chain=pt.ChainSpec(backend=engine))
    args = (w["tm"], w["to"], 4, w["tm"].accuracy_fn(), w["val_t"])
    node = AutoDFL(*args, spec=spec, device=CPU)
    assert supports_fused(node.chain, node.rollup) == (engine == "vector")
    sch = Scheduler(node, seal_every=2, megabatch="auto")
    sch.add_task("t0", _torch_agents(w, node.store), rounds=1)
    sch.add_task("t1", AgentCohort(_torch_agents(w, node.store)), rounds=1)
    loops = []
    run_until = type(node.chain).run_until
    monkeypatch.setattr(type(node.chain), "run_until",
                        lambda ch, t: loops.append(t) or run_until(ch, t))
    out = sch.run()
    assert sorted(out) == ["t0", "t1"] and sch.mega_windows == 0
    # the stepped loop packs blocks at every window edge; the fused loop
    # plans them and packs once
    assert (len(loops) > 1) == (engine == "object")
    node = AutoDFL(*args, spec=spec, device=CPU)
    sch = Scheduler(node, megabatch=True)
    sch.add_task("t0", _torch_agents(w, node.store), rounds=1)
    with pytest.raises(RuntimeError, match="megabatch"):
        sch.run()


def test_object_engine_with_vector_cohorts_and_background(world):
    """VectorCohorts on the object stack with background traffic: the
    background lands as object Txs of the "client<k>" actors."""
    from repro_torch.core.workloads import make_workload
    w = world
    node = AutoDFL(w["tm"], w["to"], 4, w["tm"].accuracy_fn(), w["val_t"],
                   trainer_funds=50.0, device=CPU)

    def vbf(sel, rnd):
        return {k: torch.from_numpy(np.stack([np.stack(
            [w["torch_bf"](int(i), rnd * 1000 + s)[k]
             for s in range(LOCAL_STEPS)]) for i in sel]))
            for k in ("x", "labels")}
    sch = Scheduler(node, seal_every=2, background=make_workload(
        "poisson", 20.0, duration=6.0, seed=3, fn="bgPing", device=CPU))
    kern = CohortKernels(w["tm"], w["to"], DPConfig(noise_multiplier=0.05))
    for t in range(2):
        sch.add_task(f"task{t}", VectorCohort(
            w["tm"], w["to"], vbf, node.store, behaviors=BEHAVIORS,
            local_steps=LOCAL_STEPS, dp=DPConfig(noise_multiplier=0.05),
            seed=t, kernels=kern, device=CPU), rounds=2, start_window=t)
    out = sch.run()
    assert sorted(out) == ["task0", "task1"] and sch.mega_windows == 0
    assert not node.chain.mempool
    senders = {t.sender for b in node.chain.blocks for t in b.txs
               if t.fn == "bgPing"}
    assert senders and all(s.startswith("client") for s in senders)


# -- the pieces -----------------------------------------------------------------
def test_cohort_submissions_tree_for():
    stacked = {"w": torch.arange(6.0).reshape(3, 2), "b": torch.arange(3.0)}
    subs = CohortSubmissions([1, 4, 7], stacked, {})
    view = subs.tree_for(1)
    assert torch.equal(view["w"], torch.tensor([2.0, 3.0]))
    assert float(view["b"]) == 1.0


@pytest.mark.parametrize("alpha,n_clients", [(0.5, 4), (0.1, 8), (5.0, 3)])
def test_dirichlet_partition_matches_jax(alpha, n_clients):
    labels = np.random.default_rng(3).integers(0, 10, 500)
    got = dirichlet_partition(labels, n_clients, alpha=alpha, seed=2)
    want = jax_partition(labels, n_clients, alpha=alpha, seed=2)
    assert len(got) == len(want) == n_clients
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert skew_report(labels, got) == jax_skew_report(labels, want)
    assert min(len(p) for p in got) >= 8


def test_agent_blob_is_sorted_host_arrays(world):
    """The submitted tree reaches the store as host arrays in sorted key
    order, so two runs of one agent store one cid."""
    w = world
    cids = []
    for _ in range(2):
        store = BlobStore()
        agent = _torch_agents(w, store, ["good"])[0]
        p = {k: v for k, v in reversed(list(params_from_numpy(
            w["jax_init"][0], CPU).items()))}
        out = agent.train_round(p, w["to"].init(p), 0, 0)
        blob = store.get(out["cid"])
        assert list(blob) == sorted(blob)
        assert all(isinstance(v, np.ndarray) for v in blob.values())
        cids.append(out["cid"])
    assert cids[0] == cids[1]
