"""The paper's Fig. 3 world with LeNet-5 (``tests/test_fl_e2e.py``'s
``fl_world``) in the port against the JAX package, on the CPU; the
quorum and ACL tests of that file with LeNet; one default ``Scheduler``
world (2 tasks x 4 trainers, the fused loop and the megastep) with LeNet
against the JAX ``Scheduler``; and ``python -m repro_torch.launch.fl_mnist``
on the CPU.

Both packages are handed the same numpy data, partition and batch
indices; the port takes the JAX package's initial LeNet weights
(``init_params`` patched) and its noise draws (``fl.client.agent_noise``
on the agent path, ``fl.cohort.round_noise`` on the cohort path), since
torch's RNG cannot reproduce ``jax.random``.  Then, as
tests/test_torch_agents.py holds the agent path:

  * exactly equal: participation (the protocol calls), the gas log, block
    stops, the event stream but for hashes and roots, selections and the
    DON scores;
  * within ``TOL``: global parameters, reputations and payouts.

The momentum is kept in float32 on both sides (sgdm's default keeps it in
bfloat16, where a last-bit difference of a float32 gradient can flip a
rounding: a step of 2^-8 relative that this tolerance does not cover).
``TOL`` is the agent path's, rtol 1e-5 / atol 1e-6: XLA and torch take
the convolutions' float32 sums in other orders (tests/test_torch_lenet.py),
a few float32 steps a value, which 48 local steps do not grow past it.
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
from repro.configs.registry import get_config as jax_config
from repro.core.oracle import DONConfig as JaxDON
from repro.core.oracle import evaluate_quorum as jax_quorum
from repro.data.pipeline import client_batch_fn as jax_client_batch_fn
from repro.data.synthetic import make_mnist_like as jax_mnist
from repro.fl.client import ClientConfig as JaxClientConfig
from repro.fl.client import TrainingAgent as JaxAgent
from repro.fl.cohort import CohortKernels as JaxKernels
from repro.fl.cohort import VectorCohort as JaxCohort
from repro.fl.dp import DPConfig as JaxDP
from repro.fl.partition import dirichlet_partition as jax_partition
from repro.fl.scheduler import Scheduler as JaxScheduler
from repro.fl.server import AutoDFL as JaxNode
from repro.models import lenet as jlenet
from repro.models.model import build_model as jax_build_model
from repro.optim.optimizers import OptimizerSpec as JaxOptSpec
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Chain
from repro_torch.core.oracle import DONConfig, evaluate_quorum
from repro_torch.data.pipeline import client_batch_fn
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.fl import client as tclient
from repro_torch.fl import cohort as tcohort
from repro_torch.fl.dp import DPConfig
from repro_torch.fl.partition import dirichlet_partition
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.launch import fl_mnist
from repro_torch.models import lenet
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
from test_torch_agents import jax_agent_noise
from test_torch_fl_protocol import jax_round_noise

torch.set_num_threads(1)

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-6)
BEHAVIORS = ["good", "good", "malicious", "lazy"]


def flat(tree) -> dict:
    """The JAX package's nested LeNet tree as the port's flat keys."""
    return {f"{layer}.{leaf}": np.asarray(v)
            for layer, leaves in tree.items() for leaf, v in leaves.items()}


@pytest.fixture(scope="module")
def fl_world():
    """tests/test_fl_e2e.py's fl_world on both sides."""
    jcfg = jax_config("lenet5")
    jm = jax_build_model(jcfg)
    xs, ys = jax_mnist(1536, seed=1)
    txs, tys = make_mnist_like(1536, seed=1)
    np.testing.assert_array_equal(txs, xs)
    np.testing.assert_array_equal(tys, ys)
    parts = jax_partition(ys[256:], 4, alpha=2.0, seed=0)
    tparts = dirichlet_partition(ys[256:], 4, alpha=2.0, seed=0)
    assert all(np.array_equal(a, b) for a, b in zip(parts, tparts))
    raw = jax_client_batch_fn(xs[256:], ys[256:], parts, 64)
    traw = client_batch_fn(xs[256:], ys[256:], tparts, 64)
    tm = build_model(get_config("lenet5"), CPU)
    jax_init = {}

    def init(seed):
        if seed not in jax_init:
            jax_init[seed] = jax.tree.map(np.asarray,
                                          jm.init_params(jax.random.key(seed)))
        return lenet.params_from_numpy(jax_init[seed], CPU)
    return dict(
        jcfg=jcfg, jm=jm, tm=tm, init=init,
        jo=jax_optimizer(JaxOptSpec(name="sgdm", lr=0.05, grad_clip=5.0,
                                    moment_dtype="float32")),
        to=make_optimizer(OptimizerSpec(name="sgdm", lr=0.05, grad_clip=5.0,
                                        moment_dtype="float32")),
        val_j={"images": jnp.asarray(xs[:256]),
               "labels": jnp.asarray(ys[:256])},
        val_t={"images": xs[:256], "labels": ys[:256]},
        jax_bf=lambda c, r: {k: jnp.asarray(v) for k, v in raw(c, r).items()},
        torch_bf=traw,
        jax_eval=jax.jit(lambda p, b: jlenet.accuracy(jcfg, p, b)),
        torch_eval=tm.accuracy_fn(), xs=xs, ys=ys)


def _inject(w, monkeypatch):
    monkeypatch.setattr(tclient, "agent_noise", jax_agent_noise)
    monkeypatch.setattr(w["tm"], "init_params", w["init"])


def _run_jax(w, tasks, rounds, **legacy):
    node = JaxNode(w["jm"], w["jo"], 4, w["jax_eval"], w["val_j"], **legacy)
    agents = [JaxAgent(JaxClientConfig(f"trainer{i}", b,
                                       dp=JaxDP(noise_multiplier=0.05)),
                       w["jm"], w["jo"], node.store, w["jax_bf"], seed=i)
              for i, b in enumerate(BEHAVIORS)]
    out = [node.run_task(f"task{t}", agents, w["jax_bf"], rounds=rounds)
           for t in range(tasks)]
    return node, out


def _run_torch(w, tasks, rounds, **legacy):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        node = AutoDFL(w["tm"], w["to"], 4, w["torch_eval"], w["val_t"],
                       device=CPU, **legacy)
    agents = [tclient.TrainingAgent(
        tclient.ClientConfig(f"trainer{i}", b,
                             dp=DPConfig(noise_multiplier=0.05)),
        w["tm"], w["to"], node.store, w["torch_bf"], seed=i, device=CPU)
        for i, b in enumerate(BEHAVIORS)]
    out = [node.run_task(f"task{t}", agents, w["torch_bf"], rounds=rounds)
           for t in range(tasks)]
    return node, out


def _events(node):
    out = []
    for e in node.client().events(cursor=0):
        d = dataclasses.asdict(e)
        d.pop("block_hash", None)
        d.pop("state_root", None)
        out.append(d)
    return out


def _hold_results(ot, oj, nt, nj):
    for rt, rj in zip(ot, oj):
        np.testing.assert_array_equal(rt.scores, np.asarray(rj.scores))
        assert sorted(rt.payouts) == sorted(rj.payouts)
        for who, pay in rj.payouts.items():
            np.testing.assert_allclose(rt.payouts[who], pay, **TOL)
        want = flat(rj.global_params)
        assert sorted(rt.global_params) == sorted(want)
        for k, leaf in want.items():
            np.testing.assert_allclose(rt.global_params[k].numpy(), leaf,
                                       **TOL, err_msg=k)
        np.testing.assert_allclose(rt.reputations, np.asarray(rj.reputations),
                                   **TOL)
    for tid in nj.tsc.tasks:
        assert nt.tsc.tasks[tid].trainers == nj.tsc.tasks[tid].trainers


@pytest.mark.parametrize("legacy", [{"use_rollup": True},
                                    {"use_rollup": False}],
                         ids=["rollup", "l1"])
def test_fig3_world_matches_jax(fl_world, monkeypatch, legacy):
    """test_full_protocol_and_convergence's run (3 tasks of 4 rounds,
    good / good / malicious / lazy agents on the object stack), port ==
    JAX by the rules above; with the L2 rollup and on the L1 alone."""
    _inject(fl_world, monkeypatch)
    nj, oj = _run_jax(fl_world, 3, 4, **legacy)
    nt, ot = _run_torch(fl_world, 3, 4, **legacy)
    assert isinstance(nt.chain, Chain)
    assert nt.protocol_calls == nj.protocol_calls
    assert nt.chain.total_gas == nj.chain.total_gas
    assert [(b.height, b.time, len(b.txs), b.gas_used)
            for b in nt.chain.blocks] == \
        [(b.height, b.time, len(b.txs), b.gas_used) for b in nj.chain.blocks]
    if legacy["use_rollup"]:
        assert nt.rollup.gas_log == nj.rollup.gas_log
    else:
        assert nt.rollup is None and nj.rollup is None
    assert _events(nt) == _events(nj)
    _hold_results(ot, oj, nt, nj)


def test_fig3_phenomenology_on_the_port(fl_world):
    """test_full_protocol_and_convergence's assertions on the port alone,
    with its own initial weights and noise."""
    w = fl_world
    nt, ot = _run_torch(w, 3, 4, use_rollup=True)
    res = ot[-1]
    reps = res.reputations
    assert reps[0] > 0.7 and reps[1] > 0.7
    assert reps[2] < 0.35
    assert reps[2] < reps[3] < reps[0]
    batch = {k: torch.from_numpy(v) for k, v in w["val_t"].items()}
    assert float(w["torch_eval"](res.global_params, batch)) > 0.9
    assert res.payouts["trainer2"] < 0.2 * res.payouts["trainer0"]
    assert nt.rollup.gas_log and all(
        b["verify"] > 0 and b["execute"] > 0 for b in nt.rollup.gas_log)


def test_oracle_quorum_resists_badmouthing(fl_world):
    """test_fl_e2e.py's quorum test with LeNet on the port, and its
    scores and reports equal to the JAX package's on the same weights."""
    w = fl_world
    jparams = [w["jm"].init_params(jax.random.key(i)) for i in range(3)]
    tparams = [lenet.params_from_numpy(jax.tree.map(np.asarray, p), CPU)
               for p in jparams]
    cases = [dict(), dict(adversarial_oracles={0: 1.0, 1: 1.0}),
             dict(adversarial_oracles={0: 1.0})]
    got = [evaluate_quorum(w["torch_eval"], tparams, w["val_t"],
                           DONConfig(n_oracles=5), **kw) for kw in cases]
    want = [jax_quorum(w["jax_eval"], jparams, w["val_j"],
                       JaxDON(n_oracles=5), **kw) for kw in cases]
    for (ts, trep), (js, jrep) in zip(got, want):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert trep["flagged_oracles"] == list(jrep["flagged_oracles"])
        assert trep["quorum_ok"] == jrep["quorum_ok"]
    (honest, _), (attacked, report), (_, rep1) = got
    np.testing.assert_allclose(attacked.numpy(), honest.numpy(), atol=0.15)
    assert set(report["flagged_oracles"]) == {0, 1}
    assert not report["quorum_ok"]
    assert rep1["quorum_ok"] and rep1["flagged_oracles"] == [0]


def test_access_control_sybil_whitewash(fl_world):
    """test_fl_e2e.py's ACL test on a port node training LeNet."""
    w = fl_world
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        node = AutoDFL(w["tm"], w["to"], 2, w["torch_eval"], w["val_t"],
                       device=CPU)
    acl = node.acl
    # the port raises PermissionError where the JAX package asserts
    with pytest.raises(PermissionError, match="not an admin"):
        acl.grant("trainer0", "sybil", "trainer")
    acl.ban("admin0", "trainer1")
    with pytest.raises(PermissionError):
        acl.grant("admin0", "trainer1", "trainer")
    assert not acl.vote_readmit("admin0", "trainer1")
    assert acl.vote_readmit("admin1", "trainer1")
    acl.grant("admin0", "trainer1", "trainer")


# -- the default Scheduler with LeNet ------------------------------------------
SCH_STEPS, SCH_BATCH, SCH_ROUNDS = 2, 16, 2


def _sch_batches(w, sel, rnd):
    i = np.random.default_rng(int(rnd) * 131 + 7).integers(
        256, len(w["xs"]), (len(sel), SCH_STEPS, SCH_BATCH))
    return w["xs"][i], w["ys"][i]


def _run_scheduler(w, api, node_cls, cohort_cls, kernels, model, opt, val,
                   eval_fn, bf, **kw):
    node = node_cls(model, opt, 4, eval_fn, val,
                    spec=api.NodeSpec(trainer_funds=50.0), **kw)
    cohorts = [cohort_cls(model, opt, bf, node.store, behaviors=BEHAVIORS,
                          local_steps=SCH_STEPS,
                          dp=(JaxDP if api is jx else DPConfig)(
                              noise_multiplier=0.05),
                          seed=t, kernels=kernels, **kw)
               for t in range(2)]
    sch = (JaxScheduler if api is jx else Scheduler)(node, seal_every=2)
    for t, c in enumerate(cohorts):
        sch.add_task(api.FLTaskSpec(f"task{t}", rounds=SCH_ROUNDS,
                                    init_seed=t), c)
    return node, sch, sch.run()


def test_default_scheduler_with_lenet_matches_jax(fl_world, monkeypatch):
    """2 tasks x 4 trainers through the default Scheduler (fused loop and
    megastep) on both packages: ledger and scores exact, weights,
    reputations and payouts within ``TOL``; the megastep ran."""
    w = fl_world
    monkeypatch.setattr(tcohort, "round_noise", jax_round_noise)
    monkeypatch.setattr(w["tm"], "init_params", w["init"])

    def jax_bf(sel, rnd):
        x, y = _sch_batches(w, sel, rnd)
        return {"images": jnp.asarray(x), "labels": jnp.asarray(y)}

    def torch_bf(sel, rnd):
        x, y = _sch_batches(w, sel, rnd)
        return {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    # 250 validation rows: five equal oracle slices, which the megastep
    # needs (the DON stacks them)
    nj, sj, oj = _run_scheduler(
        w, jx, JaxNode, JaxCohort,
        JaxKernels(w["jm"], w["jo"], JaxDP(noise_multiplier=0.05)),
        w["jm"], w["jo"], {k: v[:250] for k, v in w["val_j"].items()},
        w["jax_eval"], jax_bf)
    nt, st, ot = _run_scheduler(
        w, pt, AutoDFL, tcohort.VectorCohort,
        tcohort.CohortKernels(w["tm"], w["to"],
                              DPConfig(noise_multiplier=0.05)),
        w["tm"], w["to"], {k: v[:250] for k, v in w["val_t"].items()},
        w["torch_eval"], torch_bf, device=CPU)
    assert st.mega_windows > 0 and st.mega_windows == sj.mega_windows
    assert nt.protocol_calls == nj.protocol_calls
    assert nt.rollup.gas_log == nj.rollup.gas_log
    assert nt.chain.total_gas == nj.chain.total_gas
    assert [(b.height, b.n_txs, b.gas_used) for b in nt.chain.blocks] == \
        [(b.height, b.n_txs, b.gas_used) for b in nj.chain.blocks]
    assert sorted(ot) == sorted(oj)
    _hold_results([ot[k] for k in sorted(ot)], [oj[k] for k in sorted(oj)],
                  nt, nj)


def test_fl_mnist_launcher_on_the_cpu(capsys):
    """The launcher's printout, and Fig. 3's ordering after three tasks."""
    out = fl_mnist.main(["--device", "cpu", "--tasks", "3"])
    text = capsys.readouterr().out
    assert "non-IID partition" in text and "rollup:" in text
    assert "global model accuracy" in text and "L1 chain" in text
    reps = out["results"][-1].reputations
    assert reps[2] < reps[3] and reps[2] < reps[0]
    assert out["node"].rollup is not None and out["accuracy"] > 0.5
    l1 = fl_mnist.main(["--device", "cpu", "--tasks", "1", "--rounds", "2",
                        "--no-rollup"])
    assert l1["node"].rollup is None
    assert "rollup:" not in capsys.readouterr().out
