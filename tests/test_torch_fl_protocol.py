"""The FL protocol slice as a whole: the port's Scheduler and run_task (on
the CPU) against the JAX package's, on the same world.  Both schedulers
run their stepped per-task path (``fused=False, megabatch=False``); the
default fused + megastep path is held to it in tests/test_torch_fused.py
and tests/test_torch_mega.py.

Both packages train TinyMLP(32, 16, 10) with sgdm on the same gaussian
clusters and batch indices (numpy streams); the port is handed the JAX
package's initial parameters (``params_from_numpy``) and its DP and
fake-update noise (``fl/cohort.round_noise`` replaced by the JAX draws).
Then:

  * exactly equal: protocol calls, gas log, blocks, total gas, batches,
    the typed event stream, each task's selected trainers and DON scores;
  * within rtol 1e-5 / atol 1e-6: global parameters, the reputation book,
    payouts;
  * state roots: every root committed before the first settlement equals
    the JAX package's; after it the reputations may differ in the last
    bit, so the final root is checked as the JAX ``StateArrays`` root of
    the port's own fields, and those fields against the JAX package's
    (integer fields and balances exactly, reputation within tolerance).

The data and seeds below keep every thresholded quantity (Eq. 2's
``o_rep`` and Eq. 9's ``l_rep`` against ``r_min``) more than 1e-5 from its
edge (asserted), so no branch can flip on a last-bit difference; the DON
scores compare exactly, so no argmax tie flipped either.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jx
import repro_torch.api as pt
from repro.core.state import StateArrays as JaxState
from repro.core.workloads import make_workload as jax_workload
from repro.data.synthetic import gaussian_clusters
from repro.fl.cohort import CohortKernels as JaxKernels
from repro.fl.cohort import VectorCohort as JaxCohort
from repro.fl.dp import DPConfig as JaxDP
from repro.fl.scheduler import Scheduler as JaxScheduler
from repro.fl.server import AutoDFL as JaxNode
from repro.models.mlp import TinyMLP as JaxMLP
from repro.optim.optimizers import OptimizerSpec as JaxOptSpec
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro_torch.core.state import STATE_SCHEMA
from repro_torch.core.workloads import make_workload as torch_workload
from repro_torch.fl import cohort as tcohort
from repro_torch.fl.dp import DPConfig
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.models.mlp import TinyMLP, params_from_numpy
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
BEHAVIORS = ["good", "good", "malicious", "lazy"]
D_IN, D_H, N_CLS, LOCAL_STEPS, BATCH, ROUNDS = 32, 16, 10, 2, 8, 3


def jax_round_noise(seed, rnd, n, shapes, device):
    """The JAX package's draws for one cohort round
    (``repro/fl/cohort.py`` ``round_step``): per-trainer DP keys split once
    more per leaf in sorted order, and one fake-update key per trainer
    shared by its leaves."""
    key = jax.random.key(seed)
    k_dp, k_fake = jax.random.split(jax.random.fold_in(key, np.uint32(rnd)))
    names = sorted(shapes)

    def dp_one(k):
        ks = jax.random.split(k, len(names))
        return {nm: jax.random.normal(kk, shapes[nm], jnp.float32)
                for nm, kk in zip(names, ks)}

    def fake_one(k):
        return {nm: jax.random.normal(k, shapes[nm], jnp.float32)
                for nm in names}
    dp = jax.vmap(dp_one)(jax.random.split(k_dp, n))
    fake = jax.vmap(fake_one)(jax.random.split(k_fake, n))

    def put(tree):
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in tree.items()}
    return put(dp), put(fake)


@pytest.fixture(scope="module")
def world():
    tr_x, tr_y = gaussian_clusters(1024, D_IN, N_CLS, seed=1, noise=0.5)
    vx, vy = gaussian_clusters(100, D_IN, N_CLS, seed=2, noise=0.5)

    def idx(sel, rnd):
        return np.random.default_rng(int(rnd) * 131 + 7).integers(
            0, len(tr_x), (len(sel), LOCAL_STEPS, BATCH))

    def jax_bf(sel, rnd):
        i = idx(sel, rnd)
        return {"x": jnp.asarray(tr_x[i]), "labels": jnp.asarray(tr_y[i])}

    def torch_bf(sel, rnd):
        i = idx(sel, rnd)
        return {"x": torch.from_numpy(tr_x[i]),
                "labels": torch.from_numpy(tr_y[i])}
    jm = JaxMLP(D_IN, D_H, N_CLS)
    jo = jax_optimizer(JaxOptSpec(name="sgdm", lr=0.1, grad_clip=5.0))
    tm = TinyMLP(D_IN, D_H, N_CLS, device="cpu")
    to = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0))
    jax_init = {s: {k: np.asarray(v) for k, v in
                    jm.init_params(jax.random.key(s)).items()}
                for s in range(3)}
    return dict(
        jm=jm, jo=jo, tm=tm, to=to, jax_bf=jax_bf, torch_bf=torch_bf,
        val_j={"x": jnp.asarray(vx), "labels": jnp.asarray(vy)},
        val_t={"x": vx, "labels": vy},
        jk=JaxKernels(jm, jo, JaxDP(noise_multiplier=0.05)),
        tk=tcohort.CohortKernels(tm, to, DPConfig(noise_multiplier=0.05)),
        jax_init=jax_init)


def _tasks(api, n_tasks):
    return [api.FLTaskSpec(f"task{t}", rounds=ROUNDS, init_seed=t % 3,
                           start_window=t % 2) for t in range(n_tasks)]


def _watch_first_settlement(node):
    """Record the event cursor at the node's first settlement."""
    mark = {}
    settle = node.settle_window

    def wrapped(rts):
        mark.setdefault("cursor", node.chain.events.next_cursor)
        return settle(rts)
    node.settle_window = wrapped
    return mark


def _run_jax(w, mode, n_tasks, background):
    node = JaxNode(w["jm"], w["jo"], len(BEHAVIORS), w["jm"].accuracy_fn(),
                   w["val_j"], spec=jx.NodeSpec(trainer_funds=50.0))
    mark = _watch_first_settlement(node)
    cohorts = [JaxCohort(w["jm"], w["jo"], w["jax_bf"], node.store,
                         behaviors=BEHAVIORS, local_steps=LOCAL_STEPS,
                         dp=JaxDP(noise_multiplier=0.05), seed=t,
                         kernels=w["jk"]) for t in range(n_tasks)]
    if mode == "run_task":
        spec = _tasks(jx, 1)[0]
        out = {spec.task_id: node.run_task(spec, cohorts[0])}
    else:
        bg = (jax_workload("poisson", 20.0, duration=10.0, seed=3,
                           fn="bgPing") if background else None)
        sch = JaxScheduler(node, seal_every=2, background=bg, fused=False,
                           megabatch=False)
        for spec, c in zip(_tasks(jx, n_tasks), cohorts):
            sch.add_task(spec, c)
        out = sch.run()
    return node, out, mark


def _run_torch(w, mode, n_tasks, background, monkeypatch):
    monkeypatch.setattr(tcohort, "round_noise", jax_round_noise)
    monkeypatch.setattr(w["tm"], "init_params", lambda seed: params_from_numpy(
        w["jax_init"][seed], "cpu"))
    node = AutoDFL(w["tm"], w["to"], len(BEHAVIORS), w["tm"].accuracy_fn(),
                   w["val_t"], spec=pt.NodeSpec(trainer_funds=50.0),
                   device="cpu")
    mark = _watch_first_settlement(node)
    cohorts = [tcohort.VectorCohort(
        w["tm"], w["to"], w["torch_bf"], node.store, behaviors=BEHAVIORS,
        local_steps=LOCAL_STEPS, dp=DPConfig(noise_multiplier=0.05), seed=t,
        kernels=w["tk"], device="cpu") for t in range(n_tasks)]
    if mode == "run_task":
        spec = _tasks(pt, 1)[0]
        out = {spec.task_id: node.run_task(spec, cohorts[0])}
    else:
        bg = (torch_workload("poisson", 20.0, duration=10.0, seed=3,
                             fn="bgPing", device="cpu") if background
              else None)
        sch = Scheduler(node, seal_every=2, background=bg, fused=False,
                        megabatch=False)
        for spec, c in zip(_tasks(pt, n_tasks), cohorts):
            sch.add_task(spec, c)
        out = sch.run()
    return node, out, mark


def _blocks(chain):
    return [(b.height, b.time, b.n_txs, b.gas_used, b.start, b.stop,
             b.block_hash) for b in chain.blocks]


def _fields(state):
    return {name: np.asarray(getattr(state, name)[: state.n])
            for name, _ in STATE_SCHEMA}


@pytest.mark.parametrize("mode,n_tasks,background", [
    ("scheduler", 1, False),
    ("scheduler", 1, True),
    ("scheduler", 3, False),
    ("scheduler", 3, True),
    ("run_task", 1, False),
])
def test_protocol_run_matches_jax(world, monkeypatch, mode, n_tasks,
                                  background):
    nj, oj, mark_j = _run_jax(world, mode, n_tasks, background)
    nt, ot, mark_t = _run_torch(world, mode, n_tasks, background,
                                monkeypatch)
    params = nj.rep_params

    # ledger outputs: exact
    assert nt.protocol_calls == nj.protocol_calls
    assert nt.rollup.gas_log == nj.rollup.gas_log
    assert _blocks(nt.chain) == _blocks(nj.chain)
    assert nt.chain.total_gas == nj.chain.total_gas
    assert nt.rollup.n_batches == nj.rollup.n_batches > 0
    assert nt.chain.n_confirmed == nt.chain.n_submitted
    if background:
        assert any(s.startswith("client") for s in nt.chain._sender_ids)

    # the typed event stream: exact, but for the roots committed after
    # the first settlement (checked through the final fields below)
    ej = nj.client().events(cursor=0)
    et = nt.client().events(cursor=0)
    assert mark_t == mark_j and "cursor" in mark_j
    assert [e.kind for e in et] == [e.kind for e in ej]
    n_pre = 0
    for a, b in zip(et, ej):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        if a.kind == "window_settled":
            assert len(da["state_root"]) == 32
            if a.seq < mark_j["cursor"]:
                n_pre += 1
            else:
                da.pop("state_root"), db.pop("state_root")
        assert da == db
    if mode == "scheduler":
        assert n_pre > 0            # some roots do precede settlement

    # per task: selections and scores exact; params, payouts in tolerance
    assert sorted(ot) == sorted(oj)
    for tid in oj:
        assert nt.tsc.tasks[tid].trainers == nj.tsc.tasks[tid].trainers
        np.testing.assert_array_equal(ot[tid].scores, oj[tid].scores)
        assert sorted(ot[tid].payouts) == sorted(oj[tid].payouts)
        for who, pay in oj[tid].payouts.items():
            np.testing.assert_allclose(ot[tid].payouts[who], pay, **TOL)
        for k, leaf in oj[tid].global_params.items():
            np.testing.assert_allclose(
                ot[tid].global_params[k].numpy(), np.asarray(leaf), **TOL)
        np.testing.assert_allclose(ot[tid].reputations,
                                   np.asarray(oj[tid].reputations), **TOL)
        diag = oj[tid].diagnostics[0]
        for key in ("o_rep", "l_rep"):
            assert np.abs(np.asarray(diag[key]) - params.r_min).min() > 1e-5
            np.testing.assert_allclose(ot[tid].diagnostics[0][key],
                                       np.asarray(diag[key]), **TOL)

    # the reputation book: within tolerance, field by field
    book_t = nt.book.to_numpy()
    for f in dataclasses.fields(nj.book):
        np.testing.assert_allclose(book_t[f.name],
                                   np.asarray(getattr(nj.book, f.name)),
                                   **TOL, err_msg=f.name)

    # the final state: the port's root is the JAX root of its own fields,
    # and those fields are the JAX package's
    ft, fj = _fields(nt.rollup.state_arrays), _fields(nj.rollup.state_arrays)
    js = JaxState(len(ft["balances"]))
    for name in ft:
        getattr(js, name)[: js.n] = ft[name]
    assert nt.rollup.state_root() == js.root()
    for name in ft:
        if name == "reputation":
            np.testing.assert_allclose(ft[name], fj[name], **TOL)
        else:
            np.testing.assert_array_equal(ft[name], fj[name], err_msg=name)
