"""The port's fused window loop (core/fused.py) against the port's stepped
path and against the JAX package's fused loop.

  * FL end to end, on the four configurations of tests/test_fused.py
    (built with ``NodeSpec``): the port fused, the port stepped and the
    JAX package fused (megastep off in all three), with the JAX initial
    parameters and noise handed to the port.  Port fused == port stepped
    exactly: event streams, blocks, confirm times, gas log, digests,
    provenance, window and settlement records, state roots, and the
    tasks' scores, parameters, reputations and payouts, bit for bit.  Port
    against JAX: the ledger exactly (every state root committed before the
    first settlement included), selections and DON scores exactly,
    parameters, reputations and payouts within rtol 1e-5 / atol 1e-6 (as
    tests/test_torch_fl_protocol.py: float32 sums in another order).
  * The raw ledger: random window schedules (hypothesis) through the loop
    and through the stepped calls it journals, and the JAX package's
    stepped ledger on the same traffic: equal, exactly.
  * The loop runs once; it adopts txs staged before it existed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from conftest import given, settings, st  # noqa: F401

import repro.api as jx
import repro_torch.api as pt
from repro.core.engine import FnRegistry as JaxFns
from repro.core.engine import TxArrays as JaxTx
from repro.core.engine import VectorChain as JaxChain
from repro.core.engine import VectorRollup as JaxRollup
from repro.core.fused import FusedWindowLoop as JaxLoop
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
from repro_torch.core.engine import TxArrays, VectorChain, VectorRollup
from repro_torch.core.fused import FusedWindowLoop, supports_fused
from repro_torch.core.workloads import make_workload as torch_workload
from repro_torch.fl import cohort as tcohort
from repro_torch.fl.dp import DPConfig
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.kernels import block_pack as bp
from repro_torch.models.mlp import TinyMLP, params_from_numpy
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
from test_torch_fl_protocol import jax_round_noise

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
BEHAVIORS = ["good", "good", "malicious", "lazy"]
D_IN, D_H, N_CLS, LOCAL_STEPS, BATCH, ROUNDS = 32, 16, 10, 2, 8, 3
CONFIGS = {
    "seal2-bg": dict(seal_every=2, bg=True),
    "seal0-bg": dict(seal_every=0, bg=True),          # seal only at flush
    "lanes2": dict(seal_every=1, bg=False, n_lanes=2, n_tasks=2),
    "no-rollup": dict(seal_every=2, bg=True, use_rollup=False),
}


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
    return dict(
        jm=jm, jo=jo, tm=tm, to=to, jax_bf=jax_bf, torch_bf=torch_bf,
        val_j={"x": jnp.asarray(vx), "labels": jnp.asarray(vy)},
        val_t={"x": vx, "labels": vy},
        jk=JaxKernels(jm, jo, JaxDP(noise_multiplier=0.05)),
        tk=tcohort.CohortKernels(tm, to, DPConfig(noise_multiplier=0.05)),
        jax_init={s: {k: np.asarray(v) for k, v in
                      jm.init_params(jax.random.key(s)).items()}
                  for s in range(3)})


def _spec(api, use_rollup=True, n_lanes=1):
    return api.NodeSpec(
        rollup=api.RollupSpec(n_lanes=n_lanes) if use_rollup else None,
        trainer_funds=50.0)


def _tasks(api, n_tasks):
    return [api.FLTaskSpec(f"task{t}", rounds=ROUNDS, init_seed=t % 3,
                           start_window=t % 2) for t in range(n_tasks)]


def _run_jax(w, seal_every, bg, use_rollup=True, n_lanes=1, n_tasks=3):
    node = JaxNode(w["jm"], w["jo"], len(BEHAVIORS), w["jm"].accuracy_fn(),
                   w["val_j"], spec=_spec(jx, use_rollup, n_lanes))
    sch = JaxScheduler(
        node, seal_every=seal_every, fused=True, megabatch=False,
        background=(jax_workload("poisson", 20.0, duration=10.0, seed=3,
                                 fn="bgPing") if bg else None))
    for t, spec in enumerate(_tasks(jx, n_tasks)):
        sch.add_task(spec, JaxCohort(
            w["jm"], w["jo"], w["jax_bf"], node.store, behaviors=BEHAVIORS,
            local_steps=LOCAL_STEPS, dp=JaxDP(noise_multiplier=0.05), seed=t,
            kernels=w["jk"]))
    return node, sch, sch.run()


def _run_torch(w, fused, seal_every, bg, use_rollup=True, n_lanes=1,
               n_tasks=3):
    node = AutoDFL(w["tm"], w["to"], len(BEHAVIORS), w["tm"].accuracy_fn(),
                   w["val_t"], spec=_spec(pt, use_rollup, n_lanes),
                   device="cpu")
    mark = _first_settlement(node)
    sch = Scheduler(
        node, seal_every=seal_every, fused=fused, megabatch=False,
        background=(torch_workload("poisson", 20.0, duration=10.0, seed=3,
                                   fn="bgPing", device="cpu") if bg
                    else None))
    for t, spec in enumerate(_tasks(pt, n_tasks)):
        sch.add_task(spec, tcohort.VectorCohort(
            w["tm"], w["to"], w["torch_bf"], node.store, behaviors=BEHAVIORS,
            local_steps=LOCAL_STEPS, dp=DPConfig(noise_multiplier=0.05),
            seed=t, kernels=w["tk"], device="cpu"))
    return node, sch, sch.run(), mark


def _blocks(chain):
    return [(b.height, b.time, b.n_txs, b.gas_used, b.start, b.stop,
             b.parent, b.block_hash) for b in chain.blocks]


def _confirm(chain):
    c = chain.confirm_times()
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _assert_ledgers_equal(a, b, roots_until=None):
    """Two ledgers (either package) equal: blocks, gas, confirm times,
    rollup bookkeeping and provenance, and the typed event stream.  With
    ``roots_until``, state roots committed at or after that event
    position are not compared."""
    ea, eb = a.chain.events.since(0), b.chain.events.since(0)
    assert [e.kind for e in ea] == [e.kind for e in eb]
    for x, y in zip(ea, eb):
        dx, dy = dataclasses.asdict(x), dataclasses.asdict(y)
        if roots_until is not None and x.kind == "window_settled" and \
                x.seq >= roots_until:
            dx.pop("state_root"), dy.pop("state_root")
        assert dx == dy, f"\n{x}\n{y}"
    assert _blocks(a.chain) == _blocks(b.chain)
    assert a.chain.total_gas == b.chain.total_gas
    np.testing.assert_array_equal(_confirm(a.chain), _confirm(b.chain))
    ra, rb = a.rollup, b.rollup
    assert (ra is None) == (rb is None)
    if ra is None:
        return
    assert ra.gas_log == rb.gas_log
    assert ra.batch_digests == rb.batch_digests
    assert ra.update_digest == rb.update_digest
    assert ra.batch_commit_ref == rb.batch_commit_ref
    assert ra.batch_settle_ref == rb.batch_settle_ref
    assert ra._prov_starts == rb._prov_starts
    assert len(ra._prov_batches) == len(rb._prov_batches)
    for x, y in zip(ra._prov_batches, rb._prov_batches):
        np.testing.assert_array_equal(x, y)
    assert (ra.n_batches, ra._next_seq, ra._sealed_seq) == \
        (rb.n_batches, rb._next_seq, rb._sealed_seq)


def _first_settlement(node):
    """Records the event position at the node's first settlement (read
    live on the stepped path, which emits as it goes)."""
    mark = {}
    settle = node.settle_window

    def wrapped(rts):
        mark.setdefault("cursor", node.chain.events.next_cursor)
        return settle(rts)
    node.settle_window = wrapped
    return mark


@pytest.mark.parametrize("cfg", list(CONFIGS.values()), ids=list(CONFIGS))
def test_fused_scheduler_matches_stepped_and_jax(world, monkeypatch, cfg):
    monkeypatch.setattr(tcohort, "round_noise", jax_round_noise)
    monkeypatch.setattr(world["tm"], "init_params",
                        lambda seed: params_from_numpy(
                            world["jax_init"][seed], "cpu"))
    packs = []
    plain = bp.block_pack_torch
    monkeypatch.setattr(bp, "block_pack_torch",
                        lambda *a: packs.append(1) or plain(*a))
    ns, ss, rs, mark = _run_torch(world, False, **cfg)
    assert packs == []                   # stepped: no block_pack
    nf, sf, rf, _ = _run_torch(world, True, **cfg)
    assert packs == [1]                  # fused: one pack for the run
    nj, sj, rj = _run_jax(world, **cfg)

    # port fused == port stepped, bit for bit
    _assert_ledgers_equal(ns, nf)
    assert ns.state_arrays.root() == nf.state_arrays.root()
    assert [repr(x) for x in ss.window_records] == \
        [repr(x) for x in sf.window_records]
    assert [repr(x) for x in ss.settlement_records] == \
        [repr(x) for x in sf.settlement_records]
    assert ns.protocol_calls == nf.protocol_calls
    for t in rs:
        np.testing.assert_array_equal(rs[t].scores, rf[t].scores)
        np.testing.assert_array_equal(rs[t].reputations, rf[t].reputations)
        assert rs[t].payouts == rf[t].payouts
        for k, v in rs[t].global_params.items():
            assert torch.equal(v, rf[t].global_params[k]), (t, k)

    # port fused against the JAX package's fused loop
    # after the first settlement the reputations may differ in the last
    # bit, and so may the state roots that commit them
    _assert_ledgers_equal(nj, nf, roots_until=mark["cursor"])
    assert nf.protocol_calls == nj.protocol_calls
    assert len(sf.window_records) == len(sj.window_records)
    assert len(sf.settlement_records) == len(sj.settlement_records)
    assert sorted(rf) == sorted(rj)
    for t in rj:
        assert nf.tsc.tasks[t].trainers == nj.tsc.tasks[t].trainers
        np.testing.assert_array_equal(rf[t].scores, rj[t].scores)
        np.testing.assert_allclose(rf[t].reputations,
                                   np.asarray(rj[t].reputations), **TOL)
        assert sorted(rf[t].payouts) == sorted(rj[t].payouts)
        for who, pay in rj[t].payouts.items():
            np.testing.assert_allclose(rf[t].payouts[who], pay, **TOL)
        for k, leaf in rj[t].global_params.items():
            np.testing.assert_allclose(rf[t].global_params[k].numpy(),
                                       np.asarray(leaf), **TOL)


def test_fused_is_the_default_and_capabilities(world):
    node = AutoDFL(world["tm"], world["to"], len(BEHAVIORS),
                   world["tm"].accuracy_fn(), world["val_t"],
                   spec=_spec(pt), device="cpu")
    assert supports_fused(node.chain, node.rollup)
    assert "fused_window_loop" in node.client().capabilities()
    chain_only = pt.NodeClient.from_spec(pt.NodeSpec(rollup=None),
                                         device="cpu")
    assert "fused_window_loop" in chain_only.capabilities()

    # the sharded fabric runs fused too (tests/test_torch_fused_fabric.py);
    # the object faces do not
    fabric = pt.NodeClient.from_spec(pt.NodeSpec(
        shards=pt.ShardSpec(count=2)), device="cpu").target
    assert supports_fused(fabric.l1, fabric)
    obj = pt.NodeClient.from_spec(pt.NodeSpec(
        chain=pt.ChainSpec(backend="object")), device="cpu")
    assert not supports_fused(obj.chain, obj.target)
    with pytest.raises(ValueError, match="fused loop needs"):
        FusedWindowLoop(obj.chain, obj.target)
    loop = FusedWindowLoop(node.chain, node.rollup)
    with pytest.raises(ValueError, match="unknown fused submit target"):
        loop.submit(object(), None)


# -- the raw ledger: random window schedules -----------------------------------
def _traffic(rng, n_tasks, n_windows, max_txs):
    out, t = [], 0.0
    for _w in range(n_windows):
        row = []
        for _m in range(n_tasks):
            k = int(rng.integers(1, max_txs + 1))
            times = t + 0.01 * np.arange(1, k + 1)
            t = float(times[-1])
            row.append((times, rng.integers(21_000, 60_000, k),
                        rng.integers(0, 4, k), rng.integers(0, 64, k)))
        out.append(row)
    return out


_FNS = ("publishTask", "submitLocalModel", "calculateObjectiveRep",
        "updateReputation")


def _drive(chain, rollup, loop, traffic, seal_every, make):
    target = rollup if rollup is not None else chain
    face = loop if loop is not None else target
    t = 0.0
    for w, row in enumerate(traffic):
        for arrays in row:
            b = make(*arrays)
            loop.submit(target, b) if loop is not None \
                else target.submit_arrays(b)
        if rollup is not None and seal_every and (w + 1) % seal_every == 0:
            face.seal()
        t_end = max(t + 1.0, float(row[-1][0][-1]))
        if rollup is not None:
            face.pump(t_end)
        (loop or chain).run_until(t_end)
        t = t_end
    if rollup is not None:
        face.flush()
    (loop or chain).run_until(t + 3.0)
    if loop is not None:
        loop.execute()


class _Stack:
    def __init__(self, chain, rollup):
        self.chain, self.rollup = chain, rollup


def _torch_stack(use_rollup, n_lanes, batch_size):
    chain = VectorChain(device="cpu")
    rollup = (VectorRollup(chain, n_lanes=n_lanes, batch_size=batch_size,
                           agg_width=4, prover_capacity=2)
              if use_rollup else None)
    fns = chain.fns
    for f in _FNS:
        fns.id(f)
    return chain, rollup, lambda t, g, f, s: TxArrays.from_numpy(
        t, g, f, s, fns, "cpu")


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 8), st.integers(2, 8),
       st.sampled_from([1, 2, 4]), st.sampled_from([0, 1, 2, 3]),
       st.sampled_from([2, 4, 8]), st.booleans())
def test_fused_ledger_property(seed, n_tasks, n_windows, n_lanes,
                               seal_every, batch_size, use_rollup):
    """Random task/lane/prover/seal configurations: the fused replay leaves
    the ledger equal to the stepped calls it journals, and to the JAX
    package's stepped ledger on the same traffic."""
    traffic = _traffic(np.random.default_rng(seed), n_tasks, n_windows, 6)
    ca, ra, make = _torch_stack(use_rollup, n_lanes, batch_size)
    _drive(ca, ra, None, traffic, seal_every, make)
    cb, rb, make = _torch_stack(use_rollup, n_lanes, batch_size)
    _drive(cb, rb, FusedWindowLoop(cb, rb), traffic, seal_every, make)
    _assert_ledgers_equal(_Stack(ca, ra), _Stack(cb, rb))

    jfns = JaxFns()
    for f in _FNS:
        jfns.id(f)
    cj = JaxChain(fns=jfns)
    rj = (JaxRollup(cj, n_lanes=n_lanes, batch_size=batch_size,
                    agg_width=4, prover_capacity=2) if use_rollup else None)
    _drive(cj, rj, None, traffic, seal_every,
           lambda t, g, f, s: JaxTx(t, g.astype(np.int64),
                                    f.astype(np.int32), s.astype(np.int32),
                                    jfns))
    _assert_ledgers_equal(_Stack(cj, rj), _Stack(cb, rb))


def test_fused_loop_single_use():
    chain = VectorChain(device="cpu")
    loop = FusedWindowLoop(chain)
    loop.run_until(1.0)
    loop.execute()
    with pytest.raises(RuntimeError, match="already executed"):
        loop.execute()
    assert len(chain.blocks) == 2


def test_fused_adopts_preexisting_pending():
    """Txs staged on the rollup BEFORE the loop exists are covered by the
    loop's first planned seal, as a stepped seal would cover them; the JAX
    package's fused loop gives the same ledger."""
    def early_late(api_tx, fns, **kw):
        early = api_tx(np.array([0.01, 0.02]), np.array([30_000, 30_000]),
                       np.array([fns.id("publishTask")] * 2, np.int32),
                       np.array([0, 1], np.int32), fns, **kw)
        late = api_tx(np.array([0.5]), np.array([30_000]),
                      np.array([fns.id("publishTask")], np.int32),
                      np.array([2], np.int32), fns, **kw)
        return early, late

    def torch_tx(*a):
        return TxArrays.from_numpy(*a, "cpu")

    def build():
        chain = VectorChain(device="cpu")
        return chain, VectorRollup(chain, n_lanes=2, agg_width=4)

    ca, ra = build()
    early, late = early_late(torch_tx, ra.fns)
    ra.submit_arrays(early)
    ra.submit_arrays(late)
    ra.seal()
    ra.pump(2.0)
    ca.run_until(2.0)
    ra.flush()

    cb, rb = build()
    early, late = early_late(torch_tx, rb.fns)
    rb.submit_arrays(early)          # staged before the loop
    loop = FusedWindowLoop(cb, rb)
    assert loop.submit(rb, late) == (2, 3)
    loop.seal()
    loop.pump(2.0)
    loop.run_until(2.0)
    loop.flush()
    loop.execute()
    _assert_ledgers_equal(_Stack(ca, ra), _Stack(cb, rb))

    cj = JaxChain()
    rj = JaxRollup(cj, n_lanes=2, agg_width=4)
    early, late = early_late(JaxTx, rj.fns)
    rj.submit_arrays(early)
    jloop = JaxLoop(cj, rj)
    jloop.submit(rj, late)
    jloop.seal()
    jloop.pump(2.0)
    jloop.run_until(2.0)
    jloop.flush()
    jloop.execute()
    _assert_ledgers_equal(_Stack(cj, rj), _Stack(cb, rb))
