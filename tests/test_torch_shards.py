"""The port's sharded rollup fabric (core/shards.py) against the JAX
package's, on the CPU (the cases of tests/test_shards.py).

  * Through ``NodeClient`` on ``NodeSpec(shards=ShardSpec(...))`` at K of
    1, 2, 4 and 8 with routes ``hash`` and ``least_loaded``: gas logs,
    batch and update digests, ``fabric_roots``, ``partition_roots``, state
    roots, blocks, the interconnect's log and summary, ``latency``, typed
    events, receipts and accounts, bit for bit; ``assign_task`` and pinned
    routing the same.
  * One shard == ``VectorRollup``; the state root does not depend on K;
    incremental partition roots equal full ones after the state grows.
  * ``AutoDFL`` on a fabric, stepped per task through the Scheduler,
    against the JAX package with its initial parameters and noise handed
    to the port: the ledger exactly (roots up to the first settlement),
    selections and DON scores exactly, parameters, reputations and payouts
    within rtol 1e-5 / atol 1e-6 (tests/test_torch_fl_protocol.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as jx
import repro_torch.api as pt
from repro.core.engine import TxArrays as JaxTx
from repro.core.state import StateArrays as JaxState
from repro.core.workloads import make_workload as jax_workload
from repro_torch.core.engine import VectorChain, VectorRollup
from repro_torch.core.ledger import LedgerBackend
from repro_torch.core.shards import ShardedRollup, _hash_route
from repro_torch.core.state import StateArrays, default_state_handlers
from repro_torch.core.workloads import make_workload as torch_workload
from repro_torch.fl import cohort as tcohort
from repro_torch.fl.dp import DPConfig
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from test_torch_fused_fabric import (BEHAVIORS, LOCAL_STEPS, N_TASKS, TOL,
                                     _events, _tasks, _wire_by_kind,
                                     inject, world)  # noqa: F401

torch.set_num_threads(1)

GAS_KEYS = ("n_txs", "commit", "verify", "execute", "total")
WINDOWS = 6


def _receipt(r):
    d = dict(vars(r))
    d.pop("tx", None)
    return d


def _blocks(chain):
    return [(b.height, b.time, b.n_txs, b.gas_used, b.start, b.stop,
             b.block_hash) for b in chain.blocks]


def _fabric_spec(api, k, route, **kw):
    return api.NodeSpec(shards=api.ShardSpec(count=k, route=route,
                                             fabric=True), **kw)


def _windows(times, n):
    return [tuple(int(i) for i in np.searchsorted(times, [w, w + 1.0]))
            for w in range(n)]


@pytest.mark.parametrize("route", ["hash", "least_loaded"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_fabric_node_matches_jax(k, route):
    wj = jax_workload("mixed", 400.0, duration=float(WINDOWS), seed=11,
                      n_senders=500)
    wt = torch_workload("mixed", 400.0, duration=float(WINDOWS), seed=11,
                        n_senders=500, device="cpu")
    a, b = wj.txs, wt.txs
    cj = jx.NodeClient.from_spec(_fabric_spec(jx, k, route))
    ct = pt.NodeClient.from_spec(_fabric_spec(pt, k, route), device="cpu")
    assert isinstance(ct.target, ShardedRollup)
    assert ct.capabilities() == cj.capabilities()
    rj, rt = [], []
    for w, (lo, hi) in enumerate(_windows(a.submit_time, WINDOWS)):
        rj += cj.submit_arrays(JaxTx(
            a.submit_time[lo:hi], a.gas[lo:hi], a.fn_id[lo:hi],
            a.sender_id[lo:hi], a.fns))
        rt += ct.submit_arrays(b.select(slice(lo, hi)))
        for c, out in ((cj, rj), (ct, rt)):
            out.append(c.submit("publishTask", f"pub{w % 3}", at=w + 0.5))
        assert cj.seal() == ct.seal()
        cj.run_until(w + 1.0)
        ct.run_until(w + 1.0)
        assert ct.state_root() == cj.state_root()
        assert [dataclasses.asdict(e) for e in ct.events()] == \
            [dataclasses.asdict(e) for e in cj.events()]
    for c in (cj, ct):
        c.flush()
        c.run_until(WINDOWS + 60.0)
    fj, ft = cj.target, ct.target
    assert ft.gas_log == fj.gas_log
    assert all(r["shard"] < k for r in ft.gas_log)
    assert sum(r["n_txs"] for r in ft.gas_log) == len(wj) + WINDOWS
    assert ft.batch_digests == fj.batch_digests
    assert ft.update_digest == fj.update_digest
    assert ft.n_batches == fj.n_batches
    assert ft.fabric_roots == fj.fabric_roots
    assert ft.fabric_root() == fj.fabric_root()
    assert ft.state.partition_roots(k) == fj.state.partition_roots(k)
    assert [ft.state.partition_root(s, k) for s in range(k)] == \
        fj.state.partition_roots(k)
    assert ft.state_root() == fj.state_root()
    assert _blocks(ct.chain) == _blocks(cj.chain)
    assert ct.chain.total_gas == cj.chain.total_gas
    np.testing.assert_array_equal(ft._submitted, fj._submitted)
    assert ft.interconnect.log == fj.interconnect.log
    assert ft.interconnect.summary() == fj.interconnect.summary()
    assert ft.latency(len(wj)) == fj.latency(len(wj))
    assert ft.sealed_batch_throughput(len(wj)) == \
        fj.sealed_batch_throughput(len(wj))
    assert ft.throughput(10.0) == fj.throughput(10.0)
    got = [_receipt(ct.refresh(r)) for r in rt]
    want = [_receipt(cj.refresh(r)) for r in rj]
    assert got == want
    assert {r["status"] for r in got} == {"finalized"}
    for addr in ("pub0", "pub2", "nobody"):
        assert dataclasses.asdict(ct.get_account(addr)) == \
            dataclasses.asdict(cj.get_account(addr))
    tasks = [f"task{i}" for i in range(10)]
    assert [ft.assign_task(t) for t in tasks] == \
        [fj.assign_task(t) for t in tasks]
    assert ft.assign_task("task3") == fj.assign_task("task3")


def test_fabric_is_a_ledger_backend_and_spec_checks():
    chain = VectorChain(device="cpu")
    fab = ShardedRollup(chain, n_shards=2)
    assert isinstance(fab, LedgerBackend)
    for bad in (dict(count=0), dict(route="random"), dict(mesh="maybe")):
        with pytest.raises(ValueError):
            pt.ShardSpec(**bad)
    with pytest.raises(ValueError, match="RollupSpec"):
        pt.NodeSpec(rollup=None, shards=pt.ShardSpec(count=2))
    with pytest.raises(ValueError, match="vector"):
        pt.NodeSpec(chain=pt.ChainSpec(backend="object"),
                    shards=pt.ShardSpec(count=2))
    assert not pt.ShardSpec().wants_fabric
    assert pt.ShardSpec(fabric=True).wants_fabric
    spec_t = pt.NodeSpec(shards=pt.ShardSpec(count=8, route="least_loaded"))
    spec_j = jx.NodeSpec(shards=jx.ShardSpec(count=8, route="least_loaded"))
    assert spec_t.describe() == spec_j.describe()
    one = pt.NodeClient.from_spec(pt.NodeSpec(shards=pt.ShardSpec(count=1)),
                                  device="cpu")
    assert type(one.target) is VectorRollup
    legacy = pt.NodeSpec.from_legacy(engine="vector", n_shards=4,
                                     shard_route="least_loaded")
    assert legacy.describe() == jx.NodeSpec.from_legacy(
        engine="vector", n_shards=4, shard_route="least_loaded").describe()


def _mk(k, route="hash", **kw):
    chain = VectorChain(device="cpu")
    fab = ShardedRollup(chain, n_shards=k, route=route, **kw)
    for fn, h in default_state_handlers().items():
        fab.register_state(fn, h)
    return chain, fab


def test_single_shard_fabric_equals_vector_rollup():
    wl = torch_workload("mixed", 300.0, duration=10.0, seed=5, device="cpu")
    chain, fab = _mk(1)
    fab.submit_arrays(wl.txs)
    fab.flush()
    chain.run_until(15.0)
    base_chain = VectorChain(device="cpu")
    base = VectorRollup(base_chain)
    base.submit_arrays(wl.txs)
    base.flush()
    base_chain.run_until(15.0)
    assert [tuple(r[k] for k in GAS_KEYS) for r in fab.gas_log] == \
        [tuple(r[k] for k in GAS_KEYS) for r in base.gas_log]
    assert all(r["shard"] == 0 for r in fab.gas_log)
    assert chain.total_gas == base_chain.total_gas
    assert torch.equal(chain.confirm_times(), base_chain.confirm_times())
    assert fab.update_digest == base.update_digest
    assert fab.batch_digests == base.batch_digests


@pytest.mark.parametrize("route", ["hash", "least_loaded"])
def test_state_root_invariant_across_shard_counts(route):
    wl = torch_workload("mixed", 400.0, duration=8.0, seed=11, device="cpu")

    def run(k):
        chain, fab = _mk(k, route)
        fab.submit_arrays(wl.txs)
        fab.flush()
        chain.run_until(12.0)
        # every submitted tx sealed in exactly one shard
        assert sum(r["n_txs"] for r in fab.gas_log) == len(wl)
        return fab

    roots = {k: run(k).state_root() for k in (1, 2, 4, 8)}
    assert len(set(roots.values())) == 1, roots
    a, b = run(4), run(4)
    assert (a.state_root(), a.fabric_root()) == \
        (b.state_root(), b.fabric_root())
    assert run(2).fabric_root() != run(4).fabric_root()


def test_fabric_roots_at_seal_windows_and_subscribe():
    chain, fab = _mk(2)
    seen = {"window_settled": [], "batch_sealed": []}
    for kind, out in seen.items():
        fab.subscribe(kind, out.append)
    wl = torch_workload("poisson", 100.0, duration=4.0, seed=1, device="cpu")
    fab.submit_arrays(wl.txs)
    fab.seal()
    fab.seal()                      # an empty window still commits
    fab.flush()
    assert len(fab.fabric_roots) == 3
    assert fab.fabric_roots[0]["fabric_root"] == \
        fab.fabric_roots[1]["fabric_root"]
    assert [r["window"] for r in fab.fabric_roots] == [0, 1, 2]
    assert seen["window_settled"] == fab.fabric_roots
    assert sorted({p["shard"] for p in seen["batch_sealed"]}) == [0, 1]


def test_routing_matches_jax():
    wj = jax_workload("poisson", 200.0, duration=5.0, seed=3)
    wt = torch_workload("poisson", 200.0, duration=5.0, seed=3,
                        device="cpu")
    sid = np.arange(1000, dtype=np.int32)
    from repro.core.shards import _hash_route as jax_route
    np.testing.assert_array_equal(
        _hash_route(torch.from_numpy(sid), 8).numpy(), jax_route(sid, 8))
    # least-loaded: three submissions spread over three emptiest shards
    from repro.core.engine import VectorChain as JaxChain
    from repro.core.shards import ShardedRollup as JaxFabric
    tf = ShardedRollup(VectorChain(device="cpu"), n_shards=4,
                       route="least_loaded")
    jf = JaxFabric(JaxChain(), n_shards=4, route="least_loaded")
    n = len(wj)
    for lo, hi in ((0, n // 3), (n // 3, 2 * n // 3), (2 * n // 3, n)):
        st, qt = tf.submit_arrays(wt.txs.select(slice(lo, hi)))
        sj, qj = jf.submit_arrays(JaxTx(
            wj.txs.submit_time[lo:hi], wj.txs.gas[lo:hi],
            wj.txs.fn_id[lo:hi], wj.txs.sender_id[lo:hi], wj.txs.fns))
        np.testing.assert_array_equal(st.numpy(), sj)
        np.testing.assert_array_equal(qt.numpy(), qj)
    assert [s._pending_n for s in tf.shards] == \
        [s._pending_n for s in jf.shards]
    assert sorted(s._pending_n > 0 for s in tf.shards) == \
        [False, True, True, True]
    # a pin overrides the route
    tp = ShardedRollup(VectorChain(device="cpu"), n_shards=4)
    shard_of, seq_of = tp.submit_arrays(wt.txs, shard=2)
    assert tp.shards[2]._pending_n == len(wt)
    assert set(shard_of.tolist()) == {2}
    assert seq_of.tolist() == list(range(len(wt)))
    assert all(tp.shards[k]._pending_n == 0 for k in (0, 1, 3))
    # hash routing keeps arrival order within a shard
    th = ShardedRollup(VectorChain(device="cpu"), n_shards=4)
    shard_of, seq_of = th.submit_arrays(wt.txs)
    for k, s in enumerate(th.shards):
        mine = (shard_of == k).nonzero().reshape(-1)
        assert seq_of[mine].tolist() == list(range(len(mine)))
        assert torch.equal(s._pending[0].submit_time,
                           wt.txs.submit_time[mine])


def test_latency_reflects_routing_skew():
    wt = torch_workload("poisson", 100.0, duration=5.0, seed=13,
                        device="cpu")
    balanced = ShardedRollup(VectorChain(device="cpu"), n_shards=8)
    balanced.submit_arrays(wt.txs)
    skewed = ShardedRollup(VectorChain(device="cpu"), n_shards=8)
    skewed.submit_arrays(wt.txs, shard=0)
    single = ShardedRollup(VectorChain(device="cpu"), n_shards=1)
    single.submit_arrays(wt.txs)
    n = len(wt)
    assert skewed.latency(n) == single.latency(n)
    assert balanced.latency(n) < skewed.latency(n)
    assert skewed.sealed_batch_throughput(n) == \
        pytest.approx(single.sealed_batch_throughput(n))
    fresh = ShardedRollup(VectorChain(device="cpu"), n_shards=8)
    from repro.core.engine import VectorChain as JaxChain
    from repro.core.shards import ShardedRollup as JaxFabric
    assert fresh.latency(n) == JaxFabric(JaxChain(), n_shards=8).latency(n)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_incremental_partition_roots_equal_full_after_growth(k):
    """Tracked partition roots (cached words, dirty chunks refolded)
    equal a full refold and the JAX package's, across writes and growth
    (growth drops the caches)."""
    g = np.random.default_rng(k)
    tracked = StateArrays(device="cpu")
    tracked.enable_dirty_tracking()
    ref = JaxState()

    def write(n_rows, ids):
        tracked.ensure(n_rows)
        ref.ensure(n_rows)
        vals = g.normal(size=ids.size)
        for st, conv in ((tracked, torch.from_numpy), (ref, np.asarray)):
            st.balances[conv(ids)] = conv(vals)
            st.submissions[conv(ids)] += 1
        tracked.mark_dirty(torch.from_numpy(ids))

    def full():
        out = StateArrays.from_numpy(tracked.to_numpy(), device="cpu")
        return out.partition_roots(k), out.root()

    for n_rows, writes in ((100, 30), (100, 5), (3000, 200), (3000, 1),
                           (70_000, 900), (70_000, 40)):
        write(n_rows, g.integers(0, n_rows, writes))
        got = tracked.partition_roots(k), tracked.root()
        assert got == full()
        assert got == (ref.partition_roots(k), ref.root())
    assert ("part", k, 2048) in tracked._commit_caches
    tracked.ensure(80_000)
    assert not tracked._commit_caches


# -- AutoDFL on a fabric, stepped, against the JAX package --------------------
def _run_jax(w, k):
    from repro.fl.cohort import CohortKernels as JaxKernels
    from repro.fl.cohort import VectorCohort as JaxCohort
    from repro.fl.dp import DPConfig as JaxDP
    from repro.fl.scheduler import Scheduler as JaxScheduler
    from repro.fl.server import AutoDFL as JaxNode
    node = JaxNode(w["jm"], w["jo"], len(BEHAVIORS), w["jm"].accuracy_fn(),
                   w["val_j"], spec=_fabric_spec(jx, k, "hash",
                                                 trainer_funds=50.0))
    kern = JaxKernels(w["jm"], w["jo"], JaxDP(noise_multiplier=0.05))
    sch = JaxScheduler(node, seal_every=2, fused=False, megabatch=False)
    for t, spec in enumerate(_tasks(jx)):
        sch.add_task(spec, JaxCohort(
            w["jm"], w["jo"], w["jax_bf"], node.store, behaviors=BEHAVIORS,
            local_steps=LOCAL_STEPS, dp=JaxDP(noise_multiplier=0.05), seed=t,
            kernels=kern))
    return node, sch, sch.run()


def _run_torch(w, k):
    node = AutoDFL(w["tm"], w["to"], len(BEHAVIORS), w["tm"].accuracy_fn(),
                   w["val_t"], spec=_fabric_spec(pt, k, "hash",
                                                 trainer_funds=50.0),
                   device="cpu")
    mark = {}
    settle = node.settle_window

    def watched(rts):
        mark.setdefault("cursor", node.chain.events.next_cursor)
        return settle(rts)
    node.settle_window = watched
    kern = tcohort.CohortKernels(w["tm"], w["to"],
                                 DPConfig(noise_multiplier=0.05))
    sch = Scheduler(node, seal_every=2, fused=False, megabatch=False)
    for t, spec in enumerate(_tasks(pt)):
        sch.add_task(spec, tcohort.VectorCohort(
            w["tm"], w["to"], w["torch_bf"], node.store, behaviors=BEHAVIORS,
            local_steps=LOCAL_STEPS, dp=DPConfig(noise_multiplier=0.05),
            seed=t, kernels=kern, device="cpu"))
    return node, sch, sch.run(), mark


@pytest.mark.parametrize("k", [1, 2, 4])
def test_autodfl_fabric_stepped_matches_jax(world, inject, k):
    nt, st, ot, mark = _run_torch(world, k)
    nj, sj, oj = _run_jax(world, k)
    assert isinstance(nt.rollup, ShardedRollup)
    assert nt.state_arrays is nt.rollup.state
    assert {rt.task_id: rt.shard for rt in st.runtimes} == \
        {rt.task_id: rt.shard for rt in sj.runtimes}
    assert len(st.runtimes) == N_TASKS
    assert nt.protocol_calls == nj.protocol_calls
    assert nt.rollup.gas_log == nj.rollup.gas_log
    assert nt.rollup.batch_digests == nj.rollup.batch_digests
    assert nt.chain.total_gas == nj.chain.total_gas
    assert _blocks(nt.chain) == _blocks(nj.chain)
    assert nt.rollup.interconnect.log == nj.rollup.interconnect.log
    assert _wire_by_kind(nt.rollup.interconnect)["settle_scatter"]
    cursor = mark["cursor"]
    assert _events(nt, cursor) == _events(nj, cursor)
    # window roots up to the first settlement: bit for bit
    early = [r for r, e in zip(nt.rollup.fabric_roots,
                               [e for e in nt.client().events(cursor=0)
                                if e.kind == "window_settled"])
             if e.seq < cursor]
    assert early == nj.rollup.fabric_roots[:len(early)]
    for t, rj in oj.items():
        rt = ot[t]
        assert nt.tsc.tasks[t].trainers == nj.tsc.tasks[t].trainers
        np.testing.assert_array_equal(rt.scores, rj.scores)
        np.testing.assert_allclose(rt.reputations,
                                   np.asarray(rj.reputations), **TOL)
        for who, pay in rj.payouts.items():
            np.testing.assert_allclose(rt.payouts[who], pay, **TOL)
        for key, leaf in rj.global_params.items():
            np.testing.assert_allclose(rt.global_params[key].numpy(),
                                       np.asarray(leaf), **TOL)
    # the settlement synced the book into the fabric state; the final
    # root commits the port's own fields
    ids = [nt._target().sender_id(t) for t in nt.trainer_ids]
    np.testing.assert_array_equal(nt.state_arrays.reputation[ids].numpy(),
                                  nt.book.reputation.numpy())
    again = StateArrays.from_numpy(nt.state_arrays.to_numpy(), device="cpu")
    assert again.root() == nt.state_arrays.root()
    assert again.partition_roots(k) == nt.rollup.state.partition_roots(k)
