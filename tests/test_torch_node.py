"""The rollup node path on both packages: the port (repro_torch, on the
CPU) against the JAX package (repro), same workload, same calls.

Every integer output must be bit-identical: gas log, blocks, batch and
update digests, the typed event stream, receipts, accounts and the state
root after every window.  ``load_metrics`` latency is a float mean taken in
another summation order, held at rel 1e-12.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as jx
import repro_torch.api as pt
from repro.core.engine import TxArrays as JaxTxArrays
from repro.core.workloads import make_workload as jax_workload
from repro_torch.core.workloads import make_workload as torch_workload

torch.set_num_threads(1)

WINDOWS = 6
SCENARIOS = {
    "poisson": dict(rate=2000.0, n_senders=3000),
    "mixed": dict(rate=2000.0, n_senders=3000),
    "bursty": dict(rate=800.0, n_senders=3000, burst_start=2.0,
                   burst_len=2.0),
    "spam": dict(rate=600.0, n_senders=3000, spam_start=1.0,
                 spam_len=3.0),
}


def _specs(n_lanes, agg_width, finalize):
    out = []
    for api in (jx, pt):
        out.append(api.NodeSpec(
            chain=api.ChainSpec(),
            rollup=api.RollupSpec(n_lanes=n_lanes),
            prover=api.ProverSpec(agg_width=agg_width, finalize=finalize)))
    return out


def _events(client):
    return [(e.kind, dataclasses.asdict(e)) for e in client.events()]


def _receipt(r):
    d = dict(vars(r))                  # flat fields; gas_breakdown by value
    d.pop("tx", None)                  # the JAX object-path handle
    return d


def _blocks(chain):
    return [(b.height, b.time, b.n_txs, b.gas_used, b.start, b.stop,
             b.block_hash) for b in chain.blocks]


def _windows(times, n):
    return [tuple(int(i) for i in np.searchsorted(times, [w, w + 1.0]))
            for w in range(n)]


@pytest.mark.parametrize("finalize", ["eager", "window"])
@pytest.mark.parametrize("agg_width", [1, 8])
@pytest.mark.parametrize("n_lanes", [1, 2])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_node_path_matches_jax(scenario, n_lanes, agg_width, finalize):
    kw = dict(SCENARIOS[scenario])
    rate = kw.pop("rate")
    wj = jax_workload(scenario, rate, duration=float(WINDOWS), seed=7, **kw)
    wt = torch_workload(scenario, rate, duration=float(WINDOWS), seed=7,
                        device="cpu", **kw)
    assert 0 < len(wj) <= 20_000
    a, b = wj.txs, wt.txs
    np.testing.assert_array_equal(b.submit_time.numpy(), a.submit_time)
    np.testing.assert_array_equal(b.gas.numpy(), a.gas)
    np.testing.assert_array_equal(b.fn_id.numpy(), a.fn_id)
    np.testing.assert_array_equal(b.sender_id.numpy(), a.sender_id)
    assert b.fns.names == a.fns.names

    spec_j, spec_t = _specs(n_lanes, agg_width, finalize)
    cj = jx.NodeClient.from_spec(spec_j)
    ct = pt.NodeClient.from_spec(spec_t, device="cpu")
    assert ct.capabilities() == cj.capabilities() - {"fused_window_loop"}
    rj, rt = [], []
    for w, (lo, hi) in enumerate(_windows(a.submit_time, WINDOWS)):
        rj += cj.submit_arrays(JaxTxArrays(
            a.submit_time[lo:hi], a.gas[lo:hi], a.fn_id[lo:hi],
            a.sender_id[lo:hi], a.fns))
        rt += ct.submit_arrays(b.select(slice(lo, hi)))
        # named senders exercise the submit/get_account surface
        for c, out in ((cj, rj), (ct, rt)):
            out.append(c.submit("publishTask", f"pub{w % 3}", at=w + 0.5))
        assert cj.seal() == ct.seal()
        cj.run_until(w + 1.0)
        ct.run_until(w + 1.0)
        assert ct.state_root() == cj.state_root()
        assert _events(ct) == _events(cj)
    for c in (cj, ct):
        c.flush()
        c.run_until(WINDOWS + 60.0)
    assert _events(ct) == _events(cj)

    ru_j, ru_t = cj.target, ct.target
    assert ru_t.gas_log == ru_j.gas_log
    assert ru_t.batch_digests == ru_j.batch_digests
    assert ru_t.update_digest == ru_j.update_digest
    assert _blocks(ct.chain) == _blocks(cj.chain)
    assert ct.chain.total_gas == cj.chain.total_gas
    assert ct.state_root() == cj.state_root()
    got = [_receipt(ct.refresh(r)) for r in rt]
    want = [_receipt(cj.refresh(r)) for r in rj]
    assert got == want
    assert {r["status"] for r in got} == {"finalized"}
    for addr in ("pub0", "pub1", "pub2", "nobody"):
        assert dataclasses.asdict(ct.get_account(addr)) == \
            dataclasses.asdict(cj.get_account(addr))
    mj = cj.chain.load_metrics(len(wj) / WINDOWS, float(WINDOWS))
    mt = ct.chain.load_metrics(len(wj) / WINDOWS, float(WINDOWS))
    assert mt.pop("latency") == pytest.approx(mj.pop("latency"), rel=1e-12)
    assert mt == mj


def test_chain_only_node_matches_jax():
    """NodeSpec(rollup=None): receipts walk pending -> confirmed."""
    wj = jax_workload("poisson", 300.0, duration=4.0, seed=3)
    wt = torch_workload("poisson", 300.0, duration=4.0, seed=3,
                        device="cpu")
    cj = jx.NodeClient.from_spec(jx.NodeSpec(rollup=None))
    ct = pt.NodeClient.from_spec(pt.NodeSpec(rollup=None), device="cpu")
    rj, rt = cj.submit_arrays(wj.txs), ct.submit_arrays(wt.txs)
    rj.append(cj.submit("submitLocalModel", "t0", at=4.5))
    rt.append(ct.submit("submitLocalModel", "t0", at=4.5))
    for c in (cj, ct):
        c.run_until(10.0)
    assert _events(ct) == _events(cj)
    assert [_receipt(ct.refresh(r)) for r in rt] == \
        [_receipt(cj.refresh(r)) for r in rj]
    assert _blocks(ct.chain) == _blocks(cj.chain)
    assert ct.state_root() == cj.state_root()


def test_events_page_and_cursor_match_jax():
    spec_j, spec_t = _specs(2, 1, "eager")
    cj = jx.NodeClient.from_spec(spec_j)
    ct = pt.NodeClient.from_spec(spec_t, device="cpu")
    for c in (cj, ct):
        for i in range(45):
            c.submit("submitLocalModel", f"t{i % 5}", at=0.02 * i)
        c.flush()
        c.run_until(5.0)
    for cursor, limit in ((0, None), (3, 4), (10, 100)):
        ej, nj, dj = cj.events_page(cursor, limit=limit)
        et, nt, dt = ct.events_page(cursor, limit=limit)
        assert (nt, dt) == (nj, dj)
        assert [dataclasses.asdict(e) for e in et] == \
            [dataclasses.asdict(e) for e in ej]
    assert [e.kind for e in ct.events(kinds={"aggregate_verified"})] == \
        [e.kind for e in cj.events(kinds={"aggregate_verified"})]


def test_object_tx_shims_callbacks_and_models_match_jax():
    """The LedgerBackend surface beyond the node client: object ``Tx``
    submission, batch handlers, legacy callbacks and the latency/TPS
    models, on both faces of both packages."""
    from repro.core.engine import VectorChain as JaxChain
    from repro.core.engine import VectorRollup as JaxRollup
    from repro.core.state import default_state_handlers as jax_handlers
    from repro_torch.core.engine import VectorChain, VectorRollup
    from repro_torch.core.state import default_state_handlers

    wj = jax_workload("mixed", 200.0, duration=3.0, seed=5)
    wt = torch_workload("mixed", 200.0, duration=3.0, seed=5, device="cpu")
    seen = {"jax": [], "torch": []}
    faces = {}
    for key, chain_cls, ru_cls, handlers, wl in (
            ("jax", JaxChain, JaxRollup, jax_handlers, wj),
            ("torch", lambda: VectorChain(device="cpu"), VectorRollup,
             default_state_handlers, wt)):
        chain = chain_cls()
        chain.register_batch("rollup_commit",
                             lambda st, n, view, k=key: seen[k].append(
                                 ("batch", n, len(view))))
        ru = ru_cls(chain, n_lanes=2, agg_width=2)
        for fn, h in handlers().items():
            ru.register_state(fn, h)
        for event in ("batch_sealed", "session_settled"):
            ru.subscribe(event, lambda p, k=key, e=event: seen[k].append(
                (e, {x: (list(v) if isinstance(v, list) else v)
                     for x, v in p.items()})))
        for tx in wl.to_txs():
            ru.submit(tx)
        ru.seal()
        chain.run_until(4.0)
        ru.flush()
        chain.run_until(30.0)
        faces[key] = (chain, ru)
    (cj, rj), (ct, rt) = faces["jax"], faces["torch"]
    assert seen["torch"] == seen["jax"] and seen["jax"]
    assert rt.gas_log == rj.gas_log
    assert rt.state_root() == rj.state_root()
    assert _blocks(ct) == _blocks(cj)
    for n in (1, 19, 20, 41, 1000):
        assert rt.latency(n) == rj.latency(n)
    assert rt.throughput(150.0) == rj.throughput(150.0)


def test_workload_spec_builds_the_same_batch():
    spec_t = pt.WorkloadSpec.make("spam", 300.0, duration=4.0, seed=2,
                                  n_spammers=3)
    spec_j = jx.WorkloadSpec.make("spam", 300.0, duration=4.0, seed=2,
                                  n_spammers=3)
    wt, wj = spec_t.build(device="cpu"), spec_j.build()
    assert wt.meta == wj.meta and len(wt) == len(wj)
    np.testing.assert_array_equal(wt.txs.sender_id.numpy(), wj.txs.sender_id)
    node_t = pt.NodeSpec(workload=spec_t)
    node_j = jx.NodeSpec(workload=spec_j)
    want = node_j.describe()
    want.pop("shards")                  # the sharded fabric is not ported
    assert node_t.describe() == want
    tasks = (pt.FLTaskSpec("t0", rounds=2), pt.FLTaskSpec("t1", reward=3.0))
    full_t = pt.NodeSpec(n_trainers=8, trainer_funds=7.0, seed=3,
                         reputation=pt.ReputationSpec(theta=0.3),
                         don=pt.DONSpec(n_oracles=3), tasks=tasks)
    full_j = jx.NodeSpec(n_trainers=8, trainer_funds=7.0, seed=3,
                         reputation=jx.ReputationSpec(theta=0.3),
                         don=jx.DONSpec(n_oracles=3),
                         tasks=tuple(jx.FLTaskSpec(**dataclasses.asdict(t))
                                     for t in tasks))
    want = full_j.describe()
    want.pop("shards")
    assert full_t.describe() == want
