"""The port's node service (repro_torch/serve) against the JAX package's,
on the CPU.

Every case of tests/test_serve.py, against the port:

  * each admission rule rejects for ITS reason and only in the ladder
    order (fee floor -> reputation gate -> token bucket -> pool cap), with
    lowest-fee-first eviction under a strict fee comparison;
  * the bounded ``EventLog`` ring and ``NodeClient``'s cursor modes;
  * N async clients racing into ``NodeService`` give the state root and L1
    gas of ``replay_ops`` replaying the op log serially, on the vector and
    the 2-shard fabric backends; rejected transactions never reach the op
    log; a full writer queue is an explicit ``overloaded`` reply; the HTTP
    face round-trips and answers 429.

Then the port against the JAX package, bit for bit (a payload-free ledger
path, hashes included):

  * the same scripted submissions through both services, on the vector
    and the 2-shard fabric backends: the admission log, the op log, every
    ref's receipt, the event stream, the state root and the L1 gas;
  * ``benchmarks/bench_serve.py``'s spam drive (one asyncio client a
    sender, lockstep windows) at its quick mode, not cut (200 honest
    senders at 60 tx/s, 8 spammers at 240 tx/s, 15 s, pool cap 128; about
    a second a package here): the admission counters, the committed
    transactions by sender, the state root, the L1 gas and the honest
    retention;
  * ``launch.serve_node.main`` boots on the CPU on an ephemeral port.

Nothing the service hands to ``json.dumps`` is a tensor.
"""
import asyncio
import dataclasses
import importlib
import sys

import numpy as np
import pytest
import torch

import repro.api as jx
import repro.serve as jserve
import repro_torch.api as pt
from repro.core.workloads import adversarial_spam_workload as jax_spam
from repro_torch.api import AdmissionSpec, NodeClient, NodeSpec, ServeSpec
from repro_torch.core.events import BlockPacked, EventLog, EventsDropped
from repro_torch.core.reputation import ReputationParams
from repro_torch.core.workloads import adversarial_spam_workload
from repro_torch.launch import serve_node
from repro_torch.serve import (AdmissionController, HttpNodeServer,
                               NodeService, PendingPool, http_rpc,
                               replay_ops)

torch.set_num_threads(1)

CPU = "cpu"
REP = ReputationParams()          # r_min=0.4, r_init=0.5
OK_REP = 0.9                      # comfortably above the trust line
LOW_REP = 0.1                     # below r_min


def _ctrl(**kw):
    return AdmissionController(AdmissionSpec(**kw), REP)


def _admit(ctrl, ref, *, fee=100, at=0.0, sender="a", rep=OK_REP,
           intrinsic=100, fn="submitLocalModel"):
    return ctrl.admit(ref=ref, fn=fn, sender=sender, fee=fee,
                      intrinsic=intrinsic, at=at, reputation=rep)


# -- admission rules, one by one ------------------------------------------------

def test_fee_floor_rejects_below_and_admits_at():
    c = _ctrl(fee_floor=50)
    assert _admit(c, 0, fee=49).reason == "fee_floor"
    assert _admit(c, 1, fee=50).admitted
    assert c.rejected["fee_floor"] == 1 and c.n_admitted == 1


def test_rep_gate_reject_mode():
    c = _ctrl(rep_gate="reject")
    assert _admit(c, 0, rep=LOW_REP).reason == "reputation"
    assert _admit(c, 1, rep=REP.r_min).admitted       # at the line is in
    assert _admit(c, 2, rep=REP.r_init).admitted      # newcomer prior is in


def test_rep_gate_surcharge_mode():
    c = _ctrl(rep_gate="surcharge", rep_surcharge=1.5)
    assert _admit(c, 0, rep=LOW_REP, fee=100, intrinsic=100).reason \
        == "surcharge"
    d = _admit(c, 1, rep=LOW_REP, fee=150, intrinsic=100)
    assert d.admitted
    assert c.pool.entries[1].fee == 150
    assert _admit(c, 2, rep=OK_REP, fee=100, intrinsic=100).admitted


def test_rep_gate_off_ignores_reputation():
    c = _ctrl(rep_gate="off")
    assert _admit(c, 0, rep=0.0).admitted


def test_token_bucket_refills_on_modeled_time():
    c = _ctrl(rate_limit=1.0, burst=2.0)
    assert _admit(c, 0, at=0.0).admitted
    assert _admit(c, 1, at=0.0).admitted
    assert _admit(c, 2, at=0.0).reason == "rate_limited"   # bucket empty
    assert _admit(c, 3, at=0.0, sender="b").admitted
    assert _admit(c, 4, at=1.0).admitted
    assert _admit(c, 5, at=1.0).reason == "rate_limited"
    assert c.rejected["rate_limited"] == 2


def test_pool_cap_evicts_lowest_fee_on_strictly_higher_offer():
    c = _ctrl(pool_cap=2, burst=100.0)
    _admit(c, 0, fee=10)
    _admit(c, 1, fee=20)
    assert _admit(c, 2, fee=10).reason == "overloaded"
    d = _admit(c, 3, fee=15)                    # strictly beats fee=10
    assert d.admitted and d.evicted == 0
    assert set(c.pool.entries) == {1, 3}
    assert c.n_evicted == 1


def test_pool_cap_without_eviction_is_overloaded():
    c = _ctrl(pool_cap=1, evict=False, burst=100.0)
    assert _admit(c, 0, fee=10).admitted
    assert _admit(c, 1, fee=99).reason == "overloaded"
    assert c.rejected["overloaded"] == 1


def test_pool_drains_in_modeled_time_order():
    pool = PendingPool(cap=10)
    c = AdmissionController(AdmissionSpec(burst=100.0), REP, pool=pool)
    _admit(c, 0, at=2.0)
    _admit(c, 1, at=1.0)
    _admit(c, 2, at=1.0)
    drained = pool.drain()
    assert [(e.at, e.ref) for e in drained] == [(1.0, 1), (1.0, 2), (2.0, 0)]
    assert len(pool) == 0 and pool.cheapest_fee() is None


def test_counters_cover_every_decision():
    c = _ctrl(fee_floor=50, rate_limit=1.0, burst=1.0)
    _admit(c, 0, fee=10)                        # fee_floor
    _admit(c, 1, at=0.0)                        # admitted
    _admit(c, 2, at=0.0)                        # rate_limited
    got = c.counters()
    assert got["admitted"] == 1
    assert got["rejected_fee_floor"] == 1
    assert got["rejected_rate_limited"] == 1
    assert len(c.log) == 3


@pytest.mark.parametrize("bad", [
    dict(rate_limit=0.0), dict(burst=0.5), dict(rep_gate="maybe"),
    dict(rep_surcharge=0.9), dict(pool_cap=0)])
def test_admission_spec_refuses_what_the_jax_spec_refuses(bad):
    with pytest.raises(ValueError) as err:
        AdmissionSpec(**bad)
    with pytest.raises(ValueError) as ref:
        jx.AdmissionSpec(**bad)
    assert str(err.value) == str(ref.value)


@pytest.mark.parametrize("bad", [
    dict(queue_cap=0), dict(window=0.0), dict(event_cap=0)])
def test_serve_spec_refuses_what_the_jax_spec_refuses(bad):
    with pytest.raises(ValueError) as err:
        ServeSpec(**bad)
    with pytest.raises(ValueError) as ref:
        jx.ServeSpec(**bad)
    assert str(err.value) == str(ref.value)
    assert dataclasses.asdict(ServeSpec()) == dataclasses.asdict(
        jx.ServeSpec())


# -- the bounded event ring -----------------------------------------------------

def _packed(log, i):
    return log.emit(BlockPacked, time=float(i), height=i, n_txs=1,
                    gas_used=10, block_hash=f"h{i}")


def test_ring_evicts_oldest_and_keeps_absolute_seq():
    log = EventLog(cap=3)
    for i in range(5):
        _packed(log, i)
    assert log.base == 2 and log.n_dropped == 2
    assert log.next_cursor == 5
    assert [e.seq for e in log.since(2)] == [2, 3, 4]
    assert log.dropped(0) == 2 and log.dropped(2) == 0


def test_stale_cursor_gets_an_explicit_marker():
    log = EventLog(cap=2)
    for i in range(4):
        _packed(log, i)
    got = log.since(0)
    assert isinstance(got[0], EventsDropped)
    assert got[0].kind == "events_dropped"
    assert got[0].n_dropped == 2 and got[0].resume_cursor == 2
    assert [e.seq for e in got[1:]] == [2, 3]
    assert not isinstance(log.since(2)[0], EventsDropped)


def test_unbounded_log_keeps_seed_semantics():
    log = EventLog()
    for i in range(4):
        _packed(log, i)
    assert log.base == 0 and log.dropped(0) == 0
    assert [e.seq for e in log.since(0)] == [0, 1, 2, 3]
    assert log.since(4) == []


def test_cap_settable_after_construction():
    log = EventLog()
    for i in range(5):
        _packed(log, i)
    log.cap = 2
    _packed(log, 5)
    assert log.base == 4 and len(log.since(4)) == 2


# -- NodeClient cursor modes ----------------------------------------------------

def _small_client():
    c = NodeClient.from_spec(NodeSpec(), device=CPU)
    for i in range(4):
        c.submit("submitLocalModel", f"u{i}", at=0.1 * i)
    c.flush()
    c.run_until(5.0)
    return c


def test_explicit_cursor_reads_do_not_advance_the_drain():
    c = _small_client()
    full = c.events(cursor=0)
    assert full, "expected a typed event stream"
    drained = c.events()
    assert [e.seq for e in drained] == [e.seq for e in full]
    assert c.events() == []
    assert [e.seq for e in c.events(cursor=0)] == [e.seq for e in full]


def test_events_page_paginates_with_resume_cursor():
    c = _small_client()
    log = c._event_log()
    seen = []
    cursor, n_pages = 0, 0
    while True:
        page, cursor, n_dropped = c.events_page(cursor, limit=3)
        assert n_dropped == 0
        if not page:
            break
        seen.extend(e.seq for e in page)
        n_pages += 1
    assert seen == list(range(log.next_cursor))
    assert n_pages >= 2
    _, nxt, _ = c.events_page(0, kinds=["no_such_kind"])
    assert nxt == log.next_cursor


def test_events_page_reports_ring_gap():
    c = _small_client()
    log = c._event_log()
    log.cap = 2
    log.emit(BlockPacked, time=9.0, height=99, n_txs=0, gas_used=0,
             block_hash="x")
    page, nxt, n_dropped = c.events_page(0)
    assert n_dropped == log.base > 0
    assert all(not isinstance(e, EventsDropped) for e in page)
    assert nxt == log.next_cursor


# -- concurrent service vs serial replay ----------------------------------------

BACKENDS = {
    "vector": lambda api: api.NodeSpec(),
    "fabric": lambda api: api.NodeSpec(
        shards=api.ShardSpec(count=2, fabric=True)),
}


def _no_tensors(obj) -> bool:
    """True when nothing in ``obj`` (dicts, lists, tuples) is a tensor."""
    if isinstance(obj, torch.Tensor):
        return False
    if isinstance(obj, dict):
        return all(_no_tensors(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_no_tensors(v) for v in obj)
    return True


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_concurrent_clients_match_serial_replay(backend):
    spec = ServeSpec(
        node=BACKENDS[backend](pt), window=0.5,
        admission=AdmissionSpec(rate_limit=1000.0, burst=1000.0))

    async def run():
        svc = await NodeService(spec, device=CPU).start()

        async def one_client(i):
            out = []
            for k in range(5):
                r = await svc.submit("submitLocalModel", f"user{i}",
                                     at=0.3 * k + 0.001 * i)
                out.append(r)
            return out

        replies = await asyncio.gather(*(one_client(i) for i in range(20)))
        await svc.close()
        return svc, replies

    svc, replies = asyncio.run(run())
    flat = [r for client in replies for r in client]
    assert all(r["status"] == "queued" for r in flat)
    assert svc.metrics.flushed == 100
    receipts = [svc.receipt(r["ref"]) for r in flat]
    assert {r["status"] for r in receipts} <= {"finalized", "confirmed"}
    assert _no_tensors(receipts) and _no_tensors(svc.events(cursor=0))
    assert _no_tensors(svc.stats()) and _no_tensors(svc.get_account("user0"))

    serial = replay_ops(spec.node, svc.ops, device=CPU)
    assert svc.client.state_root() == serial.state_root()
    assert svc.client.chain.total_gas == serial.chain.total_gas


def test_rejected_txs_never_reach_the_op_log():
    spec = ServeSpec(node=NodeSpec(), window=1000.0,
                     admission=AdmissionSpec(rate_limit=1.0, burst=1.0))

    async def run():
        svc = await NodeService(spec, device=CPU).start()
        a = await svc.submit("submitLocalModel", "u", at=0.0)
        b = await svc.submit("submitLocalModel", "u", at=0.0)
        await svc.finalize()
        return svc, a, b

    svc, a, b = asyncio.run(run())
    assert a["status"] == "queued" and b["reason"] == "rate_limited"
    assert svc.receipt(b["ref"])["status"] == "rejected"
    batches = [op for op in svc.ops if op[0] == "batch"]
    assert sum(len(op[1]) for op in batches) == 1


# -- backpressure ---------------------------------------------------------------

def test_full_writer_queue_is_an_explicit_overload():
    spec = ServeSpec(node=NodeSpec(), queue_cap=4)

    async def run():
        svc = await NodeService(spec, device=CPU).start()
        svc._writer.cancel()
        try:
            await svc._writer
        except asyncio.CancelledError:
            pass
        svc._writer = None
        pending = [asyncio.ensure_future(
            svc.submit("submitLocalModel", f"u{i}", at=0.0))
            for i in range(spec.queue_cap)]
        await asyncio.sleep(0)
        overflow = await svc.submit("submitLocalModel", "late", at=0.0)
        assert overflow == {"error": "overloaded",
                            "detail": "op queue full"}
        assert svc.metrics.queue_rejections == 1
        await svc.start()
        replies = await asyncio.gather(*pending)
        assert all(r["status"] == "queued" for r in replies)
        await svc.close()

    asyncio.run(run())


# -- the HTTP face --------------------------------------------------------------

def test_http_roundtrip_submit_flush_receipt_events():
    spec = ServeSpec(node=NodeSpec(), port=0)

    async def run():
        server = HttpNodeServer(NodeService(spec, device=CPU))
        host, port = await server.start()
        st, body = await http_rpc(host, port, "submit",
                                  {"fn": "submitLocalModel",
                                   "sender": "alice"})
        assert st == 200 and body["result"]["status"] == "queued"
        ref = body["result"]["ref"]

        st, body = await http_rpc(host, port, "flush")
        assert st == 200 and body["result"]["status"] == "finalized"

        st, body = await http_rpc(host, port, "receipt", {"ref": ref})
        assert st == 200
        assert body["result"]["status"] in ("finalized", "confirmed")
        assert body["result"] == server.service.receipt(ref)

        st, body = await http_rpc(host, port, "state_root")
        assert st == 200 and body["result"]["state_root"]

        st, body = await http_rpc(host, port, "get_account",
                                  {"address": "alice"})
        assert st == 200 and body["result"]["submissions"] == 1

        st, body = await http_rpc(host, port, "events", {"cursor": 0})
        assert st == 200 and body["result"]["events"]
        assert body["result"]["next_cursor"] > 0
        assert body["result"]["dropped"] == 0
        kinds = {e["kind"] for e in body["result"]["events"]}
        assert "block_packed" in kinds

        st, body = await http_rpc(host, port, "capabilities")
        assert st == 200 and "block_packed" in body["result"]["capabilities"]

        st, body = await http_rpc(host, port, "metrics")
        assert st == 200 and body["result"]["flushed"] == 1

        st, body = await http_rpc(host, port, "no_such_method")
        assert st == 400 and "error" in body
        await server.close()

    asyncio.run(run())


def test_http_429_when_pool_rejects_overloaded():
    spec = ServeSpec(node=NodeSpec(), port=0, window=1000.0,
                     admission=AdmissionSpec(pool_cap=1, evict=False))

    async def run():
        server = HttpNodeServer(NodeService(spec, device=CPU))
        host, port = await server.start()
        st1, _ = await http_rpc(host, port, "submit",
                                {"fn": "submitLocalModel", "sender": "a",
                                 "at": 0.0})
        st2, body = await http_rpc(host, port, "submit",
                                   {"fn": "submitLocalModel", "sender": "b",
                                    "at": 0.0})
        assert st1 == 200 and st2 == 429
        assert body["result"]["reason"] == "overloaded"
        await server.close()

    asyncio.run(run())


def test_service_event_cap_bounds_the_stream():
    spec = ServeSpec(node=NodeSpec(), event_cap=4, window=0.25,
                     admission=AdmissionSpec(rate_limit=1000.0, burst=1000.0))

    async def run():
        svc = await NodeService(spec, device=CPU).start()
        for k in range(30):
            await svc.submit("submitLocalModel", f"u{k % 3}", at=0.05 * k)
        await svc.close()
        return svc, svc.events(cursor=0)

    svc, page = asyncio.run(run())
    assert page["dropped"] > 0
    assert len(page["events"]) <= 4
    assert page["next_cursor"] == svc.client._event_log().next_cursor


# -- the port against the JAX package -------------------------------------------

def _script(seed=0, n=400, duration=4.0):
    """Scripted submissions that walk every rung of the ladder: honest
    senders at the intrinsic fee, a few senders whose
    calculateSubjectiveRep calls drop them below the trust line (then
    they must pay the surcharge), fees below the floor, bursts past the
    token bucket and a pool that overflows each window."""
    rng = np.random.default_rng(seed)
    fns = np.where(rng.uniform(size=n) < 0.3, "calculateSubjectiveRep",
                   np.where(rng.uniform(size=n) < 0.5, "submitLocalModel",
                            "publishTask"))
    senders = [f"s{k}" for k in rng.integers(0, 24, n)]
    fees = np.where(rng.uniform(size=n) < 0.7, -1,
                    rng.integers(10_000, 120_000, n))
    times = np.sort(rng.uniform(0.0, duration, n))
    return [(str(f), s, None if fee < 0 else int(fee), float(t))
            for f, s, fee, t in zip(fns, senders, fees, times)]


ADMISSION = dict(rate_limit=4.0, burst=3.0, fee_floor=20_000, pool_cap=24)


def _serve_script(serve, api, backend, **kw):
    spec = api.ServeSpec(node=BACKENDS[backend](api), window=0.5,
                         admission=api.AdmissionSpec(**ADMISSION))
    script = _script()

    async def run():
        svc = await serve.NodeService(spec, **kw).start()

        async def one(part):
            return [await svc.submit(fn, sender, fee=fee, at=at)
                    for fn, sender, fee, at in part]
        # four interleaving clients, then the rest one by one
        replies = await asyncio.gather(*(one(script[i:200:4])
                                         for i in range(4)))
        replies.append(await one(script[200:]))
        await svc.close()
        return svc, replies

    svc, replies = asyncio.run(run())
    receipts = {ref: svc.receipt(ref) for ref in sorted(svc.receipts)}
    events = [(e["kind"], e) for e in svc.events(cursor=0)["events"]]
    return dict(replies=replies, log=svc.admission.log, ops=svc.ops,
                counters=svc.admission.counters(), stats=svc.stats(),
                receipts=receipts, events=events,
                root=svc.client.state_root(),
                gas=svc.client.chain.total_gas)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_service_matches_jax_bit_for_bit(backend):
    got = _serve_script(sys.modules["repro_torch.serve"], pt, backend,
                        device=CPU)
    want = _serve_script(jserve, jx, backend)
    assert got["counters"]["admitted"] > 0
    for reason in ("fee_floor", "surcharge", "rate_limited", "overloaded"):
        assert got["counters"][f"rejected_{reason}"] > 0, reason
    assert got["counters"]["evicted"] > 0
    statuses = {r["status"] for r in got["receipts"].values()}
    assert {"finalized", "rejected", "evicted"} <= statuses
    for key in ("replies", "log", "ops", "counters", "stats", "receipts",
                "events", "root", "gas"):
        assert got[key] == want[key], key
    assert _no_tensors(got["receipts"]) and _no_tensors(got["events"])


# benchmarks/bench_serve.py's spam point in its quick mode (:139-140)
SPAM = dict(n_honest=200, n_spammers=8, honest_rate=60.0, spam_rate=240.0,
            duration=15.0, pool_cap=128, window=1.0)
HONEST_FN = "submitLocalModel"
SPAM_FN = "calculateSubjectiveRep"


def _bench_drive(serve, api, times, names, senders, duration, n_clients,
                 **kw):
    """bench_serve.py's ``_drive``: one asyncio client a sender, clients in
    lockstep epochs of one serve window."""
    spec = api.ServeSpec(node=api.NodeSpec(),
                         admission=api.AdmissionSpec(
                             pool_cap=SPAM["pool_cap"]),
                         queue_cap=n_clients + 64, window=SPAM["window"])
    n_epochs = int(duration / spec.window) + 2
    by_sender = {}
    for i in range(len(times)):
        epoch = min(int(times[i] / spec.window), n_epochs - 1)
        by_sender.setdefault(int(senders[i]),
                             [[] for _ in range(n_epochs)])[epoch].append(i)

    async def run():
        svc = await serve.NodeService(spec, **kw).start()
        ref_sender = {}

        async def one_client(sid, idxs):
            for i in idxs:
                r = await svc.submit(names[i], f"c{sid}", at=float(times[i]))
                if "ref" in r:
                    ref_sender[r["ref"]] = sid
                await asyncio.sleep(0)
        for k in range(n_epochs):
            await asyncio.gather(*(one_client(s, per_epoch[k])
                                   for s, per_epoch in sorted(
                                       by_sender.items())
                                   if per_epoch[k]))
        await svc.close()
        return svc, ref_sender

    svc, ref_sender = asyncio.run(run())
    committed = {}
    for ref, rec in svc.receipts.items():
        if rec.get("status") == "submitted" and ref in ref_sender:
            sid = ref_sender[ref]
            committed[sid] = committed.get(sid, 0) + 1
    return dict(counters=svc.admission.counters(), committed=committed,
                flushed=svc.metrics.flushed, windows=svc.metrics.windows,
                root=svc.client.state_root(),
                gas=svc.client.chain.total_gas)


def _spam_point(serve, api, make, **kw):
    common = dict(duration=SPAM["duration"], fn=HONEST_FN, spam_fn=SPAM_FN,
                  n_spammers=SPAM["n_spammers"], seed=0,
                  n_senders=SPAM["n_honest"])
    n_clients = SPAM["n_honest"] + SPAM["n_spammers"]
    out = {}
    for label, rate in (("alone", 0.0), ("spam", SPAM["spam_rate"])):
        txs = make(SPAM["honest_rate"], rate, **common).txs
        times = np.asarray(txs.submit_time)
        names = [txs.fns.names[int(f)] for f in np.asarray(txs.fn_id)]
        out[label] = _bench_drive(serve, api, times, names,
                                  np.asarray(txs.sender_id),
                                  SPAM["duration"], n_clients, **kw)

    def honest(res):
        return sum(n for sid, n in res["committed"].items()
                   if sid >= SPAM["n_spammers"])
    out["retention"] = honest(out["spam"]) / max(honest(out["alone"]), 1)
    return out


def test_bench_serve_spam_drive_matches_jax():
    got = _spam_point(sys.modules["repro_torch.serve"], pt,
                      lambda *a, **k: adversarial_spam_workload(
                          *a, device=CPU, **k), device=CPU)
    want = _spam_point(jserve, jx, jax_spam)
    counters = got["spam"]["counters"]
    assert counters["rejected_surcharge"] > 0
    assert counters["rejected_overloaded"] > 0
    assert got == want
    assert got["retention"] >= 0.8       # bench_serve.py's floor


# -- the launchers --------------------------------------------------------------

def test_serve_node_main_boots_on_the_cpu(capsys):
    serve_node.main(["--port", "0", "--serve-for", "0.2", "--device", CPU])
    out = capsys.readouterr().out
    assert "node service listening on http://127.0.0.1:" in out
    assert "device=cpu" in out
    assert ":0/rpc" not in out                  # the bound port, not 0


def test_serve_node_build_spec_matches_jax(monkeypatch):
    """The same flags build the same ServeSpec in both launchers (each
    ``main`` parses, and stops before serving)."""
    import argparse

    from repro.launch import serve_node as jax_serve_node
    argv = ["--shards", "2", "--pool-cap", "64", "--rep-gate", "reject",
            "--no-evict", "--window", "0.5", "--event-cap", "8"]
    parsed = []
    real = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        parsed.append(real(self, args, namespace))
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        parse_then_stop)
    for mod in (serve_node, jax_serve_node):
        with pytest.raises(SystemExit):
            mod.main(argv)
    got, want = (mod.build_spec(ns) for mod, ns in
                 zip((serve_node, jax_serve_node), parsed))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert parsed[0].device is None         # the card unless named


def test_serve_shim_warns_and_reexports_the_model_launcher():
    sys.modules.pop("repro_torch.launch.serve", None)
    with pytest.warns(DeprecationWarning,
                      match="repro_torch.launch.serve_model"):
        shim = importlib.import_module("repro_torch.launch.serve")
    from repro_torch.launch import serve_model
    assert shim.main is serve_model.main
