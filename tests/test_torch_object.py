"""The object ledger of the port (core/ledger.Chain, core/rollup.Rollup and
the paths through them) against the JAX package's, on the CPU.

No payload on these paths carries a float, so everything is held bit for
bit: metrics of ``simulate_load`` and ``simulate_workload``, Table I gas
logs, object-batch digests, the Rollup's pre and post roots, tx ids, block
hashes, receipts and the typed event stream.  The object == vector pins of
the JAX package (tests/test_engine.py, tests/test_state.py,
tests/test_prover.py) hold within the port too.  The agent path, whose
payloads and state carry floats, is tests/test_torch_agents.py.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.api as jx
import repro_torch.api as pt
from repro.core.engine import VectorChain as JaxVectorChain
from repro.core.engine import VectorRollup as JaxVectorRollup
from repro.core.ledger import Chain as JaxChain
from repro.core.ledger import Tx as JaxTx
from repro.core.ledger import simulate_load as jax_simulate_load
from repro.core.ledger import simulate_workload as jax_simulate_workload
from repro.core.rollup import Rollup as JaxRollup
from repro.core.rollup import state_digest as jax_state_digest
from repro.core.state import canonical_bytes as jax_canonical_bytes
from repro.core.state import default_state_handlers as jax_handlers
from repro.core.workloads import make_workload as jax_workload
from repro_torch.core.engine import (FnRegistry, TxArrays, VectorChain,
                                     VectorRollup)
from repro_torch.core.gas import DEFAULT_GAS, FUNCTIONS, l2_gas
from repro_torch.core.ledger import (Chain, LedgerBackend, Tx,
                                     simulate_load, simulate_workload)
from repro_torch.core.rollup import Rollup, state_digest
from repro_torch.core.state import canonical_bytes, default_state_handlers
from repro_torch.core.tasks import TaskContract
from repro_torch.core.workloads import SCENARIOS
from repro_torch.core.workloads import make_workload as torch_workload

CPU = "cpu"
GAS_KEYS = ("n_txs", "commit", "verify", "execute", "total")


@dataclasses.dataclass
class Rec:
    x: int
    y: object


# -- canonical_bytes: the reference's regression cases, byte for byte ----------
_BIG = np.zeros(2000)
_BIG_B = _BIG.copy()
_BIG_B[1000] = 7.0
CANON_CASES = {
    "none": None, "true": True, "int": 1, "neg_int": -12345678901234,
    "np_int": np.int64(7), "float": 1.0, "neg_zero": -0.0, "str": "1",
    "bytes": b"x", "list": [1, 2], "tuple": (1, 2), "set": {1, 2},
    "int32_array": np.zeros(4, np.int32), "int64_array": np.zeros(4),
    "matrix": np.arange(6.0).reshape(2, 3), "big": _BIG, "big_b": _BIG_B,
    "object_array": np.array([{"x": 1}, [1, 2]], dtype=object),
    "dataclass": Rec(1, np.arange(3)),
    "nested": {"tasks": {"t0": {"publisher": "tp0", "round": 0}},
               "models": {"('t0', 0)": {"trainer0": "Qm"}},
               "o_rep": {"trainer1": 0.25}},
}


@pytest.mark.parametrize("name", sorted(CANON_CASES))
def test_canonical_bytes_matches_jax(name):
    value = CANON_CASES[name]
    assert canonical_bytes(value) == jax_canonical_bytes(value)
    assert state_digest({"w": value}) == jax_state_digest({"w": value})


def test_canonical_bytes_tensor_encodes_as_its_ndarray():
    for a in (np.arange(5, dtype=np.float32), np.zeros((2, 3), np.int64),
              np.array(3.5, np.float64)):
        assert canonical_bytes(torch.from_numpy(a)) == canonical_bytes(a)
    a = np.zeros(2000)
    b = a.copy()
    b[1000] = 7.0                                 # the repr-collision case
    assert canonical_bytes(a) != canonical_bytes(b)
    assert state_digest({"a": 1, "b": np.arange(5)}) == \
        state_digest({"b": np.arange(5), "a": 1})


# -- object == vector == JAX on the L1 ------------------------------------------
def _random_txs(rng, n, tx_cls):
    fns = list(FUNCTIONS)
    times = np.sort(rng.uniform(0.0, 10.0, n))
    out = []
    for t in times:
        fn = fns[int(rng.integers(len(fns)))]
        sender = f"c{int(rng.integers(8))}"
        gas = int(DEFAULT_GAS.l1_per_call[fns[0]] if rng.uniform() < 0.1
                  else rng.integers(20_000, 200_000))
        out.append(tx_cls(fn, sender, {}, gas, float(t)))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_chain_equivalence_random_workloads(seed):
    """The port's object Chain packs the JAX object Chain's blocks (hashes
    included) and its VectorChain's (heights, times, gas, confirm
    times)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 800))
    limit = int(rng.integers(500_000, 9_000_000))
    bt = float(rng.uniform(0.3, 2.0))
    state = rng.bit_generator.state
    txs = _random_txs(rng, n, Tx)
    rng.bit_generator.state = state
    jtxs = _random_txs(rng, n, JaxTx)
    oc = Chain(block_gas_limit=limit, block_time=bt, device=CPU)
    jc = JaxChain(block_gas_limit=limit, block_time=bt)
    vc = VectorChain(block_gas_limit=limit, block_time=bt, device=CPU)
    for t, jt in zip(txs, jtxs):
        oc.submit(t)
        jc.submit(jt)
    vc.submit_arrays(TxArrays.from_txs(txs, vc.fns, CPU))
    for ch in (oc, jc, vc):
        ch.run_until(12.0)
    assert [(b.height, b.time, b.gas_used, b.block_hash) for b in oc.blocks] \
        == [(b.height, b.time, b.gas_used, b.block_hash) for b in jc.blocks]
    assert [(b.height, b.time, b.gas_used) for b in oc.blocks] == \
        [(b.height, b.time, b.gas_used) for b in vc.blocks]
    assert [len(b.txs) for b in oc.blocks] == [b.n_txs for b in vc.blocks]
    assert oc.total_gas == vc.total_gas == jc.total_gas
    conf = [t.confirm_time for b in oc.blocks for t in b.txs]
    np.testing.assert_array_equal(np.asarray(conf),
                                  vc.confirm_times().numpy())
    assert [t.tx_id for t in txs] == [t.tx_id for t in jtxs]


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_simulate_load_matches_jax(fn):
    """Fig. 4: both backends of the port and of the JAX package give the
    same metrics, bit for bit."""
    for rate in (40, 320):
        got = [simulate_load(fn, rate, duration=8.0, device=CPU,
                             spec=pt.ChainSpec(backend=b))
               for b in ("object", "vector")]
        want = [jax_simulate_load(fn, rate, duration=8.0,
                                  spec=jx.ChainSpec(backend=b))
                for b in ("object", "vector")]
        assert got[0] == got[1] == want[0] == want[1], (fn, rate)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulate_workload_matches_jax(name):
    wt = torch_workload(name, 60.0, duration=6.0, seed=9, device=CPU)
    wj = jax_workload(name, 60.0, duration=6.0, seed=9)
    got = [simulate_workload(wt, device=CPU, spec=pt.ChainSpec(backend=b))
           for b in ("object", "vector")]
    want = [jax_simulate_workload(wj, spec=jx.ChainSpec(backend=b))
            for b in ("object", "vector")]
    assert got[0] == got[1] == want[0] == want[1]
    assert got[0]["scenario"] == name
    # a WorkloadSpec is built on the chain's device
    spec = pt.WorkloadSpec.make(name, 60.0, duration=6.0, seed=9)
    assert simulate_workload(spec, device=CPU,
                             spec=pt.ChainSpec(backend="object")) == got[0]


@pytest.mark.parametrize("case", ["stall", "oversized"])
def test_head_of_line_rules_match(case):
    """FIFO head-of-line: a future head, or one over the block limit,
    stalls the queue the same way on every engine."""
    rows = ([("a", 50_000, 0.5), ("b", 50_000, 99.0), ("c", 50_000, 1.0)]
            if case == "stall" else
            [("a", 10_000_000, 0.1), ("b", 1_000, 0.2)])
    oc, jc = Chain(device=CPU), JaxChain()
    vc = VectorChain(device=CPU)
    txs = [Tx("submitLocalModel", s, {}, g, t) for s, g, t in rows]
    for s, g, t in rows:
        jc.submit(JaxTx("submitLocalModel", s, {}, g, t))
    for t in txs:
        oc.submit(t)
    vc.submit_arrays(TxArrays.from_txs(txs, vc.fns, CPU))
    for ch in (oc, jc, vc):
        ch.run_until(5.0)
    confirmed = sum(len(b.txs) for b in oc.blocks)
    assert confirmed == sum(len(b.txs) for b in jc.blocks) == vc.n_confirmed
    assert confirmed == (1 if case == "stall" else 0)
    assert oc.total_gas == jc.total_gas == vc.total_gas


def test_interleaved_submit_produce_matches_object():
    rng = np.random.default_rng(21)
    txs = _random_txs(rng, 400, Tx)
    oc = Chain(block_gas_limit=2_000_000, device=CPU)
    vc = VectorChain(block_gas_limit=2_000_000, device=CPU)
    i, t = 0, 0.0
    while t < 12.0:
        while i < len(txs) and txs[i].submit_time <= t + 1.0:
            oc.submit(txs[i])
            vc.submit(txs[i])
            i += 1
        t += 1.0
        oc.produce_block(t)
        vc.produce_block(t)
    assert oc.total_gas == vc.total_gas
    conf = [x.confirm_time for b in oc.blocks for x in b.txs]
    np.testing.assert_array_equal(np.asarray(conf),
                                  vc.confirm_times().numpy())


def test_batch_handlers_match_per_tx_handlers():
    wl = torch_workload("mixed", 150.0, duration=6.0, seed=11, device=CPU)
    oc = Chain(device=CPU)
    counts = {}
    for fn in FUNCTIONS:
        oc.register(fn, lambda s, tx, fn=fn: counts.__setitem__(
            fn, counts.get(fn, 0) + 1))
    for t in wl.to_txs():
        oc.submit(t)
    oc.run_until(6.0)
    vc = VectorChain(fns=wl.txs.fns, device=CPU)
    TaskContract.register_batch_handlers(vc)
    vc.submit_arrays(wl.txs)
    vc.run_until(6.0)
    assert vc.state["calls"] == {k: v for k, v in counts.items() if v}
    per = vc.state["calls_by_sender"]
    assert sum(sum(d.values()) for d in per.values()) == sum(counts.values())


# -- the object Rollup ----------------------------------------------------------
def _rollups(batch):
    return (Rollup(Chain(device=CPU), batch_size=batch),
            JaxRollup(JaxChain(), batch_size=batch))


@pytest.mark.parametrize("fn,n_calls,batch", [
    ("publishTask", 100, 20), ("submitLocalModel", 50, 20),
    ("calculateSubjectiveRep", 7, 4), ("calculateObjectiveRep", 3, 8)])
def test_rollup_matches_jax_and_vector(fn, n_calls, batch):
    """Object Rollup == the JAX object Rollup (gas log, proofs, digests,
    blocks) and == the port's VectorRollup on the gas log."""
    oru, jru = _rollups(batch)
    vru = VectorRollup(VectorChain(device=CPU), batch_size=batch)
    for i in range(n_calls):
        oru.submit(Tx(fn, f"c{i}", {}, 0, i * 0.01))
        jru.submit(JaxTx(fn, f"c{i}", {}, 0, i * 0.01))
        vru.submit(Tx(fn, f"c{i}", {}, 0, i * 0.01))
    for ru in (oru, jru, vru):
        ru.flush()
        ru.l1.run_until(n_calls * 0.01 + 2.0)
    assert oru.gas_log == jru.gas_log
    assert [dataclasses.astuple(b) for b in oru.batches] == \
        [dataclasses.astuple(b) for b in jru.batches]
    assert [(b.height, b.gas_used, b.block_hash) for b in oru.l1.blocks] == \
        [(b.height, b.gas_used, b.block_hash) for b in jru.l1.blocks]
    assert [tuple(r[k] for k in GAS_KEYS) for r in oru.gas_log] == \
        [tuple(r[k] for k in GAS_KEYS) for r in vru.gas_log]
    assert oru.l1.total_gas == vru.l1.total_gas == jru.l1.total_gas


def test_settlement_amortization_rollup_invariants():
    """Amortized shares sum to the posted proof gas, per session; verify
    and execute post once a session (tests/test_engine.py:222)."""
    oru, jru = _rollups(5)
    for sess, n in enumerate((12, 7)):
        start = len(oru.gas_log)
        for i in range(n):
            oru.submit(Tx("submitLocalModel", "s", {}, 0, sess + i * 0.01))
            jru.submit(JaxTx("submitLocalModel", "s", {}, 0,
                             sess + i * 0.01))
        oru.flush()
        jru.flush()
        rows = oru.gas_log[start:]
        assert sum(r["verify"] for r in rows) == pytest.approx(
            DEFAULT_GAS.verify_multi)
        assert sum(r["execute"] for r in rows) == pytest.approx(
            DEFAULT_GAS.execute_multi)
    posted = [t.fn for t in oru.l1.mempool]
    assert posted.count("rollup_verify") == posted.count(
        "rollup_execute") == 2
    assert oru.gas_log == jru.gas_log
    assert [t.tx_id for t in oru.l1.mempool] == \
        [t.tx_id for t in jru.l1.mempool]


@pytest.mark.parametrize("kind", ["flush", "submit"])
def test_rollup_reentrancy_guards(kind):
    """A handler that flushes, or submits back, mid-seal neither splits
    the session nor seals against a half-executed state."""
    ch = Chain(device=CPU)
    ru = Rollup(ch, batch_size=4)
    executed = []

    def handler(state, tx):
        executed.append(tx.tx_id)
        if kind == "flush":
            ru.flush()
        elif tx.payload.get("spawn"):
            for j in range(4):
                ru.submit(Tx("f", "child", {"p": (tx.submit_time, j)}, 0,
                             tx.submit_time + 1 + j))
    ru.register("f", handler)
    n = 6 if kind == "flush" else 4
    for i in range(n):
        ru.submit(Tx("f", "root", {"spawn": True, "i": i}, 0, float(i)))
    ru.flush()
    posted = [t.fn for t in ch.mempool]
    assert posted.count("rollup_verify") == posted.count(
        "rollup_execute") == 1
    assert len(executed) == len(set(executed)) == (
        n if kind == "flush" else 20)
    assert all(b.n_txs <= 4 for b in ru.batches)
    assert sum(r["verify"] for r in ru.gas_log) == pytest.approx(
        DEFAULT_GAS.verify_multi)


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_table1_replay_matches_jax(fn):
    """bench_gas.py's replay through build_stack on the object backend:
    the gas log, every batch digest and the blocks equal the JAX
    package's; the totals within the bench's 10 % of l2_gas."""
    for n in (5, 20, 50, 100):
        ch, ru = pt.build_stack(pt.NodeSpec(chain=pt.ChainSpec(
            backend="object")), device=CPU)
        jch, jru = jx.build_stack(jx.preset("rollup-object"))
        for i in range(n):
            ru.submit(Tx(fn, f"c{i}", {}, 0, i * 0.01))
            jru.submit(JaxTx(fn, f"c{i}", {}, 0, i * 0.01))
        ru.flush()
        jru.flush()
        ch.run_until(5.0)
        jch.run_until(5.0)
        assert ru.gas_log == jru.gas_log
        assert [b.word_digest for b in ru.batches] == \
            [b.word_digest for b in jru.batches]
        assert [b.block_hash for b in ch.blocks] == \
            [b.block_hash for b in jch.blocks]
        live = sum(r["total"] for r in ru.gas_log)
        model = l2_gas(fn, n)["total"]
        assert abs(live - model) / model < 0.1


def test_vector_rollup_on_an_object_chain_matches_jax():
    """VectorRollup._l1_submit's object branch: commits and settlements
    post as sequencer Txs, exactly as the JAX package posts them."""
    vru = VectorRollup(Chain(device=CPU), batch_size=8)
    jru = JaxVectorRollup(JaxChain(), batch_size=8)
    wt = torch_workload("mixed", 40.0, duration=2.0, seed=4, device=CPU)
    wj = jax_workload("mixed", 40.0, duration=2.0, seed=4)
    vru.submit_arrays(wt.txs)
    jru.submit_arrays(wj.txs)
    for ru in (vru, jru):
        ru.flush()
        ru.l1.run_until(10.0)
    assert vru.gas_log == jru.gas_log
    assert isinstance(vru.batch_commit_ref[0], Tx)
    assert [b.block_hash for b in vru.l1.blocks] == \
        [b.block_hash for b in jru.l1.blocks]


# -- StateArrays on the object faces -------------------------------------------
def _feed(backend, txs):
    for t in txs:
        backend.submit(t)
    if isinstance(backend, (Chain, VectorChain, JaxChain, JaxVectorChain)):
        backend.run_until(10.0)
    else:
        backend.flush()


@pytest.mark.parametrize("face", ["chain", "rollup"])
def test_state_handlers_on_object_faces(face):
    backend = (Chain(device=CPU) if face == "chain"
               else Rollup(Chain(device=CPU)))
    jbackend = JaxChain() if face == "chain" else JaxRollup(JaxChain())
    assert isinstance(backend, LedgerBackend)
    for (fn, h), (jfn, jh) in zip(default_state_handlers().items(),
                                  jax_handlers().items()):
        backend.register_state(fn, h)
        jbackend.register_state(jfn, jh)
    assert backend.state_arrays._track_dirty
    assert backend.state_arrays.device == torch.device(CPU)
    rows = [("submitLocalModel", f"t{i % 3}", 0.1 * (i + 1))
            for i in range(6)] + [("publishTask", "tp0", 0.65)]
    _feed(backend, [Tx(f, s, {}, 1000, t) for f, s, t in rows])
    _feed(jbackend, [JaxTx(f, s, {}, 1000, t) for f, s, t in rows])
    st = backend.state_arrays
    for s, c in (("t0", 2), ("t1", 2), ("t2", 2)):
        assert int(st.submissions[backend.sender_id(s)]) == c
    assert int(st.tasks_published[backend.sender_id("tp0")]) == 1
    assert backend.state_root() == jbackend.state_root() != ""
    assert backend.state_root() == st.copy().root()


def test_state_root_matches_across_object_and_vector_rollups():
    """The same handlers commit the same state through 1-row object views
    and fn-filtered vector views, and the JAX object Rollup's root."""
    rows = [("submitLocalModel", f"c{i % 4}", 0.05 * (i + 1))
            for i in range(12)]
    roots = []
    for backend in (Rollup(Chain(device=CPU)),
                    VectorRollup(VectorChain(device=CPU))):
        for fn, handler in default_state_handlers().items():
            backend.register_state(fn, handler)
        _feed(backend, [Tx(f, s, {}, 1000, t) for f, s, t in rows])
        roots.append(backend.state_root())
    jru = JaxRollup(JaxChain())
    for fn, handler in jax_handlers().items():
        jru.register_state(fn, handler)
    _feed(jru, [JaxTx(f, s, {}, 1000, t) for f, s, t in rows])
    assert roots[0] == roots[1] == jru.state_root() != ""


@pytest.mark.parametrize("face", ["chain", "rollup"])
def test_submit_arrays_preserves_sender_ids_on_object_faces(face):
    """Lowering a SoA batch must not re-mint sender ids: row 0 IS alice
    (tests/test_state.py:224)."""
    backend = (Chain(device=CPU) if face == "chain"
               else Rollup(Chain(device=CPU)))
    backend.register_state("publishTask",
                           default_state_handlers()["publishTask"])
    alice = backend.sender_id("alice")
    backend.submit(Tx("publishTask", "alice", {}, 1000, 0.1))
    fns = FnRegistry()
    batch = TxArrays.from_numpy([0.2], [1000], [fns.id("publishTask")],
                                [alice], fns, CPU)
    lowered = backend.submit_arrays(batch)
    assert [t.sender for t in lowered] == ["alice"]
    # an unknown id is pinned, and round-trips to itself
    batch = TxArrays.from_numpy([0.3], [1000], [fns.id("publishTask")],
                                [7], fns, CPU)
    assert backend.submit_arrays(batch)[0].sender == "__acct7"
    assert backend.sender_id("__acct7") == 7
    _feed(backend, [])
    st = backend.state_arrays
    assert int(st.tasks_published[alice]) == 2
    assert int(st.tasks_published[: st.n].sum()) == 3


# -- the API over the object backend --------------------------------------------
def test_build_ledger_maps_object_specs():
    assert isinstance(pt.build_ledger(pt.ChainSpec(backend="object"),
                                      device=CPU), Chain)
    ru = pt.build_ledger(pt.NodeSpec(chain=pt.ChainSpec(backend="object")),
                         device=CPU)
    assert isinstance(ru, Rollup) and isinstance(ru.l1, Chain)
    assert ru.device == torch.device(CPU)
    assert pt.l1_of(ru) is ru.l1
    chain, rollup = pt.build_stack(pt.NodeSpec(
        chain=pt.ChainSpec(backend="object"), rollup=None), device=CPU)
    assert isinstance(chain, Chain) and rollup is None
    with pytest.raises(ValueError, match="n_lanes"):
        pt.NodeSpec(chain=pt.ChainSpec(backend="object"),
                    rollup=pt.RollupSpec(n_lanes=2))


def test_latency_parity_object_vs_vector_and_prepr_formula():
    ru_spec = pt.RollupSpec(batch_size=20, prove_time=0.9, per_tx_time=0.14)
    obj = pt.build_ledger(pt.NodeSpec(chain=pt.ChainSpec(backend="object"),
                                      rollup=ru_spec), device=CPU)
    vec = pt.build_ledger(pt.NodeSpec(rollup=ru_spec), device=CPU)
    for n in (1, 5, 20, 99, 1000):
        nb = max(1, -(-n // 20))
        assert obj.latency(n) == vec.latency(n) == pytest.approx(
            nb * 0.9 + n * 0.14)
        assert obj.throughput(150.0) == vec.throughput(150.0)


def _receipt(r):
    d = dict(vars(r))
    d.pop("tx", None)
    return d


def test_object_rollup_events_and_provenance():
    """tests/test_api.py:248 on both packages: 25 calls seal as 20 + 5,
    receipts carry batch, commit tx id, proof and aggregate refs, and the
    receipts and the event stream equal the JAX package's."""
    ct = pt.NodeClient.from_spec(pt.NodeSpec(chain=pt.ChainSpec(
        backend="object")), device=CPU)
    cj = jx.NodeClient.from_spec(jx.NodeSpec(chain=jx.ChainSpec(
        backend="object")))
    for c in (ct, cj):
        c.receipts = [c.submit("calculateObjectiveRep", "t0")
                      for _ in range(25)]
        c.flush()
        c.run_until(5.0)
        for r in c.receipts:
            c.refresh(r)
    sealed = ct.events(kinds=("batch_sealed",), cursor=0)
    assert [e.n_txs for e in sealed] == [20, 5]
    assert [r.batch for r in ct.receipts] == [0] * 20 + [1] * 5
    assert all(r.l1_ref for r in ct.receipts)
    assert all(r.proof_ref is not None and r.aggregate_ref is not None
               for r in ct.receipts)
    assert {r.status for r in ct.receipts} == {"finalized"}
    assert [_receipt(r) for r in ct.receipts] == \
        [_receipt(r) for r in cj.receipts]
    assert [dataclasses.asdict(e) for e in ct.events(cursor=0)] == \
        [dataclasses.asdict(e) for e in cj.events(cursor=0)]
    assert ct.state_root() == cj.state_root()
    for addr in ("t0", "nobody"):
        assert dataclasses.asdict(ct.get_account(addr)) == \
            dataclasses.asdict(cj.get_account(addr))


@pytest.mark.parametrize("rollup", [True, False])
def test_object_client_payloads_and_chain_receipts(rollup):
    """Payloads ride on the object faces (and into the tx id); the SoA
    faces refuse them, with the JAX package's message."""
    spec = pt.NodeSpec(chain=pt.ChainSpec(backend="object"),
                       rollup=pt.RollupSpec() if rollup else None)
    jspec = jx.NodeSpec(chain=jx.ChainSpec(backend="object"),
                        rollup=jx.RollupSpec() if rollup else None)
    ct = pt.NodeClient.from_spec(spec, device=CPU)
    cj = jx.NodeClient.from_spec(jspec)
    for c in (ct, cj):
        c.rs = [c.submit("publishTask", "p0", payload={"reward": 5}),
                c.submit("publishTask", "p0")]
        c.flush()
        c.run_until(5.0)
    assert ct.rs[0].tx.tx_id != ct.rs[1].tx.tx_id
    assert [r.tx.tx_id for r in ct.rs] == [r.tx.tx_id for r in cj.rs]
    assert [_receipt(ct.refresh(r)) for r in ct.rs] == \
        [_receipt(cj.refresh(r)) for r in cj.rs]
    assert {r.status for r in ct.rs} == (
        {"finalized"} if rollup else {"confirmed"})
    with pytest.raises(ValueError, match="backend='object'"):
        pt.NodeClient.from_spec(pt.NodeSpec(), device=CPU).submit(
            "publishTask", "p0", payload={"reward": 5})


def test_deprecated_engine_string_and_exclusive_spec():
    with pytest.warns(DeprecationWarning, match="ChainSpec"):
        m = simulate_load("publishTask", 10.0, duration=2.0,
                          engine="object", device=CPU)
    assert m["submitted"] == 20
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert simulate_load("publishTask", 10.0, duration=2.0,
                             device=CPU)["submitted"] == 20
    with pytest.raises(ValueError, match="not both"):
        simulate_load("publishTask", 10.0, block_time=0.5,
                      spec=pt.ChainSpec(), device=CPU)
    with pytest.raises(ValueError, match="QBFT"):
        Chain(n_validators=3, device=CPU)
