"""The port's fused window loop over the sharded fabric (core/fused.py x
core/shards.py) against the port's stepped fabric and the JAX package's
fused fabric.

  * The raw ledger, on tests/test_fused_fabric.py's traffic (task pins,
    both routes, K of 1, 2, 4 and 8, random schedules by hypothesis): the
    port fused == the port stepped == the JAX package's fused fabric,
    exactly: typed events, blocks, confirm times, L1 gas, the fabric's gas
    log, digests, fabric roots, state root, per-shard provenance, the
    per-tx ``(shard, seq)`` receipts and the interconnect's wire log per
    kind.  The fused fabric folds its seals in TWO ``shard_seal`` calls
    and no ``batch_seal`` call.
  * The mesh knob's mapping (``None`` on one device, so that the factory
    and ``REPRO_TORCH_KERNEL_IMPL`` decide), ``mesh="on"`` through the
    mesh impl, one shard == a plain ``VectorRollup``, ``capabilities()``.
  * The default Scheduler (fused loop + megastep, tasks pinned) on 2
    shards against its stepped per-task run and against the JAX package's
    default Scheduler, with the JAX initial parameters and noise handed to
    the port: the ledger exactly (roots up to the first settlement),
    selections and DON scores exactly, parameters, reputations and
    payouts within rtol 1e-5 / atol 1e-6 (tests/test_torch_fl_protocol.py).
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
from repro.core.fused import FusedWindowLoop as JaxLoop
from repro.core.shards import ShardedRollup as JaxFabric
from repro.core.state import default_state_handlers as jax_handlers
from repro.data.synthetic import gaussian_clusters
from repro.fl.cohort import CohortKernels as JaxKernels
from repro.fl.cohort import VectorCohort as JaxCohort
from repro.fl.dp import DPConfig as JaxDP
from repro.fl.scheduler import Scheduler as JaxScheduler
from repro.fl.server import AutoDFL as JaxNode
from repro.models.mlp import TinyMLP as JaxMLP
from repro.optim.optimizers import OptimizerSpec as JaxOptSpec
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro_torch.core import fused as fused_mod
from repro_torch.core.engine import TxArrays, VectorChain, VectorRollup
from repro_torch.core.fused import FusedWindowLoop, supports_fused
from repro_torch.core.shards import ShardedRollup
from repro_torch.core.state import default_state_handlers
from repro_torch.fl import cohort as tcohort
from repro_torch.fl.dp import DPConfig
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.kernels import batch_seal as bs
from repro_torch.kernels import shard_lanes as sl
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.mlp import TinyMLP, params_from_numpy
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
from test_torch_fl_protocol import jax_round_noise

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
_FNS = ("publishTask", "submitLocalModel", "calculateObjectiveRep",
        "updateReputation")


# -- the raw ledger ------------------------------------------------------------
def _traffic(rng, n_windows, n_tasks, pin_tasks, n_shards, max_txs=6):
    """tests/test_fused_fabric.py's windows of (arrays, shard pin): even
    tasks pin to a random shard when ``pin_tasks``, odd ones route by
    policy."""
    out, t = [], 0.0
    for _w in range(n_windows):
        row = []
        for m in range(n_tasks):
            k = int(rng.integers(1, max_txs + 1))
            times = t + 0.01 * np.arange(1, k + 1)
            t = float(times[-1])
            pin = int(rng.integers(0, n_shards)) \
                if pin_tasks and m % 2 == 0 else None
            row.append(((times, rng.integers(21_000, 60_000, k),
                         rng.integers(0, 4, k), rng.integers(0, 64, k)),
                        pin))
        out.append(row)
    return out


FABRIC_KW = dict(batch_size=4, n_lanes=2, agg_width=4, prover_capacity=2)


def _torch_fabric(k, route="hash", mesh="off"):
    chain = VectorChain(device="cpu")
    for f in _FNS:
        chain.fns.id(f)
    fabric = ShardedRollup(chain, n_shards=k, route=route, mesh=mesh,
                           **FABRIC_KW)
    for fn, handler in default_state_handlers().items():
        fabric.register_state(fn, handler)
    fns = chain.fns
    return chain, fabric, lambda t, g, f, s: TxArrays.from_numpy(
        t, g, f, s, fns, "cpu")


def _jax_fabric(k, route="hash"):
    fns = JaxFns()
    for f in _FNS:
        fns.id(f)
    chain = JaxChain(fns=fns)
    fabric = JaxFabric(chain, n_shards=k, route=route, mesh="off",
                       **FABRIC_KW)
    for fn, handler in jax_handlers().items():
        fabric.register_state(fn, handler)
    return chain, fabric, lambda t, g, f, s: JaxTx(
        t, g.astype(np.int64), f.astype(np.int32), s.astype(np.int32), fns)


def _drive(chain, fabric, loop, traffic, seal_every, make):
    """One window schedule, stepped (``loop`` None) or fused; returns the
    per-submission ``(shard_of, seq_of)`` provenance as host arrays."""
    face = loop if loop is not None else fabric
    prov, t = [], 0.0
    for w, row in enumerate(traffic):
        for arrays, pin in row:
            b = make(*arrays)
            p = (loop.submit(fabric, b, shard=pin) if loop is not None
                 else fabric.submit_arrays(b, shard=pin))
            prov.append(tuple(np.asarray(x.cpu() if isinstance(
                x, torch.Tensor) else x) for x in p))
        if seal_every and (w + 1) % seal_every == 0:
            face.seal()
        t_end = max(t + 1.0, float(row[-1][0][0][-1]))
        face.pump(t_end)
        (loop or chain).run_until(t_end)
        t = t_end
    face.flush()
    (loop or chain).run_until(t + 3.0)
    if loop is not None:
        loop.execute()
    return prov


def _blocks(chain):
    return [(b.height, b.time, b.n_txs, b.gas_used, b.start, b.stop,
             b.parent, b.block_hash) for b in chain.blocks]


def _confirm(chain):
    c = chain.confirm_times()
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _wire_by_kind(ic):
    out = {}
    for r in ic.log:
        out.setdefault(r["kind"], []).append(r)
    return out


def _assert_fabrics_equal(ca, fa, cb, fb):
    """Two fabric stacks (either package) equal, exactly."""
    ea, eb = ca.events.since(0), cb.events.since(0)
    assert [e.kind for e in ea] == [e.kind for e in eb]
    for x, y in zip(ea, eb):
        assert dataclasses.asdict(x) == dataclasses.asdict(y), f"\n{x}\n{y}"
    assert ca.total_gas == cb.total_gas
    assert _blocks(ca) == _blocks(cb)
    np.testing.assert_array_equal(_confirm(ca), _confirm(cb))
    assert fa.gas_log == fb.gas_log
    assert fa.batch_digests == fb.batch_digests
    assert fa.update_digest == fb.update_digest
    assert fa.state_root() == fb.state_root()
    assert fa.fabric_root() == fb.fabric_root()
    assert fa.fabric_roots == fb.fabric_roots
    np.testing.assert_array_equal(fa._submitted, fb._submitted)
    for sa, sb in zip(fa.shards, fb.shards):
        assert sa.batch_commit_ref == sb.batch_commit_ref
        assert sa.batch_settle_ref == sb.batch_settle_ref
        assert sa._prov_starts == sb._prov_starts
        for x, y in zip(sa._prov_batches, sb._prov_batches):
            np.testing.assert_array_equal(x, y)
        assert (sa.n_batches, sa._next_seq, sa._sealed_seq) == \
            (sb.n_batches, sb._next_seq, sb._sealed_seq)
    # per kind and in total; only the interleaving may differ (the fused
    # loop merges windows at execute())
    assert _wire_by_kind(fa.interconnect) == _wire_by_kind(fb.interconnect)
    assert fa.interconnect.summary() == fb.interconnect.summary()


def _assert_provenance_equal(pa, pb):
    assert len(pa) == len(pb)
    for (sa, qa), (sb, qb) in zip(pa, pb):
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(qa, qb)


def _three_ways(traffic, k, route, seal_every, monkeypatch=None):
    ca, fa, make = _torch_fabric(k, route)
    pa = _drive(ca, fa, None, traffic, seal_every, make)
    cb, fb, make = _torch_fabric(k, route)
    pb = _drive(cb, fb, FusedWindowLoop(cb, fb), traffic, seal_every, make)
    cj, fj, make = _jax_fabric(k, route)
    pj = _drive(cj, fj, JaxLoop(cj, fj), traffic, seal_every, make)
    _assert_provenance_equal(pa, pb)
    _assert_fabrics_equal(ca, fa, cb, fb)
    _assert_provenance_equal(pj, pb)
    _assert_fabrics_equal(cj, fj, cb, fb)
    return fb


@pytest.mark.parametrize("route", ["hash", "least_loaded"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_fused_fabric_matches_stepped_and_jax(monkeypatch, k, route):
    calls = {"shard_seal": 0, "batch_seal": 0}
    for name, mod in (("shard_seal", sl), ("batch_seal", bs)):
        plain = getattr(mod, f"{name}_torch")
        monkeypatch.setattr(mod, f"{name}_torch",
                            lambda *a, _n=name, _p=plain: (
                                calls.__setitem__(_n, calls[_n] + 1),
                                _p(*a))[1])
    traffic = _traffic(np.random.default_rng(42 + k), 5, 3,
                       pin_tasks=True, n_shards=k)
    cb, fb, make = _torch_fabric(k, route)
    _drive(cb, fb, FusedWindowLoop(cb, fb), traffic, 2, make)
    # the fused fabric folds the run's seals in two shard_seal calls
    assert calls == {"shard_seal": 2, "batch_seal": 0}
    _three_ways(traffic, k, route, seal_every=2)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from([1, 2, 4, 8]),
       st.sampled_from(["hash", "least_loaded"]),
       st.sampled_from([0, 1, 2, 3]), st.booleans())
def test_fused_fabric_property(seed, n_shards, route, seal_every,
                               pin_tasks):
    rng = np.random.default_rng(seed)
    traffic = _traffic(rng, int(rng.integers(2, 6)), int(rng.integers(1, 4)),
                       pin_tasks=pin_tasks, n_shards=n_shards)
    _three_ways(traffic, n_shards, route, seal_every)


def test_mesh_knob_mapping(monkeypatch):
    """``"on"`` takes the mesh impl, ``"auto"`` takes it on more than one
    card; otherwise ``None`` (the factory default and
    ``REPRO_TORCH_KERNEL_IMPL`` decide), or the lanes' digest backend."""
    assert mesh_mod.n_local_devices() == 1
    for mode, want in (("on", "mesh"), ("off", None), ("auto", None)):
        chain, fabric, _ = _torch_fabric(2, mesh=mode)
        assert FusedWindowLoop(chain, fabric)._shard_seal_impl() == want
    chain = VectorChain(device="cpu")
    forced = ShardedRollup(chain, n_shards=2, mesh="off",
                           digest_backend="torch")
    assert FusedWindowLoop(chain, forced)._shard_seal_impl() == "torch"
    monkeypatch.setattr(mesh_mod, "n_local_devices", lambda: 2)
    chain, fabric, _ = _torch_fabric(2, mesh="auto")
    assert FusedWindowLoop(chain, fabric)._shard_seal_impl() == "mesh"
    with pytest.raises(ValueError, match="mesh mode"):
        ShardedRollup(chain, n_shards=2, mesh="sometimes")


def test_fused_fabric_mesh_on(monkeypatch):
    """``mesh="on"`` folds through the mesh impl (one CPU device here),
    still equal to the stepped fabric."""
    used = []
    real = sl.shard_seal_mesh
    monkeypatch.setattr(sl, "shard_seal_mesh",
                        lambda *a, **kw: used.append(1) or real(*a, **kw))
    from repro_torch.kernels import factory
    monkeypatch.setitem(factory._REGISTRY["shard_seal"], "mesh",
                        sl.shard_seal_mesh)
    traffic = _traffic(np.random.default_rng(77), 4, 3, pin_tasks=True,
                       n_shards=4)
    ca, fa, make = _torch_fabric(4, mesh="off")
    _drive(ca, fa, None, traffic, 2, make)
    cb, fb, make = _torch_fabric(4, mesh="on")
    _drive(cb, fb, FusedWindowLoop(cb, fb), traffic, 2, make)
    assert used == [1, 1]
    _assert_fabrics_equal(ca, fa, cb, fb)


def test_one_shard_fused_fabric_matches_vector_rollup():
    """One shard through the fused loop == a plain stepped VectorRollup
    (modulo the ``shard`` tag of the gas rows)."""
    traffic = _traffic(np.random.default_rng(7), 4, 2, pin_tasks=False,
                       n_shards=1)
    chain = VectorChain(device="cpu")
    for f in _FNS:
        chain.fns.id(f)
    ru = VectorRollup(chain, **FABRIC_KW)
    for fn, handler in default_state_handlers().items():
        ru.register_state(fn, handler)
    t = 0.0
    for w, row in enumerate(traffic):
        for arrays, _ in row:
            ru.submit_arrays(TxArrays.from_numpy(*arrays, chain.fns, "cpu"))
        if (w + 1) % 2 == 0:
            ru.seal()
        t_end = max(t + 1.0, float(row[-1][0][0][-1]))
        ru.pump(t_end)
        chain.run_until(t_end)
        t = t_end
    ru.flush()
    chain.run_until(t + 3.0)
    cb, fb, make = _torch_fabric(1)
    _drive(cb, fb, FusedWindowLoop(cb, fb), traffic, 2, make)
    assert [{k: v for k, v in r.items() if k != "shard"}
            for r in fb.gas_log] == ru.gas_log
    assert fb.batch_digests == ru.batch_digests
    assert fb.update_digest == ru.update_digest
    assert fb.shards[0].batch_commit_ref == ru.batch_commit_ref
    assert fb.state_root() == ru.state_arrays.root()


def test_capabilities_and_supports_fused():
    fab = pt.NodeClient.from_spec(pt.NodeSpec(
        shards=pt.ShardSpec(count=2, fabric=True)), device="cpu")
    assert supports_fused(fab.chain, fab.target)
    assert "fused_window_loop" in fab.capabilities()
    assert "window_settled" in fab.capabilities()
    vec = pt.NodeClient.from_spec(pt.NodeSpec(), device="cpu")
    assert "fused_window_loop" in vec.capabilities()
    obj = pt.NodeClient.from_spec(pt.NodeSpec(
        chain=pt.ChainSpec(backend="object")), device="cpu")
    assert "fused_window_loop" not in obj.capabilities()
    assert not supports_fused(obj.chain, obj.target)
    with pytest.raises(ValueError, match="fused loop needs"):
        FusedWindowLoop(obj.chain, obj.target)


# -- the default Scheduler on a fabric -----------------------------------------
D_IN, D_H, N_CLS, LOCAL_STEPS, BATCH = 8, 8, 4, 2, 8
BEHAVIORS = ["good", "good", "malicious", "lazy", "good"]


@pytest.fixture(scope="module")
def world():
    tr_x, tr_y = gaussian_clusters(256, D_IN, N_CLS, seed=1, noise=0.5)
    vx, vy = gaussian_clusters(40, D_IN, N_CLS, seed=2, noise=0.5)

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
        jax_init={s: {k: np.asarray(v) for k, v in
                      jm.init_params(jax.random.key(s)).items()}
                  for s in range(4)})


@pytest.fixture
def inject(world, monkeypatch):
    monkeypatch.setattr(tcohort, "round_noise", jax_round_noise)
    monkeypatch.setattr(world["tm"], "init_params",
                        lambda seed: params_from_numpy(
                            world["jax_init"][seed], "cpu"))


N_TASKS, ROUNDS = 3, 2


def _tasks(api):
    return [api.FLTaskSpec(f"task{t}", rounds=ROUNDS, init_seed=t,
                           start_window=t % 2) for t in range(N_TASKS)]


def _fabric_spec(api, route):
    return api.NodeSpec(shards=api.ShardSpec(count=2, route=route),
                        trainer_funds=50.0)


def _run_jax(w, route):
    node = JaxNode(w["jm"], w["jo"], len(BEHAVIORS), w["jm"].accuracy_fn(),
                   w["val_j"], spec=_fabric_spec(jx, route))
    kern = JaxKernels(w["jm"], w["jo"], JaxDP(noise_multiplier=0.05))
    sch = JaxScheduler(node, seal_every=2)
    for t, spec in enumerate(_tasks(jx)):
        sch.add_task(spec, JaxCohort(
            w["jm"], w["jo"], w["jax_bf"], node.store, behaviors=BEHAVIORS,
            local_steps=LOCAL_STEPS, dp=JaxDP(noise_multiplier=0.05), seed=t,
            kernels=kern))
    return node, sch, sch.run()


def _run_torch(w, route, **knobs):
    node = AutoDFL(w["tm"], w["to"], len(BEHAVIORS), w["tm"].accuracy_fn(),
                   w["val_t"], spec=_fabric_spec(pt, route), device="cpu")
    mark = {}
    settle = node.settle_window

    def watched(rts):
        mark.setdefault("cursor", node.chain.events.next_cursor)
        return settle(rts)
    node.settle_window = watched
    kern = tcohort.CohortKernels(w["tm"], w["to"],
                                 DPConfig(noise_multiplier=0.05))
    sch = Scheduler(node, seal_every=2, **knobs)
    for t, spec in enumerate(_tasks(pt)):
        sch.add_task(spec, tcohort.VectorCohort(
            w["tm"], w["to"], w["torch_bf"], node.store, behaviors=BEHAVIORS,
            local_steps=LOCAL_STEPS, dp=DPConfig(noise_multiplier=0.05),
            seed=t, kernels=kern, device="cpu"))
    return node, sch, sch.run(), mark


# what commits the reputations (which may differ in the last bit across
# packages after the first settlement)
_ROOT_FIELDS = ("state_root", "fabric_root", "shard_roots")


def _events(node, roots_until=None):
    out = []
    for e in node.client().events(cursor=0):
        d = dataclasses.asdict(e)
        if roots_until is not None and e.kind == "window_settled" and \
                e.seq >= roots_until:
            for key in _ROOT_FIELDS:
                d.pop(key)
        out.append(d)
    return out


def _ledger(node):
    fab = node.rollup
    return (node.protocol_calls, fab.gas_log, fab.batch_digests,
            fab.update_digest, node.chain.total_gas,
            [(b.start, b.stop, b.gas_used, b.block_hash)
             for b in node.chain.blocks],
            dict(fab.task_shard), fab._submitted.tolist())


@pytest.mark.parametrize("route", ["hash", "least_loaded"])
def test_default_scheduler_on_fabric_matches_stepped_and_jax(
        world, inject, monkeypatch, route):
    executed = []
    real = fused_mod.FusedWindowLoop.execute
    monkeypatch.setattr(fused_mod.FusedWindowLoop, "execute",
                        lambda self: (executed.append(
                            type(self.rollup).__name__), real(self))[1])
    na, sa, oa, mark = _run_torch(world, route, fused=False,
                                  megabatch=False)
    assert executed == [] and sa.mega_windows == 0
    nb, sb, ob, _ = _run_torch(world, route)           # the default
    assert executed == ["ShardedRollup"]
    nj, sj, oj = _run_jax(world, route)
    assert sb.mega_windows == sj.mega_windows > 0
    assert {rt.task_id: rt.shard for rt in sb.runtimes} == \
        {rt.task_id: rt.shard for rt in sj.runtimes}

    # port default == port stepped per task, bit for bit (the megastep
    # coalesces a window's submissions: the same wire bytes in fewer
    # transfers)
    assert _ledger(na) == _ledger(nb)
    assert na.rollup.interconnect.totals["bytes"] == \
        nb.rollup.interconnect.totals["bytes"]
    assert _events(na) == _events(nb)
    assert na.rollup.fabric_roots == nb.rollup.fabric_roots
    assert na.state_arrays.root() == nb.state_arrays.root()
    for t, ra in oa.items():
        rb = ob[t]
        np.testing.assert_array_equal(ra.scores, rb.scores)
        np.testing.assert_array_equal(ra.reputations, rb.reputations)
        assert ra.payouts == rb.payouts
        for k, v in ra.global_params.items():
            assert torch.equal(v, rb.global_params[k]), (t, k)

    # port default against the JAX package's default Scheduler
    assert _ledger(nb) == (nj.protocol_calls, nj.rollup.gas_log,
                           nj.rollup.batch_digests, nj.rollup.update_digest,
                           nj.chain.total_gas,
                           [(b.start, b.stop, b.gas_used, b.block_hash)
                            for b in nj.chain.blocks],
                           dict(nj.rollup.task_shard),
                           nj.rollup._submitted.tolist())
    assert nb.rollup.interconnect.log == nj.rollup.interconnect.log
    cursor = mark["cursor"]
    assert _events(nb, cursor) == _events(nj, cursor)
    for t, rj in oj.items():
        rt = ob[t]
        assert nb.tsc.tasks[t].trainers == nj.tsc.tasks[t].trainers
        np.testing.assert_array_equal(rt.scores, rj.scores)
        np.testing.assert_allclose(rt.reputations,
                                   np.asarray(rj.reputations), **TOL)
        for who, pay in rj.payouts.items():
            np.testing.assert_allclose(rt.payouts[who], pay, **TOL)
        for k, leaf in rj.global_params.items():
            np.testing.assert_allclose(rt.global_params[k].numpy(),
                                       np.asarray(leaf), **TOL)
