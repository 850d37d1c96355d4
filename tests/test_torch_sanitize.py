"""The port's runtime sanitizer (repro_torch/analysis/sanitize.py) on the
CPU, against the JAX package's (repro/analysis/sanitize.py).

  * Every case of tests/test_sanitize.py on the port's stack: one injected
    violation per dynamic rule (skipped ``mark_dirty`` -> R001, an
    out-of-band event seq -> R005, a gas leak -> R006, an illegal receipt
    lifecycle -> R007) raises ``SanitizeViolation`` with the matching rule
    id; clean stepped, object, fabric and fused runs stay silent with the
    checks executed (``n_checks > 0``).
  * The same traffic through the JAX ``NodeClient`` and the port's, each
    with ``install_stack``: equal ``n_checks``; each injection raises the
    same rule id in both packages.
  * ``REPRO_SANITIZE=1`` installs the sanitizer through the port's
    ``build_stack`` on every branch (no rollup, the vector and object
    chains' rollups, the fabric), and a sanitized run's outputs (gas log,
    blocks, batch digests, event stream, state root) equal an unsanitized
    run's, exactly.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from conftest import given, settings, st

import repro.api as jx
import repro_torch.api as pt
from repro.analysis import sanitize as jax_sanitize
from repro.core import events as jax_events
from repro_torch.analysis.sanitize import (ENV_FLAG, SanitizeViolation,
                                           install_stack)
from repro_torch.core import events as torch_events

torch.set_num_threads(1)

DYNAMIC_RULES = ("R001", "R005", "R006", "R007")
#: the JAX package and the port, each as (api, sanitize module, events)
PACKAGES = {"jax": (jx, jax_sanitize, jax_events),
            "torch": (pt, None, torch_events)}
SPECS = {
    "vector": lambda api: api.NodeSpec(),
    "object": lambda api: api.NodeSpec(chain=api.ChainSpec(backend="object")),
    "fabric-2": lambda api: api.NodeSpec(
        shards=api.ShardSpec(count=2, fabric=True)),
}


def _client(api, spec):
    if api is pt:
        return pt.NodeClient.from_spec(spec, device="cpu")
    return api.NodeClient.from_spec(spec)


def _fresh_stack(spec=None, package="torch"):
    api, san_mod, _ = PACKAGES[package]
    install = install_stack if san_mod is None else san_mod.install_stack
    client = _client(api, spec or api.NodeSpec())
    return client, install(client.chain, client.target)


def _seed_traffic(client, n=3):
    for i in range(n):
        client.submit("submitLocalModel", f"s{i}")
    client.seal()


def _inject(rule, client, events=torch_events):
    """Introduce exactly one violation of ``rule`` into a primed stack
    (tests/test_sanitize.py's injections)."""
    log = client.chain.events
    if rule == "R001":
        # column write that skips mark_dirty; the next window carries a
        # no-state-handler tx so nothing re-dirties the poked chunk
        client.target.state_arrays.balances[0] += 7.0
        client.submit("bgPing", "s0")
        client.seal()
    elif rule == "R005":
        # out-of-band append desynchronizes seq == position
        log._events.append(events.BlockPacked(
            seq=len(log._events) + 5, time=0.0, shard=None, height=99,
            n_txs=0, gas_used=0, block_hash="bogus"))
        log.emit(events.BlockPacked, time=1.0, height=100, n_txs=0,
                 gas_used=0, block_hash="next")
    elif rule == "R006":
        client.chain.total_gas += 12345          # gas leaked out of band
        client.chain.produce_block(1e6)          # BlockPacked runs the audit
    elif rule == "R007":
        log.emit(events.ProofGenerated, time=0.5, shard=None, job=0,
                 batch=777, n_txs=1, digest=0, sealed_at=0.0)
    else:                                        # pragma: no cover
        raise AssertionError(rule)


def _session(client, n=60):
    for i in range(n):
        client.submit("submitLocalModel", f"t{i % 5}")
        if (i + 1) % 20 == 0:
            client.seal()
            client.target.settle_session()
    client.flush()
    client.run_until(10.0)


@pytest.mark.parametrize("rule", DYNAMIC_RULES)
def test_injected_violation_raises_matching_rule(rule):
    client, san = _fresh_stack()
    _seed_traffic(client)
    assert san.n_checks > 0, "sanitizer saw no events during clean traffic"
    with pytest.raises(SanitizeViolation) as exc:
        _inject(rule, client)
    assert exc.value.rule == rule
    assert rule in str(exc.value)


@settings(max_examples=12, deadline=None)
@given(rule=st.sampled_from(DYNAMIC_RULES), n_txs=st.integers(1, 6),
       n_windows=st.integers(1, 3))
def test_property_injection_caught_under_randomized_traffic(
        rule, n_txs, n_windows):
    client, _ = _fresh_stack()
    for _ in range(n_windows):
        _seed_traffic(client, n=n_txs)
    with pytest.raises(SanitizeViolation) as exc:
        _inject(rule, client)
    assert exc.value.rule == rule


def test_double_proof_is_illegal():
    client, _ = _fresh_stack()
    _seed_traffic(client)
    log = client.chain.events
    proofs = [e for e in log.since(0) if e.kind == "proof_generated"]
    if not proofs:                       # force one through the pipeline
        client.target.settle_session()
        proofs = [e for e in log.since(0) if e.kind == "proof_generated"]
    assert proofs, "seeding produced no proofs to duplicate"
    p = proofs[0]
    with pytest.raises(SanitizeViolation) as exc:
        log.emit(torch_events.ProofGenerated, time=p.time, shard=p.shard,
                 job=p.job, batch=p.batch, n_txs=p.n_txs, digest=p.digest,
                 sealed_at=p.sealed_at)
    assert exc.value.rule == "R007"


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_clean_session_run_stays_silent(kind):
    client, san = _fresh_stack(SPECS[kind](pt))
    _session(client)
    assert san.n_checks > 0
    # the committed incremental root matches a full refold (R001 path pin)
    st_arrays = san._state()
    if st_arrays is not None:
        assert st_arrays.root() == st_arrays.copy().root()


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_same_traffic_same_checks_as_jax(kind):
    """One session of traffic through both packages' NodeClient, each
    with install_stack: the same number of checks, and both silent."""
    checks = {}
    for package in PACKAGES:
        client, san = _fresh_stack(SPECS[kind](PACKAGES[package][0]),
                                   package)
        _session(client)
        checks[package] = san.n_checks
    assert checks["torch"] == checks["jax"] > 0


@pytest.mark.parametrize("rule", DYNAMIC_RULES)
def test_injection_raises_same_rule_as_jax(rule):
    raised = {}
    for package, (_api, san_mod, events) in PACKAGES.items():
        client, _ = _fresh_stack(package=package)
        _seed_traffic(client)
        violation = (SanitizeViolation if san_mod is None
                     else san_mod.SanitizeViolation)
        with pytest.raises(violation) as exc:
            _inject(rule, client, events)
        raised[package] = exc.value.rule
    assert raised["torch"] == raised["jax"] == rule


def test_env_flag_wires_sanitizer_through_build_stack(monkeypatch):
    monkeypatch.setenv(ENV_FLAG, "1")
    client = pt.NodeClient.from_spec(pt.NodeSpec(), device="cpu")
    san = getattr(client.chain.events, "_sanitizer", None)
    assert san is not None, "REPRO_SANITIZE=1 did not install the sanitizer"
    _seed_traffic(client)
    assert san.n_checks > 0
    monkeypatch.setenv(ENV_FLAG, "0")
    client2 = pt.NodeClient.from_spec(pt.NodeSpec(), device="cpu")
    assert getattr(client2.chain.events, "_sanitizer", None) is None


@pytest.mark.parametrize("branch", ["no-rollup", "vector", "object",
                                    "fabric"])
def test_env_flag_installs_on_every_build_stack_branch(branch, monkeypatch):
    spec = {"no-rollup": pt.NodeSpec(rollup=None),
            "vector": pt.NodeSpec(),
            "object": pt.NodeSpec(chain=pt.ChainSpec(backend="object")),
            "fabric": pt.NodeSpec(shards=pt.ShardSpec(count=2,
                                                      fabric=True))}[branch]
    monkeypatch.setenv(ENV_FLAG, "1")
    chain, rollup = pt.build_stack(spec, device="cpu")
    san = chain.events._sanitizer
    assert san.chain is chain and san.rollup is rollup
    assert (rollup is None) == (branch == "no-rollup")
    if branch == "fabric":
        from repro_torch.core.shards import ShardedRollup
        assert isinstance(rollup, ShardedRollup)
    monkeypatch.setenv(ENV_FLAG, "")
    chain, _ = pt.build_stack(spec, device="cpu")
    assert getattr(chain.events, "_sanitizer", None) is None


def _outputs(client) -> dict:
    ru = client.target
    return {"gas_log": ru.gas_log,
            "blocks": [(b.height, b.n_txs, b.gas_used, b.block_hash)
                       for b in client.chain.blocks],
            "batch_digests": getattr(ru, "batch_digests", None),
            "events": client.events(cursor=0),
            "root": client.state_root()}


@pytest.mark.parametrize("kind", ["vector", "fabric-2"])
def test_sanitized_run_equals_unsanitized(kind, monkeypatch):
    from repro_torch.core.workloads import make_workload
    wl = make_workload("mixed", 400.0, duration=4.0, seed=3, device="cpu")
    outs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv(ENV_FLAG, flag)
        client = pt.NodeClient.from_spec(SPECS[kind](pt), device="cpu")
        times = wl.txs.submit_time.numpy()
        for w in range(4):
            lo, hi = np.searchsorted(times, [w, w + 1.0])
            client.submit_arrays(wl.txs.select(slice(int(lo), int(hi))))
            client.seal()
            client.run_until(w + 1.0)
        client.flush()
        client.run_until(40.0)
        san = getattr(client.chain.events, "_sanitizer", None)
        assert (san is not None) == (flag == "1")
        if san is not None:
            assert san.n_checks > 0
        outs[flag] = _outputs(client)
    assert outs["1"] == outs["0"]


def test_clean_fused_scheduler_run_stays_silent(monkeypatch):
    """A default Scheduler run (fused loop, splice path included) under
    the sanitizer: no violations, and the spliced stream keeps
    seq == position."""
    from repro_torch.data.synthetic import gaussian_clusters
    from repro_torch.fl.cohort import VectorCohort, batched_batch_fn
    from repro_torch.fl.dp import DPConfig
    from repro_torch.fl.scheduler import Scheduler
    from repro_torch.fl.server import AutoDFL
    from repro_torch.models.mlp import TinyMLP
    from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

    monkeypatch.setenv(ENV_FLAG, "1")
    model = TinyMLP(16, 8, 4, device="cpu")
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0))
    tr_x, tr_y = gaussian_clusters(256, 16, 4, seed=1, noise=0.5)
    vx, vy = gaussian_clusters(64, 16, 4, seed=2, noise=0.5)
    val = {"x": vx, "labels": vy}

    def bf(c, r):
        g = np.random.default_rng((c * 9973 + r) % 2**31)
        idx = g.integers(0, len(tr_x), 8)
        return {"x": tr_x[idx], "labels": tr_y[idx]}

    node = AutoDFL(model, opt, 4, model.accuracy_fn(), val,
                   spec=pt.NodeSpec(), device="cpu")
    san = getattr(node.chain.events, "_sanitizer", None)
    assert san is not None
    cohort = VectorCohort(model, opt, batched_batch_fn(bf, local_steps=2,
                                                       device="cpu"),
                          node.store, behaviors=["good"] * 4, local_steps=2,
                          dp=DPConfig(noise_multiplier=0.05), seed=0,
                          device="cpu")
    sch = Scheduler(node, seal_every=2, fused=True)
    sch.add_task("t0", cohort, rounds=2)
    out = sch.run()
    assert out["t0"] is not None
    assert san.n_checks > 0
    evs = node.chain.events.since(0)
    assert [e.seq for e in evs] == list(range(len(evs)))
