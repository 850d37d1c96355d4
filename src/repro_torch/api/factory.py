"""One ledger factory: ``build_ledger(spec) -> LedgerBackend``.

    ChainSpec alone (or NodeSpec(rollup=None))   -> VectorChain | Chain
    + RollupSpec                                 -> VectorRollup | Rollup
    + ShardSpec(count > 1 or fabric=True)        -> ShardedRollup

``build_ledger`` returns the SUBMISSION target (the L2 face when a rollup
is configured, else the L1 itself); the rollup keeps its L1 on ``.l1``,
and ``l1_of`` resolves it uniformly.  With ``REPRO_SANITIZE=1``
``build_stack`` installs the runtime sanitizer (analysis/sanitize.py) on
every stack it builds.  ``build_node`` builds the whole
protocol node (``fl/server.AutoDFL``).  Every build function takes
``device``: ``None`` means the CUDA card and raises without one.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

from repro_torch.api.specs import ChainSpec, NodeSpec, ProverSpec
from repro_torch.core.ledger import LedgerBackend
from repro_torch.device import resolve_device

LedgerSpec = Union[NodeSpec, ChainSpec]


def _as_node_spec(spec: LedgerSpec) -> NodeSpec:
    if isinstance(spec, ChainSpec):
        return NodeSpec(chain=spec, rollup=None)
    if isinstance(spec, NodeSpec):
        return spec
    raise TypeError(f"expected NodeSpec or ChainSpec, got {type(spec)!r}")


def build_chain(spec: ChainSpec, *, fns=None, device=None):
    """Build just the L1 from a ChainSpec.  ``fns``: optional engine
    FnRegistry to share (vector backend only; a runtime handle, not spec
    data)."""
    if spec.backend == "vector":
        from repro_torch.core.engine import VectorChain
        return VectorChain(n_validators=spec.n_validators,
                           block_time=spec.block_time,
                           block_gas_limit=spec.block_gas_limit,
                           gas_table=spec.gas_table, fns=fns,
                           device=resolve_device(device))
    from repro_torch.core.ledger import Chain
    return Chain(n_validators=spec.n_validators, block_time=spec.block_time,
                 block_gas_limit=spec.block_gas_limit,
                 gas_table=spec.gas_table, device=resolve_device(device))


def build_stack(spec: LedgerSpec, *, fns=None, state=None, device=None
                ) -> Tuple[object, Optional[object]]:
    """Build (l1_chain, rollup_or_None) from a spec.  ``state``: an
    optional pre-built StateArrays for the sharded fabric."""
    node = _as_node_spec(spec)
    chain = build_chain(node.chain, fns=fns, device=device)
    ru = node.rollup
    if ru is None:
        return _sanitized(chain, None)
    pv = node.prover if node.prover is not None else ProverSpec()
    prove_time = ru.prove_time if pv.prove_time is None else pv.prove_time
    prover_kw = dict(agg_width=pv.agg_width, prover_capacity=pv.capacity,
                     finalize=pv.finalize)
    if node.shards is not None and node.shards.wants_fabric:
        from repro_torch.core.shards import ShardedRollup
        return _sanitized(chain, ShardedRollup(
            chain, n_shards=node.shards.count, batch_size=ru.batch_size,
            gas_table=node.chain.gas_table, prove_time=prove_time,
            per_tx_time=ru.per_tx_time, n_lanes=ru.n_lanes,
            digest_backend=ru.digest_backend, route=node.shards.route,
            state=state, interconnect=node.shards.interconnect,
            mesh=node.shards.mesh, **prover_kw))
    if node.chain.backend == "vector":
        from repro_torch.core.engine import VectorRollup
        return _sanitized(chain, VectorRollup(
            chain, batch_size=ru.batch_size, gas_table=node.chain.gas_table,
            prove_time=prove_time, per_tx_time=ru.per_tx_time,
            n_lanes=ru.n_lanes, digest_backend=ru.digest_backend,
            **prover_kw))
    from repro_torch.core.rollup import Rollup
    return _sanitized(chain, Rollup(chain, batch_size=ru.batch_size,
                                    gas_table=node.chain.gas_table,
                                    prove_time=prove_time,
                                    per_tx_time=ru.per_tx_time, **prover_kw))


def _sanitized(chain, rollup):
    """REPRO_SANITIZE=1 installs the runtime sanitizer on every stack
    this factory builds (see analysis/sanitize.py; a no-op otherwise)."""
    from repro_torch.analysis import sanitize
    if sanitize.enabled():
        sanitize.install_stack(chain, rollup)
    return chain, rollup


def build_ledger(spec: LedgerSpec, *, fns=None, state=None,
                 device=None) -> LedgerBackend:
    """THE ledger factory: spec -> the LedgerBackend you submit to (the L2
    face when the spec configures a rollup, else the L1)."""
    chain, rollup = build_stack(spec, fns=fns, state=state, device=device)
    return rollup if rollup is not None else chain


def l1_of(backend) -> object:
    """The L1 chain behind any backend built by ``build_ledger``."""
    return getattr(backend, "l1", backend)


def build_node(spec: NodeSpec, model, opt, eval_fn, val_batch, *,
               device=None, **kw):
    """Build a full protocol node (``fl/server.AutoDFL``) from a NodeSpec
    on ``device`` (the CUDA card unless named; raises without one).

    ``spec.n_trainers`` is required here (the ledger-only factories
    don't need it).  Extra ``kw`` are forwarded to AutoDFL.
    """
    if spec.n_trainers is None:
        raise ValueError("build_node needs spec.n_trainers")
    from repro_torch.fl.server import AutoDFL
    return AutoDFL(model, opt, spec.n_trainers, eval_fn, val_batch,
                   spec=spec, device=device, **kw)
