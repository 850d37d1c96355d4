"""Typed node-construction specs of the port (``src/repro/api/specs.py``).

Specs are data: frozen, comparable, serializable (``asdict``).  A node is
a ``NodeSpec`` of a ``ChainSpec`` (the L1), an optional ``RollupSpec``
(the L2 sequencer), an optional ``ProverSpec`` (the proof pipeline) and
an optional ``ShardSpec`` (the sharded fabric over that L2),
with the FL protocol's constants (``ReputationSpec``, ``DONSpec``, funds,
trainer count), handed to ``repro_torch.api.build_ledger``,
``NodeClient.from_spec`` or ``repro_torch.fl.server.AutoDFL``.
``FLTaskSpec`` describes one FL task.

``NodeSpec.from_legacy`` maps the old ``AutoDFL`` flag kwargs onto a
spec (the object stack by default, as in the JAX package).
``AdmissionSpec`` and ``ServeSpec`` configure the node service
(``repro_torch.serve``).  No spec names a device: the constructors take
``device=`` (``NodeClient.from_spec``, ``NodeService``, ``build_node``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.gas import DEFAULT_GAS, ROLLUP_BATCH, GasTable
from repro_torch.core.interconnect import InterconnectSpec
from repro_torch.core.oracle import DONConfig
from repro_torch.core.prover import FINALIZE_MODES
from repro_torch.core.reputation import ReputationParams
from repro_torch.core.shards import MESH_MODES
from repro_torch.core.state import DIGEST_BACKENDS

#: engine paths a ChainSpec can select
CHAIN_BACKENDS = ("vector", "object")


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """L1 permissioned chain: QBFT quorum + gas-limited FIFO blocks.

    ``backend="vector"`` is the SoA engine (core/engine.VectorChain);
    ``"object"`` the per-Tx simulator (core/ledger.Chain).  Both pack the
    same blocks from the same transactions.
    """

    backend: str = "vector"
    n_validators: int = 4
    block_time: float = 1.0
    block_gas_limit: int = 9_000_000
    gas_table: GasTable = DEFAULT_GAS

    def __post_init__(self):
        if self.backend not in CHAIN_BACKENDS:
            raise ValueError(f"unknown chain backend {self.backend!r}; "
                             f"choose from {CHAIN_BACKENDS}")


@dataclasses.dataclass(frozen=True)
class RollupSpec:
    """L2 zk-rollup sequencer.  ``NodeSpec(rollup=None)`` is the
    single-layer L1 baseline.

    ``digest_backend``: ``"auto"`` follows the stack's device (the CUDA
    kernels on the card, their plain versions on the CPU); ``"cuda"`` or
    ``"torch"`` names the kernel-factory impl.
    """

    batch_size: int = ROLLUP_BATCH
    n_lanes: int = 1
    prove_time: float = 0.9
    per_tx_time: float = 0.14
    digest_backend: str = "auto"        # "auto" | "cuda" | "torch"

    def __post_init__(self):
        if self.n_lanes < 1:
            raise ValueError("n_lanes must be >= 1")
        if self.digest_backend not in DIGEST_BACKENDS:
            raise ValueError(f"unknown digest backend "
                             f"{self.digest_backend!r}; choose from "
                             f"{DIGEST_BACKENDS}")


@dataclasses.dataclass(frozen=True)
class ProverSpec:
    """Proof pipeline (core/prover.py).

    ``agg_width``: settle-sessions folded into one aggregate proof, whose
    single L1 verify amortizes across every batch it covers.
    ``capacity``/``prove_time``: the modeled prover (``None`` inherits
    ``RollupSpec.prove_time``).  ``finalize``: ``"eager"`` posts as soon
    as ``agg_width`` sessions close; ``"window"`` defers posting to
    window-clock pumps (``flush`` always forces the remainder).
    """

    agg_width: int = 1
    capacity: int = 1
    prove_time: Optional[float] = None
    finalize: str = "eager"             # "eager" | "window"

    def __post_init__(self):
        if self.agg_width < 1:
            raise ValueError("agg_width must be >= 1")
        if self.capacity < 1:
            raise ValueError("prover capacity must be >= 1")
        if self.finalize not in FINALIZE_MODES:
            raise ValueError(f"unknown finalize mode {self.finalize!r}; "
                             f"choose from {FINALIZE_MODES}")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Sharded rollup fabric (core/shards.py): K sequencers, one L1.

    ``count=1`` without ``fabric=True`` means a plain rollup;
    ``fabric=True`` builds the ``ShardedRollup`` even at one shard
    (bit-equivalent to ``VectorRollup``, with fabric roots and per-shard
    receipts).

    ``mesh``: whether the fused window loop folds the K lanes' seals
    through the mesh impl of ``shard_seal`` (kernels/shard_lanes.py over
    launch/mesh.make_shard_mesh): ``"auto"`` where more than one card is
    visible, ``"on"`` always; ``"off"`` and a single card leave the
    choice to the kernel factory.  Every impl gives the same bits.

    ``interconnect`` (core/interconnect.InterconnectSpec) overrides the
    fabric's modeled wire costs; ``None`` means the default links.
    """

    count: int = 1
    route: str = "hash"                 # "hash" | "least_loaded"
    fabric: bool = False
    mesh: str = "auto"                  # "auto" | "on" | "off"
    interconnect: Optional[InterconnectSpec] = None

    def __post_init__(self):
        if self.count < 1:
            raise ValueError("shard count must be >= 1")
        if self.route not in ("hash", "least_loaded"):
            raise ValueError(f"unknown shard route {self.route!r}")
        if self.mesh not in MESH_MODES:
            raise ValueError(f"unknown shard mesh mode {self.mesh!r}; "
                             f"choose from {MESH_MODES}")

    @property
    def wants_fabric(self) -> bool:
        return self.fabric or self.count > 1


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A core/workloads.py scenario, as data.  ``options`` are the
    scenario factory's extra kwargs, as a sorted item tuple."""

    scenario: str = "poisson"
    rate: float = 100.0
    duration: float = 30.0
    seed: int = 0
    options: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def make(cls, scenario: str, rate: float, duration: float = 30.0,
             seed: int = 0, **options) -> "WorkloadSpec":
        return cls(scenario, rate, duration, seed,
                   tuple(sorted(options.items())))

    def build(self, device=None):
        """Materialize the Workload, its batch on ``device`` (the card
        unless named)."""
        from repro_torch.core.workloads import make_workload
        return make_workload(self.scenario, self.rate,
                             duration=self.duration, seed=self.seed,
                             device=device, **dict(self.options))


@dataclasses.dataclass(frozen=True)
class ReputationSpec(ReputationParams):
    """Paper Eq. 2-10 constants, as a spec (field docs on
    core/reputation.ReputationParams)."""

    def to_params(self) -> ReputationParams:
        return ReputationParams(**dataclasses.asdict(self))

    @classmethod
    def from_params(cls, p: ReputationParams) -> "ReputationSpec":
        return cls(**dataclasses.asdict(p))


@dataclasses.dataclass(frozen=True)
class DONSpec(DONConfig):
    """Decentralized oracle network quorum config (core/oracle.DONConfig)."""

    def to_config(self) -> DONConfig:
        return DONConfig(**dataclasses.asdict(self))

    @classmethod
    def from_config(cls, c: DONConfig) -> "DONSpec":
        return cls(**dataclasses.asdict(c))


@dataclasses.dataclass(frozen=True)
class FLTaskSpec:
    """One FL task's lifecycle parameters (paper Fig. 1 steps 1-16),
    consumed by ``AutoDFL.run_task`` and ``Scheduler.add_task``."""

    task_id: str
    rounds: int = 5
    reward: float = 10.0
    n_select: Optional[int] = None
    start_window: int = 0
    init_seed: int = 0


def as_task_spec(task, **kw) -> FLTaskSpec:
    """A task-id string plus loose kwargs becomes an FLTaskSpec (defaults
    live on FLTaskSpec alone); an FLTaskSpec passes through, rejecting
    extra kwargs it would otherwise shadow."""
    if isinstance(task, str):
        return FLTaskSpec(task, **{k: v for k, v in kw.items()
                                   if v is not None})
    if not isinstance(task, FLTaskSpec):
        raise TypeError(f"expected task id or FLTaskSpec, got {task!r}")
    extra = {k for k, v in kw.items() if v is not None}
    if extra:
        raise ValueError(f"kwargs {sorted(extra)} conflict with the "
                         f"FLTaskSpec; set them on the spec")
    return task


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """A node: L1 + optional L2 + optional proof pipeline + optional
    sharded fabric, the FL protocol's constants, and the background
    traffic it is driven with.

    ``n_trainers=None`` defers the cohort size to ``AutoDFL``'s positional
    argument.  ``use_pallas_agg`` is kept so that specs and ``describe()``
    match the JAX package's, but it chooses no code in the port: Eq. 1
    always runs through the kernel factory's ``weighted_agg`` op (the CUDA
    kernel on the card).
    """

    chain: ChainSpec = dataclasses.field(default_factory=ChainSpec)
    rollup: Optional[RollupSpec] = dataclasses.field(
        default_factory=RollupSpec)
    prover: Optional[ProverSpec] = None     # None = default proof pipeline
    shards: Optional[ShardSpec] = None
    reputation: ReputationSpec = dataclasses.field(
        default_factory=ReputationSpec)
    don: DONSpec = dataclasses.field(default_factory=DONSpec)
    n_trainers: Optional[int] = None
    trainer_funds: float = 10.0
    publisher_funds: float = 1000.0
    seed: int = 0
    use_pallas_agg: bool = False
    workload: Optional[WorkloadSpec] = None     # background traffic
    tasks: Tuple[FLTaskSpec, ...] = ()          # declarative task set

    def __post_init__(self):
        if self.prover is not None and self.rollup is None:
            raise ValueError("a ProverSpec needs a RollupSpec (the proof "
                             "pipeline settles sealed L2 batches)")
        if self.shards is not None and self.shards.wants_fabric:
            if self.rollup is None:
                raise ValueError("a sharded fabric needs a RollupSpec")
            if self.chain.backend != "vector":
                raise ValueError("sharding needs the vector chain backend")
        if self.rollup is not None and self.chain.backend == "object":
            if self.rollup.n_lanes != 1:
                raise ValueError("n_lanes > 1 needs the vector backend")
            if self.rollup.digest_backend != "auto":
                raise ValueError("digest_backend is a vector-backend knob")

    # -- legacy flag mapping (the deprecation shim's single source) --------
    @classmethod
    def from_legacy(cls, *, engine: str = "object", use_rollup: bool = True,
                    n_shards: int = 1, shard_route: str = "hash",
                    rep_params: Optional[ReputationParams] = None,
                    don: Optional[DONConfig] = None,
                    trainer_funds: float = 10.0,
                    publisher_funds: float = 1000.0, seed: int = 0,
                    use_pallas_agg: bool = False) -> "NodeSpec":
        """Map the old AutoDFL kwargs onto a NodeSpec (``n_shards > 1``
        builds the sharded fabric)."""
        shards = (ShardSpec(count=n_shards, route=shard_route)
                  if n_shards > 1 else None)
        return cls(
            chain=ChainSpec(backend=engine),
            rollup=RollupSpec() if use_rollup else None,
            shards=shards,
            reputation=(ReputationSpec.from_params(rep_params)
                        if rep_params is not None else ReputationSpec()),
            don=(DONSpec.from_config(don) if don is not None else DONSpec()),
            trainer_funds=trainer_funds, publisher_funds=publisher_funds,
            seed=seed, use_pallas_agg=use_pallas_agg)

    def describe(self) -> Dict[str, Any]:
        """JSON-friendly summary."""
        d = dataclasses.asdict(self)
        d["chain"].pop("gas_table", None)       # calibration table, not data
        return d


#: reputation-gate policies an AdmissionSpec can select
REP_GATES = ("off", "surcharge", "reject")


@dataclasses.dataclass(frozen=True)
class AdmissionSpec:
    """Mempool admission rules for the node service (repro_torch/serve).

    Every rule is a pure function of (this spec, the sender's modeled
    state, the pending pool) — no wall clock anywhere on the decision
    path; the token bucket refills on the MODELED submit
    time, the same window clock the ledgers run on.

      * ``rate_limit``/``burst`` — per-sender token bucket: ``burst``
        tokens deep, refilling ``rate_limit`` tokens per modeled second;
        each transaction consumes one token.
      * ``fee_floor`` — minimum offered fee (gas) for any transaction.
      * ``rep_gate`` — senders whose reputation is below the trust line
        (``ReputationParams.r_min``; unknown senders start at ``r_init``)
        are ``"reject"``-ed outright, or under ``"surcharge"`` must
        offer at least ``rep_surcharge`` x the function's intrinsic gas;
        ``"off"`` disables the gate.
      * ``pool_cap``/``evict`` — the pending pool holds at most
        ``pool_cap`` admitted transactions per flush window; at cap,
        ``evict=True`` drops the lowest-fee entry to make room for a
        strictly higher-fee arrival (spam eviction — spam floods the
        cheapest function, so it drains first), ``evict=False`` rejects
        the arrival as overloaded instead.
    """

    rate_limit: float = 50.0
    burst: float = 20.0
    fee_floor: int = 0
    rep_gate: str = "surcharge"
    rep_surcharge: float = 1.5
    pool_cap: int = 4096
    evict: bool = True

    def __post_init__(self):
        if self.rate_limit <= 0 or self.burst < 1:
            raise ValueError("rate_limit must be > 0 and burst >= 1")
        if self.rep_gate not in REP_GATES:
            raise ValueError(f"unknown rep_gate {self.rep_gate!r}; "
                             f"choose from {REP_GATES}")
        if self.rep_surcharge < 1.0:
            raise ValueError("rep_surcharge must be >= 1.0")
        if self.pool_cap < 1:
            raise ValueError("pool_cap must be >= 1")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """One concurrent node service (repro_torch/serve.NodeService): the node it
    fronts, its admission rules, and the serving knobs.

      * ``queue_cap`` — bound of the single-writer op queue; a submit
        arriving while the queue is full gets an explicit
        ``overloaded``/HTTP-429 response (the backpressure contract).
      * ``window`` — modeled seconds between pool flushes: the service
        drains the admitted pool into the ledger, seals, and pumps
        ``run_until`` at every window boundary the modeled clock
        crosses.
      * ``event_cap`` — bounds the stack's EventLog as a ring buffer so
        long-lived multi-consumer serving cannot grow it without limit
        (``None`` keeps the default unbounded log).
    """

    node: NodeSpec = dataclasses.field(default_factory=NodeSpec)
    admission: AdmissionSpec = dataclasses.field(
        default_factory=AdmissionSpec)
    host: str = "127.0.0.1"
    port: int = 8545
    queue_cap: int = 1024
    window: float = 1.0
    event_cap: Optional[int] = None

    def __post_init__(self):
        if self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        if self.window <= 0:
            raise ValueError("window must be > 0 modeled seconds")
        if self.event_cap is not None and self.event_cap < 1:
            raise ValueError("event_cap must be >= 1 (or None)")
