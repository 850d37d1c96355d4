"""Typed node-construction specs of the port: the ledger part of
``src/repro/api/specs.py``.

Specs are data: frozen, comparable, serializable (``asdict``).  A node is
a ``NodeSpec`` of a ``ChainSpec`` (the L1), an optional ``RollupSpec``
(the L2 sequencer) and an optional ``ProverSpec`` (the proof pipeline),
handed to ``repro_torch.api.build_ledger`` or ``NodeClient.from_spec``.

``ShardSpec``, ``ReputationSpec``, ``DONSpec``, ``FLTaskSpec``,
``AdmissionSpec`` and ``ServeSpec`` are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.gas import DEFAULT_GAS, ROLLUP_BATCH, GasTable
from repro_torch.core.prover import FINALIZE_MODES
from repro_torch.core.state import DIGEST_BACKENDS

#: engine paths a ChainSpec can select
CHAIN_BACKENDS = ("vector", "object")


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """L1 permissioned chain: QBFT quorum + gas-limited FIFO blocks.

    ``backend="vector"`` is the SoA engine (core/engine.VectorChain);
    ``"object"``, the per-Tx simulator, is not ported yet and raises at
    build time.
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
class NodeSpec:
    """A ledger node: L1 + optional L2 + optional proof pipeline, and the
    background traffic it is driven with."""

    chain: ChainSpec = dataclasses.field(default_factory=ChainSpec)
    rollup: Optional[RollupSpec] = dataclasses.field(
        default_factory=RollupSpec)
    prover: Optional[ProverSpec] = None     # None = default proof pipeline
    workload: Optional[WorkloadSpec] = None     # background traffic

    def __post_init__(self):
        if self.prover is not None and self.rollup is None:
            raise ValueError("a ProverSpec needs a RollupSpec (the proof "
                             "pipeline settles sealed L2 batches)")
        if self.rollup is not None and self.chain.backend == "object":
            if self.rollup.n_lanes != 1:
                raise ValueError("n_lanes > 1 needs the vector backend")
            if self.rollup.digest_backend != "auto":
                raise ValueError("digest_backend is a vector-backend knob")

    def describe(self) -> Dict[str, Any]:
        """JSON-friendly summary."""
        d = dataclasses.asdict(self)
        d["chain"].pop("gas_table", None)       # calibration table, not data
        return d
