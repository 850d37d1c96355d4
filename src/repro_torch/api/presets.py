"""Named NodeSpec presets — each benchmark's scenario as data (the same
eight as ``src/repro/api/presets.py``).

A caller fetches a node configuration here instead of hand-wiring
constructors, and builds it on a device of its choice
(``NodeClient.from_spec(preset(name), device=...)``).

``preset(name, **overrides)`` returns a copy with replaced fields, e.g.
``preset("shard-fabric", shards=ShardSpec(count=2))`` for a 2-shard
fabric.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.api.specs import (ChainSpec, NodeSpec, ProverSpec,
                                   ShardSpec, WorkloadSpec)

#: the benchmark scenario catalog (immutable specs; override per point)
PRESETS: Dict[str, NodeSpec] = {
    # Fig. 4 / Fig. 5: bare L1 saturation sweeps, one per engine path
    "l1-vector": NodeSpec(rollup=None),
    "l1-object": NodeSpec(chain=ChainSpec(backend="object"), rollup=None),
    # Table I / Table II: the paper-faithful object rollup over an object L1
    "rollup-object": NodeSpec(chain=ChainSpec(backend="object")),
    # the SoA rollup (multi-lane latency sweeps override n_lanes)
    "rollup-vector": NodeSpec(),
    # bench_protocol: sequential paper-faithful baseline vs the vectorized
    # scheduler node (funds are scaled per point via preset overrides)
    "protocol-sequential": NodeSpec(chain=ChainSpec(backend="object")),
    "protocol-scheduler": NodeSpec(),
    # bench_shards: the fabric point (shard count overridden per point)
    "shard-fabric": NodeSpec(shards=ShardSpec(count=8),
                             workload=WorkloadSpec.make(
                                 "mixed", 20_000.0, duration=10.0, seed=0)),
    # bench_prover: the proof-aggregation sweep (agg_width overridden per
    # point; the workload is settled in window-sized sessions)
    "prover-pipeline": NodeSpec(prover=ProverSpec(agg_width=8),
                                workload=WorkloadSpec.make(
                                    "mixed", 4_000.0, duration=10.0,
                                    seed=0)),
}


def preset(name: str, **overrides: Any) -> NodeSpec:
    """Fetch a preset, optionally replacing spec fields."""
    try:
        spec = PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; "
                       f"catalog: {sorted(PRESETS)}") from None
    return dataclasses.replace(spec, **overrides) if overrides else spec


def describe_presets() -> Dict[str, Dict]:
    """JSON-friendly catalog: each preset's ``NodeSpec.describe()``."""
    return {name: spec.describe() for name, spec in sorted(PRESETS.items())}
