"""Interconnect model: per-link latency/bandwidth for the sharded fabric.

A copy of the JAX package's ``src/repro/core/interconnect.py``: host
bookkeeping only, so the port's wire logs equal the reference's.

The ``ShardedRollup`` fabric (core/shards.py) moves three kinds of bytes
between participants that, on real deployments, sit on different machines:

  * **shard -> L1**: per-window root gathering — each shard ships its
    partition root (and its sealed-batch commit metadata) to the L1
    aggregator that merges the fabric root;
  * **shard <-> shard**: cross-shard settlement — the end-of-window
    ``sync_book_to_state`` scatter writes reputation/balance/stake rows
    that span every shard's state partition;
  * **cohort -> shard**: trainer cohorts submitting protocol transactions
    into their task's pinned shard.

A single host simulates all of that with memcpy, so the modeled fabric
wall-clock would silently pretend wires are free.  ``Interconnect``
makes the wire cost explicit: every link is a ``LinkSpec`` (fixed
latency + bandwidth), every logical transfer is accounted as

    transfer_time(bytes) = latency_s + bytes / bandwidth_Bps

and concurrent same-window transfers over DISTINCT links overlap (the
fabric charges the max, mirroring how shard lanes overlap in
``ShardedRollup.latency``), while transfers over one link serialize
(sum).  ``benchmarks/bench_shards.py`` folds these costs into the
measured wall-clock scaling section as the honest latency decomposition:
``root_gather_s`` + ``settle_scatter_s`` per window on top of the
measured per-lane seal walls.

The accounting is deterministic — byte counts derive from tx/row counts,
never from timers — so fused and stepped runs of one schedule record the
same transfers (per-kind sequences and totals match bit-for-bit; only
the interleaving differs, because the fused loop defers window merges to
``execute()``), and CI can assert on the decomposition.  The model
NEVER feeds back into ``ShardedRollup.latency`` / ``throughput`` (the
Table-II modeled numbers stay calibrated against the paper); it is a
parallel ledger of what crossing the fabric would cost.

Defaults approximate a single-datacenter deployment (100us, 10 Gbit/s
links); ``repro_torch.api.ShardSpec(interconnect=...)`` overrides per node.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

#: bytes per transaction on the wire: the SoA word buffer's 4 u32 words
#: (time, gas, fn, sender — core/engine.TxArrays.word_buffer)
TX_WIRE_BYTES = 16
#: bytes per shipped root: a 32-hex-char commitment + framing
ROOT_WIRE_BYTES = 64
#: bytes per scattered state row: ids + reputation + balance + stake
#: (i64 + f32 + f64 + f64, padded to a wire word)
STATE_ROW_WIRE_BYTES = 32


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One directed link class: fixed latency + bandwidth."""

    latency_s: float = 100e-6           # same-DC RTT/2
    bandwidth_Bps: float = 1.25e9       # 10 Gbit/s

    def __post_init__(self):
        if self.latency_s < 0:
            raise ValueError("link latency must be >= 0")
        if self.bandwidth_Bps <= 0:
            raise ValueError("link bandwidth must be > 0")

    def transfer_time(self, n_bytes: int) -> float:
        """Seconds to move ``n_bytes`` over this link."""
        return self.latency_s + n_bytes / self.bandwidth_Bps


@dataclasses.dataclass(frozen=True)
class InterconnectSpec:
    """The fabric's three link classes (see module docstring)."""

    shard_l1: LinkSpec = LinkSpec()
    shard_shard: LinkSpec = LinkSpec()
    cohort_shard: LinkSpec = LinkSpec()

    def build(self, n_shards: int) -> "Interconnect":
        return Interconnect(self, n_shards)


class Interconnect:
    """Deterministic wire-cost accumulator for one fabric instance.

    Three recording entry points, one per traffic class; each returns the
    modeled seconds the transfer would take, and appends a wire-log row.
    ``window_cost`` folds one window's transfers the way the fabric
    overlaps them: per-shard transfers over distinct links take the max,
    the L1-side merge serializes after the slowest gather.
    """

    def __init__(self, spec: InterconnectSpec, n_shards: int):
        self.spec = spec
        self.n_shards = n_shards
        self.log: List[Dict[str, Any]] = []
        self.totals = {"root_gather_s": 0.0, "settle_scatter_s": 0.0,
                       "submit_s": 0.0, "bytes": 0}

    # -- per-transfer recording ------------------------------------------------
    def record_root_gather(self, window: int,
                           shard_batches: List[int]) -> float:
        """One window's root gather: every shard ships its partition root
        plus one commit record per sealed batch to the L1 merger over its
        own shard->L1 link (distinct links overlap -> max), and the L1
        folds the K roots serially (K * latency on the merge side)."""
        link = self.spec.shard_l1
        per_shard = [link.transfer_time(
            ROOT_WIRE_BYTES + ROOT_WIRE_BYTES * int(nb))
            for nb in shard_batches]
        gather = max(per_shard, default=0.0)
        merge = self.n_shards * link.latency_s
        cost = gather + merge
        n_bytes = sum(ROOT_WIRE_BYTES + ROOT_WIRE_BYTES * int(nb)
                      for nb in shard_batches)
        self.log.append({"kind": "root_gather", "window": window,
                         "bytes": n_bytes, "cost_s": cost})
        self.totals["root_gather_s"] += cost
        self.totals["bytes"] += n_bytes
        return cost

    def record_settle_scatter(self, n_rows: int) -> float:
        """Cross-shard settlement scatter: ``n_rows`` state rows fan out
        over the shard<->shard mesh.  Rows split evenly across the K
        destination partitions (account_owner is uniform over ids); the
        K per-destination writes overlap -> the cost is the slowest
        (ceil) share's transfer."""
        link = self.spec.shard_shard
        share = -(-int(n_rows) // max(self.n_shards, 1))
        cost = link.transfer_time(STATE_ROW_WIRE_BYTES * share) \
            if n_rows else 0.0
        n_bytes = STATE_ROW_WIRE_BYTES * int(n_rows)
        self.log.append({"kind": "settle_scatter", "rows": int(n_rows),
                         "bytes": n_bytes, "cost_s": cost})
        self.totals["settle_scatter_s"] += cost
        self.totals["bytes"] += n_bytes
        return cost

    def record_submit(self, shard_tx_counts) -> float:
        """Cohort->shard submission: per-tx wire bytes over each target
        shard's cohort link; distinct shard links overlap -> max."""
        link = self.spec.cohort_shard
        costs = [link.transfer_time(TX_WIRE_BYTES * int(c))
                 for c in shard_tx_counts if c]
        cost = max(costs, default=0.0)
        n_bytes = TX_WIRE_BYTES * int(sum(int(c) for c in shard_tx_counts))
        self.log.append({"kind": "submit", "bytes": n_bytes,
                         "cost_s": cost})
        self.totals["submit_s"] += cost
        self.totals["bytes"] += n_bytes
        return cost

    # -- summaries ---------------------------------------------------------------
    def window_costs(self) -> List[Tuple[int, float]]:
        """(window, root_gather cost) per recorded window, in order."""
        return [(r["window"], r["cost_s"]) for r in self.log
                if r["kind"] == "root_gather"]

    def summary(self) -> Dict[str, Any]:
        """JSON-friendly totals for the benchmark decomposition."""
        return {
            "n_transfers": len(self.log),
            "total_bytes": int(self.totals["bytes"]),
            "root_gather_s": round(self.totals["root_gather_s"], 6),
            "settle_scatter_s": round(self.totals["settle_scatter_s"], 6),
            "submit_s": round(self.totals["submit_s"], 6),
            "wire_s": round(self.totals["root_gather_s"]
                            + self.totals["settle_scatter_s"]
                            + self.totals["submit_s"], 6),
        }
