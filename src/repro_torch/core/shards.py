"""Sharded rollup fabric: K L2 sequencers over one L1, one array state.

The port of ``src/repro/core/shards.py``.  ``ShardedRollup`` scales the L2
past one sequencer: K ``VectorRollup`` shards each own

  * their own sequencer lanes (batches seal concurrently within a shard
    and across shards: the fabric's latency is the slowest shard's),
  * a partition of the account state (``StateArrays`` rows; owner =
    ``state.account_owner`` of the account id, mod K),

and all post their commit, verify and execute transactions to ONE shared
L1 ``VectorChain``.

Routing: per-tx ``hash`` (``account_owner`` of the sender id: a sender's
txs land on the shard that owns its state rows) or ``least_loaded``
(whole submissions to the shard with the fewest submitted txs); the FL
protocol pins every tx of a task to one shard (``assign_task`` +
``submit_arrays(..., shard=k)``).  Hash routing runs on the device: the
lanes are computed there, one ``bincount`` of them comes to the host (the
per-shard counts feed ``_submitted`` and the wire model), and the batch is
split by a stable sort on the lane, so each shard gets its txs in arrival
order (sequence numbers and receipts depend on it).

Commitment: every ``seal()`` records a fabric root, one sha256 over the K
partition roots (``StateArrays.partition_roots``), in ``fabric_roots``.
The flat state root is chunked independently of K, so the same tx set
commits to the same state root at any shard count; state handlers must
therefore be per-account commutative (core/state.py).

One shard is bit-equivalent to a plain ``VectorRollup`` (same gas log, L1
stream and digests).  Every integer output equals the JAX package's on
the same inputs.
"""
from __future__ import annotations

import hashlib
import math
from functools import reduce
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (FnRegistry, TxArrays, VectorRollup,
                                     _remap)
from repro_torch.core.events import EventLog, WindowSettled
from repro_torch.core.gas import DEFAULT_GAS, ROLLUP_BATCH, GasTable
from repro_torch.core.interconnect import InterconnectSpec
from repro_torch.core.ledger import EventHooks
from repro_torch.core.prover import ProverPipeline
from repro_torch.core.state import StateArrays, account_owner, group_by

#: the fabric's ``mesh`` knob (core/fused.py ``_shard_seal_impl``)
MESH_MODES = ("auto", "on", "off")


def _hash_route(sender_id: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Stable per-tx shard (int64, on the ids' device):
    ``state.account_owner``, the partition function the partition roots
    commit rows with, so a sender's txs land on the shard that owns its
    state rows."""
    return account_owner(sender_id, n_shards)


class ShardedRollup(EventHooks):
    """K-shard L2 fabric over one shared L1 (LedgerBackend face)."""

    soa_native = True
    # the fused loop replays the fabric as K lanes: routing decisions are
    # taken at record time against the live ``_submitted`` counters, and
    # execute() seals the lanes per window in shard order before
    # ``_finish_window``, as a stepped seal does
    fused_capable = True

    def __init__(self, l1, n_shards: int = 1,
                 batch_size: int = ROLLUP_BATCH,
                 gas_table: GasTable = DEFAULT_GAS,
                 prove_time: float = 0.9, per_tx_time: float = 0.14,
                 n_lanes: int = 1, digest_backend: str = "auto",
                 route: str = "hash",
                 state: Optional[StateArrays] = None,
                 agg_width: int = 1, prover_capacity: int = 1,
                 finalize: str = "eager",
                 interconnect: Optional[InterconnectSpec] = None,
                 mesh: str = "auto"):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if route not in ("hash", "least_loaded"):
            raise ValueError(f"unknown shard route {route!r}")
        if mesh not in MESH_MODES:
            raise ValueError(f"unknown shard mesh mode {mesh!r}; choose "
                             f"from {MESH_MODES}")
        self.l1 = l1
        self.device = l1.device
        self.n_shards = n_shards
        self.route = route
        l1_fns = getattr(l1, "fns", None)
        self.fns: FnRegistry = l1_fns if l1_fns is not None else FnRegistry()
        # ONE typed event stream and ONE prover pipeline for the fabric:
        # shard events interleave in the L1's log, and proof ids are
        # fabric-wide (each shard still closes its own sessions)
        l1_events = getattr(l1, "events", None)
        self.events = l1_events if l1_events is not None else EventLog()
        self.prover = ProverPipeline(
            gas_table, agg_width=agg_width, capacity=prover_capacity,
            prove_time=prove_time, finalize=finalize, events=self.events)
        self.shards: List[VectorRollup] = []
        for k in range(n_shards):
            s = VectorRollup(l1, batch_size=batch_size, gas_table=gas_table,
                             prove_time=prove_time, per_tx_time=per_tx_time,
                             n_lanes=n_lanes, digest_backend=digest_backend,
                             prover=self.prover)
            s.fns = self.fns          # one fn namespace across the fabric
            s._event_shard = k        # shard tag on the shard's events
            s._suppress_window_event = True   # the fabric's is the window
            self.shards.append(s)
        self.batch_size = batch_size
        self.gas_table = gas_table
        # ONE fabric-wide sender namespace: ids index StateArrays rows AND
        # drive hash routing
        self._sender_ids: Dict[str, int] = {}
        self.state = state
        self.task_shard: Dict[str, int] = {}
        self._task_counts = np.zeros(n_shards, np.int64)
        self._submitted = np.zeros(n_shards, np.int64)
        self.fabric_roots: List[Dict[str, Any]] = []
        self._window = 0
        # the wire-cost model (core/interconnect.py): a parallel ledger of
        # what crossing the fabric would cost; never feeds latency()
        self.interconnect = (interconnect if interconnect is not None
                             else InterconnectSpec()).build(n_shards)
        # whether the fused loop folds the K lanes' seals through the
        # mesh impl of shard_seal (kernels/shard_lanes.py)
        self.mesh_mode = mesh
        self._init_events()

    # -- events (NodeClient subscription hook) ---------------------------------
    def subscribe(self, event: str, callback: Callable) -> None:
        """``"window_settled"`` fires once per fabric seal (payload = the
        fabric-root record); ``"batch_sealed"`` and ``"session_settled"``
        forward from every shard with a ``"shard"`` key added."""
        if event == "window_settled":
            self._subs.setdefault(event, []).append(callback)
            return
        for k, s in enumerate(self.shards):
            s.subscribe(event,
                        lambda payload, k=k: callback(dict(payload, shard=k)))

    # -- LedgerBackend surface -------------------------------------------------
    def sender_id(self, sender: str) -> int:
        return self._sender_ids.setdefault(sender, len(self._sender_ids))

    def register_state(self, fn: str, handler: Callable):
        """Attach a StateArrays handler to every shard, all writing the ONE
        fabric state (on the fabric's device, dirty tracking on).
        Handlers must be per-account commutative: each shard executes
        only the txs routed to it."""
        if self.state is None:
            self.state = StateArrays(device=self.device)
            self.state.enable_dirty_tracking()
        for s in self.shards:
            s.state_arrays = self.state
            s.register_state(fn, handler)

    def submit(self, tx):
        """Object-Tx compatibility shim (fabric sender namespace)."""
        batch = TxArrays.from_txs([tx], self.fns, self.device)
        batch.sender_id.fill_(self.sender_id(tx.sender))
        return self.submit_arrays(batch)

    def submit_arrays(self, batch: TxArrays, shard: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Route a SoA batch into the fabric.

        ``shard=k`` pins the whole batch (task-level routing); otherwise
        ``hash`` splits it per tx by sender and ``least_loaded`` sends it
        to the shard with the fewest submitted txs.

        Returns per-tx provenance in input order: ``(shard_of, seq_of)``,
        int64 tensors on the fabric's device: the owning shard and the
        sequence number that shard assigned, which receipts resolve to
        batches through ``shards[k].batch_of_seq``."""
        return self._route(_remap(batch, self.fns, self.device), shard,
                           lambda k, b: self.shards[k].submit_arrays(b))

    def _route(self, batch: TxArrays, shard: Optional[int],
               stage: Callable[[int, TxArrays], Tuple[int, int]]):
        """The routing decision for one batch (fns already remapped):
        ``_submitted`` and the wire model updated, each shard's part
        handed to ``stage(k, part)``, which returns the part's ``[lo,
        hi)`` sequence range: the shard's own ``submit_arrays`` here, the
        fused loop's journal at record time (core/fused.py)."""
        dev = self.device
        n = len(batch)
        if shard is None and self.route == "least_loaded":
            shard = int(np.argmin(self._submitted))
        if shard is not None or self.n_shards == 1:
            k = int(shard or 0)
            self._submitted[k] += n
            pinned = np.zeros(self.n_shards, np.int64)
            pinned[k] = n
            self._wire_submit(pinned)
            lo, hi = stage(k, batch)
            return (torch.full((n,), k, dtype=torch.int64, device=dev),
                    torch.arange(lo, hi, dtype=torch.int64, device=dev))
        # the tx indices by shard, in arrival order (a stable sort), and
        # one host copy of the counts
        lanes = _hash_route(batch.sender_id, self.n_shards)
        order, counts = group_by(lanes, self.n_shards)
        self._wire_submit(counts)
        seqs = []
        for k, idx in enumerate(torch.split(order, counts)):
            if counts[k]:
                self._submitted[k] += counts[k]
                lo, hi = stage(k, batch.select(idx))
                seqs.append(torch.arange(lo, hi, dtype=torch.int64,
                                         device=dev))
        seq_of = torch.empty(n, dtype=torch.int64, device=dev)
        if seqs:
            seq_of[order] = torch.cat(seqs)
        return lanes, seq_of

    def _wire_submit(self, counts) -> None:
        """Account the cohort->shard wire cost of one routed submission
        (``counts``: txs per destination shard).  Called at routing time
        on the stepped and the fused path alike, so their wire logs
        match."""
        if int(np.sum(counts)):
            self.interconnect.record_submit(counts)

    # -- task-level routing (protocol layer) -----------------------------------
    def assign_task(self, task_id: str) -> int:
        """Pin a task to a shard: a stable sha256 of the task id, or the
        shard with the fewest assigned tasks (``least_loaded``)."""
        k = self.task_shard.get(task_id)
        if k is None:
            if self.route == "least_loaded":
                k = int(np.argmin(self._task_counts))
            else:
                h = hashlib.sha256(task_id.encode()).digest()
                k = int.from_bytes(h[:8], "big") % self.n_shards
            self.task_shard[task_id] = k
            self._task_counts[k] += 1
        return k

    # -- sequencing / settlement -----------------------------------------------
    def seal(self) -> int:
        """Seal every shard's pending txs, then record the fabric root
        (the window's cross-shard commitment)."""
        return self._finish_window([s.seal() for s in self.shards])

    def _finish_window(self, shard_batches: List[int]) -> int:
        """Merge one window after every shard sealed: account the root
        gather's wire cost, record the fabric root and emit
        ``WindowSettled``.  The fused loop (core/fused.py) calls this after
        applying the K lanes' precomputed seals."""
        nb = int(sum(shard_batches))
        self.interconnect.record_root_gather(self._window, shard_batches)
        record: Dict[str, Any] = {"n_batches": nb}
        if self.state is not None:
            record = self._root_record(nb)
            self.fabric_roots.append(record)
        self.events.emit(
            WindowSettled,
            time=max((s._last_time for s in self.shards), default=0.0),
            window=self._window, n_batches=nb,
            state_root=record.get("state_root", ""),
            fabric_root=record.get("fabric_root", ""),
            shard_roots=tuple(record.get("shard_roots", ())))
        self._window += 1
        self._emit("window_settled", record)
        return nb

    @staticmethod
    def _merge_roots(shard_roots: List[str]) -> str:
        h = hashlib.sha256()
        for r in shard_roots:
            h.update(r.encode())
        return h.hexdigest()[:32]

    def _root_record(self, n_batches: int) -> Dict[str, Any]:
        shard_roots = self.state.partition_roots(self.n_shards)
        return {"window": len(self.fabric_roots), "n_batches": n_batches,
                "state_root": self.state.root(),
                "fabric_root": self._merge_roots(shard_roots),
                "shard_roots": shard_roots}

    def fabric_root(self) -> str:
        """The current merged commitment, from the K partition roots."""
        if self.state is None:
            return ""
        return self._merge_roots(self.state.partition_roots(self.n_shards))

    def state_root(self) -> str:
        return self.state.root() if self.state is not None else ""

    def settle_session(self):
        """Each shard closes its own session through the ONE shared prover
        pipeline (the L1 sees K proof aggregations)."""
        for s in self.shards:
            s.settle_session()

    def pump(self, now: float) -> int:
        """Drain the fabric's modeled prover to ``now``."""
        return self.prover.pump(now)

    def flush(self):
        self.seal()
        self.settle_session()
        self.prover.drain()

    # -- merged views ----------------------------------------------------------
    @property
    def gas_log(self) -> List[Dict[str, Any]]:
        """Per-batch rows in (shard, row) order, each tagged with its
        ``shard``."""
        return [dict(r, shard=k) for k, s in enumerate(self.shards)
                for r in s.gas_log]

    @property
    def n_batches(self) -> int:
        return sum(s.n_batches for s in self.shards)

    @property
    def batch_digests(self) -> List[int]:
        return [d for s in self.shards for d in s.batch_digests]

    @property
    def update_digest(self) -> int:
        return reduce(lambda a, b: a ^ b,
                      (s.update_digest for s in self.shards))

    # -- metrics ---------------------------------------------------------------
    def throughput(self, l1_tps: float) -> float:
        """The paper's method, scaled by concurrently sequencing shards."""
        return sum(s.throughput(l1_tps) for s in self.shards)

    def latency(self, n_calls: int) -> float:
        """Table II latency model: shards sequence concurrently, so the
        fabric's session latency is the slowest shard's share of
        ``n_calls``, by the OBSERVED routing (``_submitted``); a fabric
        with no traffic yet assumes an even split."""
        total = int(self._submitted.sum())
        if total > 0:
            return max(s.latency(math.ceil(n_calls * int(c) / total))
                       for s, c in zip(self.shards, self._submitted) if c)
        per_shard = math.ceil(n_calls / self.n_shards)
        return max(s.latency(per_shard) for s in self.shards)

    def sealed_batch_throughput(self, n_calls: int) -> float:
        """Modeled sealed-batch throughput: txs per modeled fabric-session
        second."""
        return n_calls / max(self.latency(n_calls), 1e-12)
