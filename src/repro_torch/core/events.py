"""Typed ledger events + the shared per-stack event log.

The PR-4 event surface was a string-keyed callback ``subscribe`` that
existed only on the rollup faces and pushed loose dict payloads.  This
module replaces it with

  * small frozen **event dataclasses** — one per lifecycle stage of the
    proof pipeline (``BatchSealed`` -> ``ProofGenerated`` ->
    ``AggregateVerified``), plus the window commitment
    (``WindowSettled``) and L1 block production (``BlockPacked``), and
  * an ``EventLog`` — ONE append-only, totally ordered stream per ledger
    stack.  The L1 chain owns the log; every rollup face built on top of
    it (``VectorRollup``, ``Rollup``, the sharded fabric and its shards)
    adopts the same instance, so L1 and L2 events interleave in emission
    order under a single monotonic ``seq``.

Consumption is pull-based: readers keep a cursor and drain
``log.since(cursor)`` (the public face is ``repro_torch.api.NodeClient.
events()``).  Events are plain data — Python ints, floats and strs, never
tensors — so they are safe to hold, compare and serialize, and compare
equal to the JAX package's events; ``shard`` tags fabric-side events with
the owning shard and stays ``None`` on unsharded faces.

Host-only module: a copy of ``src/repro/core/events.py``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, List, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class LedgerEvent:
    """Base event: total order (``seq``), simulated time, shard tag."""

    seq: int
    time: float
    shard: Optional[int]

    kind: ClassVar[str] = "event"


@dataclasses.dataclass(frozen=True)
class BatchSealed(LedgerEvent):
    """One seal pass committed ``n_batches`` L2 batches to the L1."""

    first_batch: int
    n_batches: int
    n_txs: int
    digest: int                  # merged update-buffer xor-mix digest

    kind: ClassVar[str] = "batch_sealed"


@dataclasses.dataclass(frozen=True)
class ProofGenerated(LedgerEvent):
    """A batch's proof job completed (modeled prover drain).

    ``time`` is the modeled completion time (``sealed_at`` + queueing
    under the prover's capacity + prove latency).
    """

    job: int
    batch: int
    n_txs: int
    digest: int                  # the batch's tx xor-root
    sealed_at: float

    kind: ClassVar[str] = "proof_generated"


@dataclasses.dataclass(frozen=True)
class AggregateVerified(LedgerEvent):
    """An aggregate proof's single verify+execute posted to the L1.

    The recursive-aggregation product: ``n_sessions`` session proofs
    (each folding its batches' digests) folded into one digest, whose L1
    verify gas is amortized across every batch in ``batches``.
    """

    aggregate: int
    n_sessions: int
    batches: Tuple[int, ...]
    n_txs: int
    verify: int
    execute: int
    digest: int                  # recursive fold of the session digests

    kind: ClassVar[str] = "aggregate_verified"


@dataclasses.dataclass(frozen=True)
class WindowSettled(LedgerEvent):
    """A window boundary sealed: the backend's state commitment record.

    Emitted once per ``seal()`` on every rollup face.  On the sharded
    fabric it carries the merged fabric root and the per-shard partition
    roots; on unsharded faces those fields stay empty.
    """

    window: int
    n_batches: int
    state_root: str
    fabric_root: str = ""
    shard_roots: Tuple[str, ...] = ()

    kind: ClassVar[str] = "window_settled"


@dataclasses.dataclass(frozen=True)
class BlockPacked(LedgerEvent):
    """The L1 packed one block (chain-only nodes' event stream)."""

    height: int
    n_txs: int
    gas_used: int
    block_hash: str

    kind: ClassVar[str] = "block_packed"


@dataclasses.dataclass(frozen=True)
class EventsDropped(LedgerEvent):
    """Overflow marker: a reader's cursor fell behind a bounded log.

    Never stored in the log — ``since`` synthesizes one (``seq`` is the
    stale cursor, ``time`` the first retained event's time) when a
    cursor points below the ring-buffer base, so long-poll consumers see
    the gap explicitly instead of a silent skip.  ``resume_cursor`` is
    the oldest cursor that still resolves to retained events.
    """

    n_dropped: int
    resume_cursor: int

    kind: ClassVar[str] = "events_dropped"


class EventLog:
    """Append-only, totally ordered typed event stream for one stack.

    ``emit`` assigns the next ``seq`` and returns the constructed event;
    readers drain with ``since(cursor)`` + ``next_cursor`` (cursors live
    with the reader, so independent consumers never steal each other's
    events).

    ``cap`` (settable any time; ``None`` = unbounded, the default every
    stack is built with) turns the log into a bounded ring: emissions
    past the cap evict the oldest events, ``seq`` keeps counting from
    process start (``_base`` tracks the seq of the oldest retained
    event), and a cursor that fell below the base gets an explicit
    ``EventsDropped`` marker from ``since`` instead of silently reading
    a shifted window.  Multi-consumer serving (the JAX package's repro/serve)
    is the one user that sets a cap.
    """

    def __init__(self, cap: Optional[int] = None):
        self._events: List[LedgerEvent] = []
        self._base = 0                  # seq of _events[0]
        self.cap = cap
        self.n_dropped = 0              # lifetime evictions (monitoring)

    def emit(self, cls: Type[LedgerEvent], *, time: float,
             shard: Optional[int] = None, **fields) -> LedgerEvent:
        ev = cls(seq=self._base + len(self._events), time=float(time),
                 shard=shard, **fields)
        self._events.append(ev)
        self._evict()
        return ev

    def _evict(self) -> None:
        if self.cap is not None and len(self._events) > self.cap:
            n = len(self._events) - int(self.cap)
            del self._events[:n]
            self._base += n
            self.n_dropped += n

    def splice(self, inserts) -> None:
        """Insert event runs at recorded positions and renumber ``seq ==
        position`` across the whole stream — THE one sanctioned bulk-
        mutation path (rule R005: only this module touches ``_events``).

        ``inserts`` is a sequence of ``(position, events)`` pairs with
        positions in seq coordinates of the pre-splice stream, ascending
        (callers record ``next_cursor``); the inserted events' ``seq``
        values are ignored and rewritten.  The fused window loop uses
        this to land deferred ``BlockPacked`` events exactly where the
        stepped path emitted them; callers must not have handed out
        cursors past the first splice point, and on a bounded log the
        positions must not predate the ring base.
        """
        merged: List[LedgerEvent] = []
        prev = 0
        for pos, evs in inserts:
            pos -= self._base
            if pos < 0:
                raise ValueError("splice position predates the ring base")
            if pos < prev:
                raise ValueError("splice positions must be ascending")
            merged.extend(self._events[prev:pos])
            merged.extend(evs)
            prev = pos
        merged.extend(self._events[prev:])
        # in-place renumber: the log owns its event objects, so rewriting
        # seq on the frozen dataclasses is unobservable to drained readers
        for i, e in enumerate(merged):
            if e.seq != self._base + i:
                object.__setattr__(e, "seq", self._base + i)
        self._events[:] = merged
        self._evict()

    def since(self, cursor: int) -> List[LedgerEvent]:
        lo = cursor - self._base
        if lo >= 0:
            return self._events[lo:]
        marker = EventsDropped(
            seq=cursor, time=self._events[0].time if self._events else 0.0,
            shard=None, n_dropped=-lo, resume_cursor=self._base)
        return [marker] + self._events

    def dropped(self, cursor: int) -> int:
        """Events a reader at ``cursor`` can no longer see (0 if none)."""
        return max(0, self._base - cursor)

    @property
    def base(self) -> int:
        """Seq of the oldest retained event (0 on an unbounded log)."""
        return self._base

    @property
    def next_cursor(self) -> int:
        return self._base + len(self._events)
