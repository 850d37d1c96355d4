"""Pipelined prover: proof jobs, session proofs, recursive aggregation.

Before this module, every rollup face carried its own copy of the
settlement bookkeeping (``_unsettled_rows`` + an inlined amortization
pass in ``Rollup._settle_session`` / ``VectorRollup.settle_session``),
the "prover" was synchronous and invisible, and the verify/execute gas
could only amortize within one settle call.  ``ProverPipeline`` is the
ONE settlement engine all three rollup backends route through:

  1. **Proof jobs** — every sealed batch enqueues a job.  Jobs drain
     through a modeled prover with ``capacity`` concurrent workers and
     ``prove_time`` seconds per batch proof; ``pump(now)`` completes the
     jobs whose modeled completion is due on the shared window clock
     (``ProofGenerated`` events carry the drain times).
  2. **Session proofs** — ``close_session`` (the face's
     ``settle_session``) folds the session's batch digests into one
     session proof via the same xor-mix/chunk-fold primitive as the
     Pallas ``rollup_digest`` kernel (``core.state.chunk_fold_digests``).
  3. **Recursive aggregation** — ``agg_width`` session proofs fold into
     one *aggregate proof* (the same construction one level up, by
     ``chunk_fold_digests`` on the host), and the aggregate posts ONE
     verify + execute pair to the L1,
     amortized across every batch it covers — the paper's 20X gas lever,
     now tunable per node (``repro_torch.api.ProverSpec``).

Finalization policy: ``"eager"`` posts an aggregate as soon as
``agg_width`` sessions have closed (width 1 therefore posts at every
``settle_session`` — **bit-equivalent to the pre-pipeline settlement
path**: same gas rows, same L1 transactions, same timestamps; pinned by
tests/test_prover.py on all three backends); ``"window"`` defers posting
to ``pump(now)`` window edges, releasing only aggregates whose proofs
have fully drained.  ``drain(force=True)`` (the face's ``flush``) always
pushes the remainder through.

The sharded fabric keeps this invariant too: ``ShardedRollup`` gives
every shard lane its own face but ONE shared pipeline, and the fused
window loop (core/fused.py) enqueues each window's jobs lane-by-lane in
shard order, so a fused fabric drains the exact proof/aggregate stream
the stepped fabric does — one pipeline across fused shard lanes.

Security caveat: session and aggregate digests are validity stand-ins
for recursive SNARK composition, not zk proofs — see core/rollup.py.

Host-only module: a copy of ``src/repro/core/prover.py``.  The proof
digests are one word per proof, so the aggregation fold stays on the host
(``state.chunk_fold_digests``), as it does in the JAX package.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import (AggregateVerified, EventLog,
                                     ProofGenerated)
from repro_torch.core.gas import DEFAULT_GAS, GasTable
from repro_torch.core.state import chunk_fold_digests

#: finalization policies a pipeline (and repro.api.ProverSpec) accepts
FINALIZE_MODES = ("eager", "window")


def session_latency(n_calls: int, *, batch_size: int, prove_time: float,
                    per_tx_time: float, n_lanes: int = 1,
                    capacity: int = 1) -> float:
    """THE modeled L2 session latency (Table-II calibration).

    One formula for every face — ``Rollup.latency`` and
    ``VectorRollup.latency`` previously each carried their own copy
    (identical at n_lanes=1, but free to drift): sequencing is the
    slowest lane's ceil-split share, proving is the batch count drained
    through ``capacity`` concurrent workers.  ``capacity=1`` reproduces
    the pre-pipeline ``nb * prove_time`` model exactly (pinned by
    tests/test_prover.py).
    """
    per_lane = math.ceil(n_calls / max(1, n_lanes))
    nb = max(1, math.ceil(per_lane / batch_size))
    return math.ceil(nb / max(1, capacity)) * prove_time \
        + per_lane * per_tx_time


def _fold_digests(digests: np.ndarray, width: int) -> np.ndarray:
    """Vectorized recursive fold: (n,) u32 digests -> (ceil(n/width),)
    u32, one xor-mix fold per ``width`` inputs: ``chunk_fold_digests``
    on the host (one word per proof), applied one level up."""
    return chunk_fold_digests(np.asarray(digests, np.uint32), chunk=width)


class ProverFace:
    """Shared rollup-face wiring for the pipeline (one copy, like
    ledger.ObjectLedgerFace): event-log adoption, pipeline construction,
    the per-seal WindowSettled emission and the ``pump``/
    ``settle_session`` delegation.  ``Rollup`` and ``VectorRollup`` mix
    this in; the sharded fabric shares one pipeline across its shards
    and emits its own (root-merged) window events instead.

    Subclasses call ``_init_prover_face`` from ``__init__`` and
    ``_emit_window(nb)`` at the end of ``seal()``; they must provide
    ``_last_time``, ``state_root()`` and ``_post_settlement``.
    """

    def _init_prover_face(self, l1, gas_table, prove_time: float,
                          agg_width: int, prover_capacity: int,
                          finalize: str, prover) -> None:
        # adopt the L1's typed event log so L1/L2 events share one total
        # order; a passed-in pipeline (the fabric's) wins over building
        # our own
        l1_events = getattr(l1, "events", None)
        self.events = l1_events if l1_events is not None else EventLog()
        self.prover = prover if prover is not None else ProverPipeline(
            gas_table, agg_width=agg_width, capacity=prover_capacity,
            prove_time=prove_time, finalize=finalize, events=self.events)
        self._window = 0                    # WindowSettled counter
        self._event_shard: Optional[int] = None   # fabric shard tag
        self._suppress_window_event = False       # fabric emits instead

    def _emit_window(self, nb: int) -> None:
        """One typed WindowSettled per ``seal()`` call — the window-clock
        commitment record (the fabric emits its own, root-merged form).
        The state root is (re)committed every window by design — the
        same per-seal commitment the fabric has always recorded; it is a
        chunked fold over the compact account arrays (sub-millisecond at
        benchmark scales)."""
        if self._suppress_window_event:
            return
        from repro_torch.core.events import WindowSettled
        self.events.emit(WindowSettled, time=self._last_time,
                         shard=self._event_shard, window=self._window,
                         n_batches=nb, state_root=self.state_root())
        self._window += 1

    def pump(self, now: float) -> int:
        """Drain the modeled prover to ``now`` (shared window clock)."""
        return self.prover.pump(now)

    def settle_session(self) -> None:
        """Close the settle session through the shared prover pipeline
        (core/prover.py owns the bookkeeping that used to live on each
        face as ``_settle_session``, duplicated per backend)."""
        self.prover.close_session(self)


@dataclasses.dataclass
class ProofJob:
    """One sealed batch's proof work item."""

    job: int
    batch: int                   # owner-global batch id
    n_txs: int
    digest: int                  # the batch's tx xor-root
    sealed_at: float
    done_at: float               # modeled prove completion
    row: Dict[str, Any]          # the owner's gas_log row (by reference)
    proved: bool = False


@dataclasses.dataclass(frozen=True)
class SessionProof:
    """A closed settle-session: its batches' digests folded into one."""

    session: int
    jobs: Tuple[ProofJob, ...]
    n_txs: int
    digest: int
    closed_at: float


@dataclasses.dataclass(frozen=True)
class AggregateProof:
    """``n_sessions`` session proofs folded into one posted L1 verify."""

    aggregate: int
    sessions: Tuple[int, ...]
    batches: Tuple[int, ...]
    n_txs: int
    digest: int
    verify: int
    execute: int
    posted_at: float


class ProverPipeline:
    """Shared prover + aggregation stage for one or more rollup faces.

    Owners are the rollup faces themselves (a sharded fabric's shards
    share ONE pipeline, so job/session/aggregate ids are fabric-global);
    each owner provides ``_post_settlement(verify, execute, at,
    n_batches) -> refs``, a ``gas_log`` whose rows are handed over at
    ``enqueue``, and a ``batch_settle_ref`` dict the pipeline fills.
    """

    def __init__(self, gas_table: GasTable = DEFAULT_GAS, *,
                 agg_width: int = 1, capacity: int = 1,
                 prove_time: float = 0.9, finalize: str = "eager",
                 events: Optional[EventLog] = None):
        if agg_width < 1:
            raise ValueError("agg_width must be >= 1")
        if capacity < 1:
            raise ValueError("prover capacity must be >= 1")
        if finalize not in FINALIZE_MODES:
            raise ValueError(f"unknown finalize mode {finalize!r}; "
                             f"choose from {FINALIZE_MODES}")
        self.gas_table = gas_table
        self.agg_width = agg_width
        self.capacity = capacity
        self.prove_time = prove_time
        self.finalize = finalize
        self.events = events if events is not None else EventLog()
        self.aggregates: List[AggregateProof] = []
        self._workers = [0.0] * capacity          # min-heap of free times
        self._open: Dict[Any, List[ProofJob]] = {}     # sealed, unsettled
        self._closed: Dict[Any, List[SessionProof]] = {}  # awaiting agg
        self._jobs: Dict[Any, Dict[int, ProofJob]] = {}   # batch -> job
        # drain schedule: (done_at, job_id, owner, job) min-heap so pump
        # pops only the jobs that are actually due instead of scanning
        # every open job per call (job_id is unique, so owners are never
        # compared); settled jobs are skipped lazily via ``proved``
        self._due: List[Tuple[float, int, Any, ProofJob]] = []
        self._next_job = 0
        self._next_session = 0
        self._next_agg = 0

    # -- sealing side -----------------------------------------------------------
    def enqueue(self, owner, first_batch: int, digests, n_txs,
                sealed_at, rows: List[Dict[str, Any]]) -> None:
        """Enqueue one proof job per batch sealed by ``owner``.

        ``digests``/``n_txs``/``sealed_at`` are per-batch arrays in
        batch-id order starting at ``first_batch``; ``rows`` are the
        owner's freshly appended ``gas_log`` rows (held by reference —
        truncating ``gas_log`` between sessions can no longer skew the
        amortization, the old ``_unsettled_rows`` index hazard)."""
        queue = self._open.setdefault(owner, [])
        jobs = self._jobs.setdefault(owner, {})
        for j, row in enumerate(rows):
            free = heapq.heappop(self._workers)
            start = max(free, float(sealed_at[j]))
            done = start + self.prove_time
            heapq.heappush(self._workers, done)
            job = ProofJob(self._next_job, first_batch + j, int(n_txs[j]),
                           int(digests[j]), float(sealed_at[j]), done, row)
            row["job"] = job.job
            self._next_job += 1
            queue.append(job)
            jobs[job.batch] = job
            heapq.heappush(self._due, (done, job.job, owner, job))

    # -- modeled prover drain ---------------------------------------------------
    def _complete(self, owner, job: ProofJob,
                  at_most: Optional[float] = None) -> None:
        """Mark a proof done.  ``at_most`` clamps the event timestamp
        when posting forces a job through BEFORE its modeled drain (the
        eager path) — the stream must never show a proof generated
        after the aggregate that consumed it."""
        if job.proved:
            return
        job.proved = True
        t = job.done_at if at_most is None else min(job.done_at, at_most)
        self.events.emit(ProofGenerated, time=t,
                         shard=getattr(owner, "_event_shard", None),
                         job=job.job, batch=job.batch, n_txs=job.n_txs,
                         digest=job.digest, sealed_at=job.sealed_at)

    def pump(self, now: float) -> int:
        """Advance the prover to ``now`` on the shared window clock:
        complete every job whose modeled ``done_at`` is due, and (in
        ``"window"`` finalization) post the aggregates whose sessions
        have fully drained.  Returns the number of jobs completed."""
        due: List[Tuple[Any, ProofJob]] = []
        while self._due and self._due[0][0] <= now:
            _, _, owner, job = heapq.heappop(self._due)
            if not job.proved:
                due.append((owner, job))
        if due:
            # emit in the owner-then-job order the full scan produced
            # (owners by first-enqueue order — _jobs keeps every owner;
            # keyed by the owner itself, not id(), so the order is stable
            # across processes — rule R003)
            order = {o: i for i, o in enumerate(self._jobs)}
            due.sort(key=lambda oj: (order[oj[0]], oj[1].job))
            for owner, job in due:
                self._complete(owner, job)
        n_done = len(due)
        if self.finalize == "window":
            for owner in list(self._closed):
                self._post_ready(owner, force=False, drained_only=True)
        return n_done

    def n_unsettled(self, owner) -> int:
        """Batches sealed by ``owner`` whose aggregate has not posted."""
        return len(self._jobs.get(owner, {}))

    def phase_of(self, owner, batch: int) -> Optional[str]:
        """``"sealed"`` / ``"proved"`` while the batch is in flight;
        ``None`` once its aggregate posted (or for unknown batches)."""
        job = self._jobs.get(owner, {}).get(batch)
        if job is None:
            return None
        return "proved" if job.proved else "sealed"

    # -- session close (the faces' settle_session) ------------------------------
    def close_session(self, owner, at: Optional[float] = None) -> None:
        """Fold ``owner``'s open batches into one session proof.

        ``at`` defaults to the owner's ``_last_time`` (the last seal
        timestamp — where the pre-pipeline path posted its settlement).
        Eager finalization posts every full ``agg_width`` group of
        closed sessions immediately."""
        jobs = self._open.pop(owner, None)
        if not jobs:
            return
        if at is None:
            at = getattr(owner, "_last_time", jobs[-1].sealed_at)
        digest = int(_fold_digests(
            np.array([j.digest for j in jobs], np.uint32), len(jobs))[0])
        proof = SessionProof(self._next_session, tuple(jobs),
                             int(sum(j.n_txs for j in jobs)), digest,
                             float(at))
        self._next_session += 1
        self._closed.setdefault(owner, []).append(proof)
        if self.finalize == "eager":
            self._post_ready(owner, force=False, drained_only=False)

    def drain(self, owner=None, force: bool = True) -> None:
        """Push closed sessions through aggregation (the faces' flush
        tail).  ``force`` posts the final partial-width aggregate too."""
        owners = [owner] if owner is not None else list(self._closed)
        for o in owners:
            self._post_ready(o, force=force, drained_only=False)

    # -- recursive aggregation + L1 posting -------------------------------------
    def _post_ready(self, owner, *, force: bool,
                    drained_only: bool) -> None:
        sessions = self._closed.get(owner)
        if not sessions:
            return
        w = self.agg_width
        while sessions:
            group, partial = sessions[:w], len(sessions) < w
            if partial and not force:
                break
            if drained_only and any(not j.proved
                                    for s in group for j in s.jobs):
                break
            del sessions[:len(group)]
            self._post_aggregate(owner, group, forced=force)
        if not sessions:
            self._closed.pop(owner, None)

    def _post_aggregate(self, owner, group: List[SessionProof], *,
                        forced: bool = False) -> None:
        jobs = [j for s in group for j in s.jobs]
        nb = len(jobs)
        # same single/multi predicate as the pre-pipeline settlement: a
        # lone small batch verifies at the cheap single-proof price
        single = nb == 1 and jobs[0].n_txs <= 5
        gt = self.gas_table
        verify = gt.verify_single if single else gt.verify_multi
        execute = gt.execute_single if single else gt.execute_multi
        if self.finalize == "eager" or forced:
            # pre-pipeline posting time; a FORCED drain (flush) must not
            # stamp the settlement with a still-future modeled drain
            # time — a future tx at the L1 mempool head stalls everything
            # behind it (FIFO head-of-line rule, see Chain.produce_block)
            at = group[-1].closed_at
        else:
            # window-clock posting: pump() only releases fully drained
            # aggregates, so these times are <= the pumped ``now``
            at = max(max(s.closed_at for s in group),
                     max(j.done_at for j in jobs))
        for job in jobs:                    # proofs must exist to fold
            self._complete(owner, job, at_most=at)
        refs = owner._post_settlement(verify, execute, at, nb)
        digest = int(_fold_digests(
            np.array([s.digest for s in group], np.uint32), len(group))[0])
        agg = AggregateProof(
            self._next_agg, tuple(s.session for s in group),
            tuple(j.batch for j in jobs), int(sum(j.n_txs for j in jobs)),
            digest, int(verify), int(execute), float(at))
        self._next_agg += 1
        self.aggregates.append(agg)
        owner_jobs = self._jobs.get(owner, {})
        for job in jobs:
            row = job.row
            row["verify"] = verify / nb
            row["execute"] = execute / nb
            row["total"] = row["commit"] + row["verify"] + row["execute"]
            row["aggregate"] = agg.aggregate
            owner.batch_settle_ref[job.batch] = refs
            owner_jobs.pop(job.batch, None)
        self.events.emit(
            AggregateVerified, time=at,
            shard=getattr(owner, "_event_shard", None),
            aggregate=agg.aggregate, n_sessions=len(group),
            batches=agg.batches, n_txs=agg.n_txs, verify=int(verify),
            execute=int(execute), digest=digest)
        # legacy callback shim (string-keyed subscribe, one release)
        owner._emit("session_settled", {
            "n_batches": nb, "verify": verify, "execute": execute,
            "batches": [j.batch for j in jobs]})
