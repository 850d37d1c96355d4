"""The concurrent node service: one stack, one writer, many clients.

``NodeService`` fronts a single ``repro_torch.api`` stack (one
``build_stack`` per process, owned by a ``NodeClient`` on ``device``: the
CUDA card unless named) and serializes every ledger mutation through ONE
asyncio writer task: submissions from any number of concurrent clients
funnel into a bounded op queue, the writer applies them in arrival order,
and because the ledger operations themselves never await, each op is
atomic under cooperative scheduling — the stepped semantics and state
roots are exactly the single-threaded ones.  Reads (receipts, accounts,
events, state root) are served directly on the event loop for the same
reason.

One thread, one stream.  Every ledger op, writes and reads, runs on the
event loop's thread and on torch's current stream: nothing here hands
work to another thread or executor.  That is a condition, not a style:
``batch_seal`` joins its blocks' carries through one process-wide ticket
in the kernel library, so two of its launches in flight on two streams
would corrupt each other.  The writer is the only caller that seals
(``batch_seal``, ``rollup_digest``, each fabric shard stepped, never
``shard_seal``); the read path launches ``rollup_chunk_digests`` and
``dirty_fold`` at ``state_root`` and never ``batch_seal``.

Admission happens in the writer, ahead of the ledger
(``serve/admission.py``, plain Python on modeled time): admitted
transactions collect in the ``PendingPool`` and are flushed to the ledger
in (modeled-time, ref) order at every ``ServeSpec.window`` boundary the
modeled clock crosses — drain pool -> seal -> ``run_until`` the boundary.
A flush builds one ``TxArrays`` on the stack's device (one batch of
host-to-device copies a window, not one a transaction).  The reputation
gate reads a sender's ``reputation`` and ``rep_events`` in one host copy
a submit.  A full op queue is the backpressure signal: the submit gets an
explicit ``overloaded`` reply (HTTP 429 at the serving edge) instead of
unbounded buffering.

Determinism contract (``tests/test_torch_serve.py``): the service records
an op log — the exact batches it flushed plus every seal/run_until/flush
— and ``replay_ops`` replaying that log serially through a fresh
``NodeClient`` reproduces the same final state root and gas totals, on
the vector and fabric backends alike; the admission log, op log,
receipts, state root and L1 gas equal the JAX package's
(``src/repro/serve/service.py``) on the same submissions.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.client import NodeClient
from repro_torch.api.specs import NodeSpec, ServeSpec
from repro_torch.core.engine import TxArrays
from repro_torch.core.gas import L1_DEFAULT_GAS
from repro_torch.serve.admission import AdmissionController, PoolEntry

#: ops the writer understands / the op log records
_OPS = ("batch", "seal", "run_until", "flush")


@dataclasses.dataclass
class ServeMetrics:
    """Live counters the metrics endpoint reports."""

    submitted: int = 0
    flushed: int = 0                 # txs committed to the ledger
    windows: int = 0
    queue_rejections: int = 0        # op-queue backpressure 429s


class NodeService:
    """One served node: admission + single-writer ledger loop."""

    def __init__(self, spec: ServeSpec,
                 client: Optional[NodeClient] = None, *, device=None):
        self.spec = spec
        self.client = client if client is not None \
            else NodeClient.from_spec(spec.node, device=device)
        log = self.client._event_log()
        if spec.event_cap is not None:
            log.cap = spec.event_cap
        self.admission = AdmissionController(
            spec.admission, spec.node.reputation)
        self.metrics = ServeMetrics()
        # ref -> {"status": queued|evicted|rejected|submitted, ...}
        self.receipts: Dict[int, Dict[str, Any]] = {}
        self._ledger_receipts: Dict[int, Any] = {}      # ref -> TxReceipt
        self._next_ref = 0
        self._clock = 0.0                # modeled time, high-water
        self._next_window = spec.window
        self.ops: List[Tuple] = []       # the replayable op log
        self._queue: Optional[asyncio.Queue] = None
        self._writer: Optional[asyncio.Task] = None

    # -- lifecycle --------------------------------------------------------------
    async def start(self) -> "NodeService":
        if self._queue is None:
            self._queue = asyncio.Queue(maxsize=self.spec.queue_cap)
        if self._writer is None:
            self._writer = asyncio.get_running_loop().create_task(
                self._writer_loop())
        return self

    async def close(self) -> None:
        """Flush everything pending and stop the writer."""
        await self.finalize()
        if self._writer is not None:
            self._writer.cancel()
            try:
                await self._writer
            except asyncio.CancelledError:
                pass
            self._writer = None

    async def finalize(self) -> Dict[str, Any]:
        """Commit the pool, settle the open session and drain the
        modeled prover past the last submission (recorded in the op
        log, so replays settle identically)."""
        return await self._enqueue(("finalize",))

    # -- the single writer ------------------------------------------------------
    async def _enqueue(self, op: Tuple) -> Any:
        if self._queue is None:
            await self.start()
        fut = asyncio.get_running_loop().create_future()
        try:
            self._queue.put_nowait((op, fut))
        except asyncio.QueueFull:
            self.metrics.queue_rejections += 1
            return {"error": "overloaded", "detail": "op queue full"}
        return await fut

    async def _writer_loop(self) -> None:
        while True:
            op, fut = await self._queue.get()
            try:
                if op[0] == "submit":
                    out = self._do_submit(*op[1:])
                elif op[0] == "finalize":
                    out = self._do_finalize()
                else:
                    raise ValueError(f"unknown writer op {op[0]!r}")
                if not fut.done():
                    fut.set_result(out)
            except Exception as err:               # surface, don't kill loop
                if not fut.done():
                    fut.set_exception(err)

    # -- submission path --------------------------------------------------------
    def _stamp(self, at: Optional[float]) -> float:
        if at is None:
            self._clock += 0.01
            return self._clock
        self._clock = max(self._clock, float(at))
        return float(at)

    def _intrinsic(self, fn: str) -> int:
        return int(self.client.gas_table.l1_per_call.get(fn,
                                                         L1_DEFAULT_GAS))

    def _reputation(self, sender: str) -> float:
        """Sender's modeled reputation: the on-ledger value once any
        reputation event touched the account, the newcomer prior
        ``r_init`` before that (paper: newcomers start above r_min).
        Reads the row's two fields in one host copy (``get_account``
        would sync once a field)."""
        client = self.client
        sid = getattr(client.target, "_sender_ids", {}).get(sender)
        st = client._state_arrays()
        if sid is not None and st is not None and sid < st.n:
            rep, events = torch.stack((st.reputation[sid].double(),
                                       st.rep_events[sid].double())).tolist()
            if events != 0:
                return rep
        return float(self.spec.node.reputation.r_init)

    async def submit(self, fn: str, sender: str, fee: Optional[int] = None,
                     at: Optional[float] = None) -> Dict[str, Any]:
        """Admission-checked submit; returns a JSON-shaped summary with
        the tx ``ref`` to poll (or the rejection reason)."""
        return await self._enqueue(("submit", fn, sender, fee, at))

    def _do_submit(self, fn: str, sender: str, fee: Optional[int],
                   at: Optional[float]) -> Dict[str, Any]:
        t = self._stamp(at)
        ref = self._next_ref
        self._next_ref += 1
        self.metrics.submitted += 1
        intrinsic = self._intrinsic(fn)
        offered = intrinsic if fee is None else int(fee)
        decision = self.admission.admit(
            ref=ref, fn=fn, sender=sender, fee=offered,
            intrinsic=intrinsic, at=t, reputation=self._reputation(sender))
        if decision.admitted:
            self.receipts[ref] = {"status": "queued", "fn": fn,
                                  "sender": sender, "fee": offered, "at": t}
            if decision.evicted is not None:
                self.receipts[decision.evicted] = {
                    "status": "evicted",
                    "detail": "displaced by a higher-fee arrival at pool "
                              "cap"}
            out = {"ref": ref, "status": "queued"}
        else:
            self.receipts[ref] = {"status": "rejected",
                                  "reason": decision.reason}
            out = {"ref": ref, "status": "rejected",
                   "reason": decision.reason}
        self._roll_windows()
        return out

    # -- window flushing --------------------------------------------------------
    def _roll_windows(self) -> None:
        while self._clock >= self._next_window:
            boundary = self._next_window
            self._commit_pool()
            self.client.seal()
            self.ops.append(("seal",))
            self.client.run_until(boundary)
            self.ops.append(("run_until", boundary))
            self.metrics.windows += 1
            self._next_window = boundary + self.spec.window

    def _commit_pool(self) -> None:
        entries = self.admission.pool.drain()
        if not entries:
            return
        receipts = self._submit_entries(entries)
        self.ops.append(("batch", [(e.fn, e.sender, e.fee, e.at)
                                   for e in entries]))
        for e, r in zip(entries, receipts):
            self._ledger_receipts[e.ref] = r
            self.receipts[e.ref] = {"status": "submitted"}
        self.metrics.flushed += len(entries)

    def _submit_entries(self, entries: List[PoolEntry]):
        target = self.client.target
        if getattr(target, "soa_native", False):
            batch = TxArrays.from_numpy(
                np.array([e.at for e in entries], np.float64),
                np.array([e.fee for e in entries], np.int64),
                np.array([target.fns.id(e.fn) for e in entries], np.int32),
                np.array([target.sender_id(e.sender) for e in entries],
                         np.int32),
                target.fns, device=target.device)
            receipts = self.client.submit_arrays(batch)
            for e, r in zip(entries, receipts):
                r.sender = e.sender        # real addresses, not acct labels
            return receipts
        return [self.client.submit(e.fn, e.sender, gas=e.fee, at=e.at)
                for e in entries]

    def _do_finalize(self) -> Dict[str, Any]:
        self._commit_pool()
        self.client.flush()
        self.ops.append(("flush",))
        block_time = self.spec.node.chain.block_time
        t_end = self._clock + 2.0 * block_time
        self.client.run_until(t_end)
        self.ops.append(("run_until", t_end))
        return {"status": "finalized", "flushed": self.metrics.flushed}

    # -- read path (direct: ledger reads never await) ---------------------------
    def receipt(self, ref: int) -> Dict[str, Any]:
        rec = self.receipts.get(ref)
        if rec is None:
            return {"error": "unknown ref", "ref": ref}
        if rec.get("status") != "submitted":
            return {"ref": ref, **rec}
        rcpt = self.client.refresh(self._ledger_receipts[ref])
        # the object faces' Tx handle is not JSON: drop it before asdict
        # deep-copies it
        d = dataclasses.asdict(dataclasses.replace(rcpt, tx=None))
        d.pop("tx")
        return {"ref": ref, **d}

    def get_account(self, addr: str) -> Dict[str, Any]:
        return dataclasses.asdict(self.client.get_account(addr))

    def state_root(self) -> str:
        return self.client.state_root()

    def capabilities(self) -> List[str]:
        return sorted(self.client.capabilities())

    def events(self, cursor: int = 0, kinds=None,
               limit: Optional[int] = None) -> Dict[str, Any]:
        evs, next_cursor, n_dropped = self.client.events_page(
            cursor, kinds=kinds, limit=limit)
        return {"events": [{"kind": e.kind, **dataclasses.asdict(e)}
                           for e in evs],
                "next_cursor": next_cursor, "dropped": n_dropped}

    def stats(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self.metrics)
        out.update(self.admission.counters())
        out["pool_depth"] = len(self.admission.pool)
        out["clock"] = self._clock
        return out


def replay_ops(node_spec: NodeSpec, ops: List[Tuple], *,
               device=None) -> NodeClient:
    """Replay a service op log serially through a fresh ``NodeClient`` on
    ``device`` (the CUDA card unless named).

    The equivalence oracle: submits every recorded batch one transaction
    at a time (no batching, no concurrency) and repeats the recorded
    seal/run_until/flush schedule; the resulting state root and gas
    totals must match the served stack's (tests/test_torch_serve.py pins
    it on the vector and fabric backends)."""
    client = NodeClient.from_spec(node_spec, device=device)
    for op in ops:
        if op[0] == "batch":
            for fn, sender, fee, at in op[1]:
                client.submit(fn, sender, gas=fee, at=at)
        elif op[0] == "seal":
            client.seal()
        elif op[0] == "run_until":
            client.run_until(op[1])
        elif op[0] == "flush":
            client.flush()
        else:
            raise ValueError(f"unknown op {op[0]!r} in op log")
    return client
