"""zk-rollup-style node client: submit -> TxReceipt, accounts, events.

``NodeClient`` is the RPC-shaped façade over a ledger built by
``repro_torch.api.build_ledger``:

  * ``submit(fn, sender)`` / ``submit_arrays(batch)`` return receipts with
    status, gas breakdown, L2 batch id / L1 block, proof/aggregate refs
    and the L1 settlement ref; ``refresh(receipt)`` re-resolves one
    against the live ledger (receipts are provenance handles, not
    snapshots).
  * ``get_account(addr)`` reads one row of the account state.
  * ``state_root()`` is the chunked state commitment.
  * ``events()`` drains the stack's typed event stream; ``capabilities()``
    reports which event kinds the backend emits.

Receipt statuses (``RECEIPT_STATUSES``): ``pending`` -> ``sealed`` ->
``proved`` -> ``finalized`` on a rollup node, ``pending`` -> ``confirmed``
on a chain-only node.  On the object faces (``Chain``, ``Rollup``) a
receipt holds its ``Tx`` and a submission may carry a payload; the SoA
faces carry (time, gas, fn, sender) only and refuse one.  On the sharded
fabric a receipt also names its shard, and resolves through that shard's
rollup.  The string-keyed callback ``subscribe`` is kept as a deprecation
shim, as in the JAX package: drain ``events()`` instead.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.api.factory import build_ledger, l1_of
from repro_torch.api.specs import NodeSpec
from repro_torch.core.engine import TxArrays
from repro_torch.core.events import LedgerEvent
from repro_torch.core.fused import supports_fused
from repro_torch.core.gas import DEFAULT_GAS, L1_DEFAULT_GAS, GasTable
from repro_torch.core.ledger import Tx
from repro_torch.core.state import (STATE_SCHEMA, StateArrays,
                                    default_state_handlers)

#: the proof lifecycle a receipt walks (chain-only nodes use
#: ``pending`` -> ``confirmed``)
RECEIPT_STATUSES = ("pending", "sealed", "proved", "finalized", "confirmed")


@dataclasses.dataclass
class TxReceipt:
    """Provenance handle for one submitted transaction."""

    fn: str
    sender: str
    gas: int                       # intrinsic (L1-schedule) gas of the tx
    submit_time: float
    status: str = "pending"        # see RECEIPT_STATUSES
    seq: Optional[int] = None      # provenance in the target's namespace
    shard: Optional[int] = None    # owning shard (fabric only)
    batch: Optional[int] = None    # global L2 batch id
    block: Optional[int] = None    # L1 block height (commit tx / own tx)
    block_hash: Optional[str] = None
    l1_ref: Optional[Any] = None   # L1 settlement ref of the commit
    confirm_time: Optional[float] = None
    proof_ref: Optional[int] = None      # the batch's proof job id
    aggregate_ref: Optional[int] = None  # the posted aggregate proof id
    gas_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the object faces' provenance handle: the submitted Tx itself
    tx: Optional[Any] = dataclasses.field(default=None, repr=False,
                                          compare=False)


@dataclasses.dataclass(frozen=True)
class AccountView:
    """One StateArrays row, by address (zeros for unknown accounts)."""

    address: str
    account_id: Optional[int]
    balance: float = 0.0
    stake: float = 0.0
    reputation: float = 0.0
    tasks_published: int = 0
    submissions: int = 0
    rep_events: int = 0


class NodeClient:
    """RPC-shaped façade over one ledger stack (L1 + optional L2)."""

    def __init__(self, target, chain=None,
                 gas_table: GasTable = DEFAULT_GAS, clock_start: float = 0.0):
        self.target = target
        self.chain = chain if chain is not None else l1_of(target)
        self.gas_table = gas_table
        self._clock = clock_start
        self._event_cursor = 0          # per-client typed-event cursor

    @classmethod
    def from_spec(cls, spec: NodeSpec, *, device=None,
                  wire_state: bool = True, **build_kw) -> "NodeClient":
        """Build the ledger from a spec on ``device`` (the CUDA card unless
        named; raises without one) and wrap it.  ``wire_state`` attaches
        the default Table-I account-state handlers so ``get_account`` and
        ``state_root`` report live protocol counters."""
        target = build_ledger(spec, device=device, **build_kw)
        if wire_state:
            for fn, handler in default_state_handlers().items():
                target.register_state(fn, handler)
        gas = spec.chain.gas_table if isinstance(spec, NodeSpec) else \
            spec.gas_table
        return cls(target, gas_table=gas)

    # -- submission ------------------------------------------------------------
    def _stamp(self, at: Optional[float]) -> float:
        if at is None:
            self._clock += 0.01
            return self._clock
        self._clock = max(self._clock, float(at))
        return float(at)

    def submit(self, fn: str, sender: str, payload: Optional[Dict] = None,
               gas: Optional[int] = None,
               at: Optional[float] = None) -> TxReceipt:
        """Submit one transaction; returns its receipt (initially
        ``pending`` — call ``refresh`` after blocks/seals advance).

        ``payload`` rides only on the object backends; the SoA engines
        carry (time, gas, fn, sender) only, so a payload there is an
        error."""
        gas = int(gas if gas is not None else
                  self.gas_table.l1_per_call.get(fn, L1_DEFAULT_GAS))
        t = self._stamp(at)
        target = self.target
        if not getattr(target, "soa_native", False):
            tx = Tx(fn, sender, dict(payload or {}), gas, t)
            target.submit(tx)
            return self.refresh(TxReceipt(fn, sender, gas, t, tx=tx))
        if payload:
            raise ValueError(
                "payloads need ChainSpec(backend='object'); the SoA "
                "engines carry (time, gas, fn, sender) only")
        dev = target.device
        batch = TxArrays(
            torch.tensor([t], dtype=torch.float64, device=dev),
            torch.tensor([gas], dtype=torch.int64, device=dev),
            torch.tensor([target.fns.id(fn)], dtype=torch.int32, device=dev),
            torch.tensor([target.sender_id(sender)], dtype=torch.int32,
                         device=dev), target.fns)
        prov = target.submit_arrays(batch)
        if isinstance(prov[0], torch.Tensor):         # fabric: (shard, seq)
            rcpt = TxReceipt(fn, sender, gas, t, shard=int(prov[0][0]),
                             seq=int(prov[1][0]))
        else:                                         # (lo, hi) range
            rcpt = TxReceipt(fn, sender, gas, t, seq=prov[0])
        return self.refresh(rcpt)

    def submit_arrays(self, batch) -> List[TxReceipt]:
        """Submit a SoA TxArrays batch; returns one receipt per tx (built
        from one host copy of the batch)."""
        names = batch.fns.names
        fn_ids, senders = batch.fn_id.tolist(), batch.sender_id.tolist()
        gas, times = batch.gas.tolist(), batch.submit_time.tolist()
        prov = self.target.submit_arrays(batch)
        if isinstance(prov, tuple) and isinstance(prov[0], torch.Tensor):
            shard_of, seq_of = prov[0].tolist(), prov[1].tolist()  # fabric
            out = [TxReceipt(names[f], f"acct{s}", g, t, shard=k, seq=q)
                   for f, s, g, t, k, q in zip(fn_ids, senders, gas, times,
                                               shard_of, seq_of)]
        elif isinstance(prov, tuple):                 # (lo, hi) range
            out = [TxReceipt(names[f], f"acct{s}", g, t, seq=prov[0] + i)
                   for i, (f, s, g, t) in enumerate(zip(fn_ids, senders,
                                                        gas, times))]
        else:                                         # object faces: Txs
            out = [TxReceipt(names[f], tx.sender, g, t, tx=tx)
                   for f, g, t, tx in zip(fn_ids, gas, times, prov)]
        self._clock = max(self._clock, times[-1] if times else 0.0)
        return out

    # -- receipt resolution ----------------------------------------------------
    def refresh(self, rcpt: TxReceipt) -> TxReceipt:
        """Re-resolve a receipt against the live ledger (in place)."""
        t = self.target
        if hasattr(t, "shards"):                      # sharded fabric
            self._refresh_rollup(rcpt, t.shards[rcpt.shard])
        elif hasattr(t, "batch_size"):                # rollup face
            self._refresh_rollup(rcpt, t)
        else:                                         # chain-only
            self._refresh_chain(rcpt)
        return rcpt

    def _refresh_rollup(self, r: TxReceipt, ru) -> None:
        if r.tx is not None:                          # object Rollup
            batch = ru.tx_batch.get(r.tx.tx_id)
        else:
            batch = ru.batch_of_seq(r.seq)
        if batch is None:
            r.status = "pending"
            return
        r.batch = int(batch)
        row = ru.gas_log[batch] if (batch < len(ru.gas_log) and
                                    ru.gas_log[batch]["batch"] == batch) \
            else next(x for x in ru.gas_log if x["batch"] == batch)
        n_txs = max(1, int(row["n_txs"]))
        r.gas_breakdown = {
            "intrinsic": float(r.gas),
            "batch_commit": float(row["commit"]),
            "batch_verify": float(row["verify"]),
            "batch_execute": float(row["execute"]),
            "batch_total": float(row["total"]),
            "batch_n_txs": float(row["n_txs"]),
            "amortized": float(row["total"]) / n_txs,
            # per-tx slice of the ONE L1 verify the batch's aggregate
            # posted (0 until finalized)
            "verify_share": float(row["verify"]) / n_txs,
        }
        r.proof_ref = row.get("job")
        r.aggregate_ref = row.get("aggregate")
        if batch in ru.batch_settle_ref:
            r.status = "finalized"
        else:
            phase = ru.prover.phase_of(ru, batch)
            r.status = phase if phase is not None else "sealed"
        ref = ru.batch_commit_ref.get(batch)
        r.l1_ref = getattr(ref, "tx_id", ref)
        if isinstance(ref, Tx):                       # object Chain Tx
            self._resolve_tx(r, ref)
        elif ref is not None:                         # L1 arrival index
            blk = self.chain.block_of(int(ref))
            if blk is not None:
                r.block, r.block_hash = blk.height, blk.block_hash
                r.confirm_time = self.chain.confirm_time_of(int(ref))

    def _resolve_tx(self, r: TxReceipt, tx: Tx) -> None:
        """Block, hash and confirm time of an object Tx on the L1."""
        r.block, r.confirm_time = tx.block_height, tx.confirm_time
        if tx.block_height is not None:
            r.block_hash = self.chain.blocks[tx.block_height].block_hash

    def _refresh_chain(self, r: TxReceipt) -> None:
        r.gas_breakdown = {"intrinsic": float(r.gas)}
        if r.tx is not None:                          # object Chain
            if r.tx.confirm_time is None:
                r.status = "pending"
                return
            r.status = "confirmed"
            self._resolve_tx(r, r.tx)
        else:                                         # VectorChain
            blk = self.chain.block_of(r.seq)
            if blk is None:
                r.status = "pending"
                return
            r.status = "confirmed"
            r.block, r.block_hash = blk.height, blk.block_hash
            r.confirm_time = self.chain.confirm_time_of(r.seq)
        r.l1_ref = r.block_hash

    # -- state queries ---------------------------------------------------------
    def _state_arrays(self):
        """The account state: the fabric keeps it in ``state`` (the object
        Rollup's ``state`` is its dict), the other faces in
        ``state_arrays``."""
        st = getattr(self.target, "state", None)
        if isinstance(st, StateArrays):
            return st
        return getattr(self.target, "state_arrays", None)

    def get_account(self, addr: str) -> AccountView:
        """Balance/stake/reputation + protocol counters for an address
        (a read: unknown addresses are NOT minted into the namespace)."""
        sid = getattr(self.target, "_sender_ids", {}).get(addr)
        st = self._state_arrays()
        if sid is None or st is None or sid >= st.n:
            return AccountView(addr, sid)
        vals = {name: getattr(st, name)[sid].item()
                for name, _ in STATE_SCHEMA}
        return AccountView(
            addr, sid, balance=float(vals["balances"]),
            stake=float(vals["stake"]),
            reputation=float(vals["reputation"]),
            tasks_published=int(vals["tasks_published"]),
            submissions=int(vals["submissions"]),
            rep_events=int(vals["rep_events"]))

    def state_root(self) -> str:
        return self.target.state_root()

    # -- events ----------------------------------------------------------------
    def _event_log(self):
        log = getattr(self.target, "events", None)
        return log if log is not None else self.chain.events

    def capabilities(self) -> frozenset:
        """Typed-event kinds this backend emits through ``events()``, plus
        the execution-path marker ``"fused_window_loop"`` when the stack
        can run the core/fused.py plan-then-execute loop (what
        ``Scheduler(fused="auto")`` picks).  Every node emits
        ``block_packed``; rollup nodes add the proof lifecycle."""
        caps = {"block_packed"}
        if getattr(self.target, "prover", None) is not None:
            caps |= {"batch_sealed", "proof_generated",
                     "aggregate_verified", "window_settled"}
        rollup = None if self.target is self.chain else self.target
        if supports_fused(self.chain, rollup):
            caps.add("fused_window_loop")
        return frozenset(caps)

    def events(self, kinds=None,
               cursor: Optional[int] = None) -> List[LedgerEvent]:
        """Drain the typed events emitted since this client's last call
        (per-client cursor).  ``kinds`` filters what is returned, never
        what the cursor advances past.  ``cursor`` reads from that
        position WITHOUT touching this client's own cursor; on a bounded
        log a stale cursor yields a leading ``EventsDropped`` marker."""
        log = self._event_log()
        if cursor is None:
            new = log.since(self._event_cursor)
            self._event_cursor = log.next_cursor
        else:
            new = log.since(int(cursor))
        if kinds is not None:
            kinds = frozenset(kinds)
            new = [e for e in new if e.kind in kinds]
        return new

    def events_page(self, cursor: int = 0, kinds=None,
                    limit: Optional[int] = None):
        """One page of the typed event stream for an explicit consumer:
        ``(events, next_cursor, n_dropped)``."""
        log = self._event_log()
        n_dropped = log.dropped(int(cursor))
        new = log.since(int(cursor))
        if n_dropped:
            new = new[1:]                 # drop the synthesized marker;
        if limit is not None:             # n_dropped reports the gap
            new = new[:int(limit)]
        next_cursor = (new[-1].seq + 1 if new
                       else max(int(cursor), log.base))
        if kinds is not None:
            kinds = frozenset(kinds)
            new = [e for e in new if e.kind in kinds]
        return new, next_cursor, n_dropped

    def subscribe(self, event: str, callback: Callable) -> None:
        """DEPRECATED one-release shim over the string-keyed callback
        hooks (``batch_sealed``/``session_settled`` on rollup faces,
        ``window_settled`` on the fabric, ``block_packed`` on the L1) —
        drain typed events via ``events()`` instead."""
        warnings.warn(
            "NodeClient.subscribe is deprecated; drain typed events via "
            "client.events() (see docs/MIGRATION.md)", DeprecationWarning,
            stacklevel=2)
        if event == "block_packed":
            self.chain.subscribe(event, callback)
            return
        target = self.target
        sub = getattr(target, "subscribe", None)
        legacy = set(getattr(target, "EVENTS", ()))
        if hasattr(target, "shards"):
            legacy |= {"batch_sealed", "session_settled", "window_settled"}
        if sub is None or event not in legacy:
            raise ValueError(
                f"event {event!r} is not a callback hook of this backend; "
                f"typed stream capabilities: {sorted(self.capabilities())} "
                f"(use client.events())")
        sub(event, callback)

    # -- lifecycle passthroughs ------------------------------------------------
    def seal(self) -> int:
        """Seal pending L2 batches (no-op count on chain-only nodes)."""
        seal = getattr(self.target, "seal", None)
        return seal() if seal is not None else 0

    def flush(self) -> None:
        """Seal + settle the open L2 session (chain-only: no-op)."""
        flush = getattr(self.target, "flush", None)
        if flush is not None:
            flush()

    def run_until(self, t_end: float) -> None:
        """Drive the modeled prover's drain — and then L1 block
        production — to ``t_end`` simulated seconds.  The prover pumps
        FIRST so that window-finalized settlement transactions land in
        the mempool before the blocks that should pack them."""
        pump = getattr(self.target, "pump", None)
        if pump is not None:
            pump(t_end)
        self.chain.run_until(t_end)
        self._clock = max(self._clock, t_end)
