"""L1 permissioned-chain simulator of the port (``src/repro/core/ledger.py``):
accounts and roles, mempool, QBFT quorum, gas-limited blocks.  Drives the
paper's Fig. 4 (throughput and latency against send rate) and backs the FL
task lifecycle (core/tasks.py).

  * ``LedgerBackend`` is the surface every ledger face shares: the object
    ``Chain`` (this module) and ``Rollup`` (core/rollup.py), and the SoA
    ``VectorChain`` and ``VectorRollup`` (core/engine.py).
  * ``Chain`` is the per-Tx simulator, discrete-event over block
    boundaries: transactions arrive with timestamps, wait in the mempool
    and are packed FIFO into blocks under the block gas limit.  Latency =
    confirmation time - submit time.  Its ``StateArrays`` live on the
    chain's device; each confirmed tx runs its state handler through a
    1-row view there, in confirmation order.
  * ``simulate_load`` and ``simulate_workload`` run the Fig. 4 experiments
    on either chain; both give the JAX package's metrics bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from collections import deque
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    runtime_checkable)

import numpy as np

from repro_torch.core.events import BlockPacked, EventLog
from repro_torch.core.gas import DEFAULT_GAS, GasTable
from repro_torch.device import resolve_device

ROLES = ("admin", "task_publisher", "trainer", "evaluator", "aggregator",
         "validator", "oracle")


@runtime_checkable
class LedgerBackend(Protocol):
    """The one surface every ledger face shares (``Chain`` and ``Rollup``
    on the object path, ``VectorChain`` and ``VectorRollup`` on the SoA
    path, core/engine.py):

      * ``submit(tx)`` / ``submit_arrays(batch)`` — object-Tx and SoA
        ingestion (the object faces lower ``TxArrays`` row by row; the
        SoA faces lift single ``Tx`` objects through a shim).
      * ``sender_id(name)`` — the backend's stable sender namespace;
        account ids index ``StateArrays`` rows directly.
      * ``register_state(fn, handler)`` — attach a handler written against
        ``(StateArrays, TxArrays-view)``, the view holding only the
        registered function's transactions in confirmation order (the
        object faces run it per tx, on a 1-row view).
      * ``state_root()`` — the chunked commitment over the attached
        ``StateArrays`` (core/state.py), or "" when none is attached.
    """

    def submit(self, tx) -> None: ...
    def submit_arrays(self, batch) -> None: ...
    def sender_id(self, sender: str) -> int: ...
    def register_state(self, fn: str, handler: Callable) -> None: ...
    def state_root(self) -> str: ...


class EventHooks:
    """Legacy string-keyed callback plumbing.  The supported surface is
    the typed event stream (core/events.py) drained through
    ``repro_torch.api.NodeClient.events()``; the emission sites feed both.

    Subclasses call ``_init_events()`` from ``__init__`` and ``_emit`` at
    the event sites.
    """

    EVENTS = ("batch_sealed", "session_settled")

    def _init_events(self):
        self._subs: Dict[str, List[Callable]] = {}

    def subscribe(self, event: str, callback: Callable) -> None:
        """Register ``callback(payload)`` for ``"batch_sealed"`` (once
        per seal, covering all batches sealed together) or
        ``"session_settled"`` (once per amortized verify/execute)."""
        if event not in self.EVENTS:
            raise ValueError(f"unknown event {event!r}; "
                             f"choose from {self.EVENTS}")
        self._subs.setdefault(event, []).append(callback)

    def _emit(self, event: str, payload: Dict[str, Any]) -> None:
        for cb in self._subs.get(event, ()):
            cb(payload)


def lift_tx_rows(txs, fns, sender_ids: List[int], device):
    """Object -> SoA adapter: one ``TxArrays`` on ``device`` over object
    ``Tx`` rows, with sender ids resolved in the TARGET's namespace
    (``TxArrays.from_txs`` would mint a private namespace and misalign
    ``StateArrays`` rows)."""
    from repro_torch.core.engine import TxArrays
    return TxArrays.from_numpy([t.submit_time for t in txs],
                               [t.gas for t in txs],
                               [fns.id(t.fn) for t in txs], sender_ids, fns,
                               device)


class ObjectLedgerFace:
    """Shared object-face LedgerBackend plumbing for ``Chain`` and
    ``rollup.Rollup``: ONE sender/account namespace, the id-pinning
    SoA-lowering adapter, and the StateArrays bootstrap on the face's
    ``device``.

    Subclasses set ``device``, provide ``submit(tx)`` and call
    ``_init_object_face()`` from ``__init__``."""

    def _init_object_face(self):
        self.state_arrays = None
        self._state_handlers: Dict[str, Callable] = {}
        self._sender_ids: Dict[str, int] = {}
        self._sender_names: Dict[int, str] = {}
        self._state_fns = None

    def sender_id(self, sender: str) -> int:
        """Stable sender-name -> id mapping (StateArrays row index)."""
        sid = self._sender_ids.setdefault(sender, len(self._sender_ids))
        self._sender_names.setdefault(sid, sender)
        return sid

    def _sender_name(self, sid: int) -> str:
        """Reverse id -> name, PINNING unknown ids so that a later
        ``sender_id`` round-trips to the same id: lowering a SoA batch
        must not re-mint ids, or state handlers would scatter to the wrong
        StateArrays rows."""
        name = self._sender_names.get(sid)
        if name is None:
            name = f"__acct{sid}"
            if self._sender_ids.setdefault(name, sid) != sid:
                raise RuntimeError(f"sender name {name!r} is taken")
            self._sender_names[sid] = name
        return name

    def register_state(self, fn: str, handler: Callable):
        """Attach a StateArrays handler (see LedgerBackend).  Creates the
        SoA state on the face's device at the first registration."""
        if self.state_arrays is None:
            from repro_torch.core.state import StateArrays
            self.state_arrays = StateArrays(device=self.device)
            self.state_arrays.enable_dirty_tracking()
        self._state_handlers[fn] = handler

    def state_root(self) -> str:
        return self.state_arrays.root() if self.state_arrays is not None \
            else ""

    def _apply_state_tx(self, tx: "Tx"):
        """1-row-view adapter: run the fn's StateArrays handler for one
        executed or confirmed object Tx (a few tiny host-to-device copies
        a tx)."""
        handler = self._state_handlers.get(tx.fn)
        if handler is None:
            return
        if self._state_fns is None:
            from repro_torch.core.engine import FnRegistry
            self._state_fns = FnRegistry()
        handler(self.state_arrays,
                lift_tx_rows([tx], self._state_fns,
                             [self.sender_id(tx.sender)], self.device))

    def submit_arrays(self, batch):
        """SoA ingestion adapter: lower a TxArrays batch to object txs
        (small N: the vector engine is the path at scale), in one host
        copy.  Sender ids are preserved, not re-minted (see
        ``_sender_name``).  Returns the lowered ``Tx`` objects (the object
        path's provenance handles)."""
        names = batch.fns.names
        txs = [Tx(names[f], self._sender_name(s), {}, g, t)
               for f, s, g, t in zip(batch.fn_id.tolist(),
                                     batch.sender_id.tolist(),
                                     batch.gas.tolist(),
                                     batch.submit_time.tolist())]
        for tx in txs:
            self.submit(tx)
        return txs


@dataclasses.dataclass
class Tx:
    fn: str
    sender: str
    payload: Dict[str, Any]
    gas: int
    submit_time: float
    tx_id: str = ""
    confirm_time: Optional[float] = None
    block_height: Optional[int] = None    # set when packed into an L1 block

    def __post_init__(self):
        if not self.tx_id:
            h = hashlib.sha256(
                json.dumps([self.fn, self.sender, self.submit_time,
                            sorted(self.payload.items(), key=str)],
                           default=str).encode()).hexdigest()
            self.tx_id = h[:16]


@dataclasses.dataclass
class Block:
    height: int
    time: float
    txs: List[Tx]
    gas_used: int
    parent: str
    block_hash: str = ""

    def __post_init__(self):
        if not self.block_hash:
            h = hashlib.sha256(
                (self.parent + str(self.height) +
                 "".join(t.tx_id for t in self.txs)).encode()).hexdigest()
            self.block_hash = h[:16]


class AccessControl:
    """ASC: role-based permissioning with admin majority voting (Sybil /
    whitewashing mitigation: only the consortium can add or re-add
    users)."""

    def __init__(self, admins: List[str]):
        self.admins = set(admins)
        self.roles: Dict[str, set] = {a: {"admin"} for a in admins}
        self.banned: set = set()
        self._votes: Dict[str, set] = {}

    def _check_admin(self, admin: str) -> None:
        if admin not in self.admins:
            raise PermissionError(f"{admin!r} is not an admin")

    def grant(self, admin: str, user: str, role: str):
        self._check_admin(admin)
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}; choose from {ROLES}")
        if user in self.banned:
            raise PermissionError("banned identity: consortium vote required")
        self.roles.setdefault(user, set()).add(role)

    def has_role(self, user: str, role: str) -> bool:
        return role in self.roles.get(user, ())

    def ban(self, admin: str, user: str):
        self._check_admin(admin)
        self.banned.add(user)
        self.roles.pop(user, None)

    def vote_readmit(self, admin: str, user: str) -> bool:
        """Whitewashing guard: a strict majority of admins (self-votes
        rejected, double votes idempotent) re-admits a banned user."""
        self._check_admin(admin)
        if admin == user:
            raise PermissionError("self-readmission vote rejected")
        self._votes.setdefault(user, set()).add(admin)
        if len(self._votes[user]) * 2 > len(self.admins):
            self.banned.discard(user)
            del self._votes[user]
            return True
        return False


class Chain(ObjectLedgerFace, EventHooks):
    """Gas-limited block production with a QBFT-style quorum check, one
    object ``Tx`` at a time.  ``device``: where the attached StateArrays
    live (the card unless named)."""

    EVENTS = ("block_packed",)

    def __init__(self, n_validators: int = 4, block_time: float = 1.0,
                 block_gas_limit: int = 9_000_000,
                 gas_table: GasTable = DEFAULT_GAS, device=None):
        if n_validators < 4:
            raise ValueError("QBFT needs >= 3f+1 validators with f >= 1")
        self.device = resolve_device(device)
        self.n_validators = n_validators
        self.block_time = block_time
        self.block_gas_limit = block_gas_limit
        self.gas_table = gas_table
        self.mempool: deque[Tx] = deque()
        self.blocks: List[Block] = [Block(0, 0.0, [], 0, "genesis")]
        self.state: Dict[str, Any] = {}
        self._handlers: Dict[str, Callable] = {}
        self.total_gas = 0
        # the stack-wide typed event stream: the L1 owns it, every L2
        # face built on this chain adopts the same log (core/events.py)
        self.events = EventLog()
        self._init_events()
        self._init_object_face()

    # -- contract surface ------------------------------------------------------
    def register(self, fn: str, handler: Callable):
        self._handlers[fn] = handler

    def submit(self, tx: Tx):
        self.mempool.append(tx)

    def quorum(self, approvals: int) -> bool:
        return 3 * approvals >= 2 * self.n_validators

    # -- block production ------------------------------------------------------
    def produce_block(self, now: float) -> Block:
        """Pack one block at time ``now``.

        FIFO head-of-line semantics (mirrored by engine.VectorChain): the
        mempool is walked in submission order and packing stops at the
        first tx whose ``submit_time`` is in the future or whose gas would
        overflow the block; later txs are never skipped ahead.
        """
        txs, gas_used = [], 0
        height = len(self.blocks)
        while self.mempool:
            tx = self.mempool[0]
            if tx.submit_time > now:
                break
            if gas_used + tx.gas > self.block_gas_limit:
                break
            self.mempool.popleft()
            handler = self._handlers.get(tx.fn)
            if handler is not None:
                handler(self.state, tx)
            if self._state_handlers:
                self._apply_state_tx(tx)
            tx.confirm_time = now
            tx.block_height = height
            txs.append(tx)
            gas_used += tx.gas
        # QBFT: 2/3 of validators sign (the paper's honest majority)
        if not self.quorum(self.n_validators - self.n_validators // 3):
            raise RuntimeError("no QBFT quorum")
        blk = Block(height, now, txs, gas_used, self.blocks[-1].block_hash)
        self.blocks.append(blk)
        self.total_gas += gas_used
        self.events.emit(BlockPacked, time=now, height=blk.height,
                         n_txs=len(txs), gas_used=gas_used,
                         block_hash=blk.block_hash)
        self._emit("block_packed", {"height": blk.height, "n_txs": len(txs),
                                    "gas_used": gas_used,
                                    "block_hash": blk.block_hash})
        return blk

    def run_until(self, t_end: float):
        t = self.blocks[-1].time
        while t < t_end:
            t += self.block_time
            self.produce_block(t)

    def confirmed_metrics(self, send_rate: float, duration: float,
                          submitted: int) -> Dict[str, float]:
        """Fig. 4 metrics over the confirmed txs (latency: numpy's mean in
        confirmation order, as the JAX package takes it)."""
        confirmed = [t for b in self.blocks for t in b.txs
                     if t.confirm_time is not None]
        lat = (float(np.mean([t.confirm_time - t.submit_time
                              for t in confirmed])) if confirmed else 0.0)
        return {"send_rate": send_rate,
                "throughput": len(confirmed) / duration, "latency": lat,
                "confirmed": len(confirmed), "submitted": submitted}


def _resolve_chain_spec(spec, engine, block_time, block_gas_limit,
                        gas_table):
    """spec wins and is exclusive; the loose kwargs (and the deprecated
    ``engine=`` string flag) fold into a ChainSpec otherwise."""
    from repro_torch.api.specs import ChainSpec
    if spec is not None:
        if not (engine is None and block_time is None
                and block_gas_limit is None and gas_table is None):
            raise ValueError(
                "pass either spec= or the loose chain kwargs, not both")
        return spec
    if engine is not None:
        warnings.warn("engine= is deprecated; pass "
                      "spec=repro_torch.api.ChainSpec(backend=...)",
                      DeprecationWarning, stacklevel=3)
    return ChainSpec(backend=engine or "vector",
                     block_time=1.0 if block_time is None else block_time,
                     block_gas_limit=(9_000_000 if block_gas_limit is None
                                      else block_gas_limit),
                     gas_table=gas_table if gas_table is not None
                     else DEFAULT_GAS)


def simulate_load(fn: str, send_rate: float, duration: float = 30.0,
                  gas_table: Optional[GasTable] = None, seed: int = 0,
                  block_time: Optional[float] = None,
                  block_gas_limit: Optional[int] = None,
                  engine: Optional[str] = None, *, spec=None,
                  device=None) -> Dict[str, float]:
    """Fig. 4 experiment: constant send rate of one function type.

    The chain is described by ``spec`` (a ``repro_torch.api.ChainSpec``;
    the vector backend by default) and built on ``device`` (the card
    unless named).  Both backends draw the same arrival times from the
    same numpy stream and pack FIFO alike, so their metrics are equal,
    and equal to the JAX package's.  ``engine=`` is the deprecated string
    form of ``spec.backend``.
    """
    spec = _resolve_chain_spec(spec, engine, block_time, block_gas_limit,
                               gas_table)
    from repro_torch.api.factory import build_chain
    rng = np.random.default_rng(seed)
    n = int(send_rate * duration)
    times = np.sort(rng.uniform(0.0, duration, n))
    gas = spec.gas_table.l1_per_call[fn]
    chain = build_chain(spec, device=device)
    if spec.backend == "vector":
        from repro_torch.core.engine import TxArrays
        chain.submit_arrays(TxArrays.homogeneous(fn, times, gas,
                                                 device=chain.device))
        chain.run_until(duration)
        return chain.load_metrics(send_rate, duration)
    for i, t in enumerate(times.tolist()):
        chain.submit(Tx(fn, f"client{i % 64}", {}, gas, t))
    chain.run_until(duration)
    return chain.confirmed_metrics(send_rate, duration, n)


def simulate_workload(workload, block_time: Optional[float] = None,
                      block_gas_limit: Optional[int] = None,
                      gas_table: Optional[GasTable] = None,
                      engine: Optional[str] = None, *, spec=None,
                      device=None) -> Dict[str, float]:
    """Run a workloads.Workload scenario (or a ``WorkloadSpec``, built on
    ``device``) through the spec'd chain on ``device`` (the card unless
    named) and report the Fig. 4 metrics."""
    spec = _resolve_chain_spec(spec, engine, block_time, block_gas_limit,
                               gas_table)
    dev = resolve_device(device)
    if hasattr(workload, "build"):          # WorkloadSpec -> Workload
        workload = workload.build(device=dev)
    duration = workload.duration
    rate = len(workload) / max(duration, 1e-9)
    from repro_torch.api.factory import build_chain
    if spec.backend == "vector":
        chain = build_chain(spec, fns=workload.txs.fns, device=dev)
        chain.submit_arrays(workload.txs)
        chain.run_until(duration)
        m = chain.load_metrics(rate, duration)
    else:
        chain = build_chain(spec, device=dev)
        for t in workload.to_txs():
            chain.submit(t)
        chain.run_until(duration)
        m = chain.confirmed_metrics(rate, duration, len(workload))
    m["scenario"] = workload.name
    return m
