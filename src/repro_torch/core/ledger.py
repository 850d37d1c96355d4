"""Ledger surface shared by the port's faces: the ``LedgerBackend``
protocol, the legacy ``EventHooks`` callbacks, the object ``Tx`` and the
role contract ``AccessControl`` that the FL task contracts check.

The object ``Chain``, ``simulate_load`` and ``simulate_workload`` of
``src/repro/core/ledger.py`` are not ported yet (ROADMAP.md, queue 1
item 7).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    runtime_checkable)

ROLES = ("admin", "task_publisher", "trainer", "evaluator", "aggregator",
         "validator", "oracle")


@runtime_checkable
class LedgerBackend(Protocol):
    """The one surface every ledger face shares (``VectorChain`` and
    ``VectorRollup`` in the port, core/engine.py):

      * ``submit(tx)`` / ``submit_arrays(batch)`` — object-Tx and SoA
        ingestion (the SoA faces lift single ``Tx`` objects through a
        shim).
      * ``sender_id(name)`` — the backend's stable sender namespace;
        account ids index ``StateArrays`` rows directly.
      * ``register_state(fn, handler)`` — attach a handler written against
        ``(StateArrays, TxArrays-view)``, the view holding only the
        registered function's transactions in confirmation order.
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
