"""Mempool admission: pure decision layer ahead of the ledger.

``AdmissionController.admit`` applies the ``AdmissionSpec`` rules in a
fixed order — fee floor, reputation gate, per-sender token bucket, pool
capacity — and either places the transaction in the ``PendingPool`` or
rejects it with a machine-readable reason.  Every decision is a pure
function of (spec, sender state, pool state) and the transaction's
MODELED submit time: nothing here may read the wall clock, so a recorded
admission log replays to the identical admitted set.  Plain Python, no
torch: the port's own copy of ``src/repro/serve/admission.py``.

Rejection reasons (``REJECT_REASONS``):

  * ``fee_floor``    — offered fee below ``AdmissionSpec.fee_floor``
  * ``reputation``   — sender below ``r_min`` under ``rep_gate="reject"``
  * ``surcharge``    — sender below ``r_min`` under ``"surcharge"`` and
    the offered fee does not cover ``rep_surcharge x intrinsic`` gas
  * ``rate_limited`` — the sender's token bucket is empty
  * ``overloaded``   — the pool is at cap and the arrival's fee does not
    beat the cheapest pooled entry (or eviction is disabled); the
    serving layer maps this to HTTP 429

The trust line and newcomer prior come from the node's own
``ReputationParams`` (``r_min``/``r_init``): a sender with no on-ledger
reputation history is treated at ``r_init`` — the paper's newcomers
start above the trust line, not at zero.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.api.specs import AdmissionSpec
from repro_torch.core.reputation import ReputationParams

#: every reason ``Decision.reason`` can carry (order = rule order)
REJECT_REASONS = ("fee_floor", "reputation", "surcharge", "rate_limited",
                  "overloaded")


@dataclasses.dataclass(frozen=True)
class PoolEntry:
    """One admitted-but-not-yet-flushed transaction."""

    ref: int                     # service-assigned submission ref
    fn: str
    sender: str
    fee: int                     # offered gas (what the ledger meters)
    at: float                    # modeled submit time


@dataclasses.dataclass(frozen=True)
class Decision:
    """Outcome of one admission check."""

    admitted: bool
    reason: Optional[str] = None     # one of REJECT_REASONS when rejected
    evicted: Optional[int] = None    # ref displaced to make room, if any


class PendingPool:
    """Bounded pending pool with lowest-fee-first eviction.

    A min-heap on ``(fee, ref)`` finds the cheapest entry in O(log n);
    ``ref`` ties the ordering so equal-fee entries never compare
    ``PoolEntry`` objects and eviction is deterministic (oldest ref
    first among equal fees).  Entries leave either by ``drain`` (the
    service's window flush) or by ``evict_cheapest``; the heap removes
    stale refs lazily.
    """

    def __init__(self, cap: int):
        self.cap = int(cap)
        self.entries: Dict[int, PoolEntry] = {}
        self._heap: List[Tuple[int, int]] = []      # (fee, ref)

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def full(self) -> bool:
        return len(self.entries) >= self.cap

    def place(self, entry: PoolEntry) -> None:
        self.entries[entry.ref] = entry
        heapq.heappush(self._heap, (entry.fee, entry.ref))

    def cheapest_fee(self) -> Optional[int]:
        """Fee of the cheapest live entry (None on an empty pool)."""
        while self._heap and self._heap[0][1] not in self.entries:
            heapq.heappop(self._heap)               # lazily drop drained refs
        return self._heap[0][0] if self._heap else None

    def evict_cheapest(self) -> Optional[int]:
        """Remove and return the ref of the cheapest live entry."""
        if self.cheapest_fee() is None:
            return None
        _fee, ref = heapq.heappop(self._heap)
        del self.entries[ref]
        return ref

    def drain(self) -> List[PoolEntry]:
        """Remove every entry, ordered by (modeled time, ref) — the
        deterministic flush order the service commits to the ledger."""
        out = sorted(self.entries.values(), key=lambda e: (e.at, e.ref))
        self.entries.clear()
        self._heap.clear()
        return out


class AdmissionController:
    """Applies one ``AdmissionSpec`` over one ``PendingPool``.

    Keeps the per-sender token buckets, the admission log (every
    decision, in ref order) and per-reason counters.  All time is the
    modeled submit time the caller passes in.
    """

    def __init__(self, spec: AdmissionSpec, rep: ReputationParams,
                 pool: Optional[PendingPool] = None):
        self.spec = spec
        self.rep = rep
        self.pool = pool if pool is not None else PendingPool(spec.pool_cap)
        # sender -> (tokens, last refill time); buckets start full
        self._buckets: Dict[str, Tuple[float, float]] = {}
        self.log: List[Tuple[int, str, str, int, float, str]] = []
        self.n_admitted = 0
        self.n_evicted = 0
        self.rejected: Dict[str, int] = {r: 0 for r in REJECT_REASONS}

    # -- rules, in order --------------------------------------------------------
    def _take_token(self, sender: str, at: float) -> bool:
        spec = self.spec
        tokens, last = self._buckets.get(sender, (float(spec.burst), at))
        tokens = min(float(spec.burst),
                     tokens + max(0.0, at - last) * spec.rate_limit)
        ok = tokens >= 1.0
        if ok:
            tokens -= 1.0
        self._buckets[sender] = (tokens, max(last, at))
        return ok

    def admit(self, *, ref: int, fn: str, sender: str, fee: int,
              intrinsic: int, at: float, reputation: float) -> Decision:
        """Run the rule ladder for one transaction; on admission the
        entry is placed in the pool (possibly displacing the cheapest).

        ``intrinsic`` is the function's schedule gas, ``fee`` the gas
        the sender actually offers (what the ledger will meter),
        ``reputation`` the sender's resolved modeled reputation."""
        spec = self.spec
        if fee < spec.fee_floor:
            return self._reject(ref, fn, sender, fee, at, "fee_floor")
        if spec.rep_gate != "off" and reputation < self.rep.r_min:
            if spec.rep_gate == "reject":
                return self._reject(ref, fn, sender, fee, at, "reputation")
            if fee < spec.rep_surcharge * intrinsic:
                return self._reject(ref, fn, sender, fee, at, "surcharge")
        if not self._take_token(sender, at):
            return self._reject(ref, fn, sender, fee, at, "rate_limited")
        evicted = None
        if self.pool.full:
            cheapest = self.pool.cheapest_fee()
            # strict >: an equal-fee arrival must not churn pooled peers
            if not spec.evict or cheapest is None or fee <= cheapest:
                return self._reject(ref, fn, sender, fee, at, "overloaded")
            evicted = self.pool.evict_cheapest()
            self.n_evicted += 1
        self.pool.place(PoolEntry(ref, fn, sender, int(fee), float(at)))
        self.n_admitted += 1
        self.log.append((ref, sender, fn, int(fee), float(at), "admitted"))
        return Decision(True, evicted=evicted)

    def _reject(self, ref: int, fn: str, sender: str, fee: int, at: float,
                reason: str) -> Decision:
        self.rejected[reason] += 1
        self.log.append((ref, sender, fn, int(fee), float(at), reason))
        return Decision(False, reason=reason)

    def counters(self) -> Dict[str, int]:
        out = {"admitted": self.n_admitted, "evicted": self.n_evicted}
        out.update({f"rejected_{k}": v for k, v in self.rejected.items()})
        return out
