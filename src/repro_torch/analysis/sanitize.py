"""Runtime sanitizer: dynamic enforcement of the invariant catalog.

``REPRO_SANITIZE=1`` (the JAX package's flag: one switch for both
packages) makes ``repro_torch.api.factory.build_stack`` install a
``StackSanitizer`` on every stack it builds (tests can also call
``install_stack`` directly).  The sanitizer wraps the stack's ONE
``EventLog`` — every lifecycle event on both the stepped and fused paths
flows through ``emit``/``splice``, so one observation point cross-checks
the same contracts the static pass (analysis/lint.py) enforces at the
AST level, plus the dynamic-only ones:

- **R001** after every ``WindowSettled``: the committed (incremental,
  dirty-chunk) state root must equal a full refold of the live arrays —
  a column write that skipped ``mark_dirty`` diverges them.
- **R005** event seq integrity: every emission extends the total order
  by exactly one; splices leave ``seq == position`` across the stream.
- **R006** gas conservation: on every ``BlockPacked`` the chain's
  ``total_gas`` equals the sum of its blocks (and, on a vector chain,
  the confirmed cumsum); on every ``BatchSealed`` the fresh gas rows
  satisfy ``total == commit + verify + execute``.
- **R007** receipt lifecycle legality: batches move strictly
  sealed -> proved -> aggregated, windows count up contiguously.

Violations raise ``SanitizeViolation`` (an AssertionError subclass
carrying ``.rule``) at the emission site, so the offending transition is
on the stack when it fires.  Overhead is dominated by the per-window
full refold — on the card one ``rollup_chunk_digests`` launch over the
whole state (and, on a fabric, the K partition roots through the same
kernel) plus one host copy of the digests; reading the confirmed gas
cumsum (a device tensor) costs one sync per ``BlockPacked``.  This is a
debugging tool: it never changes an output.  The port's own copy of
``src/repro/analysis/sanitize.py``; numbers in docs/ANALYSIS_TORCH.md.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Set, Tuple

from repro_torch.analysis.invariants import CATALOG

#: the env flag build_stack consults ("" / "0" mean off)
ENV_FLAG = "REPRO_SANITIZE"


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


class SanitizeViolation(AssertionError):
    """An invariant-catalog violation observed at run time."""

    def __init__(self, rule: str, message: str):
        self.rule = rule
        inv = CATALOG.get(rule)
        title = f" [{inv.title}]" if inv is not None else ""
        super().__init__(f"{rule}{title}: {message}")


class StackSanitizer:
    """Wraps one stack's EventLog and cross-checks every emission."""

    def __init__(self, chain, rollup=None):
        self.chain = chain
        self.rollup = rollup
        self.log = getattr(chain, "events", None)
        self.n_checks = 0                 # emissions validated (tests pin >0)
        self._last_seq = (self.log.next_cursor - 1
                          if self.log is not None else -1)
        self._sealed: Set[Tuple[Any, int]] = set()     # (shard, batch)
        self._proved: Set[Tuple[Any, int]] = set()
        self._aggregated: Set[Tuple[Any, int]] = set()
        self._windows: Dict[Any, int] = {}             # shard -> next window
        if self.log is not None:
            self._install_log(self.log)

    # -- wiring -----------------------------------------------------------------
    def _install_log(self, log) -> None:
        orig_emit, orig_splice = log.emit, log.splice

        def emit(cls, **kw):
            ev = orig_emit(cls, **kw)
            self._on_event(ev)
            return ev

        def splice(inserts):
            orig_splice(inserts)
            # seq == base + position: on an unbounded log base is 0 and
            # this is the classic seq == position contract
            for i, e in enumerate(log._events):
                if e.seq != log.base + i:
                    raise SanitizeViolation(
                        "R005", f"post-splice stream has seq {e.seq} at "
                                f"position {log.base + i}")
            self._last_seq = log.next_cursor - 1
            self._check_gas("splice")
            self.n_checks += 1

        log.emit = emit
        log.splice = splice
        log._sanitizer = self

    def _face(self, shard: Optional[int]):
        """The rollup face owning ``shard``'s gas rows/batch counters."""
        ru = self.rollup
        if ru is None:
            return None
        shards = getattr(ru, "shards", None)
        if shards is not None and shard is not None:
            return shards[shard]
        return ru

    def _state(self):
        ru = self.rollup
        if ru is None:
            return None
        st = getattr(ru, "state_arrays", None)
        if st is None:
            # the fabric's StateArrays lives at .state — but on object
            # faces .state is the plain dict book, not the array state
            cand = getattr(ru, "state", None)
            if hasattr(cand, "root") and hasattr(cand, "copy"):
                st = cand
        return st

    # -- checks -----------------------------------------------------------------
    def _on_event(self, ev) -> None:
        if ev.seq != self._last_seq + 1:
            raise SanitizeViolation(
                "R005", f"event {ev.kind!r} emitted with seq {ev.seq}, "
                        f"expected {self._last_seq + 1} — something mutated "
                        f"the log out of band")
        self._last_seq = ev.seq
        kind = ev.kind
        if kind == "batch_sealed":
            for b in range(ev.first_batch, ev.first_batch + ev.n_batches):
                self._sealed.add((ev.shard, b))
            self._check_gas_rows(ev)
        elif kind == "proof_generated":
            key = (ev.shard, ev.batch)
            if key not in self._sealed:
                raise SanitizeViolation(
                    "R007", f"ProofGenerated for batch {ev.batch} "
                            f"(shard {ev.shard}) that was never sealed")
            if key in self._proved:
                raise SanitizeViolation(
                    "R007", f"batch {ev.batch} (shard {ev.shard}) proved "
                            f"twice")
            self._proved.add(key)
        elif kind == "aggregate_verified":
            for b in ev.batches:
                key = (ev.shard, b)
                if key not in self._proved:
                    raise SanitizeViolation(
                        "R007", f"aggregate {ev.aggregate} covers batch {b} "
                                f"(shard {ev.shard}) with no proof")
                if key in self._aggregated:
                    raise SanitizeViolation(
                        "R007", f"batch {b} (shard {ev.shard}) aggregated "
                                f"twice")
                self._aggregated.add(key)
        elif kind == "window_settled":
            want = self._windows.get(ev.shard, 0)
            if ev.window != want:
                raise SanitizeViolation(
                    "R007", f"WindowSettled window {ev.window} out of order "
                            f"(shard {ev.shard}, expected {want})")
            self._windows[ev.shard] = want + 1
            self._check_root(ev)
        elif kind == "block_packed":
            self._check_gas("BlockPacked")
        self.n_checks += 1

    def _check_root(self, ev) -> None:
        """R001 dynamic form: committed incremental root == full refold."""
        st = self._state()
        if st is None or not ev.state_root:
            return
        # copy() drops dirty tracking, so root() on it is a full refold of
        # the live arrays (kernel rollup_chunk_digests on the state's
        # device); a write that skipped mark_dirty leaves the committed
        # (cached + dirty-chunk patched) root stale
        full = st.copy().root()
        if ev.state_root != full:
            raise SanitizeViolation(
                "R001", f"window {ev.window} committed state root "
                        f"{ev.state_root} != full refold {full} — a "
                        f"StateArrays write skipped mark_dirty")
        ru = self.rollup
        if ev.fabric_root and hasattr(ru, "_merge_roots"):
            fab = ru._merge_roots(
                st.copy().partition_roots(ru.n_shards))
            if ev.fabric_root != fab:
                raise SanitizeViolation(
                    "R001", f"window {ev.window} fabric root "
                            f"{ev.fabric_root} != refolded {fab}")

    def _check_gas_rows(self, ev) -> None:
        face = self._face(ev.shard)
        gas_log = getattr(face, "gas_log", None)
        if not gas_log or ev.n_batches <= 0:
            return
        for row in gas_log[-ev.n_batches:]:
            want = row["commit"] + row["verify"] + row["execute"]
            if abs(row["total"] - want) > 1e-6:
                raise SanitizeViolation(
                    "R006", f"gas row for batch {row.get('batch')} has "
                            f"total {row['total']} != commit+verify+execute "
                            f"{want}")

    def _check_gas(self, where: str) -> None:
        chain = self.chain
        total = getattr(chain, "total_gas", None)
        blocks = getattr(chain, "blocks", None)
        if total is None or blocks is None:
            return
        by_blocks = sum(b.gas_used for b in blocks)
        if total != by_blocks:
            raise SanitizeViolation(
                "R006", f"[{where}] chain.total_gas {total} != sum of "
                        f"block gas {by_blocks} — gas leaked out of band")
        ptr = getattr(chain, "_ptr", None)
        gcum = getattr(chain, "_gcum", None)
        if ptr and gcum is not None and ptr <= len(gcum):
            # the vector chain's cumsum lives on its device: one sync
            confirmed = int(gcum[ptr - 1])
            if total != confirmed:
                raise SanitizeViolation(
                    "R006", f"[{where}] chain.total_gas {total} != confirmed "
                            f"tx gas cumsum {confirmed}")


def install_stack(chain, rollup=None) -> StackSanitizer:
    """Install (or fetch) the sanitizer for ``chain``'s event log."""
    log = getattr(chain, "events", None)
    existing = getattr(log, "_sanitizer", None) if log is not None else None
    if existing is not None:
        if rollup is not None and existing.rollup is None:
            existing.rollup = rollup
        return existing
    return StackSanitizer(chain, rollup)
