"""zk-Rollup Layer-2 engine, object face (paper §III-C.3), the port of
``src/repro/core/rollup.py``.

``Rollup`` batches FL transactions off-chain, executes them against the L2
state dict, produces a validity digest (a stand-in for the zk proof) and
posts commit / verify / execute to the L1 chain with Table-I-calibrated
gas: the paper's 20x gas reduction.  It shares the settlement pipeline
(core/prover.py) with ``engine.VectorRollup``: one proof job per sealed
batch, one verify + execute pair per aggregate.

Each sealed batch's ``word_digest`` is the xor-mix fold of its merged tx
word buffer through the kernel factory's ``rollup_digest`` op (the CUDA
kernel on the card, its plain version on the CPU): one launch a batch,
bit-equal to the JAX package's ``xor_fold_digest``.  The attached
``StateArrays`` live on the L1's device and run their handlers per tx, in
seal order, on 1-row views.

Security caveat: every root here (``state_digest``, the batch
``word_digest``, the chunked ``StateArrays`` root) is a validity stand-in,
not a zk proof: deterministic and tamper-evident (replaying the batch from
``pre_root`` must reach ``post_root``), with no claim of cryptographic
succinctness or zero knowledge.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.events import BatchSealed
from repro_torch.core.gas import DEFAULT_GAS, ROLLUP_BATCH, GasTable
from repro_torch.core.ledger import Chain, EventHooks, ObjectLedgerFace, Tx
from repro_torch.core.prover import (ProverFace, ProverPipeline,
                                     session_latency)
from repro_torch.core.state import canonical_bytes


def state_digest(state: Dict[str, Any]) -> str:
    """Deterministic state-root stand-in: the content hash of the L2
    state dict over ``core.state.canonical_bytes`` (total, type-tagged)."""
    return hashlib.sha256(canonical_bytes(state)).hexdigest()[:32]


@dataclasses.dataclass
class BatchProof:
    batch_id: int
    n_txs: int
    pre_root: str
    post_root: str
    tx_root: str
    # xor-mix fold over the batch's transaction words (kernel
    # ``rollup_digest``)
    word_digest: int = 0

    def verify(self, pre_state: Dict[str, Any],
               replay: Callable[[Dict[str, Any]], Dict[str, Any]]) -> bool:
        """Validity check: replaying the batch from pre_root reaches
        post_root (a zk-SNARK proves this without replay)."""
        if state_digest(pre_state) != self.pre_root:
            return False
        return state_digest(replay(pre_state)) == self.post_root


class Rollup(ObjectLedgerFace, ProverFace, EventHooks):
    """L2 sequencer + prover + L1 settlement over an object ``Chain``."""

    def __init__(self, l1: Chain, batch_size: int = ROLLUP_BATCH,
                 gas_table: GasTable = DEFAULT_GAS,
                 prove_time: float = 0.9, per_tx_time: float = 0.14,
                 agg_width: int = 1, prover_capacity: int = 1,
                 finalize: str = "eager",
                 prover: Optional[ProverPipeline] = None):
        self.l1 = l1
        self.device = l1.device
        self.batch_size = batch_size
        self.gas_table = gas_table
        self.prove_time = prove_time      # per-batch prover latency (s)
        self.per_tx_time = per_tx_time    # sequencer execution latency (s)
        self.state: Dict[str, Any] = {}
        self._handlers: Dict[str, Callable] = {}
        self._init_object_face()
        self.pending: List[Tx] = []
        self.batches: List[BatchProof] = []
        self.gas_log: List[Dict[str, Any]] = []
        self._sealing = False
        self._last_time = 0.0
        # tx->batch provenance + per-batch L1 refs (receipts), keyed by
        # tx_id on the object path
        self.tx_batch: Dict[str, int] = {}
        self.batch_commit_ref: Dict[int, Tx] = {}
        self.batch_settle_ref: Dict[int, tuple] = {}
        self._init_events()
        self._init_prover_face(l1, gas_table, prove_time, agg_width,
                               prover_capacity, finalize, prover)

    def register(self, fn: str, handler: Callable):
        self._handlers[fn] = handler

    # -- sequencing -------------------------------------------------------------
    def submit(self, tx: Tx):
        self.pending.append(tx)
        if len(self.pending) >= self.batch_size:
            self.seal_batch()

    def _execute(self, state: Dict[str, Any], txs: List[Tx]) -> Dict[str, Any]:
        # PURE (state, txs) -> state replay: BatchProof.verify replays
        # batches through it, so it must not touch the live StateArrays
        for tx in txs:
            handler = self._handlers.get(tx.fn)
            if handler is not None:
                handler(state, tx)
        return state

    def seal(self) -> int:
        """Seal every pending tx (the LedgerBackend face shared with
        VectorRollup.seal); returns #batches."""
        nb = 0
        while self.pending:
            if self.seal_batch() is None:
                break
            nb += 1
        self._emit_window(nb)
        return nb

    def seal_batch(self) -> Optional[BatchProof]:
        if not self.pending or self._sealing:
            # re-entrancy guard: a handler that submits back into the
            # rollup during _execute must not trigger a nested seal against
            # a half-executed state; the queued txs seal on the next
            # seal_batch/flush instead
            return None
        self._sealing = True
        try:
            txs, self.pending = self.pending[: self.batch_size], \
                self.pending[self.batch_size:]
            pre_root = state_digest(self.state)
            self.state = self._execute(self.state, txs)
            if self._state_handlers:
                # SoA state handlers run at seal time, outside the pure
                # replay function (1-row views, the vector faces' code)
                for tx in txs:
                    self._apply_state_tx(tx)
            post_root = state_digest(self.state)
            tx_root = hashlib.sha256(
                "".join(t.tx_id for t in txs).encode()).hexdigest()[:32]
            proof = BatchProof(len(self.batches), len(txs), pre_root,
                               post_root, tx_root,
                               word_digest=self._word_digest(txs))
            self.batches.append(proof)
            for t in txs:
                self.tx_batch[t.tx_id] = proof.batch_id
            row = self._settle(proof, txs)
            # one proof job per sealed batch (core/prover.py)
            self.prover.enqueue(self, proof.batch_id, [proof.word_digest],
                                [proof.n_txs], [self._last_time], [row])
            self.events.emit(BatchSealed, time=self._last_time,
                             shard=self._event_shard,
                             first_batch=proof.batch_id, n_batches=1,
                             n_txs=proof.n_txs, digest=proof.word_digest)
            self._emit("batch_sealed", {
                "first_batch": proof.batch_id, "n_batches": 1,
                "n_txs": proof.n_txs, "digest": proof.word_digest})
        finally:
            self._sealing = False
        return proof

    def _word_digest(self, txs: List[Tx]) -> int:
        """The xor-mix fold of the batch's merged tx-word buffer (4 words
        a tx), on the rollup's device: one ``rollup_digest`` launch on the
        card."""
        from repro_torch.core.engine import TxArrays, update_digest_of
        from repro_torch.kernels.rollup_digest import MASK
        words = TxArrays.from_txs(txs, device=self.device).word_buffer()
        return int(update_digest_of(words)) & MASK

    def flush(self):
        if self._sealing:
            # re-entrant flush from a handler: the outer seal/flush drains
            # pending and settles the session; settling here would split
            # the session in two (double verify/execute)
            return
        self.seal()
        self.settle_session()
        self.prover.drain(self)

    # -- L1 settlement: commit per batch; verify + execute once per aggregate
    def _settle(self, proof: BatchProof, txs: List[Tx]) -> Dict[str, Any]:
        by_fn: Dict[str, int] = {}
        for t in txs:
            by_fn[t.fn] = by_fn.get(t.fn, 0) + 1
        commit = sum(
            self.gas_table.commit_base.get(fn, 37000)
            + n * self.gas_table.commit_per_call.get(fn, 500)
            for fn, n in by_fn.items())
        now = max((t.submit_time for t in txs), default=0.0)
        commit_tx = Tx("rollup_commit", "sequencer",
                       {"batch": proof.batch_id,
                        "root": proof.post_root}, commit, now)
        self.l1.submit(commit_tx)
        self.batch_commit_ref[proof.batch_id] = commit_tx
        row = {"batch": proof.batch_id, "n_txs": proof.n_txs,
               "commit": commit, "verify": 0, "execute": 0,
               "total": commit}
        self.gas_log.append(row)
        self._last_time = now
        return row

    def _post_settlement(self, verify: int, execute: int, at: float,
                         n_batches: int):
        """Prover callback: post one verify + execute pair to the L1."""
        refs = []
        for phase, gas in (("verify", verify), ("execute", execute)):
            settle_tx = Tx(f"rollup_{phase}", "sequencer",
                           {"batches": n_batches}, gas, at)
            self.l1.submit(settle_tx)
            refs.append(settle_tx)
        return tuple(refs)

    # -- metrics ---------------------------------------------------------------
    def throughput(self, l1_tps: float) -> float:
        """Paper's method: L2 TPS = batch_size x L1 TPS."""
        return self.batch_size * l1_tps

    def latency(self, n_calls: int) -> float:
        """Table-II latency model (prover.session_latency, the formula the
        vector face uses too)."""
        return session_latency(n_calls, batch_size=self.batch_size,
                               prove_time=self.prove_time,
                               per_tx_time=self.per_tx_time,
                               capacity=self.prover.capacity)
