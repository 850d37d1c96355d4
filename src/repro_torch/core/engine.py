"""Vectorized L1/L2 transaction engine on tensors (the rollup node path).

The port of ``src/repro/core/engine.py``: the same discrete-event
semantics, with the mempool, the sealed batches and the account state held
as tensors on the stack's device.

  * ``VectorChain`` packs gas-limited FIFO blocks with the head-of-line
    rule: a block takes the longest mempool prefix whose running-max
    submit time is <= now, cut to the longest prefix of that whose gas
    fits the block limit.  Two ``searchsorted`` calls on the device answer
    both; one copy of the result to the host per block is the only sync.
    This stepped ``produce_block`` is the reference semantics; the fused
    window loop (core/fused.py) packs a whole run's blocks in one
    ``block_pack`` launch instead.
  * ``VectorRollup`` stripes transactions round-robin over ``n_lanes``
    lanes, cuts FIFO batches of ``batch_size`` and seals them in one
    vectorized pass: commit gas, per-batch L1 commit time, per-batch roots
    (kernel ``batch_seal``) and the merged update digest (kernel
    ``rollup_digest``).  The small per-batch vectors come to the host once
    per seal, to build the gas-log rows and feed the prover pipeline.

Every integer output (gas log, blocks, digests, events, state roots) is
bit-identical to the JAX package's on the same inputs.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.events import BatchSealed, BlockPacked, EventLog
from repro_torch.core.gas import (DEFAULT_GAS, ROLLUP_BATCH, GasTable,
                                  commit_gas_vectors)
from repro_torch.core.ledger import EventHooks
from repro_torch.core.prover import (ProverFace, ProverPipeline,
                                     session_latency)
from repro_torch.core.state import (MIX_SEED, Registry, StateArrays,
                                    kernel_impl)
from repro_torch.device import resolve_device
from repro_torch.kernels.factory import get_kernel
from repro_torch.kernels.rollup_digest import (MASK, rollup_digest_torch,
                                               to_i32)

DIGEST_SEED = int(MIX_SEED)


def xor_fold_digest(words: torch.Tensor) -> int:
    """The plain fold of a whole word buffer, as a Python int (the seed
    for an empty buffer)."""
    return int(rollup_digest_torch(words)) & MASK


def xor_fold_digest_segments(words: torch.Tensor, starts: torch.Tensor,
                             backend: str = "auto") -> torch.Tensor:
    """Segmented fold: one digest per ``[starts[i], starts[i+1])`` word
    range (int32 bits), through the kernel factory (op ``batch_seal``)."""
    return get_kernel("batch_seal", kernel_impl(backend))(words, starts)


def update_digest_of(words: torch.Tensor,
                     backend: str = "auto") -> torch.Tensor:
    """The merged-buffer digest (0-d int32 bits) through the kernel
    factory (op ``rollup_digest``)."""
    return get_kernel("rollup_digest", kernel_impl(backend))(words)


class FnRegistry(Registry):
    """Stable fn-name <-> integer-id mapping shared across SoA batches."""


@dataclasses.dataclass
class TxArrays:
    """Structure-of-arrays transaction batch, on one device."""

    submit_time: torch.Tensor        # float64 (N,)
    gas: torch.Tensor                # int64   (N,)
    fn_id: torch.Tensor              # int32   (N,)
    sender_id: torch.Tensor          # int32   (N,)
    fns: FnRegistry

    def __post_init__(self):
        dev = self.submit_time.device
        self.submit_time = self.submit_time.to(dev, torch.float64)
        self.gas = self.gas.to(dev, torch.int64)
        self.fn_id = self.fn_id.to(dev, torch.int32)
        self.sender_id = self.sender_id.to(dev, torch.int32)

    def __len__(self) -> int:
        return self.submit_time.shape[0]

    @property
    def device(self) -> torch.device:
        return self.submit_time.device

    def to(self, device) -> "TxArrays":
        return TxArrays(self.submit_time.to(device), self.gas.to(device),
                        self.fn_id.to(device), self.sender_id.to(device),
                        self.fns)

    def select(self, index) -> "TxArrays":
        """The rows picked by ``index`` (a slice, mask or index tensor)."""
        return TxArrays(self.submit_time[index], self.gas[index],
                        self.fn_id[index], self.sender_id[index], self.fns)

    @classmethod
    def from_numpy(cls, submit_time, gas, fn_id, sender_id,
                   fns: FnRegistry, device=None) -> "TxArrays":
        """Batch from host arrays, placed on ``device`` (the card unless
        named)."""
        dev = resolve_device(device)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
        return cls(put(submit_time, np.float64), put(gas, np.int64),
                   put(fn_id, np.int32), put(sender_id, np.int32), fns)

    @classmethod
    def homogeneous(cls, fn: str, times, gas: int, n_senders: int = 64,
                    fns: Optional[FnRegistry] = None,
                    device=None) -> "TxArrays":
        """One function type at fixed per-call gas (the Fig. 4 workload),
        senders round-robin over ``n_senders``, on ``device`` (the card
        unless named)."""
        fns = fns or FnRegistry()
        n = len(times)
        return cls.from_numpy(times, np.full(n, gas, np.int64),
                              np.full(n, fns.id(fn), np.int32),
                              np.arange(n) % max(1, n_senders), fns, device)

    @classmethod
    def from_txs(cls, txs: Sequence[Any], fns: Optional[FnRegistry] = None,
                 device=None) -> "TxArrays":
        """Compatibility shim: lift object ``Tx`` lists into SoA form."""
        fns = fns or FnRegistry()
        senders: Dict[str, int] = {}
        sid = [senders.setdefault(t.sender, len(senders)) for t in txs]
        return cls.from_numpy([t.submit_time for t in txs],
                              [t.gas for t in txs],
                              [fns.id(t.fn) for t in txs], sid, fns, device)

    def word_buffer(self) -> torch.Tensor:
        """Interleaved u32 words (time bits, gas, fn, sender) for digests,
        as int32 bits.  The time word is the float32 rounding (to nearest
        even, as numpy rounds) of the float64 submit time."""
        return torch.stack([
            self.submit_time.to(torch.float32).view(torch.int32),
            to_i32(self.gas), self.fn_id, self.sender_id], dim=1).reshape(-1)


@dataclasses.dataclass
class BlockStats:
    """Vector-engine block record (counts + gas, not per-tx objects)."""
    height: int
    time: float
    n_txs: int
    gas_used: int
    start: int                 # [start, stop) tx index range in arrival order
    stop: int
    parent: str = ""
    block_hash: str = ""

    def __post_init__(self):
        if not self.block_hash:
            h = hashlib.sha256(
                (self.parent + ":" + str(self.height) + ":" +
                 str(self.start) + ":" + str(self.stop) + ":" +
                 str(self.gas_used)).encode()).hexdigest()
            self.block_hash = h[:16]


def _remap(batch: TxArrays, fns: FnRegistry, device) -> TxArrays:
    """``batch`` on ``device`` with fn ids in the registry ``fns``."""
    if batch.device != device:
        batch = batch.to(device)
    if batch.fns is fns:
        return batch
    remap = torch.tensor([fns.id(n) for n in batch.fns.names],
                         dtype=torch.int32, device=device)
    fn_id = remap[batch.fn_id.long()] if len(batch) else batch.fn_id
    return TxArrays(batch.submit_time, batch.gas, fn_id, batch.sender_id,
                    fns)


class VectorChain(EventHooks):
    """Vectorized L1: QBFT quorum, gas-limited FIFO block packing over
    device tensors, O(log n) device work and one host sync per block."""

    EVENTS = ("block_packed",)

    # SoA is this face's native path (the client dispatches on it)
    soa_native = True
    # the SoA L1 can run under the core/fused.py plan-then-execute loop
    fused_capable = True

    def __init__(self, n_validators: int = 4, block_time: float = 1.0,
                 block_gas_limit: int = 9_000_000,
                 gas_table: GasTable = DEFAULT_GAS,
                 fns: Optional[FnRegistry] = None, device=None):
        if n_validators < 4:
            raise ValueError("QBFT needs >= 3f+1 validators with f >= 1")
        self.device = resolve_device(device)
        self.n_validators = n_validators
        self.block_time = block_time
        self.block_gas_limit = block_gas_limit
        self.gas_table = gas_table
        self.fns = fns or FnRegistry()
        self.blocks: List[BlockStats] = [BlockStats(0, 0.0, 0, 0, 0, 0,
                                                    "genesis")]
        self.state: Dict[str, Any] = {}
        self.total_gas = 0
        self._batch_handlers: Dict[int, Callable] = {}
        self.state_arrays = None
        self._state_handlers: Dict[int, Callable] = {}
        self._sender_ids: Dict[str, int] = {}    # submit(tx) shim namespace
        # consolidated mempool tensors (arrival order, never reordered),
        # grown geometrically; the running max / cumsum extend over each
        # new tail only, so consolidation is amortized O(new txs)
        self._n = 0                              # filled prefix of buffers
        dev = self.device
        self._t = torch.empty(0, dtype=torch.float64, device=dev)
        self._g = torch.empty(0, dtype=torch.int64, device=dev)
        self._f = torch.empty(0, dtype=torch.int32, device=dev)
        self._s = torch.empty(0, dtype=torch.int32, device=dev)
        self._confirm = torch.empty(0, dtype=torch.float64, device=dev)
        self._tmax = torch.empty(0, dtype=torch.float64, device=dev)
        self._gcum = torch.empty(0, dtype=torch.int64, device=dev)
        self._ptr = 0                            # first unconfirmed index
        self._staged: List[TxArrays] = []
        self._staged_n = 0
        self._block_stops: List[int] = []        # block_of lookup cache
        # the stack-wide typed event stream (L1-owned; L2 faces adopt it)
        self.events = EventLog()
        self._init_events()

    # -- contract surface ------------------------------------------------------
    def register_batch(self, fn: str, handler: Callable):
        """Batched handler: handler(state, n_calls, tx_slice: TxArrays).
        Called once per (block, fn) instead of once per tx."""
        self._batch_handlers[self.fns.id(fn)] = handler

    def register_state(self, fn: str, handler: Callable):
        """StateArrays handler: handler(state_arrays, view) with ``view``
        holding only ``fn``'s confirmed txs, block order."""
        if self.state_arrays is None:
            self.state_arrays = StateArrays(device=self.device)
            self.state_arrays.enable_dirty_tracking()
        self._state_handlers[self.fns.id(fn)] = handler

    def state_root(self) -> str:
        return self.state_arrays.root() if self.state_arrays is not None \
            else ""

    def submit_arrays(self, batch: TxArrays):
        """Stage a SoA batch; returns the ``[lo, hi)`` global arrival-index
        range assigned to it (stable across consolidation; what
        ``block_of`` and receipts resolve)."""
        batch = _remap(batch, self.fns, self.device)
        lo = self._n + self._staged_n
        self._staged.append(batch)
        self._staged_n += len(batch)
        return lo, lo + len(batch)

    def sender_id(self, sender: str) -> int:
        """Stable sender-name -> id mapping for the object-Tx shim."""
        return self._sender_ids.setdefault(sender, len(self._sender_ids))

    def submit(self, tx):
        """Object-Tx compatibility shim (small-N debugging)."""
        batch = TxArrays.from_txs([tx], self.fns, self.device)
        batch.sender_id.fill_(self.sender_id(tx.sender))
        return self.submit_arrays(batch)

    # -- provenance (receipts) -------------------------------------------------
    def block_of(self, tx_index: int) -> Optional[BlockStats]:
        """The block that confirmed arrival index ``tx_index`` (None while
        unconfirmed).  O(log blocks) on the host."""
        if tx_index >= self._ptr:
            return None
        if len(self._block_stops) != len(self.blocks):
            self._block_stops = [b.stop for b in self.blocks]
        blk = self.blocks[bisect.bisect_right(self._block_stops, tx_index)]
        if not blk.start <= tx_index < blk.stop:
            raise RuntimeError(f"block index out of step at tx {tx_index}")
        return blk

    def confirm_time_of(self, tx_index: int) -> Optional[float]:
        """A confirmed tx's confirm time: its block's time (the value the
        block wrote into the device confirm buffer)."""
        blk = self.block_of(tx_index)
        return None if blk is None else blk.time

    def quorum(self, approvals: int) -> bool:
        return 3 * approvals >= 2 * self.n_validators

    def _grow(self, need: int):
        cap = self._t.shape[0]
        if self._n + need <= cap:
            return
        new_cap = max(1024, self._n + need, 2 * cap)

        def grow(a):
            out = torch.empty(new_cap, dtype=a.dtype, device=self.device)
            out[: self._n] = a[: self._n]
            return out
        self._t, self._g = grow(self._t), grow(self._g)
        self._f, self._s = grow(self._f), grow(self._s)
        self._confirm = grow(self._confirm)
        self._tmax, self._gcum = grow(self._tmax), grow(self._gcum)

    def _consolidate(self):
        if not self._staged:
            return
        new, m = self._staged, self._staged_n
        self._staged, self._staged_n = [], 0
        self._grow(m)
        lo, hi = self._n, self._n + m
        for name, field in (("_t", "submit_time"), ("_g", "gas"),
                            ("_f", "fn_id"), ("_s", "sender_id")):
            parts = [getattr(b, field) for b in new]
            getattr(self, name)[lo:hi] = (parts[0] if len(parts) == 1
                                          else torch.cat(parts))
        self._confirm[lo:hi] = float("nan")
        # extend the running max (head-of-line eligibility) and the gas
        # cumsum (packing) over the new tail only
        tmax = torch.cummax(self._t[lo:hi], dim=0).values
        gcum = torch.cumsum(self._g[lo:hi], dim=0)
        if lo:
            tmax = torch.maximum(tmax, self._tmax[lo - 1])
            gcum += self._gcum[lo - 1]
        self._tmax[lo:hi] = tmax
        self._gcum[lo:hi] = gcum
        self._n = hi

    # -- block production ------------------------------------------------------
    def _pack(self, now: float):
        """(stop, gas_used) of the block packed at ``now``.

        The gas cumsum is nondecreasing, so the txs of ``[ptr, hi)`` whose
        cumsum fits ``base + limit`` are ``[ptr, min(max(j, ptr), hi))``
        with ``j`` one search over the whole cumsum: both searches and the
        gas sum run on the device and come back in one copy."""
        ptr, n = self._ptr, self._n
        if n == ptr:
            return ptr, 0
        dev = self.device
        tmax, gcum = self._tmax[:n], self._gcum[:n]
        hi = torch.searchsorted(
            tmax, torch.tensor([now], dtype=torch.float64, device=dev),
            right=True).clamp_(min=ptr)
        base = (gcum[ptr - 1:ptr] if ptr > 0 else
                torch.zeros(1, dtype=torch.int64, device=dev))
        j = torch.searchsorted(gcum, base + self.block_gas_limit,
                               right=True)
        stop = torch.minimum(j.clamp(min=ptr), hi)
        gas = torch.where(stop > ptr, gcum[(stop - 1).clamp(min=0)] - base,
                          torch.zeros_like(base))
        stop, gas_used = torch.cat([stop, gas]).tolist()
        return stop, gas_used

    def produce_block(self, now: float) -> BlockStats:
        """Pack the next block at time ``now`` (FIFO head-of-line rule: a
        future-timestamped head tx, or one whose gas alone exceeds the
        block limit, stalls the queue behind it)."""
        self._consolidate()
        ptr = self._ptr
        stop, gas_used = self._pack(now)
        if stop > ptr:
            self._confirm[ptr:stop] = now
            if self._batch_handlers or self._state_handlers:
                self._run_handlers(ptr, stop)
        blk = BlockStats(len(self.blocks), now, stop - ptr, gas_used,
                         ptr, stop, self.blocks[-1].block_hash)
        self.blocks.append(blk)
        self.total_gas += gas_used
        self._ptr = stop
        self.events.emit(BlockPacked, time=now, height=blk.height,
                         n_txs=blk.n_txs, gas_used=gas_used,
                         block_hash=blk.block_hash)
        self._emit("block_packed", {"height": blk.height, "n_txs": blk.n_txs,
                                    "gas_used": gas_used,
                                    "block_hash": blk.block_hash})
        return blk

    def _run_handlers(self, ptr: int, stop: int):
        view = TxArrays(self._t[ptr:stop], self._g[ptr:stop],
                        self._f[ptr:stop], self._s[ptr:stop], self.fns)
        counts = torch.bincount(view.fn_id.long(),
                                minlength=len(self.fns)).tolist()
        for fid, h in self._batch_handlers.items():
            if fid < len(counts) and counts[fid]:
                h(self.state, counts[fid], view)
        for fid, h in self._state_handlers.items():
            if fid < len(counts) and counts[fid]:
                h(self.state_arrays, view.select(view.fn_id == fid))

    def run_until(self, t_end: float):
        t = self.blocks[-1].time
        while t < t_end:
            t += self.block_time
            self.produce_block(t)

    # -- metrics ---------------------------------------------------------------
    @property
    def n_confirmed(self) -> int:
        return self._ptr

    @property
    def n_submitted(self) -> int:
        return self._n + self._staged_n

    def confirm_times(self) -> torch.Tensor:
        return self._confirm[: self._ptr]

    def load_metrics(self, send_rate: float,
                     duration: float) -> Dict[str, float]:
        """Fig. 4 metrics.  The latency is numpy's mean on the host over
        one copy of the confirmed txs' latencies, so it equals the object
        Chain's and the JAX package's bit for bit."""
        n_conf = self._ptr
        if n_conf == 0:
            return {"send_rate": send_rate, "throughput": 0.0, "latency": 0.0,
                    "confirmed": 0, "submitted": self.n_submitted}
        lat = float(np.mean((self._confirm[:n_conf]
                             - self._t[:n_conf]).cpu().numpy()))
        return {"send_rate": send_rate,
                "throughput": n_conf / duration,
                "latency": lat,
                "confirmed": n_conf,
                "submitted": self.n_submitted}


class VectorRollup(ProverFace, EventHooks):
    """Vectorized zk-rollup with a multi-lane sequencer.

    Transactions stripe round-robin across ``n_lanes`` lanes; each lane
    cuts FIFO batches of ``batch_size`` which all seal together (commit
    gas and per-batch roots in one vectorized pass); the prover pipeline
    (core/prover.py) settles them.
    """

    soa_native = True
    fused_capable = True

    def __init__(self, l1, batch_size: int = ROLLUP_BATCH,
                 gas_table: GasTable = DEFAULT_GAS,
                 prove_time: float = 0.9, per_tx_time: float = 0.14,
                 n_lanes: int = 1, digest_backend: str = "auto",
                 agg_width: int = 1, prover_capacity: int = 1,
                 finalize: str = "eager",
                 prover: Optional[ProverPipeline] = None):
        if n_lanes < 1:
            raise ValueError("n_lanes must be >= 1")
        kernel_impl(digest_backend)              # validates the name
        self.l1 = l1
        self.device = l1.device
        self.batch_size = batch_size
        self.gas_table = gas_table
        self.prove_time = prove_time
        self.per_tx_time = per_tx_time
        self.n_lanes = n_lanes
        self.digest_backend = digest_backend
        self._init_prover_face(l1, gas_table, prove_time, agg_width,
                               prover_capacity, finalize, prover)
        # share the L1's registry when it has one (`or` would discard an
        # empty-but-present registry: FnRegistry defines __len__)
        l1_fns = getattr(l1, "fns", None)
        self.fns: FnRegistry = l1_fns if l1_fns is not None else FnRegistry()
        self._sender_ids: Dict[str, int] = {}
        self.gas_log: List[Dict[str, Any]] = []
        # StateArrays handlers applied at seal time over the sealed txs in
        # ARRIVAL order (before the lane sort), fn-filtered
        self.state_arrays = None
        self._state_handlers: Dict[int, Callable] = {}
        self.batch_digests: List[int] = []      # per-batch tx xor-roots
        self.update_digest: int = DIGEST_SEED   # merged-buffer digest
        self.n_batches = 0
        self._pending: List[TxArrays] = []
        self._pending_n = 0
        self._last_time = 0.0
        # tx->batch provenance: submission order IS seal order, so the
        # seq->batch map extends chunk-wise at each seal (host arrays)
        self._next_seq = 0
        self._sealed_seq = 0
        self._prov_starts: List[int] = []
        self._prov_batches: List[np.ndarray] = []
        # per-batch L1 settlement refs: the commit tx's and the (verify,
        # execute) txs' arrival indices on the L1
        self.batch_commit_ref: Dict[int, Any] = {}
        self.batch_settle_ref: Dict[int, Any] = {}
        self._init_events()

    # -- sequencing ------------------------------------------------------------
    def submit_arrays(self, batch: TxArrays):
        """Queue a SoA batch; returns the ``[lo, hi)`` sequence-number
        range assigned to it (this rollup's provenance namespace)."""
        batch = _remap(batch, self.fns, self.device)
        lo = self._next_seq
        self._pending.append(batch)
        self._pending_n += len(batch)
        self._next_seq += len(batch)
        return lo, lo + len(batch)

    def sender_id(self, sender: str) -> int:
        """Stable sender-name -> id mapping for this rollup's SoA stream."""
        return self._sender_ids.setdefault(sender, len(self._sender_ids))

    def register_state(self, fn: str, handler: Callable):
        """StateArrays handler: handler(state_arrays, view) with ``view``
        holding only ``fn``'s sealed txs, arrival order."""
        if self.state_arrays is None:
            self.state_arrays = StateArrays(device=self.device)
            self.state_arrays.enable_dirty_tracking()
        self._state_handlers[self.fns.id(fn)] = handler

    def state_root(self) -> str:
        return self.state_arrays.root() if self.state_arrays is not None \
            else ""

    def _apply_state(self, txs: TxArrays):
        present = torch.bincount(txs.fn_id.long(),
                                 minlength=len(self.fns)).tolist()
        for fid, h in self._state_handlers.items():
            if fid < len(present) and present[fid]:
                h(self.state_arrays, txs.select(txs.fn_id == fid))

    def submit(self, tx):
        """Object-Tx compatibility shim."""
        batch = TxArrays.from_txs([tx], self.fns, self.device)
        batch.sender_id.fill_(self.sender_id(tx.sender))
        return self.submit_arrays(batch)

    def batch_of_seq(self, seq: int) -> Optional[int]:
        """Global batch id that sealed sequence number ``seq`` (None while
        still pending).  Chunk-indexed: one bisect over seal chunks."""
        if seq >= self._sealed_seq or seq < 0:
            return None
        c = bisect.bisect_right(self._prov_starts, seq) - 1
        return int(self._prov_batches[c][seq - self._prov_starts[c]])

    def _commit_gas_vectors(self):
        """(commit_base, commit_per_call) int64 tensors on the device,
        indexable by fn id."""
        return tuple(torch.from_numpy(v).to(self.device) for v in
                     commit_gas_vectors(self.fns.names, self.gas_table))

    def seal(self) -> int:
        """Seal every pending tx into lane batches; returns #batches sealed.

        One vectorized device pass computes, for all batches at once: the
        per-batch (fn -> count) histograms (commit gas), the per-batch max
        submit time (the L1 commit timestamp), the per-batch roots and the
        merged update digest.  Sealed batches enqueue proof jobs on the
        prover pipeline, which settles them (core/prover.py)."""
        if not self._pending:
            self._emit_window(0)
            return 0
        parts = self._pending
        txs = parts[0] if len(parts) == 1 else TxArrays(
            *(torch.cat([getattr(b, f) for b in parts])
              for f in ("submit_time", "gas", "fn_id", "sender_id")),
            self.fns)
        self._pending, self._pending_n = [], 0
        if self._state_handlers:
            # execute against the SoA account state in arrival order —
            # the lane layout must not change the committed state
            self._apply_state(txs)
        n, dev = len(txs), self.device
        idx = torch.arange(n, device=dev)
        lane = idx % self.n_lanes
        pos = idx // self.n_lanes                 # FIFO position within lane
        batch_in_lane = pos // self.batch_size
        # order (lane-major, FIFO within lane) so batches are contiguous;
        # the keys are distinct, so any sort gives numpy's lexsort order
        order = torch.argsort(lane * ((n - 1) // self.n_lanes + 1) + pos)
        lane_o, bil_o = lane[order], batch_in_lane[order]
        seg_new = torch.ones(n, dtype=torch.bool, device=dev)
        seg_new[1:] = (lane_o[1:] != lane_o[:-1]) | (bil_o[1:] != bil_o[:-1])
        batch_id = torch.cumsum(seg_new, dim=0) - 1
        starts = torch.nonzero(seg_new).reshape(-1)
        nb = starts.numel()

        fn_o = txs.fn_id[order]
        t_o = txs.submit_time[order]
        n_fns = len(self.fns)
        counts = torch.bincount(batch_id * n_fns + fn_o.long(),
                                minlength=nb * n_fns).reshape(nb, n_fns)
        base, percall = self._commit_gas_vectors()
        # CUDA has no int64 matmul: multiply and sum instead
        commit = ((counts > 0).long() * base).sum(1) + (counts * percall).sum(1)
        n_txs = counts.sum(1)
        now = torch.full((nb,), float("-inf"), dtype=torch.float64,
                         device=dev).scatter_reduce(0, batch_id, t_o, "amax")
        # per-batch xor-roots over the interleaved word buffer, and the
        # merged update-buffer digest, through the kernel factory
        words = TxArrays(t_o, txs.gas[order], fn_o, txs.sender_id[order],
                         self.fns).word_buffer()
        roots = xor_fold_digest_segments(words, starts * 4,
                                         self.digest_backend)
        update = update_digest_of(words, self.digest_backend)
        # L1 commits: one tx per batch.  Lanes can finish out of global
        # time order; post commits time-sorted (stable) so the L1's FIFO
        # head-of-line rule never stalls on a later lane's commit
        post = torch.sort(now, stable=True).indices
        inv_post = torch.empty_like(post)
        inv_post[post] = torch.arange(nb, device=dev)
        arrival_batch = torch.empty_like(batch_id)
        arrival_batch[order] = batch_id
        commit_batch = TxArrays(
            now[post], commit[post],
            torch.full((nb,), self.fns.id("rollup_commit"), dtype=torch.int32,
                       device=dev),
            torch.zeros(nb, dtype=torch.int32, device=dev), self.fns)
        refs = self._l1_submit(commit_batch)
        # the per-batch vectors and the tx->batch map reach the host in one
        # copy (the float64 commit times ride as their int64 bits)
        host = torch.cat([roots.long() & MASK, commit, n_txs, lane_o[starts],
                          inv_post, now.view(torch.int64),
                          (update.long() & MASK).reshape(1),
                          arrival_batch]).cpu().numpy()
        roots_h, commit_h, n_txs_h, lane_h, inv_h, now_bits = \
            host[: 6 * nb].reshape(6, nb)
        now_h = now_bits.view(np.float64)
        self.update_digest = int(host[6 * nb])
        first = self.n_batches
        self.batch_digests.extend(roots_h.tolist())

        self._prov_starts.append(self._sealed_seq)
        self._prov_batches.append(host[6 * nb + 1:] + first)
        self._sealed_seq += n

        rows = []
        for j, (ln, k, c, p) in enumerate(zip(
                lane_h.tolist(), n_txs_h.tolist(), commit_h.tolist(),
                inv_h.tolist())):
            self.batch_commit_ref[first + j] = refs[p]
            rows.append({"batch": first + j, "lane": ln, "n_txs": k,
                         "commit": c, "verify": 0, "execute": 0,
                         "total": c})
        self.gas_log.extend(rows)
        self.n_batches += nb
        self._last_time = float(now_h.max())
        self.prover.enqueue(self, first, roots_h, n_txs_h, now_h, rows)
        self.events.emit(BatchSealed, time=self._last_time,
                         shard=self._event_shard, first_batch=first,
                         n_batches=nb, n_txs=n, digest=self.update_digest)
        self._emit("batch_sealed", {
            "first_batch": first, "n_batches": nb, "n_txs": n,
            "digest": self.update_digest})
        self._emit_window(nb)
        return nb

    def _l1_submit(self, batch: TxArrays) -> List[Any]:
        """Submit to the L1; returns one settlement ref per tx: the L1
        arrival index on a VectorChain, the submitted Tx on an object
        Chain (both resolve to a block through the NodeClient)."""
        if getattr(self.l1, "soa_native", False):
            lo, hi = self.l1.submit_arrays(batch)
            return list(range(lo, hi))
        from repro_torch.core.ledger import Tx                # object Chain
        names = batch.fns.names
        txs = [Tx(names[f], "sequencer", {}, g, t)
               for f, g, t in zip(batch.fn_id.tolist(), batch.gas.tolist(),
                                  batch.submit_time.tolist())]
        for tx in txs:
            self.l1.submit(tx)
        return txs

    # -- settlement (routed through the shared prover pipeline) -----------------
    def flush(self):
        self.seal()
        self.settle_session()
        self.prover.drain(self)

    def _post_settlement(self, verify: int, execute: int, at: float,
                         n_batches: int):
        """Prover callback: post one verify + execute pair to the L1."""
        dev = self.device
        settle = TxArrays(
            torch.full((2,), float(at), dtype=torch.float64, device=dev),
            torch.tensor([verify, execute], dtype=torch.int64, device=dev),
            torch.tensor([self.fns.id("rollup_verify"),
                          self.fns.id("rollup_execute")], dtype=torch.int32,
                         device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev), self.fns)
        return tuple(self._l1_submit(settle))

    # -- metrics ---------------------------------------------------------------
    def throughput(self, l1_tps: float) -> float:
        """Paper's method, scaled by concurrent lanes."""
        return self.n_lanes * self.batch_size * l1_tps

    def latency(self, n_calls: int) -> float:
        """Table-II latency model (prover.session_latency)."""
        return session_latency(n_calls, batch_size=self.batch_size,
                               prove_time=self.prove_time,
                               per_tx_time=self.per_tx_time,
                               n_lanes=self.n_lanes,
                               capacity=self.prover.capacity)
