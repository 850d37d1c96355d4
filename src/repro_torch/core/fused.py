"""Fused window loop over the SoA ledger hot path: plan, then execute.

The stepped scheduler drives every window through four round trips to the
ledger: seal the lane batches, pump the prover, settle, and pack L1 blocks
one at a time (one host sync per block).  ``FusedWindowLoop`` is a
plan-then-execute driver for the same loop:

  * during the window loop, ledger calls append cheap plan entries (chain
    staging, seal, pump and settle points, block-production edges)
    instead of executing;
  * ``execute()`` replays the plan once:

      1. every seal point's batch structure, commit gas, timestamps and
         digests come from ONE pass over all windows on the device: the
         per-batch tx roots and the per-seal update digests are two
         segmented folds (kernel ``batch_seal``) for the whole run, and
         the per-batch vectors reach the host in one copy;
      2. the plan is walked in order, applying the precomputed seals,
         pumping the prover and staging L1 traffic exactly as the stepped
         path would, so event order, arrival indices, gas rows and
         state-handler order are identical;
      3. every deferred ``run_until`` edge becomes a row of one block grid,
         packed by ONE ``block_pack`` launch; gas used and confirm times
         are computed on the device, the stops and gas come to the host
         in one copy, and the ``BlockPacked`` events are spliced into the
         stream where the stepped path emitted them.

A fused run and a stepped run of the same schedule give identical event
streams, state roots, gas logs, blocks, confirm times and results
(tests/test_torch_fused.py).  The state handlers and the per-seal state
root (``WindowSettled`` carries it as a string) still read the device at
each seal point, as the stepped seal does.

Scope: ``VectorChain`` alone, ``VectorChain`` + ``VectorRollup``, or
``VectorChain`` + ``ShardedRollup``.  The fabric runs as K shard lanes:
routing decisions (the hash split, the least-loaded argmin, task pins) are
taken at record time against the live ``_submitted`` counters, each
lane's seal groups go through the same precompute, the K lanes' digest
folds are two ``shard_seal`` calls over a ``(K, W)`` word grid (kernel
``shard_seal``; its ``mesh`` impl where the fabric's ``mesh`` knob asks
for it), and every window closes through ``ShardedRollup._finish_window``
as a stepped seal does.  A plain ``VectorRollup`` is the one-lane case and
keeps its two ``batch_seal`` calls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (BlockStats, TxArrays, VectorChain,
                                     VectorRollup, _remap,
                                     xor_fold_digest_segments)
from repro_torch.core.events import BatchSealed, BlockPacked
from repro_torch.core.state import kernel_impl
from repro_torch.kernels.factory import get_kernel
from repro_torch.kernels.rollup_digest import MASK


def supports_fused(chain, rollup) -> bool:
    """True when the (chain, rollup) pair can run the fused loop: a SoA L1
    and, optionally, a SoA rollup face (a ``fused_capable`` class marker
    on each: ``VectorChain``, ``VectorRollup`` and ``ShardedRollup``; the
    object faces lack it)."""
    if not getattr(chain, "fused_capable", False):
        return False
    return rollup is None or getattr(rollup, "fused_capable", False)


@dataclasses.dataclass
class _SealPrep:
    """One seal point, fully precomputed (None -> an empty seal): applying
    it is bookkeeping only."""

    txs: TxArrays                # the seal's txs, arrival order (device)
    n_txs: np.ndarray            # per-batch tx counts
    now: np.ndarray              # per-batch max submit time (float64)
    roots: np.ndarray            # per-batch tx xor-roots (u32 in int64)
    update_digest: int           # the seal's merged-buffer digest
    arrival_batch: np.ndarray    # per-tx global batch id (arrival order)
    first: int                   # global id of the seal's first batch
    rows: List[Dict[str, Any]]   # the seal's gas_log rows
    commit_batch: TxArrays       # time-sorted L1 commit txs (device)
    inv_post: np.ndarray         # batch j -> its commit's index in post


class FusedWindowLoop:
    """Plan-then-execute driver for one stepped window loop.

    Record phase: ``submit`` / ``seal`` / ``pump`` / ``run_until`` /
    ``flush`` (and ``sync_state`` for the node's end-of-window account
    scatter).  Rollup-bound batches are journaled with their sequence
    numbers assigned at once (receipts hold ``[lo, hi)`` before
    ``execute``, as on a live submit); chain-bound batches are journaled
    so their arrival indices interleave with the seal commits and
    settlement txs replayed later.  ``execute()`` runs the whole plan
    once; afterwards the ledger is indistinguishable from a stepped run.
    """

    def __init__(self, chain: VectorChain, rollup=None):
        if not supports_fused(chain, rollup):
            raise ValueError("the fused loop needs a VectorChain and, "
                             "optionally, a VectorRollup or a "
                             "ShardedRollup")
        self.chain = chain
        self.rollup = rollup
        # the sharded fabric runs as K shard lanes; a plain VectorRollup
        # is the one-lane case of the same machinery
        self.fabric = rollup if hasattr(rollup, "shards") else None
        self._lanes: List[VectorRollup] = (
            list(rollup.shards) if self.fabric is not None
            else ([rollup] if rollup is not None else []))
        self._plan: List[Tuple] = []
        # journaled staging a lane; anything already pending is adopted so
        # the first planned seal covers it, as a stepped seal would
        self._r_batches: List[List[TxArrays]] = [[] for _ in self._lanes]
        for k, lane in enumerate(self._lanes):
            if lane._pending:
                self._r_batches[k].extend(lane._pending)
                lane._pending, lane._pending_n = [], 0
        self._executed = False

    # -- record phase ----------------------------------------------------------
    def _stage(self, k: int, batch: TxArrays) -> Tuple[int, int]:
        """Journal one batch into lane ``k``, assigning its sequence range
        now (receipts hold ``[lo, hi)`` before ``execute``)."""
        lane = self._lanes[k]
        lo = lane._next_seq
        lane._next_seq += len(batch)
        self._r_batches[k].append(batch)
        return lo, lo + len(batch)

    def submit(self, target, batch: TxArrays, shard: Optional[int] = None):
        """Journal one SoA batch for ``target`` (the rollup or the chain).
        Fn names register in the target's registry NOW, in the stepped
        path's order.  Returns the rollup's ``[lo, hi)`` sequence range
        for a rollup batch, the per-tx ``(shard_of, seq_of)`` provenance
        on the fabric (routed now, as ``ShardedRollup.submit_arrays``
        would route it; ``shard`` pins the batch), None for a chain
        batch."""
        rollup = self.rollup
        if rollup is not None and target is rollup:
            batch = _remap(batch, rollup.fns, rollup.device)
            if self.fabric is None:
                return self._stage(0, batch)
            # the stepped routing decision, taken now; the parts journal
            # into the lanes instead of the shards' pending queues
            return self.fabric._route(batch, shard, self._stage)
        if target is not self.chain:
            raise ValueError("unknown fused submit target")
        self._plan.append(("tx", _remap(batch, self.chain.fns,
                                        self.chain.device)))
        return None

    def covers(self, target) -> bool:
        return target is self.chain or (self.rollup is not None
                                        and target is self.rollup)

    def _need_rollup(self, what: str) -> VectorRollup:
        if self.rollup is None:
            raise ValueError(f"{what} needs a rollup")
        return self.rollup

    def seal(self):
        """Plan a seal point at the current staging watermark of every
        lane."""
        # the stepped path registers the commit fn at its first seal: keep
        # the registry's id order identical
        self._need_rollup("seal").fns.id("rollup_commit")
        self._plan.append(("seal", tuple(len(rb) for rb in self._r_batches)))

    def pump(self, t_end: float):
        self._need_rollup("pump")
        self._plan.append(("pump", float(t_end)))

    def run_until(self, t_end: float):
        self._plan.append(("blocks", float(t_end)))

    def flush(self):
        """Plan the stepped ``rollup.flush()``: tail seal, session close,
        forced drain."""
        self.seal()
        self._plan.append(("settle",))

    def sync_state(self, state, ids: torch.Tensor, reputation: torch.Tensor,
                   balances: torch.Tensor, stake: torch.Tensor):
        """Plan the node's end-of-window account scatter so it lands
        between the seal points where the stepped path wrote it: the
        per-seal state roots depend on it.  The tensors are the values to
        write (the caller hands over copies it no longer changes)."""
        self._plan.append(("sync", state, ids, reputation, balances, stake))

    # -- execute: one pass over the plan ---------------------------------------
    def execute(self) -> None:
        if self._executed:
            raise RuntimeError("fused plan already executed")
        self._executed = True
        chain, rollup = self.chain, self.rollup
        preps = self._prepare_seals()
        chain_buf: List[TxArrays] = []

        def flush_chain():
            if not chain_buf:
                return
            chain.submit_arrays(chain_buf[0] if len(chain_buf) == 1 else
                                TxArrays(*(torch.cat([getattr(b, f)
                                                      for b in chain_buf])
                                           for f in ("submit_time", "gas",
                                                     "fn_id", "sender_id")),
                                         chain.fns))
            chain_buf.clear()

        times: List[float] = []
        n_vis: List[int] = []
        # (event position, first deferred block, #blocks) per blocks edge
        markers: List[Tuple[int, int, int]] = []
        cursor = chain.blocks[-1].time
        seal_i = 0
        for entry in self._plan:
            op = entry[0]
            if op == "tx":
                chain_buf.append(entry[1])
            elif op == "seal":
                flush_chain()
                if self.fabric is not None:
                    # lanes seal in shard order, then the fabric merges
                    # the window: the stepped ShardedRollup.seal()
                    self.fabric._finish_window(
                        [self._apply_seal(preps[k][seal_i], lane)
                         for k, lane in enumerate(self._lanes)])
                else:
                    self._apply_seal(preps[0][seal_i], rollup)
                seal_i += 1
            elif op == "pump":
                flush_chain()
                rollup.pump(entry[1])
            elif op == "settle":
                flush_chain()
                rollup.settle_session()
                # the fabric's drain is fabric-wide, as its flush()'s
                rollup.prover.drain(None if self.fabric is not None
                                    else rollup)
            elif op == "sync":
                _, state, ids, rep, bal, stake = entry
                state.ensure_ids(ids)
                state.reputation[ids] = rep
                state.balances[ids] = bal
                state.stake[ids] = stake
                state.mark_dirty(ids)
            elif op == "blocks":
                flush_chain()
                lo = len(times)
                while cursor < entry[1]:
                    cursor += chain.block_time
                    times.append(cursor)
                    n_vis.append(chain.n_submitted)
                if len(times) > lo:
                    markers.append((chain.events.next_cursor, lo,
                                    len(times) - lo))
            else:
                raise AssertionError(f"unknown plan op {op!r}")
        flush_chain()
        self._pack_blocks(times, n_vis, markers)

    # -- seal precompute + per-point application -------------------------------
    def _collect_groups(self, k: int) -> List[List[TxArrays]]:
        """Split lane ``k``'s journaled staging at the planned watermarks;
        batches past the last watermark go back to the lane's pending
        queue (what a stepped run would leave unsealed)."""
        groups, prev = [], 0
        for entry in self._plan:
            if entry[0] == "seal":
                groups.append(self._r_batches[k][prev:entry[1][k]])
                prev = entry[1][k]
        tail = self._r_batches[k][prev:]
        if tail:
            lane = self._lanes[k]
            lane._pending.extend(tail)
            lane._pending_n += sum(len(b) for b in tail)
        return groups

    def _prepare_seals(self) -> List[List[Optional[_SealPrep]]]:
        """Every seal point's batch structure, commit gas, timestamps,
        digests, gas rows and commit txs, a lane at a time (the stepped
        ``VectorRollup.seal`` math, all windows at once), with the digest
        folds of all lanes together.  Indexed ``[lane][seal point]``."""
        if self.rollup is None:
            return []
        groups = [self._collect_groups(k) for k in range(len(self._lanes))]
        structs = [self._lane_struct(lane, g)
                   for lane, g in zip(self._lanes, groups)]
        self._fold_digests(structs)
        return [self._lane_preps(lane, st, len(g))
                for lane, st, g in zip(self._lanes, structs, groups)]

    def _lane_struct(self, rollup: VectorRollup,
                     groups: List[List[TxArrays]]) -> Optional[Dict]:
        """Everything the stepped ``seal()`` derives for the seal groups
        but the digest folds.

        The batch layout depends only on the group sizes, so it is laid
        out on the host: within a group, tx ``i`` goes to lane ``i %
        n_lanes`` at FIFO position ``i // n_lanes``; the sorted order is
        group-major, lane-major, FIFO within a lane (the stepped seal's
        order), and batches are runs of ``batch_size`` within a lane.  The
        device scatters each tx to its sorted position and reduces the
        per-batch vectors."""
        sizes = [sum(len(b) for b in g) for g in groups]
        live = [i for i, s in enumerate(sizes) if s > 0]
        if not live:
            return None
        dev, n_lanes, bsz = rollup.device, rollup.n_lanes, rollup.batch_size
        cat = [b for i in live for b in groups[i]]
        t, g, f, s = (torch.cat([getattr(b, name) for b in cat])
                      for name in ("submit_time", "gas", "fn_id",
                                   "sender_id"))
        n = int(t.shape[0])
        gsz = np.array([sizes[i] for i in live], np.int64)
        gstart = np.concatenate([[0], np.cumsum(gsz)[:-1]])
        # per (group, lane): tx count and offset in the sorted order
        lane_n = np.maximum(0, (gsz[:, None] - np.arange(n_lanes)[None]
                                + n_lanes - 1) // n_lanes)
        lane_off = gstart[:, None] + np.cumsum(lane_n, axis=1) - lane_n
        starts, n_txs, lane_b, group_b = [], [], [], []
        for k in range(len(live)):
            for ln in range(n_lanes):
                c = int(lane_n[k, ln])
                at = np.arange(0, c, bsz)
                starts.append(lane_off[k, ln] + at)
                n_txs.append(np.minimum(bsz, c - at))
                lane_b.append(np.full(at.size, ln))
                group_b.append(np.full(at.size, k))
        starts, n_txs = np.concatenate(starts), np.concatenate(n_txs)
        lane_b, group_b = np.concatenate(lane_b), np.concatenate(group_b)
        nb = int(starts.size)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)
        gidx = torch.repeat_interleave(put(np.arange(len(live))), put(gsz),
                                       output_size=n)
        within = torch.arange(n, device=dev) - put(gstart)[gidx]
        dest = (put(lane_off.reshape(-1))[gidx * n_lanes + within % n_lanes]
                + within // n_lanes)              # arrival -> sorted slot
        order = torch.empty_like(dest)
        order[dest] = torch.arange(n, device=dev)  # sorted slot -> arrival
        batch_of = torch.repeat_interleave(
            torch.arange(nb, device=dev), put(n_txs), output_size=n)
        fn_o, t_o = f[order], t[order]
        n_fns = len(rollup.fns)
        counts = torch.bincount(batch_of * n_fns + fn_o.long(),
                                minlength=nb * n_fns).reshape(nb, n_fns)
        base, percall = rollup._commit_gas_vectors()
        # CUDA has no int64 matmul: multiply and sum instead
        commit = ((counts > 0).long() * base).sum(1) + (counts * percall
                                                        ).sum(1)
        now = torch.full((nb,), float("-inf"), dtype=torch.float64,
                         device=dev).scatter_reduce(0, batch_of, t_o, "amax")
        # each seal posts its commits time-sorted (stable): group-major,
        # then commit time, then batch order
        by_time = torch.sort(now, stable=True).indices
        post = by_time[torch.sort(put(group_b)[by_time], stable=True).indices]
        inv_post = torch.empty_like(post)
        inv_post[post] = torch.arange(nb, device=dev)
        return {"live": live, "t": t, "g": g, "f": f, "s": s, "gsz": gsz,
                "gstart": gstart, "nb": nb, "starts": starts,
                "n_txs": n_txs, "lane_b": lane_b, "group_b": group_b,
                "words": TxArrays(t_o, g[order], fn_o, s[order],
                                  rollup.fns).word_buffer(),
                "commit": commit, "now": now, "post": post,
                "inv_post": inv_post, "arrival_batch": batch_of[dest],
                "roots": None, "gdigest": None}

    def _fold_digests(self, structs: List[Optional[Dict]]) -> None:
        """Every lane's per-batch tx roots and per-seal update digests
        (each seal's txs are word-contiguous in the sorted order, so its
        merged-buffer digest is one segment of the same buffer).  One
        lane: two ``batch_seal`` folds over its buffer.  The fabric: the
        live lanes' buffers are the rows of one ``(K, W)`` word grid, and
        two ``shard_seal`` calls fold every lane's segments."""
        live = [st for st in structs if st is not None]
        if not live:
            return
        dev = live[0]["words"].device
        if self.fabric is None:
            st, backend = live[0], self.rollup.digest_backend
            for key, cut in (("roots", "starts"), ("gdigest", "gstart")):
                st[key] = xor_fold_digest_segments(
                    st["words"], torch.from_numpy(st[cut] * 4).to(dev),
                    backend)
            return
        fold = get_kernel("shard_seal", self._shard_seal_impl())
        words = torch.nn.utils.rnn.pad_sequence(
            [st["words"] for st in live], batch_first=True)
        n_words = np.array([st["words"].numel() for st in live], np.int64)
        for key, cut in (("roots", "starts"), ("gdigest", "gstart")):
            n_seg = np.array([st[cut].size for st in live], np.int64)
            # the starts grid (padded with each lane's word count), the
            # segment counts and the word counts in one copy
            host = np.repeat(n_words[:, None], int(n_seg.max()) + 2, 1)
            for i, st in enumerate(live):
                host[i, : n_seg[i]] = st[cut] * 4
            host[:, -2] = n_seg
            grid = torch.from_numpy(host).to(dev)
            out = fold(words, grid[:, :-2], grid[:, -2].contiguous(),
                       grid[:, -1].contiguous())
            for i, st in enumerate(live):
                st[key] = out[i, : n_seg[i]]

    def _shard_seal_impl(self) -> Optional[str]:
        """The fabric's ``mesh`` knob as a ``shard_seal`` impl: ``"on"``
        takes the mesh impl, ``"auto"`` takes it where more than one card
        is visible; otherwise the lanes' digest backend decides (``None``
        for ``"auto"``: the factory default and
        ``REPRO_TORCH_KERNEL_IMPL``)."""
        mode = self.fabric.mesh_mode
        if mode == "on":
            return "mesh"
        if mode == "auto":
            from repro_torch.launch.mesh import n_local_devices
            if n_local_devices() > 1:
                return "mesh"
        return kernel_impl(self._lanes[0].digest_backend)

    def _lane_preps(self, rollup: VectorRollup, st: Optional[Dict],
                    n_groups: int) -> List[Optional[_SealPrep]]:
        """Assemble the per-seal ``_SealPrep`` list; the per-batch vectors
        and the tx -> batch map reach the host in one copy (the float64
        commit times ride as their int64 bits)."""
        preps: List[Optional[_SealPrep]] = [None] * n_groups
        if st is None:
            return preps
        nb, n_live = st["nb"], len(st["live"])
        host = torch.cat([st["roots"].long() & MASK, st["commit"],
                          st["now"].view(torch.int64), st["inv_post"],
                          st["gdigest"].long() & MASK,
                          st["arrival_batch"]]).cpu().numpy()
        roots, commit, now_bits, inv_post = host[: 4 * nb].reshape(4, nb)
        now = now_bits.view(np.float64)
        gdigest = host[4 * nb: 4 * nb + n_live]
        first0 = rollup.n_batches
        arrival_batch = host[4 * nb + n_live:] + first0
        now_p, commit_p = st["now"][st["post"]], st["commit"][st["post"]]
        commit_fn = rollup.fns.id("rollup_commit")
        dev = rollup.device
        bstart = np.searchsorted(st["group_b"], np.arange(n_live))
        bstop = np.append(bstart[1:], nb)
        n_txs, lane_b = st["n_txs"], st["lane_b"]
        for k, i in enumerate(st["live"]):
            b0, b1 = int(bstart[k]), int(bstop[k])
            # seal k is one slice both in arrival order (the concat) and in
            # the sorted order
            lo, hi = int(st["gstart"][k]), int(st["gstart"][k] + st["gsz"][k])
            rows = [{"batch": first0 + j, "lane": ln, "n_txs": m,
                     "commit": c, "verify": 0, "execute": 0, "total": c}
                    for j, ln, m, c in zip(range(b0, b1),
                                           lane_b[b0:b1].tolist(),
                                           n_txs[b0:b1].tolist(),
                                           commit[b0:b1].tolist())]
            nb_g = b1 - b0
            preps[i] = _SealPrep(
                TxArrays(st["t"][lo:hi], st["g"][lo:hi], st["f"][lo:hi],
                         st["s"][lo:hi], rollup.fns),
                n_txs[b0:b1], now[b0:b1], roots[b0:b1], int(gdigest[k]),
                arrival_batch[lo:hi], first0 + b0, rows,
                TxArrays(now_p[b0:b1], commit_p[b0:b1],
                         torch.full((nb_g,), commit_fn, dtype=torch.int32,
                                    device=dev),
                         torch.zeros(nb_g, dtype=torch.int32, device=dev),
                         rollup.fns),
                inv_post[b0:b1] - b0)
        return preps

    def _apply_seal(self, prep: Optional[_SealPrep],
                    rollup: VectorRollup) -> int:
        """Apply one precomputed seal point: the stepped ``seal()``'s
        bookkeeping.  Returns the number of batches sealed."""
        if prep is None:                       # empty seal: window event
            rollup._emit_window(0)
            return 0
        n = len(prep.txs)
        if rollup._state_handlers:
            rollup._apply_state(prep.txs)
        first, nb = prep.first, len(prep.n_txs)
        rollup.batch_digests.extend(prep.roots.tolist())
        rollup.update_digest = prep.update_digest
        rollup._prov_starts.append(rollup._sealed_seq)
        rollup._prov_batches.append(prep.arrival_batch)
        rollup._sealed_seq += n
        refs = rollup._l1_submit(prep.commit_batch)
        for j, p in enumerate(prep.inv_post.tolist()):
            rollup.batch_commit_ref[first + j] = refs[p]
        rollup.gas_log.extend(prep.rows)
        rollup.n_batches += nb
        rollup._last_time = float(prep.now.max())
        rollup.prover.enqueue(rollup, first, prep.roots, prep.n_txs,
                              prep.now, prep.rows)
        rollup.events.emit(BatchSealed, time=rollup._last_time,
                           shard=rollup._event_shard, first_batch=first,
                           n_batches=nb, n_txs=n,
                           digest=rollup.update_digest)
        rollup._emit("batch_sealed", {
            "first_batch": first, "n_batches": nb, "n_txs": n,
            "digest": rollup.update_digest})
        rollup._emit_window(nb)
        return nb

    # -- deferred block production ---------------------------------------------
    def _pack_blocks(self, times: List[float], n_vis: List[int],
                     markers: List[Tuple[int, int, int]]) -> None:
        """Pack every deferred block in ONE ``block_pack`` launch, compute
        gas used and confirm times on the device, bring the stops and gas
        to the host in one copy, and splice the BlockPacked events to
        their stepped positions."""
        chain = self.chain
        nblk = len(times)
        if nblk == 0:
            return
        chain._consolidate()
        dev, n, ptr0 = chain.device, chain._n, chain._ptr
        times_t = torch.tensor(times, dtype=torch.float64, device=dev)
        stops = get_kernel("block_pack")(
            chain._tmax[:n], chain._gcum[:n], times_t,
            torch.tensor(n_vis, dtype=torch.int64, device=dev),
            chain.block_gas_limit, ptr0)
        starts = torch.cat([stops.new_tensor([ptr0]), stops[:-1]])
        if n:
            gcum = chain._gcum
            gend = torch.where(stops > 0, gcum[(stops - 1).clamp(min=0)], 0)
            gprev = torch.where(starts > 0, gcum[(starts - 1).clamp(min=0)],
                                0)
            gas_used = torch.where(stops > starts, gend - gprev, 0)
        else:                                  # empty mempool: empty blocks
            gas_used = torch.zeros_like(stops)
        ntx = stops - starts
        host = torch.cat([stops, gas_used]).cpu().numpy()
        stops_h, gas_h = host[:nblk], host[nblk:]
        final = int(stops_h[-1])
        if final > ptr0:
            chain._confirm[ptr0:final] = torch.repeat_interleave(
                times_t, ntx, output_size=final - ptr0)
        dispatch = bool(chain._batch_handlers or chain._state_handlers)
        if not chain.quorum(chain.n_validators - chain.n_validators // 3):
            raise RuntimeError("no QBFT quorum")
        height0 = len(chain.blocks)
        parent = chain.blocks[-1].block_hash
        lo = ptr0
        for b, (hi, gas) in enumerate(zip(stops_h.tolist(), gas_h.tolist())):
            if dispatch and hi > lo:
                self._dispatch_handlers(lo, hi)
            blk = BlockStats(height0 + b, times[b], hi - lo, gas, lo, hi,
                             parent)
            parent = blk.block_hash
            chain.blocks.append(blk)
            lo = hi
        chain.total_gas += int(gas_h.sum())
        chain._ptr = final
        self._splice_block_events(height0, markers)

    def _dispatch_handlers(self, lo: int, hi: int) -> None:
        """Per-(block, fn) handler dispatch on one deferred block's
        confirmed slice: ``produce_block``'s contract."""
        self.chain._run_handlers(lo, hi)

    def _splice_block_events(self, height0: int,
                             markers: List[Tuple[int, int, int]]) -> None:
        """Land the BlockPacked events where the stepped path emitted them
        (``EventLog.splice`` renumbers ``seq``)."""
        chain = self.chain
        inserts: List[Tuple[int, List[Any]]] = []
        for pos, blo, bn in markers:
            run: List[Any] = []
            for blk in chain.blocks[height0 + blo: height0 + blo + bn]:
                run.append(BlockPacked(
                    seq=-1, time=blk.time, shard=None, height=blk.height,
                    n_txs=blk.n_txs, gas_used=blk.gas_used,
                    block_hash=blk.block_hash))
                chain._emit("block_packed", {
                    "height": blk.height, "n_txs": blk.n_txs,
                    "gas_used": blk.gas_used, "block_hash": blk.block_hash})
            inserts.append((pos, run))
        chain.events.splice(inserts)
