"""Multi-task protocol scheduler: N concurrent FL tasks on one shared clock,
ledger and reputation book.

  * ``TaskRuntime`` is the per-task state machine (paper Fig. 1 steps
    1-16): select -> [train -> evaluate -> aggregate] x rounds -> settle.
    Each ``step()`` advances one phase, so a scheduler can interleave many
    tasks at round granularity.
  * ``Scheduler`` drives N TaskRuntimes on a shared window clock.  Every
    window, each active task steps once; all lifecycle and reputation
    transactions land in the node's ONE shared chain/rollup, optionally
    racing a background ``Workload`` (core/workloads.py) for block gas.
    Tasks that finish in the same window settle together through one
    multi-task reputation update.

A ``Scheduler`` with one task gives ``AutoDFL.run_task``'s outputs.

Per round a task trains its cohort (fl/cohort.py), scores the stacked
submissions with the DON (one vmapped score table, one host copy), and
merges them by Eq. 1 (kernel ``weighted_agg``); at settlement the Eq. 4
distances (kernel ``model_distance``, one launch and one host copy per
task) feed the Eq. 2-10 update.

By default (``fused="auto"``, ``megabatch="auto"``) a run takes the JAX
package's default path:

  * the ledger side runs through the plan-then-execute window loop
    (core/fused.py): the whole run's seals in one pass and its blocks in
    one ``block_pack`` launch at the end;
  * a window in which every stepping task is mid-round runs as ONE
    cross-task megastep: ``MegaCohort`` trains all tasks in one call,
    ``mega_score_tables`` scores them in one call, the full-participation
    tasks merge in one task-axis ``weighted_agg`` launch (ragged tasks
    keep one launch each), the full tasks that finish in the window get
    their Eq. 4 distances in one task-axis ``model_distance`` launch and
    one host copy, and the window's txs go out as one batch.

Both give the stepped per-task path's outputs, which stay the reference
semantics (``fused=False, megabatch=False``).  Under the defaults a node
on the object ``Chain`` / ``Rollup`` runs the stepped ledger loop, and a
task driven by ``TrainingAgent``s (an ``AgentCohort``) steps per task.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.specs import as_task_spec
from repro_torch.core.aggregation import (tree_flat, tree_flat_stacked,
                                          weighted_average_tree,
                                          weighted_average_tree_mega)
from repro_torch.core.engine import TxArrays
from repro_torch.core.fused import FusedWindowLoop, supports_fused
from repro_torch.core.ledger import Tx
from repro_torch.core.oracle import (evaluate_quorum, is_unbatchable,
                                     mega_score_tables, quorum_from_table)
from repro_torch.core.reputation import model_distances
from repro_torch.fl.cohort import (AgentCohort, CohortSubmissions,
                                   MegaCohort, VectorCohort)


def _settle_distances(stacked_tree, global_tree) -> np.ndarray:
    """Batched Eq. 4 distances of one task's final submissions: one
    ``model_distance`` launch, one host copy."""
    return model_distances(tree_flat_stacked(stacked_tree),
                           tree_flat(global_tree)).cpu().numpy()


def _settle_distances_mega(flat: torch.Tensor,
                           merged: Dict[str, torch.Tensor]) -> np.ndarray:
    """(F, K) Eq. 4 distances of F full tasks at once: their (F, K, P)
    submissions ``flat`` against their merged params (leaves (F, ...)) in
    one task-axis ``model_distance`` launch, one host copy; row f equals
    ``_settle_distances`` on task f alone."""
    return model_distances(flat, tree_flat_stacked(merged)).cpu().numpy()


class TaskRuntime:
    """Per-task state machine over a shared protocol node (AutoDFL).

    Phases: "select" -> "round" (x rounds) -> "settle_ready" -> "done".
    ``step()`` advances one phase; settlement is performed by the node
    (``AutoDFL.settle_window``) so that tasks closing in the same scheduler
    window share one reputation update.
    """

    def __init__(self, node, task_id: str, cohort, *,
                 rounds: int = 5, reward: float = 10.0,
                 n_select: Optional[int] = None, init_seed: int = 0):
        if isinstance(cohort, (list, tuple)):
            cohort = AgentCohort(cohort)
        if len(cohort) != len(node.trainer_ids):
            raise ValueError("cohort must cover the node's trainer set")
        self.node = node
        self.task_id = task_id
        self.cohort = cohort
        self.rounds = rounds
        self.reward = reward
        self.n_select = n_select
        self.init_seed = init_seed
        # on a sharded fabric (core/shards.py) every emission of this task
        # goes to one shard, chosen when the task is created
        rollup = getattr(node, "rollup", None)
        self.shard: Optional[int] = (rollup.assign_task(task_id)
                                     if hasattr(rollup, "assign_task")
                                     else None)
        self.phase = "select"
        self.rnd = 0
        self.start_window = 0
        n = len(cohort)
        self.completed = np.zeros(n, np.float32)
        self.sel_idx: List[int] = []
        self.params = None
        self.last_subs: Optional[CohortSubmissions] = None
        self.last_scores: Optional[np.ndarray] = None
        # settlement arrays, filled by _finalize
        self.score_auto = np.zeros(n, np.float32)
        self.dists = np.zeros(n, np.float32)
        self.participated = np.zeros(n, np.float32)
        self.result = None

    # -- lifecycle -------------------------------------------------------------
    def step(self):
        # every protocol tx emitted while this task steps goes to the
        # task's shard (nothing changes off a fabric)
        self.node._route_shard = self.shard
        try:
            if self.phase == "select":
                self._select()
                self.phase = "round"
                if self.rounds == 0:
                    self._finalize()
            elif self.phase == "round":
                self._round()
                if self.rnd >= self.rounds:
                    self._finalize()
            else:
                raise RuntimeError(f"step() in phase {self.phase!r} "
                                   f"(task {self.task_id})")
        finally:
            self.node._route_shard = None

    # steps 1-2: publish + reputation-ranked selection --------------------------
    def _select(self):
        node = self.node
        model_cid = node.store.put({"arch": node.model.cfg.name})
        node.tsc.publish_task(node.publisher, self.task_id, model_cid,
                              model_cid, self.rounds, 0.5, self.reward)
        node._tx("publishTask", node.publisher, {"taskId": self.task_id})
        selected = node.tsc.select_trainers(
            self.task_id, node.book.reputation.cpu().numpy(),
            self.n_select or len(self.cohort), trainer_ids=node.trainer_ids)
        self.sel_idx = [node.trainer_index(t) for t in selected]
        for t in selected:
            node.escrow.lock_collateral(t, self.task_id, 1.0)
        self.params = node.model.init_params(self.init_seed)
        self.cohort.start_task(self.params, node.opt, self.sel_idx)

    # steps 3-15: one round (local training -> DON -> Eq. 1 merge) --------------
    def _round(self):
        node = self.node
        subs = self.cohort.train(self.params, self.rnd, self.sel_idx)
        self.rnd += 1
        if subs is None:
            node.tsc.advance_round(self.task_id)
            return
        senders = []
        for i in subs.idxs:
            tid = node.trainer_ids[i]
            node.tsc.submit_local_model(tid, self.task_id, self.rnd - 1,
                                        subs.cids[i])
            senders.append(tid)
        node._tx_batch("submitLocalModel", senders,
                       lambda: [{"taskId": self.task_id,
                                 "round": self.rnd - 1, "cid": subs.cids[i]}
                                for i in subs.idxs])
        self.completed[subs.idxs] += 1.0
        scores, report = evaluate_quorum(node.eval_fn, subs.stacked, None,
                                          node.don, slices=node.val_slices)
        scores_np = np.asarray(report["median"], np.float32)
        node._tx_batch("calculateObjectiveRep", senders,
                       lambda: [{"value": float(v)} for v in scores_np])
        self.params = weighted_average_tree(subs.stacked, scores)
        node.tsc.advance_round(self.task_id)
        self.last_subs = subs
        self.last_scores = scores_np

    # step 16 prep: cohort settlement arrays ------------------------------------
    def _finalize(self):
        """Distances + final scores for the end-of-task update."""
        self._settle(self._distances())

    def _distances(self) -> np.ndarray:
        """The submitters' Eq. 4 distances, in one batched pass."""
        if self.last_subs is None:
            return np.zeros(0, np.float32)
        return _settle_distances(self.last_subs.stacked, self.params)

    def _settle(self, d: np.ndarray):
        """The host part of settlement, given the submitters' distances
        ``d``.  Final scores reuse the last round's DON quorum medians;
        every selected non-submitter gets the max over submitted distances
        (or 1.0 when there is none, or it is 0)."""
        self.participated[self.sel_idx] = 1.0
        if self.last_subs is not None:
            self.dists[self.last_subs.idxs] = d
            self.score_auto[self.last_subs.idxs] = self.last_scores
        fallback = float(d.max()) if d.size and float(d.max()) > 0 else 1.0
        submitted = set(self.last_subs.idxs) if self.last_subs else set()
        for i in self.sel_idx:
            if i not in submitted:
                self.dists[i] = fallback
        self.phase = "settle_ready"


class Scheduler:
    """Interleave N TaskRuntimes on a shared window clock.

    window: simulated seconds per scheduling window; every active task
    advances one phase per window and the L1 produces blocks up to the
    window edge.  ``background`` (a core/workloads.py Workload) is injected
    into the shared L1 in time order, racing protocol traffic for block
    gas.  ``seal_every``: seal rollup lane batches every k windows (0 =
    only the final flush).
    ``fused``: drive the ledger through the core/fused.py plan-then-
    execute loop: "auto" (when the stack supports it), True (it must), or
    False (always stepped).
    ``megabatch``: run a window in which every stepping task is mid-round
    on one shared ``CohortKernels`` as one cross-task megastep: "auto"
    (when eligible), True (raise on a window that is all-round but not
    eligible), or False (always per task).  A run with background traffic
    steps per task.
    """

    def __init__(self, node, *, window: float = 1.0, seal_every: int = 0,
                 background=None, fused="auto", megabatch="auto"):
        for name, value in (("fused", fused), ("megabatch", megabatch)):
            if not any(value is v for v in ("auto", True, False)):
                raise ValueError(f"{name} must be 'auto', True or False")
        self.node = node
        self.window = window
        self.seal_every = seal_every
        self.background = background
        self.fused = fused
        self.megabatch = megabatch
        self.mega_windows = 0       # windows driven by the megastep
        self.n_windows = 0          # scheduling windows the last run took
        self._mega = None           # (cohorts, cached MegaCohort)
        self._loop: Optional[FusedWindowLoop] = None   # during run()
        self.runtimes: List[TaskRuntime] = []
        self._bg_pos = 0
        # the background's submit times and sender ids, on the host once:
        # each window's slice is found there, and the remap runs in numpy
        self._bg_host = None
        if background is not None:
            txs = background.txs
            self._bg_host = (txs.submit_time.cpu().numpy(),
                             txs.sender_id.cpu().numpy())
        self.window_records: List[object] = []
        self.settlement_records: List[object] = []

    def add_task(self, task, cohort, **task_kw) -> TaskRuntime:
        """Register a task: ``task`` is an ``FLTaskSpec`` or a task-id
        string with FLTaskSpec's fields as loose kwargs (``rounds=``,
        ``reward=``, ``n_select=``, ``start_window=``, ``init_seed=``)."""
        task = as_task_spec(task, **task_kw)
        rt = TaskRuntime(self.node, task.task_id, cohort, rounds=task.rounds,
                         reward=task.reward, n_select=task.n_select,
                         init_seed=task.init_seed)
        rt.start_window = task.start_window
        self.runtimes.append(rt)
        return rt

    def _submit_background(self, t_end: float):
        if self.background is None:
            return
        times, senders = self._bg_host
        i = self._bg_pos
        j = int(np.searchsorted(times, t_end, side="left"))
        if j <= i:
            return
        chain = self.node.chain
        txs = self.background.txs
        self._bg_pos = j
        if not getattr(chain, "soa_native", False):
            # the object Chain: one Tx a row, the same "client<k>" actors
            names = txs.fns.names
            for f, s, g, t in zip(txs.fn_id[i:j].tolist(), senders[i:j],
                                  txs.gas[i:j].tolist(), times[i:j].tolist()):
                chain.submit(Tx(names[f], f"client{int(s)}", {}, g, t))
            return
        # remap raw workload sender ids into the chain's namespace (the
        # "client<k>" actors); raw ids would collide with protocol senders
        sid = senders[i:j]
        uniq = np.unique(sid)
        lut = np.array([chain.sender_id(f"client{int(u)}") for u in uniq],
                       np.int32)
        remapped = torch.from_numpy(lut[np.searchsorted(uniq, sid)]).to(
            txs.device)
        batch = TxArrays(txs.submit_time[i:j], txs.gas[i:j], txs.fn_id[i:j],
                         remapped, txs.fns)
        if self._loop is not None:
            self._loop.submit(chain, batch)
        else:
            chain.submit_arrays(batch)

    def _seal_rollup(self):
        """The window-boundary seal: planned under the fused loop."""
        if self._loop is not None:
            self._loop.seal()
        else:
            self.node.rollup.seal()

    # -- cross-task megastep ---------------------------------------------------
    def _mega_eligible(self, rts: List[TaskRuntime]) -> bool:
        """One megastep can replace this window's per-task loop when every
        stepping task is mid-round, the cohorts share one CohortKernels
        and one cohort size, the oracle slices are equal-sized and the
        eval_fn vmaps.  Mixed-phase windows step per task silently; under
        ``megabatch=True`` an all-round window that is not eligible
        raises."""
        if not self.megabatch or self.background is not None:
            return False
        if any(rt.phase != "round" for rt in rts):
            return False
        node = self.node
        kernels = getattr(rts[0].cohort, "kernels", None)
        target = node._target()
        ok = (getattr(target, "soa_native", False)
              and node.val_slices.stacked is not None
              and all(isinstance(rt.cohort, VectorCohort)
                      and rt.cohort.kernels is kernels for rt in rts)
              and len({len(rt.sel_idx) for rt in rts}) == 1
              # a fabric: the one emission a shard needs every task pinned
              # (least-loaded routing depends on how submissions are cut)
              and (not hasattr(target, "shards")
                   or all(rt.shard is not None for rt in rts))
              and not is_unbatchable(node.eval_fn))
        if not ok and self.megabatch is True:
            raise RuntimeError(
                "Scheduler(megabatch=True): window is not megabatchable "
                "(needs a SoA-native target, equal-sized oracle slices, "
                "VectorCohorts sharing one CohortKernels, one cohort size, "
                "a vmappable eval_fn and shard pins on a fabric)")
        return ok

    def _mega_window(self, rts: List[TaskRuntime]) -> List[TaskRuntime]:
        """One round of EVERY task in ``rts`` as a single megastep; gives
        what stepping each ``TaskRuntime._round`` in order gives."""
        node = self.node
        self.mega_windows += 1
        # cached across windows so the stacked opt state stays resident
        # between consecutive megasteps of the same group
        key = tuple(rt.cohort for rt in rts)     # cohorts compare by identity
        if self._mega is None or self._mega[0] != key:
            self._mega = (key, MegaCohort(list(key)))
        mega = self._mega[1].train([rt.params for rt in rts],
                                   [rt.rnd for rt in rts],
                                   [rt.sel_idx for rt in rts])
        for rt in rts:
            rt.rnd += 1
        groups = []
        for rt, subs in zip(rts, mega.subs):
            if subs is None:
                continue
            senders = []
            for i in subs.idxs:
                tid = node.trainer_ids[i]
                node.tsc.submit_local_model(tid, rt.task_id, rt.rnd - 1,
                                            subs.cids[i])
                senders.append(tid)
            groups += [("submitLocalModel", senders, rt.shard),
                       ("calculateObjectiveRep", senders, rt.shard)]
            rt.completed[subs.idxs] += 1.0
        node._tx_batch_many(groups)
        scores: Dict[int, torch.Tensor] = {}
        if mega.active:
            try:
                tables = mega_score_tables(node.eval_fn, mega.raw,
                                           node.val_slices)
            except RuntimeError:
                # eval_fn does not vmap: score per task; evaluate_quorum
                # caches the verdict, so later windows step per task
                tables = None
            for a, t in enumerate(mega.active):
                if tables is not None:
                    s, report = quorum_from_table(tables[a][:, mega.pos[a]],
                                                  node.don)
                else:
                    s, report = evaluate_quorum(
                        node.eval_fn, mega.subs[t].stacked, None, node.don,
                        slices=node.val_slices)
                scores[t] = s
                rts[t].last_scores = np.asarray(report["median"], np.float32)
        # full-participation tasks merge in ONE task-axis Eq. 1 launch;
        # ragged tasks (fewer submitters) keep one launch each
        full = mega.full_rows
        settled: Dict[int, np.ndarray] = {}
        if full:
            dev = next(iter(mega.sorted_full.values())).device
            flat = tree_flat_stacked(mega.sorted_full, lead=2)
            merged = weighted_average_tree_mega(
                mega.sorted_full, torch.stack([scores[t] for t in full]).to(
                    dev), flat=flat)
            for f, t in enumerate(full):
                rts[t].params = {k: v[f] for k, v in merged.items()}
            # the full tasks that finish now settle in ONE task-axis Eq. 4
            # launch on the merge's flat; the others, one launch each
            done = [f for f, t in enumerate(full)
                    if rts[t].rnd >= rts[t].rounds]
            if done:
                if len(done) < len(full):
                    pick = torch.tensor(done, device=dev)
                    flat = flat[pick]
                    merged = {k: v[pick] for k, v in merged.items()}
                for f, d in zip(done, _settle_distances_mega(flat, merged)):
                    settled[full[f]] = d
        for t in mega.active:
            if t not in full:
                subs = mega.subs[t]
                rts[t].params = weighted_average_tree(
                    subs.stacked, scores[t].to(
                        next(iter(subs.stacked.values())).device))
            node.tsc.advance_round(rts[t].task_id)
            rts[t].last_subs = mega.subs[t]
        for rt, subs in zip(rts, mega.subs):
            if subs is None:
                node.tsc.advance_round(rt.task_id)
        ready = []
        for t, rt in enumerate(rts):
            if rt.rnd >= rt.rounds:
                rt._settle(settled[t] if t in settled else rt._distances())
                ready.append(rt)
        return ready

    def run(self) -> Dict[str, object]:
        """Drive every task to completion; returns {task_id: FLTaskResult}.

        After the run, ``self.window_records`` holds the ``WindowSettled``
        commitments and ``self.settlement_records`` the
        ``AggregateVerified`` postings of this run, in emission order,
        read from the node's typed event stream."""
        node = self.node
        client = node.client()
        client.events()              # this run's provenance only
        self.window_records, self.settlement_records = [], []
        use_fused = (supports_fused(node.chain, node.rollup)
                     if self.fused == "auto" else self.fused)
        if use_fused:
            self._loop = FusedWindowLoop(node.chain, node.rollup)
            node._fused = self._loop
        ledger = self._loop if use_fused else None
        node.pre_tx_hook = self._submit_background
        w = 0
        t = 0.0
        try:
            while any(rt.phase != "done" for rt in self.runtimes):
                # the window END tracks the protocol clock: a window edge
                # behind the clock would strand late-stamped protocol txs
                node._clock = max(node._clock, t)
                stepping = [rt for rt in self.runtimes
                            if rt.phase not in ("settle_ready", "done")
                            and rt.start_window <= w]
                if stepping and self._mega_eligible(stepping):
                    ready = self._mega_window(stepping)
                else:
                    ready = []
                    for rt in stepping:
                        rt.step()
                        if rt.phase == "settle_ready":
                            ready.append(rt)
                if ready:
                    node.settle_window(ready)
                if self.seal_every and node.rollup is not None and \
                        (w + 1) % self.seal_every == 0:
                    self._seal_rollup()
                t_end = max(t + self.window, node._clock)
                self._submit_background(t_end)
                if node.rollup is not None:
                    # proof jobs drain on the window clock: pump BEFORE
                    # block production so window-finalized settlements
                    # land in the blocks that pack this window
                    (ledger or node.rollup).pump(t_end)
                (ledger or node.chain).run_until(t_end)
                t = t_end
                w += 1
                self.n_windows = w
                if w >= 1_000_000:
                    raise RuntimeError("scheduler failed to make progress")
            self._submit_background(float("inf"))
            if node.rollup is not None:
                (ledger or node.rollup).flush()
            t_end = node._clock + 5.0
            if self.background is not None:
                t_end = max(t_end, self.background.duration + 5.0)
            (ledger or node.chain).run_until(t_end)
            if ledger is not None:
                # replay the recorded window loop in one pass: the run's
                # seals at once, its blocks in one block_pack launch
                ledger.execute()
        finally:
            node.pre_tx_hook = None
            node._fused = None
            self._loop = None
        for ev in client.events():
            if ev.kind == "window_settled":
                self.window_records.append(ev)
            elif ev.kind == "aggregate_verified":
                self.settlement_records.append(ev)
        return {rt.task_id: rt.result for rt in self.runtimes}
