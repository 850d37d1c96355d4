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
distances (kernel ``model_distance``) feed the Eq. 2-10 update.

Only the stepped per-task path is ported.  The cross-task megastep
(``megabatch``, with ``MegaCohort``) and the fused plan-then-execute
window loop (``fused``, with ``core/fused.py`` and ``block_pack``) are the
next slice (ROADMAP.md, queue 1 item 3): ``"auto"`` resolves to the
stepped path and says so once in the log, ``True`` raises.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.specs import as_task_spec
from repro_torch.core.aggregation import (tree_flat, tree_flat_stacked,
                                          weighted_average_tree)
from repro_torch.core.engine import TxArrays
from repro_torch.core.oracle import evaluate_quorum
from repro_torch.core.reputation import model_distances
from repro_torch.fl.cohort import CohortSubmissions, VectorCohort

_log = logging.getLogger(__name__)
# stack shapes already told that "auto" resolved to the stepped path: the
# log fires once per stack shape per process, not once per run
_STEPPED_FALLBACK_LOGGED: set = set()


def _settle_distances(stacked_tree, global_tree) -> torch.Tensor:
    """Batched Eq. 4 distances of the final submissions (one
    ``model_distance`` launch per task at settlement)."""
    return model_distances(tree_flat_stacked(stacked_tree),
                           tree_flat(global_tree))


class TaskRuntime:
    """Per-task state machine over a shared protocol node (AutoDFL).

    Phases: "select" -> "round" (x rounds) -> "settle_ready" -> "done".
    ``step()`` advances one phase; settlement is performed by the node
    (``AutoDFL.settle_window``) so that tasks closing in the same scheduler
    window share one reputation update.
    """

    def __init__(self, node, task_id: str, cohort: VectorCohort, *,
                 rounds: int = 5, reward: float = 10.0,
                 n_select: Optional[int] = None, init_seed: int = 0):
        if not isinstance(cohort, VectorCohort):
            raise TypeError("the port drives VectorCohorts; AgentCohort is "
                            "not ported yet (ROADMAP.md, queue 1 item 7)")
        if len(cohort) != len(node.trainer_ids):
            raise ValueError("cohort must cover the node's trainer set")
        self.node = node
        self.task_id = task_id
        self.cohort = cohort
        self.rounds = rounds
        self.reward = reward
        self.n_select = n_select
        self.init_seed = init_seed
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

    # steps 1-2: publish + reputation-ranked selection --------------------------
    def _select(self):
        node = self.node
        model_cid = node.store.put({"arch": node.model.cfg.name})
        node.tsc.publish_task(node.publisher, self.task_id, model_cid,
                              model_cid, self.rounds, 0.5, self.reward)
        node._tx("publishTask", node.publisher)
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
        node._tx_batch("submitLocalModel", senders)
        self.completed[subs.idxs] += 1.0
        scores, report = evaluate_quorum(node.eval_fn, subs.stacked, None,
                                          node.don, slices=node.val_slices)
        node._tx_batch("calculateObjectiveRep", senders)
        self.params = weighted_average_tree(subs.stacked, scores)
        node.tsc.advance_round(self.task_id)
        self.last_subs = subs
        self.last_scores = np.asarray(report["median"], np.float32)

    # step 16 prep: cohort settlement arrays ------------------------------------
    def _finalize(self):
        """Distances + final scores for the end-of-task update.

        Final scores reuse the last round's DON quorum medians.  Distances
        are computed for submitters in one batched Eq. 4 pass; every
        selected non-submitter then gets the max over submitted distances
        (or 1.0 when there is none, or it is 0)."""
        self.participated[self.sel_idx] = 1.0
        d = np.zeros(0, np.float32)
        if self.last_subs is not None:
            d = _settle_distances(self.last_subs.stacked,
                                  self.params).cpu().numpy()
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
    only the final flush).  ``fused`` and ``megabatch``: ``"auto"`` and
    ``False`` run the stepped per-task path, the only one ported;
    ``True`` raises ``NotImplementedError``.
    """

    def __init__(self, node, *, window: float = 1.0, seal_every: int = 0,
                 background=None, fused="auto", megabatch="auto"):
        for name, value in (("fused", fused), ("megabatch", megabatch)):
            if value is True:
                raise NotImplementedError(
                    f"Scheduler({name}=True): the {name} path is not ported "
                    "yet (ROADMAP.md, queue 1 item 3)")
            if value not in ("auto", False):
                raise ValueError(f"{name} must be 'auto', True or False")
        self.node = node
        self.window = window
        self.seal_every = seal_every
        self.background = background
        self.fused = fused
        self.megabatch = megabatch
        self.mega_windows = 0       # the megastep is not ported: stays 0
        self.n_windows = 0          # scheduling windows the last run took
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
        # remap raw workload sender ids into the chain's namespace (the
        # "client<k>" actors); raw ids would collide with protocol senders
        sid = senders[i:j]
        uniq = np.unique(sid)
        lut = np.array([chain.sender_id(f"client{int(u)}") for u in uniq],
                       np.int32)
        remapped = torch.from_numpy(lut[np.searchsorted(uniq, sid)]).to(
            txs.device)
        chain.submit_arrays(TxArrays(
            txs.submit_time[i:j], txs.gas[i:j], txs.fn_id[i:j], remapped,
            txs.fns))
        self._bg_pos = j

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
        key = (type(node.chain).__name__,
               type(node.rollup).__name__ if node.rollup is not None
               else None)
        if "auto" in (self.fused, self.megabatch) and \
                key not in _STEPPED_FALLBACK_LOGGED:
            _STEPPED_FALLBACK_LOGGED.add(key)
            _log.info("Scheduler(fused='auto', megabatch='auto') on %s/%s: "
                      "the fused loop and the megastep are not ported; "
                      "using the stepped per-task window loop", *key)
        node.pre_tx_hook = self._submit_background
        w = 0
        t = 0.0
        try:
            while any(rt.phase != "done" for rt in self.runtimes):
                # the window END tracks the protocol clock: a window edge
                # behind the clock would strand late-stamped protocol txs
                node._clock = max(node._clock, t)
                ready = []
                for rt in self.runtimes:
                    if rt.phase in ("settle_ready", "done") or \
                            rt.start_window > w:
                        continue
                    rt.step()
                    if rt.phase == "settle_ready":
                        ready.append(rt)
                if ready:
                    node.settle_window(ready)
                if self.seal_every and node.rollup is not None and \
                        (w + 1) % self.seal_every == 0:
                    node.rollup.seal()
                t_end = max(t + self.window, node._clock)
                self._submit_background(t_end)
                if node.rollup is not None:
                    # proof jobs drain on the window clock: pump BEFORE
                    # block production so window-finalized settlements
                    # land in the blocks that pack this window
                    node.rollup.pump(t_end)
                node.chain.run_until(t_end)
                t = t_end
                w += 1
                self.n_windows = w
                if w >= 1_000_000:
                    raise RuntimeError("scheduler failed to make progress")
            self._submit_background(float("inf"))
            if node.rollup is not None:
                node.rollup.flush()
            t_end = node._clock + 5.0
            if self.background is not None:
                t_end = max(t_end, self.background.duration + 5.0)
            node.chain.run_until(t_end)
        finally:
            node.pre_tx_hook = None
        for ev in client.events():
            if ev.kind == "window_settled":
                self.window_records.append(ev)
            elif ev.kind == "aggregate_verified":
                self.settlement_records.append(ev)
        return {rt.task_id: rt.result for rt in self.runtimes}
