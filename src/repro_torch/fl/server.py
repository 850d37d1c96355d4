"""Decentralized FL protocol node: tasks + trainers + DON + reputation +
escrow + rollup, wired together (the paper's workflow, steps 1-16 of
Fig. 1).  No central server: the "orchestrator" is the protocol state
machine every node can replay from the ledger.

``AutoDFL`` owns the SHARED protocol state (chain/rollup, escrow, blob
store, reputation book, clock); the per-task round logic lives in
``fl/scheduler.TaskRuntime``.  ``run_task`` drives one TaskRuntime to
completion; ``fl/scheduler.Scheduler`` interleaves many on the same node.
The reputation book, the account state and the models live on the node's
device (the card unless the caller names another); the escrow, the task
contracts and the clock are host state.

Not ported yet (ROADMAP.md): the legacy flag kwargs and
``NodeSpec.from_legacy`` (a missing ``spec`` means ``NodeSpec()``), the
sharded-fabric branches and the fused window loop's journaling,
``_tx_batch_many`` (with ``MegaCohort``) and the object-path payloads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.factory import build_stack
from repro_torch.api.specs import NodeSpec, as_task_spec
from repro_torch.core.engine import TxArrays
from repro_torch.core.escrow import Escrow
from repro_torch.core.gas import DEFAULT_GAS, L1_DEFAULT_GAS
from repro_torch.core.ledger import AccessControl
from repro_torch.core.oracle import ValidationSlices
from repro_torch.core.reputation import (TrainerBook,
                                         end_of_multitask_update, init_book,
                                         sync_book_to_state)
from repro_torch.core.state import default_state_handlers
from repro_torch.core.storage import BlobStore
from repro_torch.core.tasks import TaskContract
from repro_torch.device import resolve_device


@dataclasses.dataclass
class FLTaskResult:
    global_params: Dict[str, torch.Tensor]
    scores: np.ndarray
    reputations: np.ndarray
    payouts: Dict[str, float]
    diagnostics: List[Dict]


class AutoDFL:
    """End-to-end protocol node, built from ``spec=NodeSpec(...)``.

    ``model``: a ``TinyMLP`` (or any module with ``init_params(seed)``,
    ``loss`` and ``cfg.name``); ``opt``: an ``Optimizer`` pair;
    ``eval_fn(params, batch)`` scores one model (vmapped by the DON);
    ``val_batch``: the publisher's validation set, a dict of host arrays
    or tensors.  ``device``: the card unless named.
    """

    def __init__(self, model, opt, n_trainers: int, eval_fn: Callable,
                 val_batch, *, spec: Optional[NodeSpec] = None,
                 device=None):
        spec = spec if spec is not None else NodeSpec()
        if spec.n_trainers not in (None, n_trainers):
            raise ValueError(
                f"spec.n_trainers={spec.n_trainers} contradicts the "
                f"positional n_trainers={n_trainers}")
        self.device = resolve_device(device)
        self.spec = spec
        self.model = model
        self.opt = opt
        self.eval_fn = eval_fn
        self.val_batch = val_batch
        self.rep_params = spec.reputation.to_params()
        self.don = spec.don.to_config()
        self.val_slices = ValidationSlices(val_batch, self.don.n_oracles,
                                           self.device)
        self.use_pallas_agg = spec.use_pallas_agg   # chooses no code here

        self.store = BlobStore()
        self.acl = AccessControl(["admin0", "admin1", "admin2"])
        self.escrow = Escrow()
        self.tsc = TaskContract(self.acl, self.escrow, self.store)
        self.chain, self.rollup = build_stack(spec, device=self.device)
        self.book: TrainerBook = init_book(n_trainers, device=self.device)
        self.trainer_ids = [f"trainer{i}" for i in range(n_trainers)]
        self._trainer_idx = {t: i for i, t in enumerate(self.trainer_ids)}
        for t in self.trainer_ids:
            self.acl.grant("admin0", t, "trainer")
            self.escrow.fund(t, spec.trainer_funds)
        self.publisher = "tp0"
        self.acl.grant("admin0", self.publisher, "task_publisher")
        self.escrow.fund(self.publisher, spec.publisher_funds)
        self._clock = 0.0
        # array-native L2 account state (core/state.py), rows indexed by
        # the L2 target's sender ids
        self._wire_state()
        # protocol traffic accounting (the protocol TPS numerator)
        self.protocol_calls: Dict[str, int] = {}
        # invoked with the current clock before every protocol emission;
        # the Scheduler drains background traffic in time order through it
        # (the engines pack FIFO and stall on out-of-order future stamps)
        self.pre_tx_hook: Optional[Callable[[float], None]] = None

    def trainer_index(self, trainer_id: str) -> int:
        return self._trainer_idx[trainer_id]

    # -- ledger helpers -----------------------------------------------------------
    def _target(self):
        return self.rollup if self.rollup is not None else self.chain

    def client(self):
        """RPC-style façade over this node's ledger
        (``repro_torch.api.NodeClient``): receipts, account views, state
        root and the typed event stream.  Shares the node's ledger and
        clock origin."""
        from repro_torch.api.client import NodeClient
        return NodeClient(self._target(), self.chain,
                          gas_table=self.spec.chain.gas_table,
                          clock_start=self._clock)

    def _wire_state(self) -> None:
        """Attach the fixed-schema account state and the default protocol
        counters to the L2 target (or the L1 on a chain-only node)."""
        target = self._target()
        for fn, handler in default_state_handlers().items():
            target.register_state(fn, handler)
        self.state_arrays = target.state_arrays

    def _sync_fabric_state(self) -> None:
        """End-of-window settlement: scatter the reputation book and the
        escrow balances and stake into the account state; the next
        window-boundary seal roots the result."""
        state = self.state_arrays
        target = self._target()
        ids = np.array([target.sender_id(t) for t in self.trainer_ids],
                       np.int64)
        locked: Dict[str, float] = {}
        for per_task in self.escrow.collateral.values():
            for who, amount in per_task.items():
                locked[who] = locked.get(who, 0.0) + amount
        balances = [self.escrow.balances.get(t, 0.0)
                    for t in self.trainer_ids]
        stake = [locked.get(t, 0.0) for t in self.trainer_ids]
        sync_book_to_state(self.book, state, ids)
        rows = torch.from_numpy(ids).to(state.device)
        host = torch.tensor([balances, stake], dtype=torch.float64)
        state.balances[rows] = host[0].to(state.device)
        state.stake[rows] = host[1].to(state.device)
        state.mark_dirty(rows)

    def _tx(self, fn: str, sender: str):
        self._tx_batch(fn, [sender])

    def _tx_batch(self, fn: str, senders: Sequence[str]):
        """Emit one protocol tx per sender, clock-stamped 0.01 s apart,
        as one SoA batch.  The SoA engines carry (time, gas, fn, sender)
        only, so the calls' payloads are not materialized."""
        n = len(senders)
        if n == 0:
            return
        if self.pre_tx_hook is not None:
            self.pre_tx_hook(self._clock)
        target = self._target()
        gas = DEFAULT_GAS.l1_per_call.get(fn, L1_DEFAULT_GAS)
        times = self._clock + 0.01 * np.arange(1, n + 1)
        self._clock += 0.01 * n
        # ids MUST come from the target's own namespace
        sender_ids = [target.sender_id(s) for s in senders]
        target.submit_arrays(TxArrays.from_numpy(
            times, np.full(n, gas, np.int64),
            np.full(n, target.fns.id(fn), np.int32), sender_ids,
            target.fns, self.device))
        self.protocol_calls[fn] = self.protocol_calls.get(fn, 0) + n

    # -- end-of-task settlement (step 16, Eq. 2-10) -------------------------------
    def settle_window(self, runtimes) -> None:
        """Settle every task that reached "settle_ready" in this window:
        the K Eq. 2-10 updates in runtime order over one book, then per
        task the score recording, escrow payout and reputation txs."""
        if not runtimes:
            return
        n = len(self.trainer_ids)

        def stack(key):
            return np.stack([getattr(rt, key) for rt in runtimes])
        rounds_total = np.stack([np.full(n, float(rt.rounds), np.float32)
                                 for rt in runtimes])
        self.book, diags = end_of_multitask_update(
            self.book, stack("score_auto"), stack("completed"),
            rounds_total, stack("dists"), stack("participated"),
            self.rep_params)
        # the book and the diagnostics reach the host in one copy
        keys = sorted(diags)
        host = torch.cat([self.book.reputation[None],
                          *(diags[k] for k in keys)]).cpu().numpy()
        reputations = host[0]
        diags_h = {k: host[1 + i * len(runtimes): 1 + (i + 1) * len(runtimes)]
                   for i, k in enumerate(keys)}
        for k, rt in enumerate(runtimes):
            self._tx_batch("calculateSubjectiveRep",
                           [self.trainer_ids[i] for i in rt.sel_idx])
            self.tsc.record_scores(rt.task_id, {
                self.trainer_ids[i]: float(rt.score_auto[i])
                for i in rt.sel_idx})
            payouts = self.tsc.close_task(rt.task_id)
            diag_k = {key: v[k] for key, v in diags_h.items()}
            rt.result = FLTaskResult(rt.params, rt.score_auto, reputations,
                                     payouts, [diag_k])
            rt.phase = "done"
        self._sync_fabric_state()

    # -- one full task (steps 1-16 of Fig. 1), driven sequentially ----------------
    def run_task(self, task, cohort, **task_kw) -> FLTaskResult:
        """Run one task to completion over the TaskRuntime state
        machine.  ``task`` is an ``FLTaskSpec`` or a task-id string with
        FLTaskSpec's fields as loose kwargs; ``cohort`` a VectorCohort.
        A ``Scheduler`` with this one task gives the same outputs."""
        from repro_torch.fl.scheduler import TaskRuntime
        task = as_task_spec(task, **task_kw)
        rt = TaskRuntime(self, task.task_id, cohort, rounds=task.rounds,
                         reward=task.reward, n_select=task.n_select,
                         init_seed=task.init_seed)
        while rt.phase not in ("settle_ready", "done"):
            rt.step()
        self.settle_window([rt])
        if self.rollup is not None:
            self.rollup.flush()
        self.chain.run_until(self._clock + 5.0)
        return rt.result
