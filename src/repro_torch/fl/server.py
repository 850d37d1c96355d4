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

While a ``Scheduler`` runs the fused window loop (core/fused.py), the
node's protocol emissions and its end-of-window account scatter are
journaled into the loop's plan (``_fused``) instead of reaching the
ledger at once; ``_tx_batch_many`` is the cross-task megastep's one
concatenated emission.

Construction follows the JAX package: ``spec=NodeSpec(...)`` is the
public path; without one, the legacy flag kwargs (``engine=``,
``use_rollup=``, ...) fold into ``NodeSpec.from_legacy``, whose default is
the object ``Chain`` and ``Rollup`` (a DeprecationWarning names the flags
given).  On the object faces each protocol tx carries its payload (the
task id, the model cid, the reputation value); the SoA engines carry
(time, gas, fn, sender) only.  On a sharded fabric (core/shards.py) every
emission of a task goes to the task's shard (``_route_shard``, set while
a ``TaskRuntime`` steps), and the end-of-window scatter of the reputation
book and the escrow is a cross-shard settlement whose wire cost the
fabric's interconnect model records.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.factory import build_stack
from repro_torch.api.specs import NodeSpec, as_task_spec
from repro_torch.core.engine import TxArrays
from repro_torch.core.escrow import Escrow
from repro_torch.core.gas import DEFAULT_GAS, L1_DEFAULT_GAS
from repro_torch.core.ledger import AccessControl, Tx
from repro_torch.core.oracle import DONConfig, ValidationSlices
from repro_torch.core.reputation import (ReputationParams, TrainerBook,
                                         end_of_multitask_update, init_book,
                                         sync_book_to_state)
from repro_torch.core.state import StateArrays, default_state_handlers
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
    """End-to-end protocol node.

    ``model``: a ``TinyMLP`` (or any module with ``init_params(seed)``,
    ``loss`` and ``cfg.name``); ``opt``: an ``Optimizer`` pair;
    ``eval_fn(params, batch)`` scores one model (vmapped by the DON);
    ``val_batch``: the publisher's validation set, a dict of host arrays
    or tensors.  ``spec=NodeSpec(...)`` describes the node; without it the
    legacy kwargs go through ``NodeSpec.from_legacy`` (the object stack by
    default), with a DeprecationWarning for the ledger-shape flags.  Both
    paths build the ledger through ``build_stack``.  ``device``: the card
    unless named.
    """

    #: legacy ctor kwargs folded into NodeSpec.from_legacy, with defaults
    _LEGACY_DEFAULTS = {"engine": "object", "use_rollup": True,
                        "n_shards": 1, "shard_route": "hash",
                        "trainer_funds": 10.0, "publisher_funds": 1000.0}

    def __init__(self, model, opt, n_trainers: int, eval_fn: Callable,
                 val_batch, rep_params: Optional[ReputationParams] = None,
                 don: Optional[DONConfig] = None,
                 use_rollup: Optional[bool] = None,
                 use_pallas_agg: Optional[bool] = None,
                 seed: Optional[int] = None,
                 engine: Optional[str] = None,
                 trainer_funds: Optional[float] = None,
                 publisher_funds: Optional[float] = None,
                 n_shards: Optional[int] = None,
                 shard_route: Optional[str] = None, *,
                 spec: Optional[NodeSpec] = None, device=None):
        legacy = {k: v for k, v in {
            "engine": engine, "use_rollup": use_rollup, "n_shards": n_shards,
            "shard_route": shard_route, "trainer_funds": trainer_funds,
            "publisher_funds": publisher_funds}.items() if v is not None}
        if spec is None:
            # the ledger-shape flags warn; the protocol constants and
            # funds stay silent
            flags = sorted(k for k in legacy if k in (
                "engine", "use_rollup", "n_shards", "shard_route"))
            if flags:
                warnings.warn(
                    f"AutoDFL kwargs {flags} are deprecated; pass "
                    "spec=repro_torch.api.NodeSpec(...)",
                    DeprecationWarning, stacklevel=2)
            spec = NodeSpec.from_legacy(
                rep_params=rep_params, don=don, seed=seed or 0,
                use_pallas_agg=bool(use_pallas_agg),
                **{**self._LEGACY_DEFAULTS, **legacy})
        else:
            # spec wins wholesale: reject every kwarg it would shadow
            if legacy or rep_params is not None or don is not None \
                    or use_pallas_agg is not None or seed is not None:
                raise ValueError(
                    "pass either spec= or legacy kwargs, not both")
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
        # the active core/fused.py plan while a Scheduler runs fused:
        # emissions and the end-of-window state scatter journal into it
        self._fused = None
        # the shard pin of the current emission on a fabric (set by
        # TaskRuntime.step and settle_window; None routes by policy)
        self._route_shard: Optional[int] = None

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
        counters to the L2 target (or the L1 on a chain-only node).  The
        fabric keeps its StateArrays in ``state``, the other faces in
        ``state_arrays``."""
        target = self._target()
        for fn, handler in default_state_handlers().items():
            target.register_state(fn, handler)
        st = getattr(target, "state", None)
        self.state_arrays = st if isinstance(st, StateArrays) \
            else target.state_arrays

    def _sync_fabric_state(self) -> None:
        """End-of-window settlement: scatter the reputation book and the
        escrow balances and stake into the account state; the next
        window-boundary seal roots the result.  On a fabric these rows
        span every shard's partition: their wire cost is recorded on the
        interconnect now, at the same point on the stepped and the fused
        path."""
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
        ic = getattr(target, "interconnect", None)
        if ic is not None and len(ids):
            ic.record_settle_scatter(len(ids))
        if self._fused is not None:
            # the per-seal roots commit this scatter: journal it so the
            # fused replay writes it between the same seal points
            dev = state.device
            host = torch.tensor([balances, stake], dtype=torch.float64)
            self._fused.sync_state(
                state, torch.from_numpy(ids).to(dev),
                self.book.reputation.to(dev, torch.float32).clone(),
                host[0].to(dev), host[1].to(dev))
            return
        sync_book_to_state(self.book, state, ids)
        rows = torch.from_numpy(ids).to(state.device)
        host = torch.tensor([balances, stake], dtype=torch.float64)
        state.balances[rows] = host[0].to(state.device)
        state.stake[rows] = host[1].to(state.device)
        state.mark_dirty(rows)

    def _tx(self, fn: str, sender: str, payload: Dict):
        self._tx_batch(fn, [sender], [payload])

    def _tx_batch(self, fn: str, senders: Sequence[str], payloads=None):
        """Emit one protocol tx per sender, clock-stamped 0.01 s apart.
        ``payloads``: a list of dicts, or a zero-argument callable giving
        one, materialized on the object faces only (one ``Tx`` a sender);
        a SoA target takes the calls as one batch without payloads."""
        n = len(senders)
        if n == 0:
            return
        if self.pre_tx_hook is not None:
            self.pre_tx_hook(self._clock)
        target = self._target()
        gas = DEFAULT_GAS.l1_per_call.get(fn, L1_DEFAULT_GAS)
        times = self._clock + 0.01 * np.arange(1, n + 1)
        self._clock += 0.01 * n
        if getattr(target, "soa_native", False):
            # ids MUST come from the target's own namespace
            sender_ids = [target.sender_id(s) for s in senders]
            self._submit(target, TxArrays.from_numpy(
                times, np.full(n, gas, np.int64),
                np.full(n, target.fns.id(fn), np.int32), sender_ids,
                target.fns, self.device))
        else:
            if callable(payloads):
                payloads = payloads()
            for k, (s, t) in enumerate(zip(senders, times.tolist())):
                target.submit(Tx(fn, s, payloads[k] if payloads else {},
                                 gas, t))
        self.protocol_calls[fn] = self.protocol_calls.get(fn, 0) + n

    def _submit(self, target, batch: TxArrays,
                shard: Optional[int] = None) -> None:
        """Stage on the ledger, or journal into the fused plan; ``shard``
        pins the batch on a fabric (the current task's shard by
        default)."""
        if shard is None:
            shard = self._route_shard
        if self._fused is not None and self._fused.covers(target):
            self._fused.submit(target, batch, shard=shard)
        elif shard is not None and hasattr(target, "shards"):
            target.submit_arrays(batch, shard=shard)
        else:
            target.submit_arrays(batch)

    def _tx_batch_many(self, groups) -> None:
        """The megastep's emission: ``groups`` is ``[(fn, senders,
        shard)]`` in the order sequential ``_tx_batch`` calls would run.
        Times are stamped group by group with ``_tx_batch``'s arithmetic
        (clock + 0.01 per tx), and the whole window's protocol traffic
        lands in ONE SoA batch a destination shard (one batch off a
        fabric): each shard's tx stream is the one the per-task calls
        give (submitting only stages; batches and blocks form later)."""
        groups = [(fn, senders, shard) for fn, senders, shard in groups
                  if senders]
        total = sum(len(senders) for _, senders, _ in groups)
        if total == 0:
            return
        if self.pre_tx_hook is not None:
            self.pre_tx_hook(self._clock)
        target = self._target()
        times = np.empty(total, np.float64)
        gas = np.empty(total, np.int64)
        fn_id = np.empty(total, np.int32)
        sender_id = np.empty(total, np.int32)
        shard_of = np.full(total, -1, np.int64)
        o = 0
        for fn, senders, shard in groups:
            n = len(senders)
            # advance the clock group by group, as _tx_batch does: one
            # arange over the concatenation drifts by ulps
            times[o: o + n] = self._clock + 0.01 * np.arange(1, n + 1)
            self._clock += 0.01 * n
            gas[o: o + n] = DEFAULT_GAS.l1_per_call.get(fn, L1_DEFAULT_GAS)
            fn_id[o: o + n] = target.fns.id(fn)
            sender_id[o: o + n] = [target.sender_id(s) for s in senders]
            if shard is not None:
                shard_of[o: o + n] = shard
            self.protocol_calls[fn] = self.protocol_calls.get(fn, 0) + n
            o += n
        if not hasattr(target, "shards"):
            self._submit(target, TxArrays.from_numpy(
                times, gas, fn_id, sender_id, target.fns, self.device))
            return
        if (shard_of < 0).any():
            raise ValueError("the megastep's emission on a fabric needs "
                             "a shard pin for every task")
        for k in np.unique(shard_of):
            m = shard_of == k
            self._submit(target, TxArrays.from_numpy(
                times[m], gas[m], fn_id[m], sender_id[m], target.fns,
                self.device), shard=int(k))

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
        s_rep = diags_h["s_rep"]
        for k, rt in enumerate(runtimes):
            self._route_shard = rt.shard
            try:
                self._tx_batch(
                    "calculateSubjectiveRep",
                    [self.trainer_ids[i] for i in rt.sel_idx],
                    lambda k=k, rt=rt: [{"value": float(s_rep[k, i])}
                                        for i in rt.sel_idx])
            finally:
                self._route_shard = None
            self.tsc.record_scores(rt.task_id, {
                self.trainer_ids[i]: float(rt.score_auto[i])
                for i in rt.sel_idx})
            payouts = self.tsc.close_task(rt.task_id)
            diag_k = {key: v[k] for key, v in diags_h.items()}
            rt.result = FLTaskResult(rt.params, rt.score_auto, reputations,
                                     payouts, [diag_k])
            rt.phase = "done"
        # cross-shard settlement: commit the merged book and escrow into
        # the account state; the next window-boundary seal roots it
        self._sync_fabric_state()

    # -- one full task (steps 1-16 of Fig. 1), driven sequentially ----------------
    def run_task(self, task, agents, batch_fn=None,
                 **task_kw) -> FLTaskResult:
        """Run one task to completion over the TaskRuntime state
        machine.  ``task`` is an ``FLTaskSpec`` or a task-id string with
        FLTaskSpec's fields as loose kwargs; ``agents`` a list of
        ``TrainingAgent``s or a cohort (fl/cohort.py).  ``batch_fn`` is
        the JAX package's positional slot: the agents and cohorts hold
        their own.  A ``Scheduler`` with this one task gives the same
        outputs."""
        from repro_torch.fl.scheduler import TaskRuntime
        del batch_fn
        task = as_task_spec(task, **task_kw)
        rt = TaskRuntime(self, task.task_id, agents, rounds=task.rounds,
                         reward=task.reward, n_select=task.n_select,
                         init_seed=task.init_seed)
        while rt.phase not in ("settle_ready", "done"):
            rt.step()
        self.settle_window([rt])
        if self.rollup is not None:
            self.rollup.flush()
        self.chain.run_until(self._clock + 5.0)
        return rt.result
