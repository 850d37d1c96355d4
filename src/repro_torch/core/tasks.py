"""FL task lifecycle smart contract (TSC): publishTask (paper Algo. 1),
selectTrainers, submitLocalModel (Algo. 2), with role checks (ASC) and
escrow hooks (DSC).

The state-dict chain-handler adapters of ``src/repro/core/tasks.py``
serve the object ledger path, which is not ported yet (ROADMAP.md, queue
1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.escrow import Escrow
from repro_torch.core.ledger import AccessControl
from repro_torch.core.storage import BlobStore


@dataclasses.dataclass
class Task:
    task_id: str
    model_cid: str          # IPFS-style content id of the model architecture
    description_cid: str
    publisher: str
    rounds_total: int
    required_accuracy: float
    reward: float
    trainers: List[str] = dataclasses.field(default_factory=list)
    current_round: int = 0
    state: str = "selection"     # selection -> training -> evaluated -> closed
    # per-round: {round: {trainer: model_cid}}
    models: Dict[int, Dict[str, str]] = dataclasses.field(default_factory=dict)
    scores: Dict[str, float] = dataclasses.field(default_factory=dict)


class TaskContract:
    """TSC bound to an access controller, escrow and blob store."""

    def __init__(self, acl: AccessControl, escrow: Escrow, store: BlobStore):
        self.acl = acl
        self.escrow = escrow
        self.store = store
        self.tasks: Dict[str, Task] = {}

    def _task_in(self, task_id: str, state: str) -> Task:
        task = self.tasks[task_id]
        if task.state != state:
            raise RuntimeError(f"task {task_id!r} is {task.state!r}, not "
                               f"{state!r}")
        return task

    # Algo. 1 -------------------------------------------------------------------
    def publish_task(self, sender: str, task_id: str, model_cid: str,
                     description_cid: str, rounds_total: int,
                     required_accuracy: float, reward: float) -> Task:
        if not self.acl.has_role(sender, "task_publisher"):
            raise PermissionError("isTaskPublisher(msg.sender) failed")
        if task_id in self.tasks:
            raise ValueError(f"duplicate taskId {task_id!r}")
        # false-reporting guard: reward locked up-front in the DSC
        self.escrow.deposit(sender, task_id, reward)
        task = Task(task_id, model_cid, description_cid, sender,
                    rounds_total, required_accuracy, reward)
        self.tasks[task_id] = task
        return task

    # trainer selection (reputation-ranked, on-chain) -----------------------------
    def select_trainers(self, task_id: str, reputations,
                        n_select: int, min_rep: float = 0.0,
                        trainer_ids: Optional[List[str]] = None) -> List[str]:
        """Rank trainers by reputation; ties break by stable trainer index
        (dict insertion / array position), never by id-string order.

        ``reputations`` is either {trainer_id: rep} or a host array
        aligned with ``trainer_ids`` (the scheduler's form: the book's
        reputation vector, copied to the host once).
        """
        task = self._task_in(task_id, "selection")
        if isinstance(reputations, dict):
            if trainer_ids is not None:
                raise ValueError("trainer_ids are implied by the dict")
            trainer_ids = list(reputations)
            reps = np.asarray(list(reputations.values()), np.float64)
        else:
            reps = np.asarray(reputations, np.float64)
            if trainer_ids is None or len(trainer_ids) != len(reps):
                raise ValueError("an array of reputations needs trainer_ids "
                                 "of the same length")
        ok = np.array([self.acl.has_role(t, "trainer")
                       for t in trainer_ids], bool) & (reps >= min_rep)
        idx = np.flatnonzero(ok)
        # stable sort on -rep: equal reputations keep ascending index order
        order = idx[np.argsort(-reps[idx], kind="stable")]
        task.trainers = [trainer_ids[i] for i in order[:n_select]]
        task.state = "training"
        return task.trainers

    # Algo. 2 --------------------------------------------------------------------
    def submit_local_model(self, sender: str, task_id: str, round_: int,
                           local_model_cid: str):
        task = self._task_in(task_id, "training")
        if sender not in task.trainers:
            raise PermissionError("isTrainerInTask failed")
        if not self.store.has(local_model_cid):
            raise ValueError("model blob not on IPFS")
        task.models.setdefault(round_, {})[sender] = local_model_cid

    def advance_round(self, task_id: str):
        task = self.tasks[task_id]
        task.current_round += 1
        if task.current_round >= task.rounds_total:
            task.state = "evaluated"

    def record_scores(self, task_id: str, scores: Dict[str, float]):
        self.tasks[task_id].scores.update(scores)

    def close_task(self, task_id: str) -> Dict[str, float]:
        """Settle rewards proportionally to final scores (free-riding guard:
        zero-score trainers get nothing; their collateral is slashed)."""
        task = self._task_in(task_id, "evaluated")
        payouts = self.escrow.settle(task.task_id, task.scores)
        task.state = "closed"
        return payouts
