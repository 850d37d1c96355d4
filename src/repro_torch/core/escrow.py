"""Deposit/escrow smart contract (DSC): locked rewards, trainer collateral,
score-proportional settlement, slashing (paper §III-D, false-reporting and
free-riding guards)."""
from __future__ import annotations

import dataclasses
from typing import Dict


class InsufficientFunds(Exception):
    pass


@dataclasses.dataclass
class Escrow:
    balances: Dict[str, float] = dataclasses.field(default_factory=dict)
    locked: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    collateral: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    slashed_pool: float = 0.0

    def fund(self, who: str, amount: float):
        if amount < 0:
            raise ValueError("funding must be >= 0")
        self.balances[who] = self.balances.get(who, 0.0) + amount

    def deposit(self, publisher: str, task_id: str, amount: float):
        """Reward lock at publishTask (false-reporting guard: the publisher
        cannot repudiate payment after the fact)."""
        if self.balances.get(publisher, 0.0) < amount:
            raise InsufficientFunds(publisher)
        self.balances[publisher] -= amount
        self.locked.setdefault(task_id, {})[publisher] = amount

    def lock_collateral(self, trainer: str, task_id: str, amount: float):
        if self.balances.get(trainer, 0.0) < amount:
            raise InsufficientFunds(trainer)
        self.balances[trainer] -= amount
        self.collateral.setdefault(task_id, {})[trainer] = amount

    def settle(self, task_id: str, scores: Dict[str, float],
               min_score: float = 1e-6) -> Dict[str, float]:
        """Score-proportional payout; zero-score (free-riding) trainers lose
        their collateral to the slash pool."""
        pot = sum(self.locked.pop(task_id, {}).values())
        total = sum(s for s in scores.values() if s > min_score)
        payouts: Dict[str, float] = {}
        for trainer, score in scores.items():
            coll = self.collateral.get(task_id, {}).pop(trainer, 0.0)
            if score > min_score and total > 0:
                pay = pot * score / total
                payouts[trainer] = pay
                self.balances[trainer] = self.balances.get(trainer, 0.0) \
                    + pay + coll
            else:
                payouts[trainer] = 0.0
                self.slashed_pool += coll
        return payouts
