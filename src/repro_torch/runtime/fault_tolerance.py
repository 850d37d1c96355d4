"""Fault tolerance & straggler mitigation for 1000+-node FL fleets.

Design (DESIGN.md §7):
  * Rollup rounds are the natural sync/recovery points: the committed global
    state (+ digest) is the only thing that must survive; per-trainer local
    state is reconstructible from it.
  * Failure detection: heartbeat registry with deadline sweep.
  * Straggler mitigation: (a) round deadline — aggregate whatever subset
    submitted, reweighting by score mass (Eq. 1 is subset-closed);
    (b) the reputation completeness term (Eq. 2) economically punishes
    chronic stragglers so selection avoids them next task.
  * Elastic re-mesh: on membership change pick the nearest valid
    (pod, data, model) factorisation and resume from the last commit.

The port's copy of ``src/repro/runtime/fault_tolerance.py`` (plain
Python, no JAX in it): the same classes and functions;
``ElasticController`` takes the port's ``checkpoint.Checkpointer``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class NodeState:
    node_id: str
    last_heartbeat: float
    status: str = "alive"          # alive | suspect | dead
    missed_rounds: int = 0


class HeartbeatRegistry:
    def __init__(self, suspect_after: float = 5.0, dead_after: float = 15.0):
        self.nodes: Dict[str, NodeState] = {}
        self.suspect_after = suspect_after
        self.dead_after = dead_after

    def beat(self, node_id: str, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        n = self.nodes.get(node_id)
        if n is None:
            self.nodes[node_id] = NodeState(node_id, now)
        else:
            n.last_heartbeat = now
            n.status = "alive"

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """Update statuses; return newly-dead node ids."""
        now = time.monotonic() if now is None else now
        died = []
        for n in self.nodes.values():
            dt = now - n.last_heartbeat
            if dt > self.dead_after and n.status != "dead":
                n.status = "dead"
                died.append(n.node_id)
            elif dt > self.suspect_after and n.status == "alive":
                n.status = "suspect"
        return died

    def alive(self) -> List[str]:
        return [n.node_id for n in self.nodes.values() if n.status != "dead"]


@dataclasses.dataclass
class RoundDeadline:
    """Straggler cutoff: proceed with the submitted subset once either the
    deadline passes or a quorum fraction has submitted."""

    deadline_s: float = 30.0
    quorum_frac: float = 2 / 3

    def ready(self, n_submitted: int, n_expected: int, elapsed: float) -> bool:
        if n_expected == 0:
            return False
        if n_submitted == n_expected:
            return True
        return (elapsed >= self.deadline_s
                and n_submitted >= self.quorum_frac * n_expected)


def subset_aggregate_ok(n_submitted: int, n_expected: int,
                        quorum_frac: float = 2 / 3) -> bool:
    """Eq. 1 is subset-closed: the weighted mean over submitters is still the
    correct estimator; require the chain's 2/3 quorum for commit validity."""
    return n_submitted >= quorum_frac * n_expected


def factorize_mesh(n_nodes: int, prefer_model: int = 16
                   ) -> Tuple[int, int, int]:
    """Elastic re-mesh: nearest valid (pod, data, model) for n_nodes chips.

    Keeps the model axis at the largest power-of-two <= prefer_model that
    divides n_nodes (TP degree changes force a resharded restore, so prefer
    keeping it); splits the rest into pod x data.
    """
    assert n_nodes >= 1
    model = 1
    m = prefer_model
    while m > 1:
        if n_nodes % m == 0:
            model = m
            break
        m //= 2
    rest = n_nodes // model
    pod = 1
    for cand in (8, 4, 2):
        if rest % cand == 0 and rest // cand >= cand:
            pod = cand
            break
    data = rest // pod
    return pod, data, model


class ElasticController:
    """Drives re-mesh + restore-from-commit on membership change."""

    def __init__(self, registry: HeartbeatRegistry, checkpointer,
                 prefer_model: int = 16):
        self.registry = registry
        self.checkpointer = checkpointer
        self.prefer_model = prefer_model
        self.current_mesh: Optional[Tuple[int, int, int]] = None
        self.events: List[Dict] = []

    def reconcile(self, now: Optional[float] = None) -> Optional[Tuple]:
        died = self.registry.sweep(now)
        n = len(self.registry.alive())
        target = factorize_mesh(n, self.prefer_model) if n else None
        if target != self.current_mesh:
            step = self.checkpointer.latest_step()
            self.events.append({
                "died": died, "alive": n, "new_mesh": target,
                "resume_step": step})
            self.current_mesh = target
            return target
        return None
