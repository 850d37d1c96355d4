"""AutoDFL reputation model (paper §IV, Eq. 2-10), vectorised over trainers.

Every function takes and returns tensors over the whole trainer cohort, on
the tensors' device.  Symbols follow the paper:

  O_rep  objective reputation          (Eq. 2)
  ND_i   normalised model distance     (Eq. 3)
  D_i    L2 distance local vs global   (Eq. 4, kernel ``model_distance``)
  S_rep  subjective reputation         (Eq. 5-7)
  L_rep  local reputation              (Eq. 8)
  R_i    overall reputation            (Eq. 9-10)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.factory import get_kernel

_LOG2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class ReputationParams:
    """Consortium-configured constants (paper defaults in parentheses)."""

    tau: float = -1.0        # distance-penalty threshold; <0 => use mean(ND)
    theta: float = 0.35      # good-behaviour weight (<0.5 punishes bad harder)
    sigma: float = 0.3       # uncertainty weight in S_rep
    gamma: float = 0.6       # O_rep vs S_rep blend
    lam: float = 0.35        # tanh tenure rate (omega = tanh_lam(N))
    r_min: float = 0.4       # critical trust line
    r_init: float = 0.5      # newcomer reputation
    recency_half_life: float = 8.0   # tasks; C_j recency weighting


# ---------------------------------------------------------------------------
# Objective reputation (Eq. 2-4)
# ---------------------------------------------------------------------------
def model_distances(local_flat: torch.Tensor,
                    global_flat: torch.Tensor) -> torch.Tensor:
    """Eq. 4: D_i = ||w_i - w_g||_2 through the kernel factory's
    ``model_distance`` op.  local_flat: (n, P); global_flat: (P,)."""
    return get_kernel("model_distance")(local_flat, global_flat)


def normalised_distances(d: torch.Tensor) -> torch.Tensor:
    """Eq. 3: ND_i = D_i / max_j D_j."""
    return d / torch.clamp(torch.max(d), min=1e-12)


def objective_reputation(score_auto, rounds_completed, rounds_total, nd,
                         params: ReputationParams = ReputationParams()):
    """Eq. 2.  All inputs (n,) over trainers; returns (n,) in [0, 1]."""
    tau = torch.mean(nd) if params.tau < 0 else params.tau
    penalty = torch.clamp((nd - tau) / torch.clamp(
        torch.as_tensor(1.0 - tau, dtype=nd.dtype, device=nd.device),
        min=1e-9), min=0.0)
    completeness = rounds_completed.to(torch.float32) / torch.clamp(
        rounds_total.to(torch.float32), min=1.0)
    o = score_auto.to(torch.float32) * completeness * (1.0 - penalty)
    return torch.clamp(o, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Subjective reputation (Eq. 5-7)
# ---------------------------------------------------------------------------
def recency_weights(task_ages: torch.Tensor, half_life: float):
    """C_j: exponential recency, age 0 = most recent task."""
    return torch.exp(-_LOG2 * task_ages.to(torch.float32) / half_life)


def subjective_opinion(good_mask, task_ages, interactions_with,
                       interactions_total,
                       params: ReputationParams = ReputationParams()):
    """Eq. 5-6: the opinion (b, d, u) per trainer.  good_mask and
    task_ages are (n, T)."""
    C = recency_weights(task_ages, params.recency_half_life)
    alpha = torch.sum(params.theta * C * good_mask, dim=-1)
    beta = torch.sum((1.0 - params.theta) * C * (1.0 - good_mask), dim=-1)
    i_f = interactions_with.to(torch.float32) / torch.clamp(
        interactions_total.to(torch.float32), min=1.0)
    u = 1.0 - torch.clamp(i_f, 0.0, 1.0)
    denom = torch.clamp(alpha + beta, min=1e-9)
    b = (1.0 - u) * alpha / denom
    d = (1.0 - u) * beta / denom
    return b, d, u


def subjective_reputation(b, u, params: ReputationParams = ReputationParams()):
    """Eq. 7: S_rep = b + sigma * u."""
    return torch.clamp(b + params.sigma * u, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Local reputation + update (Eq. 8-10)
# ---------------------------------------------------------------------------
def local_reputation(o_rep, s_rep,
                     params: ReputationParams = ReputationParams()):
    """Eq. 8."""
    return params.gamma * o_rep + (1.0 - params.gamma) * s_rep


def tenure_weight(n_tasks, params: ReputationParams = ReputationParams()):
    """Eq. 10: omega = (1 - e^{-lam N}) / (1 + e^{-lam N})."""
    e = torch.exp(-params.lam * n_tasks.to(torch.float32))
    return (1.0 - e) / (1.0 + e)


def update_reputation(r_prev, l_rep, n_tasks,
                      params: ReputationParams = ReputationParams()):
    """Eq. 9: asymmetric tenure-weighted update."""
    w = tenure_weight(n_tasks, params)
    good = w * r_prev + (1.0 - w) * l_rep       # L_rep >= R_min branch
    bad = (1.0 - w) * r_prev + w * l_rep        # L_rep <  R_min branch
    return torch.where(l_rep >= params.r_min, good, bad)


# ---------------------------------------------------------------------------
# End-of-task update (what the RSC smart contract computes on chain)
# ---------------------------------------------------------------------------
_BOOK_FIELDS = ("reputation", "n_tasks", "good_history", "age_history",
                "interactions_with", "interactions_total")


@dataclasses.dataclass
class TrainerBook:
    """Per-trainer running state (the on-chain record), float32 tensors."""

    reputation: torch.Tensor         # (n,)
    n_tasks: torch.Tensor            # (n,) tasks participated in
    good_history: torch.Tensor       # (n, T) rolling good/bad bits
    age_history: torch.Tensor        # (n, T) task ages (inf = empty slot)
    interactions_with: torch.Tensor  # (n,) with this TP
    interactions_total: torch.Tensor  # () total TP interactions

    @classmethod
    def from_numpy(cls, fields: Dict[str, np.ndarray],
                   device=None) -> "TrainerBook":
        """A book from host arrays, one per field (e.g. the JAX package's
        ``TrainerBook`` fields); ``device`` is the card unless named."""
        dev = resolve_device(device)
        return cls(**{f: torch.from_numpy(np.array(fields[f], np.float32))
                      .to(dev) for f in _BOOK_FIELDS})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {f: getattr(self, f).cpu().numpy() for f in _BOOK_FIELDS}


def end_of_task_update(book: TrainerBook, score_auto, rounds_completed,
                       rounds_total, distances, participated,
                       params: ReputationParams = ReputationParams()
                       ) -> Tuple[TrainerBook, Dict[str, torch.Tensor]]:
    """One task completion: the Eq. 2-10 pipeline for the cohort.

    participated: (n,) 1.0 for trainers in this task (others unchanged).
    Returns (new_book, diagnostics dict).
    """
    nd = normalised_distances(distances)
    o_rep = objective_reputation(score_auto, rounds_completed, rounds_total,
                                 nd, params)

    good_now = (o_rep >= params.r_min).to(torch.float32)
    inf = torch.tensor(float("inf"), device=o_rep.device)
    zero = torch.zeros((), device=o_rep.device)
    took_part = participated[:, None] > 0
    # roll histories: shift ages by one task, insert the new outcome at slot 0
    age_hist = torch.where(book.age_history >= inf, inf,
                           book.age_history + 1.0)
    age_hist = torch.cat([torch.where(took_part, zero, inf),
                          age_hist[:, :-1]], dim=1)
    good_hist = torch.cat([good_now[:, None], book.good_history[:, :-1]],
                          dim=1)

    inter_with = book.interactions_with + participated
    inter_total = book.interactions_total + torch.sum(participated)

    finite = torch.isfinite(age_hist)
    good_mask = torch.where(finite, good_hist, zero)
    # empty slots contribute 0 via C(1e9) = 0
    age_for_c = torch.where(finite, age_hist, torch.full_like(age_hist, 1e9))
    b, d, u = subjective_opinion(good_mask, age_for_c, inter_with,
                                 inter_total, params)
    s_rep = subjective_reputation(b, u, params)
    l_rep = local_reputation(o_rep, s_rep, params)

    n_tasks = book.n_tasks + participated
    r_new = torch.clamp(update_reputation(book.reputation, l_rep, n_tasks,
                                          params), 0.0, 1.0)
    reputation = torch.where(participated > 0, r_new, book.reputation)

    new_book = TrainerBook(
        reputation=reputation,
        n_tasks=n_tasks,
        good_history=torch.where(took_part, good_hist, book.good_history),
        age_history=torch.where(took_part, age_hist, book.age_history),
        interactions_with=inter_with,
        interactions_total=inter_total,
    )
    diag = {"o_rep": o_rep, "s_rep": s_rep, "l_rep": l_rep, "nd": nd,
            "belief": b, "disbelief": d, "uncertainty": u}
    return new_book, diag


def end_of_multitask_update(book: TrainerBook, score_auto, rounds_completed,
                            rounds_total, distances, participated,
                            params: ReputationParams = ReputationParams()):
    """Settlement for K tasks closing in the same scheduler window.

    All inputs are (K, n) (host arrays or tensors): row k holds task k's
    cohort arrays, and ``participated[k]`` masks that task's trainers.
    Applies the K Eq. 2-10 updates in row order, a loop over the rows in
    place of the JAX package's ``lax.scan``.  Returns (new_book,
    diagnostics) with each diagnostic stacked (K, n).
    """
    dev = book.reputation.device
    xs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
          for a in (score_auto, rounds_completed, rounds_total, distances,
                    participated)]
    if xs[0].dim() != 2:
        raise ValueError("multitask inputs are (K, n)")
    diags = []
    for k in range(xs[0].shape[0]):
        book, diag = end_of_task_update(book, *(x[k] for x in xs), params)
        diags.append(diag)
    return book, {key: torch.stack([d[key] for d in diags])
                  for key in diags[0]}


def sync_book_to_state(book: TrainerBook, state, account_ids) -> None:
    """Scatter the on-chain reputation record into the L2 account state
    (core/state.py StateArrays): the settlement write fl/server.py makes
    at the end of a window.  ``account_ids[i]`` is the ledger sender id
    (StateArrays row) of trainer i."""
    ids = torch.as_tensor(np.asarray(account_ids, np.int64),
                          device=state.device)
    state.ensure_ids(ids)
    state.reputation[ids] = book.reputation.to(state.device, torch.float32)
    state.mark_dirty(ids)


def init_book(n: int, history: int = 16,
              params: ReputationParams = ReputationParams(),
              device=None) -> TrainerBook:
    dev = resolve_device(device)
    return TrainerBook(
        reputation=torch.full((n,), params.r_init, dtype=torch.float32,
                              device=dev),
        n_tasks=torch.zeros(n, device=dev),
        good_history=torch.zeros(n, history, device=dev),
        age_history=torch.full((n, history), float("inf"), device=dev),
        interactions_with=torch.zeros(n, device=dev),
        interactions_total=torch.zeros((), device=dev),
    )
