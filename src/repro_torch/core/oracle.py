"""Decentralized Oracle Network (DON, paper §III-C.5): automated
contribution evaluation, off the chain's critical path.

Each oracle scores every trainer's local model on its own slice of the
task publisher's validation set; the network aggregates by median (robust
to a minority of bad-mouthing oracles) and flags outlier oracles.  The
paper's 2/3-honest assumption maps to the quorum check.

Scoring is batched: the trainers' models arrive stacked (a dict of
tensors with a leading trainer axis) and one ``torch.func.vmap`` over
oracles of a ``vmap`` over trainers scores the whole table on the device
when the slices are equal-sized (one vmap per slice otherwise).  The
table comes to the host once per call, and the median quorum is numpy
there.  ``mode="loop"`` keeps the per-(oracle, trainer) calls for an
``eval_fn`` that cannot be vmapped; ``mode="auto"`` (the default) falls
back to it when the vmapped call raises, and remembers that verdict per
``eval_fn`` so later rounds go straight to the loop (``mode="batched"``
clears it).

``mega_score_tables`` scores a whole stack of tasks (the cross-task
megastep) with a third vmap, over tasks, around the same oracle x trainer
vmap: one call, one host copy.

``cross_verify_aggregate`` guards Eq. 1 itself: each oracle recomputes the
aggregate over its own seeded permutation of the trainer axis, and a 2/3
quorum must agree elementwise.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DONConfig:
    n_oracles: int = 5
    outlier_tol: float = 0.15      # |score - median| above this flags oracle
    quorum_frac: float = 2 / 3


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.asarray(a)).to(device)


def split_validation(val_batch: Dict, n_oracles: int):
    """Disjoint per-oracle validation slices (keeps oracles independent)."""
    n = len(next(iter(val_batch.values())))
    per = max(1, n // n_oracles)
    out = []
    for i in range(n_oracles):
        sl = slice(i * per, (i + 1) * per if i < n_oracles - 1 else n)
        out.append({k: v[sl] for k, v in val_batch.items()})
    return out


class ValidationSlices:
    """Per-oracle validation slices on ``device`` (the card unless
    named), split once and, when equal-sized, stacked on a leading oracle
    axis for the double-vmapped scoring pass."""

    def __init__(self, val_batch: Dict, n_oracles: int, device=None):
        dev = resolve_device(device)
        batch = {k: _as_tensor(v, dev) for k, v in val_batch.items()}
        self.slices = split_validation(batch, n_oracles)
        sizes = {int(next(iter(sl.values())).shape[0]) for sl in self.slices}
        self.stacked = ({k: torch.stack([sl[k] for sl in self.slices])
                         for k in batch} if len(sizes) == 1 else None)

    def __len__(self) -> int:
        return len(self.slices)


def stack_trainer_params(trainer_params):
    """Lift a list of per-trainer parameter dicts into one stacked dict
    (leading axis = trainer); a stacked dict passes through.  Returns
    (stacked, n_trainers)."""
    if isinstance(trainer_params, (list, tuple)):
        stacked = {k: torch.stack([p[k] for p in trainer_params])
                   for k in trainer_params[0]}
        return stacked, len(trainer_params)
    return trainer_params, int(next(iter(trainer_params.values())).shape[0])


# eval_fns found not to vmap ("not batchable" verdicts), oldest first
_UNBATCHABLE: OrderedDict = OrderedDict()
_UNBATCHABLE_SIZE = 32


def _verdict_key(eval_fn: Callable):
    """Bound methods are fresh objects at every attribute access: key on
    (instance, function).  None for an unhashable callable."""
    key = eval_fn
    if hasattr(eval_fn, "__func__") and hasattr(eval_fn, "__self__"):
        key = (eval_fn.__self__, eval_fn.__func__)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def is_unbatchable(eval_fn: Callable) -> bool:
    """True when ``eval_fn`` was found not to vmap (cached verdict)."""
    key = _verdict_key(eval_fn)
    return key is not None and key in _UNBATCHABLE


def _mark_unbatchable(eval_fn: Callable, value: bool) -> None:
    key = _verdict_key(eval_fn)
    if key is None:
        return
    _UNBATCHABLE.pop(key, None)
    if value:
        _UNBATCHABLE[key] = True
        while len(_UNBATCHABLE) > _UNBATCHABLE_SIZE:
            _UNBATCHABLE.popitem(last=False)


def _score_table_batched(eval_fn: Callable, stacked,
                         val: ValidationSlices) -> torch.Tensor:
    """(n_oracles, n_trainers) score table, on the device, from vmapped
    ``eval_fn`` calls: one double vmap (oracles x trainers) when the
    slices are equal-sized, else one trainer vmap per slice.  Counts its
    calls in ``_score_table_batched.calls``."""
    per_trainer = vmap(eval_fn, in_dims=(0, None))
    if val.stacked is not None:
        table = vmap(per_trainer, in_dims=(None, 0))(stacked, val.stacked)
    else:
        table = torch.stack([per_trainer(stacked, sl) for sl in val.slices])
    _score_table_batched.calls += 1
    return table


_score_table_batched.calls = 0


def mega_score_tables(eval_fn: Callable, mega_stacked,
                      val: ValidationSlices) -> np.ndarray:
    """(n_tasks, n_oracles, n_trainers) score tables for a stack of tasks
    (leaves ``(T, K, ...)``) in one triple-vmapped call and one host copy.
    Needs equal-sized oracle slices (``val.stacked``).  Every cell equals
    the per-task table's cell: the vmaps only batch independent calls.
    Counts its calls in ``mega_score_tables.calls``."""
    if val.stacked is None:
        raise ValueError("mega scoring needs equal-sized oracle slices")
    per_trainer = vmap(eval_fn, in_dims=(0, None))
    per_oracle = vmap(per_trainer, in_dims=(None, 0))
    table = vmap(per_oracle, in_dims=(0, None))(mega_stacked, val.stacked)
    mega_score_tables.calls += 1
    return table.cpu().numpy().astype(np.float64)


mega_score_tables.calls = 0


def _score_table_loop(eval_fn: Callable, stacked, n_trainers: int,
                      slices) -> np.ndarray:
    """Per-(oracle, trainer) calls, for eval_fns that cannot be vmapped.
    Counts its calls in ``_score_table_loop.calls``."""
    table = np.zeros((len(slices), n_trainers), np.float64)
    for o, sl in enumerate(slices):
        for t in range(n_trainers):
            params = {k: v[t] for k, v in stacked.items()}
            table[o, t] = float(eval_fn(params, sl))
    _score_table_loop.calls += 1
    return table


_score_table_loop.calls = 0


def quorum_from_table(table: np.ndarray, cfg: DONConfig = DONConfig(),
                      adversarial_oracles: Optional[Dict[int, float]] = None):
    """Median aggregation + outlier flagging over one (n_oracles,
    n_trainers) score table, in numpy on the host.  Returns ((n_trainers,)
    float32 median scores as a CPU tensor, report)."""
    table = np.array(table, np.float64)
    if adversarial_oracles:
        for o, forged in adversarial_oracles.items():
            table[o, :] = forged
    median = np.median(table, axis=0)                   # robust aggregate
    dev = np.abs(table - median[None, :]).mean(axis=1)  # per-oracle drift
    flagged = [o for o in range(cfg.n_oracles) if dev[o] > cfg.outlier_tol]
    honest = cfg.n_oracles - len(flagged)
    quorum_ok = honest >= cfg.quorum_frac * cfg.n_oracles
    report = {
        "table": table, "median": median, "oracle_deviation": dev,
        "flagged_oracles": flagged, "quorum_ok": bool(quorum_ok),
    }
    return torch.from_numpy(median.astype(np.float32)), report


def evaluate_quorum(eval_fn: Callable, trainer_params,
                    val_batch: Optional[Dict] = None,
                    cfg: DONConfig = DONConfig(),
                    adversarial_oracles: Optional[Dict[int, float]] = None,
                    mode: str = "auto",
                    slices: Optional[ValidationSlices] = None):
    """Score every trainer's model with every oracle; aggregate by median.

    eval_fn(params, batch) -> scalar score in [0, 1] (e.g. accuracy).
    trainer_params: a list of per-trainer parameter dicts OR one stacked
    dict with a leading trainer axis (the cohort hot path).
    mode: "auto" | "batched" | "loop" (see the module docstring).
    slices: pre-built ValidationSlices (else split from ``val_batch`` on
    the models' device).
    Returns (scores (n_trainers,) float32 on the models' device, report).
    """
    if mode not in ("auto", "batched", "loop"):
        raise ValueError(f"unknown scoring mode {mode!r}")
    stacked, n_trainers = stack_trainer_params(trainer_params)
    device = next(iter(stacked.values())).device
    val = slices if slices is not None else ValidationSlices(
        val_batch, cfg.n_oracles, device)
    if len(val) != cfg.n_oracles:
        raise ValueError(f"{len(val)} validation slices for "
                         f"{cfg.n_oracles} oracles")
    table = None
    if mode == "batched":
        _mark_unbatchable(eval_fn, False)     # a forced retry clears it
    if mode == "batched" or (mode == "auto" and not is_unbatchable(eval_fn)):
        try:
            batched = _score_table_batched(eval_fn, stacked, val)
        except RuntimeError:
            # torch.func.vmap refuses data-dependent Python (``float()``,
            # ``.item()``) with a RuntimeError while it runs the batch
            if mode == "batched":
                raise
            # remember it: "auto" must not pay a failed vmap every round
            _mark_unbatchable(eval_fn, True)
        else:
            table = batched.cpu().numpy().astype(np.float64)
    if table is None:
        table = _score_table_loop(eval_fn, stacked, n_trainers, val.slices)
    scores, report = quorum_from_table(table, cfg, adversarial_oracles)
    return scores.to(device), report


def _leaves(tree):
    """A parameter tree's tensors in sorted key order (a bare tensor is
    its own one leaf)."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def cross_verify_aggregate(agg_fn: Callable, stacked_params, scores,
                           cfg: DONConfig = DONConfig(), rtol: float = 1e-4,
                           seed: int = 0):
    """Bad-mouthing guard on aggregation: n_oracles independently recompute
    the Eq. 1 aggregate; accept iff a 2/3 quorum agrees elementwise.

    Each oracle o >= 1 recomputes over a seeded permutation of the trainer
    axis (numpy's ``default_rng(seed + o)``, as in the JAX package) --
    algebraically the same aggregate, but a distinct floating-point
    reduction path -- so an ``agg_fn`` whose output depends on trainer
    order or call history loses the quorum.  Agreement is
    ``torch.allclose(a, b, rtol=rtol, atol=1e-8)`` on every leaf against
    oracle 0's result, which is returned with the count of agreeing
    oracles."""
    leaves = _leaves(stacked_params)
    device = leaves[0].device
    scores = _as_tensor(scores, device)
    n = int(leaves[0].shape[0])
    results = []
    for o in range(cfg.n_oracles):
        perm = (np.arange(n) if o == 0
                else np.random.default_rng(seed + o).permutation(n))
        idx = torch.from_numpy(perm).to(device)
        permuted = ({k: v[idx] for k, v in stacked_params.items()}
                    if isinstance(stacked_params, dict)
                    else stacked_params[idx])
        results.append(agg_fn(permuted, scores[idx]))
    ref = results[0]
    agree = 0
    for r in results:
        agree += all(torch.allclose(a, b, rtol=rtol, atol=1e-8)
                     for a, b in zip(_leaves(ref), _leaves(r)))
    if agree < cfg.quorum_frac * cfg.n_oracles:
        raise RuntimeError("oracle quorum failed on aggregation")
    return ref, agree
