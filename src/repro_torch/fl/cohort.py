"""Trainer cohorts: the training face a TaskRuntime drives each round.

``VectorCohort`` trains the whole selected cohort in one batched pass per
round: per-trainer stacked parameters, ``torch.func.vmap`` of
``torch.func.grad`` over the trainer axis, a Python loop over the local
steps, and the behaviour profiles (malicious, lazy) applied as masks.
DP noise and the malicious trainers' random weights come from one seam,
``round_noise``, which draws a whole round's standard normals at once.

It returns a ``CohortSubmissions`` whose params are STACKED (leading
trainer axis), so the DON scoring pass (core/oracle.py) and the Eq. 1
merge (core/aggregation.py) take them without restacking.

``AgentCohort`` (needs ``fl/client.TrainingAgent``, ROADMAP.md queue 1
item 7) and the cross-task ``MegaCohort`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.storage import BlobStore
from repro_torch.device import resolve_device
from repro_torch.fl.dp import DPConfig, privatize

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class CohortSubmissions:
    """One round's submissions: sorted cohort indices + stacked params."""

    idxs: List[int]          # cohort indices that submitted, ascending
    stacked: Tree            # leaves (len(idxs), ...) in idx order
    cids: Dict[int, str]     # per-idx content id of the submitted blob


def round_noise(seed: int, rnd: int, n: int,
                shapes: Dict[str, Tuple[int, ...]],
                device) -> Tuple[Tree, Tree]:
    """All of one round's random draws for an ``n``-trainer cohort:
    ``(dp_noise, fake_noise)``, each ``{leaf: (n, *shape)}`` standard
    normals.  ``dp_noise`` feeds the Gaussian mechanism (fl/dp.py) and
    ``fake_noise`` the malicious trainers' random weights.

    The draws come from a host ``torch.Generator`` seeded from (cohort
    seed, round counter) and are then moved to ``device``, so the card and
    the CPU see the same numbers.  They cannot match the JAX package's
    ``jax.random`` streams; tests that compare the two packages replace
    this function with one that returns the JAX draws."""
    g = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, rnd]).generate_state(1)[0]))
    keys = sorted(shapes)
    dp = {k: torch.randn((n, *shapes[k]), generator=g) for k in keys}
    fake = {k: torch.randn((n, *shapes[k]), generator=g) for k in keys}
    return ({k: v.to(device) for k, v in dp.items()},
            {k: v.to(device) for k, v in fake.items()})


def batched_batch_fn(raw_batch_fn: Callable[[int, int], Dict],
                     local_steps: int, device=None) -> Callable:
    """Adapt a per-(client, round) batch fn to the VectorCohort signature
    ``fn(sel_idx, rnd) -> leaves (K, H, ...)`` by stacking its host arrays
    (numpy) and placing them on ``device`` (the card unless named)."""
    dev = resolve_device(device)

    def fn(sel_idx: np.ndarray, rnd: int) -> Dict:
        per = [[raw_batch_fn(int(i), rnd * 1000 + s)
                for s in range(local_steps)] for i in sel_idx]
        keys = per[0][0].keys()
        return {k: torch.from_numpy(np.stack([
            np.stack([np.asarray(b[k]) for b in row]) for row in per])
        ).to(dev) for k in keys}
    return fn


def _rows(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (K,) mask shaped to broadcast over a (K, ...) leaf."""
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


class CohortKernels:
    """The cohort round as one function, shared by every VectorCohort
    built on the same (model, opt, dp)."""

    def __init__(self, model, opt, dp: DPConfig = DPConfig()):
        self.model = model
        self.opt = opt
        self.dp = dp

        def step_one(p, o, batch):
            # one local step for ONE trainer, lifted over the cohort by vmap
            grads, loss = grad_and_value(model.loss)(p, batch)
            p, o, _ = opt.update(grads, o, p)
            return p, o, loss

        self._step = vmap(step_one)
        self._privatize = vmap(lambda u, z: privatize(u, z, dp)[0])

    def round_step(self, params: Tree, opt_state, batches: Dict,
                   seed: int, rnd: int, mal_mask: torch.Tensor,
                   keep_mask: torch.Tensor, use_fake: bool):
        """The whole round for a cohort: H local steps per trainer
        (vmapped over the trainers, a Python loop over the steps), DP on
        the submitted update, the malicious rows overwritten by random
        weights, and opt-state rows kept only where ``keep_mask`` is set.
        Returns (submitted stacked params, new opt state, mean loss per
        trainer)."""
        n = int(mal_mask.shape[0])
        steps = int(next(iter(batches.values())).shape[1])
        p = {k: v.expand((n,) + v.shape) for k, v in params.items()}
        o = opt_state
        losses = []
        for h in range(steps):
            p, o, loss = self._step(p, o, {k: v[:, h]
                                           for k, v in batches.items()})
            losses.append(loss)
        dp_noise, fake_noise = round_noise(
            seed, rnd, n, {k: tuple(v.shape) for k, v in params.items()},
            mal_mask.device)
        update = {k: p[k] - params[k][None] for k in params}
        noised = self._privatize(update, dp_noise)
        submitted = {k: params[k][None] + noised[k] for k in params}
        if use_fake:
            submitted = {
                k: torch.where(_rows(mal_mask, s),
                               (fake_noise[k] * 0.1).to(s.dtype), s)
                for k, s in submitted.items()}
        new_o = _tree_where(keep_mask, o, opt_state)
        return submitted, new_o, torch.stack(losses).mean(0)


def _tree_where(mask: torch.Tensor, new, old):
    """Row-wise select over two state trees of one structure."""
    if isinstance(new, dict):
        return {k: _tree_where(mask, new[k], old[k]) for k in new}
    return torch.where(_rows(mask, new), new, old)


class VectorCohort:
    """Vectorized cohort: one batched training pass per round.

    behaviors: per-trainer profile strings ("good" | "malicious" | "lazy"),
    matching the JAX package's fl/client.py: malicious submits random
    weights without training, lazy skips a round with a probability drawn
    from ``lazy_skip_range``.
    batch_fn(sel_idx, rnd) -> batch dict with leaves (K, H, local_B, ...)
    on ``device`` (H = local optimizer steps; see ``batched_batch_fn``).
    kernels: shared CohortKernels (built on demand otherwise).
    device: where the cohort trains (the card unless named).
    """

    def __init__(self, model, opt, batch_fn: Callable, store: BlobStore,
                 behaviors: Optional[Sequence[str]] = None,
                 n_trainers: Optional[int] = None, local_steps: int = 4,
                 dp: DPConfig = DPConfig(),
                 lazy_skip_range=(0.4, 0.6), seed: int = 0,
                 kernels: Optional[CohortKernels] = None, device=None):
        if behaviors is None:
            if n_trainers is None:
                raise ValueError("need behaviors or n_trainers")
            behaviors = ["good"] * n_trainers
        self.device = resolve_device(device)
        self.behaviors = list(behaviors)
        self.model = model
        self.opt = opt
        self.batch_fn = batch_fn
        self.store = store
        self.local_steps = local_steps
        self.dp = dp
        self.lazy_skip_range = lazy_skip_range
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.is_lazy = np.array([b == "lazy" for b in self.behaviors])
        self.is_malicious = np.array(
            [b == "malicious" for b in self.behaviors])
        self.kernels = kernels or CohortKernels(model, opt, dp)
        self._opt = None           # stacked opt state over selected trainers
        self._round_counter = 0

    def __len__(self) -> int:
        return len(self.behaviors)

    def start_task(self, global_params: Tree, opt, sel_idx: Sequence[int]):
        k = len(sel_idx)
        o = opt.init(global_params)
        self._opt = _tree_expand(o, k)

    def _participation(self, sel_idx: np.ndarray) -> np.ndarray:
        lazy = self.is_lazy[sel_idx]
        r = self.rng.random(len(sel_idx))
        lo, hi = self.lazy_skip_range
        u = self.rng.uniform(lo, hi, len(sel_idx))
        return ~lazy | (r > u)

    def train(self, global_params: Tree, rnd: int,
              sel_idx: Sequence[int]) -> Optional[CohortSubmissions]:
        sel = np.asarray(sel_idx)
        part = self._participation(sel)
        if not part.any():
            return None
        batches = self.batch_fn(sel, rnd)
        # malicious rows submit random weights without training (free-
        # riding); their opt state must not advance, nor must lazy skips'
        mal = self.is_malicious[sel]
        masks = torch.from_numpy(np.stack([mal, part & ~mal])).to(
            self.device)
        submitted, self._opt, _loss = self.kernels.round_step(
            global_params, self._opt, batches, self.seed,
            self._round_counter, masks[0], masks[1],
            use_fake=bool(mal.any()))
        self._round_counter += 1

        if part.all():
            sub_pos = np.argsort(sel)             # CohortSubmissions order
        else:
            sub_pos = np.flatnonzero(part)
            sub_pos = sub_pos[np.argsort(sel[sub_pos])]
        if np.array_equal(sub_pos, np.arange(len(sel))):
            stacked = submitted
        else:
            pos = torch.from_numpy(sub_pos).to(self.device)
            stacked = {k: v[pos] for k, v in submitted.items()}
        cid = self.store.put(_host_tree(stacked))
        idxs = [int(i) for i in sel[sub_pos]]
        return CohortSubmissions(idxs, stacked, {i: cid for i in idxs})


def _host_tree(stacked: Tree) -> Dict[str, np.ndarray]:
    """A stacked float tree as numpy arrays (sorted keys), in one copy
    from the device."""
    keys = sorted(stacked)
    k = stacked[keys[0]].shape[0]
    flat = torch.cat([stacked[name].reshape(k, -1) for name in keys],
                     dim=1).cpu().numpy()
    out, at = {}, 0
    for name in keys:
        shape = tuple(stacked[name].shape)
        size = int(np.prod(shape[1:], dtype=np.int64))
        out[name] = np.ascontiguousarray(flat[:, at: at + size]).reshape(
            shape)
        at += size
    return out


def _tree_expand(tree, k: int):
    """Every leaf broadcast to a leading axis of ``k`` (a view)."""
    if isinstance(tree, dict):
        return {name: _tree_expand(v, k) for name, v in tree.items()}
    return tree.expand((k,) + tree.shape)
