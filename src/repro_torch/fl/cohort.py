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

``MegaCohort`` is the cross-task megastep: T same-kernel cohorts' rounds
stacked on a leading task axis and advanced by one ``vmap`` over tasks of
the cohort round, with each cohort's noise drawn through the same
``round_noise`` seam from its own (seed, round counter).  The stacked
optimizer state stays with the MegaCohort between consecutive megasteps;
a cohort that steps on its own takes it back first (``_opt_holder``).

``AgentCohort`` wraps a list of ``fl/client.TrainingAgent``s: one
``train_round`` call a trainer, the per-trainer loop of the JAX package's
object path (the sequential baseline).  Its submissions are stacked into
the same ``CohortSubmissions``, so the DON, Eq. 1 and Eq. 4 run on them
exactly as on a ``VectorCohort``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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

    def tree_for(self, k: int) -> Tree:
        """Per-trainer view (``k`` indexes ``idxs``, not the cohort)."""
        return {name: leaf[k] for name, leaf in self.stacked.items()}


class AgentCohort:
    """One ``TrainingAgent.train_round`` call per selected trainer, in
    selection order: each agent's participation stream, noise draws and
    blob puts are its own, as in the JAX package's object path."""

    def __init__(self, agents: Sequence):
        self.agents = list(agents)
        self._opt: Dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self.agents)

    def start_task(self, global_params: Tree, opt, sel_idx: Sequence[int]):
        self._opt = {i: opt.init(global_params) for i in sel_idx}

    def train(self, global_params: Tree, rnd: int,
              sel_idx: Sequence[int]) -> Optional[CohortSubmissions]:
        subs: Dict[int, Dict] = {}
        for i in sel_idx:
            out = self.agents[i].train_round(global_params, self._opt[i],
                                             i, rnd)
            if out is None:
                continue
            self._opt[i] = out["opt_state"]
            subs[i] = out
        if not subs:
            return None
        idxs = sorted(subs)
        stacked = {k: torch.stack([subs[i]["params"][k] for i in idxs])
                   for k in sorted(global_params)}
        return CohortSubmissions(idxs, stacked,
                                 {i: subs[i]["cid"] for i in idxs})


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
        dp_noise, fake_noise = round_noise(
            seed, rnd, int(mal_mask.shape[0]),
            {k: tuple(v.shape) for k, v in params.items()}, mal_mask.device)
        return self._round_core(params, opt_state, batches, dp_noise,
                                fake_noise, mal_mask, keep_mask, use_fake)

    def mega_round_step(self, params: Tree, opt_state, batches: Dict,
                        seeds: Sequence[int], rnds: Sequence[int],
                        mal_masks: torch.Tensor, keep_masks: torch.Tensor,
                        use_fake: bool):
        """T cohort rounds at once: ``torch.func.vmap`` over tasks of the
        round.  Every input carries a leading task axis (params ``(T,
        ...)``, opt state and masks ``(T, K, ...)``, batches ``(T, K, H,
        ...)``).  Task t's noise is ``round_noise(seeds[t], rnds[t], ...)``
        as on the per-task path, drawn on the host for all tasks and
        copied to the device once.  Row t of every output is what
        ``round_step`` gives on task t's inputs alone."""
        n = int(mal_masks.shape[1])
        shapes = {k: tuple(v.shape[1:]) for k, v in params.items()}
        cpu = torch.device("cpu")
        draws = [round_noise(sd, r, n, shapes, cpu)
                 for sd, r in zip(seeds, rnds)]
        dev = mal_masks.device
        dp_noise, fake_noise = ({k: torch.stack([d[j][k] for d in draws]
                                                 ).to(dev) for k in shapes}
                                for j in (0, 1))
        return vmap(lambda *a: self._round_core(*a, use_fake))(
            params, opt_state, batches, dp_noise, fake_noise, mal_masks,
            keep_masks)

    def _round_core(self, params: Tree, opt_state, batches: Dict,
                    dp_noise: Tree, fake_noise: Tree, mal_mask: torch.Tensor,
                    keep_mask: torch.Tensor, use_fake: bool):
        """The round's tensor work, given its noise (vmappable over a task
        axis)."""
        n = int(mal_mask.shape[0])
        steps = int(next(iter(batches.values())).shape[1])
        p = {k: v.expand((n,) + v.shape) for k, v in params.items()}
        o = opt_state
        losses = []
        for h in range(steps):
            p, o, loss = self._step(p, o, {k: v[:, h]
                                           for k, v in batches.items()})
            losses.append(loss)
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
        self._opt_holder = None    # MegaCohort currently holding _opt
        self._round_counter = 0

    def __len__(self) -> int:
        return len(self.behaviors)

    def start_task(self, global_params: Tree, opt, sel_idx: Sequence[int]):
        if self._opt_holder is not None:
            self._opt_holder.flush_opt()
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
        if self._opt_holder is not None:
            # a megastep holds this cohort's opt state stacked on its task
            # axis: take it back before stepping alone
            self._opt_holder.flush_opt()
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


def _host_tree(stacked: Tree, lead: int = 1) -> Dict[str, np.ndarray]:
    """A stacked float tree (``lead`` leading axes on every leaf) as numpy
    arrays (sorted keys), in one copy from the device."""
    keys = sorted(stacked)
    front = tuple(stacked[keys[0]].shape[:lead])
    flat = torch.cat([stacked[name].reshape(front + (-1,)) for name in keys],
                     dim=-1).cpu().numpy()
    out, at = {}, 0
    for name in keys:
        shape = tuple(stacked[name].shape)
        size = int(np.prod(shape[lead:], dtype=np.int64))
        out[name] = np.ascontiguousarray(flat[..., at: at + size]).reshape(
            shape)
        at += size
    return out


def _tree_expand(tree, k: int):
    """Every leaf broadcast to a leading axis of ``k`` (a view)."""
    if isinstance(tree, dict):
        return {name: _tree_expand(v, k) for name, v in tree.items()}
    return tree.expand((k,) + tree.shape)


def _tree_stack(trees: Sequence[Any]):
    """Stack same-structure trees (dicts of tensors, nested) on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))


def _tree_index(tree, i):
    """Row ``i`` of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


@dataclasses.dataclass
class MegaRound:
    """One megastep's outputs and the row bookkeeping the scheduler needs
    to score and merge across tasks in the stacked layout."""

    subs: List[Optional[CohortSubmissions]]  # per task; None: nobody came
    raw: Optional[Tree]          # (A, K, ...) submitted, selection order,
                                 # one row per active task (the DON input)
    sorted_full: Optional[Tree]  # (F, K, ...) the full-participation tasks'
                                 # submissions in CohortSubmissions order
    active: List[int]            # task index of raw row a
    full_rows: List[int]         # task index of sorted_full row f
    pos: List[np.ndarray]        # per active row: sub_pos into selection


class MegaCohort:
    """Cross-task megastep over T ``VectorCohort``s that share one
    ``CohortKernels``: their round inputs stacked on a leading task axis
    (exactly the active tasks, no padding) and advanced by ONE
    ``mega_round_step`` call instead of T ``round_step`` calls.

    Stepping each ``VectorCohort.train`` alone gives the same outputs:
    participation draws come from each cohort's own rng in the same
    order, noise from each cohort's (seed, round counter), opt state and
    round counters advance per task, and blob cids are content-identical.
    Ragged participation changes only the gather: the step trains all K
    selected trainers under per-task keep masks, as the per-task path
    does.
    """

    def __init__(self, cohorts: Sequence[VectorCohort]):
        if not cohorts:
            raise ValueError("empty mega group")
        k0 = cohorts[0].kernels
        if any(c.kernels is not k0 for c in cohorts):
            raise ValueError("a mega group shares ONE CohortKernels")
        self.cohorts = list(cohorts)
        self.kernels = k0
        # opt-state residency: between consecutive megasteps over the same
        # active tasks the stacked opt tree stays here; each active
        # cohort's ``_opt_holder`` points back, so a per-task step or a
        # new task takes it back first
        self._opt_stacked = None
        self._opt_active: Optional[List[int]] = None

    def flush_opt(self) -> None:
        """Hand the stacked opt state back to its cohorts."""
        if self._opt_stacked is None:
            return
        for a, t in enumerate(self._opt_active):
            self.cohorts[t]._opt = _tree_index(self._opt_stacked, a)
            self.cohorts[t]._opt_holder = None
        self._opt_stacked = self._opt_active = None

    def _stacked_opt(self, active: List[int]):
        if self._opt_active == active and all(
                self.cohorts[t]._opt_holder is self for t in active):
            return self._opt_stacked
        self.flush_opt()
        for t in active:
            holder = self.cohorts[t]._opt_holder
            if holder is not None:
                holder.flush_opt()
        return _tree_stack([self.cohorts[t]._opt for t in active])

    def train(self, params_list: Sequence[Tree], rnds: Sequence[int],
              sel_list: Sequence[Sequence[int]]) -> MegaRound:
        cohorts = self.cohorts
        sels = [np.asarray(s) for s in sel_list]
        if len({s.size for s in sels}) != 1:
            raise ValueError("a mega group needs one cohort size")
        parts = [c._participation(s) for c, s in zip(cohorts, sels)]
        active = [t for t in range(len(cohorts)) if parts[t].any()]
        subs: List[Optional[CohortSubmissions]] = [None] * len(cohorts)
        if not active:
            return MegaRound(subs, None, None, [], [], [])
        dev = cohorts[active[0]].device
        mal = np.stack([cohorts[t].is_malicious[sels[t]] for t in active])
        keep = np.stack([parts[t] for t in active]) & ~mal
        masks = torch.from_numpy(np.stack([mal, keep])).to(dev)
        submitted, new_opt, _loss = self.kernels.mega_round_step(
            _tree_stack([params_list[t] for t in active]),
            self._stacked_opt(active),
            _tree_stack([cohorts[t].batch_fn(sels[t], rnds[t])
                         for t in active]),
            [cohorts[t].seed for t in active],
            [cohorts[t]._round_counter for t in active],
            masks[0], masks[1], use_fake=bool(mal.any()))
        self._opt_stacked, self._opt_active = new_opt, active
        for t in active:
            cohorts[t]._opt_holder = self
            cohorts[t]._round_counter += 1
        # per-task submission order (the VectorCohort.train sub_pos)
        pos, full_rows = [], []
        for t in active:
            if parts[t].all():
                pos.append(np.argsort(sels[t]))
                full_rows.append(t)
            else:
                p = np.flatnonzero(parts[t])
                pos.append(p[np.argsort(sels[t][p])])
        sorted_full = None
        if full_rows:
            # full tasks: one gather, one host copy for all their blobs
            fa = [active.index(t) for t in full_rows]
            rows = torch.tensor(fa, device=dev)[:, None]
            cols = torch.from_numpy(np.stack([pos[a] for a in fa])).to(dev)
            sorted_full = {k: v[rows, cols] for k, v in submitted.items()}
            host = _host_tree(sorted_full, lead=2)
            for f, t in enumerate(full_rows):
                cid = cohorts[t].store.put({k: host[k][f] for k in host})
                idxs = [int(i) for i in sels[t][pos[fa[f]]]]
                subs[t] = CohortSubmissions(
                    idxs, _tree_index(sorted_full, f),
                    {i: cid for i in idxs})
        for a, t in enumerate(active):
            if subs[t] is not None:
                continue
            p = torch.from_numpy(pos[a]).to(dev)
            stacked = {k: v[a][p] for k, v in submitted.items()}
            cid = cohorts[t].store.put(_host_tree(stacked))
            idxs = [int(i) for i in sels[t][pos[a]]]
            subs[t] = CohortSubmissions(idxs, stacked, {i: cid for i in idxs})
        return MegaRound(subs, submitted, sorted_full, active, full_rows,
                         pos)
