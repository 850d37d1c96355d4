"""FL training agent (TA): local training, DP and submission through the
blob store and the ledger (the port of ``src/repro/fl/client.py``).

The per-trainer face of the protocol, driven one agent at a time by
``fl/cohort.AgentCohort`` (the sequential baseline); the batched face is
``fl/cohort.VectorCohort``.  Behaviour profiles (good / malicious / lazy)
implement the paper's §VI-C experiment.

Each agent trains on its model's device with ``torch.func.grad_and_value``
and the port's ``Optimizer`` pair, and owns a seeded ``torch.Generator``
there for its DP noise and its malicious random weights, both drawn
through the module-level seam ``agent_noise`` (tests replace it with the
JAX package's ``jax.random`` split chain).  The lazy profile's
participation draws keep the ``np.random.default_rng(seed)`` stream of the
JAX package, so both skip the same rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.core.storage import BlobStore
from repro_torch.device import resolve_device
from repro_torch.fl.dp import DPConfig, privatize

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ClientConfig:
    client_id: str
    behavior: str = "good"            # good | malicious | lazy
    lazy_skip_range: tuple = (0.4, 0.6)  # fraction of rounds skipped
    local_steps: int = 4
    dp: DPConfig = dataclasses.field(default_factory=DPConfig)


def agent_noise(agent: "TrainingAgent", kind: str,
                shapes: Dict[str, Tuple[int, ...]]) -> Tree:
    """One draw of standard normals for ``agent``, one tensor a leaf
    (sorted keys), from the agent's generator on its device.  ``kind`` is
    ``"dp"`` (the Gaussian mechanism's noise) or ``"fake"`` (a malicious
    agent's random weights, scaled by 0.1 by the caller)."""
    g = agent.generator
    return {k: torch.randn(shapes[k], generator=g, device=agent.device)
            for k in sorted(shapes)}


class TrainingAgent:
    """One trainer: ``train_round`` runs its local steps from the global
    parameters and submits the DP-noised result (or, malicious, random
    weights) to the blob store.  ``batch_fn(client_idx, step_key)`` gives
    one batch (host arrays or tensors); ``device``: where it trains (the
    card unless named)."""

    def __init__(self, cfg: ClientConfig, model, opt, store: BlobStore,
                 batch_fn: Callable[[int, int], Dict], seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.model = model
        self.opt = opt
        self.store = store
        self.batch_fn = batch_fn
        self.seed = seed
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))

    def participate(self, rnd: int) -> bool:
        if self.cfg.behavior == "lazy":
            lo, hi = self.cfg.lazy_skip_range
            return self.rng.random() > self.rng.uniform(lo, hi)
        return True

    def _local_step(self, params: Tree, opt_state, batch):
        grads, loss = grad_and_value(self.model.loss)(params, batch)
        params, opt_state, _ = self.opt.update(grads, opt_state, params)
        return params, opt_state, loss

    def _batch(self, client_idx: int, key: int) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in self.batch_fn(client_idx, key).items()}

    def train_round(self, global_params: Tree, opt_state, client_idx: int,
                    rnd: int) -> Optional[Dict]:
        """One FL round: {cid, params, opt_state[, loss]}, or None when
        the agent skips it."""
        if not self.participate(rnd):
            return None
        shapes = {k: tuple(v.shape) for k, v in global_params.items()}
        if self.cfg.behavior == "malicious":
            # free-riding: arbitrary weights, no actual training
            noise = agent_noise(self, "fake", shapes)
            fake = {k: (noise[k] * 0.1).to(global_params[k].dtype)
                    for k in sorted(global_params)}
            cid = self.store.put(fake)
            return {"cid": cid, "params": fake, "opt_state": opt_state}

        params = global_params
        loss = None
        for s in range(self.cfg.local_steps):
            params, opt_state, loss = self._local_step(
                params, opt_state, self._batch(client_idx, rnd * 1000 + s))
        # differential privacy on the submitted update (w' = w + n)
        update = {k: params[k] - global_params[k] for k in global_params}
        noised, _ = privatize(update, agent_noise(self, "dp", shapes),
                              self.cfg.dp)
        submitted = {k: global_params[k] + noised[k]
                     for k in sorted(global_params)}
        # the blob pickles host arrays in sorted key order, as the JAX
        # package's store does, so equal values get equal cids
        cid = self.store.put(submitted)
        return {"cid": cid, "params": submitted, "opt_state": opt_state,
                "loss": None if loss is None else float(loss)}
