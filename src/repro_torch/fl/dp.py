"""Differential privacy for submitted model weights (paper §III-D.3):
w' = w + n, the Gaussian mechanism on the clipped update.

The noise is an argument here: the caller draws standard normals (one
tensor per leaf, shaped like it) and ``add_noise`` scales them by sigma.
The FL path draws them for a whole round at once in
``fl/cohort.round_noise``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DPConfig:
    enabled: bool = True
    clip_norm: float = 1.0        # L2 sensitivity bound on the update
    noise_multiplier: float = 0.6  # sigma = multiplier * clip / sqrt(batch)
    batch_size: int = 32

    @property
    def sigma(self) -> float:
        return (self.noise_multiplier * self.clip_norm
                / max(self.batch_size, 1) ** 0.5)


def clip_update(update: Tree, clip_norm: float):
    """Clip the whole update tree to L2 norm <= ``clip_norm``; returns
    (clipped tree, norm before clipping)."""
    sq = sum(torch.sum(torch.square(update[k].to(torch.float32)))
             for k in sorted(update))
    norm = torch.sqrt(sq)
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (u.to(torch.float32) * scale).to(u.dtype)
            for k, u in update.items()}, norm


def add_noise(update: Tree, noise: Tree, cfg: DPConfig) -> Tree:
    """Gaussian mechanism: ``update + sigma * noise`` leaf by leaf, with
    ``noise`` standard normals shaped like ``update``."""
    if not cfg.enabled:
        return update
    return {k: (u.to(torch.float32) + cfg.sigma * noise[k]).to(u.dtype)
            for k, u in update.items()}


def privatize(update: Tree, noise: Tree, cfg: DPConfig = DPConfig()):
    clipped, norm = clip_update(update, cfg.clip_norm)
    return add_noise(clipped, noise, cfg), norm
