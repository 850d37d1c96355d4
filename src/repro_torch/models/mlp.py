"""Tiny MLP of the FL protocol path.

The model the protocol benchmark and the scheduler tests train, small so
that protocol costs dominate.  It works on feature-vector batches
``{"x": (B, d_in) float32, "labels": (B,) int}`` and keeps the JAX
package's layout: ``logits = relu(x @ w1 + b1) @ w2 + b2``.

Training code holds parameters as plain dicts of tensors (keys in sorted
order, as the JAX package's pytrees flatten them) and runs the module
through ``torch.func.functional_call``, so that a cohort's stacked
per-trainer parameters vmap.  ``params_from_numpy`` / ``params_to_numpy``
carry the JAX package's parameters across as numpy arrays.
"""
from __future__ import annotations

import types
from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]


def params_from_numpy(tree: Dict[str, np.ndarray], device=None) -> Params:
    """A parameter dict of host arrays (e.g. the JAX package's TinyMLP
    parameters) as tensors on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(tree[k])).to(dev)
            for k in sorted(tree)}


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    return {k: params[k].detach().cpu().numpy() for k in sorted(params)}


class TinyMLP(nn.Module):
    def __init__(self, d_in: int = 64, d_h: int = 32, n_classes: int = 10,
                 name: str = "tiny-mlp", device=None):
        super().__init__()
        self.cfg = types.SimpleNamespace(name=name)
        self.d_in, self.d_h, self.n_classes = d_in, d_h, n_classes
        dev = resolve_device(device)
        self.w1 = nn.Parameter(torch.zeros(d_in, d_h, device=dev))
        self.b1 = nn.Parameter(torch.zeros(d_h, device=dev))
        self.w2 = nn.Parameter(torch.zeros(d_h, n_classes, device=dev))
        self.b2 = nn.Parameter(torch.zeros(n_classes, device=dev))
        self.load_params(self.init_params(0))

    @property
    def device(self) -> torch.device:
        return self.w1.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2

    def init_params(self, seed: int) -> Params:
        """He-scaled normal ``w1``, ``0.2``-scaled normal ``w2``, zero
        biases.  Drawn on the host from a ``torch.Generator`` seeded with
        ``seed`` and moved to the model's device, so the card and the CPU
        start from the same values."""
        g = torch.Generator().manual_seed(int(seed))
        s1 = (2.0 / self.d_in) ** 0.5
        host = {"b1": torch.zeros(self.d_h),
                "b2": torch.zeros(self.n_classes),
                "w1": torch.randn(self.d_in, self.d_h, generator=g) * s1,
                "w2": torch.randn(self.d_h, self.n_classes,
                                  generator=g) * 0.2}
        return {k: v.to(self.device) for k, v in host.items()}

    @torch.no_grad()
    def load_params(self, params: Params) -> None:
        for k, v in params.items():
            getattr(self, k).copy_(v)

    def logits(self, p: Params, batch) -> torch.Tensor:
        return torch.func.functional_call(self, p, (batch["x"],))

    def loss(self, p: Params, batch) -> torch.Tensor:
        lo = self.logits(p, batch).to(torch.float32)
        lse = torch.logsumexp(lo, dim=-1)
        ll = torch.gather(lo, -1, batch["labels"].to(torch.int64)[:, None]
                          )[..., 0]
        return torch.mean(lse - ll)

    def accuracy_fn(self):
        """eval_fn(params, batch) -> accuracy scalar (DON scoring).

        The mean is taken as the float32 count of hits times ``1/B`` in
        float32: the JAX package's compiled mean multiplies by the
        reciprocal, so equal predictions give bit-equal scores (a true
        division differs from it in the last bit for some counts)."""
        def accuracy(p: Params, batch) -> torch.Tensor:
            pred = torch.argmax(self.logits(p, batch), dim=-1)
            hits = (pred == batch["labels"].to(torch.int64)).to(
                torch.float32)
            return hits.sum() * (1.0 / hits.shape[-1])
        return accuracy
