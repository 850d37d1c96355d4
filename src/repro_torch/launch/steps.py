"""The training step of the model substrate.

``build_train_step(model, opt)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm"})`` over a flat dict of
weights (``Model.train_params``), as the JAX package's
``build_train_step`` does over its tree.  PyTorch runs eagerly: the step
is a function, not a jitted cell.  ``build_cell`` and
``opt_state_pspecs`` serve the JAX package's dry-run and wait for the
meshes (ROADMAP.md queue 1 item 10(f)).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def value_and_grad(model, params: Dict[str, torch.Tensor], batch,
                   remat=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, gradients) of ``model.loss`` at ``params``, the gradients
    keyed as ``params``; the weights themselves are not written.  A
    weight the loss does not reach raises, except an encoder-decoder's
    ``encdec.unread`` weights (whisper's ``wi_up``), whose gradient is
    zero, as JAX gives it."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = model.loss(leaves, batch, remat)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    missing = [k for k, g in zip(leaves, grads) if g is None]
    if missing:
        from repro_torch.models import encdec
        if not (getattr(getattr(model, "cfg", None), "enc_dec", False)
                and all(map(encdec.unread, missing))):
            raise RuntimeError(f"the loss does not reach {missing}")
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def build_train_step(model, opt):
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        new_params, new_opt_state, gn = opt.update(grads, opt_state, params)
        return new_params, new_opt_state, {"loss": loss, "grad_norm": gn}
    return train_step
