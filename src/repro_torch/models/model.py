"""Model facade over the decoder LMs (dense attention, MoE, xLSTM, jamba's
hybrid Mamba / attention stack with MoE layers, and qwen2-vl's backbone on
precomputed embeddings), in the JAX package's interface:

    model = build_model(cfg)                  # on the card; device="cpu"
    params = model.init_params(0)             # a TransformerLM module
    logits = model.forward(params, {"tokens": tokens})
    loss   = model.loss(model.train_params(params),
                        {"tokens": tokens, "labels": labels})
    logits, caches = model.prefill(params, {"tokens": tokens})
    state = model.init_decode_state(batch_size, max_len)
    logits, state = model.decode(params, state, {"tokens": tok, "pos": t})

For an ``embeds`` config (qwen2-vl) a batch holds ``embeds`` (B, S, d)
and ``positions`` (3, B, S) instead of ``tokens``, and a decode step
``embeds`` (B, 1, d) and ``pos``.  ``loss`` takes the module or a flat
dict of its weights (``train_params``), which autograd differentiates
(``launch/steps.py``); the module is frozen for serving.  The port runs
one card with no mesh: the JAX facade's ``ctx is None`` branch.  Meshes
and sharding are ROADMAP.md queue 1 item 10(f); whisper (the
encoder-decoder on audio) is item 10(e), and its config raises
``NotImplementedError`` here.

The conv family (``lenet5``, the paper's FL workload) is the JAX facade's
``lenet`` branch: ``build_model`` returns a ``models.lenet.LeNet``, which
has the interface the FL protocol takes (``models.mlp.TinyMLP``'s:
``init_params(seed)``, ``loss(params, batch)``, ``accuracy_fn()``, flat
parameter dicts) rather than this class's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lenet, transformer


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, seed=0, dtype=None) -> transformer.TransformerLM:
        """Weights drawn on the model's device from ``seed`` (an int, or a
        ``torch.Generator`` on that device), in ``dtype`` (default: the
        config's)."""
        g = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(int(seed))
        return transformer.init_params(self.cfg, g, dtype, self.device)

    def _tokens(self, batch):
        """``batch`` with its arrays (tokens, labels, embeds, positions) as
        tensors on the model's device."""
        return {k: v if k == "pos" else torch.as_tensor(v,
                                                        device=self.device)
                for k, v in batch.items()}

    def _params(self, params):
        return transformer.params_view(self.cfg, params) \
            if isinstance(params, dict) else params

    def train_params(self, params) -> dict:
        """The weights of ``params`` (a module) as the flat dict ``loss``
        differentiates."""
        return transformer.train_params(params)

    def param_groups(self, flat: dict) -> dict:
        """Each key's JAX leaf, for adafactor (``optim.make_optimizer``)."""
        return transformer.param_groups(self.cfg, flat)

    def loss(self, params, batch, remat=None) -> torch.Tensor:
        """Mean next-token cross entropy over ``batch`` (``tokens``,
        ``labels``); each layer checkpointed by ``remat`` (default the
        config's)."""
        return transformer.loss_fn(self.cfg, self._params(params),
                                   self._tokens(batch), remat)

    def forward(self, params, batch, remat=None) -> torch.Tensor:
        return transformer.forward(self.cfg, self._params(params),
                                   self._tokens(batch), remat)

    def prefill(self, params, batch):
        return transformer.prefill(self.cfg, params, self._tokens(batch))

    def decode(self, params, state, batch):
        return transformer.decode_step(self.cfg, params, state,
                                       self._tokens(batch))

    def init_decode_state(self, batch_size: int, max_len: int):
        return transformer.init_decode_state(self.cfg, batch_size, max_len,
                                             device=self.device)


def build_model(cfg: ModelConfig, device=None):
    """The model of ``cfg`` on ``device`` (the card unless named): a
    ``LeNet`` for the conv family, a ``Model`` otherwise."""
    if cfg.family == "conv":
        return lenet.LeNet(cfg, device)
    return Model(cfg, device)
