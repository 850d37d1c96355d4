"""Model facade over the decoder LMs (dense attention, MoE, xLSTM, jamba's
hybrid Mamba / attention stack with MoE layers, and qwen2-vl's backbone on
precomputed embeddings) and whisper's encoder-decoder, in the JAX
package's interface:

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
and sharding are ROADMAP.md queue 1 item 10(f).

An ``enc_dec`` config (whisper) is the JAX facade's ``encdec`` branch:
``init_params`` gives a ``models.encdec.EncDecLM``, a batch holds
``audio_embeds`` (B, enc_seq, d) and ``tokens`` (and ``labels``), and
``prefill`` returns the whole forward's last logits and ``None``, as the
JAX facade does (no state: a decode state's ``ek`` / ``ev`` are filled by
``encdec.encode`` and ``attention.encode_cross_kv``).

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
from repro_torch.models import encdec, lenet, transformer


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._mod = encdec if cfg.enc_dec else transformer

    def init_params(self, seed=0, dtype=None):
        """Weights drawn on the model's device from ``seed`` (an int, or a
        ``torch.Generator`` on that device), in ``dtype`` (default: the
        config's): a ``TransformerLM``, or an ``EncDecLM``."""
        g = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(int(seed))
        return self._mod.init_params(self.cfg, g, dtype, self.device)

    def _tokens(self, batch):
        """``batch`` with its arrays (tokens, labels, embeds, positions) as
        tensors on the model's device."""
        return {k: v if k == "pos" else torch.as_tensor(v,
                                                        device=self.device)
                for k, v in batch.items()}

    def _params(self, params):
        return self._mod.params_view(self.cfg, params) \
            if isinstance(params, dict) else params

    def train_params(self, params) -> dict:
        """The weights of ``params`` (a module) as the flat dict ``loss``
        differentiates."""
        return self._mod.train_params(params)

    def param_groups(self, flat: dict) -> dict:
        """Each key's JAX leaf, for adafactor (``optim.make_optimizer``)."""
        return self._mod.param_groups(self.cfg, flat)

    def loss(self, params, batch, remat=None) -> torch.Tensor:
        """Mean next-token cross entropy over ``batch`` (``tokens``,
        ``labels``; and ``audio_embeds`` for an encoder-decoder); each
        (decoder) layer checkpointed by ``remat`` (default the
        config's)."""
        return self._mod.loss_fn(self.cfg, self._params(params),
                                 self._tokens(batch), remat)

    def forward(self, params, batch, remat=None) -> torch.Tensor:
        return self._mod.forward(self.cfg, self._params(params),
                                 self._tokens(batch), remat)

    def prefill(self, params, batch):
        if self._mod is encdec:
            # the JAX facade's enc-dec prefill: the whole forward with no
            # remat, the last logits, and no state
            logits = encdec.forward(self.cfg, params, self._tokens(batch),
                                    remat="none")
            return logits[:, -1], None
        return transformer.prefill(self.cfg, params, self._tokens(batch))

    def decode(self, params, state, batch):
        return self._mod.decode_step(self.cfg, params, state,
                                     self._tokens(batch))

    def init_decode_state(self, batch_size: int, max_len: int):
        return self._mod.init_decode_state(self.cfg, batch_size, max_len,
                                           device=self.device)


def build_model(cfg: ModelConfig, device=None):
    """The model of ``cfg`` on ``device`` (the card unless named): a
    ``LeNet`` for the conv family, a ``Model`` otherwise."""
    if cfg.family == "conv":
        return lenet.LeNet(cfg, device)
    return Model(cfg, device)
