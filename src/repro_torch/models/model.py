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
(``launch/steps.py``); the module is frozen for serving.

``Model(cfg, device, mesh=mesh)`` takes a ``DeviceMesh`` (``launch/
mesh.py``) and carries it in ``self.ctx`` (``sharding.specs.MeshCtx``):
its steps then take flat dicts of DTensor weights, DTensor batches and
DTensor decode states laid out by ``params_pspecs``, ``input_pspecs``
and ``decode_state_pspecs``, as the JAX facade's ``ctx`` branch does
(``launch/steps.build_cell``).  With no mesh ``self.ctx`` holds none:
the same model code runs, its constraints no-ops and its local regions
on whole tensors.  ``params_shape`` (the weights on the ``meta`` device),
``input_specs`` and ``decode_state_shape`` are the dry run's stand-ins
(``launch/dryrun.py``), allocating nothing.

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
parameter dicts) rather than this class's; under a mesh it holds a
``MeshCtx`` as this class does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lenet, transformer
from repro_torch.sharding.specs import (MeshCtx, P, params_pspec_tree,
                                        state_pspec_tree)


class Model:
    def __init__(self, cfg: ModelConfig, device=None, *, mesh=None):
        transformer.check_supported(cfg)
        self.cfg = cfg
        if mesh is not None and device is None:
            from repro_torch.launch.mesh import mesh_device
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self.ctx = MeshCtx(mesh, cfg.sharding)
        self._mod = encdec if cfg.enc_dec else transformer

    def init_params(self, seed=0, dtype=None):
        """Weights drawn on the model's device from ``seed`` (an int, or a
        ``torch.Generator`` on that device), in ``dtype`` (default: the
        config's): a ``TransformerLM``, or an ``EncDecLM``."""
        g = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(int(seed))
        return self._mod.init_params(self.cfg, g, dtype, self.device)

    def params_shape(self, dtype=None) -> dict:
        """The weights as a flat dict of ``meta`` tensors (shapes and
        dtypes; nothing allocated, nothing drawn), keyed as
        ``train_params`` keys them."""
        return self._mod.train_params(self._mod.init_params_shape(self.cfg,
                                                                  dtype))

    def params_pspecs(self, params_shape=None) -> dict:
        """Each weight's partition spec (``sharding.specs.
        params_pspec_tree``, through ``param_groups``)."""
        ps = params_shape if params_shape is not None \
            else self.params_shape()
        return params_pspec_tree(self.ctx, ps, self.param_groups(ps))

    def _tokens(self, batch):
        """``batch`` with its arrays (tokens, labels, embeds, positions) as
        tensors on the model's device (DTensors as they come)."""
        if self.ctx.mesh is not None:
            return dict(batch)
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
                                 self._tokens(batch), remat, self.ctx)

    def forward(self, params, batch, remat=None) -> torch.Tensor:
        return self._mod.forward(self.cfg, self._params(params),
                                 self._tokens(batch), remat, self.ctx)

    def prefill(self, params, batch):
        if self._mod is encdec:
            # the JAX facade's enc-dec prefill: the whole forward with no
            # remat, the last logits, and no state
            logits = encdec.forward(self.cfg, self._params(params),
                                    self._tokens(batch), "none", self.ctx)
            return logits[:, -1], None
        return transformer.prefill(self.cfg, self._params(params),
                                   self._tokens(batch), self.ctx)

    def decode(self, params, state, batch):
        return self._mod.decode_step(self.cfg, self._params(params), state,
                                     self._tokens(batch), self.ctx)

    def init_decode_state(self, batch_size: int, max_len: int):
        return self._mod.init_decode_state(self.cfg, batch_size, max_len,
                                           device=self.device)

    def decode_state_shape(self, batch_size: int, max_len: int):
        """``init_decode_state``'s tensors on the ``meta`` device."""
        return self._mod.init_decode_state(self.cfg, batch_size, max_len,
                                           device="meta")

    def decode_state_pspecs(self, batch_size: int, max_len: int):
        return state_pspec_tree(
            self.ctx, self.decode_state_shape(batch_size, max_len))

    # -- the dry run's batch stand-ins ----------------------------------------
    def input_specs(self, shape: ShapeConfig, device="meta") -> dict:
        """The batch of one assigned shape as empty tensors on ``device``
        (``meta``, or a fake tensor mode's device), as the JAX facade's
        ``ShapeDtypeStruct`` s: tokens (and labels to train), embeds and
        positions (qwen2-vl), audio frames and tokens (whisper); a decode
        step's one token and its host ``pos``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        dt = transformer._torch_dtype(cfg.dtype)

        def sds(shp, dtype):
            return torch.empty(shp, dtype=dtype, device=device)

        if shape.kind in ("train", "prefill"):
            if cfg.input_mode == "embeds":
                batch = {"embeds": sds((B, S, cfg.d_model), dt),
                         "positions": sds((3, B, S), i32)}
            elif cfg.input_mode == "audio":
                batch = {"audio_embeds": sds((B, cfg.enc_seq, cfg.d_model),
                                             dt),
                         "tokens": sds((B, S), i32)}
            else:
                batch = {"tokens": sds((B, S), i32)}
            if shape.kind == "train":
                batch["labels"] = sds((B, S), i32)
            return batch
        # decode: one new token against a seq_len-deep cache or state
        if cfg.input_mode == "embeds":
            return {"embeds": sds((B, 1, cfg.d_model), dt), "pos": S - 1}
        return {"tokens": sds((B, 1), i32), "pos": S - 1}

    def input_pspecs(self, shape: ShapeConfig) -> dict:
        """Partition specs matching ``input_specs`` (``pos``, a host int,
        replicated)."""
        dp = self.ctx.dp_axes or None
        sp = self.ctx.sp_axis

        def leaf_spec(name, leaf):
            nd = len(getattr(leaf, "shape", ()))
            if name == "positions":
                return P(None, dp, sp)
            if name == "pos":
                return P()
            if name == "embeds":
                return P(dp, sp, None) if nd == 3 else P(dp, None)
            if name == "audio_embeds":
                return P(dp, None, None)
            if name in ("tokens", "labels"):
                return P(*([dp] + [None] * (nd - 1)))
            if name == "images":
                return P(dp, None, None, None)
            return P(*([None] * nd))

        return {k: leaf_spec(k, v)
                for k, v in self.input_specs(shape).items()}


def build_model(cfg: ModelConfig, device=None, *, mesh=None):
    """The model of ``cfg`` on ``device`` (the card unless named; under a
    ``mesh``, the mesh's device): a ``LeNet`` for the conv family, a
    ``Model`` otherwise."""
    if cfg.family == "conv":
        return lenet.LeNet(cfg, device, mesh=mesh)
    return Model(cfg, device, mesh=mesh)
