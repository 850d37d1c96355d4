"""Whisper-style encoder-decoder (the audio family), with the JAX package's
layouts and casts.

The audio frontend is a stub, as in the JAX package: a batch carries
precomputed frame embeddings ``audio_embeds`` (B, enc_seq, d), which
must be in the model's dtype (the JAX package would promote a bfloat16
encoder to float32 frames; the port refuses them), and the decoder's ``tokens`` (B, S) (and ``labels``
for the loss).  Positions are learned and absolute on both sides:
``enc_pos`` added to the frames, ``dec_pos[:S]`` to the token embeddings
(``dec_pos[pos]`` in a decode step).  Norms are ``layernorm`` with a
scale and no bias.

  * Encoder: ``n_enc_layers`` blocks of bidirectional self attention (no
    mask, no RoPE) and a dense FFN ``gelu(h @ wi_gate) @ w_down`` (GELU's
    tanh approximation, ``jax.nn.gelu``'s default), then ``enc_final_norm``.
  * Decoder: ``n_layers`` blocks of causal self attention, cross attention
    to the encoder output (its K and V projected from the encoder output
    in every block, ``attention.encode_cross_kv``) and the same FFN.
    ``wi_up`` is a weight that nothing reads, carried across all the
    same: its gradient is zero (``unread``).

Every attention but the decode step's self attention goes through the
factory's ``flash_attention`` op (the CUDA kernel on the card): the
encoder's and the cross attention with ``causal=False`` (the cross
attention at Sq = the decoder's tokens against Skv = the encoder's
frames, Sq = 1 in a decode step), the decoder's self attention causal.
The decode step's self attention is the decoder LMs' float32 path over
the cache (``attention.decode_attention_block``).

The weights live in an :class:`EncDecLM` module (``enc_blocks`` and
``blocks``, ModuleLists of :class:`EncBlock` and :class:`DecBlock`);
``params_from_numpy`` / ``params_to_numpy`` carry the JAX package's tree
across (``enc_periods.b0`` and ``periods.b0``, each weight stacked over
the layers).  Training differentiates a flat dict of the weights
(``train_params``, ``params_view``), as for the decoder LMs; each decoder
layer is checkpointed by ``remat`` (default the config's
``sharding.remat``), the encoder not at all, as in the JAX package.

Decode state keeps the JAX layout, updated in place: ``{"k", "v":
(n_layers, B, max_len, Hkv, dh), "ek", "ev": (n_layers, B, enc_seq, Hkv,
dh)}``.  ``init_decode_state`` zeroes all four, as the JAX package does,
and the prefill (``models.model.Model.prefill``) returns no state, so a
caller fills ``ek`` / ``ev`` from ``encode`` and
``attention.encode_cross_kv`` before decoding.

``init_params_shape`` builds the module on the ``meta`` device (no
draw).  The passes take a ``ctx`` (``sharding.specs.MeshCtx``, default
``NO_MESH``): under a mesh the encoder's input and every layer's output
are ``act_btd``-constrained, as in the JAX package, and the attention,
embedding and cross entropy run on each rank's shards
(``models/attention.py``, ``models/transformer.py``).
"""
from __future__ import annotations

import functools
import types
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_norm, dense_init
from repro_torch.models.transformer import (_block_tree, _delta,
                                            _from_host, _host, _maybe_remat,
                                            _stack, _torch_dtype,
                                            cross_entropy, decode_logits,
                                            embed, gathered, train_params)
from repro_torch.sharding.specs import NO_MESH

State = Dict[str, torch.Tensor]
DEC_POSITIONS = 32_768               # rows of dec_pos, as in the JAX package


def unread(key: str) -> bool:
    """Whether ``key`` (a ``train_params`` key) names a weight that no
    forward reads, the FFN's ``wi_up``: its gradient is zero."""
    return key.rsplit(".", 1)[-1] == "wi_up"


def _ffn(bp, h: torch.Tensor) -> torch.Tensor:
    """gelu(h @ wi_gate) @ w_down, GELU's tanh approximation."""
    return F.gelu(h @ bp.wi_gate, approximate="tanh") @ bp.w_down


class EncBlock(nn.Module):
    """An encoder layer: ``ln``, ``attn`` (wq, wk, wv, wo), ``ln2``,
    ``wi_gate``, ``wi_up`` (read by nothing), ``w_down``."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        param = nn.Parameter
        self.ln = param(torch.ones(d, dtype=dtype, device=device))
        self.attn = nn.ParameterDict(attn.init_attn_params(
            cfg, dtype, generator, device))
        self.ln2 = param(torch.ones(d, dtype=dtype, device=device))
        self.wi_gate = param(dense_init((d, f), dtype, generator, device))
        self.wi_up = param(dense_init((d, f), dtype, generator, device))
        self.w_down = param(dense_init((f, d), dtype, generator, device))


class DecBlock(EncBlock):
    """A decoder layer: an encoder layer's weights, and ``ln_x`` and
    ``xattn`` (the cross attention's wq, wk, wv, wo)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__(cfg, dtype, device, generator)
        d = cfg.d_model
        self.ln_x = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.xattn = nn.ParameterDict(attn.init_attn_params(
            cfg, dtype, generator, device, cross=True))


class EncDecLM(nn.Module):
    """The weights of an encoder-decoder.  With a ``generator`` they are
    drawn on ``device`` (truncated normals, fan-in scaled; norms ones);
    without one they are left uninitialised for loading."""

    def __init__(self, cfg, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.enc_dec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        dtype = _torch_dtype(dtype or cfg.dtype)
        dev = resolve_device(device)
        d, vocab = cfg.d_model, cfg.vocab_size
        param = nn.Parameter
        self.enc_pos = param(dense_init((cfg.enc_seq, d), dtype, generator,
                                        dev))
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, dtype, dev, generator)
            for _ in range(cfg.n_enc_layers))
        self.enc_final_norm = param(torch.ones(d, dtype=dtype, device=dev))
        self.dec_pos = param(dense_init((DEC_POSITIONS, d), dtype, generator,
                                        dev))
        self.embed = param(dense_init((vocab, d), dtype, generator, dev))
        self.blocks = nn.ModuleList(DecBlock(cfg, dtype, dev, generator)
                                    for _ in range(cfg.n_layers))
        self.final_norm = param(torch.ones(d, dtype=dtype, device=dev))
        self.head_w = param(dense_init((d, vocab), dtype, generator, dev))
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.head_w.device


def init_params(cfg, generator: torch.Generator, dtype=None,
                device=None) -> EncDecLM:
    return EncDecLM(cfg, dtype, device, generator)


def init_params_shape(cfg, dtype=None) -> EncDecLM:
    """The module on the ``meta`` device: shapes and dtypes, no draw."""
    with torch.device("meta"):
        return EncDecLM(cfg, dtype, "meta")


# ---------------------------------------------------------------------------
# The JAX package's stacked parameter tree, and flat dicts for training
# ---------------------------------------------------------------------------
# the unstacked weights, named alike in both layouts (and the embedding,
# ``embed.table`` in the JAX tree)
_TOP = ("enc_pos", "enc_final_norm", "dec_pos", "final_norm", "head_w")
# (JAX stack, module list)
_STACKS = (("enc_periods", "enc_blocks"), ("periods", "blocks"))


def params_from_numpy(cfg, tree, device=None, dtype=None) -> EncDecLM:
    """The JAX package's parameter tree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as an :class:`EncDecLM` on
    ``device`` (the card unless named), in ``dtype`` (default: the
    tree's)."""
    if dtype is None:
        name = np.asarray(tree["head_w"]).dtype.name
        dtype = torch.bfloat16 if name == "bfloat16" else getattr(torch, name)
    model = EncDecLM(cfg, _torch_dtype(dtype), device)
    flat = dict(model.named_parameters())
    src = flat_keys(tree)
    if sorted(src) != sorted(flat):
        raise ValueError(f"the tree's weights {sorted(set(src) ^ set(flat))} "
                         f"do not match {cfg.name}'s")
    for key, t in flat.items():
        t.copy_(_from_host(src[key]).to(t.dtype))
    return model


def flat_keys(tree) -> dict:
    """The JAX package's tree as ``{flat key: numpy array}``, keyed as
    ``EncDecLM.named_parameters`` names them (a stacked leaf split by
    layer)."""
    out = {key: tree[key] for key in _TOP}
    out["embed"] = tree["embed"]["table"]
    for stack, blocks in _STACKS:
        for name, leaf in tree[stack]["b0"].items():
            items = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
            for sub, a in items:
                for layer in range(np.shape(a)[0]):
                    key = f"{blocks}.{layer}.{name}"
                    out[key if sub is None else f"{key}.{sub}"] = a[layer]
    return out


def flat_to_numpy(cfg, flat: Dict[str, torch.Tensor]):
    """A flat dict keyed as ``named_parameters`` (the weights, or their
    gradients) as the JAX package's stacked tree of numpy arrays, bfloat16
    as float32."""
    out = {key: _host(flat[key]) for key in _TOP}
    out["embed"] = {"table": _host(flat["embed"])}
    for (stack_key, blocks), n in zip(_STACKS,
                                      (cfg.n_enc_layers, cfg.n_layers)):
        out[stack_key] = {"b0": _stack([_block_tree(flat, f"{blocks}.{i}.")
                                        for i in range(n)])}
    return out


def params_to_numpy(params: EncDecLM):
    """The module's weights as the JAX package's stacked tree of numpy
    arrays (bfloat16 weights as float32, which holds them exactly)."""
    return flat_to_numpy(params.cfg, train_params(params))


def param_groups(cfg, flat) -> Dict[str, Tuple[str, Optional[int]]]:
    """``{key: (leaf, j)}`` for ``optim.make_optimizer``'s adafactor: the
    JAX package's leaf that holds each key (``enc_periods.b0.<name>`` or
    ``periods.b0.<name>``, stacked over the layers, ``j`` the layer;
    ``embed.table`` and the other unstacked weights, ``j`` None)."""
    stacks = dict((blocks, key) for key, blocks in _STACKS)
    out = {}
    for key in flat:
        head, _, rest = key.partition(".")
        if head in stacks:
            layer, name = rest.split(".", 1)
            out[key] = (f"{stacks[head]}.b0.{name}", int(layer))
        else:
            out[key] = ("embed.table" if key == "embed" else key, None)
    return out


def params_view(cfg, flat: Dict[str, torch.Tensor]):
    """A flat dict of weights with the attributes the forward reads from
    an :class:`EncDecLM` (``blocks[l].xattn["wq"]``, ``enc_pos``, ...), so
    that the forward differentiates the dict's tensors themselves."""
    def blocks(name, n):
        return [types.SimpleNamespace(**_block_tree(flat, f"{name}.{i}."))
                for i in range(n)]
    return types.SimpleNamespace(
        cfg=cfg, enc_blocks=blocks("enc_blocks", cfg.n_enc_layers),
        blocks=blocks("blocks", cfg.n_layers), embed=flat["embed"],
        **{key: flat[key] for key in _TOP},
        device=flat["head_w"].device)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def encode(cfg, params: EncDecLM, audio_embeds: torch.Tensor,
           ctx=NO_MESH) -> torch.Tensor:
    """The encoder over frame embeddings (B, enc_seq, d) in the model's
    dtype -> (B, enc_seq, d)."""
    if audio_embeds.dtype != params.enc_pos.dtype:
        raise TypeError(f"audio_embeds are {audio_embeds.dtype}, the "
                        f"model's weights {params.enc_pos.dtype}: cast the "
                        f"frames to the model's dtype")
    x = ctx.act_btd(audio_embeds + params.enc_pos[None])
    for bp in params.enc_blocks:
        bp = gathered(ctx, bp)
        h = apply_norm(cfg, x, bp.ln)
        x = x + _delta(ctx, attn.bidir_attention_block(cfg, bp.attn, h, ctx))
        x = ctx.act_btd(x + _delta(ctx, _ffn(bp, apply_norm(cfg, x,
                                                           bp.ln2))))
    return apply_norm(cfg, x, params.enc_final_norm)


def _dec_block(cfg, bp, x: torch.Tensor, positions: torch.Tensor,
               enc_out: torch.Tensor, ctx=NO_MESH) -> torch.Tensor:
    bp = gathered(ctx, bp)
    h = apply_norm(cfg, x, bp.ln)
    x = x + _delta(ctx, attn.attention_block(cfg, bp.attn, h, positions,
                                             ctx=ctx))
    h = apply_norm(cfg, x, bp.ln_x)
    ek, ev = attn.encode_cross_kv(cfg, bp.xattn, enc_out, ctx)
    x = x + _delta(ctx, attn.cross_attention_block(cfg, bp.xattn, h, ek, ev,
                                                   ctx))
    return ctx.act_btd(x + _delta(ctx, _ffn(bp, apply_norm(cfg, x, bp.ln2))))


def _embed(params, tokens: torch.Tensor, pos: int = 0,
           ctx=NO_MESH) -> torch.Tensor:
    """Token embeddings plus the learned positions pos .. pos + S - 1."""
    rows = params.dec_pos[pos:pos + tokens.shape[1]]
    return embed(ctx, params.embed, tokens) + rows[None]


def forward(cfg, params: EncDecLM, batch, remat=None,
            ctx=NO_MESH) -> torch.Tensor:
    """The training forward: ``audio_embeds`` and ``tokens`` -> logits (B,
    S, V); each decoder layer checkpointed by ``remat`` (default
    ``cfg.sharding.remat``) where autograd records."""
    policy = remat if remat is not None else cfg.sharding.remat
    enc_out = encode(cfg, params, batch["audio_embeds"], ctx)
    tokens = batch["tokens"]
    x = ctx.act_btd(_embed(params, tokens, ctx=ctx))
    for bp in params.blocks:
        # learned positions, no RoPE: the attention takes no positions
        x = _maybe_remat(functools.partial(_dec_block, cfg, bp, ctx=ctx),
                         policy)(x, None, enc_out)
    x = apply_norm(cfg, x, params.final_norm)
    return x @ ctx.unshard_fsdp(params.head_w)


def loss_fn(cfg, params: EncDecLM, batch, remat=None,
            ctx=NO_MESH) -> torch.Tensor:
    """``transformer.cross_entropy`` of the forward's logits and
    ``batch["labels"]``."""
    return cross_entropy(forward(cfg, params, batch, remat, ctx),
                         batch["labels"], ctx)


def init_decode_state(cfg, batch: int, max_len: int, dtype=None,
                      device=None) -> State:
    """Zero self-attention caches (L, batch, max_len, Hkv, dh) and zero
    cross-attention K / V (L, batch, enc_seq, Hkv, dh) in ``dtype``
    (default: the config's)."""
    dtype = _torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {name: torch.zeros((L, batch, n, Hkv, dh), dtype=dtype,
                              device=dev)
            for name, n in (("k", max_len), ("v", max_len),
                            ("ek", cfg.enc_seq), ("ev", cfg.enc_seq))}


def decode_step(cfg, params: EncDecLM, state: State, batch, ctx=NO_MESH):
    """One-token decode against the self-attention caches and the cached
    cross K / V.  batch: ``{"tokens": (B, 1), "pos": int}`` (the write
    index).  Returns (logits (B, V), state), the caches written in
    place."""
    pos = int(batch["pos"])
    x = _embed(params, batch["tokens"], pos, ctx)
    for layer, bp in enumerate(params.blocks):
        bp = gathered(ctx, bp)
        h = apply_norm(cfg, x, bp.ln)
        x = x + attn.decode_attention_block(cfg, bp.attn, h,
                                            state["k"][layer],
                                            state["v"][layer], pos, ctx)
        h = apply_norm(cfg, x, bp.ln_x)
        x = x + attn.cross_attention_block(cfg, bp.xattn, h,
                                           state["ek"][layer],
                                           state["ev"][layer], ctx)
        x = x + _ffn(bp, apply_norm(cfg, x, bp.ln2))
    x = apply_norm(cfg, x, params.final_norm)
    return decode_logits(ctx, (x @ ctx.unshard_fsdp(params.head_w))[:, 0]), \
        state
