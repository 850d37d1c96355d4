"""The Mamba (selective SSM) block, jamba's recurrent token mixer, in the
JAX package's layouts and casts (``src/repro/models/mamba.py``).

  * ``_causal_conv``: the depthwise causal conv1d of kernel ``d_conv``,
    plain PyTorch as in the JAX package: the k shifted products summed in
    float32 in order, then ``conv_b``, then silu, in x's dtype; the new
    conv state is the padded input's last k - 1 rows.
  * ``mamba_mix``: the mixer's products (``x_dt`` then ``dt_proj``, ``x_B``,
    ``x_C``) in float32 ``torch.matmul``, as the JAX package computes them
    outside any kernel, then the factory's ``ssm_scan`` op (the CUDA
    kernel on the card) for every S, decode's S = 1 included.
  * ``mamba_block``: in_proj, split into the stream and the gate z, the
    conv, the mix, the gate y ⊙ silu(z) in the model's dtype, out_proj.

``A_log`` and ``D`` are float32 in every model dtype, as in the JAX
package.  A block returns its residual delta (the caller adds x) and,
given a state ``{"conv": (B, k - 1, di) in the model's dtype, "ssm": (B,
di, ds) float32}``, the new state; with ``state=None`` (forward, prefill)
it starts from zeros and returns ``None``.

The conv and the ``ssm_scan`` kernel each run in a ``ctx.local`` region
(``sharding.specs.MeshCtx``; with the default ``NO_MESH``, on the whole
tensors).  Under a mesh the products are DTensor ops, the stream is
constrained to channels over ``model`` (the JAX package's constraint),
and each region takes the rank's batch rows and channels (its
``A_log``, ``D``, ``dt_bias`` and conv rows; ``Bm`` and ``Cm`` whole).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.factory import get_kernel
from repro_torch.models.layers import dense_init
from repro_torch.sharding.specs import NO_MESH, P

Params = Mapping[str, torch.Tensor]


def dt_rank(cfg) -> int:
    return max(1, (cfg.d_model * cfg.mamba_expand) // 16)


def init_mamba_params(cfg, dtype: torch.dtype,
                      generator: torch.Generator | None,
                      device) -> Dict[str, torch.Tensor]:
    """Projections from ``dense_init`` (uninitialised with no generator),
    ``conv_b`` and ``dt_bias`` zeros; ``A_log`` the S4D-real log(1 .. ds)
    on every channel and ``D`` ones, both float32."""
    d = cfg.d_model
    di = d * cfg.mamba_expand
    ds = cfg.mamba_d_state
    r = dt_rank(cfg)

    def dense(shape):
        return dense_init(shape, dtype, generator, device)

    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, ds + 1, **f32)).expand(di, ds)
    return {"in_proj": dense((d, 2 * di)),
            "conv_w": dense((di, cfg.mamba_d_conv)),
            "conv_b": torch.zeros(di, dtype=dtype, device=device),
            "x_dt": dense((di, r)), "dt_proj": dense((r, di)),
            "dt_bias": torch.zeros(di, dtype=dtype, device=device),
            "x_B": dense((di, ds)), "x_C": dense((di, ds)),
            "A_log": a_log.contiguous(), "D": torch.ones(di, **f32),
            "out_proj": dense((di, d))}


def init_mamba_state(cfg, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    di = cfg.d_model * cfg.mamba_expand
    return {"conv": torch.zeros(batch, cfg.mamba_d_conv - 1, di, dtype=dtype,
                                device=device),
            "ssm": torch.zeros(batch, di, cfg.mamba_d_state,
                               dtype=torch.float32, device=device)}


def _causal_conv(p: Params, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d of kernel k over x (B, S, di); ``conv_state``
    (B, k - 1, di) is the trailing context for decode.  Returns (y in x's
    dtype, the new state: the padded input's last k - 1 rows)."""
    k = p["conv_w"].shape[-1]
    B, S, di = x.shape
    if conv_state is None:
        pad = torch.zeros(B, k - 1, di, dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], 1)                       # (B, S + k - 1, di)
    w = p["conv_w"].to(torch.float32)                 # (di, k)
    y = xp[:, 0:S].to(torch.float32) * w[:, 0]
    for i in range(1, k):
        y = y + xp[:, i:i + S].to(torch.float32) * w[:, i]
    y = y + p["conv_b"].to(torch.float32)
    new_state = xp[:, S:] if k > 1 else None
    return F.silu(y).to(x.dtype), new_state


def mamba_mix(cfg, p: Params, xz: torch.Tensor,
              state: Optional[torch.Tensor] = None, ctx=NO_MESH):
    """The selective SSM on the post-conv stream xz (B, S, di): returns (y
    (B, S, di) in xz's dtype, the last state (B, di, ds) float32)."""
    x32 = xz.to(torch.float32)
    f32 = {k: p[k].to(torch.float32)
           for k in ("x_dt", "dt_proj", "x_B", "x_C")}
    B, S, di = xz.shape
    rows, ch = _specs(ctx, B, di)
    # the products over the channels are partial sums over "model":
    # reduced (and their gradients taken) whole, then dt_pre split again
    whole = P(rows, None, None)
    dt_pre = ctx.constrain(ctx.constrain(x32 @ f32["x_dt"], whole)
                           @ f32["dt_proj"], P(rows, None, ch))
    Bm = ctx.constrain(x32 @ f32["x_B"], whole)
    Cm = ctx.constrain(x32 @ f32["x_C"], whole)
    args = (xz, dt_pre, p["dt_bias"], Bm, Cm, p["A_log"], p["D"], state)
    return ctx.local(
        lambda *a: get_kernel("ssm_scan")(*a),
        (P(rows, None, ch), P(rows, None, ch), P(ch), P(rows, None, None),
         P(rows, None, None), P(ch, None), P(ch), P(rows, ch, None)),
        (P(rows, None, ch), P(rows, ch, None)))(*args)


def _specs(ctx, B: int, di: int):
    """(the batch rows' entry, the channels' entry) of a rank's shard."""
    s = ctx.fit(P(ctx.dp_axes or None, ctx.tp_axis), (B, di))
    return s[0], s[1]


def _conv(ctx, p: Params, xs, conv_state):
    B, _, di = xs.shape
    rows, ch = _specs(ctx, B, di)
    act = P(rows, None, ch)
    return ctx.local(
        lambda x, w, b, st: _causal_conv({"conv_w": w, "conv_b": b}, x, st),
        (act, P(ch, None), P(ch), act), (act, act))(
        xs, p["conv_w"], p["conv_b"], conv_state)


def mamba_block(cfg, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                ctx=NO_MESH):
    """The whole Mamba block, x (B, S, d) -> (delta (B, S, d), new state or
    None)."""
    xs, z = ctx.split_product(x, p["in_proj"], 2)
    xs = ctx.constrain(xs, P(ctx.dp_axes or None, None, ctx.tp_axis))
    xs, new_conv = _conv(ctx, p, xs, None if state is None
                         else state["conv"])
    y, new_ssm = mamba_mix(cfg, p, xs, None if state is None
                           else state["ssm"], ctx)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    if state is None:
        return out, None
    return out, {"conv": new_conv.to(state["conv"].dtype), "ssm": new_ssm}

