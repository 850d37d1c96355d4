"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, strictly sequential), in the JAX package's layouts and
casts.

  * mLSTM is plain PyTorch, as the JAX package computes it outside any
    Pallas kernel: the stabilised exponential-gate chunkwise form (chunks
    of 256; one chunk of the whole sequence where S is not a multiple of
    256), a running per-head max stabiliser carried across chunks, and an
    O(1) single-token step for decode.  The ``-1e30`` initial stabiliser,
    the ``-inf`` causal mask and the ``max(|den|, exp(-m))`` guard (where
    ``exp`` overflows to ``inf`` and the output to 0) are the JAX
    package's.
  * sLSTM's time scan goes through the factory's ``slstm_scan`` op (the
    CUDA kernel on the card) for every S, decode's S = 1 included; its
    post-FFN (tanh GELU) follows.  The plain recurrent step, the JAX
    package's ``xlstm._slstm_cell``, is ``kernels.slstm_scan.slstm_cell``
    (the op's plain version loops it).

Each block returns a residual delta (the caller adds x) and, given a
state, the new state; with ``state=None`` (forward, prefill) it starts
from the initial state and returns ``None``.

The mLSTM's mix and the ``slstm_scan`` kernel each run in a
``ctx.local`` region (``sharding.specs.MeshCtx``; with the default
``NO_MESH``, on the whole tensors).  Under a mesh the projections and
norms are DTensor ops, and each region takes the rank's batch rows and
heads (the heads over ``model`` where they divide evenly, else every
head on every rank of it).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.factory import get_kernel
from repro_torch.models.layers import dense_init, layer_norm
from repro_torch.sharding.specs import NO_MESH, P

NEG_INIT = -1e30
Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm_params(cfg, dtype: torch.dtype,
                      generator: torch.Generator | None,
                      device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di = int(d * cfg.mlstm_proj_factor)
    nh = cfg.n_heads
    dh = di // nh

    def dense(shape):
        return dense_init(shape, dtype, generator, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {"ln": full((d,), 1.0), "up_proj": dense((d, 2 * di)),
            "m_wq": dense((nh, dh, dh)), "m_wk": dense((nh, dh, dh)),
            "m_wv": dense((nh, dh, dh)), "w_ig": dense((d, nh)),
            "w_fg": dense((d, nh)), "b_ig": full((nh,), 0.0),
            "b_fg": full((nh,), 3.0), "w_og": dense((d, di)),
            "gn": full((di,), 1.0), "down_proj": dense((di, d))}


def init_mlstm_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    di = int(cfg.d_model * cfg.mlstm_proj_factor)
    nh = cfg.n_heads
    dh = di // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(batch, nh, dh, dh, **f32),
            "n": torch.zeros(batch, nh, dh, **f32),
            "m": torch.full((batch, nh), NEG_INIT, **f32)}


def _mlstm_qkv(p: Params, xs: torch.Tensor, nh: int, dh: int):
    B, S, _ = xs.shape
    xh = xs.reshape(B, S, nh, dh)
    q = torch.einsum("bshd,hde->bshe", xh, p["m_wq"])
    k = torch.einsum("bshd,hde->bshe", xh, p["m_wk"]) * dh ** -0.5
    v = torch.einsum("bshd,hde->bshe", xh, p["m_wv"])
    return q, k, v


def mlstm_mix(p: Params, x: torch.Tensor, xs: torch.Tensor,
              state: Dict[str, torch.Tensor], chunk: int = 256):
    """x: (B, S, d) block input (drives the gates); xs: (B, S, di) the
    up-projected stream.  Returns (y (B, S, di), new state)."""
    B, S, di = xs.shape
    nh = p["m_wq"].shape[0]
    dh = di // nh
    q, k, v = _mlstm_qkv(p, xs, nh, dh)
    f32 = torch.float32
    x32 = x.to(f32)
    ig = x32 @ p["w_ig"].to(f32) + p["b_ig"].to(f32)             # (B,S,nh)
    fg = x32 @ p["w_fg"].to(f32) + p["b_fg"].to(f32)
    logf = F.logsigmoid(fg)

    if S == 1:
        return _mlstm_step(q, k, v, ig, fg, state)
    if S % chunk:
        chunk = S
    C, n, m = state["C"], state["n"], state["m"]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        qb, kb, vb = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        igb = ig[:, sl]
        F_ = torch.cumsum(logf[:, sl], dim=1)                     # (B,c,nh)
        Ftot = F_[:, -1]
        log_inter = m[:, None] + F_
        dmat = F_[:, :, None] - F_[:, None, :] + igb[:, None, :]  # (B,t,u,nh)
        dmat = torch.where(tri[None, :, :, None], dmat, -torch.inf)
        m_intra = dmat.amax(dim=2)
        m_new_t = torch.maximum(log_inter, m_intra)
        inter_w = torch.exp(log_inter - m_new_t)
        intra_w = torch.exp(dmat - m_new_t[:, :, None])
        scores = torch.einsum("bthd,buhd->btuh", qb, kb)
        num_intra = torch.einsum("btuh,buhd->bthd", scores * intra_w, vb)
        den_intra = (scores * intra_w).sum(dim=2)
        qf = qb * inter_w[..., None]
        num_inter = torch.einsum("bthd,bhde->bthe", qf, C)
        den_inter = torch.einsum("bthd,bhd->bth", qf, n)
        num = num_intra + num_inter
        den = torch.abs(den_intra + den_inter)
        ys.append(num / torch.maximum(den, torch.exp(-m_new_t))[..., None])
        m_next = torch.maximum(m + Ftot,
                               (Ftot[:, None] - F_ + igb).amax(dim=1))
        decay = torch.exp(m + Ftot - m_next)                      # (B,nh)
        kv_w = torch.exp(Ftot[:, None] - F_ + igb - m_next[:, None])
        kw = kb * kv_w[..., None]
        C = C * decay[..., None, None] + torch.einsum("buhd,buhe->bhde",
                                                      kw, vb)
        n = n * decay[..., None] + kw.sum(dim=1)
        m = m_next
    y = torch.cat(ys, dim=1).reshape(B, S, di)
    return y.to(xs.dtype), {"C": C, "n": n, "m": m}


def _mlstm_step(q, k, v, ig, fg, state):
    """Single-token decode update."""
    B = q.shape[0]
    f32 = torch.float32
    q1, k1, v1 = q[:, 0].to(f32), k[:, 0].to(f32), v[:, 0].to(f32)
    ig1, logf1 = ig[:, 0], F.logsigmoid(fg[:, 0])                # (B, nh)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf1 + m, ig1)
    fw = torch.exp(logf1 + m - m_new)[..., None, None]
    iw = torch.exp(ig1 - m_new)[..., None, None]
    C = C * fw + iw * torch.einsum("bhd,bhe->bhde", k1, v1)
    n = n * fw[..., 0] + iw[..., 0] * k1
    num = torch.einsum("bhd,bhde->bhe", q1, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q1, n))
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return (y.reshape(B, 1, -1).to(q.dtype),
            {"C": C, "n": n, "m": m_new})


def _heads(ctx, B: int, nh: int):
    """(the batch rows' entry, the heads' entry) of a rank's shard."""
    s = ctx.fit(P(ctx.dp_axes or None, ctx.tp_axis), (B, nh))
    return s[0], s[1]


_MIX = ("m_wq", "m_wk", "m_wv", "w_ig", "w_fg", "b_ig", "b_fg")


def _mlstm_shards(cfg, ctx, p: Params, h, u, state):
    """``mlstm_mix`` on each rank's rows and heads, from the initial state
    where ``state`` is None."""
    B, _, di = u.shape
    nh = cfg.n_heads
    rows, hd = _heads(ctx, B, nh)
    w = P(hd, None, None)
    st = {"C": P(rows, hd, None, None), "n": P(rows, hd, None),
          "m": P(rows, hd)}

    def fn(h, u, wq, wk, wv, wig, wfg, big, bfg, C, n, m):
        pl = dict(zip(_MIX, (wq, wk, wv, wig, wfg, big, bfg)))
        if C is None:
            full = init_mlstm_state(cfg, h.shape[0], h.device)
            k = wq.shape[0]
            C, n, m = (full[name][:, :k] for name in ("C", "n", "m"))
        return mlstm_mix(pl, h, u, {"C": C, "n": n, "m": m})

    ins = (P(rows, None, None), P(rows, None, hd), w, w, w, P(None, hd),
           P(None, hd), P(hd), P(hd), st["C"], st["n"], st["m"])
    s = state or {}
    return ctx.local(fn, ins, (P(rows, None, hd), st))(
        h, u, *(p[k] for k in _MIX), s.get("C"), s.get("n"), s.get("m"))


def mlstm_block(cfg, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                ctx=NO_MESH):
    """The mLSTM residual block: x (B, S, d) -> (delta, new state or
    None)."""
    B, S, d = x.shape
    di = int(d * cfg.mlstm_proj_factor)
    nh = cfg.n_heads
    h = layer_norm(x, p["ln"])
    u, z = ctx.split_product(h, p["up_proj"], 2)
    y, new_state = _mlstm_shards(cfg, ctx, p, h, u, state)
    # per-head group norm, then the output gate
    y = layer_norm(y.reshape(B, S, nh, di // nh),
                   p["gn"].reshape(nh, di // nh)).reshape(B, S, di)
    if nh % ctx.size(ctx.tp_axis):
        # the gradient reaches the heads' reshape whole (a shard would cut
        # a head)
        y = ctx.constrain(y, P(_heads(ctx, B, nh)[0], None, None))
    og = torch.sigmoid(h @ p["w_og"])
    y = y * og * F.silu(z)
    return y @ p["down_proj"], (new_state if state is not None else None)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm_params(cfg, dtype: torch.dtype,
                      generator: torch.Generator | None,
                      device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    dff = int(d * cfg.slstm_proj_factor)
    b_gates = torch.zeros(4 * d, dtype=dtype, device=device)
    b_gates[2 * d:3 * d] = 3.0
    return {"ln": torch.ones(d, dtype=dtype, device=device),
            "w_gates": dense_init((d, 4 * d), dtype, generator, device),
            "r_gates": dense_init((nh, dh, 4 * dh), dtype, generator, device),
            "b_gates": b_gates,
            "ln2": torch.ones(d, dtype=dtype, device=device),
            "ff_up": dense_init((d, dff), dtype, generator, device),
            "ff_down": dense_init((dff, d), dtype, generator, device)}


def init_slstm_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {"h": torch.zeros(batch, d, **f32),
            "c": torch.zeros(batch, d, **f32),
            "nn": torch.zeros(batch, d, **f32),
            "mm": torch.full((batch, d), NEG_INIT, **f32)}


def _slstm_shards(cfg, ctx, wx, r_gates, state):
    """The ``slstm_scan`` kernel on each rank's rows and heads (over
    ``model`` where nh divides evenly): the rank's columns of each of
    wx's four gates and its heads of ``r_gates``."""
    B, _, d4 = wx.shape
    nh = cfg.n_heads
    rows, hd = _heads(ctx, B, nh)
    d = d4 // 4

    def fn(wx, r, h, c, n, m):
        if hd is not None:
            k = ctx.rank(hd)
            nl = r.shape[0] // ctx.size(hd)
            r = r[k * nl:(k + 1) * nl]
            cols = nl * r.shape[1]
            wx = wx.reshape(*wx.shape[:2], 4, d)[..., k * cols:(k + 1) * cols]
            wx = wx.reshape(*wx.shape[:2], 4 * cols)
        if h is None:
            st = init_slstm_state(cfg, wx.shape[0], wx.device)
            cols = wx.shape[-1] // 4
            h, c, n, m = (st[k][:, :cols] for k in ("h", "c", "nn", "mm"))
        y, carry = get_kernel("slstm_scan")(wx, r, h, c, n, m)
        return y, tuple(carry)

    sv = P(rows, hd)
    s = state or {}
    return ctx.local(
        fn, (P(rows, None, None), P(None, None, None), sv, sv, sv, sv),
        (P(rows, None, hd), (sv, sv, sv, sv)))(
        wx, r_gates, s.get("h"), s.get("c"), s.get("nn"), s.get("mm"))


def slstm_block(cfg, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                ctx=NO_MESH):
    """The sLSTM residual block: x (B, S, d) -> (delta, new state or
    None); delta = y + ffn(ln2(x + y))."""
    B = x.shape[0]
    rows = P(_heads(ctx, B, cfg.n_heads)[0], None, None)
    h = layer_norm(x, p["ln"])
    wx = h @ p["w_gates"] + p["b_gates"]
    y, (hN, cN, nN, mN) = _slstm_shards(cfg, ctx, wx, p["r_gates"], state)
    # every head's output on each rank of "model"
    y = ctx.constrain(y.to(x.dtype), rows)
    hf = layer_norm(x + y, p["ln2"])
    # the FFN's partial sums reduced
    ff = ctx.constrain(
        F.gelu(hf @ p["ff_up"], approximate="tanh") @ p["ff_down"], rows)
    delta = y + ff
    new_state = {"h": hN, "c": cN, "nn": nN, "mm": mN}
    return delta, (new_state if state is not None else None)
