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
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.factory import get_kernel
from repro_torch.models.layers import dense_init, layer_norm

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


def mlstm_block(cfg, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None):
    """The mLSTM residual block: x (B, S, d) -> (delta, new state or
    None)."""
    B, S, d = x.shape
    di = int(d * cfg.mlstm_proj_factor)
    nh = cfg.n_heads
    h = layer_norm(x, p["ln"])
    u, z = (h @ p["up_proj"]).chunk(2, dim=-1)
    st = state if state is not None else init_mlstm_state(cfg, B, x.device)
    y, new_state = mlstm_mix(p, h, u, st)
    # per-head group norm, then the output gate
    y = layer_norm(y.reshape(B, S, nh, di // nh),
                   p["gn"].reshape(nh, di // nh)).reshape(B, S, di)
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


def slstm_block(cfg, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None):
    """The sLSTM residual block: x (B, S, d) -> (delta, new state or
    None); delta = y + ffn(ln2(x + y))."""
    B = x.shape[0]
    h = layer_norm(x, p["ln"])
    wx = h @ p["w_gates"] + p["b_gates"]
    st = state if state is not None else init_slstm_state(cfg, B, x.device)
    y, (hN, cN, nN, mN) = get_kernel("slstm_scan")(
        wx, p["r_gates"], st["h"], st["c"], st["nn"], st["mm"])
    y = y.to(x.dtype)
    hf = layer_norm(x + y, p["ln2"])
    delta = y + F.gelu(hf @ p["ff_up"], approximate="tanh") @ p["ff_down"]
    new_state = {"h": hN, "c": cN, "nn": nN, "mm": mN}
    return delta, (new_state if state is not None else None)
