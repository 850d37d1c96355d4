"""Causal or non-causal attention with grouped-query heads (the prefill's
and training's self attention, whisper's encoder and cross attention):

    q (B, Sq, H, dh), k and v (B, Skv, Hkv, dh)  ->  (B, Sq, H, dh) in
    q's dtype

Query head h reads kv head ``h // (H // Hkv)``.  Scores are float32,
scaled by ``dh ** -0.5``; masked scores (causal: key after query) are set
to -1e30 before the softmax; float32 or bfloat16 in, any Sq and Skv.  Sq
and Skv differ only where the attention is not causal (cross attention:
the decoder's tokens against the encoder's frames, the decode step's one
token among them); a causal call with Sq != Skv raises.

Kernel: replaces the Pallas ``_kernel`` of
``src/repro/kernels/flash_attention.py:25`` (``pallas_call`` at ``:87``),
which asserts ``S % block_q == 0``; the CUDA kernels (``csrc/attn.cu``)
mask the tails of their tiles instead (query rows past Sq, keys past
Skv).  Bound: operations, 4·B·H·Sq·Skv·dh (halved when causal), against
the bytes of q, k, v and the output.  Two forms, chosen by ``form`` from
the dtype and dh:

  * ``wgmma`` (bfloat16, dh 64 or 128: the serving paths): a block owns
    128 query rows of one (batch, head); a producer warpgroup streams K
    and V tiles of 64 keys by TMA through a 4-stage ring, read in place
    from the kv head; two consumer warpgroups, taking turns, compute S =
    Q·Kᵀ with ``wgmma`` into float32, the online softmax in registers, and
    P·V as two bf16 ``wgmma``s on P's high and low bfloat16 halves (P keeps
    about 16 bits, as the Pallas kernel keeps p in float32).
  * ``simt`` (float32, other head widths up to 128, multiples of 8): one
    block per 64-row query tile, float32 on the CUDA cores.

Both skip the causal tiles past the diagonal and read the kv head in
place, with no repeat.  Where autograd records (``q``, ``k`` or ``v``
requires grad), the forward also writes each row's logsumexp (B, H, Sq)
float32, and the backward is ``flash_attention_bwd``: the kernels of
``csrc/attn_bwd.cu`` (a rows pass, D = rowsum(dO o); a dQ pass over the
key tiles; a dK/dV pass over the query tiles and the group's heads; no
atomics, so two runs give the same bits), in the forward's two forms:

  * ``wgmma`` (bfloat16, dh 64 or 128: the training shapes): a producer
    streams 64-row Q/dO or K/V tiles by TMA through a 4-stage ring; each
    consumer warpgroup owns 64 keys (dK/dV) or 64 query rows (dQ), runs
    the score products Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (or S, dP) with ``wgmma``
    from shared memory, P and dS in float32 registers, and the
    accumulating products with P or dS from registers, each in the
    forward's two bfloat16 pieces (its rounding and the rounding of what
    that left).
  * ``simt`` (float32, other head widths): float32 on the CUDA cores.

Serving passes no logsumexp and launches as before.  Each wrapper counts
its launches (``launches``), by form (``form_launches``) and by ``kind``
(``kind_launches``: ``causal``, ``square`` or ``cross``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.factory import counted, get_kernel
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG

NEG_INF = -1e30
MAX_HEAD_DIM = 128
# How far the kernel may sit from the plain version.  Both sum in float32
# and round once to the output's dtype.  In float32 the sums run in another
# order; in bfloat16 the two float32 sums may straddle a rounding point:
# one bfloat16 step, at most 2^-7 of the value, plus 1e-4 where the value
# is so small that the float32 order shows.
KERNEL_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
              torch.bfloat16: dict(rtol=2 ** -7, atol=1e-4)}
# How far the backward kernel's dq, dk and dv may sit from
# flash_attention_bwd_torch's: rtol of the value plus ``atol_of_max`` of
# the largest |value| of the three gradients.  Both sum in float32 and
# round once; the sums are of S terms of either sign, and dS = P (dP - D)
# cancels (wholly at S = 1, where o = v and dq, dk are float32 noise on
# both sides), so a float32 order shows at the scale of the summed terms,
# which the largest gradient stands for, not at each value's; in bfloat16
# the two float32 sums may also straddle one rounding point (2^-7 of the
# value).
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol_of_max=1e-5),
           torch.bfloat16: dict(rtol=2 ** -7, atol_of_max=2 ** -9)}


def bwd_close(got, want) -> bool:
    """The gradients ``got`` (dq, dk, dv) within ``BWD_TOL`` of
    ``want``."""
    tol = BWD_TOL[want[0].dtype]
    top = max((float(w.abs().max()) for w in want if w.numel()), default=0.)
    return all(g.shape == w.shape and bool(
        ((g.float() - w.float()).abs()
         <= tol["rtol"] * w.float().abs() + tol["atol_of_max"] * top).all())
        for g, w in zip(got, want))


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> Tuple[float, int]:
    """(FLOPs, bytes) of the attention: the two products, 4·B·H·Sq·Skv·dh
    (halved when causal: the tiles past the diagonal are skipped); q, k,
    v read once and the output written once (q and the output at Sq, k
    and v at Skv)."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    flops = 4 * B * H * Sq * Skv * dh / (2 if causal else 1)
    n_bytes = q.element_size() * (2 * B * Sq * H * dh
                                  + 2 * B * Skv * k.shape[2] * dh)
    return flops, n_bytes


@counted("flash_attention")
def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain version (``ref.flash_attention_ref``'s semantics): kv heads
    repeated, float32 scores over the whole (Sq, Skv), mask, softmax,
    cast."""
    _check_shapes(q, k, v, causal)
    S, dh = q.shape[1], q.shape[3]
    n_rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * dh ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return o.to(q.dtype)


@counted("flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor; its backward the ``flash_attention_bwd`` kernel."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu" and not _build.is_fake(q):
        return flash_attention_torch(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _KernelAttention.apply(q, k, v, causal)[0]
    return _launch(q, k, v, causal)[0]


def flash_attention_bwd_cost(q, k, v, o, lse, do,
                             causal: bool = True) -> Tuple[float, int]:
    """(FLOPs, bytes) of the attention's gradient: the five products (QKᵀ
    recomputed, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K), 10·B·H·Sq·Skv·dh (halved
    when causal); q, k, v, o, dO and the logsumexp read once, dq, dk and
    dv written once (q, o, dO, dq at Sq; k, v, dk, dv at Skv)."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    flops = 10 * B * H * Sq * Skv * dh / (2 if causal else 1)
    n_bytes = q.element_size() * 4 * (B * Sq * H * dh
                                      + B * Skv * k.shape[2] * dh) \
        + 4 * B * H * Sq
    return flops, n_bytes


@counted("flash_attention_bwd")
def flash_attention_bwd_torch(q, k, v, o, lse, do, causal: bool = True):
    """Plain version of the gradient (q, k, v, the forward's output ``o``
    and ``lse``, the output's gradient ``do``) -> (dq, dk, dv) in q's
    dtype: the full (Sq, Skv) float32 scores recomputed, masked and
    softmaxed (``lse`` is the kernel's shortcut to P and is not read
    here), D = rowsum(dO·o) from the saved output as the kernel takes it,
    dS = P (dP - D), and dk, dv summed over each kv head's query heads."""
    _check_shapes(q, k, v, causal)
    B, S, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n_rep, scale = H // Hkv, dh ** -0.5
    f32 = torch.float32
    qf, of, gf = q.to(f32), o.to(f32), do.to(f32)
    kf = k.to(f32).repeat_interleave(n_rep, dim=2)
    vf = v.to(f32).repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * of).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dk = dk.reshape(B, Skv, Hkv, n_rep, dh).sum(3)
    dv = dv.reshape(B, Skv, Hkv, n_rep, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@counted("flash_attention_bwd")
def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """The gradient of ``flash_attention``: the plain version for CPU
    tensors, the ``csrc/attn_bwd.cu`` kernels (one count in ``launches``,
    in the form ``form`` gives) for CUDA tensors."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu" and not _build.is_fake(q):
        return flash_attention_bwd_torch(q, k, v, o, lse, do, causal)
    return _launch_bwd(q, k, v, o, lse, do, causal)


flash_attention_bwd.launches = 0
flash_attention_bwd.last_form = None    # the form of the latest launch
flash_attention_bwd.form_launches = {}  # launches by form
flash_attention_bwd.kind_launches = {}  # launches by kind


flash_attention.launches = 0
flash_attention.last_form = None    # the form of the latest launch
flash_attention.form_launches = {}  # launches by form
flash_attention.kind_launches = {}  # launches by kind

# the forms, as csrc/attn.cu's and csrc/attn_bwd.cu's launchers number them
FORMS = {"simt": 0, "wgmma": 1}


def form(dtype: torch.dtype, dh: int) -> str:
    """The form of a launch of either kernel, forward or backward:
    ``wgmma`` for bfloat16 at head width 64 or 128, ``simt`` otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and dh in (64, 128) else "simt"


def kind(Sq: int, Skv: int, causal: bool) -> str:
    """What a launch attends: ``causal`` (self attention, Sq == Skv),
    ``square`` (not causal, Sq == Skv: whisper's encoder) or ``cross``
    (Sq != Skv: whisper's cross attention)."""
    if causal:
        return "causal"
    return "square" if Sq == Skv else "cross"


def bwd_rows(S: int, chosen: str) -> int:
    """The rows a (b, h) takes in the backward's scratch (S the query
    rows, Sq): S for ``simt``, S rounded up to 128 for ``wgmma`` (whose
    tiles bulk-copy the rows' lse and D 64 or 128 at a time)."""
    return -(-S // 128) * 128 if chosen == "wgmma" else S


def _count(wrapper, chosen: str, what: str) -> None:
    wrapper.launches += 1
    wrapper.last_form = chosen
    wrapper.form_launches[chosen] = wrapper.form_launches.get(chosen, 0) + 1
    wrapper.kind_launches[what] = wrapper.kind_launches.get(what, 0) + 1


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention takes q (B, Sq, H, dh) and k, v "
                         f"(B, Skv, Hkv, dh) with H a multiple of Hkv, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if causal and k.shape[1] != q.shape[1]:
        raise ValueError(f"causal flash_attention takes Sq == Skv (no mask "
                         f"convention for Sq != Skv), got Sq {q.shape[1]}, "
                         f"Skv {k.shape[1]}")


def _on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if _build.is_fake(t):                   # no address: taken as aligned
        return t
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_launch(q, k, v, what: str) -> torch.device:
    dev = check_cuda(q, k, v)
    if q.dtype not in DTYPE_FLAG or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, dh = q.shape
    if dh > MAX_HEAD_DIM or dh % 8:
        raise ValueError(f"the {what} kernel takes head widths up to "
                         f"{MAX_HEAD_DIM} that are multiples of 8, got {dh}")
    if B * H > 65535:
        raise ValueError(f"the {what} kernel takes B * H <= 65535, got {B} "
                         f"* {H}")
    return dev


def _launch(q, k, v, causal: bool, lse: bool = False):
    """(output, the rows' logsumexp (B, H, Sq) float32 or None); on fake
    tensors the same allocations and no launch."""
    fake = _build.is_fake(q)
    dev = _check_launch(q, k, v, "flash_attention")
    _check_shapes(q, k, v, causal)
    B, S, H, dh = q.shape
    q, k, v = _on_16_bytes(q), _on_16_bytes(k), _on_16_bytes(v)
    out = torch.empty_like(q)
    rows = torch.empty(B, H, S, dtype=torch.float32, device=dev) \
        if lse else None
    if out.numel() and not fake:
        chosen = form(q.dtype, dh)
        _build.launch("attn_flash_attention", dev, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), B, S, k.shape[1], H,
                      k.shape[2], dh, dh ** -0.5, int(causal),
                      DTYPE_FLAG[q.dtype], FORMS[chosen], out.data_ptr(),
                      rows.data_ptr() if lse else None)
        _count(flash_attention, chosen, kind(S, k.shape[1], causal))
    return out, rows


def _launch_bwd(q, k, v, o, lse, do, causal: bool):
    fake = _build.is_fake(q)
    dev = _check_launch(q, k, v, "flash_attention_bwd")
    _check_shapes(q, k, v, causal)
    B, S, H, dh = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd takes o and do shaped as q "
                         f"{tuple(q.shape)} and lse (B, H, Sq) float32, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{tuple(lse.shape)} {lse.dtype}")
    q, k, v, o = (_on_16_bytes(t) for t in (q, k, v, o))
    do, lse = _on_16_bytes(do.to(q.dtype)), lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel():
        chosen = form(q.dtype, dh)
        # each row's D, and the wgmma form's base-2 logsumexp
        rows = torch.empty(2, B, H, bwd_rows(S, chosen), dtype=torch.float32,
                           device=dev)
        if fake:
            return dq, dk, dv
        _build.launch("attn_flash_attention_bwd", dev, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), B, S, k.shape[1], H,
                      k.shape[2], dh, dh ** -0.5, int(causal),
                      DTYPE_FLAG[q.dtype], FORMS[chosen], rows.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        _count(flash_attention_bwd, chosen, kind(S, k.shape[1], causal))
    return dq, dk, dv


class _KernelAttention(torch.autograd.Function):
    """The forward kernel with its logsumexp, and the backward kernel."""

    @staticmethod
    def forward(q, k, v, causal):
        return _launch(q, k, v, causal, lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        out, lse = output
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)

    @staticmethod
    def backward(ctx, grad, _grad_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = get_kernel("flash_attention_bwd")(q, k, v, out, lse,
                                                       grad, ctx.causal)
        return dq, dk, dv, None
