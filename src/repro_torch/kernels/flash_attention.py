"""Causal or non-causal attention with grouped-query heads (the prefill's
attention):

    q (B, S, H, dh), k and v (B, S, Hkv, dh)  ->  (B, S, H, dh) in q's dtype

Query head h reads kv head ``h // (H // Hkv)``.  Scores are float32,
scaled by ``dh ** -0.5``; masked scores (causal: key after query) are set
to -1e30 before the softmax; float32 or bfloat16 in, any S.

Kernel: replaces the Pallas ``_kernel`` of
``src/repro/kernels/flash_attention.py:25`` (``pallas_call`` at ``:87``),
which asserts ``S % block_q == 0``; the CUDA kernels (``csrc/attn.cu``)
mask the tails of their tiles instead.  Bound: operations, 4·B·H·S²·dh
(halved when causal), against the bytes of q, k, v and the output.  Two
forms, chosen by ``form`` from the dtype and dh:

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
place, with no repeat.  Neither has a backward: training through attention
is ROADMAP.md queue 1 item 10(d), and a backward through the kernel
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
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


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain version (``ref.flash_attention_ref``'s semantics): kv heads
    repeated, float32 scores over the whole (S, S), mask, softmax, cast."""
    _check_shapes(q, k, v)
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor (no backward through the kernel)."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    return _KernelAttention.apply(q, k, v, causal)


flash_attention.launches = 0
flash_attention.last_form = None    # the form of the latest launch
flash_attention.form_launches = {}  # launches by form

# the forms, as csrc/attn.cu's launcher numbers them
FORMS = {"simt": 0, "wgmma": 1}


def form(dtype: torch.dtype, dh: int) -> str:
    """The kernel's form for a launch: ``wgmma`` for bfloat16 at head
    width 64 or 128, ``simt`` otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and dh in (64, 128) else "simt"


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention takes q (B, S, H, dh) and k, v "
                         f"(B, S, Hkv, dh) with H a multiple of Hkv, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    dev = check_cuda(q, k, v)
    if q.dtype not in DTYPE_FLAG or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, dh = q.shape
    if dh > MAX_HEAD_DIM or dh % 8:
        raise ValueError(f"the flash_attention kernel takes head widths up "
                         f"to {MAX_HEAD_DIM} that are multiples of 8, got "
                         f"{dh}")
    if B * H > 65535:
        raise ValueError(f"the flash_attention kernel takes B * H <= 65535, "
                         f"got {B} * {H}")
    q, k, v = _on_16_bytes(q), _on_16_bytes(k), _on_16_bytes(v)
    out = torch.empty_like(q)
    if out.numel():
        chosen = form(q.dtype, dh)
        _build.launch("attn_flash_attention", dev, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), B, S, H, k.shape[2], dh,
                      dh ** -0.5, int(causal), DTYPE_FLAG[q.dtype],
                      FORMS[chosen], out.data_ptr())
        flash_attention.launches += 1
        flash_attention.last_form = chosen
        counts = flash_attention.form_launches
        counts[chosen] = counts.get(chosen, 0) + 1
    return out


class _KernelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the flash_attention CUDA kernel has no backward: training "
            "through attention is ROADMAP.md queue 1 item 10(d)")
