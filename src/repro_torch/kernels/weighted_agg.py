"""Reputation-weighted aggregation, paper Eq. 1:

    out[p] = sum_n s[n] * w[n, p] / max(sum_n s[n], 1e-12)

over a stacked ``(n, P)`` float32 or bfloat16 tensor of trainer models and
``(n,)`` scores, accumulated in float32 and returned in the input's dtype.
The FL path hands it the whole parameter tree flattened to one ``(n, P)``
tensor (``core/aggregation.tree_flat_stacked``): columns are independent,
so one launch per round gives what one launch per leaf would.  The
cross-task megastep hands it T such stacks at once, ``(T, n, P)`` with
``(T, n)`` scores -> ``(T, P)``: row t is bit-identical to the call on
task t alone.

Kernel (``weighted_agg_kernel`` in ``csrc/fl.cu``): replaces the Pallas
``_kernel`` of ``src/repro/kernels/weighted_agg.py:22`` (called through
``weighted_agg``, ``pallas_call`` at ``:42``).  Bound: the bytes moved,
(n·P + P) elements plus 4·n bytes of scores, over the card's memory rate;
2·n·P float operations are far below the compute rate.  What holds a read
of 0.6 MB (one task of the FL path) to 270 MB (1M wide) at that rate is
the bytes in flight on every SM, so:

* the sum order is fixed by n alone: the rows split into ``ROW_GROUPS``
  contiguous groups of ceil(n / ``ROW_GROUPS``) rows, each summed in
  increasing row from 0, every product and sum rounded on its own; the
  group sums added in group order from 0 (``weighted_agg_mirror`` spells
  it out, bit for bit);
* a block owns ``tile(dtype)`` columns of one task (``TILE_BYTES``, 512
  bytes of each row, fixed when the kernel is compiled), a warp a row
  group, so a task of 2,410 float32 columns spreads over 19 blocks and the
  default path's 32 tasks over 608; the tile changes no sum;
* each warp stages its rows by 1-D bulk copies of their 16-byte covers
  (every other row of the FL path starts 8 bytes off the 16-byte grid),
  all of a group of up to 8 rows at once, longer groups through a ring of
  two stages; the scores load while the copies are in flight.

Rows may be strided (a view of rows at any offset): only the last axis
must be contiguous.  The TPU wrapper padded P to its tile; the kernel
masks the ragged tile instead, so no padded copy is made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import check_cuda

#: dtype flags of the launchers in csrc/fl.cu
DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}
ROW_GROUPS = 8                      # R: row groups, a warp each (kGroups)
DENOM_LANES = 32                    # lanes summing the scores
TILE_BYTES = 512                    # a row's span in a block (kAggTileBytes)


def weighted_agg_torch(stacked: torch.Tensor,
                       scores: torch.Tensor) -> torch.Tensor:
    """Plain version: (n, P), (n,) -> (P,), or (T, n, P), (T, n) -> (T, P),
    in ``stacked``'s dtype."""
    s = scores.to(torch.float32)
    denom = torch.clamp(s.sum(-1), min=1e-12)
    return ((stacked.to(torch.float32) * s[..., None]).sum(-2)
            / denom[..., None]).to(stacked.dtype)


def tile(dtype: torch.dtype) -> int:
    """Columns a block of the kernel owns: ``TILE_BYTES`` of a row, at
    every shape (the kernel's compile-time width).  The sums do not
    depend on it.  Timed on an H100 at 128 to 1,024 bytes at the default
    FL path's (32, 64, 2,410), the stepped path's (64, 2,410) and
    (64, 1M), 512 was the fastest or within 1 % of it at each."""
    return TILE_BYTES // dtype.itemsize


def _rounded_sums(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis -2 in increasing index from 0, one rounding a sum."""
    acc = torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=x.dtype)
    for i in range(x.shape[-2]):
        acc = acc + x[..., i, :]
    return acc


def weighted_agg_mirror(stacked: torch.Tensor,
                        scores: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch on the CPU, order for order:
    float32 products; ``ROW_GROUPS`` groups of ceil(n / ROW_GROUPS) rows,
    each summed in increasing row from 0; the group sums added in group
    order from 0; the denominator as ``DENOM_LANES`` lane sums (lane j:
    s[j], s[j + 32], ...) and the halving tree of the shuffles, clamped to
    1e-12; one division, then the input's dtype.  Bit-equal to the kernel
    whatever T, P, the tile or the rows' addresses."""
    w = stacked.cpu().to(torch.float32)
    s = scores.cpu().to(torch.float32)
    n = w.shape[-2]
    prods = s[..., None] * w
    group = -(-n // ROW_GROUPS)
    total = torch.zeros(w.shape[:-2] + w.shape[-1:])
    for r in range(ROW_GROUPS):
        lo, hi = min(n, r * group), min(n, (r + 1) * group)
        total = total + _rounded_sums(prods[..., lo:hi, :])
    pad = (-n) % DENOM_LANES
    lanes = _rounded_sums(torch.nn.functional.pad(s, (0, pad)).reshape(
        s.shape[:-1] + (-1, DENOM_LANES)))
    while lanes.shape[-1] > 1:
        h = lanes.shape[-1] // 2
        lanes = lanes[..., :h] + lanes[..., h:]
    denom = torch.clamp(lanes[..., 0], min=1e-12)
    return (total / denom[..., None]).to(stacked.dtype)


def weighted_agg(stacked: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Eq. 1 average of the rows of ``stacked`` weighted by ``scores``:
    (n, P), (n,) -> (P,), or T tasks at once, (T, n, P), (T, n) -> (T, P).
    The plain version for a CPU tensor, the CUDA kernel (one launch) for a
    CUDA tensor."""
    if stacked.dim() not in (2, 3) or scores.shape != stacked.shape[:-1]:
        raise ValueError(f"weighted_agg takes (n, P) and (n,), or (T, n, P) "
                         f"and (T, n), got {tuple(stacked.shape)} and "
                         f"{tuple(scores.shape)}")
    if stacked.device.type == "cpu":
        return weighted_agg_torch(stacked, scores)
    check_cuda(stacked, scores)
    if stacked.dtype not in DTYPE_FLAG:
        raise TypeError(f"weighted_agg takes float32 or bfloat16, got "
                        f"{stacked.dtype}")
    T = stacked.shape[0] if stacked.dim() == 3 else 1
    n, P = stacked.shape[-2:]
    if not P or not T:
        return torch.empty(stacked.shape[:-2] + (P,), dtype=stacked.dtype,
                           device=stacked.device)
    # rows are taken as they lie where the last axis is contiguous
    w = stacked if stacked.stride(-1) == 1 else stacked.contiguous()
    s = scores.to(torch.float32).contiguous()
    out = torch.empty(w.shape[:-2] + (P,), dtype=w.dtype, device=w.device)
    _build.launch("fl_weighted_agg", w.device, w.data_ptr(), s.data_ptr(), T,
                  n, P, w.stride(0) if w.dim() == 3 else 0, w.stride(-2),
                  DTYPE_FLAG[w.dtype], out.data_ptr())
    weighted_agg.launches += 1
    return out


weighted_agg.launches = 0
