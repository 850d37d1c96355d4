"""Per-trainer model distance, paper Eq. 4:

    D[i] = || l[i, :] - g[:] ||_2

over a stacked ``(n, P)`` float32 or bfloat16 tensor of local models and
the ``(P,)`` global model, accumulated in float32; ``(n,)`` float32 out.
The cross-task megastep settles T tasks at once, ``(T, n, P)`` against
``(T, P)`` -> ``(T, n)``: row t is bit-identical to the call on task t
alone, in every version.

Kernel: replaces the Pallas ``_kernel`` of
``src/repro/kernels/model_distance.py:18`` (called through
``model_distance``, ``pallas_call`` at ``:41``).  Bound: the bytes moved,
(T·n·P + T·P) elements read plus 4·T·n bytes written, over the card's
memory rate; 3·n·P float operations are far below the compute rate.  At
the FL path's sizes a launch costs more than its bytes, so the design
(``csrc/fl.cu``) spends one launch on all of a window's tasks and one
short wave of loads on it.  The TPU grid carried each row's sum across
its sequential P axis in the output block; on Hopper the rows and g reach
shared memory by 1-D bulk copies of their 16-byte covers (any alignment),
in one of two forms that ``form(P, dtype)`` picks from the row's length:

* ``row`` (short rows, the FL path's P = 2,410): a warp a row, a few
  rows of one task a block with the task's g staged once;
* ``cluster`` (long rows, the 1M-wide point): a cluster of blocks for
  one to four rows of a task, each block streaming a fixed range of g
  (once) and of the rows through a ring of bulk copies; the blocks'
  partial sums meet in rank 0's shared memory, added in rank order.

In both, thread j of a group of ``lanes`` threads adds the squared
differences of elements k = j, j + lanes, ... in increasing k (each
operation rounded on its own), then a fixed halving tree: the order is
fixed by the element index, so a row gives the same bits at any address,
batched or not.  ``model_distance_mirror`` is that arithmetic in plain
PyTorch, bit for bit.  No atomics.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import check_cuda
from repro_torch.kernels.weighted_agg import DTYPE_FLAG

FORMS = {"row": 0, "cluster": 1}
ROW_LANES = 32                      # row form: threads summing a row
CLUSTER_LANES = 256                 # cluster form: threads summing a block
CLUSTER_WARPS = CLUSTER_LANES // 32
ROW_BYTES_MAX = 24_576              # rows up to this many bytes: row form
CHUNK_BYTES = 8192                  # cluster form: a stage's chunk, kChunkBytes
BLOCK_BYTES = 32_768                # .. about this much of a row a block ..
MAX_CLUSTER = 8                     # .. in at most this many blocks


def model_distance_torch(local: torch.Tensor,
                         global_: torch.Tensor) -> torch.Tensor:
    """Plain version: (n, P), (P,) -> (n,), or (T, n, P), (T, P) -> (T, n),
    float32 L2 distances."""
    d = local.to(torch.float32) - global_.to(torch.float32)[..., None, :]
    return torch.sqrt((d * d).sum(-1))


def form(P: int, dtype: torch.dtype) -> str:
    """The kernel's form for rows of ``P`` elements of ``dtype``: ``row``
    where a row takes at most ``ROW_BYTES_MAX`` bytes (nine of them fit a
    block's shared memory), ``cluster`` above.  Decided by P and the dtype
    alone, never by n or T (so a batched launch sums as the unbatched one
    does) and never after a failure."""
    return "row" if P * _itemsize(dtype) <= ROW_BYTES_MAX else "cluster"


def cluster_span(P: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The cluster form's (blocks a row, elements a block): about
    ``BLOCK_BYTES`` of the row a block, 2 to ``MAX_CLUSTER`` blocks, each
    block's range a whole number of chunks."""
    size = _itemsize(dtype)
    blocks = min(MAX_CLUSTER, max(2, -(-P * size // BLOCK_BYTES)))
    chunk = CHUNK_BYTES // size
    span = -(-(-(-P // blocks)) // chunk) * chunk
    return blocks, span


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _lane_sums(sq: torch.Tensor, lanes: int) -> torch.Tensor:
    """(..., L) -> (..., lanes): lane j's running sum of the elements
    k = j (mod lanes), in increasing k (zero padding adds nothing)."""
    pad = (-sq.shape[-1]) % lanes
    x = torch.nn.functional.pad(sq, (0, pad)).reshape(
        sq.shape[:-1] + (-1, lanes))
    acc = torch.zeros(sq.shape[:-1] + (lanes,), dtype=sq.dtype,
                      device=sq.device)
    for m in range(x.shape[-2]):
        acc = acc + x[..., m, :]
    return acc


def _halve(v: torch.Tensor) -> torch.Tensor:
    """The shuffle tree over the last axis (a power of two): element j
    adds element j + h, for h = width / 2, ..., 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (``__fsqrt_rn``): taken
    in float64 and rounded once more, which is exact for a float32 input,
    where torch's float32 CPU square root may miss by an ulp."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def model_distance_mirror(local: torch.Tensor,
                          global_: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, order for order, in the
    form ``form`` names: bit-equal to the kernel (float32 differences,
    products and sums each rounded once; the IEEE square root)."""
    d = local.to(torch.float32) - global_.to(torch.float32)[..., None, :]
    sq = d * d
    P = sq.shape[-1]
    if form(P, local.dtype) == "row":
        return _sqrt(_halve(_lane_sums(sq, ROW_LANES)))
    blocks, span = cluster_span(P, local.dtype)
    total = None
    for r in range(blocks):
        lanes = _lane_sums(sq[..., r * span:(r + 1) * span], CLUSTER_LANES)
        part = _halve(_halve(lanes.reshape(lanes.shape[:-1]
                                           + (CLUSTER_WARPS, 32))))
        total = part if total is None else total + part
    return _sqrt(total)


def _check(local: torch.Tensor, global_: torch.Tensor) -> None:
    if local.dim() not in (2, 3) or \
            global_.shape != local.shape[:-2] + local.shape[-1:]:
        raise ValueError(f"model_distance takes (n, P) and (P,), or "
                         f"(T, n, P) and (T, P), got {tuple(local.shape)} "
                         f"and {tuple(global_.shape)}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with contiguous rows (a view where they already are)."""
    return t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


def model_distance(local: torch.Tensor,
                   global_: torch.Tensor) -> torch.Tensor:
    """Distances of the rows of ``local`` from ``global_``: (n, P), (P,)
    -> (n,), or T tasks in one launch, (T, n, P), (T, P) -> (T, n).  The
    plain version for a CPU tensor; the CUDA kernel for a CUDA tensor, in
    the form ``form`` names, on strided views as they are (each row
    contiguous)."""
    _check(local, global_)
    if local.device.type == "cpu":
        return model_distance_torch(local, global_)
    dev = check_cuda(local, global_)
    if local.dtype not in DTYPE_FLAG or global_.dtype != local.dtype:
        raise TypeError(f"model_distance takes float32 or bfloat16 of one "
                        f"dtype, got {local.dtype} and {global_.dtype}")
    loc, glob = _rows(local), _rows(global_)
    if loc.dim() == 2:
        n_tasks, l_task, g_task = 1, 0, 0
    else:
        n_tasks, l_task, g_task = loc.shape[0], loc.stride(0), glob.stride(0)
    n, p = loc.shape[-2:]
    out = torch.empty(loc.shape[:-1], dtype=torch.float32, device=dev)
    if n and n_tasks:
        chosen = form(p, loc.dtype)
        blocks, span = cluster_span(p, loc.dtype) if chosen == "cluster" \
            else (0, 0)
        _build.launch("fl_model_distance", dev, loc.data_ptr(),
                      glob.data_ptr(), n_tasks, n, p, l_task,
                      loc.stride(-2), g_task, DTYPE_FLAG[loc.dtype],
                      FORMS[chosen], blocks, span, out.data_ptr())
        model_distance.launches += 1
        model_distance.last_form = chosen
    return out


model_distance.launches = 0
model_distance.last_form = None     # the form of the latest launch


def cluster_capacity(device: torch.device, P: int,
                     dtype: torch.dtype) -> int:
    """How many cluster-form clusters for rows of ``P`` elements the card
    holds at once (``cudaOccupancyMaxActiveClusters``); the launcher
    refuses the form where this is 0."""
    out = ctypes.c_int(0)
    _build.launch("fl_model_distance_capacity", device, DTYPE_FLAG[dtype],
                  cluster_span(P, dtype)[0], ctypes.addressof(out))
    return out.value
