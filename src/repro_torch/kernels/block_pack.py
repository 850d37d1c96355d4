"""Block packing: B consecutive gas-limited FIFO blocks in one launch.

``VectorChain.produce_block`` packs ONE block with two searches (the
head-of-line rule on the running-max submit times, then the gas cap on the
gas cumsum) and copies its stop to the host.  The fused window loop
(core/fused.py) needs the same decision for every block of a run at once;
the carried mempool pointer makes the blocks sequentially dependent.

    tmax:  (N,) float64 running max of submit times (arrival order)
    gcum:  (N,) int64 gas cumsum (arrival order)
    times: (B,) float64 block timestamps, nondecreasing
    n_vis: (B,) int64 mempool length visible to each block, nondecreasing
    -> stops (B,) int64: block b confirms ``[stops[b-1], stops[b])``
       (``ptr0`` before the first block)

For block b, with ``ptr`` the previous stop: ``hi = max(min(ub(tmax,
times[b]), n_vis[b]), ptr)``, ``base = gcum[ptr-1]`` (0 at ptr 0) and
``stop = ub(gcum[ptr:hi], base + gas_limit)`` from ``ptr``, where ``ub``
is an upper bound (numpy's ``searchsorted(..., side="right")``).  An empty
mempool leaves every stop at ``ptr0``; a future-stamped head tx, or one
whose gas alone exceeds the limit, stalls the queue.

Kernel: replaces the Pallas ``_pack_kernel`` of
``src/repro/kernels/block_pack.py:179`` (``pallas_call`` at ``:219``).
float64 and int64 compares are native on the card, so the (hi, lo) u32
pair encoding and the pow2 sentinel padding of the TPU version are gone.
Bound: the bytes are tiny (16·N + 24·B); what bounds it is the chain the
carried pointer makes, one step a block.  The gas search depends on the
pointer alone, so it leaves the chain as a jump table over every pointer
value (``jump_table``: ``g[i] = ub(gcum, base_i + gas_limit)``), and a
block's stop is ``min(max(g[ptr], ptr), max(hi_t[b], ptr))``.  Design
(``csrc/pack.cu``), two kernels: a grid builds the table and the time
bounds ``hi_t[b] = min(ub(tmax, times[b]), n_vis[b])``, every entry its
own binary search; then one block stages the table in shared memory
(where it fits: int32, N up to about 56,000) and one thread walks the
blocks, each one dependent shared-memory load.  ``block_pack_walk_torch``
mirrors the two for the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rollup_digest import check_cuda

_DTYPES = (("tmax", torch.float64), ("gcum", torch.int64),
           ("times", torch.float64), ("n_vis", torch.int64))
WALK_CHUNK = 2048                   # csrc/pack.cu kWalkChunk
SMEM_LIMIT = 232_448                # bytes of shared memory a block can use


def table_staged(n: int) -> bool:
    """Whether the walk reads the jump table of an N-tx mempool from
    shared memory (int32 entries, beside ``WALK_CHUNK`` time bounds), not
    from device memory."""
    return n < 2**31 - 1 and 4 * (WALK_CHUNK + n + 1) <= SMEM_LIMIT


def _check(tmax, gcum, times, n_vis, gas_limit: int, ptr0: int) -> None:
    for (name, dtype), t in zip(_DTYPES, (tmax, gcum, times, n_vis)):
        if t.dtype != dtype or t.dim() != 1:
            raise TypeError(f"block_pack: {name} must be a 1-d {dtype} "
                            f"tensor, got {t.dtype} {tuple(t.shape)}")
    if tmax.shape != gcum.shape or times.shape != n_vis.shape:
        raise ValueError("block_pack: tmax/gcum and times/n_vis must match")
    if not 0 <= int(ptr0) <= tmax.numel():
        raise ValueError(f"block_pack: ptr0={ptr0} outside [0, "
                         f"{tmax.numel()}]")
    if int(gas_limit) < 0:
        raise ValueError("block_pack: gas_limit must be >= 0")


def block_pack_torch(tmax: torch.Tensor, gcum: torch.Tensor,
                     times: torch.Tensor, n_vis: torch.Tensor,
                     gas_limit: int, ptr0: int) -> torch.Tensor:
    """Plain version: the per-block loop with ``torch.searchsorted``.

    Both cumulative arrays are nondecreasing, so a search over the prefix
    ``tmax[:n_vis[b]]`` is the search over the whole array clipped to
    ``n_vis[b]``, and the search over ``gcum[ptr:hi]`` is the search over
    the whole cumsum clipped to ``[ptr, hi]`` (every entry before ``ptr``
    is at most ``base``): the loop runs on the tensors' device without
    copying a pointer to the host."""
    _check(tmax, gcum, times, n_vis, gas_limit, ptr0)
    dev = times.device
    if tmax.numel() == 0:
        return torch.full(times.shape, int(ptr0), dtype=torch.int64,
                          device=dev)
    hi_t = torch.minimum(torch.searchsorted(tmax, times, right=True), n_vis)
    stops = torch.empty(times.shape, dtype=torch.int64, device=dev)
    ptr = torch.tensor(int(ptr0), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(times.numel()):
        hi = torch.maximum(hi_t[b], ptr)
        base = torch.where(ptr > 0, gcum[(ptr - 1).clamp(min=0)], zero)
        j = torch.searchsorted(gcum, (base + int(gas_limit)).reshape(1),
                               right=True)[0]
        ptr = torch.minimum(torch.maximum(j, ptr), hi)
        stops[b] = ptr
    return stops


def jump_table(gcum: torch.Tensor, gas_limit: int) -> torch.Tensor:
    """(N + 1,) int64: entry i is where a block starting at pointer i stops
    for gas alone, ``ub(gcum, base_i + gas_limit)`` with ``base_i =
    gcum[i-1]`` (0 at i = 0); every entry before i is at most ``base_i``,
    so the entry is at least i."""
    base = torch.cat([gcum.new_zeros(1), gcum])
    return torch.searchsorted(gcum, base + int(gas_limit), right=True)


def block_pack_walk_torch(tmax: torch.Tensor, gcum: torch.Tensor,
                          times: torch.Tensor, n_vis: torch.Tensor,
                          gas_limit: int, ptr0: int) -> torch.Tensor:
    """Plain mirror of the kernels: the jump table and the time bounds,
    then the walk, ``ptr = min(max(g[ptr], ptr), max(hi_t[b], ptr))`` a
    block (on the host: one Python step a block)."""
    _check(tmax, gcum, times, n_vis, gas_limit, ptr0)
    g = jump_table(gcum, gas_limit).tolist()
    hi_t = torch.minimum(torch.searchsorted(tmax, times, right=True),
                         n_vis).tolist()
    ptr, stops = int(ptr0), []
    for ht in hi_t:
        ptr = min(max(g[ptr], ptr), max(ht, ptr))
        stops.append(ptr)
    return torch.tensor(stops, dtype=torch.int64, device=times.device)


def block_pack(tmax: torch.Tensor, gcum: torch.Tensor, times: torch.Tensor,
               n_vis: torch.Tensor, gas_limit: int,
               ptr0: int) -> torch.Tensor:
    """(B,) int64 stop pointers of B consecutive blocks: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if tmax.device.type == "cpu":
        return block_pack_torch(tmax, gcum, times, n_vis, gas_limit, ptr0)
    dev = check_cuda(tmax, gcum, times, n_vis)
    _check(tmax, gcum, times, n_vis, gas_limit, ptr0)
    tmax, gcum = tmax.contiguous(), gcum.contiguous()
    times, n_vis = times.contiguous(), n_vis.contiguous()
    stops = torch.empty(times.shape, dtype=torch.int64, device=dev)
    if times.numel():
        n = tmax.numel()
        wide = n >= 2**31 - 1          # int32 table entries otherwise
        table = torch.empty(n + 1, dtype=torch.int64 if wide else
                            torch.int32, device=dev)
        _build.launch("pack_block_pack", dev, tmax.data_ptr(),
                      gcum.data_ptr(), n, times.data_ptr(), n_vis.data_ptr(),
                      times.numel(), int(gas_limit), int(ptr0), int(wide),
                      table.data_ptr(), stops.data_ptr())
        block_pack.launches += 1
    return stops


block_pack.launches = 0
