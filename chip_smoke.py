#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one CUDA card: the rollup node
path (stepped, and through the fused window loop), the reputation-aware
FL protocol run (the default Scheduler: fused loop + cross-task megastep,
and the stepped per-task path), the token-LM serving paths (prefill and
decode of yi-6b, moonshot-v1-16b-a3b and xlstm-1.3b at full width), the
object ledger with its agent path (the default ``AutoDFL()``), the
sharded rollup fabric, and the admission-controlled node service.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its result on a line of its own:

  1. device  — needs a CUDA card; prints its name and power limit
               (nvidia-smi) and the torch and CUDA versions; float32
               matrix products must run in full float32 (no TF32).
  2. build   — compiles every src/repro_torch/kernels/csrc/*.cu with nvcc
               (in parallel; attn.cu and moe.cu include hopper.cuh, the
               TMA / mbarrier / wgmma header) into one library; prints
               ptxas's register use.
  3. kernels — the four fold kernels and ``block_pack`` against their
               plain PyTorch versions on the card, bit for bit
               (``rollup_digest`` also on either side of its ``plan``
               split, one launch a call, timed at 0.8, 4 and 16 MB at each
               cluster count; ``batch_seal`` also at its hard cases --
               the whole 16 MB buffer as one segment, 4,096 one-word
               segments, power-law lengths from 1 to 10^6 words, starts
               off the 4-word grid, views offset by 1-3 words, segments of
               one span and one span +- 1 -- and at every span the kernel
               takes, timed at each power of two; ``dirty_fold`` also at
               the node path's shape with repeated ids and at chunks of
               128, 2,048 and 65,536 words on views offset by 1-3 words,
               both its forms timed at chunks of 2,048 to 65,536; both
               timed at the node path's shapes by CUDA events and by the
               profiler's device time of the kernel), and the two FL
               kernels (Eq. 1
               ``weighted_agg`` and Eq. 4 ``model_distance``, each also
               with its task axis at (32, 64, 2,410), row t bit-equal to
               the unbatched launch; ``model_distance`` in both its forms,
               on shifted views, P of 1, 7, 2,410, 2,411 and 1M, bit-equal
               to its mirror) within rtol 1e-5 / atol 1e-6 in float32 and
               2e-2 in bfloat16, at the grids of the CPU tests and at the
               shapes of the main paths (plus a 1M-wide FL shape); times
               each (CUDA events, L2 flushed before every launch) beside
               its bound, the plain version's time and, where one exists,
               one PyTorch call's; ``model_distance``'s task axis also
               beside 32 unbatched launches, in turns.
  4. node    — NodeClient on the card: 1M transactions of the Table-I mix
               over 262,144 accounts, 20 one-second windows of
               submit_arrays / seal / run_until, then flush and drain;
               launch counts of the fold kernels read just after.
     fused   — the same 1M transactions through the raw-ledger window loop
               of benchmarks/bench_protocol.py (per window submit / seal /
               pump / run_until, then flush and run_until the end), once
               stepped and once through FusedWindowLoop: blocks, gas log,
               batch digests, WindowSettled roots and event kinds equal,
               ONE block_pack launch and TWO batch_seal calls of one
               launch each; batch_seal is held bit-equal to its plain
               version at those two calls' own arguments (the batches'
               roots and one digest a seal over the run's 4M-word buffer)
               and timed there (events, device time, every span).
               block_pack is checked and timed at
               this run's shape, beside its bytes bound, its chain of
               dependent walk steps and the stepped per-block path on the
               same blocks; checked also where its jump table is too
               large for shared memory (N = 300,000).
  5. agree   — the node path at a tenth of the size three ways (card with
               kernels, card with the plain versions forced, CPU): the
               gas log, blocks, digests and per-window state roots must
               be equal; the same for the fused twin, which must also
               equal the stepped twin on the CPU.
  6. fl agree — the default FL protocol run (fused + megastep) at 4 tasks
               x 16 trainers, 2 rounds, the same three ways: protocol
               calls, gas log, blocks, selections, event kinds and DON
               scores equal; reputations and payouts within rtol 1e-5 /
               atol 1e-6, parameters within rtol 1e-5 / atol 1e-5 of each
               leaf's largest value plus 2^-7 of its largest movement in
               training (one bfloat16 step of sgdm's momentum, see
               fl_hold); each card run's final state root equal to the
               root of its fields recomputed on the CPU.  The
               megastep must run, and both Eq. 1 branches with it (one
               task has no lazy trainer, so its rounds are full).
  7. fl      — the FL protocol run on the card at the largest point of
               benchmarks/bench_protocol.py: 32 concurrent tasks x 64
               trainers on NodeSpec() with seal_every=2, TinyMLP(64, 32,
               10), 3 rounds of 2 local sgdm steps on batches of 8 under
               DP, through the default Scheduler; launch counts read just
               after (weighted_agg 3, block_pack 1, model_distance 1: the
               32 tasks finish in the last megastep window and settle in
               one task-axis launch; the stepped path 32).
               Then the stepped per-task path (fused=False,
               megabatch=False) on the same world, held to it as in
               phase 6, and the stepped path on the CPU for scale; where
               the megastep and the per-task round part ways on the card
               (one forward pass, one round).  Then the default run under
               torch.profiler: the device's busy time and the kernels
               that take it.

  8. attention — the flash_attention kernel against its plain version on
               the grid of tests/test_kernels.py:60-64, causal and not,
               plus head width 80, S = 4,097 and ragged tails, and where
               TMA's edges bite (S of 1, 65, 127 and 4,097 at dh 64 and
               128, GQA 8:1 and 1:1), in float32 (rtol 1e-4 / atol 1e-5)
               and bfloat16 (one bfloat16 step: rtol 2^-7 / atol 1e-4),
               each launch in the form flash_attention.form names (the
               wgmma form for bfloat16 at dh 64 and 128); at yi-6b's
               prefill layer (8, 4,096, 32 heads, 4 kv heads, 128) in
               bfloat16, held on one batch row and timed beside its bound,
               the plain version (row by row) and SDPA; at prefill_32k's
               sequence (1, 32,768), held to the plain version on three
               slices of 256 query rows and timed beside SDPA; at
               moonshot's layer (4, 4,096, 16, 16, 128), timed beside
               SDPA.
  9. lm agree — the reduced yi-6b, qwen2-0.5b, qwen1.5-0.5b and qwen3-32b
               in float32 and bfloat16 three ways (card with the kernel,
               card with the plain version forced, CPU): prefill logits
               and caches and three decode steps, within LM_TOL.
 10. lm      — yi-6b at full width and depth (32 layers, bfloat16, weights
               drawn on the card): a 64-token prompt through prefill and
               through 64 decode steps, held to each other; Model.prefill
               on 8 x 4,096 tokens (32 flash_attention launches, counted
               from 0, every one in the wgmma form); its caches in an 8 x 4,128 decode state and 32
               decode steps; (d) one untimed row of the prefill (1 x
               4,096) under analysis.hlo_cost.counting(): counted FLOPs
               and bytes (32 flash_attention launches at their registered
               cost), model_flops' figure and the useful_flops_ratio, the
               share of the 989 TFLOP/s bf16 peak the timed prefill
               reaches by model_flops; the kernel's share of the
               prefill's device time (torch.profiler); then
               launch/serve_model.py's loop at its defaults (batch 4,
               prompt 8, 8 tokens).
 11. moe/xlstm kernels — gmm and slstm_scan against their plain versions
               on the grids of the CPU tests plus ragged shapes and where
               TMA's edges bite (C of 33 and 1,921, f = 200), float32 and
               bfloat16, every gmm form run (gmm.form: wgmma, wmma, simt,
               stream, skinny); a backward through gmm or slstm_scan
               raises; gmm at moonshot's prefill and decode products timed
               beside its bound, the plain version and torch.bmm;
               slstm_scan in the form slstm_scan.form names: the grid form
               also at batches of 17, 32 and 33 rows (launches of 16), the
               cluster form (bfloat16) at dh 64 / 128 / 512, 1 to 33 rows
               in one launch, S of 1, 37 and 4,096, from a live state; at
               xlstm-1.3b's prefill (8, 4,096, 2,048, 4 heads) in the
               cluster form, timed against the grid form it replaced in
               turns (grid, cluster, cluster, grid), there and at a decode
               step (S = 1), beside its bound and the plain version.
 12. moe/xlstm agree — the reduced moonshot, kimi and xlstm, float32 and
               bfloat16, three ways (card with the kernels, card with the
               plain versions forced, CPU), layer by layer on the CPU's
               activations (mixer, caches or state, FFN norm, FFN with
               its routing compared first, head; prefill and two decode
               steps) within LM_TOL; then the reduced moonshot's MoE FFN
               twice on the card, prefill and decode: bit-equal.
 13. moe     — phase 10 for moonshot-v1-16b-a3b at full width and depth
               (48 layers, 64 experts top-6, 56 GB of bfloat16 weights):
               the 64-token check with a capacity that drops nothing
               (K caches held on the first layer: deeper ones sit behind
               routing that prefill and decode may break apart at a
               near-tie); prefill 4 x 4,096 (144 gmm launches in the
               wgmma form and 48 flash_attention launches in theirs); 32
               decode steps at 4 x 4,128 (every gmm launch in the stream
               form); the serve loop.
 14. xlstm   — phase 10 for xlstm-1.3b at full width and depth (42 mLSTM
               and 6 sLSTM layers; the 64-token check in float32, held at
               1e-2, and its bfloat16 gap logged): prefill 8 x 4,096 (6
               slstm_scan launches, in the cluster form as every decode
               step's; it emits no recurrent state, so
               decode starts from the initial one, as in the JAX
               package); 32 decode steps at batch 8; the serve loop.

 15. object  — the object ledger and the agent path (the JAX package's
               default AutoDFL() stack): rollup_digest bit-equal to its
               plain version at the object Rollup's buffers (4, 8, 80 and
               84 words, views offset by 0-3 words, one launch a call),
               timed at 80 words; (a) the Fig. 4/5 grid of
               benchmarks/bench_l2_throughput.py (the four Table I
               functions at 160, 320 and 640 tx/s for 20 s) through
               simulate_load on the object and the vector chain, card and
               CPU, all equal, and L2 TPS = 20 x the L1 peak; (b) the Table
               I replay of benchmarks/bench_gas.py (5, 20, 50, 100 calls)
               through build_stack on the object backend, card == CPU,
               within 10 % of the gas model, every batch digest equal to
               the plain version's; (c) the sequential baseline of
               benchmarks/bench_protocol.py at 16 tasks x 64 trainers:
               AutoDFL on the protocol-sequential spec, 64 TrainingAgents,
               a warm-up task and 16 run_task calls of 3 rounds, launch
               counts from 0 (rollup_digest one a sealed batch,
               weighted_agg 49, model_distance 17), beside the default
               Scheduler on NodeSpec() at the same point; (d) the agent
               path at 2 tasks x 16 trainers, 2 rounds, three ways (card
               with kernels, card with the plain versions forced, CPU; the
               agents' noise drawn on the host), then on the card
               AutoDFL() == spec=NodeSpec.from_legacy() and a Scheduler of
               one agent task == run_task, bit for bit.

 16. fabric  — the sharded rollup fabric (NodeSpec(shards=ShardSpec(...))):
               (c) the 1M-tx raw-ledger loop of phase 4's fused twin over
               an 8-shard fabric (hash routing), stepped and fused: gas
               logs (with ``shard``), blocks, batch digests, fabric roots,
               interconnect logs (per kind) and event kinds equal; launch
               counts from 0: TWO shard_seal launches, one block_pack, no
               batch_seal; (a) shard_seal bit-equal to its plain version at
               K of 1, 2, 8 and 64 lanes, an empty lane, unequal lanes,
               4,096 one-word segments, a 16 MB lane as one segment,
               power-law lengths and views offset by 1-3 words, the mesh
               impl equal to the wrapper; then at (c)'s two calls (captured)
               bit-equal to plain and to one batch_seal a lane, timed by
               CUDA events and the profiler beside its bytes bound, the
               plain version, the K batch_seal launches and the ticket
               buffer's zeroing; (b) benchmarks/bench_shards.py's
               "shard-fabric" point (Table I's mixed blend at 20,000 tx/s
               for 10 s, seed 0) through build_stack at 1, 2, 4 and 8
               shards: the state root equal at every K and in a second run
               at 8, the fabric root reproduced, every tx sealed in one
               shard, the per-lane seal walls, the interconnect's summary,
               the fold kernels' launches from 0, the modeled 8-against-1
               sealed-batch scaling (at least 3x, the reference's floor)
               and the measured one; (d) the 32 x 64 FL run on 8 shards,
               default (two shard_seal launches) against stepped as in
               phase 7, and the 4 x 16 run on 2 shards three ways as in
               phase 6.

 17. serve   — the node service (repro_torch.serve, NodeSpec() unless
               named): (a) benchmarks/bench_serve.py's full-mode spam point
               (honest 300 tx/s over 1,000 senders and spam 1,200 tx/s
               from 24 spammers for 30 s, pool cap 512, window 1.0, seed
               0), driven as its _drive does (one asyncio client a sender,
               lockstep windows), beside its honest control: honest
               retention at least 0.8, launch counts from 0 (the four fold
               kernels, no shard_seal), admission counters and log, op log,
               committed txs, state root and L1 gas equal on the card and
               the CPU, replay_ops on the card reaching the served root; the
               wall, submits per wall second, host seconds by step
               (admission, pool commit, seal, run_until) and the device
               busy share (torch.profiler) of further runs, held equal; (b)
               its poisson point on a 2-shard fabric (each shard sealed
               stepped: no shard_seal), served on the card == replayed
               on the CPU; (c)
               ``python -m repro_torch.launch.serve_node --port 0`` as a
               process on the card, driven over HTTP (submits, flush, a
               finalized receipt, state_root, metrics), stopped by an
               interrupt; (d) cross_verify_aggregate at 64 x 2,410 (the FL
               path's TinyMLP, a local update of 0.01 a trainer): five
               weighted_agg launches, agree 5, oracle 0 bit-equal to
               weighted_average_tree, within 1e-6 of the CPU; (e) each
               preset's drive (tests/test_presets.py) card == CPU.
 18. analysis — (a) REPRO_SANITIZE=1 through build_stack: the node path
               at full size (1M txs, 20 windows; sanitizer off, on, on,
               off), its fused twin and the 8-shard fused fabric at a
               tenth, and the FL run at FL_AGREE through the default
               Scheduler, each silent with checks made, its gas log,
               blocks, batch digests and WindowSettled roots equal to the
               unsanitized run's and rollup_chunk_digests (counted from
               0) launched at least once more a WindowSettled (R001's
               refold, on the card); the node path's walls both ways; (b)
               one violation a dynamic rule (R001, R005, R006, R007)
               injected on a stack whose state lives on the card, each
               raising its rule; (c) every bound of the kernels line
               recomputed from its op's registered cost at the row's
               timed arguments (cost_bound: bytes over 3.35 TB/s,
               operations over 989 TFLOP/s bf16) and equal to PERF.md
               section 6's Bound column, the hand code's (HAND_BOUNDS).

Then one JSON line lists every kernel with its launches on its path, the
card's name and power limit follow on a line of their own, and the last
line is ``{"ok": true, "device": {...}}``.  Any failed phase raises before
them, so the script exits nonzero with no result line; so it does without
a CUDA card, or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# a kernel's bound: the larger of its registered cost's bytes over the
# memory rate and its operations over the bf16 tensor-core peak
# (``cost_bound``); the ledger and FL kernels' integer and float32
# operations are held to the same peak: at every shape timed here their
# bytes take at least 10x as long as their operations would at the CUDA
# cores' 67 T/s (block_pack's searches the closest), so their bound is
# the bytes either way
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_TENSOR_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
# assumed time of one step of block_pack's walk (an estimate, not a
# measurement): a dependent shared-memory load and two min / max, about 40
# clocks; and a dependent L2 load where the table stays in device memory
WALK_STEP_S = 20e-9
L2_STEP_S = 0.3e-6
FULL = dict(rate=50_000.0, duration=20.0, seed=0, n_senders=262_144)
TENTH = dict(rate=5_000.0, duration=20.0, seed=0, n_senders=26_214)
# the FL protocol run: benchmarks/bench_protocol.py:95-96 and its largest
# scheduler point (:345-346)
FL_MODEL = dict(d_in=64, d_h=32, n_classes=10)
FL_RUN = dict(tasks=32, trainers=64, rounds=3, local_steps=2, batch=8)
FL_AGREE = dict(tasks=4, trainers=16, rounds=2, local_steps=2, batch=8)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def log(*parts) -> None:
    print(*parts, flush=True)


def cost_args(args) -> list:
    """The arguments of a kernel call as a cost needs them: a tensor's
    shape and dtype; a small 1-D tensor (shard_seal's lane counts) whole."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append({"dtype": str(a.dtype).split(".")[1],
                        **({"values": a.cpu().tolist()}
                           if a.dim() == 1 and a.numel() <= 64
                           and a.device.type != "meta"
                           else {"shape": list(a.shape)})})
        else:
            out.append(a)
    return out


def from_cost_args(spec) -> list:
    """``cost_args``' record as arguments: meta tensors of each shape (a
    cost reads shapes and dtypes only), small tensors on the host."""
    out = []
    for a in spec:
        if isinstance(a, dict):
            dtype = getattr(torch, a["dtype"])
            out.append(torch.tensor(a["values"], dtype=dtype)
                       if "values" in a else
                       torch.empty(a["shape"], dtype=dtype, device="meta"))
        else:
            out.append(a)
    return out


def cost_bound(op: str, *args) -> dict:
    """The bound of one call of factory op ``op`` at these arguments: its
    registered cost (``kernels.factory.kernel_cost``: operations and bytes,
    whatever implements the op), the bytes over ``HBM_BYTES_PER_S``, the
    operations over ``BF16_TENSOR_FLOPS``, the larger; with the arguments
    as ``cost_args`` records them (phase 18 (c) recomputes it)."""
    from repro_torch.kernels.factory import kernel_cost
    flops, n_bytes = kernel_cost(op)(*args)
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, mem_ms),
            "bound_by": "operations" if ops_ms > mem_ms else "bytes",
            "cost_args": cost_args(args)}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions -----------------------------

def timed_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` (CUDA events), L2 evicted before each."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in marks:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


TRACE_TRIES = 3
# a trace sometimes lacks the device records of its first 15-21 launches
# (on the H100, traces of 20 launches of 3 records held 5, 13 and 15
# kernel spans, every other record there): one-word fills before the
# timed launches (and after them) take the loss in their place, as a
# profiler schedule's warm-up steps would
TRACE_PAD = 64
# every trace device_ms took again: its name fragment, the launches, the
# spans of that name it held and all of its device spans
RETAKES: list = []


def device_ms(fn, fragment: str, iters: int, flush: torch.Tensor,
              clean: bool = False, per_call: int = 1) -> float:
    """The kernel's own device time: the mean over ``iters`` launches of
    ``fn`` (L2 evicted before each) of the device spans whose names hold
    ``fragment`` in a torch.profiler trace, read by name as fl_profile
    reads them; ``TRACE_PAD`` small fills come before and after the
    timed launches in the trace.  Fails unless there is one such span a launch; a trace
    that holds another count is taken again, up to ``TRACE_TRIES``
    times, each retake logged and kept in ``RETAKES`` (why a trace loses
    records is not known, so each run's retakes are printed with its
    numbers).  The L2 is evicted by writing ``flush`` (its dirty
    lines are written back while the kernel reads), or with ``clean`` by
    reading it.  ``per_call``: launches of the kernel in one call of
    ``fn`` (their device times add up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_PAD):
                flush[:1].zero_()
            for _ in range(iters):
                if clean:
                    flush.sum()
                else:
                    flush.zero_()
                fn()
            for _ in range(TRACE_PAD):
                flush[:1].zero_()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        spans = [e.time_range.end - e.time_range.start for e in device
                 if fragment in e.name]
        if len(spans) == iters * per_call:
            break
        RETAKES.append({"fragment": fragment, "launches": iters * per_call,
                        "spans": len(spans), "device_spans": len(device)})
        log(f"device_ms: {len(spans)} device spans named {fragment!r} in "
            f"{iters * per_call} launches ({len(device)} device spans in "
            f"all); tracing them again")
    if len(spans) != iters * per_call:
        raise AssertionError(f"{len(spans)} device spans named {fragment!r} "
                             f"in {iters * per_call} launches")
    return sum(spans) / iters / 1e3


# the fold kernels timed by device_ms too, by their names in a trace
FOLD_KERNELS = {"batch_seal": "batch_seal_span_kernel",
                "dirty_fold": "dirty_fold_kernel",
                "rollup_chunk_digests": "chunk_digests_kernel"}


def u32_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the u32 values two int32 word tensors carry."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    d = (a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)
    return int(d.abs().max())


def seal_starts(n: int, n_lanes: int, batch: int) -> np.ndarray:
    """Word offsets of the seal's batches for ``n`` txs (lane-major)."""
    starts, at = [], 0
    for lane in range(n_lanes):
        k = len(range(lane, n, n_lanes))
        starts.extend(at + np.arange(0, k, batch))
        at += k
    return 4 * np.asarray(starts, np.int64)


def seal_hard_cases(words, g, span: int) -> list:
    """batch_seal's hard inputs (those of tests/test_torch_gpu.py): the
    whole 16 MB buffer as one segment; 4,096 one-word segments; lengths
    drawn from a power law (~ 1 / l) between 1 and 10^6 words; starts off
    the 4-word grid; views offset by 1-3 words; segment edges exactly on
    span edges (lengths of one span and of one span +- 1).  (words,
    starts) pairs on the words' device."""
    def starts_of(lengths, first=0):
        return np.concatenate([[first], first + np.cumsum(lengths)[:-1]])

    power = []
    while sum(power) < 4_000_000:
        power.append(int(10 ** g.uniform(0, 6)))
    cases = [(words(4 << 20), [0]),
             (words(4096), np.arange(4096)),
             (words(sum(power)), starts_of(power)),
             (words(50_000), starts_of(g.integers(1, 80, 1000) * 4 + 1, 3))]
    cases += [(words(200_788 + off)[off:],
               starts_of(g.integers(1, 81, 2600))) for off in (1, 2, 3)]
    cases += [(words(40 * length), np.arange(40) * length)
              for length in (span - 1, span, span + 1)]
    dev = cases[0][0].device
    return [(w, torch.from_numpy(np.asarray(st, np.int64)[
        np.asarray(st) < w.numel()]).to(dev)) for w, st in cases]


def check_kernels(dev, shapes) -> list:
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import rollup_digest as rd
    g = np.random.default_rng(0)

    def words(n):
        w = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(dev)

    def segments(n, n_segs):
        cuts = np.sort(g.choice(np.arange(1, n), n_segs - 1, replace=False)
                       ) if n_segs > 1 else np.empty(0, np.int64)
        return torch.from_numpy(np.concatenate([[0], cuts]).astype(
            np.int64)).to(dev)

    chunk = shapes["chunk"]
    n_state = shapes["state_words"]
    n_chunks = -(-n_state // chunk)
    ids = torch.arange(n_chunks, device=dev)
    seal_words = words(shapes["seal_words"])
    seal_starts_t = torch.from_numpy(shapes["seal_starts"]).to(dev)
    state_words = words(n_state)
    cases = {
        "rollup_digest": (
            rd.rollup_digest, rd.rollup_digest_torch,
            [(torch.from_numpy(g.normal(size=p).astype(np.float32)).to(dev),)
             for p in (128, 10_000, 65_536)]
            + [(words(n),) for n in (0, 1, 7, 513, 4096)]
            + [(seal_words[1:],)]
            + [(words(n + 1)[1:],) for n in (
                rd.SPLIT_WORDS - 1, rd.SPLIT_WORDS + 1,
                3 * rd.SPLIT_WORDS + 5)],
            (seal_words,)),
        "rollup_chunk_digests": (
            rd.rollup_chunk_digests, rd.rollup_chunk_digests_torch,
            [(words(n), chunk) for n in (1, 128, 2048, 4097, 70_000)]
            # views offset by 1-3 words at the node shape and at chunks of
            # 128, 2,048 and 65,536 (the block form); a ragged last chunk
            # of one word
            + [(state_words[off:], c) for off in (1, 2, 3)
               for c in (chunk, 128, 2048, 65_536)]
            + [(words(40 * c + 1), c) for c in (128, 2048, 65_536)],
            (state_words, chunk)),
        "dirty_fold": (
            df.dirty_fold, df.dirty_fold_torch,
            [(w, torch.from_numpy(g.integers(0, -(-w.numel() // chunk), d)
                                  ).to(dev), chunk)
             for w, d in ((words(1), 1), (words(100), 1), (words(5000), 2),
                          (words(70_000), 7), (words(300_000), 146))]
            # the node path's shape with repeated ids; chunks of 128,
            # 2,048 and 65,536 words on views offset by 1-3 words
            + [(state_words, torch.from_numpy(g.integers(
                0, n_chunks, 2 * n_chunks)).to(dev), chunk)]
            + [(state_words[off:], torch.from_numpy(g.integers(
                0, -(-(n_state - off) // c), 300)).to(dev), c)
               for off in (1, 2, 3) for c in (128, 2048, 65_536)],
            (state_words, ids, chunk)),
        "batch_seal": (
            bs.batch_seal, bs.batch_seal_torch,
            [(words(n), segments(n, s)) for n, s in
             ((4, 1), (4096, 17), (100_000, 257), (128, 128))]
            + seal_hard_cases(words, g, bs.plan(shapes["seal_words"]).span),
            (seal_words, seal_starts_t)),
    }
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    results = []
    for name, (kernel, plain, grid, chip) in cases.items():
        err = 0
        for args in grid + [chip]:
            err = max(err, u32_err(kernel(*args), plain(*args)))
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err}")
        row = {"name": name, "max_abs_err": err,
               "ms": timed_ms(lambda: kernel(*chip), 50, flush),
               "plain_ms": timed_ms(lambda: plain(*chip), 10, flush),
               **cost_bound(name, *chip),
               "shape": [list(a.shape) for a in chip
                         if isinstance(a, torch.Tensor)]}
        device = ""
        if name in FOLD_KERNELS:
            row["device_ms"] = device_ms(lambda: kernel(*chip),
                                         FOLD_KERNELS[name], 20, flush)
            device = f", device {row['device_ms']:.6f} ms (profiler)"
        log(f"kernel {name}: bit-equal to plain on {len(grid) + 1} inputs; "
            f"{row['ms']:.6f} ms{device} (bound {row['bound_ms']:.6f} ms, "
            f"{row['bound_by']}), plain {row['plain_ms']:.6f} ms, "
            f"library call: none, at {row['shape']}")
        results.append(row)
    check_rollup_plan(words, flush)
    seal_spans(seal_words, seal_starts_t, "the stepped seal", flush)
    chunk_forms(state_words, chunk, flush)
    return results


def seal_spans(w, starts, label: str, flush) -> None:
    """batch_seal at every span the kernel takes (plan picks one), each
    bit-equal to plain and timed (CUDA events, L2 flushed): the times
    ``plan``'s span comes from."""
    from repro_torch.kernels import batch_seal as bs
    want = bs.batch_seal_torch(w, starts)
    n, nb = w.numel(), starts.numel()
    row = {"words": n, "segments": nb, "plan": bs.plan(n).span}
    for span in range(bs.MIN_SPAN, bs.MAX_SPAN + 1, bs.MIN_SPAN):
        p = bs.plan(n, span)
        if u32_err(bs._launch(w, starts, p), want):
            raise AssertionError(f"batch_seal at {label}, span {span}: "
                                 f"differs from plain")
        if span & (span - 1) == 0:
            row[f"ms_span_{span}"] = timed_ms(
                lambda: bs._launch(w, starts, p), 50, flush)
    log(f"kernel batch_seal spans at {label}: {json.dumps(row)}")


def chunk_forms(state_words, chunk: int, flush) -> None:
    """The chunk fold's two forms (a warp a chunk, a block a chunk), which
    ``rollup_chunk_digests`` and ``dirty_fold`` share, at the node path's
    chunk and at longer ones: both kernels in both forms bit-equal to
    plain (``dirty_fold`` with every chunk selected), and
    ``rollup_chunk_digests`` timed by the profiler (L2 flushed), the times
    ``WARP_CHUNK_MAX`` comes from."""
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import rollup_digest as rd
    for c in (chunk, 4096, 8192, 16_384, 65_536):
        want = rd.rollup_chunk_digests_torch(state_words, c)
        ids = torch.arange(want.numel(), device=state_words.device)
        row = {"chunk": c, "chunks": want.numel(), "form": rd.form(c)}
        for warps in (1, rd.BLOCK_WARPS):
            for name, got in (
                    ("rollup_chunk_digests",
                     rd._chunk_launch(state_words, c, warps)),
                    ("dirty_fold", df._launch(state_words, ids, c, warps))):
                if u32_err(got, want):
                    raise AssertionError(f"{name} at chunk {c} with {warps} "
                                         f"warps a chunk differs from plain")
            row[f"device_ms_{warps}_warps"] = device_ms(
                lambda: rd._chunk_launch(state_words, c, warps),
                FOLD_KERNELS["rollup_chunk_digests"], 20, flush)
        log(f"kernel chunk fold forms: {json.dumps(row)}")


def check_fused_seals(calls, flush) -> None:
    """The fused twin's two batch_seal calls (the batches' roots and one
    digest a seal, over the whole run's word buffer) at their real
    arguments: bit-equal to plain, timed by CUDA events and by the
    profiler beside the bytes bound and the plain version, and at every
    span."""
    from repro_torch.kernels import batch_seal as bs
    for label, (w, starts) in zip(("roots", "seal digests"), calls):
        if u32_err(bs.batch_seal(w, starts), bs.batch_seal_torch(w, starts)):
            raise AssertionError(f"batch_seal at the fused twin's {label} "
                                 f"differs from plain")
        n, nb = w.numel(), starts.numel()
        row = {"words": n, "segments": nb,
               "longest": int(torch.diff(starts, append=starts.new_tensor(
                   [n])).max()),
               "ms": timed_ms(lambda: bs.batch_seal(w, starts), 50, flush),
               "device_ms": device_ms(lambda: bs.batch_seal(w, starts),
                                      FOLD_KERNELS["batch_seal"], 20, flush),
               "bound_ms": cost_bound("batch_seal", w, starts)["bound_ms"],
               "plain_ms": timed_ms(lambda: bs.batch_seal_torch(w, starts),
                                    10, flush)}
        log(f"kernel batch_seal at the fused twin's {label}: bit-equal to "
            f"plain; {json.dumps(row)}")
        seal_spans(w, starts, f"the fused twin's {label}", flush)


def check_rollup_plan(words, flush) -> None:
    """rollup_digest at 0.8, 4 and 16 MB: one launch of the op a call and
    bit-equal to plain, at ``plan``'s cluster count and at 1, 2, 4 and 8
    clusters, each timed beside the bytes bound (the times ``plan``'s
    split comes from)."""
    from repro_torch.kernels import rollup_digest as rd
    for mb in (0.8, 4, 16):
        n = int(mb * 2**20) // 4
        w = words(n)
        want = int(rd.rollup_digest_torch(w))
        before = rd.rollup_digest.launches
        if int(rd.rollup_digest(w)) != want or \
                rd.rollup_digest.launches != before + 1:
            raise AssertionError(f"rollup_digest at {n} words: differs from "
                                 f"plain, or not one launch a call")
        row = {"words": n, "plan": rd.plan(n),
               "bound_ms": cost_bound("rollup_digest", w)["bound_ms"],
               "ms": timed_ms(lambda: rd.rollup_digest(w), 50, flush)}
        for k in (1, 2, 4, 8):
            if int(rd._launch(w, k)) != want:
                raise AssertionError(f"rollup_digest at {n} words over {k} "
                                     f"clusters differs from plain")
            row[f"ms_{k}_clusters"] = timed_ms(lambda: rd._launch(w, k), 50,
                                               flush)
        log(f"kernel rollup_digest at {mb} MB: {json.dumps(row)}")


# -- phases 4 and 5: the node path ---------------------------------------------

def node_spec():
    from repro_torch.api import ChainSpec, NodeSpec, ProverSpec, RollupSpec
    return NodeSpec(chain=ChainSpec(), rollup=RollupSpec(n_lanes=2),
                    prover=ProverSpec(agg_width=8))


def run_node(workload, dev, *, receipts: bool):
    """Windows of submit_arrays / seal / run_until, then flush and drain.
    Returns (client, receipts, per-window records, host seconds by step;
    a step's seconds include the device work it waits for)."""
    from repro_torch.api import NodeClient
    client = NodeClient.from_spec(node_spec(), device=dev)
    txs = workload.txs
    times = txs.submit_time.cpu().numpy()
    n_windows = int(workload.duration)
    rcpts, windows = [], []
    spans = dict.fromkeys(("submit", "seal", "run_until", "flush_drain"),
                          0.0)
    clock = time.perf_counter()

    def lap(step):
        nonlocal clock
        now = time.perf_counter()
        spans[step] += now - clock
        clock = now

    for w in range(n_windows):
        lo, hi = (int(i) for i in np.searchsorted(times, [w, w + 1.0]))
        batch = txs.select(slice(lo, hi))
        if receipts:
            rcpts += client.submit_arrays(batch)
        else:
            client.target.submit_arrays(batch)
        lap("submit")
        client.seal()
        lap("seal")
        client.run_until(w + 1.0)
        lap("run_until")
        windows.append([(e.kind, e.digest if e.kind == "batch_sealed"
                         else e.state_root) for e in client.events(
                             kinds={"batch_sealed", "window_settled"})])
    client.flush()
    t, chain = float(n_windows), client.chain
    while chain.n_confirmed < chain.n_submitted:
        if t > n_windows + 1e5:
            raise AssertionError("the L1 mempool does not drain")
        t += 100.0
        client.run_until(t)
    lap("flush_drain")
    return client, rcpts, windows, spans


def check_main_path(client, workload, rcpts) -> dict:
    """The repo's own invariants on the main path's result."""
    ru, chain = client.target, client.chain
    n = len(workload)
    if sum(r["n_txs"] for r in ru.gas_log) != n:
        raise AssertionError("the gas log does not cover every tx")
    l2_gas = sum(r["total"] for r in ru.gas_log)
    if abs(l2_gas - chain.total_gas) > 1e-9 * chain.total_gas:
        raise AssertionError(f"gas log {l2_gas} != L1 gas {chain.total_gas}")
    st = ru.state_arrays
    counted = int(st.tasks_published[: st.n].sum() + st.submissions[: st.n]
                  .sum() + st.rep_events[: st.n].sum())
    if counted != n:
        raise AssertionError(f"state counters {counted} != {n} txs")
    finalized = sum(client.refresh(r).status == "finalized" for r in rcpts)
    if finalized != n:
        raise AssertionError(f"{finalized} of {n} receipts finalized")
    root = client.state_root()
    if len(root) != 32:
        raise AssertionError(f"bad state root {root!r}")
    return {"txs": n, "batches": ru.n_batches,
            "l1_blocks": len(chain.blocks) - 1,
            "aggregates": len(ru.prover.aggregates),
            "windows": int(workload.duration),
            "finalized_receipts": finalized,
            "accounts": st.n, "state_root": root}


def agree(dev) -> None:
    """The tenth-size path on the card with kernels, on the card with the
    plain versions forced, and on the CPU: identical outputs; the same
    for the fused twin, which equals the stepped twin on the CPU."""
    from repro_torch.core.workloads import make_workload
    cpu = torch.device("cpu")
    _, stepped_cpu, _ = run_twin(make_workload("mixed", device=cpu,
                                               **TENTH), cpu, fused=False)
    until = stepped_cpu["blocks"][-1][1]
    outs, twins = {}, {}
    for label, device, impl in (("card, kernels", dev, None),
                                ("card, plain", dev, "torch"),
                                ("cpu", torch.device("cpu"), None)):
        old = os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
        if impl:
            os.environ["REPRO_TORCH_KERNEL_IMPL"] = impl
        try:
            wl = make_workload("mixed", device=device, **TENTH)
            client, _, windows, _ = run_node(wl, device, receipts=False)
            _, twins[label], _ = run_twin(wl, device, fused=True,
                                          until=until)
        finally:
            os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
            if old is not None:
                os.environ["REPRO_TORCH_KERNEL_IMPL"] = old
        ru = client.target
        outs[label] = {
            "gas_log": ru.gas_log,
            "blocks": [(b.start, b.stop, b.block_hash)
                       for b in client.chain.blocks],
            "batch_digests": ru.batch_digests,
            "windows": windows, "root": client.state_root()}
        log(f"agree {label}: {len(ru.gas_log)} batches, "
            f"{len(client.chain.blocks) - 1} blocks, "
            f"root {outs[label]['root']}")
    ref = outs["cpu"]
    for label, out in outs.items():
        for key in ref:
            if out[key] != ref[key]:
                raise AssertionError(f"{label} differs from the CPU in "
                                     f"{key}")
    log(f"agree: card (kernels), card (plain) and CPU equal over "
        f"{len(ref['windows'])} windows")
    twins_equal(stepped_cpu, twins["cpu"], "agree: fused twin on the CPU "
                "against the stepped twin")
    for label, out in twins.items():
        twins_equal(twins["cpu"], out, f"agree: fused twin, {label} "
                    f"against the CPU")
    log(f"agree: the fused twin equal three ways and to the stepped twin "
        f"({len(stepped_cpu['blocks']) - 1} blocks, "
        f"{len(stepped_cpu['window_roots'])} window roots)")


# -- phase 4, fused: the node path through the fused window loop ---------------

def run_twin(workload, dev, *, fused: bool, until=None):
    """benchmarks/bench_protocol.py's raw-ledger window loop (:269-292)
    over ``workload`` on a NodeClient's chain and rollup: per window
    submit / seal / pump / run_until, then flush and run the L1 to
    ``until``; the stepped twin drains the mempool in 100 s steps when
    ``until`` is None.  Returns (client, outputs, wall seconds ending in a
    synchronize)."""
    from repro_torch.api import NodeClient
    from repro_torch.core.fused import FusedWindowLoop
    client = NodeClient.from_spec(node_spec(), device=dev)
    chain, rollup = client.chain, client.target
    loop = FusedWindowLoop(chain, rollup) if fused else None
    face, blocks = (loop, loop) if fused else (rollup, chain)
    txs = workload.txs
    times = txs.submit_time.cpu().numpy()
    n_windows = int(workload.duration)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(n_windows):
        lo, hi = (int(i) for i in np.searchsorted(times, [w, w + 1.0]))
        batch = txs.select(slice(lo, hi))
        if fused:
            loop.submit(rollup, batch)
        else:
            rollup.submit_arrays(batch)
        face.seal()
        face.pump(w + 1.0)
        blocks.run_until(w + 1.0)
    face.flush()
    if until is None:
        t = float(n_windows)
        while chain.n_confirmed < chain.n_submitted:
            if t > n_windows + 1e5:
                raise AssertionError("the L1 mempool does not drain")
            t += 100.0
            chain.run_until(t)
    else:
        blocks.run_until(until)
    if fused:
        loop.execute()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = client.events(cursor=0)
    out = {"blocks": [(b.height, b.time, b.n_txs, b.gas_used, b.start,
                       b.stop, b.block_hash) for b in chain.blocks],
           "gas_log": rollup.gas_log, "batch_digests": rollup.batch_digests,
           "window_roots": [e.state_root for e in events
                            if e.kind == "window_settled"],
           "event_kinds": [e.kind for e in events],
           "root": client.state_root()}
    return client, out, wall


def twins_equal(a: dict, b: dict, what: str) -> None:
    for key in a:
        if a[key] != b[key]:
            raise AssertionError(f"{what}: {key} differ")


def fused_node(dev, workload, smi: str):
    """The node workload stepped, then through FusedWindowLoop (block_pack
    and batch_seal launch counts from 0): equal outputs, one block_pack
    launch and two batch_seal calls of one launch each; host seconds by
    step of each, and of the work both do inside a seal.  Returns the
    block_pack arguments of the fused run, the arguments of its two
    batch_seal calls, its client and the block_pack launch count."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import fused as fused_mod
    from repro_torch.core.engine import VectorChain, VectorRollup
    from repro_torch.core.prover import ProverPipeline
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import block_pack as bp
    loop = fused_mod.FusedWindowLoop
    # inside a stepped seal and a fused apply_seal alike
    shared = ((ProverPipeline, "enqueue", "prover_enqueue"),
              (VectorRollup, "_apply_state", "state_handlers"),
              (VectorRollup, "_emit_window", "window_root"))
    wraps = {"stepped": ((VectorRollup, "seal", "seal"),
                         (VectorRollup, "pump", "pump"),
                         (VectorChain, "run_until", "run_until")),
             "fused": ((loop, "_prepare_seals", "prepare_seals"),
                       (loop, "_apply_seal", "apply_seal"),
                       (VectorRollup, "pump", "pump"),
                       (loop, "_pack_blocks", "pack_blocks"))}
    steps = {label: PhaseClock() for label in wraps}
    inside = {label: PhaseClock() for label in wraps}

    def wrap(label):
        for owner, attr, phase in wraps[label]:
            steps[label].wrap(owner, attr, phase)
        for owner, attr, phase in shared:
            inside[label].wrap(owner, attr, phase)

    def restore(label):
        inside[label].restore()
        steps[label].restore()
    wrap("stepped")
    try:
        _, stepped, stepped_wall = run_twin(workload, dev, fused=False)
    finally:
        restore("stepped")
    captured = {"batch_seal": []}
    spied = [(fused_mod, fused_mod.get_kernel),
             (engine_mod, engine_mod.get_kernel)]

    def spy(real):
        def resolve(op, impl=None):
            fn = real(op, impl)
            if op not in ("block_pack", "batch_seal"):
                return fn

            def recorded(*args):
                if op == "block_pack":
                    captured[op] = args
                else:
                    captured[op].append(args)
                return fn(*args)
            return recorded
        return resolve
    wrap("fused")
    for module, real in spied:
        module.get_kernel = spy(real)
    bp.block_pack.launches = bs.batch_seal.launches = 0
    try:
        client, fused, fused_wall = run_twin(workload, dev, fused=True,
                                             until=stepped["blocks"][-1][1])
    finally:
        for module, real in spied:
            module.get_kernel = real
        restore("fused")
    launches = bp.block_pack.launches
    seal_launches = bs.batch_seal.launches
    twins_equal(stepped, fused, "fused node against stepped")
    if launches != 1:
        raise AssertionError(f"the fused node run launched block_pack "
                             f"{launches} times, not once")
    if seal_launches != 2 or len(captured["batch_seal"]) != 2:
        raise AssertionError(f"the fused node run launched batch_seal "
                             f"{seal_launches} times in "
                             f"{len(captured['batch_seal'])} calls, not 2")
    spans = {}
    for label, wall in (("stepped", stepped_wall), ("fused", fused_wall)):
        spans[label] = dict(steps[label].seconds)
        spans[label]["rest"] = wall - sum(spans[label].values())
    log(f"fused node: {len(workload)} txs, {len(fused['blocks']) - 1} L1 "
        f"blocks, {len(fused['gas_log'])} batches, "
        f"{len(fused['window_roots'])} window roots: blocks, gas log, "
        f"digests, roots and event kinds equal to the stepped twin; wall "
        f"stepped {stepped_wall:.6f} s, fused {fused_wall:.6f} s on {smi}; "
        f"block_pack launches {launches}, batch_seal launches "
        f"{seal_launches}")
    log(f"fused node: host seconds by step (each ends in a synchronize) "
        f"{json.dumps(spans)}; of which inside seal / apply_seal "
        f"{json.dumps({k: c.seconds for k, c in inside.items()})}")
    return captured["block_pack"], captured["batch_seal"], client, launches


def pack_stream(n_txs, n_blocks, seed, gas_limit, dev):
    """tests/test_kernels.py's random mempool + block grid, on ``dev``."""
    g = np.random.default_rng(seed)
    tmax = np.maximum.accumulate(np.cumsum(g.exponential(0.02, n_txs)))
    gcum = np.cumsum(g.integers(21_000, 120_000, n_txs).astype(np.int64))
    times = np.cumsum(g.uniform(0.05, 1.5, n_blocks))
    n_vis = np.sort(g.integers(0, n_txs + 1, n_blocks)).astype(np.int64)
    return (*(torch.from_numpy(a).to(dev) for a in (tmax, gcum, times,
                                                     n_vis)), gas_limit)


def check_block_pack(dev, args, client) -> dict:
    """block_pack against its plain version, bit for bit: on the CPU tests'
    grid (ptr0 = 0 and the first stop), on an empty mempool, on a mempool
    too large for the walk's shared-memory table and on the fused node
    run's own arguments.  Timed at the last (CUDA events, L2 flushed)
    beside its bytes bound, its chain of B dependent walk steps, the plain
    version and the stepped path (``VectorChain.run_until``, one host
    sync per block) on the same mempool and blocks."""
    from repro_torch.core.engine import TxArrays, VectorChain
    from repro_torch.kernels import block_pack as bp
    grid = []
    for case in ((1, 1, 0, 9_000_000), (100, 7, 1, 9_000_000),
                 (1000, 33, 2, 300_000), (513, 16, 3, 2**40),
                 (64, 5, 4, 21_000), (300_000, 820, 8, 9_000_000)):
        stream = pack_stream(*case, dev)
        first = int(bp.block_pack_torch(*stream, 0)[0])
        grid += [(*stream, 0), (*stream, first)]
    grid.append((*pack_stream(0, 4, 5, 9_000_000, dev), 0))
    large = grid[-3]
    if bp.table_staged(large[0].numel()) or \
            not bp.table_staged(args[0].numel()):
        raise AssertionError("the grid must hold a table the walk stages "
                             "and one it does not")
    for a in grid + [args]:
        if not torch.equal(bp.block_pack(*a), bp.block_pack_torch(*a)):
            raise AssertionError("block_pack differs from its plain version")
    torch.cuda.synchronize()
    tmax, gcum, times, n_vis, limit, ptr0 = args
    n, b = tmax.numel(), times.numel()
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    row = {"name": "block_pack", "max_abs_err": 0,
           "ms": timed_ms(lambda: bp.block_pack(*args), 20, flush),
           "plain_ms": timed_ms(lambda: bp.block_pack_torch(*args), 3, flush),
           **cost_bound("block_pack", *args),
           "library_ms": None, "chain_steps": b,
           "chain_ms": b * WALK_STEP_S * 1e3,
           "large_n": [large[0].numel(), large[2].numel()],
           "large_n_ms": timed_ms(lambda: bp.block_pack(*large), 5, flush),
           "large_n_chain_ms": large[2].numel() * L2_STEP_S * 1e3}
    # the stepped path on the same mempool, every tx visible from the
    # start: B produce_block calls against one block_pack launch
    src = client.chain
    full = torch.full_like(n_vis, n)
    want = bp.block_pack(tmax, gcum, times, full, limit, 0)
    stepped_s = []
    for _ in range(3):
        chain = VectorChain(block_gas_limit=limit, device=dev)
        chain.submit_arrays(TxArrays(src._t[:n], src._g[:n], src._f[:n],
                                     src._s[:n], src.fns))
        chain._consolidate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain.run_until(float(times[-1]))
        torch.cuda.synchronize()
        stepped_s.append(time.perf_counter() - t0)
        if [blk.stop for blk in chain.blocks[1:]] != want.tolist():
            raise AssertionError("block_pack differs from the stepped "
                                 "produce_block on the same blocks")
    row["stepped_ms"] = 1e3 * sum(stepped_s) / len(stepped_s)
    log(f"kernel block_pack: bit-equal to plain on {len(grid) + 1} inputs "
        f"(N up to {large[0].numel()}, past the walk's shared-memory "
        f"table) and to {b} stepped produce_block calls; {row['ms']:.6f} ms "
        f"(bound {row['bound_ms']:.6f} ms, {row['bound_by']}; plus the "
        f"walk's chain of {b} dependent shared-memory steps, about "
        f"{row['chain_ms']:.6f} ms at an assumed {WALK_STEP_S * 1e9:.0f} ns "
        f"each), plain {row['plain_ms']:.6f} ms, stepped path "
        f"(VectorChain.run_until, one host sync per block) "
        f"{row['stepped_ms']:.6f} ms for the same {b} blocks, library "
        f"call: none, at N={n}, B={b}; at N={large[0].numel()}, "
        f"B={large[2].numel()} (the table in device memory) "
        f"{row['large_n_ms']:.6f} ms (chain about "
        f"{row['large_n_chain_ms']:.6f} ms at an assumed "
        f"{L2_STEP_S * 1e6:.1f} us an L2 load)")
    return row


# -- phase 3: FL kernels against their plain versions --------------------------

def check_fl_kernels(dev, path_n: int, path_p: int, wide_p: int,
                     n_tasks: int) -> dict:
    """weighted_agg and model_distance against their plain versions at
    the grids of tests/test_kernels.py, at the FL path's shape and at a
    1M-wide shape, and weighted_agg with its task axis at the megastep's
    (n_tasks, path_n, path_p); times at the last three.  Returns {name:
    row} with the path shape's numbers, the wide shape's under ``"wide"``
    and the task-axis shape's under ``"task"``."""
    from repro_torch.kernels import model_distance as md
    from repro_torch.kernels import weighted_agg as wa
    g = torch.Generator().manual_seed(0)

    def rows(n, p, dtype):
        return torch.randn(n, p, generator=g).to(dev, dtype)

    def scores(n):
        return (torch.rand(n, generator=g) * 0.95 + 0.05).to(dev)

    f32, bf16 = torch.float32, torch.bfloat16
    agg_grid = [(rows(n, p, dt), scores(n)) for n, p, dt in (
        (2, 256, f32), (4, 1000, f32), (16, 8192, bf16), (64, 4096, bf16),
        (3, 130, f32), (1, 1, f32), (0, 7, f32))]
    agg_grid.append((torch.stack([torch.ones(256), 100 * torch.ones(256)])
                     .to(dev), torch.tensor([1.0, 0.0], device=dev)))
    dist_grid = []
    for n, p, dt in ((4, 1000, f32), (8, 5000, bf16), (1, 128, f32),
                     (3, 1, f32), (5, 7, f32), (64, 2410, f32),
                     (6, 2411, f32), (4, 2411, bf16), (2, 1 << 20, f32),
                     (2, 1 << 20, bf16)):
        w = rows(n, p + 1, dt)
        glob = rows(1, p + 1, dt)[0]
        # the rows p + 1 apart, then shifted one element off their (and
        # g's) alignment; the path shape below is contiguous, 9,640 bytes
        # a row: 8 mod 16
        dist_grid += [(w[:, :p], glob[:p]), (w[:, 1:], glob[1:])]
    shapes = {"path": (path_n, path_p), "wide": (path_n, wide_p)}
    chips = {}
    for label, (n, p) in shapes.items():
        w, glob = rows(n, p, f32), rows(1, p, f32)[0]
        chips[label] = {"weighted_agg": (w, scores(n)),
                        "model_distance": (w, glob)}
    cases = {
        "weighted_agg": (
            wa.weighted_agg, wa.weighted_agg_torch, agg_grid,
            lambda w, s: torch.matmul(s, w) / s.sum().clamp(min=1e-12)),
        "model_distance": (
            md.model_distance, md.model_distance_torch, dist_grid,
            lambda w, glob: torch.cdist(w, glob[None])[:, 0]),
    }
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    agg_mirror(agg_grid + [chips[k]["weighted_agg"] for k in shapes]
               + agg_hard_cases(rows, scores, path_n, path_p))
    out = {}
    for name, (kernel, plain, grid, library) in cases.items():
        err = 0.0
        checked = grid + [chips["path"][name], chips["wide"][name]]
        for args in checked:
            got, want = kernel(*args), plain(*args)
            tol = BF16_TOL if args[0].dtype == torch.bfloat16 else F32_TOL
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m, name=name: f"{name}: {m}")
            if got.numel() and args[0].dtype == torch.float32:
                err = max(err, float((got - want).abs().max()))
        torch.cuda.synchronize()
        timed = {}
        for label in shapes:
            args = chips[label][name]
            timed[label] = {
                "ms": timed_ms(lambda: kernel(*args), 50, flush),
                "plain_ms": timed_ms(lambda: plain(*args), 20, flush),
                "library_ms": timed_ms(lambda: library(*args), 20, flush),
                **cost_bound(name, *args),
                "shape": [list(a.shape) for a in args]}
            t = timed[label]
            if name == "weighted_agg":
                t["device_ms"] = device_ms(lambda: kernel(*args),
                                           "weighted_agg", 20, flush)
            if name == "model_distance":
                t["form"] = md.model_distance.last_form
                if t["form"] != md.form(args[0].shape[1], args[0].dtype):
                    raise AssertionError(f"model_distance at {t['shape']}: "
                                         f"form {t['form']}")
            device = (f", device {t['device_ms']:.6f} ms (profiler)"
                      if "device_ms" in t else "")
            log(f"kernel {name} at {t['shape']} (float32): {t['ms']:.6f} ms"
                f"{device} (bound {t['bound_ms']:.6f} ms, {t['bound_by']}), "
                f"plain {t['plain_ms']:.6f} ms, library call "
                f"{t['library_ms']:.6f} ms; {t.get('form', '')}")
        log(f"kernel {name}: within tolerance of plain on {len(checked)} "
            f"inputs (float32 rtol 1e-5 atol 1e-6, bfloat16 2e-2); largest "
            f"float32 |kernel - plain| {err}")
        out[name] = {"name": name, "max_abs_err": err, **timed["path"],
                     "wide": timed["wide"]}
    out["weighted_agg"]["task"] = check_task_axis_agg(
        dev, g, n_tasks, path_n, path_p, flush, out["weighted_agg"])
    out["model_distance"]["task"] = check_task_axis_distance(
        dev, g, n_tasks, path_n, path_p, wide_p, flush,
        out["model_distance"])
    return out


def agg_hard_cases(rows, scores, n, p) -> list:
    """weighted_agg's hard inputs (those of tests/test_torch_gpu.py): n of
    1, 7, 9 and 1,000 rows, P of 1, 3 and 2,411 columns, rows offset by
    1-3 elements, bfloat16 at the path's (n, p)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(rows(k, p, f32), scores(k)) for k in (1, 7, 9, 1000)]
    cases += [(rows(n, q, f32), scores(n)) for q in (1, 3, p + 1)]
    cases += [(rows(n, p + off, f32)[:, off:], scores(n))
              for off in (1, 2, 3)]
    return cases + [(rows(n, p, bf16), scores(n))]


def agg_mirror(cases) -> None:
    """weighted_agg bit-equal to ``weighted_agg_mirror`` (the kernel's sum
    order on the CPU) on every (stacked, scores) pair."""
    from repro_torch.kernels import weighted_agg as wa
    for w, s in cases:
        if not torch.equal(wa.weighted_agg(w, s).cpu(),
                           wa.weighted_agg_mirror(w, s)):
            raise AssertionError(f"weighted_agg at {tuple(w.shape)} "
                                 f"{w.dtype} (strides {w.stride()}): differs "
                                 f"from its mirror")
    log(f"kernel weighted_agg: bit-equal to weighted_agg_mirror on "
        f"{len(cases)} inputs")


def check_task_axis_agg(dev, g, n_tasks, n, p, flush, row) -> dict:
    """The megastep's Eq. 1 launch, (T, n, P) -> (T, P): row t bit-equal
    to the unbatched launch on task t, all rows within float32 tolerance
    of the plain version; timed beside its bound, the plain version and
    one batched matrix product."""
    from repro_torch.kernels import weighted_agg as wa
    w = torch.randn(n_tasks, n, p, generator=g).to(dev)
    s = (torch.rand(n_tasks, n, generator=g) * 0.95 + 0.05).to(dev)
    got, want = wa.weighted_agg(w, s), wa.weighted_agg_torch(w, s)
    for t in range(n_tasks):
        if not torch.equal(got[t], wa.weighted_agg(w[t], s[t])):
            raise AssertionError(f"weighted_agg: task-axis row {t} differs "
                                 f"from the unbatched launch")
    if not torch.equal(got.cpu(), wa.weighted_agg_mirror(w, s)):
        raise AssertionError("weighted_agg: the task-axis launch differs "
                             "from its mirror")
    torch.testing.assert_close(got, want, **F32_TOL)
    torch.cuda.synchronize()
    row["max_abs_err"] = max(row["max_abs_err"],
                             float((got - want).abs().max()))
    t = {"ms": timed_ms(lambda: wa.weighted_agg(w, s), 50, flush),
         "device_ms": device_ms(lambda: wa.weighted_agg(w, s),
                                "weighted_agg", 20, flush),
         "plain_ms": timed_ms(lambda: wa.weighted_agg_torch(w, s), 20, flush),
         "library_ms": timed_ms(
             lambda: torch.matmul(s[:, None], w)[:, 0]
             / s.sum(1, keepdim=True).clamp(min=1e-12), 20, flush),
         **cost_bound("weighted_agg", w, s),
         "shape": [list(w.shape), list(s.shape)]}
    log(f"kernel weighted_agg at {t['shape']} (float32, task axis): rows "
        f"bit-equal to the {n_tasks} unbatched launches and to the mirror; "
        f"{t['ms']:.6f} ms, device {t['device_ms']:.6f} ms (profiler) "
        f"(bound {t['bound_ms']:.6f} ms, {t['bound_by']}), plain "
        f"{t['plain_ms']:.6f} ms, library call (batched matmul) "
        f"{t['library_ms']:.6f} ms")
    return t


def check_task_axis_distance(dev, g, n_tasks, n, p, wide_p, flush,
                             row) -> dict:
    """The megastep's Eq. 4 launch, (T, n, P) -> (T, n), in both forms, T
    of 1, 3 and 32, float32 and bfloat16, shifted views too: row t
    bit-equal to the unbatched launch on task t and to the kernel's mirror
    (``model_distance_mirror``, on the CPU), all within tolerance of the
    plain version; at (n_tasks, n, p) timed beside its bound, the plain
    version, batched ``torch.cdist`` and n_tasks unbatched launches (in
    turns: unbatched, batched, batched, unbatched)."""
    from repro_torch.kernels import model_distance as md
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(1, n, p, f32), (3, 16, p + 1, bf16), (n_tasks, n, p, f32),
             (3, 4, wide_p, f32), (3, 2, wide_p + 3, bf16)]
    for t_n, r_n, width, dt in cases:
        w = torch.randn(t_n, r_n, width + 1, generator=g).to(dev, dt)
        glob = torch.randn(t_n, width + 1, generator=g).to(dev, dt)
        for lw, lg in ((w[..., :width], glob[..., :width]),
                       (w[..., 1:], glob[..., 1:])):
            got = md.model_distance(lw, lg)
            chosen = md.model_distance.last_form
            for t in range(t_n):
                if not torch.equal(got[t], md.model_distance(lw[t], lg[t])):
                    raise AssertionError(f"model_distance: task-axis row {t} "
                                         f"at {tuple(lw.shape)} differs from "
                                         f"the unbatched launch")
            if not torch.equal(got.cpu(), md.model_distance_mirror(
                    lw.cpu(), lg.cpu())):
                raise AssertionError(f"model_distance at {tuple(lw.shape)} "
                                     f"{dt}: differs from its mirror")
            want = md.model_distance_torch(lw, lg)
            torch.testing.assert_close(
                got, want, **(BF16_TOL if dt == bf16 else F32_TOL))
            if dt == f32:
                row["max_abs_err"] = max(row["max_abs_err"],
                                         float((got - want).abs().max()))
        log(f"kernel model_distance at {[t_n, r_n, width]} {dt}: {chosen} "
            f"form, rows bit-equal to the {t_n} unbatched launches and to "
            f"the mirror (aligned and shifted)")
    torch.cuda.synchronize()
    w = torch.randn(n_tasks, n, p, generator=g).to(dev)
    glob = torch.randn(n_tasks, p, generator=g).to(dev)

    def unbatched():
        for t in range(n_tasks):
            md.model_distance(w[t], glob[t])
    turns = []
    for fn in (unbatched, lambda: md.model_distance(w, glob),
               lambda: md.model_distance(w, glob), unbatched):
        turns.append(timed_ms(fn, 50, flush))
    if md.model_distance.last_form != md.form(p, torch.float32):
        raise AssertionError("model_distance: task-axis form")
    t = {"ms": (turns[1] + turns[2]) / 2,
         "unbatched_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns,
         "plain_ms": timed_ms(lambda: md.model_distance_torch(w, glob), 20,
                              flush),
         "library_ms": timed_ms(lambda: torch.cdist(w, glob[:, None]), 20,
                                flush),
         **cost_bound("model_distance", w, glob),
         "form": md.model_distance.last_form,
         "shape": [list(w.shape), list(glob.shape)]}
    log(f"kernel model_distance at {t['shape']} (float32, task axis): "
        f"{t['ms']:.6f} ms in one launch, {n_tasks} unbatched launches "
        f"{t['unbatched_ms']:.6f} ms (turns {t['turns_ms']}; bound "
        f"{t['bound_ms']:.6f} ms, {t['bound_by']}), plain "
        f"{t['plain_ms']:.6f} ms, library call (batched cdist) "
        f"{t['library_ms']:.6f} ms; {t['form']} form")
    return t


# -- phases 6 and 7: the FL protocol run ---------------------------------------

def fl_world(dev, n_trainers: int, local_steps: int, batch: int):
    """bench_protocol.py's world on ``dev``: TinyMLP, sgdm with grad_clip,
    gaussian clusters (numpy streams, then placed on the device), DP."""
    from repro_torch.data.synthetic import gaussian_clusters
    from repro_torch.fl.dp import DPConfig
    from repro_torch.models.mlp import TinyMLP
    from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
    d = FL_MODEL
    model = TinyMLP(d["d_in"], d["d_h"], d["n_classes"], name="bench-mlp",
                    device=dev)
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0))
    tr_x, tr_y = gaussian_clusters(4096, d["d_in"], d["n_classes"], seed=1)
    vx, vy = gaussian_clusters(250, d["d_in"], d["n_classes"], seed=2)
    tx, ty = torch.from_numpy(tr_x).to(dev), torch.from_numpy(tr_y).to(dev)

    def batch_fn(sel, rnd):
        idx = np.random.default_rng(int(rnd) * 131 + 7).integers(
            0, len(tr_x), (len(sel), local_steps, batch))
        i = torch.from_numpy(idx).to(dev)
        return {"x": tx[i], "labels": ty[i]}
    val = {"x": torch.from_numpy(vx).to(dev),
           "labels": torch.from_numpy(vy).to(dev)}
    return model, opt, val, batch_fn, DPConfig(noise_multiplier=0.05)


def run_fl(dev, cfg, behaviors=None, shards=None, **knobs):
    """One Scheduler run of ``cfg['tasks']`` concurrent tasks on
    ``NodeSpec()`` (the protocol-scheduler preset; with ``shards``, a
    ShardSpec, on that sharded fabric) with seal_every=2 and the
    Scheduler's ``knobs`` (its defaults: the fused loop and the
    megastep).  ``behaviors``: one list per task, or None (all good).
    Returns (node, scheduler, results, wall seconds ending in a
    synchronize)."""
    from repro_torch.api import FLTaskSpec, NodeSpec
    from repro_torch.fl.cohort import CohortKernels, VectorCohort
    from repro_torch.fl.scheduler import Scheduler
    from repro_torch.fl.server import AutoDFL
    n, tasks = cfg["trainers"], cfg["tasks"]
    model, opt, val, batch_fn, dp = fl_world(dev, n, cfg["local_steps"],
                                             cfg["batch"])
    spec = NodeSpec(shards=shards, trainer_funds=10.0 * (tasks + 2),
                    publisher_funds=100.0 * (tasks + 2))
    node = AutoDFL(model, opt, n, model.accuracy_fn(), val, spec=spec,
                   device=dev)
    kernels = CohortKernels(model, opt, dp)
    sch = Scheduler(node, seal_every=2, **knobs)
    for t in range(tasks):
        sch.add_task(FLTaskSpec(f"task{t}", rounds=cfg["rounds"]),
                     VectorCohort(model, opt, batch_fn, node.store,
                                  behaviors=behaviors and behaviors[t],
                                  n_trainers=n,
                                  local_steps=cfg["local_steps"], dp=dp,
                                  seed=t, kernels=kernels, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sch.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return node, sch, out, time.perf_counter() - t0


def fl_outputs(node, sch, out) -> dict:
    from repro_torch.core.state import StateArrays
    st = node.state_arrays
    fields = st.to_numpy()
    return {
        "protocol_calls": dict(node.protocol_calls),
        "gas_log": node.rollup.gas_log,
        "blocks": [(b.start, b.stop, b.gas_used, b.block_hash)
                   for b in node.chain.blocks],
        "selected": {t: node.tsc.tasks[t].trainers for t in out},
        "event_kinds": [e.kind for e in node.client().events(cursor=0)],
        "scores": {t: r.scores.tolist() for t, r in out.items()},
        "params": {t: {k: v.cpu().numpy() for k, v in
                       r.global_params.items()} for t, r in out.items()},
        "reputation": node.book.reputation.cpu().numpy(),
        "payouts": {t: r.payouts for t, r in out.items()},
        # every task starts from init_params(0) (FLTaskSpec's init_seed)
        "init": {k: v.cpu().numpy()
                 for k, v in node.model.init_params(0).items()},
        "root": node.rollup.state_root(),
        "cpu_root": StateArrays.from_numpy(fields, "cpu").root(),
    }


def fl_hold(ref: dict, o: dict, what: str) -> None:
    """Hold one FL run's outputs to another's: ledger, selections and DON
    scores exactly; reputations and payouts within rtol 1e-5 / atol 1e-6;
    parameters within rtol 1e-5 and, per leaf, an absolute term for each
    of the two ways the same training can differ (see below)."""
    worst = max(float(np.abs(o["params"][t][k] - v).max())
                for t in ref["params"] for k, v in ref["params"][t].items())
    log(f"{what}: largest |param difference| {worst}, largest |reputation "
        f"difference| {float(np.abs(o['reputation'] - ref['reputation']).max())}")
    for key in ("protocol_calls", "gas_log", "blocks", "selected",
                "event_kinds", "scores"):
        if o[key] != ref[key]:
            raise AssertionError(f"{what}: {key} differ")
    for t in ref["params"]:
        for k, v in ref["params"][t].items():
            # (1) float32 products summed in another order (the card
            # against the CPU, a batched product against one per task):
            # an element near zero carries a difference on the scale of
            # its leaf, 1e-5 of the leaf's largest value; (2) sgdm keeps
            # its momentum in bfloat16, so a last-bit difference can round
            # a momentum element one bfloat16 step (2^-8 to 2^-7 of it)
            # the other way, moving the parameter by up to 2^-7 of a
            # step: 2^-7 of the leaf's largest net movement in training
            moved = float(np.abs(v - ref["init"][k]).max())
            np.testing.assert_allclose(
                o["params"][t][k], v, rtol=F32_TOL["rtol"],
                atol=F32_TOL["rtol"] * float(np.abs(v).max()) + moved / 128,
                err_msg=f"{what}: {t} {k}")
        for who, pay in ref["payouts"][t].items():
            np.testing.assert_allclose(o["payouts"][t][who], pay,
                                       **F32_TOL, err_msg=what)
    np.testing.assert_allclose(o["reputation"], ref["reputation"],
                               **F32_TOL, err_msg=what)


def fl_agree(dev, shards=None) -> None:
    """The default FL run (fused + megastep) at 4 tasks x 16 trainers, 2
    rounds, on the card with kernels, on the card with the plain versions
    forced, and on the CPU (on the sharded fabric ``shards`` when given).
    The lazy trainers make tasks ragged; the last task has none, so its
    rounds are full and both Eq. 1 branches run."""
    from repro_torch.fl import scheduler as fl_sched
    tag = "fl agree" if shards is None else f"fl agree fabric {shards.count}"
    lazy = ["good", "good", "malicious", "lazy"] * (FL_AGREE["trainers"] // 4)
    behaviors = [lazy] * (FL_AGREE["tasks"] - 1) + [
        ["good", "good", "malicious", "good"] * (FL_AGREE["trainers"] // 4)]
    outs = {}
    for label, device, impl in (("card, kernels", dev, None),
                                ("card, plain", dev, "torch"),
                                ("cpu", torch.device("cpu"), None)):
        old = os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
        if impl:
            os.environ["REPRO_TORCH_KERNEL_IMPL"] = impl
        branches = PhaseClock()
        for attr in ("weighted_average_tree_mega", "weighted_average_tree"):
            branches.wrap(fl_sched, attr, attr)
        try:
            node, sch, out, wall = run_fl(device, FL_AGREE, behaviors,
                                          shards)
        finally:
            branches.restore()
            os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
            if old is not None:
                os.environ["REPRO_TORCH_KERNEL_IMPL"] = old
        if sch.mega_windows == 0 or 0 in branches.calls.values():
            raise AssertionError(f"{tag} {label}: megastep windows "
                                 f"{sch.mega_windows}, Eq. 1 calls "
                                 f"{branches.calls}")
        log(f"{tag} {label}: {sch.mega_windows} megastep windows, Eq. 1 "
            f"calls {json.dumps(branches.calls)}")
        outs[label] = o = fl_outputs(node, sch, out)
        digest = hashlib.sha256(b"".join(
            o["params"][t][k].tobytes() for t in sorted(o["params"])
            for k in sorted(o["params"][t]))).hexdigest()[:16]
        log(f"{tag} {label}: parameters' sha256 {digest} (compare "
            f"between calls)")
        if o["root"] != o["cpu_root"]:
            raise AssertionError(f"{tag} {label}: root {o['root']} != "
                                 f"the CPU root of its fields {o['cpu_root']}")
        log(f"{tag} {label}: {sum(o['protocol_calls'].values())} protocol "
            f"calls, {len(o['gas_log'])} batches, {len(o['blocks']) - 1} "
            f"blocks, root {o['root']} (= the CPU root of its fields), "
            f"{wall:.3f} s")
    ref = outs["cpu"]
    for label, o in outs.items():
        fl_hold(ref, o, f"{tag} {label} against the CPU")
    log(f"{tag}: card (kernels), card (plain) and CPU agree over "
        f"{FL_AGREE['tasks']} tasks x {FL_AGREE['trainers']} trainers, "
        f"{FL_AGREE['rounds']} rounds (ledger, selections, scores exact; "
        f"reputations, payouts within rtol 1e-5 atol 1e-6; params within "
        f"rtol 1e-5 atol 1e-5 x the leaf's largest value)")


class PhaseClock:
    """Host seconds spent in named methods, each ending in a synchronize
    so that a phase holds its own device work; and their calls."""

    def __init__(self):
        self.seconds = {}
        self.calls = {}
        self._undo = []

    def wrap(self, owner, attr: str, phase: str) -> None:
        fn = getattr(owner, attr)
        self.seconds.setdefault(phase, 0.0)
        self.calls.setdefault(phase, 0)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            self.calls[phase] += 1
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds[phase] += time.perf_counter() - t0
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def fl_measured(dev, smi: str, label: str, shards=None, **knobs) -> dict:
    """The FL protocol run at 32 tasks x 64 trainers (on the sharded
    fabric ``shards`` when given) with the Scheduler's ``knobs``, launch
    counts from 0, host seconds by phase; checks the repo's invariants on
    the result and returns what it measured."""
    from repro_torch.core import oracle
    from repro_torch.core.fused import FusedWindowLoop
    from repro_torch.core.gas import DEFAULT_GAS, L1_DEFAULT_GAS
    from repro_torch.fl import scheduler as fl_sched
    from repro_torch.fl.cohort import MegaCohort, VectorCohort
    from repro_torch.fl.server import AutoDFL
    from repro_torch.kernels import block_pack as bp
    from repro_torch.kernels import model_distance as md
    from repro_torch.kernels import shard_lanes as sl
    from repro_torch.kernels import weighted_agg as wa
    clock = PhaseClock()
    for owner, attr, phase in (
            (VectorCohort, "train", "train"), (MegaCohort, "train", "train"),
            (fl_sched, "evaluate_quorum", "quorum"),
            (fl_sched, "mega_score_tables", "quorum"),
            (fl_sched, "quorum_from_table", "quorum"),
            (fl_sched, "weighted_average_tree", "eq1"),
            (fl_sched, "weighted_average_tree_mega", "eq1"),
            (fl_sched, "_settle_distances", "settle"),
            (fl_sched, "_settle_distances_mega", "settle"),
            (fl_sched.TaskRuntime, "_settle", "settle"),
            (AutoDFL, "settle_window", "settle"),
            (FusedWindowLoop, "execute", "fused_execute")):
        clock.wrap(owner, attr, phase)
    wrappers = {"weighted_agg": wa.weighted_agg,
                "model_distance": md.model_distance,
                "block_pack": bp.block_pack, "shard_seal": sl.shard_seal}
    for fn in wrappers.values():
        fn.launches = 0
    tables = (oracle._score_table_batched, oracle._score_table_loop,
              oracle.mega_score_tables)
    for fn in tables:
        fn.calls = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        node, sch, out, wall = run_fl(dev, FL_RUN, shards=shards, **knobs)
    finally:
        clock.restore()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    batched, looped, mega = (fn.calls for fn in tables)
    # the repo's own invariants on the result (every trainer is good, so
    # a megastep scores every task)
    n_rounds = FL_RUN["tasks"] * FL_RUN["rounds"]
    if batched + FL_RUN["tasks"] * mega != n_rounds or looped:
        raise AssertionError(f"{label}: DON scoring: {batched} batched, "
                             f"{mega} megastep and {looped} looped tables "
                             f"for {n_rounds} task-rounds")
    if sorted(out) != sorted(f"task{t}" for t in range(FL_RUN["tasks"])):
        raise AssertionError(f"{label}: not every task finished")
    for tid, res in out.items():
        for k, v in res.global_params.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{tid}: non-finite {k}")
        if res.scores.shape != (FL_RUN["trainers"],) or not (
                (res.scores >= 0) & (res.scores <= 1)).all():
            raise AssertionError(f"{tid}: bad scores {res.scores}")
    ru, chain = node.rollup, node.chain
    l2 = sum(r["total"] for r in ru.gas_log)
    # a fabric's rows carry each shard's float shares of its amortized
    # verify and execute, which miss the L1's integer gas by rounding
    # (check_main_path's rule); one rollup's sum is exact
    tol = 0.0 if shards is None else 1e-9 * chain.total_gas
    if abs(l2 - chain.total_gas) > tol or \
            chain.n_confirmed != chain.n_submitted:
        raise AssertionError(f"L2 gas {l2} != L1 gas {chain.total_gas}, or "
                             f"the L1 did not drain")
    st = node.state_arrays
    if int(st.submissions[: st.n].sum()) != \
            node.protocol_calls["submitLocalModel"]:
        raise AssertionError("state counters miss submissions")
    n_tasks_book = node.book.n_tasks.cpu().numpy()
    if not (n_tasks_book == FL_RUN["tasks"]).all():
        raise AssertionError(f"book n_tasks {n_tasks_book}")
    l1_equiv = sum(DEFAULT_GAS.l1_per_call.get(fn, L1_DEFAULT_GAS) * k
                   for fn, k in node.protocol_calls.items())
    acc = float(node.eval_fn(out["task0"].global_params, node.val_batch))
    n_txs = sum(node.protocol_calls.values())
    spans = dict(clock.seconds)
    spans["ledger_and_rest"] = wall - sum(spans.values())
    stats = {"path": label, "tasks": FL_RUN["tasks"],
             "trainers": FL_RUN["trainers"], "rounds": FL_RUN["rounds"],
             "protocol_calls": node.protocol_calls,
             "scheduler_windows": sch.n_windows,
             "megastep_windows": sch.mega_windows,
             "sealed_windows": len(sch.window_records),
             "batches": ru.n_batches,
             "l1_blocks": len(chain.blocks) - 1,
             "aggregates": len(sch.settlement_records),
             "state_root": ru.state_root(), "task0_val_acc": acc,
             "l1_equivalent_gas": int(l1_equiv), "l2_gas": int(l2),
             "gas_reduction": l1_equiv / l2,
             "batched_don_tables": batched, "megastep_don_tables": mega,
             "looped_don_tables": looped, "launches": launches}
    log(f"fl {label}: {json.dumps(stats)}")
    log(f"fl {label}: wall {wall:.6f} s for {n_txs} protocol txs over "
        f"{sch.n_windows} scheduling windows ({wall / sch.n_windows:.6f} s "
        f"per window, {n_txs / wall:.1f} tx/s, "
        f"{n_txs / wall / FL_RUN['tasks']:.1f} per task) on {smi}; peak "
        f"device memory {peak:.1f} MiB")
    log(f"fl {label}: host seconds by phase (each ends in a synchronize) "
        f"{json.dumps(spans)}")
    return {"launches": launches, "wall": wall,
            "outputs": fl_outputs(node, sch, out)}


def fl_main(dev, smi: str):
    """The default FL run (fused loop + megastep) at 32 tasks x 64
    trainers, then the stepped per-task path on the same world, held to
    it.  Returns the default run's kernel launches and wall seconds."""
    default = fl_measured(dev, smi, "default")
    stepped = fl_measured(dev, smi, "stepped", fused=False, megabatch=False)
    # on the card the megastep's batched products go through another
    # cuBLAS kernel (2,048 matrices at once, not 64): fl_divergence below
    # shows where the two part ways
    fl_hold(stepped["outputs"], default["outputs"],
            "fl default against stepped")
    windows = FL_RUN["rounds"]          # every task steps its rounds at once
    # every task is full and finishes in the last megastep window: ONE
    # task-axis model_distance launch settles them all
    expect = {
        "default": {"weighted_agg": windows, "model_distance": 1,
                    "block_pack": 1, "shard_seal": 0},
        "stepped": {"weighted_agg": FL_RUN["tasks"] * FL_RUN["rounds"],
                    "model_distance": FL_RUN["tasks"], "block_pack": 0,
                    "shard_seal": 0}}
    for label, run in (("default", default), ("stepped", stepped)):
        if run["launches"] != expect[label]:
            raise AssertionError(f"fl {label}: launches {run['launches']}, "
                                 f"expected {expect[label]}")
    log(f"fl: default path {default['wall']:.6f} s, stepped path "
        f"{stepped['wall']:.6f} s on {smi}; launches default "
        f"{json.dumps(default['launches'])}, stepped "
        f"{json.dumps(stepped['launches'])}")
    node, sch, out, _ = run_fl(torch.device("cpu"), FL_RUN, fused=False,
                               megabatch=False)
    cpu, card = fl_outputs(node, sch, out)["params"], \
        stepped["outputs"]["params"]
    gap = max(float(np.abs(card[t][k] - v).max())
              for t in cpu for k, v in cpu[t].items())
    log(f"fl: the stepped path on the card against the CPU: largest |param "
        f"difference| {gap} (the card's own float32 order, for scale)")
    fl_divergence(dev)
    return default["launches"], default["wall"]


def fl_divergence(dev) -> None:
    """Where the megastep and the per-task path part ways on the card: one
    forward pass and one cohort round of all 32 tasks at 64 trainers,
    batched over tasks against task by task, counting the elements whose
    bits differ; the round with sgdm's bfloat16 momentum and with float32
    momentum."""
    from torch.func import vmap

    from repro_torch.fl import cohort as tc
    from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
    t_n, k_n = FL_RUN["tasks"], FL_RUN["trainers"]
    model, _, _, batch_fn, dp = fl_world(dev, k_n, FL_RUN["local_steps"],
                                         FL_RUN["batch"])
    params = [model.init_params(t) for t in range(t_n)]
    batches = [batch_fn(np.arange(k_n), r) for r in range(t_n)]
    rows = [{k: v[None].expand((k_n,) + v.shape) for k, v in p.items()}
            for p in params]
    first = [{k: v[:, 0] for k, v in b.items()} for b in batches]
    one = torch.stack([vmap(model.logits)(r, b) for r, b in zip(rows, first)])
    batched = vmap(vmap(model.logits))(tc._tree_stack(rows),
                                       tc._tree_stack(first))
    found = {"logits": int((one != batched).sum()), "logits_of": one.numel()}
    keep = torch.ones(k_n, dtype=torch.bool, device=dev)
    for moment in ("bfloat16", "float32"):
        opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0,
                                           moment_dtype=moment))
        kern = tc.CohortKernels(model, opt, dp)
        opts = [tc._tree_expand(opt.init(p), k_n) for p in params]
        per = [kern.round_step(params[t], opts[t], batches[t], t, 0, ~keep,
                               keep, False) for t in range(t_n)]
        mega = kern.mega_round_step(
            tc._tree_stack(params), tc._tree_stack(opts),
            tc._tree_stack(batches), list(range(t_n)), [0] * t_n,
            ~keep[None].expand(t_n, k_n), keep[None].expand(t_n, k_n), False)
        sub = max(float((mega[0][k][t] - per[t][0][k]).abs().max())
                  for t in range(t_n) for k in params[0])
        flips = sum(int((mega[1]["m"][k][t] != per[t][1]["m"][k]).sum())
                    for t in range(t_n) for k in params[0])
        found[moment] = {"momentum_elements_differ": flips,
                         "largest_update_difference": sub}
    log(f"fl divergence (megastep against per task, one round, {t_n} x "
        f"{k_n}): {json.dumps(found)}")


def device_time(prof):
    """(number of device intervals, their union in µs, µs by name) of a
    torch.profiler trace."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return len(spans), busy_us, by_name


def fl_profile(dev, wall: float) -> None:
    """Device time of the FL path: the same run again under
    ``torch.profiler``; the union of its device intervals (kernels,
    copies, fills) over the traced wall and over the untraced ``wall``,
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, traced_wall = run_fl(dev, FL_RUN)
    n_spans, busy_us, by_name = device_time(prof)
    busy = busy_us / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"fl profile: {n_spans} device intervals, device busy "
        f"{busy:.6f} s = {busy / traced_wall:.6f} of the traced wall "
        f"{traced_wall:.6f} s and {busy / wall:.6f} of the untraced wall "
        f"{wall:.6f} s")
    log("fl profile: device seconds by name " + json.dumps(
        {name[:80]: us / 1e6 for name, us in top}))


# -- phases 8-10: the dense-transformer serving path ------------------------------

# yi-6b's attention at the prefill of phase 10 (B=8 of 4,096 tokens), and
# prefill_32k's sequence at one row
YI_LAYER = dict(B=8, S=4096, H=32, Hkv=4, dh=128)
LONG_LAYER = dict(B=1, S=32_768, H=32, Hkv=4, dh=128)
# moonshot-v1-16b-a3b's attention at the prefill of phase 13
MOON_LAYER = dict(B=4, S=4096, H=16, Hkv=16, dh=128)
# phase 10's cuts of the assigned shapes (configs/base.py SHAPES): prefill
# 32 x 32,768 -> 8 x 4,096 (the simple kernel's time on the chip); decode
# 128 x 32,768 -> 8 x 4,128 (decode_32k's cache at batch 128 is 256 GiB)
PREFILL = dict(batch=8, seq=4096)
DECODE = dict(batch=8, max_len=4128, steps=32)
# query rows held to the plain version at prefill_32k's sequence (its
# full scores would take 137 GB): the first, a middle and the last 256
LONG_ROWS = 256
# card against CPU on the reduced LMs: float32 sums in another order;
# bfloat16 a few bfloat16 steps on logits of order 3, as the CPU parity
# tests hold the port to the JAX package (tests/test_torch_transformer.py)
LM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=2e-2, atol=6e-2)}
# prefill against decode at full width: tests/test_arch_smoke.py:85's
# tolerance, over 32 (yi-6b) or 48 (moonshot) bfloat16 layers; xlstm-1.3b
# in float32 (its 48 exponential-gated layers amplify one bfloat16
# rounding a layer: the bfloat16 gap is logged beside the held one)
PREFILL_DECODE_TOL = dict(rtol=0.15, atol=0.15)
PREFILL_DECODE_TOL_F32 = dict(rtol=1e-2, atol=1e-2)


def sdpa(q, k, v):
    """One PyTorch call for the same function (the yardstick; the port
    never calls it): flash or memory-efficient backends only, so that it
    never materialises the scores."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)


def plain_rows(q, k, v, r0: int, r1: int) -> torch.Tensor:
    """The plain version's steps (kv repeated, float32 scores, -1e30 mask,
    softmax, cast) for the causal query rows [r0, r1) against keys
    [0, r1): the plain version on a slice of rows, where the whole (S, S)
    of scores would not fit."""
    dh, n_rep = q.shape[3], q.shape[2] // k.shape[2]
    k = k[:, :r1].repeat_interleave(n_rep, dim=2).to(torch.float32)
    v = v[:, :r1].repeat_interleave(n_rep, dim=2).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1].to(torch.float32),
                     k) * dh ** -0.5
    mask = (torch.arange(r0, r1, device=q.device)[:, None]
            >= torch.arange(r1, device=q.device)[None])
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def held(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """got within the kernel's tolerance (flash_attention.KERNEL_TOL) of
    want; the largest error, its share of the bound, and the median |want|
    it stands against."""
    from repro_torch.kernels.flash_attention import KERNEL_TOL
    tol = KERNEL_TOL[want.dtype]
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **tol,
                               msg=lambda m: f"flash_attention {what}: {m}")
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "of_bound": float((err / (tol["atol"] + tol["rtol"]
                                      * want.abs())).max()),
            "median_abs": float(want.abs().median())}


def check_attention(dev) -> dict:
    """flash_attention against its plain version on the card: the grid of
    tests/test_kernels.py:60-64 causal and not, head width 80, S = 4,097
    and ragged tails, float32 and bfloat16; then yi-6b's layer at the
    prefill of phase 10, (8, 4,096, 32, 4, 128) bfloat16, held on one
    batch row (the plain scores for all 8 are 17 GB) and timed beside its
    bound, the plain version (row by row) and SDPA; and prefill_32k's
    sequence at one row, held to the plain version on three slices of
    query rows and timed beside SDPA.  bfloat16 is held to one bfloat16
    step (flash_attention.KERNEL_TOL)."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)

    def qkv(B, S, H, Hkv, dh, dtype):
        return [torch.randn(B, S, n, dh, generator=g).to(dev, dtype)
                for n in (H, Hkv, Hkv)]

    f32, bf16 = torch.float32, torch.bfloat16
    grid = [(2, 256, 4, 2, 64), (1, 512, 8, 8, 32), (2, 256, 8, 2, 64),
            (1, 128, 4, 1, 128), (1, 256, 2, 2, 32), (2, 7, 4, 2, 16),
            (1, 4097, 4, 1, 128), (2, 33, 4, 1, 80), (1, 300, 8, 2, 80),
            (3, 65, 6, 3, 40), (1, 1, 2, 1, 128)]
    # where TMA's edges bite: S of 1, 65, 127 and 4,097 (a tail of one
    # row past a 128-row tile), dh 64 and 128, GQA 8:1 and 1:1
    grid += [(B, S, 8, hkv, dh) for S, B in ((1, 2), (65, 2), (127, 2),
                                              (4097, 1))
             for dh in (64, 128) for hkv in (1, 8)]
    err = {}
    n = 0
    for shape in grid:
        for dtype in (f32, bf16):
            q, k, v = qkv(*shape, dtype)
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal)
                want = fa.flash_attention_torch(q, k, v, causal)
                h = held(got, want, f"at {shape}")
                chosen = fa.flash_attention.last_form
                if chosen != fa.form(dtype, shape[4]):
                    raise AssertionError(f"flash_attention at {shape} "
                                         f"{dtype} ran form {chosen}")
                key = f"{chosen} {str(dtype)[6:]}"
                err[key] = max(err.get(key, 0.0), h["max_abs_err"])
                n += 1
    torch.cuda.synchronize()
    log(f"attention: flash_attention within tolerance of plain on {n} "
        f"inputs (float32 rtol 1e-4 atol 1e-5, bfloat16 {fa.KERNEL_TOL[bf16]}); "
        f"largest |kernel - plain| by form and dtype {json.dumps(err)}")

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    L = YI_LAYER
    q, k, v = qkv(L["B"], L["S"], L["H"], L["Hkv"], L["dh"], bf16)
    out = fa.flash_attention(q, k, v)
    if fa.flash_attention.last_form != "wgmma":
        raise AssertionError(f"flash_attention at {L} ran form "
                             f"{fa.flash_attention.last_form}")
    want = fa.flash_attention_torch(q[:1], k[:1], v[:1])
    h0 = held(out[:1], want, f"at {list(L.values())}, row 0")
    row_err = h0["max_abs_err"]
    # the row-slice reference against the plain version on the same rows
    S = L["S"]
    h_ref = held(plain_rows(q[:1], k[:1], v[:1], S - LONG_ROWS, S),
                 want[:, S - LONG_ROWS:], "plain_rows against plain")
    lib_err = float((sdpa(q, k, v).float() - out.float()).abs().max())
    del out, want
    cb = cost_bound("flash_attention", q, k, v)
    bound, bound_by = cb["bound_ms"], cb["bound_by"]
    row = {"name": "flash_attention", "max_abs_err": row_err,
           "ms": timed_ms(lambda: fa.flash_attention(q, k, v), 5, flush),
           "plain_ms": timed_ms(lambda: [fa.flash_attention_torch(
               q[b:b + 1], k[b:b + 1], v[b:b + 1]) for b in range(L["B"])],
               2, flush),
           "library_ms": timed_ms(lambda: sdpa(q, k, v), 5, flush),
           **cb,
           "shape": [L["B"], L["S"], L["H"], L["Hkv"], L["dh"]]}
    log(f"kernel flash_attention at {row['shape']} (bfloat16, causal, form "
        f"wgmma): {row['ms']:.6f} ms (bound {bound:.6f} ms, {bound_by}), "
        f"plain "
        f"{row['plain_ms']:.6f} ms (row by row), SDPA {row['library_ms']:.6f}"
        f" ms; row 0 against plain {json.dumps(h0)} (bound "
        f"{fa.KERNEL_TOL[bf16]}), its last {LONG_ROWS} rows' slice reference "
        f"against plain {json.dumps(h_ref)}; |kernel - SDPA| {lib_err} "
        f"(not held)")
    del q, k, v
    L = LONG_LAYER
    q, k, v = qkv(L["B"], L["S"], L["H"], L["Hkv"], L["dh"], bf16)
    out = fa.flash_attention(q, k, v)
    S = L["S"]
    mid = S // 2 - LONG_ROWS // 2
    spans = [(0, LONG_ROWS), (mid, mid + LONG_ROWS), (S - LONG_ROWS, S)]
    h_long = {f"{r0}:{r1}": held(out[:, r0:r1], plain_rows(q, k, v, r0, r1),
                                 f"at {list(L.values())}, rows {r0}:{r1}")
              for r0, r1 in spans}
    long_err = float((out.float() - sdpa(q, k, v).float()).abs().max())
    del out
    cb = cost_bound("flash_attention", q, k, v)
    bound, bound_by = cb["bound_ms"], cb["bound_by"]
    row["long"] = {
        "ms": timed_ms(lambda: fa.flash_attention(q, k, v), 2, flush),
        "plain_ms": None, "library_ms": timed_ms(lambda: sdpa(q, k, v), 2,
                                                 flush),
        **cb,
        "shape": [L["B"], L["S"], L["H"], L["Hkv"], L["dh"]]}
    t = row["long"]
    log(f"kernel flash_attention at {t['shape']} (bfloat16, causal): "
        f"{t['ms']:.6f} ms (bound {bound:.6f} ms, {bound_by}), SDPA "
        f"{t['library_ms']:.6f} ms; against plain on query rows "
        f"{json.dumps(h_long)}; |kernel - SDPA| {long_err} (not held); plain "
        f"ms: not measured (its scores would take 137 GB)")
    del q, k, v
    L = MOON_LAYER
    q, k, v = qkv(L["B"], L["S"], L["H"], L["Hkv"], L["dh"], bf16)
    h_moon = held(fa.flash_attention(q[:1], k[:1], v[:1]),
                  fa.flash_attention_torch(q[:1], k[:1], v[:1]),
                  f"at {list(L.values())}, row 0")
    cb = cost_bound("flash_attention", q, k, v)
    bound, bound_by = cb["bound_ms"], cb["bound_by"]
    row["moonshot"] = {
        "ms": timed_ms(lambda: fa.flash_attention(q, k, v), 5, flush),
        "library_ms": timed_ms(lambda: sdpa(q, k, v), 5, flush),
        **cb,
        "shape": [L["B"], L["S"], L["H"], L["Hkv"], L["dh"]]}
    t = row["moonshot"]
    log(f"kernel flash_attention at {t['shape']} (bfloat16, causal): "
        f"{t['ms']:.6f} ms (bound {bound:.6f} ms, {bound_by}), SDPA "
        f"{t['library_ms']:.6f} ms; row 0 against plain {json.dumps(h_moon)}")
    return row


@contextlib.contextmanager
def kernel_impl(impl):
    """Force the factory's impl (``REPRO_TORCH_KERNEL_IMPL``) inside the
    block; ``None`` leaves the default (the kernels on the card)."""
    old = os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
    if impl:
        os.environ["REPRO_TORCH_KERNEL_IMPL"] = impl
    try:
        yield
    finally:
        os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
        if old is not None:
            os.environ["REPRO_TORCH_KERNEL_IMPL"] = old


def lm_agree(dev) -> None:
    """The reduced dense LMs three ways (card with the kernel, card with
    the plain version forced, CPU) on one set of weights: prefill logits
    and caches, then three decode steps' logits, within LM_TOL."""
    import dataclasses
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.model import build_model
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(1)
    for arch in ("yi-6b", "qwen2-0.5b", "qwen1.5-0.5b", "qwen3-32b"):
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                      dtype=dt)
            host = tt.params_to_numpy(build_model(cfg, cpu).init_params(0))
            toks = torch.randint(0, cfg.vocab_size, (2, 73), generator=g)
            outs = {}
            for label, device, impl in (("card, kernel", dev, None),
                                        ("card, plain", dev, "torch"),
                                        ("cpu", cpu, None)):
                with kernel_impl(impl):
                    model = build_model(cfg, device)
                    params = tt.params_from_numpy(cfg, host, device=device,
                                                  dtype=dt)
                    logits, caches = model.prefill(
                        params, {"tokens": toks[:, :70]})
                    state = model.init_decode_state(2, 73)
                    for kv in ("k", "v"):
                        state["b0"][kv][:, :, :70] = caches["b0"][kv]
                    steps = []
                    for t in range(70, 73):
                        step, state = model.decode(params, state, {
                            "tokens": toks[:, t:t + 1], "pos": t})
                        steps.append(step)
                outs[label] = [logits, caches["b0"]["k"], caches["b0"]["v"],
                               *steps]
            gaps = {}
            for label in ("card, kernel", "card, plain"):
                for got, want in zip(outs[label], outs["cpu"]):
                    torch.testing.assert_close(
                        got.cpu().float(), want.float(), **LM_TOL[dt],
                        msg=lambda m, a=arch, d=dt, lb=label:
                        f"lm agree {a} {d} {lb}: {m}")
                gaps[label] = max(float((a.cpu().float() - b.float()).abs()
                                        .max()) for a, b in
                                  zip(outs[label], outs["cpu"]))
            log(f"lm agree {arch} ({cfg.head_dim}-wide heads, {dt}): "
                f"largest |card - CPU| {json.dumps(gaps)} (tolerance "
                f"{json.dumps(LM_TOL[dt])})")


def profile_share(fn, kernels=(("attention", "flash_attention_"),)
                  ) -> dict:
    """``fn`` under torch.profiler: the union of its device intervals over
    the traced wall, the part of it in each of ``kernels`` ((label, name
    fragment) pairs), and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, busy_us, by_name = device_time(prof)
    out = {"traced_wall_s": wall, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall}
    for label, fragment in kernels:
        us = sum(t for name, t in by_name.items() if fragment in name)
        out[f"{label}_s"] = us / 1e6
        out[f"{label}_share"] = us / busy_us if busy_us else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["top_s"] = {name[:60]: us / 1e6 for name, us in top}
    return out


# the kernels of the serving paths, by the fragment of their names in a
# profiler trace (flash_attention_kernel and flash_attention_wgmma_kernel;
# gmm_wgmma_kernel, gmm_stream_kernel and gmm_split_sum_kernel, ...;
# slstm_scan_kernel and slstm_cluster_kernel)
LM_KERNELS = {"flash_attention": "flash_attention_", "gmm": "::gmm_",
              "slstm_scan": "slstm_"}
# the form each serving kernel must take at full width: the prefill's and
# the decode's (flash_attention runs in the prefill only)
LM_FORMS = {"prefill": {"flash_attention": "wgmma", "gmm": "wgmma",
                        "slstm_scan": "cluster"},
            "decode": {"gmm": "stream", "slstm_scan": "cluster"}}


def lm_launches_expected(cfg) -> dict:
    """Launches of each serving kernel in one prefill (and one decode
    step, but for flash_attention, which decode bypasses)."""
    from repro_torch.models import transformer as tt
    specs = tt.block_specs(cfg) * cfg.n_periods
    return {"flash_attention": sum(m == "attn" for m, _ in specs),
            "gmm": 3 * sum(f == "moe" for _, f in specs),
            "slstm_scan": sum(m == "slstm" for m, _ in specs)}


def counted_prefill(model, params, tokens, timed_batch: int,
                    timed_s: float, smi: str) -> dict:
    """Phase 10 (d): one untimed pass of the prefill of ``tokens`` under
    ``analysis.hlo_cost.counting``: the counted FLOPs and bytes (each
    flash_attention launch at its registered cost), the launches it
    recorded, model_flops' prefill figure (exact parameter counts) and
    their ratio, dryrun.py's useful_flops_ratio; and the share of the bf16
    peak that phase 10's timed prefill (``timed_batch`` rows of the same
    length in ``timed_s``) reaches by model_flops."""
    from repro_torch.analysis.hlo_cost import counting
    from repro_torch.analysis.model_flops import model_flops
    from repro_torch.configs.base import ShapeConfig
    cfg = model.cfg
    B, S = tokens.shape
    plain_logits, _ = model.prefill(params, {"tokens": tokens})
    with counting() as cost:
        logits, _ = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    gap = float((logits.float() - plain_logits.float()).abs().max())
    torch.testing.assert_close(logits.float(), plain_logits.float(),
                               **LM_TOL["bfloat16"])
    launches = cost.launches("flash_attention")
    want = lm_launches_expected(cfg)["flash_attention"]
    if launches != want or cost.flops <= 0:
        raise AssertionError(f"counted prefill: {launches} flash_attention "
                             f"launches recorded, not {want}")
    mf = model_flops(cfg, ShapeConfig("counted", S, B, "prefill"), params)
    timed = model_flops(cfg, ShapeConfig("timed", S, timed_batch, "prefill"),
                        params)
    row = {"tokens": [B, S], "counted_flops": cost.flops,
           "counted_bytes": cost.bytes,
           "transcendentals": cost.transcendentals,
           "convert_bytes": cost.convert_bytes,
           "flash_attention_launches": launches,
           "model_flops": mf["model_flops_total"],
           "useful_flops_ratio": mf["model_flops_total"] / cost.flops,
           "timed_prefill": [timed_batch, S], "timed_prefill_s": timed_s,
           "timed_model_flops": timed["model_flops_total"],
           "bf16_peak_share": timed["model_flops_total"] / timed_s
           / BF16_TENSOR_FLOPS,
           "logits_gap_uncounted": gap}
    log(f"lm counted: the prefill of {B} x {S} tokens under counting() "
        f"(untimed; logits within {LM_TOL['bfloat16']} of an uncounted "
        f"pass) on {smi}: {json.dumps(row)}")
    return row


def lm_main(dev, smi: str, arch: str = "yi-6b", prefill=PREFILL,
            decode=DECODE, check_dtype=None, count: bool = False) -> dict:
    """``arch`` at full width and depth, bfloat16, weights drawn on the
    card: a 64-token prompt through prefill and through 64 decode steps
    (held to each other, in ``check_dtype`` if given, with weights of that
    dtype drawn from the same seed, and then the gap in bfloat16 is
    logged, not held; an MoE model with a capacity that drops nothing,
    since the prefill's queues overflow where a decode step's never do);
    the prefill of ``prefill`` tokens, each serving kernel's launches
    counted from 0 (with ``count``, then one row of it counted:
    ``counted_prefill``); the prefill's caches in a decode state (an xLSTM
    prefill emits none: its decode starts from the initial state, as in
    the JAX package) and ``decode["steps"]`` decode steps; the device
    shares under the profiler; then the serve loop of
    launch/serve_model.py at its defaults for ``arch``.  Returns the
    launch counts of the prefill."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.launch import serve_model
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    wrappers = {"flash_attention": fa.flash_attention, "gmm": gm.gmm,
                "slstm_scan": ss.slstm_scan}
    formed = (fa.flash_attention, gm.gmm, ss.slstm_scan)  # with forms
    expected = lm_launches_expected(cfg)

    def held_forms(stage: str, counts: dict) -> dict:
        """The forms each kernel's launches took in ``stage``: every
        launch of a kernel named in LM_FORMS[stage] must take its form."""
        taken = {name: dict(wrappers[name].form_launches)
                 for name in LM_FORMS[stage] if counts[name]}
        for name, got in taken.items():
            want = {LM_FORMS[stage][name]: counts[name]}
            if got != want:
                raise AssertionError(f"the {arch} {stage} ran {name} in the "
                                     f"forms {got}, not {want}")
        return taken
    tag = {"dense": "lm", "moe": "moe", "ssm": "xlstm"}[cfg.family]
    g = torch.Generator().manual_seed(2)
    model = build_model(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{tag}: {cfg.name} {cfg.n_layers} layers {cfg.pattern}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}, head_dim "
        f"{cfg.head_dim}), d_ff {cfg.d_ff}, moe {cfg.moe}, vocab "
        f"{cfg.vocab_size}: {n_params} parameters ({cfg.param_count()} "
        f"without norm scales), {2 * n_params / 1e9:.3f} GB in bfloat16, "
        f"drawn on the card in {time.perf_counter() - t0:.3f} s")
    log(f"{tag}: cuts from the assigned shapes: prefill_32k 32 x 32,768 -> "
        f"{prefill['batch']} x {prefill['seq']}; decode_32k 128 x 32,768 -> "
        f"{decode['batch']} x {decode['max_len']}")

    # a. prefill against decode at full width (also the warm-up)
    check, check_params, tol = model, params, PREFILL_DECODE_TOL
    if cfg.moe is not None:
        check = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)),
            dev)
    if check_dtype is not None:
        check = build_model(dataclasses.replace(cfg, dtype=check_dtype), dev)
        check_params, tol = check.init_params(0), PREFILL_DECODE_TOL_F32
    toks = torch.randint(0, cfg.vocab_size, (1, 64), generator=g).to(dev)

    def prefill_and_decode(m, p):
        last, caches = m.prefill(p, {"tokens": toks})
        state = m.init_decode_state(1, 64)
        for t in range(64):
            step, state = m.decode(p, state,
                                   {"tokens": toks[:, t:t + 1], "pos": t})
        torch.cuda.synchronize()
        return last, caches, state, step

    last, caches, state, step = prefill_and_decode(check, check_params)
    gap = float((step.float() - last.float()).abs().max())
    agree = bool((step.argmax(-1) == last.argmax(-1)).all())
    torch.testing.assert_close(step.float(), last.float(), **tol)
    # the K caches: all of them for a dense stack; for an MoE stack the
    # first layer's (the rest sit behind routing decisions that one
    # bfloat16 rounding of prefill against decode may flip at a near-tie:
    # their gap is logged, not held)
    held_periods = 1 if cfg.moe is not None else cfg.n_periods
    deeper = 0.0
    for b, kv in caches.items():
        got, want = state[b]["k"].float(), kv["k"].float()
        torch.testing.assert_close(got[:held_periods], want[:held_periods],
                                   **tol)
        if held_periods < cfg.n_periods:
            deeper = max(deeper, float((got[held_periods:]
                                        - want[held_periods:]).abs().max()))
    note = ""
    if cfg.moe is not None:
        note = (f"; K caches held on the first layer, the deeper layers' "
                f"largest gap {deeper} (not held)")
        capped, _ = model.prefill(params, {"tokens": toks})
        note += (f"; with capacity factor {cfg.moe.capacity_factor} (expert "
                f"queues of 8 for 64 x {cfg.moe.top_k} picks, which overflow)"
                f" the prefill's gap is "
                f"{float((capped.float() - step.float()).abs().max())} "
                f"(not held)")
    if check_dtype is not None:
        b_last, _, _, b_step = prefill_and_decode(model, params)
        note += (f"; in bfloat16 the gap is "
                 f"{float((b_step.float() - b_last.float()).abs().max())} "
                 f"(not held: the stack amplifies one rounding a layer)")
    log(f"{tag}: prefill against 64 decode steps at full width "
        f"({check_dtype or cfg.dtype}): largest |logit gap| {gap} "
        f"(tolerance {json.dumps(tol)}), argmax agrees: {agree}, logits "
        f"up to {float(last.float().abs().max())}{note}")
    del last, caches, state, step, check, check_params

    # b. prefill, every serving kernel's launches from 0
    B, S = prefill["batch"], prefill["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g).to(dev)
    for fn in wrappers.values():
        fn.launches = 0
    for fn in formed:
        fn.form_launches = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if launches != expected:
        raise AssertionError(f"the {arch} prefill launched {launches}, not "
                             f"{expected}")
    forms = {"prefill": held_forms("prefill", launches)}
    kv_shape = (cfg.n_periods, B, S, cfg.n_kv_heads, cfg.head_dim)
    kv_shapes = [tuple(kv["k"].shape) for kv in caches.values()]
    if tuple(logits.shape) != (B, cfg.vocab_size) or \
            any(shape != kv_shape for shape in kv_shapes) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill gave logits {tuple(logits.shape)}, "
                             f"caches {kv_shapes}")
    if count:
        counted_prefill(model, params, tokens[:1], B, prefill_s, smi)

    # c. decode against the prefill's caches
    state = model.init_decode_state(decode["batch"], decode["max_len"])
    for b, kv in caches.items():
        for name in ("k", "v"):
            state[b][name][:, :, :S] = kv[name]
    del caches
    tok = logits.argmax(-1)[:, None]
    for fn in wrappers.values():
        fn.launches = 0
    for fn in formed:
        fn.form_launches = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(S, S + decode["steps"]):
        logits, state = model.decode(params, state, {"tokens": tok,
                                                     "pos": t})
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = {name: fn.launches for name, fn in wrappers.items()}
    forms["decode"] = held_forms("decode", decode_launches)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode gave non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 2**30

    def decode_steps(n=8):
        nonlocal logits, state, tok
        for t in range(S, S + n):          # rewrites the first steps
            logits, state = model.decode(params, state, {"tokens": tok,
                                                         "pos": t})
            tok = logits.argmax(-1)[:, None]
    n_steps = decode["steps"]
    shares = tuple((name, fragment) for name, fragment in LM_KERNELS.items()
                   if expected[name])
    traced_decode = profile_share(decode_steps, shares)
    del state, logits, tok
    traced_prefill = profile_share(
        lambda: model.prefill(params, {"tokens": tokens}), shares)
    stats = {
        "prefill_s": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
        "decode_ms_per_step": decode_s / n_steps * 1e3,
        "decode_tokens_per_s": decode["batch"] * n_steps / decode_s,
        "peak_device_memory_GiB": peak, "prefill_launches": launches,
        "decode_launches": decode_launches, "forms": forms}
    log(f"{tag}: prefill {B} x {S} (its wall is the time to first token) and "
        f"{n_steps} decode steps at {decode['batch']} x {decode['max_len']} "
        f"on {smi}: {json.dumps(stats)}")
    log(f"{tag} profile: prefill {json.dumps(traced_prefill)}")
    log(f"{tag} profile: 8 more decode steps {json.dumps(traced_decode)}")
    del params, tokens
    torch.cuda.empty_cache()

    # d. the serve loop at its defaults (batch 4, prompt 8, 8 tokens)
    served = serve_model.main(["--arch", arch])
    torch.cuda.empty_cache()
    log(f"{tag}: serve_model at its defaults ({arch}, batch 4, prompt 8, 8 "
        f"tokens): {served['tokens_per_s']} tokens/s over "
        f"{served['seconds']} s, first row {served['tokens'][0].tolist()}")
    return {name: n for name, n in launches.items() if expected[name]}


# -- phases 11-14: the MoE and xLSTM serving paths ---------------------------

# moonshot-v1-16b-a3b's expert products (E, C, d, f) at phase 13's prefill
# (4 x 4,096 tokens: capacity 480 a row, the batch folded into C) and at
# its decode (the batch of 4 is one row: capacity 8); the gate and up
# products first, then the down product
MOONSHOT_GMM = [(64, 1920, 2048, 1408), (64, 1920, 1408, 2048)]
MOONSHOT_GMM_DECODE = [(64, 8, 2048, 1408), (64, 8, 1408, 2048)]
# xlstm-1.3b's sLSTM scan at phase 14's prefill
XLSTM_SCAN = dict(B=8, S=4096, nh=4, dh=512)
# slstm_scan's grid in phase 11, (B, S, nh, dh, dtype): the CPU tests' and
# batches over MAX_BATCH rows in both dtypes; then the cluster form
# (bfloat16) at dh 64 / 128 / 512 and 1 to 33 rows, S of 1, 37 and 4,096
SLSTM_GRID = [(B, S, nh, dh, dtype)
              for B, S, nh, dh in [(2, 32, 4, 16), (1, 64, 4, 16),
                                   (3, 16, 4, 16), (2, 1, 4, 16),
                                   (2, 37, 4, 16), (4, 20, 2, 12),
                                   (8, 64, 4, 512), (16, 8, 4, 64),
                                   (17, 6, 4, 512), (32, 6, 4, 512),
                                   (33, 5, 4, 16)]
              for dtype in (torch.float32, torch.bfloat16)] \
    + [(B, 37, 4, dh, torch.bfloat16) for dh in (64, 128, 512)
       for B in (1, 8, 16, 17, 33)] \
    + [(B, 1, 4, dh, torch.bfloat16) for dh in (64, 512) for B in (1, 8, 33)] \
    + [(1, 4096, 4, 64, torch.bfloat16), (17, 4096, 4, 128, torch.bfloat16),
       (16, 4096, 2, 512, torch.bfloat16)]
# phase 13's and 14's cuts of the assigned shapes: prefill_32k 32 x 32,768
# -> 4 x 4,096 (moonshot: its 56 GB of weights, the caches of the prefill
# and of the decode state must share 80 GB) and 8 x 4,096 (xlstm);
# decode_32k 128 x 32,768 -> 4 x 4,128 and 8 x 4,128
MOE_PREFILL = dict(batch=4, seq=4096)
MOE_DECODE = dict(batch=4, max_len=4128, steps=32)
XLSTM_PREFILL = dict(batch=8, seq=4096)
XLSTM_DECODE = dict(batch=8, max_len=4128, steps=32)
# a routing decision may differ between card and CPU only at a near-tie
# of the k-th and (k+1)-th gates
ROUTING_GAP = 1e-6


def check_moe_xlstm_kernels(dev) -> tuple:
    """gmm and slstm_scan against their plain versions on the card: the
    grids of the CPU tests (tests/test_kernels.py:84-89 and
    tests/test_slstm_kernel.py:22, plus ragged and unaligned shapes, S = 1
    and S = 37) in float32 and bfloat16; then at the main paths' shapes,
    bfloat16: gmm at moonshot's prefill and decode products, timed beside
    its bound, the plain version and torch.bmm; slstm_scan at xlstm-1.3b's
    prefill (8, 4,096, 2,048, 4 heads), timed beside its bound and the
    plain version.  Returns the two kernels' rows."""
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import slstm_scan as ss
    g = torch.Generator().manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    err, n = {}, 0
    # the CPU tests' grid, ragged and unaligned shapes, and where TMA's
    # edges bite: C of 33 and 1,921 (one row past a 128-row tile), f =
    # 200 (a 256-column tile 56 short), d of 72 and 1,100 (a short last
    # k-slice or split); every form runs
    for E, C, d, f in [(8, 96, 64, 200), (4, 128, 128, 512), (1, 8, 32, 64),
                       (3, 65, 40, 33), (2, 7, 24, 8), (3, 129, 37, 129),
                       (64, 8, 256, 176), (3, 30, 72, 300), (2, 33, 64, 128),
                       (2, 32, 1100, 40), (1, 1, 7, 5), (3, 33, 72, 200),
                       (2, 1921, 136, 200), (2, 1921, 64, 264),
                       (4, 8, 1104, 200), (3, 33, 1100, 200)]:
        for dtype in (f32, bf16):
            xe = torch.randn(E, C, d, generator=g).to(dev, dtype)
            w = torch.randn(E, d, f, generator=g).to(dev, dtype)
            got, want = gm.gmm(xe, w), gm.gmm_torch(xe, w)
            torch.testing.assert_close(
                got.float(), want.float(), **gm.kernel_tol(want),
                msg=lambda m, s=(E, C, d, f): f"gmm at {s}: {m}")
            chosen = gm.gmm.last_form
            if chosen != gm.form(dtype, C, d, f, True):
                raise AssertionError(f"gmm at {(E, C, d, f)} {dtype} ran "
                                     f"form {chosen}")
            key = f"{chosen} {str(dtype)[6:]}"
            err[key] = max(err.get(key, 0.0),
                           float((got.float() - want.float()).abs().max()))
            n += 1
    torch.cuda.synchronize()
    if {key.split()[0] for key in err} != set(gm.FORMS):
        raise AssertionError(f"the gmm grid ran the forms {sorted(err)}")
    log(f"moe kernels: gmm within gmm.kernel_tol of plain on {n} inputs "
        f"({json.dumps({str(k): v for k, v in gm.KERNEL_TOL.items()})}); "
        f"largest |kernel - plain| by form and dtype {json.dumps(err)}")
    # no backward through the kernels: it raises, it does not cut the graph
    xe = torch.randn(2, 40, 64, device=dev, requires_grad=True)
    wx = torch.randn(2, 3, 64, device=dev, requires_grad=True)
    for what, run in (("gmm", lambda: gm.gmm(xe, torch.randn(2, 64, 16,
                                                             device=dev))),
                      ("slstm_scan", lambda: ss.slstm_scan(
                          wx, torch.randn(1, 16, 64, device=dev),
                          *[torch.zeros(2, 16, device=dev)
                            for _ in range(4)])[0])):
        try:
            run().sum().backward()
        except NotImplementedError:
            continue
        raise AssertionError(f"a backward through {what} did not raise")
    log("moe/xlstm kernels: a backward through gmm or slstm_scan raises "
        "NotImplementedError")

    gd = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    gmm_rows = []
    for label, shapes in (("prefill", MOONSHOT_GMM),
                          ("decode", MOONSHOT_GMM_DECODE)):
        for E, C, d, f in shapes:
            xe = torch.randn(E, C, d, device=dev, generator=gd).to(bf16)
            w = (torch.randn(E, d, f, device=dev, generator=gd)
                 * d ** -0.5).to(bf16)
            got, want = gm.gmm(xe, w), gm.gmm_torch(xe, w)
            torch.testing.assert_close(
                got.float(), want.float(), **gm.kernel_tol(want),
                msg=lambda m, s=(E, C, d, f): f"gmm at {s}: {m}")
            cb = cost_bound("gmm", xe, w)
            bound, bound_by = cb["bound_ms"], cb["bound_by"]
            row = {"name": "gmm", "path": label, "shape": [E, C, d, f],
                   "form": gm.gmm.last_form,
                   "max_abs_err": float((got.float() - want.float()).abs()
                                        .max()),
                   "median_abs": float(want.float().abs().median()),
                   "ms": timed_ms(lambda: gm.gmm(xe, w), 5, flush),
                   "plain_ms": timed_ms(lambda: gm.gmm_torch(xe, w), 3,
                                        flush),
                   "library_ms": timed_ms(lambda: torch.bmm(xe, w), 5, flush),
                   **cb}
            gmm_rows.append(row)
            log(f"kernel gmm ({label}) at {row['shape']} (bfloat16, form "
                f"{row['form']}): "
                f"{row['ms']:.6f} ms (bound {bound:.6f} ms, {bound_by}), "
                f"plain {row['plain_ms']:.6f} ms, torch.bmm "
                f"{row['library_ms']:.6f} ms; |kernel - plain| "
                f"{row['max_abs_err']} (median |out| {row['median_abs']})")
            del xe, w, got, want

    err, n = {}, 0
    for B, S, nh, dh, dtype in SLSTM_GRID:
        d = nh * dh
        wx = (0.5 * torch.randn(B, S, 4 * d, generator=g)).to(dev, dtype)
        r = (torch.randn(nh, dh, 4 * dh, generator=g)
             * dh ** -0.5).to(dev, dtype)
        # a live state: the plain scan's after 5 steps of other inputs
        state = [torch.zeros(B, d, device=dev) for _ in range(3)] + \
            [torch.full((B, d), -1e30, device=dev)]
        warm = (0.5 * torch.randn(B, 5, 4 * d, generator=g)).to(dev, dtype)
        state = list(ss.slstm_scan_torch(warm, r, *state)[1])
        chosen = ss.form(dtype, B, nh, dh)
        before = ss.slstm_scan.launches
        y, carry = ss.slstm_scan(wx, r, *state)
        launched = ss.slstm_scan.launches - before
        if launched != (1 if chosen == "cluster"
                        else -(-B // ss.MAX_BATCH)) \
                or ss.slstm_scan.last_form != chosen:
            raise AssertionError(f"slstm_scan at {(B, S, nh, dh)} "
                                 f"{dtype} launched {launched} times, "
                                 f"last in the {ss.slstm_scan.last_form}"
                                 f" form")
        want_y, want_carry = ss.slstm_scan_torch(wx, r, *state)
        key = f"{chosen} {str(dtype)[6:]}"
        for got, want in zip((y, *carry), (want_y, *want_carry)):
            torch.testing.assert_close(
                got, want, **ss.KERNEL_TOL,
                msg=lambda m, sh=(B, S, nh, dh):
                f"slstm_scan at {sh}: {m}")
            err[key] = max(err.get(key, 0.0),
                           float((got - want).abs().max()))
        n += 1
    torch.cuda.synchronize()
    log(f"xlstm kernels: slstm_scan within {ss.KERNEL_TOL} of plain on {n} "
        f"inputs (grid-form batches of 17, 32 and 33 rows in launches of "
        f"{ss.MAX_BATCH}; cluster-form batches in one launch); largest "
        f"|kernel - plain| by form and dtype {json.dumps(err)}")

    L = XLSTM_SCAN
    d = L["nh"] * L["dh"]
    wx = (0.5 * torch.randn(L["B"], L["S"], 4 * d, device=dev,
                            generator=gd)).to(bf16)
    r = (torch.randn(L["nh"], L["dh"], 4 * L["dh"], device=dev, generator=gd)
         * L["dh"] ** -0.5).to(bf16)
    state = [torch.zeros(L["B"], d, device=dev) for _ in range(3)] + \
        [torch.full((L["B"], d), -1e30, device=dev)]
    clusters = ss.cluster_capacity(dev, L["B"], L["nh"], L["dh"])
    y, carry = ss.slstm_scan(wx, r, *state)
    if ss.slstm_scan.last_form != "cluster":
        raise AssertionError(f"slstm_scan at {L} ran the "
                             f"{ss.slstm_scan.last_form} form")
    want_y, want_carry = ss.slstm_scan_torch(wx, r, *state)
    scan_err = 0.0
    for got, want in zip((y, *carry), (want_y, *want_carry)):
        torch.testing.assert_close(got, want, **ss.KERNEL_TOL,
                                   msg=lambda m: f"slstm_scan at {L}: {m}")
        scan_err = max(scan_err, float((got - want).abs().max()))
    cb = cost_bound("slstm_scan", wx, r, *state)
    bound, bound_by = cb["bound_ms"], cb["bound_by"]
    # the grid form (the kernel this form replaced at this shape) and the
    # cluster form in turns, at the prefill's scan and at a decode step's
    w1 = wx[:, :1].contiguous()
    times = {("grid", "prefill"): [], ("cluster", "prefill"): [],
             ("grid", "decode"): [], ("cluster", "decode"): []}
    for chosen in ("grid", "cluster", "cluster", "grid"):
        times[chosen, "prefill"].append(timed_ms(
            lambda: ss._launch(wx, r, *state, chosen=chosen), 3, flush))
        times[chosen, "decode"].append(timed_ms(
            lambda: ss._launch(w1, r, *state, chosen=chosen), 20, flush))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    scan_row = {"name": "slstm_scan", "shape": list(L.values()),
                "form": "cluster", "max_abs_err": scan_err,
                "ms": mean["cluster", "prefill"],
                "grid_form_ms": mean["grid", "prefill"],
                "decode_ms": mean["cluster", "decode"],
                "decode_grid_form_ms": mean["grid", "decode"],
                "plain_ms": timed_ms(lambda: ss.slstm_scan_torch(wx, r,
                                                                 *state),
                                     1, flush),
                "library_ms": None, **cb, "clusters_resident": clusters}
    scan_row["us_per_step"] = scan_row["ms"] * 1e3 / L["S"]
    scan_row["grid_form_us_per_step"] = \
        scan_row["grid_form_ms"] * 1e3 / L["S"]
    turns = json.dumps({" ".join(k): v for k, v in times.items()})
    log(f"kernel slstm_scan at {scan_row['shape']} (bfloat16 wx and r, "
        f"float32 state), cluster form ({clusters} clusters of "
        f"{L['dh'] // ss.CLUSTER_DIMS} blocks fit the card at once): "
        f"{scan_row['ms']:.6f} ms, {scan_row['us_per_step']:.3f} us a step "
        f"(bound {bound:.6f} ms, {bound_by}: {ss.PIECES} bfloat16 products "
        f"on the tensor cores); the grid form it replaced "
        f"{scan_row['grid_form_ms']:.6f} "
        f"ms, {scan_row['grid_form_us_per_step']:.3f} us a step (timed in "
        f"turns: grid, cluster, cluster, grid; {turns}); "
        f"a decode step (S = 1): cluster {scan_row['decode_ms']:.6f} ms, "
        f"grid {scan_row['decode_grid_form_ms']:.6f} ms; plain "
        f"{scan_row['plain_ms']:.6f} ms (a step-by-step loop), no PyTorch "
        f"call computes it; |kernel - plain| {scan_err} (median |y| "
        f"{float(want_y.abs().median())})")
    return gmm_rows, scan_row


def mixer_stage(cfg, blk, x, positions=None, state=None, pos=None):
    """x plus the block's mixer delta, and the attention's (k, v) (prefill)
    or the layer's new state (decode; an attention layer's caches are the
    views in ``state``, written in place)."""
    from repro_torch.models import attention as at
    from repro_torch.models import xlstm as xl
    from repro_torch.models.layers import apply_norm
    mixer = blk.spec[0]
    if mixer == "attn":
        h = apply_norm(cfg, x, blk.ln)
        if state is None:
            delta, (k, v) = at.attention_block(cfg, blk.attn, h, positions,
                                               return_cache=True)
            return x + delta, {"k": k, "v": v}
        delta = at.decode_attention_block(cfg, blk.attn, h, state["k"],
                                          state["v"], pos)
        return x + delta, state
    fn = xl.mlstm_block if mixer == "mlstm" else xl.slstm_block
    delta, new = fn(cfg, getattr(blk, mixer), x, state)
    return x + delta, new


def ffn_body(cfg, blk, hf, single):
    from repro_torch.models import moe as mo
    from repro_torch.models.layers import swiglu
    if blk.spec[1] == "moe":
        p = {k: getattr(blk, k) for k in ("router", "moe_wg", "moe_wu",
                                          "moe_wo")}
        return (mo.moe_ffn_single if single else mo.moe_ffn)(cfg, p, hf)
    return swiglu(hf, blk.wi_gate, blk.wi_up, blk.w_down)


def layerwise(cfg, ref, card, toks, dev, what, n_decode=2) -> float:
    """The card model against the CPU model ``ref`` layer by layer, each
    stage fed the CPU's activations: the mixer (with its caches or state),
    the FFN's norm and the FFN (routing compared first: a decision may
    differ only at a near-tie under ROUTING_GAP, and then its token is
    left out of that FFN's comparison), then the head; the prefill of
    ``toks`` and ``n_decode`` decode steps from its caches.  Held at
    LM_TOL.  Returns the largest |card - CPU|."""
    from repro_torch.models import moe as mo
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import apply_norm
    tol = LM_TOL[cfg.dtype]
    worst = 0.0

    def hold(got, want, stage, rows=None):
        nonlocal worst
        got, want = got.cpu().float(), want.float()
        if rows is not None:
            got, want = got[rows], want[rows]
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{what} {stage}: {m}")
        if got.numel():
            worst = max(worst, float((got - want).abs().max()))

    def ffn(rblk, cblk, xm, stage, single):
        if rblk.spec[1] == "none":
            return xm
        hf = apply_norm(cfg, xm, rblk.ln2)
        hold(apply_norm(cfg, xm.to(dev), cblk.ln2), hf, stage + " ln2")
        rows = None
        if rblk.spec[1] == "moe":
            k = cfg.moe.top_k
            gates = torch.softmax(hf.float() @ rblk.router, -1)
            _, want_idx = mo.route_topk(hf.float() @ rblk.router, k)
            _, got_idx = mo.route_topk(hf.to(dev).float() @ cblk.router, k)
            rows = (got_idx.cpu().sort(-1).values
                    == want_idx.sort(-1).values).all(-1)
            top = gates.sort(-1, descending=True).values
            gap = top[..., k - 1] - top[..., k]
            if (~rows).any() and float(gap[~rows].max()) >= ROUTING_GAP:
                raise AssertionError(f"{what} {stage}: routing differs "
                                     f"beyond a near-tie")
            if single:
                rows = rows.reshape(-1)
        out = ffn_body(cfg, rblk, hf, single)
        hold(ffn_body(cfg, cblk, hf.to(dev), single), out, stage + " ffn",
             rows)
        return xm + out

    B, S = toks.shape
    x, positions = tt.embed_inputs(cfg, ref, {"tokens": toks})
    state = tt.init_decode_state(cfg, B, S + n_decode, device="cpu")
    for layer, j, i in tt._layer_items(cfg):
        rblk, cblk, stage = ref.blocks[layer], card.blocks[layer], \
            f"layer {layer}"
        xm, extra = mixer_stage(cfg, rblk, x, positions)
        got, got_extra = mixer_stage(cfg, cblk, x.to(dev), positions.to(dev))
        hold(got, xm, stage + " mixer")
        if rblk.spec[0] == "attn":
            for name in ("k", "v"):
                hold(got_extra[name], extra[name], f"{stage} {name}")
                state[f"b{i}"][name][j, :, :S] = extra[name]
        x = ffn(rblk, cblk, xm, stage, single=False)
    hold(apply_norm(cfg, x.to(dev), card.final_norm) @ card.head_w,
         apply_norm(cfg, x, ref.final_norm) @ ref.head_w, "head")
    nxt = torch.randint(0, cfg.vocab_size, (B, n_decode),
                        generator=torch.Generator().manual_seed(S))
    for step in range(n_decode):
        x = torch.nn.functional.embedding(nxt[:, step:step + 1], ref.embed)
        for layer, j, i in tt._layer_items(cfg):
            rblk, cblk = ref.blocks[layer], card.blocks[layer]
            stage = f"decode {step} layer {layer}"
            st = {k: v[j] for k, v in state[f"b{i}"].items()}
            cst = {k: v.to(dev) for k, v in st.items()}
            xm, new = mixer_stage(cfg, rblk, x, state=st, pos=S + step)
            got, got_new = mixer_stage(cfg, cblk, x.to(dev), state=cst,
                                       pos=S + step)
            hold(got, xm, stage + " mixer")
            for name in new:
                hold(got_new[name], new[name], f"{stage} state {name}")
                st[name].copy_(new[name])
            x = ffn(rblk, cblk, xm, stage, single=True)
        hold(apply_norm(cfg, x.to(dev), card.final_norm) @ card.head_w,
             apply_norm(cfg, x, ref.final_norm) @ ref.head_w,
             f"decode {step} head")
    return worst


def moe_xlstm_agree(dev) -> None:
    """The reduced moonshot, kimi and xlstm three ways (card with the
    kernels, card with the plain versions forced, CPU) on one set of
    weights, float32 and bfloat16, layer by layer on the CPU's
    activations (``layerwise``): the deeper stacks amplify one rounding
    difference into gaps that say nothing of the kernels."""
    import dataclasses
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.models import transformer as tt
    from repro_torch.models.model import build_model
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(4)
    for arch in ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "xlstm-1.3b"):
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                      dtype=dt)
            host = tt.params_to_numpy(build_model(cfg, cpu).init_params(0))
            ref = tt.params_from_numpy(cfg, host, device=cpu, dtype=dt)
            toks = torch.randint(0, cfg.vocab_size, (2, 73), generator=g)
            gaps, launched = {}, {}
            for label, impl in (("card, kernel", None),
                                ("card, plain", "torch")):
                before = gm.gmm.launches + ss.slstm_scan.launches
                with kernel_impl(impl):
                    card = tt.params_from_numpy(cfg, host, device=dev,
                                                dtype=dt)
                    gaps[label] = layerwise(cfg, ref, card, toks, dev,
                                            f"moe/xlstm agree {arch} {dt} "
                                            f"{label}")
                launched[label] = gm.gmm.launches + ss.slstm_scan.launches \
                    - before
            if not launched["card, kernel"] or launched["card, plain"]:
                raise AssertionError(f"{arch}: kernel launches {launched}")
            log(f"moe/xlstm agree {arch} ({dt}, layer by layer on the CPU's "
                f"activations): largest |card - CPU| {json.dumps(gaps)} "
                f"(tolerance {json.dumps(LM_TOL[dt])}); kernel launches "
                f"{json.dumps(launched)}")
    moe_deterministic(dev)


def moe_deterministic(dev) -> None:
    """The reduced moonshot's MoE FFN in bfloat16 twice on the card, on
    the same weights and input: bit-equal (its combine adds each token's
    expert rows in a fixed order, no atomics), with the prefill's gmm form
    and the decode's (moe_ffn_single, C = 8)."""
    import dataclasses
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.kernels import gmm as gm
    from repro_torch.models import moe
    cfg = dataclasses.replace(reduced_config(get_config(
        "moonshot-v1-16b-a3b")), dtype="bfloat16")
    gd = torch.Generator(device=dev).manual_seed(6)
    p = moe.init_moe_params(cfg, torch.bfloat16, gd, dev)
    x = torch.randn(4, 512, cfg.d_model, device=dev, generator=gd).to(
        torch.bfloat16)
    runs, forms = [], []
    for fn, arg in ((moe.moe_ffn, x), (moe.moe_ffn_single, x[:, :1])):
        for _ in range(2):
            gm.gmm.form_launches = {}
            runs.append(fn(cfg, p, arg))
            forms.append(dict(gm.gmm.form_launches))
    torch.cuda.synchronize()
    for a, b, what in ((runs[0], runs[1], "prefill"),
                       (runs[2], runs[3], "decode")):
        if not torch.equal(a, b):
            gap = float((a.float() - b.float()).abs().max())
            raise AssertionError(f"two card runs of moe_ffn ({what}) differ "
                                 f"by {gap}")
    log(f"moe agree: the reduced moonshot's moe_ffn bit-equal over two card "
        f"runs, prefill {tuple(x.shape)} (gmm forms {forms[0]}) and decode "
        f"{tuple(x[:, :1].shape)} (gmm forms {forms[2]})")


# -- phase 15: the object ledger and the agent path ----------------------------

# the Fig. 4/5 grid: benchmarks/bench_l2_throughput.py:15-31
OBJ_RATES = (160, 320, 640)
OBJ_DURATION = 20.0
# the Table I replay: benchmarks/bench_gas.py:33-40
OBJ_CALLS = (5, 20, 50, 100)
# the sequential baseline: benchmarks/bench_protocol.py:127-150 at its
# assert point (16 tasks x 64 trainers); and the agreement point
OBJ_SEQ = dict(tasks=16, trainers=64, rounds=3, local_steps=2, batch=8)
OBJ_AGREE = dict(tasks=2, trainers=16, rounds=2, local_steps=2, batch=8)
# the object Rollup's digest buffers: 4 words a tx, 20 txs a batch, and a
# flush's remainder of one or 21 txs
OBJ_DIGEST_WORDS = (4, 8, 80, 84)


def object_spec(**kw):
    from repro_torch.api import ChainSpec, NodeSpec
    return NodeSpec(chain=ChainSpec(backend="object"), **kw)


def object_digests(dev, flush) -> dict:
    """rollup_digest at the object Rollup's buffer sizes, on views offset
    by 0-3 words, bit-equal to its plain version; one launch a call; and
    timed at a 20-tx batch (80 words) beside its bound and the plain
    version."""
    from repro_torch.kernels import rollup_digest as rd
    g = torch.Generator(device=dev).manual_seed(15)
    base = torch.randint(-2**31, 2**31 - 1, (128,), dtype=torch.int32,
                         device=dev, generator=g)
    worst = 0
    for n in OBJ_DIGEST_WORDS:
        for off in range(4):
            w = base[off: off + n]
            before = rd.rollup_digest.launches
            got = rd.rollup_digest(w)
            if rd.rollup_digest.launches != before + 1:
                raise AssertionError(f"rollup_digest at {n} words took "
                                     f"{rd.rollup_digest.launches - before} "
                                     f"launches")
            worst = max(worst, u32_err(got, rd.rollup_digest_torch(w)))
    if worst:
        raise AssertionError(f"rollup_digest at the object batch sizes "
                             f"differs from its plain version by {worst}")
    w = base[:80]
    ms = timed_ms(lambda: rd.rollup_digest(w), 200, flush)
    plain = timed_ms(lambda: rd.rollup_digest_torch(w), 200, flush)
    row = {"words": list(OBJ_DIGEST_WORDS), "offsets": [0, 1, 2, 3],
           "max_abs_err": worst, "ms_at_80": ms, "plain_ms_at_80": plain,
           "bound_ms_at_80": cost_bound("rollup_digest", w)["bound_ms"]}
    log(f"object digests: {json.dumps(row)}")
    return row


def object_grid(dev) -> None:
    """(a) The Fig. 4/5 grid through simulate_load on the object chain and
    on the vector chain, on the card and on the CPU: all four equal; L2
    TPS = ROLLUP_BATCH x the L1 peak, by function."""
    from repro_torch.api import ChainSpec
    from repro_torch.core.gas import FUNCTIONS, ROLLUP_BATCH
    from repro_torch.core.ledger import simulate_load
    cpu = torch.device("cpu")
    rows, walls = [], {}
    for fn in FUNCTIONS:
        peak = 0.0
        for rate in OBJ_RATES:
            got = {}
            for backend in ("object", "vector"):
                for label, device in (("card", dev), ("cpu", cpu)):
                    t0 = time.perf_counter()
                    got[backend, label] = simulate_load(
                        fn, rate, duration=OBJ_DURATION, device=device,
                        spec=ChainSpec(backend=backend))
                    key = f"{backend}/{label}"
                    walls[key] = walls.get(key, 0.0) + \
                        time.perf_counter() - t0
            ref = got["object", "cpu"]
            for key, m in got.items():
                if m != ref:
                    raise AssertionError(f"object grid {fn} at {rate} tx/s:"
                                         f" {key} {m} != object/cpu {ref}")
            peak = max(peak, ref["throughput"])
        rows.append({"fn": fn, "l1_peak_tps": peak,
                     "l2_tps": ROLLUP_BATCH * peak})
    log(f"object grid: {len(FUNCTIONS)} functions x rates {OBJ_RATES} for "
        f"{OBJ_DURATION} s (up to {int(max(OBJ_RATES) * OBJ_DURATION)} txs "
        f"a run): object == vector, card == CPU, every metric")
    log(f"object grid: {json.dumps(rows)}")
    log(f"object grid: host seconds by engine/device {json.dumps(walls)}")


def object_table1(dev) -> None:
    """(b) bench_gas.py's Table I replay through build_stack on the object
    backend, on the card and on the CPU: gas logs equal, totals within the
    bench's 10 % of l2_gas, every batch digest from the kernel equal to
    the plain version's on the same words (one launch a batch)."""
    from repro_torch.api import build_stack
    from repro_torch.core.engine import TxArrays
    from repro_torch.core.gas import FUNCTIONS, gas_reduction, l2_gas
    from repro_torch.core.ledger import Tx
    from repro_torch.kernels import rollup_digest as rd
    cpu = torch.device("cpu")
    rows, max_red, n_batches = [], 0.0, 0
    rd.rollup_digest.launches = 0
    for fn in FUNCTIONS:
        for n in OBJ_CALLS:
            logs = {}
            for label, device in (("card", dev), ("cpu", cpu)):
                chain, ru = build_stack(object_spec(), device=device)
                for i in range(n):
                    ru.submit(Tx(fn, f"c{i}", {}, 0, i * 0.01))
                ru.flush()
                chain.run_until(5.0)
                logs[label] = (ru.gas_log, [b.word_digest
                                            for b in ru.batches],
                               [b.block_hash for b in chain.blocks])
                if label == "card":
                    n_batches += len(ru.batches)
                    for b0 in range(0, n, ru.batch_size):
                        txs = [Tx(fn, f"c{i}", {}, 0, i * 0.01)
                               for i in range(b0, min(n, b0 + ru.batch_size))]
                        words = TxArrays.from_txs(txs, device=device
                                                  ).word_buffer()
                        want = int(rd.rollup_digest_torch(words)) & 0xFFFFFFFF
                        if ru.batches[b0 // ru.batch_size].word_digest != want:
                            raise AssertionError(f"Table I {fn} x {n}: batch "
                                                 f"{b0 // ru.batch_size} "
                                                 f"digest off the plain one")
            if logs["card"] != logs["cpu"]:
                raise AssertionError(f"Table I {fn} x {n}: card != CPU")
            live = sum(r["total"] for r in logs["card"][0])
            model = l2_gas(fn, n)["total"]
            if abs(live - model) / model >= 0.1:
                raise AssertionError(f"Table I {fn} x {n}: live L2 gas {live}"
                                     f" vs the model's {model}")
            red = gas_reduction(fn, n)
            max_red = max(max_red, red)
            rows.append({"fn": fn, "n": n, "L2_live": live,
                         "L2_model": model, "reduction": red})
    if rd.rollup_digest.launches != n_batches:
        raise AssertionError(f"Table I: {rd.rollup_digest.launches} "
                             f"rollup_digest launches for {n_batches} "
                             f"batches")
    if max_red < 20.0:
        raise AssertionError(f"Table I: largest reduction {max_red} < 20")
    log(f"object table1: {json.dumps(rows)}")
    log(f"object table1: card == CPU (gas logs, digests, block hashes); "
        f"live L2 within 10 % of the model; {n_batches} batch digests, one "
        f"rollup_digest launch each, equal to the plain version; largest "
        f"reduction {max_red}")


def obj_world(dev, n_trainers: int, local_steps: int, batch: int):
    """bench_protocol.py's sequential world on ``dev``: fl_world's model,
    optimizer and data, and its per-agent batch_fn (one batch of ``batch``
    rows a local step, numpy index streams)."""
    model, opt, val, _, dp = fl_world(dev, n_trainers, local_steps, batch)
    from repro_torch.data.synthetic import gaussian_clusters
    d = FL_MODEL
    tr_x, tr_y = gaussian_clusters(4096, d["d_in"], d["n_classes"], seed=1)
    tx, ty = torch.from_numpy(tr_x).to(dev), torch.from_numpy(tr_y).to(dev)

    def bf(c, r):
        idx = np.random.default_rng((c * 9973 + r) % 2**31).integers(
            0, len(tr_x), batch)
        i = torch.from_numpy(idx).to(dev)
        return {"x": tx[i], "labels": ty[i]}
    return model, opt, val, bf, dp


def obj_agents(dev, node, cfg, world, behaviors=None):
    from repro_torch.fl.client import ClientConfig, TrainingAgent
    model, opt, _, bf, dp = world
    n = cfg["trainers"]
    behaviors = behaviors or ["good"] * n
    return [TrainingAgent(ClientConfig(f"trainer{i}", behaviors[i], dp=dp,
                                       local_steps=cfg["local_steps"]),
                          model, opt, node.store, bf, seed=i, device=dev)
            for i in range(n)]


def object_sequential(dev, smi: str) -> dict:
    """(c) The sequential protocol baseline on the card: AutoDFL on the
    protocol-sequential spec (the object Chain and Rollup), 64
    TrainingAgents, a warm-up task of one round and 16 run_task calls of 3
    rounds (host seconds by phase, each ending in a synchronize); launch
    counts from before the warm-up.  Then one more task under
    torch.profiler (the device's busy share), and the default Scheduler
    on NodeSpec() at the same point (a warm-up run, then the measured one)
    and the ratio of their rates."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import FLTaskSpec
    from repro_torch.core.gas import DEFAULT_GAS, L1_DEFAULT_GAS
    from repro_torch.core.ledger import Chain
    from repro_torch.core.rollup import Rollup
    from repro_torch.fl import scheduler as fl_sched
    from repro_torch.fl import server as fl_server
    from repro_torch.fl.client import TrainingAgent
    from repro_torch.fl.server import AutoDFL
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import model_distance as md
    from repro_torch.kernels import rollup_digest as rd
    from repro_torch.kernels import weighted_agg as wa
    cfg = OBJ_SEQ
    n, tasks = cfg["trainers"], cfg["tasks"]
    world = obj_world(dev, n, cfg["local_steps"], cfg["batch"])
    model, opt, val, _, _ = world
    node = AutoDFL(model, opt, n, model.accuracy_fn(), val,
                   spec=object_spec(trainer_funds=10.0 * (tasks + 2),
                                    publisher_funds=100.0 * (tasks + 2)),
                   device=dev)
    agents = obj_agents(dev, node, cfg, world)
    wrappers = {"rollup_digest": rd.rollup_digest,
                "rollup_chunk_digests": rd.rollup_chunk_digests,
                "dirty_fold": df.dirty_fold,
                "weighted_agg": wa.weighted_agg,
                "model_distance": md.model_distance}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    node.run_task(FLTaskSpec("warmup", rounds=1), agents)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    calls0 = dict(node.protocol_calls)
    gas0 = sum(r["total"] for r in node.rollup.gas_log)
    clock = PhaseClock()
    for owner, attr, phase in (
            (TrainingAgent, "train_round", "train"),
            (fl_sched, "evaluate_quorum", "quorum"),
            (fl_sched, "weighted_average_tree", "eq1"),
            (fl_sched.TaskRuntime, "_finalize", "eq4"),
            (fl_server, "end_of_multitask_update", "eq2_10"),
            (Rollup, "seal_batch", "seal"),
            (Chain, "run_until", "blocks")):
        clock.wrap(owner, attr, phase)
    t0 = time.perf_counter()
    try:
        for t in range(tasks):
            res = node.run_task(FLTaskSpec(f"task{t}",
                                           rounds=cfg["rounds"]), agents)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        clock.restore()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    spans = dict(clock.seconds)
    spans["rest"] = wall - sum(spans.values())
    delta = {fn: k - calls0.get(fn, 0) for fn, k in node.protocol_calls.items()}
    n_txs = sum(delta.values())
    l1_equiv = sum(DEFAULT_GAS.l1_per_call.get(fn, L1_DEFAULT_GAS) * k
                   for fn, k in delta.items())
    l2 = sum(r["total"] for r in node.rollup.gas_log) - gas0
    expect = {"rollup_digest": len(node.rollup.batches),
              "weighted_agg": tasks * cfg["rounds"] + 1,
              "model_distance": tasks + 1}
    for name, k in expect.items():
        if launches[name] != k:
            raise AssertionError(f"object sequential: {launches[name]} "
                                 f"{name} launches, expected {k}")
    if not launches["rollup_chunk_digests"] or not launches["dirty_fold"]:
        raise AssertionError(f"object sequential: the state root launched "
                             f"no fold kernel {launches}")
    st = node.rollup.state_arrays
    if int(st.submissions[: st.n].sum()) != \
            node.protocol_calls["submitLocalModel"]:
        raise AssertionError("object sequential: state counters miss "
                             "submissions")
    root = node.rollup.state_root()
    from repro_torch.core.state import StateArrays
    if root != StateArrays.from_numpy(st.to_numpy(), "cpu").root():
        raise AssertionError("object sequential: the root differs from the "
                             "CPU root of its fields")
    for k, v in res.global_params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"object sequential: non-finite {k}")
    acc = float(node.eval_fn(res.global_params, node.val_batch))
    stats = {"tasks": tasks, "trainers": n, "rounds": cfg["rounds"],
             "warmup_s": warm, "wall_s": wall, "protocol_txs": n_txs,
             "tps": n_txs / wall, "l1_equivalent_gas": int(l1_equiv),
             "l2_gas": int(l2), "gas_reduction": l1_equiv / l2,
             "batches": len(node.rollup.batches),
             "l1_blocks": len(node.chain.blocks) - 1,
             "last_task_val_acc": acc, "launches": launches}
    log(f"object sequential: {json.dumps(stats)}")
    log(f"object sequential: wall {wall:.6f} s for {n_txs} protocol txs, "
        f"{n_txs / wall:.1f} tx/s on {smi}; host seconds by phase (each "
        f"ends in a synchronize) {json.dumps(spans)}; calls "
        f"{json.dumps(clock.calls)}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        node.run_task(FLTaskSpec("profiled", rounds=cfg["rounds"]), agents)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    n_spans, busy_us, by_name = device_time(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"object sequential profile: one more task, {n_spans} device "
        f"intervals, device busy {busy_us / 1e6:.6f} s = "
        f"{busy_us / 1e6 / traced:.6f} of the traced wall {traced:.6f} s; "
        f"device seconds by name " + json.dumps(
            {name[:80]: us / 1e6 for name, us in top}))
    # the default Scheduler at the same point (bench_protocol.py's other
    # side), warmed up on a throwaway run as the bench does
    run_fl(dev, cfg)
    node_s, sch, _, wall_s = run_fl(dev, cfg)
    tps_s = sum(node_s.protocol_calls.values()) / wall_s
    log(f"object sequential: the default Scheduler on NodeSpec() at "
        f"{tasks} x {n}: {sum(node_s.protocol_calls.values())} txs in "
        f"{wall_s:.6f} s, {tps_s:.1f} tx/s ({sch.mega_windows} megastep "
        f"windows); ratio to the sequential baseline {tps_s / stats['tps']}"
        f" on {smi}")
    return launches


def host_agent_noise(agent, kind, shapes):
    """The agents' draws from a host generator each (seeded by the agent's
    seed), moved to the agent's device: the card and the CPU see the same
    numbers."""
    g = getattr(agent, "_host_generator", None)
    if g is None:
        g = agent._host_generator = torch.Generator().manual_seed(agent.seed)
    return {k: torch.randn(shapes[k], generator=g).to(agent.device)
            for k in sorted(shapes)}


def obj_run(dev, cfg, behaviors, spec=None, scheduler=False):
    """``cfg['tasks']`` tasks of TrainingAgents through run_task (or one
    Scheduler) on the object stack: ``AutoDFL()`` from legacy kwargs when
    ``spec`` is None."""
    from repro_torch.api import FLTaskSpec
    from repro_torch.fl.scheduler import Scheduler
    from repro_torch.fl.server import AutoDFL
    world = obj_world(dev, cfg["trainers"], cfg["local_steps"],
                      cfg["batch"])
    model, opt, val, _, _ = world
    kw = ({"trainer_funds": 50.0} if spec is None else {"spec": spec})
    node = AutoDFL(model, opt, cfg["trainers"], model.accuracy_fn(), val,
                   device=dev, **kw)
    specs = [FLTaskSpec(f"task{t}", rounds=cfg["rounds"])
             for t in range(cfg["tasks"])]
    if scheduler:
        sch = Scheduler(node)
        for s in specs:
            sch.add_task(s, obj_agents(dev, node, cfg, world, behaviors))
        out = sch.run()
    else:
        out = {s.task_id: node.run_task(s, obj_agents(dev, node, cfg, world,
                                                      behaviors))
               for s in specs}
    return node, out


def obj_outputs(node, out) -> dict:
    from repro_torch.core.state import StateArrays
    st = node.rollup.state_arrays
    fields = st.to_numpy()
    return {
        "protocol_calls": dict(node.protocol_calls),
        "gas_log": node.rollup.gas_log,
        "blocks": [(b.height, b.time, len(b.txs), b.gas_used)
                   for b in node.chain.blocks],
        "block_hashes": [b.block_hash for b in node.chain.blocks],
        "total_gas": node.chain.total_gas,
        "selected": {t: node.tsc.tasks[t].trainers for t in out},
        "event_kinds": [e.kind for e in node.client().events(cursor=0)],
        "scores": {t: r.scores.tolist() for t, r in out.items()},
        "counters": {k: fields[k].tolist() for k in
                     ("tasks_published", "submissions", "rep_events")},
        "params": {t: {k: v.cpu().numpy() for k, v in
                       r.global_params.items()} for t, r in out.items()},
        "reputation": node.book.reputation.cpu().numpy(),
        "payouts": {t: r.payouts for t, r in out.items()},
        "init": {k: v.cpu().numpy()
                 for k, v in node.model.init_params(0).items()},
        "root": node.rollup.state_root(),
        "cpu_root": StateArrays.from_numpy(fields, "cpu").root(),
    }


def object_agree(dev) -> None:
    """(d) The agent path at 2 tasks x 16 trainers, 2 rounds, three ways
    (card with kernels, card with the plain versions forced, CPU), the
    agents' noise drawn on the host so that all three see the same
    numbers: protocol calls, gas log, block stops, selections, DON scores
    and the state counters exact; parameters, reputations and payouts as
    fl_hold holds them; each run's root the CPU root of its fields.  Then
    on the card: AutoDFL() with no spec equals spec=NodeSpec.from_legacy()
    (gas log, blocks with their hashes, root), and a Scheduler of one
    agent task equals run_task on the object engine, bit for bit."""
    from repro_torch.api import NodeSpec
    from repro_torch.fl import client as fl_client
    cfg = OBJ_AGREE
    behaviors = ["good", "good", "malicious", "lazy"] * (cfg["trainers"] // 4)
    default_noise = fl_client.agent_noise
    fl_client.agent_noise = host_agent_noise
    outs = {}
    try:
        for label, device, impl in (("card, kernels", dev, None),
                                    ("card, plain", dev, "torch"),
                                    ("cpu", torch.device("cpu"), None)):
            old = os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
            if impl:
                os.environ["REPRO_TORCH_KERNEL_IMPL"] = impl
            try:
                node, out = obj_run(device, cfg, behaviors)
            finally:
                os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
                if old is not None:
                    os.environ["REPRO_TORCH_KERNEL_IMPL"] = old
            outs[label] = o = obj_outputs(node, out)
            if o["root"] != o["cpu_root"]:
                raise AssertionError(f"object agree {label}: root "
                                     f"{o['root']} != the CPU root of its "
                                     f"fields {o['cpu_root']}")
            log(f"object agree {label}: {type(node.chain).__name__} + "
                f"{type(node.rollup).__name__}, "
                f"{sum(o['protocol_calls'].values())} protocol calls, "
                f"{len(o['gas_log'])} batches, {len(o['blocks']) - 1} "
                f"blocks, root {o['root']} (= the CPU root of its fields)")
        ref = outs["cpu"]
        for label, o in outs.items():
            fl_hold(ref, o, f"object agree {label} against the CPU")
            if o["counters"] != ref["counters"]:
                raise AssertionError(f"object agree {label}: state counters")
        log(f"object agree: card (kernels), card (plain) and CPU agree over "
            f"{cfg['tasks']} tasks x {cfg['trainers']} trainers, "
            f"{cfg['rounds']} rounds")
        # the Scheduler packs blocks at its window edges, run_task at the
        # end: their blocks differ, their gas and everything else do not
        same = ("protocol_calls", "gas_log", "selected", "scores",
                "counters", "root", "payouts", "total_gas")
        pairs = (("AutoDFL() against spec=NodeSpec.from_legacy()",
                  obj_run(dev, cfg, behaviors),
                  obj_run(dev, cfg, behaviors,
                          spec=NodeSpec.from_legacy(trainer_funds=50.0)),
                  same + ("blocks", "block_hashes", "event_kinds")),
                 ("a Scheduler of one agent task against run_task",
                  obj_run(dev, dict(cfg, tasks=1), behaviors,
                          spec=object_spec(), scheduler=True),
                  obj_run(dev, dict(cfg, tasks=1), behaviors,
                          spec=object_spec()), same))
        for what, a, b, keys in pairs:
            oa, ob = obj_outputs(*a), obj_outputs(*b)
            for key in keys:
                if oa[key] != ob[key]:
                    raise AssertionError(f"object agree, {what}: {key}")
            for t in oa["params"]:
                for k, v in oa["params"][t].items():
                    if not np.array_equal(v, ob["params"][t][k]):
                        raise AssertionError(f"object agree, {what}: {t} {k}")
            if not np.array_equal(oa["reputation"], ob["reputation"]):
                raise AssertionError(f"object agree, {what}: reputation")
            log(f"object agree on the card: {what}: equal bit for bit "
                f"(root {oa['root']})")
    finally:
        fl_client.agent_noise = default_noise


# -- phase 16: the sharded fabric ------------------------------------------------

# the "shard-fabric" point of benchmarks/bench_shards.py (the preset of
# src/repro/api/presets.py:34-36): Table I's mixed blend at 20,000 tx/s
# for 10 s, seed 0, at 1, 2, 4 and 8 shards with hash routing
FABRIC_POINT = dict(rate=20_000.0, duration=10.0, seed=0)
FABRIC_SHARDS = (1, 2, 4, 8)
FABRIC_REPS = 3                  # bench_shards.py's best-of-N a point
FABRIC_TWIN_SHARDS = 8
FL_FABRIC_SHARDS = 8
FL_AGREE_SHARDS = 2


def fabric_spec(k: int, **kw):
    from repro_torch.api import NodeSpec, ShardSpec
    return NodeSpec(shards=ShardSpec(count=k, fabric=True), **kw)


def lane_grid(lanes, dev, offset: int = 0):
    """(words, starts, n_seg, n_words) of ``shard_seal``'s contract on
    ``dev`` from host lanes ``[(words u32, starts), ...]``: the word grid
    a view ``offset`` words into each row of its allocation (each row
    then starts off the 16-byte grid by a different amount), starts
    padded with the lane's word count."""
    k = len(lanes)
    n_words = np.array([w.size for w, _ in lanes], np.int64)
    n_seg = np.array([len(s) for _, s in lanes], np.int64)
    width = max(1, int(n_words.max()))
    words = np.zeros((k, width + offset), np.uint32)
    starts = np.repeat(n_words[:, None], max(1, int(n_seg.max())), 1)
    for i, (w, st) in enumerate(lanes):
        words[i, offset: offset + w.size] = w
        starts[i, : len(st)] = st
    grid = torch.from_numpy(words.view(np.int32)).to(dev)[:, offset:]
    return (grid, torch.from_numpy(starts).to(dev),
            torch.from_numpy(n_seg).to(dev), torch.from_numpy(n_words).to(dev))


def shard_seal_cases(g) -> list:
    """shard_seal's hard inputs (those of tests/test_torch_gpu.py): K of
    1, 2, 8 and 64 lanes of unequal length; an empty lane; 4,096 one-word
    segments; a 16 MB lane as one segment; power-law segment lengths (1
    to 10^5 words); views offset by 1-3 words.  (label, lanes, offset)."""
    def lane(n, n_seg=None, lengths=None, one_word=False):
        w = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        if lengths is not None:
            st = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        elif one_word:
            st = np.arange(n)
        elif n_seg:
            st = np.concatenate([[0], np.sort(g.choice(
                np.arange(1, n), n_seg - 1, replace=False))])
        else:
            st = np.zeros(0, np.int64)
        return w, np.asarray(st, np.int64)

    power = []
    while sum(power) < 1_000_000:
        power.append(int(10 ** g.uniform(0, 5)))
    unequal = [lane(int(n), int(s)) for n, s in
               zip(g.integers(1_000, 300_000, 8), g.integers(1, 900, 8))]
    return [
        ("K=1", [lane(200_000, 2_500)], 0),
        ("K=2 unequal", [lane(50_000, 600), lane(3_000_000, 40_000)], 0),
        ("K=8 unequal", unequal, 0),
        ("K=64", [lane(int(n), int(s)) for n, s in zip(
            g.integers(100, 20_000, 64), g.integers(1, 99, 64))], 0),
        ("empty lane", [lane(5_000, 70), lane(0), lane(9_000, 1)], 0),
        ("4,096 one-word segments", [lane(4096, one_word=True),
                                     lane(4096, 3)], 0),
        ("16 MB lane, one segment", [lane(4 << 20, 1)], 0),
        ("power-law lengths", [lane(sum(power), lengths=power),
                               lane(200_000, 2_500)], 0),
    ] + [(f"offset {off}", unequal[:4], off) for off in (1, 2, 3)]


def lane_views(words, starts, n_seg, n_words) -> list:
    """Each lane's (words, starts), as views: one batch_seal launch a lane
    is the per-lane form shard_seal replaces (no PyTorch call computes
    it)."""
    ns, nw = n_seg.tolist(), n_words.tolist()
    return [(words[k, : nw[k]], starts[k, : ns[k]])
            for k in range(len(ns)) if ns[k]]


def per_lane_seals(lanes) -> list:
    """One batch_seal launch a lane of ``lane_views``."""
    from repro_torch.kernels import batch_seal as bs
    return [bs.batch_seal(w, st) for w, st in lanes]


def check_shard_seal(dev, calls, flush) -> dict:
    """(a) shard_seal bit-equal to its plain version at its hard cases,
    the mesh impl equal to the wrapper; then at the fused fabric twin's
    two calls (captured), timed by CUDA events and the profiler's device
    time beside its bytes bound, the plain version and K batch_seal
    launches on the same lanes.  Returns the kernels line's row (the
    twin's roots call)."""
    from repro_torch.kernels import shard_lanes as sl
    g = np.random.default_rng(16)
    before = sl.shard_seal.launches
    n_cases = 0
    for label, lanes, offset in shard_seal_cases(g):
        args = lane_grid(lanes, dev, offset)
        got = sl.shard_seal(*args)
        want = sl.shard_seal_torch(*args)
        if u32_err(got, want):
            raise AssertionError(f"shard_seal at {label}: differs from "
                                 f"its plain version")
        if not torch.equal(sl.shard_seal_mesh(*args), got):
            raise AssertionError(f"shard_seal's mesh impl at {label}: "
                                 f"differs from the wrapper")
        n_cases += 1
    torch.cuda.synchronize()
    if sl.shard_seal.launches != before + 2 * n_cases:
        raise AssertionError("shard_seal: not one launch a call")
    log(f"kernel shard_seal: bit-equal to plain on {n_cases} cases (K of "
        f"1 to 64, an empty lane, one-word segments, a 16 MB lane, "
        f"power-law lengths, views offset by 1-3 words); the mesh impl "
        f"equal to the wrapper")
    rows = []
    for label, args in zip(("roots", "seal digests"), calls):
        words, starts, n_seg, n_words = args
        err = u32_err(sl.shard_seal(*args), sl.shard_seal_torch(*args))
        views = lane_views(*args)
        lanes = torch.cat(per_lane_seals(views))
        real = torch.arange(starts.shape[1], device=dev)[None] < \
            n_seg[:, None]
        err = max(err, u32_err(sl.shard_seal(*args)[real], lanes))
        if err:
            raise AssertionError(f"shard_seal at the fused fabric twin's "
                                 f"{label}: differs from plain or from the "
                                 f"per-lane batch_seal")
        k, b = starts.shape
        sum_w, sum_b = int(n_words.sum()), int(n_seg.sum())
        row = {"name": "shard_seal", "max_abs_err": err,
               "lanes": k, "words": sum_w, "segments": sum_b,
               "grid": [k, int(words.shape[1])],
               "ms": timed_ms(lambda: sl.shard_seal(*args), 50, flush),
               "device_ms": device_ms(lambda: sl.shard_seal(*args),
                                      "shard_seal_span_kernel", 20, flush),
               "plain_ms": timed_ms(lambda: sl.shard_seal_torch(*args), 5,
                                    flush),
               **cost_bound("shard_seal", *args),
               "library_ms": None,
               # the per-launch ticket buffer: one fill of K words
               "tickets_zero_ms": timed_ms(lambda: torch.zeros(
                   k, dtype=torch.int32, device=dev), 50, flush),
               "lanes_batch_seal_ms": timed_ms(
                   lambda: per_lane_seals(views), 20, flush),
               "lanes_batch_seal_device_ms": device_ms(
                   lambda: per_lane_seals(views), "batch_seal_span_kernel",
                   10, flush, per_call=len(views))}
        log(f"kernel shard_seal at the fused fabric twin's {label}: "
            f"bit-equal to plain and to {len(views)} per-lane "
            f"batch_seal launches; {json.dumps(row)}")
        rows.append(row)
    return rows[0]


def fabric_twin(workload, dev, *, k: int, fused: bool, until=None):
    """run_twin's raw-ledger window loop on a K-shard fabric (hash
    routing): per window submit / seal / pump / run_until, then flush and
    run the L1 to ``until`` (or drain it in 100 s steps).  Returns
    (client, outputs, wall seconds ending in a synchronize)."""
    from repro_torch.api import NodeClient
    from repro_torch.core.fused import FusedWindowLoop
    client = NodeClient.from_spec(fabric_spec(k), device=dev)
    chain, fabric = client.chain, client.target
    loop = FusedWindowLoop(chain, fabric) if fused else None
    face, blocks = (loop, loop) if fused else (fabric, chain)
    txs = workload.txs
    times = txs.submit_time.cpu().numpy()
    n_windows = int(workload.duration)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(n_windows):
        lo, hi = (int(i) for i in np.searchsorted(times, [w, w + 1.0]))
        batch = txs.select(slice(lo, hi))
        if fused:
            loop.submit(fabric, batch)
        else:
            fabric.submit_arrays(batch)
        face.seal()
        face.pump(w + 1.0)
        blocks.run_until(w + 1.0)
    face.flush()
    if until is None:
        t = float(n_windows)
        while chain.n_confirmed < chain.n_submitted:
            if t > n_windows + 1e5:
                raise AssertionError("the L1 mempool does not drain")
            t += 100.0
            chain.run_until(t)
    else:
        blocks.run_until(until)
    if fused:
        loop.execute()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wire = {}
    for r in fabric.interconnect.log:
        wire.setdefault(r["kind"], []).append(r)
    out = {"blocks": [(b.height, b.time, b.n_txs, b.gas_used, b.start,
                       b.stop, b.block_hash) for b in chain.blocks],
           "gas_log": fabric.gas_log, "batch_digests": fabric.batch_digests,
           "fabric_roots": fabric.fabric_roots, "wire": wire,
           "event_kinds": [e.kind for e in client.events(cursor=0)],
           "root": client.state_root()}
    return client, out, wall


def fused_fabric(dev, workload, smi: str):
    """(c) The node workload through fabric_twin on 8 shards, stepped,
    then fused (shard_seal, batch_seal and block_pack launch counts from
    0): equal gas logs (with ``shard``), blocks, batch digests, fabric
    roots, interconnect logs (per kind) and event kinds; exactly two
    shard_seal launches, no batch_seal launch and one block_pack launch.
    Returns the arguments of the two shard_seal calls."""
    from repro_torch.core import fused as fused_mod
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import block_pack as bp
    from repro_torch.kernels import shard_lanes as sl
    k = FABRIC_TWIN_SHARDS
    _, stepped, stepped_wall = fabric_twin(workload, dev, k=k, fused=False)
    captured = []
    real = fused_mod.get_kernel

    def spy(op, impl=None):
        fn = real(op, impl)
        if op != "shard_seal":
            return fn

        def recorded(*args):
            captured.append(args)
            return fn(*args)
        return recorded
    fused_mod.get_kernel = spy
    for fn in (sl.shard_seal, bs.batch_seal, bp.block_pack):
        fn.launches = 0
    try:
        _, fused, fused_wall = fabric_twin(workload, dev, k=k, fused=True,
                                           until=stepped["blocks"][-1][1])
    finally:
        fused_mod.get_kernel = real
    launches = {"shard_seal": sl.shard_seal.launches,
                "batch_seal": bs.batch_seal.launches,
                "block_pack": bp.block_pack.launches}
    twins_equal(stepped, fused, "fused fabric against stepped")
    if launches != {"shard_seal": 2, "batch_seal": 0, "block_pack": 1} or \
            len(captured) != 2:
        raise AssertionError(f"the fused fabric run launched {launches} in "
                             f"{len(captured)} shard_seal calls")
    if {r["shard"] for r in fused["gas_log"]} != set(range(k)):
        raise AssertionError("a shard of the fused fabric sealed nothing")
    log(f"fused fabric: {len(workload)} txs over {k} shards, "
        f"{len(fused['blocks']) - 1} L1 blocks, {len(fused['gas_log'])} "
        f"batches, {len(fused['fabric_roots'])} fabric roots: gas log, "
        f"blocks, digests, fabric roots, interconnect logs and event kinds "
        f"equal to the stepped fabric; wall stepped {stepped_wall:.6f} s, "
        f"fused {fused_wall:.6f} s on {smi}; launches {json.dumps(launches)}")
    return captured, launches["shard_seal"]


def fabric_point(wl, k: int, dev) -> dict:
    """One point of bench_shards.py's _run_point on the card: the whole
    workload into a K-shard fabric (build_stack, default state handlers),
    each shard's seal timed alone (ending in a synchronize), the window
    merged, the sessions settled and drained, one settlement scatter of
    the whole state recorded, the L1 run for the workload's duration and
    5 s more; fold kernel launches from 0."""
    from repro_torch.api import build_stack
    from repro_torch.core.state import default_state_handlers
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import rollup_digest as rd
    wrappers = {"batch_seal": bs.batch_seal,
                "rollup_digest": rd.rollup_digest,
                "rollup_chunk_digests": rd.rollup_chunk_digests,
                "dirty_fold": df.dirty_fold}
    for fn in wrappers.values():
        fn.launches = 0
    chain, fabric = build_stack(fabric_spec(k), fns=wl.txs.fns, device=dev)
    for fn, handler in default_state_handlers().items():
        fabric.register_state(fn, handler)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fabric.submit_arrays(wl.txs)
    torch.cuda.synchronize()
    submit_wall = time.perf_counter() - t0
    ic = fabric.interconnect
    lane_walls, nbs = [], []
    for s in fabric.shards:
        t1 = time.perf_counter()
        nbs.append(s.seal())
        torch.cuda.synchronize()
        lane_walls.append(time.perf_counter() - t1)
    gather_before = ic.totals["root_gather_s"]
    fabric._finish_window(nbs)
    root_gather_s = ic.totals["root_gather_s"] - gather_before
    fabric.settle_session()
    fabric.prover.drain()
    settle_scatter_s = ic.record_settle_scatter(fabric.state.n)
    torch.cuda.synchronize()
    seal_wall = time.perf_counter() - t0
    chain.run_until(wl.duration + 5.0)
    n = len(wl)
    if sum(r["n_txs"] for r in fabric.gas_log) != n:
        raise AssertionError("every tx must seal in exactly one shard")
    wall_window_s = max(lane_walls) + root_gather_s + settle_scatter_s
    return {"n_shards": k, "n_txs": n, "n_batches": fabric.n_batches,
            "seal_wall_s": seal_wall,
            "fabric_latency_s": fabric.latency(n),
            "sealed_batch_tps": fabric.sealed_batch_throughput(n),
            "wall": {"submit_wall_s": submit_wall,
                     "lane_seal_s": lane_walls,
                     "max_lane_seal_s": max(lane_walls),
                     "sum_lane_seal_s": sum(lane_walls),
                     "root_gather_s": root_gather_s,
                     "settle_scatter_s": settle_scatter_s,
                     "wall_window_s": wall_window_s,
                     "wall_tps": n / wall_window_s},
            "interconnect": ic.summary(),
            "launches": {name: fn.launches
                         for name, fn in wrappers.items()},
            "state_root": fabric.state_root(),
            "fabric_root": fabric.fabric_root()}


def fabric_node(dev, smi: str) -> None:
    """(b) bench_shards.py's "shard-fabric" point on the card: a warm-up
    point, then K = 1, 2, 4 and 8 (the best of three runs each) and
    K = 8 again.  The state root equal
    at every K and in both K = 8 runs, the fabric root reproduced; the
    modeled 8-against-1 sealed-batch scaling at least 3x (the
    reference's assert), the measured one printed."""
    from repro_torch.core.workloads import make_workload
    wl = make_workload("mixed", device=dev, **FABRIC_POINT)
    fabric_point(wl, FABRIC_SHARDS[0], dev)            # warm-up, discarded
    points = {}
    for k in FABRIC_SHARDS:
        # the best of FABRIC_REPS by measured wall (the roots, gas and
        # model fields repeat exactly), as bench_shards.py takes it
        points[k] = p = max((fabric_point(wl, k, dev)
                             for _ in range(FABRIC_REPS)),
                            key=lambda q: q["wall"]["wall_tps"])
        log(f"fabric node: {json.dumps(p)}")
    again = fabric_point(wl, FABRIC_SHARDS[-1], dev)
    roots = {k: p["state_root"] for k, p in points.items()}
    if len(set(roots.values())) != 1 or \
            again["state_root"] != roots[FABRIC_SHARDS[-1]]:
        raise AssertionError(f"the state root depends on the shard count "
                             f"or the run: {roots}, {again['state_root']}")
    if again["fabric_root"] != points[FABRIC_SHARDS[-1]]["fabric_root"]:
        raise AssertionError("the fabric root does not reproduce")
    hi, lo = points[FABRIC_SHARDS[-1]], points[FABRIC_SHARDS[0]]
    scaling = hi["sealed_batch_tps"] / lo["sealed_batch_tps"]
    wall_scaling = hi["wall"]["wall_tps"] / lo["wall"]["wall_tps"]
    if scaling < 3.0:
        raise AssertionError(f"modeled {FABRIC_SHARDS[-1]}-shard scaling "
                             f"{scaling:.3f}x, under the reference's 3x")
    log(f"fabric node: {len(wl)} txs; state root {roots[1]} at every K and "
        f"again at K = {FABRIC_SHARDS[-1]}, fabric root reproduced; "
        f"modeled sealed-batch scaling {FABRIC_SHARDS[-1]} against "
        f"{FABRIC_SHARDS[0]} shards {scaling:.6f}x (reference floor 3x), "
        f"measured wall scaling {wall_scaling:.6f}x; max lane seal "
        f"{json.dumps({k: p['wall']['max_lane_seal_s'] for k, p in points.items()})}"
        f" s on {smi}")


def fabric_fl(dev, smi: str) -> int:
    """(d) The FL run at 32 tasks x 64 trainers on an 8-shard fabric, the
    default Scheduler (fused + megastep; launch counts from 0: two
    shard_seal launches for the run) and the stepped per-task path, held
    to each other as phase 7 holds them; then the 4 x 16 run on 2 shards
    three ways, as phase 6.  Returns the default run's shard_seal
    launches."""
    from repro_torch.api import ShardSpec
    shards = ShardSpec(count=FL_FABRIC_SHARDS)
    default = fl_measured(dev, smi, f"fabric {FL_FABRIC_SHARDS} default",
                          shards=shards)
    stepped = fl_measured(dev, smi, f"fabric {FL_FABRIC_SHARDS} stepped",
                          shards=shards, fused=False, megabatch=False)
    fl_hold(stepped["outputs"], default["outputs"],
            "fl fabric default against stepped")
    expect = {
        "default": {"weighted_agg": FL_RUN["rounds"], "model_distance": 1,
                    "block_pack": 1, "shard_seal": 2},
        "stepped": {"weighted_agg": FL_RUN["tasks"] * FL_RUN["rounds"],
                    "model_distance": FL_RUN["tasks"], "block_pack": 0,
                    "shard_seal": 0}}
    for label, run in (("default", default), ("stepped", stepped)):
        if run["launches"] != expect[label]:
            raise AssertionError(f"fl fabric {label}: launches "
                                 f"{run['launches']}, expected "
                                 f"{expect[label]}")
    log(f"fl fabric: default {default['wall']:.6f} s, stepped "
        f"{stepped['wall']:.6f} s on {FL_FABRIC_SHARDS} shards on {smi}")
    fl_agree(dev, ShardSpec(count=FL_AGREE_SHARDS))
    return default["launches"]["shard_seal"]


# -- phase 17: the node service ------------------------------------------------

# benchmarks/bench_serve.py's full mode (:130-132): the spam point and its
# honest control, and the poisson point (on the 2-shard fabric here)
SERVE_POINT = dict(n_honest=1000, n_spammers=24, honest_rate=300.0,
                   spam_rate=1200.0, duration=30.0, pool_cap=512,
                   window=1.0, seed=0)
SERVE_HONEST_FN = "submitLocalModel"        # dearer intrinsic gas
SERVE_SPAM_FN = "calculateSubjectiveRep"    # the cheapest target
SERVE_RETENTION = 0.8                       # bench_serve.py:183-185
SERVE_SHARDS = 2
# cross_verify_aggregate at the FL path's shape: 64 trainers' TinyMLP(64,
# 32, 10) (2,410 parameters), the global model plus a local update each
XV_TRAINERS, XV_UPDATE = 64, 0.01
SERVE_TOL = 1e-6


def serve_spec(node, n_clients: int):
    """bench_serve.py's _serve_spec: the default admission rules at its
    pool cap, a queue of one in-flight op a client and 64 more."""
    from repro_torch.api import AdmissionSpec, ServeSpec
    return ServeSpec(node=node,
                     admission=AdmissionSpec(pool_cap=SERVE_POINT["pool_cap"]),
                     queue_cap=n_clients + 64, window=SERVE_POINT["window"])


def serve_txs(wl) -> tuple:
    """A workload's (times, fn names, sender ids) on the host."""
    t = wl.txs
    names = t.fns.names
    return (t.submit_time.cpu().numpy(),
            [names[f] for f in t.fn_id.tolist()], t.sender_id.cpu().numpy())


def serve_drive(txs, duration: float, spec, dev, hooks=None) -> dict:
    """bench_serve.py's _drive through the port's NodeService on ``dev``:
    one asyncio client a sender, each submitting its own transactions in
    modeled-time order, all clients in lockstep epochs of one window.
    ``txs``: host arrays (``serve_txs``), made before the clock starts.
    ``hooks``: (start, stop), called just inside the clock (a profiler).
    Returns the service, the wall and what bench_serve.py reads."""
    import asyncio
    from repro_torch.serve import NodeService
    times, names, senders = txs
    n_epochs = int(duration / spec.window) + 2
    by_sender = {}
    for i in range(len(times)):
        epoch = min(int(times[i] / spec.window), n_epochs - 1)
        by_sender.setdefault(int(senders[i]),
                             [[] for _ in range(n_epochs)])[epoch].append(i)

    async def run():
        svc = await NodeService(spec, device=dev).start()
        ref_sender = {}

        async def one_client(sid, idxs):
            for i in idxs:
                r = await svc.submit(names[i], f"c{sid}", at=float(times[i]))
                if "ref" in r:
                    ref_sender[r["ref"]] = sid
                await asyncio.sleep(0)          # interleave with peers
        for k in range(n_epochs):
            await asyncio.gather(*(one_client(s, per_epoch[k])
                                   for s, per_epoch in sorted(
                                       by_sender.items())
                                   if per_epoch[k]))
        await svc.close()
        return svc, ref_sender

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if hooks:
        hooks[0]()
    svc, ref_sender = asyncio.run(run())
    torch.cuda.synchronize()
    if hooks:
        hooks[1]()
    wall = time.perf_counter() - t0
    committed = {}
    for ref, rec in svc.receipts.items():
        if rec.get("status") == "submitted" and ref in ref_sender:
            sid = ref_sender[ref]
            committed[sid] = committed.get(sid, 0) + 1
    return {"svc": svc, "wall": wall, "n_clients": len(by_sender),
            "committed": committed, "counters": svc.admission.counters(),
            "submitted": svc.metrics.submitted,
            "flushed": svc.metrics.flushed, "windows": svc.metrics.windows}


def served(res: dict) -> dict:
    """What a served run must repeat on another device or in another run:
    the admission counters and log, the op log, committed txs by sender,
    the state root and the L1 gas."""
    svc = res["svc"]
    return {"counters": res["counters"], "log": svc.admission.log,
            "ops": svc.ops, "committed": res["committed"],
            "root": svc.client.state_root(),
            "gas": svc.client.chain.total_gas}


def replayed(node, res: dict, dev, what: str) -> float:
    """replay_ops of a served run's op log on ``dev``: its root and L1 gas
    must be the served ones.  Returns the replay's wall."""
    from repro_torch.serve import replay_ops
    svc = res["svc"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = replay_ops(node, svc.ops, device=dev)
    root = serial.state_root()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if root != svc.client.state_root() or \
            serial.chain.total_gas != svc.client.chain.total_gas:
        raise AssertionError(f"{what}: replay_ops diverged from the served "
                             f"stack ({root} against "
                             f"{svc.client.state_root()})")
    return wall


def serve_wrappers() -> dict:
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import rollup_digest as rd
    from repro_torch.kernels import shard_lanes as sl
    return {"batch_seal": bs.batch_seal, "rollup_digest": rd.rollup_digest,
            "rollup_chunk_digests": rd.rollup_chunk_digests,
            "dirty_fold": df.dirty_fold, "shard_seal": sl.shard_seal}


def serve_spam(dev, smi: str) -> dict:
    """(a) bench_serve.py's full-mode spam point on the card: the honest
    control, then the spam run (launch counts from 0), the same on the
    CPU, replay_ops on the card, and the spam run again under a
    PhaseClock (host seconds by step) and under torch.profiler (device
    busy share).  Returns the fold kernels' launches of the spam run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import NodeClient, NodeSpec
    from repro_torch.core.workloads import adversarial_spam_workload
    from repro_torch.serve import AdmissionController, NodeService
    p = SERVE_POINT
    common = dict(duration=p["duration"], fn=SERVE_HONEST_FN,
                  spam_fn=SERVE_SPAM_FN, n_spammers=p["n_spammers"],
                  seed=p["seed"], n_senders=p["n_honest"], device="cpu")
    alone = serve_txs(adversarial_spam_workload(p["honest_rate"], 0.0,
                                                **common))
    spam = serve_txs(adversarial_spam_workload(p["honest_rate"],
                                               p["spam_rate"], **common))
    spec = serve_spec(NodeSpec(), p["n_honest"] + p["n_spammers"])

    def honest(res):
        return sum(n for sid, n in res["committed"].items()
                   if sid >= p["n_spammers"])

    res_alone = serve_drive(alone, p["duration"], spec, dev)
    wrappers = serve_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    res = serve_drive(spam, p["duration"], spec, dev)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if launches.pop("shard_seal") or not all(launches.values()):
        raise AssertionError(f"serve spam: launches {launches}")
    retention = honest(res) / max(honest(res_alone), 1)
    # bench_serve.py's full mode drives >= 1000 concurrent clients
    if res["n_clients"] < p["n_honest"] or retention < SERVE_RETENTION:
        raise AssertionError(f"serve spam: {res['n_clients']} clients, "
                             f"honest retention {retention:.6f} (floor "
                             f"{SERVE_RETENTION})")
    want = served(res)
    replay_wall = replayed(spec.node, res, dev, "serve spam")
    res_cpu = serve_drive(spam, p["duration"], spec, torch.device("cpu"))
    if served(res_cpu) != want:
        raise AssertionError("serve spam: the card and the CPU admitted or "
                             "committed differently")
    clock = PhaseClock()
    for owner, attr, phase in (
            (AdmissionController, "admit", "admission"),
            (NodeService, "_reputation", "admission"),
            (NodeService, "_commit_pool", "pool_commit"),
            (NodeClient, "seal", "seal"),
            (NodeClient, "run_until", "run_until")):
        clock.wrap(owner, attr, phase)
    try:
        res_clock = serve_drive(spam, p["duration"], spec, dev)
    finally:
        clock.restore()
    # device activity only: recording every host op of 21,000 submits
    # took the traced wall from 2.5 to 23 s on the H100
    prof = profile(activities=[ProfilerActivity.CUDA])
    res_prof = serve_drive(spam, p["duration"], spec, dev,
                           hooks=(prof.start, prof.stop))
    for again in (res_clock, res_prof):
        if served(again) != want:
            raise AssertionError("serve spam: a second card run differed")
    n_spans, busy_us, by_name = device_time(prof)
    if not n_spans:
        raise AssertionError("serve spam: the trace holds no device span")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    wall = res["wall"]
    log(f"serve spam: {res['n_clients']} clients, {res['submitted']} "
        f"submits, {res['flushed']} committed over {res['windows']} "
        f"windows; counters {json.dumps(res['counters'])}; honest retention "
        f"{retention:.6f} ({honest(res)} / {honest(res_alone)}, floor "
        f"{SERVE_RETENTION}); card == CPU (admission log, op log, committed "
        f"by sender, state root {want['root']}, L1 gas {want['gas']}); "
        f"replay_ops on the card == served ({replay_wall:.6f} s)")
    log(f"serve spam: wall {wall:.6f} s, {res['submitted'] / wall:.1f} "
        f"submits per wall s (CPU {res_cpu['wall']:.6f} s; honest control "
        f"{res_alone['wall']:.6f} s) on {smi}; launches from 0 "
        f"{json.dumps(launches)}")
    log(f"serve spam: host seconds by step (each ends in a synchronize; "
        f"wall {res_clock['wall']:.6f} s) {json.dumps(clock.seconds)}, "
        f"calls {json.dumps(clock.calls)}")
    log(f"serve spam profile: {n_spans} device intervals, device busy "
        f"{busy_us / 1e6:.6f} s = {busy_us / 1e6 / res_prof['wall']:.6f} of "
        f"the traced wall {res_prof['wall']:.6f} s and "
        f"{busy_us / 1e6 / wall:.6f} of the untraced wall; device seconds "
        f"by name " + json.dumps({n[:80]: us / 1e6 for n, us in top}))
    return launches


def serve_fabric(dev, smi: str) -> None:
    """(b) bench_serve.py's poisson point (300 tx/s for 30 s over 1,000
    senders) served on a 2-shard fabric on the card, each shard sealed
    stepped (no shard_seal launch), and replayed by replay_ops on the CPU
    (one tx at a time: 9.5 s on the card, a fifth of that on the CPU):
    the same root and L1 gas."""
    from repro_torch.api import NodeSpec, ShardSpec
    from repro_torch.core.workloads import make_workload
    p = SERVE_POINT
    txs = serve_txs(make_workload(
        "poisson", p["honest_rate"], duration=p["duration"], seed=p["seed"],
        fn=SERVE_HONEST_FN, n_senders=p["n_honest"], device="cpu"))
    node = NodeSpec(shards=ShardSpec(count=SERVE_SHARDS, fabric=True))
    spec = serve_spec(node, p["n_honest"])
    wrappers = serve_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    res = serve_drive(txs, p["duration"], spec, dev)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if launches["shard_seal"] or not launches["batch_seal"]:
        raise AssertionError(f"serve fabric: launches {launches}")
    replay_wall = replayed(node, res, torch.device("cpu"), "serve fabric")
    log(f"serve fabric: {SERVE_SHARDS} shards, {res['n_clients']} clients, "
        f"{res['submitted']} submits, {res['flushed']} committed; counters "
        f"{json.dumps(res['counters'])}; state root "
        f"{res['svc'].client.state_root()} served on the card == replayed "
        f"on the CPU ({replay_wall:.6f} s); wall {res['wall']:.6f} s "
        f"({res['submitted'] / res['wall']:.1f} submits per wall s) on "
        f"{smi}; launches from 0 {json.dumps(launches)}")


def serve_http(smi: str) -> None:
    """(c) ``python -m repro_torch.launch.serve_node --port 0`` as a
    process of its own on the card, driven over HTTP by http_rpc: submits,
    a flush, a finalized receipt, the state root and the metrics; then
    stopped by an interrupt."""
    import asyncio
    import re
    import signal
    from repro_torch.serve import http_rpc
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_node", "--port",
         "0", "--serve-for", "300"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        boot = time.perf_counter() - t0
        found = re.search(r"http://([\d.]+):(\d+)/rpc .*device=(\S+)\)",
                          line)
        if not found or not found.group(3).startswith("cuda"):
            raise AssertionError(f"serve_node did not start on the card: "
                                 f"{line!r}")
        host, port = found.group(1), int(found.group(2))

        async def drive():
            out = [await http_rpc(host, port, "submit", {
                "fn": SERVE_HONEST_FN, "sender": f"h{i}", "at": 0.1 * i})
                for i in range(8)]
            for method, params in (("flush", None), ("receipt", {"ref": 0}),
                                   ("state_root", None), ("metrics", None)):
                out.append(await http_rpc(host, port, method, params))
            return out
        t1 = time.perf_counter()
        replies = asyncio.run(drive())
        rpc_wall = time.perf_counter() - t1
        if any(st != 200 for st, _ in replies) or \
                any(b["result"]["status"] != "queued"
                    for _, b in replies[:8]):
            raise AssertionError(f"serve_node replies {replies}")
        flushed, rcpt, root, metrics = (b["result"] for _, b in replies[8:])
        if flushed["flushed"] != 8 or rcpt["status"] != "finalized" or \
                len(root["state_root"]) != 32 or metrics["flushed"] != 8:
            raise AssertionError(f"serve_node replies {replies[8:]}")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"serve_node exited {proc.returncode}: "
                             f"{proc.stderr.read()[-2000:]}")
    log(f"serve http: serve_node up in {boot:.3f} s on port {port} "
        f"({found.group(3)}); 8 submits, flush, receipt (finalized, block "
        f"{rcpt['block']}), state_root {root['state_root']}, metrics in "
        f"{rpc_wall:.6f} s on {smi}; stopped by SIGINT, exit code 0")


def serve_cross_verify(dev) -> int:
    """(d) cross_verify_aggregate at the FL path's shape on the card: one
    weighted_agg launch an oracle, all five agreeing, oracle 0 bit-equal
    to weighted_average_tree, the card within SERVE_TOL of the CPU.
    Returns the launches."""
    from repro_torch.core.aggregation import weighted_average_tree
    from repro_torch.core.oracle import DONConfig, cross_verify_aggregate
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.models.mlp import TinyMLP
    d = FL_MODEL
    glob = TinyMLP(d["d_in"], d["d_h"], d["n_classes"],
                   device="cpu").init_params(0)
    rng = np.random.default_rng(0)
    host = {k: v[None] + XV_UPDATE * torch.from_numpy(rng.normal(
        size=(XV_TRAINERS,) + tuple(v.shape)).astype(np.float32))
        for k, v in glob.items()}
    scores = torch.from_numpy(rng.uniform(0.1, 1.0, XV_TRAINERS).astype(
        np.float32))
    card = {k: v.to(dev) for k, v in host.items()}
    cfg = DONConfig()
    wa.weighted_agg.launches = 0
    ref, agree = cross_verify_aggregate(weighted_average_tree, card,
                                        scores.to(dev), cfg)
    launches = wa.weighted_agg.launches
    plain = weighted_average_tree(card, scores.to(dev))
    cpu_ref, cpu_agree = cross_verify_aggregate(weighted_average_tree, host,
                                                scores, cfg)
    err = max(float((ref[k].cpu() - cpu_ref[k]).abs().max()) for k in ref)
    n_params = sum(v[0].numel() for v in host.values())
    if launches != cfg.n_oracles or not agree == cpu_agree == cfg.n_oracles \
            or not all(torch.equal(ref[k], plain[k]) for k in ref) \
            or err > SERVE_TOL:
        raise AssertionError(f"cross_verify_aggregate: launches {launches}, "
                             f"agree {agree} (CPU {cpu_agree}), card "
                             f"against CPU {err}")
    log(f"serve cross_verify_aggregate: {XV_TRAINERS} x {n_params} "
        f"parameters, {launches} weighted_agg launches, agree {agree} of "
        f"{cfg.n_oracles} (CPU {cpu_agree}), oracle 0 bit-equal to "
        f"weighted_average_tree, card against CPU {err:.3e} (tol "
        f"{SERVE_TOL})")
    return launches


def serve_presets(dev) -> None:
    """(e) every preset driven on the card as tests/test_presets.py's
    _drive does (12 submits, flush, run_until 8): its receipts settled and
    its state root equal to the CPU's."""
    from repro_torch.api import PRESETS, NodeClient, preset

    def drive(spec, d):
        client = NodeClient.from_spec(spec, device=d)
        rs = [client.submit("submitLocalModel", f"t{i % 4}")
              for i in range(12)]
        client.flush()
        client.run_until(8.0)
        return client.state_root(), [client.refresh(r).status for r in rs]
    roots = {}
    for name in sorted(PRESETS):
        spec = preset(name)
        root, statuses = drive(spec, dev)
        want = "finalized" if spec.rollup is not None else "confirmed"
        if set(statuses) != {want} or \
                (root, statuses) != drive(spec, torch.device("cpu")):
            raise AssertionError(f"preset {name}: {root} {statuses} on the "
                                 f"card against the CPU")
        roots[name] = root
    log(f"serve presets: card == CPU for {json.dumps(roots)}")


def serve_main(dev, smi: str) -> dict:
    """Phase 17; returns the launches of its paths."""
    steps, launches = {}, {}
    for label, step in (("spam", lambda: launches.update(
                            serve_spam(dev, smi))),
                        ("fabric", lambda: serve_fabric(dev, smi)),
                        ("http", lambda: serve_http(smi)),
                        ("cross_verify", lambda: launches.update(
                            weighted_agg=serve_cross_verify(dev))),
                        ("presets", lambda: serve_presets(dev))):
        t0 = time.perf_counter()
        step()
        steps[label] = time.perf_counter() - t0
    log(f"serve: phase 17 in {sum(steps.values()):.3f} s "
        f"{json.dumps(steps)}")
    return launches


# -- phase 18: the analysis layer ----------------------------------------------

# PERF.md section 6's Bound column: what the hand code this phase's cost
# functions replaced gave at each kernels-line row's shape (as printed, to
# 6 decimals)
HAND_BOUNDS = {"batch_seal": 0.000249, "rollup_digest": 0.000240,
               "rollup_chunk_digests": 0.003445, "dirty_fold": 0.003448,
               "weighted_agg": 0.005988, "model_distance": 0.005988,
               "block_pack": 0.000245, "flash_attention": 1.111741,
               "gmm": 0.716552, "slstm_scan": 0.555870,
               "shard_seal": 0.004958}
SANITIZED_RULES = ("R001", "R005", "R006", "R007")


@contextlib.contextmanager
def sanitizing(on: bool):
    """``REPRO_SANITIZE`` set to 1 (or unset) inside the block."""
    from repro_torch.analysis.sanitize import ENV_FLAG
    old = os.environ.pop(ENV_FLAG, None)
    if on:
        os.environ[ENV_FLAG] = "1"
    try:
        yield
    finally:
        os.environ.pop(ENV_FLAG, None)
        if old is not None:
            os.environ[ENV_FLAG] = old


def settled(events) -> list:
    """Every WindowSettled's (shard, window, state root, fabric root)."""
    return [(e.shard, e.window, e.state_root, e.fabric_root)
            for e in events if e.kind == "window_settled"]


def sanitized_pair(label: str, run, turns=(False, True)) -> dict:
    """``run()`` (-> (chain, ledger outputs, wall)) with the sanitizer off
    and on, in ``turns``: the sanitized runs silent with checks made, every
    ledger output equal to the unsanitized run's, and
    ``rollup_chunk_digests`` launched (counted from 0) at least once a
    WindowSettled more than without the sanitizer: its R001 refold, on the
    card through the kernel."""
    from repro_torch.kernels import rollup_digest as rd
    outs, walls, launches, checks = {}, {False: [], True: []}, {}, []
    for on in turns:
        rd.rollup_chunk_digests.launches = 0
        with sanitizing(on):
            chain, out, wall = run()
        torch.cuda.synchronize()
        walls[on].append(wall)
        launches[on] = rd.rollup_chunk_digests.launches
        san = getattr(chain.events, "_sanitizer", None)
        if (san is not None) != on:
            raise AssertionError(f"sanitize {label}: REPRO_SANITIZE={int(on)}"
                                 f" {'did not install' if on else 'installed'}"
                                 f" the sanitizer")
        if on:
            checks.append(san.n_checks)
            if san.n_checks <= 0:
                raise AssertionError(f"sanitize {label}: no checks made")
        if on in outs and outs[on] != out:
            raise AssertionError(f"sanitize {label}: two runs differ")
        outs[on] = out
    for key in outs[False]:
        if outs[True][key] != outs[False][key]:
            raise AssertionError(f"sanitize {label}: {key} differ with the "
                                 f"sanitizer on")
    n_ws = len(outs[True]["settled"])
    if n_ws == 0 or launches[True] - launches[False] < n_ws:
        raise AssertionError(f"sanitize {label}: rollup_chunk_digests "
                             f"launched {launches[True]} times sanitized, "
                             f"{launches[False]} without, for {n_ws} "
                             f"WindowSettled events")
    row = {"n_checks": checks, "window_settled": n_ws,
           "rollup_chunk_digests_launches": launches,
           "wall_s": {("sanitized" if on else "unsanitized"): w
                      for on, w in walls.items()}}
    log(f"sanitize {label}: silent, outputs (gas log, blocks, batch "
        f"digests, WindowSettled roots) equal to the unsanitized run; "
        f"{json.dumps(row)}")
    return row


def ledger_outputs(client) -> dict:
    ru, chain = client.target, client.chain
    return {"gas_log": ru.gas_log,
            "blocks": [(b.height, b.n_txs, b.gas_used, b.start, b.stop,
                        b.block_hash) for b in chain.blocks],
            "batch_digests": ru.batch_digests,
            "settled": settled(client.events(cursor=0)),
            "root": client.state_root()}


def sanitize_paths(dev, smi: str) -> dict:
    """(a) The node path at full size (1M txs, 20 windows; sanitizer off,
    on, on, off), its fused twin at a tenth, the FL run at FL_AGREE
    through the default Scheduler and the 8-shard fused fabric at a
    tenth, each built through build_stack with REPRO_SANITIZE=1 against
    the same run without it."""
    from repro_torch.core.workloads import make_workload

    wl = make_workload("mixed", device=dev, **FULL)

    def node():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        client, _, _, _ = run_node(wl, dev, receipts=False)
        torch.cuda.synchronize()
        return client.chain, ledger_outputs(client), \
            time.perf_counter() - t0
    out = {"node": sanitized_pair("node path (1M txs)", node,
                                  (False, True, True, False))}
    walls = out["node"]["wall_s"]
    log(f"sanitize node path: wall unsanitized {walls['unsanitized']} s, "
        f"sanitized {walls['sanitized']} s on {smi}")
    del wl

    tenth = make_workload("mixed", device=dev, **TENTH)
    _, stepped, _ = run_twin(tenth, dev, fused=False)
    until = stepped["blocks"][-1][1]

    def twin():
        client, o, wall = run_twin(tenth, dev, fused=True, until=until)
        return client.chain, dict(ledger_outputs(client), **o), wall
    out["fused"] = sanitized_pair("fused twin (a tenth)", twin)

    def fabric():
        client, o, wall = fabric_twin(tenth, dev, k=FABRIC_TWIN_SHARDS,
                                      fused=True, until=until)
        return client.chain, dict(ledger_outputs(client), **o), wall
    out["fabric"] = sanitized_pair(f"fused fabric ({FABRIC_TWIN_SHARDS} "
                                   f"shards, a tenth)", fabric)
    del tenth

    # fl_agree's world: ragged tasks, and a last one with full rounds
    lazy = ["good", "good", "malicious", "lazy"] * (FL_AGREE["trainers"] // 4)
    behaviors = [lazy] * (FL_AGREE["tasks"] - 1) + [
        ["good", "good", "malicious", "good"] * (FL_AGREE["trainers"] // 4)]
    fl_runs = []

    def fl():
        node, sch, res, wall = run_fl(dev, FL_AGREE, behaviors)
        if sch.mega_windows == 0:
            raise AssertionError("sanitize FL: the megastep did not run")
        client = node.client()
        fl_runs.append(fl_outputs(node, sch, res))
        return node.chain, ledger_outputs(client), wall
    out["fl"] = sanitized_pair("FL run (default Scheduler, FL_AGREE)", fl)
    fl_hold(fl_runs[0], fl_runs[1], "sanitize FL: sanitized against "
            "unsanitized")
    return out


def inject_violation(rule: str, client) -> None:
    """One violation of ``rule`` on a primed stack, as
    tests/test_sanitize.py's ``_inject`` makes it."""
    from repro_torch.core.events import BlockPacked, ProofGenerated
    log_ = client.chain.events
    if rule == "R001":
        # a column write that skips mark_dirty; the next window carries a
        # tx with no state handler, so nothing re-dirties the chunk
        client.target.state_arrays.balances[0] += 7.0
        client.submit("bgPing", "s0")
        client.seal()
    elif rule == "R005":
        log_._events.append(BlockPacked(
            seq=len(log_._events) + 5, time=0.0, shard=None, height=99,
            n_txs=0, gas_used=0, block_hash="bogus"))
        log_.emit(BlockPacked, time=1.0, height=100, n_txs=0, gas_used=0,
                  block_hash="next")
    elif rule == "R006":
        client.chain.total_gas += 12345
        client.chain.produce_block(1e6)
    elif rule == "R007":
        log_.emit(ProofGenerated, time=0.5, shard=None, job=0, batch=777,
                  n_txs=1, digest=0, sealed_at=0.0)
    else:
        raise AssertionError(rule)


def sanitize_injections(dev) -> dict:
    """(b) One violation a dynamic rule on a stack whose StateArrays lives
    on the card: each raises SanitizeViolation with that rule."""
    from repro_torch.analysis.sanitize import SanitizeViolation, install_stack
    from repro_torch.api import NodeClient, NodeSpec
    caught = {}
    for rule in SANITIZED_RULES:
        client = NodeClient.from_spec(NodeSpec(), device=dev)
        san = install_stack(client.chain, client.target)
        for i in range(3):
            client.submit("submitLocalModel", f"s{i}")
        client.seal()
        if client.target.state_arrays.balances.device.type != "cuda" or \
                san.n_checks <= 0:
            raise AssertionError("sanitize inject: the stack is not on the "
                                 "card, or no checks ran")
        try:
            inject_violation(rule, client)
        except SanitizeViolation as exc:
            caught[rule] = exc.rule
        if caught.get(rule) != rule:
            raise AssertionError(f"sanitize inject: {rule} raised "
                                 f"{caught.get(rule)}")
    log(f"sanitize inject: on the card each injected violation raised its "
        f"rule: {json.dumps(caught)}")
    return caught


def check_bounds(rows) -> dict:
    """(c) Every kernels-line row's bound: recomputed from the registered
    cost at the row's timed arguments (one source), and equal to the bound
    the hand code it replaced gave there (HAND_BOUNDS)."""
    out = {}
    for row in rows:
        name = row["name"]
        again = cost_bound(name, *from_cost_args(row["cost_args"]))
        if (again["bound_ms"], again["bound_by"]) != \
                (row["bound_ms"], row["bound_by"]):
            raise AssertionError(f"bounds: {name}'s row holds "
                                 f"{row['bound_ms']} ({row['bound_by']}), "
                                 f"its cost gives {again['bound_ms']}")
        if round(row["bound_ms"], 6) != HAND_BOUNDS[name]:
            raise AssertionError(f"bounds: {name}'s cost gives "
                                 f"{row['bound_ms']:.6f} ms, the hand code "
                                 f"gave {HAND_BOUNDS[name]}")
        out[name] = [row["bound_ms"], row["bound_by"]]
    log(f"bounds: every kernels-line bound from its registered cost, equal "
        f"to the hand code's: {json.dumps(out)}")
    return out


def analysis_main(dev, smi: str, rows) -> None:
    """Phase 18: (a) the sanitizer on the sanitized paths, (b) injections
    on the card, (c) the kernels line's bounds from the registered costs."""
    t0 = time.perf_counter()
    sanitize_paths(dev, smi)
    sanitize_injections(dev)
    check_bounds(rows)
    log(f"analysis: phase 18 in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s), "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matrix products must not use TF32")
    log("device: float32 matmul precision 'highest', TF32 off")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.workloads import make_workload
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import rollup_digest as rd

    # 2. build
    t0 = time.perf_counter()
    built = _build.build(force=True)
    build_s = time.perf_counter() - t0
    usage = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or ln.startswith("==")]
    log(f"build: {[src.name for src in _build.sources()]} -> "
        f"{built.path.relative_to(ROOT)} in {build_s:.3f} s")
    for ln in usage:
        log(f"  ptxas: {ln}")

    # 3. kernels, at the shapes the main paths give them
    wl = make_workload("mixed", device=dev, **FULL)
    times = wl.txs.submit_time.cpu().numpy()
    lo, hi = np.searchsorted(times, [FULL["duration"] - 1, FULL["duration"]])
    n_acc = int(wl.txs.sender_id.max()) + 1
    spec = node_spec()
    shapes = {"seal_words": 4 * int(hi - lo),
              "seal_starts": seal_starts(int(hi - lo), spec.rollup.n_lanes,
                                         spec.rollup.batch_size),
              "state_words": 11 * n_acc, "chunk": 2048}
    rows = check_kernels(dev, shapes)
    d = FL_MODEL
    n_params = d["d_in"] * d["d_h"] + d["d_h"] + d["d_h"] * d["n_classes"] \
        + d["n_classes"]
    fl_rows = check_fl_kernels(dev, FL_RUN["trainers"], n_params, 1 << 20,
                               FL_RUN["tasks"])

    # 4. node path, launch counts from 0
    wrappers = {"rollup_digest": rd.rollup_digest,
                "rollup_chunk_digests": rd.rollup_chunk_digests,
                "dirty_fold": df.dirty_fold, "batch_seal": bs.batch_seal}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client, rcpts, _, spans = run_node(wl, dev, receipts=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    stats = check_main_path(client, wl, rcpts)
    spans["refresh_checks"] = time.perf_counter() - t0
    log(f"main: {json.dumps(stats)}")
    log(f"main: modeled L2 TPS {stats['finalized_receipts'] / FULL['duration']}"
        f" ({stats['finalized_receipts']} txs finalized over "
        f"{FULL['duration']} modeled s); wall {wall:.3f} s for windows, "
        f"flush and drain on {smi}; peak device memory {peak:.1f} MiB")
    log(f"main: host seconds by step {json.dumps(spans)}")
    missing = [name for name, k in launches.items() if k == 0]
    if missing:
        raise AssertionError(f"the node path never launched {missing}")
    del client, rcpts

    # 4, fused: the same workload through the fused window loop, against
    # the stepped twin; block_pack checked and timed at its shape
    pack_args, seal_calls, fused_client, _ = fused_node(dev, wl, smi)
    pack_row = check_block_pack(dev, pack_args, fused_client)
    check_fused_seals(seal_calls, torch.empty(256 * 2**20 // 4,
                                              dtype=torch.int32, device=dev))
    del fused_client, pack_args, seal_calls, wl

    # 5. node path: card against CPU at a tenth of the size
    agree(dev)

    # 6. FL path: card against CPU at 4 tasks x 16 trainers
    fl_agree(dev)

    # 7. FL path on the card, launch counts from 0; then its device time
    fl_launches, fl_wall = fl_main(dev, smi)
    launches.update(fl_launches)
    fl_profile(dev, fl_wall)

    # 8. the attention kernel against its plain version and SDPA
    attn_row = check_attention(dev)

    # 9. the reduced dense LMs: card against CPU
    lm_agree(dev)

    # 10. yi-6b at full width and depth: prefill (launch counts from 0),
    # decode, the serve loop
    launches.update(lm_main(dev, smi, count=True))
    torch.cuda.empty_cache()

    # 11. the MoE and xLSTM kernels against their plain versions and bmm
    gmm_rows, scan_row = check_moe_xlstm_kernels(dev)
    torch.cuda.empty_cache()

    # 12. the reduced MoE and xLSTM LMs: card against CPU, layer by layer
    moe_xlstm_agree(dev)

    # 13. moonshot-v1-16b-a3b at full width and depth: prefill (launch
    # counts from 0), decode, the serve loop
    launches["gmm"] = lm_main(dev, smi, "moonshot-v1-16b-a3b", MOE_PREFILL,
                              MOE_DECODE)["gmm"]
    torch.cuda.empty_cache()

    # 14. xlstm-1.3b at full width and depth: the same
    launches["slstm_scan"] = lm_main(dev, smi, "xlstm-1.3b", XLSTM_PREFILL,
                                     XLSTM_DECODE, "float32")["slstm_scan"]
    torch.cuda.empty_cache()

    # 15. the object ledger and the agent path: rollup_digest at the object
    # batch sizes, the Fig. 4/5 grid, the Table I replay, the sequential
    # baseline (launch counts from 0, added to the kernels line) and the
    # agreement three ways
    object_digests(dev, torch.empty(256 * 2**20 // 4, dtype=torch.int32,
                                    device=dev))
    object_grid(dev)
    object_table1(dev)
    for name, k in object_sequential(dev, smi).items():
        launches[name] += k
    object_agree(dev)

    # 16. the sharded fabric: (c) the fused fabric twin (launch counts from
    # 0; its two shard_seal calls captured), (a) shard_seal at its hard
    # cases and timed at those calls, (b) bench_shards.py's point, (d) the
    # FL run on the fabric (launch counts from 0)
    torch.cuda.empty_cache()
    wl = make_workload("mixed", device=dev, **FULL)
    seal_calls, twin_launches = fused_fabric(dev, wl, smi)
    del wl
    shard_row = check_shard_seal(dev, seal_calls, torch.empty(
        256 * 2**20 // 4, dtype=torch.int32, device=dev))
    del seal_calls
    fabric_node(dev, smi)
    fl_fabric_launches = fabric_fl(dev, smi)
    launches["shard_seal"] = twin_launches + fl_fabric_launches
    log(f"shard_seal launches: {twin_launches} on the fused fabric twin, "
        f"{fl_fabric_launches} on the default FL run on the fabric")

    # 17. the node service: (a) bench_serve.py's spam point (launch counts
    # from 0, added to the kernels line), card == CPU, replayed; (b) its
    # poisson point on 2 shards; (c) serve_node over HTTP; (d)
    # cross_verify_aggregate (launches added); (e) the presets
    torch.cuda.empty_cache()
    for name, k in serve_main(dev, smi).items():
        launches[name] += k

    # the kernels line's source rows: the default FL path merges Eq. 1 and
    # Eq. 4 with the task axis, so their rows are timed at (32, 64, 2,410)
    # (the per-task (64, 2,410) is logged below); gmm's is moonshot's gate
    # and up products at the prefill (two of its three launches a layer)
    agg, dist = fl_rows["weighted_agg"], fl_rows["model_distance"]
    source_rows = rows + [dict(agg, **agg["task"]), dict(dist, **dist["task"]),
                          pack_row, attn_row, gmm_rows[0], scan_row,
                          shard_row]

    # 18. the analysis layer: (a) the sanitizer through build_stack on the
    # node path, its fused twin, the 8-shard fused fabric and the FL run,
    # against unsanitized runs; (b) injected violations on the card; (c)
    # every bound of the kernels line from its op's registered cost
    torch.cuda.empty_cache()
    analysis_main(dev, smi, source_rows)

    replaces = {"rollup_digest": "src/repro/kernels/rollup_digest.py:16",
                "rollup_chunk_digests":
                    "src/repro/kernels/rollup_digest.py:76",
                "dirty_fold": "src/repro/kernels/dirty_fold.py:107",
                "batch_seal": "src/repro/kernels/batch_seal.py:59",
                "weighted_agg": "src/repro/kernels/weighted_agg.py:22",
                "model_distance": "src/repro/kernels/model_distance.py:18",
                "block_pack": "src/repro/kernels/block_pack.py:179",
                "flash_attention": "src/repro/kernels/flash_attention.py:25",
                "gmm": "src/repro/kernels/gmm.py:18",
                "slstm_scan": "src/repro/kernels/slstm_scan.py:25",
                # no Pallas form: _lane_fold, the jnp program of
                # shard_seal_jax and shard_seal_shard_map
                "shard_seal": "src/repro/kernels/shard_lanes.py:79"}
    sources = {"weighted_agg": "fl.cu", "model_distance": "fl.cu",
               "block_pack": "pack.cu", "flash_attention": "attn.cu",
               "gmm": "moe.cu", "slstm_scan": "slstm.cu"}
    kernels = []
    for row in source_rows:
        name = row["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/"
                       + sources.get(name, "fold.cu")),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")})
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"a main path never launched {missing}")
    for name, row in fl_rows.items():
        log(f"wide {name}: {json.dumps(row['wide'])}")
    for name, row in (("weighted_agg", agg), ("model_distance", dist)):
        per_task = {k: row[k] for k in ("ms", "device_ms", "plain_ms",
                                         "library_ms", "bound_ms", "shape")
                    if k in row}
        log(f"per-task {name}: {json.dumps(per_task)}")
    log(f"flash_attention at prefill_32k's sequence: "
        f"{json.dumps(attn_row['long'])}; at moonshot's layer: "
        f"{json.dumps(attn_row['moonshot'])}")
    log(f"gmm at moonshot's other products: {json.dumps(gmm_rows[1:])}")

    log(f"device_ms retakes: {json.dumps(RETAKES)}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
