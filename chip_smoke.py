#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one CUDA card: the rollup node
path (stepped, and through the fused window loop), the reputation-aware
FL protocol run (the default Scheduler: fused loop + cross-task megastep,
and the stepped per-task path) and the dense-transformer serving path
(prefill and KV-cache decode of yi-6b at full width).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its result on a line of its own:

  1. device  — needs a CUDA card; prints its name and power limit
               (nvidia-smi) and the torch and CUDA versions; float32
               matrix products must run in full float32 (no TF32).
  2. build   — compiles every src/repro_torch/kernels/csrc/*.cu with nvcc
               (in parallel) into one library; prints ptxas's register use.
  3. kernels — the four fold kernels and ``block_pack`` against their
               plain PyTorch versions on the card, bit for bit, and the two
               FL kernels (Eq. 1 ``weighted_agg``, also with its task axis
               at (32, 64, 2,410), row t bit-equal to the unbatched launch;
               Eq. 4 ``model_distance``) within rtol 1e-5 / atol 1e-6 in
               float32 and 2e-2 in bfloat16, at the grids of the CPU tests
               and at the shapes of the main paths (plus a 1M-wide FL
               shape); times each (CUDA events, L2 flushed before every
               launch) beside its bound, the plain version's time and,
               where one exists, one PyTorch call's.
  4. node    — NodeClient on the card: 1M transactions of the Table-I mix
               over 262,144 accounts, 20 one-second windows of
               submit_arrays / seal / run_until, then flush and drain;
               launch counts of the fold kernels read just after.
     fused   — the same 1M transactions through the raw-ledger window loop
               of benchmarks/bench_protocol.py (per window submit / seal /
               pump / run_until, then flush and run_until the end), once
               stepped and once through FusedWindowLoop: blocks, gas log,
               batch digests, WindowSettled roots and event kinds equal,
               ONE block_pack launch.  block_pack is checked and timed at
               this run's shape, beside its bytes bound, its latency chain
               and the stepped per-block path on the same blocks.
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
               after (weighted_agg 3, model_distance 32, block_pack 1).
               Then the stepped per-task path (fused=False,
               megabatch=False) on the same world, held to it as in
               phase 6, and the stepped path on the CPU for scale; where
               the megastep and the per-task round part ways on the card
               (one forward pass, one round).  Then the default run under
               torch.profiler: the device's busy time and the kernels
               that take it.

  8. attention — the flash_attention kernel against its plain version on
               the grid of tests/test_kernels.py:60-64, causal and not,
               plus head width 80, S = 4,097 and ragged tails, in float32
               (rtol 1e-4 / atol 1e-5) and bfloat16 (one bfloat16 step:
               rtol 2^-7 / atol 1e-4); at yi-6b's prefill layer (8, 4,096,
               32 heads, 4 kv heads, 128) in bfloat16, held on one batch
               row and timed beside its bound, the plain version (row by
               row) and SDPA; at prefill_32k's sequence (1, 32,768), held
               to the plain version on three slices of 256 query rows and
               timed beside SDPA.
  9. lm agree — the reduced yi-6b, qwen2-0.5b, qwen1.5-0.5b and qwen3-32b
               in float32 and bfloat16 three ways (card with the kernel,
               card with the plain version forced, CPU): prefill logits
               and caches and three decode steps, within LM_TOL.
 10. lm      — yi-6b at full width and depth (32 layers, bfloat16, weights
               drawn on the card): a 64-token prompt through prefill and
               through 64 decode steps, held to each other; Model.prefill
               on 8 x 4,096 tokens (32 flash_attention launches, counted
               from 0); its caches in an 8 x 4,128 decode state and 32
               decode steps; the kernel's share of the prefill's device
               time (torch.profiler); then launch/serve_model.py's loop at
               its defaults (batch 4, prompt 8, 8 tokens).

Then one JSON line lists every kernel with its launches on its path, the
card's name and power limit follow on a line of their own, and the last
line is ``{"ok": true, "device": {...}}``.  Any failed phase raises before
them, so the script exits nonzero with no result line; so it does without
a CUDA card, or outside a checkout of the repository.
"""
from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT_OPS_PER_S = 67e12            # H100 SXM 32-bit rate outside tensor cores
F32_OPS_PER_S = 67e12            # H100 SXM float32 rate outside tensor cores
OPS_PER_WORD = 4                 # shift, xor, multiply, xor-reduce
# assumed latency of one dependent device-memory load on the card (an
# estimate, not a measurement): block_pack's latency-chain estimate
LOAD_LATENCY_S = 0.6e-6
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
            + [(seal_words[1:],)],
            (seal_words,),
            lambda a: (4 * a[0].numel() + 4, a[0].numel())),
        "rollup_chunk_digests": (
            rd.rollup_chunk_digests, rd.rollup_chunk_digests_torch,
            [(words(n), chunk) for n in (1, 128, 2048, 4097, 70_000)]
            + [(state_words[3:], chunk)],
            (state_words, chunk),
            lambda a: (4 * a[0].numel() + 4 * n_chunks, a[0].numel())),
        "dirty_fold": (
            df.dirty_fold, df.dirty_fold_torch,
            [(w, torch.from_numpy(g.integers(0, -(-w.numel() // chunk), d)
                                  ).to(dev), chunk)
             for w, d in ((words(1), 1), (words(100), 1), (words(5000), 2),
                          (words(70_000), 7), (words(300_000), 146))],
            (state_words, ids, chunk),
            lambda a: (4 * n_state + 12 * n_chunks, n_state)),
        "batch_seal": (
            bs.batch_seal, bs.batch_seal_torch,
            [(words(n), segments(n, s)) for n, s in
             ((4, 1), (4096, 17), (100_000, 257), (128, 128))],
            (seal_words, seal_starts_t),
            lambda a: (4 * a[0].numel() + 12 * a[1].numel(),
                       a[0].numel())),
    }
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    results = []
    for name, (kernel, plain, grid, chip, work) in cases.items():
        err = 0
        for args in grid + [chip]:
            err = max(err, u32_err(kernel(*args), plain(*args)))
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err}")
        n_bytes, n_words = work(chip)
        mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_WORD * n_words / INT_OPS_PER_S * 1e3
        row = {"name": name, "max_abs_err": err,
               "ms": timed_ms(lambda: kernel(*chip), 50, flush),
               "plain_ms": timed_ms(lambda: plain(*chip), 10, flush),
               "bound_ms": max(mem_ms, ops_ms),
               "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
               "shape": [list(a.shape) for a in chip
                         if isinstance(a, torch.Tensor)]}
        log(f"kernel {name}: bit-equal to plain on {len(grid) + 1} inputs; "
            f"{row['ms']:.6f} ms (bound {row['bound_ms']:.6f} ms, "
            f"{row['bound_by']}), plain {row['plain_ms']:.6f} ms, "
            f"library call: none, at {row['shape']}")
        results.append(row)
    return results


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
    launch count from 0): equal outputs, one launch; host seconds by step
    of each, and of the work both do inside a seal.  Returns the
    block_pack arguments of the fused run, its client and the launch
    count."""
    from repro_torch.core import fused as fused_mod
    from repro_torch.core.engine import VectorChain, VectorRollup
    from repro_torch.core.prover import ProverPipeline
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
    captured = {}
    real = fused_mod.get_kernel

    def spy(op, impl=None):
        fn = real(op, impl)
        if op != "block_pack":
            return fn

        def recorded(*args):
            captured["args"] = args
            return fn(*args)
        return recorded
    wrap("fused")
    fused_mod.get_kernel = spy
    bp.block_pack.launches = 0
    try:
        client, fused, fused_wall = run_twin(workload, dev, fused=True,
                                             until=stepped["blocks"][-1][1])
    finally:
        fused_mod.get_kernel = real
        restore("fused")
    launches = bp.block_pack.launches
    twins_equal(stepped, fused, "fused node against stepped")
    if launches != 1:
        raise AssertionError(f"the fused node run launched block_pack "
                             f"{launches} times, not once")
    spans = {}
    for label, wall in (("stepped", stepped_wall), ("fused", fused_wall)):
        spans[label] = dict(steps[label].seconds)
        spans[label]["rest"] = wall - sum(spans[label].values())
    log(f"fused node: {len(workload)} txs, {len(fused['blocks']) - 1} L1 "
        f"blocks, {len(fused['gas_log'])} batches, "
        f"{len(fused['window_roots'])} window roots: blocks, gas log, "
        f"digests, roots and event kinds equal to the stepped twin; wall "
        f"stepped {stepped_wall:.6f} s, fused {fused_wall:.6f} s on {smi}; "
        f"block_pack launches {launches}")
    log(f"fused node: host seconds by step (each ends in a synchronize) "
        f"{json.dumps(spans)}; of which inside seal / apply_seal "
        f"{json.dumps({k: c.seconds for k, c in inside.items()})}")
    return captured["args"], client, launches


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
    grid (ptr0 = 0 and the first stop), on an empty mempool and on the
    fused node run's own arguments.  Timed at the last (CUDA events, L2
    flushed) beside its bytes bound, its latency chain, the plain version
    and the stepped path (``VectorChain.run_until``, one host sync per
    block) on the same mempool and blocks."""
    import math

    from repro_torch.core.engine import TxArrays, VectorChain
    from repro_torch.kernels import block_pack as bp
    grid = []
    for case in ((1, 1, 0, 9_000_000), (100, 7, 1, 9_000_000),
                 (1000, 33, 2, 300_000), (513, 16, 3, 2**40),
                 (64, 5, 4, 21_000)):
        stream = pack_stream(*case, dev)
        first = int(bp.block_pack_torch(*stream, 0)[0])
        grid += [(*stream, 0), (*stream, first)]
    grid.append((*pack_stream(0, 4, 5, 9_000_000, dev), 0))
    for a in grid + [args]:
        if not torch.equal(bp.block_pack(*a), bp.block_pack_torch(*a)):
            raise AssertionError("block_pack differs from its plain version")
    torch.cuda.synchronize()
    tmax, gcum, times, n_vis, limit, ptr0 = args
    n, b = tmax.numel(), times.numel()
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    mem_ms = 8 * (2 * n + 3 * b) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * b * (math.ceil(math.log2(max(n, 2))) + 1) \
        / INT_OPS_PER_S * 1e3
    loads = b * (1 + math.ceil(math.log(max(n, 2), 32)))
    row = {"name": "block_pack", "max_abs_err": 0,
           "ms": timed_ms(lambda: bp.block_pack(*args), 20, flush),
           "plain_ms": timed_ms(lambda: bp.block_pack_torch(*args), 3, flush),
           "bound_ms": max(mem_ms, ops_ms),
           "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
           "library_ms": None, "chain_loads": loads,
           "chain_ms": loads * LOAD_LATENCY_S * 1e3}
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
        f"and to {b} stepped produce_block calls; {row['ms']:.6f} ms (bound "
        f"{row['bound_ms']:.6f} ms, {row['bound_by']}; latency chain "
        f"{loads} dependent loads, about {row['chain_ms']:.6f} ms at an "
        f"assumed {LOAD_LATENCY_S * 1e6:.1f} us each), plain "
        f"{row['plain_ms']:.6f} ms, stepped path (VectorChain.run_until, "
        f"one host sync per block) {row['stepped_ms']:.6f} ms for the same "
        f"{b} blocks, library call: none, at N={n}, B={b}")
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
                     (3, 1, f32)):
        w = rows(n, p, dt)
        glob = rows(1, p, dt)[0]
        dist_grid += [(w, glob), (w[:, 1:], glob[1:])]     # unaligned rows
    shapes = {"path": (path_n, path_p), "wide": (path_n, wide_p)}
    chips = {}
    for label, (n, p) in shapes.items():
        w, glob = rows(n, p, f32), rows(1, p, f32)[0]
        chips[label] = {"weighted_agg": (w, scores(n)),
                        "model_distance": (w, glob)}
    cases = {
        "weighted_agg": (
            wa.weighted_agg, wa.weighted_agg_torch, agg_grid,
            lambda w, s: torch.matmul(s, w) / s.sum().clamp(min=1e-12),
            lambda a: ((a[0].numel() + a[0].shape[1]) * 4 + 4 * a[1].numel(),
                       2 * a[0].numel())),
        "model_distance": (
            md.model_distance, md.model_distance_torch, dist_grid,
            lambda w, glob: torch.cdist(w, glob[None])[:, 0],
            lambda a: ((a[0].numel() + a[1].numel()) * 4 + 4 * a[0].shape[0],
                       3 * a[0].numel())),
    }
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    out = {}
    for name, (kernel, plain, grid, library, work) in cases.items():
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
            n_bytes, n_ops = work(args)
            mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / F32_OPS_PER_S * 1e3
            timed[label] = {
                "ms": timed_ms(lambda: kernel(*args), 50, flush),
                "plain_ms": timed_ms(lambda: plain(*args), 20, flush),
                "library_ms": timed_ms(lambda: library(*args), 20, flush),
                "bound_ms": max(mem_ms, ops_ms),
                "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
                "shape": [list(a.shape) for a in args]}
            t = timed[label]
            log(f"kernel {name} at {t['shape']} (float32): {t['ms']:.6f} ms "
                f"(bound {t['bound_ms']:.6f} ms, {t['bound_by']}), plain "
                f"{t['plain_ms']:.6f} ms, library call {t['library_ms']:.6f}"
                f" ms")
        log(f"kernel {name}: within tolerance of plain on {len(checked)} "
            f"inputs (float32 rtol 1e-5 atol 1e-6, bfloat16 2e-2); largest "
            f"float32 |kernel - plain| {err}")
        out[name] = {"name": name, "max_abs_err": err, **timed["path"],
                     "wide": timed["wide"]}
    out["weighted_agg"]["task"] = check_task_axis_agg(
        dev, g, n_tasks, path_n, path_p, flush, out["weighted_agg"])
    return out


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
    torch.testing.assert_close(got, want, **F32_TOL)
    torch.cuda.synchronize()
    row["max_abs_err"] = max(row["max_abs_err"],
                             float((got - want).abs().max()))
    mem_ms = ((w.numel() + n_tasks * p) * 4 + 4 * s.numel()) \
        / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * w.numel() / F32_OPS_PER_S * 1e3
    t = {"ms": timed_ms(lambda: wa.weighted_agg(w, s), 50, flush),
         "plain_ms": timed_ms(lambda: wa.weighted_agg_torch(w, s), 20, flush),
         "library_ms": timed_ms(
             lambda: torch.matmul(s[:, None], w)[:, 0]
             / s.sum(1, keepdim=True).clamp(min=1e-12), 20, flush),
         "bound_ms": max(mem_ms, ops_ms),
         "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
         "shape": [list(w.shape), list(s.shape)]}
    log(f"kernel weighted_agg at {t['shape']} (float32, task axis): rows "
        f"bit-equal to the {n_tasks} unbatched launches; {t['ms']:.6f} ms "
        f"(bound {t['bound_ms']:.6f} ms, {t['bound_by']}), plain "
        f"{t['plain_ms']:.6f} ms, library call (batched matmul) "
        f"{t['library_ms']:.6f} ms")
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


def run_fl(dev, cfg, behaviors=None, **knobs):
    """One Scheduler run of ``cfg['tasks']`` concurrent tasks on
    ``NodeSpec()`` (the protocol-scheduler preset) with seal_every=2 and
    the Scheduler's ``knobs`` (its defaults: the fused loop and the
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
    spec = NodeSpec(trainer_funds=10.0 * (tasks + 2),
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
    st = node.rollup.state_arrays
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


def fl_agree(dev) -> None:
    """The default FL run (fused + megastep) at 4 tasks x 16 trainers, 2
    rounds, on the card with kernels, on the card with the plain versions
    forced, and on the CPU.  The lazy trainers make tasks ragged; the last
    task has none, so its rounds are full and both Eq. 1 branches run."""
    from repro_torch.fl import scheduler as fl_sched
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
            node, sch, out, wall = run_fl(device, FL_AGREE, behaviors)
        finally:
            branches.restore()
            os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
            if old is not None:
                os.environ["REPRO_TORCH_KERNEL_IMPL"] = old
        if sch.mega_windows == 0 or 0 in branches.calls.values():
            raise AssertionError(f"fl agree {label}: megastep windows "
                                 f"{sch.mega_windows}, Eq. 1 calls "
                                 f"{branches.calls}")
        log(f"fl agree {label}: {sch.mega_windows} megastep windows, Eq. 1 "
            f"calls {json.dumps(branches.calls)}")
        outs[label] = o = fl_outputs(node, sch, out)
        digest = hashlib.sha256(b"".join(
            o["params"][t][k].tobytes() for t in sorted(o["params"])
            for k in sorted(o["params"][t]))).hexdigest()[:16]
        log(f"fl agree {label}: parameters' sha256 {digest} (compare "
            f"between calls)")
        if o["root"] != o["cpu_root"]:
            raise AssertionError(f"fl agree {label}: root {o['root']} != "
                                 f"the CPU root of its fields {o['cpu_root']}")
        log(f"fl agree {label}: {sum(o['protocol_calls'].values())} protocol "
            f"calls, {len(o['gas_log'])} batches, {len(o['blocks']) - 1} "
            f"blocks, root {o['root']} (= the CPU root of its fields), "
            f"{wall:.3f} s")
    ref = outs["cpu"]
    for label, o in outs.items():
        fl_hold(ref, o, f"fl agree {label} against the CPU")
    log(f"fl agree: card (kernels), card (plain) and CPU agree over "
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


def fl_measured(dev, smi: str, label: str, **knobs) -> dict:
    """The FL protocol run at 32 tasks x 64 trainers with the Scheduler's
    ``knobs``, launch counts from 0, host seconds by phase; checks the
    repo's invariants on the result and returns what it measured."""
    from repro_torch.core import oracle
    from repro_torch.core.fused import FusedWindowLoop
    from repro_torch.core.gas import DEFAULT_GAS, L1_DEFAULT_GAS
    from repro_torch.fl import scheduler as fl_sched
    from repro_torch.fl.cohort import MegaCohort, VectorCohort
    from repro_torch.fl.server import AutoDFL
    from repro_torch.kernels import block_pack as bp
    from repro_torch.kernels import model_distance as md
    from repro_torch.kernels import weighted_agg as wa
    clock = PhaseClock()
    for owner, attr, phase in (
            (VectorCohort, "train", "train"), (MegaCohort, "train", "train"),
            (fl_sched, "evaluate_quorum", "quorum"),
            (fl_sched, "mega_score_tables", "quorum"),
            (fl_sched, "quorum_from_table", "quorum"),
            (fl_sched, "weighted_average_tree", "eq1"),
            (fl_sched, "weighted_average_tree_mega", "eq1"),
            (fl_sched.TaskRuntime, "_finalize", "settle"),
            (AutoDFL, "settle_window", "settle"),
            (FusedWindowLoop, "execute", "fused_execute")):
        clock.wrap(owner, attr, phase)
    wrappers = {"weighted_agg": wa.weighted_agg,
                "model_distance": md.model_distance,
                "block_pack": bp.block_pack}
    for fn in wrappers.values():
        fn.launches = 0
    tables = (oracle._score_table_batched, oracle._score_table_loop,
              oracle.mega_score_tables)
    for fn in tables:
        fn.calls = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        node, sch, out, wall = run_fl(dev, FL_RUN, **knobs)
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
    if l2 != chain.total_gas or chain.n_confirmed != chain.n_submitted:
        raise AssertionError(f"L2 gas {l2} != L1 gas {chain.total_gas}, or "
                             f"the L1 did not drain")
    st = ru.state_arrays
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
    expect = {
        "default": {"weighted_agg": windows,
                    "model_distance": FL_RUN["tasks"], "block_pack": 1},
        "stepped": {"weighted_agg": FL_RUN["tasks"] * FL_RUN["rounds"],
                    "model_distance": FL_RUN["tasks"], "block_pack": 0}}
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
# phase 10's cuts of the assigned shapes (configs/base.py SHAPES): prefill
# 32 x 32,768 -> 8 x 4,096 (the simple kernel's time on the chip); decode
# 128 x 32,768 -> 8 x 4,128 (decode_32k's cache at batch 128 is 256 GiB)
PREFILL = dict(batch=8, seq=4096)
DECODE = dict(batch=8, max_len=4128, steps=32)
BF16_TENSOR_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
# query rows held to the plain version at prefill_32k's sequence (its
# full scores would take 137 GB): the first, a middle and the last 256
LONG_ROWS = 256
# card against CPU on the reduced LMs: float32 sums in another order;
# bfloat16 a few bfloat16 steps on logits of order 3, as the CPU parity
# tests hold the port to the JAX package (tests/test_torch_transformer.py)
LM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=2e-2, atol=6e-2)}
# prefill against decode at full width: tests/test_arch_smoke.py:85's
# tolerance, over 32 bfloat16 layers
PREFILL_DECODE_TOL = dict(rtol=0.15, atol=0.15)


def attn_bound(B, S, H, Hkv, dh, causal=True, itemsize=2):
    """(bound ms, "operations" or "bytes"): 4 B H S^2 dh FLOPs (halved
    when causal) over the bf16 tensor peak, q + k + v + o over HBM."""
    flops = 4 * B * H * S * S * dh / (2 if causal else 1)
    n_bytes = itemsize * (2 * B * S * H * dh + 2 * B * S * Hkv * dh)
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, mem_ms), "operations" if ops_ms >= mem_ms else "bytes"


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
    err = {f32: 0.0, bf16: 0.0}
    n = 0
    for shape in grid:
        for dtype in (f32, bf16):
            q, k, v = qkv(*shape, dtype)
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal)
                want = fa.flash_attention_torch(q, k, v, causal)
                h = held(got, want, f"at {shape}")
                err[dtype] = max(err[dtype], h["max_abs_err"])
                n += 1
    torch.cuda.synchronize()
    log(f"attention: flash_attention within tolerance of plain on {n} "
        f"inputs (float32 rtol 1e-4 atol 1e-5, bfloat16 {fa.KERNEL_TOL[bf16]}); "
        f"largest |kernel - plain| float32 {err[f32]}, bfloat16 {err[bf16]}")

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    L = YI_LAYER
    q, k, v = qkv(L["B"], L["S"], L["H"], L["Hkv"], L["dh"], bf16)
    out = fa.flash_attention(q, k, v)
    want = fa.flash_attention_torch(q[:1], k[:1], v[:1])
    h0 = held(out[:1], want, f"at {list(L.values())}, row 0")
    row_err = h0["max_abs_err"]
    # the row-slice reference against the plain version on the same rows
    S = L["S"]
    h_ref = held(plain_rows(q[:1], k[:1], v[:1], S - LONG_ROWS, S),
                 want[:, S - LONG_ROWS:], "plain_rows against plain")
    lib_err = float((sdpa(q, k, v).float() - out.float()).abs().max())
    del out, want
    bound, bound_by = attn_bound(**L)
    row = {"name": "flash_attention", "max_abs_err": row_err,
           "ms": timed_ms(lambda: fa.flash_attention(q, k, v), 5, flush),
           "plain_ms": timed_ms(lambda: [fa.flash_attention_torch(
               q[b:b + 1], k[b:b + 1], v[b:b + 1]) for b in range(L["B"])],
               2, flush),
           "library_ms": timed_ms(lambda: sdpa(q, k, v), 5, flush),
           "bound_ms": bound, "bound_by": bound_by,
           "shape": [L["B"], L["S"], L["H"], L["Hkv"], L["dh"]]}
    log(f"kernel flash_attention at {row['shape']} (bfloat16, causal): "
        f"{row['ms']:.6f} ms (bound {bound:.6f} ms, {bound_by}), plain "
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
    bound, bound_by = attn_bound(**L)
    row["long"] = {
        "ms": timed_ms(lambda: fa.flash_attention(q, k, v), 2, flush),
        "plain_ms": None, "library_ms": timed_ms(lambda: sdpa(q, k, v), 2,
                                                 flush),
        "bound_ms": bound, "bound_by": bound_by,
        "shape": [L["B"], L["S"], L["H"], L["Hkv"], L["dh"]]}
    t = row["long"]
    log(f"kernel flash_attention at {t['shape']} (bfloat16, causal): "
        f"{t['ms']:.6f} ms (bound {bound:.6f} ms, {bound_by}), SDPA "
        f"{t['library_ms']:.6f} ms; against plain on query rows "
        f"{json.dumps(h_long)}; |kernel - SDPA| {long_err} (not held); plain "
        f"ms: not measured (its scores would take 137 GB)")
    return row


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
                old = os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
                if impl:
                    os.environ["REPRO_TORCH_KERNEL_IMPL"] = impl
                try:
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
                finally:
                    os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
                    if old is not None:
                        os.environ["REPRO_TORCH_KERNEL_IMPL"] = old
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


def profile_share(fn) -> dict:
    """``fn`` under torch.profiler: the union of its device intervals over
    the traced wall, the part of it in the attention kernel, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, busy_us, by_name = device_time(prof)
    attn_us = sum(us for name, us in by_name.items()
                  if "flash_attention_kernel" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"traced_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "attention_s": attn_us / 1e6,
            "attention_share": attn_us / busy_us if busy_us else None,
            "top_s": {name[:60]: us / 1e6 for name, us in top}}


def lm_main(dev, smi: str) -> dict:
    """yi-6b at full width and depth, bfloat16, weights drawn on the card:
    a 64-token prompt through prefill and through 64 decode steps (held
    to each other); the prefill of 8 x 4,096 tokens (flash_attention
    launches counted from 0); its caches in a decode state of 8 x 4,128
    and 32 decode steps; the prefill's kernel share under the profiler;
    then the serve loop of launch/serve_model.py at its defaults.
    Returns the prefill's launch count."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_model
    from repro_torch.models.model import build_model
    cfg = get_config("yi-6b")
    g = torch.Generator().manual_seed(2)
    model = build_model(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"lm: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads (kv {cfg.n_kv_heads}, head_dim "
        f"{cfg.head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{n_params} parameters ({cfg.param_count()} without norm scales), "
        f"{2 * n_params / 1e9:.3f} GB in bfloat16, drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    log(f"lm: cuts from the assigned shapes: prefill_32k 32 x 32,768 -> "
        f"{PREFILL['batch']} x {PREFILL['seq']}; decode_32k 128 x 32,768 -> "
        f"{DECODE['batch']} x {DECODE['max_len']}")

    # 10a. prefill against decode at full width (also the warm-up)
    toks = torch.randint(0, cfg.vocab_size, (1, 64), generator=g).to(dev)
    last, caches = model.prefill(params, {"tokens": toks})
    state = model.init_decode_state(1, 64)
    for t in range(64):
        step, state = model.decode(params, state,
                                   {"tokens": toks[:, t:t + 1], "pos": t})
    torch.cuda.synchronize()
    gap = float((step.float() - last.float()).abs().max())
    agree = bool((step.argmax(-1) == last.argmax(-1)).all())
    torch.testing.assert_close(step.float(), last.float(),
                               **PREFILL_DECODE_TOL)
    torch.testing.assert_close(state["b0"]["k"].float(),
                               caches["b0"]["k"].float(),
                               **PREFILL_DECODE_TOL)
    log(f"lm: prefill against 64 decode steps at full width: largest "
        f"|logit gap| {gap} (tolerance rtol 0.15 atol 0.15, "
        f"tests/test_arch_smoke.py:85's), argmax agrees: {agree}, logits "
        f"up to {float(last.float().abs().max())}")
    del last, caches, state, step

    # 10b. prefill, flash_attention launches from 0
    B, S = PREFILL["batch"], PREFILL["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g).to(dev)
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"the prefill launched flash_attention "
                             f"{launches} times, not {cfg.n_layers}")
    kv_shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    if tuple(logits.shape) != (B, cfg.vocab_size) or \
            tuple(caches["b0"]["k"].shape) != kv_shape or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill gave logits {tuple(logits.shape)}, "
                             f"caches {tuple(caches['b0']['k'].shape)}")

    # 10c. decode against the prefill's caches
    state = model.init_decode_state(DECODE["batch"], DECODE["max_len"])
    for kv in ("k", "v"):
        state["b0"][kv][:, :, :S] = caches["b0"][kv]
    del caches
    tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(S, S + DECODE["steps"]):
        logits, state = model.decode(params, state, {"tokens": tok,
                                                     "pos": t})
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode gave non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 2**30

    def decode_steps(n=8):
        nonlocal logits, state, tok
        for t in range(S, S + n):          # rewrites the first steps
            logits, state = model.decode(params, state, {"tokens": tok,
                                                         "pos": t})
            tok = logits.argmax(-1)[:, None]
    n_steps = DECODE["steps"]
    traced_decode = profile_share(decode_steps)
    del state, logits, tok
    traced_prefill = profile_share(
        lambda: model.prefill(params, {"tokens": tokens}))
    stats = {
        "prefill_s": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
        "decode_ms_per_step": decode_s / n_steps * 1e3,
        "decode_tokens_per_s": B * n_steps / decode_s,
        "peak_device_memory_GiB": peak, "flash_attention_launches": launches}
    log(f"lm: prefill {B} x {S} (its wall is the time to first token) and "
        f"{n_steps} decode steps at {B} x {DECODE['max_len']} on {smi}: "
        f"{json.dumps(stats)}")
    log(f"lm profile: prefill {json.dumps(traced_prefill)}")
    log(f"lm profile: 8 more decode steps {json.dumps(traced_decode)}")
    del params, tokens
    torch.cuda.empty_cache()

    # 10d. the serve loop at its defaults (batch 4, prompt 8, 8 tokens)
    served = serve_model.main([])
    log(f"lm: serve_model at its defaults (yi-6b, batch 4, prompt 8, 8 "
        f"tokens): {served['tokens_per_s']} tokens/s over "
        f"{served['seconds']} s, first row {served['tokens'][0].tolist()}")
    return {"flash_attention": launches}


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
    built = _build.build(force=True)
    usage = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or ln.startswith("==")]
    log(f"build: {[src.name for src in _build.sources()]} -> "
        f"{built.path.relative_to(ROOT)} in {built.seconds:.3f} s")
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
    pack_args, fused_client, _ = fused_node(dev, wl, smi)
    pack_row = check_block_pack(dev, pack_args, fused_client)
    del fused_client, pack_args, wl

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
    launches.update(lm_main(dev, smi))

    replaces = {"rollup_digest": "src/repro/kernels/rollup_digest.py:16",
                "rollup_chunk_digests":
                    "src/repro/kernels/rollup_digest.py:76",
                "dirty_fold": "src/repro/kernels/dirty_fold.py:107",
                "batch_seal": "src/repro/kernels/batch_seal.py:59",
                "weighted_agg": "src/repro/kernels/weighted_agg.py:22",
                "model_distance": "src/repro/kernels/model_distance.py:18",
                "block_pack": "src/repro/kernels/block_pack.py:179",
                "flash_attention": "src/repro/kernels/flash_attention.py:25"}
    sources = {"weighted_agg": "fl.cu", "model_distance": "fl.cu",
               "block_pack": "pack.cu", "flash_attention": "attn.cu"}
    # the default FL path merges Eq. 1 with the task axis: its row is
    # timed at (32, 64, 2,410); the per-task (64, 2,410) is logged below
    agg = fl_rows["weighted_agg"]
    kernels = []
    for row in rows + [dict(agg, **agg["task"]), fl_rows["model_distance"],
                       pack_row, attn_row]:
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
    per_task = {k: agg[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "shape")}
    log(f"per-task weighted_agg: {json.dumps(per_task)}")
    log(f"flash_attention at prefill_32k's sequence: "
        f"{json.dumps(attn_row['long'])}")

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
