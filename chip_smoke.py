#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths on one CUDA card: the rollup
node path and the reputation-aware FL protocol run.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its result on a line of its own:

  1. device  — needs a CUDA card; prints its name and power limit
               (nvidia-smi) and the torch and CUDA versions; float32
               matrix products must run in full float32 (no TF32).
  2. build   — compiles every src/repro_torch/kernels/csrc/*.cu with nvcc
               (in parallel) into one library; prints ptxas's register use.
  3. kernels — the four fold kernels against their plain PyTorch versions
               on the card, bit for bit, and the two FL kernels (Eq. 1
               ``weighted_agg``, Eq. 4 ``model_distance``) within rtol
               1e-5 / atol 1e-6 in float32 and 2e-2 in bfloat16, at the
               grids of the CPU tests and at the shapes of the main paths
               (plus a 1M-wide FL shape); times each (CUDA events, L2
               flushed before every launch) beside its bound, the plain
               version's time and, where one exists, one PyTorch call's.
  4. node    — NodeClient on the card: 1M transactions of the Table-I mix
               over 262,144 accounts, 20 one-second windows of
               submit_arrays / seal / run_until, then flush and drain;
               launch counts of the fold kernels read just after.
  5. agree   — the node path at a tenth of the size three ways (card with
               kernels, card with the plain versions forced, CPU): the
               gas log, blocks, digests and per-window state roots must
               be equal.
  6. fl agree — the FL protocol run at 4 tasks x 16 trainers, 2 rounds,
               the same three ways: protocol calls, gas log, blocks,
               selections, event kinds and DON scores equal; reputations
               and payouts within rtol 1e-5 / atol 1e-6, parameters within
               rtol 1e-5 / atol 1e-5 of each leaf's largest value; each
               card run's final state root equal to the root of its fields
               recomputed on the CPU.
  7. fl      — the FL protocol run on the card at the largest point of
               benchmarks/bench_protocol.py: 32 concurrent tasks x 64
               trainers on NodeSpec() with seal_every=2, TinyMLP(64, 32,
               10), 3 rounds of 2 local sgdm steps on batches of 8 under
               DP; launch counts of the FL kernels read just after.  Then
               the same run under torch.profiler: the device's busy time
               and the kernels that take it.

Then one JSON line lists every kernel with its launches on its path, the
card's name and power limit follow on a line of their own, and the last
line is ``{"ok": true, "device": {...}}``.  Any failed phase raises before
them, so the script exits nonzero with no result line; so it does without
a CUDA card, or outside a checkout of the repository.
"""
from __future__ import annotations

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
    plain versions forced, and on the CPU: identical outputs."""
    from repro_torch.core.workloads import make_workload
    outs = {}
    for label, device, impl in (("card, kernels", dev, None),
                                ("card, plain", dev, "torch"),
                                ("cpu", torch.device("cpu"), None)):
        old = os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
        if impl:
            os.environ["REPRO_TORCH_KERNEL_IMPL"] = impl
        try:
            wl = make_workload("mixed", device=device, **TENTH)
            client, _, windows, _ = run_node(wl, device, receipts=False)
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


# -- phase 3: FL kernels against their plain versions --------------------------

def check_fl_kernels(dev, path_n: int, path_p: int, wide_p: int) -> dict:
    """weighted_agg and model_distance against their plain versions at
    the grids of tests/test_kernels.py, at the FL path's shape and at a
    1M-wide shape; times at the last two.  Returns {name: row} with the
    path shape's numbers, and the wide shape's under ``"wide"``."""
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
    return out


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


def run_fl(dev, cfg, behaviors=None, phases=None):
    """One Scheduler run of ``cfg['tasks']`` concurrent tasks on
    ``NodeSpec()`` (the protocol-scheduler preset) with seal_every=2.
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
    sch = Scheduler(node, seal_every=2)
    for t in range(tasks):
        sch.add_task(FLTaskSpec(f"task{t}", rounds=cfg["rounds"]),
                     VectorCohort(model, opt, batch_fn, node.store,
                                  behaviors=behaviors, n_trainers=n,
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
        "root": node.rollup.state_root(),
        "cpu_root": StateArrays.from_numpy(fields, "cpu").root(),
    }


def fl_agree(dev) -> None:
    """The FL run at 4 tasks x 16 trainers, 2 rounds, on the card with
    kernels, on the card with the plain versions forced, and on the CPU."""
    behaviors = ["good", "good", "malicious", "lazy"] * (
        FL_AGREE["trainers"] // 4)
    outs = {}
    for label, device, impl in (("card, kernels", dev, None),
                                ("card, plain", dev, "torch"),
                                ("cpu", torch.device("cpu"), None)):
        old = os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
        if impl:
            os.environ["REPRO_TORCH_KERNEL_IMPL"] = impl
        try:
            node, sch, out, wall = run_fl(device, FL_AGREE, behaviors)
        finally:
            os.environ.pop("REPRO_TORCH_KERNEL_IMPL", None)
            if old is not None:
                os.environ["REPRO_TORCH_KERNEL_IMPL"] = old
        outs[label] = o = fl_outputs(node, sch, out)
        if o["root"] != o["cpu_root"]:
            raise AssertionError(f"fl agree {label}: root {o['root']} != "
                                 f"the CPU root of its fields {o['cpu_root']}")
        log(f"fl agree {label}: {sum(o['protocol_calls'].values())} protocol "
            f"calls, {len(o['gas_log'])} batches, {len(o['blocks']) - 1} "
            f"blocks, root {o['root']} (= the CPU root of its fields), "
            f"{wall:.3f} s")
    ref = outs["cpu"]
    for label, o in outs.items():
        worst = max(float(np.abs(o["params"][t][k] - v).max())
                    for t in ref["params"] for k, v in ref["params"][t].items())
        log(f"fl agree {label}: largest |param - CPU param| {worst}, "
            f"largest |reputation - CPU| "
            f"{float(np.abs(o['reputation'] - ref['reputation']).max())}")
    for label, o in outs.items():
        for key in ("protocol_calls", "gas_log", "blocks", "selected",
                    "event_kinds", "scores"):
            if o[key] != ref[key]:
                raise AssertionError(f"fl agree: {label} differs from the "
                                     f"CPU in {key}")
        for t in ref["params"]:
            for k, v in ref["params"][t].items():
                # float32 products sum in another order on the card than
                # on the CPU, through four SGD steps: an element near zero
                # carries an absolute difference on the scale of its leaf,
                # so the absolute term is 1e-5 of the leaf's largest value
                np.testing.assert_allclose(
                    o["params"][t][k], v, rtol=F32_TOL["rtol"],
                    atol=F32_TOL["rtol"] * float(np.abs(v).max()),
                    err_msg=f"{label}: {t} {k}")
            for who, pay in ref["payouts"][t].items():
                np.testing.assert_allclose(o["payouts"][t][who], pay,
                                           **F32_TOL, err_msg=label)
        np.testing.assert_allclose(o["reputation"], ref["reputation"],
                                   **F32_TOL, err_msg=label)
    log(f"fl agree: card (kernels), card (plain) and CPU agree over "
        f"{FL_AGREE['tasks']} tasks x {FL_AGREE['trainers']} trainers, "
        f"{FL_AGREE['rounds']} rounds (ledger, selections, scores exact; "
        f"reputations, payouts within rtol 1e-5 atol 1e-6; params within "
        f"rtol 1e-5 atol 1e-5 x the leaf's largest value)")


class PhaseClock:
    """Host seconds spent in named methods, each ending in a synchronize
    so that a phase holds its own device work."""

    def __init__(self):
        self.seconds = {}
        self._undo = []

    def wrap(self, owner, attr: str, phase: str) -> None:
        fn = getattr(owner, attr)
        self.seconds.setdefault(phase, 0.0)

        def timed(*args, **kw):
            t0 = time.perf_counter()
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


def fl_main(dev, smi: str) -> dict:
    """The FL protocol run at 32 tasks x 64 trainers, launch counts from 0;
    returns the launches of the FL kernels and the wall seconds."""
    from repro_torch.core import oracle
    from repro_torch.core.gas import DEFAULT_GAS, L1_DEFAULT_GAS
    from repro_torch.fl import scheduler as fl_sched
    from repro_torch.fl.cohort import VectorCohort
    from repro_torch.fl.server import AutoDFL
    from repro_torch.kernels import model_distance as md
    from repro_torch.kernels import weighted_agg as wa
    clock = PhaseClock()
    clock.wrap(VectorCohort, "train", "train")
    clock.wrap(fl_sched, "evaluate_quorum", "quorum")
    clock.wrap(fl_sched, "weighted_average_tree", "eq1")
    clock.wrap(fl_sched.TaskRuntime, "_finalize", "settle")
    clock.wrap(AutoDFL, "settle_window", "settle")
    wrappers = {"weighted_agg": wa.weighted_agg,
                "model_distance": md.model_distance}
    for fn in wrappers.values():
        fn.launches = 0
    oracle._score_table_batched.calls = oracle._score_table_loop.calls = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        node, sch, out, wall = run_fl(dev, FL_RUN)
    finally:
        clock.restore()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    batched = oracle._score_table_batched.calls
    looped = oracle._score_table_loop.calls
    # the repo's own invariants on the result
    n_rounds = FL_RUN["tasks"] * FL_RUN["rounds"]
    if batched != n_rounds or looped:
        raise AssertionError(f"DON scoring: {batched} batched and {looped} "
                             f"looped tables for {n_rounds} task-rounds")
    if sorted(out) != sorted(f"task{t}" for t in range(FL_RUN["tasks"])):
        raise AssertionError("not every task finished")
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
    stats = {"tasks": FL_RUN["tasks"], "trainers": FL_RUN["trainers"],
             "rounds": FL_RUN["rounds"],
             "protocol_calls": node.protocol_calls,
             "scheduler_windows": sch.n_windows,
             "sealed_windows": len(sch.window_records),
             "batches": ru.n_batches,
             "l1_blocks": len(chain.blocks) - 1,
             "aggregates": len(sch.settlement_records),
             "state_root": ru.state_root(), "task0_val_acc": acc,
             "l1_equivalent_gas": int(l1_equiv), "l2_gas": int(l2),
             "gas_reduction": l1_equiv / l2,
             "batched_don_tables": batched, "looped_don_tables": looped}
    log(f"fl: {json.dumps(stats)}")
    log(f"fl: wall {wall:.6f} s for {n_txs} protocol txs over "
        f"{sch.n_windows} scheduling windows ({wall / sch.n_windows:.6f} s "
        f"per window, {n_txs / wall:.1f} tx/s, "
        f"{n_txs / wall / FL_RUN['tasks']:.1f} per task) on {smi}; peak "
        f"device memory {peak:.1f} MiB")
    log(f"fl: host seconds by phase (each ends in a synchronize) "
        f"{json.dumps(spans)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"the FL path never launched {missing}")
    return launches, wall


def fl_profile(dev, wall: float) -> None:
    """Device time of the FL path: the same run again under
    ``torch.profiler``; the union of its device intervals (kernels,
    copies, fills) over the traced wall and over the untraced ``wall``,
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, traced_wall = run_fl(dev, FL_RUN)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy = busy_us / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"fl profile: {len(spans)} device intervals, device busy "
        f"{busy:.6f} s = {busy / traced_wall:.6f} of the traced wall "
        f"{traced_wall:.6f} s and {busy / wall:.6f} of the untraced wall "
        f"{wall:.6f} s")
    log("fl profile: device seconds by name " + json.dumps(
        {name[:80]: us / 1e6 for name, us in top}))


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
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
    fl_rows = check_fl_kernels(dev, FL_RUN["trainers"], n_params, 1 << 20)

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
    del client, rcpts, wl

    # 5. node path: card against CPU at a tenth of the size
    agree(dev)

    # 6. FL path: card against CPU at 4 tasks x 16 trainers
    fl_agree(dev)

    # 7. FL path on the card, launch counts from 0; then its device time
    fl_launches, fl_wall = fl_main(dev, smi)
    launches.update(fl_launches)
    fl_profile(dev, fl_wall)

    replaces = {"rollup_digest": "src/repro/kernels/rollup_digest.py:16",
                "rollup_chunk_digests":
                    "src/repro/kernels/rollup_digest.py:76",
                "dirty_fold": "src/repro/kernels/dirty_fold.py:107",
                "batch_seal": "src/repro/kernels/batch_seal.py:59",
                "weighted_agg": "src/repro/kernels/weighted_agg.py:22",
                "model_distance": "src/repro/kernels/model_distance.py:18"}
    kernels = []
    for row in rows + list(fl_rows.values()):
        name = row["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/fl.cu"
                       if name in fl_rows else
                       "src/repro_torch/kernels/csrc/fold.cu"),
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

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
