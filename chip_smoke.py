#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's rollup node path on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its result on a line of its own:

  1. device  — needs a CUDA card; prints its name and power limit
               (nvidia-smi) and the torch and CUDA versions.
  2. build   — compiles src/repro_torch/kernels/csrc/fold.cu with nvcc.
  3. kernels — each of the four fold kernels against its plain PyTorch
               version on the card, bit for bit, at the grids of the CPU
               tests and at the shapes of the main path; times each
               (CUDA events, L2 flushed before every launch) beside its
               byte bound and the plain version's time.
  4. main    — NodeClient on the card: 1M transactions of the Table-I mix
               over 262,144 accounts, 20 one-second windows of
               submit_arrays / seal / run_until, then flush and drain.
  5. counts  — how many times the main path launched each kernel (every
               count must be above 0), as one JSON line.
  6. agree   — the main path at a tenth of the size three ways (card with
               kernels, card with the plain versions forced, CPU): the
               gas log, blocks, digests and per-window state roots must
               be equal.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises before it, so the script exits nonzero with no result line; so it
does without a CUDA card, or outside a checkout of the repository.
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
OPS_PER_WORD = 4                 # shift, xor, multiply, xor-reduce
FULL = dict(rate=50_000.0, duration=20.0, seed=0, n_senders=262_144)
TENTH = dict(rate=5_000.0, duration=20.0, seed=0, n_senders=26_214)


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


# -- phases 4 and 6: the node path ---------------------------------------------

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


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.workloads import make_workload
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import dirty_fold as df
    from repro_torch.kernels import rollup_digest as rd

    # 2. build
    built = _build.build(force=True)
    usage = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log(f"build: {built.path.relative_to(ROOT)} in {built.seconds:.3f} s")
    for ln in usage:
        log(f"  ptxas: {ln}")

    # 3. kernels, at the shapes the main path gives them
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

    # 4. main path, launch counts from 0
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

    # 5. launches on the main path
    replaces = {"rollup_digest": "src/repro/kernels/rollup_digest.py:16",
                "rollup_chunk_digests":
                    "src/repro/kernels/rollup_digest.py:76",
                "dirty_fold": "src/repro/kernels/dirty_fold.py:107",
                "batch_seal": "src/repro/kernels/batch_seal.py:59"}
    kernels = []
    for row in rows:
        name = row["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fold.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    # 6. card against CPU at a tenth of the size
    agree(dev)

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
