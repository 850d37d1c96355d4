#!/usr/bin/env python3
"""Where a ``batch_seal`` launch goes: time the kernel
(``batch_seal_span_kernel`` in ``csrc/fold.cu``) whole and in trial builds
that each stop it short, at the node path's three shapes: the stepped
seal (200,788 words in 2,510 batches), and over the fused twin's
4,001,576-word buffer one segment of 80 words a batch (50,040, the roots)
or 20 equal segments (one digest a seal):

    copy_only   returns once its span is staged: the launch, the bulk
                copy, the search and the staged starts
    no_walk     skips the walk of the span (nothing is folded)
    no_carry    returns before its carry: no fence, ticket or last block
    no_tail     the last block returns at once: no prefix, no running
                segments written

The trial builds compute wrong results and serve for timing only.  They
are made at run time from ``csrc/fold.cu`` by text edits, each compiled
alone with nvcc into ``build/seal_split/``; nothing of them is kept in
the source.  Each build is timed by CUDA events and by the profiler's
device time of the kernel (chip_smoke.timed_ms and device_ms, L2 flushed
before every launch), in turns (whole, trials, trials reversed, whole).

    python3 tools/seal_split.py

Prints one JSON line a shape, with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# {variant: [(text of csrc/fold.cu, its replacement)]}
VARIANTS = {
    "whole": [],
    "copy_only": [("  hopper::mbar_wait(&bar, 0);\n",
                   "  hopper::mbar_wait(&bar, 0);\n  if (blocks) return;\n")],
    "no_walk": [("  for (int i = threadIdx.x * per; i < v_hi; ++i) {",
                 "  for (int i = v_hi; i < v_hi; ++i) {")],
    "no_carry": [("  if (blocks == 1) return;", "  if (blocks) return;")],
    "no_tail": [("  if (!is_last) return;",
                 "  if (!is_last || blocks) return;")],
}


def build(out_dir: Path) -> dict:
    """Compile every variant at once; returns {variant: loaded library}."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "fold.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the edit's text occurs "
                                   f"{src.count(old)} times in fold.cu")
            src = src.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-shared", "-I",
             str(_build.CSRC), "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.fold_batch_seal.argtypes = list(
            _build._SIGNATURES["fold_batch_seal"])
        lib.fold_batch_seal.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("seal_split: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import batch_seal as bs
    dev = torch.device("cuda")
    libs = build(ROOT / "build" / "seal_split")
    g = np.random.default_rng(0)

    def words(n):
        w = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(dev)

    n_run = 4_001_576
    shapes = {
        "stepped seal": (words(200_788), cs.seal_starts(50_197, 2, 20)),
        "80-word segments": (words(n_run), np.arange(0, n_run, 80)),
        "20 segments": (words(n_run),
                        np.linspace(0, n_run, 21)[:-1].astype(np.int64))}
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    names = list(VARIANTS)
    for label, (w, starts) in shapes.items():
        starts = torch.from_numpy(np.asarray(starts, np.int64)).to(dev)
        p = bs.plan(w.numel())
        carry = torch.empty(3 * p.blocks, dtype=torch.int64, device=dev)
        out = torch.empty(starts.numel(), dtype=torch.int32, device=dev)

        def run(name):
            rc = libs[name].fold_batch_seal(
                dev.index or 0, w.data_ptr(), w.numel(), starts.data_ptr(),
                starts.numel(), p.span, carry.data_ptr(), out.data_ptr(),
                stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        run("whole")
        if not torch.equal(out, bs.batch_seal_torch(w, starts)):
            raise AssertionError(f"whole build at {label}: differs from "
                                 f"plain")
        ms = {name: [] for name in names}
        dev_ms = {name: [] for name in names}
        for name in names + names[::-1]:
            ms[name].append(cs.timed_ms(lambda: run(name), 30, flush))
            dev_ms[name].append(cs.device_ms(
                lambda: run(name), "batch_seal_span_kernel", 20, flush))
        print(json.dumps({
            "shape": label, "words": w.numel(), "segments": starts.numel(),
            "span": p.span, "blocks": p.blocks, "card": cs.nvidia_smi(),
            "ms": {k: sum(v) / len(v) for k, v in ms.items()},
            "device_ms": {k: sum(v) / len(v) for k, v in dev_ms.items()},
            "runs": {"ms": ms, "device_ms": dev_ms}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
