#!/usr/bin/env python3
"""Where a ``shard_seal`` launch goes: time the kernel
(``shard_seal_cluster_kernel`` in ``csrc/shard.cu``) whole and in trial
builds that each stop it short, at the fused fabric twin's two call
shapes (8 lanes of some 502,000 words: 80-word segments, the batch
roots; 20 segments a lane, one digest a seal), at 8 and 16 blocks a lane:

    launch_only  returns after the padded columns: the launch of the
                 clusters and the seeds
    no_search    stages one start (no guessed bracket, no probes): the
                 walk sees one segment a range
    no_walk      skips the walk of each stage (the ring still turns)
    copy_only    both: the copies through the ring, nothing else
    no_join      returns before the cluster join

and in trial builds that change the design, held bit for bit to the
plain version:

    guess_first  the producer waits for the guessed starts before it
                 issues the first stages
    one_group    one group of walkers walks every stage (kGroups 1)
    ring2        kRing stages in flight: 2, one a group (4 in the tree)

The trial builds are made at run time from ``csrc/shard.cu`` by text
edits, each compiled alone with nvcc into ``build/shard_split/``; nothing
of them is kept in the source.  The stopped-short builds compute wrong
results and serve for timing only.  Each build is timed by CUDA events
and by the profiler's device time (chip_smoke.timed_ms and device_ms, L2
evicted before every launch by writing a buffer, whose dirty lines are
written back while the kernel reads, and for ``clean_device_ms`` by
reading it), in turns (the builds, then in reverse).

    python3 tools/shard_split.py

Prints one JSON line a shape and block count, with the card's name and
power limit, and each build's cluster capacity.
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

WALK = "      for (int i = v0; i < v1; ++i) {\n"
GUESS = "  const bool guess = g_hi - g_lo < kRaw;\n"
NO_GUESS = GUESS.replace("g_hi - g_lo < kRaw", "false")
SEARCH = "  int64_t lb[2] = {0, 0}, open[2] = {nb, nb};\n"
NO_SEARCH = SEARCH.replace("{nb, nb}", "{0, 0}")
FIRST = "    for (int s = 0; s < kRing && s < stages; ++s) issue(s);\n"
# {variant: ([(text of csrc/shard.cu, its replacement)], exact)}
VARIANTS = {
    "whole": ([], True),
    "launch_only": ([("  if (nb < 1) return;", "  if (nb >= 0) return;")],
                    False),
    "no_search": ([(GUESS, NO_GUESS), (SEARCH, NO_SEARCH)], False),
    "no_walk": ([(WALK, WALK.replace("v0; i < v1", "v1; i < v1"))], False),
    "copy_only": ([(GUESS, NO_GUESS), (SEARCH, NO_SEARCH),
                   (WALK, WALK.replace("v0; i < v1", "v1; i < v1"))], False),
    "no_join": ([("  // The join in rank 0's shared memory.\n",
                  "  if (n >= 0) {\n    hopper::cluster_wait_acquire();\n"
                  "    return;\n  }\n")], False),
    "guess_first": ([(FIRST, "    if (guess) hopper::mbar_wait(&guessed, 0);\n"
                      + FIRST)], True),
    "one_group": ([("constexpr int kGroups = 2;",
                    "constexpr int kGroups = 1;")], True),
    "ring2": ([("constexpr int kRing = 4;", "constexpr int kRing = 2;")],
              True),
}


def build(out_dir: Path) -> dict:
    """Compile every variant at once; returns {variant: loaded library}."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "shard.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the edit's text occurs "
                                   f"{src.count(old)} times in shard.cu")
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
        for fn in ("fold_shard_seal", "fold_shard_seal_capacity"):
            getattr(lib, fn).argtypes = list(_build._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def fabric_shapes(dev) -> dict:
    """The fused fabric twin's two call shapes on random words: 8 lanes
    of 500,000-504,000 words, cut every 80 words (the roots) or into 20
    equal segments (the seal digests)."""
    import chip_smoke as cs
    g = np.random.default_rng(1)
    sizes = [500_000 + int(g.integers(0, 4000)) for _ in range(8)]
    words = [g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
             for n in sizes]
    return {
        "roots": cs.lane_grid([(w, np.arange(0, w.size, 80))
                               for w in words], dev),
        "seal digests": cs.lane_grid(
            [(w, np.linspace(0, w.size, 21)[:-1].astype(np.int64))
             for w in words], dev)}


def main() -> int:
    if not torch.cuda.is_available():
        print("shard_split: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import shard_lanes as sl
    dev = torch.device("cuda")
    libs = build(ROOT / "build" / "shard_split")
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = dev.index or 0
    capacity = {}
    for name, lib in libs.items():
        fit = {}
        for c in (8, 16):
            out = ctypes.c_int(0)
            if lib.fold_shard_seal_capacity(index, c, ctypes.addressof(out),
                                            stream):
                raise RuntimeError(f"{name}: capacity query failed")
            fit[c] = out.value
        capacity[name] = fit
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    names = list(VARIANTS)
    for label, args in fabric_shapes(dev).items():
        words, starts, n_seg, n_words = args
        k, b = starts.shape
        want = sl.shard_seal_torch(*args)
        for c in (8, 16):
            out = torch.empty(k, b, dtype=torch.int32, device=dev)

            def run(name):
                rc = libs[name].fold_shard_seal(
                    index, words.data_ptr(), words.stride(0),
                    starts.data_ptr(), starts.stride(0), n_seg.data_ptr(),
                    n_words.data_ptr(), k, b, words.shape[1], c,
                    out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            for name in names:
                if VARIANTS[name][1]:
                    run(name)
                    if not torch.equal(out, want):
                        raise AssertionError(f"{name} build at {label}, "
                                             f"{c} blocks: differs from "
                                             f"plain")
            ms = {name: [] for name in names}
            dev_ms = {name: [] for name in names}
            clean_ms = {name: [] for name in names}
            for name in names + names[::-1]:
                print(f"timing {name} at {label}, {c} blocks", file=sys.stderr,
                      flush=True)
                ms[name].append(cs.timed_ms(lambda: run(name), 30, flush))
                dev_ms[name].append(cs.device_ms(
                    lambda: run(name), "shard_seal_cluster_kernel", 20,
                    flush))
                clean_ms[name].append(cs.device_ms(
                    lambda: run(name), "shard_seal_cluster_kernel", 20,
                    flush, clean=True))
            print(json.dumps({
                "shape": label, "lanes": k, "words": int(n_words.sum()),
                "segments": int(n_seg.sum()), "blocks_a_lane": c,
                "card": cs.nvidia_smi(),
                **cs.cost_bound("shard_seal", *args),
                "ms": {n: sum(v) / len(v) for n, v in ms.items()},
                "device_ms": {n: sum(v) / len(v) for n, v in dev_ms.items()},
                "clean_device_ms": {n: sum(v) / len(v)
                                    for n, v in clean_ms.items()},
                "capacity": capacity,
                "runs": {"ms": ms, "device_ms": dev_ms,
                         "clean_device_ms": clean_ms}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
