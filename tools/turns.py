#!/usr/bin/env python3
"""Time kernels of several source trees in turns on one CUDA card, at
their paths' shapes (``CASES``):

* ``batch_seal``: the stepped seal (200,788 words in 2,510 batches) and
  the fused twin's two calls over the run's 4,001,576-word buffer (50,040
  batch roots, and one digest a seal);
* the state commitment's full refold, 2,883,584 words (11 x 262,144
  accounts) in chunks of 2,048: ``dirty_fold`` with every chunk selected
  and ``rollup_chunk_digests``;
* Eq. 1 ``weighted_agg`` in float32 at the default FL path's (32, 64,
  2,410) task-axis launch, the stepped path's (64, 2,410) and 1M wide.

    python3 tools/turns.py [--only TEXT ...] TREE [TREE ...]

e.g. ``python3 tools/turns.py build/parent . . build/parent`` with a
``git archive`` of the parent commit unpacked under build/parent;
``--only TEXT`` (repeatable) keeps the cases whose label holds TEXT.  The
seals' inputs come from this checkout: the stepped seal's from
chip_smoke's arithmetic on random words, the fused calls' arguments
captured from the fused twin of the 1M-tx workload (chip_smoke.fused_node);
the others are drawn on the card from a seed a case.  Each TREE (the root
of a checkout) is then timed in a process of its own, with its own src/
and its own library: CUDA events with L2 flushed before each launch
(chip_smoke.timed_ms) and the kernel's device time from torch.profiler
(chip_smoke.device_ms), with L2 evicted by writing a buffer
(``device_ms``: its dirty lines are written back while the kernel reads)
and by reading it (``clean_device_ms``), each result held to the plain
version (bit for bit, Eq. 1 at float32 rtol 1e-5 / atol 1e-6).  One JSON
line a tree, in the order given, with the profiler traces taken again
(``retakes``); all of them, with the card's name and power limit, in
chiprun_out/turns.json.
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

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ROOT / "build" / "turns" / "shapes.pt"
OUT = ROOT / "chiprun_out" / "turns.json"
STATE_WORDS, CHUNK = 2_883_584, 2048
F32_TOL = {"rtol": 1e-5, "atol": 1e-6}
AGG_SHAPES = {"(32, 64, 2410)": (32, 64, 2410), "(64, 2410)": (1, 64, 2410),
              "(64, 1048576)": (1, 64, 1 << 20)}

# label -> (module of repro_torch.kernels, wrapper, tolerance against the
# plain version (None: bit for bit), a name fragment of its kernels in a
# trace: this tree's and those they replaced)
CASES = {
    "stepped seal": ("batch_seal", "batch_seal", None, "batch_seal"),
    "fused roots": ("batch_seal", "batch_seal", None, "batch_seal"),
    "fused seal digests": ("batch_seal", "batch_seal", None, "batch_seal"),
    "state refold": ("dirty_fold", "dirty_fold", None, "dirty_"),
    f"rollup_chunk_digests ({STATE_WORDS}, {CHUNK})": (
        "rollup_digest", "rollup_chunk_digests", None,
        "chunk_digests_kernel"),
    **{f"weighted_agg {shape}": ("weighted_agg", "weighted_agg", F32_TOL,
                                 "weighted_agg") for shape in AGG_SHAPES},
}
FROM_WORKLOAD = ("stepped seal", "fused roots", "fused seal digests")


def make_shapes(dev) -> None:
    """The seals' inputs, saved to SHAPES (CPU tensors)."""
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core.workloads import make_workload
    wl = make_workload("mixed", device=dev, **cs.FULL)
    times = wl.txs.submit_time.cpu().numpy()
    lo, hi = np.searchsorted(times, [cs.FULL["duration"] - 1,
                                     cs.FULL["duration"]])
    spec = cs.node_spec()
    g = np.random.default_rng(0)
    w = g.integers(0, 2**32, 4 * int(hi - lo), dtype=np.uint64)
    _, seals, _, _ = cs.fused_node(dev, wl, cs.nvidia_smi())
    shapes = {
        "stepped seal": (
            torch.from_numpy(w.astype(np.uint32).view(np.int32)),
            torch.from_numpy(cs.seal_starts(int(hi - lo),
                                            spec.rollup.n_lanes,
                                            spec.rollup.batch_size))),
        "fused roots": tuple(t.cpu() for t in seals[0]),
        "fused seal digests": tuple(t.cpu() for t in seals[1])}
    SHAPES.parent.mkdir(parents=True, exist_ok=True)
    torch.save(shapes, SHAPES)


def drawn(label: str, dev) -> tuple:
    """The arguments of a case not taken from the workload, drawn on the
    card from the case's own seed (the same in every process)."""
    g = torch.Generator(device=dev).manual_seed(list(CASES).index(label))
    if label.startswith("weighted_agg"):
        T, n, p = AGG_SHAPES[label.removeprefix("weighted_agg ")]
        w = torch.randn(T, n, p, generator=g, device=dev)
        s = torch.rand(T, n, generator=g, device=dev) * 0.95 + 0.05
        return (w, s) if T > 1 else (w[0], s[0])
    words = torch.randint(-2**31, 2**31 - 1, (STATE_WORDS,), generator=g,
                          device=dev, dtype=torch.int32)
    if label == "state refold":
        return words, torch.arange(-(-STATE_WORDS // CHUNK), device=dev), \
            CHUNK
    return words, CHUNK


def time_tree(tree: Path, labels: list, dev) -> dict:
    """This process's ``repro_torch`` is ``tree``'s: its kernels at every
    case in ``labels``, held to its plain versions, timed three ways."""
    import importlib

    import chip_smoke as cs
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    build_s = time.perf_counter() - t0
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    captured = (torch.load(SHAPES) if set(labels) & set(FROM_WORKLOAD)
                else {})
    row = {"tree": str(tree), "build_s": build_s}
    for label in labels:
        module, op, tol, fragment = CASES[label]
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        kernel, plain = getattr(mod, op), getattr(mod, f"{op}_torch")
        args = (tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                      for a in captured[label])
                if label in FROM_WORKLOAD else drawn(label, dev))
        got, want = kernel(*args), plain(*args)
        if tol:
            torch.testing.assert_close(got, want, **tol)
        elif not torch.equal(got, want):
            raise AssertionError(f"{tree}: {label} differs from plain")
        row[label] = {"ms": cs.timed_ms(lambda: kernel(*args), 50, flush),
                      "device_ms": cs.device_ms(lambda: kernel(*args),
                                                fragment, 20, flush),
                      "clean_device_ms": cs.device_ms(
                          lambda: kernel(*args), fragment, 20, flush,
                          clean=True)}
    row["retakes"] = cs.RETAKES
    return row


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("turns: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT))
    only = []
    while argv[:1] == ["--only"] and len(argv) > 1:
        only.append(argv[1])
        argv = argv[2:]
    labels = [k for k in CASES if not only or any(t in k for t in only)]
    if argv[:1] == ["--time"]:
        tree = Path(argv[1]).resolve()
        sys.path.insert(0, str(tree / "src"))
        print(json.dumps(time_tree(tree, labels, dev)), flush=True)
        return 0
    if not argv or not labels:
        print(__doc__, file=sys.stderr)
        return 2
    if set(labels) & set(FROM_WORKLOAD):
        make_shapes(dev)
    import chip_smoke as cs
    rows = []
    for tree in argv:
        run = subprocess.run(
            [sys.executable, __file__]
            + [a for t in only for a in ("--only", t)] + ["--time", tree],
            capture_output=True, text=True, check=False,
            env=dict(os.environ, PYTHONPATH=""))
        if run.returncode:
            print(run.stdout, run.stderr, file=sys.stderr)
            return run.returncode
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"card": cs.nvidia_smi(), "turns": rows},
                              indent=1))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
