#!/usr/bin/env python3
"""Time ``batch_seal`` and ``dirty_fold`` of several source trees in turns
on one CUDA card, at the node path's shapes: the stepped seal (200,788
words in 2,510 batches), the fused twin's two calls over the run's
4,001,576-word buffer (50,040 batch roots, and one digest a seal) and the
state refold (1,408 chunks of 2,048 words).

    python3 tools/fold_turns.py TREE [TREE ...]

e.g. ``python3 tools/fold_turns.py build/parent . . build/parent`` with a
``git archive`` of the parent commit unpacked under build/parent.  The
inputs come from this checkout: the stepped seal's from chip_smoke's
arithmetic on random words, the fused calls' arguments captured from the
fused twin of the 1M-tx workload (chip_smoke.fused_node).  Each TREE (the
root of a checkout) is then timed in a process of its own, with its own
src/ and its own library: CUDA events with L2 flushed before each launch
(chip_smoke.timed_ms) and the kernel's device time from torch.profiler
(chip_smoke.device_ms), each result held bit-equal to the plain version.
One JSON line a tree, in the order given; all of them, with the card's
name and power limit, in chiprun_out/fold_turns.json.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ROOT / "build" / "fold_turns" / "shapes.pt"
OUT = ROOT / "chiprun_out" / "fold_turns.json"


def make_shapes(dev) -> None:
    """The four inputs, saved to SHAPES (CPU tensors)."""
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core.workloads import make_workload
    wl = make_workload("mixed", device=dev, **cs.FULL)
    times = wl.txs.submit_time.cpu().numpy()
    lo, hi = np.searchsorted(times, [cs.FULL["duration"] - 1,
                                     cs.FULL["duration"]])
    spec = cs.node_spec()
    g = np.random.default_rng(0)

    def words(n):
        w = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32))

    _, seals, _, _ = cs.fused_node(dev, wl, cs.nvidia_smi())
    n_state = 11 * (int(wl.txs.sender_id.max()) + 1)
    shapes = {
        "stepped seal": (words(4 * int(hi - lo)), torch.from_numpy(
            cs.seal_starts(int(hi - lo), spec.rollup.n_lanes,
                           spec.rollup.batch_size))),
        "fused roots": tuple(t.cpu() for t in seals[0]),
        "fused seal digests": tuple(t.cpu() for t in seals[1]),
        "state refold": (words(n_state),
                         torch.arange(-(-n_state // 2048)), 2048)}
    SHAPES.parent.mkdir(parents=True, exist_ok=True)
    torch.save(shapes, SHAPES)


def time_tree(tree: Path, dev) -> dict:
    """This process's ``repro_torch`` is ``tree``'s: its kernels at every
    shape, bit-equal to its plain versions, timed two ways."""
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_seal as bs
    from repro_torch.kernels import dirty_fold as df
    built = _build.build(force=True)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    row = {"tree": str(tree), "build_s": built.seconds}
    for label, args in torch.load(SHAPES).items():
        args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                     for a in args)
        # name fragments that match this tree's kernels and those they
        # replaced (dirty_chunks_kernel, batch_seal_kernel)
        if label == "state refold":
            kernel, plain, name = df.dirty_fold, df.dirty_fold_torch, "dirty_"
        else:
            kernel, plain, name = bs.batch_seal, bs.batch_seal_torch, \
                "batch_seal"
        if not torch.equal(kernel(*args), plain(*args)):
            raise AssertionError(f"{tree}: {label} differs from plain")
        row[label] = {"ms": cs.timed_ms(lambda: kernel(*args), 50, flush),
                      "device_ms": cs.device_ms(lambda: kernel(*args), name,
                                                20, flush)}
    return row


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("fold_turns: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--time"]:
        tree = Path(argv[1]).resolve()
        sys.path.insert(0, str(tree / "src"))
        print(json.dumps(time_tree(tree, dev)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    make_shapes(dev)
    import chip_smoke as cs
    rows = []
    for tree in argv:
        run = subprocess.run([sys.executable, __file__, "--time", tree],
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
