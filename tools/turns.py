#!/usr/bin/env python3
"""Time kernels of several source trees in turns on one CUDA card, at
their paths' shapes (``CASES``):

* ``batch_seal``: the stepped seal (200,788 words in 2,510 batches) and
  the fused twin's two calls over the run's 4,001,576-word buffer (50,040
  batch roots, and one digest a seal);
* ``shard_seal``: the fused fabric twin's two calls over 8 lanes of the
  same run (some 502,000 words a lane: 50,096 batch roots, and 160 seal
  digests), whichever kernel the tree has (the name fragment
  ``shard_seal`` matches them all);
* the state commitment's full refold, 2,883,584 words (11 x 262,144
  accounts) in chunks of 2,048: ``dirty_fold`` with every chunk selected
  and ``rollup_chunk_digests``;
* Eq. 1 ``weighted_agg`` in float32 at the default FL path's (32, 64,
  2,410) task-axis launch, the stepped path's (64, 2,410) and 1M wide;
* ``flash_attention_bwd`` in bfloat16, causal, at qwen2-0.5b's training
  layer (4, 4,096, 14, 2, 64) and yi-6b's head (1, 4,096, 32, 4, 128),
  on the tree's own forward kernel's output and logsumexp (three kernels
  a call, their device times added);
* ``gmm_bwd`` in bfloat16 at moonshot's two training products, (64, 960,
  2,048, 1,408) and (64, 960, 1,408, 2,048) (a tree's kernels a call:
  one in the wgmma form, two in the WMMA form, their device times added);
* ``slstm_scan_bwd`` in bfloat16 at xlstm-1.3b's training scan, (2,
  4,096, 4 heads of 512), on the saved states of the tree's own forward
  kernel (one kernel a call in either form);
* ``ssm_scan`` at jamba's prefill (4, 4,096, d_inner 16,384, d_state
  16), bfloat16 x, from zeros (chip_smoke.ssm_inputs; a tree before the
  Mamba port has no such case);
* ``ssm_scan_bwd`` at jamba's training scan (2, 4,096, 16,384, 16),
  bfloat16 x and dout, on the saved states of the tree's own forward
  kernel (two kernels a call, their device times added; a tree before the
  gradient kernel has no such case, and its row says so).

    python3 tools/turns.py [--only TEXT ...] TREE [TREE ...]

e.g. ``python3 tools/turns.py build/parent . . build/parent`` with a
``git archive`` of the parent commit unpacked under build/parent;
``--only TEXT`` (repeatable) keeps the cases whose label holds TEXT.  The
seals' inputs come from this checkout: the stepped seal's from
chip_smoke's arithmetic on random words, the fused calls' arguments
captured from the fused twin of the 1M-tx workload (chip_smoke.fused_node)
and the fabric's from its 8-shard fused fabric twin
(chip_smoke.fused_fabric); the others are drawn on the card from a seed a
case.  Each TREE (the root
of a checkout) is then timed in a process of its own, with its own src/
and its own library: CUDA events with L2 flushed before each launch
(chip_smoke.timed_ms) and the kernel's device time from torch.profiler
(chip_smoke.device_ms), with L2 evicted by writing a buffer
(``device_ms``: its dirty lines are written back while the kernel reads)
and by reading it (``clean_device_ms``), each result held to the plain
version (bit for bit, Eq. 1 at float32 rtol 1e-5 / atol 1e-6, the
attention's gradient by ``flash_attention.bwd_close``, the gmm and sLSTM
gradients and the Mamba scan by their modules' kernel tolerances,
``grads_close``).  One JSON
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

BWD_SHAPES = {"(4, 4096, 14, 2, 64)": (4, 4096, 14, 2, 64),
              "(1, 4096, 32, 4, 128)": (1, 4096, 32, 4, 128)}
GMM_BWD_SHAPES = {"(64, 960, 2048, 1408)": (64, 960, 2048, 1408),
                  "(64, 960, 1408, 2048)": (64, 960, 1408, 2048)}
SCAN_BWD_SHAPE = (2, 4096, 4, 512)          # B, S, nh, dh
SSM_SHAPE = (4, 4096, 16384, 16)            # B, S, di, ds
SSM_BWD_SHAPE = (2, 4096, 16384, 16)


def grads_close(mod, got, want) -> bool:
    """Each gradient of ``got`` within its module's kernel tolerance of
    the plain version's (``kernel_bwd_tol``, else ``kernel_tol``)."""
    tol = getattr(mod, "kernel_bwd_tol", None) or mod.kernel_tol
    try:
        for a, b in zip(got, want):
            if a is None and b is None:         # no such gradient
                continue
            torch.testing.assert_close(a.float(), b.float(), **tol(b))
    except AssertionError:
        return False
    return True


def gmm_bwd_kernels(kernel) -> int:
    """Device kernels of one gmm_bwd call at the training shapes: one in
    the wgmma form, a dx and a dw product in the trees before it."""
    return 1 if getattr(kernel, "last_form", None) == "wgmma" else 2


# label -> (module of repro_torch.kernels, wrapper, tolerance against the
# plain version (None: bit for bit; a string: the module's function that
# holds (got, want); a function of (module, got, want)), a name fragment
# of its kernels in a trace: this tree's and those they replaced, the
# launches of them a call (or a function of the wrapper after a call))
CASES = {
    "stepped seal": ("batch_seal", "batch_seal", None, "batch_seal", 1),
    "fused roots": ("batch_seal", "batch_seal", None, "batch_seal", 1),
    "fused seal digests": ("batch_seal", "batch_seal", None, "batch_seal",
                           1),
    "fabric roots": ("shard_lanes", "shard_seal", None, "shard_seal", 1),
    "fabric seal digests": ("shard_lanes", "shard_seal", None, "shard_seal",
                            1),
    "state refold": ("dirty_fold", "dirty_fold", None, "dirty_", 1),
    f"rollup_chunk_digests ({STATE_WORDS}, {CHUNK})": (
        "rollup_digest", "rollup_chunk_digests", None,
        "chunk_digests_kernel", 1),
    **{f"weighted_agg {shape}": ("weighted_agg", "weighted_agg", F32_TOL,
                                 "weighted_agg", 1) for shape in AGG_SHAPES},
    **{f"flash_attention_bwd {shape}": (
        "flash_attention", "flash_attention_bwd", "bwd_close", "attn_bwd_",
        3) for shape in BWD_SHAPES},
    **{f"gmm_bwd {shape}": ("gmm", "gmm_bwd", grads_close, "gmm_bwd_",
                            gmm_bwd_kernels) for shape in GMM_BWD_SHAPES},
    f"slstm_scan_bwd {SCAN_BWD_SHAPE}": (
        "slstm_scan", "slstm_scan_bwd", grads_close, "slstm_bwd_", 1),
    f"ssm_scan {SSM_SHAPE}": ("ssm_scan", "ssm_scan", grads_close,
                              "ssm_scan_kernel", 1),
    f"ssm_scan_bwd {SSM_BWD_SHAPE}": ("ssm_scan", "ssm_scan_bwd",
                                      grads_close, "ssm_bwd_", 2),
}
FROM_WORKLOAD = ("stepped seal", "fused roots", "fused seal digests",
                 "fabric roots", "fabric seal digests")
FROM_FABRIC = ("fabric roots", "fabric seal digests")


def make_shapes(dev, labels) -> None:
    """The seals' inputs, saved to SHAPES (CPU tensors); the fabric's
    captured only where ``labels`` hold one of its cases."""
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
    if set(labels) & set(FROM_FABRIC):
        calls, _ = cs.fused_fabric(dev, wl, cs.nvidia_smi())
        for label, call in zip(FROM_FABRIC, calls):
            shapes[label] = tuple(t.cpu() for t in call)
    SHAPES.parent.mkdir(parents=True, exist_ok=True)
    torch.save(shapes, SHAPES)


def drawn(label: str, dev) -> tuple:
    """The arguments of a case not taken from the workload, drawn on the
    card from the case's own seed (the same in every process)."""
    g = torch.Generator(device=dev).manual_seed(list(CASES).index(label))
    if label.startswith("gmm_bwd"):
        E, C, d, f = GMM_BWD_SHAPES[label.removeprefix("gmm_bwd ")]
        return tuple(torch.randn(s, generator=g, device=dev,
                                 dtype=torch.bfloat16)
                     for s in ((E, C, d), (E, d, f), (E, C, f)))
    if label.startswith("slstm_scan_bwd"):
        from repro_torch.kernels import slstm_scan as ss
        B, S, nh, dh = SCAN_BWD_SHAPE
        d = nh * dh
        wx = (0.5 * torch.randn(B, S + 5, 4 * d, generator=g, device=dev)
              ).bfloat16()
        r = (torch.randn(nh, dh, 4 * dh, generator=g, device=dev)
             * dh ** -0.5).bfloat16()
        state = [torch.zeros(B, d, device=dev) for _ in range(3)] + \
            [torch.full((B, d), -1e30, device=dev)]
        state = list(ss.slstm_scan_torch(wx[:, :5], r, *state)[1])
        wx = wx[:, 5:].contiguous()
        states = torch.empty(B, 3, S, d, device=dev)
        y, _ = ss._launch(wx, r, *state, states=states)
        grads = [torch.randn(s, generator=g, device=dev)
                 for s in ((B, S, d),) + ((B, d),) * 4]
        return (wx, r, *state, y, states, *grads)
    if label.startswith("ssm_scan_bwd"):
        import chip_smoke as cs
        from repro_torch.kernels import ssm_scan as sm
        B, S, di, ds = SSM_BWD_SHAPE
        args = cs.ssm_inputs(B, S, di, ds, torch.bfloat16, False, g, dev)
        _, _, ckpt = sm._launch(*args, ckpt=True)
        dout = torch.randn(B, S, di, generator=g, device=dev).bfloat16()
        return (*args, ckpt, dout, None)
    if label.startswith("ssm_scan"):
        import chip_smoke as cs
        B, S, di, ds = SSM_SHAPE
        return cs.ssm_inputs(B, S, di, ds, torch.bfloat16, False, g, dev)
    if label.startswith("flash_attention_bwd"):
        from repro_torch.kernels import flash_attention as fa
        B, S, H, Hkv, dh = BWD_SHAPES[label.removeprefix(
            "flash_attention_bwd ")]
        q, k, v, do = (torch.randn(B, S, n, dh, generator=g, device=dev,
                                   dtype=torch.bfloat16)
                       for n in (H, Hkv, Hkv, H))
        o, lse = fa._launch(q, k, v, True, lse=True)
        return q, k, v, o, lse, do, True
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
        module, op, tol, fragment, per_call = CASES[label]
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        if not hasattr(mod, op):             # a tree before this kernel
            row[label] = None
            continue
        kernel, plain = getattr(mod, op), getattr(mod, f"{op}_torch")
        args = (tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                      for a in captured[label])
                if label in FROM_WORKLOAD else drawn(label, dev))
        got, want = kernel(*args), plain(*args)
        if callable(tol):
            if not tol(mod, got, want):
                raise AssertionError(f"{tree}: {label} is not within the "
                                     f"kernel tolerance of plain")
        elif isinstance(tol, str):
            if not getattr(mod, tol)(got, want):
                raise AssertionError(f"{tree}: {label} is not {tol} plain")
        elif tol:
            torch.testing.assert_close(got, want, **tol)
        elif not torch.equal(got, want):
            raise AssertionError(f"{tree}: {label} differs from plain")
        del got, want
        if callable(per_call):
            per_call = per_call(kernel)
        # the gradients take milliseconds a call: fewer launches
        n = 5 if label.startswith(("gmm_bwd", "slstm_scan_bwd",
                                   "ssm_scan_bwd")) else 50
        row[label] = {"ms": cs.timed_ms(lambda: kernel(*args), n, flush),
                      "device_ms": cs.device_ms(lambda: kernel(*args),
                                                fragment, min(n, 20), flush,
                                                per_call=per_call),
                      "clean_device_ms": cs.device_ms(
                          lambda: kernel(*args), fragment, min(n, 20), flush,
                          clean=True, per_call=per_call)}
        if label.startswith(("flash_attention_bwd", "gmm_bwd",
                             "slstm_scan_bwd")):
            row[label]["form"] = getattr(kernel, "last_form", None)
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
        make_shapes(dev, labels)
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
