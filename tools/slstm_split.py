#!/usr/bin/env python3
"""Where a step of ``slstm_scan`` goes: time each form of the kernel
(``csrc/slstm.cu``) at xlstm-1.3b's prefill scan, (8, 4,096, 2,048, 4
heads) in bfloat16, whole and in trial builds that each leave one part of
the step out.  The grid form (``slstm_scan_kernel``: one cooperative
launch, a grid barrier a step):

    no_dot       the dot-product loop (the recurrent sums stay 0)
    no_sync      the grid barrier (grid.sync())
    no_hbuf      the reads of h from device memory (h made from its index)
    skeleton     all three (what is left: wx, the cell update, y, the
                 block's own barriers)

The cluster form (``slstm_cluster_kernel``: a cluster a head, the product
on tensor cores, h by bulk copies into the peers' shared memory):

    no_product   the mma.sync products (and so the B-fragment loads)
    no_exchange  the bulk copies of h and the waits for them
    no_cell      the cell update's arithmetic (h = the gates' sum)
    skeleton     all three

and, computing the scan too, its alternatives: three bfloat16 pieces of h
in place of two, the precise expf / log1pf / tanhf cell in place of the
hardware's exp2 / lg2, both, and the copies of a step started by one
warp or by four in place of two; for these and the whole form the
largest |y - plain| over the scan is reported.

The trial builds compute wrong results and serve for timing only.  They
are made at run time from ``csrc/slstm.cu`` by text edits, each compiled
alone with nvcc into ``build/slstm_split/``; nothing of them is kept in
the source.  Each build is timed with CUDA events, L2 flushed before every
launch, in turns (whole, trials, trials reversed, whole).

    python3 tools/slstm_split.py [grid|cluster ...]   # default: both

Prints one JSON line a form and writes them to
``build/slstm_split/split.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPE = dict(B=8, S=4096, nh=4, dh=512)
ITERS = 3
# {form: {variant: [(text of csrc/slstm.cu, its replacement)]}}
DOT = """    for (int i = i0; i < i1; ++i) {
      const float rv = rs[i * J + j];
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) acc[b] = fmaf(hs[b * dh + i], rv, acc[b]);
      }
    }
"""
SYNC = "    grid.sync();\n"
HBUF = ("hs[idx] = __ldcg(hin + static_cast<int64_t>(b) * d + head * dh "
        "+ i);")
NO_HBUF = "hs[idx] = 1e-3f * static_cast<float>(i - b);"
MMA = """\
              hopper::mma_bf16_16816(acc[g][nt], a[g][j], b[p][nt].x,
                                     b[p][nt].y);
"""
HALF = "  const int half = (cs + 1) / 2;"
ISSUERS = "      if (warp < 2 && lane < half && warp * half + lane < cs) {"
EXCHANGE = [(ISSUERS, "      if (false) {"),
            ("""          hopper::mbar_wait(bar, ((t - 1) >> 1) & 1);
          if (mg == 0 && lane == 0 && t + 2 < S) {
            hopper::mbar_expect_tx(bar, kSlab * 2);
          }
""", "")]
CELL = """\
      const float logf = fminf(ff, 0.f) - __logf(1.f + __expf(-fabsf(ff)));
      const float m_new = fmaxf(logf + m[nt], ii);
      const float fw = __expf(logf + m[nt] - m_new);
      const float iw = __expf(ii - m_new);
      c[nt] = fw * c[nt] + iw * (1.f - 2.f / (__expf(2.f * zi) + 1.f));
      nn[nt] = fw * nn[nt] + iw;
      h[nt] = __fdividef(c[nt], (1.f + __expf(-oo)) * fmaxf(nn[nt], 1e-6f));
      m[nt] = m_new;
"""
NO_CELL = "      h[nt] = zi + ii + ff + oo;\n"
PRECISE_CELL = """\
      const float logf = fminf(ff, 0.f) - log1pf(expf(-fabsf(ff)));
      const float m_new = fmaxf(logf + m[nt], ii);
      const float fw = expf(logf + m[nt] - m_new);
      const float iw = expf(ii - m_new);
      c[nt] = fw * c[nt] + iw * tanhf(zi);
      nn[nt] = fw * nn[nt] + iw;
      h[nt] = 1.f / (1.f + expf(-oo)) * c[nt] / fmaxf(nn[nt], 1e-6f);
      m[nt] = m_new;
"""
TWO = "constexpr int kPieces = 2;"
THREE = "constexpr int kPieces = 3;"
ONE_WARP = [(HALF, "  const int half = cs;")]
FOUR_WARPS = [(HALF, "  const int half = (cs + 3) / 4;"),
              (ISSUERS, ISSUERS.replace("warp < 2", "warp < 4"))]
VARIANTS = {
    "grid": {
        "whole": [],
        "no_dot": [(DOT, "")],
        "no_sync": [(SYNC, "")],
        "no_hbuf": [(HBUF, NO_HBUF)],
        "skeleton": [(DOT, ""), (SYNC, ""), (HBUF, NO_HBUF)],
    },
    "cluster": {
        "whole": [],
        "no_product": [(MMA, "")],
        "no_exchange": EXCHANGE,
        "no_cell": [(CELL, NO_CELL)],
        "skeleton": [(MMA, ""), *EXCHANGE, (CELL, NO_CELL)],
        # alternatives that compute the scan too (their error is reported)
        "three_pieces": [(TWO, THREE)],
        "precise_cell": [(CELL, PRECISE_CELL)],
        "three_pieces_precise_cell": [(TWO, THREE), (CELL, PRECISE_CELL)],
        "one_warp_starts_copies": ONE_WARP,
        "four_warps_start_copies": FOUR_WARPS,
    },
}
# the builds that compute the scan: their largest |y - plain| over the
# whole scan is reported
CORRECT = {"whole", "three_pieces", "precise_cell",
           "three_pieces_precise_cell", "one_warp_starts_copies",
           "four_warps_start_copies"}


def build(out_dir: Path, forms) -> dict:
    """Compile every variant of ``forms`` at once; returns {(form,
    variant): loaded library}."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "slstm.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for form in forms:
        for name, edits in VARIANTS[form].items():
            src = text
            for old, new in edits:
                if src.count(old) != 1:
                    raise RuntimeError(f"{form} {name}: the edit's text "
                                       f"occurs {src.count(old)} times in "
                                       f"slstm.cu")
                src = src.replace(old, new)
            path = out_dir / f"{form}_{name}.cu"
            path.write_text(src)
            procs[form, name] = subprocess.Popen(
                [_build.nvcc_path(), "-gencode",
                 "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                 "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I",
                 str(_build.CSRC), "-o", str(path.with_suffix(".so")),
                 str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{key[0]}_{key[1]}.so"))
        lib.slstm_scan.argtypes = list(_build._SIGNATURES["slstm_scan"])
        lib.slstm_scan.restype = ctypes.c_int
        libs[key] = lib
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("slstm_split: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi
    from repro_torch.kernels import slstm_scan as ss
    forms = argv or list(VARIANTS)
    dev = torch.device("cuda")
    libs = build(ROOT / "build" / "slstm_split", forms)
    B, S, nh, dh = SHAPE.values()
    d = nh * dh
    g = torch.Generator(device=dev).manual_seed(5)
    wx = (0.5 * torch.randn(B, S, 4 * d, device=dev, generator=g)).bfloat16()
    r = (torch.randn(nh, dh, 4 * dh, device=dev, generator=g)
         * dh ** -0.5).bfloat16()
    zeros = torch.zeros(B, d, device=dev)
    m0 = torch.full((B, d), -1e30, device=dev)
    hbuf = torch.zeros(2, B, d, device=dev)
    y = torch.empty(B, S, d, device=dev)
    out = [torch.empty(B, d, device=dev) for _ in range(4)]
    U, _ = ss.plan(B, dh)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(form: str, name: str) -> None:
        hbuf[0].zero_()                 # h0: the cluster form reads it too
        rc = libs[form, name].slstm_scan(
            dev.index or 0, wx.data_ptr(), r.data_ptr(), hbuf.data_ptr(),
            zeros.data_ptr(), zeros.data_ptr(), m0.data_ptr(), B, S, nh, dh,
            U, 1, ss.FORMS[form], y.data_ptr(),
            *(t.data_ptr() for t in out), stream)
        if rc:
            raise RuntimeError(f"{form} {name}: launch failed ({rc})")

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    want_y, _ = ss.slstm_scan_torch(wx, r, zeros, zeros, zeros, m0)
    lines = []
    for form in forms:
        names = list(VARIANTS[form])
        err = {}
        for name in names:              # warm up; the error of each scan
            run(form, name)
            if name in CORRECT:
                err[name] = float((y - want_y).abs().max())
        if err["whole"] > 1e-4:
            raise AssertionError(f"the {form} form sits {err['whole']} "
                                 f"from the plain version")
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(ITERS)]
            for start, end in events:
                flush.zero_()
                start.record()
                run(form, name)
                end.record()
            torch.cuda.synchronize()
            ms[name] += [s.elapsed_time(e) for s, e in events]
        mean = {name: sum(v) / len(v) for name, v in ms.items()}
        line = json.dumps({
            "form": form, "shape": list(SHAPE.values()),
            "card": nvidia_smi(), "ms": mean, "max_abs_err_y": err,
            "us_per_step": {k: v * 1e3 / S for k, v in mean.items()},
            "saved_us_per_step": {k: (mean["whole"] - v) * 1e3 / S
                                  for k, v in mean.items() if k != "whole"},
            "runs": ms})
        print(line, flush=True)
        lines.append(line)
    (ROOT / "build" / "slstm_split" / "split.json").write_text(
        "\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
