#!/usr/bin/env python3
"""Where the time of the two backward kernels goes: each timed whole and
in trial builds that leave one part out, at the training shapes.

``gmm`` (``csrc/moe_bwd.cu``, the wgmma form, at moonshot's two training
products, (64, 960, 2,048, 1,408) and (64, 960, 1,408, 2,048)):

    dx_only      dw's tiles dropped (dx's products alone)
    dw_only      dx's tiles dropped
    no_store     the TMA stores of the staged tiles (the products and the
                 staging still run)
    no_epilogue  the staging and the stores

``slstm`` (``csrc/slstm_bwd.cu``, the cluster form, at xlstm-1.3b's
training scan, (2, 4,096, 2,048, 4 heads)):

    no_gates     the gates' mma.sync products and their transposes (the
                 lent tiles' ldmatrix loads stay)
    no_transpose the transposes alone (the product reads r_slice's tiles
                 as they are)
    no_chain     the chain's product, dgates_t . r_slice
    no_exchange  the bulk copies of the shares and the waits for them
    no_cell      the cell back's arithmetic (dgates = dh)
    no_refill    the inputs' copies after the first steps (and the waits
                 for them)
    no_store     the writes of dgates
    skeleton     no_gates, no_chain, no_exchange and no_cell at once (what
                 is left: the input copies, the sums, the stores, the
                 block's barriers)
    skeleton_min the skeleton without the cell's first terms, the sums
                 of the exchange's slabs and of the gates' shares, the
                 dgates writes and the inputs' copies: the barriers and
                 the loop
    lend2, lend4 (compute the gradient) warps 0-3 lend 2 or all 4 of
                 their m-tiles of the gates' product to warps 4-7 (3 in
                 the tree)

The trial builds but lend2 and lend4 compute wrong results and serve for
timing only.  They are made at run time from the sources by text edits,
each compiled alone with nvcc into ``build/bwd_split/``; nothing of them
is kept in the source.  Each build is timed with CUDA events, L2 flushed
before every launch, in turns (whole, trials, trials reversed, whole).

    python3 tools/bwd_split.py [gmm|slstm ...]   # default: both

Prints one JSON line a kernel and shape (with the card's name and power
limit) and writes them to ``chiprun_out/bwd_split.json``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GMM_SHAPES = [(64, 960, 2048, 1408), (64, 960, 1408, 2048)]
SLSTM_SHAPE = dict(B=2, S=4096, nh=4, dh=512)
ITERS = {"gmm": 10, "slstm": 3}

GMM_STORE = ("        hopper::tma_store_3d(map, ep + b * kWBox, w.n0 + 64 * b,"
             " m0, w.e);\n")
GMM_STAGE = """      *reinterpret_cast<__nv_bfloat162*>(
          ep + (j / 8) * kWBox + row * 128 + (((cb / 8) ^ (row % 8)) << 4)
          + (cb % 8) * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
"""
PDX = "  const WgProduct pdx = wg_product(E, C, d, f, f, nullptr);\n"
PDW = "  const WgProduct pdw = wg_product(E, d, f, C, chunk, part);\n"
# (texts are matched whatever their indentation: see edit)
SLSTM_GATES_MMA = """hopper::movmatrix_trans(ra[j][ks][3])};
hopper::mma_bf16_16816(acc[ks], at, b0, b1);
"""
SLSTM_GATES_NO_MMA = "hopper::movmatrix_trans(ra[j][ks][3])};\n"
SLSTM_LENT_MMA = """m >> 1));
hopper::mma_bf16_16816(acc[ks], at, b0, b1);
"""
SLSTM_LENT_NO_MMA = "m >> 1));\n"
SLSTM_NO_GATES = [(SLSTM_GATES_MMA, SLSTM_GATES_NO_MMA),
                  (SLSTM_LENT_MMA, SLSTM_LENT_NO_MMA)]
SLSTM_MOVM = """const uint32_t at[4] = {hopper::movmatrix_trans(ra[j][ks][0]),
hopper::movmatrix_trans(ra[j][ks][2]),
hopper::movmatrix_trans(ra[j][ks][1]),
hopper::movmatrix_trans(ra[j][ks][3])};
"""
SLSTM_NO_MOVM = """const uint32_t at[4] = {ra[j][ks][0], ra[j][ks][2], ra[j][ks][1],
                        ra[j][ks][3]};
"""
SLSTM_FETCH = ("      if (fetcher && t < S && t >= kBSlots - 1) "
               "fetch(t - (kBSlots - 1));\n")
SLSTM_SLOT_WAIT = ("    hopper::mbar_wait(&ibar[tp % kBSlots], ((S - 1 - tp) / "
                   "kBSlots) & 1);\n")
SLSTM_STORE = [
    ("    if (fetcher && t + 1 < S) store_dgates(t + 1);\n", ""),
    ("  if (fetcher) store_dgates(0);\n", "")]
SLSTM_CHAIN_MMA = \
    "              hopper::mma_bf16_16816(acc[j], ra[j][ks], b0, b1);\n"
SLSTM_ISSUERS = \
    "      if (warp < 2 && lane < half && warp * half + lane < cs) {"
SLSTM_NO_EXCHANGE = [
    (SLSTM_ISSUERS, "      if (false) {"),
    ("        hopper::mbar_wait(&rbar[b], ((S - 2 - t) >> 1) & 1);\n", ""),
    ("""        if (tid == 0 && t >= 1) {
          hopper::mbar_expect_tx(&rbar[b], cs * kBSlab * 4);
        }
""", ""),
    ("    hopper::mbar_wait(&rbar[0], ((S - 1) >> 1) & 1);\n", "")]
SLSTM_CELL = """        const float dff = dt1 * (ff < 0.f ? 1.f - sf : sf);
        const float dg[4] = {dzi, dii, dff, doo};
"""
SLSTM_NO_CELL = """        const float dff = dt1 * (ff < 0.f ? 1.f - sf : sf);
        const float dg[4] = {dh_t, dh_t, dh_t, dh_t};
"""
SLSTM_CELL_BODY = """        const float ez = __expf(-fabsf(ff));
        const float t1 = fminf(ff, 0.f) - __logf(1.f + ez) + m_p;
"""
SLSTM_NO_CELL_BODY = """        const float ez = ff;
        const float t1 = m_p + ii;
"""
SLSTM_P1_SUM = """        float rec = 0.f;
        for (int src = 0; src < cs; ++src) rec += rv[src * kBSlab];
        dh_t += rec;
"""
SLSTM_GATES_SUM = """          for (int w = 0; w < min(8, nmt); ++w) {
            sum += pp[w * kBRows * kBPartStride];
          }
"""
SKELETON = [*SLSTM_NO_GATES, (SLSTM_MOVM, SLSTM_NO_MOVM),
            (SLSTM_CHAIN_MMA, ""), *SLSTM_NO_EXCHANGE,
            (SLSTM_CELL, SLSTM_NO_CELL)]
# {kernel: (source, {variant: [(text, its replacement)]})}
VARIANTS = {
    "gmm": ("moe_bwd.cu", {
        "whole": [],
        "dx_only": [(PDW, PDW.replace("const ", "") + "  pdw.tiles = 0;\n")],
        "dw_only": [(PDX, PDX.replace("const ", "") + "  pdx.tiles = 0;\n")],
        "no_store": [(GMM_STORE, "")],
        "no_epilogue": [(GMM_STORE, ""), (GMM_STAGE, "")],
    }),
    "slstm": ("slstm_bwd.cu", {
        "whole": [],
        "no_gates": SLSTM_NO_GATES + [(SLSTM_MOVM, SLSTM_NO_MOVM)],
        "lend2": [("constexpr int kBLent = 3;", "constexpr int kBLent = 2;")],
        "lend4": [("constexpr int kBLent = 3;", "constexpr int kBLent = 4;")],
        "no_transpose": [(SLSTM_MOVM, SLSTM_NO_MOVM)],
        "no_chain": [(SLSTM_CHAIN_MMA, "")],
        "no_exchange": SLSTM_NO_EXCHANGE,
        "no_cell": [(SLSTM_CELL, SLSTM_NO_CELL)],
        "no_refill": [(SLSTM_FETCH, ""), (SLSTM_SLOT_WAIT, "")],
        "no_store": SLSTM_STORE,
        "skeleton": SKELETON,
        "skeleton_min": SKELETON + [(SLSTM_P1_SUM, ""),
                                    (SLSTM_GATES_SUM, ""),
                                    (SLSTM_CELL_BODY, SLSTM_NO_CELL_BODY),
                                    *SLSTM_STORE, (SLSTM_FETCH, ""),
                                    (SLSTM_SLOT_WAIT, "")],
    }),
}
# the builds that compute the gradient: held to the plain version
CORRECT = {"whole", "lend2", "lend4"}
LAUNCHER = {"gmm": "moe_gmm_bwd", "slstm": "slstm_scan_bwd"}
# the kernel of each whose ptxas lines are kept
ENTRY = {"gmm": "gmm_bwd_wgmma_kernel", "slstm": "slstm_bwd_cluster_kernel"}


def edit(src: str, old: str, new: str) -> str:
    """``src`` with ``old`` (one occurrence, matched line by line whatever
    its indentation) replaced by ``new``, shifted as ``old`` was."""
    olines = old.rstrip("\n").split("\n")
    pattern = "\n".join(("([ \t]*)" if i == 0 else "[ \t]*")
                        + re.escape(ln.lstrip()) for i, ln in enumerate(olines))
    found = list(re.finditer(pattern, src))
    if len(found) != 1:
        raise RuntimeError(f"the edit's text occurs {len(found)} times: "
                           f"{olines[0]!r}")
    start, end = found[0].span()
    shift = len(found[0].group(1)) - (len(olines[0])
                                      - len(olines[0].lstrip()))
    if not new.strip():                 # drop the lines
        return src[:start] + src[end + (src[end:end + 1] == "\n"):]
    lines = [ln if not ln.strip() else
             " " * shift + ln if shift >= 0 else ln[min(-shift, len(ln)
                                                      - len(ln.lstrip())):]
             for ln in new.rstrip("\n").split("\n")]
    return src[:start] + "\n".join(lines) + src[end:]


def build(out_dir: Path, kernels) -> dict:
    """Compile every variant of ``kernels`` at once; returns {(kernel,
    variant): (loaded library, ptxas's lines)}."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for kernel in kernels:
        source, variants = VARIANTS[kernel]
        text = (_build.CSRC / source).read_text()
        for name, edits in variants.items():
            src = text
            for old, new in edits:
                src = edit(src, old, new)
            sources[kernel, name] = src
    procs = {}
    for (kernel, name), src in sources.items():
        path = out_dir / f"{kernel}_{name}.cu"
        path.write_text(src)
        procs[kernel, name] = subprocess.Popen(
            [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v",
             "-shared", "-I", str(_build.CSRC), "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            for other in procs.values():
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{key[0]}_{key[1]}.so"))
        fn = getattr(lib, LAUNCHER[key[0]])
        fn.argtypes = list(_build._SIGNATURES[LAUNCHER[key[0]]])
        fn.restype = ctypes.c_int
        usage, ours = [], False
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                ours = ENTRY[key[0]] in ln
            elif ours and ("registers" in ln or "spill" in ln
                           or "C7519" in ln):
                usage.append(ln.strip())
        libs[key] = (fn, usage)
    return libs


def gmm_case(dev, shape, seed):
    """The launch of each build at ``shape`` and a check of its result."""
    from repro_torch.kernels import gmm as gm
    E, C, d, f = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    xe, w, dy = (torch.randn(s, generator=g, device=dev).bfloat16()
                 for s in ((E, C, d), (E, d, f), (E, C, f)))
    dx, dw = torch.empty_like(xe), torch.empty_like(w)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        rc = fn(dev.index or 0, xe.data_ptr(), w.data_ptr(), dy.data_ptr(),
                E, C, d, f, 1, gm.BWD_FORMS["wgmma"], C, None, dx.data_ptr(),
                dw.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"moe_gmm_bwd failed ({rc})")

    want = gm.gmm_bwd_torch(xe, w, dy)

    def check(name):
        for a, b in zip((dx, dw), want):
            torch.testing.assert_close(
                a.float(), b.float(), **gm.kernel_tol(b),
                msg=lambda m: f"gmm {name} at {shape}: {m}")
        return max(float((a.float() - b.float()).abs().max())
                   for a, b in zip((dx, dw), want))
    return run, check


def slstm_case(dev, seed):
    from repro_torch.kernels import slstm_scan as ss
    B, S, nh, dh = SLSTM_SHAPE.values()
    d = nh * dh
    g = torch.Generator(device=dev).manual_seed(seed)
    wx = (0.5 * torch.randn(B, S + 5, 4 * d, device=dev, generator=g)) \
        .bfloat16()
    r = (torch.randn(nh, dh, 4 * dh, device=dev, generator=g)
         * dh ** -0.5).bfloat16()
    state = [torch.zeros(B, d, device=dev) for _ in range(3)] + \
        [torch.full((B, d), -1e30, device=dev)]
    state = list(ss.slstm_scan_torch(wx[:, :5], r, *state)[1])
    wx = wx[:, 5:].contiguous()
    states = torch.empty(B, 3, S, d, device=dev)
    y, _ = ss._launch(wx, r, *state, states=states)
    grads = [torch.randn(s, generator=g, device=dev)
             for s in ((B, S, d),) + ((B, d),) * 4]
    dgates = torch.empty(B, S, 4 * d, device=dev)
    outs = [torch.empty(B, d, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        rc = fn(dev.index or 0, wx.data_ptr(), r.data_ptr(),
                *(t.data_ptr() for t in (*state, y, states, *grads)),
                B, S, nh, dh, 0, 1, ss.BWD_FORMS["cluster"], None,
                dgates.data_ptr(), *(t.data_ptr() for t in outs), stream)
        if rc:
            raise RuntimeError(f"slstm_scan_bwd failed ({rc})")

    args = (wx, r, *state, y, states, *grads)
    want = ss.slstm_scan_bwd_torch(*args)

    def check(name):
        got = (dgates.to(wx.dtype),
               ss.dr_gates(state[0], y, dgates, nh).to(r.dtype), *outs)
        for a, b in zip(got, want):
            torch.testing.assert_close(
                a, b, **ss.kernel_bwd_tol(b),
                msg=lambda m: f"slstm {name}: {m}")
        return max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(got, want))
    return run, check


def time_builds(kernel, label, libs, run, check, flush) -> dict:
    names = list(VARIANTS[kernel][1])
    err = {}
    for name in names:                  # warm up; the error of the correct
        run(libs[kernel, name][0])
        torch.cuda.synchronize()
        if name in CORRECT:
            err[name] = check(name)
    ms = {name: [] for name in names}
    for name in names + names[::-1]:
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(ITERS[kernel])]
        for start, end in events:
            flush.zero_()
            start.record()
            run(libs[kernel, name][0])
            end.record()
        torch.cuda.synchronize()
        ms[name] += [s.elapsed_time(e) for s, e in events]
    mean = {name: sum(v) / len(v) for name, v in ms.items()}
    return {"kernel": kernel, "shape": label, "ms": mean,
            "saved_ms": {k: mean["whole"] - v for k, v in mean.items()
                         if k != "whole"},
            "max_abs_err": err, "runs": ms,
            "ptxas": {name: libs[kernel, name][1] for name in names}}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bwd_split: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi
    kernels = argv or list(VARIANTS)
    dev = torch.device("cuda")
    libs = build(ROOT / "build" / "bwd_split", kernels)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    card = nvidia_smi()
    lines = []
    cases = []
    if "gmm" in kernels:
        cases += [("gmm", list(shape), *gmm_case(dev, shape, i))
                  for i, shape in enumerate(GMM_SHAPES)]
    if "slstm" in kernels:
        cases.append(("slstm", list(SLSTM_SHAPE.values()),
                      *slstm_case(dev, 7)))
    for kernel, label, run, check in cases:
        row = time_builds(kernel, label, libs, run, check, flush)
        if kernel == "slstm":
            row["us_per_step"] = {k: v * 1e3 / SLSTM_SHAPE["S"]
                                  for k, v in row["ms"].items()}
        row["card"] = card
        line = json.dumps(row)
        print(line, flush=True)
        lines.append(line)
    out = ROOT / "chiprun_out" / "bwd_split.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
