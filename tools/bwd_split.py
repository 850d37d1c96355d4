#!/usr/bin/env python3
"""Where the time of the hand-written backward kernels and the Mamba scan
goes: each timed whole, in trial builds that leave one part out, and in
variants that compute the same result another way, at the training (or
prefill) shapes.

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

``ssm`` (``csrc/ssm.cu``, the selective scan, at jamba's prefill (4,
4,096, 16,384, 16) in bfloat16 from zeros): the layouts the kernel was
chosen from (threads a channel, channels a block, blocks an SM, steps a
tile), other forms of the step (y as a tree or two chains, the softplus
by ``log1pf`` or a lower-degree polynomial, the next step's decays first)
and a share of the decays on the FMA pipes by range reduction and a
polynomial (``EX2_FMA``); and trials named ``trial_*``.  ``ssm_bwd``
(``csrc/ssm_bwd.cu``, its gradient, at jamba's training scan (2, 4,096,
16,384, 16), on the saved states of this tree's forward kernel): blocks
of 1 and 4 warps beside the 2 of the source, and trials that leave out
one part (the recomputed states' decays, the step back's decays or the
whole step back, dB's and dC's terms, the shuffles of u and the A q sum,
the owner's outputs, the conversion's exponentials, the step loops'
shared-memory loads, the sums after the chunk, the copies after the first
chunk) or halve the blocks an SM.  The two kernels' builds take ``ssm.cuh``
inlined, so that an edit may change it too; besides the events, they are
timed by the profiler's device time (``chip_smoke.device_ms``), and their
rows carry the bound (``ssm_scan.bound_ms`` / ``bwd_bound_ms``; for
``ssm``, ``ssm_bound_both_pipes`` too).

The trial builds compute wrong results and serve for timing only; every
other build is held to the plain version within the kernel's tolerance.
They are made at run time from the sources by text edits, each compiled
alone with nvcc into ``build/bwd_split/``; nothing of them is kept in the
source.  Each build is timed with CUDA events, L2 flushed before every
launch, in turns (whole, the others, the others reversed, whole).

    python3 tools/bwd_split.py [gmm|slstm|ssm|ssm_bwd ...]   # default: all

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
SSM_SHAPE = (4, 4096, 16384, 16)        # jamba's prefill
SSM_BWD_SHAPE = (2, 4096, 16384, 16)    # jamba's training scan
ITERS = {"gmm": 10, "slstm": 3, "ssm": 10, "ssm_bwd": 5}
# FMA-pipe operations of EX2_FMA's exponential (its eight floating ones)
EX2_FMA_OPS = 8

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
# the Mamba scan (ssm.cu with ssm.cuh inlined)
SSM_STEP_LOOP = """for (int n = 0; n < kDs; ++n) {
const float decay = ex2(dt * a[n]);
h[n] = fmaf(decay, h[n], dtx * brow[n]);
y = fmaf(h[n], crow[n], y);
}"""
SSM_DECAY = "const float decay = ex2(dt * a[n]);"
SSM_WHOLE_TILE = """#pragma unroll
for (int k = 0; k < kTile; ++k) {
const float v = cur.dt[k][chl] + bias;
step(k, softplus_of(v, exp_neg_abs(v)));
}"""
SSM_POLY8 = """float q = 0.0051859976f;
q = fmaf(q, e, -0.029210234f);
q = fmaf(q, e, 0.07754031f);
q = fmaf(q, e, -0.13583934f);
q = fmaf(q, e, 0.1905595f);
q = fmaf(q, e, -0.24825647f);
q = fmaf(q, e, 0.3331601f);
q = fmaf(q, e, -0.49999255f);
q = fmaf(q, e, 0.99999994f);"""
SSM_SOFTPLUS_RETURN = "return fmaf(e, q, fmaxf(v, 0.f));"
# 2^x for x <= 0 on the FMA pipes: x = i + f, i by the 1.5 2^23 rounding
# trick, f in [-0.5, 0.5]; 2^f by a degree-5 polynomial (least squares on
# Chebyshev nodes, within 2.2e-7 relative in float32, ex2.approx's 2 ulp);
# 2^i added to its exponent bits; x below -125 taken as -125 (a decay under
# 2^-125, where ex2.approx.ftz flushes under 2^-126).  Eight floating
# operations on the FMA pipes, a shift and an integer add.
EX2_FMA = """using namespace ssm;

__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -125.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = 0.0013266970636f;
  p = fmaf(p, f, 0.0096754599362f);
  p = fmaf(p, f, 0.0555074252188f);
  p = fmaf(p, f, 0.2402212172747f);
  p = fmaf(p, f, 0.6931469440460f);
  p = fmaf(p, f, 1.0000001192093f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
"""


def ssm_fma_decays(which: str) -> list:
    """The decays of the states n where ``which`` holds (a C expression
    of the unrolled n) on the FMA pipes, the others on the SFU."""
    return [("using namespace ssm;", EX2_FMA),
            (SSM_DECAY, f"const float decay = ({which}) ? "
                        f"ex2_fma(dt * a[n]) : ex2(dt * a[n]);")]


def ssm_layout(threads=None, min_blocks=None, tile=None) -> list:
    """Another block (threads, a channel each), launch bound or tile."""
    return ([("constexpr int kThreads = 64;",
              f"constexpr int kThreads = {threads};")] if threads else []) + \
        ([("constexpr int kMinBlocks = 8;",
           f"constexpr int kMinBlocks = {min_blocks};")]
         if min_blocks else []) + \
        ([("constexpr int kTile = 16;", f"constexpr int kTile = {tile};")]
         if tile else [])


def ssm_lanes(lanes: int, min_blocks: int) -> list:
    """A channel's states split over ``lanes`` threads of one warp, each
    with kDs / lanes of them; y joined by shuffles; lane p of a channel
    takes the softplus of the tile's steps i lanes + p and shuffles them
    to the others."""
    own = "(kDs / kLanes)"
    return ssm_layout(min_blocks=min_blocks) + [
        ("constexpr int kChannels = kThreads;",
         f"constexpr int kLanes = {lanes};\n"
         "constexpr int kChannels = kThreads / kLanes;"),
        ("const int chl = tid;",
         "const int chl = tid / kLanes, part = tid % kLanes;\n"
         "const int base = (tid & 31) & ~(kLanes - 1);"),
        ("const int64_t state0 = (b * di + c) * kDs;",
         f"const int64_t state0 = (b * di + c) * kDs + part * {own};"),
        ("""for (int n = 0; n < kDs; ++n) {
a[n] = live ? -expf(a_log[c * kDs + n]) * kLog2e : 0.f;""",
         f"""for (int n = 0; n < {own}; ++n) {{
a[n] = live ? -expf(a_log[c * kDs + part * {own} + n]) * kLog2e : 0.f;"""),
        ("""for (int i = 0; i < kDs / 4; ++i) {
sm.ck[k / kChunk][chl][ck_piece(chl, i)] =""",
         f"""for (int i = 0; i < {own} / 4; ++i) {{
sm.ck[k / kChunk][chl][ck_piece(chl, part * {own} / 4 + i)] ="""),
        ("""const float* brow = &cur.bc[k][0];
const float* crow = &cur.bc[k][kDs];""",
         f"""const float* brow = &cur.bc[k][part * {own}];
const float* crow = &cur.bc[k][kDs + part * {own}];"""),
        (SSM_STEP_LOOP, SSM_STEP_LOOP.replace("n < kDs", f"n < {own}")),
        ("sm.out[k][chl] = from_float<T>(fmaf(dskip, xv, y));",
         """#pragma unroll
for (int o = kLanes / 2; o > 0; o /= 2) {
  y += __shfl_xor_sync(0xffffffffu, y, o);
}
if (part == 0) sm.out[k][chl] = from_float<T>(fmaf(dskip, xv, y));"""),
        (SSM_WHOLE_TILE, """float sp[kTile / kLanes];
#pragma unroll
for (int i = 0; i < kTile / kLanes; ++i) {
  const float v = cur.dt[i * kLanes + part][chl] + bias;
  sp[i] = softplus_of(v, exp_neg_abs(v));
}
#pragma unroll
for (int k = 0; k < kTile; ++k) {
  step(k, __shfl_sync(0xffffffffu, sp[k / kLanes], base | (k % kLanes)));
}"""),
        ("for (int n = 0; n < kDs; ++n) h_last[state0 + n] = h[n];",
         f"for (int n = 0; n < {own}; ++n) h_last[state0 + n] = h[n];"),
    ]


SSM_VARIANTS = {
    "whole": [],
    "decays_fma_2of16": ssm_fma_decays("n % 8 == 7"),
    "decays_fma_3of16": ssm_fma_decays("n % 5 == 4"),
    "decays_fma_4of16": ssm_fma_decays("n % 4 == 3"),
    "lanes2_16blocks": ssm_lanes(2, 16),
    "lanes4_24blocks": ssm_lanes(4, 24),
    "channels32": ssm_layout(threads=32, min_blocks=16),
    "channels128": ssm_layout(threads=128, min_blocks=4),
    "blocks6": ssm_layout(min_blocks=6),
    "tile32": ssm_layout(tile=32),
    "y_tree": [(SSM_STEP_LOOP, """float p[kDs];
#pragma unroll
for (int n = 0; n < kDs; ++n) {
  const float decay = ex2(dt * a[n]);
  h[n] = fmaf(decay, h[n], dtx * brow[n]);
  p[n] = h[n] * crow[n];
}
#pragma unroll
for (int w = 1; w < kDs; w *= 2) {
#pragma unroll
  for (int n = 0; n + w < kDs; n += 2 * w) p[n] += p[n + w];
}
y = p[0];""")],
    "y_two_chains": [(SSM_STEP_LOOP, """float y2 = 0.f;
#pragma unroll
for (int n = 0; n < kDs; ++n) {
  const float decay = ex2(dt * a[n]);
  h[n] = fmaf(decay, h[n], dtx * brow[n]);
  if (n % 2) y2 = fmaf(h[n], crow[n], y2);
  else y = fmaf(h[n], crow[n], y);
}
y += y2;""")],
    "next_decays_first": [
        ("const auto step = [&](int k, float dt) {",
         "const auto step = [&](int k, float dt, const float* pre) {"),
        (SSM_DECAY, "const float decay = pre ? pre[n] : ex2(dt * a[n]);"),
        ("""for (int k = 0; k < S - t0; ++k) {
const float v = cur.dt[k][chl] + bias;
step(k, softplus_of(v, exp_neg_abs(v)));""",
         """for (int k = 0; k < S - t0; ++k) {
  const float v = cur.dt[k][chl] + bias;
  step(k, softplus_of(v, exp_neg_abs(v)), nullptr);"""),
        (SSM_WHOLE_TILE, """float dcur[kDs], dnext[kDs];
const float v0 = cur.dt[0][chl] + bias;
float dtc = softplus_of(v0, exp_neg_abs(v0));
#pragma unroll
for (int n = 0; n < kDs; ++n) dcur[n] = ex2(dtc * a[n]);
#pragma unroll
for (int k = 0; k < kTile; ++k) {
  float dtn = 0.f;
  if (k + 1 < kTile) {
    const float v = cur.dt[k + 1][chl] + bias;
    dtn = softplus_of(v, exp_neg_abs(v));
#pragma unroll
    for (int n = 0; n < kDs; ++n) dnext[n] = ex2(dtn * a[n]);
  }
  step(k, dtc, dcur);
#pragma unroll
  for (int n = 0; n < kDs; ++n) dcur[n] = dnext[n];
  dtc = dtn;
}""")],
    # log1p(e) / e on [0, 1] by lower degrees (Chebyshev least squares;
    # within 6.1e-7 and 3.1e-6 of log1p relative), or log1pf itself
    "log1p_degree7": [(SSM_POLY8, """float q = -0.008466253f;
q = fmaf(q, e, 0.043658514f);
q = fmaf(q, e, -0.10679787f);
q = fmaf(q, e, 0.17659733f);
q = fmaf(q, e, -0.24453324f);
q = fmaf(q, e, 0.3326524f);
q = fmaf(q, e, -0.49996355f);
q = fmaf(q, e, 0.9999995f);""")],
    "log1p_degree6": [(SSM_POLY8, """float q = 0.014026629f;
q = fmaf(q, e, -0.065769143f);
q = fmaf(q, e, 0.14810520f);
q = fmaf(q, e, -0.23417252f);
q = fmaf(q, e, 0.33078748f);
q = fmaf(q, e, -0.49982542f);
q = fmaf(q, e, 0.99999708f);""")],
    "log1pf": [(SSM_POLY8, ""),
               (SSM_SOFTPLUS_RETURN, "return fmaxf(v, 0.f) + log1pf(e);")],
    # trials (wrong results)
    "trial_decays_fma_pipe": [(SSM_DECAY,
                               "const float decay = fmaf(dt, a[n], 1.f);")],
    "trial_half_decays_fma_pipe": [(
        SSM_DECAY, "const float decay = n < kDs / 2 ? ex2(dt * a[n])\n"
                   "                                : fmaf(dt, a[n], 1.f);")],
    "trial_decays_twice_sfu": [(
        SSM_DECAY, "const float decay = ex2(dt * a[n]) * "
                   "ex2(dt * a[n] * 0.5f);")],
    "trial_no_softplus": [(SSM_POLY8, ""),
                          (SSM_SOFTPLUS_RETURN, "return v;")],
    "trial_bc_registers": [("""const float* brow = &cur.bc[k][0];
const float* crow = &cur.bc[k][kDs];""", """const float* brow = a;
const float* crow = a;""")],
}
# the gradient (ssm_bwd.cu with ssm.cuh inlined)
SSM_BWD_FWD_STEP = """h[j][n] = fmaf(ex2(comp(dt4, j) * a2[j][n]), h[j][n],
comp(dx4, j) * comp(b4, n));
dc[n] = fmaf(comp(dy4, j), h[j][n], dc[n]);"""
SSM_BWD_FWD_DECAY = \
    "h[j][n] = fmaf(ex2(comp(dt4, j) * a2[j][n]), h[j][n],"
SSM_BWD_DECAY = "const float decay = ex2(comp(dt4, j) * a2[j][n]);"
SSM_BWD_STATE_SUMS = """const bool hi = lane & 2, lo = lane & 1;
float u2[2], s2[2];
#pragma unroll
for (int m = 0; m < 2; ++m) {
u2[m] = (hi ? u[m + 2] : u[m])
+ __shfl_xor_sync(0xffffffffu, hi ? u[m] : u[m + 2], 2);
s2[m] = (hi ? s[m + 2] : s[m])
+ __shfl_xor_sync(0xffffffffu, hi ? s[m] : s[m + 2], 2);
}
const float uo = (lo ? u2[1] : u2[0])
+ __shfl_xor_sync(0xffffffffu, lo ? u2[0] : u2[1],
1);
const float so = (lo ? s2[1] : s2[0])
+ __shfl_xor_sync(0xffffffffu, lo ? s2[0] : s2[1],
1);"""
SSM_BWD_DC_STORE = """sm.red[warp][k][q][((q & 1) ^ 1) * kGroups + p] =
make_float4(dc[0], dc[1], dc[2], dc[3]);"""
SSM_BWD_DB_STORE = """sm.red[warp][k][q][(q & 1) * kGroups + p] =
make_float4(db[0], db[1], db[2], db[3]);"""
SSM_BWD_OWNER = """const float ddtp = fmaf(to_float(cur.x[k][tid]), uo, so * kLn2)
* sm.sg[k][tid];
sm.dx[k][tid] = from_float<T>(fmaf(sm.dt[k][tid], uo,
dskip * sm.dy[k][tid]));
sm.ddt[k][tid] = ddtp;
dbias += ddtp;"""
SSM_BWD_CONVERT = """const float e = exp_neg_abs(v);
const float r = __fdividef(1.f, 1.f + e);
const float dt = softplus_of(v, e);"""
SSM_BWD_LOADS = [
    ("const float4 dt4 = ld4(&sm.dt[k][cb]);",
     "const float4 dt4 = make_float4(a2[0][k & 3], a2[1][1], a2[2][2], "
     "a2[3][3]);", 2),
    ("const float4 dx4 = ld4(&sm.dtx[k][cb]);",
     "const float4 dx4 = make_float4(a2[1][k & 3], a2[2][1], a2[3][2], "
     "a2[0][3]);", 2),
    ("const float4 dy4 = ld4(&sm.dy[k][cb]);",
     "const float4 dy4 = make_float4(a2[2][k & 3], a2[3][1], a2[0][2], "
     "a2[1][3]);", 2),
    ("const float4 b4 = ld4(&cur.bc[k][kSt * p]);",
     "const float4 b4 = make_float4(a2[3][k & 3], a2[0][1], a2[1][2], "
     "a2[2][3]);", 2),
    ("const float4 c4 = ld4(&cur.bc[k][kDs + kSt * p]);",
     "const float4 c4 = make_float4(a2[0][k & 3], a2[2][1], a2[1][2], "
     "a2[3][3]);")]


def ssm_bwd_layout(warps: int, min_blocks: int) -> list:
    """Another block: ``warps`` warps (32 channels each), the launch bound
    at ``min_blocks`` blocks an SM."""
    return [("constexpr int kWarps = 2;", f"constexpr int kWarps = {warps};"),
            ("constexpr int kMinBlocks = 4;",
             f"constexpr int kMinBlocks = {min_blocks};")]


SSM_BWD_VARIANTS = {
    "whole": [],
    "warps1": ssm_bwd_layout(1, 8),
    "warps4": ssm_bwd_layout(4, 2),
    # the recomputed states without their decays (h = A h + dt x B)
    "trial_recompute_no_sfu": [(SSM_BWD_FWD_DECAY,
                                "h[j][n] = fmaf(a2[j][n], h[j][n],")],
    # the step back's decays not taken (the carry scaled by A log2 e)
    "trial_step_back_no_sfu": [(SSM_BWD_DECAY,
                                "const float decay = a2[j][n];")],
    # dB's and dC's terms neither taken nor staged (the sums after the
    # chunk add what shared memory holds)
    "trial_no_channel_sums": [(SSM_BWD_DC_STORE, ""),
                              (SSM_BWD_DB_STORE, "")],
    # u and the A q sum over the thread's states only (no shuffles)
    "trial_no_state_sums": [(SSM_BWD_STATE_SUMS,
                             "const float uo = u[0] + u[1] + u[2] + u[3];\n"
                             "const float so = s[0] + s[1] + s[2] + s[3];")],
    # the step back left out (the forward's dC terms stay)
    "trial_forward_only": [("for (int k = kK - 1; k >= 0; --k) {",
                            "for (int k = kK - 1; k >= kK; --k) {")],
    # the recomputed states as one add each (loads and stores stay)
    "trial_light_forward": [(SSM_BWD_FWD_STEP, """h[j][n] += comp(dx4, j);
dc[n] += h[j][n];""")],
    # the owner's dx, ddt_pre and ddt_bias left out
    "trial_no_owner": [(SSM_BWD_OWNER, "dbias += uo + so;")],
    # the softplus, sigmoid and reciprocal left out of the conversion
    "trial_light_conversion": [(SSM_BWD_CONVERT,
                                "const float e = v, r = v, dt = v;")],
    # the step loops' loads of the per-channel values, B and C left out
    "trial_no_step_loads": SSM_BWD_LOADS,
    # the sums of dB's and dC's terms after the chunk left out
    "trial_no_chunk_sums": [(
        "for (int e = tid; e < kK * kPieces; e += kThreads) {",
        "for (int e = tid; e < 0; e += kThreads) {")],
    # the copies of every chunk but the first left out
    "trial_no_refill": [("""if (jc > 0) {
load_chunk(sm.tile[(i + 1) & 1], x, dt_pre, dy, bm, cm, ckpt, b, n_ck,""",
                         """if (false) {
load_chunk(sm.tile[(i + 1) & 1], x, dt_pre, dy, bm, cm, ckpt, b, n_ck,""")],
    # 64 KB more shared memory a block: 2 blocks (4 warps) an SM
    "trial_half_occupancy": [(
        "const int smem = static_cast<int>(sizeof(BwdSmem<T>));",
        "const int smem = static_cast<int>(sizeof(BwdSmem<T>)) + 65536;")],
}
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
    }),    "ssm": ("ssm.cu", SSM_VARIANTS),
    "ssm_bwd": ("ssm_bwd.cu", SSM_BWD_VARIANTS),
}
# the builds that compute the result: held to the plain version
CORRECT = {"gmm": {"whole"}, "slstm": {"whole", "lend2", "lend4"},
           **{k: {n for n in VARIANTS[k][1] if not n.startswith("trial_")}
              for k in ("ssm", "ssm_bwd")}}
LAUNCHER = {"gmm": "moe_gmm_bwd", "slstm": "slstm_scan_bwd",
            "ssm": "ssm_scan", "ssm_bwd": "ssm_scan_bwd"}
# the kernel of each whose ptxas lines are kept
ENTRY = {"gmm": "gmm_bwd_wgmma_kernel", "slstm": "slstm_bwd_cluster_kernel",
         "ssm": "ssm_scan_kernel", "ssm_bwd": "ssm_bwd_kernel"}
# the kernels whose builds take ssm.cuh inlined; their device spans'
# names and launches a call (chip_smoke.device_ms)
INLINE = {"ssm", "ssm_bwd"}
DEVICE = {"ssm": ("ssm_scan_kernel", 1), "ssm_bwd": ("ssm_bwd_", 2)}


def edit(src: str, old: str, new: str, count: int = 1) -> str:
    """``src`` with ``old`` (``count`` occurrences, matched line by line
    whatever its indentation) replaced by ``new``, shifted as ``old``
    was."""
    olines = old.rstrip("\n").split("\n")
    pattern = "\n".join(("([ \t]*)" if i == 0 else "[ \t]*")
                        + re.escape(ln.lstrip()) for i, ln in enumerate(olines))
    found = list(re.finditer(pattern, src))
    if len(found) != count:
        raise RuntimeError(f"the edit's text occurs {len(found)} times, "
                           f"not {count}: {olines[0]!r}")
    for match in reversed(found):
        start, end = match.span()
        shift = len(match.group(1)) - (len(olines[0])
                                       - len(olines[0].lstrip()))
        if not new.strip():             # drop the lines
            src = src[:start] + src[end + (src[end:end + 1] == "\n"):]
            continue
        lines = [ln if not ln.strip() else
                 " " * shift + ln if shift >= 0 else
                 ln[min(-shift, len(ln) - len(ln.lstrip())):]
                 for ln in new.rstrip("\n").split("\n")]
        src = src[:start] + "\n".join(lines) + src[end:]
    return src


def inline_header(text: str, csrc: Path) -> str:
    """``text`` with its ``#include "ssm.cuh"`` replaced by the header's
    lines (``#pragma once`` left out), so that an edit reaches both."""
    header = (csrc / "ssm.cuh").read_text().replace("#pragma once\n", "")
    return text.replace('#include "ssm.cuh"\n', header)


def build(out_dir: Path, kernels) -> dict:
    """Compile every variant of ``kernels`` at once; returns {(kernel,
    variant): (loaded library, ptxas's lines)}."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for kernel in kernels:
        source, variants = VARIANTS[kernel]
        text = (_build.CSRC / source).read_text()
        if kernel in INLINE:
            text = inline_header(text, _build.CSRC)
        for name, edits in variants.items():
            src = text
            for old, new, *count in edits:
                src = edit(src, old, new, *count)
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


def ssm_case(dev, seed):
    """``gmm_case`` for the scan at SSM_SHAPE (chip_smoke.ssm_inputs,
    bfloat16 x, from zeros), and its bounds."""
    import chip_smoke as cs
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.kernels.weighted_agg import DTYPE_FLAG
    B, S, di, ds = SSM_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    args = cs.ssm_inputs(B, S, di, ds, torch.bfloat16, False, g, dev)
    x, *rest = args[:7]
    out = torch.empty_like(x)
    h = torch.empty(B, di, ds, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        rc = fn(dev.index or 0, x.data_ptr(), *(t.data_ptr() for t in rest),
                None, B, S, di, ds, DTYPE_FLAG[x.dtype], out.data_ptr(),
                h.data_ptr(), None, stream)
        if rc:
            raise RuntimeError(f"ssm_scan failed ({rc})")

    want = sm.ssm_scan_torch(*args)
    bounds = {"bound_ms": sm.bound_ms(*args)["bound_ms"],
              "bound_both_pipes_ms": ssm_bound_both_pipes(args)}
    return run, lambda name: cs.ssm_held((out, h), want, f"ssm {name}"), \
        bounds


def ssm_bwd_case(dev, seed):
    """``ssm_case`` for the gradient at SSM_BWD_SHAPE: the tree's forward
    kernel's saved states, random output gradients, the outputs and
    scratch as the wrapper allocates them (ssm_scan._launch_bwd)."""
    import chip_smoke as cs
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.kernels.weighted_agg import DTYPE_FLAG
    B, S, di, ds = SSM_BWD_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    args = cs.ssm_inputs(B, S, di, ds, torch.bfloat16, False, g, dev)
    _, _, ckpt = sm._launch(*args, ckpt=True)
    dout = torch.randn(B, S, di, generator=g, device=dev).bfloat16()
    want = sm.ssm_scan_bwd_torch(*args, ckpt, dout, None)
    f32 = dict(dtype=torch.float32, device=dev)
    # part_bc for a block of one warp (32 channels), the smallest variant
    part_bc = torch.empty(B, S, -(-di // 32), 2 * ds, **f32)
    part_ch = torch.empty(sm.bwd_scratch_shapes(B, S, di)["part_ch"], **f32)
    dx = torch.empty_like(args[0])
    outs = [torch.empty(B, S, di, **f32), torch.empty(B, S, ds, **f32),
            torch.empty(B, S, ds, **f32), torch.empty(di, ds, **f32),
            torch.empty(di, **f32), torch.empty(di, **f32)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        rc = fn(dev.index or 0, args[0].data_ptr(),
                *(t.data_ptr() for t in args[1:7]), ckpt.data_ptr(),
                dout.data_ptr(), None, B, S, di, ds,
                DTYPE_FLAG[args[0].dtype], part_bc.data_ptr(),
                part_ch.data_ptr(), dx.data_ptr(),
                *(t.data_ptr() for t in outs), None, stream)
        if rc:
            raise RuntimeError(f"ssm_scan_bwd failed ({rc})")

    def check(name):
        got = (dx, outs[0], outs[5], outs[1], outs[2], outs[3], outs[4])
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(),
                                       **sm.kernel_bwd_tol(b),
                                       msg=lambda m: f"ssm_bwd {name}: {m}")
        return max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(got, want))
    return run, check, {"bound_ms": sm.bwd_bound_ms(*args, ckpt,
                                                     dout)["bound_ms"]}


def ssm_bound_both_pipes(args) -> float:
    """ssm_scan's bound where a decay may go to the SFU or, at
    ``EX2_FMA_OPS`` operations, to the FMA pipes beside the step's float32
    FLOPs (at 2 an FMA-pipe operation), split as takes least; or the
    bytes, the larger."""
    from repro_torch.kernels import ssm_scan as sm
    per_s = sm.SM_COUNT * sm.BOOST_HZ               # SM clocks a second
    fma_lanes = sm.CUDA_CORE_FLOPS / 2 / per_s      # 128 an SM a clock
    exps = sm.exp_count(args[0], args[5])
    flops, n_bytes = sm.ssm_scan_cost(*args)
    fma_ops = flops / 2
    ops_s = max(fma_ops / (fma_lanes * per_s),
                min(exps / (sm.SFU_PER_CLOCK * per_s),
                    (fma_ops + EX2_FMA_OPS * exps)
                    / ((fma_lanes + sm.SFU_PER_CLOCK * EX2_FMA_OPS)
                       * per_s)))
    return max(ops_s, n_bytes / sm.HBM_BYTES_PER_S) * 1e3


def time_builds(kernel, label, libs, run, check, flush) -> dict:
    names = list(VARIANTS[kernel][1])
    err = {}
    for name in names:                  # warm up; the error of the correct
        run(libs[kernel, name][0])
        torch.cuda.synchronize()
        if name in CORRECT[kernel]:
            err[name] = check(name)
    ms = {name: [] for name in names}
    device = {name: [] for name in names}
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
        if kernel in DEVICE:
            from chip_smoke import device_ms
            fragment, per_call = DEVICE[kernel]
            device[name].append(device_ms(
                lambda: run(libs[kernel, name][0]), fragment, ITERS[kernel],
                flush, per_call=per_call))
    mean = {name: sum(v) / len(v) for name, v in ms.items()}
    row = {"kernel": kernel, "shape": label, "ms": mean,
           "saved_ms": {k: mean["whole"] - v for k, v in mean.items()
                        if k != "whole"},
           "max_abs_err": err, "runs": ms,
           "ptxas": {name: libs[kernel, name][1] for name in names}}
    if kernel in DEVICE:
        row["device_ms"] = device
    return row


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
    if "ssm" in kernels:
        cases.append(("ssm", list(SSM_SHAPE), *ssm_case(dev, 0)))
    if "ssm_bwd" in kernels:
        cases.append(("ssm_bwd", list(SSM_BWD_SHAPE), *ssm_bwd_case(dev, 1)))
    for kernel, label, run, check, *bounds in cases:
        row = time_builds(kernel, label, libs, run, check, flush)
        for extra in bounds:
            row.update(extra)
        if kernel == "slstm":
            row["us_per_step"] = {k: v * 1e3 / SLSTM_SHAPE["S"]
                                  for k, v in row["ms"].items()}
        row["card"] = card
        if kernel in DEVICE:
            from chip_smoke import RETAKES
            row["retakes"] = list(RETAKES)
        line = json.dumps(row)
        print(line, flush=True)
        lines.append(line)
    out = ROOT / "chiprun_out" / "bwd_split.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
