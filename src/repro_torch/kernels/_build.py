"""Build and load the port's CUDA kernels (every ``csrc/*.cu``, with the
headers ``csrc/*.cuh`` they include).

The sources have a plain C interface, so they build with ``nvcc`` alone
(seconds, against minutes for a source that includes PyTorch's headers)
and load with ``ctypes``.  Each source compiles to an object file, all of
them at once in parallel ``nvcc`` processes; one more ``nvcc`` links the
objects into the one shared library ``build/repro_torch/librepro_torch.so``
at the root of the checkout.  That happens at the first launch, and again
whenever any source or header is newer than the library.  Nothing here runs at
import time: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIBRARY = BUILD_DIR / "librepro_torch.so"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                 "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-c")

# (launcher, argument types) of every function the sources export; the
# stream is appended to each
_D, _P, _I, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_R = ctypes.c_float
_SIGNATURES = {
    # csrc/fold.cu
    # (device, words, n, clusters, partial words, out, stream)
    "fold_rollup_digest": (_D, _P, _I, _I, _P, _P, _P),
    # (device, words, n, chunk, warps a chunk, out, stream)
    "fold_chunk_digests": (_D, _P, _I, _I, _I, _P, _P),
    # (device, words, n, chunk, ids, D, warps a chunk, out, stream)
    "fold_dirty_chunks": (_D, _P, _I, _I, _P, _I, _I, _P, _P),
    # (device, words, n, starts, nb, span, carry scratch, out, stream)
    "fold_batch_seal": (_D, _P, _I, _P, _I, _I, _P, _P, _P),
    # (device, words, row stride, starts, row stride, n_seg, n_words, K,
    # B, W, span, carry scratch, tickets, out, stream)
    "fold_shard_seal": (_D, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P,
                        _P, _P),
    # csrc/fl.cu: (device, w, s, T, n, P, w's task and row strides, dtype
    # flag, out, stream)
    "fl_weighted_agg": (_D, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P),
    # (device, l, g, T, n, P, l's task and row strides, g's task stride,
    # dtype flag, form, cluster blocks, span, out, stream)
    "fl_model_distance": (_D, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                          _P, _P),
    # (device, dtype flag, cluster blocks, out int, stream)
    "fl_model_distance_capacity": (_D, _F, _I, _P, _P),
    # csrc/pack.cu: (device, tmax, gcum, N, times, n_vis, B, gas_limit,
    # ptr0, wide table, table, stops, stream)
    "pack_block_pack": (_D, _P, _P, _I, _P, _P, _I, _I, _I, _F, _P, _P, _P),
    # csrc/attn.cu: (device, q, k, v, B, S, H, Hkv, dh, scale, causal,
    # dtype flag, form, out, stream)
    "attn_flash_attention": (_D, _P, _P, _P, _I, _I, _I, _I, _I, _R, _F, _F,
                             _F, _P, _P),
    # csrc/moe.cu: (device, x, w, E, C, d, f, dtype flag, form, partial
    # sums, out, stream)
    "moe_gmm": (_D, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P, _P),
    # csrc/slstm.cu: (device, wx, r, hbuf, c0, n0, m0, B, S, nh, dh, U,
    # dtype flag, form, y, hN, cN, nN, mN, stream)
    "slstm_scan": (_D, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                   _P, _P, _P, _P, _P, _P),
    # (device, B, nh, dh, out int, stream)
    "slstm_cluster_capacity": (_D, _I, _I, _I, _P, _P),
}

_LIB = None


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    log: str                      # nvcc's output (register and smem use)


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, under CUDA_HOME, or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _up_to_date() -> bool:
    if not LIBRARY.is_file():
        return False
    built = LIBRARY.stat().st_mtime
    return all(src.stat().st_mtime <= built
               for src in sources() + headers())


def build(force: bool = False) -> BuildResult:
    """Compile every ``csrc/*.cu`` (in parallel) and link them into
    ``LIBRARY``, unless the library is newer than every source and
    header.  Untimed: the launch path reaches it, and nothing on that path
    reads the wall clock (repro-lint R003); a caller that reports the
    build's time times the call."""
    if not force and _up_to_date():
        return BuildResult(LIBRARY, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = nvcc_path(), f"{os.getpid()}.tmp"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{tag}.so")
    try:
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objects)]
        logs = [f"== {src.name}\n{proc.communicate()[0]}"
                for src, proc in zip(sources(), procs)]
        failed = [(log, proc.returncode) for log, proc in zip(logs, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({rc}) {log}" for log, rc in failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objects)], capture_output=True,
                              text=True, check=False)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{logs[-1]}")
        os.replace(tmp, LIBRARY)      # atomic: no reader sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return BuildResult(LIBRARY, "\n".join(logs))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.fold_error_string.argtypes = [ctypes.c_int]
        lib.fold_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(name: str, device: torch.device, *args: int) -> None:
    """Call launcher ``name`` on ``device``'s current stream; raise if the
    launch was refused (the C function returns ``cudaGetLastError()``)."""
    lib = library()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, name)(index, *args, stream)
    if rc != 0:
        msg = lib.fold_error_string(rc).decode()
        raise RuntimeError(f"{name} failed to launch: {msg} ({rc})")
