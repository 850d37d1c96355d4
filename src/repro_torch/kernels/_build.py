"""Build and load the port's CUDA kernels (``csrc/fold.cu``).

The source has a plain C interface, so it builds with ``nvcc`` alone into a
shared library (seconds, against minutes for a source that includes
PyTorch's headers) and loads with ``ctypes``.  The library goes to
``build/repro_torch/libfold.so`` at the root of the checkout, at the first
launch, and is rebuilt when the source is newer.  Nothing here runs at
import time: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fold.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIBRARY = BUILD_DIR / "libfold.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# (launcher, argument types) of every function csrc/fold.cu exports
_D, _P, _I = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "fold_rollup_digest": (_D, _P, _I, _P, _P),
    "fold_chunk_digests": (_D, _P, _I, _I, _P, _P),
    "fold_dirty_chunks": (_D, _P, _I, _I, _P, _I, _P, _P),
    "fold_batch_seal": (_D, _P, _I, _P, _I, _P, _P),
}

_LIB = None


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float
    log: str                      # nvcc's output (register and smem use)


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


def build(force: bool = False) -> BuildResult:
    """Compile ``fold.cu`` into ``LIBRARY`` unless it is up to date."""
    if (not force and LIBRARY.is_file()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return BuildResult(LIBRARY, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"libfold.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, LIBRARY)          # atomic: no reader sees half a file
    return BuildResult(LIBRARY, seconds, log)


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
