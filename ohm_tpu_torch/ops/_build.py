"""Build and load the hand-written CUDA kernels (``ohm_tpu_torch/csrc``).

nvcc compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) on first use, one
process per source, all started together, and links the objects into one
shared library with a plain C interface; ctypes loads it.  Every
pointer and the stream cross as ``c_void_p`` (a bare int would be cut to
32 bits).  Each C entry point returns ``cudaGetLastError()`` after its
launches, and ``check`` raises when that is not 0: a refused launch never
runs, and a later synchronise would not report it.

Build flags: ``-fmad=false`` keeps every multiply and add separately
rounded, as the reference's keys and sweep need; no fast math, so ``1/x``
and the conversions stay IEEE.  The library goes to
``ohm_tpu_torch/_build/`` (ignored by git) and is rebuilt when a source is
newer.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libohm_tpu_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (extern "C"); every entry returns a cudaError_t.
_SIGNATURES = {
    # fray, iray, gmeta, key, vox (or null), missed, B, S, K, shift, v,
    # sentinel, exclude_origin, stream
    "ohm_expand_keys": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # occupancy, keys, n_keys, hit, miss, n_vox, flags, hit_value,
    # miss_value, threshold, min_value, max_value, saturation_min,
    # saturation_max, touched, stream
    "ohm_deposit_and_sweep": [_P, _P, _I, _P, _P, _I, _I,
                              _F, _F, _F, _F, _F, _F, _F, _P, _P],
    # occupancy, walk_keys, n_walk, end_keys, n_end, dkeys (or null), dvals,
    # n_delta, delta plane, hit, miss, n_vox, hit_value, miss_value,
    # min_value, max_value, saturation_min, saturation_max, touched, stream
    "ohm_deposit_and_sweep_ndt": [_P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I,
                                  _F, _F, _F, _F, _F, _F, _P, _P],
    # plane, ids, n, sentinel, out, stream
    "ohm_gather_plane": [_P, _P, _I, _I, _P, _P],
}

_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False, verbose: bool = False) -> tuple[float, str]:
    """Compile the kernels unless the library is newer than every source.

    Returns (seconds spent compiling, compiler output); ``verbose`` adds
    ptxas's register and shared-memory report to the output."""
    srcs = sources()
    if not force and os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
            os.path.getmtime(s) for s in srcs):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o") for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []), "-c", src, "-o", obj],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    log, failed = [], []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate(timeout=900)
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = f"{LIB_PATH}.{tag}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True, timeout=300)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0, "".join(log) + link.stdout + link.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ohm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ohm_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().ohm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
