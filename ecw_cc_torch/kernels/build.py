"""Build the port's CUDA sources into one shared library at first use.

`nvcc` compiles every `ecw_cc_torch/csrc/*.cu` for Hopper (`sm_90a`), one
process per source, all started together, and links the objects into a
shared library with a plain C interface, which `ctypes` loads.  The output
lives in `ecw_cc_torch/_build/` (listed in `.gitignore`) under a name keyed
on a hash of the sources and flags, so an edited source is rebuilt and a
stale binary is never loaded.  Nothing here runs at import time: the CPU
tests import every module on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# name -> argtypes; every function returns its launch's cudaError_t
# ladder_mm: device, a, b, c, M, N, K, bm, bn, bk, split, stream
_LADDER_MM = [_INT, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT,
              _INT, _PTR]
# the tensor-core variants also take the operands' row strides, the
# blocks of an M group and whether B still needs its TF32 rounding:
# device, a, b, c, M, N, K, lda, ldb, bm, bn, bk, cm, split, round_b, stream
_LADDER_MM_LD = [_INT, _PTR, _PTR, _PTR] + [_INT] * 11 + [_PTR]
_SIGNATURES = {
    "ecw_ladder_mm_f32": _LADDER_MM,
    "ecw_ladder_mm_f64": _LADDER_MM,
    "ecw_ladder_mm_tf32": _LADDER_MM_LD,
    "ecw_ladder_mm_bf16": _LADDER_MM_LD,
}


class Library(NamedTuple):
    cdll: ctypes.CDLL
    path: str
    build_seconds: float   # 0.0 when the binary was already on disk
    log: str               # nvcc/ptxas output of this build ('' if cached)


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest(paths):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of ecw_cc_torch "
                           "need the CUDA toolkit to build")
    return path


@functools.cache
def library() -> Library:
    """Build (if needed) and load the kernel library; raises on failure."""
    srcs = sources()
    path = os.path.join(BUILD_DIR, f"libecw_torch_kernels-{_digest(srcs)}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        cu = [s for s in srcs if s.endswith(".cu")]
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cu, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed (exits "
                               f"{[p.returncode for p in procs]}):\n{log}")
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log += proc.stdout + proc.stderr
        for o in objs:
            os.remove(o)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{log}")
        os.replace(tmp, path)
    cdll = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Library(cdll, path, seconds, log)
