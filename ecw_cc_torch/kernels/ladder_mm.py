"""The ladder GEMM C = A @ B.T: the hand-written Hopper kernel and its plain
PyTorch version.

`ladder_mm` launches `csrc/ladder_mm.cu` for CUDA tensors and raises on
anything the kernel does not take; it never falls back.  Only for CPU
tensors does it compute the plain `ladder_mm_ref`.  `ladder_mm.launches`
counts kernel launches, so a run can show that its main path went through
the kernel.
"""

from __future__ import annotations

import torch

from ecw_cc_torch.kernels import build

_FUNCS = {torch.float32: "ecw_ladder_mm_f32",
          torch.float64: "ecw_ladder_mm_f64"}
_INT_MAX = 2 ** 31 - 1


def ladder_mm_ref(a, b):
    """Plain version: C[m, n] = sum_k a[m, k] b[n, k]."""
    return a @ b.T


def _check(a, b):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"ladder_mm needs both operands on one CUDA device "
                         f"(got {a.device} and {b.device})")
    if a.dtype not in _FUNCS or b.dtype != a.dtype:
        raise TypeError(f"ladder_mm takes float32 or float64 operands of one "
                        f"dtype (got {a.dtype} and {b.dtype})")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"ladder_mm takes 2-D operands (got {tuple(a.shape)}"
                         f" and {tuple(b.shape)})")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"ladder_mm: K mismatch, a {tuple(a.shape)} vs "
                         f"b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ladder_mm takes contiguous operands")
    if max(a.shape[0], b.shape[0], a.shape[1]) > _INT_MAX:
        raise ValueError("ladder_mm: dimension exceeds int32")


def ladder_mm(a, b):
    """C = a @ b.T through the CUDA kernel (CPU tensors: the plain version)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ladder_mm_ref(a, b)
    _check(a, b)
    M, K = a.shape
    N = b.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    fn = getattr(build.library().cdll, _FUNCS[a.dtype])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.device.index, a.data_ptr(), b.data_ptr(), c.data_ptr(),
             M, N, K, stream)
    if err != 0:
        raise RuntimeError(f"ladder_mm kernel launch failed: cudaError {err}")
    ladder_mm.launches += 1
    return c


ladder_mm.launches = 0
