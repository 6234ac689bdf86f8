"""The ladder GEMM C = A @ B.T: the hand-written Hopper kernel, its planner
and its plain PyTorch version.

`ladder_mm` launches `csrc/ladder_mm.cu` for CUDA tensors and raises on
anything the kernel does not take; it never falls back.  Only for CPU
tensors does it compute the plain `ladder_mm_ref`.  `ladder_mm.launches`
counts kernel launches, forward and backward, so a run can show that its
main path went through the kernel; `ladder_mm.backward_launches` counts
the backward ones among them.

The launch is a `torch.autograd.Function`: the gradient for `a` is
dA = dC @ b, one more launch of the same kernel: on `b` itself where the
call site declares it symmetric (every ladder operand is), else on a
transposed copy of it.

`plan` is pure Python: it picks the tile width and the split of K across
the blocks of a thread block cluster that fill the card at the solver's
skinny shapes (M = 98).  The wrapper hands the plan to the kernel, which
checks the tile against its own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ecw_cc_torch.kernels import build

_FUNCS = {torch.float32: "ecw_ladder_mm_f32",
          torch.float64: "ecw_ladder_mm_f64"}
_INT_MAX = 2 ** 31 - 1
# The kernel's tiles (kBM, kBK, kMaxSplit and its BN instances in
# csrc/ladder_mm.cu): f32 is built 64 and 32 columns wide, f64 32.
BM, BK = 112, 16
WIDTHS = {torch.float32: (64, 32), torch.float64: (32,)}   # widest first
MAX_SPLIT = 16            # blocks per cluster


class Plan(NamedTuple):
    bm: int
    bn: int
    bk: int
    m_tiles: int
    n_tiles: int
    split: int                # K splits = blocks per cluster
    k_ranges: tuple           # ((k0, k1), ...) of each split, in split order
    partials: int             # elements of partial tiles summed across each
                              # cluster: split * tiles * bm * bn (0 if split 1)

    @property
    def tiles(self):
        return self.m_tiles * self.n_tiles

    @property
    def blocks(self):
        return self.tiles * self.split


def _cdiv(x, y):
    return -(-x // y)


@functools.lru_cache(maxsize=256)
def plan(M, N, K, dtype, n_sm):
    """The launch of C (M, N) = A (M, K) @ B (N, K).T on a card of `n_sm` SMs.

    The output is cut into BM x bn tiles, bn the widest of WIDTHS[dtype]
    whose tiles can still fill the card; K into BK chunks, dealt to `split`
    blocks per tile (one cluster) as evenly as whole chunks allow: split s
    takes chunks [s * chunks // split, (s+1) * chunks // split).  The split
    is the smallest power of two, at most MAX_SPLIT and the chunk count,
    that gives at least one full wave of n_sm blocks, or the largest there
    is.  Powers of two because clusters of 9 to 15 blocks ran slower on an
    H100 than clusters of 8 or 16 at the same shapes."""
    if dtype not in _FUNCS:
        raise TypeError(f"ladder_mm has no kernel for {dtype}")
    if min(M, N) < 1 or K < 0 or n_sm < 1:
        raise ValueError(f"ladder_mm cannot plan M={M}, N={N}, K={K} on "
                         f"{n_sm} SMs")
    m_tiles, chunks = _cdiv(M, BM), _cdiv(K, BK)
    splits = [s for s in (1, 2, 4, 8, 16) if s <= max(1, min(chunks, MAX_SPLIT))]
    for bn in WIDTHS[dtype]:
        tiles = m_tiles * _cdiv(N, bn)
        if tiles * splits[-1] >= n_sm:
            break
    split = next((s for s in splits if tiles * s >= n_sm), splits[-1])
    bounds = [s * chunks // split * BK for s in range(split)] + [K]
    k_ranges = tuple((bounds[s], min(bounds[s + 1], K)) for s in range(split))
    partials = split * tiles * BM * bn if split > 1 else 0
    return Plan(BM, bn, BK, m_tiles, tiles // m_tiles, split, k_ranges,
                partials)


@functools.cache
def _n_sm(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(M, N, K, dtype, device):
    """`plan` for the CUDA device `device`, with its SM count read from it."""
    return plan(M, N, K, dtype, _n_sm(device.index))


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


def _launch(a, b, backward=False):
    """One launch of the kernel on checked CUDA operands: C = a @ b.T.
    backward: the launch computes a gradient (counted as such)."""
    _check(a, b)
    M, K = a.shape
    N = b.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    p = device_plan(M, N, K, a.dtype, a.device)
    fn = getattr(build.library().cdll, _FUNCS[a.dtype])
    err = fn(a.device.index, a.data_ptr(), b.data_ptr(), c.data_ptr(),
             M, N, K, p.bm, p.bn, p.bk, p.split,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ladder_mm kernel launch failed: cudaError {err}")
    ladder_mm.launches += 1
    ladder_mm.backward_launches += bool(backward)
    return c


class _LadderMM(torch.autograd.Function):
    """The launch with its gradient for `a`.  forward and setup_context are
    separate so that the function also runs under torch.func transforms,
    which hand forward the plain tensors behind their wrappers (the launch
    reads data_ptr()).  backward: this launch is itself part of a backward
    pass."""

    @staticmethod
    def forward(a, b, symmetric, backward):
        return _launch(a, b, backward)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, b, symmetric, _ = inputs
        ctx.save_for_backward(b)
        ctx.symmetric = symmetric

    @staticmethod
    def backward(ctx, dc):
        (b,) = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise RuntimeError(_NO_B_GRAD)
        # dA = dC @ B, an NN product, as the kernel's own NT product.  A
        # symmetric operand (its K leading rows; further rows are zero
        # padding) serves as it is: dC[:, :K] @ B[:K] = (dC[:, :K] @
        # B.T)[:, :K].  Any other is transposed first: dC @ B = dC @ (B.T).T
        K = b.shape[1]
        if ctx.symmetric:
            da = _LadderMM.apply(dc[:, :K].contiguous(), b, True, True)
            da = da[:, :K] if b.shape[0] != K else da
        else:
            da = _LadderMM.apply(dc.contiguous(), b.T.contiguous(), False,
                                 True)
        return da, None, None, None


_NO_B_GRAD = ("ladder_mm has no gradient for its second operand (an ERI "
              "block): detach it")


def ladder_mm(a, b, symmetric=False):
    """C = a @ b.T through the CUDA kernel (CPU tensors: the plain version,
    with its native autograd).

    The launch carries the gradient for `a`, dA = dC @ b, itself a launch
    of the kernel.  symmetric=True is the caller's word that b[:K, :K] is a
    symmetric matrix (K = b.shape[1]; rows past K, if any, are zero
    padding), as every ladder operand is by <ab||ef> = <ef||ab>: then the
    backward reads `b` as it is, else a transposed copy of it.  `b` takes no
    gradient: one that requires it raises."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ladder_mm_ref(a, b)
    if b.requires_grad:
        raise RuntimeError(_NO_B_GRAD)
    if symmetric and b.dim() == 2 and b.shape[0] < b.shape[1]:
        raise ValueError(f"ladder_mm: a {tuple(b.shape)} operand cannot be "
                         "symmetric in its leading rows")
    return _LadderMM.apply(a, b, bool(symmetric), False)


ladder_mm.launches = 0             # every launch of the kernel
ladder_mm.backward_launches = 0    # those of them made by a backward
