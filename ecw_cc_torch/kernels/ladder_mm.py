"""The ladder GEMM C = A @ B.T: the hand-written Hopper kernel, its planner
and its plain PyTorch versions.

Four variants, named by `variant(dtype, precision)`:
  'f32'  float32, full precision on the CUDA cores (csrc/ladder_mm.cu);
  'f64'  float64 on the FP64 tensor cores (csrc/ladder_mm.cu);
  'tf32' float32 operands rounded to TF32 (cvt.rna), f32 accumulation and
         output, on the tensor cores (csrc/ladder_mm_tc.cu): the solver's
         'high' and 'default' modes;
  'bf16' bfloat16 operands, f32 accumulation, the sum rounded once to a
         bfloat16 output (csrc/ladder_mm_tc.cu): the solver's 'bf16' mode.

`ladder_mm` launches the variant's kernel for CUDA tensors and raises on
anything it does not take; it never falls back.  Only for CPU tensors does
it compute the variant's plain version (`ladder_mm_plain`).
`ladder_mm.launches` counts kernel launches, forward and backward, so a
run can show that its main path went through the kernel;
`ladder_mm.backward_launches` counts the backward ones among them and
`ladder_mm.launches_by_variant` the launches of each variant.

The full-precision launch is a `torch.autograd.Function`: the gradient
for `a` is dA = dC @ b, one more launch of the same kernel: on `b` itself
where the call site declares it symmetric (every ladder operand is), else
on a transposed copy of it.  A backward pass through a reduced-precision
product raises: no path differentiates through a reduced-precision solve.

`plan` is pure Python: it picks the tile width and the split of K across
the blocks of a thread block cluster that fill the card at the solver's
skinny shapes (M = 98).  The wrapper hands the plan to the kernel, which
checks the tile against its own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ecw_cc_torch.config import matmul_precision
from ecw_cc_torch.kernels import build

_FUNCS = {"f32": "ecw_ladder_mm_f32", "f64": "ecw_ladder_mm_f64",
          "tf32": "ecw_ladder_mm_tf32", "bf16": "ecw_ladder_mm_bf16"}
VARIANTS = tuple(_FUNCS)
REDUCED = ("tf32", "bf16")
_DTYPE_VARIANT = {torch.float32: "f32", torch.float64: "f64",
                  torch.bfloat16: "bf16"}
_INT_MAX = 2 ** 31 - 1
# The kernels' tiles (kBM, kBK, kMaxSplit and the BN instances of
# csrc/ladder_mm.cu and csrc/ladder_mm_tc.cu): f32 is built 64 and 32
# columns wide, f64 32, the tensor-core variants 64.
BM, BK = 112, 16
WIDTHS = {"f32": (64, 32), "f64": (32,), "tf32": (64,),
          "bf16": (64,)}   # widest first
MAX_SPLIT = 16            # blocks per cluster
# row strides of the bf16 operands: multiples of 8 elements (16 bytes)
BF16_ROW_ALIGN = 8


def variant(dtype, precision=None):
    """The kernel variant for operands of `dtype` at `precision` (None, or
    'tf32' for float32 operands); raises TypeError on a pair that has no
    kernel."""
    if precision == "tf32" and dtype == torch.float32:
        return "tf32"
    if precision is None and dtype in _DTYPE_VARIANT:
        return _DTYPE_VARIANT[dtype]
    raise TypeError(f"ladder_mm has no kernel for {dtype} operands at "
                    f"precision {precision!r} (it takes float32, float32 "
                    "with precision='tf32', float64 and bfloat16)")


def _as_variant(v):
    return v if v in _FUNCS else variant(v)


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
    """The launch of C (M, N) = A (M, K) @ B (N, K).T on a card of `n_sm` SMs;
    `dtype` is a variant name or the operands' dtype (its full-precision
    variant).

    The output is cut into BM x bn tiles, bn the widest of WIDTHS[variant]
    whose tiles can still fill the card; K into BK chunks, dealt to `split`
    blocks per tile (one cluster) as evenly as whole chunks allow: split s
    takes chunks [s * chunks // split, (s+1) * chunks // split).  The split
    is the smallest power of two, at most MAX_SPLIT and the chunk count,
    that gives at least one full wave of n_sm blocks, or the largest there
    is.  Powers of two because clusters of 9 to 15 blocks ran slower on an
    H100 than clusters of 8 or 16 at the same shapes."""
    v = _as_variant(dtype)
    if min(M, N) < 1 or K < 0 or n_sm < 1:
        raise ValueError(f"ladder_mm cannot plan M={M}, N={N}, K={K} on "
                         f"{n_sm} SMs")
    m_tiles, chunks = _cdiv(M, BM), _cdiv(K, BK)
    splits = [s for s in (1, 2, 4, 8, 16) if s <= max(1, min(chunks, MAX_SPLIT))]
    for bn in WIDTHS[v]:
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
    """Plain version of the full-precision variants: C[m, n] = sum_k
    a[m, k] b[n, k]."""
    return a @ b.T


def round_tf32(x):
    """float32 x rounded to TF32 as cvt.rna.tf32.f32 rounds: to the nearest
    value with 10 mantissa bits, ties away from zero (the low 13 bits of
    the pattern cleared after adding half of their range to the
    magnitude); NaN stays NaN, a finite value may round to infinity."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def ladder_mm_plain(a, b, precision=None):
    """Plain version of each variant, in the kernel's arithmetic: f32 and
    f64 a @ b.T; tf32 the operands rounded as the kernel rounds them, then
    an f32 product; bf16 an f32 product of the bf16 values, rounded once
    to bf16 (f32 products at full precision, whatever mode the caller
    runs)."""
    v = variant(a.dtype, precision)
    with matmul_precision("highest"):
        if v == "tf32":
            return round_tf32(a) @ round_tf32(b).T
        if v == "bf16":
            return (a.float() @ b.float().T).to(torch.bfloat16)
        return a @ b.T


def _check(a, b, v):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"ladder_mm needs both operands on one CUDA device "
                         f"(got {a.device} and {b.device})")
    if b.dtype != a.dtype:
        raise TypeError(f"ladder_mm takes operands of one dtype (got "
                        f"{a.dtype} and {b.dtype})")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"ladder_mm takes 2-D operands (got {tuple(a.shape)}"
                         f" and {tuple(b.shape)})")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"ladder_mm: K mismatch, a {tuple(a.shape)} vs "
                         f"b {tuple(b.shape)}")
    if v in REDUCED:
        # rows contiguous along K; the row stride is passed to the kernel
        if a.shape[1] > 1 and (a.stride(1) != 1 or b.stride(1) != 1):
            raise ValueError("ladder_mm takes operands contiguous along K")
    elif not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ladder_mm takes contiguous operands")
    if max(a.shape[0], b.shape[0], a.shape[1], a.stride(0),
           b.stride(0)) > _INT_MAX:
        raise ValueError("ladder_mm: dimension exceeds int32")


def bf16_rows(x):
    """x (2-D) as bfloat16 with a row stride the BF16 kernel's 16-byte
    copies take: x itself where it has one, else a copy (cast on the way)
    into rows padded to a multiple of BF16_ROW_ALIGN elements, returned as
    a view of its first x.shape[1] columns."""
    if x.dtype == torch.bfloat16 and (x.numel() == 0 or (
            x.stride(1) == 1 and x.stride(0) % BF16_ROW_ALIGN == 0
            and x.data_ptr() % 16 == 0)):
        return x
    k = x.shape[1]
    kp = -(-k // BF16_ROW_ALIGN) * BF16_ROW_ALIGN
    out = torch.zeros((x.shape[0], kp), dtype=torch.bfloat16,
                      device=x.device)
    out[:, :k] = x
    return out[:, :k]


def _launch(a, b, backward=False, precision=None):
    """One launch of the kernel on checked CUDA operands: C = a @ b.T.
    backward: the launch computes a gradient (counted as such)."""
    v = variant(a.dtype, precision)
    _check(a, b, v)
    if v == "bf16":
        a, b = bf16_rows(a), bf16_rows(b)
    M, K = a.shape
    N = b.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    p = device_plan(M, N, K, v, a.device)
    fn = getattr(build.library().cdll, _FUNCS[v])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    # row strides of the tensor-core variants (no row is read at K = 0)
    lds = ((a.stride(0), b.stride(0)) if K else (0, 0)) if v in REDUCED else ()
    err = fn(a.device.index, a.data_ptr(), b.data_ptr(), c.data_ptr(),
             M, N, K, *lds, p.bm, p.bn, p.bk, p.split, stream)
    if err != 0:
        raise RuntimeError(f"ladder_mm {v} kernel launch failed: "
                           f"cudaError {err}")
    ladder_mm.launches += 1
    ladder_mm.backward_launches += bool(backward)
    ladder_mm.launches_by_variant[v] += 1
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


class _ReducedMM(torch.autograd.Function):
    """A reduced-precision product (the 'tf32' and 'bf16' variants): the
    launch on CUDA tensors, the plain version on CPU ones, and no
    gradient."""

    @staticmethod
    def forward(a, b, precision):
        if a.device.type == "cpu" and b.device.type == "cpu":
            return ladder_mm_plain(a, b, precision)
        return _launch(a, b, precision=precision)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.variant = variant(inputs[0].dtype, inputs[2])

    @staticmethod
    def backward(ctx, dc):
        raise RuntimeError(
            f"ladder_mm: no gradient through a reduced-precision product "
            f"(the {ctx.variant!r} variant): no path differentiates through "
            "a reduced-precision solve; take the gradient at "
            "iter_precision='highest'")


_NO_B_GRAD = ("ladder_mm has no gradient for its second operand (an ERI "
              "block): detach it")


def ladder_mm(a, b, symmetric=False, precision=None):
    """C = a @ b.T through the CUDA kernel of variant(a.dtype, precision)
    (CPU tensors: the variant's plain version; the full-precision ones
    with their native autograd).

    precision: None, or 'tf32' for float32 operands (the 'high' and
    'default' modes).  bfloat16 operands take the BF16 variant and give a
    bfloat16 C.  The full-precision launch carries the gradient for `a`,
    dA = dC @ b, itself a launch of the kernel.  symmetric=True is the
    caller's word that b[:K, :K] is a symmetric matrix (K = b.shape[1];
    rows past K, if any, are zero padding), as every ladder operand is by
    <ab||ef> = <ef||ab>: then the backward reads `b` as it is, else a
    transposed copy of it.  `b` takes no gradient: one that requires it
    raises."""
    v = variant(a.dtype, precision)
    if b.requires_grad and (v in REDUCED or a.device.type != "cpu"
                            or b.device.type != "cpu"):
        raise RuntimeError(_NO_B_GRAD)
    if v in REDUCED:
        return _ReducedMM.apply(a, b, precision)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ladder_mm_ref(a, b)
    if symmetric and b.dim() == 2 and b.shape[0] < b.shape[1]:
        raise ValueError(f"ladder_mm: a {tuple(b.shape)} operand cannot be "
                         "symmetric in its leading rows")
    return _LadderMM.apply(a, b, bool(symmetric), False)


ladder_mm.launches = 0             # every launch of the kernel
ladder_mm.backward_launches = 0    # those of them made by a backward
ladder_mm.launches_by_variant = dict.fromkeys(VARIANTS, 0)
