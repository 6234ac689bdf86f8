"""The ladder GEMM C = A @ B.T: the hand-written Hopper kernel, its planner
and its plain PyTorch versions.

Four variants, named by `variant(dtype, precision)`:
  'f32'  float32, full precision on the CUDA cores (csrc/ladder_mm.cu);
  'f64'  float64 on the FP64 tensor cores (csrc/ladder_mm.cu);
  'tf32' float32 operands rounded to TF32 (cvt.rna), f32 accumulation and
         output, on the tensor cores (csrc/ladder_mm_tc.cu, TMA and wgmma):
         the solver's 'high' and 'default' modes;
  'bf16' bfloat16 operands, f32 accumulation, the sum rounded once to a
         bfloat16 output (csrc/ladder_mm_tc.cu): the solver's 'bf16' mode.

`ladder_mm` launches the variant's kernel for CUDA tensors and raises on
anything it does not take; it never falls back.  Only for CPU tensors does
it compute the variant's plain version (`ladder_mm_plain`).
`ladder_mm.launches` counts kernel launches, forward, tangent and
backward, so a run can show that its main path went through the kernel;
`ladder_mm.backward_launches` and `ladder_mm.tangent_launches` count the
backward and the tangent ones among them, and
`ladder_mm.launches_by_variant` the launches of each variant.

The full-precision launch is a `torch.autograd.Function`: the gradient
for `a` is dA = dC @ b, one more launch of the same kernel: on `b` itself
where the call site declares it symmetric (every ladder operand is), else
on a transposed copy of it.  Its tangent (forward mode, `torch.func.jvp`:
the EOM-EE right sigma) is dC = dA @ b.T, one more launch on the same `b`.
A backward or tangent pass through a reduced-precision product raises: no
path differentiates through a reduced-precision solve.

Under torch.func.vmap (the batched lambda sweep, whose lanes share every
ERI block) both launches fold the lane axis of `a` into its rows: one
launch of M = lanes x rows for all lanes, counted once; a `b` with a
batch axis raises.

On a device mesh (parallel/sharding.py) `b` is a `RowShard`: this rank's
rows of the operand.  The product is one launch on them and an
all-gather of C's columns over the rank's group (`_ShardMM`), with the
same forward, backward, tangent and vmap rules, each one launch on the
local rows; `ladder_mm.shard_launches` counts those launches.

`plan` is pure Python: it picks the tile width and the split of K across
the blocks of a thread block cluster that fill the card at the solver's
skinny shapes (M = 98), and for the tensor-core variants the cluster of
row tiles that share each B tile.  The wrapper hands the plan to the
kernel, which checks the tile against its own.

The tensor-core variants load their operands by TMA, which needs row
strides of whole 16 bytes: `tf32_rows` and `bf16_rows` make such copies
(the solver makes its ladder operand's once per solve), and the wrapper
copies an operand that lacks them.  A TF32 B made by `tf32_rows` is
already rounded; any other B is rounded by the kernel as it arrives.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import torch
import torch.distributed as dist

from ecw_cc_torch.config import matmul_precision
from ecw_cc_torch.kernels import build

_FUNCS = {"f32": "ecw_ladder_mm_f32", "f64": "ecw_ladder_mm_f64",
          "tf32": "ecw_ladder_mm_tf32", "bf16": "ecw_ladder_mm_bf16"}
VARIANTS = tuple(_FUNCS)
REDUCED = ("tf32", "bf16")
_DTYPE_VARIANT = {torch.float32: "f32", torch.float64: "f64",
                  torch.bfloat16: "bf16"}
_INT_MAX = 2 ** 31 - 1
# The f32/f64 kernels' tiles (kBM, kBK, kMaxSplit and the BN instances of
# csrc/ladder_mm.cu): f32 is built 64 and 32 columns wide, f64 32.
BM, BK = 112, 16
WIDTHS = {"f32": (64, 32), "f64": (32,)}   # widest first
MAX_SPLIT = 16            # blocks per cluster
# The tensor-core variants' tile (csrc/ladder_mm_tc.cu kBM, kBN and one
# 128-byte row of K per chunk) and their largest cluster (kMaxCluster):
# cluster_m row tiles times split K ranges
TC_TILE = {"tf32": (128, 128, 32), "bf16": (128, 128, 64)}
TC_MAX_CLUSTER = 8
# row strides the TMA loads take: multiples of 16 bytes
TF32_ROW_ALIGN, BF16_ROW_ALIGN = 4, 8


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
    cluster_m: int = 1        # row tiles per cluster that share each B tile
                              # by TMA multicast (tensor-core variants)

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
    if v in TC_TILE:
        return _plan_tc(M, N, K, v, n_sm)
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


def _plan_tc(M, N, K, v, n_sm):
    """The tensor-core variants' plan: 128 x 128 tiles, K in chunks of one
    128-byte row.  The row tiles of one N tile form a cluster (cluster_m
    of them, the largest power of two <= TC_MAX_CLUSTER that divides the
    row tiles: all of them at every M <= 1024 whose tile count is a power
    of two, as M = 98, 196, 392), and each B tile is multicast to all of
    them, so B streams from device memory once per launch.  The split of K
    then follows the rule of `plan` within the cluster's room: the
    smallest power of two with cluster_m * split <= TC_MAX_CLUSTER, at
    most the chunk count, that gives a full wave, or the largest
    there is."""
    bm, bn, bk = TC_TILE[v]
    m_tiles, n_tiles, chunks = _cdiv(M, bm), _cdiv(N, bn), _cdiv(K, bk)
    cm = next(c for c in (8, 4, 2, 1) if m_tiles % c == 0)
    splits = [s for s in (1, 2, 4, 8)
              if cm * s <= TC_MAX_CLUSTER and s <= max(1, chunks)]
    tiles = m_tiles * n_tiles
    split = next((s for s in splits if tiles * s >= n_sm), splits[-1])
    bounds = [s * chunks // split * bk for s in range(split)] + [K]
    k_ranges = tuple((bounds[s], min(bounds[s + 1], K)) for s in range(split))
    partials = split * tiles * bm * bn if split > 1 else 0
    return Plan(bm, bn, bk, m_tiles, n_tiles, split, k_ranges, partials, cm)


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


def _has_rows(x, align):
    """x's rows are contiguous, 16-byte aligned and 16 bytes apart."""
    return x.numel() == 0 or (x.stride(-1) == 1 and x.stride(0) % align == 0
                              and x.data_ptr() % 16 == 0)


def _padded(x, dtype, align, values=None):
    """A copy of x in `dtype` into zero-filled rows padded to a multiple
    of `align` elements (`values`: what to write instead of x), as a view
    of its first x.shape[1] columns."""
    k = x.shape[1]
    out = torch.zeros((x.shape[0], _cdiv(k, align) * align), dtype=dtype,
                      device=x.device)
    out[:, :k] = x if values is None else values
    return out[:, :k]


def bf16_rows(x):
    """x (2-D) as bfloat16 with a row stride the BF16 kernel's TMA loads
    take: x itself where it has one, else a copy (cast on the way) into
    rows padded to a multiple of BF16_ROW_ALIGN elements, returned as a
    view of its first x.shape[1] columns."""
    if x.dtype == torch.bfloat16 and _has_rows(x, BF16_ROW_ALIGN):
        return x
    return _padded(x, torch.bfloat16, BF16_ROW_ALIGN)


def tf32_rows(x):
    """x (2-D, float32) rounded to TF32 (`round_tf32`) into zero-filled
    rows padded to a multiple of TF32_ROW_ALIGN floats (16 bytes), returned
    as a view of its first x.shape[1] columns: the TF32 kernel's B as the
    solver holds it, made once per solve, which the kernel reads without
    rounding it again (`is_tf32_rows`)."""
    out = _padded(x, torch.float32, TF32_ROW_ALIGN,
                  values=round_tf32(x.float()))
    key = id(out)
    _TF32_ROWS[key] = weakref.ref(out, lambda _: _TF32_ROWS.pop(key, None))
    return out


_TF32_ROWS = {}   # id -> weak reference of each view tf32_rows returned


def is_tf32_rows(x):
    """x is a view that `tf32_rows` returned (rounded, 16-byte rows)."""
    ref = _TF32_ROWS.get(id(x))
    return ref is not None and ref() is x


def _launch(a, b, backward=False, precision=None, tangent=False):
    """One launch of the kernel on checked CUDA operands: C = a @ b.T.
    backward, tangent: the launch computes a gradient or a tangent
    (counted as such)."""
    v = variant(a.dtype, precision)
    _check(a, b, v)
    M, K = a.shape
    N = b.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    p = device_plan(M, N, K, v, a.device)
    fn = getattr(build.library().cdll, _FUNCS[v])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if v in REDUCED:
        a, b, round_b = _tc_operands(a, b, v)
        # row strides (no row is read at K = 0), the plan's M group and
        # split, and whether the kernel rounds B
        args = ((a.stride(0), b.stride(0)) if K else (0, 0)) + (
            p.bm, p.bn, p.bk, p.cluster_m, p.split, round_b)
    else:
        args = (p.bm, p.bn, p.bk, p.split)
    err = fn(a.device.index, a.data_ptr(), b.data_ptr(), c.data_ptr(),
             M, N, K, *args, stream)
    if err != 0:
        raise RuntimeError(f"ladder_mm {v} kernel launch failed: "
                           f"cudaError {err}")
    ladder_mm.launches += 1
    ladder_mm.backward_launches += bool(backward)
    ladder_mm.tangent_launches += bool(tangent)
    ladder_mm.launches_by_variant[v] += 1
    return c


def _tc_operands(a, b, v):
    """(a, b, round_b) for a tensor-core launch: operands with 16-byte rows
    (a copy only of one that lacks them) and round_b = 1 where the TF32
    kernel must round B itself: a B with such rows that `tf32_rows` did
    not make (the dense route's view of the whole vvvv block, which no
    call copies).  A is always rounded by the kernel."""
    if v == "bf16":
        return bf16_rows(a), bf16_rows(b), 0
    if not _has_rows(a, TF32_ROW_ALIGN):
        a = _padded(a, torch.float32, TF32_ROW_ALIGN)
    if is_tf32_rows(b):
        return a, b, 0
    if _has_rows(b, TF32_ROW_ALIGN):
        return a, b, 1
    return a, tf32_rows(b), 0


class _LadderMM(torch.autograd.Function):
    """The launch with its gradient and its tangent for `a`.  forward and
    setup_context are separate so that the function also runs under
    torch.func transforms, which hand forward the plain tensors behind
    their wrappers (the launch reads data_ptr()).  backward: False for a
    forward product, True where this launch is part of a backward pass,
    "tangent" where it computes a tangent."""

    @staticmethod
    def forward(a, b, symmetric, backward):
        if backward == "tangent":
            return _launch(a, b, tangent=True)
        return _launch(a, b, backward)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, b, symmetric, _ = inputs
        ctx.save_for_backward(b)
        ctx.save_for_forward(b)
        ctx.symmetric = symmetric
        ctx.set_materialize_grads(False)   # an absent tangent stays None

    @staticmethod
    def jvp(ctx, da, db, dsymmetric, dbackward):
        # dC = dA @ B.T, one launch of the same product on the same B (its
        # padding rows, if any, give the same zero columns as the
        # forward's).  B takes no tangent: with materialize_grads off, db
        # is None unless the caller gave B one.  Under torch.func the
        # tangent arrives wrapped: the launch goes through apply, whose
        # forward sees the plain tensor
        if db is not None:
            raise RuntimeError(_NO_B_GRAD)
        (b,) = ctx.saved_tensors
        return _LadderMM.apply(da.contiguous(), b, ctx.symmetric, "tangent")

    @staticmethod
    def vmap(info, in_dims, a, b, symmetric, backward):
        # the lanes of a (torch.func.vmap: the batched lambda sweep) folded
        # into M, one launch on the shared B
        a2, lanes = _fold_lanes(in_dims, a, b)
        c = _LadderMM.apply(a2.contiguous(), b, symmetric, backward)
        return c.reshape(lanes + c.shape[1:]), 0

    @staticmethod
    def backward(ctx, dc):
        (b,) = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise RuntimeError(_NO_B_GRAD)
        if dc is None:
            return None, None, None, None
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
    launch on CUDA tensors, the plain version on CPU ones, and neither
    gradient nor tangent."""

    @staticmethod
    def forward(a, b, precision):
        if a.device.type == "cpu" and b.device.type == "cpu":
            return ladder_mm_plain(a, b, precision)
        return _launch(a, b, precision=precision)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.variant = variant(inputs[0].dtype, inputs[2])

    @staticmethod
    def vmap(info, in_dims, a, b, precision):
        # as _LadderMM.vmap; the launch pads the folded rows if the TMA
        # loads need it (_tc_operands)
        a2, lanes = _fold_lanes(in_dims, a, b)
        if a2.shape[1] > 1 and a2.stride(1) != 1:
            a2 = a2.contiguous()
        c = _ReducedMM.apply(a2, b, precision)
        return c.reshape(lanes + c.shape[1:]), 0

    @staticmethod
    def backward(ctx, dc):
        raise RuntimeError(_no_reduced_derivative("gradient", ctx.variant))

    @staticmethod
    def jvp(ctx, da, db, dprecision):
        raise RuntimeError(_no_reduced_derivative("tangent", ctx.variant))


def _no_reduced_derivative(what, v):
    return (f"ladder_mm: no {what} through a reduced-precision product "
            f"(the {v!r} variant): no path differentiates through a "
            f"reduced-precision solve; take the {what} at "
            "iter_precision='highest'")


def _fold_lanes(in_dims, a, b):
    """(a with its lane axis folded into its rows, (lanes, rows)): the
    vmap rule of a product whose A carries lanes (torch.func.vmap over the
    batched lambda sweep) and whose B is shared.  A batched B raises: each
    lane would need a launch of its own."""
    if in_dims[1] is not None:
        raise RuntimeError(_NO_B_BATCH)
    if in_dims[0] is None:
        raise RuntimeError("ladder_mm vmap rule called with no batched "
                           "operand")
    a = a.movedim(in_dims[0], 0)
    return a.reshape(-1, a.shape[-1]), a.shape[:2]


_NO_B_BATCH = ("ladder_mm takes no batch axis (torch.func.vmap) on its "
               "second operand (an ERI block, shared by the lanes): close "
               "over it instead")

_NO_B_GRAD = ("ladder_mm has no gradient or tangent for its second operand "
              "(an ERI block): detach it")


class RowShard:
    """This rank's rows of a ladder operand whose rows are split over the
    ranks of a process group (the 'tp' axis of a device mesh): `local`
    holds rows [r * per, r * per + local.shape[0]) of the operand's GEMM
    view (n_rows, K), r this rank's place in `group`; `shape` is the whole
    operand's (2-D, or the (v, v, v, v) of a dense vvvv, whose GEMM view
    is (v*v, v*v)).  The product C = A @ B.T on it is one launch on the
    local rows and an all-gather of C's columns (`ladder_mm`); the
    operand itself never moves.  Made by parallel.sharding.row_shard
    from a DTensor, outside any torch.func transform (which cannot see
    into one)."""

    __slots__ = ("local", "shape", "n_rows", "per", "group", "size")

    def __init__(self, local, shape, n_rows, per, group, size):
        self.local, self.shape, self.n_rows = local, tuple(shape), n_rows
        self.per, self.group, self.size = per, group, size

    def with_local(self, local):
        """The same split with other local rows (a cast of these)."""
        return RowShard(local, self.shape, self.n_rows, self.per,
                        self.group, self.size)

    def to(self, *args, **kwargs):
        return self.with_local(self.local.to(*args, **kwargs))

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n

    def amax_abs(self, other=None):
        """max |B| (or max |B - other|, `other` split alike) over the
        whole operand: the local maximum, then one all-reduce."""
        x = self.local if other is None else self.local - other.local
        m = (x.abs().max() if x.numel() else x.new_zeros(())).reshape(1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        return m[0]


def _local_mm(a, b, precision, kind):
    """One rank's product a @ b.T on its rows: the launch on CUDA tensors
    (counted, also in ladder_mm.shard_launches), the plain version on CPU
    ones.  kind: False (forward), True (backward), "tangent"."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ladder_mm_plain(a, b, precision)
    c = _launch(a, b, backward=kind is True, precision=precision,
                tangent=kind == "tangent")
    ladder_mm.shard_launches += 1
    return c


def _gather_cols(c, shard):
    """The local columns c (M, rows) of every rank in the group, side by
    side: (M, n_rows).  One all-gather of M x per per rank."""
    M = c.shape[0]
    if c.shape[1] < shard.per:
        c = torch.nn.functional.pad(c, (0, shard.per - c.shape[1]))
    out = c.new_empty((shard.size * M, shard.per))
    dist.all_gather_into_tensor(out, c.contiguous(), group=shard.group)
    out = out.view(shard.size, M, shard.per).permute(1, 0, 2)
    return out.reshape(M, shard.size * shard.per)[:, :shard.n_rows]


class _ShardMM(torch.autograd.Function):
    """The product on a row shard, C = A @ B.T with B's rows shard over
    the group: each rank launches on its rows, the columns of C are
    gathered.  Its gradient uses the whole operand's symmetry (every
    ladder operand's): dA = dC @ B, and dA[:, rows_r] = dC[:, :K] @
    B_r.T, so the backward is one launch on the local rows as they are,
    then the same all-gather (no transposed copy of the shard).  Its
    tangent dC = dA @ B.T is the forward's launch on dA.  Under
    torch.func.vmap the lanes of A fold into its rows, as in _LadderMM.
    kind: False (forward), True (backward), "tangent"."""

    @staticmethod
    def forward(a, b, shard, precision, kind):
        return _gather_cols(_local_mm(a, b, precision, kind), shard)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, shard, precision, _ = inputs
        ctx.save_for_backward(b)
        ctx.save_for_forward(b)
        v = variant(a.dtype, precision)
        ctx.shard, ctx.reduced = shard, v if v in REDUCED else None
        ctx.set_materialize_grads(False)

    @staticmethod
    def jvp(ctx, da, db, dshard, dprecision, dkind):
        if db is not None:
            raise RuntimeError(_NO_B_GRAD)
        if ctx.reduced:
            raise RuntimeError(_no_reduced_derivative("tangent",
                                                      ctx.reduced))
        (b,) = ctx.saved_tensors
        return _ShardMM.apply(da.contiguous(), b, ctx.shard, None,
                              "tangent")

    @staticmethod
    def vmap(info, in_dims, a, b, shard, precision, kind):
        a2, lanes = _fold_lanes(in_dims, a, b)
        c = _ShardMM.apply(a2.contiguous(), b, shard, precision, kind)
        return c.reshape(lanes + c.shape[1:]), 0

    @staticmethod
    def backward(ctx, dc):
        if ctx.needs_input_grad[1]:
            raise RuntimeError(_NO_B_GRAD)
        if dc is None:
            return None, None, None, None, None
        if ctx.reduced:
            raise RuntimeError(_no_reduced_derivative("gradient",
                                                      ctx.reduced))
        (b,) = ctx.saved_tensors
        K = b.shape[1]
        da = _ShardMM.apply(dc[:, :K].contiguous(), b, ctx.shard, None,
                            True)
        return da[:, :K], None, None, None, None


def _shard_mm(a, shard, symmetric, precision):
    """ladder_mm on a RowShard."""
    if not symmetric:
        raise ValueError("ladder_mm on a row shard takes symmetric=True "
                         "only: its backward rests on the whole operand's "
                         "symmetry")
    if shard.n_rows < shard.local.shape[1]:
        raise ValueError(f"ladder_mm: an operand of {shard.n_rows} rows "
                         f"and {shard.local.shape[1]} columns cannot be "
                         "symmetric in its leading rows")
    # the RowShard rides along as a plain object (torch.func passes it
    # through untouched); its rows go in as the tensor argument
    return _ShardMM.apply(a, shard.local, shard, precision, False)


def ladder_mm(a, b, symmetric=False, precision=None):
    """C = a @ b.T through the CUDA kernel of variant(a.dtype, precision)
    (CPU tensors: the variant's plain version; the full-precision ones
    with their native autograd).

    b may be a RowShard (its rows split over a process group, symmetric
    =True), or the DTensor of one: one launch on the local rows, C's
    columns all-gathered (_ShardMM), with the same gradient, tangent and
    vmap rules.

    precision: None, or 'tf32' for float32 operands (the 'high' and
    'default' modes).  bfloat16 operands take the BF16 variant and give a
    bfloat16 C.  The full-precision launch carries the gradient for `a`,
    dA = dC @ b, itself a launch of the kernel.  symmetric=True is the
    caller's word that b[:K, :K] is a symmetric matrix (K = b.shape[1];
    rows past K, if any, are zero padding), as every ladder operand is by
    <ab||ef> = <ef||ab>: then the backward reads `b` as it is, else a
    transposed copy of it.  The tangent in `a` (torch.func.jvp or forward
    mode) is dC = dA @ b.T, one more launch on `b` as it is.  `b` takes no
    gradient and no tangent: one that carries either raises."""
    if type(b).__name__ == "DTensor":
        # split over a mesh: its RowShard (eagerly; a consumer under a
        # torch.func transform makes it first, parallel.sharding.
        # local_operand)
        from ecw_cc_torch.parallel.sharding import row_shard

        b = row_shard(b)
    if isinstance(b, RowShard):
        return _shard_mm(a, b, symmetric, precision)
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
ladder_mm.tangent_launches = 0     # those of them made by a tangent (jvp)
ladder_mm.shard_launches = 0       # those of them on a RowShard's rows
ladder_mm.launches_by_variant = dict.fromkeys(VARIANTS, 0)
