"""The ladder GEMM C = A @ B.T: the hand-written Hopper kernels, their
planner and their plain PyTorch versions.

Four variants, named by `variant(dtype, precision)`, and the kernels that
run them (`Plan.kernel`, chosen by `plan` from the shape):
  'f32'  float32 to the full-precision contract (1e-5 max|C| of a @ b.T):
         'tc3', three TF32 passes on the tensor cores (csrc/
         ladder_mm_f32tc.cu, TMA and wgmma) at the shapes of `tc3_rule`,
         the sector GEMMs from cc-pVTZ up; 'ffma', the CUDA cores in full
         f32 (csrc/ladder_mm.cu) everywhere else;
  'f64'  float64 on the FP64 tensor cores: 'f64tc' (csrc/
         ladder_mm_f64tc.cu, TMA and a register-blocked DMMA tile) at the
         shapes of `f64tc_rule`, the packed, dense and polish GEMMs; 'dmma'
         (csrc/ladder_mm.cu) everywhere else;
  'tf32' float32 operands rounded to TF32 (cvt.rna), f32 accumulation and
         output, on the tensor cores: 'tc1', the one-pass instance of
         csrc/ladder_mm_f32tc.cu, at the shapes of `tc1_rule`, else 'tc'
         (csrc/ladder_mm_tc.cu): the solver's 'high' and 'default' modes;
  'bf16' bfloat16 operands, f32 accumulation, the sum rounded once to a
         bfloat16 output: 'tc' (csrc/ladder_mm_tc.cu): the solver's 'bf16'
         mode.

`ladder_mm` launches the kernel its plan names for CUDA tensors and raises
on anything it does not take; it never falls back to another kernel.
Only for CPU tensors does it compute the variant's plain version
(`ladder_mm_plain`; `ladder_mm_plain_split` is the three-pass kernel's
arithmetic, for the tests and the card's checks).
`ladder_mm.launches` counts kernel launches, forward, tangent and
backward, so a run can show that its main path went through the kernel;
`ladder_mm.backward_launches` and `ladder_mm.tangent_launches` count the
backward and the tangent ones among them,
`ladder_mm.launches_by_variant` the launches of each variant,
`ladder_mm.launches_by_kernel` those of each kernel function ('ffma',
'dmma', 'f64tc', 'tc_tf32', 'tc_bf16', 'tc3', 'tc1'), and
`ladder_mm.b_copies` (`a_copies`) the launches that had to copy their B
(their A) into 16-byte rows first.  A launch captured into a CUDA graph is counted at each
replay instead (`launch_counts`, `add_launch_counts`; solvers/
device_loop.py).

The full-precision launch is a `torch.autograd.Function`: the gradient
for `a` is dA = dC @ b, one more launch of the same kernel: on `b` itself
where the call site declares it symmetric (every ladder operand is), else
on a transposed copy of it.  Its tangent (forward mode, `torch.func.jvp`:
the EOM-EE right sigma through torch.func.jvp) is dC = dA @ b.T, one
more launch on the same `b`.  The gradient launch is itself such a
function, so a double backward (the EOM-EE right matvec, ops/eom.py: the
backward of a backward product taken for its cotangent) is one more
launch on `b`, a tangent dA @ b.T, and is counted as one.  Every one of
these launches, and the vmap-folded and row-shard ones below, takes the
plan of its own shape; on a symmetric B that is the forward's.  A
backward or tangent pass through a reduced-precision product raises: no
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

`plan` is pure Python: it picks the kernel, the tile and the split of K
across the blocks of a thread block cluster that fill the card at the
solver's skinny shapes (M = 98), and for the TMA kernels the cluster of
row tiles that share each B tile.  The wrapper hands the plan to the
kernel, which checks the tile against its own.

The TMA kernels ('tc', 'tc3', 'tc1', 'f64tc') load their operands by
TMA, which needs row strides of whole 16 bytes: `f32_rows`, `f64_rows`,
`tf32_rows` and `bf16_rows` make such copies (the solver's f32 and f64
operands are built in them, models/eris.py and ops/ladder.py; a cast one
gets them once per solve), and the wrapper copies an operand that lacks
them.  A TF32 B made by `tf32_rows` is
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

# (kernel, variant) -> (its key in ladder_mm.launches_by_kernel, the C
# function that launches it)
_FUNCS = {("ffma", "f32"): ("ffma", "ecw_ladder_mm_f32"),
          ("dmma", "f64"): ("dmma", "ecw_ladder_mm_f64"),
          ("f64tc", "f64"): ("f64tc", "ecw_ladder_mm_f64_tc"),
          ("tc", "tf32"): ("tc_tf32", "ecw_ladder_mm_tf32"),
          ("tc", "bf16"): ("tc_bf16", "ecw_ladder_mm_bf16"),
          ("tc3", "f32"): ("tc3", "ecw_ladder_mm_f32_tc3"),
          ("tc1", "tf32"): ("tc1", "ecw_ladder_mm_tf32_tc1")}
VARIANTS = ("f32", "f64", "tf32", "bf16")
KERNELS = ("ffma", "dmma", "f64tc", "tc", "tc3", "tc1")   # Plan.kernel
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
# csrc/ladder_mm_f32tc.cu: its instances' rows of A per block (wgmma's N;
# 'tc1' is built at 104 only), B's rows per block (kBN) and K per chunk;
# at most F32TC_MAX_GROUPS row groups of A and F32TC_MAX_CLUSTER blocks
# per cluster
F32TC_WIDTHS = {"tc3": (104, 152), "tc1": (104,)}
F32TC_BN, F32TC_BK = 128, 32
F32TC_MAX_GROUPS = 8
F32TC_MAX_CLUSTER = 16
# csrc/ladder_mm_f64tc.cu: rows of A and of B per block, K per chunk
F64TC_TILE = (104, 128, 16)
# row strides the TMA loads take: multiples of 16 bytes
TF32_ROW_ALIGN, BF16_ROW_ALIGN, F64_ROW_ALIGN = 4, 8, 2


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
    return v if v in VARIANTS else variant(v)


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
                              # by TMA multicast (the TMA kernels)
    kernel: str = "ffma"      # the kernel that runs it (KERNELS)

    @property
    def tiles(self):
        return self.m_tiles * self.n_tiles

    @property
    def blocks(self):
        return self.tiles * self.split


def _cdiv(x, y):
    return -(-x // y)


def _k_ranges(K, bk, split):
    chunks = _cdiv(K, bk)
    bounds = [s * chunks // split * bk for s in range(split)] + [K]
    return tuple((bounds[s], min(bounds[s + 1], K)) for s in range(split))


def tc3_rule(M, N, K):
    """The 'f32' shapes that take the three-pass kernel 'tc3' (else
    'ffma'): K from TC3_MIN_K to TC3_MAX_K and at most F32TC_MAX_GROUPS
    row groups of A.  In that window 'tc3' beat the FFMA kernel in turn at
    every shape timed, 1.7-3.4x (chip_smoke.py --kernel-times and
    tools/f32tc_splits.py on an H100 SXM; PERF.md section 6): the sector
    GEMMs of cc-pVTZ (98 x {3240, 6561}^2), of the flagship basis (98 x
    {2211, 4489}^2) and of their lambda lanes and mesh ranks, and the
    dense ladder from nvir 46 (196 x 3844^2 at cc-pVDZ).  Below it the
    FFMA kernel is kept: at 98 x {465, 961}^2 it is as fast or faster;
    above it, the packed operands of cc-pVTZ and the flagship basis (K =
    13041, 8911), the three-pass sum is unchecked."""
    return M <= F32TC_MAX_GROUPS * max(F32TC_WIDTHS["tc3"]) and (
        TC3_MIN_K <= K <= TC3_MAX_K)


def tc1_rule(M, N, K):
    """The 'tf32' shapes that take the one-pass instance 'tc1' (else 'tc',
    csrc/ladder_mm_tc.cu): one row group of A (M <= 104, the sector
    GEMMs) and K in tc3_rule's window, where it beat ladder_mm_tc.cu's
    TF32 kernel in turn (98 x {2211, 3240, 4489}^2 by 1.1-1.4x, 6561^2
    even)."""
    return M <= F32TC_WIDTHS["tc1"][0] and TC3_MIN_K <= K <= TC3_MAX_K


# the K window of the rules above
TC3_MIN_K, TC3_MAX_K = 2048, 8192


def f64tc_rule(M, N, K):
    """The 'f64' shapes that take csrc/ladder_mm_f64tc.cu ('f64tc'; else
    'dmma'): K of at least F64TC_MIN_K.  There it beat the 'dmma' kernel
    in turn at every f64 shape a path runs (tools/f64tc_splits.py on an
    H100 SXM at 700 W, us): 392 x 13041^2 3175 against 5283 (ECW's f64
    route at cc-pVTZ), 196 x 26244^2 6627 against 11246 (the cc-pVTZ
    polish), 196 x 3844^2 146 against 237, 392 x 1891^2 80 against 125
    (cc-pVDZ), 196 x 13041^2 1601 against 2877, 196 x 1891^2 46 against
    68, 14 x 1891^2 29 against 32 (the EOM sigmas); below it 'dmma' is
    faster: 196 x 900^2 21 against 26 (6-31G), 98 x {465, 961}^2 8 and
    16 against 13 and 18 (the sorted sectors)."""
    return K >= F64TC_MIN_K


F64TC_MIN_K = 1024


def kernel_for(M, N, K, v):
    """The kernel `plan` names for variant v at C (M, N) = A (M, K) @
    B (N, K).T."""
    if v == "f32":
        return "tc3" if tc3_rule(M, N, K) else "ffma"
    if v == "tf32":
        return "tc1" if tc1_rule(M, N, K) else "tc"
    if v == "f64":
        return "f64tc" if f64tc_rule(M, N, K) else "dmma"
    return "tc"


@functools.lru_cache(maxsize=256)
def plan(M, N, K, dtype, n_sm, kernel=None):
    """The launch of C (M, N) = A (M, K) @ B (N, K).T on a card of `n_sm` SMs;
    `dtype` is a variant name or the operands' dtype (its full-precision
    variant); `kernel` one of KERNELS that runs the variant, or None for
    `kernel_for`'s (tc3_rule, tc1_rule, f64tc_rule).

    'ffma' and 'dmma': the output is cut into BM x bn tiles, bn the widest
    of WIDTHS[variant] whose tiles can still fill the card; K into BK
    chunks, dealt to `split` blocks per tile (one cluster) as evenly as
    whole chunks allow: split s takes chunks [s * chunks // split, (s+1) *
    chunks // split).  The split is the smallest power of two, at most
    MAX_SPLIT and the chunk count, that gives at least one full wave of
    n_sm blocks, or the largest there is.  Powers of two because clusters
    of 9 to 15 blocks ran slower on an H100 than clusters of 8 or 16 at
    the same shapes.  'tc': `_plan_tc`; 'tc3' and 'tc1': `_plan_f32tc`;
    'f64tc': `_plan_f64tc`."""
    v = _as_variant(dtype)
    if min(M, N) < 1 or K < 0 or n_sm < 1:
        raise ValueError(f"ladder_mm cannot plan M={M}, N={N}, K={K} on "
                         f"{n_sm} SMs")
    kernel = kernel or kernel_for(M, N, K, v)
    if (kernel, v) not in _FUNCS:
        raise ValueError(f"no {kernel!r} kernel runs the {v!r} variant")
    if kernel == "tc":
        return _plan_tc(M, N, K, v, n_sm)
    if kernel in ("tc3", "tc1"):
        return _plan_f32tc(M, N, K, kernel, n_sm)
    if kernel == "f64tc":
        return _plan_f64tc(M, N, K, n_sm)
    m_tiles, chunks = _cdiv(M, BM), _cdiv(K, BK)
    splits = [s for s in (1, 2, 4, 8, 16) if s <= max(1, min(chunks, MAX_SPLIT))]
    for bn in WIDTHS[v]:
        tiles = m_tiles * _cdiv(N, bn)
        if tiles * splits[-1] >= n_sm:
            break
    split = next((s for s in splits if tiles * s >= n_sm), splits[-1])
    partials = split * tiles * BM * bn if split > 1 else 0
    return Plan(BM, bn, BK, m_tiles, tiles // m_tiles, split,
                _k_ranges(K, BK, split), partials, 1, kernel)


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
    partials = split * tiles * bm * bn if split > 1 else 0
    return Plan(bm, bn, bk, m_tiles, n_tiles, split, _k_ranges(K, bk, split),
                partials, cm, "tc")


def _plan_f32tc(M, N, K, kernel, n_sm):
    """csrc/ladder_mm_f32tc.cu's plan (both instances): B in tiles of 128
    rows; A in cm row groups of bm rows, bm the width of
    F32TC_WIDTHS[kernel] that pads M the least (then the fewer groups:
    104 for 98 rows a lambda lane, 152 for 294), cm = ceil(M / bm) <=
    F32TC_MAX_GROUPS; the cm blocks of one B tile one cluster that shares
    it by multicast; K in chunks of 32, split by `_f32tc_split`."""
    fits = [w for w in F32TC_WIDTHS[kernel] if _cdiv(M, w) <= F32TC_MAX_GROUPS]
    if not fits:
        raise ValueError(f"the {kernel!r} kernel takes at most "
                         f"{F32TC_MAX_GROUPS * max(F32TC_WIDTHS[kernel])} "
                         f"rows of A (got {M})")
    bm = min(fits, key=lambda w: (_cdiv(M, w) * w, _cdiv(M, w)))
    bn, bk = F32TC_BN, F32TC_BK
    cm = _cdiv(M, bm)
    n_tiles, chunks = _cdiv(N, bn), _cdiv(K, bk)
    split = _f32tc_split(cm, cm * n_tiles, chunks, n_sm)
    partials = split * cm * n_tiles * bm * bn if split > 1 else 0
    return Plan(bm, bn, bk, cm, n_tiles, split, _k_ranges(K, bk, split),
                partials, cm, kernel)


def _f32tc_split(cm, tiles, chunks, n_sm):
    """The split of K for csrc/ladder_mm_f32tc.cu: the largest power of two
    s that keeps the launch within one wave (tiles * s <= n_sm blocks, one
    block an SM), with at least F32TC_MIN_CHUNKS chunks a block and a
    cluster cm * s of at most 8 blocks (16 with one row group); 1 where
    the tiles alone fill the card.  A second wave ran slower than the
    first with half the K each: on an H100 (tools/f32tc_splits.py, in
    turn) 98 x 6561^2 took 128 us at split 2 (104 blocks) and 142 us at 4
    (208), 98 x 3240^2 43 us at 4 (104) and 51 us at 8; clusters of 16
    blocks with two row groups, and splits of under 3 chunks a block, were
    slower too."""
    limit = 16 if cm == 1 else 8
    splits = [s for s in (1, 2, 4, 8, 16)
              if cm * s <= limit and (s == 1 or chunks >= F32TC_MIN_CHUNKS * s)]
    return max(s for s in splits if s == 1 or tiles * s <= n_sm)


F32TC_MIN_CHUNKS = 3


def _plan_f64tc(M, N, K, n_sm):
    """csrc/ladder_mm_f64tc.cu's plan: 104 x 128 output tiles, K in chunks
    of 16 split over the blocks of a cluster (`_f64tc_split`); the row
    tiles of one B tile are neighbours in the grid and share no
    cluster."""
    bm, bn, bk = F64TC_TILE
    m_tiles, n_tiles, chunks = _cdiv(M, bm), _cdiv(N, bn), _cdiv(K, bk)
    split = _f64tc_split(m_tiles * n_tiles, chunks, n_sm)
    partials = split * m_tiles * n_tiles * bm * bn if split > 1 else 0
    return Plan(bm, bn, bk, m_tiles, n_tiles, split, _k_ranges(K, bk, split),
                partials, 1, "f64tc")


def _f64tc_split(tiles, chunks, n_sm):
    """The split s of K (a power of two up to 16, at most the chunk count)
    that minimizes the kernel's time in the model that measured it: one
    block an SM, so ceil(tiles * s / slots(s)) waves of blocks, each
    block's time its chunks / s plus F64TC_SPLIT_CHUNKS for the split's
    fixed costs (the partials' sum, the pipeline's fill and drain);
    slots(s) the blocks that clusters of s hold at once (F64TC_SLOTS, read
    by cudaOccupancyMaxActiveClusters on an H100 SXM; elsewhere whole
    clusters of n_sm).  The smallest s of the least time.  It picked the
    fastest split at every f64 path shape timed (tools/f64tc_splits.py):
    2 at 392 x 13041^2, 196 x 26244^2, 196 x 3844^2 and 392 x 1891^2
    (408, 412, 62 and 60 tiles), 4 at 196 x 13041^2 and 196 x 1891^2, 8
    at 14 x 1891^2."""
    slots = F64TC_SLOTS.get(n_sm, {})

    def cost(s):
        waves = _cdiv(tiles * s, slots.get(s, n_sm // s * s))
        return waves * (chunks / s + F64TC_SPLIT_CHUNKS)
    return min((s for s in (1, 2, 4, 8, 16) if s <= max(1, chunks)),
               key=cost)


# {SMs: {split: blocks of the kernel the card holds at once in clusters of
# split}}: an H100 SXM holds 132, 66, 30, 15 and 7 clusters of 1, 2, 4, 8
# and 16 (cudaOccupancyMaxActiveClusters, tools/f64tc_splits.py)
F64TC_SLOTS = {132: {1: 132, 2: 132, 4: 120, 8: 120, 16: 112}}
# a split block's fixed costs in chunk times: about 10 us against 1.09 us
# a chunk (the 104 x 128 x 16 DMMA work of a block) on an H100 SXM
F64TC_SPLIT_CHUNKS = 10


@functools.cache
def _n_sm(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(M, N, K, dtype, device, kernel=None):
    """`plan` for the CUDA device `device`, with its SM count read from it."""
    return plan(M, N, K, dtype, _n_sm(device.index), kernel)


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


def split_tf32(x):
    """float32 x as (hi, lo), x = hi + lo + O(2^-22 |x|): hi = round_tf32(x),
    lo = round_tf32(x - hi), or 0 where x - hi is not finite (x Inf or NaN,
    or hi rounded to Inf), as csrc/ladder_mm_f32tc.cu splits.  A NaN in an
    operand gives a NaN in C; an Inf an Inf, or a NaN where a cross term
    is Inf x 0."""
    hi = round_tf32(x)
    d = x - hi
    return hi, torch.where(torch.isfinite(d), round_tf32(d),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def ladder_mm_plain_split(a, b, passes=3):
    """Plain version of csrc/ladder_mm_f32tc.cu's arithmetic on float32
    operands: each split by split_tf32, then passes=3 the three products
    lo_a hi_b + hi_a lo_b + hi_a hi_b at full f32 precision, summed;
    passes=1 round_tf32(a) @ round_tf32(b).T (the 'tf32' variant's plain
    version)."""
    if passes not in (1, 3):
        raise ValueError(f"ladder_mm_plain_split takes 1 or 3 passes "
                         f"(got {passes})")
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    with matmul_precision("highest"):
        if passes == 1:
            return ah @ bh.T
        return (al @ bh.T + ah @ bl.T) + ah @ bh.T


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
    # rows contiguous along K; the row stride is passed to the kernel
    if a.shape[1] > 1 and (a.stride(1) != 1 or b.stride(1) != 1):
        raise ValueError("ladder_mm takes operands contiguous along K")
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


def f32_rows(x):
    """x (2-D) as float32 with a row stride the TMA kernels take: x itself
    where it has one, else a copy (cast on the way, values unchanged) into
    zero-filled rows padded to a multiple of TF32_ROW_ALIGN floats,
    returned as a view of its first x.shape[1] columns.  The unrounded
    twin of tf32_rows: the solver's f32 ladder operand (models/eris.py,
    ops/ladder.py _cast), which every f32 kernel reads as it is."""
    if x.dtype == torch.float32 and _has_rows(x, TF32_ROW_ALIGN):
        return x
    return _padded(x, torch.float32, TF32_ROW_ALIGN)


def f64_rows(x):
    """x (2-D) as float64 with a row stride the TMA kernels take: x itself
    where it has one, else a copy (cast on the way, values unchanged) into
    zero-filled rows padded to a multiple of F64_ROW_ALIGN doubles,
    returned as a view of its first x.shape[1] columns.  The solver's f64
    ladder operands (ops/ladder.py _cast, pack_vvvv, models/eris.py), which
    csrc/ladder_mm_f64tc.cu reads as they are."""
    if x.dtype == torch.float64 and _has_rows(x, F64_ROW_ALIGN):
        return x
    return _padded(x, torch.float64, F64_ROW_ALIGN)


def tma_rows(x):
    """x (2-D) in the 16-byte rows its dtype's TMA kernels take (row_align):
    x itself where it has them or where no kernel loads its dtype by TMA,
    else a padded copy."""
    align = row_align(x.dtype)
    return x if _has_rows(x, align) else _padded(x, x.dtype, align)


def row_align(dtype):
    """The elements of a 16-byte row of `dtype` (1 where no TMA kernel
    loads it)."""
    return {torch.float32: TF32_ROW_ALIGN, torch.float64: F64_ROW_ALIGN,
            torch.bfloat16: BF16_ROW_ALIGN}.get(dtype, 1)


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


def _launch(a, b, backward=False, precision=None, tangent=False,
            kernel=None):
    """One launch of the kernel that the plan names (or `kernel`) on checked
    CUDA operands: C = a @ b.T.  backward, tangent: the launch computes a
    gradient or a tangent (counted as such); backward="second": the
    backward of a backward launch (a double backward), whose product is a
    tangent and is counted as one."""
    v = variant(a.dtype, precision)
    _check(a, b, v)
    M, K = a.shape
    N = b.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    p = device_plan(M, N, K, v, a.device, kernel)
    key, name = _FUNCS[(p.kernel, v)]
    fn = getattr(build.library().cdll, name)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    head = ()
    if p.kernel == "tc":
        a, b, round_b = _tc_operands(a, b, v)
        tail = (p.cluster_m, p.split, round_b)
    elif p.kernel in ("tc3", "tc1"):
        # B in 16-byte rows for TMA (split or rounded in the kernel); A's
        # hi and lo written by the launch's split pass into the scratch
        b = _counted_rows(b, "b_copies")
        scratch = torch.empty(
            (2 if p.kernel == "tc3" else 1, M,
             _cdiv(K, TF32_ROW_ALIGN) * TF32_ROW_ALIGN), dtype=torch.float32,
            device=a.device)
        head = (scratch.data_ptr(),)
        tail = (p.cluster_m, p.split)
    else:
        if p.kernel == "f64tc":
            a, b = _counted_rows(a, "a_copies"), _counted_rows(b, "b_copies")
        tail = (p.split,)
    # row strides (no row is read at K = 0)
    lds = (a.stride(0), b.stride(0)) if K else (max(K, 1),) * 2
    err = fn(a.device.index, a.data_ptr(), b.data_ptr(), c.data_ptr(),
             *head, M, N, K, *lds, p.bm, p.bn, p.bk, *tail, stream)
    if err != 0:
        raise RuntimeError(f"ladder_mm {v} kernel {p.kernel!r} launch "
                           f"failed: cudaError {err}")
    ladder_mm.launches += 1
    ladder_mm.backward_launches += backward is True
    ladder_mm.tangent_launches += bool(tangent) or backward == "second"
    ladder_mm.launches_by_variant[v] += 1
    ladder_mm.launches_by_kernel[key] += 1
    return c


def _counted_rows(x, counter):
    """An operand with the 16-byte rows of the TMA loads of
    csrc/ladder_mm_f32tc.cu (B) and ladder_mm_f64tc.cu (A and B): x itself,
    or a padded copy (counted in ladder_mm.<counter>)."""
    y = tma_rows(x)
    if y is not x:
        setattr(ladder_mm, counter, getattr(ladder_mm, counter) + 1)
    return y


def _tc_operands(a, b, v):
    """(a, b, round_b) for a csrc/ladder_mm_tc.cu launch: operands with
    16-byte rows (a copy only of one that lacks them) and round_b = 1
    where the TF32 kernel must round B itself: a B with such rows that
    `tf32_rows` did not make (the dense route's view of the whole vvvv
    block, which no call copies).  A is always rounded by the kernel."""
    if v == "bf16":
        if not _has_rows(b, BF16_ROW_ALIGN):
            ladder_mm.b_copies += 1
        return bf16_rows(a), bf16_rows(b), 0
    if not _has_rows(a, TF32_ROW_ALIGN):
        a = _padded(a, torch.float32, TF32_ROW_ALIGN)
    if is_tf32_rows(b):
        return a, b, 0
    if _has_rows(b, TF32_ROW_ALIGN):
        return a, b, 1
    ladder_mm.b_copies += 1
    return a, tf32_rows(b), 0


def launch_kernel(a, b, kernel, precision=None):
    """One launch of `kernel` (KERNELS) on CUDA operands, its plan at this
    shape with the kernel fixed: the card's checks and timings of a kernel
    at a shape its rule does not route to it.  Counted as a forward
    launch; no gradient."""
    return _launch(a, b, precision=precision, kernel=kernel)


class _LadderMM(torch.autograd.Function):
    """The launch with its gradient and its tangent for `a`.  forward and
    setup_context are separate so that the function also runs under
    torch.func transforms, which hand forward the plain tensors behind
    their wrappers (the launch reads data_ptr()).  backward: False for a
    forward product, True where this launch is part of a backward pass,
    "tangent" where it computes a tangent, "second" where it is the
    backward of a backward launch."""

    @staticmethod
    def forward(a, b, symmetric, backward):
        if backward == "tangent":
            return _launch(a, b, tangent=True)
        return _launch(a, b, backward)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, b, symmetric, backward = inputs
        ctx.save_for_backward(b)
        ctx.save_for_forward(b)
        ctx.symmetric = symmetric
        ctx.kind = backward
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
        # the backward of a backward product (a double backward) is a
        # tangent: d(dC @ B)/d(dC) applied to a direction
        K = b.shape[1]
        kind = "second" if ctx.kind is True else True
        if ctx.symmetric:
            da = _LadderMM.apply(dc[:, :K].contiguous(), b, True, kind)
            da = da[:, :K] if b.shape[0] != K else da
        else:
            da = _LadderMM.apply(dc.contiguous(), b.T.contiguous(), False,
                                 kind)
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
ladder_mm.b_copies = 0             # launches that copied B into TMA rows
ladder_mm.a_copies = 0             # f64tc launches that copied A into them
ladder_mm.launches_by_variant = dict.fromkeys(VARIANTS, 0)
# by kernel function: ladder_mm_tc.cu's TF32 and BF16 apart
ladder_mm.launches_by_kernel = dict.fromkeys(
    (key for key, _ in _FUNCS.values()), 0)

_COUNTERS = ("launches", "backward_launches", "tangent_launches",
             "shard_launches", "b_copies", "a_copies")


def launch_counts(since=None):
    """The launch counters as a dict (the variants' and the kernels'
    under their names), or their change since an earlier such dict."""
    now = {n: getattr(ladder_mm, n) for n in _COUNTERS}
    now.update(ladder_mm.launches_by_variant)
    now.update(ladder_mm.launches_by_kernel)
    if since is None:
        return now
    return {n: v - since.get(n, 0) for n, v in now.items()}


def add_launch_counts(delta, times=1):
    """Add `times` x a change of the counters (launch_counts(since=)):
    the launches that a replayed CUDA graph makes without passing through
    the wrapper (solvers/device_loop.py)."""
    for n, v in delta.items():
        if n in ladder_mm.launches_by_variant:
            ladder_mm.launches_by_variant[n] += times * v
        elif n in ladder_mm.launches_by_kernel:
            ladder_mm.launches_by_kernel[n] += times * v
        else:
            setattr(ladder_mm, n, getattr(ladder_mm, n) + times * v)
