"""The ladder kernels: the vvvv products of the CCSD and Lambda updates.

PATTERN matches, mangled or demangled, every kernel a ladder product
launches: the FFMA/DMMA kernel (ladder_mm_nt), the TF32/BF16 one-pass
kernels (ladder_mm_tc), the three-pass f32 kernel (ladder_mm_f32tc) and
its A-split pass (split_a), and the f64 tensor-core kernel
(ladder_mm_f64tc).  So a split pass's time counts against the ladder.

products(cfg) gives the work a sweep iteration needs, counted the same
whatever kernel does it: on the spin-sorted sectored route with the
closed-shell mirror (`sym`), one product per spin sector, alpha-alpha
(pairs a < b) and alpha-beta, each on the stacked t and lambda rows
(2 oa^2 rows).  A product M x N x K needs 2 M N K operations and reads A
(M x K) and B (N x K) and writes C (M x N) once.
"""

PATTERN = r"ladder_mm_(nt|tc|f32tc|f64tc)|split_a"

# NVIDIA H100 SXM data sheet, dense: TF32 tensor cores (f32 products are
# held to the tensor-core peak, which the three-pass kernel's passes run
# on) and HBM3 bandwidth
PEAK_FLOPS = {"float32": 495e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8}


def products(cfg):
    """[(M, N, K)] of one sweep iteration on the sectored `sym` route."""
    oa, va = cfg["nocc"] // 2, cfg["nvir"] // 2
    m = 2 * oa * oa
    return [(m, va * (va - 1) // 2, va * (va - 1) // 2), (m, va * va, va * va)]


def bound_s(M, N, K, dtype="float32"):
    """The least time of one product on the card: the larger of its
    operations over the peak and its bytes over the bandwidth."""
    ops = 2.0 * M * N * K
    nbytes = ITEMSIZE[dtype] * (M * K + N * K + M * N)
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
