"""The split-K planner of the ladder GEMM kernel (ecw_cc_torch.kernels.
ladder_mm.plan), on the CPU: the plan is pure Python, and the kernel only
checks the tile it is handed and recomputes the same K ranges."""

import types

import numpy as np
import pytest
import torch

from ecw_cc_torch.kernels import build
from ecw_cc_torch.kernels import ladder_mm as lmm

DTYPES = [torch.float32, torch.float64]
# every kernel variant: f32, f64, and the tensor-core TF32 and BF16 ones
VARIANTS = DTYPES + ["tf32", torch.bfloat16]
MAIN = [(98, 465, 465), (98, 961, 961)]
# C2H2 (nocc 14) on the dense, packed and stacked-sectored routes: the dense
# ladder at cc-pVDZ (nvir 62), the stacked packed GEMM at cc-pVDZ and
# cc-pVTZ (nvir 162), the stacked sector GEMMs at cc-pVDZ
ROUTES = [(196, 3844, 3844), (392, 1891, 1891), (392, 13041, 13041),
          (392, 465, 465), (392, 961, 961)]
SHAPES = MAIN + ROUTES + [(1, 1, 1), (1, 961, 961), (129, 465, 465), (98, 465, 15),
                 (98, 465, 240), (98, 465, 241), (98, 465, 257),
                 (98, 961, 960), (37, 513, 129), (100, 130, 1001),
                 (4096, 4096, 64), (5, 3, 0)]
N_SM = 132   # NVIDIA H100 SXM


@pytest.mark.parametrize("dtype", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_k_ranges_tile_k(shape, dtype):
    M, N, K = shape
    p = lmm.plan(M, N, K, dtype, N_SM)
    assert len(p.k_ranges) == p.split >= 1
    assert p.k_ranges[0][0] == 0 and p.k_ranges[-1][1] == K
    for (_, k1), (k0, _) in zip(p.k_ranges, p.k_ranges[1:]):
        assert k1 == k0                      # no gap, no overlap
    for k0, k1 in p.k_ranges:
        assert k0 % p.bk == 0                # whole chunks per split
        assert k1 > k0 or K == 0             # no empty split
    assert p.m_tiles * p.bm >= M > (p.m_tiles - 1) * p.bm
    assert p.n_tiles * p.bn >= N > (p.n_tiles - 1) * p.bn


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MAIN)
def test_plan_fills_the_card_at_the_solver_shapes(shape, dtype):
    p = lmm.plan(*shape, dtype, N_SM)
    assert p.m_tiles == 1                   # B streams from memory once
    assert p.blocks >= N_SM
    assert 1 < p.split <= lmm.MAX_SPLIT     # one cluster per output tile
    assert p.bn in lmm.WIDTHS[lmm.variant(dtype)]


@pytest.mark.parametrize("dtype", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_partials_are_split_tiles_tile(shape, dtype):
    """A split tile leaves one partial tile per block in its cluster."""
    p = lmm.plan(*shape, dtype, N_SM)
    if p.split > 1:
        assert p.partials == p.split * p.tiles * p.bm * p.bn
    else:
        assert p.partials == 0
    assert p.blocks == p.tiles * p.split
    assert p.split in (1, 2, 4, 8, 16)


@pytest.mark.parametrize("dtype", VARIANTS)
@pytest.mark.parametrize("shape", ROUTES)
def test_plan_at_the_route_shapes(shape, dtype):
    """f32 and f64: two or four 112-row tiles; at least one wave of blocks,
    split only where the tiles alone do not fill the card.  TF32 and
    BF16: every 128-row tile of an N tile in one cluster, which takes each
    B tile by one multicast, so B streams from device memory once per
    launch; the split within the cluster's room."""
    M, N, K = shape
    p = lmm.plan(M, N, K, dtype, N_SM)
    v = lmm._as_variant(dtype)
    if p.kernel in ("tc3", "tc1"):
        # the dense ladder at cc-pVDZ lies in the three-pass kernel's K
        # window (tc3_rule): two 104-row groups of A share each B tile
        assert (v, shape) == ("f32", (196, 3844, 3844))
        assert (p.bm, p.cluster_m, p.m_tiles) == (104, 2, 2)
        assert p.cluster_m * p.split <= 8 and p.blocks <= N_SM
        return
    if p.kernel == "f64tc":
        # f64 from K = 1024 (f64tc_rule): 104-row tiles of A, no cluster of
        # row tiles, the split of the wave model (_f64tc_split)
        assert v == "f64" and K >= lmm.F64TC_MIN_K
        assert (p.bm, p.bn, p.bk, p.cluster_m) == lmm.F64TC_TILE + (1,)
        assert p.m_tiles == -(-M // 104) in (2, 4)
        assert p.split == 2 and p.blocks >= 120
        return
    if v in lmm.REDUCED:
        assert (p.bm, p.bn, p.bk) == lmm.TC_TILE[v]
        assert p.m_tiles == -(-M // p.bm) in (2, 4)
        assert p.cluster_m == p.m_tiles          # B from memory once
        assert p.cluster_m * p.split <= lmm.TC_MAX_CLUSTER
        assert (p.blocks >= N_SM
                or p.cluster_m * p.split == lmm.TC_MAX_CLUSTER)
        assert p.split == 1 or p.tiles * (p.split // 2) < N_SM
        if shape == (392, 13041, 13041):
            assert (p.tiles, p.split, p.blocks) == (408, 1, 408)
        return
    assert p.m_tiles == -(-M // lmm.BM) in (2, 4)
    assert p.blocks >= N_SM
    assert p.split == 1 or p.tiles * (p.split // 2) < N_SM
    if dtype == torch.float32 and shape == (196, 3844, 3844):
        assert (p.tiles, p.split) == (122, 2)
    if dtype == torch.float32 and shape == (392, 13041, 13041):
        assert (p.tiles, p.split) == (816, 1)


# (M, N, K) -> (m_tiles, cluster_m, split) of the tensor-core plan
TC_PLANS = {(98, 465, 465): (1, 1, 8), (98, 3240, 3240): (1, 1, 8),
            (98, 6561, 6561): (1, 1, 4), (196, 3844, 3844): (2, 2, 4),
            (392, 1891, 1891): (4, 4, 2), (64, 961, 961): (1, 1, 8),
            (65, 961, 961): (1, 1, 8), (129, 961, 961): (2, 2, 4),
            (384, 961, 961): (3, 1, 8), (768, 961, 961): (6, 2, 4),
            (4096, 4096, 64): (32, 8, 1), (98, 465, 31): (1, 1, 1),
            (98, 465, 33): (1, 1, 2), (1, 1, 0): (1, 1, 1)}


@pytest.mark.parametrize("var", ["tf32", torch.bfloat16])
@pytest.mark.parametrize("shape", list(TC_PLANS))
def test_plan_tensor_core_tile_and_cluster(shape, var):
    """The tensor-core tile: 128 x 128, one 128-byte row of K per chunk;
    the largest power-of-two cluster of row tiles that divides them (at
    most 8), then the smallest split that fills the card within the
    cluster's room of 8 blocks and the chunk count."""
    M, N, K = shape
    v = lmm._as_variant(var)
    p = lmm.plan(M, N, K, var, N_SM, "tc")      # csrc/ladder_mm_tc.cu's plan
    assert p.kernel == "tc"
    assert (p.bm, p.bn, p.bk) == (128, 128, 32 if v == "tf32" else 64)
    m_tiles, cm, split = TC_PLANS[shape]
    if v == "bf16" and shape == (98, 465, 33):
        split = 1                                # one 64-wide chunk
    assert (p.m_tiles, p.cluster_m, p.split) == (m_tiles, cm, split)
    assert p.m_tiles % p.cluster_m == 0
    assert p.n_tiles == -(-N // 128)
    assert p.blocks == p.m_tiles * p.n_tiles * p.split
    assert lmm.plan(M, N, K, torch.float32, N_SM, "ffma").cluster_m == 1


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 5, 7), (7, 1, 5),
                                   (7, 5, 1), (1, 1, 961), (1, 961, 1)])
def test_plan_degenerate_shapes(shape):
    M, N, K = shape
    p = lmm.plan(M, N, K, torch.float32, N_SM)
    assert p.m_tiles == 1 and p.n_tiles >= 1
    assert 1 <= p.split <= max(1, -(-K // p.bk))
    assert p.blocks == p.tiles * p.split
    assert p.k_ranges[0][0] == 0 and p.k_ranges[-1][1] == K


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        lmm.plan(98, 465, 465, torch.float16, N_SM)
    with pytest.raises(ValueError):
        lmm.plan(0, 465, 465, torch.float32, N_SM)


@pytest.mark.parametrize("shape", SHAPES[:-1])
def test_split_sum_in_plan_order_matches_plain(shape):
    """The kernel's arithmetic, emulated: each split's partial product over
    its K range, summed in split order 0..S-1, equals a @ b.T."""
    M, N, K = shape
    rng = np.random.default_rng(sum(shape))
    a = torch.tensor(rng.standard_normal((M, K)), dtype=torch.float64)
    b = torch.tensor(rng.standard_normal((N, K)), dtype=torch.float64)
    p = lmm.plan(M, N, K, torch.float64, N_SM)
    c = torch.zeros((M, N), dtype=torch.float64)
    for k0, k1 in p.k_ranges:
        c = c + a[:, k0:k1] @ b[:, k0:k1].T
    ref = lmm.ladder_mm_ref(a, b)
    assert float((c - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


# ---- the kernel each plan names (PR: the three-pass TF32 kernel) --------

# f32 shapes that chip_smoke.py routes to the three-pass kernel 'tc3': the
# sector GEMMs of cc-pVTZ and the flagship basis, their three lambda lanes
# (294 rows), a mesh rank's rows at tp = 4, and the dense ladder at
# cc-pVDZ (inside the K window)
TC3 = [(98, 2211, 2211), (98, 3240, 3240), (98, 4489, 4489),
       (98, 6561, 6561), (294, 3240, 3240), (294, 6561, 6561),
       (98, 810, 3240), (98, 1641, 6561), (196, 3844, 3844)]
# ... and those it keeps on the FFMA kernel: the cc-pVDZ sector shapes and
# their lanes, the packed route's products, the dense one at 6-31G, the
# EOM sigmas, the 3- and 8-lane packed and stacked-sector shapes
FFMA_F32 = [(98, 465, 465), (98, 961, 961), (196, 465, 465),
            (196, 961, 961), (294, 465, 465), (294, 961, 961),
            (784, 465, 465), (784, 961, 961), (392, 465, 465),
            (392, 961, 961), (392, 1891, 1891), (392, 13041, 13041),
            (392, 8911, 8911), (196, 1891, 1891), (196, 13041, 13041),
            (196, 900, 900), (14, 1891, 1891), (1176, 1891, 1891),
            (3136, 1891, 1891), (1176, 13041, 13041), (1176, 465, 465),
            (1176, 961, 961), (392, 6521, 13041)]
# the cc-pVTZ, flagship and lane shapes of ECW's main path: (bm, cm, split)
MAIN_TC3 = {(98, 2211, 2211): (104, 1, 4), (98, 3240, 3240): (104, 1, 4),
            (98, 4489, 4489): (104, 1, 2), (98, 6561, 6561): (104, 1, 2),
            (294, 3240, 3240): (152, 2, 2), (294, 6561, 6561): (152, 2, 1)}
F32TC_EDGES = [(1, 1, 1), (37, 513, 129), (100, 130, 1001), (98, 465, 31),
               (98, 465, 33), (105, 129, 8191), (211, 300, 8193),
               (832, 961, 961), (1216, 465, 465), (5, 3, 0)]


@pytest.mark.parametrize("shape", TC3 + FFMA_F32)
def test_plan_names_the_f32_kernel(shape):
    p = lmm.plan(*shape, torch.float32, N_SM)
    assert p.kernel == ("tc3" if shape in TC3 else "ffma")
    assert (p.kernel == "tc3") == lmm.tc3_rule(*shape)
    if p.kernel == "ffma":
        assert (p.bm, p.bk, p.cluster_m) == (lmm.BM, lmm.BK, 1)


@pytest.mark.parametrize("shape", TC3 + FFMA_F32)
def test_plan_keeps_dmma_for_f64_and_tc_for_bf16(shape):
    """f64 takes the f64tc kernel where f64tc_rule names it (K >= 1024)
    and 'dmma' elsewhere; bf16 ladder_mm_tc.cu's kernel."""
    M, N, K = shape
    f64 = lmm.plan(*shape, torch.float64, N_SM).kernel
    assert f64 == ("f64tc" if lmm.f64tc_rule(*shape) else "dmma")
    assert (f64 == "f64tc") == (K >= 1024)
    assert lmm.plan(*shape, torch.bfloat16, N_SM).kernel == "tc"
    tf32 = lmm.plan(*shape, "tf32", N_SM).kernel
    assert tf32 == ("tc1" if shape in TC3 and shape[0] <= 104 else "tc")


@pytest.mark.parametrize("kernel", ["tc3", "tc1"])
@pytest.mark.parametrize("shape", TC3 + FFMA_F32[:12] + F32TC_EDGES)
def test_f32tc_plan_tiles_k_and_groups_a(shape, kernel):
    """csrc/ladder_mm_f32tc.cu's plan at any shape it takes: K ranges that
    tile K in whole 32-deep chunks, no split empty; A in cm groups of bm
    rows (104, or 152 for three passes) that cover M; the cluster of cm
    row groups times split at most 8 blocks (16 with one group)."""
    M, N, K = shape
    if kernel == "tc1" and M > 8 * 104:
        return
    p = lmm.plan(M, N, K, "f32" if kernel == "tc3" else "tf32", N_SM, kernel)
    assert p.kernel == kernel and (p.bn, p.bk) == (128, 32)
    assert p.bm in lmm.F32TC_WIDTHS[kernel]
    assert p.m_tiles == p.cluster_m == -(-M // p.bm) <= lmm.F32TC_MAX_GROUPS
    assert p.n_tiles == -(-N // 128)
    assert p.cluster_m * p.split <= (16 if p.cluster_m == 1 else 8)
    assert p.cluster_m * p.split <= lmm.F32TC_MAX_CLUSTER
    assert len(p.k_ranges) == p.split
    assert p.k_ranges[0][0] == 0 and p.k_ranges[-1][1] == K
    for (_, k1), (k0, _) in zip(p.k_ranges, p.k_ranges[1:]):
        assert k1 == k0 and k0 % 32 == 0
    assert all(k1 > k0 for k0, k1 in p.k_ranges) or K == 0
    assert p.blocks == p.m_tiles * p.n_tiles * p.split
    assert p.partials == (p.blocks * p.bm * p.bn if p.split > 1 else 0)


@pytest.mark.parametrize("shape", list(MAIN_TC3))
def test_f32tc_plan_is_one_wave_at_the_main_shapes(shape):
    """At the cc-pVTZ, flagship and lane shapes the split is the largest
    power of two that keeps the launch in one wave of at most 132 blocks
    (on an H100 a second wave with half the K a block ran slower: 98 x
    6561^2 128 us at 104 blocks against 142 us at 208), and at least 72
    blocks run."""
    M, N, K = shape
    p = lmm.plan(M, N, K, torch.float32, N_SM)
    assert (p.kernel, p.bm, p.cluster_m, p.split) == ("tc3",) + MAIN_TC3[shape]
    assert 72 <= p.blocks <= N_SM
    assert (p.blocks * 2 > N_SM
            or p.cluster_m * p.split * 2 > (16 if p.cluster_m == 1 else 8))


def test_f32tc_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        lmm.plan(8 * 152 + 1, 465, 465, torch.float32, N_SM, "tc3")
    with pytest.raises(ValueError):
        lmm.plan(8 * 104 + 1, 465, 465, "tf32", N_SM, "tc1")
    with pytest.raises(ValueError):
        lmm.plan(98, 465, 465, torch.float32, N_SM, "tc1")   # tc1 is TF32
    with pytest.raises(ValueError):
        lmm.plan(98, 465, 465, torch.float64, N_SM, "tc3")


def test_launch_counts_carry_the_kernels():
    """launch_counts names each kernel beside each variant, and
    add_launch_counts (a replayed graph's launches) adds to both."""
    before = lmm.launch_counts()
    assert {"ffma", "dmma", "f64tc", "tc_tf32", "tc_bf16", "tc3", "tc1",
            "b_copies", "a_copies"} <= set(before)
    delta = dict.fromkeys(before, 0)
    delta.update(launches=2, f32=2, tc3=1, ffma=1)
    try:
        lmm.add_launch_counts(delta, times=3)
        after = lmm.launch_counts(since=before)
        assert (after["tc3"], after["ffma"], after["f32"],
                after["launches"]) == (3, 3, 6, 6)
    finally:
        lmm.add_launch_counts(delta, times=-3)
    assert lmm.launch_counts() == before


# ---- the f64 kernel each plan names (csrc/ladder_mm_f64tc.cu) ------------

# the f64 path shapes: (kernel, split) of their plan on an H100 SXM, the
# split the fastest one timed (tools/f64tc_splits.py)
F64_PATH = {(392, 13041, 13041): ("f64tc", 2),   # ECW's f64 route, cc-pVTZ
            (196, 26244, 26244): ("f64tc", 2),   # the cc-pVTZ f64 polish
            (196, 3844, 3844): ("f64tc", 2),     # dense / polish, cc-pVDZ
            (392, 1891, 1891): ("f64tc", 2),     # ECW's f64 route, cc-pVDZ
            (196, 13041, 13041): ("f64tc", 4),   # packed target, cc-pVTZ
            (196, 1891, 1891): ("f64tc", 4),     # f64 EOM-EE sigma
            (14, 1891, 1891): ("f64tc", 8),      # f64 EOM-EA sigma
            (196, 900, 900): ("dmma", 4),        # 6-31G dense (10b, 13b)
            (98, 465, 465): ("dmma", 16),        # sorted sectors, cc-pVDZ
            (98, 961, 961): ("dmma", 8)}
F64TC_EDGES = [(1, 1, 1), (1, 1891, 1891), (98, 465, 15), (98, 465, 17),
               (98, 465, 0), (37, 513, 129), (105, 129, 1891),
               (832, 300, 257), (1176, 13041, 13041), (392, 1891, 1889)]


@pytest.mark.parametrize("shape", list(F64_PATH))
def test_f64_plan_names_the_kernel_of_each_path_shape(shape):
    kernel, split = F64_PATH[shape]
    p = lmm.plan(*shape, torch.float64, N_SM)
    assert p.kernel == kernel == ("f64tc" if lmm.f64tc_rule(*shape)
                                  else "dmma")
    if kernel == "f64tc":
        assert p.split == split


@pytest.mark.parametrize("shape", list(F64_PATH) + F64TC_EDGES)
def test_f64tc_plan_tiles_k_and_covers_c(shape):
    """The f64tc plan at any shape: 104 x 128 tiles covering C, no cluster
    of row tiles, K in whole 16-deep chunks over at most 16 split blocks
    (each one chunk at least), the blocks tiles x split."""
    M, N, K = shape
    p = lmm.plan(M, N, K, torch.float64, N_SM, "f64tc")
    assert p.kernel == "f64tc" and (p.bm, p.bn, p.bk) == (104, 128, 16)
    assert p.cluster_m == 1
    assert p.m_tiles == -(-M // 104) and p.n_tiles == -(-N // 128)
    assert p.split in (1, 2, 4, 8, 16)
    assert p.split <= max(1, -(-K // 16))
    assert len(p.k_ranges) == p.split
    assert p.k_ranges[0][0] == 0 and p.k_ranges[-1][1] == K
    for (_, k1), (k0, _) in zip(p.k_ranges, p.k_ranges[1:]):
        assert k1 == k0 and k0 % 16 == 0
    assert all(k1 > k0 for k0, k1 in p.k_ranges) or K == 0
    assert p.blocks == p.m_tiles * p.n_tiles * p.split
    assert p.partials == (p.blocks * p.bm * p.bn if p.split > 1 else 0)


@pytest.mark.parametrize("shape", [(392, 13041, 13041), (196, 26244, 26244),
                                   (196, 13041, 13041)])
def test_f64tc_plan_fills_whole_waves_at_the_large_shapes(shape):
    """At the cc-pVTZ shapes the tiles alone (408, 412, 204 blocks) leave
    a last wave mostly idle on 132 SMs; the split fills its waves to at
    least 85% of the blocks that its clusters can hold at once."""
    M, N, K = shape
    p = lmm.plan(M, N, K, torch.float64, N_SM)
    slots = lmm.F64TC_SLOTS[N_SM][p.split]
    waves = -(-p.blocks // slots)
    assert p.split > 1 and p.blocks / (waves * slots) >= 0.85
    assert (p.tiles / (-(-p.tiles // N_SM) * N_SM)) < 0.8


@pytest.mark.parametrize("n_sm", [132, 114, 78])
def test_f64tc_split_model_picks_the_least_modelled_time(n_sm):
    """_f64tc_split's split minimizes waves x (chunks / s + the split's
    fixed cost), the smallest s among equals, on any SM count."""
    for tiles, chunks in ((408, 816), (62, 241), (15, 119), (4, 30),
                          (1, 1), (7, 0)):
        s = lmm._f64tc_split(tiles, chunks, n_sm)
        slots = lmm.F64TC_SLOTS.get(n_sm, {})

        def cost(x):
            return -(-tiles * x // slots.get(x, n_sm // x * x)) * (
                chunks / x + lmm.F64TC_SPLIT_CHUNKS)
        allowed = [x for x in (1, 2, 4, 8, 16) if x <= max(1, chunks)]
        assert s in allowed
        assert cost(s) == min(cost(x) for x in allowed)
        assert all(cost(x) > cost(s) for x in allowed if x < s)


def test_f64tc_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        lmm.plan(98, 465, 465, torch.float32, N_SM, "f64tc")   # f64 only
    with pytest.raises(ValueError):
        lmm.plan(98, 465, 465, "tf32", N_SM, "f64tc")
    with pytest.raises(ValueError):
        lmm.plan(0, 465, 465, torch.float64, N_SM, "f64tc")
    with pytest.raises(ValueError):
        lmm.plan(98, 465, 465, torch.float64, N_SM, "tc3")


@pytest.mark.parametrize("kernel,dtype,precision", [
    ("f64tc", torch.float64, None), ("dmma", torch.float64, None),
    ("ffma", torch.float32, None), ("tc3", torch.float32, None),
    ("tc1", torch.float32, "tf32"), ("tc", torch.float32, "tf32"),
    ("tc", torch.bfloat16, None)])
def test_launch_passes_each_c_function_its_signature(monkeypatch, kernel,
                                                     dtype, precision):
    """_launch hands every kernel's C function exactly the arguments of its
    ctypes signature (kernels/build.py), the stream last: ctypes passes
    surplus arguments on unchecked, so a stale tail would reach the card
    as a stream handle.  The library, the device checks and the stream are
    stand-ins here."""
    calls = []

    class Cdll:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(build, "library",
                        lambda: build.Library(Cdll(), "", 0.0, ""))
    monkeypatch.setattr(lmm, "_check", lambda a, b, v: None)
    monkeypatch.setattr(lmm, "_n_sm", lambda index: N_SM)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=12345))
    a = torch.ones((196, 1891), dtype=dtype)
    b = torch.ones((1891, 1891), dtype=dtype)
    before = lmm.launch_counts()
    try:
        lmm._launch(a, b, precision=precision, kernel=kernel)
    finally:
        lmm.add_launch_counts(lmm.launch_counts(since=before), times=-1)
    (name, args), = calls
    assert name == lmm._FUNCS[(kernel, lmm.variant(dtype, precision))][1]
    assert len(args) == len(build._SIGNATURES[name])
    assert args[-1] == 12345
