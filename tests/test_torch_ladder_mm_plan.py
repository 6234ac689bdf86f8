"""The split-K planner of the ladder GEMM kernel (ecw_cc_torch.kernels.
ladder_mm.plan), on the CPU: the plan is pure Python, and the kernel only
checks the tile it is handed and recomputes the same K ranges."""

import numpy as np
import pytest
import torch

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
    p = lmm.plan(M, N, K, var, N_SM)
    assert (p.bm, p.bn, p.bk) == (128, 128, 32 if v == "tf32" else 64)
    m_tiles, cm, split = TC_PLANS[shape]
    if v == "bf16" and shape == (98, 465, 33):
        split = 1                                # one 64-wide chunk
    assert (p.m_tiles, p.cluster_m, p.split) == (m_tiles, cm, split)
    assert p.m_tiles % p.cluster_m == 0
    assert p.n_tiles == -(-N // 128)
    assert p.blocks == p.m_tiles * p.n_tiles * p.split
    assert lmm.plan(M, N, K, torch.float32, N_SM).cluster_m == 1


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
