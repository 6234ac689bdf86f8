"""The ladder family's work and bound against hand-worked numbers."""

import pytest

from ecwbench.spec import Spec

LADDER = Spec().kernel_families()["ladder"]


@pytest.mark.parametrize("cfg,shapes", [
    ({"nocc": 14, "nvir": 134}, [(98, 2211, 2211), (98, 4489, 4489)]),
    ({"nocc": 14, "nvir": 78}, [(98, 741, 741), (98, 1521, 1521)]),
])
def test_products_of_a_sweep_iteration(cfg, shapes):
    # oa = 7 occupied alpha orbitals: 2 * 7^2 stacked t and lambda rows;
    # va = 67 (39) virtual alpha orbitals: 67 * 66 / 2 = 2211 pairs a < b
    # (39 * 38 / 2 = 741) and 67^2 = 4489 (39^2 = 1521) alpha-beta columns
    assert LADDER.products(cfg) == shapes


# (M, N, K, operations 2MNK, bytes 4(MK + NK + MN), the bound in us)
HAND = [
    (98, 2211, 2211, 958150116, 21287508, 6.354480),
    (98, 4489, 4489, 3949619716, 84123860, 25.111600),
    (98, 741, 741, 107619876, 2777268, 0.829035),
    (98, 1521, 1521, 453434436, 10446228, 3.118277),
]


@pytest.mark.parametrize("M,N,K,ops,nbytes,bound_us", HAND)
def test_bound_of_a_product(M, N, K, ops, nbytes, bound_us):
    assert 2 * M * N * K == ops
    assert 4 * (M * K + N * K + M * N) == nbytes
    # at these shapes the bytes bound it: ops / 495e12 is the smaller
    assert ops / 495e12 < nbytes / 3.35e12
    assert LADDER.bound_s(M, N, K) * 1e6 == pytest.approx(bound_us,
                                                         rel=1e-6)


def test_pattern_covers_every_ladder_kernel():
    import re

    pat = re.compile(LADDER.PATTERN)
    for name in ("void ladder_mm_nt<float>(float const*, float const*)",
                 "_Z12ladder_mm_ntIfEvPKfS1_Pfiiii",
                 "ladder_mm_tcI13__nv_bfloat16",
                 "_ZN12_GLOBAL__N_115ladder_mm_f32tcILi3EEEvv",
                 "_ZN12_GLOBAL__N_17split_aILi3EEEvPKfPfS3_ii",
                 "void (anonymous namespace)::split_a<3>(float const*)",
                 "ladder_mm_f64tc"):
        assert pat.search(name), name
    for name in ("ampere_sgemm_128x64_nn", "elementwise_kernel",
                 "Memcpy DtoD (Device -> Device)"):
        assert not pat.search(name), name
