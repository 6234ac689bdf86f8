"""csrc/ladder_mm_f64tc.cu on the card: the f64 ladder product's TMA-fed
DMMA kernel against its plain version (a @ b.T) at the f64 route shapes
and the edges of its tile, split and K, bitwise repeatable, and the
wrapper's launch and copy counts.  Every test here needs a CUDA card and
skips without one; the file imports no JAX."""

import numpy as np
import pytest
import torch

from ecw_cc_torch.kernels import ladder_mm as lmm

TOL = 1e-12     # x max|C|: the f64 variant's contract
SHAPES = [(392, 1891, 1891), (196, 3844, 3844), (392, 13041, 13041),
          (196, 1891, 1891), (14, 1891, 1891), (1, 961, 961), (98, 465, 15),
          (98, 465, 0), (37, 513, 129), (105, 129, 1891), (832, 300, 257)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _operands(shape, seed):
    M, N, K = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((n, K)),
                                 dtype=torch.float64, device="cuda")
                 for n in (M, N))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f64tc_kernel_matches_plain_on_card(shape):
    """One launch of the kernel on operands in 16-byte rows (f64_rows)
    against a @ b.T, no copy made, and a second launch bitwise equal."""
    dev = _card()
    a, b = (lmm.f64_rows(x) for x in _operands(shape, sum(shape)))
    counts = lmm.launch_counts()
    c = lmm.launch_kernel(a, b, "f64tc")
    torch.cuda.synchronize()
    delta = lmm.launch_counts(since=counts)
    assert (delta["f64tc"], delta["a_copies"], delta["b_copies"]) == (1, 0, 0)
    ref = lmm.ladder_mm_plain(a, b)
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    assert float((c - ref).abs().max()) <= TOL * scale
    assert torch.equal(lmm.launch_kernel(a, b, "f64tc"), c)
    assert lmm.device_plan(*shape, torch.float64, dev, "f64tc").kernel == \
        "f64tc"


@pytest.mark.gpu
def test_f64tc_wrapper_copies_and_counts_unaligned_operands_on_card():
    """An odd K without padded rows: the launch copies A and B into
    16-byte rows (one count each) and gives the same product; ladder_mm
    routes a shape of f64tc_rule to the kernel."""
    _card()
    shape = (392, 1891, 1891)
    a, b = _operands(shape, 5)
    assert lmm.f64tc_rule(*shape)
    counts = lmm.launch_counts()
    c = lmm.ladder_mm(a, b)
    torch.cuda.synchronize()
    delta = lmm.launch_counts(since=counts)
    assert (delta["f64tc"], delta["a_copies"], delta["b_copies"]) == (1, 1, 1)
    ref = lmm.ladder_mm_plain(a, b)
    assert float((c - ref).abs().max()) <= TOL * float(ref.abs().max())
    assert torch.equal(lmm.ladder_mm(lmm.f64_rows(a), lmm.f64_rows(b)), c)
