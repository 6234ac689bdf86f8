"""The three-pass TF32 ladder product (csrc/ladder_mm_f32tc.cu) on the CPU:
its plain version, ladder_mm_plain_split, against an f64 product and the
JAX package's XLA ladder product at 'highest' precision; its one-pass
form against round_tf32 exactly; an f32 ECW sweep whose sector products
take the three-pass arithmetic against the JAX package's f64 sweep; and
the 16-byte rows of the f32 ladder operand that its TMA loads take."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ecw_cc_torch
from ecw_cc_torch.kernels import ladder_mm as lmm
from ecw_cc_torch.models import eris as port_eris
from ecw_cc_torch.ops.ladder import SectoredVVVV

torch.set_num_threads(1)

# sector-like shapes (M, N, K): odd K, M = 98 (one lambda lane at C2H2,
# mirror symmetry) and 294 (three lanes); N cut to keep the CPU quick
SPLIT_SHAPES = [(98, 61, 465), (98, 45, 961), (294, 33, 2211),
                (98, 29, 3241), (294, 17, 6561)]
TOL = 1e-5                      # x max|C|: the f32 variant's contract


def _operands(shape, seed):
    M, N, K = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((N, K)).astype(np.float32))


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_plain_split_three_passes_matches_f64_and_the_jax_product(shape):
    """lo_a hi_b + hi_a lo_b + hi_a hi_b is an f32-accurate product: within
    1e-5 max|C| of the f64 a @ b.T and of the JAX package's _ladder_mm_xla
    at jax_default_matmul_precision='highest' (its config's setting)."""
    from ecw_cc_tpu.ops.ladder import _ladder_mm_xla

    a, b = _operands(shape, sum(shape))
    c3 = lmm.ladder_mm_plain_split(torch.from_numpy(a), torch.from_numpy(b),
                                   3).numpy()
    ref64 = a.astype(np.float64) @ b.astype(np.float64).T
    scale = np.abs(ref64).max()
    assert np.abs(c3 - ref64).max() <= TOL * scale
    with jax.default_matmul_precision("highest"):
        cj = np.asarray(_ladder_mm_xla(jnp.asarray(a), jnp.asarray(b)))
    assert cj.dtype == np.float32
    assert np.abs(c3 - cj).max() <= TOL * scale


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_plain_split_one_pass_is_round_tf32(shape):
    a, b = (torch.from_numpy(x) for x in _operands(shape, 7 + sum(shape)))
    c1 = lmm.ladder_mm_plain_split(a, b, 1)
    ref = lmm.round_tf32(a) @ lmm.round_tf32(b).T
    assert torch.equal(c1, ref)
    assert torch.equal(c1, lmm.ladder_mm_plain(a, b, "tf32"))


def test_split_tf32_halves():
    """hi is TF32 (low 13 bits clear), lo too; hi + lo is x to 2^-21 of
    |x|; Inf and NaN keep lo = 0 and reach C through hi: a NaN as a NaN,
    an Inf as an Inf or, where a cross term is Inf x 0, a NaN."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.integers(-20, 20, 4096))
                         .astype(np.float32))
    x[:3] = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, lo = lmm.split_tf32(x)
    for h in (hi, lo):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    fin = torch.isfinite(x)
    err = ((hi + lo) - x).abs()[fin] / x.abs()[fin].clamp_min(1e-30)
    assert float(err.max()) <= 2.0 ** -21
    assert torch.equal(lo[:3], torch.zeros(3))
    assert torch.isinf(hi[:2]).all() and torch.isnan(hi[2])
    a = torch.ones(2, 3)
    a[0, 0], a[1, 1] = float("inf"), float("nan")
    b = torch.full((2, 3), 1.0 + 2.0 ** -15)       # lo = 2^-15, not 0
    b[1] = 1.0                                      # lo = 0: Inf x 0
    c = lmm.ladder_mm_plain_split(a, b, 3)
    assert torch.isinf(c[0, 0]) and torch.isnan(c[0, 1])
    assert torch.isnan(c[1]).all()
    with pytest.raises(ValueError):
        lmm.ladder_mm_plain_split(a, a, 2)


def test_ecw_f32_sweep_on_three_pass_products_matches_the_jax_f64_sweep(
        monkeypatch):
    """H2O/6-31G: ECW at f32 with ladder_mode='packed' builds the sorted
    SectoredVVVV and runs the sectored route with the mirror symmetry.
    With the f32 ladder's plain version swapped for the three-pass one,
    its lambda sweep lands on the JAX package's f64 sweep: Ep within 1e-5
    Ha and iterations +-1 at every lambda."""
    from ecw_cc_tpu.models.ecw import ECW as JECW

    calls = []
    plain = lmm.ladder_mm_ref

    def three_pass(a, b):
        if a.dtype == torch.float32:
            calls.append(tuple(a.shape) + (b.shape[0],))
            return lmm.ladder_mm_plain_split(a, b, 3)
        return plain(a, b)

    monkeypatch.setattr(lmm, "ladder_mm_ref", three_pass)
    lambdas = [0.0, 0.25, 0.5]
    field = [0.05, 0.01, 0.0]
    ref = JECW("h2o", "6-31g")
    ref.Build_GS_exp("mat", "HF", field=field)
    res_j = [ref.CCSD_GS([L], diis="tl") for L in lambdas]

    # a copy: get_config() is the live object that set_config changes
    saved = dataclasses.replace(ecw_cc_torch.get_config())
    ecw_cc_torch.set_config(ladder_mode="packed", spin_sorted=True)
    try:
        ecw = ecw_cc_torch.ECW("h2o", "6-31g", device="cpu",
                               dtype=torch.float32)
        ecw.Build_GS_exp("mat", "HF", field=field)
        res = [ecw.CCSD_GS([L], diis="tl") for L in lambdas]
        log = ecw.solve_log
    finally:
        ecw_cc_torch.set_config(ladder_mode=saved.ladder_mode,
                                spin_sorted=saved.spin_sorted)
    assert isinstance(ecw.vvvv_op, SectoredVVVV)
    assert all(s["route"] == "sectored" and s["sym"] for s in log)
    assert calls, "no f32 ladder product took the three-pass version"
    for r, rj in zip(res, res_j):
        assert "Convergence reached" in r[0]
        assert abs(len(r[1]) - len(rj[1])) <= 1
        assert abs(float(r[1][-1]) - float(rj[1][-1])) <= 1e-5


def test_sorted_f32_operand_has_tma_rows():
    """models/eris.py builds the f32 SectoredVVVV in rows padded to 16
    bytes (zero-filled), as views whose values are the unpadded block's:
    the same build at f64, cast, to the f32 transform's 3e-6."""
    from ecw_cc_torch.models.molecule import Molecule
    from ecw_cc_torch.models.scf import GHF, RHF

    mol = Molecule("h2o", "6-31g", charge=0, spin=0)
    mf = RHF(mol, conv_tol=1e-11)
    mf.kernel()
    ghf = GHF(mf)
    kw = dict(device="cpu", pack_ladder=True, sort_spin=True)
    _, op32 = port_eris.build_eris_device(mol, ghf, dtype=torch.float32, **kw)
    _, op64 = port_eris.build_eris_device(mol, ghf, dtype=torch.float64, **kw)
    assert isinstance(op32, SectoredVVVV)
    for w32, w64 in zip(op32, op64):
        K = w32.shape[1]
        assert w32.stride(1) == 1 and w32.stride(0) % 4 == 0
        assert w32.stride(0) == -(-K // 4) * 4
        assert w32.data_ptr() % 16 == 0
        assert w64.is_contiguous()                 # f64 stays as it was
        assert float((w32.double() - w64).abs().max()) <= 3e-6
        pad = torch.as_strided(w32, (w32.shape[0], w32.stride(0) - K),
                               (w32.stride(0), 1), w32.storage_offset() + K)
        assert not pad.any()


def test_stack_rows_and_f32_rows():
    rng = np.random.default_rng(5)
    groups = [torch.from_numpy(rng.standard_normal((n, 13)).astype(np.float32))
              for n in (3, 0, 5)]
    rows = port_eris._stack_rows(groups)
    assert rows.stride() == (16, 1) and torch.equal(rows, torch.cat(groups))
    g64 = [g.double() for g in groups]
    assert port_eris._stack_rows(g64).is_contiguous()
    x = torch.from_numpy(rng.standard_normal((7, 9)).astype(np.float32))
    y = lmm.f32_rows(x)
    assert y.stride() == (12, 1) and torch.equal(y, x)
    assert lmm.f32_rows(y) is y                   # already in TMA rows
    z = lmm.f32_rows(x.double())
    assert z.dtype == torch.float32 and torch.equal(z, x)
