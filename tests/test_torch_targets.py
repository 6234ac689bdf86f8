"""Correlated ground-state targets of the PyTorch port (ecw_cc_torch.models.
gamma_exp.Gexp with 'CCSD' and 'CCSD(T)', and ECW on them)
against the JAX package, f64 on the CPU; the f32 builds (spin-sorted and
sector-blocked, or alternating and packed) against f64."""

import numpy as np
import pytest
import torch

import ecw_cc_tpu.config as jcfg
from ecw_cc_tpu import ECW as JaxECW
from ecw_cc_tpu.models.gamma_exp import Gexp as JaxGexp
from ecw_cc_tpu.models.molecule import Molecule as JaxMolecule
from ecw_cc_torch import ECW
from gauge import jax_gauge
from ecw_cc_torch.models import gamma_exp as tg
from ecw_cc_torch.models.molecule import Molecule
from ecw_cc_torch.models.scf import GHF, RHF
from ecw_cc_torch.ops.ladder import PackedVVVV, SectoredVVVV

torch.set_num_threads(1)

FIELD = [0.05, 0.01, 0.0]
METHODS = ["CCSD", "CCSD(T)"]


def _torch_target(method, dtype=torch.float64, field=FIELD):
    g = tg.Gexp(Molecule("h2o", "sto-3g"), method, device="cpu", dtype=dtype)
    if field is not None:
        g.Vext(field)
    g.build()
    return g


@pytest.fixture(scope="module")
def targets_f64():
    return {m: _torch_target(m) for m in METHODS}


@pytest.mark.parametrize("method", METHODS)
def test_gexp_matches_jax(targets_f64, method):
    """The target density and energy in a static field: gamma_ao to 1e-8,
    Eexp to 1e-9, Tr(gamma S) = N."""
    ref = JaxGexp(JaxMolecule("h2o", "sto-3g"), method)
    ref.Vext(FIELD)
    ref.build()
    g = targets_f64[method]
    assert abs(g.Eexp - ref.Eexp) < 1e-9
    assert abs(g.ECCSD_def - ref.ECCSD_def) < 1e-9
    assert abs(g.ECCSD_t_def - ref.ECCSD_t_def) < 1e-9
    assert np.abs(g.gamma_ao - ref.gamma_ao).max() < 1e-8
    S = g.mol_def.intor("ovlp")
    assert abs(np.einsum("ij,ji", g.gamma_ao, S) - g.mol_def.nelectron) < 1e-8
    assert g.Eexp < g.EHF_def       # correlation lowers the energy
    assert g.log["ccsd"]["converged"]
    last = "adjoint" if method == "CCSD(T)" else "lambda"
    assert g.log[last]["converged"] and g.log[last + "_s"] > 0


def test_ccsd_t_target_differs_from_ccsd(targets_f64):
    """(T) lowers the energy and moves the density."""
    cc, cct = targets_f64["CCSD"], targets_f64["CCSD(T)"]
    assert cct.ECCSD_def == pytest.approx(cc.ECCSD_def, abs=1e-12)
    assert cct.Eexp < cc.Eexp
    assert 1e-6 < np.abs(cct.gamma_ao - cc.gamma_ao).max() < 1e-2


@pytest.mark.parametrize("method", METHODS)
def test_gexp_f32_target_matches_f64(targets_f64, method):
    """The f32 target build (spin-sorted: sectored + mirror-symmetric
    t/lambda solves, sectored (T) and adjoint, permuted back) reproduces
    the f64 dense-path target within the JAX package's bounds."""
    g64 = targets_f64[method]
    g32 = _torch_target(method, torch.float32)
    assert g32.log["sym"] is True
    assert abs(g64.Eexp - g32.Eexp) < 1e-6
    assert np.abs(g64.gamma_ao - g32.gamma_ao).max() < 1e-5


def test_alternating_packed_f32_build_gives_the_sorted_target(targets_f64):
    """_build_eris_auto's route (alternating layout, PackedVVVV, dense
    kernels and the dense (T) loop) against the f64 CCSD(T) target."""
    g64 = targets_f64["CCSD(T)"]
    ghf = GHF(g64.mf_def)
    eris, op = tg._build_eris_auto(g64.mol_def, ghf, torch.float32, "cpu")
    log = {}
    e_cc, e_t, gamma = tg._run_gccsd_t_rdm1((eris, op, None, None), log=log)
    g32 = tg.Gexp(g64.mol_def, "CCSD(T)", device="cpu", dtype=torch.float32)
    g32._store_mo_g(gamma, ghf)
    assert log["ccsd"]["converged"] and log["adjoint"]["converged"]
    assert abs(e_cc + e_t - g64.ECCSD_t_def) < 1e-6
    assert np.abs(g64.gamma_ao - g32.gamma_ao).max() < 1e-5


def test_gexp_f32_ccsd_matches_jax_f32():
    """No field, as tests/test_ccsd_t.py::
    test_gexp_f32_sorted_target_matches_f64: the port's f32 sorted target
    against the JAX package's."""
    old = jcfg.get_config().dtype
    try:
        jcfg.set_config(dtype="float32")
        ref = JaxGexp(JaxMolecule("h2o", "sto-3g"), "CCSD")
        ref.build()
    finally:
        jcfg.set_config(dtype=old)
    g32 = _torch_target("CCSD", torch.float32, field=None)
    assert abs(ref.Eexp - g32.Eexp) < 1e-6
    assert np.abs(ref.gamma_ao - g32.gamma_ao).max() < 1e-5


def test_target_generation_never_builds_dense_vvvv():
    """At f32 both target builds are pack-on-build: the GEris carries the
    (nvir, 0, 0, 0) placeholder and the dense v^4 block is never made."""
    mol = Molecule("h2o", "sto-3g")
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    eris, op = tg._build_eris_auto(mol, ghf, torch.float32, "cpu")
    assert eris.vvvv.numel() == 0 and isinstance(op, PackedVVVV)
    eris, op, (info, sym), unperm = tg._build_eris_sorted(
        mol, ghf, torch.float32, "cpu")
    assert eris.vvvv.numel() == 0 and isinstance(op, SectoredVVVV)
    assert sym is True and (info.oa, info.ob) == (5, 5)
    assert sorted(unperm) == list(range(2 * mol.nao))
    # f64: the dense host build, no operand, no sectors
    eris, op, sect, unperm = tg._build_eris_sorted(mol, ghf, torch.float64,
                                                   "cpu")
    assert eris.vvvv.numel() == eris.nvir ** 4
    assert op is None and sect is None and unperm is None


def test_gexp_refuses_unknown_methods_and_a_missing_card():
    mol = Molecule("h2", "sto-3g")
    with pytest.raises(ValueError, match="method not recognized"):
        tg.Gexp(mol, "MP2", device="cpu").build()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tg.Gexp(mol, "CCSD").build()     # the default device is the card


@pytest.mark.parametrize("posthf", METHODS)
def test_ecw_sweep_on_correlated_target_matches_jax(posthf):
    """ECW.Build_GS_exp('mat', posthf) + CCSD_GS([0.0, 0.3]) end to end
    against the JAX ECW: the target, the iterations and Ep of each
    lambda, and the final rdm1."""
    ref = JaxECW("h2o", "sto-3g")
    ref.Build_GS_exp("mat", posthf, field=FIELD)
    r_ref = ref.CCSD_GS([0.0, 0.3], diis="tl", conv_thres=1e-8)
    with jax_gauge(ref):
        ecw = ECW("h2o", "sto-3g", device="cpu", dtype=torch.float64)
    ecw.Build_GS_exp("mat", posthf, field=FIELD)
    res = ecw.CCSD_GS([0.0, 0.3], diis="tl", conv_thres=1e-8)
    assert abs(ecw.Eexp_GS - ref.Eexp_GS) < 1e-9
    assert np.abs(ecw.exp_data[0][0][1] - ref.exp_data[0][0][1]).max() < 1e-8
    assert ecw.target_log["ccsd"]["converged"]
    assert res[0] == r_ref[0] and len(res[1]) == len(r_ref[1])
    assert np.abs(np.asarray(res[1]) - np.asarray(r_ref[1])).max() < 1e-10
    assert np.abs(res[4] - np.asarray(r_ref[4])).max() < 1e-8
    np.testing.assert_allclose(ecw.Delta_lamb, ref.Delta_lamb, atol=1e-8)
    # the fit moves the wave function toward the correlated target
    assert ecw.Delta_lamb[1] < ecw.Delta_lamb[0]


def test_ecw_passes_its_device_and_dtype_to_the_target():
    ecw = ECW("h2", "6-31g", device="cpu", dtype=torch.float32)
    ecw.Build_GS_exp("mat", "CCSD")
    assert ecw.target_log["sym"] is True      # the f32 sorted build ran
    assert abs(np.trace(ecw.exp_data[0][0][1]) - 2.0) < 1e-5


def test_f32_stopping_tolerances_hold_the_target():
    """At f32 the target's solves stop at looser tolerances than the JAX
    package's 1e-10 of every dtype (solve_ccsd 1e-7, solve_lambda 1e-6, the
    (T) adjoint 1e-5; arguments conv_tol= / tol=): the CCSD(T) target of
    H2O/6-31G then agrees with its f64 twin within 1e-5 Ha and 1e-4 in
    gamma_ao, and every stage stops before its iteration limit."""
    import inspect

    from ecw_cc_torch.ops import ccsd_t

    out = {}
    for dtype in (torch.float64, torch.float32):
        g = tg.Gexp(Molecule("h2o", "6-31g"), "CCSD(T)", device="cpu",
                    dtype=dtype)
        g.Vext(FIELD)
        g.build()
        out[dtype] = g
        assert g.log["ccsd"]["converged"] and g.log["adjoint"]["converged"]
    g64, g32 = out[torch.float64], out[torch.float32]
    assert abs(g64.Eexp - g32.Eexp) < 1e-5
    assert np.abs(g64.gamma_ao - g32.gamma_ao).max() < 1e-4
    # the looser tolerance is what stops f32 earlier, and it can be given
    assert g32.log["ccsd"]["iterations"] <= g64.log["ccsd"]["iterations"]
    assert g32.log["adjoint"]["iterations"] <= g64.log["adjoint"]["iterations"]
    assert "conv_tol" in inspect.signature(ccsd_t.solve_ccsd).parameters
    assert "conv_tol" in inspect.signature(tg.solve_lambda).parameters
    assert "tol" in inspect.signature(
        ccsd_t.ccsd_t_rdm1_response).parameters
