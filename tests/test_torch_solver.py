"""End-to-end parity of the PyTorch port's ECW-CCSD ground-state solve with
the JAX package, f64 on the CPU:

  - Solver_CCSD.SCF against the JAX Solver_CCSD(mo_perm=..., vvvv_op=
    SectoredVVVV) on the same sorted system (mirrors
    test_ccsd_solve_sector_path_matches_dense);
  - ECW (H2O/6-31G doctest target) against the JAX ECW, both on the JAX
    ECW's f64 route (alternating layout, dense ladder);
  - the routes the port does not have yet raise, naming their ROADMAP item.
"""

import numpy as np
import pytest
import torch

import ecw_cc_torch
from ecw_cc_tpu.models.eris import build_eris_device
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_tpu.ops.ccsd import GCC as JGCC
from ecw_cc_tpu.ops.vexp import Exp as JExp
from ecw_cc_tpu.solvers.gs import Solver_CCSD as JSolver
from ecw_cc_torch.models.eris import from_numpy
from gauge import jax_gauge
from ecw_cc_torch.ops.ccsd import GCC as TGCC
from ecw_cc_torch.ops.vexp import Exp as TExp
from ecw_cc_torch.solvers.gs import Solver_CCSD as TSolver

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sorted_problem(h2o_631g):
    mol, ghf, eris_host, _ = h2o_631g
    er, sect = build_eris_device(mol, ghf, dtype="float64",
                                 pack_ladder=True, sort_spin=True)
    perm = jl.spin_sort_perm(ghf.orbspin, eris_host.nocc)
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    er_t, sect_t = from_numpy(er, sect, dtype=torch.float64, device="cpu")
    return dict(mol=mol, ghf=ghf, er=er, sect=sect, er_t=er_t,
                sect_t=sect_t, perm=perm, target=target)


def _torch_solver(p, **kw):
    exp = TExp(0.05, [[["mat", p["target"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    args = dict(conv="tl", conv_thres=1e-9, diis="tl", maxiter=60,
                vvvv_op=p["sect_t"], mo_perm=p["perm"])
    args.update(kw)
    return TSolver(TGCC(p["er_t"]), exp, **args)


@pytest.mark.parametrize("diis,conv,sym,alpha,maxiter", [
    ("tl", "tl", True, None, 60),      # the production route
    ("tl", "tl", False, None, 60),     # mirror symmetry off: 3 GEMMs
    ("", "Ep", True, None, 60),        # no DIIS, energy criterion
    # rdm1 DIIS amplifies roundoff along its trajectory (1e-16 -> 1e-9 in
    # Ep over 30 iterations, in either package), and L1 regularization
    # does not converge to 1e-9: compare fixed-length prefixes
    ("rdm1", "l", True, None, 15),
    ("tl", "tl", True, 1e-3, 10),
], ids=["tl-sym", "tl-nosym", "none-Ep", "rdm1-l", "tl-alpha"])
def test_sector_solve_matches_jax(sorted_problem, diis, conv, sym, alpha,
                                  maxiter):
    from ecw_cc_tpu import config as jcfg

    p = sorted_problem
    exp_j = JExp(0.05, [[["mat", p["target"]]]], mol=p["mol"],
                 mo_coeff=p["ghf"].mo_coeff)
    jcfg.set_config(soup_sym=sym)      # conftest restores the JAX config
    ref = JSolver(JGCC(p["er"]), exp_j, conv=conv, conv_thres=1e-9,
                  diis=diis, maxiter=maxiter, vvvv_op=p["sect"],
                  mo_perm=p["perm"]).SCF_device(0.05, alpha=alpha)
    ecw_cc_torch.set_config(soup_sym=sym)
    try:
        solver = _torch_solver(p, conv=conv, diis=diis, maxiter=maxiter)
        out = solver.SCF(0.05, alpha=alpha)
    finally:
        ecw_cc_torch.set_config(soup_sym=True)
    assert out[0] == ref[0]     # same status, lambda and iteration count
    if diis == "tl" and alpha is None:
        assert "Convergence reached" in out[0]
    assert len(out[1]) == len(ref[1])              # same iteration count
    assert abs(out[1][-1] - ref[1][-1]) < 1e-10
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(out[4], ref[4], rtol=0, atol=1e-9)
    for a, b in zip(out[5], ref[5]):
        assert isinstance(a, np.ndarray) and a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-8)
    assert solver.last_solve["sym"] is sym
    assert solver.last_solve["iterations"] == len(out[1])


def test_ecw_ccsd_gs_matches_jax(h2o_631g):
    """Doctest configuration (H2O/6-31G, HF target with a static field,
    L = 0.5): the port's driver against the JAX driver."""
    from ecw_cc_tpu import ECW as JECW

    ref_ecw = JECW("h2o", "6-31g")
    ref_ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    with jax_gauge(ref_ecw):
        out_ecw = ecw_cc_torch.ECW("h2o", "6-31g", device="cpu",
                                   dtype=torch.float64)
    out_ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    assert abs(out_ecw.EHF - (-75.98395)) < 1e-4
    out = out_ecw.CCSD_GS([0.5], diis="tl")
    ref = ref_ecw.CCSD_GS([0.5], diis="tl")
    assert "Convergence reached" in out[0]
    assert len(out[1]) == len(ref[1])
    assert abs(out[1][-1] - ref[1][-1]) < 1e-10
    np.testing.assert_allclose(out[4], ref[4], rtol=0, atol=1e-9)
    for a, b in zip(out[5], ref[5]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-8)
    assert out_ecw.Delta_lamb == pytest.approx(ref_ecw.Delta_lamb, abs=1e-10)


def test_unported_routes_raise(sorted_problem):
    """The routes of ROADMAP A.2 are ported: the alternating layout
    (guarded by the sorted-layout warning), a solver with no ladder operand
    (derived from eris.vvvv, which a pack-on-build placeholder refuses) and
    the dense route on the sorted layout.  SCF_batch (A.13) runs on the
    sectored route; refine=True without eris_host raises as in JAX."""
    p = sorted_problem
    exp = TExp(0.05, [[["mat", p["target"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    with pytest.warns(RuntimeWarning, match="spin-SORTED"):
        TSolver(TGCC(p["er_t"]), exp, mo_perm=None)
    no_op = TSolver(TGCC(p["er_t"]), exp, mo_perm=p["perm"])
    assert no_op.route() == "sectored"
    with pytest.raises(ValueError, match="not materialized"):
        no_op.SCF(0.05)
    solver = _torch_solver(p)
    assert solver.route() == "sectored"
    with pytest.raises(ValueError, match="eris_host"):
        solver.SCF(0.05, refine=True)
    batch = solver.SCF_batch([0.05, 0.1])
    assert solver.last_solve["route"] == "sectored"
    assert solver.last_solve["lanes"] == 2
    assert all("Convergence reached" in r[0] for r in batch)
    assert solver.last_solve["iterations"] == [len(r[1]) for r in batch]
    # a precision mode that does not exist cannot be set at all
    with pytest.raises(ValueError, match="iter_precision"):
        ecw_cc_torch.set_config(iter_precision="tf32")
    assert ecw_cc_torch.get_config().iter_precision == "highest"
    ecw_cc_torch.set_config(soup_sector=False)
    try:
        assert solver.route() == "dense_sorted"
        out = solver.SCF(0.05)
        assert solver.last_solve["route"] == "dense_sorted"
        assert "Convergence reached" in out[0]
    finally:
        ecw_cc_torch.set_config(soup_sector=True)
    ref = _torch_solver(p).SCF(0.05)
    assert len(out[1]) == len(ref[1])
    assert abs(out[1][-1] - ref[1][-1]) < 1e-10


def test_explicit_device_is_required():
    """The entry points run on the card unless the caller asks for the CPU:
    device defaults to 'cuda', which raises without a card (no silent CPU
    fallback); None is refused."""
    import inspect

    from ecw_cc_torch.config import check_device
    from ecw_cc_torch.models import eris

    with pytest.raises(ValueError, match="device"):
        check_device(None)
    for fn in (ecw_cc_torch.ECW.__init__, eris.build_eris_device,
               eris.from_numpy, eris.sorted_from_host,
               eris.ErisHost.to_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert check_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            check_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ecw_cc_torch.ECW("h2o", "sto-3g")      # no device= given
