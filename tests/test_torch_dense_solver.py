"""The PyTorch port's dense-kernel solve routes against the JAX package, f64
on the CPU, H2O/6-31G:

  - alternating layout (mo_perm=None), dense ladder (ladder_mode 'auto' at
    nvir 16) and with a PackedVVVV from build_eris_device(pack_ladder=True);
  - sorted layout whose structure gate fails: a target rdm1 that couples
    the spins (test_ccsd_kernels.py::test_sectored_gate_spin_mixing_target
    builds the same one), and soup_sector=False;

each against JAX Solver_CCSD.SCF_device on the same inputs: the same
status and iteration count, Ep to 1e-10, rdm1 to 1e-9, amplitudes to 1e-8.
Also the layout warning of Solver_CCSD(mo_perm=None), and the port's ECW
on the JAX ECW's route at f64, at lambda = 0 against a plain CCSD loop
of the port's own tupdate (test_e2e_gs.py::test_ccsd_L0_equals_plain_ccsd).
"""

import numpy as np
import pytest
import torch

import ecw_cc_torch
from ecw_cc_tpu import config as jcfg
from ecw_cc_tpu.models.eris import build_eris_device as j_build
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_tpu.ops.ccsd import GCC as JGCC
from ecw_cc_tpu.ops.vexp import Exp as JExp
from ecw_cc_tpu.solvers.gs import Solver_CCSD as JSolver
from ecw_cc_torch.kernels.ladder_mm import ladder_mm
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import ccsd as tc
from ecw_cc_torch.ops.ccsd import GCC as TGCC
from ecw_cc_torch.ops.ladder import pack_vvvv
from ecw_cc_torch.ops.vexp import Exp as TExp
from ecw_cc_torch.solvers.gs import Solver_CCSD as TSolver

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def problems(h2o_631g):
    """ERIs of each route, JAX and port, and the two targets."""
    mol, ghf, eris_host, eris_j = h2o_631g
    nocc = eris_host.nocc
    nmo = eris_j.fock.shape[0]
    er_p, packed = j_build(mol, ghf, dtype="float64", pack_ladder=True)
    er_s, sect = j_build(mol, ghf, dtype="float64", pack_ladder=True,
                         sort_spin=True)
    hf = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((nmo, nmo)) * 1e-3
    routes = {
        "dense": (eris_j, None, None),
        "packed": (er_p, packed, None),
        "sorted": (er_s, sect, jl.spin_sort_perm(ghf.orbspin, nocc)),
    }
    port = {}
    for name, (er, op, perm) in routes.items():
        port[name] = (from_numpy(er, op, **F64) if op is not None
                      else (from_numpy(er, **F64), None))
    return dict(mol=mol, ghf=ghf, routes=routes, port=port,
                targets={"hf": hf, "mix": hf + 0.5 * (mix + mix.T)})


def _solve_pair(p, eris_name, target, diis, conv, maxiter, alpha=None):
    er, op, perm = p["routes"][eris_name]
    er_t, op_t = p["port"][eris_name]
    tgt = p["targets"][target]
    kw = dict(conv=conv, conv_thres=1e-9, diis=diis, maxiter=maxiter)
    exp_j = JExp(0.05, [[["mat", tgt]]], mol=p["mol"],
                 mo_coeff=p["ghf"].mo_coeff)
    ref_solver = JSolver(JGCC(er), exp_j, vvvv_op=op, mo_perm=perm, **kw)
    ref = ref_solver.SCF_device(0.05, alpha=alpha)
    exp_t = TExp(0.05, [[["mat", tgt]]], mol=p["mol"],
                 mo_coeff=p["ghf"].mo_coeff)
    solver = TSolver(TGCC(er_t), exp_t, vvvv_op=op_t, mo_perm=perm, **kw)
    out = solver.SCF(0.05, alpha=alpha)
    return ref, out, solver, ref_solver


def _assert_same_solve(out, ref):
    assert out[0] == ref[0]     # same status, lambda and iteration count
    assert len(out[1]) == len(ref[1])
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(out[4], ref[4], rtol=0, atol=1e-9)
    for a, b in zip(out[5], ref[5]):
        assert isinstance(a, np.ndarray) and a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-8)


@pytest.mark.parametrize("eris_name,target,sector,diis,conv,maxiter,route", [
    ("dense", "hf", True, "tl", "tl", 60, "dense"),
    ("dense", "hf", True, "", "Ep", 60, "dense"),
    # rdm1 DIIS amplifies roundoff along its trajectory (as in the sectored
    # solve's test): a fixed-length prefix
    ("dense", "hf", True, "rdm1", "l", 10, "dense"),
    ("packed", "hf", True, "tl", "tl", 60, "packed"),
    ("packed", "mix", True, "", "l", 60, "packed"),
    ("sorted", "mix", True, "tl", "tl", 60, "dense_sorted"),
    ("sorted", "mix", True, "rdm1", "Ep", 10, "dense_sorted"),
    ("sorted", "hf", False, "tl", "l", 60, "dense_sorted"),
], ids=["dense-tl-tl", "dense-none-Ep", "dense-rdm1-l", "packed-tl-tl",
        "packed-mix-none-l", "sorted-mix-tl-tl", "sorted-mix-rdm1-Ep",
        "sorted-nosector-tl-l"])
def test_dense_routes_match_jax(problems, eris_name, target, sector, diis,
                                conv, maxiter, route):
    jcfg.set_config(soup_sector=sector)     # conftest restores the JAX config
    ecw_cc_torch.set_config(soup_sector=sector)
    try:
        ladder_mm.launches = 0
        ref, out, solver, ref_solver = _solve_pair(
            problems, eris_name, target, diis, conv, maxiter)
    finally:
        ecw_cc_torch.set_config(soup_sector=True)
    assert ladder_mm.launches == 0          # CPU: the plain version
    assert solver.last_solve["route"] == route
    assert solver.last_solve["sym"] is False
    if eris_name == "sorted" and target == "mix":
        assert not solver._vexp_block_diagonal()
        assert not ref_solver._vexp_block_diagonal()
    if diis != "rdm1":
        assert "Convergence reached" in out[0]
    _assert_same_solve(out, ref)


@pytest.mark.parametrize("mode,per_iter", [("dense", 2), ("packed", 1)])
def test_sorted_route_follows_gate_not_operand(problems, mode, per_iter):
    """Dense sorted ERIs with no explicit operand: the structure gate alone
    picks the sectored route, as in the JAX loop.  ladder_mode='dense'
    packs the sorted vvvv into a SectoredVVVV (two sector GEMMs per
    iteration with the mirror symmetry), 'packed' runs the stacked packed
    GEMM (one); both match the JAX sectored solve with its SectoredVVVV."""
    from ecw_cc_torch.ops import ladder as tl

    p = problems
    mol, ghf = p["mol"], p["ghf"]
    perm = p["routes"]["sorted"][2]
    dense_sorted = from_numpy(j_build(mol, ghf, dtype="float64",
                                      sort_spin=True), **F64)
    kw = dict(conv="tl", conv_thres=1e-9, diis="tl", maxiter=60)
    er_j, sect_j, _ = p["routes"]["sorted"]
    exp_j = JExp(0.05, [[["mat", p["targets"]["hf"]]]], mol=mol,
                 mo_coeff=ghf.mo_coeff)
    ref = JSolver(JGCC(er_j), exp_j, vvvv_op=sect_j, mo_perm=perm,
                  **kw).SCF_device(0.05)
    calls = []
    real = tl.ladder_mm
    tl.ladder_mm = lambda a, b, **kw: (calls.append(a.shape)
                                        or real(a, b, **kw))
    ecw_cc_torch.set_config(ladder_mode=mode)
    try:
        exp_t = TExp(0.05, [[["mat", p["targets"]["hf"]]]], mol=mol,
                     mo_coeff=ghf.mo_coeff)
        solver = TSolver(TGCC(dense_sorted), exp_t, mo_perm=perm, **kw)
        assert solver.route() == "sectored"
        out = solver.SCF(0.05)
    finally:
        tl.ladder_mm = real
        ecw_cc_torch.set_config(ladder_mode="auto")
    assert solver.last_solve["route"] == "sectored"
    assert solver.last_solve["sym"] is True
    assert len(calls) == per_iter * len(out[1])
    assert "Convergence reached" in out[0]
    _assert_same_solve(out, ref)


def test_dense_route_l1_regularized_matches_jax(problems):
    """alpha (L1 regularization of the doubles) on the dense route; it does
    not converge to 1e-9, so a fixed-length prefix."""
    ref, out, solver, _ = _solve_pair(problems, "dense", "hf", "tl", "tl",
                                      10, alpha=1e-3)
    assert solver.last_solve["route"] == "dense"
    _assert_same_solve(out, ref)


def test_alternating_solver_warns_on_sorted_eris(problems):
    """Solver_CCSD(mo_perm=None) takes the reference alternating layout; the
    sorted handle gets the warn_if_sorted_layout warning, and a SectoredVVVV
    (a sorted-layout operand) is refused."""
    import warnings

    p = problems
    exp = TExp(0.05, [[["mat", p["targets"]["hf"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    er_s, sect_s = p["port"]["sorted"]
    with pytest.warns(RuntimeWarning, match="spin-SORTED"):
        TSolver(TGCC(er_s), exp, mo_perm=None)
    with pytest.warns(RuntimeWarning, match="spin-SORTED"):
        with pytest.raises(ValueError, match="mo_perm"):
            TSolver(TGCC(er_s), exp, vvvv_op=sect_s, mo_perm=None)
    er_a, packed = p["port"]["packed"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solver = TSolver(TGCC(er_a), exp, vvvv_op=packed, mo_perm=None)
    assert solver.route() == "packed"


def test_vvvv_op_follows_ladder_mode(problems):
    """Without an explicit operand the solver derives it from eris.vvvv per
    config.ladder_mode, anew when the mode changes."""
    p = problems
    exp = TExp(0.05, [[["mat", p["targets"]["hf"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    er, _ = p["port"]["dense"]
    solver = TSolver(TGCC(er), exp, mo_perm=None)
    assert solver.route() == "dense" and solver._get_vvvv_op() is None
    ecw_cc_torch.set_config(ladder_mode="packed")
    try:
        assert solver.route() == "packed"
        op = solver._get_vvvv_op()
        assert torch.equal(op.wc, pack_vvvv(er.vvvv).wc)
        # the slab-packed build's operand, up to the two transforms' roundoff
        assert float((op.wc - p["port"]["packed"][1].wc).abs().max()) < 1e-12
    finally:
        ecw_cc_torch.set_config(ladder_mode="auto")
    assert solver.route() == "dense"


@pytest.fixture(scope="module")
def ecw_h2o():
    ecw = ecw_cc_torch.ECW("h2o", "6-31g", device="cpu", dtype=torch.float64)
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    return ecw


def test_ecw_f64_takes_the_alternating_dense_route(ecw_h2o):
    """ECW at f64 uploads the host ERIs in the alternating layout, as the
    JAX ECW does: no mo_perm, no ladder operand (nvir 16 < 48: dense)."""
    ecw = ecw_h2o
    assert ecw.mo_perm is None and ecw.vvvv_op is None
    assert ecw.eris.vvvv.shape == (ecw.nvir,) * 4
    np.testing.assert_array_equal(ecw.fock, ecw.eris_host.fock)
    np.testing.assert_array_equal(ecw.eris.oovv.numpy(), ecw.eris_host.oovv)


def test_ecw_f32_takes_the_alternating_packed_route(ecw_h2o):
    """ECW at f32 with the ladder packed (as 'auto' does at nvir >= 48)
    builds the alternating layout with a PackedVVVV, never the sorted one,
    and its sweep runs the packed route to the f64 solve within f32
    rounding."""
    from ecw_cc_torch.ops.ladder import PackedVVVV

    ecw_cc_torch.set_config(ladder_mode="packed")
    try:
        ecw = ecw_cc_torch.ECW("h2o", "6-31g", device="cpu",
                               dtype=torch.float32)
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        assert ecw.mo_perm is None and isinstance(ecw.vvvv_op, PackedVVVV)
        assert ecw.eris.vvvv.shape == (ecw.nvir, 0, 0, 0)
        res = ecw.CCSD_GS([0.5], diis="tl")
    finally:
        ecw_cc_torch.set_config(ladder_mode="auto")
    assert ecw.solve_log[0]["route"] == "packed"
    np.testing.assert_allclose(ecw.fock, ecw_h2o.fock, rtol=0, atol=1e-5)
    ref = ecw_h2o.CCSD_GS([0.5], diis="tl")
    assert abs(len(res[1]) - len(ref[1])) <= 1
    assert abs(res[1][-1] - ref[1][-1]) <= 1e-5


def test_ccsd_L0_equals_plain_ccsd(ecw_h2o):
    """At L = 0 ECW-CCSD is plain CCSD (reference Solver_GS.py:885, parity
    1e-8): the ECW solve against a plain loop of the port's tupdate."""
    ecw = ecw_h2o
    res = ecw.CCSD_GS([0.0], conv_thres=1e-8, maxiter=60)
    assert ecw.solve_log[0]["route"] == "dense"
    Ep0 = res[1][-1]
    eris = ecw.eris
    nocc, nvir = ecw.nocc, ecw.nvir
    e = np.diag(ecw.fock)
    eia = e[:nocc, None] - e[None, nocc:]
    eijab = eia[:, None, :, None] + eia[None, :, None, :]
    t1 = torch.zeros((nocc, nvir), dtype=torch.float64)
    t2 = eris.oovv / torch.as_tensor(eijab)
    e_old = 0.0
    for _ in range(120):
        t1, t2 = tc.tupdate(eris, t1, t2, None)
        e_cc = float(tc.energy(eris, t1, t2, None))
        if abs(e_cc - e_old) < 1e-12:
            break
        e_old = e_cc
    assert abs(e_cc - Ep0) < 1e-8
    # literature check: H2O/6-31G CCSD correlation energy ~ -0.1354
    assert abs(e_cc - (-0.13540)) < 2e-4
