"""The PyTorch port's excited-state path (ecw_cc_torch.solvers.es, ESexp,
ECW.Build_ES_exp_* / CCS_ES) against the JAX package on identical f64
inputs, CPU, and the JAX package's own ES tests (tests/test_es.py)
mirrored on the port."""

import numpy as np
import pytest
import torch

from ecw_cc_tpu import ECW as JaxECW
from ecw_cc_tpu.ops.ccs import Gccs as JaxGccs
from ecw_cc_tpu.ops.vexp import Exp as JaxExp
from ecw_cc_tpu.solvers.es import Solver_ES as JaxSolverES
from ecw_cc_tpu.solvers.es import SolverES_Device as JaxSolverESDevice
from ecw_cc_torch import ECW
from ecw_cc_torch.models import gamma_exp
from ecw_cc_torch.models.eris import sorted_from_host
from ecw_cc_torch.ops import ccs as ccs_ops
from ecw_cc_torch.ops.ccs import Gccs
from ecw_cc_torch.ops.ladder import spin_sort_perm
from ecw_cc_torch.ops.vexp import Exp
from ecw_cc_torch.solvers.es import (Solver_ES, SolverES_Device,
                                     amp_from_numpy, amp_to_numpy)
from ecw_cc_torch.utils import linalg as ulinalg
from ecw_cc_torch.utils import props
from gauge import jax_gauge

torch.set_num_threads(1)

EV = 27.2114
F64 = dict(dtype=torch.float64, device="cpu")
ANCHOR = [[["trdip", (0.54, 0.0, 0.0)]]]
DIP = (0.523742 + 0.550251) / 2.0
TWO_STATES = [[["trdip", (DIP, 0.0, 0.0)]], [["DEk", 7.6051 * 0.03675]]]


def _fresh(es_prop):
    return [[list(p) for p in st] for st in es_prop]


def _pair(es_prop, molecule="h2o", basis="6-31g"):
    ref = JaxECW(molecule, basis)
    ref.Build_ES_exp_input(_fresh(es_prop))
    with jax_gauge(ref):
        ecw = ECW(molecule, basis, **F64)
    ecw.Build_ES_exp_input(_fresh(es_prop))
    return ref, ecw


@pytest.fixture(scope="module")
def anchor_pair():
    """H2O/6-31G with one transition-dipole target, in both packages."""
    return _pair(ANCHOR)


@pytest.fixture(scope="module")
def ecw_es_pair():
    """The reference's worked example (Main.py:1220-1231) in both packages:
    a transition dipole for ES1 and a kinetic-energy difference for ES2."""
    return _pair(TWO_STATES)


def _iterations(text):
    """The count in a solver's convergence text (None at max iterations)."""
    words = text.replace(",", " ").split()
    return int(words[words.index("after") + 1]) if "after" in words else None


def _assert_same_solve(out_t, out_j, tol=1e-9):
    assert out_t[0] == out_j[0]                  # status and iterations
    assert np.abs(np.asarray(out_j[3]) - out_t[3]).max() <= tol      # Ep
    assert np.abs(np.asarray(out_j[2]) - out_t[2]).max() <= tol      # Delta
    assert np.abs(np.asarray(out_j[4]) - out_t[4]).max() <= 1e-8     # rdm1
    for key in ("ts", "ls"):
        assert np.abs(np.asarray(out_j[1][key]) - out_t[1][key]).max() < 1e-8
    for key in ("rn", "ln", "r0n", "l0n"):
        for a, b in zip(out_j[1][key], out_t[1][key]):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-8


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_koopman_guess(ecw_es_pair):
    """Koopman guesses: single excitation, sensible energies, the JAX
    package's."""
    ref, ecw = ecw_es_pair
    assert len(ecw.r_ini) == 2
    for r, rj in zip(ecw.r_ini, ref.r_ini):
        assert np.sum(np.abs(r) > 0) == 1
        assert np.array_equal(r, rj)
    r1, de = ulinalg.koopman_init_guess(np.diag(ecw.fock), ecw.mo_occ, [2, 0])
    assert de[0] <= de[1]
    assert 0.1 < de[0] < 1.5  # valence gap in au
    assert ecw.exp_data[1:] == ref.exp_data[1:]
    assert ecw.HF_prop == ref.HF_prop


@pytest.mark.parametrize("diis", ["", "GS", "ES", "all"])
@pytest.mark.parametrize("method", ["scf", "device"])
def test_es_solve_matches_jax(anchor_pair, method, diis):
    """Every DIIS mode of the host loop and of the device loop: the same
    iterations, Ep, Delta and amplitudes.  'ES' and 'all' converge; '' and
    'GS' are compared over a fixed 21 iterations (they need more than 80
    here, in both packages).  A cold start: (o, v) pinned from the
    guess."""
    ref, ecw = anchor_pair
    kw = dict(method=method, diis=diis, conv="rl", conv_thres=1e-5,
              maxiter=20, print_ite=False)
    out_j = ref.CCS_ES(0.15, **kw)
    out_t = ecw.CCS_ES(0.15, **kw)
    _assert_same_solve(out_t, out_j)
    if diis in ("ES", "all"):
        assert "Convergence reached" in out_t[0]
    else:
        assert out_t[0] == "Max iteration reached"
    if method == "device":
        assert ecw.solve_log[-1]["iterations"] == (
            21 if diis in ("", "GS") else _iterations(out_t[0]))


def test_es_anchor_eleven_iterations(anchor_pair):
    """The documented ES flow: Build_ES_exp_input([[['trdip',
    (0.54, 0, 0)]]]) then CCS_ES(0.15, diis='all', conv='rl') converges in
    11 iterations with Er = 0.32066 au."""
    _, ecw = anchor_pair
    out = ecw.CCS_ES(0.15, diis="all", conv="rl", print_ite=False)
    assert "Convergence reached" in out[0] and _iterations(out[0]) == 11
    assert abs(out[3][1, 0] - 0.32066) < 1e-5
    tab = ecw.CCS_ES(0.15, diis="all", conv="rl", print_ite=True)
    assert tab[0] == out[0]


@pytest.mark.parametrize("method", ["scf", "device"])
def test_es_two_states_match_jax(ecw_es_pair, method):
    """Two coupled excited states (trdip + DEk, which feeds V00) to
    convergence, and the physics the JAX package's test asks of them."""
    ref, ecw = ecw_es_pair
    kw = dict(method=method, diis="all", conv="rl", conv_thres=1e-5,
              maxiter=60, print_ite=False)
    out_j = ref.CCS_ES(0.15, **kw)
    out_t = ecw.CCS_ES(0.15, **kw)
    _assert_same_solve(out_t, out_j)
    Conv_text, dic_amp, Delta, Ep, rdm1_GS = out_t
    assert "Convergence reached" in Conv_text
    # excitation energies in a physically sensible window (QChem EOM-CCSD
    # references: 7.61 eV and 9.96 eV)
    e1, e2 = Ep[1, 0] * EV, Ep[2, 0] * EV
    assert 6.0 < e1 < 10.0 and 8.0 < e2 < 13.0 and e2 > e1
    assert abs(Ep[1, 0] - Ep[1, 1]) < 1e-3       # right = left energy
    assert abs(np.trace(rdm1_GS) - ecw.nocc) < 1e-8
    C = ulinalg.check_ortho(dic_amp["rn"], dic_amp["ln"],
                            dic_amp["r0n"], dic_amp["l0n"])
    assert abs(C[0, 0] - 1) < 0.05 and abs(C[1, 1] - 1) < 0.05


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_warm_start_crosses_packages(anchor_pair, direction):
    """A dic_amp of one package warm-starts the other's solve (the warm
    branch: (o, v) follows the largest amplitude), and the two continued
    solves agree."""
    ref, ecw = anchor_pair
    kw = dict(method="device", diis="all", conv="rl", conv_thres=1e-5,
              maxiter=40, print_ite=False)
    first, other = (ref, ecw) if direction == "jax_to_port" else (ecw, ref)
    amp = first.CCS_ES(0.1, **kw)[1]

    def warm(e, device):
        V = (JaxExp if e is ref else Exp)(0.15, e.exp_data, e.mol, e.mo_coeff)
        S = (JaxSolverES if e is ref else Solver_ES)(
            e.myccs, V, rn_ini=e.r_ini, conv_var="rl", conv_thres=1e-5,
            maxiter=40, diis="all")
        if device:
            S = (JaxSolverESDevice if e is ref else SolverES_Device)(S)
        return S.SCF(0.15, dic_amp_ini=amp, print_ite=False)

    for device in (True, False):
        out_same, out_other = warm(first, device), warm(other, device)
        out_t, out_j = ((out_other, out_same) if direction == "jax_to_port"
                        else (out_same, out_other))
        _assert_same_solve(out_t, out_j)
        assert "Convergence reached" in out_t[0]
        cold = ecw.CCS_ES(0.15, **kw)
        assert _iterations(out_t[0]) < _iterations(cold[0])


def test_amp_dictionary_round_trip():
    rng = np.random.default_rng(0)
    dic = {"ts": rng.random((4, 6)), "ls": rng.random((4, 6)),
           "rn": [rng.random((4, 6)) for _ in range(2)],
           "ln": [rng.random((4, 6)) for _ in range(2)],
           "r0n": [0.1, 0.2], "l0n": [np.float64(0.3), 0.4]}
    amp = amp_from_numpy(dic, "cpu", torch.float64)
    assert amp["rn"].shape == (2, 4, 6) and amp["r0n"].shape == (2,)
    back = amp_to_numpy(amp)
    for key in ("ts", "ls"):
        assert np.array_equal(back[key], dic[key])
    for key in ("rn", "ln", "r0n", "l0n"):
        assert isinstance(back[key], list)
        assert all(np.array_equal(a, b) for a, b in zip(back[key], dic[key]))
    # the stacked form is taken as it is
    again = amp_from_numpy(amp, "cpu", torch.float32)
    assert again["ln"].dtype == torch.float32
    assert torch.equal(again["ln"].double().float(), again["ln"])


def _eig_in_one_gauge(eig):
    """np.linalg.eig with each eigenvector's sign fixed (its entry of
    largest modulus positive).  Both packages' SCF_diag follow the root
    whose vector numpy returns, sign and all, and the transition Vexp sees
    that sign; numpy's own choice flips with the last bits of the matrix
    (H2O's symmetry leaves exact zeros for its Householder pivots)."""
    def fixed(a):
        w, v = eig(a)
        idx = np.argmax(np.abs(v), axis=0)
        s = np.sign(v[idx, np.arange(v.shape[1])].real)
        return w, v * np.where(s == 0, 1.0, s)
    return fixed


def test_scf_diag_exact_matches_jax(anchor_pair, monkeypatch):
    ref, ecw = anchor_pair
    kw = dict(method="diag", conv="tl", conv_thres=1e-5, maxiter=80,
              print_ite=False)
    monkeypatch.setattr(np.linalg, "eig", _eig_in_one_gauge(np.linalg.eig))
    out_j = ref.CCS_ES(0.15, **kw)
    out_t = ecw.CCS_ES(0.15, **kw)
    assert out_t[0] == out_j[0] and "Convergence reached" in out_t[0]
    assert np.abs(np.asarray(out_j[3]) - out_t[3]).max() < 1e-9
    assert np.abs(np.asarray(out_j[2]) - out_t[2]).max() < 1e-9


def test_mom_es_targets():
    """MOM delta-SCF ES target generation (reference gamma_exp.ESexp), on
    H2 as the JAX package tests it and on H2O, where no orbital shell is
    degenerate: the same targets as the JAX package's.  The transition
    density is the reference's biorthogonalisation of two complete orbital
    sets (utilities.py:658-695): every singular value is 1, so which
    rotation it picks, and the density with it, is fixed only by identical
    inputs.  The port's MOM therefore runs on the JAX package's AO
    integrals here (the engines agree to 1e-12, tests/test_torch_host.py),
    and its ECW in the JAX ECW's orbital gauge."""
    for molecule, basis in (("h2", "6-31g"), ("h2o", "sto-3g")):
        ref = JaxECW(molecule, basis)
        ref.Build_ES_exp_MOM(nbr_of_es=(1, 0))
        with jax_gauge(ref):
            ecw = ECW(molecule, basis, **F64)
        for kind in ("ovlp", "kin", "nuc", "int2e"):
            ecw.mol._cache[(kind, None)] = ref.mol.intor(kind)
        ecw.Build_ES_exp_MOM(nbr_of_es=(1, 0))
        assert len(ecw.exp_data) == 2
        assert ecw.exp_data[1][0][0] == "trmat"
        de = ecw.Eexp_ES[0][0]
        assert 0.2 < de < 1.5  # HOMO->LUMO delta-SCF in au
        assert abs(de - ref.Eexp_ES[0][0]) < 1e-9
        tdm = ecw.exp_data[1][0][1][0]
        assert tdm.shape == (2 * ecw.mol.nao,) * 2
        assert np.abs(tdm - ref.exp_data[1][0][1][0]).max() < 1e-7
        assert np.array_equal(ecw.r_ini[0], ref.r_ini[0])
        assert abs(ecw.Eexp_GS - ref.Eexp_GS) < 1e-10
    # the targets reach the solver: a 'trmat' pair per state
    V = Exp(0.05, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    assert V.nbr_states == 2 and V.prop_names[1] == ["trmat"]


@pytest.mark.parametrize("method", ["scf", "device"])
def test_mom_guesses_diverge_as_in_jax(method):
    """A fault the two packages share (ROADMAP C): Build_ES_exp_MOM's r_ini
    has a unit entry in each spin block, so that the normality condition
    (get_ov) returns 0 for the pinned amplitude and the first iteration
    divides by it.  The port diverges exactly as the JAX package does;
    with Koopman guesses (r_ini=None) the same targets start."""
    ref = JaxECW("h2o", "sto-3g")
    ref.Build_ES_exp_MOM(nbr_of_es=(1, 0))
    ecw = ECW("h2o", "sto-3g", **F64)
    ecw.Build_ES_exp_MOM(nbr_of_es=(1, 0))
    assert np.sum(np.asarray(ecw.r_ini[0]) == 1) == 2
    kw = dict(method=method, diis="all", conv="rl", maxiter=20,
              print_ite=False)
    with np.errstate(all="ignore"):
        out_j = ref.CCS_ES(0.05, **kw)
        out_t = ecw.CCS_ES(0.05, **kw)
    assert out_t[0] == out_j[0] and out_t[0].startswith("Diverges")
    assert not np.all(np.isfinite(out_t[3]))
    ecw.r_ini = None
    out = ecw.CCS_ES(0.05, **kw)
    assert np.all(np.isfinite(out[3])) and not out[0].startswith("Diverges")


def test_device_es_solver_production_basis():
    """H2O/6-31++G** (nocc 10, nvir 50), two transition-dipole targets at
    lambda = 0.1: the bench configuration of the ES row.  The port's device
    solve equals the JAX package's (7.134 and 10.07 eV, with Solver_ES's
    own maxdiis of 20) and its own host loop.  The count itself, 19 in the
    bench record, is not asserted: conv='rl' sums r and l over the states,
    so with two states it depends on the signs the SCF's eigensolver gives
    the orbitals (23 with an integral engine built without FMA)."""
    dip1 = (0.523742 + 0.550251) / 2.0
    dip2 = (0.622534 + 0.649058) / 2.0
    ref, ecw = _pair([[["trdip", (dip1, 0.0, 0.0)]],
                      [["trdip", (0.0, 0.0, dip2)]]], basis="6-31++g**")
    kw = dict(diis="all", conv="rl", conv_thres=1e-5, maxiter=80, maxdiis=20,
              print_ite=False)
    out_j = ref.CCS_ES(0.1, method="device", **kw)
    out_t = ecw.CCS_ES(0.1, method="device", **kw)
    _assert_same_solve(out_t, out_j)
    assert "Convergence reached" in out_t[0]
    assert np.abs(out_t[3][1:, 0] * EV - (7.134, 10.07)).max() < 1e-3
    out_h = ecw.CCS_ES(0.1, method="scf", **kw)
    assert out_h[0] == out_t[0]
    assert np.abs(out_h[3] - out_t[3]).max() < 1e-9
    assert abs(np.trace(out_t[4]) - ecw.nocc) < 1e-8


def test_device_es_solve_with_F_target(ecw_es_pair):
    """A device ES solve with a structure-factor state target mixed with a
    trdip transition target: converges, matches the host Solver_ES path
    and the JAX package's device solve."""
    _, ecw = ecw_es_pair
    h = [[1, 0, 0], [0, 1, 0], [1, 1, 0]]
    rec = np.asarray([8.0, 8.0, 8.0])
    # structure factors of the HF density, so that the solve has a
    # reachable fixed point
    Fvals = [complex(f) for f in props.structure_factor(
        ecw.mol, h, ecw.rdm1_hf, mo_coeff=ecw.mo_coeff, g=True, aobasis=True,
        rec_vec=rec)]
    es_prop = [[["trdip", (DIP, 0.0, 0.0)]], [["F", Fvals, h, rec]]]
    ref2, ecw2 = _pair(es_prop)

    def solve(e, device):
        jax_side = e is ref2
        V = (JaxExp if jax_side else Exp)(0.05, e.exp_data, e.mol, e.mo_coeff)
        S = (JaxSolverES if jax_side else Solver_ES)(
            (JaxGccs if jax_side else Gccs)(e.eris), V, rn_ini=e.r_ini,
            conv_var="rl", conv_thres=1e-6, maxiter=80, diis="all")
        if device:
            return (JaxSolverESDevice if jax_side else SolverES_Device)(
                S).SCF(0.05)
        return S.SCF(0.05, print_ite=False)

    out_h, out_d, out_j = solve(ecw2, False), solve(ecw2, True), \
        solve(ref2, True)
    assert "Convergence reached" in out_h[0]
    assert "Convergence reached" in out_d[0]
    assert np.max(np.abs(out_h[3] - out_d[3])) < 1e-5
    assert np.max(np.abs(out_h[1]["ts"] - out_d[1]["ts"])) < 1e-5
    _assert_same_solve(out_d, out_j)


def test_l_loop_sweep_matches_jax(anchor_pair, tmp_path):
    """L_loop=True: the warm-started sweep, its record for the results
    table, the cube files and the table itself."""
    ref, _ = anchor_pair
    ecw = ECW("h2o", "6-31g", out_dir=str(tmp_path), **F64)
    ecw.Build_ES_exp_input(_fresh(ANCHOR))
    kw = dict(method="device", diis="all", conv="rl", L_loop=True,
              print_ite=False)
    # (not from 0: without coupling ts = ls = 0 and the DIIS system of
    # mode 'all' is singular to roundoff, in either package)
    Ls = np.array([0.05, 0.1, 0.2])
    assert ecw.CCS_ES(Ls, **kw) is None
    ref.CCS_ES(Ls, **kw)
    assert len(ecw.Ep_lamb) == 3 and ecw.nbr_ES == 1
    for (er, el), (jr, jl) in zip(ecw.Ep_lamb, ref.Ep_lamb):
        assert np.abs(er - np.asarray(jr)).max() < 1e-9
        assert np.abs(el - np.asarray(jl)).max() < 1e-9
    for (d0n, dn0), (j0n, jn0) in zip(ecw.Delta_lamb, ref.Delta_lamb):
        assert np.abs(d0n - np.asarray(j0n)).max() < 1e-9
        assert np.abs(dn0 - np.asarray(jn0)).max() < 1e-9
    assert len(ecw.solve_log) == 3
    assert all(s["status"] == 1 for s in ecw.solve_log)     # converged
    # the constraint pulls the transition dipole towards its target
    assert ecw.Delta_lamb[2][1][0] < ecw.Delta_lamb[0][1][0]
    ecw.print_results_ES()
    text = (tmp_path / "output.txt").read_text()
    assert "Er_1" in text and "Deltal_1" in text
    assert any(f.name.startswith("L0.10") for f in tmp_path.iterdir())
    assert any(f.name.startswith("L0.05") for f in tmp_path.iterdir())
    assert ecw.plot_results_ES() is not None
    with pytest.raises(ValueError, match="1D array"):
        ecw.CCS_ES(0.1, L_loop=True, print_ite=False)


# ---------------------------------------------------------------------------
# tests/test_es.py mirrored on the port alone
# ---------------------------------------------------------------------------

def _singles_matrix(eris, ts):
    """The similarity-transformed singles matrix at ts (no Vexp)."""
    nocc, nvir = ts.shape
    Fab, Fji, W, F, Tia, Pia = (x.numpy() for x in ccs_ops.R1inter(
        eris, torch.as_tensor(ts), None, None))
    A = (np.einsum("ab,ij->iajb", Fab, np.eye(nocc))
         - np.einsum("ji,ab->iajb", Fji, np.eye(nvir))
         + W.transpose(2, 0, 1, 3))  # akic -> i a k c
    return A.reshape(nocc * nvir, nocc * nvir) + float(F) * np.eye(nocc * nvir)


@pytest.fixture(scope="module")
def sto3g_es():
    ecw = ECW("h2o", "sto-3g", **F64)
    ecw.Build_ES_exp_input([[["trdip", (0.5, 0.0, 0.0)]]])
    return ecw


def test_es_L0_pure_eom_limit(sto3g_es):
    """At L=0 the coupled ES solve decouples into plain EOM-CCS: the
    converged energy must be an eigenvalue of the similarity-transformed
    singles matrix restricted to the force_alpha subspace (rows 1::2, the
    rows rsupdate leaves free, CCS.py:940-941)."""
    ecw = sto3g_es
    Vexp = Exp(0.0, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    solver = Solver_ES(Gccs(ecw.eris), Vexp, rn_ini=ecw.r_ini, conv_var="rl",
                       conv_thres=1e-7, maxiter=100, diis="all")
    out = solver.SCF(0.0, print_ite=False)
    assert "Convergence reached" in out[0]
    A = _singles_matrix(ecw.eris, out[1]["ts"])
    mask = np.zeros((ecw.nocc, ecw.nvir), dtype=bool)
    mask[1::2, :] = True
    idx = np.where(mask.ravel())[0]
    w = np.linalg.eigvals(A[np.ix_(idx, idx)])
    assert np.min(np.abs(w.real - out[3][1, 0])) < 1e-6


def test_scf_diag_davidson_matches_exact(sto3g_es):
    """SCF_diag with the matrix-free Davidson equals exact diagonalization:
    root selection within degenerate spin pairs is arbitrary, so each
    eigenvalue must coincide with AN eigenvalue of the exact singles
    matrix."""
    ecw = sto3g_es
    Vexp = Exp(0.0, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    solver = Solver_ES(Gccs(ecw.eris), Vexp, rn_ini=ecw.r_ini, conv_var="rl",
                       conv_thres=1e-7, maxiter=60)
    out_e = solver.SCF_diag(0.0)
    out_d = solver.SCF_diag(0.0, davidson=True)
    w = np.linalg.eigvals(_singles_matrix(ecw.eris, out_d[1]["ts"])).real
    assert np.min(np.abs(w - out_d[3][1, 0])) < 1e-6
    assert np.min(np.abs(w - out_e[3][1, 0])) < 1e-6
    assert np.min(np.abs(w - out_d[3][1, 1])) < 1e-6


def test_device_es_solver_matches_host(ecw_es_pair):
    """The device ES solver reproduces the host-loop solver (same Vexp
    math, same update order) on the reference example."""
    _, ecw = ecw_es_pair
    outs = []
    for device in (False, True):
        V = Exp(0.15, ecw.exp_data, ecw.mol, ecw.mo_coeff)
        S = Solver_ES(Gccs(ecw.eris), V, rn_ini=ecw.r_ini, conv_var="rl",
                      conv_thres=1e-6, maxiter=60, diis="all")
        outs.append(SolverES_Device(S).SCF(0.15) if device
                    else S.SCF(0.15, print_ite=False))
    out_h, out_d = outs
    assert "Convergence reached" in out_h[0]
    assert "Convergence reached" in out_d[0]
    assert np.max(np.abs(out_h[3] - out_d[3])) < 1e-5
    assert np.max(np.abs(out_h[1]["ts"] - out_d[1]["ts"])) < 1e-5
    assert abs(np.trace(out_d[4]) - ecw.nocc) < 1e-8


def test_scf_diag_left_vectors_differ_from_right():
    """The similarity-transformed singles map is non-symmetric once
    ts != 0: SCF_diag must deliver DISTINCT left eigenvectors with the same
    eigenvalue as the right solve."""
    ecw = ECW("h2o", "sto-3g", **F64)
    # a GS 'mat' target makes ts converge away from zero; the trdip target
    # threads transition Vexp into the maps
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    ecw.Build_ES_exp_input([[["trdip", (0.5, 0.0, 0.0)]]])
    Vexp = Exp(0.05, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    solver = Solver_ES(Gccs(ecw.eris), Vexp, rn_ini=ecw.r_ini, conv_var="rl",
                       conv_thres=1e-7, maxiter=80)
    text, dic, Delta, Ep, rdm1 = solver.SCF_diag(0.05)
    assert "Convergence reached" in text
    ov = abs(float(np.ravel(dic["rn"][0]) @ np.ravel(dic["ln"][0])))
    # the non-symmetry is O(ts^2), small for this field, but an aliased
    # (ln = rn) implementation returns |<l|r>| = 1.0 exactly
    assert ov < 1.0 - 1e-8, f"left vector aliases the right one ({ov})"
    assert ov > 0.5  # same physical root
    assert Vexp.Vexp[1, 0] is not None and np.any(np.asarray(Vexp.Vexp[1, 0]))
    assert Vexp.Vexp[0, 1] is not None


def test_driver_es_method_device_and_diag(ecw_es_pair):
    """ECW.CCS_ES reaches the device solver (method='device') and SCF_diag
    (method='diag', exact and Davidson)."""
    _, ecw = ecw_es_pair
    kw = dict(diis="all", conv="rl", conv_thres=1e-5, maxiter=60,
              print_ite=False)
    out_scf = ecw.CCS_ES(0.15, method="scf", **kw)
    out_dev = ecw.CCS_ES(0.15, method="device", **kw)
    assert "Convergence reached" in out_dev[0]
    assert np.max(np.abs(out_scf[3] - out_dev[3])) < 1e-4
    e_scf = out_scf[3][1:, 0]
    for davidson in (False, True):
        out_diag = ecw.CCS_ES(0.15, method="diag", conv="tl",
                              conv_thres=1e-5, maxiter=80, print_ite=False,
                              davidson=davidson)
        assert "Convergence reached" in out_diag[0]
        # diag and scf solve different update schemes but the same
        # equations: excitation energies agree to the coupling-scheme
        # tolerance
        assert np.max(np.abs(e_scf - out_diag[3][1:, 0])) < 5e-2


def test_driver_es_method_bad(sto3g_es):
    with pytest.raises(SyntaxError):
        sto3g_es.CCS_ES(0.1, method="nope", print_ite=False)
    with pytest.raises(NotImplementedError, match="GS solver"):
        ECW("h2", "sto-3g", **F64).CCS_ES(0.1)
    with pytest.raises(ValueError, match="val_core"):
        sto3g_es.Build_ES_exp_input(_fresh(ANCHOR), val_core=[2, 0])


def test_es_solver_warns_on_sorted_layout(h2o_sto3g):
    """ES amplitudes in the alternating convention on spin-SORTED ERIs
    give silently wrong physics: constructing the solver on a sorted handle
    warns."""
    mol, ghf, eris_host, _ = h2o_sto3g
    perm = spin_sort_perm(ghf.orbspin, eris_host.nocc)
    eris, _ = sorted_from_host(eris_host, perm, **F64)
    V = Exp(0.1, [[], [["trdip", (0.5, 0.0, 0.0)]]], mol, ghf.mo_coeff)
    with pytest.warns(RuntimeWarning, match="spin-SORTED"):
        Solver_ES(Gccs(eris), V, conv_var="rl")


def test_es_entry_points_that_wait_for_eom(sto3g_es):
    """The EOM entry points run (they raised before EOM was ported): on a
    copy of the fixture's ECW with targets of its own, Build_ES_exp_EOM
    adds one 'trmat' state; ESexp.EOM returns its omega."""
    import copy

    ecw = copy.copy(sto3g_es)
    ecw.exp_data = [list(x) for x in sto3g_es.exp_data]
    ecw.HF_prop = [list(x) for x in sto3g_es.HF_prop]
    ecw.Eexp_ES, ecw.r_ini = [], list(sto3g_es.r_ini)
    ecw.Build_ES_exp_EOM(1)
    assert ecw.exp_data[-1][0][0] == "trmat" and len(ecw.r_ini) == 2
    assert len(sto3g_es.exp_data) == 2 and len(sto3g_es.r_ini) == 1
    w = gamma_exp.ESexp(sto3g_es.mol, device="cpu",
                        dtype=torch.float64).EOM(1)
    assert abs(w[0] - ecw.Eexp_ES[0][0]) < 1e-9
    assert gamma_exp._spin_label(sto3g_es.r_ini[0]) in ("singlet", "triplet")
    g = np.arange(16.0).reshape(4, 4)
    assert np.array_equal(gamma_exp._swap_ov_vo(gamma_exp._swap_ov_vo(g, 2),
                                                2), g)


def test_es_solver_argument_checks(sto3g_es):
    ecw = sto3g_es
    V = Exp(0.1, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    with pytest.raises(ValueError, match="convergence parameter"):
        Solver_ES(Gccs(ecw.eris), V, conv_var="x")
    with pytest.raises(ValueError, match="initial r vectors"):
        Solver_ES(Gccs(ecw.eris), V, rn_ini=[ecw.r_ini[0]] * 2)
    S = Solver_ES(Gccs(ecw.eris), V)          # Koopman guess of its own
    assert np.array_equal(S.rn_ini[0], ecw.r_ini[0])
    assert isinstance(S.r0_ini[0], float)
    V.prop_names[1][0] = "quadrupole"
    with pytest.raises(NotImplementedError, match="device ES solver"):
        SolverES_Device(S)
