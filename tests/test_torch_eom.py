"""EOM-EE-CCSD of the PyTorch port (ecw_cc_torch/ops/eom.py, ESexp.EOM,
ECW.Build_ES_exp_EOM) against the JAX package, f64 on the CPU, on the JAX
fixtures' ERIs (one SCF, so MO-basis arrays compare as they are) or, for
the entry points, through tests/gauge.py; the FCI identities of
tests/test_eom.py for two electrons; the x4 metric of the left vectors;
the sectored sigma without the mirror gate's sym; the solver's matvecs off
the residual kept once per problem against torch.func.jvp and vjp, and
their Davidson cycle bodies capturable; and the ladder kernel's tangent
rule with the launch replaced by the plain product (no kernel runs off
the card), down to the launches an EOM solve makes per matvec."""

import contextlib
import io
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecw_cc_tpu.ops import ccsd_t as jct
from ecw_cc_tpu.ops import eom as jeom
from ecw_cc_tpu.ops import ladder as jladder
from ecw_cc_torch.kernels import ladder_mm as lmm
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import ccsd_t as tct
from ecw_cc_torch.ops import eom as teom
from ecw_cc_torch.ops import ladder as tladder
from ecw_cc_torch.ops.spinsect import SectorInfo
from test_torch_davidson import assert_programs_capturable, recorded_programs  # noqa: F401

torch.set_num_threads(1)

ROUTES = ["dense", "packed", "sectored"]


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_sorted(h2o_sto3g):
    """The JAX package's sorted f64 ERIs of H2O/STO-3G (dense and
    pack-on-build with a SectoredVVVV) and their SectorInfo."""
    from test_ccsd_kernels import _sorted_system

    _, _, er, er_dense, sect, _, info = _sorted_system(h2o_sto3g)
    return er, er_dense, sect, info


@pytest.fixture(scope="module")
def systems(h2o_sto3g):
    """Per route: (JAX eris, JAX vvvv_op, JAX sect, port eris, port
    vvvv_op, port sect, t1, t2 as NumPy), converged CCSD amplitudes."""
    _, _, _, ej = h2o_sto3g
    t1, t2, _ = jct.solve_ccsd(ej, conv_tol=1e-11)
    er = from_numpy(ej, dtype=torch.float64, device="cpu")
    out = {"dense": (ej, None, None, er, None, None, t1, t2),
           "packed": (ej, jladder.pack_vvvv(ej.vvvv), None, er,
                      tladder.pack_vvvv(er.vvvv), None, t1, t2)}
    ejs, ejs_dense, jsect, info = _jax_sorted(h2o_sto3g)
    ts1, ts2, _ = jct.solve_ccsd(ejs_dense, conv_tol=1e-11)
    ers, top = from_numpy(ejs, jsect, dtype=torch.float64, device="cpu")
    tinfo = SectorInfo(*info)
    out["sectored"] = (ejs, jsect, (info, True), ers, top, (tinfo, True),
                       ts1, ts2)
    # the sorted layout with its dense vvvv: the sectored sigma's reference
    out["sorted_dense"] = from_numpy(ejs_dense, dtype=torch.float64,
                                     device="cpu")
    return out


def _random_vectors(nocc, nvir, seed, balanced=None):
    """Antisymmetric (r1, r2), masked to the spin balance of the sorted
    layout when `balanced` is a SectorInfo."""
    rng = np.random.default_rng(seed)
    r1 = rng.standard_normal((nocc, nvir))
    r2 = rng.standard_normal((nocc, nocc, nvir, nvir))
    r2 = r2 - r2.transpose(1, 0, 2, 3)
    r2 = r2 - r2.transpose(0, 1, 3, 2)
    if balanced is not None:
        m1, m2 = teom._balance_masks(nocc, nvir, balanced)
        r1, r2 = r1 * m1, r2 * m2
    return r1, r2


@pytest.mark.parametrize("route", ROUTES)
def test_sigmas_match_jax(systems, route):
    """The right (jvp) and left (vjp) sigmas at random vectors, to 1e-11
    relative, on each ladder route."""
    ej, jop, jsect, er, top, tsect, t1, t2 = systems[route]
    nocc, nvir = np.asarray(t1).shape
    r1, r2 = _random_vectors(nocc, nvir, 3, None if tsect is None
                             else tsect[0])
    sj, slj = jeom.make_sigma(ej, jnp.asarray(t1), jnp.asarray(t2),
                              vvvv_op=jop, sect=jsect)
    st, slt = teom.make_sigma(er, _t(t1), _t(t2), vvvv_op=top, sect=tsect)
    for fj, ft in ((sj, st), (slj, slt)):
        want = fj(jnp.asarray(r1), jnp.asarray(r2))
        got = ft(_t(r1), _t(r2))
        for a, b in zip(want, got):
            a = np.asarray(a)
            assert np.abs(a - _np(b)).max() < 1e-11 * max(1.0,
                                                           np.abs(a).max())


@pytest.mark.parametrize("route", ROUTES)
def test_eom_ccsd_matches_jax(systems, route):
    """Two roots with their left vectors: omegas to 1e-9 Ha, R and the
    metric-corrected, biorthonormalised L to 1e-7, and the Davidson's
    cycles logged."""
    ej, jop, jsect, er, top, tsect, t1, t2 = systems[route]
    wj, Rj, Lj = jeom.eom_ccsd(ej, jnp.asarray(t1), jnp.asarray(t2),
                               nroots=2, tol=1e-8, left=True, vvvv_op=jop,
                               sect=jsect)
    log = {}
    wt, Rt, Lt = teom.eom_ccsd(er, _t(t1), _t(t2), nroots=2, tol=1e-8,
                               left=True, vvvv_op=top, sect=tsect, log=log)
    assert np.abs(np.asarray(wj) - np.asarray(wt)).max() < 1e-9
    for k in range(2):
        for a, b in zip(Rj[k] + Lj[k], Rt[k] + Lt[k]):
            assert np.abs(np.asarray(a) - _np(b)).max() < 1e-7
    assert log["right"]["converged"] == [True, True]
    assert log["left"]["converged"] == [True, True]
    assert log["right"]["matvecs"] >= log["right"]["cycles"] > 1


def test_densities_and_r0_match_jax(systems):
    """tr_rdm1_right, tr_rdm1_left, es_rdm1 and eom_r0 against the JAX
    package at its own converged roots."""
    from ecw_cc_tpu.models.gamma_exp import solve_lambda

    ej, _, _, er, _, _, t1, t2 = systems["dense"]
    t1j, t2j = jnp.asarray(t1), jnp.asarray(t2)
    lam1, lam2 = solve_lambda(ej, t1j, t2j, conv_tol=1e-11)
    w, Rs, Ls = jeom.eom_ccsd(ej, t1j, t2j, nroots=2, tol=1e-9, left=True)
    T1, T2 = _t(t1), _t(t2)
    for k in range(2):
        r1, r2 = map(jnp.asarray, Rs[k])
        e1, e2 = map(jnp.asarray, Ls[k])
        r0j = jeom.eom_r0(ej, t1j, t2j, r1, r2, w[k])
        r0t = teom.eom_r0(er, T1, T2, _t(Rs[k][0]), _t(Rs[k][1]), w[k])
        assert abs(r0j - r0t) < 1e-10
        pairs = (
            (jeom.tr_rdm1_right(t1j, t2j, lam1, lam2, r1, r2, r0j),
             teom.tr_rdm1_right(T1, T2, _t(lam1), _t(lam2), _t(Rs[k][0]),
                                _t(Rs[k][1]), r0t)),
            (jeom.tr_rdm1_left(t1j, t2j, e1, e2),
             teom.tr_rdm1_left(T1, T2, _t(Ls[k][0]), _t(Ls[k][1]))),
            (jeom.es_rdm1(t1j, t2j, e1, e2, r1, r2, r0j),
             teom.es_rdm1(T1, T2, _t(Ls[k][0]), _t(Ls[k][1]), _t(Rs[k][0]),
                          _t(Rs[k][1]), r0t)))
        for a, b in pairs:
            assert np.abs(np.asarray(a) - _np(b)).max() < 1e-11


def test_contract_follows_a_path():
    """ops/eom.contract: a four-operand term equals torch.einsum's."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((3, 4, 5, 6)))
    b = torch.tensor(rng.standard_normal((3, 4, 5, 6)))
    c = torch.tensor(rng.standard_normal((3, 5)))
    d = torch.tensor(rng.standard_normal((4, 6)))
    expr = "ijab,klcd,ia,jb->klcd"
    want = torch.einsum(expr, a, b, c, d)
    assert (teom.contract(expr, a, b, c, d) - want).abs().max() < 1e-12


def _fci(eris_host, nocc):
    from ecw_cc_tpu.oracle import CCOracle
    from tests.test_ccs_kernels import _assemble_full_eri

    oracle = CCOracle(np.asarray(eris_host.fock),
                      _assemble_full_eri(eris_host), nocc)
    return oracle


@pytest.fixture(scope="module")
def h2_port(h2_631g):
    """H2/6-31G: port eris, converged t, Lambda and the EOM roots with
    left vectors (tests/test_eom.py's 2-electron system)."""
    from ecw_cc_torch.models.gamma_exp import solve_lambda

    mol, ghf, eris_host, ej = h2_631g
    er = from_numpy(ej, dtype=torch.float64, device="cpu")
    t1, t2, _ = tct.solve_ccsd(er, conv_tol=1e-13)
    l1, l2 = solve_lambda(er, t1, t2, conv_tol=1e-12)
    w, Rs, Ls = teom.eom_ccsd(er, t1, t2, nroots=4, tol=1e-9, left=True)
    return mol, ghf, eris_host, er, t1, t2, l1, l2, w, Rs, Ls


def test_eom_ccsd_equals_fci_for_two_electrons(h2_port):
    """CCSD is FCI for two electrons: every EOM root is an FCI excitation
    energy to 1e-7."""
    _, _, eris_host, er, _, _, _, _, w, _, _ = h2_port
    oracle = _fci(eris_host, er.nocc)
    ev = np.sort(np.linalg.eigvalsh(oracle.H))
    exc = ev[1:] - ev[0]
    for om in w:
        assert om > 0
        assert np.min(np.abs(exc - om)) < 1e-7, (om, exc[:6])


def test_transition_dipole_product_equals_fci(h2_port):
    """The biorthogonal product of the left and right transition dipoles
    equals the exact |<0|mu|k>|^2 for two electrons, at every
    non-degenerate root; the port's left density is the ov/vo-swapped
    ops/ccsd.tr_rdm1_left of the reference convention."""
    from ecw_cc_torch.ops import ccsd as tccsd
    from ecw_cc_torch.utils import props

    mol, ghf, eris_host, er, t1, t2, l1, l2, w, Rs, Ls = h2_port
    dip_int = mol.intor("r", origin=mol.charge_center())
    no = er.nocc
    fs = []
    for k in range(len(w)):
        r0 = teom.eom_r0(er, t1, t2, Rs[k][0], Rs[k][1], w[k])
        tr_l = _np(teom.tr_rdm1_right(t1, t2, l1, l2, *Rs[k], r0))
        tr_r = _np(teom.tr_rdm1_left(t1, t2, *Ls[k]))
        ref = _np(tccsd.tr_rdm1_left(t1, t2, *Ls[k]))
        swp = tr_r.copy()
        swp[:no, no:] = tr_r[no:, :no].T
        swp[no:, :no] = tr_r[:no, no:].T
        assert np.abs(swp - ref).max() < 1e-10
        dl = props.dipole(mol, tr_l, g=True, aobasis=False,
                          mo_coeff=ghf.mo_coeff, dip_int=dip_int)
        dr = props.dipole(mol, tr_r, g=True, aobasis=False,
                          mo_coeff=ghf.mo_coeff, dip_int=dip_int)
        fs.append(float(np.dot(dl, dr)))
    oracle = _fci(eris_host, no)
    ev, V = np.linalg.eigh(oracle.H)
    nao, C = mol.nao, ghf.mo_coeff
    ops = []
    for x in range(3):
        mu = np.zeros((2 * nao, 2 * nao))
        mu[:nao, :nao] = mu[nao:, nao:] = dip_int[x]
        ops.append(oracle.space.op_matrix_1e(C.T @ mu @ C))
    checked = 0
    for k, om in enumerate(w):
        idx = np.where(np.abs((ev - ev[0]) - om) < 1e-7)[0]
        if len(idx) != 1:
            continue      # a degenerate level: no single-root moment
        f_fci = sum(float(V[:, 0] @ M @ V[:, idx[0]]) ** 2 for M in ops)
        assert abs(fs[k] - f_fci) < 1e-7, (k, om, fs[k], f_fci)
        checked += 1
    assert checked >= 1 and max(map(abs, fs)) > 1e-3


def test_left_vectors_take_the_x4_metric(systems):
    """The returned L are operator-convention amplitudes: the raw left
    eigenvector of the transposed map is (l1, l2/4), and
    l1.r1 + 1/4 l2.r2 = 1; without the x4 the raw vector is no
    eigenvector."""
    ej, _, _, er, _, _, t1, t2 = systems["dense"]
    T1, T2 = _t(t1), _t(t2)
    w, Rs, Ls = teom.eom_ccsd(er, T1, T2, nroots=2, tol=1e-9, left=True)
    _, sigma_left = teom.make_sigma(er, T1, T2)

    def residual(l1, l2):
        s1, s2 = sigma_left(l1, l2)
        s2 = teom._asym(s2)
        r = torch.cat([s1.reshape(-1), s2.reshape(-1)])
        lv = torch.cat([l1.reshape(-1), l2.reshape(-1)])
        return float(torch.linalg.norm(r - w[k] * lv) / torch.linalg.norm(lv))

    for k in range(2):
        l1, l2 = Ls[k]
        ov = (torch.vdot(l1.reshape(-1), Rs[k][0].reshape(-1))
              + 0.25 * torch.vdot(l2.reshape(-1), Rs[k][1].reshape(-1)))
        assert abs(float(ov) - 1.0) < 1e-10
        assert residual(l1, l2 / 4.0) < 1e-6
        assert residual(l1, l2) > 1e-3 or float(l2.abs().max()) < 1e-8


def test_sectored_sigma_does_not_take_the_gates_sym(systems):
    """The sorted layout's gate passes (sym=True) at the mirror-symmetric
    amplitudes, but a tangent need not be mirror-symmetric (a triplet is
    not): make_sigma with sect=(info, True) must equal the dense Jacobian
    on a balanced, non-mirror-symmetric vector, which a jvp of the
    mirror-halved update (sym=True) does not."""
    from ecw_cc_torch.ops.ccsd_sect import tupdate_sect

    _, _, _, er, top, (info, sym), t1, t2 = systems["sectored"]
    assert sym is True
    T1, T2 = _t(t1), _t(t2)
    nocc, nvir = T1.shape
    r1, r2 = (_t(x) for x in _random_vectors(nocc, nvir, 11, info))
    s_dense = teom.make_sigma(systems["sorted_dense"], T1, T2)[0](r1, r2)
    s_sect = teom.make_sigma(er, T1, T2, vvvv_op=top,
                             sect=(info, True))[0](r1, r2)
    for a, b in zip(s_dense, s_sect):
        assert (a - b).abs().max() < 1e-10

    def folded(a, b):
        return tupdate_sect(er, a, b, er.fock, info, vvvv_op=top, sym=True,
                            equation=True)

    _, s_sym = torch.func.jvp(folded, (T1, T2), (r1, r2))
    assert max(float((a - b).abs().max())
               for a, b in zip(s_dense, s_sym)) > 1e-3


def _stand_in_launch(counts):
    """_launch replaced by the plain product, counting like the wrapper;
    it reads data_ptr() as the launch does, so a wrapped tensor fails."""
    def stand_in(a, b, backward=False, precision=None, tangent=False):
        a.data_ptr()
        b.data_ptr()
        counts["forward"] += not backward and not tangent
        counts["tangent"] += bool(tangent) or backward == "second"
        counts["backward"] += backward is True
        return a @ b.T
    return stand_in


@pytest.mark.parametrize("symmetric", [True, False])
def test_ladder_mm_tangent_with_a_stand_in_launch(monkeypatch, symmetric):
    """_LadderMM under torch.func.jvp and under forward-mode AD: the
    tangent is dA @ B.T, one more launch counted as a tangent (its forward
    sees plain tensors); a tangent on B raises."""
    import torch.autograd.forward_ad as fwAD

    counts = dict(forward=0, tangent=0, backward=0)
    monkeypatch.setattr(lmm, "_launch", _stand_in_launch(counts))
    rng = np.random.default_rng(4)
    a, da = (torch.tensor(rng.standard_normal((5, 7))) for _ in range(2))
    w = torch.tensor(rng.standard_normal((7, 7)))
    if symmetric:
        w = w + w.T
    fn = lambda x: lmm._LadderMM.apply(x, w, symmetric, False)   # noqa: E731
    c, dc = torch.func.jvp(fn, (a,), (da,))
    assert (c - a @ w.T).abs().max() < 1e-13
    assert (dc - da @ w.T).abs().max() < 1e-13
    assert counts == dict(forward=1, tangent=1, backward=0)
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(a, da))
        assert (fwAD.unpack_dual(out).tangent - da @ w.T).abs().max() < 1e-13
    assert counts == dict(forward=2, tangent=2, backward=0)
    with pytest.raises(RuntimeError, match="second operand"):
        torch.func.jvp(lambda x, y: lmm._LadderMM.apply(x, y, symmetric,
                                                        False),
                       (a, w), (da, torch.ones_like(w)))


def test_reduced_precision_product_has_no_tangent():
    """A jvp through the TF32 product raises with a message naming it."""
    a = torch.randn(4, 6)
    w = torch.randn(5, 6)
    with pytest.raises(RuntimeError, match="no tangent through a reduced"):
        torch.func.jvp(lambda x: lmm.ladder_mm(x, w, precision="tf32"),
                       (a,), (torch.randn(4, 6),))


@pytest.mark.parametrize("route", ["packed", "sectored"])
def test_eom_solve_launches_per_matvec(monkeypatch, systems, route):
    """With every ladder product sent through _LadderMM and the launch
    replaced by the plain product (as on the card, where ladder_mm takes
    that path): the problem's primal makes one forward launch per product
    and its linear map's graph one backward, then each right matvec one
    tangent launch per product (a double backward) and each left matvec
    one backward; no matvec makes a forward launch, and the roots do not
    move."""
    _, _, _, er, top, tsect, t1, t2 = systems[route]
    counts = dict(forward=0, tangent=0, backward=0)
    monkeypatch.setattr(lmm, "_launch", _stand_in_launch(counts))
    monkeypatch.setattr(
        tladder, "ladder_mm",
        lambda a, b, symmetric=False, precision=None:
        lmm._LadderMM.apply(a, b, bool(symmetric), False))
    log = {}
    w, _, _ = teom.eom_ccsd(er, _t(t1), _t(t2), nroots=2, tol=1e-8,
                            left=True, vvvv_op=top, sect=tsect, log=log)
    products = 1 if route == "packed" else 3
    right = log["right"]["matvecs"]
    left = log["left"]["matvecs"] + sum(
        x["matvecs"] for x in log.get("left_follow", []))
    assert counts == dict(forward=products,
                          tangent=products * right,
                          backward=products * (1 + left))
    monkeypatch.undo()
    w0, _ = teom.eom_ccsd(er, _t(t1), _t(t2), nroots=2, tol=1e-8,
                          vvvv_op=top, sect=tsect)
    assert np.abs(np.asarray(w) - np.asarray(w0)).max() < 1e-9


@pytest.mark.parametrize("route", ROUTES)
def test_linearized_matvecs_equal_jvp_and_vjp(monkeypatch, systems, route):
    """The solver's matvecs off the residual kept once per problem
    (_linearize): the right one (a double backward) equals make_sigma's
    torch.func.jvp and the left one its fresh vjp, to 1e-12 relative; with
    every ladder product through _LadderMM and a stand-in launch, the
    problem launches each product once forward and once backward, and a
    matvec then launches no forward product: a right one one tangent per
    product, a left one one backward."""
    _, _, _, er, top, tsect, t1, t2 = systems[route]
    T1, T2 = _t(t1), _t(t2)
    nocc, nvir = T1.shape
    info = None if tsect is None else tsect[0]
    r1, r2 = (_t(x) for x in _random_vectors(nocc, nvir, 5, info))
    l1, l2 = (_t(x) for x in _random_vectors(nocc, nvir, 6, info))
    sigma, sigma_left = teom.make_sigma(er, T1, T2, vvvv_op=top, sect=tsect)
    want = (sigma(r1, r2), sigma_left(l1, l2))
    counts = dict(forward=0, tangent=0, backward=0)
    monkeypatch.setattr(lmm, "_launch", _stand_in_launch(counts))
    monkeypatch.setattr(
        tladder, "ladder_mm",
        lambda a, b, symmetric=False, precision=None:
        lmm._LadderMM.apply(a, b, bool(symmetric), False))
    right, left = teom._linearize(er, top, None, T1, T2, tsect)
    k = counts["forward"]
    assert k > 0 and counts == dict(forward=k, tangent=0, backward=k)
    got = (right(r1, r2), left(l1, l2))
    assert counts == dict(forward=k, tangent=k, backward=2 * k)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            assert (a - b).abs().max() < 1e-12 * max(1.0, a.abs().max())


@pytest.mark.parametrize("route", ROUTES)
def test_eom_davidson_bodies_are_capturable(systems, recorded_programs,
                                            route):
    """The right and left solves' cycle and collapse bodies, the
    linearised matvecs inside, read nothing to the host and issue the
    same operations at every call (a small basis forces collapses)."""
    _, _, _, er, top, tsect, t1, t2 = systems[route]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        teom.eom_ccsd(er, _t(t1), _t(t2), nroots=1, tol=1e-8, left=True,
                      vvvv_op=top, sect=tsect, max_space=3, max_cycle=7)
    assert_programs_capturable(recorded_programs)


# ---------------------------------------------------------------------------
# the entry points against the JAX package (one orbital gauge)
# ---------------------------------------------------------------------------

def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


@pytest.fixture(scope="module")
def eom_targets():
    """ECW('h2o', 'sto-3g').Build_ES_exp_EOM(2, prop) of both packages,
    for each prop, and the orbital signs that take the port's ESexp SCF to
    the JAX one's, per spin orbital."""
    from ecw_cc_tpu import ECW as JaxECW
    from ecw_cc_torch import ECW
    from gauge import orbital_signs

    out = {}
    for prop in ("trmat", "trdip", "mat"):
        j = _quiet(JaxECW, "h2o", "sto-3g")
        _quiet(j.Build_ES_exp_EOM, 2, prop=prop)
        t = _quiet(ECW, "h2o", "sto-3g", device="cpu", dtype=torch.float64)
        _quiet(t.Build_ES_exp_EOM, 2, prop=prop)
        out[prop] = (j, t)
    t = out["trmat"][1]
    S = t.mol.intor("ovlp")
    from ecw_cc_tpu.models.gamma_exp import ESexp as JaxESexp
    from ecw_cc_tpu.models.molecule import Molecule as JaxMolecule

    jes = _quiet(JaxESexp, JaxMolecule("h2o", "sto-3g"))
    d = orbital_signs(t.es_eom.mo_coeff, jes.mo_coeff, S)
    return out, np.repeat(d, 2)


@pytest.mark.parametrize("prop", ["trmat", "trdip", "mat"])
def test_build_es_exp_eom_matches_jax(eom_targets, prop):
    """Excitation energies to 1e-9 Ha, oscillator strengths and spin labels;
    the targets (transition rdm1s, dipoles, excited-state densities) and
    the R1 guesses in the JAX orbital gauge, up to the one sign the
    canonical phase then fixes."""
    from gauge import flip

    out, d = eom_targets
    j, t = out[prop]
    nocc = int(np.sum(t.mo_occ > 0))
    assert np.abs(np.asarray(j.Eexp_ES[0]) - np.asarray(t.Eexp_ES[0])).max() \
        < 1e-9
    assert np.abs(np.asarray(j.f_osc_ES) - np.asarray(t.f_osc_ES)).max() \
        < 1e-9
    assert j.spin_ES == t.spin_ES
    assert len(t.exp_data) == 3 and len(t.r_ini) == 2
    for k in range(2):
        r = flip(t.r_ini[k], d, "ov", nocc)
        s = 1.0 if np.vdot(r, j.r_ini[k]) > 0 else -1.0
        assert np.abs(s * r - j.r_ini[k]).max() < 1e-8
        (kind_j, val_j), = j.exp_data[k + 1]
        (kind_t, val_t), = t.exp_data[k + 1]
        assert kind_j == kind_t == prop
        if prop == "trmat":
            for a, b in zip(val_j, val_t):
                assert np.abs(s * flip(b, d, "nn", nocc) - a).max() < 1e-8
        elif prop == "mat":
            assert np.abs(flip(val_t, d, "nn", nocc) - val_j).max() < 1e-8
            assert abs(np.trace(val_t) - t.mol.nelectron) < 1e-8
        else:
            assert np.abs(s * np.asarray(val_t) - np.asarray(val_j)).max() \
                < 1e-8
    assert t.es_eom.log["eom"]["right"]["converged"] == [True, True]


def test_es_exp_eom_f32_matches_f64(eom_targets):
    """The f32 ESexp.EOM (spin-sorted build, sectored sigma, balance
    projector, tol 1e-5) gives the f64 roots to 2e-5 Ha and its transition
    rdm1s to 1e-5, permuted back to the alternating layout."""
    from ecw_cc_torch.models import gamma_exp as tg
    from ecw_cc_torch.models.molecule import Molecule

    t64 = eom_targets[0]["trmat"][1].es_eom
    e32 = _quiet(tg.ESexp, Molecule("h2o", "sto-3g"), device="cpu",
                 dtype=torch.float32)
    _quiet(e32.EOM, 2)
    assert e32.log["sym"] is True
    assert np.abs(np.asarray(t64.DE_exp) - np.asarray(e32.DE_exp)).max() \
        < 2e-5
    for k in range(2):
        for s in (0, 1):
            assert np.abs(t64.gamma_tr_mo[k][s]
                          - e32.gamma_tr_mo[k][s]).max() < 1e-5


def test_device_es_solver_starts_from_eom_guesses(eom_targets):
    """CCS_ES(method='device') on EOM targets: the generated R1 guesses
    have no entry equal to 1, so the cold start pins each state at its
    largest entry, as method='scf' does; it converges to finite energies
    within 1e-4 Ha of 'scf'."""
    t = eom_targets[0]["trdip"][1]
    kw = dict(diis="all", conv="rl", conv_thres=1e-5, maxiter=80,
              maxdiis=20, print_ite=False)
    dev = _quiet(t.CCS_ES, 0.05, method="device", **kw)
    scf = _quiet(t.CCS_ES, 0.05, method="scf", **kw)
    for out in (dev, scf):
        assert "Convergence reached" in out[0], out[0]
        assert np.all(np.isfinite(out[3]))
    assert np.abs(dev[3] - scf[3]).max() < 1e-4
