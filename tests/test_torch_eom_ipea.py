"""EOM-IP/EA-CCSD of the PyTorch port (ecw_cc_torch/ops/eom_ipea.py)
against the JAX package, f64 on the CPU: the sigma matrices at random
amplitudes (dense, and the EA ladder through the packed route), the
determinant-space identity against ecw_cc_tpu.oracle.hbar_in_sector, the
exact IP of a 2-electron system, the Davidson roots and vectors, Dyson
orbitals, and the left vectors' x2 metric.

The JAX twin's solver terms are seeded from the port's term table (the
generator takes about 35 s per doubles block; tests/test_torch_wick.py
holds the table equal to both packages' generators), so these tests
compare the evaluation: contraction, packing, vjp, Davidson."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecw_cc_tpu.ops import eom_ipea as jip
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import eom_ipea as tip
from ecw_cc_torch.ops import ladder as tladder
from test_eom_ipea import (_detspace_matrix, _geris_from_fv, _lambda_bra,
                           _rand_amps, _rand_fv, _r_vector, _rect_op,
                           _sigma_matrix, _unit_r, _pack_sigma)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_terms_from_the_table(monkeypatch):
    """The JAX twin's connected terms, from the port's table."""
    for kind in ("ip", "ea"):
        for rank in (1, 2):
            monkeypatch.setitem(jip._TERMS_CACHE, (kind, rank, True),
                                tip._terms(kind, rank, True))


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _port_eris(eris_jax):
    return from_numpy(eris_jax, dtype=torch.float64, device="cpu")


def _port_sigma_matrix(eris, t1, t2, kind, connected, vvvv_op=None):
    """The port's sigma as a matrix on the packed (i<j / a<b) basis."""
    nocc, nvir = np.asarray(t1).shape
    sigma, _ = tip.make_sigma_ipea(eris, _t(t1), _t(t2), kind,
                                   connected=connected, vvvv_op=vvvv_op)
    if kind == "ip":
        dim = nocc + nocc * (nocc - 1) // 2 * nvir
    else:
        dim = nvir + nocc * nvir * (nvir - 1) // 2
    cols = []
    for col in range(dim):
        r1, r2 = _unit_r(nocc, nvir, kind, col)
        s1, s2 = sigma(_t(r1), _t(r2))
        cols.append(_pack_sigma(s1.numpy(), s2.numpy(), nocc, nvir, kind))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("kind,nmo,nocc", [("ip", 6, 3), ("ea", 6, 2)])
def test_sigma_matrix_matches_jax(kind, nmo, nocc):
    """The connected sigma matrix at random amplitudes, to 1e-12."""
    f, v = _rand_fv(nmo, nocc, seed=5)
    t1, t2 = _rand_amps(nocc, nmo - nocc, seed=6)
    ej = _geris_from_fv(f, v, nocc)
    A_j = _sigma_matrix(ej, t1, t2, kind, connected=True)
    A_t = _port_sigma_matrix(_port_eris(ej), t1, t2, kind, True)
    assert np.abs(A_j - A_t).max() < 1e-12


def test_ea_packed_ladder_matches_dense():
    """On pack-on-build ERIs (no dense vvvv) the EA sigma's two <ab||cd>
    terms ride one PackedVVVV product: equal to the dense einsums, to the
    JAX twin's packed route, and refused without the operand."""
    from ecw_cc_tpu.ops.ladder import pack_vvvv

    nmo, nocc = 6, 2
    nvir = nmo - nocc
    f, v = _rand_fv(nmo, nocc, seed=3)
    t1, t2 = _rand_amps(nocc, nvir, seed=4)
    ej = _geris_from_fv(f, v, nocc)
    et = _port_eris(ej)
    A_dense = _port_sigma_matrix(et, t1, t2, "ea", True)
    et_p = et._replace(vvvv=torch.zeros((nvir, 0, 0, 0), dtype=torch.float64))
    A_packed = _port_sigma_matrix(et_p, t1, t2, "ea", True,
                                  vvvv_op=tladder.pack_vvvv(et.vvvv))
    ej_p = ej._replace(vvvv=jnp.zeros((nvir, 0, 0, 0)))
    A_jax = _sigma_matrix(ej_p, t1, t2, "ea", connected=True,
                          vvvv_op=pack_vvvv(ej.vvvv))
    assert np.abs(A_dense - A_packed).max() < 1e-12
    assert np.abs(A_jax - A_packed).max() < 1e-12
    with pytest.raises(NotImplementedError):
        tip.make_sigma_ipea(et_p, _t(t1), _t(t2), "ea")
    with pytest.raises(NotImplementedError):
        tip._ea_vvvv_packed(object(), _t(t1), torch.zeros(nvir),
                            torch.zeros(nocc, nvir, nvir), ())


@pytest.mark.parametrize("kind,nmo,nocc", [("ip", 6, 3), ("ea", 6, 2)])
def test_sigma_matches_detspace_at_random_amps(kind, nmo, nocc):
    """With the R-disconnected terms kept (connected=False) the sigma
    matrix is P (e^-T H_N e^T) P on the 1h+2h1p / 1p+2p1h determinants
    (ecw_cc_tpu.oracle.hbar_in_sector), at any amplitudes."""
    f, v = _rand_fv(nmo, nocc)
    t1, t2 = _rand_amps(nocc, nmo - nocc)
    A = _port_sigma_matrix(_port_eris(_geris_from_fv(f, v, nocc)), t1, t2,
                           kind, False)
    M = _detspace_matrix(f, v, nocc, kind, t1, t2)
    assert A.shape == M.shape
    assert np.abs(A - M).max() < 1e-10


@pytest.fixture(scope="module")
def h2(h2_631g):
    """H2/6-31G (2 electrons): port eris, converged amplitudes, Lambda."""
    from ecw_cc_torch.models.gamma_exp import solve_lambda
    from ecw_cc_torch.ops.ccsd_t import solve_ccsd

    mol, ghf, _, ej = h2_631g
    er = _port_eris(ej)
    t1, t2, ecc = solve_ccsd(er, conv_tol=1e-13)
    l1, l2 = solve_lambda(er, t1, t2, conv_tol=1e-11)
    e_ref = ghf.e_tot - mol.energy_nuc()
    return mol, ghf, er, t1, t2, float(ecc), e_ref, l1, l2


def test_ip_exact_for_two_electrons(h2):
    """1h+2h1p spans the 1-electron sector of a 2-electron system: every
    EOM-IP eigenvalue is a 1-electron eigenvalue minus E_CCSD, to 1e-8."""
    mol, ghf, er, t1, t2, ecc, e_ref, _, _ = h2
    A = _port_sigma_matrix(er, t1.numpy(), t2.numpy(), "ip", True)
    w = np.sort(np.linalg.eigvals(A).real)
    h_ao = ghf._rhf.get_hcore()
    nao = h_ao.shape[0]
    h_g = np.zeros((2 * nao, 2 * nao))
    h_g[:nao, :nao] = h_g[nao:, nao:] = h_ao
    e1 = np.sort(np.linalg.eigvalsh(ghf.mo_coeff.T @ h_g @ ghf.mo_coeff))
    assert w.shape == e1.shape
    assert np.abs(w - (e1 - (e_ref + ecc))).max() < 1e-8


@pytest.mark.parametrize("kind", ["ip", "ea"])
def test_davidson_roots_match_jax(h2o_sto3g, kind):
    """eom_ipea_ccsd with left vectors: roots to 1e-9 Ha of the JAX twin's
    and of the dense matrix; the right vectors, Dyson pole strengths and
    orbitals of non-degenerate roots as the twin's (a degenerate pair's
    vectors are any basis of its plane)."""
    from ecw_cc_tpu.ops.ccsd_t import solve_ccsd

    _, _, _, ej = h2o_sto3g
    t1, t2, _ = solve_ccsd(ej, conv_tol=1e-12)
    er = _port_eris(ej)
    wj, Rj, Lj = jip.eom_ipea_ccsd(ej, t1, t2, kind, nroots=3, tol=1e-9,
                                   left=True)
    log = {}
    wt, Rt, Lt = tip.eom_ipea_ccsd(er, _t(t1), _t(t2), kind, nroots=3,
                                   tol=1e-9, left=True, log=log)
    assert np.abs(np.asarray(wj) - np.asarray(wt)).max() < 1e-9
    assert log["right"]["converged"] == [True] * 3
    dj = jip.dyson_orbitals(t1, t2, Rj, Lj, kind)
    dt = tip.dyson_orbitals(_t(t1), _t(t2), Rt, Lt, kind)
    for k in range(3):
        assert abs(dj[k][2] - dt[k][2]) < 1e-9
        others = [abs(wt[k] - wt[m]) for m in range(3) if m != k]
        if min(others) > 1e-6:
            for a, b in zip(Rj[k] + Lj[k], Rt[k] + Lt[k]):
                assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-7
            assert np.abs(dj[k][0] - dt[k][0]).max() < 1e-8
            assert np.abs(dj[k][1] - dt[k][1]).max() < 1e-8


@pytest.mark.parametrize("kind", ["ip", "ea"])
def test_dyson_matches_detspace_at_random_amps(kind):
    """d^L and d^R against the determinant-space construction of
    tests/test_eom_ipea.py, at random amplitudes, Lambda and L = R."""
    from ecw_cc_tpu.oracle import cluster_matrices

    nmo, nocc = 6, 3 if kind == "ip" else 2
    nvir = nmo - nocc
    t1, t2 = _rand_amps(nocc, nvir, seed=8)
    lam1, lam2 = _rand_amps(nocc, nvir, seed=9)
    rng = np.random.default_rng(10)
    if kind == "ip":
        x1 = rng.standard_normal(nocc)
        x2 = rng.standard_normal((nocc, nocc, nvir))
        x2 = 0.5 * (x2 - x2.transpose(1, 0, 2))
    else:
        x1 = rng.standard_normal(nvir)
        x2 = rng.standard_normal((nocc, nvir, nvir))
        x2 = 0.5 * (x2 - x2.transpose(0, 2, 1))
    [(dL, dR, s)] = tip.dyson_orbitals(
        _t(t1), _t(t2), [(_t(x1), _t(x2))], [(_t(x1), _t(x2))], kind,
        lam1=lam1, lam2=lam2)
    nelec = nocc - 1 if kind == "ip" else nocc + 1
    spaceN, UN, UinvN = cluster_matrices(nmo, nocc, nocc, t1, t2)
    spaceM, UM, UinvM = cluster_matrices(nmo, nocc, nelec, t1, t2)
    e0 = np.zeros(spaceN.dim)
    e0[spaceN.index[(1 << nocc) - 1]] = 1.0
    vec = _r_vector(spaceM, nocc, nmo, kind, x1, x2)
    lbra = _lambda_bra(spaceN, nocc, nmo, lam1, lam2)
    dL_ref, dR_ref = np.zeros(nmo), np.zeros(nmo)
    for p in range(nmo):
        A = _rect_op(spaceN, spaceM, p, create=(kind == "ea"))
        dL_ref[p] = vec @ (UinvM @ A @ UN @ e0)
        C = _rect_op(spaceM, spaceN, p, create=(kind == "ip"))
        dR_ref[p] = lbra @ (UinvN @ C @ UM @ vec)
    assert np.abs(dL - dL_ref).max() < 1e-11
    assert np.abs(dR - dR_ref).max() < 1e-11
    assert abs(s - dL_ref @ dR_ref) < 1e-10


def test_left_vectors_take_the_x2_metric(h2):
    """The raw left eigenvector of the transposed IP map is (l1, l2/2) and
    l1.r1 + 1/2 l2.r2 = 1; the lowest IP of H2 has a pole strength close
    to 1, dominated by the occupied 1h component."""
    _, _, er, t1, t2, _, _, l1g, l2g = h2
    w, Rs, Ls = tip.eom_ip_ccsd(er, t1, t2, nroots=1, tol=1e-9, left=True)
    _, sigma_left = tip.make_sigma_ipea(er, t1, t2, "ip")
    l1, l2 = Ls[0]
    s1, s2 = sigma_left(l1, l2 / 2.0)
    s2 = 0.5 * (s2 - s2.permute(1, 0, 2))
    assert (s1 - w[0] * l1).abs().max() < 1e-6
    assert (s2 - w[0] * (l2 / 2.0)).abs().max() < 1e-6
    ov = (torch.vdot(l1, Rs[0][0])
          + 0.5 * torch.vdot(l2.reshape(-1), Rs[0][1].reshape(-1)))
    assert abs(float(ov) - 1.0) < 1e-8
    [(dL, dR, s)] = tip.dyson_orbitals(t1, t2, Rs, Ls, "ip", lam1=l1g,
                                       lam2=l2g)
    assert 0.7 < s <= 1.0001
    assert np.argmax(np.abs(dL)) < er.nocc


def test_term_table_serves_the_solver():
    """The solver reads its connected terms from the table: both kinds and
    ranks present, in the generator's tuple form."""
    for kind in ("ip", "ea"):
        for rank in (1, 2):
            terms = tip._terms(kind, rank, True)
            assert terms and all(isinstance(p, tuple) and isinstance(p[0],
                                                                     tuple)
                                 for _, p, _ in terms)
