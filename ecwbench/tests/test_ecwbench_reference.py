"""The plain reference: its integrals against published numbers and the
NumPy engine it was copied from, and its answers against the program's
f64 route on the CPU at C2H2/STO-3G."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from ecwbench.reference import aoints, eri, hf, solve
from ecwbench.spec import ROOT

STO3G = aoints.load_basis(os.path.join(ROOT, "ecwbench", "reference",
                                       "basis", "sto-3g.json"))
C2H2 = [("C", (0.0, 0.0, 0.6034010)), ("C", (0.0, 0.0, -0.6034010)),
        ("H", (0.0, 0.0, 1.6667490)), ("H", (0.0, 0.0, -1.6667490))]


def test_h2_sto3g_integrals():
    # Szabo and Ostlund, Table 3.8 (H2, STO-3G, R = 1.4 bohr): (11|11),
    # (11|22), (12|12), (11|12) over the AO functions
    mol = hf.Molecule([("H", (0.0, 0.0, 0.0)),
                       ("H", (0.0, 0.0, 1.4 / hf.ANG2BOHR))], STO3G)
    g = eri.eri(mol.bs).numpy()
    assert g[0, 0, 0, 0] == pytest.approx(0.7746, abs=1e-4)
    assert g[0, 0, 1, 1] == pytest.approx(0.5697, abs=1e-4)
    assert g[0, 1, 0, 1] == pytest.approx(0.2970, abs=1e-4)
    assert g[0, 0, 0, 1] == pytest.approx(0.4441, abs=1e-4)
    mf = hf.rhf(mol, "cpu")
    assert mf.e_tot == pytest.approx(-1.1167, abs=1e-4)


@pytest.mark.parametrize("nmax", [0, 4, 8])
def test_boys_function(nmax):
    from scipy.special import hyp1f1

    T = torch.tensor([0.0, 1e-8, 0.3, 2.0, 12.0, 34.9, 35.1, 80.0, 400.0],
                     dtype=torch.float64)
    F = eri.boys(nmax, T).numpy()
    for n in range(nmax + 1):
        want = hyp1f1(n + 0.5, n + 1.5, -T.numpy()) / (2 * n + 1)
        np.testing.assert_allclose(F[n], want, rtol=1e-12, atol=1e-16)


def test_eri_against_the_numpy_engine():
    # the loop over shell quartets that reference/eri.py batches
    mol = hf.Molecule(C2H2, STO3G)
    bs = mol.bs
    g = eri.eri(bs).numpy()
    for (i, j, k, l) in [(0, 0, 0, 0), (1, 2, 3, 4), (5, 5, 10, 11),
                         (2, 8, 3, 9), (11, 0, 6, 7)]:
        # one element by the Hermite sums written out
        ref = _one_eri(bs, i, j, k, l)
        assert g[i, j, k, l] == pytest.approx(ref, abs=1e-12)
    # the eight-fold symmetry
    np.testing.assert_allclose(g, g.transpose(1, 0, 2, 3), atol=1e-14)
    np.testing.assert_allclose(g, g.transpose(2, 3, 0, 1), atol=1e-14)


def _one_eri(bs, i, j, k, l):
    """(ij|kl) of s and p functions by quadrature-free direct sums over
    primitives: the McMurchie-Davidson formula, one AO element at a
    time."""
    def locate(ao):
        for n, sh in enumerate(bs.shells):
            o = bs.sph_offsets[n]
            if o <= ao < o + aoints.NSPH[sh.l]:
                return sh, ao - o, bs._norms[ao]
        raise IndexError(ao)

    # p functions are x, y, z in this order; s is (0, 0, 0)
    def powers(sh, m):
        return (0, 0, 0) if sh.l == 0 else tuple(int(m == d)
                                                  for d in range(3))

    fa, fb, fc, fd = (locate(x) for x in (i, j, k, l))
    total = 0.0
    for a, ca in zip(fa[0].exps, fa[0].coefs):
        for b, cb in zip(fb[0].exps, fb[0].coefs):
            for c, cc_ in zip(fc[0].exps, fc[0].coefs):
                for d, cd in zip(fd[0].exps, fd[0].coefs):
                    total += ca * cb * cc_ * cd * _prim(
                        (a, fa[0].center, powers(fa[0], fa[1])),
                        (b, fb[0].center, powers(fb[0], fb[1])),
                        (c, fc[0].center, powers(fc[0], fc[1])),
                        (d, fd[0].center, powers(fd[0], fd[1])))
    return total * fa[2] * fb[2] * fc[2] * fd[2]


def _prim(A, B, C, D):
    import math

    def E(i, j, t, Qx, a, b):
        p = a + b
        q = a * b / p
        if t < 0 or t > i + j:
            return 0.0
        if i == j == t == 0:
            return math.exp(-q * Qx * Qx)
        if j == 0:
            return (E(i - 1, j, t - 1, Qx, a, b) / (2 * p)
                    - q * Qx / a * E(i - 1, j, t, Qx, a, b)
                    + (t + 1) * E(i - 1, j, t + 1, Qx, a, b))
        return (E(i, j - 1, t - 1, Qx, a, b) / (2 * p)
                + q * Qx / b * E(i, j - 1, t, Qx, a, b)
                + (t + 1) * E(i, j - 1, t + 1, Qx, a, b))

    def R(t, u, v, n, p, X, Y, Z, RPC):
        T = p * RPC * RPC
        if t == u == v == 0:
            from scipy.special import hyp1f1
            return (-2 * p) ** n * hyp1f1(n + 0.5, n + 1.5, -T) / (2 * n + 1)
        if t == u == 0:
            val = 0.0
            if v > 1:
                val += (v - 1) * R(t, u, v - 2, n + 1, p, X, Y, Z, RPC)
            return val + Z * R(t, u, v - 1, n + 1, p, X, Y, Z, RPC)
        if t == 0:
            val = 0.0
            if u > 1:
                val += (u - 1) * R(t, u - 2, v, n + 1, p, X, Y, Z, RPC)
            return val + Y * R(t, u - 1, v, n + 1, p, X, Y, Z, RPC)
        val = 0.0
        if t > 1:
            val += (t - 1) * R(t - 2, u, v, n + 1, p, X, Y, Z, RPC)
        return val + X * R(t - 1, u, v, n + 1, p, X, Y, Z, RPC)

    (a, Ac, la), (b, Bc, lb), (c, Cc, lc), (d, Dc, ld) = A, B, C, D
    p, q = a + b, c + d
    alpha = p * q / (p + q)
    P = (a * np.asarray(Ac) + b * np.asarray(Bc)) / p
    Q = (c * np.asarray(Cc) + d * np.asarray(Dc)) / q
    X, Y, Z = P - Q
    RPQ = float(np.linalg.norm(P - Q))
    val = 0.0
    for t in range(la[0] + lb[0] + 1):
        for u in range(la[1] + lb[1] + 1):
            for v in range(la[2] + lb[2] + 1):
                e1 = (E(la[0], lb[0], t, Ac[0] - Bc[0], a, b)
                      * E(la[1], lb[1], u, Ac[1] - Bc[1], a, b)
                      * E(la[2], lb[2], v, Ac[2] - Bc[2], a, b))
                for tau in range(lc[0] + ld[0] + 1):
                    for nu in range(lc[1] + ld[1] + 1):
                        for phi in range(lc[2] + ld[2] + 1):
                            e2 = (E(lc[0], ld[0], tau, Cc[0] - Dc[0], c, d)
                                  * E(lc[1], ld[1], nu, Cc[1] - Dc[1], c, d)
                                  * E(lc[2], ld[2], phi, Cc[2] - Dc[2], c,
                                      d))
                            val += (e1 * e2 * (-1) ** (tau + nu + phi)
                                    * R(t + tau, u + nu, v + phi, 0, alpha,
                                        X, Y, Z, RPQ))
    return 2 * math.pi ** 2.5 / (p * q * math.sqrt(p + q)) * val


def test_reference_matches_the_programs_f64_route():
    """The reference and the program's f64 route solve the same equations:
    at C2H2/STO-3G their answers agree to the program's thresholds."""
    from ecw_cc_torch import ECW

    from ecwbench import check

    lams = [0.0, 0.35, 0.7]
    with contextlib.redirect_stdout(io.StringIO()):
        ecw = ECW(C2H2, "sto-3g", device="cpu", dtype=torch.float64)
        ecw.Build_GS_exp("mat", "CCSD(T)")
        res = ecw.CCSD_GS(lams, diis="tl", conv_thres=1e-9, maxiter=200)
    ref = solve.solve(C2H2, STO3G, lams)
    C = ecw.mo_coeff
    assert ref.ehf == pytest.approx(ecw.EHF, abs=1e-9)
    assert ref.eexp == pytest.approx(ecw.Eexp_GS, abs=1e-8)
    tgt = check.to_ao(ecw.exp_data[0][0][1], C)
    np.testing.assert_allclose(tgt, ref.target_ao.numpy(), atol=1e-7)
    np.testing.assert_allclose([ecw.EHF - x for x in ecw.Ep_lamb], ref.ep,
                               atol=1e-8)
    np.testing.assert_allclose(ecw.Delta_lamb, ref.delta, atol=1e-7)
    np.testing.assert_allclose(check.to_ao(res[4], C),
                               ref.rdm1_ao.numpy(), atol=1e-7)
