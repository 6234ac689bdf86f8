"""Standalone Gaussian-integral engine (McMurchie-Davidson scheme, NumPy host code).

Replaces the reference's dependency on PySCF/libcint (reference Eris.py:97-131,
exp_pot.py:98-110, utilities.py:1009-1082) with an embedded engine providing:
  - overlap, kinetic, nuclear-attraction, dipole integrals
  - full 4-index electron-repulsion integrals (chemists' notation (ij|kl))
  - analytic Fourier-transform integrals <mu|exp(i k.r)|nu> for structure factors

Spherical-harmonic AOs (PySCF ordering: p = x,y,z ; d = xy,yz,z2,xz,x2-y2),
contracted functions renormalized numerically.  Supports l <= 3 per shell
(s, p, d, f) — covers STO-3G through cc-pVTZ.

This is deliberately host/NumPy: integrals are computed once per molecule and
staged to the device; the hot path of the framework is the CC iteration, not
the integral build.  A C++ engine (ecw_cc_torch/native) can be swapped in for
large basis sets.

Copy of ecw_cc_tpu/models/integrals.py (the PyTorch port imports
nothing of the JAX package); only the imports differ.
"""

from __future__ import annotations

import numpy as np
from scipy.special import hyp1f1

from ecw_cc_torch.models.basis_data import get_basis

__all__ = ["BasisSet", "overlap", "kinetic", "nuclear", "dipole", "eri", "ft_aopair"]


# ----------------------------------------------------------------------------
# Shell / basis containers
# ----------------------------------------------------------------------------

LMAX = 5            # s, p, d, f, g, h (native engine: mdint.cpp LMAX)

# Cartesian monomial orderings (lexicographic in (lx, ly, lz) descending on x)
CART_COMPONENTS = {
    l: [(lx, ly, l - lx - ly)
        for lx in range(l, -1, -1) for ly in range(l - lx, -1, -1)]
    for l in range(LMAX + 1)
}
NCART = {l: len(c) for l, c in CART_COMPONENTS.items()}
NSPH = {l: 2 * l + 1 for l in range(LMAX + 1)}


def _c2s_matrix(l):
    """Real-solid-harmonic expansion over PLAIN cartesian monomials.

    Rows: spherical components in PySCF order (m = -l..l);
    columns: CART_COMPONENTS[l].  Normalization chosen so every row has the
    same self-overlap as the (l,0,0)-like solid harmonic; the absolute scale
    is fixed later by numerical renormalization of the contracted AO.
    """
    if l == 0:
        return np.array([[1.0]])
    if l == 1:
        # PySCF order: x (m=-1? PySCF uses x,y,z), keep x,y,z
        return np.eye(3)
    if l == 2:
        s3 = np.sqrt(3.0)
        # columns: xx xy xz yy yz zz ; rows: xy, yz, z2, xz, x2-y2
        return np.array([
            [0.0, s3, 0.0, 0.0, 0.0, 0.0],        # sqrt(3) xy
            [0.0, 0.0, 0.0, 0.0, s3, 0.0],        # sqrt(3) yz
            [-0.5, 0.0, 0.0, -0.5, 0.0, 1.0],     # z2 - (x2+y2)/2
            [0.0, 0.0, s3, 0.0, 0.0, 0.0],        # sqrt(3) xz
            [s3 / 2, 0.0, 0.0, -s3 / 2, 0.0, 0.0],  # sqrt(3)/2 (x2-y2)
        ])
    if l == 3:
        # cols: xxx xxy xxz xyy xyz xzz yyy yyz yzz zzz
        a = np.sqrt(5.0 / 8.0)
        b = np.sqrt(15.0)
        c = np.sqrt(3.0 / 8.0)
        M = np.zeros((7, 10))
        M[0, 1], M[0, 6] = 3 * a, -a          # m=-3: sqrt(5/8)(3x2y - y3)
        M[1, 4] = b                           # m=-2: sqrt(15) xyz
        M[2, 8], M[2, 1], M[2, 6] = 4 * c, -c, -c  # m=-1
        M[3, 9], M[3, 2], M[3, 7] = 1.0, -1.5, -1.5  # m=0
        M[4, 5], M[4, 0], M[4, 3] = 4 * c, -c, -c  # m=+1
        M[5, 2], M[5, 7] = b / 2, -b / 2      # m=+2
        M[6, 0], M[6, 3] = a, -3 * a          # m=+3
        return M
    if l == 4:
        # cols: x4 x3y x3z x2y2 x2yz x2z2 xy3 xy2z xyz2 xz3
        #       y4 y3z y2z2 yz3 z4   (rows m=-4..4; exact constants, the
        # native engine embeds the identical values — mdint.cpp case 4)
        c = np.sqrt(35.0) / 8.0
        d = np.sqrt(35.0 / 8.0)
        e = np.sqrt(5.0) / 2.0
        f = np.sqrt(5.0 / 8.0)
        M = np.zeros((9, 15))
        M[0, 1], M[0, 6] = 4 * c, -4 * c             # m=-4: xy(x2-y2)
        M[1, 4], M[1, 11] = 3 * d, -d                # m=-3: yz(3x2-y2)
        M[2, 1], M[2, 6], M[2, 8] = -e, -e, 6 * e    # m=-2: xy(7z2-r2)
        M[3, 4], M[3, 11], M[3, 13] = -3 * f, -3 * f, 4 * f  # m=-1
        M[4, 0], M[4, 3], M[4, 5] = 0.375, 0.75, -3.0        # m=0
        M[4, 10], M[4, 12], M[4, 14] = 0.375, -3.0, 1.0
        M[5, 2], M[5, 7], M[5, 9] = -3 * f, -3 * f, 4 * f    # m=+1
        M[6, 0], M[6, 5] = -e / 2, 3 * e             # m=+2: (x2-y2)(7z2-r2)
        M[6, 10], M[6, 12] = e / 2, -3 * e
        M[7, 2], M[7, 7] = d, -3 * d                 # m=+3: xz(x2-3y2)
        M[8, 0], M[8, 3], M[8, 10] = c, -6 * c, c    # m=+4: x4-6x2y2+y4
        return M
    if l <= LMAX:
        return _c2s_general(l)
    raise NotImplementedError(f"l={l} > LMAX={LMAX}")


_C2S_CACHE = {}


def _c2s_general(l):
    """Real-solid-harmonic expansion over the CART_COMPONENTS[l] monomials
    for arbitrary l (g shells and beyond, r3 VERDICT next #8).

    r^l Y_lm is a homogeneous degree-l polynomial, so its monomial
    coefficients are EXACT: they are recovered by least squares from real
    spherical harmonics evaluated on unit-sphere points (deterministic
    seed; residual ~1e-14, snapped to clean zeros).  Rows in PySCF m order
    (-l..l); per-row scale is normalized so the m=0 row's z^l coefficient
    is 1 (matching the hand-coded l=2,3 tables' convention; absolute AO
    scale is fixed by the numerical renormalization in BasisSet anyway).
    The native engine (native/mdint.cpp c2s_matrix) embeds the identical
    values so both engines agree to the double."""
    if l in _C2S_CACHE:
        return _C2S_CACHE[l]
    try:                      # scipy >= 1.15 renames sph_harm
        from scipy.special import sph_harm_y

        def _ylm(m, ll, theta, phi):
            return sph_harm_y(ll, m, theta, phi)
    except ImportError:       # pragma: no cover - older scipy
        from scipy.special import sph_harm

        def _ylm(m, ll, theta, phi):
            return sph_harm(m, ll, phi, theta)

    ncart = NCART[l]
    rng = np.random.default_rng(12345)
    pts = rng.standard_normal((4 * ncart, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    x, y, z = pts.T
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = np.arctan2(y, x)
    rows = []
    for m in range(-l, l + 1):
        Y = _ylm(abs(m), l, theta, phi)
        if m < 0:
            f = np.sqrt(2.0) * (-1) ** m * np.imag(Y)
        elif m > 0:
            f = np.sqrt(2.0) * (-1) ** m * np.real(Y)
        else:
            f = np.real(Y)
        rows.append(f)
    Mon = np.stack([x ** lx * y ** ly * z ** lz
                    for (lx, ly, lz) in CART_COMPONENTS[l]], axis=1)
    C, res, rank, _ = np.linalg.lstsq(Mon, np.stack(rows, axis=1),
                                      rcond=None)
    C = C.T                                       # (nsph, ncart)
    # normalize the overall scale by the m=0 row's z^l coefficient
    C = C / C[l, ncart - 1]
    C[np.abs(C) < 1e-10] = 0.0
    _C2S_CACHE[l] = C
    return C


class Shell:
    __slots__ = ("l", "exps", "coefs", "center", "atom")

    def __init__(self, l, exps, coefs, center, atom):
        self.l = int(l)
        self.exps = np.asarray(exps, dtype=float)
        self.coefs = np.asarray(coefs, dtype=float)
        self.center = np.asarray(center, dtype=float)
        self.atom = int(atom)


class BasisSet:
    """Contracted spherical-Gaussian basis for a molecule.

    `atoms` is a list of (symbol, xyz_bohr) and `basis` a registered basis
    name or dict (see basis_data.py).
    """

    def __init__(self, atoms, basis):
        self.shells: list[Shell] = []
        for ia, (sym, xyz) in enumerate(atoms):
            for (l, prims) in get_basis(basis, sym):
                exps = [p[0] for p in prims]
                coefs = [p[1] for p in prims]
                # Fold normalized-primitive factors into coefficients
                e = np.asarray(exps)
                c = np.asarray(coefs)
                dfact = float(np.prod(np.arange(2 * l - 1, 0, -2))) \
                    if l > 0 else 1.0   # (2l-1)!!
                nprim = (2 * e / np.pi) ** 0.75 * (4 * e) ** (l / 2.0) / np.sqrt(dfact)
                self.shells.append(Shell(l, e, c * nprim, xyz, ia))
        # offsets in the spherical AO basis
        self.sph_offsets = []
        n = 0
        for sh in self.shells:
            self.sph_offsets.append(n)
            n += NSPH[sh.l]
        self.nao = n
        # numerical renormalization of contracted AOs
        self._norms = np.ones(self.nao)
        s = self._overlap_raw()
        self._norms = 1.0 / np.sqrt(np.diag(s))

    # -- normalization ---------------------------------------------------
    def _overlap_raw(self):
        return _one_electron(self, kind="overlap", renorm=False)

    def ao_norms(self):
        return self._norms


# ----------------------------------------------------------------------------
# Hermite expansion coefficients
# ----------------------------------------------------------------------------

def _E_table(la, lb, A, B, a, b):
    """Hermite expansion coefficients E[i, j, t] per dimension.

    a, b: (np,) arrays of primitive exponent pairs (already meshed);
    A, B: scalars (center components).  Returns array (3-dim list) of shape
    (la+1, lb+1, la+lb+1, np).
    """
    p = a + b
    mu = a * b / p
    Qx = A - B
    n = len(p)
    E = np.zeros((la + 1, lb + 1, la + lb + 1, n))
    E[0, 0, 0] = np.exp(-mu * Qx * Qx)
    # recurrence on i then j
    for i in range(1, la + 1):
        for t in range(i + 1):
            val = 0.0
            if t - 1 >= 0:
                val = E[i - 1, 0, t - 1] / (2 * p)
            val = val - (b / p) * Qx * E[i - 1, 0, t]
            if t + 1 <= i - 1:
                val = val + (t + 1) * E[i - 1, 0, t + 1]
            E[i, 0, t] = val
    for j in range(1, lb + 1):
        for i in range(la + 1):
            for t in range(i + j + 1):
                val = 0.0
                if t - 1 >= 0:
                    val = E[i, j - 1, t - 1] / (2 * p)
                val = val + (a / p) * Qx * E[i, j - 1, t]
                if t + 1 <= i + j - 1:
                    val = val + (t + 1) * E[i, j - 1, t + 1]
                E[i, j, t] = val
    return E


def _boys(nmax, T):
    """Boys function F_n(T) for n = 0..nmax; T: (np,) array.
    Top order via Kummer 1F1, lower orders by stable downward recursion."""
    T = np.asarray(T, dtype=float)
    F = np.empty((nmax + 1,) + T.shape)
    F[nmax] = hyp1f1(nmax + 0.5, nmax + 1.5, -T) / (2 * nmax + 1)
    if nmax > 0:
        eT = np.exp(-T)
        for n in range(nmax - 1, -1, -1):
            F[n] = (2 * T * F[n + 1] + eT) / (2 * n + 1)
    return F


def _R_table(Lmax, p, PC):
    """Hermite Coulomb integrals R_{t,u,v} (n=0) for t+u+v <= Lmax.

    p: (np,) exponents; PC: (np, 3).  Returns R of shape
    (Lmax+1, Lmax+1, Lmax+1, np) (entries with t+u+v > Lmax are garbage/0).
    """
    T = p * np.einsum("ni,ni->n", PC, PC)
    Fn = _boys(Lmax, T)
    n_ = len(p)
    # Rn[n, t, u, v]
    R = np.zeros((Lmax + 1, Lmax + 1, Lmax + 1, Lmax + 1, n_))
    for n in range(Lmax + 1):
        R[n, 0, 0, 0] = (-2 * p) ** n * Fn[n]
    X, Y, Z = PC[:, 0], PC[:, 1], PC[:, 2]
    for total in range(1, Lmax + 1):
        for t in range(total + 1):
            for u in range(total - t + 1):
                v = total - t - u
                for n in range(Lmax - total + 1):
                    if t > 0:
                        val = X * R[n + 1, t - 1, u, v]
                        if t > 1:
                            val = val + (t - 1) * R[n + 1, t - 2, u, v]
                    elif u > 0:
                        val = Y * R[n + 1, t, u - 1, v]
                        if u > 1:
                            val = val + (u - 1) * R[n + 1, t, u - 2, v]
                    else:
                        val = Z * R[n + 1, t, u, v - 1]
                        if v > 1:
                            val = val + (v - 1) * R[n + 1, t, u, v - 2]
                    R[n, t, u, v] = val
    return R[0]


# ----------------------------------------------------------------------------
# One-electron integrals
# ----------------------------------------------------------------------------

def _pair_data(sha, shb):
    a = np.repeat(sha.exps, len(shb.exps))
    b = np.tile(shb.exps, len(sha.exps))
    cc = np.outer(sha.coefs, shb.coefs).ravel()
    p = a + b
    P = (a[:, None] * sha.center + b[:, None] * shb.center) / p[:, None]
    return a, b, cc, p, P


def _cart_block_overlap(sha, shb, moment_center=None, moments=0):
    """Cartesian overlap (and moment) block between two shells.

    Returns (ncarta, ncartb) if moments == 0 else (3, ncarta, ncartb) for
    dipole integrals about moment_center.
    """
    a, b, cc, p, P = _pair_data(sha, shb)
    Ex = _E_table(sha.l, shb.l, sha.center[0], shb.center[0], a, b)
    Ey = _E_table(sha.l, shb.l, sha.center[1], shb.center[1], a, b)
    Ez = _E_table(sha.l, shb.l, sha.center[2], shb.center[2], a, b)
    pref = (np.pi / p) ** 1.5
    ca, cb = CART_COMPONENTS[sha.l], CART_COMPONENTS[shb.l]
    if moments == 0:
        out = np.zeros((len(ca), len(cb)))
        for ia, (ix, iy, iz) in enumerate(ca):
            for ib, (jx, jy, jz) in enumerate(cb):
                out[ia, ib] = np.sum(cc * pref * Ex[ix, jx, 0] * Ey[iy, jy, 0] * Ez[iz, jz, 0])
        return out
    # dipole about moment_center: <a| r - C |b>
    PC = P - np.asarray(moment_center)
    out = np.zeros((3, len(ca), len(cb)))
    E = (Ex, Ey, Ez)
    for ia, (ix, iy, iz) in enumerate(ca):
        for ib, (jx, jy, jz) in enumerate(cb):
            la = (ix, iy, iz)
            lb = (jx, jy, jz)
            s1 = [None] * 3  # per-dim <i| x - C |j> ; s0: plain overlap per dim
            s0 = [E[d][la[d], lb[d], 0] for d in range(3)]
            # integral of (x-P) Lambda_t dx = delta_{t,1} * sqrt(pi/p), hence
            # per-dim moment: <x - C> = E_1 + (P_x - C_x) E_0 (times sqrt(pi/p))
            for d in range(3):
                e1 = E[d][la[d], lb[d], 1] if la[d] + lb[d] >= 1 else 0.0
                s1[d] = e1 + PC[:, d] * s0[d]
            out[0, ia, ib] = np.sum(cc * pref * s1[0] * s0[1] * s0[2])
            out[1, ia, ib] = np.sum(cc * pref * s0[0] * s1[1] * s0[2])
            out[2, ia, ib] = np.sum(cc * pref * s0[0] * s0[1] * s1[2])
    return out


def _cart_block_kinetic(sha, shb):
    a, b, cc, p, P = _pair_data(sha, shb)
    la, lb = sha.l, shb.l
    # need E with lb+2
    Ex = _E_table(la, lb + 2, sha.center[0], shb.center[0], a, b)
    Ey = _E_table(la, lb + 2, sha.center[1], shb.center[1], a, b)
    Ez = _E_table(la, lb + 2, sha.center[2], shb.center[2], a, b)
    pref = (np.pi / p) ** 1.5
    E = (Ex, Ey, Ez)

    def S(d, i, j):
        if j < 0 or i < 0:
            return 0.0
        return E[d][i, j, 0]

    def K(d, i, j):
        val = -2.0 * b ** 2 * S(d, i, j + 2) + b * (2 * j + 1) * S(d, i, j)
        if j >= 2:
            val = val - 0.5 * j * (j - 1) * S(d, i, j - 2)
        return val

    ca, cb = CART_COMPONENTS[la], CART_COMPONENTS[lb]
    out = np.zeros((len(ca), len(cb)))
    for ia, (ix, iy, iz) in enumerate(ca):
        for ib, (jx, jy, jz) in enumerate(cb):
            term = (K(0, ix, jx) * S(1, iy, jy) * S(2, iz, jz)
                    + S(0, ix, jx) * K(1, iy, jy) * S(2, iz, jz)
                    + S(0, ix, jx) * S(1, iy, jy) * K(2, iz, jz))
            out[ia, ib] = np.sum(cc * pref * term)
    return out


def _cart_block_nuclear(sha, shb, charges, coords):
    a, b, cc, p, P = _pair_data(sha, shb)
    la, lb = sha.l, shb.l
    Ltot = la + lb
    Ex = _E_table(la, lb, sha.center[0], shb.center[0], a, b)
    Ey = _E_table(la, lb, sha.center[1], shb.center[1], a, b)
    Ez = _E_table(la, lb, sha.center[2], shb.center[2], a, b)
    ca, cb = CART_COMPONENTS[la], CART_COMPONENTS[lb]
    out = np.zeros((len(ca), len(cb)))
    pref = 2 * np.pi / p
    for Z, C in zip(charges, coords):
        R = _R_table(Ltot, p, P - C)  # (L+1, L+1, L+1, np)
        for ia, (ix, iy, iz) in enumerate(ca):
            for ib, (jx, jy, jz) in enumerate(cb):
                acc = 0.0
                for t in range(ix + jx + 1):
                    for u in range(iy + jy + 1):
                        for v in range(iz + jz + 1):
                            acc = acc + np.sum(
                                cc * pref * Ex[ix, jx, t] * Ey[iy, jy, u]
                                * Ez[iz, jz, v] * R[t, u, v])
                out[ia, ib] += -Z * acc
    return out


def _sph_transform(block, sha, shb, bs, oa, ob):
    """cartesian block -> spherical block with final AO normalization."""
    Ca = _c2s_matrix(sha.l)
    Cb = _c2s_matrix(shb.l)
    sph = Ca @ block @ Cb.T
    na = bs._norms[oa:oa + NSPH[sha.l]]
    nb = bs._norms[ob:ob + NSPH[shb.l]]
    return sph * na[:, None] * nb[None, :]


def _one_electron(bs: BasisSet, kind="overlap", renorm=True, **kw):
    nao = bs.nao
    if kind == "dipole":
        out = np.zeros((3, nao, nao))
    else:
        out = np.zeros((nao, nao))
    for isha, sha in enumerate(bs.shells):
        oa = bs.sph_offsets[isha]
        for ishb in range(isha + 1):
            shb = bs.shells[ishb]
            ob = bs.sph_offsets[ishb]
            if kind == "overlap":
                blk = _cart_block_overlap(sha, shb)
            elif kind == "kinetic":
                blk = _cart_block_kinetic(sha, shb)
            elif kind == "nuclear":
                blk = _cart_block_nuclear(sha, shb, kw["charges"], kw["coords"])
            elif kind == "dipole":
                blk = _cart_block_overlap(sha, shb, moment_center=kw["center"], moments=1)
            else:
                raise ValueError(kind)
            if kind == "dipole":
                for d in range(3):
                    sph = _c2s_matrix(sha.l) @ blk[d] @ _c2s_matrix(shb.l).T
                    if renorm:
                        na = bs._norms[oa:oa + NSPH[sha.l]]
                        nb = bs._norms[ob:ob + NSPH[shb.l]]
                        sph = sph * na[:, None] * nb[None, :]
                    out[d, oa:oa + sph.shape[0], ob:ob + sph.shape[1]] = sph
                    if isha != ishb:
                        out[d, ob:ob + sph.shape[1], oa:oa + sph.shape[0]] = sph.T
            else:
                sph = _c2s_matrix(sha.l) @ blk @ _c2s_matrix(shb.l).T
                if renorm:
                    na = bs._norms[oa:oa + NSPH[sha.l]]
                    nb = bs._norms[ob:ob + NSPH[shb.l]]
                    sph = sph * na[:, None] * nb[None, :]
                out[oa:oa + sph.shape[0], ob:ob + sph.shape[1]] = sph
                if isha != ishb:
                    out[ob:ob + sph.shape[1], oa:oa + sph.shape[0]] = sph.T
    return out


def _native_int1e(bs, kind, **kw):
    """C++ one-electron path (None -> fall back to NumPy)."""
    import os as _os

    if _os.environ.get("ECW_CC_TPU_NO_NATIVE", "0") == "1":
        return None
    from ecw_cc_torch import native as _native

    if not _native.available() \
            or max(sh.l for sh in bs.shells) > _native.NATIVE_LMAX:
        return None
    return _native.compute_int1e(bs, kind, **kw)


def overlap(bs):
    out = _native_int1e(bs, "overlap")
    return out if out is not None else _one_electron(bs, "overlap")


def kinetic(bs):
    out = _native_int1e(bs, "kinetic")
    return out if out is not None else _one_electron(bs, "kinetic")


def nuclear(bs, charges, coords):
    coords = np.asarray(coords, float)
    out = _native_int1e(bs, "nuclear", charges=charges, coords=coords)
    return out if out is not None else _one_electron(
        bs, "nuclear", charges=charges, coords=coords)


def dipole(bs, center):
    """<mu| r - center |nu>, 3 components (matches PySCF int1e_r with common origin)."""
    center = np.asarray(center, float)
    out = _native_int1e(bs, "dipole", origin=center)
    return out if out is not None else _one_electron(bs, "dipole", center=center)


# ----------------------------------------------------------------------------
# Two-electron integrals
# ----------------------------------------------------------------------------

def _pair_hermite(sha, shb):
    """Per shell-pair: combined Hermite coefficients.

    Returns (coeff_tensor, p, P) where coeff_tensor has shape
    (ncarta, ncartb, Lt+1, Lu+1, Lv+1, nprimpair) = E^x_t E^y_u E^z_v * c_a c_b.
    """
    a, b, cc, p, P = _pair_data(sha, shb)
    la, lb = sha.l, shb.l
    L = la + lb
    Ex = _E_table(la, lb, sha.center[0], shb.center[0], a, b)
    Ey = _E_table(la, lb, sha.center[1], shb.center[1], a, b)
    Ez = _E_table(la, lb, sha.center[2], shb.center[2], a, b)
    ca, cb = CART_COMPONENTS[la], CART_COMPONENTS[lb]
    T = np.zeros((len(ca), len(cb), L + 1, L + 1, L + 1, len(p)))
    for ia, (ix, iy, iz) in enumerate(ca):
        for ib, (jx, jy, jz) in enumerate(cb):
            for t in range(ix + jx + 1):
                for u in range(iy + jy + 1):
                    for v in range(iz + jz + 1):
                        T[ia, ib, t, u, v] = cc * Ex[ix, jx, t] * Ey[iy, jy, u] * Ez[iz, jz, v]
    return T, p, P


def eri(bs: BasisSet, native="auto"):
    """Full (nao,nao,nao,nao) spherical ERI tensor, chemists' notation (ij|kl).

    native='auto' uses the C++ engine (ecw_cc_torch/native) when it compiles,
    falling back to this NumPy implementation; native=False forces NumPy
    (used as the cross-check oracle for the C++ engine).
    Uses 4-fold shell-pair symmetry (ij|kl) = (ji|kl) = (ij|lk) = (kl|ij).
    """
    if native != False:  # noqa: E712  (allow 'auto'/True)
        import os as _os
        if _os.environ.get("ECW_CC_TPU_NO_NATIVE", "0") != "1":
            from ecw_cc_torch import native as _native
            if _native.available() \
                    and max(sh.l for sh in bs.shells) <= _native.NATIVE_LMAX:
                return _native.compute_eri(bs)
            if native is True:
                raise RuntimeError("native ERI engine requested but unavailable")
    nao = bs.nao
    nsh = len(bs.shells)
    pairs = []
    for i in range(nsh):
        for j in range(i + 1):
            T, p, P = _pair_hermite(bs.shells[i], bs.shells[j])
            pairs.append((i, j, T, p, P))
    out = np.zeros((nao, nao, nao, nao))
    npair = len(pairs)
    for ipair in range(npair):
        i, j, Tb, pb, Pb = pairs[ipair]
        Lb = bs.shells[i].l + bs.shells[j].l
        oi, oj = bs.sph_offsets[i], bs.sph_offsets[j]
        for kpair in range(ipair + 1):
            k, l_, Tk, pk, Pk = pairs[kpair]
            Lk = bs.shells[k].l + bs.shells[l_].l
            ok, ol = bs.sph_offsets[k], bs.sph_offsets[l_]
            Lmax = Lb + Lk
            # meshed primitive quartets
            nb_, nk_ = len(pb), len(pk)
            pbm = np.repeat(pb, nk_)
            pkm = np.tile(pk, nb_)
            alpha = pbm * pkm / (pbm + pkm)
            PQ = (np.repeat(Pb, nk_, axis=0) - np.tile(Pk, (nb_, 1)))
            R = _R_table(Lmax, alpha, PQ)
            pref = 2 * np.pi ** 2.5 / (pbm * pkm * np.sqrt(pbm + pkm))
            R = R * pref  # fold prefactor
            R = R.reshape(Lmax + 1, Lmax + 1, Lmax + 1, nb_, nk_)
            # contract: bra (t,u,v) x ket (tau,nu,phi) with (-1)^{tau+nu+phi}
            # signs for ket Hermite indices
            Lk1 = Lk + 1
            sgn = (-1.0) ** (np.add.outer(np.add.outer(np.arange(Lk1), np.arange(Lk1)),
                                          np.arange(Lk1)))
            # block computation: for each cart component pair
            nca, ncb_ = Tb.shape[0], Tb.shape[1]
            nck, ncl = Tk.shape[0], Tk.shape[1]
            blk = np.zeros((nca, ncb_, nck, ncl))
            # R2[t,u,v,tau,nu,phi, nb, nk] = R[t+tau, u+nu, v+phi]
            Lb1 = Lb + 1
            R2 = np.empty((Lb1, Lb1, Lb1, Lk1, Lk1, Lk1, nb_, nk_))
            for t in range(Lb1):
                for u in range(Lb1):
                    for v in range(Lb1):
                        R2[t, u, v] = R[t:t + Lk1, u:u + Lk1, v:v + Lk1]
            # contract ket side first: M[t,u,v, nck, ncl, nb] = sum over tau,nu,phi,nk
            M = np.einsum("tuvxyznm,cdxyzm->tuvcdn", R2, Tk * sgn[None, None, ...,
                                                                  None], optimize=True)
            blk = np.einsum("abtuvn,tuvcdn->abcd", Tb, M, optimize=True)
            # spherical transform + normalization
            Ca = _c2s_matrix(bs.shells[i].l)
            Cb = _c2s_matrix(bs.shells[j].l)
            Ck = _c2s_matrix(bs.shells[k].l)
            Cl = _c2s_matrix(bs.shells[l_].l)
            sph = np.einsum("pa,qb,rc,sd,abcd->pqrs", Ca, Cb, Ck, Cl, blk, optimize=True)
            na = bs._norms[oi:oi + sph.shape[0]]
            nb2 = bs._norms[oj:oj + sph.shape[1]]
            nc = bs._norms[ok:ok + sph.shape[2]]
            nd = bs._norms[ol:ol + sph.shape[3]]
            sph = sph * na[:, None, None, None] * nb2[None, :, None, None] \
                      * nc[None, None, :, None] * nd[None, None, None, :]
            _scatter_eri(out, sph, oi, oj, ok, ol)
    return out


def _scatter_eri(out, blk, oi, oj, ok, ol):
    ni, nj, nk, nl = blk.shape
    si = slice(oi, oi + ni)
    sj = slice(oj, oj + nj)
    sk = slice(ok, ok + nk)
    sl = slice(ol, ol + nl)
    out[si, sj, sk, sl] = blk
    out[sj, si, sk, sl] = blk.transpose(1, 0, 2, 3)
    out[si, sj, sl, sk] = blk.transpose(0, 1, 3, 2)
    out[sj, si, sl, sk] = blk.transpose(1, 0, 3, 2)
    out[sk, sl, si, sj] = blk.transpose(2, 3, 0, 1)
    out[sl, sk, si, sj] = blk.transpose(3, 2, 0, 1)
    out[sk, sl, sj, si] = blk.transpose(2, 3, 1, 0)
    out[sl, sk, sj, si] = blk.transpose(3, 2, 1, 0)


# ----------------------------------------------------------------------------
# Analytic Fourier transform  <mu| exp(-i k.r) |nu>   (for structure factors)
# ----------------------------------------------------------------------------

def ft_aopair(bs: BasisSet, kvecs):
    """FT integrals  F[h, mu, nu] = int phi_mu(r) phi_nu(r) exp(-i k_h . r) dr.

    Matches the convention of PySCF gto.ft_ao.ft_aopair (used by the
    reference utilities.FT_MO, utilities.py:1127-1161).
    """
    kvecs = np.asarray(kvecs, dtype=float).reshape(-1, 3)
    nk = len(kvecs)
    nao = bs.nao
    out = np.zeros((nk, nao, nao), dtype=complex)
    for isha, sha in enumerate(bs.shells):
        oa = bs.sph_offsets[isha]
        for ishb in range(isha + 1):
            shb = bs.shells[ishb]
            ob = bs.sph_offsets[ishb]
            a, b, cc, p, P = _pair_data(sha, shb)
            Ex = _E_table(sha.l, shb.l, sha.center[0], shb.center[0], a, b)
            Ey = _E_table(sha.l, shb.l, sha.center[1], shb.center[1], a, b)
            Ez = _E_table(sha.l, shb.l, sha.center[2], shb.center[2], a, b)
            ca, cb = CART_COMPONENTS[sha.l], CART_COMPONENTS[shb.l]
            pref = (np.pi / p) ** 1.5
            blk = np.zeros((nk, len(ca), len(cb)), dtype=complex)
            for ik, kv in enumerate(kvecs):
                # int Lambda_t exp(-i k x) dx = sqrt(pi/p) (-i k)^t exp(-k^2/4p) exp(-i k P)
                phase = np.exp(-np.einsum("n,i,i->n", 1.0 / (4 * p), kv, kv)) \
                    * np.exp(-1j * (P @ kv)) * pref
                for ia, (ix, iy, iz) in enumerate(ca):
                    for ib, (jx, jy, jz) in enumerate(cb):
                        acc = 0.0
                        for t in range(ix + jx + 1):
                            for u in range(iy + jy + 1):
                                for v in range(iz + jz + 1):
                                    acc = acc + (Ex[ix, jx, t] * Ey[iy, jy, u]
                                                 * Ez[iz, jz, v]
                                                 * (-1j * kv[0]) ** t
                                                 * (-1j * kv[1]) ** u
                                                 * (-1j * kv[2]) ** v)
                        blk[ik, ia, ib] = np.sum(cc * phase * acc)
            Ca = _c2s_matrix(sha.l)
            Cb = _c2s_matrix(shb.l)
            for ik in range(nk):
                sph = Ca @ blk[ik] @ Cb.T
                na = bs._norms[oa:oa + NSPH[sha.l]]
                nb2 = bs._norms[ob:ob + NSPH[shb.l]]
                sph = sph * na[:, None] * nb2[None, :]
                out[ik, oa:oa + sph.shape[0], ob:ob + sph.shape[1]] = sph
                if isha != ishb:
                    out[ik, ob:ob + sph.shape[1], oa:oa + sph.shape[0]] = sph.T
    return out


# ----------------------------------------------------------------------------
# AO evaluation on a real-space grid (for cube files / densities)
# ----------------------------------------------------------------------------

def eval_ao(bs: BasisSet, points):
    """Evaluate all (spherical, normalized) AOs at `points` (n, 3) Bohr.

    Returns (n, nao).  Replaces PySCF's numint AO evaluator for cube output
    (reference utilities.py:917-937 uses pyscf.tools.cubegen)."""
    points = np.asarray(points, dtype=float)
    n = len(points)
    out = np.zeros((n, bs.nao))
    for ish, sh in enumerate(bs.shells):
        off = bs.sph_offsets[ish]
        d = points - sh.center
        r2 = np.einsum("ni,ni->n", d, d)
        rad = np.zeros(n)
        for a, c in zip(sh.exps, sh.coefs):
            rad += c * np.exp(-a * r2)
        carts = CART_COMPONENTS[sh.l]
        cart_vals = np.empty((len(carts), n))
        for ic, (lx, ly, lz) in enumerate(carts):
            cart_vals[ic] = d[:, 0] ** lx * d[:, 1] ** ly * d[:, 2] ** lz * rad
        sph = _c2s_matrix(sh.l) @ cart_vals
        nrm = bs._norms[off:off + NSPH[sh.l]]
        out[:, off:off + NSPH[sh.l]] = (sph * nrm[:, None]).T
    return out
