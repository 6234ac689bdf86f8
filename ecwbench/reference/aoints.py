"""AO integrals of the reference: contracted spherical Gaussians, the
one-electron integrals (overlap, kinetic, nuclear attraction) by the
McMurchie-Davidson scheme in NumPy.

A frozen copy of the NumPy half of the port's integral engine
(ecw_cc_torch/models/integrals.py: the shell and basis containers, the
Cartesian-to-spherical matrices, the Hermite tables and the one-electron
blocks), so that the reference imports nothing of the program.  The basis
comes from a JSON data file (reference/basis/*.json: {element: [[l,
[[exponent, coefficient], ...]], ...]}, coefficients over normalized
primitives).  The two-electron integrals are reference/eri.py's.
"""

from __future__ import annotations

import json

import numpy as np
from scipy.special import hyp1f1


def load_basis(path):
    """{element: [(l, [(exp, coef), ...]), ...]} from a basis JSON file."""
    with open(path) as f:
        data = json.load(f)
    return {el: [(int(l), [tuple(p) for p in prims]) for l, prims in shells]
            for el, shells in data["elements"].items()}

LMAX = 5            # s, p, d, f, g, h

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

    `atoms` is a list of (symbol, xyz_bohr) and `basis` a dict
    {element: shells} as load_basis gives it.
    """

    def __init__(self, atoms, basis):
        self.shells: list[Shell] = []
        for ia, (sym, xyz) in enumerate(atoms):
            for (l, prims) in basis[sym.capitalize()]:
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


def _cart_block_overlap(sha, shb):
    """Cartesian overlap block (ncarta, ncartb) between two shells."""
    a, b, cc, p, P = _pair_data(sha, shb)
    Ex = _E_table(sha.l, shb.l, sha.center[0], shb.center[0], a, b)
    Ey = _E_table(sha.l, shb.l, sha.center[1], shb.center[1], a, b)
    Ez = _E_table(sha.l, shb.l, sha.center[2], shb.center[2], a, b)
    pref = (np.pi / p) ** 1.5
    ca, cb = CART_COMPONENTS[sha.l], CART_COMPONENTS[shb.l]
    out = np.zeros((len(ca), len(cb)))
    for ia, (ix, iy, iz) in enumerate(ca):
        for ib, (jx, jy, jz) in enumerate(cb):
            out[ia, ib] = np.sum(cc * pref * Ex[ix, jx, 0] * Ey[iy, jy, 0]
                                 * Ez[iz, jz, 0])
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


def _one_electron(bs: BasisSet, kind="overlap", renorm=True, **kw):
    nao = bs.nao
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
            else:
                raise ValueError(kind)
            sph = _c2s_matrix(sha.l) @ blk @ _c2s_matrix(shb.l).T
            if renorm:
                na = bs._norms[oa:oa + NSPH[sha.l]]
                nb = bs._norms[ob:ob + NSPH[shb.l]]
                sph = sph * na[:, None] * nb[None, :]
            out[oa:oa + sph.shape[0], ob:ob + sph.shape[1]] = sph
            if isha != ishb:
                out[ob:ob + sph.shape[1], oa:oa + sph.shape[0]] = sph.T
    return out


def overlap(bs):
    return _one_electron(bs, "overlap")


def kinetic(bs):
    return _one_electron(bs, "kinetic")


def nuclear(bs, charges, coords):
    return _one_electron(bs, "nuclear", charges=charges,
                         coords=np.asarray(coords, float))
