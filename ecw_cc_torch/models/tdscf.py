"""TDHF / CIS (TDA) in the G spin-orbital basis.

Copy of ecw_cc_tpu/models/tdscf.py (the PyTorch port imports nothing of the
JAX package): host NumPy on the ERI blocks, which are read back from the
device where they are tensors.

Replaces pyscf.tdscf used by the reference's get_init_r
(utilities.py:104-129): full RPA [[A, B], [-B, -A]] eigenproblem built from
the antisymmetrized G-format ERI blocks,
    A_{ia,jb} = d_ij d_ab (e_a - e_i) + <aj||ib>
    B_{ia,jb} = <ab||ij>
plus transition dipole moments from the X+Y vectors.  System sizes in this
domain are small; dense diagonalization is exact and cheap.
"""

from __future__ import annotations

import numpy as np


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _build_AB(eris, mo_energy):
    nocc, nvir = eris.nocc, eris.nvir
    e = np.asarray(mo_energy)
    eia = e[nocc:][None, :] - e[:nocc][:, None]
    voov = _host(eris.voov).astype(np.float64)
    vvoo = _host(eris.vvoo).astype(np.float64)
    A = np.einsum("ajib->iajb", voov).reshape(nocc * nvir, nocc * nvir)
    A = A + np.diag(eia.ravel())
    B = np.einsum("abij->iajb", vvoo).reshape(nocc * nvir, nocc * nvir)
    return A, B


def cis(eris, mo_energy, nroots=5):
    """CIS/TDA: eigenpairs of A. Returns (energies, X[nroots, nocc, nvir])."""
    nocc, nvir = eris.nocc, eris.nvir
    A, _ = _build_AB(eris, mo_energy)
    w, v = np.linalg.eigh(0.5 * (A + A.T))
    nroots = min(nroots, len(w))
    return w[:nroots], v[:, :nroots].T.reshape(nroots, nocc, nvir)


def tdhf(eris, mo_energy, nroots=5):
    """Full RPA/TDHF. Returns (energies, X, Y) with positive-energy roots
    normalized to <X|X> - <Y|Y> = 1."""
    nocc, nvir = eris.nocc, eris.nvir
    A, B = _build_AB(eris, mo_energy)
    n = A.shape[0]
    M = np.block([[A, B], [-B.conj(), -A.conj()]])
    w, v = np.linalg.eig(M)
    # keep positive roots, sorted
    idx = np.argsort(w.real)
    idx = [i for i in idx if w[i].real > 1e-8]
    roots = []
    for i in idx[:nroots]:
        x = v[:n, i].real
        y = v[n:, i].real
        nrm = np.dot(x, x) - np.dot(y, y)
        if abs(nrm) < 1e-10:
            continue
        s = 1.0 / np.sqrt(abs(nrm))
        roots.append((w[i].real, (x * s).reshape(nocc, nvir),
                      (y * s).reshape(nocc, nvir)))
    es = np.array([r[0] for r in roots])
    X = np.stack([r[1] for r in roots])
    Y = np.stack([r[2] for r in roots])
    return es, X, Y


def get_init_r(mol, ghf, eris, roots=10):
    """TDHF initial r amplitudes + transition dipoles.
    Reference utilities.get_init_r (utilities.py:104-129)."""
    from ecw_cc_torch.utils import props

    es, X, Y = tdhf(eris, ghf.mo_energy, nroots=roots)
    nocc, nvir = eris.nocc, eris.nvir
    dim = nocc + nvir
    dip_int = mol.intor("r", origin=mol.charge_center())
    tdms = []
    for k in range(len(es)):
        # transition density in MO basis from X+Y
        t = np.zeros((dim, dim))
        t[:nocc, nocc:] = X[k] + Y[k]
        tdms.append(props.dipole(mol, t, g=True, aobasis=False,
                                 mo_coeff=ghf.mo_coeff, dip_int=dip_int))
    r_ini = X[0]
    return r_ini, np.asarray(tdms), es
