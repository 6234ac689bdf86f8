"""R/U/G format conversions (reference utilities.py:137-339).

G format: spin-orbitals interleaved [a, b, a, b, ...] in the MO index, AO
index blocked [alpha AOs; beta AOs] (PySCF convert_to_ghf convention).

Copy of ecw_cc_tpu/utils/convert.py (the PyTorch port imports
nothing of the JAX package); only the imports differ.
"""

from __future__ import annotations

import numpy as np


def convert_r_to_g_amp(amp):
    """R-format amplitudes -> G [0,1,0,1,...] spin format.
    Reference utilities.py:137-158."""
    amp = np.asarray(amp)
    if amp.ndim == 2:
        no, nv = amp.shape
        g = np.zeros((no * 2, nv * 2))
        g[0::2, 0::2] = amp
        g[1::2, 1::2] = amp
        return g
    if amp.ndim == 4:
        # spatial t2[i,j,a,b] (= t2ab mixed-spin block) -> spin-orbital t2
        no1, no2, nv1, nv2 = amp.shape
        g = np.zeros((no1 * 2, no2 * 2, nv1 * 2, nv2 * 2))
        # mixed-spin blocks: t2(ab) directly
        ab = amp
        ba = amp.transpose(1, 0, 3, 2)
        # same-spin block from antisymmetrized mixed blocks: t2aa = ab - ab.swap
        aa = amp - amp.transpose(0, 1, 3, 2)
        for si, sj, sa, sb, blk, sign in [
            (0, 0, 0, 0, aa, 1.0), (1, 1, 1, 1, aa, 1.0),
            (0, 1, 0, 1, ab, 1.0), (1, 0, 1, 0, ba, 1.0),
            (0, 1, 1, 0, ab.transpose(0, 1, 3, 2), -1.0),
            (1, 0, 0, 1, ba.transpose(0, 1, 3, 2), -1.0),
        ]:
            g[si::2, sj::2, sa::2, sb::2] = sign * blk
        return g
    raise ValueError("amplitudes must be 2- or 4-dimensional")


def convert_g_to_r_amp(amp):
    """G [0,1,0,1] amplitudes -> R format. Reference utilities.py:161-186."""
    amp = np.asarray(amp)
    if amp.ndim == 2:
        return amp[0::2, 0::2].copy()
    if amp.ndim == 4:
        # return the mixed-spin (ab) block (pyscf spin2spatial t2ab)
        return amp[0::2, 1::2, 0::2, 1::2].copy()
    raise ValueError("amp dimension must be 2 or 4")


def convert_g_to_ru_rdm1(rdm1_g):
    """AO G rdm1 -> (R, (a, b)) rdm1s. Reference utilities.py:189-206."""
    nao = rdm1_g.shape[0] // 2
    a = rdm1_g[:nao, :nao]
    b = rdm1_g[nao:, nao:]
    return a + b, (a, b)


def convert_u_to_g_rdm1(rdm_u):
    """U rdm1 (a, b) in AO basis -> interleaved G rdm1.
    Reference utilities.py:209-223."""
    nao = rdm_u[0].shape[0]
    g = np.zeros((nao * 2, nao * 2))
    g[::2, ::2] = rdm_u[0]
    g[1::2, 1::2] = rdm_u[1]
    return g


def convert_r_to_g_rdm1(rdm_r):
    """R rdm1 -> block-diagonal G with 1/2 weights. Reference utilities.py:226-243."""
    nao = rdm_r.shape[0]
    g = np.zeros((nao * 2, nao * 2), dtype=np.asarray(rdm_r).dtype)
    g[:nao, :nao] = 0.5 * rdm_r
    g[nao:, nao:] = 0.5 * rdm_r
    return g


def convert_r_to_g_coeff(mo_coeff):
    """Spatial MO coeffs -> G format [0,1,0,1] columns. Reference utilities.py:246-262."""
    dim = mo_coeff.shape[0] * 2
    out = np.zeros((dim, dim))
    out[: dim // 2, 0::2] = mo_coeff
    out[dim // 2:, 1::2] = mo_coeff
    return out


def convert_g_to_r_coeff(mo_coeff):
    """G [0,1,0,1] MO coeffs -> spatial. Reference utilities.py:265-278."""
    dim = mo_coeff.shape[0] // 2
    return mo_coeff[:dim, 0::2].copy()


def convert_u_to_g_coeff(mo_coeff_u):
    """U MO coeffs (a,b) -> G format. Reference utilities.py:281-294."""
    dim = mo_coeff_u[0].shape[0] * 2
    out = np.zeros((dim, dim))
    out[: dim // 2, 0::2] = mo_coeff_u[0]
    out[dim // 2:, 1::2] = mo_coeff_u[1]
    return out


def convert_u_to_g_moc(moc_u):
    """U occupation vectors -> interleaved G. Reference utilities.py:297-308."""
    g = np.zeros(moc_u[0].shape[0] * 2)
    g[::2] = moc_u[0]
    g[1::2] = moc_u[1]
    return g


def ao_to_mo(rdm1_ao, mo_coeff):
    """rdm1 AO -> MO basis (same format both sides). Reference utilities.py:361-378."""
    if rdm1_ao.shape != mo_coeff.shape:
        raise ValueError("rdm1 and MO coefficients must have the same dimension")
    cinv = np.linalg.inv(mo_coeff)
    return cinv @ rdm1_ao @ cinv.conj().T


def mo_to_ao(rdm1_mo, mo_coeff):
    """rdm1 MO -> AO basis. Reference utilities.py:381-394."""
    if rdm1_mo.shape != mo_coeff.shape:
        raise ValueError("rdm1 and mo coeff must have the same size")
    return mo_coeff @ rdm1_mo @ mo_coeff.conj().T


def convert_aoint(int_ao, mo_coeff, g=True):
    """AO integrals -> spin-orbital MO integrals via the reference's
    rdm1-style transform (utilities.py:311-339).  NOTE: this uses ao_to_mo
    (inverse-coefficient transform), replicating the reference's convention
    for building Vexp potential matrices."""
    int_ao = np.asarray(int_ao)
    mo = mo_coeff if g else convert_r_to_g_coeff(mo_coeff)
    if int_ao.ndim == 3 and int_ao.shape[0] == 3:  # dipole
        dim = mo.shape[0]
        out = np.zeros((3, dim, dim))
        for c in range(3):
            out[c] = ao_to_mo(convert_r_to_g_rdm1(int_ao[c]), mo)
        return out
    return ao_to_mo(convert_r_to_g_rdm1(int_ao), mo)


def cis_rdm1(c1):
    """CIS rdm1 blocks from CIS/TDA coefficients. Reference utilities.py:347-358.

    The reference computes ``doo = 2 - einsum(...)`` — an elementwise
    subtraction from 2 that also adds 2 to every OFF-diagonal element; the
    intended closed-shell expression is ``2*I - einsum(...)`` (corrected
    here, like the other documented reference bugs)."""
    nocc = c1.shape[0]
    doo = 2.0 * np.eye(nocc) - np.einsum("ia,ka->ik", c1.conj(), c1)
    dvv = np.einsum("ia,ic->ac", c1, c1.conj())
    return doo, dvv
