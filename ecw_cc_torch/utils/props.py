"""One-electron property evaluators (reference utilities.py:985-1161).

All accept rdm1 in AO or MO basis, R or G format, exactly like the reference.

Copy of ecw_cc_tpu/utils/props.py (the PyTorch port imports
nothing of the JAX package); the imports differ, and `_to_ao_r` takes two
matrix products where the original takes a three-operand einsum.
"""

from __future__ import annotations

import numpy as np

from ecw_cc_torch.utils import convert


def _to_ao_r(mol, rdm1, g, aobasis, mo_coeff):
    rdm1 = np.asarray(rdm1)
    if not aobasis:
        if mo_coeff is None:
            raise ValueError("mo_coeff must be given if rdm is not in AO basis")
        # C gamma C^H as two matrix products (the three-operand einsum of the
        # JAX copy runs unfactored, O(n^4))
        mo_coeff = np.asarray(mo_coeff)
        rdm1 = (mo_coeff @ rdm1) @ np.conj(mo_coeff).T
    if g:
        rdm1 = convert.convert_g_to_ru_rdm1(rdm1)[0]
    return rdm1


def Ekin(mol, rdm1, g=True, aobasis=True, mo_coeff=None, ek_int=None):
    """Electronic kinetic energy. Reference utilities.py:985-1014."""
    dm = _to_ao_r(mol, rdm1, g, aobasis, mo_coeff)
    if ek_int is None:
        ek_int = mol.intor("kin")
    return np.einsum("ij,ji", ek_int, dm)


def v1e(mol, rdm1, g=True, aobasis=True, mo_coeff=None, v1e_int=None):
    """One-electron nuclear-attraction potential. Reference utilities.py:1017-1046."""
    dm = _to_ao_r(mol, rdm1, g, aobasis, mo_coeff)
    if v1e_int is None:
        v1e_int = mol.intor("nuc")
    return np.einsum("ij,ji", v1e_int, dm)


def dipole(mol, rdm1, g=True, aobasis=True, mo_coeff=None, dip_int=None):
    """(Transition) dipole vector. Reference utilities.py:1049-1086."""
    dm = _to_ao_r(mol, rdm1, g, aobasis, mo_coeff)
    if dip_int is None:
        dip_int = mol.intor("r", origin=mol.charge_center())
    return np.einsum("xij,ji->x", dip_int, dm)


def structure_factor(mol, h, rdm1, mo_coeff=None, g=True, aobasis=True, F_int=None,
                     rec_vec=np.asarray([10.0, 10.0, 10.0])):
    """Structure factors for Miller indices h. Reference utilities.py:1089-1124."""
    dm = _to_ao_r(mol, rdm1, g, aobasis, mo_coeff)
    if F_int is None:
        F_int = FT_MO(mol, h, mo_coeff, rec_vec)[1]
    return np.einsum("hij,ji->h", F_int, dm)


def FT_MO(mol, h, mo_coeff, rec_vec=np.asarray([10.0, 10.0, 10.0])):
    """FT integrals over AOs, transformed to MO G basis.
    Reference utilities.py:1127-1161; returns (ft_mo, ft_ao)."""
    mo_coeff = np.asarray(mo_coeff)
    if mo_coeff.shape[0] != mol.nao:
        mo_r = convert.convert_g_to_r_coeff(mo_coeff)
    else:
        mo_r = mo_coeff
    mo_inv = np.linalg.inv(mo_r)
    h = np.asarray(h, dtype=float)
    rec = np.linalg.inv(np.diag(np.asarray(rec_vec, dtype=float)))
    gv = 2 * np.pi * h @ rec
    ft_ao = mol.ft_aopair(gv)
    ft_mo = np.einsum("pi,hij,qj->hpq", mo_inv, ft_ao, np.conj(mo_inv))
    return ft_mo, ft_ao
