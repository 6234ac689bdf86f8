"""Simulated ground-state target data (port of ecw_cc_tpu/models/gamma_exp.py
Gexp; reference gamma_exp.py:104-275).

Only HF targets are ported: the rdm1 of an RHF calculation, optionally
with a static external field, a random geometry deformation and
under-fitting.  CCSD and CCSD(T) targets need the plain CCSD, Lambda and
(T) solvers (ROADMAP A.10) and raise.
"""

from __future__ import annotations

import numpy as np

from ecw_cc_torch.models.molecule import Molecule
from ecw_cc_torch.models.scf import RHF


class Gexp:
    """GS target rdm1 generator (HF method)."""

    def __init__(self, mol: Molecule, method, basis=None):
        self.mol_def = mol.with_basis(basis) if basis is not None else mol.copy()
        self.mf_def = RHF(self.mol_def)
        self.mo_coeff_def = None
        self.nocc = None
        self.nvir = None
        self.gamma_ao = None  # AO basis, R format
        self.method = method
        self.EHF_def = 0.0
        self.Eexp = 0.0

    def deform(self, def_max, rng=None):
        """Random geometry kicks up to def_max (Bohr); reference
        gamma_exp.py:140-168 with per-coordinate indexing."""
        rng = rng or np.random.default_rng()
        natm = self.mol_def.natm
        dq = (rng.random(natm * 3) * 2 - 1) * def_max
        new_atoms = [(sym, xyz + dq[3 * i:3 * i + 3])
                     for i, (sym, xyz) in enumerate(self.mol_def.atoms)]
        self.mol_def = self.mol_def.with_geometry(new_atoms)
        self.mf_def = RHF(self.mol_def)

    def Vext(self, field):
        """Static external field on the one-electron operator; reference
        gamma_exp.py:170-191 (dipole origin at [0,0,0])."""
        mol = self.mol_def
        h = (mol.intor("kin") + mol.intor("nuc")
             + np.einsum("x,xij->ij", np.asarray(field, float),
                         mol.intor("r", origin=np.zeros(3))))
        self.mf_def.set_hcore(h)

    def build(self):
        """HF target calculation; reference gamma_exp.py:193-227."""
        if self.method != "HF":
            norm = self.method.upper().replace("(", "").replace(")", "")
            if norm in ("CCSD", "CCSDT"):
                raise NotImplementedError(
                    f"{self.method} targets are not ported yet "
                    "(ROADMAP A.10); use 'HF'")
            raise ValueError("method not recognized (use 'HF', 'CCSD' or "
                             "'CCSD(T)')")
        self.mf_def.conv_tol = 1e-11
        self.mf_def.kernel()
        self.mo_coeff_def = self.mf_def.mo_coeff
        self.nocc = int(np.sum(self.mf_def.mo_occ > 0))
        self.nvir = int(np.sum(self.mf_def.mo_occ == 0))
        self.EHF_def = self.mf_def.e_tot
        self.Eexp = self.EHF_def
        self.gamma_ao = self.mf_def.make_rdm1()

    def underfit(self, para_factor, rng=None):
        """Randomly zero elements of gamma_ao to simulate under-fitting;
        reference gamma_exp.py:257-275."""
        rng = rng or np.random.default_rng()
        dim = self.mo_coeff_def.shape[0]
        n_exp = int(round(dim ** 2 - para_factor * (self.nocc * self.nvir * 2)))
        idx = rng.choice(dim * dim, size=max(n_exp, 0), replace=False)
        flat = self.gamma_ao.ravel().copy()
        flat[idx] = 0.0
        self.gamma_ao = flat.reshape(dim, dim)
