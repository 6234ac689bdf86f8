"""Host-side SCF: RHF and UHF with DIIS, plus RHF->GHF conversion.

Replaces PySCF scf.RHF/UHF/convert_to_ghf used by the reference
(Main.py:156-169, gamma_exp.py:123-211, 332-462).  The GHF conversion
reproduces PySCF's layout: spin-orbitals interleaved [a, b, a, b, ...]
(orbspin = [0, 1, 0, 1, ...]) with the AO dimension doubled as
[[mo_a], [mo_b]] stacked blocks (reference Eris.py:52-57).

Copy of ecw_cc_tpu/models/scf.py (the PyTorch port imports
nothing of the JAX package); only the imports differ.
"""

from __future__ import annotations

import numpy as np


class HostDIIS:
    """Pulay DIIS over arbitrary flattened vectors (host-side NumPy).

    Mirrors pyscf.lib.diis.DIIS usage in the reference (Solver_GS.py:149-152):
    `update(x)` extrapolates from the history of x and its successive
    differences as error vectors.
    """

    def __init__(self, space=8, min_space=2):
        self.space = space
        self.min_space = min_space
        self._xs = []
        self._errs = []
        self._last = None

    def update(self, x, err=None):
        x = np.asarray(x)
        if err is None:
            if self._last is None:
                self._last = x.copy()
                return x
            err = x - self._last
        self._xs.append(x.ravel().copy())
        self._errs.append(np.asarray(err).ravel().copy())
        if len(self._xs) > self.space:
            self._xs.pop(0)
            self._errs.pop(0)
        self._last = x.copy()
        n = len(self._xs)
        if n < self.min_space:
            return x
        B = np.empty((n + 1, n + 1))
        B[:n, :n] = np.array([[e1 @ e2 for e2 in self._errs] for e1 in self._errs])
        B[n, :] = -1.0
        B[:, n] = -1.0
        B[n, n] = 0.0
        rhs = np.zeros(n + 1)
        rhs[n] = -1.0
        try:
            c = np.linalg.solve(B, rhs)[:n]
        except np.linalg.LinAlgError:
            c, *_ = np.linalg.lstsq(B, rhs, rcond=None)
            c = c[:n]
        xnew = sum(ci * xi for ci, xi in zip(c, self._xs))
        self._last = xnew.reshape(x.shape).copy()
        return self._last


class RHF:
    def __init__(self, mol, conv_tol=1e-11, max_cycle=200, diis_space=8):
        self.mol = mol
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.diis_space = diis_space
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self.e_tot = None
        self.converged = False
        self._hcore_override = None

    def get_hcore(self):
        if self._hcore_override is not None:
            return self._hcore_override
        return self.mol.intor("kin") + self.mol.intor("nuc")

    def set_hcore(self, h):
        self._hcore_override = np.asarray(h)

    def get_veff(self, dm):
        eri = self.mol.intor("int2e")
        j = np.einsum("pqrs,rs->pq", eri, dm)
        k = np.einsum("prqs,rs->pq", eri, dm)
        return j - 0.5 * k

    def kernel(self, dm0=None):
        mol = self.mol
        S = mol.intor("ovlp")
        h = self.get_hcore()
        # symmetric orthogonalization
        w, v = np.linalg.eigh(S)
        X = v @ np.diag(w ** -0.5) @ v.T
        nocc = mol.nelectron // 2
        if mol.nelectron % 2 != 0:
            raise ValueError("RHF requires an even number of electrons")

        def make_dm(C):
            Cocc = C[:, :nocc]
            return 2.0 * Cocc @ Cocc.T

        if dm0 is None:
            e, C = np.linalg.eigh(X.T @ h @ X)
            C = X @ C
            dm = make_dm(C)
        else:
            dm = np.asarray(dm0)
        diis = HostDIIS(space=self.diis_space)
        e_old = 0.0
        for cycle in range(self.max_cycle):
            vhf = self.get_veff(dm)
            F = h + vhf
            # DIIS on Fock with commutator error
            err = F @ dm @ S - S @ dm @ F
            F = diis.update(F, err=err).reshape(F.shape)
            e, C = np.linalg.eigh(X.T @ F @ X)
            C = X @ C
            dm = make_dm(C)
            e_scf = 0.5 * np.einsum("pq,qp", dm, h + h + vhf)
            # recompute vhf-consistent energy
            e_scf = np.einsum("pq,qp", dm, h) + 0.5 * np.einsum("pq,qp", dm, vhf)
            if abs(e_scf - e_old) < self.conv_tol and cycle > 1:
                self.converged = True
                break
            e_old = e_scf
        vhf = self.get_veff(dm)
        F = h + vhf
        e, C = np.linalg.eigh(X.T @ F @ X)
        C = X @ C
        self.mo_energy = e
        self.mo_coeff = C
        self.mo_occ = np.zeros(len(e))
        self.mo_occ[:nocc] = 2.0
        dm = make_dm(C)
        self.e_tot = (np.einsum("pq,qp", dm, h) + 0.5 * np.einsum("pq,qp", dm, self.get_veff(dm))
                      + self.mol.energy_nuc())
        return self.e_tot

    def make_rdm1(self):
        nocc = self.mol.nelectron // 2
        Cocc = self.mo_coeff[:, :nocc]
        return 2.0 * Cocc @ Cocc.T


class UHF:
    """Unrestricted HF; supports fixed occupation patterns (for MOM)."""

    def __init__(self, mol, conv_tol=1e-10, max_cycle=300, diis_space=8):
        self.mol = mol
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.diis_space = diis_space
        self.mo_coeff = None  # (2, nao, nao)
        self.mo_energy = None
        self.mo_occ = None  # (2, nao)
        self.e_tot = None
        self.converged = False
        self._hcore_override = None
        self._mom_ref = None  # (mo_coeff_ref, mo_occ_ref) for MOM occupation

    def get_hcore(self):
        if self._hcore_override is not None:
            return self._hcore_override
        return self.mol.intor("kin") + self.mol.intor("nuc")

    def set_hcore(self, h):
        self._hcore_override = np.asarray(h)

    def set_mom(self, mo_coeff_ref, mo_occ_ref):
        """Maximum-overlap-method occupation (reference scf.addons.mom_occ,
        used in gamma_exp.py:381,429)."""
        self._mom_ref = (np.asarray(mo_coeff_ref), np.asarray(mo_occ_ref))

    def _occupy(self, C, S):
        na, nb = self.mol.nelec
        occ = np.zeros((2, C.shape[-1]))
        if self._mom_ref is None:
            occ[0, :na] = 1.0
            occ[1, :nb] = 1.0
            return occ
        Cref, occ_ref = self._mom_ref
        for s, nel in ((0, na), (1, nb)):
            refocc = Cref[s][:, occ_ref[s] > 0]
            ovl = np.abs(refocc.T @ S @ C[s]).sum(axis=0)
            idx = np.argsort(-ovl)[:nel]
            occ[s, idx] = 1.0
        return occ

    def kernel(self, dm0=None):
        mol = self.mol
        S = mol.intor("ovlp")
        h = self.get_hcore()
        eri = mol.intor("int2e")
        w, v = np.linalg.eigh(S)
        X = v @ np.diag(w ** -0.5) @ v.T
        na, nb = mol.nelec

        def veff(dma, dmb):
            jt = np.einsum("pqrs,rs->pq", eri, dma + dmb)
            ka = np.einsum("prqs,rs->pq", eri, dma)
            kb = np.einsum("prqs,rs->pq", eri, dmb)
            return jt - ka, jt - kb

        if dm0 is None:
            e, C0 = np.linalg.eigh(X.T @ h @ X)
            C0 = X @ C0
            dma = C0[:, :na] @ C0[:, :na].T
            dmb = C0[:, :nb] @ C0[:, :nb].T
        else:
            dma, dmb = dm0
        diis = HostDIIS(space=self.diis_space)
        e_old = 0.0
        C = None
        occ = None
        for cycle in range(self.max_cycle):
            va, vb = veff(dma, dmb)
            Fa, Fb = h + va, h + vb
            erra = Fa @ dma @ S - S @ dma @ Fa
            errb = Fb @ dmb @ S - S @ dmb @ Fb
            Fstack = diis.update(np.stack([Fa, Fb]), err=np.stack([erra, errb]))
            Fa, Fb = Fstack[0], Fstack[1]
            ea, Ca = np.linalg.eigh(X.T @ Fa @ X)
            eb, Cb = np.linalg.eigh(X.T @ Fb @ X)
            C = np.stack([X @ Ca, X @ Cb])
            occ = self._occupy(C, S)
            dma = (C[0] * occ[0]) @ C[0].T
            dmb = (C[1] * occ[1]) @ C[1].T
            e_scf = (np.einsum("pq,qp", dma + dmb, h)
                     + 0.5 * np.einsum("pq,qp", dma, va) + 0.5 * np.einsum("pq,qp", dmb, vb))
            if abs(e_scf - e_old) < self.conv_tol and cycle > 1:
                self.converged = True
                break
            e_old = e_scf
        va, vb = veff(dma, dmb)
        self.mo_coeff = C
        self.mo_occ = occ
        ea = np.diag(C[0].T @ (h + va) @ C[0])
        eb = np.diag(C[1].T @ (h + vb) @ C[1])
        self.mo_energy = np.stack([ea, eb])
        self.e_tot = (np.einsum("pq,qp", dma + dmb, h)
                      + 0.5 * np.einsum("pq,qp", dma, va) + 0.5 * np.einsum("pq,qp", dmb, vb)
                      + self.mol.energy_nuc())
        return self.e_tot

    def make_rdm1(self):
        C, occ = self.mo_coeff, self.mo_occ
        dma = (C[0] * occ[0]) @ C[0].T
        dmb = (C[1] * occ[1]) @ C[1].T
        return np.stack([dma, dmb])


class GHF:
    """Generalized-HF view of a converged RHF object (PySCF convert_to_ghf).

    mo_coeff has shape (2*nao, 2*nmo) with AO rows stacked [alpha-block;
    beta-block] and spin-orbital columns sorted by energy with stable
    alpha-first tie-breaking, giving orbspin = [0,1,0,1,...] for RHF input.
    """

    def __init__(self, mf_rhf: RHF):
        self.mol = mf_rhf.mol
        self._rhf = mf_rhf
        nao, nmo = mf_rhf.mo_coeff.shape
        e = mf_rhf.mo_energy
        # interleave alpha/beta (degenerate pairs) -> [0,1,0,1,...]
        order = np.argsort(np.repeat(e, 2), kind="stable")
        spins = np.tile([0, 1], nmo)[order]  # already alternating for RHF
        energies = np.repeat(e, 2)[order]
        occ_r = mf_rhf.mo_occ
        occ = np.repeat((occ_r > 0).astype(float), 2)[order]
        C = np.zeros((2 * nao, 2 * nmo))
        cols_a = np.where(spins == 0)[0]
        cols_b = np.where(spins == 1)[0]
        src = np.repeat(np.arange(nmo), 2)[order]
        C[:nao, cols_a] = mf_rhf.mo_coeff[:, src[cols_a]]
        C[nao:, cols_b] = mf_rhf.mo_coeff[:, src[cols_b]]
        self.mo_coeff = C
        self.mo_energy = energies
        self.mo_occ = occ
        self.orbspin = spins
        self.e_tot = mf_rhf.e_tot
        self.nocc = int(occ.sum())

    def make_rdm1(self):
        Cocc = self.mo_coeff[:, self.mo_occ > 0]
        return Cocc @ Cocc.T
