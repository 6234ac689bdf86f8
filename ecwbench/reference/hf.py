"""Molecule, RHF and the spin-orbital MO integrals of the reference, in
plain NumPy and PyTorch.

The conventions are those of the program's public results: AO functions
as in reference/aoints.py, the GHF spin orbitals of an RHF alternating
alpha, beta ([0, 1, 0, 1, ...], alpha first among equal energies), and
antisymmetrized physicists' integrals <pq||rs> split into the blocks the
coupled-cluster equations read (oooo, ooov, oovv, ovov, ovvo, ovvv,
ovoo, vovv, vvvv).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ecwbench.reference import aoints
from ecwbench.reference.eri import eri

ANG2BOHR = 1.0 / 0.52917721092
ELEMENT_Z = {"H": 1, "C": 6, "N": 7, "O": 8}


class Molecule:
    """Atoms [(symbol, (x, y, z) in Angstrom)] in a basis dict."""

    def __init__(self, atoms, basis):
        self.atoms = [(s, np.asarray(c, float) * ANG2BOHR) for s, c in atoms]
        self.bs = aoints.BasisSet(self.atoms, basis)
        self.nao = self.bs.nao
        self.charges = np.array([ELEMENT_Z[s] for s, _ in self.atoms], float)
        self.coords = np.array([c for _, c in self.atoms])
        self.nelectron = int(self.charges.sum())

    def energy_nuc(self):
        Z, R = self.charges, self.coords
        return sum(Z[i] * Z[j] / np.linalg.norm(R[i] - R[j])
                   for i in range(len(Z)) for j in range(i))


def rhf(mol, device, conv=1e-10, max_cycle=200):
    """Closed-shell RHF in f64 with DIIS on the commutator, run until the
    commutator's largest element is under `conv`.  Returns a namespace:
    e_tot, mo_energy, mo_coeff (AO x MO), nocc (doubly occupied), the AO
    integrals h, S and the AO ERIs (on `device`)."""
    f64 = torch.float64
    S = torch.as_tensor(aoints.overlap(mol.bs), dtype=f64, device=device)
    h = torch.as_tensor(aoints.kinetic(mol.bs)
                        + aoints.nuclear(mol.bs, mol.charges, mol.coords),
                        dtype=f64, device=device)
    g = eri(mol.bs, device=device)
    nocc = mol.nelectron // 2
    w, v = torch.linalg.eigh(S)
    X = v @ torch.diag(w.rsqrt()) @ v.T

    def solve(F):
        e, C = torch.linalg.eigh(X.T @ F @ X)
        return e, X @ C

    def veff(dm):
        J = torch.einsum("pqrs,rs->pq", g, dm)
        K = torch.einsum("prqs,rs->pq", g, dm)
        return J - 0.5 * K

    e, C = solve(h)
    dm = 2.0 * C[:, :nocc] @ C[:, :nocc].T
    focks, errs = [], []
    for _ in range(max_cycle):
        F = h + veff(dm)
        err = F @ dm @ S - S @ dm @ F
        if err.abs().max() < conv:
            break
        focks.append(F)
        errs.append(err.reshape(-1))
        focks, errs = focks[-8:], errs[-8:]
        n = len(focks)
        B = -torch.ones((n + 1, n + 1), dtype=torch.float64)
        B[n, n] = 0.0
        E = torch.stack(errs)
        B[:n, :n] = (E @ E.T).to("cpu", torch.float64)
        rhs = torch.zeros((n + 1, 1), dtype=torch.float64)
        rhs[n] = -1.0
        c = torch.linalg.lstsq(B, rhs).solution
        F = sum(float(ci) * Fi for ci, Fi in zip(c[:n, 0], focks))
        e, C = solve(F)
        dm = 2.0 * C[:, :nocc] @ C[:, :nocc].T
    else:
        raise RuntimeError("reference RHF did not converge")
    F = h + veff(dm)
    e, C = solve(F)
    dm = 2.0 * C[:, :nocc] @ C[:, :nocc].T
    e_tot = float(torch.sum(dm * h) + 0.5 * torch.sum(dm * veff(dm))
                  + mol.energy_nuc())
    return types.SimpleNamespace(e_tot=e_tot, mo_energy=e, mo_coeff=C,
                                 nocc=nocc, h=h, S=S, eri_ao=g)


def ghf_eris(mf, dtype=torch.float64):
    """The spin-orbital problem of an RHF: fock (diagonal), the
    antisymmetrized MO integral blocks in `dtype`, nocc, nvir, and the GHF
    coefficients C_g (2 nao x 2 nmo, rows [alpha AO; beta AO])."""
    nao, nmo = mf.mo_coeff.shape
    C = mf.mo_coeff
    # spatial MO integrals (pq|rs)
    g = mf.eri_ao
    for _ in range(4):
        g = torch.tensordot(C.T, g, dims=([1], [0]))
        g = g.permute(1, 2, 3, 0)
    spin = torch.arange(2 * nmo, device=C.device) % 2
    sp = torch.arange(2 * nmo, device=C.device) // 2
    same = (spin[:, None] == spin[None, :]).to(C.dtype)
    # chemists' spin-orbital (PQ|RS), then <PQ||RS> = (PR|QS) - (PS|QR)
    chem = g[sp][:, sp][:, :, sp][:, :, :, sp]
    chem = chem * same[:, :, None, None] * same[None, None, :, :]
    phys = chem.permute(0, 2, 1, 3) - chem.permute(0, 2, 3, 1)
    del chem
    nocc = 2 * mf.nocc
    o, v = slice(0, nocc), slice(nocc, 2 * nmo)
    blocks = {}
    for name in ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovvv", "ovoo",
                 "vovv", "vvvv"):
        idx = [o if c == "o" else v for c in name]
        blocks[name] = phys[idx[0], idx[1], idx[2], idx[3]].to(
            dtype).contiguous()
    del phys
    energies = mf.mo_energy.repeat_interleave(2)
    Cg = torch.zeros((2 * nao, 2 * nmo), dtype=C.dtype, device=C.device)
    Cg[:nao, 0::2] = C
    Cg[nao:, 1::2] = C
    return types.SimpleNamespace(
        fock=torch.diag(energies).to(dtype), nocc=nocc, nvir=2 * nmo - nocc,
        C_g=Cg, **blocks)
