"""ECW-CCSD kernels on the solver's path (port of the matching subset of
ecw_cc_tpu/ops/ccsd.py): the rdm1, the energy and tau.

The dense t/lambda updates (tupdate, lupdate, Linter and their
intermediates) are not ported yet (ROADMAP A.2); the solver runs the
sector-blocked twins in ops/ccsd_sect.py.
"""

from __future__ import annotations

import torch

einsum = torch.einsum


def gamma_inter(t1, t2, l1, l2):
    """Dense rdm1 intermediates (doo, dov, dvo, dvv); reference
    CCSD.py:136-182."""
    doo = -einsum("ie,je->ij", l1, t1) - 0.5 * einsum("imef,jmef->ij", l2, t2)
    dvv = einsum("ma,mb->ab", t1, l1) + 0.5 * einsum("mnea,mneb->ab", t2, l2)
    xt1 = 0.5 * einsum("mnef,inef->mi", l2, t2)
    xt2 = 0.5 * einsum("mnfa,mnfe->ae", t2, l2) + einsum("ma,me->ae", t1, l1)
    dvo = (einsum("imae,me->ai", t2, l1) - einsum("mi,ma->ai", xt1, t1)
           - einsum("ie,ae->ai", t1, xt2) + t1.T)
    return doo, l1, dvo, dvv


def gamma_CCSD(t1, t2, l1, l2, inter=None):
    """Symmetrized GS rdm1 (PySCF convention); reference CCSD.py:136-162.
    inter: precomputed (doo, dov, dvo, dvv), e.g. the sector-blocked ones
    (ops/ccsd_sect.gamma_inter_sect)."""
    doo, dov, dvo, dvv = (gamma_inter(t1, t2, l1, l2) if inter is None
                          else inter)
    nocc, nvir = dov.shape
    top = torch.cat([doo + doo.T, dov + dvo.T], dim=1)
    bot = torch.cat([(dov + dvo.T).T, dvv + dvv.T], dim=1)
    dm1 = 0.5 * torch.cat([top, bot], dim=0)
    occ = torch.cat([torch.ones(nocc, dtype=dm1.dtype, device=dm1.device),
                     torch.zeros(nvir, dtype=dm1.dtype, device=dm1.device)])
    return dm1 + torch.diag(occ)


def energy(eris, t1, t2, fsp):
    """ECW-CCSD energy with the effective Fock matrix fsp; reference
    CCSD.py:224-242."""
    nocc = t1.shape[0]
    fsp = eris.fock if fsp is None else fsp
    e = einsum("ia,ia->", fsp[:nocc, nocc:], t1)
    e = e + 0.25 * einsum("ijab,ijab->", t2, eris.oovv)
    e = e + 0.5 * einsum("ia,jb,ijab->", t1, t1, eris.oovv)
    return e


def make_tau(t2, t1a, t1b, fac=1.0):
    t1t1 = einsum("ia,jb->ijab", fac * 0.5 * t1a, t1b)
    t1t1 = t1t1 - t1t1.permute(1, 0, 2, 3)
    return t2 + t1t1 - t1t1.permute(0, 1, 3, 2)


class GCC:
    """Thin class wrapper matching the reference API (CCSD.py:185)."""

    def __init__(self, eris, fock=None):
        self.eris = eris
        self.fock = eris.fock if fock is None else fock
        self.nocc = eris.nocc
        self.nvir = eris.nvir

    def gamma(self, t1, t2, l1, l2):
        return gamma_CCSD(t1, t2, l1, l2)

    def gamma_inter(self, t1, t2, l1, l2):
        return gamma_inter(t1, t2, l1, l2)

    def energy(self, t1, t2, fsp):
        return energy(self.eris, t1, t2, fsp)

    def tupdate(self, *args, **kwargs):
        raise NotImplementedError(
            "the dense CCSD t update is not ported yet (ROADMAP A.2); the "
            "solver runs ops/ccsd_sect.tupdate_sect")

    def lupdate(self, *args, **kwargs):
        raise NotImplementedError(
            "the dense CCSD lambda update is not ported yet (ROADMAP A.2); "
            "the solver runs ops/ccsd_sect.lupdate_sect")
