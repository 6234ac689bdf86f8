"""The ECW-CCSD equations of the reference in plain PyTorch, on dense
spin-orbital tensors: the rdm1, the energy with an effective Fock matrix
fsp, and the T1/T2 and Lambda1/Lambda2 updates (Stanton, Gauss, Watts and
Bartlett, JCP 94, 4334 (1991)).

A frozen copy of the dense equations of the port (ecw_cc_torch/ops/
ccsd.py), with every kernel call written out as the plain contraction it
computes (both vvvv ladders as einsum over the dense vvvv) and without the
L1 regularization, which the benchmark does not run.  The upstream's
quirk in the Lambda update (`l1new += -l1new * E`, energy_term='ref')
is kept, since it is what the ECW solver solves.
"""

from __future__ import annotations

import torch

einsum = torch.einsum


def gamma_inter(t1, t2, l1, l2):
    """rdm1 intermediates (doo, dov, dvo, dvv); reference
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


def cc_Fvv(eris, t1, t2, fsp, tau_t=None):
    nocc = t1.shape[0]
    fov, fvv = fsp[:nocc, nocc:], fsp[nocc:, nocc:]
    if tau_t is None:
        tau_t = make_tau(t2, t1, t1, fac=0.5)
    return (fvv - 0.5 * einsum("me,ma->ae", fov, t1)
            + einsum("mf,amef->ae", t1, eris.vovv)
            - 0.5 * einsum("mnaf,mnef->ae", tau_t, eris.oovv))


def cc_Foo(eris, t1, t2, fsp, tau_t=None):
    nocc = t1.shape[0]
    fov, foo = fsp[:nocc, nocc:], fsp[:nocc, :nocc]
    if tau_t is None:
        tau_t = make_tau(t2, t1, t1, fac=0.5)
    return (foo + 0.5 * einsum("me,ie->mi", fov, t1)
            + einsum("ne,mnie->mi", t1, eris.ooov)
            + 0.5 * einsum("inef,mnef->mi", tau_t, eris.oovv))


def cc_Fov(eris, t1, t2, fsp):
    nocc = t1.shape[0]
    return fsp[:nocc, nocc:] + einsum("nf,mnef->me", t1, eris.oovv)


def cc_Woooo(eris, t1, t2):
    tau = make_tau(t2, t1, t1)
    tmp = einsum("je,mnie->mnij", t1, eris.ooov)
    W = eris.oooo + tmp - tmp.permute(0, 1, 3, 2)
    return W + 0.25 * einsum("ijef,mnef->mnij", tau, eris.oovv)


def cc_Wovvo(eris, t1, t2):
    eris_ovvo = -eris.ovov.permute(0, 1, 3, 2)
    eris_oovo = -eris.ooov.permute(0, 1, 3, 2)
    W = einsum("jf,mbef->mbej", t1, eris.ovvv)
    W = W - einsum("nb,mnej->mbej", t1, eris_oovo)
    W = W - 0.5 * einsum("jnfb,mnef->mbej", t2, eris.oovv)
    W = W - einsum("jf,nb,mnef->mbej", t1, t1, eris.oovv)
    return W + eris_ovvo


def _eia(diag_oo, diag_vv):
    """The singles and doubles orbital-energy denominators."""
    eia = diag_oo[:, None] - diag_vv[None, :]
    return eia, eia[:, None, :, None] + eia[None, :, None, :]


# ---------------------------------------------------------------------------
# t update (reference CCSD.py:248-338; JAX ccsd.py:277-385)
# ---------------------------------------------------------------------------

def tupdate(eris, t1, t2, fsp=None):
    """T1/T2 SCF update: the amplitudes' residual with fsp, plus the
    amplitudes times eris.fock's diagonal denominators, over those
    denominators."""
    nocc = t1.shape[0]
    fsp = eris.fock if fsp is None else fsp
    fov = fsp[:nocc, nocc:]
    diag = torch.diagonal(eris.fock)
    diag_oo, diag_vv = diag[:nocc], diag[nocc:]
    eia, eijab = _eia(diag_oo, diag_vv)

    tau = make_tau(t2, t1, t1)
    tau_t = make_tau(t2, t1, t1, fac=0.5)
    Fvv = cc_Fvv(eris, t1, t2, fsp, tau_t=tau_t)
    Foo = cc_Foo(eris, t1, t2, fsp, tau_t=tau_t)
    Fov = cc_Fov(eris, t1, t2, fsp)
    Wovvo = cc_Wovvo(eris, t1, t2)
    # The quadratic tau.oovv.tau term enters Stanton's t2 equation twice,
    # through the Woooo and the Wvvvv corrections (0.125 each): X is
    # applied once at 0.25 below, so the ladder and the bare Woooo omit
    # their halves.  The two go together or the term is
    # counted twice.
    X = einsum("ijef,mnef->ijmn", tau, eris.oovv)
    tmp = einsum("je,mnie->mnij", t1, eris.ooov)
    Woooo = eris.oooo + tmp - tmp.permute(0, 1, 3, 2)

    Fvv = Fvv - torch.diag(diag_vv)
    Foo = Foo - torch.diag(diag_oo)

    # T1
    t1new = (einsum("ie,ae->ia", t1, Fvv)
             - einsum("ma,mi->ia", t1, Foo)
             + einsum("imae,me->ia", t2, Fov)
             - einsum("nf,naif->ia", t1, eris.ovov)
             - 0.5 * einsum("imef,maef->ia", t2, eris.ovvv)
             - 0.5 * einsum("mnae,mnie->ia", t2, eris.ooov)
             + fov)

    # T2
    Ftmp = Fvv - 0.5 * einsum("mb,me->be", t1, Fov)
    tmp = einsum("ijae,be->ijab", t2, Ftmp)
    t2new = tmp - tmp.permute(0, 1, 3, 2)
    Ftmp = Foo + 0.5 * einsum("je,me->mj", t1, Fov)
    tmp = einsum("imab,mj->ijab", t2, Ftmp)
    t2new = t2new - (tmp - tmp.permute(1, 0, 2, 3))
    t2new = t2new + eris.oovv
    t2new = t2new + 0.5 * einsum("mnab,mnij->ijab", tau, Woooo)
    t2new = t2new + 0.25 * einsum("ijmn,mnab->ijab", X, tau)
    # the ladder 0.5 tau.Wvvvv without its quadratic term (applied above)
    Y = einsum("ijef,mbef->ijmb", tau, eris.ovvv)
    t2new = (t2new + 0.5 * einsum("ijef,abef->ijab", tau, eris.vvvv)
             + einsum("ijmb,ma->ijab", Y, -0.5 * t1)
             + einsum("ijma,mb->ijab", Y, 0.5 * t1))
    tmp = einsum("imae,mbej->ijab", t2, Wovvo)
    tmp = tmp + einsum("ie,ma,mbje->ijab", t1, t1, eris.ovov)
    tmp = tmp - tmp.permute(1, 0, 2, 3)
    tmp = tmp - tmp.permute(0, 1, 3, 2)
    t2new = t2new + tmp
    tmp = einsum("ie,jeba->ijab", t1, eris.ovvv)
    t2new = t2new + (tmp - tmp.permute(1, 0, 2, 3))
    tmp = einsum("ma,ijmb->ijab", t1, eris.ooov)
    t2new = t2new - (tmp - tmp.permute(0, 1, 3, 2))

    return t1new / eia, t2new / eijab


# ---------------------------------------------------------------------------
# Lambda intermediates and update (reference CCSD.py:419-623; JAX
# ccsd.py:392-637)
# ---------------------------------------------------------------------------

def Linter(eris, t1, t2, fsp=None, cheap=False):
    """Lambda intermediates.  Reference CCSD.py:543-623.

    cheap=True skips the (v, v, v, o) wvvvo intermediate: its only
    consumer, one l1 contraction, is folded into lupdate as reassociated
    chains instead (exact).  lupdate runs cheap=True; cheap=False, the
    reference's form, has no caller in either package."""
    nocc = t1.shape[0]
    fsp = eris.fock if fsp is None else fsp
    foo, fov = fsp[:nocc, :nocc], fsp[:nocc, nocc:]
    fvo, fvv = fsp[nocc:, :nocc], fsp[nocc:, nocc:]

    tau = t2 + 2.0 * einsum("ia,jb->ijab", t1, t1)

    v1 = (fvv - einsum("ja,jb->ba", fov, t1)
          - einsum("jbac,jc->ba", eris.ovvv, t1)
          + 0.5 * einsum("jkca,jkbc->ba", eris.oovv, tau))
    v2 = (foo + einsum("ib,jb->ij", fov, t1)
          - einsum("kijb,kb->ij", eris.ooov, t1)
          + 0.5 * einsum("ikbc,jkbc->ij", eris.oovv, tau))
    v3 = einsum("ijcd,klcd->ijkl", eris.oovv, tau)
    v4 = einsum("ljdb,klcd->jcbk", eris.oovv, t2) + eris.ovvo
    v5 = fvo + einsum("kc,jkbc->bj", fov, t2)
    tmp = fov - einsum("kldc,ld->kc", eris.oovv, t1)
    v5 = v5 + einsum("kc,kb,jc->bj", tmp, t1, t1)
    v5 = v5 - 0.5 * einsum("kljc,klbc->bj", eris.ooov, t2)
    v5 = v5 + 0.5 * einsum("kbdc,jkcd->bj", eris.ovvv, t2)

    w3 = (v5 + einsum("jcbk,jb->ck", v4, t1)
          + einsum("cb,jb->cj", v1, t1)
          - einsum("jk,jb->bk", v2, t1))

    woooo = (0.5 * eris.oooo + 0.25 * v3
             + einsum("jilc,kc->jilk", eris.ooov, t1))
    wovvo = (v4 - einsum("ljdb,lc,kd->jcbk", eris.oovv, t1, t1)
             - einsum("ljkb,lc->jcbk", eris.ooov, t1)
             + einsum("jcbd,kd->jcbk", eris.ovvv, t1))
    wovoo = (0.25 * einsum("icdb,jkdb->icjk", eris.ovvv, tau)
             + 0.5 * eris.ooov.permute(2, 3, 0, 1)
             + einsum("icbk,jb->icjk", v4, t1)
             - einsum("lijb,klcb->icjk", eris.ooov, t2))
    if cheap:
        wvvvo = None
    else:
        wvvvo = (einsum("jcak,jb->bcak", v4, t1)
                 + 0.25 * einsum("jlka,jlbc->bcak", eris.ooov, tau)
                 - 0.5 * eris.ovvv.permute(3, 2, 1, 0)
                 + einsum("kbad,jkcd->bcaj", eris.ovvv, t2))

    E = (einsum("ia,ia->", fsp[:nocc, nocc:], t1)
         + 0.25 * einsum("ijab,ijab->", t2, eris.oovv)
         + 0.5 * einsum("ia,jb,ijab->", t1, t1, eris.oovv))
    return dict(v1=v1, v2=v2, v4=v4, w3=w3, woooo=woooo, wovvo=wovvo,
                wovoo=wovoo, wvvvo=wvvvo, E=E)


def lupdate(eris, t1, t2, l1, l2, fsp=None, energy_term="ref"):
    """Lambda1/Lambda2 SCF update.  Reference CCSD.py:419-535.

    energy_term: 'ref' keeps the reference's `l1new += -l1new * E`
    (CCSD.py:509-510); 'off' gives the textbook equations."""
    nocc = t1.shape[0]
    fsp = eris.fock if fsp is None else fsp
    imds = Linter(eris, t1, t2, fsp=fsp, cheap=True)
    fov = fsp[:nocc, nocc:]
    diag = torch.diagonal(eris.fock)
    diag_oo, diag_vv = diag[:nocc], diag[nocc:]
    eia, eijab = _eia(diag_oo, diag_vv)

    v1 = imds["v1"] - torch.diag(diag_vv)
    v2 = imds["v2"] - torch.diag(diag_oo)
    E = imds["E"]
    if energy_term == "off":
        E = 0.0

    oovv = eris.oovv
    mba = 0.5 * einsum("klca,klcb->ba", l2, t2)
    mij = 0.5 * einsum("kicd,kjcd->ij", l2, t2)
    m3 = einsum("klab,ijkl->ijab", l2, imds["woooo"])
    tau = t2 + 2.0 * einsum("ia,jb->ijab", t1, t1)
    tmp = einsum("ijcd,klcd->ijkl", l2, tau)
    m3 = m3 + 0.25 * einsum("klab,ijkl->ijab", oovv, tmp)
    tmp = einsum("ijcd,kd->ijck", l2, t1)
    m3 = m3 - einsum("kcba,ijck->ijab", eris.ovvv, tmp)
    m3 = m3 + 0.5 * einsum("ijcd,cdab->ijab", l2, eris.vvvv)

    l2new = oovv + m3
    fov1 = fov + einsum("kjcb,kc->jb", oovv, t1)
    tmp = einsum("ia,jb->ijab", l1, fov1)
    tmp = tmp + einsum("kica,jcbk->ijab", l2, imds["wovvo"])
    tmp = tmp - tmp.permute(1, 0, 2, 3)
    l2new = l2new + tmp - tmp.permute(0, 1, 3, 2)
    tmp = einsum("ka,ijkb->ijab", l1, eris.ooov)
    tmp = tmp + einsum("ijca,cb->ijab", l2, v1)
    tmp1vv = mba + einsum("ka,kb->ba", l1, t1)
    tmp = tmp + einsum("ca,ijcb->ijab", tmp1vv, oovv)
    l2new = l2new - (tmp - tmp.permute(0, 1, 3, 2))
    tmp = einsum("ic,jcba->jiba", l1, eris.ovvv)
    tmp = tmp + einsum("kiab,jk->ijab", l2, v2)
    tmp1oo = mij + einsum("ic,kc->ik", l1, t1)
    tmp = tmp - einsum("ik,kjab->ijab", tmp1oo, oovv)
    l2new = l2new + (tmp - tmp.permute(1, 0, 2, 3))

    l1new = (fov
             + einsum("jb,ibaj->ia", l1, eris.ovvo)
             + einsum("ib,ba->ia", l1, v1)
             - einsum("ja,ij->ia", l1, v2)
             - einsum("kjca,icjk->ia", l2, imds["wovoo"])
             + einsum("ijab,jb->ia", m3, t1)
             + einsum("jiba,bj->ia", l2, imds["w3"]))
    # -l2.wvvvo folded in without forming wvvvo (Linter cheap=True): its
    # v4.t1, 0.25 ooov.tau, -0.5 ovvv and ovvv.t2 pieces, reassociated
    tmp = einsum("ikbc,jb->ikcj", l2, t1)
    l1new = l1new - einsum("ikcj,jcak->ia", tmp, imds["v4"])
    tmp = einsum("ikbc,jlbc->ikjl", l2, tau)
    l1new = l1new - 0.25 * einsum("ikjl,jlka->ia", tmp, eris.ooov)
    l1new = l1new + 0.5 * einsum("ikbc,kacb->ia", l2, eris.ovvv)
    Zl = einsum("ikbc,kmcd->ibmd", l2, t2)
    l1new = l1new - einsum("ibmd,mbad->ia", Zl, eris.ovvv)
    tmp = (t1 + einsum("kc,kjcb->jb", l1, t2)
           - einsum("bd,jd->jb", tmp1vv, t1)
           - einsum("lj,lb->jb", mij, t1))
    l1new = l1new + einsum("jiba,jb->ia", oovv, tmp)
    l1new = l1new + einsum("icab,bc->ia", eris.ovvv, tmp1vv)
    l1new = l1new - einsum("jika,kj->ia", eris.ooov, tmp1oo)
    tmp = fov - einsum("kjba,jb->ka", oovv, t1)
    l1new = l1new - einsum("ik,ka->ia", mij, tmp)
    l1new = l1new - einsum("ca,ic->ia", mba, tmp)

    # the reference's energy terms multiply the assembled residual
    l1new = l1new - l1new * E
    l2new = l2new - l2new * E

    return l1new / eia, l2new / eijab


