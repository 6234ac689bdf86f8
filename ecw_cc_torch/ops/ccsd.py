"""ECW-CCSD kernels on dense (o, o, v, v) tensors (port of
ecw_cc_tpu/ops/ccsd.py; reference CCSD.py).

The T1/T2 and Lambda1/Lambda2 SCF updates with the effective Fock matrix
fsp and optional L1 regularization of the doubles, their intermediates,
the CCSD rdm1 and the transition rdm1s, in the factorized spin-orbital
scheme of Stanton, Gauss, Watts and Bartlett (JCP 94, 4334 (1991)).  They
run on either MO layout.

Energy-term convention: the reference adds `l1new += -l1new * E` (and the
same for l2) in lupdate (CCSD.py:509-510).  energy_term='ref' keeps that
quirk; 'off' gives the textbook Lambda equations.

Both vvvv ladders go through ops/ladder.py, whose every product is the
hand-written GEMM kernel: the t ladder in `ladder_contract`, the lambda
ladder as the same NT product of l2 (the JAX package's
0.5*einsum('ijcd,cdab->ijab', l2, vvvv), ccsd.py:543).  The JAX package's
pre-permuted ERI views (SoupViews, `views=`) are not ported: the port
computes the reference-ordered contractions, the same math.
"""

from __future__ import annotations

import torch

from ecw_cc_torch.ops import promote
from ecw_cc_torch.ops.l1reg import subdiff
from ecw_cc_torch.ops.ladder import apply_vvvv_op, dense_ladder, ladder_contract

einsum = promote.lane_einsum


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


# ---------------------------------------------------------------------------
# Transition rdm1 (reference CCSD.py:33-133; JAX ccsd.py:123-185)
# ---------------------------------------------------------------------------

def tr_rdm1_inter(t1, t2, l1, l2, r1, r2, r0):
    """Intermediates of tr_rdm1.  Reached through GCC.tr_rdm1_inter, the
    reference API; no solver of either package calls it."""
    Yijem = einsum("if,jmfe->ijem", t1, l2)
    # the reference's einsum('me,mnea->abn', r1, l2) (CCSD.py:48) is an
    # invalid subscript; the intermediate contracted later with t1[n,b] is
    # Y[n,a] = sum_me r_me l2_mnea (as in the JAX package)
    Yna = einsum("me,mnea->na", r1, l2)
    Yim = (-einsum("ie,me->im", t1, l1)
           - 0.5 * einsum("inef,mnef->im", t2, l2)) * r0
    Yim = Yim - einsum("ie,me->im", r1, l1)
    Yim = Yim - 0.5 * einsum("inef,mnef->im", r2, l2)
    Yim = Yim - einsum("ie,nf,mnef->im", t1, r1, l2)
    Yea = (-0.5 * r0 * einsum("mnaf,mnef->ea", t2, l2)
           - einsum("ma,me->ea", r1, l1)
           - 0.5 * einsum("mnaf,mnef->ea", r2, l2))
    Yea_p = -0.5 * einsum("mnaf,mnef->ea", t2, l2)
    Yanef = -0.5 * einsum("ma,mnef->anef", r1, l2)
    Yainf = einsum("imae,mnef->ainf", t2, l2)
    return Yijem, Yna, Yim, Yea, Yea_p, Yanef, Yainf


def tr_rdm1(t1, t2, l1, l2, r1, r2, r0, inter=None):
    """Transition rdm1 <Psi_m(t,l)|ap+.aq|Psi_n(t,r)>.  Reference
    CCSD.py:75-133.  Reached through GCC.tr_rdm1, the reference API; no
    solver of either package calls it."""
    if inter is None:
        inter = tr_rdm1_inter(t1, t2, l1, l2, r1, r2, r0)
    Yijem, Yna, Yim, Yea, Yea_p, Yanef, Yainf = inter

    oo = (einsum("ie,je->ij", t1, l1)
          + 0.5 * einsum("imfe,jmfe->ij", t2, l2)) * (-r0)
    oo = (oo - einsum("ie,je->ij", r1, l1)
          - 0.5 * einsum("imfe,jmfe->ij", r2, l2))
    oo = oo + einsum("me,ijem->ij", r1, Yijem)

    vv = (einsum("mb,am->ab", t1, l1.T)
          + 0.5 * einsum("mneb,mnea->ab", t2, l2)) * r0
    vv = (vv + einsum("mb,ma->ab", r1, l1)
          + 0.5 * einsum("mneb,mnea->ab", r2, l2))
    vv = vv + einsum("nb,na->ab", t1, Yna)

    ov = r0 * l1 + einsum("imae,me->ia", l2, r1)

    vo = (r0 * einsum("imae,me->ai", t2, l1) + t1.T
          + einsum("imae,me->ai", r2, l1)
          + einsum("ie,ea->ai", r1, Yea_p)
          + einsum("inef,anef->ai", t2, Yanef)
          + einsum("nf,ainf->ai", r1, Yainf)
          + einsum("ma,im->ai", t1, Yim)
          + einsum("ea,ie->ai", Yea, t1))

    return torch.cat([torch.cat([oo, ov], dim=1),
                      torch.cat([vo, vv], dim=1)], dim=0)


def tr_rdm1_left(t1, t2, lk1, lk2):
    """Pure-L left transition rdm1 <0|L_k e^-T ap+.aq e^T|0> in the
    reference index convention (JAX ccsd.py:169): tr_rdm1 with bra
    (1 + L_k) minus its bare-reference piece, since an EOM-EE left vector
    has l0 = 0.  It equals the ov/vo-swapped ops/eom.tr_rdm1_left, which
    the tests hold it against (tests/test_torch_eom.py)."""
    zero1 = torch.zeros_like(t1)
    zero2 = torch.zeros_like(t2)
    full = tr_rdm1(t1, t2, lk1, lk2, zero1, zero2, 1.0)
    ref_piece = tr_rdm1(t1, t2, zero1, zero2, zero1, zero2, 1.0)
    return full - ref_piece


# ---------------------------------------------------------------------------
# T intermediates (reference CCSD.py:346-413; JAX ccsd.py:211-270)
# ---------------------------------------------------------------------------

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


def cc_Wvvvv(eris, t1, t2):
    """The full Wvvvv intermediate (O(v^4) memory; the solver never forms
    it, ladder_contract contracts its pieces with tau directly).  No caller
    in either package: kept as the reference's intermediate."""
    tau = make_tau(t2, t1, t1)
    tmp = einsum("mb,mafe->bafe", t1, eris.ovvv)
    W = eris.vvvv - tmp + tmp.permute(1, 0, 2, 3)
    return W + einsum("mnab,mnef->abef", tau, 0.25 * eris.oovv)


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

def tupdate(eris, t1, t2, fsp=None, alpha=None, equation=False,
            vvvv_op=None, ladder_pre=None):
    """T1/T2 SCF update (or the equation values, equation=True) with
    optional L1 regularization of the doubles.  Reference CCSD.py:248-338.

    vvvv_op: the non-dense ladder operand (PackedVVVV or SectoredVVVV),
    None for the dense GEMM against eris.vvvv.  ladder_pre: the bare
    ladder of tau, precomputed (the solver's stacked GEMM)."""
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
    # applied once at 0.25 below, so the ladder (skip_quad=True) and the
    # bare Woooo omit their halves.  The two go together or the term is
    # counted twice.
    X = einsum("ijef,mnef->ijmn", tau, eris.oovv)
    tmp = einsum("je,mnie->mnij", t1, eris.ooov)
    Woooo = eris.oooo + tmp - tmp.permute(0, 1, 3, 2)

    if not equation and alpha is None:
        Fvv = Fvv - torch.diag(diag_vv)
        Foo = Foo - torch.diag(diag_oo)

    # T1 (Fvv, Foo and the Ftmp below carry fock's dtype: under 'bf16'
    # their products with the bf16 amplitudes promote, ops/promote.py)
    t1new = (promote.einsum("ie,ae->ia", t1, Fvv)
             - promote.einsum("ma,mi->ia", t1, Foo)
             + einsum("imae,me->ia", t2, Fov)
             - einsum("nf,naif->ia", t1, eris.ovov)
             - 0.5 * einsum("imef,maef->ia", t2, eris.ovvv)
             - 0.5 * einsum("mnae,mnie->ia", t2, eris.ooov)
             + fov)

    # T2
    Ftmp = Fvv - 0.5 * einsum("mb,me->be", t1, Fov)
    tmp = promote.einsum("ijae,be->ijab", t2, Ftmp)
    t2new = tmp - tmp.permute(0, 1, 3, 2)
    Ftmp = Foo + 0.5 * einsum("je,me->mj", t1, Fov)
    tmp = promote.einsum("imab,mj->ijab", t2, Ftmp)
    t2new = t2new - (tmp - tmp.permute(1, 0, 2, 3))
    t2new = t2new + eris.oovv
    t2new = t2new + 0.5 * einsum("mnab,mnij->ijab", tau, Woooo)
    t2new = t2new + 0.25 * einsum("ijmn,mnab->ijab", X, tau)
    t2new = t2new + ladder_contract(eris, t1, t2, tau, vvvv_op=vvvv_op,
                                    skip_quad=True, L1_pre=ladder_pre)
    tmp = einsum("imae,mbej->ijab", t2, Wovvo)
    tmp = tmp + einsum("ie,ma,mbje->ijab", t1, t1, eris.ovov)
    tmp = tmp - tmp.permute(1, 0, 2, 3)
    tmp = tmp - tmp.permute(0, 1, 3, 2)
    t2new = t2new + tmp
    tmp = einsum("ie,jeba->ijab", t1, eris.ovvv)
    t2new = t2new + (tmp - tmp.permute(1, 0, 2, 3))
    tmp = einsum("ma,ijmb->ijab", t1, eris.ooov)
    t2new = t2new - (tmp - tmp.permute(0, 1, 3, 2))

    if alpha is not None:
        dW1 = t1new   # L1 regularization on the doubles only (CCSD.py:318)
        dW2 = subdiff(t2new, t2, alpha)
        if equation:
            return dW1, dW2
        return (dW1 + t1 * eia) / eia, (dW2 + t2 * eijab) / eijab
    if not equation:
        return t1new / eia, t2new / eijab
    return t1new, t2new


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


def lupdate(eris, t1, t2, l1, l2, fsp=None, alpha=None, equation=False,
            energy_term="ref", vvvv_op=None, ladder_pre=None):
    """Lambda1/Lambda2 SCF update.  Reference CCSD.py:419-535.

    energy_term: 'ref' keeps the reference's `l1new += -l1new * E`
    (CCSD.py:509-510); 'off' gives the textbook equations.  vvvv_op /
    ladder_pre: as in tupdate, for the lambda ladder 'ijcd,cdab->ijab'
    (ladder_pre must come from the l2 passed here)."""
    nocc = t1.shape[0]
    fsp = eris.fock if fsp is None else fsp
    imds = Linter(eris, t1, t2, fsp=fsp, cheap=True)
    fov = fsp[:nocc, nocc:]
    diag = torch.diagonal(eris.fock)
    diag_oo, diag_vv = diag[:nocc], diag[nocc:]
    eia, eijab = _eia(diag_oo, diag_vv)

    if equation is False and alpha is None:
        v1 = imds["v1"] - torch.diag(diag_vv)
        v2 = imds["v2"] - torch.diag(diag_oo)
        E = imds["E"]
    else:
        v1 = imds["v1"]
        v2 = imds["v2"]
        E = 0.0
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
    if ladder_pre is not None:
        m3 = m3 + ladder_pre
    elif vvvv_op is not None:
        m3 = m3 + apply_vvvv_op(vvvv_op, l2)
    else:
        # 0.5 * einsum('ijcd,cdab->ijab', l2, vvvv): the t ladder's NT
        # product by the pair-swap symmetry of <ab||cd>
        m3 = m3 + 0.5 * dense_ladder(l2, eris.vvvv)

    l2new = oovv + m3
    fov1 = fov + einsum("kjcb,kc->jb", oovv, t1)
    tmp = einsum("ia,jb->ijab", l1, fov1)
    tmp = tmp + einsum("kica,jcbk->ijab", l2, imds["wovvo"])
    tmp = tmp - tmp.permute(1, 0, 2, 3)
    l2new = l2new + tmp - tmp.permute(0, 1, 3, 2)
    tmp = einsum("ka,ijkb->ijab", l1, eris.ooov)
    tmp = tmp + promote.einsum("ijca,cb->ijab", l2, v1)
    tmp1vv = mba + einsum("ka,kb->ba", l1, t1)
    tmp = tmp + einsum("ca,ijcb->ijab", tmp1vv, oovv)
    l2new = l2new - (tmp - tmp.permute(0, 1, 3, 2))
    tmp = einsum("ic,jcba->jiba", l1, eris.ovvv)
    tmp = tmp + promote.einsum("kiab,jk->ijab", l2, v2)
    tmp1oo = mij + einsum("ic,kc->ik", l1, t1)
    tmp = tmp - einsum("ik,kjab->ijab", tmp1oo, oovv)
    l2new = l2new + (tmp - tmp.permute(1, 0, 2, 3))

    l1new = (fov
             + einsum("jb,ibaj->ia", l1, eris.ovvo)
             + promote.einsum("ib,ba->ia", l1, v1)
             - promote.einsum("ja,ij->ia", l1, v2)
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

    if alpha is not None:
        dW1 = l1new   # L1 regularization on the doubles only (CCSD.py:515)
        dW2 = subdiff(l2new, l2, alpha)
        if equation:
            return dW1, dW2
        return (dW1 + l1 * eia) / eia, (dW2 + l2 * eijab) / eijab
    if not equation:
        return l1new / eia, l2new / eijab
    return l1new, l2new


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

    def tr_rdm1_inter(self, t1, t2, l1, l2, r1, r2, r0):
        return tr_rdm1_inter(t1, t2, l1, l2, r1, r2, r0)

    def tr_rdm1(self, t1, t2, l1, l2, r1, r2, r0, inter=None):
        return tr_rdm1(t1, t2, l1, l2, r1, r2, r0, inter)

    def energy(self, t1, t2, fsp):
        return energy(self.eris, t1, t2, fsp)

    def tupdate(self, t1, t2, fsp=None, alpha=None, equation=False,
                vvvv_op=None):
        return tupdate(self.eris, t1, t2, fsp, alpha, equation, vvvv_op)

    def lupdate(self, t1, t2, l1, l2, fsp=None, alpha=None, equation=False,
                energy_term="ref", vvvv_op=None):
        return lupdate(self.eris, t1, t2, l1, l2, fsp, alpha, equation,
                       energy_term, vvvv_op)
