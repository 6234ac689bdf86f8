"""Spin-sector-blocked ECW-CCSD t/lambda updates (SORTED layout).

Port of ecw_cc_tpu/ops/ccsd_sect.py: every contraction runs through
ops/spinsect.sector_einsum, so the structurally-zero spin blocks (10 of 16
of every 4-index tensor) are neither read nor multiplied.  The math is
term for term the factorized Stanton scheme of the reference (CCSD.py:
248-338 t side, 419-623 lambda side).

Exact while every operand keeps the balanced spin structure, which holds
when the Vexp potential is spin-block-diagonal (the solver checks its
targets once, spinsect.is_block_diagonal).

The bare vvvv ladder comes in as `ladder_pre` (the solver's stacked
sectored GEMM, ops/ladder.balanced_stacked_sectored_contract).  Without it
a SectoredVVVV `vvvv_op` runs the same ladder in single-operand mode, and
any other operand (a PackedVVVV) its own route through
ops/ladder.apply_vvvv_op on the dense operand, as in the JAX package.
"""

from __future__ import annotations

import torch

from ecw_cc_torch.ops import promote
from ecw_cc_torch.ops.ccsd import _eia
from ecw_cc_torch.ops.l1reg import subdiff
from ecw_cc_torch.ops.ladder import (SectoredVVVV, apply_vvvv_op,
                                     balanced_stacked_sectored_contract)
from ecw_cc_torch.ops.spinsect import (SpinBlocked, div_eijab, sector_einsum,
                                       wrap)

einsum = promote.lane_einsum
_S = sector_einsum


def wrap_eris(eris, info, sym=False):
    """SpinBlocked views of the ERI blocks (loop-invariant: build once per
    solve and pass as eris_sb)."""
    sb = {}
    for name in ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovvv", "ovoo",
                 "vovv"):
        sb[name] = wrap(getattr(eris, name), name, info, sym=sym)
    sb["oovo"] = wrap(-eris.ooov.permute(0, 1, 3, 2), "oovo", info, sym=sym)
    return sb


def _tau_b(t2b, t1b, fac=1.0):
    """Blocked make_tau (ops/ccsd.make_tau)."""
    t1t1 = _S("ia,jb->ijab", t1b.scale(fac * 0.5), t1b)
    t1t1 = t1t1 + t1t1.transpose(1, 0, 2, 3).scale(-1.0)
    return t2b + t1t1 + t1t1.transpose(0, 1, 3, 2).scale(-1.0)


def gamma_inter_sect(t1, t2, l1, l2, info, sym=False):
    """Sector-blocked rdm1 intermediates (twin of ops/ccsd.gamma_inter)."""
    t2b = wrap(t2, "oovv", info, sym=sym)
    l1b = wrap(l1, "ov", info, sym=sym)
    l2b = wrap(l2, "oovv", info, sym=sym)
    doo = (-einsum("ie,je->ij", l1, t1)
           - 0.5 * _S("imef,jmef->ij", l2b, t2b).dense())
    dvv = (einsum("ma,mb->ab", t1, l1)
           + 0.5 * _S("mnea,mneb->ab", t2b, l2b).dense())
    xt1 = 0.5 * _S("mnef,inef->mi", l2b, t2b).dense()
    xt2 = (0.5 * _S("mnfa,mnfe->ae", t2b, l2b).dense()
           + einsum("ma,me->ae", t1, l1))
    dvo = (_S("imae,me->ai", t2b, l1b).dense()
           - einsum("mi,ma->ai", xt1, t1)
           - einsum("ie,ae->ai", t1, xt2) + t1.T)
    return doo, l1, dvo, dvv


def tupdate_sect(eris, t1, t2, fsp, info, alpha=None, vvvv_op=None,
                 ladder_pre=None, eris_sb=None, sym=False, equation=False,
                 tau_pre=None):
    """Sector-blocked T1/T2 SCF update (twin of ops/ccsd.tupdate; JAX
    ccsd_sect.py:78-205).  equation=True returns the undivided residual
    with the Fock diagonal kept, the form the EOM sigma differentiates
    (ops/eom.py): then the ladder runs on all occupied row pairs
    (sectored_vvvv_contract through apply_vvvv_op, three launches for a
    SectoredVVVV), never the balanced-row blocked route.

    ladder_pre: the bare-vvvv ladder term, dense (o,o,v,v) or SpinBlocked;
    tau_pre: the blocked tau (_tau_b(t2b, t1b)) when the caller built it."""
    nocc, nvir = t1.shape
    fov = fsp[:nocc, nocc:]
    diag = torch.diagonal(eris.fock)
    diag_vv, diag_oo = diag[nocc:], diag[:nocc]
    sb = wrap_eris(eris, info, sym=sym) if eris_sb is None else eris_sb

    t1b = wrap(t1, "ov", info, sym=sym)
    t2b = wrap(t2, "oovv", info, sym=sym)
    tau = tau_pre if tau_pre is not None else _tau_b(t2b, t1b)
    tau_t = _tau_b(t2b, t1b, fac=0.5)

    # --- F intermediates (cc_Fvv / cc_Foo / cc_Fov) ---
    Fvv = (fsp[nocc:, nocc:]
           - 0.5 * einsum("me,ma->ae", fov, t1)
           + _S("mf,amef->ae", t1b, sb["vovv"]).dense()
           - 0.5 * _S("mnaf,mnef->ae", tau_t, sb["oovv"]).dense())
    Foo = (fsp[:nocc, :nocc]
           + 0.5 * einsum("me,ie->mi", fov, t1)
           + _S("ne,mnie->mi", t1b, sb["ooov"]).dense()
           + 0.5 * _S("inef,mnef->mi", tau_t, sb["oovv"]).dense())
    Fov = fov + _S("nf,mnef->me", t1b, sb["oovv"]).dense()

    # --- Wovvo (cc_Wovvo), kept blocked for its t2 consumer ---
    Wovvo = _S("jf,mbef->mbej", t1b, sb["ovvv"])
    Wovvo = Wovvo + _S("nb,mnej->mbej", t1b, sb["oovo"]).scale(-1.0)
    Wovvo = Wovvo + _S("jnfb,mnef->mbej", t2b, sb["oovv"]).scale(-0.5)
    Wovvo = Wovvo + _S("jf,nb,mnef->mbej", t1b, t1b, sb["oovv"]).scale(-1.0)
    Wovvo = Wovvo + wrap(-eris.ovov.permute(0, 1, 3, 2), "ovvo", info,
                         sym=sym)

    # --- quadratic X (applied once at 0.25) ---
    X = _S("ijef,mnef->ijmn", tau, sb["oovv"])
    tmp = _S("je,mnie->mnij", t1b, sb["ooov"])
    Woooo = (wrap(eris.oooo, "oooo", info, sym=sym) + tmp
             + tmp.transpose(0, 1, 3, 2).scale(-1.0))

    keep_diag = alpha is not None or equation
    Fvv_d = Fvv if keep_diag else Fvv - torch.diag(diag_vv)
    Foo_d = Foo if keep_diag else Foo - torch.diag(diag_oo)

    # --- T1 ---
    t1new = (promote.einsum("ie,ae->ia", t1, Fvv_d)
             - promote.einsum("ma,mi->ia", t1, Foo_d)
             + _S("imae,me->ia", t2b, wrap(Fov, "ov", info, sym=sym)).dense()
             - _S("nf,naif->ia", t1b, sb["ovov"]).dense()
             - 0.5 * _S("imef,maef->ia", t2b, sb["ovvv"]).dense()
             - 0.5 * _S("mnae,mnie->ia", t2b, sb["ooov"]).dense()
             + fov)

    # --- T2 ---
    Ftmp = Fvv_d - 0.5 * einsum("mb,me->be", t1, Fov)
    tmp = _S("ijae,be->ijab", t2b, wrap(Ftmp, "vv", info, sym=sym))
    t2new = tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    Ftmp = Foo_d + 0.5 * einsum("je,me->mj", t1, Fov)
    tmp = _S("imab,mj->ijab", t2b, wrap(Ftmp, "oo", info, sym=sym))
    t2new = t2new + (tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)).scale(-1.0)
    t2new = t2new + sb["oovv"]
    t2new = t2new + _S("mnab,mnij->ijab", tau, Woooo).scale(0.5)
    t2new = t2new + _S("ijmn,mnab->ijab", X, tau).scale(0.25)
    # ladder L2 (t1.ovvv correction), P(ab) folded into twin contractions
    Y = _S("ijef,mbef->ijmb", tau, sb["ovvv"])
    t2new = t2new + _S("ijmb,ma->ijab", Y, t1b.scale(-0.5))
    t2new = t2new + _S("ijma,mb->ijab", Y, t1b.scale(0.5))
    tmp = _S("imae,mbej->ijab", t2b, Wovvo)
    tmp = tmp + _S("ie,ma,mbje->ijab", t1b, t1b, sb["ovov"])
    tmp = tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    tmp = tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    t2new = t2new + tmp
    tmp = _S("ie,jeba->ijab", t1b, sb["ovvv"])
    t2new = t2new + tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    tmp = _S("ma,ijmb->ijab", t1b, sb["ooov"])
    t2new = t2new + (tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)).scale(-1.0)

    # bare-vvvv ladder L1
    if ladder_pre is None:
        if isinstance(vvvv_op, SectoredVVVV) and not equation:
            ladder_pre = balanced_stacked_sectored_contract(
                vvvv_op, tau, None, info.oa, sym=sym, blocked_info=info)
        else:
            ladder_pre = apply_vvvv_op(vvvv_op, tau.dense())
    eia, eijab = _eia(diag_oo, diag_vv)
    if hasattr(ladder_pre, "blocks"):
        t2new = t2new + ladder_pre
        if alpha is None and not equation:
            return t1new / eia, div_eijab(t2new, diag_oo, diag_vv).dense()
        t2new_d = t2new.dense()
    else:
        t2new_d = t2new.dense() + ladder_pre

    if alpha is not None:
        dW2 = subdiff(t2new_d, t2, alpha)
        if equation:
            return t1new, dW2
        return (t1new + t1 * eia) / eia, (dW2 + t2 * eijab) / eijab
    if equation:
        return t1new, t2new_d
    return t1new / eia, t2new_d / eijab


def lupdate_sect(eris, t1, t2, l1, l2, fsp, info, alpha=None,
                 energy_term="ref", vvvv_op=None, ladder_pre=None,
                 eris_sb=None, sym=False):
    """Sector-blocked Lambda1/Lambda2 SCF update (twin of ops/ccsd.lupdate
    with the Linter cheap=True intermediates inlined; energy_term='ref'
    keeps the reference's `l1new -= l1new*E` quirk, 'off' drops it)."""
    nocc, nvir = t1.shape
    fov = fsp[:nocc, nocc:]
    diag = torch.diagonal(eris.fock)
    diag_vv, diag_oo = diag[nocc:], diag[:nocc]
    sb = wrap_eris(eris, info, sym=sym) if eris_sb is None else eris_sb

    t1b = wrap(t1, "ov", info, sym=sym)
    t2b = wrap(t2, "oovv", info, sym=sym)
    l1b = wrap(l1, "ov", info, sym=sym)
    l2b = wrap(l2, "oovv", info, sym=sym)
    fovb = wrap(fov, "ov", info, sym=sym)

    # ---- Linter (cheap=True) ----
    tau = t2b + _S("ia,jb->ijab", t1b.scale(2.0), t1b)
    v1 = (fsp[nocc:, nocc:]
          - einsum("ja,jb->ba", fov, t1)
          - _S("jbac,jc->ba", sb["ovvv"], t1b).dense()
          + 0.5 * _S("jkca,jkbc->ba", sb["oovv"], tau).dense())
    v2 = (fsp[:nocc, :nocc]
          + einsum("ib,jb->ij", fov, t1)
          - _S("kijb,kb->ij", sb["ooov"], t1b).dense()
          + 0.5 * _S("ikbc,jkbc->ij", sb["oovv"], tau).dense())
    v3 = _S("ijcd,klcd->ijkl", sb["oovv"], tau)
    v4 = _S("ljdb,klcd->jcbk", sb["oovv"], t2b) + sb["ovvo"]
    v5 = fsp[nocc:, :nocc] + _S("kc,jkbc->bj", fovb, t2b).dense()
    tmpkc = fov - _S("kldc,ld->kc", sb["oovv"], t1b).dense()
    v5 = v5 + einsum("kc,kb,jc->bj", tmpkc, t1, t1)
    v5 = v5 - 0.5 * _S("kljc,klbc->bj", sb["ooov"], t2b).dense()
    v5 = v5 + 0.5 * _S("kbdc,jkcd->bj", sb["ovvv"], t2b).dense()

    w3 = (v5 + _S("jcbk,jb->ck", v4, t1b).dense()
          + einsum("cb,jb->cj", v1, t1)
          - einsum("jk,jb->bk", v2, t1))

    woooo = (wrap(eris.oooo, "oooo", info, sym=sym).scale(0.5)
             + v3.scale(0.25)
             + _S("jilc,kc->jilk", sb["ooov"], t1b))
    wovvo = (v4 + _S("ljdb,lc,kd->jcbk", sb["oovv"], t1b, t1b).scale(-1.0)
             + _S("ljkb,lc->jcbk", sb["ooov"], t1b).scale(-1.0)
             + _S("jcbd,kd->jcbk", sb["ovvv"], t1b))
    wovoo = (_S("icdb,jkdb->icjk", sb["ovvv"], tau).scale(0.25)
             + wrap(0.5 * eris.ooov.permute(2, 3, 0, 1), "ovoo", info,
                    sym=sym)
             + _S("icbk,jb->icjk", v4, t1b)
             + _S("lijb,klcb->icjk", sb["ooov"], t2b).scale(-1.0))

    if alpha is None:
        v1d = v1 - torch.diag(diag_vv)
        v2d = v2 - torch.diag(diag_oo)
        E = (einsum("ia,ia->", fov, t1)
             + 0.25 * _S("ijab,ijab->", t2b, sb["oovv"]).dense()
             + 0.5 * _S("ia,jb,ijab->", t1b, t1b, sb["oovv"]).dense())
    else:
        v1d, v2d = v1, v2
        E = 0.0
    if energy_term == "off":
        E = 0.0
    v1b = wrap(v1d, "vv", info, sym=sym)
    v2b = wrap(v2d, "oo", info, sym=sym)

    # ---- Lambda2 ----
    mba = _S("klca,klcb->ba", l2b, t2b).scale(0.5)
    mij = _S("kicd,kjcd->ij", l2b, t2b).scale(0.5)
    m3 = _S("klab,ijkl->ijab", l2b, woooo)
    ltau = _S("ijcd,klcd->ijkl", l2b, tau)
    m3 = m3 + _S("klab,ijkl->ijab", sb["oovv"], ltau).scale(0.25)
    lt1 = _S("ijcd,kd->ijck", l2b, t1b)
    m3 = m3 + _S("kcba,ijck->ijab", sb["ovvv"], lt1).scale(-1.0)
    if ladder_pre is None:
        if isinstance(vvvv_op, SectoredVVVV):
            ladder_pre = balanced_stacked_sectored_contract(
                vvvv_op, l2b, None, info.oa, sym=sym, blocked_info=info)
        else:
            ladder_pre = apply_vvvv_op(vvvv_op, l2)
    blocked_pre = hasattr(ladder_pre, "blocks")
    if blocked_pre:
        m3b = m3 + ladder_pre        # stays blocked: no dense round trip
    else:
        m3b = wrap(m3.dense() + ladder_pre, "oovv", info, sym=sym)

    l2new = sb["oovv"] + m3b
    fov1 = fovb + _S("kjcb,kc->jb", sb["oovv"], t1b)
    tmp = _S("ia,jb->ijab", l1b, fov1)
    tmp = tmp + _S("kica,jcbk->ijab", l2b, wovvo)
    tmp = tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    l2new = l2new + tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    tmp = _S("ka,ijkb->ijab", l1b, sb["ooov"])
    tmp = tmp + _S("ijca,cb->ijab", l2b, v1b)
    tmp1vv = mba + _S("ka,kb->ba", l1b, t1b)
    tmp = tmp + _S("ca,ijcb->ijab", tmp1vv, sb["oovv"])
    l2new = l2new + (tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)).scale(-1.0)
    tmp = _S("ic,jcba->jiba", l1b, sb["ovvv"])
    tmp = tmp + _S("kiab,jk->ijab", l2b, v2b)
    tmp1oo = mij + _S("ic,kc->ik", l1b, t1b)
    tmp = tmp + _S("ik,kjab->ijab", tmp1oo, sb["oovv"]).scale(-1.0)
    l2new = l2new + tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)

    # ---- Lambda1 (wvvvo folded in) ----
    l1new = (fov
             + _S("jb,ibaj->ia", l1b, sb["ovvo"]).dense()
             + promote.einsum("ib,ba->ia", l1, v1d)
             - promote.einsum("ja,ij->ia", l1, v2d)
             - _S("kjca,icjk->ia", l2b, wovoo).dense()
             + _S("ijab,jb->ia", m3b, t1b).dense()
             + _S("jiba,bj->ia", l2b, wrap(w3, "vo", info, sym=sym)).dense())
    tmp = _S("ikbc,jb->ikcj", l2b, t1b)
    l1new = l1new - _S("ikcj,jcak->ia", tmp, v4).dense()
    tmp = _S("ikbc,jlbc->ikjl", l2b, tau)
    l1new = l1new - 0.25 * _S("ikjl,jlka->ia", tmp, sb["ooov"]).dense()
    l1new = l1new + 0.5 * _S("ikbc,kacb->ia", l2b, sb["ovvv"]).dense()
    Zl = _S("ikbc,kmcd->ibmd", l2b, t2b)
    l1new = l1new - _S("ibmd,mbad->ia", Zl, sb["ovvv"]).dense()
    tmp = (t1 + _S("kc,kjcb->jb", l1b, t2b).dense()
           - _S("bd,jd->jb", tmp1vv, t1b).dense()
           - _S("lj,lb->jb", mij, t1b).dense())
    l1new = l1new + _S("jiba,jb->ia", sb["oovv"],
                       wrap(tmp, "ov", info, sym=sym)).dense()
    l1new = l1new + _S("icab,bc->ia", sb["ovvv"], tmp1vv).dense()
    l1new = l1new - _S("jika,kj->ia", sb["ooov"], tmp1oo).dense()
    tmpka = wrap(fov - _S("kjba,jb->ka", sb["oovv"], t1b).dense(), "ov",
                 info, sym=sym)
    l1new = l1new - _S("ik,ka->ia", mij, tmpka).dense()
    l1new = l1new - _S("ca,ic->ia", mba, tmpka).dense()

    l1new = l1new - l1new * E
    eia, eijab = _eia(diag_oo, diag_vv)
    if blocked_pre and alpha is None:
        l2new = SpinBlocked(l2new.kinds,
                            {k: v - v * E for k, v in l2new.blocks.items()},
                            info, sym=l2new.sym)
        return l1new / eia, div_eijab(l2new, diag_oo, diag_vv).dense()
    l2new_d = l2new.dense()
    l2new_d = l2new_d - l2new_d * E

    if alpha is not None:
        dW2 = subdiff(l2new_d, l2, alpha)
        return (l1new + l1 * eia) / eia, (dW2 + l2 * eijab) / eijab
    return l1new / eia, l2new_d / eijab
