"""Spin-sector-blocked ECW-CCSD t/lambda updates (SORTED layout).

Port of ecw_cc_tpu/ops/ccsd_sect.py: every contraction runs through
ops/spinsect.sector_einsum, so the structurally-zero spin blocks (10 of 16
of every 4-index tensor) are neither read nor multiplied.  The math is
term for term the factorized Stanton scheme of the reference (CCSD.py:
248-338 t side, 419-623 lambda side).

Handed a SoupPlan (`plan=`, which Solver_CCSD builds once per solve), the
updates run their contractions through it instead: each with an ERI
operand is one GEMM per output block against that ERI laid out once, the
rest sector_einsum as before.  Every other caller passes none.

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

import functools
import math
import types

import torch
from torch._C import _functorch

from ecw_cc_torch.ops import promote
from ecw_cc_torch.ops.ccsd import _eia
from ecw_cc_torch.ops.l1reg import subdiff
from ecw_cc_torch.ops.ladder import (SectoredVVVV, apply_vvvv_op,
                                     balanced_stacked_sectored_contract)
from ecw_cc_torch.ops.spinsect import (FixedLayouts, SectorGemm, SectorInfo,
                                       SpinBlocked, div_eijab, gemm_letters,
                                       sector_einsum, wrap)

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


def _invariant(name, eris, info, sym):
    """An ERI term the updates add as it is: Wovvo's -ovov, the lambda
    side's 0.5 ooov (wovoo) and 0.5 oooo (woooo)."""
    if name == "ovvo":
        return wrap(-eris.ovov.permute(0, 1, 3, 2), "ovvo", info, sym=sym)
    if name == "ovoo":
        return wrap(0.5 * eris.ooov.permute(2, 3, 0, 1), "ovoo", info,
                    sym=sym)
    return wrap(eris.oooo, "oooo", info, sym=sym).scale(0.5)


def _eri_of(names, operands):
    """(name, position) of the one operand that is an ERI block of
    `names` ({id: name}), or (None, None)."""
    for pos, op in enumerate(operands):
        name = names.get(id(op))
        if name is not None:
            return name, pos
    return None, None


class _Recorder:
    """The plan's stand-in on the probe step (_record_step): runs every
    contraction with sector_einsum and notes, for each that has an ERI
    operand, how its other operands are stored."""

    def __init__(self, eris, eris_sb, info, sym):
        self._names = {id(v): k for k, v in eris_sb.items()}
        self._inv = {n: _invariant(n, eris, info, sym)
                     for n in ("ovvo", "ovoo", "oooo")}
        self.entries, self.fallback = {}, 0

    def invariant(self, name):
        return self._inv[name]

    def __call__(self, spec, *operands):
        name, pos = _eri_of(self._names, operands)
        if name is None or len(operands) > 3:
            self.fallback += 1
        else:
            others = tuple((op.kinds, frozenset(op.blocks), op.sym)
                           for i, op in enumerate(operands) if i != pos)
            seen = self.entries.setdefault((spec, name, pos), [others, 0])
            if seen[0] == others:
                seen[1] += 1
            else:
                self.fallback += 1   # the plan, built for the first, declines
        return _S(spec, *operands)


@functools.lru_cache(maxsize=None)
def _record_step(sym, energy):
    """Every sector contraction of one sectored step (gamma_inter_sect,
    tupdate_sect, lupdate_sect as Solver_CCSD runs them), from a run on
    CPU tensors of one orbital per spin sector: which blocks a contraction
    reads depends on the spin structure, not on the sizes.  Returns
    ({(spec, ERI name, ERI position): ((kinds, keys, sym) of each other
    operand, calls)}, the number of contractions with no ERI operand).
    energy: the lambda update computes its energy term (alpha is None)."""
    info = SectorInfo(1, 1, 1, 1)
    gen = torch.Generator().manual_seed(0)
    dim = {"o": 2, "v": 2}

    def rand(kinds):
        return torch.rand(tuple(dim[k] for k in kinds), generator=gen,
                          dtype=torch.float64)

    eris = types.SimpleNamespace(
        fock=torch.diag(torch.tensor([-1.0, -1.0, 1.0, 1.0],
                                     dtype=torch.float64)),
        **{n: rand(n) for n in ("oooo", "ooov", "oovv", "ovov", "ovvo",
                                "ovvv", "ovoo", "vovv")})
    t1, l1, t2, l2 = rand("ov"), rand("ov"), rand("oovv"), rand("oovv")
    sb = wrap_eris(eris, info, sym=sym)
    rec = _Recorder(eris, sb, info, sym)
    alpha = None if energy else 1e-3
    ladder = wrap(torch.zeros_like(t2), "oovv", info, sym=sym)
    tau = _tau_b(wrap(t2, "oovv", info, sym=sym), wrap(t1, "ov", info,
                                                      sym=sym))
    with torch.no_grad():
        gamma_inter_sect(t1, t2, l1, l2, info, sym=sym, plan=rec)
        t1n, t2n = tupdate_sect(eris, t1, t2, eris.fock, info, alpha=alpha,
                                ladder_pre=ladder, eris_sb=sb, sym=sym,
                                tau_pre=tau, plan=rec)
        lupdate_sect(eris, t1n, t2n, l1, l2, eris.fock, info, alpha=alpha,
                     ladder_pre=ladder, eris_sb=sb, sym=sym, plan=rec)
    return ({k: tuple(v) for k, v in rec.entries.items()}, rec.fallback)


class _Planned:
    """A planned contraction: the ERI block's product with operand `first`
    (a SectorGemm); for a three-operand spec, then sector_einsum of that
    with operand `second` by spec2."""

    def __init__(self, gemm, first, second=None, spec2=None):
        self.gemm, self.first, self.second, self.spec2 = (gemm, first,
                                                          second, spec2)

    def __call__(self, operands):
        out = self.gemm(operands[self.first])
        if out is None or self.second is None:
            return out
        return _S(self.spec2, operands[self.second], out)


def _split3(spec, pos, kinds, info):
    """The cheaper way to take a three-operand spec with an ERI at `pos` as
    two products, the ERI's first: (index of its partner, index of the
    third operand, spec of the first product, spec of the second).  kinds:
    each operand's, in order."""
    ins, out = spec.split("->")
    subs = ins.split(",")
    dim = {c: info.nocc if k == "o" else info.nvir
           for sub, ks in zip(subs, kinds) for c, k in zip(sub, ks)}
    best = None
    for first in (i for i in range(3) if i != pos):
        second = 3 - pos - first
        mid = "".join(dict.fromkeys(
            c for c in subs[pos] + subs[first]
            if c in subs[second] or c in out))
        cost = (math.prod(dim[c] for c in set(subs[pos] + subs[first]))
                + math.prod(dim[c] for c in set(subs[second] + mid)))
        if best is None or cost < best[0]:
            best = (cost, first, second, f"{subs[first]},{subs[pos]}->{mid}",
                    f"{subs[second]},{mid}->{out}")
    return best[1:]


class SoupPlan:
    """The sectored step's loop-invariant ERI operands, laid out once per
    solve (the torch counterpart of the JAX package's SoupViews and
    soup_gemm='kconcat'): every contraction of one ERI block with one other
    operand runs as one matrix product per output block against an operand
    built here (spinsect.SectorGemm), where sector_einsum's einsum per spin
    assignment copies the ERI block into a GEMM operand every iteration.
    A three-operand contraction with an ERI takes the ERI's product with one
    operand here, then sector_einsum with the third (_split3).  The ERI
    terms the updates add as they are (_invariant) are built here too.

    Called as sector_einsum (plan(spec, *operands)); what it has not planned
    runs there, as does everything under a torch.func transform (the
    batched sweep's vmap).  Built by Solver_CCSD._setup from the eris_sb it
    hands the updates, whose blocks it recognises by identity.

    counts: per step, 'planned' (output-block products), 'fallback' (sector
    contractions left on sector_einsum) and 'prelaid_mb' (10^6 bytes held
    by the laid-out operands), counted when the plan is built."""

    def __init__(self, eris, eris_sb, info, sym, alpha=None):
        entries, fallback = _record_step(sym, alpha is None)
        self._names = {id(v): k for k, v in eris_sb.items()}
        self._inv = {n: SpinBlocked(
            sb.kinds, {k: v.contiguous() for k, v in sb.blocks.items()},
            info, sym=sym)
            for n in ("ovvo", "ovoo", "oooo")
            for sb in (_invariant(n, eris, info, sym),)}
        layouts, self._plans, planned = FixedLayouts(), {}, 0
        for (spec, name, pos), (others, calls) in entries.items():
            fixed = eris_sb[name]
            if len(others) == 1:
                if gemm_letters(spec, pos) is None:
                    fallback += calls
                    continue
                plan = _Planned(SectorGemm(spec, fixed, pos, others[0],
                                           layouts), 1 - pos)
            else:
                kinds = [o[0] for o in others]
                kinds.insert(pos, fixed.kinds)
                first, second, spec1, spec2 = _split3(spec, pos, kinds, info)
                if gemm_letters(spec1, 1) is None:
                    fallback += calls
                    continue
                plan = _Planned(SectorGemm(spec1, fixed, 1,
                                           others[first - (first > pos)],
                                           layouts), first, second, spec2)
                fallback += calls   # the product with the third operand
            self._plans[(spec, name, pos)] = plan
            planned += calls * len(plan.gemm.blocks)
        layouts.build()
        held = layouts.nbytes + sum(v.numel() * v.element_size()
                                    for sb in self._inv.values()
                                    for v in sb.blocks.values())
        self.counts = {"planned": planned, "fallback": fallback,
                       "prelaid_mb": held / 1e6}

    def invariant(self, name):
        """The ERI term `name` of _invariant, built once."""
        return self._inv[name]

    def __call__(self, spec, *operands):
        if _functorch.peek_interpreter_stack() is None:
            name, pos = _eri_of(self._names, operands)
            plan = self._plans.get((spec, name, pos))
            if plan is not None:
                out = plan(operands)
                if out is not None:
                    return out
        return _S(spec, *operands)


def _soup(plan, eris, info, sym):
    """The updates' contraction and loop-invariant ERI terms: the plan's,
    or sector_einsum and the terms built on the spot."""
    if plan is not None:
        return plan, plan.invariant
    return _S, functools.partial(_invariant, eris=eris, info=info, sym=sym)


def _tau_b(t2b, t1b, fac=1.0, S=_S):
    """Blocked make_tau (ops/ccsd.make_tau)."""
    t1t1 = S("ia,jb->ijab", t1b.scale(fac * 0.5), t1b)
    t1t1 = t1t1 + t1t1.transpose(1, 0, 2, 3).scale(-1.0)
    return t2b + t1t1 + t1t1.transpose(0, 1, 3, 2).scale(-1.0)


def gamma_inter_sect(t1, t2, l1, l2, info, sym=False, plan=None):
    """Sector-blocked rdm1 intermediates (twin of ops/ccsd.gamma_inter).
    plan: a SoupPlan, through which its contractions run."""
    S = _S if plan is None else plan
    t2b = wrap(t2, "oovv", info, sym=sym)
    l1b = wrap(l1, "ov", info, sym=sym)
    l2b = wrap(l2, "oovv", info, sym=sym)
    doo = (-einsum("ie,je->ij", l1, t1)
           - 0.5 * S("imef,jmef->ij", l2b, t2b).dense())
    dvv = (einsum("ma,mb->ab", t1, l1)
           + 0.5 * S("mnea,mneb->ab", t2b, l2b).dense())
    xt1 = 0.5 * S("mnef,inef->mi", l2b, t2b).dense()
    xt2 = (0.5 * S("mnfa,mnfe->ae", t2b, l2b).dense()
           + einsum("ma,me->ae", t1, l1))
    dvo = (S("imae,me->ai", t2b, l1b).dense()
           - einsum("mi,ma->ai", xt1, t1)
           - einsum("ie,ae->ai", t1, xt2) + t1.T)
    return doo, l1, dvo, dvv


def tupdate_sect(eris, t1, t2, fsp, info, alpha=None, vvvv_op=None,
                 ladder_pre=None, eris_sb=None, sym=False, equation=False,
                 tau_pre=None, plan=None):
    """Sector-blocked T1/T2 SCF update (twin of ops/ccsd.tupdate; JAX
    ccsd_sect.py:78-205).  equation=True returns the undivided residual
    with the Fock diagonal kept, the form the EOM sigma differentiates
    (ops/eom.py): then the ladder runs on all occupied row pairs
    (sectored_vvvv_contract through apply_vvvv_op, three launches for a
    SectoredVVVV), never the balanced-row blocked route.

    ladder_pre: the bare-vvvv ladder term, dense (o,o,v,v) or SpinBlocked;
    tau_pre: the blocked tau (_tau_b(t2b, t1b)) when the caller built it;
    plan: the SoupPlan built on eris_sb, through which every contraction
    runs."""
    nocc, nvir = t1.shape
    fov = fsp[:nocc, nocc:]
    diag = torch.diagonal(eris.fock)
    diag_vv, diag_oo = diag[nocc:], diag[:nocc]
    sb = wrap_eris(eris, info, sym=sym) if eris_sb is None else eris_sb
    S, inv = _soup(plan, eris, info, sym)

    t1b = wrap(t1, "ov", info, sym=sym)
    t2b = wrap(t2, "oovv", info, sym=sym)
    tau = tau_pre if tau_pre is not None else _tau_b(t2b, t1b, S=S)
    tau_t = _tau_b(t2b, t1b, fac=0.5, S=S)

    # --- F intermediates (cc_Fvv / cc_Foo / cc_Fov) ---
    Fvv = (fsp[nocc:, nocc:]
           - 0.5 * einsum("me,ma->ae", fov, t1)
           + S("mf,amef->ae", t1b, sb["vovv"]).dense()
           - 0.5 * S("mnaf,mnef->ae", tau_t, sb["oovv"]).dense())
    Foo = (fsp[:nocc, :nocc]
           + 0.5 * einsum("me,ie->mi", fov, t1)
           + S("ne,mnie->mi", t1b, sb["ooov"]).dense()
           + 0.5 * S("inef,mnef->mi", tau_t, sb["oovv"]).dense())
    Fov = fov + S("nf,mnef->me", t1b, sb["oovv"]).dense()

    # --- Wovvo (cc_Wovvo), kept blocked for its t2 consumer ---
    Wovvo = S("jf,mbef->mbej", t1b, sb["ovvv"])
    Wovvo = Wovvo + S("nb,mnej->mbej", t1b, sb["oovo"]).scale(-1.0)
    Wovvo = Wovvo + S("jnfb,mnef->mbej", t2b, sb["oovv"]).scale(-0.5)
    Wovvo = Wovvo + S("jf,nb,mnef->mbej", t1b, t1b, sb["oovv"]).scale(-1.0)
    Wovvo = Wovvo + inv("ovvo")

    # --- quadratic X (applied once at 0.25) ---
    X = S("ijef,mnef->ijmn", tau, sb["oovv"])
    tmp = S("je,mnie->mnij", t1b, sb["ooov"])
    Woooo = (wrap(eris.oooo, "oooo", info, sym=sym) + tmp
             + tmp.transpose(0, 1, 3, 2).scale(-1.0))

    keep_diag = alpha is not None or equation
    Fvv_d = Fvv if keep_diag else Fvv - torch.diag(diag_vv)
    Foo_d = Foo if keep_diag else Foo - torch.diag(diag_oo)

    # --- T1 ---
    t1new = (promote.einsum("ie,ae->ia", t1, Fvv_d)
             - promote.einsum("ma,mi->ia", t1, Foo_d)
             + S("imae,me->ia", t2b, wrap(Fov, "ov", info, sym=sym)).dense()
             - S("nf,naif->ia", t1b, sb["ovov"]).dense()
             - 0.5 * S("imef,maef->ia", t2b, sb["ovvv"]).dense()
             - 0.5 * S("mnae,mnie->ia", t2b, sb["ooov"]).dense()
             + fov)

    # --- T2 ---
    Ftmp = Fvv_d - 0.5 * einsum("mb,me->be", t1, Fov)
    tmp = S("ijae,be->ijab", t2b, wrap(Ftmp, "vv", info, sym=sym))
    t2new = tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    Ftmp = Foo_d + 0.5 * einsum("je,me->mj", t1, Fov)
    tmp = S("imab,mj->ijab", t2b, wrap(Ftmp, "oo", info, sym=sym))
    t2new = t2new + (tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)).scale(-1.0)
    t2new = t2new + sb["oovv"]
    t2new = t2new + S("mnab,mnij->ijab", tau, Woooo).scale(0.5)
    t2new = t2new + S("ijmn,mnab->ijab", X, tau).scale(0.25)
    # ladder L2 (t1.ovvv correction), P(ab) folded into twin contractions
    Y = S("ijef,mbef->ijmb", tau, sb["ovvv"])
    t2new = t2new + S("ijmb,ma->ijab", Y, t1b.scale(-0.5))
    t2new = t2new + S("ijma,mb->ijab", Y, t1b.scale(0.5))
    tmp = S("imae,mbej->ijab", t2b, Wovvo)
    tmp = tmp + S("ie,ma,mbje->ijab", t1b, t1b, sb["ovov"])
    tmp = tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    tmp = tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    t2new = t2new + tmp
    tmp = S("ie,jeba->ijab", t1b, sb["ovvv"])
    t2new = t2new + tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    tmp = S("ma,ijmb->ijab", t1b, sb["ooov"])
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
                 eris_sb=None, sym=False, plan=None):
    """Sector-blocked Lambda1/Lambda2 SCF update (twin of ops/ccsd.lupdate
    with the Linter cheap=True intermediates inlined; energy_term='ref'
    keeps the reference's `l1new -= l1new*E` quirk, 'off' drops it).
    plan: as tupdate_sect's."""
    nocc, nvir = t1.shape
    fov = fsp[:nocc, nocc:]
    diag = torch.diagonal(eris.fock)
    diag_vv, diag_oo = diag[nocc:], diag[:nocc]
    sb = wrap_eris(eris, info, sym=sym) if eris_sb is None else eris_sb
    S, inv = _soup(plan, eris, info, sym)

    t1b = wrap(t1, "ov", info, sym=sym)
    t2b = wrap(t2, "oovv", info, sym=sym)
    l1b = wrap(l1, "ov", info, sym=sym)
    l2b = wrap(l2, "oovv", info, sym=sym)
    fovb = wrap(fov, "ov", info, sym=sym)

    # ---- Linter (cheap=True) ----
    tau = t2b + S("ia,jb->ijab", t1b.scale(2.0), t1b)
    v1 = (fsp[nocc:, nocc:]
          - einsum("ja,jb->ba", fov, t1)
          - S("jbac,jc->ba", sb["ovvv"], t1b).dense()
          + 0.5 * S("jkca,jkbc->ba", sb["oovv"], tau).dense())
    v2 = (fsp[:nocc, :nocc]
          + einsum("ib,jb->ij", fov, t1)
          - S("kijb,kb->ij", sb["ooov"], t1b).dense()
          + 0.5 * S("ikbc,jkbc->ij", sb["oovv"], tau).dense())
    v3 = S("ijcd,klcd->ijkl", sb["oovv"], tau)
    v4 = S("ljdb,klcd->jcbk", sb["oovv"], t2b) + sb["ovvo"]
    v5 = fsp[nocc:, :nocc] + S("kc,jkbc->bj", fovb, t2b).dense()
    tmpkc = fov - S("kldc,ld->kc", sb["oovv"], t1b).dense()
    v5 = v5 + einsum("kc,kb,jc->bj", tmpkc, t1, t1)
    v5 = v5 - 0.5 * S("kljc,klbc->bj", sb["ooov"], t2b).dense()
    v5 = v5 + 0.5 * S("kbdc,jkcd->bj", sb["ovvv"], t2b).dense()

    w3 = (v5 + S("jcbk,jb->ck", v4, t1b).dense()
          + einsum("cb,jb->cj", v1, t1)
          - einsum("jk,jb->bk", v2, t1))

    woooo = (inv("oooo")
             + v3.scale(0.25)
             + S("jilc,kc->jilk", sb["ooov"], t1b))
    wovvo = (v4 + S("ljdb,lc,kd->jcbk", sb["oovv"], t1b, t1b).scale(-1.0)
             + S("ljkb,lc->jcbk", sb["ooov"], t1b).scale(-1.0)
             + S("jcbd,kd->jcbk", sb["ovvv"], t1b))
    wovoo = (S("icdb,jkdb->icjk", sb["ovvv"], tau).scale(0.25)
             + inv("ovoo")
             + S("icbk,jb->icjk", v4, t1b)
             + S("lijb,klcb->icjk", sb["ooov"], t2b).scale(-1.0))

    if alpha is None:
        v1d = v1 - torch.diag(diag_vv)
        v2d = v2 - torch.diag(diag_oo)
        E = (einsum("ia,ia->", fov, t1)
             + 0.25 * S("ijab,ijab->", t2b, sb["oovv"]).dense()
             + 0.5 * S("ia,jb,ijab->", t1b, t1b, sb["oovv"]).dense())
    else:
        v1d, v2d = v1, v2
        E = 0.0
    if energy_term == "off":
        E = 0.0
    v1b = wrap(v1d, "vv", info, sym=sym)
    v2b = wrap(v2d, "oo", info, sym=sym)

    # ---- Lambda2 ----
    mba = S("klca,klcb->ba", l2b, t2b).scale(0.5)
    mij = S("kicd,kjcd->ij", l2b, t2b).scale(0.5)
    m3 = S("klab,ijkl->ijab", l2b, woooo)
    ltau = S("ijcd,klcd->ijkl", l2b, tau)
    m3 = m3 + S("klab,ijkl->ijab", sb["oovv"], ltau).scale(0.25)
    lt1 = S("ijcd,kd->ijck", l2b, t1b)
    m3 = m3 + S("kcba,ijck->ijab", sb["ovvv"], lt1).scale(-1.0)
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
    fov1 = fovb + S("kjcb,kc->jb", sb["oovv"], t1b)
    tmp = S("ia,jb->ijab", l1b, fov1)
    tmp = tmp + S("kica,jcbk->ijab", l2b, wovvo)
    tmp = tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)
    l2new = l2new + tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)
    tmp = S("ka,ijkb->ijab", l1b, sb["ooov"])
    tmp = tmp + S("ijca,cb->ijab", l2b, v1b)
    tmp1vv = mba + S("ka,kb->ba", l1b, t1b)
    tmp = tmp + S("ca,ijcb->ijab", tmp1vv, sb["oovv"])
    l2new = l2new + (tmp + tmp.transpose(0, 1, 3, 2).scale(-1.0)).scale(-1.0)
    tmp = S("ic,jcba->jiba", l1b, sb["ovvv"])
    tmp = tmp + S("kiab,jk->ijab", l2b, v2b)
    tmp1oo = mij + S("ic,kc->ik", l1b, t1b)
    tmp = tmp + S("ik,kjab->ijab", tmp1oo, sb["oovv"]).scale(-1.0)
    l2new = l2new + tmp + tmp.transpose(1, 0, 2, 3).scale(-1.0)

    # ---- Lambda1 (wvvvo folded in) ----
    l1new = (fov
             + S("jb,ibaj->ia", l1b, sb["ovvo"]).dense()
             + promote.einsum("ib,ba->ia", l1, v1d)
             - promote.einsum("ja,ij->ia", l1, v2d)
             - S("kjca,icjk->ia", l2b, wovoo).dense()
             + S("ijab,jb->ia", m3b, t1b).dense()
             + S("jiba,bj->ia", l2b, wrap(w3, "vo", info, sym=sym)).dense())
    tmp = S("ikbc,jb->ikcj", l2b, t1b)
    l1new = l1new - S("ikcj,jcak->ia", tmp, v4).dense()
    tmp = S("ikbc,jlbc->ikjl", l2b, tau)
    l1new = l1new - 0.25 * S("ikjl,jlka->ia", tmp, sb["ooov"]).dense()
    l1new = l1new + 0.5 * S("ikbc,kacb->ia", l2b, sb["ovvv"]).dense()
    Zl = S("ikbc,kmcd->ibmd", l2b, t2b)
    l1new = l1new - S("ibmd,mbad->ia", Zl, sb["ovvv"]).dense()
    tmp = (t1 + S("kc,kjcb->jb", l1b, t2b).dense()
           - S("bd,jd->jb", tmp1vv, t1b).dense()
           - S("lj,lb->jb", mij, t1b).dense())
    l1new = l1new + S("jiba,jb->ia", sb["oovv"],
                       wrap(tmp, "ov", info, sym=sym)).dense()
    l1new = l1new + S("icab,bc->ia", sb["ovvv"], tmp1vv).dense()
    l1new = l1new - S("jika,kj->ia", sb["ooov"], tmp1oo).dense()
    tmpka = wrap(fov - S("kjba,jb->ka", sb["oovv"], t1b).dense(), "ov",
                 info, sym=sym)
    l1new = l1new - S("ik,ka->ia", mij, tmpka).dense()
    l1new = l1new - S("ca,ic->ia", mba, tmpka).dense()

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
