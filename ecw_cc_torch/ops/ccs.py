"""ECW-CCS equations (port of ecw_cc_tpu/ops/ccs.py; reference CCS.py),
pure functions of tensors:

  - the rdm1s: gamma_unsym_CCS / gamma_es_CCS / gamma_tr_CCS / gamma_CCS
    (CCS.py:23-190)
  - T1 intermediates + SCF update with ES-coupling Vexp terms (CCS.py:288-488)
  - Lambda1 intermediates + update (CCS.py:511-768)
  - ES R1/R0/L1/L0 intermediates + updates, energy extraction
    (CCS.py:774-1518)
  - L1-regularized updates via the vectorized subgradient (CCS.py:353-384,
    585-617)
  - `Gccs`, the class wrapper of the reference API, and `ccs_gradient`, the
    Jacobian / Newton / steepest-descent machinery (CCS.py:1524-2160).

Conventions (as the reference): amplitudes (nocc, nvir); the fock diagonal
in the update denominators; Vexp enters as v = -Vexp[n, m] blocks.  The
contractions are o*v-sized torch.einsum calls (XLA einsums in the JAX
package, outside any kernel); ES updates divide by (Em + f_ii - f_aa).

The excited-state functions take one state, as their JAX twins do, or a
stack of states: every per-state argument (fsp, vm, rs, ls, r0, l0, Em, the
intermediates) may carry leading state axes, which the einsums pass
through ("..."), where the JAX solver wraps the one-state function in
jax.vmap.  What depends only on ts and the ERIs (the W tensors, the ts
contractions of the ERI blocks) is then computed once for all states.
"""

from __future__ import annotations

import numpy as np
import torch

from ecw_cc_torch.ops.l1reg import subdiff

einsum = torch.einsum


def _hf_diag(nocc, nvir, like):
    return torch.diag(torch.cat([like.new_ones(nocc), like.new_zeros(nvir)]))


# ---------------------------------------------------------------------------
# rdm1 (reference CCS.py:23-190)
# ---------------------------------------------------------------------------

def gamma_unsym_CCS(ts, ls):
    """Unsymmetrized CCS one-particle rdm1 (GS). Reference CCS.py:23-48."""
    nocc, nvir = ts.shape
    doo = -einsum("ie,je->ij", ts, ls)
    dvv = einsum("ib,ia->ab", ts, ls)
    dvo = ls.T
    dov = -einsum("ja,ib,jb->ia", ts, ts, ls) + ts
    dm1 = torch.cat([torch.cat([doo, dov], dim=1),
                     torch.cat([dvo, dvv], dim=1)], dim=0)
    return dm1 + _hf_diag(nocc, nvir, dm1)


def gamma_CCS(ts, ls):
    """Symmetrized GS rdm1 (PySCF convention, t2=l2=0). Reference CCS.py:157-190."""
    nocc, nvir = ts.shape
    doo = -einsum("ja,ia->ij", ts, ls)
    dvv = einsum("ia,ib->ab", ts, ls)
    xtv = einsum("ie,me->im", ts, ls)
    dvo = ts.T - einsum("im,ma->ai", xtv, ts)
    dov = ls
    top = torch.cat([doo + doo.T, dov + dvo.T], dim=1)
    bot = torch.cat([(dov + dvo.T).T, dvv + dvv.T], dim=1)
    dm1 = 0.5 * torch.cat([top, bot], dim=0)
    return dm1 + _hf_diag(nocc, nvir, dm1)


# ---------------------------------------------------------------------------
# Energy (reference CCS.py:226-249)
# ---------------------------------------------------------------------------

def energy_ccs(eris, ts, fsp, rsn=None, r0n=None, vn=None):
    """E'_0; optional ES contributions from stacked rsn (n,?,?), r0n (n,), vn (n,dim,dim)."""
    nocc, nvir = ts.shape
    fsp = eris.fock if fsp is None else fsp
    e = einsum("ia,ia->", fsp[:nocc, nocc:], ts)
    e = e + 0.5 * einsum("ia,jb,ijab->", ts, ts, eris.oovv)
    if rsn is not None:
        v_ov = -vn[:, :nocc, nocc:]
        v_oo = -vn[:, :nocc, :nocc]
        e = e + einsum("nia,nia->", v_ov, rsn)
        e = e + einsum("n,nia,ia->", r0n, v_ov, ts)
        e = e + einsum("n,njj->", r0n, v_oo)
    return e


# ---------------------------------------------------------------------------
# T1 intermediates and updates (reference CCS.py:271-488)
# ---------------------------------------------------------------------------

def T1inter(eris, ts, fsp):
    """'Stasis' T1 intermediates. Reference CCS.py:406-440."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov = f[:nocc, :nocc], f[:nocc, nocc:]
    fvo, fvv = f[nocc:, :nocc], f[nocc:, nocc:]

    Fai = fvo + einsum("jb,jabi->ai", ts, eris.ovvo)
    Fab = fvv - einsum("jb,ja->ab", fov, ts) + einsum("jc,jacb->ab", ts, eris.ovvv)
    tmp = einsum("kc,jkcb->jb", ts, eris.oovv)
    Fji = (foo + einsum("kb,kjbi->ji", ts, eris.oovo)
           - einsum("ib,jb->ji", ts, tmp))
    return Fab, Fji, Fai


def T1inter_Stanton(eris, ts, fsp):
    """Stanton-paper T1 intermediates. Reference CCS.py:442-488."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov = f[:nocc, :nocc], f[:nocc, nocc:]
    fvo, fvv = f[nocc:, :nocc], f[nocc:, nocc:]

    tsts = einsum("ia,jb->ijab", 0.125 * ts, ts)
    tsts = tsts - tsts.permute(1, 0, 2, 3)
    tau = tsts - tsts.permute(0, 1, 3, 2)

    Fae = (fvv - 0.5 * einsum("me,ma->ae", fov, ts)
           + einsum("mf,amef->ae", ts, eris.vovv)
           - 0.5 * einsum("mnaf,mnef->ae", 2.0 * tau, eris.oovv))
    Fmi = (foo + 0.5 * einsum("ie,me->mi", ts, fov)
           + einsum("ne,mnie->mi", ts, eris.ooov)
           + 0.5 * einsum("inef,mnef->mi", 2.0 * tau, eris.oovv))
    Fai = fvo + einsum("me,amie->ai", ts, eris.voov)
    return Fae, Fmi, Fai


def T1eq(eris, ts, fsp):
    """T1 equation value (residual form). Reference CCS.py:271-286."""
    Fab, Fji, Fai = T1inter(eris, ts, fsp)
    return Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)


def _remove_diag(F, diag):
    return F - torch.diag(diag)


def tsupdate(eris, ts, T1i, rsn=None, r0n=None, vn=None):
    """SCF update of t1 with optional ES-coupling Vexp terms. Reference CCS.py:288-351.

    rsn: (n_es, nocc, nvir); r0n: (n_es,); vn: (n_es, dim, dim) with zeros for
    absent potentials (equivalent to the reference's skip-if-None)."""
    Fab, Fji, Fai = T1i
    nocc, nvir = ts.shape
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    Fab = _remove_diag(Fab, diag_vv)
    Fji = _remove_diag(Fji, diag_oo)

    tsnew = Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)

    if rsn is not None:
        v_oo = -vn[:, :nocc, :nocc]
        v_vv = -vn[:, nocc:, nocc:]
        v_ov = -vn[:, :nocc, nocc:]
        # Z intermediates (CCS.py:328-347), batched over states
        Z = einsum("njj->n", v_oo) + einsum("njb,jb->n", v_ov, ts)
        Z0 = (v_ov + einsum("ib,nab->nia", ts, v_vv)
              - einsum("ja,nji->nia", ts, v_oo)
              - einsum("ja,njb,ib->nia", ts, v_ov, ts))
        Zab = v_vv - einsum("ja,njb->nab", ts, v_ov)
        Zji = -v_oo - einsum("ib,njb->nji", ts, v_ov)
        tsnew = tsnew + einsum("nia,n->ia", rsn, Z)
        tsnew = tsnew + einsum("n,nia->ia", r0n, Z0)
        tsnew = tsnew + einsum("nab,nib->ia", Zab, rsn)
        tsnew = tsnew + einsum("nji,nja->ia", Zji, rsn)

    return tsnew / (diag_oo[:, None] - diag_vv[None, :])


def tsupdate_L1(eris, ts, T1i, alpha):
    """SCF + L1-regularized t1 update. Reference CCS.py:353-384."""
    Fab, Fji, Fai = T1i
    nocc, nvir = ts.shape
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    T1 = Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)
    dW = subdiff(T1, ts, alpha)
    eia = diag_oo[:, None] - diag_vv[None, :]
    return (dW + ts * eia) / eia


# ---------------------------------------------------------------------------
# Lambda1 intermediates and updates (reference CCS.py:490-768)
# ---------------------------------------------------------------------------

def L1inter(eris, ts, fsp, E_term=True):
    """'Stasis' Lambda1 intermediates. Reference CCS.py:649-698."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov, fvv = f[:nocc, :nocc], f[:nocc, nocc:], f[nocc:, nocc:]

    Fba = (fvv - einsum("ja,jb->ba", fov, ts)
           + einsum("jbca,jc->ba", eris.ovvv, ts))
    tmp = einsum("jkca,jc->ka", eris.oovv, ts)
    Fba = Fba - einsum("ka,kb->ba", tmp, ts)

    Fij = (foo + einsum("ib,jb->ij", fov, ts)
           + einsum("kibj,kb->ij", eris.oovo, ts))
    tmp = einsum("kibc,kb->ic", eris.oovv, ts)
    Fij = Fij + einsum("ic,jc->ij", tmp, ts)

    Wbija = eris.voov - einsum("kija,kb->bija", eris.ooov, ts)
    tmp = einsum("kica,kb->icab", eris.oovv, ts)
    Wbija = Wbija - einsum("icab,jc->bija", tmp, ts)
    Wbija = Wbija + einsum("bica,jc->bija", eris.vovv, ts)

    Fia = fov + einsum("jiba,jb->ia", eris.oovv, ts)

    if E_term:
        E = -einsum("jb,jb->", ts, fov) - 0.5 * einsum("jb,kc,jkbc->", ts, ts, eris.oovv)
    else:
        E = torch.zeros((), dtype=ts.dtype, device=ts.device)
    return Fia, Fba, Fij, Wbija, E


def L1inter_Stanton(eris, ts, fsp):
    """Stanton-95 Lambda1 intermediates with t2=0. Reference CCS.py:700-768."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov, fvv = f[:nocc, :nocc], f[:nocc, nocc:], f[nocc:, nocc:]

    tsts = einsum("ia,jb->ijab", 0.25 * ts, ts)
    tsts = tsts - tsts.permute(1, 0, 2, 3)
    tau = tsts - tsts.permute(0, 1, 3, 2)

    TFea = (fvv - 0.5 * einsum("ma,me->ea", fov, ts)
            + einsum("mf,emaf->ea", ts, eris.vovv)
            - 0.5 * einsum("mnef,mnaf->ea", tau, eris.oovv))
    TFie = fov + einsum("nf,inef->ie", ts, eris.oovv)
    TFim = (foo + 0.5 * einsum("me,ie->im", ts, fov)
            + einsum("ne,inme->im", ts, eris.ooov)
            + 0.5 * einsum("mnef,inef->im", tau, eris.oovv))
    Fea = TFea - 0.5 * einsum("me,ma->ea", ts, TFie)
    Fim = TFim + 0.5 * einsum("me,ie->im", ts, TFie)

    Weima = eris.ovvo + einsum("mf,ieaf->ieam", ts, eris.ovvv)
    Weima = Weima - einsum("ne,inam->ieam", ts, eris.oovo)
    Weima = Weima - einsum("mf,ne,inaf->ieam", ts, ts, eris.oovv)
    Weima = Weima.permute(1, 0, 3, 2)  # ieam -> eima

    Fia = TFie
    E = torch.zeros((), dtype=ts.dtype, device=ts.device)
    return Fia, Fea, Fim, Weima, E


def L1eq(eris, ts, ls, fsp, E_term=True):
    """Lambda1 equation value. Reference CCS.py:490-509."""
    Fia, Fba, Fij, Wbija, E = L1inter(eris, ts, fsp, E_term=E_term)
    return (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
            + einsum("jb,bija->ia", ls, Wbija) + ls * E)


def lsupdate(eris, ts, ls, L1i, rsn=None, lsn=None, r0n=None, l0n=None, vn=None):
    """SCF update of lambda1 with optional ES coupling. Reference CCS.py:511-583."""
    Fia, Fba, Fij, Wbija, E = L1i
    nocc, nvir = ls.shape
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    Fba = _remove_diag(Fba, diag_vv)
    Fij = _remove_diag(Fij, diag_oo)

    lsnew = (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
             + einsum("jb,bija->ia", ls, Wbija) + ls * E)

    if rsn is not None:
        v_oo = -vn[:, :nocc, :nocc]
        v_vv = -vn[:, nocc:, nocc:]
        v_ov = -vn[:, :nocc, nocc:]
        # P intermediates (CCS.py:555-579), batched over states
        Pl = (einsum("njb,njb->n", rsn, v_ov)
              + r0n * einsum("jb,njb->n", ts, v_ov)
              + r0n * einsum("njj->n", v_oo))
        P = einsum("njj->n", v_oo) + einsum("jb,njb->n", ts, v_ov)
        Pba = v_vv - einsum("jb,nja->nba", ts, v_ov)
        Pij = -v_oo - einsum("jb,nib->nij", ts, v_ov)
        lsnew = lsnew + ls * Pl.sum()
        lsnew = lsnew + einsum("n,nia->ia", l0n, v_ov)
        lsnew = lsnew + einsum("nia,n->ia", lsn, P)
        lsnew = lsnew + einsum("nib,nba->ia", lsn, Pba)
        lsnew = lsnew + einsum("nja,nij->ia", lsn, Pij)

    return lsnew / (diag_oo[:, None] - diag_vv[None, :])


def lsupdate_L1(eris, ls, L1i, alpha):
    """SCF + L1-regularized lambda1 update. Reference CCS.py:585-617."""
    Fia, Fba, Fij, Wbija, E = L1i
    nocc, nvir = ls.shape
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    L1 = (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
          + einsum("jb,bija->ia", ls, Wbija) + ls * E)
    dW = subdiff(L1, ls, alpha)
    eia = diag_oo[:, None] - diag_vv[None, :]
    return (dW + ls * eia) / eia


# ---------------------------------------------------------------------------
# ES helpers: per-state scalars and data-dependent (o, v) positions
# ---------------------------------------------------------------------------

def _s(x, like):
    """A per-state scalar (float, 0-d tensor, or (n_es,) tensor) shaped to
    scale (..., p, q) matrices."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.to(like.dtype)[..., None, None]


def _blocks(doo, dov, dvo, dvv):
    """[[doo, dov], [dvo, dvv]] with the leading state axes broadcast."""
    batch = torch.broadcast_shapes(*(b.shape[:-2]
                                     for b in (doo, dov, dvo, dvv)))
    doo, dov, dvo, dvv = (b.expand(*batch, *b.shape[-2:])
                          for b in (doo, dov, dvo, dvv))
    return torch.cat([torch.cat([doo, dov], dim=-1),
                      torch.cat([dvo, dvv], dim=-1)], dim=-2)


def _flat_index(ov, nvir):
    o, v = ov
    return o * nvir + v


def _take(a, idx):
    """a[..., o, v] at the flattened position idx: an int, or a tensor with
    one position per state (no host read)."""
    flat = a.reshape(*a.shape[:-2], -1)
    if isinstance(idx, torch.Tensor):
        return flat.gather(-1, idx[..., None])[..., 0]
    return flat[..., idx]


def _put(a, idx, val):
    """A copy of a with a[..., o, v] = val at the flattened position idx."""
    flat = a.reshape(*a.shape[:-2], -1).clone()
    if isinstance(idx, torch.Tensor):
        if isinstance(val, torch.Tensor):
            flat.scatter_(-1, idx[..., None], val.to(a.dtype)[..., None])
        else:
            flat.scatter_(-1, idx[..., None], val)
    else:
        flat[..., idx] = val
    return flat.reshape(a.shape)


def _argmax_abs(a):
    """Flattened position of the largest |a[..., o, v]| of each state."""
    return a.abs().reshape(*a.shape[:-2], -1).argmax(dim=-1)


# ---------------------------------------------------------------------------
# ES rdm1s (reference CCS.py:51-154)
# ---------------------------------------------------------------------------

def _gamma_es_blocks(ts, ln, rk, r0k, l0n):
    r0k, l0n = _s(r0k, ts), _s(l0n, ts)
    doo = (-r0k * einsum("ie,...je->...ij", ts, ln)
           - einsum("...ie,...je->...ij", rk, ln))
    dvo = r0k * ln.transpose(-1, -2)
    dvv = (r0k * einsum("mb,...ma->...ab", ts, ln)
           + einsum("...mb,...ma->...ab", rk, ln))
    tmp = einsum("ja,...jb->...ab", ts, ln)
    rl = einsum("...ie,...me->...im", rk, ln)
    dov = (-r0k * einsum("ib,...ab->...ia", ts, tmp)
           - einsum("ma,...im->...ia", ts, rl)
           - einsum("ie,...ae->...ia", ts,
                    einsum("...ma,...me->...ae", rk, ln))
           + ts + l0n * rk)
    return doo, dov, dvo, dvv


def gamma_es_CCS(ts, ln, rk, r0k, l0n):
    """Unsymmetrized CCS ES rdm1 <Psi_n|ap+.aq|Psi_k>. Reference CCS.py:51-102.
    GS case handled by the caller passing rk=0, r0k=1, l0n=0."""
    nocc, nvir = ts.shape
    dm1 = _blocks(*_gamma_es_blocks(ts, ln, rk, r0k, l0n))
    return dm1 + _hf_diag(nocc, nvir, dm1)


def gamma_tr_CCS(ts, ln, rk, r0k, l0n):
    """Transition rdm1: gamma_es without the HF diagonal. Reference CCS.py:105-154."""
    return _blocks(*_gamma_es_blocks(ts, ln, rk, r0k, l0n))


# ---------------------------------------------------------------------------
# ES: R1 equations (reference CCS.py:774-985)
# ---------------------------------------------------------------------------

def R1inter(eris, ts, fsp, vm):
    """R1 intermediates for one excited state. Reference CCS.py:774-872.
    vm: the V^{m0} coupling potential (dim x dim) or None."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov = f[..., :nocc, :nocc], f[..., :nocc, nocc:]
    fvo, fvv = f[..., nocc:, :nocc], f[..., nocc:, nocc:]

    t_oovv = einsum("jc,jkcb->kb", ts, eris.oovv)
    Fab = (fvv - einsum("ja,...jb->...ab", ts, fov)
           + einsum("jc,jacb->ab", ts, eris.ovvv)
           - einsum("ka,kb->ab", ts, t_oovv))
    Fji = (foo + einsum("ib,...jb->...ji", ts, fov)
           + einsum("kb,kjbi->ji", ts, eris.oovo)
           + einsum("ic,jc->ji", ts, einsum("kb,kjbc->jc", ts, eris.oovv)))
    W = (eris.voov + einsum("ib,akbc->akic", ts, eris.vovv)
         - einsum("ja,jkic->akic", ts,
                  einsum("ib,jkbc->jkic", ts, eris.oovv))
         - einsum("ja,jkic->akic", ts, eris.ooov))
    Fjb = fov + 0.5 * einsum("kc,jkbc->jb", ts, eris.oovv)
    Er = einsum("jb,...jb->...", ts, Fjb)

    Zab = fvv - einsum("ja,...jb->...ab", ts, fov)
    Zji = foo + einsum("kb,kjbi->ji", ts, eris.oovo)
    tmp = einsum("ic,jkbc->ijkb", ts, eris.oovv)
    Zji = Zji - einsum("kb,ijkb->ji", ts, tmp)
    Zai = (fvo + einsum("jb,jabi->ai", ts, eris.ovvo)
           + einsum("ic,ac->ai", ts,
                    einsum("jb,jabc->ac", ts, eris.ovvv)))
    Tia = (Zai.transpose(-1, -2) + einsum("ib,...ab->...ia", ts, Zab)
           - einsum("ja,...ji->...ia", ts, Zji))

    if vm is None:
        Pia = torch.zeros_like(Tia)
    else:
        v_vo = -vm[..., nocc:, :nocc]
        v_vv = -vm[..., nocc:, nocc:]
        v_oo = -vm[..., :nocc, :nocc]
        d_oo = torch.diagonal(v_oo, dim1=-2, dim2=-1)
        Pia = (v_vo + einsum("...ab,ib->...ai", v_vv, ts)
               - einsum("...i,ja,ib->...ai", d_oo, ts, ts)
               ).transpose(-1, -2)
    return Fab, Fji, W, Er, Tia, Pia


def _r1_linear(Rinter, rs):
    Fab, Fji, W = Rinter[:3]
    return (einsum("...ab,...ib->...ia", Fab, rs)
            - einsum("...ji,...ja->...ia", Fji, rs)
            + einsum("akic,...kc->...ia", W, rs))


def R1eq(rs, r0, Rinter):
    """Ria values. Reference CCS.py:965-985."""
    Fab, Fji, W, F, Tia, Pia = Rinter
    return (_r1_linear(Rinter, rs) + rs * _s(F, rs) + _s(r0, rs) * Tia + Pia)


def Extract_Em_r(eris, rs, r0, Rinter, ov=None):
    """Em from the largest r1 element (or given (o,v)). Reference
    CCS.py:874-906.  Returns (Em, o, v); without ov, o and v are tensors
    (one position per state), found and read on the device."""
    nvir = rs.shape[-1]
    idx = _argmax_abs(rs) if ov is None else _flat_index(ov, nvir)
    rov = _take(rs, idx)
    Rov = _take(R1eq(rs, r0, Rinter), idx)
    if ov is None:
        return Rov / rov, idx // nvir, idx % nvir
    return Rov / rov, ov[0], ov[1]


def _force_alpha(a):
    a = a.clone()
    a[..., 0::2, :] = 0.0
    return a


def rsupdate(eris, rs, r0, Rinter, Em, force_alpha=True):
    """r1 SCF update. Reference CCS.py:908-943."""
    Fab, Fji, W, F, Zia, Pia = Rinter
    nocc, nvir = rs.shape[-2:]
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    Rin = (_remove_diag(Fab, diag_vv), _remove_diag(Fji, diag_oo), W)
    rsnew = (_r1_linear(Rin, rs) + rs * _s(F, rs) + _s(r0, rs) * Zia + Pia)
    rsnew = rsnew / (_s(Em, rs) + diag_oo[:, None] - diag_vv[None, :])
    return _force_alpha(rsnew) if force_alpha else rsnew


def get_ov(ls, l0, rs, r0, ov):
    """Missing amplitude from the normality condition. Reference CCS.py:945-963."""
    idx = _flat_index(ov, rs.shape[-1])
    r = _put(rs, idx, 0.0)
    rov = 1.0 - r0 * l0 - einsum("...ia,...ia->...", r, ls)
    return rov / _take(ls, idx)


def R0inter(eris, ts, fsp, vm):
    """R0 intermediates. Reference CCS.py:987-1034."""
    nocc = ts.shape[0]
    f = eris.fock if fsp is None else fsp
    fov = f[..., :nocc, nocc:]
    Fjb = fov + einsum("kc,kjcb->jb", ts, eris.oovv)
    Zjb = fov + 0.5 * einsum("kc,jkbc->jb", ts, eris.oovv)
    E = einsum("jb,...jb->...", ts, Zjb)
    vm_oo = vm[..., :nocc, :nocc]
    vm_ov = vm[..., :nocc, nocc:]
    P = einsum("...jj->...", vm_oo) + einsum("jb,...jb->...", ts, vm_ov)
    return Fjb, E, P


def r0update(rs, r0, Em, R0i):
    """r0 SCF update. Reference CCS.py:1081-1096."""
    Fjb, E, P = R0i
    return (einsum("...jb,...jb->...", rs, Fjb) + P + r0 * E) / Em


def R0eq(rs, r0, R0i):
    Fjb, E, P = R0i
    return einsum("...jb,...jb->...", rs, Fjb) + r0 * E + P


def r0_fromE(eris, En, t1, r1, vm0, fsp=None):
    """r0 from the R0 equation at energy En. Reference CCS.py:1116-1158."""
    nocc, nvir = r1.shape[-2:]
    f = eris.fock if fsp is None else fsp
    fov = f[..., :nocc, nocc:]
    t_oovv = einsum("jb,jkbc->kc", t1, eris.oovv)
    d = (En - einsum("jb,...jb->...", t1, fov)
         - 0.5 * einsum("kc,kc->", t1, t_oovv))
    r0 = (einsum("...jb,...jb->...", r1, fov)
          + einsum("...kc,kc->...", r1, t_oovv))
    if vm0 is not None:
        r0 = (r0 + einsum("jb,...jb->...", t1, -vm0[..., :nocc, nocc:])
              + einsum("...jj->...", -vm0[..., :nocc, :nocc]))
    return r0 / d


# ---------------------------------------------------------------------------
# ES: L1/L0 equations (reference CCS.py:1164-1518)
# ---------------------------------------------------------------------------

def es_L1inter(eris, ts, fsp, vm):
    """ES Lambda1 intermediates. Reference CCS.py:1164-1234.
    vm: the V^{0m} coupling potential or None."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov, fvv = (f[..., :nocc, :nocc], f[..., :nocc, nocc:],
                     f[..., nocc:, nocc:])

    Fba = (fvv - einsum("jb,...ja->...ba", ts, fov)
           + einsum("jc,jbca->ba", ts, eris.ovvv)
           - einsum("kb,ka->ba", ts, einsum("jc,jkca->ka", ts, eris.oovv)))
    Fij = (foo + einsum("jb,...ib->...ij", ts, fov)
           + einsum("kb,kibj->ij", ts, eris.oovo)
           + einsum("jc,ic->ij", ts, einsum("kb,kibc->ic", ts, eris.oovv)))
    W = (eris.voov - einsum("kb,kija->bija", ts, eris.ooov)
         + einsum("jc,bica->bija", ts, eris.vovv)
         - einsum("kb,kija->bija", ts,
                  einsum("jc,kica->kija", ts, eris.oovv)))
    Fjb = fov + 0.5 * einsum("kc,jkbc->jb", ts, eris.oovv)
    El = einsum("jb,...jb->...", ts, Fjb)
    Zia = fov + einsum("jb,jiba->ia", ts, eris.oovv)
    if vm is None:
        P = torch.zeros_like(Zia)
    else:
        P = -vm[..., :nocc, nocc:]
    return Fba, Fij, W, El, Zia, P


def _l1_linear(L1i, ls):
    Fba, Fij, W = L1i[:3]
    return (einsum("...ib,...ba->...ia", ls, Fba)
            - einsum("...ja,...ij->...ia", ls, Fij)
            + einsum("...jb,bija->...ia", ls, W))


def es_L1eq(ls, l0, esL1i):
    """Lia values. Reference CCS.py:1401-1421."""
    Fba, Fij, W, El, Zia, P = esL1i
    return (_l1_linear(esL1i, ls) + ls * _s(El, ls) + _s(l0, ls) * Zia + P)


def Extract_Em_l(eris, ls, l0, L1i, ov=None):
    """Em from the largest l1 element. Reference CCS.py:1288-1319.  Returns
    (Em, o, v) as Extract_Em_r does."""
    nvir = ls.shape[-1]
    idx = _argmax_abs(ls) if ov is None else _flat_index(ov, nvir)
    lov = _take(ls, idx)
    Lov = _take(es_L1eq(ls, l0, L1i), idx)
    if ov is None:
        return Lov / lov, idx // nvir, idx % nvir
    return Lov / lov, ov[0], ov[1]


def es_lsupdate(eris, ls, l0, Em, L1i, force_alpha=True):
    """ES l1 update. Reference CCS.py:1366-1399."""
    Fba, Fij, W, F, Zia, P = L1i
    nocc, nvir = ls.shape[-2:]
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    Lin = (_remove_diag(Fba, diag_vv), _remove_diag(Fij, diag_oo), W)
    lsnew = (_l1_linear(Lin, ls) + ls * _s(F, ls) + _s(l0, ls) * Zia + P)
    lsnew = lsnew / (_s(Em, ls) + diag_oo[:, None] - diag_vv[None, :])
    return _force_alpha(lsnew) if force_alpha else lsnew


def L0inter(eris, ts, fsp, vm):
    """L0 intermediates. Reference CCS.py:1236-1286."""
    nocc = ts.shape[0]
    f = eris.fock if fsp is None else fsp
    foo, fov = f[..., :nocc, :nocc], f[..., :nocc, nocc:]
    fvv, fvo = f[..., nocc:, nocc:], f[..., nocc:, :nocc]

    Fbj = (fvo - einsum("kb,...kj->...bj", ts, foo)
           + einsum("ja,...ba->...bj", ts, fvv)
           - einsum("jc,...bc->...bj", ts,
                    einsum("kb,...kc->...bc", ts, fov)))
    tmp = (eris.ovvo
           + einsum("lb,lkcj->kbcj", ts,
                    einsum("jd,lkcd->lkcj", ts, eris.oovv))
           - einsum("lb,klcj->kbcj", ts, eris.oovo)
           + einsum("jd,kbcd->kbcj", ts, eris.ovvv))
    Wjb = einsum("kc,kbcj->jb", ts, tmp)
    Zjb = fov + 0.5 * einsum("kc,jkbc->jb", ts, eris.oovv)
    Z = einsum("jb,...jb->...", ts, Zjb)
    P = (einsum("ia,...ia->...", ts, vm[..., :nocc, nocc:])
         + einsum("...jj->...", vm[..., :nocc, :nocc]))
    return Fbj, Wjb, Z, P


def l0update(ls, l0, Em, L0i):
    """l0 SCF update. Reference CCS.py:1423-1439."""
    Fbj, Wjb, Z, P = L0i
    F = einsum("...jb,...bj->...", ls, Fbj)
    W = einsum("...jb,jb->...", ls, Wjb)
    return (F + W + P + l0 * Z) / Em


def L0eq(ls, l0, L0i):
    Fbj, Wjb, El, P = L0i
    return (einsum("...jb,...bj->...", ls, Fbj)
            + einsum("...jb,jb->...", ls, Wjb) + l0 * El + P)


def l0_fromE(eris, En, t1, l1, v0m, fsp=None):
    """l0 from the L0 equation at energy En. Reference CCS.py:1459-1518."""
    nocc, nvir = t1.shape
    f = eris.fock if fsp is None else fsp
    fov, fvv, foo = (f[..., :nocc, nocc:], f[..., nocc:, nocc:],
                     f[..., :nocc, :nocc])

    t_oovv = einsum("lc,klcd->kd", t1, eris.oovv)
    d = En - 0.5 * einsum("jb,jb->", t1,
                          einsum("kc,jkbc->jb", t1, eris.oovv))

    lt_vv = einsum("...jb,jd->...bd", l1, t1)
    lt_oo = einsum("...jb,lb->...jl", l1, t1)
    l0 = (einsum("...jb,...jb->...", l1, fov)
          + einsum("...ja,...ja->...", l1,
                   einsum("...ab,jb->...ja", fvv, t1))
          - einsum("...jk,...kj->...", lt_oo, foo)
          - einsum("...jk,...jk->...", lt_oo,
                   einsum("jc,...kc->...jk", t1, fov))
          + einsum("...jb,bj->...", l1,
                   einsum("kc,kbcj->bj", t1, eris.ovvo)))
    l0 = l0 + einsum("...bd,bd->...", lt_vv, einsum("kb,kd->bd", t1, t_oovv))
    l0 = l0 - einsum("...jl,lj->...", lt_oo,
                     einsum("kc,klcj->lj", t1, eris.oovo))
    l0 = l0 + einsum("...bd,bd->...", lt_vv,
                     einsum("kc,kbcd->bd", t1, eris.ovvv))
    if v0m is not None:
        l0 = (l0 + einsum("ia,...ia->...", t1, v0m[..., :nocc, nocc:])
              + einsum("...jj->...", v0m[..., :nocc, :nocc]))
    return l0 / d


def _positive_root(a, b, c, what):
    disc = b * b - 4 * a * c
    x1 = (-b + np.sqrt(disc)) / (2 * a)
    x2 = (-b - np.sqrt(disc)) / (2 * a)
    if x1 > 0:
        return x1
    if x2 > 0:
        return x2
    raise ValueError(f"Both solutions for {what} are negative")


def Extract_r0(eris, r1, ts, fsp, vm):
    """r0 from the quadratic R0/R1 consistency (eliminate Em between the R1
    and R0 equations: a r0^2 + b r0 + c = 0 with a = Zia/r, b = R1/r - Z,
    c = -(r.Fjb + P)).  Reference CCS.py:1036-1079, with the standard
    quadratic formula where the reference divides by c.  One state; reads
    its scalars to the host."""
    f = eris.fock if fsp is None else fsp
    Rinter = R1inter(eris, ts, f, vm)
    Fjb, Z, P = R0inter(eris, ts, f, torch.zeros_like(f) if vm is None else vm)
    F, Zia, Pia = Rinter[3:]
    R1 = _r1_linear(Rinter, r1) + r1 * F + Pia
    c = -float(einsum("jb,jb->", r1, Fjb)) - float(P)
    if c == 0.0:
        return 0.0
    idx = int(_argmax_abs(r1))
    rov = float(_take(r1, idx))
    a = float(_take(Zia, idx)) / rov
    b = float(_take(R1, idx)) / rov - float(Z)
    return _positive_root(a, b, c, "r0")


def Extract_l0(eris, l1, ts, fsp, vm):
    """l0 from the quadratic L0/L1 consistency (mirror of Extract_r0 on the
    left-hand side).  Reference CCS.py:1321-1364, with the standard
    quadratic formula."""
    f = eris.fock if fsp is None else fsp
    vz = torch.zeros_like(f) if vm is None else vm
    L1i = es_L1inter(eris, ts, f, vz)
    Fbj, Wjb, Z, P0 = L0inter(eris, ts, f, vz)
    F, Zia, P1 = L1i[3:]
    L1 = _l1_linear(L1i, l1) + l1 * F + P1
    c = -float(einsum("jb,bj->", l1, Fbj) + einsum("jb,jb->", l1, Wjb)) \
        - float(P0)
    if c == 0.0:
        return 0.0
    idx = int(_argmax_abs(l1))
    lov = float(_take(l1, idx))
    a = float(_take(Zia, idx)) / lov
    b = float(_take(L1, idx)) / lov - float(Z)
    return _positive_root(a, b, c, "l0")


class Gccs:
    """Thin class wrapper matching the reference API (CCS.py:197)."""

    def __init__(self, eris, fock=None, M_tot=None):
        self.eris = eris
        self.fock = eris.fock if fock is None else fock
        self.M_tot = 1 if M_tot is None else M_tot
        self.nocc = eris.nocc
        self.nvir = eris.nvir

    def energy_ccs(self, ts, fsp, rsn=None, r0n=None, vn=None):
        return energy_ccs(self.eris, ts, fsp, rsn, r0n, vn)

    def gamma(self, ts, ls):
        return gamma_CCS(ts, ls)

    def gamma_unsym(self, ts, ls):
        return gamma_unsym_CCS(ts, ls)

    def T1inter(self, ts, fsp):
        return T1inter(self.eris, ts, fsp)

    def T1inter_Stanton(self, ts, fsp):
        return T1inter_Stanton(self.eris, ts, fsp)

    def T1eq(self, ts, fsp):
        return T1eq(self.eris, ts, fsp)

    def tsupdate(self, ts, T1i, rsn=None, r0n=None, vn=None):
        return tsupdate(self.eris, ts, T1i, rsn, r0n, vn)

    def tsupdate_L1(self, ts, T1i, alpha):
        return tsupdate_L1(self.eris, ts, T1i, alpha)

    def L1inter(self, ts, fsp, E_term=True):
        return L1inter(self.eris, ts, fsp, E_term=E_term)

    def L1inter_Stanton(self, ts, fsp):
        return L1inter_Stanton(self.eris, ts, fsp)

    def L1eq(self, ts, ls, fsp, E_term=True):
        return L1eq(self.eris, ts, ls, fsp, E_term=E_term)

    def lsupdate(self, ts, ls, L1i, rsn=None, lsn=None, r0n=None, l0n=None,
                 vn=None):
        return lsupdate(self.eris, ts, ls, L1i, rsn, lsn, r0n, l0n, vn)

    def lsupdate_L1(self, ls, L1i, alpha):
        return lsupdate_L1(self.eris, ls, L1i, alpha)

    def gamma_es(self, ts, ln, rn, r0n, l0n):
        return gamma_es_CCS(ts, ln, rn, r0n, l0n)

    def gamma_tr(self, ts, ln, rk, r0k, l0n):
        return gamma_tr_CCS(ts, ln, rk, r0k, l0n)

    def R1inter(self, ts, fsp, vm):
        return R1inter(self.eris, ts, fsp, vm)

    def R1eq(self, rs, r0, Rinter):
        return R1eq(rs, r0, Rinter)

    def Extract_Em_r(self, rs, r0, Rinter, ov=None):
        return Extract_Em_r(self.eris, rs, r0, Rinter, ov)

    def rsupdate(self, rs, r0, Rinter, Em, force_alpha=True):
        return rsupdate(self.eris, rs, r0, Rinter, Em, force_alpha)

    def get_ov(self, ls, l0, rs, r0, ov):
        return get_ov(ls, l0, rs, r0, ov)

    def R0inter(self, ts, fsp, vm):
        return R0inter(self.eris, ts, fsp, vm)

    def r0update(self, rs, r0, Em, R0i):
        return r0update(rs, r0, Em, R0i)

    def R0eq(self, rs, r0, R0i):
        return R0eq(rs, r0, R0i)

    def r0_fromE(self, En, t1, r1, vm0, fsp=None):
        return r0_fromE(self.eris, En, t1, r1, vm0, fsp)

    def es_L1inter(self, ts, fsp, vm):
        return es_L1inter(self.eris, ts, fsp, vm)

    def es_L1eq(self, ls, l0, esL1i):
        return es_L1eq(ls, l0, esL1i)

    def Extract_Em_l(self, ls, l0, L1i, ov=None):
        return Extract_Em_l(self.eris, ls, l0, L1i, ov)

    def es_lsupdate(self, ls, l0, Em, L1i, force_alpha=True):
        return es_lsupdate(self.eris, ls, l0, Em, L1i, force_alpha)

    def L0inter(self, ts, fsp, vm):
        return L0inter(self.eris, ts, fsp, vm)

    def l0update(self, ls, l0, Em, L0i):
        return l0update(ls, l0, Em, L0i)

    def L0eq(self, ls, l0, L0i):
        return L0eq(ls, l0, L0i)

    def l0_fromE(self, En, t1, l1, v0m, fsp=None):
        return l0_fromE(self.eris, En, t1, l1, v0m, fsp)

    def Extract_r0(self, r1, ts, fsp, vm):
        return Extract_r0(self.eris, r1, ts, fsp, vm)

    def Extract_l0(self, l1, ts, fsp, vm):
        return Extract_l0(self.eris, l1, ts, fsp, vm)


# ---------------------------------------------------------------------------
# Gradient / Newton machinery (reference CCS.py:1524-2160, class ccs_gradient)
#
# Instead of the reference's hand-derived Jacobian blocks (dT/dt, dT/dl,
# dL/dt, dL/dl with three Vexp-derivative models DV1/DV2/DV3,
# CCS.py:1668-2071), the Jacobian of the coupled (T1, Lambda1) residual
# system is obtained exactly by forward-mode AD (torch.func.jvp along each
# basis vector, vmapped in chunks) through the whole computation, the
# Vexp(gamma(t, l)) dependence included.  This covers the reference's DV1
# linear-in-gamma 'mat' model exactly and generalizes to every property
# the device Vexp supports.
# ---------------------------------------------------------------------------

# the memory of one Jacobian column in units of L1inter's (o, v, v, v)
# intermediate, with room for the temporaries beside it
JAC_COLUMN_BLOCKS = 4
JAC_CPU_BYTES = 2 ** 30      # the budget of the columns on the host


def jac_chunk(nocc, nvir, x):
    """Jacobian columns per vmapped jvp (ccs_gradient.Jacobian): as many as
    half the device's free memory holds (JAC_CPU_BYTES on the host), at
    JAC_COLUMN_BLOCKS o*v^3 blocks of x's dtype per column; at least 1, at
    most all of them."""
    if x.device.type == "cuda":
        budget = torch.cuda.mem_get_info(x.device)[0] // 2
    else:
        budget = JAC_CPU_BYTES
    per_column = JAC_COLUMN_BLOCKS * nocc * nvir ** 3 * x.element_size()
    return int(min(max(1, budget // per_column), x.numel()))


class ccs_gradient:
    def __init__(self, eris, Vexp_model=1, exp_pot=None):
        self.eris = eris
        self.fock = eris.fock
        self.nocc = eris.nocc
        self.nvir = eris.nvir
        self.exp_pot = exp_pot
        # device Vexp closure (optional): exact property-model derivatives
        self._vexp_fn = None
        if exp_pot is not None and Vexp_model in (2, 3):
            from ecw_cc_torch.ops.vexp import make_gs_vexp_device

            self._vexp_fn = make_gs_vexp_device(
                exp_pot, dtype=self.fock.dtype, device=self.fock.device)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.fock.dtype,
                               device=self.fock.device)

    # -- coupled residual with the local 'mat'-linear Vexp model ----------
    def _residuals(self, ts, ls, fsp0, gamma0, L):
        """T1/Lambda1 residuals with fsp varying through the rdm1:
        fsp(t, l) = fsp0 + L (gamma(t, l) - gamma0)  (exact for 'mat')."""
        if self._vexp_fn is not None:
            rdm1 = gamma_CCS(ts, ls)
            nprop = len(self.exp_pot.prop_names[0])
            V, _, _ = self._vexp_fn(rdm1, [L] * nprop)
            fsp = self.eris.fock - V
        else:
            fsp = fsp0 + L * (gamma_CCS(ts, ls) - gamma0)
        T1 = T1eq(self.eris, ts, fsp)
        L1 = L1eq(self.eris, ts, ls, fsp, E_term=False)
        return T1, L1

    def Jacobian(self, ts, ls, fsp, L):
        """Exact Jacobian of the stacked (T1, L1) residuals w.r.t (t1, l1):
        (J, residuals).  Its columns are the tangents of the residual along
        the identity basis, as many at a time as half the free memory holds
        (one torch.func.vmap of the jvp per chunk, jac_chunk): each tangent
        holds L1inter's (o, v, v, v) intermediate, so all 2ov at once would
        take ~46 GB at C2H2/cc-pVDZ f64."""
        ts, ls, fsp0 = self._tensor(ts), self._tensor(ls), self._tensor(fsp)
        gamma0 = gamma_CCS(ts, ls)
        n = ts.numel()

        def stacked(x):
            t = x[:n].reshape(ts.shape)
            l = x[n:].reshape(ls.shape)
            T1, L1 = self._residuals(t, l, fsp0, gamma0, L)
            return torch.cat([T1.reshape(-1), L1.reshape(-1)])

        x0 = torch.cat([ts.reshape(-1), ls.reshape(-1)])
        chunk_size = jac_chunk(self.nocc, self.nvir, x0)
        basis = torch.eye(x0.numel(), dtype=x0.dtype, device=x0.device)
        J = torch.func.vmap(lambda v: torch.func.jvp(stacked, (x0,), (v,))[1],
                            out_dims=1, chunk_size=chunk_size)(basis)
        return J, stacked(x0)

    def Newton(self, ts, ls, fsp, L):
        """One Newton step on the coupled system. Reference CCS.py:2094-2124."""
        ts, ls = self._tensor(ts), self._tensor(ls)
        n = ts.numel()
        J, R = self.Jacobian(ts, ls, fsp, L)
        dx = torch.linalg.solve(J, -R)
        return (ts + dx[:n].reshape(ts.shape),
                ls + dx[n:].reshape(ls.shape))

    def Gradient_Descent(self, beta, ts, ls, fsp, L):
        """Steepest-descent step on 1/2 |R|^2. Reference CCS.py:2126-2160."""
        ts, ls, fsp0 = self._tensor(ts), self._tensor(ls), self._tensor(fsp)
        gamma0 = gamma_CCS(ts, ls)

        def objective(t, l):
            T1, L1 = self._residuals(t, l, fsp0, gamma0, L)
            return 0.5 * ((T1 ** 2).sum() + (L1 ** 2).sum())

        gt, gl = torch.func.grad(objective, argnums=(0, 1))(ts, ls)
        return ts - beta * gt, ls - beta * gl
