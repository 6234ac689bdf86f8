"""The vvvv 'ladder' contraction on the spin-sorted, sectored route.

Port of the sorted route of ecw_cc_tpu/ops/ladder.py.  The bare ladder
    y[ij,ab] = 0.5 sum_ef x[ij,ef] <ab||ef>
is computed for x antisymmetric in its last two indices (tau, t2, l2) on
the spin-SORTED MO layout (alpha first within occ and vir), where <ab||ef>
is block-diagonal over three spin sectors and each sector is packed to its
a<b pairs (SectoredVVVV).  Every sector product is the NT GEMM
C = A @ B.T of the hand-written Hopper kernel (kernels/ladder_mm.py), called
through `_sector_mm`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ecw_cc_torch.kernels.ladder_mm import ladder_mm

_PAIR_IDX = {}


def _pair_index(v, device):
    """Flat column indices e*v + f with e < f, in row-major pair order."""
    key = (v, str(device))
    idx = _PAIR_IDX.get(key)
    if idx is None:
        r, c = torch.triu_indices(v, v, offset=1, device=device)
        idx = _PAIR_IDX[key] = r * v + c
    return idx


def _pack_pairs(x2, v):
    """(M, v*v) -> (M, p): keep the columns (e*v+f) with e<f (one gather)."""
    return x2.index_select(1, _pair_index(v, x2.device))


def _unpack_pairs(yc, v):
    """(M, p) -> (M, v*v): inverse of _pack_pairs, zeros at f <= e (one
    scatter)."""
    out = yc.new_zeros((yc.shape[0], v * v))
    out[:, _pair_index(v, yc.device)] = yc
    return out


def pack_vvvv(vvvv):
    """Antisymmetry-packed (p, p) ladder operand of a dense <ab||ef> block,
    p = v(v-1)/2."""
    v = vvvv.shape[0]
    wc_rows = _pack_pairs(vvvv.reshape(v * v, v * v), v)       # (v^2, p)
    return _pack_pairs(wc_rows.T.contiguous(), v).contiguous()  # (p, p)


class SectoredVVVV(NamedTuple):
    """Spin-sectored antisymmetry-packed <ab||ef> for the sorted layout.
    Row axes may be zero-padded; the column axes are exact, so the sector
    sizes (ma, mb) follow from the column counts (_sector_dims)."""
    wc_aa: torch.Tensor   # (paa, paa), paa = ma(ma-1)/2
    wc_bb: torch.Tensor   # (pbb, pbb)
    w_ab: torch.Tensor    # (ma*mb, ma*mb)


def _sector_dims(sect, nvir):
    """(ma, mb) from ma*mb = w_ab.shape[1] and ma + mb = nvir (ma <= mb)."""
    K = sect.w_ab.shape[1]
    disc = nvir * nvir - 4 * K
    r = int(round(disc ** 0.5))
    if r * r != disc:
        raise ValueError(f"SectoredVVVV with {K} alpha-beta columns does not "
                         f"fit nvir={nvir}")
    ma = (nvir - r) // 2
    return ma, nvir - ma


def pack_vvvv_sorted(vvvv, ma):
    """SectoredVVVV from a dense <ab||ef> block in the sorted layout (alpha
    virtuals 0..ma-1).  The spin-forbidden blocks are never stored."""
    v = vvvv.shape[0]
    mb = v - ma
    return SectoredVVVV(
        wc_aa=pack_vvvv(vvvv[:ma, :ma, :ma, :ma]),
        wc_bb=pack_vvvv(vvvv[ma:, ma:, ma:, ma:]),
        w_ab=vvvv[:ma, ma:, :ma, ma:].reshape(ma * mb, ma * mb).contiguous())


def _sector_inputs(x, ma):
    """The three sector column spaces of x (antisymmetric in its last two
    indices, sorted layout) as 2-D GEMM operands."""
    o, o2, v, _ = x.shape
    mb = v - ma
    M = o * o2
    x_aa = _pack_pairs(x[:, :, :ma, :ma].reshape(M, ma * ma), ma)
    x_bb = _pack_pairs(x[:, :, ma:, ma:].reshape(M, mb * mb), mb)
    x_ab = x[:, :, :ma, ma:].reshape(M, ma * mb)
    return x_aa, x_bb, x_ab


def _sector_mm(xs, w, ncols):
    """One sector GEMM xs @ w.T through the Hopper kernel."""
    y = ladder_mm(xs.contiguous(), w)
    return y[:, :ncols] if w.shape[0] != ncols else y


def _sector_assemble(y_aa, y_bb, y_ab, o, ma, mb, dtype, o2=None):
    """Upper-triangle sector results -> full antisymmetric (o,o2,v,v)."""
    if o2 is None:
        o2 = o
    v = ma + mb
    z = y_aa.new_zeros((o, o2, v, v), dtype=dtype)
    z[:, :, :ma, :ma] = _unpack_pairs(y_aa, ma).reshape(o, o2, ma, ma)
    z[:, :, ma:, ma:] = _unpack_pairs(y_bb, mb).reshape(o, o2, mb, mb)
    z[:, :, :ma, ma:] = y_ab.reshape(o, o2, ma, mb)
    return z - z.transpose(2, 3)


def sectored_vvvv_contract(sect, x):
    """0.5 * einsum('ijef,abef->ijab', x, vvvv) via the spin-sorted sectors
    (x antisymmetric in its last two indices; also the lambda ladder)."""
    o, o2, v, _ = x.shape
    ma, mb = _sector_dims(sect, v)
    x_aa, x_bb, x_ab = _sector_inputs(x, ma)
    y_aa = _sector_mm(x_aa, sect.wc_aa, ma * (ma - 1) // 2)
    y_bb = _sector_mm(x_bb, sect.wc_bb, mb * (mb - 1) // 2)
    y_ab = _sector_mm(x_ab, sect.w_ab, ma * mb)
    return _sector_assemble(y_aa, y_bb, y_ab, o, ma, mb, x.dtype, o2=o2)


def _block_dtype(x):
    if not hasattr(x, "blocks"):
        return x.dtype
    return next(iter(x.blocks.values())).dtype


def _check_blocked(x, sym):
    """A SpinBlocked ladder operand must carry the call's sym flag (else
    its mirror blocks would be read as the canonical ones) and blocks."""
    if x.sym != sym:
        raise ValueError(f"SpinBlocked operand has sym={x.sym} but the "
                         f"ladder was called with sym={sym}")
    if not x.blocks:
        raise ValueError("SpinBlocked ladder operand has no blocks")


def balanced_stacked_sectored_contract(sect, x1, x2, oa, sym=False,
                                       blocked_info=None):
    """Both per-iteration ladders (t side on x1 = tau, lambda side on
    x2 = l2) with spin-balanced row selection: one GEMM per spin sector on
    the stacked rows of x1 and x2.

    Requires the sorted layout and operands with balanced spin support:
    the aa/bb column sectors take only the (alpha,alpha)/(beta,beta)
    occupied row pairs and the ab sector only the (alpha,beta) rows.

    sym=True (closed-shell mirror symmetry): the bb result equals the aa
    result, so its GEMM is skipped -- two kernel launches instead of three.

    blocked_info: a SectorInfo -- return SpinBlocked results instead of
    dense (o,o,v,v) tensors.  x1/x2 may themselves be SpinBlocked; their
    `sym` must equal `sym`.

    x2=None: single-ladder mode, contracts only x1 and returns one result."""
    single = x2 is None
    xd = x1 if single or hasattr(x2, "blocks") else x2
    o, v = ((xd.info.nocc, xd.info.nvir) if hasattr(xd, "blocks")
            else (xd.shape[0], xd.shape[2]))
    ma, mb = _sector_dims(sect, v)
    ob = o - oa
    if sym and not (oa == ob and ma == mb):
        raise ValueError(f"sym requires equal alpha/beta sector sizes "
                         f"(oa={oa}, ob={ob}, ma={ma}, mb={mb})")
    paa, pbb = ma * (ma - 1) // 2, mb * (mb - 1) // 2

    def rows(x):
        if hasattr(x, "blocks"):   # SpinBlocked operand (balanced support)
            _check_blocked(x, sym)
            r_aa = _pack_pairs(
                x.get((0, 0, 0, 0)).reshape(oa * oa, ma * ma), ma)
            r_ab = x.get((0, 1, 0, 1)).reshape(oa * ob, ma * mb)
            if sym:
                return r_aa, None, r_ab
            r_bb = _pack_pairs(
                x.get((1, 1, 1, 1)).reshape(ob * ob, mb * mb), mb)
            return r_aa, r_bb, r_ab
        r_aa = _pack_pairs(x[:oa, :oa, :ma, :ma].reshape(oa * oa, ma * ma),
                           ma)
        r_ab = x[:oa, oa:, :ma, ma:].reshape(oa * ob, ma * mb)
        if sym:
            return r_aa, None, r_ab
        r_bb = _pack_pairs(x[oa:, oa:, ma:, ma:].reshape(ob * ob, mb * mb),
                           mb)
        return r_aa, r_bb, r_ab

    rls = [rows(x1)] if single else [rows(x1), rows(x2)]

    def cat(i):
        return rls[0][i] if single else torch.cat([rls[0][i], rls[1][i]])

    y_aa = _sector_mm(cat(0), sect.wc_aa, paa)
    y_bb = y_aa if sym else _sector_mm(cat(1), sect.wc_bb, pbb)
    y_ab = _sector_mm(cat(2), sect.w_ab, ma * mb)

    Maa, Mbb, Mab = oa * oa, ob * ob, oa * ob

    if blocked_info is not None:
        from ecw_cc_torch.ops.spinsect import SpinBlocked

        def bassemble(k, dtype):
            A = (_unpack_pairs(y_aa[k * Maa:(k + 1) * Maa], ma)
                 .reshape(oa, oa, ma, ma).to(dtype))
            AB = (y_ab[k * Mab:(k + 1) * Mab].reshape(oa, ob, ma, mb)
                  .to(dtype))
            blocks = {
                (0, 0, 0, 0): A - A.transpose(2, 3),
                (0, 1, 0, 1): AB,
                # z[i_a, j_b, a_b, b_a] = -z[i_a, j_b, b_a, a_b]
                (0, 1, 1, 0): -AB.transpose(2, 3),
            }
            if not sym:
                B = (_unpack_pairs(y_bb[k * Mbb:(k + 1) * Mbb], mb)
                     .reshape(ob, ob, mb, mb).to(dtype))
                blocks[(1, 1, 1, 1)] = B - B.transpose(2, 3)
                # ij-antisymmetry rows: z[i_b, j_a, ...] = -z[j_a, i_b, ...]
                blocks[(1, 0, 0, 1)] = -AB.permute(1, 0, 2, 3)
                blocks[(1, 0, 1, 0)] = AB.permute(1, 0, 3, 2)
            return SpinBlocked("oovv", blocks, blocked_info, sym=sym)

        if single:
            return bassemble(0, _block_dtype(x1))
        return bassemble(0, _block_dtype(x1)), bassemble(1, _block_dtype(x2))

    def assemble(k, dtype):
        z = y_aa.new_zeros((o, o, v, v), dtype=dtype)
        z[:oa, :oa, :ma, :ma] = (_unpack_pairs(y_aa[k * Maa:(k + 1) * Maa], ma)
                                 .reshape(oa, oa, ma, ma))
        z[oa:, oa:, ma:, ma:] = (_unpack_pairs(y_bb[k * Mbb:(k + 1) * Mbb], mb)
                                 .reshape(ob, ob, mb, mb))
        ab = y_ab[k * Mab:(k + 1) * Mab].reshape(oa, ob, ma, mb)
        z[:oa, oa:, :ma, ma:] = ab
        # z[i_b, j_a, a_a, b_b] = -z[j_a, i_b, a_a, b_b] (ij-antisymmetry)
        z[oa:, :oa, :ma, ma:] = -ab.permute(1, 0, 2, 3)
        return z - z.transpose(2, 3)

    if single:
        return assemble(0, _block_dtype(x1))
    return assemble(0, _block_dtype(x1)), assemble(1, _block_dtype(x2))


def spin_sort_perm(orbspin, nocc):
    """Permutation (new_from_old MO indices) sorting the G spin-orbital order
    by spin within the occupied and virtual blocks (alpha first, stable)."""
    spin = np.asarray(orbspin)
    occ = np.argsort(spin[:nocc], kind="stable")
    vir = nocc + np.argsort(spin[nocc:], kind="stable")
    return np.concatenate([occ, vir])
