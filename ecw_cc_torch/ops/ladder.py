"""The vvvv 'ladder' contraction: the CCSD hot spot.

Port of ecw_cc_tpu/ops/ladder.py.  The bare ladder
    y[ij,ab] = 0.5 sum_ef x[ij,ef] <ab||ef>
is computed for x antisymmetric in its last two indices (tau, t2, l2), on
one of three routes:

  - dense (`ladder_contract` with no operand): one (o^2, v^2) x (v^2, v^2)
    GEMM against the full vvvv.  This is the call site of the JAX package's
    Pallas kernel (`_ladder_mm_pallas`, ladder.py:621-629);
  - packed (`PackedVVVV`): both pair indices restricted to e<f, a<b, so the
    GEMM is (o^2, p) x (p, p) with p = v(v-1)/2, in either MO layout;
  - sectored (`SectoredVVVV`): on the spin-SORTED MO layout (alpha first
    within occ and vir) <ab||ef> is block-diagonal over three spin sectors,
    each packed to its a<b pairs: three GEMMs.

Every one of these products is the NT GEMM C = A @ B.T of the hand-written
Hopper kernel (kernels/ladder_mm.py).  The lambda ladder
0.5 * einsum('ijcd,cdab->ijab', l2, vvvv) is the same product by the
pair-swap symmetry <ab||cd> = <cd||ab>.  The same symmetry makes every
operand here a symmetric matrix, which each call site tells the kernel
(symmetric=True): a gradient through a ladder, as the CCSD(T) response
density takes, is then one more launch of the kernel per product
(dA = dC @ B = dC @ B.T).  The O(o^4 v^2) and O(o^2 v^3)
corrections of `ladder_contract` stay torch.einsum, as they were XLA
einsums outside any Pallas kernel in the JAX package.

Any operand here may be split by rows over a device mesh (a RowShard,
parallel/sharding.py): each product then launches on this rank's rows
and gathers its columns (kernels/ladder_mm._ShardMM); the code here is
the same.

The JAX package's alternating-layout spin sectors (`vvvv_spin_sectors`,
`sector_vvvv_contract`, config.ladder_mode='sectors') are deliberately not
ported: 'auto' never picks them, and the sorted layout does the same work
without strided slices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ecw_cc_torch.config import active_precision, get_config
from ecw_cc_torch.kernels.ladder_mm import (BF16_ROW_ALIGN, TF32_ROW_ALIGN,
                                            RowShard, bf16_rows, ladder_mm,
                                            tf32_rows)
from ecw_cc_torch.ops import promote

einsum = promote.lane_einsum

# ladder_mode='auto' packs the ladder operand from this nvir up (the JAX
# package's default of config.ladder_packed_min_nvir)
PACKED_MIN_NVIR = 48

_PAIR_IDX = {}


def _pair_index(v, device, align=1):
    """Flat column indices e*v + f with e < f, in row-major pair order,
    padded to a multiple of `align` entries (repeating the first)."""
    key = (v, str(device), align)
    idx = _PAIR_IDX.get(key)
    if idx is None:
        r, c = torch.triu_indices(v, v, offset=1, device=device)
        idx = r * v + c
        pad = -idx.numel() % align
        if pad and idx.numel():
            idx = torch.cat([idx, idx[:1].expand(pad)])
        _PAIR_IDX[key] = idx
    return idx


def _pack_pairs(x2, v, align=1):
    """(M, v*v) -> (M, p): keep the columns (e*v+f) with e<f (one gather).
    align > 1: the gather writes rows of a multiple of `align` elements
    (the pad repeats a column; no kernel reads it) and this returns the
    view of their first p columns, a ladder product's A as the
    tensor-core kernels' TMA loads take it, so no launch copies it."""
    p = v * (v - 1) // 2
    y = x2.index_select(1, _pair_index(v, x2.device, align))
    return y if y.shape[1] == p else y[:, :p]


def _precision(x):
    """The kernel precision of a ladder product on x: 'tf32' for float32
    operands under the reduced iter_precision modes (config.
    matmul_precision), else None (bfloat16 operands select the BF16
    variant by their dtype)."""
    if x.dtype == torch.float32 and active_precision() != "highest":
        return "tf32"
    return None


def _row_align(x):
    """The row alignment (elements) of a ladder product's A on x: the
    tensor-core kernels' 16 bytes (bfloat16, or float32 under the reduced
    modes), else 1."""
    if x.dtype == torch.bfloat16:
        return BF16_ROW_ALIGN
    return TF32_ROW_ALIGN if _precision(x) == "tf32" else 1


def _cast(w, dtype):
    """An operand block in `dtype`, or 'tf32': the float32 block rounded to
    TF32 once (kernels.ladder_mm.tf32_rows).  The bfloat16 and TF32 blocks
    get rows padded for the tensor-core kernels' TMA loads
    (kernels.ladder_mm.bf16_rows, tf32_rows), so no launch copies them
    again."""
    if type(w) is not torch.Tensor:
        # a sharded operand (RowShard, DTensor): its local rows, placement
        # kept
        from ecw_cc_torch.parallel.sharding import map_local

        return map_local(lambda x: _cast(x, dtype), w)
    if dtype == "tf32":
        return tf32_rows(w)
    return bf16_rows(w) if dtype == torch.bfloat16 else w.to(dtype)


def _unpack_pairs(yc, v):
    """(M, p) -> (M, v*v): inverse of _pack_pairs, zeros at f <= e (one
    scatter)."""
    out = yc.new_zeros((yc.shape[0], v * v))
    out[:, _pair_index(v, yc.device)] = yc
    return out


class PackedVVVV(NamedTuple):
    """Upper-triangle-packed <ab||ef> (JAX ladder.py:202): wc[A, E] =
    <a b||e f> with A = (a<b), E = (e<f) in row-major pair order.  wc is
    symmetric (pair-swap symmetry); its row axis may be zero-padded."""
    wc: torch.Tensor   # (p, p), p = nvir*(nvir-1)//2

    def to(self, dtype):
        """This operand in `dtype` (or 'tf32', see _cast): cast once per
        solve, as the JAX loop's jax.tree.map(astype) (gs.py:932-933)."""
        return PackedVVVV(wc=_cast(self.wc, dtype))


def pack_vvvv(vvvv):
    """The PackedVVVV of a dense <ab||ef> block (JAX ladder.py:233)."""
    v = vvvv.shape[0]
    wc_rows = _pack_pairs(vvvv.reshape(v * v, v * v), v)       # (v^2, p)
    return PackedVVVV(
        wc=_pack_pairs(wc_rows.T.contiguous(), v).contiguous())  # (p, p)


def _packed_mm(xc, packed, p):
    """(M, p) packed rows times the packed operand, through the kernel."""
    yc = ladder_mm(xc, packed.wc, symmetric=True, precision=_precision(xc))
    return yc[:, :p] if packed.wc.shape[0] != p else yc


def packed_vvvv_contract(packed, x):
    """0.5 * einsum('ijef,abef->ijab', x, vvvv) via the triangle packing
    (JAX ladder.py:241).  x antisymmetric in its last two indices; the two
    leading dims need not be equal.  Also the lambda ladder (pair-swap
    symmetry)."""
    o, o2, v, _ = x.shape
    p = v * (v - 1) // 2
    yc = _packed_mm(_pack_pairs(x.reshape(o * o2, v * v), v, _row_align(x)),
                    packed, p)
    z = _unpack_pairs(yc, v).reshape(o, o2, v, v)
    return z - z.transpose(2, 3)


def stacked_packed_contract(packed, x1, x2):
    """Both per-iteration ladders (t side on tau, lambda side on l2) as one
    (2 o^2, p) x (p, p) GEMM, so the packed operand is read once per
    iteration (JAX ladder.py:274).  Returns (packed_vvvv_contract(packed,
    x1), packed_vvvv_contract(packed, x2))."""
    o, _, v, _ = x1.shape
    p = v * (v - 1) // 2
    xc = _pack_pairs(torch.cat([x1.reshape(o * o, v * v),
                                x2.reshape(o * o, v * v)]), v, _row_align(x1))
    z = _unpack_pairs(_packed_mm(xc, packed, p), v).reshape(2, o, o, v, v)
    z = z - z.transpose(-1, -2)
    return z[0], z[1]


class SectoredVVVV(NamedTuple):
    """Spin-sectored antisymmetry-packed <ab||ef> for the sorted layout.
    Row axes may be zero-padded; the column axes are exact, so the sector
    sizes (ma, mb) follow from the column counts (_sector_dims)."""
    wc_aa: torch.Tensor   # (paa, paa), paa = ma(ma-1)/2
    wc_bb: torch.Tensor   # (pbb, pbb)
    w_ab: torch.Tensor    # (ma*mb, ma*mb)

    def to(self, dtype):
        """This operand in `dtype` (or 'tf32', see _cast): cast once per
        solve (gs.py:932-933)."""
        return SectoredVVVV(*(_cast(w, dtype) for w in self))


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
        wc_aa=pack_vvvv(vvvv[:ma, :ma, :ma, :ma]).wc,
        wc_bb=pack_vvvv(vvvv[ma:, ma:, ma:, ma:]).wc,
        w_ab=vvvv[:ma, ma:, :ma, ma:].reshape(ma * mb, ma * mb).contiguous())


def _sector_inputs(x, ma):
    """The three sector column spaces of x (antisymmetric in its last two
    indices, sorted layout) as 2-D GEMM operands."""
    o, o2, v, _ = x.shape
    mb = v - ma
    M = o * o2
    align = _row_align(x)
    x_aa = _pack_pairs(x[:, :, :ma, :ma].reshape(M, ma * ma), ma, align)
    x_bb = _pack_pairs(x[:, :, ma:, ma:].reshape(M, mb * mb), mb, align)
    x_ab = x[:, :, :ma, ma:].reshape(M, ma * mb)
    return x_aa, x_bb, x_ab


def _sector_mm(xs, w, ncols):
    """One sector GEMM xs @ w.T through the Hopper kernel."""
    xs = xs.contiguous()
    y = ladder_mm(xs, w, symmetric=True, precision=_precision(xs))
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


def stacked_sectored_contract(sect, x1, x2):
    """Both per-iteration ladders as one GEMM per spin sector on the
    stacked rows of x1 and x2 (every occupied row pair; JAX ladder.py:417):
    the route of a sorted-layout solve whose amplitudes do not keep the
    balanced spin structure."""
    o, _, v, _ = x1.shape
    ma, mb = _sector_dims(sect, v)
    in1 = _sector_inputs(x1, ma)
    in2 = _sector_inputs(x2, ma)
    ncols = (ma * (ma - 1) // 2, mb * (mb - 1) // 2, ma * mb)
    ys = [_sector_mm(torch.cat([a, b]), w, n)
          for a, b, w, n in zip(in1, in2,
                                (sect.wc_aa, sect.wc_bb, sect.w_ab), ncols)]
    M = o * o
    z1 = _sector_assemble(ys[0][:M], ys[1][:M], ys[2][:M], o, ma, mb,
                          x1.dtype)
    z2 = _sector_assemble(ys[0][M:], ys[1][M:], ys[2][M:], o, ma, mb,
                          x2.dtype)
    return z1, z2


def ensure_sorted_vvvv_op(vvvv_op, eris, info):
    """The operand the sorted-layout kernels need (JAX ladder.py:342): a
    prebuilt one passes through, else the dense sorted eris.vvvv is packed
    into a SectoredVVVV (sector sizes from `info`)."""
    if vvvv_op is not None:
        return vvvv_op
    _refuse_shard_pack(eris.vvvv)
    if eris.vvvv.numel() == 0:
        raise ValueError(
            "sectored kernels need a ladder operand: eris were built with "
            "pack_ladder=True but no vvvv_op was threaded through")
    return pack_vvvv_sorted(eris.vvvv, info.va)


def apply_vvvv_op(vvvv_op, x):
    """The bare ladder of x on a non-dense route (JAX ladder.py:264)."""
    if isinstance(vvvv_op, PackedVVVV):
        return packed_vvvv_contract(vvvv_op, x)
    if isinstance(vvvv_op, SectoredVVVV):
        return sectored_vvvv_contract(vvvv_op, x)
    raise TypeError(
        f"no ladder route for a {type(vvvv_op).__name__} operand: the port "
        "takes a PackedVVVV or a SectoredVVVV (the JAX package's "
        "alternating-layout spin sectors are deliberately not ported)")


def resolve_mode(nvir):
    """config.ladder_mode with 'auto' resolved for this nvir: packed at
    nvir >= PACKED_MIN_NVIR, dense below (JAX ladder.py:569)."""
    mode = get_config().ladder_mode
    if mode == "auto":
        mode = "packed" if nvir >= PACKED_MIN_NVIR else "dense"
    return mode


def _refuse_shard_pack(vvvv):
    """Packing reads the whole vvvv: a split one is packed before it is
    split, never gathered here."""
    if isinstance(vvvv, RowShard):
        raise ValueError(
            "the dense vvvv is split over a device mesh: pack it before "
            "splitting it and pass the operand split by parallel.sharding."
            "shard_vvvv_op (vvvv_op=), as the mesh never gathers a ladder "
            "operand")


def make_vvvv_op(vvvv):
    """The ladder operand for this vvvv block per config.ladder_mode (JAX
    ladder.py:579): None for 'dense', a PackedVVVV for 'packed'."""
    if vvvv.numel() == 0:
        raise ValueError(
            "dense vvvv was not materialized (build_eris_device("
            "pack_ladder=True)); pass its PackedVVVV to the solver instead "
            "of rebuilding from eris.vvvv")
    mode = resolve_mode(vvvv.shape[0])
    if mode == "dense":
        return None
    _refuse_shard_pack(vvvv)
    if mode == "packed":
        return pack_vvvv(vvvv)
    raise ValueError(f"unknown ladder_mode {mode!r}")


def ladder_contract(eris, t1, t2, tau, vvvv_op=None, skip_quad=False,
                    L1_pre=None, Y_pre=None):
    """0.5 * einsum('ijef,abef->ijab', tau, Wvvvv) without forming Wvvvv
    (JAX ladder.py:602): the bare ladder L1, the t1.ovvv correction L2 and,
    unless skip_quad, the quadratic 0.125 tau.oovv.tau term L3 (tupdate
    applies that term itself, with its Woooo twin, at weight 0.25).

    L1_pre: the bare ladder already computed (the solver's stacked GEMM);
    else vvvv_op's route; else the dense GEMM through the kernel, the call
    site of the JAX package's Pallas kernel.  Y_pre: the tau.ovvv
    intermediate 'ijef,mbef->ijmb', when the caller has it."""
    nocc, nvir = t1.shape
    if L1_pre is not None:
        L1 = L1_pre
    elif vvvv_op is not None:
        L1 = apply_vvvv_op(vvvv_op, tau)
    else:
        L1 = 0.5 * dense_ladder(tau, eris.vvvv)

    # the P(ab) part of the t1.ovvv correction, folded into two
    # output-index-swapped contractions
    Y = Y_pre if Y_pre is not None else einsum("ijef,mbef->ijmb", tau,
                                               eris.ovvv)
    L2 = (einsum("ijmb,ma->ijab", Y, -0.5 * t1)
          + einsum("ijma,mb->ijab", Y, 0.5 * t1))
    if skip_quad:
        return L1 + L2
    X = einsum("ijef,mnef->ijmn", tau, eris.oovv)
    L3 = 0.125 * einsum("ijmn,mnab->ijab", X, tau)
    return L1 + L2 + L3


def dense_ladder(x, vvvv):
    """sum_ef x[ij,ef] vvvv[ab,ef] as one (o^2, v^2) x (v^2, v^2) GEMM
    through the kernel (no factor 0.5).  With x = l2 it is also
    sum_cd l2[ij,cd] vvvv[cd,ab] by the pair-swap symmetry <ab||cd> =
    <cd||ab>, which host-built ERIs hold to roundoff; f32 device-built
    ones to their rounding (PERF.md records max|V - V.T| on the card)."""
    o, o2, v, _ = x.shape
    if vvvv.numel() == 0:
        raise ValueError(
            "the dense ladder needs the dense vvvv, but eris carry the "
            "(nvir, 0, 0, 0) placeholder of a pack_ladder=True build: pass "
            "its ladder operand (vvvv_op)")
    # a view of vvvv as it lies, never a copy of its 60 MB-3 GB: view
    # raises where the strides do not allow one, and the kernel on a
    # non-contiguous operand.  A RowShard (vvvv split over a mesh) is
    # already its rows' GEMM view
    x2 = x.reshape(o * o2, v * v).contiguous()
    w = vvvv if isinstance(vvvv, RowShard) else vvvv.view(v * v, v * v)
    y = ladder_mm(x2, w, symmetric=True, precision=_precision(x2))
    return y.reshape(o, o2, v, v)


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
        """The row blocks aa, bb (None when sym) and ab of x, unpacked."""
        if hasattr(x, "blocks"):   # SpinBlocked operand (balanced support)
            _check_blocked(x, sym)
            r_aa = x.get((0, 0, 0, 0)).reshape(oa * oa, ma * ma)
            r_ab = x.get((0, 1, 0, 1)).reshape(oa * ob, ma * mb)
            r_bb = (None if sym else
                    x.get((1, 1, 1, 1)).reshape(ob * ob, mb * mb))
            return r_aa, r_bb, r_ab
        r_aa = x[:oa, :oa, :ma, :ma].reshape(oa * oa, ma * ma)
        r_ab = x[:oa, oa:, :ma, ma:].reshape(oa * ob, ma * mb)
        r_bb = (None if sym else
                x[oa:, oa:, ma:, ma:].reshape(ob * ob, mb * mb))
        return r_aa, r_bb, r_ab

    rls = [rows(x1)] if single else [rows(x1), rows(x2)]

    def cat(i):
        """Sector i's GEMM rows, stacked, the pair sectors packed to their
        a<b columns (into TMA-ready rows where the product needs them)."""
        r = rls[0][i] if single else torch.cat([rls[0][i], rls[1][i]])
        return r if i == 2 else _pack_pairs(r, (ma, mb)[i], _row_align(r))

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
