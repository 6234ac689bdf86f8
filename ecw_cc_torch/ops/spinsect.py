"""Spin-sector-blocked einsum for the spin-SORTED MO layout.

Port of ecw_cc_tpu/ops/spinsect.py.  Every G-format tensor of an
RHF-derived GHF reference with a spin-free Hamiltonian is spin-block
sparse: an element is nonzero only when the spin multiset of its first
index half equals that of its second half (<pq||rs>, t2[ijab]; t1[ia]:
s_i = s_a).  In the sorted layout (alpha first within occ and vir) every
spin block is a contiguous slice, so a contraction of such tensors splits
into a few dense sub-block contractions.

`SpinBlocked` holds only the nonzero blocks; `sector_einsum` enumerates the
spin assignments compatible with every operand's stored blocks and runs one
`torch.einsum` per survivor, summed into the output blocks.  `SectorGemm`
runs a two-operand contraction whose one operand is fixed (an ERI block of
a solve) as one matrix product per output block instead, the survivors'
contraction axes concatenated, against that operand laid out once (the
JAX package's soup_gemm='kconcat'; ops/ccsd_sect.SoupPlan builds them).

sym=True (closed-shell mirror symmetry): each block equals the block at the
alpha<->beta flipped key, so only one canonical block per mirror pair is
stored and computed.  The solver enables it only behind its gate
(is_spin_restricted + spin_flip_asymmetry of the ERIs).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from ecw_cc_torch.ops import promote
from ecw_cc_torch.utils.metrics import span


class SectorInfo(NamedTuple):
    """Alpha/beta block sizes of the sorted layout (alpha first)."""
    oa: int
    ob: int
    va: int
    vb: int

    @property
    def nocc(self):
        return self.oa + self.ob

    @property
    def nvir(self):
        return self.va + self.vb


def sector_info(orbspin_sorted, nocc) -> SectorInfo:
    """Sector sizes from the 0/1 spin labels of the sorted MO order."""
    s = np.asarray(orbspin_sorted)
    return SectorInfo(int(np.sum(s[:nocc] == 0)), int(np.sum(s[:nocc] == 1)),
                      int(np.sum(s[nocc:] == 0)), int(np.sum(s[nocc:] == 1)))


def _slices(info):
    return {
        ("o", 0): slice(0, info.oa), ("o", 1): slice(info.oa, info.nocc),
        ("v", 0): slice(0, info.va), ("v", 1): slice(info.va, info.nvir),
    }


def _balanced(spins):
    """The spin multiset of the first index half equals that of the second."""
    h = len(spins) // 2
    return sorted(spins[:h]) == sorted(spins[h:])


def _flip(key):
    """The global alpha<->beta mirror of a spin key."""
    return tuple(1 - s for s in key)


def _is_canon(key):
    """Canonical representative of a mirror pair."""
    return key <= _flip(key)


class SpinBlocked:
    """A spin-sector-blocked tensor in the sorted layout.

    kinds: 'o'/'v' per axis; blocks: {key: tensor} with key a tuple of
    0 (alpha) / 1 (beta) per axis; only the nonzero blocks are stored.
    sym=True: only the canonical block of each mirror pair is stored and
    `get(flip(key))` returns the same tensor."""

    __slots__ = ("kinds", "blocks", "info", "sym")

    def __init__(self, kinds, blocks, info, sym=False):
        self.kinds = kinds
        self.blocks = blocks
        self.info = info
        self.sym = sym

    def get(self, key):
        """The block at `key`, honouring the mirror identity when sym."""
        val = self.blocks.get(key)
        if val is None and self.sym:
            val = self.blocks.get(_flip(key))
        return val

    @classmethod
    def from_dense(cls, arr, kinds, info, support=None, sym=False):
        """Views of the nonzero blocks of a dense sorted-layout tensor.
        support: keys to keep (default: every balanced key).  sym: keep only
        canonical keys (the mirrored content is trusted equal)."""
        sl = _slices(info)
        if support is None:
            support = [k for k in itertools.product((0, 1), repeat=len(kinds))
                       if _balanced(k)]
        if sym:
            support = sorted({k if _is_canon(k) else _flip(k)
                              for k in support})
        blocks = {}
        for key in support:
            sub = arr[tuple(sl[(kind, s)] for kind, s in zip(kinds, key))]
            if sub.numel():
                blocks[key] = sub
        return cls(kinds, blocks, info, sym=sym)

    def dense(self, dtype=None):
        """The dense sorted-layout tensor (zeros elsewhere; sym tensors write
        each canonical block at its mirror key too)."""
        info = self.info
        dim_of = {"o": info.nocc, "v": info.nvir}
        shape = tuple(dim_of[k] for k in self.kinds)
        some = next(iter(self.blocks.values()), None)
        if some is None:
            raise ValueError("SpinBlocked.dense(): no stored blocks to take "
                             "a device and dtype from")
        # allocated from a stored block, so that under torch.func.vmap
        # (the batched lambda sweep) the result is batched as the blocks are
        res = some.new_zeros(shape, dtype=dtype or some.dtype)
        sl = _slices(info)
        for key, val in self.blocks.items():
            keys = ((key,) if not self.sym or _flip(key) == key
                    else (key, _flip(key)))
            for k2 in keys:
                res[tuple(sl[(k, s)] for k, s in zip(self.kinds, k2))] = val
        return res

    def scale(self, c):
        return SpinBlocked(self.kinds,
                           {k: c * v for k, v in self.blocks.items()},
                           self.info, sym=self.sym)

    def __add__(self, other):
        if self.kinds != other.kinds:
            raise ValueError(f"kinds differ: {self.kinds} vs {other.kinds}")
        if self.sym != other.sym:
            raise ValueError("mixed sym/non-sym SpinBlocked addition is "
                             "ambiguous; wrap both with the same sym flag")
        blocks = dict(self.blocks)
        for k, v in other.blocks.items():
            blocks[k] = blocks[k] + v if k in blocks else v
        return SpinBlocked(self.kinds, blocks, self.info, sym=self.sym)

    def transpose(self, *perm):
        kinds = "".join(self.kinds[p] for p in perm)
        blocks = {}
        for k, v in self.blocks.items():
            key = tuple(k[p] for p in perm)
            if self.sym and not _is_canon(key):
                key = _flip(key)   # the same content lives at the mirror key
            blocks[key] = v.permute(*perm)
        return SpinBlocked(kinds, blocks, self.info, sym=self.sym)


def wrap(arr, kinds, info, sym=False):
    """SpinBlocked view of a primitive (balanced-halves) sorted tensor."""
    return SpinBlocked.from_dense(arr, kinds, info, sym=sym)


def mirror_dense(arr, kinds, info):
    """The global alpha<->beta mirror M of a dense sorted-layout tensor
    (equal sector sizes): swaps the alpha and beta slabs along every axis.
    M is an involution; a tensor is closed-shell mirror-symmetric iff
    M(arr) == arr."""
    if info.oa != info.ob or info.va != info.vb:
        raise ValueError(f"mirror_dense needs equal alpha/beta sector sizes "
                         f"(got {info})")
    po = torch.cat([torch.arange(info.oa, info.nocc),
                    torch.arange(0, info.oa)]).to(arr.device)
    pv = torch.cat([torch.arange(info.va, info.nvir),
                    torch.arange(0, info.va)]).to(arr.device)
    for ax, k in enumerate(kinds):
        arr = arr.index_select(ax, po if k == "o" else pv)
    return arr


def sliced_support(kinds_full, fixed):
    """Support of a balanced-halves tensor after fixing some axes at known
    spins: (kinds of the remaining axes, [keys completing a balanced full
    key]).  fixed: {axis_index: spin}."""
    n = len(kinds_full)
    rem = [a for a in range(n) if a not in fixed]
    support = []
    for combo in itertools.product((0, 1), repeat=len(rem)):
        full = [0] * n
        for a, s in fixed.items():
            full[a] = s
        for a, s in zip(rem, combo):
            full[a] = s
        if _balanced(tuple(full)):
            support.append(combo)
    return "".join(kinds_full[a] for a in rem), support


def sector_einsum(spec, *operands, info=None):
    """einsum over SpinBlocked operands -> SpinBlocked output.

    One dense `torch.einsum` per spin assignment that every operand stores,
    summed into the output blocks; each is a span named
    'ops.sector_einsum.<spec>.<spins of the sorted index letters>'.  When every operand is sym, mirrored
    output keys are skipped (their content equals the canonical block); a
    scalar output keeps one assignment of each mirror pair and doubles it."""
    ins, out = spec.split("->")
    in_specs = ins.split(",")
    if len(in_specs) != len(operands):
        raise ValueError(f"{spec}: {len(operands)} operands")
    info = info or operands[0].info
    sym = all(op.sym for op in operands)
    kind_of = {}
    for op, sub in zip(operands, in_specs):
        if len(sub) != len(op.kinds):
            raise ValueError(f"{spec}: {sub} vs kinds {op.kinds}")
        for letter, kind in zip(sub, op.kinds):
            if kind_of.setdefault(letter, kind) != kind:
                raise ValueError(f"{spec}: index {letter} is both o and v")
    letters = sorted(kind_of)
    # operands of mixed dtypes (a bf16 amplitude beside an f32 fock-shifted
    # block under 'bf16') promote, as in the JAX package
    dtypes = {next(iter(op.blocks.values())).dtype for op in operands
              if op.blocks}
    einsum = promote.einsum if len(dtypes) > 1 else promote.lane_einsum

    out_blocks = {}
    for combo in itertools.product((0, 1), repeat=len(letters)):
        sp = dict(zip(letters, combo))
        okey = tuple(sp[c] for c in out)
        if sym and (not _is_canon(okey) if out else not _is_canon(combo)):
            continue   # the mirror assignment produces the mirror block
        subs = []
        for op, sub in zip(operands, in_specs):
            val = op.get(tuple(sp[c] for c in sub))
            if val is None:
                break
            subs.append(val)
        else:
            with span(f"ops.sector_einsum.{spec}."
                      f"{''.join(map(str, combo))}"):
                val = einsum(spec, *subs)
            out_blocks[okey] = (out_blocks[okey] + val if okey in out_blocks
                                else val)
    if sym and not out:
        out_blocks = {k: v + v for k, v in out_blocks.items()}
    out_kinds = "".join(kind_of[c] for c in out)
    return SpinBlocked(out_kinds, out_blocks, info, sym=sym)


def gemm_letters(spec, pos):
    """The letters of a two-operand spec as one GEMM against its operand
    `pos`: (m, k, n), m the other operand's free letters and n operand
    pos's, both in the output's order, k the contracted letters in the
    other operand's order.  None where the spec is no plain product: a
    letter repeated within a subscript, or one kept in the output or summed
    within one operand while the other also has it."""
    ins, out = spec.split("->")
    subs = ins.split(",")
    fixed, other = subs[pos], subs[1 - pos]
    if any(len(set(s)) != len(s) for s in (fixed, other, out)):
        return None
    k = [c for c in other if c in fixed and c not in out]
    m = [c for c in out if c in other and c not in fixed]
    n = [c for c in out if c in fixed and c not in other]
    if (len(m) + len(k) != len(other) or len(n) + len(k) != len(fixed)
            or len(m) + len(n) != len(out)):
        return None
    return m, k, n


class _Block(NamedTuple):
    """One output block of a SectorGemm.  fixed: the fixed operand's blocks
    of every spin assignment that feeds it laid out as one GEMM operand,
    (K, N), or (N, K) when the product is taken transposed, their
    contracted sizes concatenated along K in enumeration order (while the
    gemm is built: the key of the layout in its FixedLayouts); segs: where
    each assignment's block of the other operand goes in the (M, K)
    operand, (key, k0, k1, view shape)."""
    okey: tuple
    name: str
    fixed: object
    segs: tuple
    mk: tuple          # (M, K)
    shape: tuple       # the product's shape, its letters split
    out_perm: tuple    # from the product's letter order to the output's


@functools.lru_cache(maxsize=None)
def _gemm_structure(spec, pos, f_kinds, f_keys, f_sym, other, info):
    """What a SectorGemm computes, without tensors: (trans, the other
    operand's permutation, the output's kinds, sym, blocks), each block an
    _Block whose `fixed` is (the fixed operand's keys, f_perm, nshape,
    their cshapes), in sector_einsum's enumeration order of the spin
    assignments that every operand stores."""
    m, k, n = gemm_letters(spec, pos)
    ins, out = spec.split("->")
    subs = ins.split(",")
    f_sub, o_sub = subs[pos], subs[1 - pos]
    o_kinds, o_keys, o_sym = other
    kind_of = dict(zip(f_sub, f_kinds))
    kind_of.update(zip(o_sub, o_kinds))
    size_of = {("o", 0): info.oa, ("o", 1): info.ob,
               ("v", 0): info.va, ("v", 1): info.vb}
    sym = f_sym and o_sym
    # the product taken transposed when the output leads with the fixed
    # operand's letters, so that it comes out in the output's order
    trans = bool(out) and out[0] in n
    res = n + m if trans else m + n
    out_perm = tuple(res.index(c) for c in out)
    f_perm = tuple(f_sub.index(c) for c in (n + k if trans else k + n))
    groups = {}
    for combo in itertools.product((0, 1), repeat=len(kind_of)):
        sp = dict(zip(sorted(kind_of), combo))
        okey = tuple(sp[c] for c in out)
        if sym and (not _is_canon(okey) if out else not _is_canon(combo)):
            continue   # the mirror assignment produces the mirror block
        o_key = tuple(sp[c] for c in o_sub)
        f_key = tuple(sp[c] for c in f_sub)
        if (o_key in o_keys or o_sym and _flip(o_key) in o_keys) and (
                f_key in f_keys or f_sym and _flip(f_key) in f_keys):
            groups.setdefault(okey, []).append((combo, sp, o_key, f_key))
    size = lambda sp, letters: tuple(size_of[(kind_of[c], sp[c])]
                                     for c in letters)
    blocks = []
    for okey, members in groups.items():
        mshape, nshape = size(members[0][1], m), size(members[0][1], n)
        segs, k0 = [], 0
        for _, sp, o_key, _ in members:
            k1 = k0 + math.prod(size(sp, k))
            segs.append((o_key, k0, k1, mshape + size(sp, k)))
            k0 = k1
        blocks.append(_Block(
            okey, "".join(map(str, members[0][0])),
            (tuple(f for *_, f in members), f_perm, nshape,
             tuple(size(sp, k) for _, sp, _, _ in members)),
            tuple(segs), (math.prod(mshape), k0),
            (nshape + mshape) if trans else (mshape + nshape),
            None if out_perm == tuple(range(len(out))) else out_perm))
    return (trans, tuple(o_sub.index(c) for c in m + k),
            "".join(kind_of[c] for c in out), sym, tuple(blocks))


class FixedLayouts:
    """The laid-out operands of SectorGemms, held in one buffer: each gemm
    reserves its layouts as it is built (equal layouts of one fixed block
    once), build() allocates the buffer, copies every fixed block into
    place and hands each gemm its operands."""

    def __init__(self):
        self._want, self._gemms = {}, []
        self.nbytes = 0

    def reserve(self, fixed, trans, lay):
        """The key of the layout `lay` (_gemm_structure's) of `fixed`."""
        f_keys, f_perm, nshape, cshapes = lay
        blocks = tuple(fixed.get(f) for f in f_keys)
        key = (id(fixed), trans, f_perm, len(nshape), tuple(map(id, blocks)))
        if key not in self._want:
            self._want[key] = (trans, f_perm, nshape, cshapes, blocks)
        return key

    def build(self):
        """Allocate, fill, and bind the reserved layouts to their gemms."""
        sizes = {key: math.prod(w[2]) * sum(map(math.prod, w[3]))
                 for key, w in self._want.items()}
        some = next(iter(self._want.values()), None)
        if some is None:
            return
        flat = some[4][0].new_empty(sum(sizes.values()))
        self.nbytes = flat.numel() * flat.element_size()
        lays, off = {}, 0
        for key, (trans, f_perm, nshape, cshapes, blocks) in (
                self._want.items()):
            nn, kk = math.prod(nshape), sizes[key] // math.prod(nshape)
            lay = flat[off:off + sizes[key]].view((nn, kk) if trans
                                                  else (kk, nn))
            off += sizes[key]
            k0 = 0
            for blk, cshape in zip(blocks, cshapes):
                k1 = k0 + math.prod(cshape)
                dst = (lay[:, k0:k1].view(nshape + cshape) if trans
                       else lay[k0:k1].view(cshape + nshape))
                dst.copy_(blk.permute(f_perm))
                k0 = k1
            lays[key] = lay
        for gemm in self._gemms:
            gemm.blocks = tuple(b._replace(fixed=lays[b.fixed])
                                for b in gemm.blocks)
        self._want, self._gemms = {}, []


class SectorGemm:
    """A two-operand sector contraction whose operand `pos` is fixed for
    the life of the object (an ERI block of a solve): what sector_einsum
    computes as one dense einsum per spin assignment, summed into the
    output blocks, done as ONE matrix product per output block against an
    operand laid out once (the JAX package's soup_gemm='kconcat',
    ops/gemm.gemm_einsum_sum, on loop-invariant layouts like its
    SoupViews).  Usable once `layouts.build()` has run.

    Per call the other operand's blocks of a block's assignments are copied
    side by side into one (M, K) operand (none copied where one assignment
    feeds the block and its block is already a matrix view), and the
    product's view in the output's letter order is the output block.  The
    same products and sums as sector_einsum; within an output block the
    sum runs in another order.

    other: (kinds, stored keys, sym) of the operand it will be called with,
    which fixes the assignments; a call with an operand stored otherwise
    returns None (the caller runs sector_einsum)."""

    def __init__(self, spec, fixed, pos, other, layouts):
        self.spec, self.info, self.other = spec, fixed.info, other
        (self.trans, self.o_perm, self.out_kinds, self.sym,
         blocks) = _gemm_structure(spec, pos, fixed.kinds,
                                   frozenset(fixed.blocks), fixed.sym,
                                   other, fixed.info)
        self.blocks = tuple(b._replace(fixed=layouts.reserve(
            fixed, self.trans, b.fixed)) for b in blocks)
        layouts._gemms.append(self)

    def __call__(self, other):
        """The contraction with `other`, a SpinBlocked; None where it is not
        stored as this object was built for."""
        o_kinds, o_keys, o_sym = self.other
        if (other.sym != o_sym or other.kinds != o_kinds
                or other.info != self.info or other.blocks.keys() != o_keys):
            return None
        out_blocks = {}
        for b in self.blocks:
            with span(f"ops.sector_einsum.{self.spec}.{b.name}"):
                if len(b.segs) == 1:
                    a = (other.get(b.segs[0][0]).permute(self.o_perm)
                         .reshape(b.mk))
                else:
                    a = b.fixed.new_empty(b.mk)
                    for key, k0, k1, shape in b.segs:
                        a[:, k0:k1].view(shape).copy_(
                            other.get(key).permute(self.o_perm))
                c = (torch.mm(b.fixed, a.t()) if self.trans
                     else torch.mm(a, b.fixed))
                val = c.view(b.shape)
                if b.out_perm is not None:
                    val = val.permute(b.out_perm)
                if self.sym and not self.out_kinds:
                    val = val + val
            out_blocks[b.okey] = val
        return SpinBlocked(self.out_kinds, out_blocks, self.info,
                           sym=self.sym)


def _pack_keys(kinds, sym):
    """Canonical balanced keys in deterministic order (the pack layout)."""
    keys = [k for k in itertools.product((0, 1), repeat=len(kinds))
            if _balanced(k) and (not sym or _is_canon(k))]
    return sorted(keys)


def pack_balanced(arr, kinds, info, sym=False):
    """The balanced (canonical when sym) blocks of a sorted-layout tensor,
    flattened into one vector; everything outside them is dropped."""
    sl = _slices(info)
    return torch.cat([arr[tuple(sl[(k, s)] for k, s in zip(kinds, key))]
                      .reshape(-1) for key in _pack_keys(kinds, sym)])


def _block_shape(kinds, key, info):
    size_of = {("o", 0): info.oa, ("o", 1): info.ob,
               ("v", 0): info.va, ("v", 1): info.vb}
    return tuple(size_of[(k, s)] for k, s in zip(kinds, key))


def unpack_balanced(flat, kinds, info, sym=False):
    """Inverse of pack_balanced: the dense sorted-layout tensor."""
    blocks = {}
    off = 0
    for key in _pack_keys(kinds, sym):
        shape = _block_shape(kinds, key, info)
        n = int(np.prod(shape))
        blocks[key] = flat[off:off + n].reshape(shape)
        off += n
    return SpinBlocked(kinds, blocks, info, sym=sym).dense(dtype=flat.dtype)


def packed_size(kinds, info, sym=False):
    """Element count of pack_balanced's output."""
    return sum(int(np.prod(_block_shape(kinds, key, info)))
               for key in _pack_keys(kinds, sym))


def div_eijab(sb, diag_oo, diag_vv):
    """Per-block division of an 'oovv' SpinBlocked tensor by the orbital
    denominator e_ijab, on the stored blocks only (same add/sub order as
    the dense x / (eia[:,None,:,None] + eia[None,:,None,:]))."""
    if sb.kinds != "oovv":
        raise ValueError(f"div_eijab takes an 'oovv' tensor, got {sb.kinds}")
    sl = _slices(sb.info)
    blocks = {}
    for key, val in sb.blocks.items():
        ei_a = (diag_oo[sl[("o", key[0])]][:, None]
                - diag_vv[sl[("v", key[2])]][None, :])
        ej_b = (diag_oo[sl[("o", key[1])]][:, None]
                - diag_vv[sl[("v", key[3])]][None, :])
        blocks[key] = val / (ei_a[:, None, :, None] + ej_b[None, :, None, :])
    return SpinBlocked(sb.kinds, blocks, sb.info, sym=sb.sym)


def spin_flip_asymmetry(arr, kinds, info):
    """max|block[key] - block[flip(key)]| over the balanced canonical keys:
    0 iff the tensor is exactly closed-shell mirror symmetric (a device
    scalar; inf when the sector sizes differ)."""
    if info.oa != info.ob or info.va != info.vb:
        return torch.tensor(float("inf"), dtype=arr.dtype, device=arr.device)
    sl = _slices(info)
    worst = torch.zeros((), dtype=arr.dtype, device=arr.device)
    for key in itertools.product((0, 1), repeat=len(kinds)):
        if not _balanced(key) or not _is_canon(key):
            continue
        idx = tuple(sl[(k, s)] for k, s in zip(kinds, key))
        mid = tuple(sl[(k, 1 - s)] for k, s in zip(kinds, key))
        diff = (arr[idx] - arr[mid]).abs()
        if diff.numel():
            worst = torch.maximum(worst, diff.max())
    return worst


def is_spin_restricted(mat, info, tol=0.0):
    """True if a (dim, dim) sorted-layout matrix is spin-block-diagonal and
    its alpha-alpha block equals its beta-beta block.  Host-side."""
    if info.oa != info.ob or info.va != info.vb:
        return False
    if not is_block_diagonal(mat, info, tol=tol):
        return False
    m = np.asarray(mat)
    oa, no, va = info.oa, info.nocc, info.va
    a_idx = np.concatenate([np.arange(0, oa), no + np.arange(0, va)])
    b_idx = np.concatenate([np.arange(oa, no), no + va + np.arange(0, va)])
    diff = m[np.ix_(a_idx, a_idx)] - m[np.ix_(b_idx, b_idx)]
    return float(np.max(np.abs(diff), initial=0.0)) <= tol


def is_block_diagonal(mat, info, tol=0.0):
    """True if a (dim, dim) sorted-layout matrix has no alpha-beta coupling
    (the condition under which the sectored soup is exact).  Host-side."""
    m = np.asarray(mat)
    n = info.nocc + info.nvir
    spin = np.zeros(n, dtype=int)
    spin[info.oa:info.nocc] = 1
    spin[info.nocc + info.va:] = 1
    off = m[spin[:, None] != spin[None, :]]
    return float(np.max(np.abs(off), initial=0.0)) <= tol
