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
`torch.einsum` per survivor, summed into the output blocks.

sym=True (closed-shell mirror symmetry): each block equals the block at the
alpha<->beta flipped key, so only one canonical block per mirror pair is
stored and computed.  The solver enables it only behind its gate
(is_spin_restricted + spin_flip_asymmetry of the ERIs).
"""

from __future__ import annotations

import itertools
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
