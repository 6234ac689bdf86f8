"""Antisymmetrized spin-orbital ERIs in physicists' notation, as torch tensors.

Port of ecw_cc_tpu/models/eris.py (reference Eris.py, geris class): the AO
ERI tensor is transformed to the GHF MO basis, antisymmetrized
<pq||rs> = <pq|rs> - <pq|sr>, and sliced into the 16 occ/vir blocks used by
the CC kernels.  The Fock matrix is diagonal in the canonical HF basis:
fock = diag(mo_energy).

The host half is a copy of the JAX package's (only the imports differ, and
`ErisHost.to_device` / `permute_geris` work on torch tensors): `GEris`,
`ErisHost` (f64 NumPy, the parity oracle), `build_eris`, `permute_geris`
and `warn_if_sorted_layout`.  Three ways to device tensors:

  - `build_eris_device(mol, ghf, ...)`: the production route at f32.  The
    ill-conditioned S^-1/2 half of the transform runs on the host in f64,
    the orthonormal half and the block slicing on the device; with
    pack_ladder=True the vvvv block goes slab by slab straight into the
    ladder operand, a SectoredVVVV (sort_spin=True) or a PackedVVVV;
  - `sorted_from_host(eris_host, perm)`: the host f64 blocks (alternating
    alpha/beta MO order) uploaded, permuted to the spin-SORTED layout
    (alpha first within occ and vir) and packed (the f64 parity route);
  - `from_numpy(geris, op)`: the fields of any object with GEris /
    SectoredVVVV / PackedVVVV field names (NumPy arrays, JAX arrays, an
    ErisHost) as they are, so both packages compute on identical inputs.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ecw_cc_torch.config import check_device, torch_dtype
from ecw_cc_torch.ops.ladder import (PackedVVVV, SectoredVVVV, _pack_pairs,
                                     pack_vvvv_sorted, spin_sort_perm)


class GEris(NamedTuple):
    """Antisymmetrized <pq||rs> blocks (physicists' notation), G
    spin-orbital basis: NumPy arrays on the host, tensors on a device."""
    fock: torch.Tensor   # (nmo, nmo), diagonal of mo_energy
    oooo: torch.Tensor
    ooov: torch.Tensor
    oovo: torch.Tensor
    oovv: torch.Tensor
    ovov: torch.Tensor
    ovvo: torch.Tensor
    ovvv: torch.Tensor
    ovoo: torch.Tensor
    vvvv: torch.Tensor
    vooo: torch.Tensor
    vovo: torch.Tensor
    voov: torch.Tensor
    vovv: torch.Tensor
    vvoo: torch.Tensor
    vvvo: torch.Tensor

    @property
    def nocc(self):
        return self.oooo.shape[0]

    @property
    def nvir(self):
        return self.vvvv.shape[0]


class ErisHost:
    """Host-side ERI builder + container mirroring the reference `geris` API
    (attributes .fock .oooo ... .nocc .mo_occ .EHF)."""

    def __init__(self, mol, ghf, int_thresh=1e-13, dir_cont=False):
        self.mol = mol
        self.ghf = ghf
        self.orbspin = ghf.orbspin
        nmo = ghf.mo_coeff.shape[1]
        nao = mol.nao
        nocc = int(np.sum(ghf.mo_occ > 0))

        eri_ao = mol.intor("int2e")
        mo_a = ghf.mo_coeff[:nao]
        mo_b = ghf.mo_coeff[nao:]
        if dir_cont:
            # direct contraction against the spin-blocked AO ERI with the
            # full G mo_coeff (reference Eris.py:58-94, dir_cont path)
            eri_g = np.zeros((2 * nao,) * 4)
            for sa in (0, 1):
                for sb in (0, 1):
                    eri_g[sa * nao:(sa + 1) * nao, sa * nao:(sa + 1) * nao,
                          sb * nao:(sb + 1) * nao, sb * nao:(sb + 1) * nao] = eri_ao
            mo = ghf.mo_coeff
            eri = np.einsum("pqrs,pi->iqrs", eri_g, mo, optimize=True)
            eri = np.einsum("iqrs,qj->ijrs", eri, mo, optimize=True)
            eri = np.einsum("ijrs,rk->ijks", eri, mo, optimize=True)
            eri = np.einsum("ijks,sl->ijkl", eri, mo, optimize=True)
        else:
            # AO ERI (chemists (ij|kl)) -> G-format MO (mo = mo_a + mo_b
            # summed rows, spin-forbidden elements zeroed; reference
            # Eris.py:108-120).  Quarter transforms run as explicit GEMMs
            # (contract the leading axis, cycle it to the back): ~300 GFLOP
            # in four dgemms instead of minutes of generic einsum.
            mo = np.ascontiguousarray(mo_a + mo_b)

            def quarter(t):
                n0 = t.shape[0]
                out = mo.T @ t.reshape(n0, -1)
                out = out.reshape((nmo,) + t.shape[1:])
                return np.ascontiguousarray(np.moveaxis(out, 0, -1))

            eri = eri_ao
            for _ in range(4):
                eri = quarter(eri)
            spin = self.orbspin
            forbid = spin[:, None] != spin[None, :]
            eri[forbid, :, :] = 0.0
            eri[:, :, forbid] = 0.0
        # chemists (pq|rs) -> physicists <pr|qs>, antisymmetrize
        eri = eri.transpose(0, 2, 1, 3) - eri.transpose(0, 2, 3, 1)
        if int_thresh:
            eri[np.abs(eri) < int_thresh] = 0.0

        o, v = slice(0, nocc), slice(nocc, nmo)
        self.fock = np.diag(ghf.mo_energy)
        self.oooo = eri[o, o, o, o].copy()
        self.ooov = eri[o, o, o, v].copy()
        self.oovo = eri[o, o, v, o].copy()
        self.oovv = eri[o, o, v, v].copy()
        self.ovov = eri[o, v, o, v].copy()
        self.ovvo = eri[o, v, v, o].copy()
        self.ovvv = eri[o, v, v, v].copy()
        self.ovoo = eri[o, v, o, o].copy()
        self.vvvv = eri[v, v, v, v].copy()
        self.vooo = eri[v, o, o, o].copy()
        self.vovo = eri[v, o, v, o].copy()
        self.voov = eri[v, o, o, v].copy()
        self.vovv = eri[v, o, v, v].copy()
        self.vvoo = eri[v, v, o, o].copy()
        self.vvvo = eri[v, v, v, o].copy()
        self.nocc = nocc
        self.nvir = nmo - nocc
        self.mo_occ = ghf.mo_occ
        self.mo_energy = ghf.mo_energy
        self.mo_coeff = ghf.mo_coeff
        self.EHF = ghf.e_tot
        del eri

    def to_device(self, dtype=None, device="cuda", sharding=None) -> GEris:
        """The blocks as a GEris of tensors on `device` in `dtype` (torch
        dtype or name; None = config.dtype), in the alternating layout.
        sharding: {block name: placements}, as parallel.sharding.
        eris_shardings(mesh) gives them (each carrying its mesh): a block
        named there becomes a DTensor with those placements, of which
        each rank keeps its own part."""
        er = from_numpy(self, dtype=torch_dtype(dtype), device=device)
        if not sharding:
            return er
        from ecw_cc_torch.parallel.sharding import shard_tensor

        return er._replace(**{
            k: shard_tensor(getattr(er, k), p.mesh, p)
            for k, p in sharding.items()})


def build_eris(mol, ghf, int_thresh=1e-13, dir_cont=False):
    return ErisHost(mol, ghf, int_thresh=int_thresh, dir_cont=dir_cont)


def permute_geris(eris: GEris, o_idx, v_idx, f_idx) -> GEris:
    """Apply occ/vir index maps (output_index -> input_index) to every block
    of a GEris of tensors (device gathers; one-time relayout).  f_idx is
    the combined map for the (dim, dim) fock.  Used to derive an
    alternating-layout view from a spin-sorted build (for consumers without
    sorted-layout support); a zero-size vvvv placeholder is passed
    through."""
    dev = eris.fock.device
    idx = {k: torch.as_tensor(np.asarray(i), device=dev)
           for k, i in (("o", o_idx), ("v", v_idx), ("f", f_idx))}
    fields = {}
    for name in GEris._fields:
        arr = getattr(eris, name)
        if name == "fock":
            fields[name] = arr[idx["f"]][:, idx["f"]]
            continue
        if arr.numel() == 0:
            fields[name] = arr
            continue
        for ax, kind in enumerate(name):
            arr = arr.index_select(ax, idx[kind])
        fields[name] = arr
    return GEris(**fields)


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def warn_if_sorted_layout(eris, where):
    """Warn when an eris handle that must be in the reference (alternating
    alpha/beta) MO convention looks spin-SORTED instead.

    Feeding the sorted handle to a consumer of the alternating convention
    silently scrambles the physics: the JAX package's r4 'f32 ES
    instability' (7.13 -> 9.11 eV drift) was exactly this --
    alternating-convention amplitudes iterated against sorted blocks.

    Detection is structural, on the fock diagonal of an (RHF-derived) GHF,
    checked separately on the occ and vir segments (the sorted layout
    sorts each segment alpha-block-first): alternating has equal PAIRS
    d[0::2] == d[1::2]; sorted has equal HALVES d[:m/2] == d[m/2:].  Warn
    only when the pairs test fails and the halves test passes on both
    segments (a UHF-derived GHF fails both)."""
    d = np.diag(_host(eris.fock))
    no = eris.oovv.shape[0]
    segs = [d[:no], d[no:]]
    if any(s.size < 2 or s.size % 2 for s in segs):
        return
    tol = 1e3 * np.finfo(d.dtype).eps * max(1.0, float(np.abs(d).max()))
    pairs = all(np.allclose(s[0::2], s[1::2], atol=tol) for s in segs)
    halves = all(np.allclose(s[:s.size // 2], s[s.size // 2:], atol=tol)
                 for s in segs)
    if halves and not pairs:
        warnings.warn(
            f"{where}: the eris fock diagonal looks spin-SORTED "
            "(alpha block then beta block), but this consumer expects the "
            "reference alternating convention -- pass eris in the "
            "alternating layout (permute_geris, or a host-built eris) "
            "instead of the sorted production handle",
            RuntimeWarning, stacklevel=3)


def _packed_rows_from_slab(slab4, lo, hi):
    """PackedVVVV rows from one alternating-layout <ab||ef> slab (w, v, v,
    v) whose first axis covers a = lo..hi-1: the rows (a, b) with b > a,
    their (e, f) columns packed to e < f (pair rows with a fixed leading a
    are contiguous in row-major a<b pair order).  Port of JAX eris.py:152,
    on the exact slice [lo, hi)."""
    v = slab4.shape[1]
    rows = [slab4[a - lo, a + 1:].reshape(v - a - 1, v * v)
            for a in range(lo, hi) if a + 1 < v]
    if not rows:                      # a slab holding only a = v-1
        return slab4.new_zeros((0, v * (v - 1) // 2))
    return _pack_pairs(torch.cat(rows, dim=0), v)


def _sector_rows_from_slab(slab4, lo, hi, ma):
    """Sectored ladder rows from one sorted-layout <ab||ef> slab (w, v, v, v)
    whose first axis covers a = lo..hi-1: returns (aa_rows, ab_rows,
    bb_rows), the wc_aa / w_ab / wc_bb row groups of SectoredVVVV for
    these a.  In the sorted layout every sector slice is contiguous;
    spin-forbidden blocks are never read.  (The JAX twin takes a
    start-clamped slab; here a slab is the exact slice [lo, hi).)"""
    v = slab4.shape[1]
    mb = v - ma
    aa, ab, bb = [], [], []
    for a in range(lo, hi):
        row = slab4[a - lo]
        if a < ma:
            if a + 1 < ma:
                aa.append(row[a + 1:ma, :ma, :ma].reshape(ma - a - 1, ma * ma))
            ab.append(row[ma:, :ma, ma:].reshape(mb, ma * mb))
        elif a + 1 < v:
            bb.append(row[a + 1:, ma:, ma:].reshape(v - a - 1, mb * mb))

    def cat(rows, pack_m, ncols):
        if not rows:
            return slab4.new_zeros((0, ncols))
        out = torch.cat(rows, dim=0)
        return _pack_pairs(out, pack_m) if pack_m else out

    return (cat(aa, ma, ma * (ma - 1) // 2),
            cat(ab, 0, ma * mb),
            cat(bb, mb, mb * (mb - 1) // 2))


_BLOCKS = ("oooo", "ooov", "oovo", "oovv", "ovov", "ovvo", "ovvv", "ovoo",
           "vooo", "vovo", "voov", "vovv", "vvoo", "vvvo")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_eris_device(mol, ghf, *, dtype=None, device="cuda",
                      pack_ladder=False, sort_spin=False, timings=None):
    """Build the G-format antisymmetrized ERI blocks on `device` in `dtype`
    (port of ecw_cc_tpu.models.eris.build_eris_device).

    sort_spin=True permutes the MO order by spin WITHIN the occupied and
    virtual blocks (alpha first; ops/ladder.spin_sort_perm) before the
    transform, so every block comes out in the spin-SORTED layout where
    sector slices are contiguous.  With pack_ladder=True the dense
    (v,v,v,v) block is never formed: each vvvv slab goes straight to its
    ladder rows, the GEris carries a (nvir,0,0,0) placeholder for vvvv, and
    the return value is a (GEris, op) pair: op is the SectoredVVVV with
    sort_spin=True, the PackedVVVV of the alternating layout without it
    (the peak is the same nmo^4 chemists' tensor either way).  With
    pack_ladder=False the dense GEris is returned.

    PRECISION: the transform is COMPENSATED by splitting it through the
    orthonormalized AO basis,

        mo = X U,   X = S^{-1/2}  (carries ALL the ill-conditioning),
                    U = S^{1/2} mo  (exactly orthonormal columns, |U| <= 1).

    The X half runs on the host in f64 (four nao-dimensional dgemm
    quarters); only the orthonormal-basis AO tensor is rounded to `dtype`
    and uploaded (the full nao^4 tensor: 240 MB in f32 at nao = 88), so
    rounding meets no cancellation to amplify.  The U half runs on the
    device as four matmul quarters, each contracting the leading axis
    into the back of a contiguous output (peak: one quarter's input plus
    its output, then the nmo^4 chemists' tensor).  These are plain large
    products, outside any kernel of the JAX package, so they go to
    torch.matmul, in full f32 (TF32 stays off, config.py): the f32 blocks
    match the host f64 ones to ~1e-6 even for diffuse bases.

    timings: a dict to receive the host-clock seconds of the two halves
    ('x_half_s', 'device_s'; the device is synchronized before each
    reading), or None.
    """
    dtype = torch_dtype(dtype)
    dev = check_device(device)
    t0 = time.perf_counter()
    nao = mol.nao
    nmo = ghf.mo_coeff.shape[1]
    nocc = int(np.sum(ghf.mo_occ > 0))
    nvir = nmo - nocc
    S = mol.intor("ovlp")
    w, V = np.linalg.eigh(S)
    mo_np = np.asarray(ghf.mo_coeff[:nao] + ghf.mo_coeff[nao:],
                       dtype=np.float64)
    spin_host = np.asarray(ghf.orbspin)
    mo_energy = np.asarray(ghf.mo_energy)
    ma = 0
    if sort_spin:
        perm = spin_sort_perm(spin_host, nocc)
        mo_np = np.ascontiguousarray(mo_np[:, perm])
        spin_host = spin_host[perm]
        mo_energy = mo_energy[perm]
        ma = int(np.sum(spin_host[nocc:] == 0))   # alpha virtuals, first
    Xh = (V * (w ** -0.5)) @ V.T           # S^{-1/2}
    U = ((V * (w ** 0.5)) @ V.T) @ mo_np   # S^{1/2} mo, orthonormal columns

    # X half on the host, f64 (exact where the cancellation lives).  Each
    # quarter is ONE dgemm whose output is already in cycled-contiguous
    # order.
    Corth = mol.intor("int2e")
    for _ in range(4):
        n = Corth.shape[0]
        Corth = np.ascontiguousarray(
            Corth.reshape(n, -1).T @ Xh).reshape(Corth.shape[1:] + (nao,))
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    C = torch.from_numpy(Corth.astype(np_dtype, copy=False)).to(dev)
    del Corth
    t1 = time.perf_counter()

    # U half on the device: contract the leading axis, cycle it to the back
    U_dev = torch.as_tensor(U, dtype=dtype, device=dev)
    for _ in range(4):
        n = C.shape[0]
        C = torch.matmul(C.reshape(n, -1).T, U_dev).reshape(
            C.shape[1:] + (nmo,))
    del U_dev

    # Blocks straight from the chemists' MO tensor with the per-block spin
    # mask: <pq||rs> = (pr|qs) - (ps|qr).
    spin = torch.as_tensor(spin_host, device=dev)
    allow = (spin[:, None] == spin[None, :]).to(dtype)
    sl = {"o": slice(0, nocc), "v": slice(nocc, nmo)}

    def chem(a0, a1, a2, a3):
        # a chemists' slice times its mask: allowed iff spin(axis0) ==
        # spin(axis1) and spin(axis2) == spin(axis3)
        mask = (allow[sl[a0], sl[a1]][:, :, None, None]
                * allow[sl[a2], sl[a3]][None, None, :, :])
        return C[sl[a0], sl[a1], sl[a2], sl[a3]] * mask

    blocks = {}
    for name in _BLOCKS:
        p, q, r, s = name
        blocks[name] = (chem(p, r, q, s).permute(0, 2, 1, 3)
                        - chem(p, s, q, r).permute(0, 2, 3, 1)).contiguous()

    # vvvv in slabs [lo, hi) over the first virtual index, width
    # ceil(nvir/6): bounds the transient slice/permute buffers
    width = max(1, -(-nvir // 6))
    allow_vv = allow[nocc:, nocc:]
    slabs, groups = [], ([], [], [])
    if pack_ladder and not sort_spin:
        # the PackedVVVV rows, filled slab by slab: no second copy of the
        # (p, p) operand at the end of the build
        npair = nvir * (nvir - 1) // 2
        wc = torch.empty((npair, npair), dtype=dtype, device=dev)
    for lo in range(0, nvir, width):
        hi = min(lo + width, nvir)
        t = C[nocc + lo:nocc + hi, nocc:, nocc:, nocc:]   # chemists (a,e,b,f)
        t = t * (allow_vv[lo:hi, :, None, None] * allow_vv[None, None])
        slab = t.permute(0, 2, 1, 3) - t.permute(0, 2, 3, 1)
        del t
        if pack_ladder and sort_spin:
            for g, rows in zip(groups, _sector_rows_from_slab(slab, lo, hi,
                                                              ma)):
                g.append(rows)
        elif pack_ladder:
            # the a < b pair rows of a = lo..hi-1 start after the
            # lo*v - lo(lo+1)/2 rows of the smaller a
            r0, r1 = (lo * nvir - lo * (lo + 1) // 2,
                      hi * nvir - hi * (hi + 1) // 2)
            wc[r0:r1] = _packed_rows_from_slab(slab, lo, hi)
        else:
            slabs.append(slab.contiguous())
        del slab
    del C
    blocks["fock"] = torch.as_tensor(np.diag(mo_energy), dtype=dtype,
                                     device=dev)
    if pack_ladder:
        blocks["vvvv"] = torch.zeros((nvir, 0, 0, 0), dtype=dtype, device=dev)
        if sort_spin:
            wc_aa, w_ab, wc_bb = (torch.cat(g, dim=0) for g in groups)
            op = SectoredVVVV(wc_aa=wc_aa, wc_bb=wc_bb, w_ab=w_ab)
        else:
            op = PackedVVVV(wc=wc)
        out = GEris(**blocks), op
    else:
        blocks["vvvv"] = torch.cat(slabs, dim=0)
        out = GEris(**blocks)
    if timings is not None:
        _sync(dev)
        timings["x_half_s"] = t1 - t0
        timings["device_s"] = time.perf_counter() - t1
    return out


def _tensor(a, dtype, device):
    """A copy of array-like `a` (JAX buffers are read-only) as a tensor."""
    return torch.tensor(_host(a), dtype=dtype, device=device)


def from_numpy(geris, op=None, *, dtype, device="cuda"):
    """Torch GEris (and its ladder operand, when `op` is given) from objects
    whose fields are array-like, on `device` in `dtype`.  `op` has the
    fields of a SectoredVVVV or of a PackedVVVV (a JAX one, say), and comes
    back as the port's type of the same name."""
    device = check_device(device)
    eris = GEris(**{f: _tensor(getattr(geris, f), dtype, device)
                    for f in GEris._fields})
    if op is None:
        return eris
    cls = PackedVVVV if hasattr(op, "wc") else SectoredVVVV
    return eris, cls(*(_tensor(getattr(op, f), dtype, device).contiguous()
                       for f in cls._fields))


def sorted_from_host(eris_host, perm, *, dtype, device="cuda"):
    """(GEris, SectoredVVVV) in the spin-sorted layout from a host ErisHost
    in the alternating layout.  perm: new_from_old MO permutation
    (spin_sort_perm(orbspin, nocc)); the alpha virtuals come first, so the
    sector size ma is the number of even (alpha) original virtuals."""
    device = check_device(device)
    nocc = eris_host.nocc
    perm = np.asarray(perm)
    idx = {"o": torch.as_tensor(perm[:nocc], device=device),
           "v": torch.as_tensor(perm[nocc:] - nocc, device=device)}
    orbspin = np.asarray(eris_host.orbspin)
    ma = int(np.sum(orbspin[perm[nocc:]] == 0))
    fields = {}
    vvvv_sorted = None
    for name in GEris._fields:
        arr = _tensor(getattr(eris_host, name), dtype, device)
        if name == "fock":
            p = torch.as_tensor(perm, device=device)
            fields[name] = arr[p][:, p]
            continue
        for ax, kind in enumerate(name):
            arr = arr.index_select(ax, idx[kind])
        if name == "vvvv":
            vvvv_sorted = arr
            arr = arr.new_zeros((arr.shape[0], 0, 0, 0))
        fields[name] = arr.contiguous()
    sect = pack_vvvv_sorted(vvvv_sorted, ma)
    return GEris(**fields), sect
