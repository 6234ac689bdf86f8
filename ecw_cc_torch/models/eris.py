"""ERI blocks as torch tensors, and the move to the spin-sorted layout.

The port shares the JAX package's host ERI builder (ecw_cc_tpu.models.eris:
`ErisHost`, f64 NumPy) and its `GEris` NamedTuple, which here holds torch
tensors.  Two ways in:

  - `from_numpy(geris, sect)`: the fields of a GEris / SectoredVVVV as
    they are (NumPy arrays, `np.asarray` of JAX arrays, or an ErisHost), so
    both packages compute on identical inputs;
  - `sorted_from_host(eris_host, perm)`: the production route.  The host
    blocks (alternating alpha/beta MO order) are uploaded, permuted to the
    spin-SORTED layout (alpha first within occ and vir) with the index maps
    of ops/ladder.spin_sort_perm, and the vvvv block is packed into the
    SectoredVVVV ladder operand; the GEris keeps a (nvir, 0, 0, 0)
    placeholder for vvvv.
"""

from __future__ import annotations

import numpy as np
import torch

from ecw_cc_tpu.models.eris import GEris
from ecw_cc_torch.ops.ladder import SectoredVVVV, pack_vvvv_sorted


def _tensor(a, dtype, device):
    """A copy of array-like `a` (JAX buffers are read-only) as a tensor."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def from_numpy(geris, sect=None, *, dtype, device):
    """Torch GEris (and SectoredVVVV, when `sect` is given) from objects
    whose fields are array-like, on `device` in `dtype`."""
    eris = GEris(**{f: _tensor(getattr(geris, f), dtype, device)
                    for f in GEris._fields})
    if sect is None:
        return eris
    return eris, SectoredVVVV(*(_tensor(getattr(sect, f), dtype, device)
                                .contiguous() for f in SectoredVVVV._fields))


def sorted_from_host(eris_host, perm, *, dtype, device):
    """(GEris, SectoredVVVV) in the spin-sorted layout from a host ErisHost
    in the alternating layout.  perm: new_from_old MO permutation
    (spin_sort_perm(orbspin, nocc)); the alpha virtuals come first, so the
    sector size ma is the number of even (alpha) original virtuals."""
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
