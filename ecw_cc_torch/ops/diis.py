"""On-device DIIS (Pulay mixing) as a fixed-size ring buffer.

Port of ecw_cc_tpu/ops/diis.py (replacing pyscf.lib.diis.DIIS of the
reference solvers): `diis_update(state, x)` takes the current iterate; the
error vector is x_k - x_{k-1}; extrapolation starts once `min_space`
vectors are stored and keeps at most `space` of them (oldest evicted).

The history rows, the last iterate and the Gram matrix live on the device;
the ring bookkeeping (head, count, whether a previous iterate exists) does
not depend on the data, so it is kept as Python integers and costs no
device read.  Rows are written unconditionally (a first-iteration row is
masked out by nvec and overwritten at the same head next call), and the
Gram matrix B is updated incrementally: one (space, n) @ (n,) product per
call.  The bordered DIIS system is solved with identity padding on the
unfilled slots; a singular or non-finite solve falls back to the
un-extrapolated iterate, decided on the device.

The state is updated in place: the solver owns it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DIISState(NamedTuple):
    xs: torch.Tensor      # (space, n)
    errs: torch.Tensor    # (space, n)
    last: torch.Tensor    # (n,)
    B: torch.Tensor       # (space, space) Gram matrix errs @ errs.T
    nvec: int             # stored vectors (capped at space)
    head: int             # next write position
    has_last: bool


def diis_init(n, space=15, *, dtype, device, lanes=None):
    """An empty ring for vectors of n elements; lanes: a leading axis of
    that many independent rings (the batched lambda sweep, which updates
    them through torch.func.vmap: the bookkeeping is shared, as every
    lane pushes at every call)."""
    lead = () if lanes is None else (lanes,)
    z = lambda *shape: torch.zeros(lead + shape, dtype=dtype, device=device)
    return DIISState(xs=z(space, n), errs=z(space, n), last=z(n),
                     B=z(space, space), nvec=0, head=0, has_last=False)


def diis_update(state: DIISState, x, min_space=2):
    """Returns (new_state, x_extrapolated)."""
    space = state.xs.shape[0]
    x = x.to(state.xs.dtype)
    head = state.head

    err = x - state.last
    push = state.has_last
    xs, errs, B = state.xs, state.errs, state.B
    xs[head] = x
    errs[head] = err
    new_head = (head + 1) % space if push else head
    nvec = min(state.nvec + 1, space) if push else state.nvec

    # incremental Gram update: only the head row/column changes
    g = errs @ err
    B[head, :] = g
    B[:, head] = g

    x_new = x
    if nvec >= min_space:
        # bordered DIIS system over the valid slots (identity elsewhere)
        # allocated from B: under torch.func.vmap (one ring per lambda
        # lane) they are then batched as B is
        Bfull = B.new_zeros((space + 1, space + 1))
        Bfull[:space, :space] = torch.eye(space, dtype=B.dtype,
                                          device=B.device)
        Bfull[:nvec, :nvec] = B[:nvec, :nvec]
        Bfull[space, :nvec] = -1.0
        Bfull[:nvec, space] = -1.0
        rhs = B.new_zeros(space + 1)
        # a slice: assigning a Python number to one element of a CUDA
        # tensor copies it from the host and synchronizes the stream
        rhs[space:] = -1.0
        sol, info = torch.linalg.solve_ex(Bfull, rhs)
        x_ext = sol[:nvec] @ xs[:nvec]
        ok = (info == 0) & torch.isfinite(x_ext).all()
        x_new = torch.where(ok, x_ext, x)
    return DIISState(xs=xs, errs=errs, last=x_new, B=B, nvec=nvec,
                     head=new_head, has_last=True), x_new
