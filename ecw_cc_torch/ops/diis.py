"""On-device DIIS (Pulay mixing) as a fixed-shape ring buffer.

Port of ecw_cc_tpu/ops/diis.py (replacing pyscf.lib.diis.DIIS of the
reference solvers): `diis_update(state, x)` takes the current iterate; the
error vector is x_k - x_{k-1}; extrapolation starts once `min_space`
vectors are stored and keeps at most `space` of them (oldest evicted).

Every part of the state is a device tensor of a fixed shape, the ring's
bookkeeping (stored vectors, next write position, whether a previous
iterate exists) included, so every call issues the same launches whatever
the ring holds and reads nothing back to the host: a solver loop that
calls it can be captured once as a CUDA graph and replayed
(solvers/device_loop.py), as the JAX ring threads through a
lax.while_loop.  Rows are written unconditionally at the head (a
first-iteration row is masked out by nvec and overwritten at the same head
next call), and the Gram matrix B is updated incrementally: one
(space, n) @ (n,) product per call.  The bordered DIIS system is built at
its full size with identity padding on the unfilled slots and solved at
every call; the extrapolation is taken only once `min_space` vectors are
stored and the solve is regular and finite, decided on the device.

The history rows and B are written in place: the solver owns the state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DIISState(NamedTuple):
    xs: torch.Tensor        # (space, n)
    errs: torch.Tensor      # (space, n)
    last: torch.Tensor      # (n,)
    B: torch.Tensor         # (space, space) Gram matrix errs @ errs.T
    nvec: torch.Tensor      # () int64: stored vectors (capped at space)
    head: torch.Tensor      # () int64: next write position
    has_last: torch.Tensor  # () bool


# the fields of one lane's ring (a leading lane axis under torch.func.vmap)
# and those the lanes share (every lane pushes at every call)
LANE_FIELDS = ("xs", "errs", "last", "B")
SHARED_FIELDS = ("nvec", "head", "has_last")


def diis_init(n, space=15, *, dtype, device, lanes=None, reset=False):
    """An empty ring for vectors of n elements; lanes: a leading axis of
    that many independent rings on the LANE_FIELDS (the batched lambda
    sweep, which updates them through torch.func.vmap with the
    SHARED_FIELDS unbatched).  reset=True: every field a broadcast zero
    that holds no memory, only to be copied into a ring that lives
    elsewhere (the static state of a captured loop, solvers/
    device_loop.py) to empty it."""
    lead = () if lanes is None else (lanes,)
    zero = torch.zeros((), dtype=dtype, device=device)
    z = ((lambda *shape: zero.expand(lead + shape)) if reset else
         (lambda *shape: torch.zeros(lead + shape, dtype=dtype,
                                     device=device)))
    i0 = torch.zeros((), dtype=torch.int64, device=device)
    return DIISState(xs=z(space, n), errs=z(space, n), last=z(n),
                     B=z(space, space), nvec=i0, head=i0.clone(),
                     has_last=torch.zeros((), dtype=torch.bool,
                                          device=device))


def diis_update(state: DIISState, x, min_space=2):
    """Returns (new_state, x_extrapolated)."""
    space = state.xs.shape[0]
    x = x.to(state.xs.dtype)
    at = state.head.reshape(1)

    err = x - state.last
    push = state.has_last
    xs = state.xs.index_put_((at,), x.unsqueeze(0))
    errs = state.errs.index_put_((at,), err.unsqueeze(0))
    head = torch.where(push, (state.head + 1) % space, state.head)
    nvec = torch.where(push, (state.nvec + 1).clamp(max=space), state.nvec)

    # incremental Gram update: only the head row/column changes
    g = errs @ err
    B = state.B.index_put_((at,), g.unsqueeze(0))
    B.transpose(0, 1).index_put_((at,), g.unsqueeze(0))

    # bordered DIIS system over the valid slots, identity elsewhere
    dev, dt = B.device, B.dtype
    slot = torch.arange(space + 1, device=dev)
    valid = slot[:space] < nvec
    eye = torch.eye(space, dtype=dt, device=dev)
    Bm = torch.where(valid[:, None] & valid[None, :], B, eye)
    border = -valid.to(dt)
    Bfull = torch.cat([torch.cat([Bm, border[:, None]], dim=1),
                       torch.cat([border, border.new_zeros(1)])[None]],
                      dim=0)
    rhs = -(slot == space).to(dt)
    sol, info = torch.linalg.solve_ex(Bfull, rhs)
    c = torch.where(valid, sol[:space], torch.zeros_like(sol[:space]))
    x_ext = c @ xs
    ok = (nvec >= min_space) & (info == 0) & torch.isfinite(x_ext).all()
    x_new = torch.where(ok, x_ext, x)
    return DIISState(xs=xs, errs=errs, last=x_new, B=B, nvec=nvec,
                     head=head, has_last=torch.ones_like(push)), x_new
