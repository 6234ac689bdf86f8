"""torch.einsum with the JAX package's dtype promotion and vmap batching.

jnp.einsum promotes mixed operands to their common dtype; torch.einsum
refuses them.  The 'bf16' precision mode relies on the promotion: its
t/lambda updates read bf16 ERI blocks and amplitudes beside an f32 (or
f64) fock, so the denominators and the terms built on the diagonal-shifted
intermediates run in f32, as in the JAX loop (ecw_cc_tpu/solvers/
gs.py:802-814).  Operands of one dtype pass through untouched.

jnp.einsum under jax.vmap contracts the lanes as one more batch index of
a dot_general.  torch.einsum under torch.func.vmap (the batched lambda
sweep, solvers/gs.Solver_CCSD.SCF_batch) is decomposed into permutes and
a bmm whose batching rule broadcasts an unbatched operand, an ERI block,
over the lanes, and cuBLAS runs the strided-batched products that result
far below its single ones: a batched iteration of 3 lanes at C2H2/cc-pVTZ
took 174 ms of device time on an H100, against 27 ms for one lane's
iteration (chip_smoke.py --profile; PERF.md).
`lane_einsum` gives the lanes of each batched operand an index letter of
their own, so that torch.einsum folds them into the rows of one product
(or, where several operands carry lanes, into one batched product),
except where cuBLAS ran that batched product far below the lanes' own
(`_lane_by_lane`): those run lane by lane.  On operands with no lanes it
is torch.einsum itself.
"""

from __future__ import annotations

import functools
import math

import torch
from torch._C import _functorch


def einsum(spec, *operands):
    dt = operands[0].dtype
    if any(o.dtype != dt for o in operands[1:]):
        dt = functools.reduce(torch.promote_types,
                              (o.dtype for o in operands))
        operands = [o.to(dt) for o in operands]
    return lane_einsum(spec, *operands)


def lane_einsum(spec, *operands):
    """torch.einsum(spec, *operands), with the lanes of operands that
    torch.func.vmap batches named in the equation (module docstring).  It
    unwraps the batched operands of the innermost vmap level and wraps the
    result again (torch._C._functorch, the calls torch.func.vmap itself
    makes): an autograd.Function's vmap rule does the same at six times the
    host cost per call, which made the cc-pVDZ loop host-bound.  With no
    torch.func transform active (every call but the batched sweep's) it
    is torch.einsum at the cost of one check."""
    if _functorch.peek_interpreter_stack() is None:
        return torch.einsum(spec, *operands)
    level = max(_functorch.maybe_get_level(o) for o in operands)
    top = [o for o in operands if _functorch.maybe_get_level(o) == level]
    if level < 0 or not all(_functorch.is_batchedtensor(o) for o in top):
        return torch.einsum(spec, *operands)
    raw, dims = [], []
    for o in operands:
        t, d = ((o, None) if _functorch.maybe_get_level(o) != level
                else _functorch._unwrap_batched(o, level))
        raw.append(t)
        dims.append(d)
    return _functorch._add_batch_dim(_lanes(spec, raw, dims), 0, level)


def _lanes(spec, operands, dims):
    """The einsum of operands whose lane axes are dims (None: no lanes),
    with the lanes first in the result."""
    if _lane_by_lane(spec, operands, dims):
        n = next(o.shape[d] for o, d in zip(operands, dims) if d is not None)
        return torch.stack([
            lane_einsum(spec, *(o if d is None else o.select(d, i)
                                for o, d in zip(operands, dims)))
            for i in range(n)])
    ins, out = spec.split("->")
    lane = next(c for c in _LETTERS if c not in spec)
    subs, ops = [], []
    for sub, o, d in zip(ins.split(","), operands, dims):
        if d is None:
            subs.append(sub)
            ops.append(o)
        else:
            subs.append(lane + sub)
            ops.append(o.movedim(d, 0))
    return lane_einsum(",".join(subs) + "->" + lane + out, *ops)


def _lane_by_lane(spec, operands, in_dims):
    """Whether the lanes of an einsum run one by one: where two operands
    carry lanes and each lane's output is smaller than its sum.  The lanes
    then form a strided-batched product, which cuBLAS ran without
    splitting the sum: 7 ms for 14 x 14 outputs over 367416 terms at
    C2H2/cc-pVTZ on an H100, against a split-K GEMM per lane in the
    sequential solve."""
    ins, out = spec.split("->")
    subs = ins.split(",")
    if sum(d is not None for d in in_dims) < 2 or "." in spec:
        return False
    size = {}
    for sub, op, d in zip(subs, operands, in_dims):
        shape = list(op.shape)
        if d is not None:
            del shape[d]
        size.update(zip(sub, shape))
    summed = math.prod(n for c, n in size.items() if c not in out)
    return math.prod(size[c] for c in out) < summed


_LETTERS = "ZYXWVUTSRQPONMLKJIHGFEDCBAzyxwvutsrqponmlkjihgfedcba"
