"""torch.einsum with the JAX package's dtype promotion.

jnp.einsum promotes mixed operands to their common dtype; torch.einsum
refuses them.  The 'bf16' precision mode relies on the promotion: its
t/lambda updates read bf16 ERI blocks and amplitudes beside an f32 (or
f64) fock, so the denominators and the terms built on the diagonal-shifted
intermediates run in f32, as in the JAX loop (ecw_cc_tpu/solvers/
gs.py:802-814).  Operands of one dtype pass through untouched.
"""

from __future__ import annotations

import functools

import torch


def einsum(spec, *operands):
    dt = operands[0].dtype
    if any(o.dtype != dt for o in operands[1:]):
        dt = functools.reduce(torch.promote_types,
                              (o.dtype for o in operands))
        operands = [o.to(dt) for o in operands]
    return torch.einsum(spec, *operands)
