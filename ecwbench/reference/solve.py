"""The reference's answers for one cell, worked out from the geometry and
the basis alone: the RHF energy, the CCSD(T) target (its energy and its
density in the AO basis) and, for a sweep, Ep, Delta and the last rdm1 of
every lambda.

It imports nothing of the program and takes nothing the program made.
The integrals and the SCF run in f64, as the program runs them on the
host (an SCF in float32 does not converge at these bases: the diffuse
functions make the overlap nearly singular).  The coupled-cluster work
runs in `precision`: 'f64' for the reference, 'tf32' for the control
(float32 with TF32 matmuls, the step below the float32 the
configurations state).
"""

from __future__ import annotations

import contextlib
import types

import torch

from ecwbench.reference import hf, sweep as sweep_mod, target as target_mod


@contextlib.contextmanager
def tf32(on):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def ao_r(gamma_mo, Cg):
    """A spin-orbital MO rdm1 as the spin-summed AO density: the alpha plus
    the beta block of C_g gamma C_g^T."""
    g = Cg @ gamma_mo.to(Cg.dtype) @ Cg.T
    nao = Cg.shape[0] // 2
    return g[:nao, :nao] + g[nao:, nao:]


# the thresholds of the reference (f64, far below the program's) and of
# the control, which stands in the program's place with the program's own
# f32 thresholds (ops/ccsd_t.py's defaults, the sweep's conv_thres and
# maxiter), returning what it has where they run out
TOLS = {"f64": dict(ccsd=(1e-9, 200, True), adjoint=(1e-9, 300, True),
                    sweep=(1e-8, 400, True)),
        "tf32": dict(ccsd=(1e-7, 200, False), adjoint=(1e-5, 300, False),
                     sweep=(1e-6, 80, False))}


def solve(atoms, basis, lambdas=None, device="cpu", precision="f64"):
    """Namespace: ehf, eexp, target_ao, the SCF's MO coefficients C and AO
    overlap S, and with lambdas ep, delta (one per lambda) and rdm1_ao
    (the last lambda's)."""
    tol = TOLS[precision]
    dt = torch.float64 if precision == "f64" else torch.float32
    mol = hf.Molecule(atoms, basis)
    mf = hf.rhf(mol, device)
    with tf32(precision == "tf32"):
        eris = hf.ghf_eris(mf, dtype=dt)
        Cg = eris.C_g
        del mf.eri_ao
        t1, t2, e_cc = target_mod.solve_ccsd(eris, *tol["ccsd"])
        gamma, e_t = target_mod.response_rdm1(eris, t1, t2,
                                                *tol["adjoint"])
        del t1, t2
        out = types.SimpleNamespace(ehf=mf.e_tot, eexp=mf.e_tot + e_cc + e_t,
                                    target_ao=ao_r(gamma, Cg),
                                    C=mf.mo_coeff, S=mf.S)
        if lambdas is None:
            return out
        # the target as the program's driver hands it to the sweep: the
        # AO density split evenly over the spins, back in the MO basis
        R = out.target_ao
        nao = R.shape[0]
        G = torch.zeros((2 * nao, 2 * nao), dtype=R.dtype, device=R.device)
        G[:nao, :nao] = G[nao:, nao:] = 0.5 * R
        Ci = torch.linalg.inv(Cg)
        tgt = (Ci @ G @ Ci.T).to(dt)
        res = sweep_mod.sweep(eris, tgt, lambdas, *tol["sweep"])
        out.ep = [r[0] for r in res]
        out.delta = [r[1] for r in res]
        out.rdm1_ao = ao_r(res[-1][2], Cg)
    return out
