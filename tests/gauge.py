"""The orbital-sign gauge of two separate SCFs, for the port's parity tests.

The port and the JAX package each run their own SCF.  Their orbitals agree
only up to the sign of each column, which the eigensolver chooses, and that
choice flips when the two integral engines differ in the last bits (one
built with FMA contraction and one without, say).  Every MO-basis array
(rdm1s, targets, amplitudes, ERI blocks) carries those signs, and with two
or more excited states so does the iteration count under conv='rl'.  So a
test that compares MO-basis arrays of two SCFs compares them in one gauge:

- `orbital_signs` reads the signs from diag(C_port^T S C_jax) and fails
  unless that overlap is a signed identity, i.e. unless the SCFs differ in
  nothing but the signs;
- `flip` applies them to an MO-basis array;
- `jax_gauge` builds the port's ECW in the gauge of a JAX twin, for the
  tests whose iteration counts, warm starts or targets depend on the signs.

Energies, iteration counts and convergence texts are compared as they are.
"""

from __future__ import annotations

import contextlib

import numpy as np

GAUGE_TOL = 1e-8


def orbital_signs(C, C_ref, S, tol=GAUGE_TOL):
    """The +-1 per column that takes the orbitals C to C_ref (both (nao,
    nmo) in the AO metric S).  Fails unless C^T S C_ref is a signed
    identity to `tol`."""
    O = np.asarray(C).T @ np.asarray(S) @ np.asarray(C_ref)
    d = np.where(np.diag(O) < 0, -1.0, 1.0)
    err = np.abs(O - np.diag(d)).max()
    assert err < tol, (
        f"the two SCFs differ in more than the orbital signs: "
        f"max|C_port^T S C_jax - diag(+-1)| = {err:.3e} (limit {tol:.0e})")
    return d


def ghf_signs(ghf, ghf_ref, mol):
    """orbital_signs of two GHF objects ((2 nao, 2 nmo) coefficients with
    the AO rows stacked [alpha; beta])."""
    S = np.asarray(mol.intor("ovlp"))
    z = np.zeros_like(S)
    S_g = np.block([[S, z], [z, S]])
    return orbital_signs(ghf.mo_coeff, ghf_ref.mo_coeff, S_g)


def flip(x, d, kinds, nocc):
    """x with the signs d applied along each axis: 'o' the occupied
    orbitals, 'v' the virtuals, 'n' all of them."""
    x = np.asarray(x)
    parts = {"o": d[:nocc], "v": d[nocc:], "n": d}
    for ax, k in enumerate(kinds):
        shape = [1] * x.ndim
        shape[ax] = -1
        x = x * parts[k].reshape(shape)
    return x


@contextlib.contextmanager
def jax_gauge(ref):
    """Inside, every `ECW` of the port takes the orbital signs of `ref`, a
    JAX ECW or RHF: its RHF orbitals are flipped to ref's (orbital_signs
    checks that nothing else differs) before the GHF and the ERIs are
    built, so every MO-basis quantity of the two is comparable as it is."""
    from ecw_cc_torch.models import ecw as tecw

    ghf_cls = tecw.GHF
    C_ref = getattr(ref, "_rhf", ref).mo_coeff

    def ghf_in_gauge(mf):
        S = mf.mol.intor("ovlp")
        mf.mo_coeff = mf.mo_coeff * orbital_signs(mf.mo_coeff, C_ref, S)
        return ghf_cls(mf)

    tecw.GHF = ghf_in_gauge
    try:
        yield
    finally:
        tecw.GHF = ghf_cls
