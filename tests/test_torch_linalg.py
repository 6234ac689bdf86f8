"""ecw_cc_torch.utils.linalg: the host helpers against their originals in
the JAX package, and both Davidson solvers against numpy.linalg.eig
(mirrors tests/test_linalg_device.py:68-134 and
tests/test_props_tdscf.py:49)."""

import numpy as np
import pytest
import torch

from ecw_cc_tpu.utils import linalg as jlin
from ecw_cc_torch.utils import linalg as tlin

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


# ---------------------------------------------------------------------------
# host helpers: copies, equal to the originals
# ---------------------------------------------------------------------------

def _amps(seed=0, n=2, no=4, nv=6):
    rng = np.random.default_rng(seed)
    rn = [rng.standard_normal((no, nv)) for _ in range(n)]
    ln = [r + 0.05 * rng.standard_normal((no, nv)) for r in rn]
    r0 = list(rng.standard_normal(n) * 0.1)
    l0 = list(rng.standard_normal(n) * 0.1)
    return rn, ln, r0, l0


def _host_cases(h2o_631g):
    mol, ghf, _, _ = h2o_631g
    rn, ln, r0, l0 = _amps()
    rng = np.random.default_rng(1)
    M = rng.standard_normal((8, 3))
    C = np.asarray(ghf.mo_coeff)
    cL = C + 0.01 * rng.standard_normal(C.shape)
    nocc = int(np.sum(np.asarray(ghf.mo_occ) > 0))
    rdm1 = np.diag(np.asarray(ghf.mo_occ, float)) \
        + 0.01 * rng.standard_normal((C.shape[1],) * 2)
    t1 = rng.standard_normal((4, 6)) * 0.1
    fsp = rng.standard_normal((10, 10))
    oovv = rng.standard_normal((4, 4, 6, 6))
    r2 = [rng.standard_normal((4, 4, 6, 6)) for _ in rn]
    mo_e = np.asarray(ghf.mo_energy)
    rs_g = np.random.default_rng(2).standard_normal((nocc, len(mo_e) - nocc))
    return {
        "get_norm": lambda m: m.get_norm(rn[0], ln[0], r0[0], l0[0]),
        "ortho_QR": lambda m: m.ortho_QR(M),
        "ortho_SVD_mol": lambda m: m.ortho_SVD(mol, cL, C),
        "ortho_SVD_ovlp": lambda m: m.ortho_SVD(mol.intor("ovlp"), cL, C),
        "ortho_GS": lambda m: m.ortho_GS(M),
        "check_ortho": lambda m: m.check_ortho(rn, ln, r0, l0),
        "ortho_es": lambda m: m.ortho_es(rn, ln, r0, l0),
        "biortho_es": lambda m: m.biortho_es(rn[0], ln[0], r0[0], l0[0]),
        "ortho_norm": lambda m: m.ortho_norm(rn, ln, r0, l0),
        "ortho_norm_no_ortho": lambda m: m.ortho_norm(rn, ln, r0, l0,
                                                      ortho=False),
        "check_spin": lambda m: m.check_spin(rn[0], ln[0]),
        "spin_square": lambda m: m.spin_square(rdm1, C, mol.intor("ovlp")),
        "koopman_init_guess": lambda m: m.koopman_init_guess(
            mo_e, ghf.mo_occ, (2, 0)),
        "koopman_init_guess_core": lambda m: m.koopman_init_guess(
            mo_e, ghf.mo_occ, (1, 1), koop_idx=[1, 0]),
        "get_DE": lambda m: m.get_DE(mo_e, rs_g),
        "tdm_slater": lambda m: m.tdm_slater(cL, C, np.asarray(ghf.mo_occ,
                                                               float)),
        "EOM_r0": lambda m: m.EOM_r0([0.3, 0.4], t1, rn, fsp, oovv, r2=r2),
    }


HOST_NAMES = ["get_norm", "ortho_QR", "ortho_SVD_mol", "ortho_SVD_ovlp",
              "ortho_GS", "check_ortho", "ortho_es", "biortho_es",
              "ortho_norm", "ortho_norm_no_ortho", "check_spin",
              "spin_square", "koopman_init_guess", "koopman_init_guess_core",
              "get_DE", "tdm_slater", "EOM_r0"]


def _flat(x):
    if isinstance(x, (tuple, list)):
        return np.concatenate([_flat(y) for y in x]) if len(x) else np.zeros(0)
    return np.asarray(x, dtype=np.float64).ravel()


@pytest.mark.parametrize("name", HOST_NAMES)
def test_host_helper_matches_jax_package(h2o_631g, name):
    fn = _host_cases(h2o_631g)[name]
    ref, out = _flat(fn(jlin)), _flat(fn(tlin))
    assert ref.shape == out.shape and ref.size > 0
    assert np.abs(out - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


def test_koopman_guess_rejects_bad_input(h2o_631g):
    _, ghf, _, _ = h2o_631g
    with pytest.raises(ValueError, match="Koopman indices"):
        tlin.koopman_init_guess(ghf.mo_energy, ghf.mo_occ, (2, 0),
                                koop_idx=[0])
    with pytest.raises(ValueError, match="same"):
        tlin.get_norm(np.zeros((2, 3)), np.zeros((3, 2)), 0.0, 0.0)


# ---------------------------------------------------------------------------
# the Davidson solvers
# ---------------------------------------------------------------------------

def _test_matrix(n=120, seed=3):
    rng = np.random.default_rng(seed)
    return np.diag(np.arange(1.0, n + 1.0)) + 0.05 * rng.standard_normal((n, n))


def test_davidson_nosym():
    rng = np.random.default_rng(3)
    n = 60
    A = np.diag(np.arange(1.0, n + 1)) + 0.01 * rng.standard_normal((n, n))
    x0 = [np.eye(n)[0], np.eye(n)[1]]
    conv, w, xs = tlin.davidson_nosym(lambda v: A @ v, x0, np.diag(A),
                                      nroots=2, tol=1e-9)
    w_exact = np.sort(np.linalg.eigvals(A).real)[:2]
    assert np.allclose(np.sort(w), w_exact, atol=1e-7)
    assert all(conv)
    # and it is the JAX package's solver, step for step
    conv_j, w_j, xs_j = jlin.davidson_nosym(lambda v: A @ v, x0, np.diag(A),
                                            nroots=2, tol=1e-9)
    assert np.array_equal(w, w_j)
    assert all(np.array_equal(a, b) for a, b in zip(xs, xs_j))


def test_davidson_names_are_one_solver():
    assert tlin.davidson_nosym_device is tlin.davidson_device
    assert tlin.davidson_pipelined_device is tlin.davidson_device
    assert not hasattr(tlin, "davidson_fused_device")


@pytest.mark.parametrize("nroots", [1, 3])
def test_device_davidson_matches_host_and_eig(nroots):
    A = _test_matrix()
    n = A.shape[0]
    diag = np.diag(A)
    x0 = [np.eye(n)[k] for k in range(nroots)]
    ops = torch.tensor(A)

    def mv(v, ops):
        return ops @ v

    conv_h, w_h, xs_h = tlin.davidson_nosym(
        lambda v: A @ v, x0, diag, nroots=nroots, tol=1e-9)
    conv_d, w_d, xs_d = tlin.davidson_device(
        mv, x0, diag, nroots=nroots, tol=1e-9, operands=ops, **CPU64)
    assert all(conv_h[:nroots]) and all(conv_d[:nroots])
    assert np.allclose(w_d[:nroots], w_h[:nroots], atol=1e-8)
    w_all = np.sort(np.linalg.eigvals(A).real)
    assert np.abs(w_d - w_all[:nroots]).max() < 1e-9
    for k in range(nroots):
        assert isinstance(xs_d[k], torch.Tensor)
        xd, xh = xs_d[k].numpy(), np.asarray(xs_h[k])
        assert abs(abs(np.dot(xd, xh)) - 1.0) < 1e-6
        assert np.linalg.norm(A @ xd - w_d[k] * xd) < 1e-8


def test_device_davidson_takes_tensors_and_their_device():
    """With tensors given, the subspace lives where they live and in their
    dtype; no device argument is needed."""
    A = _test_matrix(n=40)
    At = torch.tensor(A, dtype=torch.float32)
    conv, w, xs = tlin.davidson_device(
        lambda v: At @ v, [torch.eye(40, dtype=torch.float32)[0]],
        torch.tensor(np.diag(A), dtype=torch.float32), tol=1e-4)
    assert conv[0] and xs[0].dtype == torch.float32
    assert xs[0].device.type == "cpu"
    assert abs(w[0] - np.sort(np.linalg.eigvals(A).real)[0]) < 1e-4
    if not torch.cuda.is_available():
        # NumPy inputs and no device given: the card, which is absent here
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlin.davidson_device(lambda v: v, [np.eye(40)[0]], np.diag(A))


def test_device_davidson_follow_mode():
    """Root homing: seed on the 5th-lowest diagonal; follow=True must stay
    on that root instead of falling to the ground state."""
    A = _test_matrix(seed=5)
    n = A.shape[0]
    ops = torch.tensor(A)
    mv = lambda v, ops: ops @ v
    x0 = [np.eye(n)[4]]
    conv, w, xs = tlin.davidson_device(
        mv, x0, np.diag(A), nroots=1, tol=1e-9, follow=True, operands=ops,
        **CPU64)
    w_all = np.sort(np.linalg.eigvals(A).real)
    assert conv[0] and abs(w[0] - w_all[4]) < 1e-7
    # and WITHOUT follow it finds the lowest
    conv2, w2, _ = tlin.davidson_device(
        mv, x0, np.diag(A), nroots=1, tol=1e-9, follow=False, operands=ops,
        **CPU64)
    assert conv2[0] and abs(w2[0] - w_all[0]) < 1e-7
    # the guesses to follow may differ from the start vectors
    conv3, w3, _ = tlin.davidson_device(
        mv, [np.eye(n)[4] + 0.1 * np.eye(n)[5]], np.diag(A), nroots=1,
        tol=1e-9, follow=True, guesses=[np.eye(n)[5]], operands=ops, **CPU64)
    assert conv3[0] and abs(w3[0] - w_all[5]) < 1e-7


def test_device_davidson_restart():
    """max_space smaller than the cycles needed forces the collapse path."""
    A = _test_matrix(seed=7)
    n = A.shape[0]
    ops = torch.tensor(A)
    conv, w, xs = tlin.davidson_device(
        lambda v, ops: ops @ v, [np.eye(n)[0]], np.diag(A), nroots=1,
        tol=1e-9, max_space=5, operands=ops, **CPU64)
    w_all = np.sort(np.linalg.eigvals(A).real)
    assert conv[0] and abs(w[0] - w_all[0]) < 1e-7


def test_device_davidson_rejects_bad_guesses():
    A = _test_matrix(n=10)
    mv = lambda v: torch.tensor(A) @ v
    with pytest.raises(ValueError, match="no independent"):
        tlin.davidson_device(mv, [np.zeros(10)], np.diag(A), **CPU64)
    with pytest.raises(ValueError, match="max_space"):
        tlin.davidson_device(mv, [np.eye(10)[i] for i in range(4)],
                             np.diag(A), max_space=3, **CPU64)


def _antisymmetric_problem(m=24, seed=0, dtype=torch.float32):
    """X -> D.X + M X + X M on m x m matrices, restricted to antisymmetric
    X: the operator annihilates the symmetric part of its input, so that
    part is a structural null space with eigenvalue 0, as index
    antisymmetry is for the EOM operators.  Returns (matvec, projector,
    diagonal, guesses, the lowest three physical roots)."""
    rng = np.random.default_rng(seed)
    e = np.sort(rng.random(m)) * 2 + 0.3
    D = e[:, None] + e[None, :]
    M = rng.standard_normal((m, m))
    M = 0.05 * (M + M.T) / 2
    eye = np.eye(m)
    K = np.diag(D.ravel()) + np.kron(M, eye) + np.kron(eye, M)
    T = np.zeros((m * m, m * m))
    for i in range(m):
        for j in range(m):
            T[i * m + j, j * m + i] = 1.0
    w = np.linalg.eigvals(K @ (0.5 * (np.eye(m * m) - T))).real
    w = np.sort(w[np.abs(w) > 1e-8])
    Dt, Mt = torch.tensor(D, dtype=dtype), torch.tensor(M, dtype=dtype)

    def project(v):
        X = v.reshape(m, m)
        return (0.5 * (X - X.T)).reshape(-1)

    def matvec(v):
        X = project(v).reshape(m, m)
        return (Dt * X + Mt @ X + X @ Mt).reshape(-1)

    def guess(i, j):
        x = np.zeros((m, m))
        x[i, j], x[j, i] = 1.0, -1.0
        return x.ravel() / np.sqrt(2)

    # each physical root appears once in the antisymmetric subspace
    roots = []
    for x in w:
        if not roots or abs(x - roots[-1]) > 1e-9:
            roots.append(x)
    return (matvec, project, D.ravel(),
            [guess(0, 1), guess(0, 2), guess(1, 2)], np.array(roots[:3]))


def test_f32_davidson_needs_the_projector():
    """Without `project`, roundoff of an f32 matvec gathers in the
    operator's null space, gets normalised into the basis and converges as
    a spurious ~0 lowest root.  With it, the three physical roots come
    out."""
    matvec, project, diag, x0, roots = _antisymmetric_problem()
    kw = dict(nroots=3, tol=1e-5, max_cycle=100, max_space=12, device="cpu",
              dtype=torch.float32)
    conv, w, _ = tlin.davidson_device(matvec, x0, diag, project=project, **kw)
    assert all(conv) and np.abs(w - roots).max() < 1e-5
    conv_bad, w_bad, _ = tlin.davidson_device(matvec, x0, diag, **kw)
    assert abs(w_bad[0]) < 1e-5 < roots[0]      # the spurious root


def test_f64_davidson_with_projector():
    matvec, project, diag, x0, roots = _antisymmetric_problem(
        dtype=torch.float64)
    conv, w, xs = tlin.davidson_device(
        matvec, x0, diag, nroots=3, tol=1e-9, max_cycle=100, max_space=12,
        project=project, **CPU64)
    assert all(conv) and np.abs(w - roots).max() < 1e-9
    for x in xs:                                 # stays in range(P)
        assert torch.linalg.norm(project(x) - x) < 1e-12
