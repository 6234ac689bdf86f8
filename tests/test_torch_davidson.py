"""The port's pipelined device Davidson (ecw_cc_torch.utils.linalg.
davidson_device) against the JAX package's (ecw_cc_tpu.utils.linalg.
davidson_pipelined_device), f64 on the CPU: the same cycles, theta to
1e-10 and the vectors to 1e-8 up to sign, for one and three roots, root
following, collapses of a small basis and a projector; the matvec counts,
and a basis kept across solves (`programs=`) equal to fresh solves; and
the capturability of the cycle and collapse bodies (no host read, the
same operations at every call; the precondition of their CUDA graphs),
here on dense maps with and without root following and a projector, and
with the `recorded_programs` fixture and `assert_programs_capturable` on
the EOM-EE, IP, EA and ES solves in tests/test_torch_{eom,eom_ipea,es}.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecw_cc_tpu.utils import linalg as jlin
from ecw_cc_torch.config import matmul_precision
from ecw_cc_torch.solvers import device_loop
from ecw_cc_torch.utils import linalg as tlin
from test_torch_device_loop import _Record

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


def _matrix(n=120, seed=3):
    rng = np.random.default_rng(seed)
    return np.diag(np.arange(1.0, n + 1.0)) + 0.05 * rng.standard_normal((n, n))


def _dense_case(seed, n=120):
    A = _matrix(n, seed)
    return dict(A=A, diag=np.diag(A), jmv=lambda v, ops: ops @ v,
                tmv=lambda v, ops: ops @ v, jops=jnp.asarray(A),
                tops=torch.tensor(A), jproj=None, tproj=None)


def _antisymmetric_case(m=12, seed=0):
    """X -> D.X + M X + X M on antisymmetric m x m matrices (a structural
    null space in the symmetric part, as the EOM operators' index
    antisymmetry), with the antisymmetriser as the projector."""
    rng = np.random.default_rng(seed)
    e = np.sort(rng.random(m)) * 2 + 0.3
    D = e[:, None] + e[None, :]
    M = rng.standard_normal((m, m))
    M = 0.05 * (M + M.T) / 2

    def proj(X):
        return 0.5 * (X - X.T)

    def jmv(v, ops):
        X = proj(v.reshape(m, m))
        return (ops[0] * X + ops[1] @ X + X @ ops[1]).reshape(-1)

    def guess(i, j):
        x = np.zeros((m, m))
        x[i, j], x[j, i] = 1.0, -1.0
        return x.ravel() / np.sqrt(2)

    return dict(diag=D.ravel(), jmv=jmv, tmv=jmv,
                jops=(jnp.asarray(D), jnp.asarray(M)),
                tops=(torch.tensor(D), torch.tensor(M)),
                jproj=lambda v: proj(v.reshape(m, m)).reshape(-1),
                tproj=lambda v: proj(v.reshape(m, m)).reshape(-1),
                x0=[guess(0, 1), guess(0, 2), guess(1, 2)])


# case -> (problem, keyword arguments of both solvers)
CASES = {
    "one_root": (lambda: _dense_case(3), dict(nroots=1)),
    "three_roots": (lambda: _dense_case(3), dict(nroots=3)),
    "follow": (lambda: _dense_case(5), dict(nroots=1, follow=True,
                                            start=4)),
    "collapse": (lambda: _dense_case(7), dict(nroots=1, max_space=4)),
    "collapse_three": (lambda: _dense_case(9), dict(nroots=3,
                                                    max_space=9)),
    "projector": (_antisymmetric_case, dict(nroots=3, max_space=9)),
}


def _jax_cycles(monkeypatch):
    """Count the JAX solver's cycle-program calls (its host cycles)."""
    count = [0]
    programs = jlin._pl_programs

    def counted(*args):
        init, cycle, ritz = programs(*args)

        def cycle_counted(*a):
            count[0] += 1
            return cycle(*a)

        return init, cycle_counted, ritz

    monkeypatch.setattr(jlin, "_pl_programs", counted)
    return count


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_davidson_matches_jax(monkeypatch, case):
    make, kw = CASES[case]
    p = make()
    kw = dict(kw)
    start = kw.pop("start", 0)
    nroots = kw["nroots"]
    n = p["diag"].size
    x0 = p.get("x0") or [np.eye(n)[start + k] for k in range(nroots)]
    kw.update(tol=1e-9, max_cycle=60)
    count = _jax_cycles(monkeypatch)
    conv_j, w_j, xs_j = jlin.davidson_pipelined_device(
        p["jmv"], x0, p["diag"], operands=p["jops"], project=p["jproj"],
        **kw)
    log = {}
    conv_t, w_t, xs_t = tlin.davidson_device(
        p["tmv"], x0, p["diag"], operands=p["tops"], project=p["tproj"],
        log=log, **kw, **CPU64)
    assert all(conv_j) and conv_t == conv_j
    assert log["cycles"] == count[0] > 1
    assert np.abs(np.asarray(w_t) - np.asarray(w_j)).max() < 1e-10
    for xj, xt in zip(xs_j, xs_t):
        xj, xt = np.asarray(xj), xt.numpy()
        sign = np.sign(np.dot(xj, xt))
        assert np.abs(sign * xt - xj).max() < 1e-8
    # matvecs: the guesses, nroots per cycle, and 2 nroots more per
    # collapse (the restart's, and the discarded cycle's)
    assert log["matvecs"] == (len(x0) + nroots * log["cycles"]
                              + 2 * nroots * log["collapses"])
    assert log["collapses"] > 0 or not case.startswith("collapse")
    assert log["graph"] is False and log["replays"] == 0


def test_kept_programs_equal_fresh_solves():
    """A basis kept across solves (`programs=`, SCF_diag's outer
    iterations) gives each solve what a fresh call gives, with new
    operands, guesses and diagonal copied into its buffers."""
    programs = {}
    mv = lambda v, ops: ops[0] @ v + ops[1] * v        # noqa: E731
    for seed, shift in ((3, 0.5), (4, -0.25), (5, 1.0)):
        A = _matrix(60, seed)
        ops = (torch.tensor(A), shift)
        x0 = [np.eye(60)[2]]
        diag = np.diag(A) + shift
        kw = dict(nroots=1, tol=1e-9, max_space=6, follow=True, **CPU64)
        fresh = tlin.davidson_device(mv, x0, diag, operands=ops, **kw)
        kept = tlin.davidson_device(mv, x0, diag, operands=ops,
                                    programs=programs, **kw)
        assert len(programs) == 1
        assert fresh[0] == kept[0] == [True]
        assert abs(fresh[1][0] - kept[1][0]) < 1e-13
        assert (fresh[2][0] - kept[2][0]).abs().max() < 1e-12
    tlin.release_programs(programs)
    assert not programs


# ---------------------------------------------------------------------------
# the cycle bodies are capturable
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded_programs(monkeypatch):
    """device_loop.Program's call replaced by an eager call of its body
    under a _Record: {program: [one record per call]}."""
    recs = {}

    def call(self, host=None):
        with torch.no_grad(), matmul_precision(self.mode):
            if host is not None:
                self.inputs.copy_(torch.from_numpy(
                    np.ascontiguousarray(host)).to(self.inputs.dtype))
            rec = _Record()
            with rec:
                out = self.body()
            recs.setdefault(self, []).append(rec)
            return out.numpy().copy()

    monkeypatch.setattr(device_loop.Program, "__call__", call)
    return recs


def assert_programs_capturable(recs, collapse=True):
    """Every recorded call made no host read, and each program issued the
    same operations, on the same shapes and dtypes, at every call; the
    cycle body and, with `collapse`, the collapse body were called at
    least twice."""
    calls = {False: 0, True: 0}
    for prog, rs in recs.items():
        calls[prog.body.args[0]] = max(calls[prog.body.args[0]], len(rs))
        for i, rec in enumerate(rs):
            assert not rec.host, f"call {i + 1} reads the host: " \
                                 f"{sorted(set(rec.host))}"
            assert len(rec.ops) == len(rs[0].ops), (i, len(rec.ops))
            for n, (x, y) in enumerate(zip(rs[0].ops, rec.ops)):
                assert x == y, (i, n, x, y)
    assert calls[False] >= 2 and (calls[True] >= 2 or not collapse), calls


@pytest.mark.parametrize("case", ["one_root", "follow", "collapse_three",
                                  "projector"])
def test_davidson_bodies_are_capturable(recorded_programs, case):
    make, kw = CASES[case]
    p = make()
    kw = dict(kw)
    start = kw.pop("start", 0)
    n = p["diag"].size
    x0 = p.get("x0") or [np.eye(n)[start + k] for k in range(kw["nroots"])]
    conv, _, _ = tlin.davidson_device(
        p["tmv"], x0, p["diag"], operands=p["tops"], project=p["tproj"],
        tol=1e-9, max_cycle=60, **kw, **CPU64)
    assert all(conv)
    assert_programs_capturable(recorded_programs,
                               collapse=case.startswith("collapse"))
