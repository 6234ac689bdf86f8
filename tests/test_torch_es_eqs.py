"""The excited-state half of ecw_cc_torch.ops.ccs against the JAX package:
every function on the same seeded f64 inputs (CPU), the stacked-state form
of each against its one-state form, and the identities of
tests/test_es_eqs.py on the port alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_g_amp
from ecw_cc_tpu.ops import ccs as jccs
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import ccs as tccs

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
N_ES = 3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _flat(x):
    """A result (tensor, array, scalar, or a tuple of them) as one vector."""
    if isinstance(x, (tuple, list)):
        return np.concatenate([_flat(y) for y in x])
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    return np.asarray(x, dtype=np.float64).ravel()


@pytest.fixture(scope="module")
def es_inputs(h2o_631g):
    """H2O/6-31G ERIs in both packages and seeded inputs for N_ES states:
    amplitudes, non-symmetric coupling potentials, perturbed Fock
    matrices."""
    _, _, _, er = h2o_631g
    no, nv = er.nocc, er.nvir
    dim = no + nv
    rng = np.random.default_rng(23)
    fock = np.asarray(er.fock)
    states = []
    for _ in range(N_ES):
        V = rng.standard_normal((dim, dim)) * 0.02
        states.append(dict(
            rs=rng.standard_normal((no, nv)) * 0.2,
            ls=rng.standard_normal((no, nv)) * 0.2,
            r0=float(rng.standard_normal() * 0.1),
            l0=float(rng.standard_normal() * 0.1),
            Em=float(0.3 + 0.1 * rng.random()),
            vm=rng.standard_normal((dim, dim)) * 0.02,
            fsp=fock - (V + V.T)))
    return dict(er=er, er_t=from_numpy(er, **F64),
                ts=random_g_amp(rng, no, nv), ls0=random_g_amp(rng, no, nv),
                states=states, ov=(2, 3))


def _cases():
    """name -> f(m, er, to, ts, ls0, s, ov): one ES function of ops/ccs.py
    on one state's inputs s (`to` converts an array or a float)."""
    def rinter(m, er, to, ts, s):
        return m.R1inter(er, ts, to(s["fsp"]), to(s["vm"]))

    def linter(m, er, to, ts, s):
        return m.es_L1inter(er, ts, to(s["fsp"]), to(s["vm"]))

    c = {}
    c["gamma_es_CCS"] = lambda m, er, to, ts, ls0, s, ov: m.gamma_es_CCS(
        ts, to(s["ls"]), to(s["rs"]), to(s["r0"]), to(s["l0"]))
    c["gamma_tr_CCS"] = lambda m, er, to, ts, ls0, s, ov: m.gamma_tr_CCS(
        ts, to(s["ls"]), to(s["rs"]), to(s["r0"]), to(s["l0"]))
    # the two ways the solver calls it: GS bra with the state's r, and the
    # state's l with r = 0, r0 = 1
    c["gamma_tr_CCS_left"] = lambda m, er, to, ts, ls0, s, ov: \
        m.gamma_tr_CCS(ts, ls0, to(s["rs"]), to(s["r0"]), 1.0)
    c["gamma_tr_CCS_right"] = lambda m, er, to, ts, ls0, s, ov: \
        m.gamma_tr_CCS(ts, to(s["ls"]), 0.0 * ts, 1.0, to(s["l0"]))
    c["R1inter"] = lambda m, er, to, ts, ls0, s, ov: rinter(m, er, to, ts, s)
    c["R1inter_novm"] = lambda m, er, to, ts, ls0, s, ov: m.R1inter(
        er, ts, to(s["fsp"]), None)
    c["R1eq"] = lambda m, er, to, ts, ls0, s, ov: m.R1eq(
        to(s["rs"]), to(s["r0"]), rinter(m, er, to, ts, s))
    c["Extract_Em_r"] = lambda m, er, to, ts, ls0, s, ov: m.Extract_Em_r(
        er, to(s["rs"]), to(s["r0"]), rinter(m, er, to, ts, s))
    c["Extract_Em_r_ov"] = lambda m, er, to, ts, ls0, s, ov: m.Extract_Em_r(
        er, to(s["rs"]), to(s["r0"]), rinter(m, er, to, ts, s), ov=ov)[0]
    c["rsupdate"] = lambda m, er, to, ts, ls0, s, ov: m.rsupdate(
        er, to(s["rs"]), to(s["r0"]), rinter(m, er, to, ts, s), to(s["Em"]))
    c["rsupdate_all_spins"] = lambda m, er, to, ts, ls0, s, ov: m.rsupdate(
        er, to(s["rs"]), to(s["r0"]), rinter(m, er, to, ts, s), to(s["Em"]),
        force_alpha=False)
    c["get_ov"] = lambda m, er, to, ts, ls0, s, ov: m.get_ov(
        to(s["ls"]), to(s["l0"]), to(s["rs"]), to(s["r0"]), ov)
    c["R0inter"] = lambda m, er, to, ts, ls0, s, ov: m.R0inter(
        er, ts, to(s["fsp"]), to(s["vm"]))
    c["r0update"] = lambda m, er, to, ts, ls0, s, ov: m.r0update(
        to(s["rs"]), to(s["r0"]), to(s["Em"]),
        m.R0inter(er, ts, to(s["fsp"]), to(s["vm"])))
    c["R0eq"] = lambda m, er, to, ts, ls0, s, ov: m.R0eq(
        to(s["rs"]), to(s["r0"]),
        m.R0inter(er, ts, to(s["fsp"]), to(s["vm"])))
    c["r0_fromE"] = lambda m, er, to, ts, ls0, s, ov: m.r0_fromE(
        er, to(s["Em"]), ts, to(s["rs"]), to(s["vm"]), fsp=to(s["fsp"]))
    c["r0_fromE_novm"] = lambda m, er, to, ts, ls0, s, ov: m.r0_fromE(
        er, to(s["Em"]), ts, to(s["rs"]), None, fsp=to(s["fsp"]))
    c["es_L1inter"] = lambda m, er, to, ts, ls0, s, ov: linter(m, er, to, ts,
                                                               s)
    c["es_L1inter_novm"] = lambda m, er, to, ts, ls0, s, ov: m.es_L1inter(
        er, ts, to(s["fsp"]), None)
    c["es_L1eq"] = lambda m, er, to, ts, ls0, s, ov: m.es_L1eq(
        to(s["ls"]), to(s["l0"]), linter(m, er, to, ts, s))
    c["Extract_Em_l"] = lambda m, er, to, ts, ls0, s, ov: m.Extract_Em_l(
        er, to(s["ls"]), to(s["l0"]), linter(m, er, to, ts, s))
    c["Extract_Em_l_ov"] = lambda m, er, to, ts, ls0, s, ov: m.Extract_Em_l(
        er, to(s["ls"]), to(s["l0"]), linter(m, er, to, ts, s), ov=ov)[0]
    c["es_lsupdate"] = lambda m, er, to, ts, ls0, s, ov: m.es_lsupdate(
        er, to(s["ls"]), to(s["l0"]), to(s["Em"]), linter(m, er, to, ts, s))
    c["es_lsupdate_all_spins"] = lambda m, er, to, ts, ls0, s, ov: \
        m.es_lsupdate(er, to(s["ls"]), to(s["l0"]), to(s["Em"]),
                      linter(m, er, to, ts, s), force_alpha=False)
    c["L0inter"] = lambda m, er, to, ts, ls0, s, ov: m.L0inter(
        er, ts, to(s["fsp"]), to(s["vm"]))
    c["l0update"] = lambda m, er, to, ts, ls0, s, ov: m.l0update(
        to(s["ls"]), to(s["l0"]), to(s["Em"]),
        m.L0inter(er, ts, to(s["fsp"]), to(s["vm"])))
    c["L0eq"] = lambda m, er, to, ts, ls0, s, ov: m.L0eq(
        to(s["ls"]), to(s["l0"]),
        m.L0inter(er, ts, to(s["fsp"]), to(s["vm"])))
    c["l0_fromE"] = lambda m, er, to, ts, ls0, s, ov: m.l0_fromE(
        er, to(s["Em"]), ts, to(s["ls"]), to(s["vm"]), fsp=to(s["fsp"]))
    c["l0_fromE_novm"] = lambda m, er, to, ts, ls0, s, ov: m.l0_fromE(
        er, to(s["Em"]), ts, to(s["ls"]), None, fsp=to(s["fsp"]))
    return c


CASES = _cases()
# no leading state axis in these: python control flow on host scalars
HOST_ONLY = ("Extract_r0", "Extract_l0")


def _jax_to(a):
    return a if isinstance(a, float) else jnp.asarray(a)


def _torch_to(a):
    return a if isinstance(a, float) else _t(a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_es_function_matches_jax(es_inputs, name):
    k = es_inputs
    fn = CASES[name]
    for s in k["states"]:
        ref = fn(jccs, k["er"], _jax_to, jnp.asarray(k["ts"]),
                 jnp.asarray(k["ls0"]), s, k["ov"])
        out = fn(tccs, k["er_t"], _torch_to, _t(k["ts"]), _t(k["ls0"]), s,
                 k["ov"])
        ref, out = _flat(ref), _flat(out)
        assert ref.shape == out.shape and np.abs(ref).max() > 0
        assert np.abs(out - ref).max() < 1e-11 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(HOST_ONLY))
def test_extract_amplitude_matches_jax(es_inputs, name):
    k = es_inputs
    s = k["states"][0]
    # spin-adapted amplitudes, so that the largest element has a partner in
    # the quadratic's leading coefficient, and a symmetric potential
    no, nv = k["ts"].shape
    amp = random_g_amp(np.random.default_rng(5), no, nv, scale=0.3)
    vm = 0.5 * (s["vm"] + s["vm"].T)
    ref = getattr(jccs, name)(k["er"], jnp.asarray(amp),
                              jnp.asarray(k["ts"]), None, jnp.asarray(vm))
    out = getattr(tccs, name)(k["er_t"], _t(amp), _t(k["ts"]), None, _t(vm))
    assert ref != 0.0 and abs(out - ref) < 1e-10 * max(1.0, abs(ref))


@pytest.mark.parametrize("name", sorted(CASES))
def test_stacked_states_match_one_state(es_inputs, name):
    """The same function on a stack of N_ES states (leading state axis on
    every per-state argument) equals the states one by one: what the device
    solver relies on in place of jax.vmap."""
    k = es_inputs
    fn = CASES[name]
    ts, ls0 = _t(k["ts"]), _t(k["ls0"])
    one = [fn(tccs, k["er_t"], _torch_to, ts, ls0, s, k["ov"])
           for s in k["states"]]
    stacked = {key: np.stack([np.asarray(s[key]) for s in k["states"]])
               for key in k["states"][0]}
    ov = (torch.full((N_ES,), k["ov"][0]), torch.full((N_ES,), k["ov"][1]))
    out = fn(tccs, k["er_t"], _t, ts, ls0, stacked, ov)
    if not isinstance(out, (tuple, list)):
        out, one = (out,), [(o,) for o in one]
    for j, part in enumerate(out):
        part = torch.as_tensor(part)
        for i in range(N_ES):
            ref = torch.as_tensor(one[i][j])
            got = part[i] if part.dim() > ref.dim() else part
            assert got.shape == ref.shape
            assert (got - ref).abs().max() < 1e-12 * max(
                1.0, float(ref.abs().max()))


def test_gccs_wraps_the_es_functions(es_inputs):
    k = es_inputs
    cc = tccs.Gccs(k["er_t"])
    s = k["states"][0]
    ts, rs, ls, fsp, vm = (_t(k["ts"]), _t(s["rs"]), _t(s["ls"]),
                           _t(s["fsp"]), _t(s["vm"]))
    Ri = cc.R1inter(ts, fsp, vm)
    Li = cc.es_L1inter(ts, fsp, vm)
    er = k["er_t"]
    assert torch.equal(cc.R1eq(rs, 0.1, Ri), tccs.R1eq(rs, 0.1, Ri))
    assert torch.equal(cc.rsupdate(rs, 0.1, Ri, 0.4),
                       tccs.rsupdate(er, rs, 0.1, Ri, 0.4))
    assert torch.equal(cc.es_lsupdate(ls, 0.1, 0.4, Li),
                       tccs.es_lsupdate(er, ls, 0.1, 0.4, Li))
    assert torch.equal(cc.Extract_Em_r(rs, 0.1, Ri)[0],
                       tccs.Extract_Em_r(er, rs, 0.1, Ri)[0])
    assert torch.equal(cc.Extract_Em_l(ls, 0.1, Li)[0],
                       tccs.Extract_Em_l(er, ls, 0.1, Li)[0])
    assert torch.equal(cc.gamma_es(ts, ls, rs, 0.1, 0.2),
                       tccs.gamma_es_CCS(ts, ls, rs, 0.1, 0.2))
    assert torch.equal(cc.gamma_tr(ts, ls, rs, 0.1, 0.2),
                       tccs.gamma_tr_CCS(ts, ls, rs, 0.1, 0.2))
    assert torch.equal(cc.r0_fromE(0.4, ts, rs, vm, fsp),
                       tccs.r0_fromE(er, 0.4, ts, rs, vm, fsp))
    assert torch.equal(cc.l0_fromE(0.4, ts, ls, vm, fsp),
                       tccs.l0_fromE(er, 0.4, ts, ls, vm, fsp))
    assert torch.equal(cc.R0eq(rs, 0.1, cc.R0inter(ts, fsp, vm)),
                       tccs.R0eq(rs, 0.1, tccs.R0inter(er, ts, fsp, vm)))
    assert torch.equal(cc.L0eq(ls, 0.1, cc.L0inter(ts, fsp, vm)),
                       tccs.L0eq(ls, 0.1, tccs.L0inter(er, ts, fsp, vm)))
    assert cc.get_ov(ls, 0.1, rs, 0.2, (1, 2)) == tccs.get_ov(
        ls, 0.1, rs, 0.2, (1, 2))


# ---------------------------------------------------------------------------
# the identities of tests/test_es_eqs.py, on the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def system(h2o_sto3g):
    _, _, eris_host, er = h2o_sto3g
    rng = np.random.default_rng(11)
    nocc, nvir = eris_host.nocc, eris_host.nvir
    ts = _t(random_g_amp(rng, nocc, nvir, scale=0.1))
    rs = _t(random_g_amp(rng, nocc, nvir, scale=0.3))
    ls = _t(random_g_amp(rng, nocc, nvir, scale=0.3))
    dim = nocc + nvir
    vm = rng.standard_normal((dim, dim)) * 0.01
    return from_numpy(er, **F64), ts, rs, ls, _t(vm + vm.T)


def _dot(a, b):
    return float((a * b).sum())


def test_r0_consistency(system):
    """r0_fromE(Em) equals the fixed point of r0update at energy Em:
    r0 (Em - E) = F + P  (CCS.py:1081-1158)."""
    eris, ts, rs, ls, vm = system
    Em = 0.4
    Fjb, E, P = tccs.R0inter(eris, ts, None, vm)
    r0_fix = (_dot(rs, Fjb) + float(P)) / (Em - float(E))
    r0_alt = float(tccs.r0_fromE(eris, Em, ts, rs, -vm, fsp=None))
    assert abs(r0_fix - r0_alt) < 1e-10


def test_r0update_converges_to_fixed_point(system):
    eris, ts, rs, ls, vm = system
    Em = 0.4
    R0i = tccs.R0inter(eris, ts, None, vm)
    r0 = 0.1
    for _ in range(200):
        r0 = float(tccs.r0update(rs, r0, Em, R0i))
    Fjb, E, P = R0i
    assert abs(r0 * Em - (_dot(rs, Fjb) + float(P) + r0 * float(E))) < 1e-10


def test_l0_consistency(system):
    """l0_fromE(Em) equals the fixed point of l0update:
    l0 (Em - Z) = F + W + P  (CCS.py:1423-1518)."""
    eris, ts, rs, ls, vm = system
    Em = 0.4
    Fbj, Wjb, Z, P = tccs.L0inter(eris, ts, None, vm)
    l0_fix = (_dot(ls, Fbj.T) + _dot(ls, Wjb) + float(P)) / (Em - float(Z))
    l0_alt = float(tccs.l0_fromE(eris, Em, ts, ls, vm, fsp=None))
    assert abs(l0_fix - l0_alt) < 1e-9


def test_R0eq_L0eq_values(system):
    eris, ts, rs, ls, vm = system
    R0i = tccs.R0inter(eris, ts, None, vm)
    Fjb, E, P = R0i
    assert abs(float(tccs.R0eq(rs, 0.2, R0i))
               - (_dot(rs, Fjb) + 0.2 * float(E) + float(P))) < 1e-12
    L0i = tccs.L0inter(eris, ts, None, vm)
    Fbj, Wjb, Z, P2 = L0i
    assert abs(float(tccs.L0eq(ls, 0.2, L0i))
               - (_dot(ls, Fbj.T) + _dot(ls, Wjb) + 0.2 * float(Z)
                  + float(P2))) < 1e-12


def test_extract_r0_l0_quadratic(system):
    """Extract_r0/Extract_l0 solve the Em-eliminated quadratic: the returned
    amplitude must satisfy BOTH the R1(L1)-derived and R0(L0)-derived
    energies simultaneously."""
    eris, ts, rs, ls, vm = system
    r0 = tccs.Extract_r0(eris, rs, ts, None, vm)
    Fjb, E, P = tccs.R0inter(eris, ts, None, vm)
    Em_r0 = (_dot(rs, Fjb) + float(P)) / r0 + float(E)
    Em_r1, _, _ = tccs.Extract_Em_r(eris, rs, r0,
                                    tccs.R1inter(eris, ts, None, vm))
    assert abs(Em_r0 - float(Em_r1)) < 1e-8

    l0 = tccs.Extract_l0(eris, ls, ts, None, vm)
    Fbj, Wjb, Z, P0 = tccs.L0inter(eris, ts, None, vm)
    Em_l0 = (_dot(ls, Fbj.T) + _dot(ls, Wjb) + float(P0)) / l0 + float(Z)
    Em_l1, _, _ = tccs.Extract_Em_l(eris, ls, l0,
                                    tccs.es_L1inter(eris, ts, None, vm))
    assert abs(Em_l0 - float(Em_l1)) < 1e-8
