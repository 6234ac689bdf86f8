"""Parity of the PyTorch port's plain CCSD solve, Lambda solve, (T) energy
and CCSD(T) response density (ecw_cc_torch.ops.ccsd_t, models.gamma_exp.
solve_lambda) with the JAX package on identical f64 inputs, CPU, and the
port's own invariants: the pair loops against the full-t3 oracle, the
pairwise (T) gradient against autograd through the whole sum, the
response density against finite differences."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecw_cc_tpu.models import gamma_exp as jgexp
from ecw_cc_tpu.ops import ccsd_t as jt
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_torch.models import gamma_exp as tgexp
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import ccsd as tccsd
from ecw_cc_torch.ops import ccsd_t as tt
from ecw_cc_torch.ops import ladder as tl

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _count_calls(monkeypatch, module, name):
    """Count the calls of module.name (the JAX solvers return no iteration
    count: one call of their jitted step is one iteration)."""
    calls = [0]
    fn = getattr(module, name)

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.fixture(scope="module")
def sto3g(h2o_sto3g):
    """H2O/STO-3G: JAX ERIs, the torch copy, and the JAX CCSD amplitudes."""
    _, _, _, er = h2o_sto3g
    t1, t2, e_cc = jt.solve_ccsd(er)
    return dict(er=er, er_t=from_numpy(er, **F64), t1=t1, t2=t2, e_cc=e_cc)


@pytest.fixture(scope="module")
def sorted_631g(h2o_631g):
    """H2O/6-31G in the sorted layout: dense and sector-packed JAX ERIs,
    their torch copies, SectorInfo, and converged JAX amplitudes."""
    from test_ccsd_kernels import _sorted_system

    _, _, er, er_dense, sect, perm, info = _sorted_system(h2o_631g)
    er_t, sect_t = from_numpy(er, sect, **F64)
    t1, t2, e_cc = jt.solve_ccsd(er_dense, conv_tol=1e-11)
    return dict(er=er, er_dense=er_dense, sect=sect, info=info, er_t=er_t,
                sect_t=sect_t, er_dense_t=from_numpy(er_dense, **F64),
                t1=t1, t2=t2, e_cc=e_cc)


# ---------------------------------------------------------------------------
# solve_ccsd, solve_lambda
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("system", ["h2o_sto3g", "h2o_631g"])
def test_solve_ccsd_matches_jax(system, request, monkeypatch):
    _, _, _, er = request.getfixturevalue(system)
    calls = _count_calls(monkeypatch, jt, "_ccsd_diis_step")
    t1j, t2j, ej = jt.solve_ccsd(er)
    log = {}
    t1, t2, e = tt.solve_ccsd(from_numpy(er, **F64), log=log)
    assert log == {"iterations": calls[0], "converged": True}
    assert abs(e - ej) < 1e-10
    assert np.abs(t1.numpy() - np.asarray(t1j)).max() < 1e-9
    assert np.abs(t2.numpy() - np.asarray(t2j)).max() < 1e-9


@pytest.mark.parametrize("sym", [False, True])
def test_solve_ccsd_sect_matches_jax(sorted_631g, sym, monkeypatch):
    """The sector-blocked solve (sorted layout, SectoredVVVV operand), with
    and without the mirror symmetry, against JAX and the dense solve."""
    s = sorted_631g
    calls = _count_calls(monkeypatch, jt, "_ccsd_diis_step")
    _, t2j, ej = jt.solve_ccsd(s["er"], vvvv_op=s["sect"],
                               sect=(s["info"], sym))
    log = {}
    _, t2, e = tt.solve_ccsd(s["er_t"], vvvv_op=s["sect_t"],
                             sect=(s["info"], sym), log=log)
    assert log["iterations"] == calls[0]
    assert abs(e - ej) < 1e-10 and abs(e - s["e_cc"]) < 1e-9
    assert np.abs(t2.numpy() - np.asarray(t2j)).max() < 1e-9


def test_solve_ccsd_dense_sorted_eris_pack_their_operand(sorted_631g):
    """sect with no operand packs the dense sorted vvvv; a pack-on-build
    placeholder without its operand raises."""
    s = sorted_631g
    _, _, e = tt.solve_ccsd(s["er_dense_t"], sect=(s["info"], True))
    assert abs(e - s["e_cc"]) < 1e-9
    with pytest.raises(ValueError, match="ladder operand"):
        tt.solve_ccsd(s["er_t"], sect=(s["info"], True))
    with pytest.raises(ValueError, match="not materialized"):
        tt.solve_ccsd(s["er_t"])


def test_solve_lambda_matches_jax(sto3g, monkeypatch):
    s = sto3g
    calls = _count_calls(monkeypatch, jgexp, "_l_step")
    l1j, l2j = jgexp.solve_lambda(s["er"], s["t1"], s["t2"])
    log = {}
    l1, l2 = tgexp.solve_lambda(s["er_t"], _t(s["t1"]), _t(s["t2"]), log=log)
    assert log == {"iterations": calls[0], "converged": True}
    assert np.abs(l1.numpy() - np.asarray(l1j)).max() < 1e-9
    assert np.abs(l2.numpy() - np.asarray(l2j)).max() < 1e-9
    packed = tl.pack_vvvv(s["er_t"].vvvv)
    l1p, l2p = tgexp.solve_lambda(s["er_t"], _t(s["t1"]), _t(s["t2"]),
                                  vvvv_op=packed)
    assert (l2p - l2).abs().max() < 1e-9 and (l1p - l1).abs().max() < 1e-9


@pytest.mark.parametrize("sym", [False, True])
def test_solve_lambda_sect_matches_jax(sorted_631g, sym):
    s = sorted_631g
    sect = (s["info"], sym)
    l1j, l2j = jgexp.solve_lambda(s["er"], s["t1"], s["t2"],
                                  vvvv_op=s["sect"], sect=sect)
    l1, l2 = tgexp.solve_lambda(s["er_t"], _t(s["t1"]), _t(s["t2"]),
                                vvvv_op=s["sect_t"], sect=sect)
    assert np.abs(l1.numpy() - np.asarray(l1j)).max() < 1e-9
    assert np.abs(l2.numpy() - np.asarray(l2j)).max() < 1e-9
    rdm1 = tgexp._gamma(_t(s["t1"]), _t(s["t2"]), l1, l2, sect=sect)
    ref = jgexp._gamma_jit(s["t1"], s["t2"], l1j, l2j, sect=sect)
    assert np.abs(rdm1.numpy() - np.asarray(ref)).max() < 1e-9


# ---------------------------------------------------------------------------
# the (T) energy
# ---------------------------------------------------------------------------

def test_t_zero_for_two_electrons(h2_631g):
    """(T) vanishes identically for a 2-electron system (no triples)."""
    _, _, _, er = h2_631g
    er_t = from_numpy(er, **F64)
    t1, t2, _ = tt.solve_ccsd(er_t)
    assert abs(float(tt.energy_t(er_t, t1, t2))) < 1e-12


def test_energy_t_scan_dense_and_jax_agree(sto3g):
    """The pair loop = the full-t3 oracle = the JAX scan."""
    s = sto3g
    t1, t2 = _t(s["t1"]), _t(s["t2"])
    ref = float(jt.energy_t(s["er"], s["t1"], s["t2"]))
    e_scan = float(tt.energy_t(s["er_t"], t1, t2))
    e_dense = float(tt._energy_t_dense(s["er_t"], t1, t2))
    assert abs(e_scan - ref) < 1e-12 and abs(e_dense - ref) < 1e-12
    assert -5e-3 < e_scan < 0.0


def test_energy_t_takes_a_perturbed_fock(sto3g):
    s = sto3g
    rng = np.random.default_rng(3)
    f = np.asarray(s["er"].fock) + np.diag(rng.standard_normal(
        s["er"].fock.shape[0]) * 0.05)
    ref = float(jt.energy_t(s["er"], s["t1"], s["t2"], jnp.asarray(f)))
    out = float(tt.energy_t(s["er_t"], _t(s["t1"]), _t(s["t2"]), _t(f)))
    assert abs(out - ref) < 1e-12


def test_t3_antisymmetry(sto3g):
    s = sto3g
    t3c = tt._t3_pieces(s["er_t"], _t(s["t1"]), _t(s["t2"]), None)[0].numpy()
    ref = np.asarray(jt._t3_pieces(s["er"], s["t1"], s["t2"], None)[0])
    assert np.abs(t3c - ref).max() < 1e-12
    for perm in ((1, 0, 2, 3, 4, 5), (0, 2, 1, 3, 4, 5), (0, 1, 2, 4, 3, 5),
                 (0, 1, 2, 3, 5, 4)):
        assert np.allclose(t3c, -t3c.transpose(perm), atol=1e-10)


def _amps(info, sym, seed):
    from test_ccsd_kernels import _mirror_amps, _structured_amps

    return (_mirror_amps if sym else _structured_amps)(info, seed=seed)[:2]


@pytest.mark.parametrize("sym", [False, True])
def test_energy_t_sect_matches_dense(sorted_631g, sym):
    """The spin-sector-blocked (T) equals the dense pair loop on balanced
    amplitudes; sym=True on mirror-symmetric ones."""
    s = sorted_631g
    t1, t2 = _amps(s["info"], sym, seed=31 + sym)
    ref = float(jt.energy_t(s["er_dense"], jnp.asarray(t1), jnp.asarray(t2)))
    refj = float(jt.energy_t_sect(s["er_dense"], jnp.asarray(t1),
                                  jnp.asarray(t2), s["info"], sym=sym))
    dense = float(tt.energy_t(s["er_dense_t"], _t(t1), _t(t2)))
    for eris in (s["er_dense_t"], s["er_t"]):   # (T) never reads vvvv
        out = float(tt.energy_t(eris, _t(t1), _t(t2),
                                sect=(s["info"], sym)))
        for r in (ref, refj, dense):
            assert abs(out - r) < 1e-11 * max(1.0, abs(r))


@pytest.mark.parametrize("sym", [False, True])
def test_energy_t_bf16_slab_error_bound(sorted_631g, sym):
    """bf16 slabs with full-precision denominators and accumulation keep
    the (T) energy within the JAX package's 5e-3 relative bound."""
    s = sorted_631g
    t1, t2 = _amps(s["info"], True, seed=33)
    ref = float(tt.energy_t(s["er_dense_t"], _t(t1), _t(t2)))
    out = tt.energy_t_sect(s["er_dense_t"], _t(t1), _t(t2), s["info"],
                           sym=sym, slab_dtype="bfloat16")
    assert out.dtype == torch.float64
    assert abs(float(out) - ref) < 5e-3 * max(abs(ref), 1e-6)
    assert abs(float(out) - ref) > 1e-9 * abs(ref)   # the slabs were rounded


def test_energy_t_refuses_what_it_cannot_route(sto3g):
    s = sto3g
    t1, t2 = _t(s["t1"]), _t(s["t2"])
    with pytest.raises(ValueError, match="slab_dtype"):
        tt.energy_t(s["er_t"], t1, t2, slab_dtype="bfloat16")
    with pytest.raises(ValueError, match="requires sect"):
        tt.energy_t(s["er_t"], t1, t2, mesh=object())


@pytest.mark.parametrize("route", ["dense", "sect", "sect_sym"])
def test_energy_t_grad_pairwise_matches_autograd(sorted_631g, route):
    """energy_t_grad (one pair's graph at a time) = autograd through the
    whole sum, for every input; under sym that is the unfolded gradient."""
    s = sorted_631g
    info = s["info"]
    sect = {"dense": None, "sect": (info, False), "sect_sym": (info, True)}
    sect = sect[route]
    t1, t2 = _amps(info, True, seed=41)
    er = s["er_dense_t"]
    leaves = [_t(x).requires_grad_(True) for x in (t1, t2)]
    f = er.fock.clone().requires_grad_(True)
    e = tt.energy_t(er, *leaves, f, sect=sect)
    ref = torch.autograd.grad(e, leaves + [f])
    out = tt.energy_t_grad(er, _t(t1), _t(t2), er.fock, sect=sect)
    assert abs(float(out[0]) - float(e.detach())) < 1e-13
    nocc = info.nocc
    fdiag = torch.diagonal(ref[2])
    for got, want in zip(out[1:], (ref[0], ref[1], fdiag[:nocc],
                                   fdiag[nocc:])):
        assert (got - want).abs().max() < 1e-12
    # the dense route's gradient is the true one: sym must reproduce it
    dense = tt.energy_t_grad(er, _t(t1), _t(t2), er.fock)
    for got, want in zip(out[1:], dense[1:]):
        assert (got - want).abs().max() < 1e-11


def test_h2s_631gstar_ccsd_t_anchor():
    """H2S/6-31G* through the port's RHF, CCSD and (T): the JAX package's
    pinned energies (tests/test_scf.py)."""
    from ecw_cc_torch.models.eris import build_eris
    from ecw_cc_torch.models.molecule import Molecule
    from ecw_cc_torch.models.scf import GHF, RHF

    mol = Molecule("h2s", "6-31g*")
    mf = RHF(mol)
    assert abs(mf.kernel() - (-398.69775444)) < 1e-6
    eris = build_eris(mol, GHF(mf)).to_device(**F64)
    t1, t2, ec = tt.solve_ccsd(eris, conv_tol=1e-9)
    assert abs(ec - (-0.14214656)) < 1e-6
    assert abs(float(tt.energy_t(eris, t1, t2)) - (-0.00290457)) < 1e-6


# ---------------------------------------------------------------------------
# the mirror-symmetry gate
# ---------------------------------------------------------------------------

def test_eris_spin_restricted_matches_jax(sorted_631g, sto3g):
    s = sorted_631g
    info = s["info"]
    assert jt.eris_spin_restricted(s["er_dense"], info)
    assert tt.eris_spin_restricted(s["er_dense_t"], info)
    # pack-on-build ERIs: the gate reads the operand's packs
    assert jt.eris_spin_restricted(s["er"], info, vvvv_op=s["sect"])
    assert tt.eris_spin_restricted(s["er_t"], info, vvvv_op=s["sect_t"])
    bad = s["sect_t"]._replace(wc_bb=s["sect_t"].wc_bb * 1.001)
    assert not tt.eris_spin_restricted(s["er_t"], info, vvvv_op=bad)
    ovvv = s["er_t"].ovvv.clone()
    ovvv[0, 0, 0, 0] += 1e-6
    assert not tt.eris_spin_restricted(s["er_t"]._replace(ovvv=ovvv), info,
                                       vvvv_op=s["sect_t"])
    odd = type(info)(info.oa, info.ob, info.va + 1, info.vb - 1)
    assert not tt.eris_spin_restricted(s["er_t"], odd)
    # alternating-layout ERIs are not mirror symmetric under the sorted map
    alt = sto3g["er_t"]
    no, nv = alt.nocc, alt.nvir
    info_alt = type(info)(no // 2, no // 2, nv // 2, nv // 2)
    assert (tt.eris_spin_restricted(alt, info_alt)
            == jt.eris_spin_restricted(sto3g["er"], info_alt))


# ---------------------------------------------------------------------------
# the response density
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_t", [True, False])
def test_response_density_matches_jax(sto3g, with_t):
    s = sto3g
    ref = np.asarray(jt.ccsd_t_rdm1_response(s["er"], s["t1"], s["t2"],
                                             with_t=with_t))
    log = {}
    out = tt.ccsd_t_rdm1_response(s["er_t"], _t(s["t1"]), _t(s["t2"]),
                                  with_t=with_t, log=log)
    assert log["converged"] and 5 < log["iterations"] < 60
    assert np.abs(out.numpy() - ref).max() < 1e-8
    assert abs(float(torch.trace(out)) - s["er"].nocc) < 1e-8


def test_response_density_packed_ladder_matches_dense(sto3g):
    """A packed ladder operand gives the dense-path density: the two maps
    share the antisymmetric fixed-point branch."""
    s = sto3g
    t1, t2 = _t(s["t1"]), _t(s["t2"])
    ref = np.asarray(jt.ccsd_t_rdm1_response(
        s["er"], s["t1"], s["t2"], vvvv_op=jl.pack_vvvv(s["er"].vvvv)))
    g_d = tt.ccsd_t_rdm1_response(s["er_t"], t1, t2)
    g_p = tt.ccsd_t_rdm1_response(s["er_t"], t1, t2,
                                  vvvv_op=tl.pack_vvvv(s["er_t"].vvvv))
    assert (g_d - g_p).abs().max() < 1e-9
    assert np.abs(g_p.numpy() - ref).max() < 1e-8


def test_response_density_sect_matches_dense(sorted_631g):
    """sect=(info, True): the sector-blocked map (always sym=False) and the
    mirror-averaged sym (T) energy give the dense-path density, on dense
    sorted ERIs and on pack-on-build ones, as in the JAX package."""
    s = sorted_631g
    t1, t2 = _t(s["t1"]), _t(s["t2"])
    sect = (s["info"], True)
    ref = np.asarray(jt.ccsd_t_rdm1_response(s["er_dense"], s["t1"], s["t2"],
                                             sect=sect))
    g_dense = tt.ccsd_t_rdm1_response(s["er_dense_t"], t1, t2)
    g_sect = tt.ccsd_t_rdm1_response(s["er_dense_t"], t1, t2, sect=sect)
    g_pack = tt.ccsd_t_rdm1_response(s["er_t"], t1, t2, sect=sect,
                                     vvvv_op=s["sect_t"])
    assert (g_sect - g_dense).abs().max() < 1e-7
    assert (g_pack - g_sect).abs().max() < 1e-9
    assert np.abs(g_sect.numpy() - ref).max() < 1e-8


def test_response_density_finite_difference(sto3g):
    """The adjoint density is the derivative of the converged E_CCSD(T)
    with respect to the one-body matrix (frozen orbitals):
        Tr(gamma A) == d/de E(f + e A)  at e -> 0."""
    s = sto3g
    er = s["er_t"]
    t1, t2 = _t(s["t1"]), _t(s["t2"])
    nocc, nvir = t1.shape
    dim = nocc + nvir
    gamma = tt.ccsd_t_rdm1_response(er, t1, t2).numpy()
    rng = np.random.default_rng(5)
    A = rng.standard_normal((dim, dim)) * 0.5
    A = _t(A + A.T)
    occ = torch.diag(torch.cat([torch.ones(nocc, dtype=torch.float64),
                                torch.zeros(nvir, dtype=torch.float64)]))

    def etot(eps):
        f = er.fock + eps * A
        t1p, t2p = t1, t2
        e_old = 0.0
        for _ in range(300):   # re-solve at the perturbed f (frozen MOs)
            t1p, t2p = tccsd.tupdate(er, t1p, t2p, fsp=f)
            e_now = float(tccsd.energy(er, t1p, t2p, f))
            if abs(e_now - e_old) < 1e-12:
                break
            e_old = e_now
        return (e_now + float(tt.energy_t(er, t1p, t2p, f))
                + float((f * occ.T).sum()))

    eps = 2e-5
    deriv_fd = (etot(eps) - etot(-eps)) / (2 * eps)
    assert abs(deriv_fd - float((A.numpy() * gamma.T).sum())) < 1e-6


def test_response_density_leaves_its_inputs_alone(sto3g):
    """The adjoint runs on detached copies: amplitudes that require grad
    come back untouched and no graph outlives the call."""
    s = sto3g
    t1 = _t(s["t1"]).requires_grad_(True)
    t2 = _t(s["t2"])
    out = tt.ccsd_t_rdm1_response(s["er_t"], t1, t2, maxiter=3)
    assert not out.requires_grad and t1.grad is None
