"""Parity of the PyTorch port's dense CCSD kernels (ecw_cc_torch.ops.ccsd)
and the dense and packed ladder routes (ecw_cc_torch.ops.ladder) with the
JAX package, f64 on the CPU, on identical numpy-seeded inputs: antisymmetric
random amplitudes and a symmetric random potential in fsp (so its ov
blocks are nonzero), on H2O/6-31G and H2/6-31G.

Every function is held to its JAX twin at 1e-12 max-abs.  On the CPU the
port's ladder products run the kernel's plain version (ladder_mm_ref), the
JAX side its own CPU route (_ladder_mm_xla, an XLA dot_general), so the
launch counter must stay at 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecw_cc_tpu.models.eris import build_eris_device as j_build
from ecw_cc_tpu.ops import ccsd as jc
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_torch.kernels.ladder_mm import ladder_mm
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import ccsd as tc
from ecw_cc_torch.ops import ladder as tl

torch.set_num_threads(1)

TOL = 1e-12
F64 = dict(dtype=torch.float64, device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(out, ref, tol=TOL, what=""):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, what
    assert np.all(np.isfinite(out)), what
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol, err_msg=what)


def _asym(x):
    x = x - x.transpose(1, 0, 2, 3)
    return 0.5 * (x - x.transpose(0, 1, 3, 2))


def _system(fixture):
    mol, ghf, eris_host, eris_j = fixture
    no, nv = eris_host.nocc, eris_host.nvir
    rng = np.random.default_rng(no * 100 + nv)
    n = no + nv
    half = rng.standard_normal((n, n)) * 0.02
    fsp = np.asarray(eris_host.fock) - (half + half.T)
    amps = {k: rng.standard_normal(s) * 0.05 for k, s in
            (("t1", (no, nv)), ("l1", (no, nv)), ("r1", (no, nv)))}
    for k in ("t2", "l2", "r2"):
        amps[k] = _asym(rng.standard_normal((no, no, nv, nv)) * 0.05)
    packed_j = jl.pack_vvvv(eris_j.vvvv)
    eris_t, packed_t = from_numpy(eris_j, packed_j, **F64)
    return dict(mol=mol, ghf=ghf, ej=eris_j, et=eris_t, pj=packed_j,
                pt=packed_t, fsp=fsp, amps=amps)


@pytest.fixture(scope="module", params=["h2o_631g", "h2_631g"])
def system(request):
    return _system(request.getfixturevalue(request.param))


@pytest.fixture(scope="module")
def h2o(h2o_631g):
    return _system(h2o_631g)


def _args(s, names):
    return ([jnp.asarray(s["amps"][n]) for n in names],
            [_t(s["amps"][n]) for n in names])


@pytest.fixture(autouse=True)
def _count_launches():
    ladder_mm.launches = 0
    yield
    assert ladder_mm.launches == 0   # CPU tensors never reach the kernel


@pytest.mark.parametrize("name", ["cc_Fvv", "cc_Foo", "cc_Fov", "cc_Woooo",
                                  "cc_Wvvvv", "cc_Wovvo"])
def test_intermediates_match_jax(system, name):
    s = system
    (t1j, t2j), (t1t, t2t) = _args(s, ("t1", "t2"))
    extra_j, extra_t = [], []
    if name.startswith("cc_F"):
        extra_j, extra_t = [jnp.asarray(s["fsp"])], [_t(s["fsp"])]
    ref = getattr(jc, name)(s["ej"], t1j, t2j, *extra_j)
    out = getattr(tc, name)(s["et"], t1t, t2t, *extra_t)
    _close(out, ref, what=name)


def _route(s, route):
    """(vvvv_op JAX, vvvv_op port) of a ladder route."""
    return (None, None) if route == "dense" else (s["pj"], s["pt"])


@pytest.mark.parametrize("route", ["dense", "packed"])
@pytest.mark.parametrize("alpha", [None, 0.01])
@pytest.mark.parametrize("equation", [False, True])
def test_tupdate_matches_jax(system, equation, alpha, route):
    s = system
    (t1j, t2j), (t1t, t2t) = _args(s, ("t1", "t2"))
    opj, opt = _route(s, route)
    ref = jc.tupdate(s["ej"], t1j, t2j, jnp.asarray(s["fsp"]), alpha=alpha,
                     equation=equation, vvvv_op=opj)
    out = tc.tupdate(s["et"], t1t, t2t, _t(s["fsp"]), alpha=alpha,
                     equation=equation, vvvv_op=opt)
    for name, o, r in zip(("t1", "t2"), out, ref):
        _close(o, r, what=name)


@pytest.mark.parametrize("cheap", [False, True])
def test_linter_matches_jax(system, cheap):
    s = system
    (t1j, t2j), (t1t, t2t) = _args(s, ("t1", "t2"))
    ref = jc.Linter(s["ej"], t1j, t2j, fsp=jnp.asarray(s["fsp"]), cheap=cheap)
    out = tc.Linter(s["et"], t1t, t2t, fsp=_t(s["fsp"]), cheap=cheap)
    assert sorted(out) == sorted(ref)
    for k in ref:
        if ref[k] is None:
            assert out[k] is None and cheap and k == "wvvvo"
        else:
            _close(out[k], ref[k], what=k)


@pytest.mark.parametrize("route", ["dense", "packed"])
@pytest.mark.parametrize("alpha", [None, 0.01])
@pytest.mark.parametrize("equation", [False, True])
@pytest.mark.parametrize("energy_term", ["ref", "off"])
def test_lupdate_matches_jax(system, energy_term, equation, alpha, route):
    s = system
    ampj, ampt = _args(s, ("t1", "t2", "l1", "l2"))
    opj, opt = _route(s, route)
    ref = jc.lupdate(s["ej"], *ampj, fsp=jnp.asarray(s["fsp"]), alpha=alpha,
                     equation=equation, energy_term=energy_term,
                     vvvv_op=opj)
    out = tc.lupdate(s["et"], *ampt, fsp=_t(s["fsp"]), alpha=alpha,
                     equation=equation, energy_term=energy_term,
                     vvvv_op=opt)
    for name, o, r in zip(("l1", "l2"), out, ref):
        _close(o, r, what=name)


def test_dense_lambda_ladder_needs_the_pair_swap_symmetry(h2o):
    """The dense lambda ladder is the t ladder's NT product on l2: equal to
    JAX's 0.5*einsum('ijcd,cdab->ijab', l2, vvvv) because <ab||cd> =
    <cd||ab>, which the host ERIs hold to roundoff."""
    s = h2o
    v = s["et"].nvir
    vr = s["et"].vvvv.reshape(v * v, v * v)
    assert float((vr - vr.T).abs().max()) <= 1e-14
    l2 = s["amps"]["l2"]
    ref = 0.5 * np.einsum("ijcd,cdab->ijab", l2, np.asarray(s["ej"].vvvv))
    _close(0.5 * tl.dense_ladder(_t(l2), s["et"].vvvv), ref)


@pytest.mark.parametrize("which", ["tr_rdm1_inter", "tr_rdm1",
                                   "tr_rdm1_left"])
def test_tr_rdm1_matches_jax(system, which):
    s = system
    if which == "tr_rdm1_left":
        aj, at = _args(s, ("t1", "t2", "l1", "l2"))
        ref = jc.tr_rdm1_left(*aj)
        out = tc.tr_rdm1_left(*at)
    else:
        aj, at = _args(s, ("t1", "t2", "l1", "l2", "r1", "r2"))
        ref = getattr(jc, which)(*aj, 0.7)
        out = getattr(tc, which)(*at, 0.7)
    if which == "tr_rdm1_inter":
        assert len(out) == len(ref) == 7
        for i, (o, r) in enumerate(zip(out, ref)):
            _close(o, r, what=str(i))
    else:
        _close(out, ref)


def test_gcc_wrapper_matches_functions(h2o):
    s = h2o
    (t1, t2, l1, l2), _ = _args(s, ("t1", "t2", "l1", "l2"))
    _, (t1t, t2t, l1t, l2t) = _args(s, ("t1", "t2", "l1", "l2"))
    g = tc.GCC(s["et"])
    assert (g.nocc, g.nvir) == (s["et"].nocc, s["et"].nvir)
    fsp = _t(s["fsp"])
    for a, b in zip(g.tupdate(t1t, t2t, fsp, vvvv_op=s["pt"]),
                    tc.tupdate(s["et"], t1t, t2t, fsp, vvvv_op=s["pt"])):
        assert torch.equal(a, b)
    for a, b in zip(g.lupdate(t1t, t2t, l1t, l2t, fsp, energy_term="off"),
                    tc.lupdate(s["et"], t1t, t2t, l1t, l2t, fsp,
                               energy_term="off")):
        assert torch.equal(a, b)
    _close(g.energy(t1t, t2t, fsp),
           jc.energy(s["ej"], t1, t2, jnp.asarray(s["fsp"])))


# ---------------------------------------------------------------------------
# the ladder routes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sorted_h2o(h2o_631g):
    """H2O/6-31G in the spin-sorted layout: dense vvvv and SectoredVVVV."""
    mol, ghf, eris_host, _ = h2o_631g
    er, sect = j_build(mol, ghf, dtype="float64", pack_ladder=True,
                       sort_spin=True)
    dense = j_build(mol, ghf, dtype="float64", sort_spin=True)
    er_t, sect_t = from_numpy(dense, sect, **F64)
    return dict(ej=dense, sj=sect, et=er_t, st=sect_t)


@pytest.mark.parametrize("case", ["dense", "packed_op", "sectored_op",
                                  "skip_quad", "L1_pre", "Y_pre"])
def test_ladder_contract_matches_jax(h2o, sorted_h2o, case):
    s = sorted_h2o if case == "sectored_op" else h2o
    amps = h2o["amps"]
    t1, t2 = amps["t1"], amps["t2"]
    tau_j = jc.make_tau(jnp.asarray(t2), jnp.asarray(t1), jnp.asarray(t1))
    tau_t = tc.make_tau(_t(t2), _t(t1), _t(t1))
    kw_j, kw_t = {}, {}
    if case == "packed_op":
        kw_j, kw_t = dict(vvvv_op=s["pj"]), dict(vvvv_op=s["pt"])
    elif case == "sectored_op":
        kw_j, kw_t = dict(vvvv_op=s["sj"]), dict(vvvv_op=s["st"])
    elif case == "skip_quad":
        kw_j = kw_t = dict(skip_quad=True)
    elif case == "L1_pre":
        pre = amps["r2"]
        kw_j, kw_t = dict(L1_pre=jnp.asarray(pre)), dict(L1_pre=_t(pre))
    elif case == "Y_pre":
        pre = np.einsum("ijef,mbef->ijmb", np.asarray(tau_j),
                        np.asarray(s["ej"].ovvv))
        kw_j, kw_t = dict(Y_pre=jnp.asarray(pre)), dict(Y_pre=_t(pre))
    ref = jl.ladder_contract(s["ej"], jnp.asarray(t1), jnp.asarray(t2),
                             tau_j, **kw_j)
    out = tl.ladder_contract(s["et"], _t(t1), _t(t2), tau_t, **kw_t)
    _close(out, ref)


@pytest.mark.parametrize("o2", [None, 1])
def test_packed_vvvv_contract_matches_jax(h2o, o2):
    """Square and, as EOM-EA uses it, (nocc, 1, v, v) operands."""
    x = h2o["amps"]["t2"]
    if o2 is not None:
        x = np.ascontiguousarray(x[:, :o2])
    ref = jl.packed_vvvv_contract(h2o["pj"], jnp.asarray(x))
    out = tl.packed_vvvv_contract(h2o["pt"], _t(x))
    _close(out, ref)
    _close(tl.apply_vvvv_op(h2o["pt"], _t(x)), ref)


def test_pack_vvvv_matches_jax(h2o):
    out = tl.pack_vvvv(h2o["et"].vvvv)
    assert isinstance(out, tl.PackedVVVV)
    np.testing.assert_array_equal(out.wc.numpy(), np.asarray(h2o["pj"].wc))
    v = h2o["et"].nvir
    assert out.wc.shape == (v * (v - 1) // 2,) * 2


def test_stacked_packed_contract_matches_jax(h2o):
    a = h2o["amps"]
    ref = jl.stacked_packed_contract(h2o["pj"], jnp.asarray(a["t2"]),
                                     jnp.asarray(a["l2"]))
    out = tl.stacked_packed_contract(h2o["pt"], _t(a["t2"]), _t(a["l2"]))
    for o, r in zip(out, ref):
        _close(o, r)


def test_stacked_sectored_contract_matches_jax(h2o, sorted_h2o):
    """Every occupied row pair (amplitudes with no spin structure)."""
    s, a = sorted_h2o, h2o["amps"]
    ref = jl.stacked_sectored_contract(s["sj"], jnp.asarray(a["t2"]),
                                       jnp.asarray(a["l2"]))
    out = tl.stacked_sectored_contract(s["st"], _t(a["t2"]), _t(a["l2"]))
    for o, r in zip(out, ref):
        _close(o, r)


def test_ensure_sorted_vvvv_op(sorted_h2o, h2o_631g):
    from ecw_cc_tpu.ops import spinsect as jss

    s = sorted_h2o
    mol, ghf, eris_host, _ = h2o_631g
    perm = jl.spin_sort_perm(ghf.orbspin, eris_host.nocc)
    info = jss.sector_info(np.asarray(ghf.orbspin)[perm], eris_host.nocc)
    assert tl.ensure_sorted_vvvv_op(s["st"], None, info) is s["st"]
    out = tl.ensure_sorted_vvvv_op(None, s["et"], info)
    ref = jl.ensure_sorted_vvvv_op(None, s["ej"], info)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    placeholder = s["et"]._replace(vvvv=s["et"].vvvv.new_zeros((16, 0, 0, 0)))
    with pytest.raises(ValueError, match="no vvvv_op"):
        tl.ensure_sorted_vvvv_op(None, placeholder, info)


@pytest.mark.parametrize("mode,nvir,expect", [
    ("auto", 16, "dense"), ("auto", 48, "packed"), ("auto", 62, "packed"),
    ("dense", 162, "dense"), ("packed", 16, "packed")])
def test_resolve_mode_matches_jax(mode, nvir, expect):
    import ecw_cc_torch
    from ecw_cc_tpu import config as jcfg

    jcfg.set_config(ladder_mode=mode)      # conftest restores the JAX config
    ecw_cc_torch.set_config(ladder_mode=mode)
    try:
        assert tl.resolve_mode(nvir) == jl.resolve_mode(nvir) == expect
    finally:
        ecw_cc_torch.set_config(ladder_mode="auto")


def test_make_vvvv_op_routes(h2o):
    import ecw_cc_torch

    vvvv = h2o["et"].vvvv
    assert tl.make_vvvv_op(vvvv) is None           # auto at nvir 16: dense
    ecw_cc_torch.set_config(ladder_mode="packed")
    try:
        op = tl.make_vvvv_op(vvvv)
        assert isinstance(op, tl.PackedVVVV)
        assert torch.equal(op.wc, h2o["pt"].wc)
        with pytest.raises(ValueError, match="not materialized"):
            tl.make_vvvv_op(vvvv.new_zeros((16, 0, 0, 0)))
    finally:
        ecw_cc_torch.set_config(ladder_mode="auto")
    with pytest.raises(ValueError, match="deliberately not ported"):
        ecw_cc_torch.set_config(ladder_mode="sectors")
    with pytest.raises(ValueError, match="must be one of"):
        ecw_cc_torch.set_config(ladder_mode="fast")
    assert ecw_cc_torch.get_config().ladder_mode == "auto"
    with pytest.raises(TypeError, match="no ladder route"):
        tl.apply_vvvv_op((vvvv, vvvv, vvvv), _t(h2o["amps"]["t2"]))
    with pytest.raises(ValueError, match="placeholder"):
        tl.dense_ladder(_t(h2o["amps"]["t2"]), vvvv.new_zeros((16, 0, 0, 0)))
