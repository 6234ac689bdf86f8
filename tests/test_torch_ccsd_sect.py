"""Parity of the PyTorch port's sector-blocked CCSD kernels
(ecw_cc_torch.ops.ccsd_sect with ops.ccsd.gamma_CCSD) with the JAX package
on identical f64 inputs, CPU: rdm1, t update and lambda update at the MP2
guess and at random seeded amplitudes, with and without the closed-shell
mirror symmetry, with the stacked blocked ladder as the solver runs it."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecw_cc_tpu.models.eris import build_eris_device
from ecw_cc_tpu.ops import ccsd as jccsd
from ecw_cc_tpu.ops import ccsd_sect as jcs
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_tpu.ops import spinsect as jss
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import ccsd as tccsd
from ecw_cc_torch.ops import ccsd_sect as tcs
from ecw_cc_torch.ops import ladder as tl
from ecw_cc_torch.ops import spinsect as tss

torch.set_num_threads(1)

TOL = 1e-11


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def system(h2o_631g):
    mol, ghf, eris_host, _ = h2o_631g
    nocc = eris_host.nocc
    er, sect = build_eris_device(mol, ghf, dtype="float64",
                                 pack_ladder=True, sort_spin=True)
    perm = jl.spin_sort_perm(ghf.orbspin, nocc)
    info = jss.sector_info(np.asarray(ghf.orbspin)[perm], nocc)
    er_t, sect_t = from_numpy(er, sect, dtype=torch.float64, device="cpu")
    # a spin-restricted symmetric potential, so fsp has ov blocks
    rng = np.random.default_rng(2)
    n = info.nocc + info.nvir
    a = np.r_[np.arange(info.oa), info.nocc + np.arange(info.va)]
    b = np.r_[info.oa + np.arange(info.ob),
              info.nocc + info.va + np.arange(info.vb)]
    half = rng.standard_normal((len(a), len(a))) * 0.02
    V = np.zeros((n, n))
    V[np.ix_(a, a)] = V[np.ix_(b, b)] = half + half.T
    fsp = np.asarray(er.fock) - V
    return dict(er=er, sect=sect, er_t=er_t, sect_t=sect_t, info=info,
                fsp=fsp, mol=mol, ghf=ghf)


def _amps(system, kind, sym):
    info, er = system["info"], system["er"]
    no = info.nocc
    if kind == "mp2":
        d = np.diag(np.asarray(er.fock))
        eia = d[:no, None] - d[None, no:]
        t2 = np.asarray(er.oovv) / (eia[:, None, :, None]
                                    + eia[None, :, None, :])
        t1 = np.zeros_like(eia)
        return t1, t2, t1.copy(), t2.copy()
    rng = np.random.default_rng(17)
    sl = jss._slices(info)
    dims = {"o": no, "v": info.nvir}

    def rand(kinds):
        arr = np.zeros(tuple(dims[k] for k in kinds))
        for key in itertools.product((0, 1), repeat=len(kinds)):
            if not jss._balanced(key) or (sym and not jss._is_canon(key)):
                continue
            idx = tuple(sl[(k, s)] for k, s in zip(kinds, key))
            blk = rng.standard_normal(arr[idx].shape) * 0.05
            arr[idx] = blk
            if sym:
                arr[tuple(sl[(k, 1 - s)] for k, s in zip(kinds, key))] = blk
        return arr

    def asym(x):
        x = x - x.transpose(1, 0, 2, 3)
        return 0.5 * (x - x.transpose(0, 1, 3, 2))

    return rand("ov"), asym(rand("oovv")), rand("ov"), asym(rand("oovv"))


def _run_jax(s, amps, sym, alpha):
    info, er, sect = s["info"], s["er"], s["sect"]
    t1, t2, l1, l2 = map(jnp.asarray, amps)
    fsp = jnp.asarray(s["fsp"])
    rdm1 = jccsd.gamma_CCSD(t1, t2, l1, l2, inter=jcs.gamma_inter_sect(
        t1, t2, l1, l2, info, sym=sym))
    tau = jcs._tau_b(jss.wrap(t2, "oovv", info, sym=sym),
                     jss.wrap(t1, "ov", info, sym=sym))
    lad_t, lad_l = jl.balanced_stacked_sectored_contract(
        sect, tau, l2, info.oa, sym=sym, blocked_info=info)
    t1n, t2n = jcs.tupdate_sect(er, t1, t2, fsp, info, alpha=alpha,
                                vvvv_op=sect, ladder_pre=lad_t, sym=sym,
                                tau_pre=tau)
    l1n, l2n = jcs.lupdate_sect(er, t1n, t2n, l1, l2, fsp, info, alpha=alpha,
                                vvvv_op=sect, ladder_pre=lad_l, sym=sym)
    return [np.asarray(x) for x in (rdm1, t1n, t2n, l1n, l2n)]


def _run_torch(s, amps, sym, alpha):
    info, er, sect = s["info"], s["er_t"], s["sect_t"]
    t1, t2, l1, l2 = map(_t, amps)
    fsp = _t(s["fsp"])
    rdm1 = tccsd.gamma_CCSD(t1, t2, l1, l2, inter=tcs.gamma_inter_sect(
        t1, t2, l1, l2, info, sym=sym))
    tau = tcs._tau_b(tss.wrap(t2, "oovv", info, sym=sym),
                     tss.wrap(t1, "ov", info, sym=sym))
    lad_t, lad_l = tl.balanced_stacked_sectored_contract(
        sect, tau, l2, info.oa, sym=sym, blocked_info=info)
    eris_sb = tcs.wrap_eris(er, info, sym=sym)
    t1n, t2n = tcs.tupdate_sect(er, t1, t2, fsp, info, alpha=alpha,
                                vvvv_op=sect, ladder_pre=lad_t,
                                eris_sb=eris_sb, sym=sym, tau_pre=tau)
    l1n, l2n = tcs.lupdate_sect(er, t1n, t2n, l1, l2, fsp, info, alpha=alpha,
                                vvvv_op=sect, ladder_pre=lad_l,
                                eris_sb=eris_sb, sym=sym)
    return [x.numpy() for x in (rdm1, t1n, t2n, l1n, l2n)]


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("kind", ["mp2", "random"])
def test_sector_kernels_match_jax(system, kind, sym):
    amps = _amps(system, kind, sym)
    ref = _run_jax(system, amps, sym, None)
    out = _run_torch(system, amps, sym, None)
    for name, r, o in zip(("rdm1", "t1", "t2", "l1", "l2"), ref, out):
        assert np.all(np.isfinite(o)), name
        np.testing.assert_allclose(o, r, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("sym", [False, True])
def test_sector_kernels_l1_regularized_match_jax(system, sym):
    """alpha (L1 regularization) path of both updates."""
    amps = _amps(system, "random", sym)
    ref = _run_jax(system, amps, sym, 0.05)
    out = _run_torch(system, amps, sym, 0.05)
    for name, r, o in zip(("rdm1", "t1", "t2", "l1", "l2"), ref, out):
        np.testing.assert_allclose(o, r, rtol=0, atol=TOL, err_msg=name)


def test_single_ladder_fallback_and_missing_ladder(system):
    """Without ladder_pre the updates run the SectoredVVVV ladder in
    single-operand mode, or a PackedVVVV's own route (same result); without
    either they raise."""
    s = system
    info = s["info"]
    t1, t2, l1, l2 = map(_t, _amps(s, "random", True))
    fsp = _t(s["fsp"])
    er, sect = s["er_t"], s["sect_t"]
    ref = _run_torch(s, (t1.numpy(), t2.numpy(), l1.numpy(), l2.numpy()),
                     True, None)
    t1n, t2n = tcs.tupdate_sect(er, t1, t2, fsp, info, vvvv_op=sect,
                                sym=True)
    l1n, l2n = tcs.lupdate_sect(er, t1n, t2n, l1, l2, fsp, info,
                                vvvv_op=sect, sym=True)
    for r, o in zip(ref[1:], (t1n, t2n, l1n, l2n)):
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=TOL)
    # a PackedVVVV of the same sorted vvvv: apply_vvvv_op on the dense
    # operands, as in the JAX package
    dense = build_eris_device(s["mol"], s["ghf"], dtype="float64",
                              sort_spin=True)
    packed = jl.pack_vvvv(dense.vvvv)
    pt = tl.PackedVVVV(wc=_t(packed.wc))
    t1p, t2p = tcs.tupdate_sect(er, t1, t2, fsp, info, vvvv_op=pt, sym=True)
    l1p, l2p = tcs.lupdate_sect(er, t1p, t2p, l1, l2, fsp, info,
                                vvvv_op=pt, sym=True)
    r1, r2 = jcs.tupdate_sect(s["er"], *map(jnp.asarray, (t1, t2)),
                              jnp.asarray(fsp), info, vvvv_op=packed,
                              sym=True)
    q1, q2 = jcs.lupdate_sect(s["er"], r1, r2, jnp.asarray(l1),
                              jnp.asarray(l2), jnp.asarray(fsp), info,
                              vvvv_op=packed, sym=True)
    for r, o in zip((r1, r2, q1, q2), (t1p, t2p, l1p, l2p)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL)
    for r, o in zip(ref[1:], (t1p, t2p, l1p, l2p)):
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=TOL)
    with pytest.raises(TypeError, match="no ladder route"):
        tcs.tupdate_sect(er, t1, t2, fsp, info, sym=True)
    with pytest.raises(TypeError, match="no ladder route"):
        tcs.lupdate_sect(er, t1, t2, l1, l2, fsp, info, sym=True)


def test_energy_and_tau_match_jax(system):
    s = system
    t1, t2, _, _ = _amps(s, "random", False)
    fsp = s["fsp"]
    ref = float(jccsd.energy(s["er"], jnp.asarray(t1), jnp.asarray(t2),
                             jnp.asarray(fsp)))
    out = float(tccsd.energy(s["er_t"], _t(t1), _t(t2), _t(fsp)))
    assert abs(out - ref) < 1e-13
    np.testing.assert_allclose(
        tccsd.make_tau(_t(t2), _t(t1), _t(t1), fac=0.5).numpy(),
        np.asarray(jccsd.make_tau(jnp.asarray(t2), jnp.asarray(t1),
                                  jnp.asarray(t1), fac=0.5)),
        rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# The SoupPlan: the step's ERI operands laid out once, one GEMM per block
# ---------------------------------------------------------------------------

def _cast(sb, dtype):
    return tss.SpinBlocked(sb.kinds, {k: v.to(dtype)
                                      for k, v in sb.blocks.items()},
                           sb.info, sym=sb.sym)


def _step(s, amps, sym, alpha, dtype, planned):
    """_run_torch's step in `dtype`, through a SoupPlan or without one."""
    info, sect = s["info"], s["sect_t"]
    er = s["er_t"]._replace(**{f: getattr(s["er_t"], f).to(dtype)
                               for f in s["er_t"]._fields})
    t1, t2, l1, l2 = (_t(a).to(dtype) for a in amps)
    fsp = _t(s["fsp"]).to(dtype)
    tau = tcs._tau_b(tss.wrap(t2, "oovv", info, sym=sym),
                     tss.wrap(t1, "ov", info, sym=sym))
    lad_t, lad_l = tl.balanced_stacked_sectored_contract(
        sect, _cast(tau, torch.float64), l2.double(), info.oa, sym=sym,
        blocked_info=info)
    lad_t, lad_l = _cast(lad_t, dtype), _cast(lad_l, dtype)
    eris_sb = tcs.wrap_eris(er, info, sym=sym)
    plan = (tcs.SoupPlan(er, eris_sb, info, sym, alpha=alpha) if planned
            else None)
    rdm1 = tccsd.gamma_CCSD(t1, t2, l1, l2, inter=tcs.gamma_inter_sect(
        t1, t2, l1, l2, info, sym=sym, plan=plan))
    t1n, t2n = tcs.tupdate_sect(er, t1, t2, fsp, info, alpha=alpha,
                                ladder_pre=lad_t, eris_sb=eris_sb, sym=sym,
                                tau_pre=tau, plan=plan)
    l1n, l2n = tcs.lupdate_sect(er, t1n, t2n, l1, l2, fsp, info, alpha=alpha,
                                ladder_pre=lad_l, eris_sb=eris_sb, sym=sym,
                                plan=plan)
    return [x.double().numpy() for x in (rdm1, t1n, t2n, l1n, l2n)]


@pytest.mark.parametrize("alpha", [None, 0.05])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_soup_plan_matches_unplanned_and_jax(system, dtype, sym, alpha):
    """The planned rdm1 intermediates, t and lambda updates equal the
    unplanned ones to the dtype's rounding (only the order of each output
    block's sum differs), and at f64 the JAX package's."""
    amps = _amps(system, "random", sym)
    plain = _step(system, amps, sym, alpha, dtype, planned=False)
    out = _step(system, amps, sym, alpha, dtype, planned=True)
    rel = 1e-12 if dtype == torch.float64 else 1e-6
    for name, p, o in zip(("rdm1", "t1", "t2", "l1", "l2"), plain, out):
        assert np.max(np.abs(o - p)) <= rel * np.max(np.abs(p)), name
    if dtype == torch.float64:
        ref = _run_jax(system, amps, sym, alpha)
        for name, r, o in zip(("rdm1", "t1", "t2", "l1", "l2"), ref, out):
            np.testing.assert_allclose(o, r, rtol=0, atol=TOL, err_msg=name)


def _random_sectors(oa, va, sym):
    """ERIs and amplitudes of random values on oa / va orbitals per spin
    sector (only which blocks a contraction reads matters here)."""
    import types
    gen = torch.Generator().manual_seed(5)
    info = tss.SectorInfo(oa, oa, va, va)
    dim = {"o": 2 * oa, "v": 2 * va}

    def rand(kinds):
        return torch.rand(tuple(dim[k] for k in kinds), generator=gen) * 0.1

    d = torch.cat([-1 - torch.rand(2 * oa, generator=gen),
                   1 + torch.rand(2 * va, generator=gen)])
    eris = types.SimpleNamespace(fock=torch.diag(d), **{
        n: rand(n) for n in ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovvv",
                             "ovoo", "vovv")})
    return info, eris, (rand("ov"), rand("oovv"), rand("ov"), rand("oovv"))


@pytest.mark.parametrize("sym", [False, True])
def test_soup_plan_copies_no_eri_and_runs_fewer_ops(sym):
    """The planned step reads the ERI blocks only through the plan's
    operands: no clone or copy_ of an ERI tensor's storage (the unplanned
    step copies them into GEMM operands every iteration), and at least 140
    fewer clone, bmm / mm and add ops.  Every ERI contraction of the step
    is planned."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    info, eris, (t1, t2, l1, l2) = _random_sectors(2, 4, sym)
    eris_sb = tcs.wrap_eris(eris, info, sym=sym)
    plan = tcs.SoupPlan(eris, eris_sb, info, sym)
    entries, _ = tcs._record_step(sym, True)
    assert set(plan._plans) == set(entries)
    stores = {t.untyped_storage().data_ptr() for n, t in vars(eris).items()
              if n != "fock"}
    stores |= {v.untyped_storage().data_ptr() for sb in eris_sb.values()
               for v in sb.blocks.values()}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.eri_copies = collections.Counter(), 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.ops[name] += 1
            src = (args[1] if name == "copy_" else args[0]
                   if name == "clone" else None)
            if (isinstance(src, torch.Tensor)
                    and src.untyped_storage().data_ptr() in stores):
                self.eri_copies += 1
            return func(*args, **(kwargs or {}))

    def step(p):
        tau = tcs._tau_b(tss.wrap(t2, "oovv", info, sym=sym),
                         tss.wrap(t1, "ov", info, sym=sym))
        lad = tss.wrap(torch.zeros_like(t2), "oovv", info, sym=sym)
        with Count() as c:
            tcs.gamma_inter_sect(t1, t2, l1, l2, info, sym=sym, plan=p)
            t1n, t2n = tcs.tupdate_sect(eris, t1, t2, eris.fock, info,
                                        ladder_pre=lad, eris_sb=eris_sb,
                                        sym=sym, tau_pre=tau, plan=p)
            tcs.lupdate_sect(eris, t1n, t2n, l1, l2, eris.fock, info,
                             ladder_pre=lad, eris_sb=eris_sb, sym=sym,
                             plan=p)
        return c

    plain, planned = step(None), step(plan)
    assert plain.eri_copies > 100 and planned.eri_copies == 0
    n = lambda c: sum(c.ops[k] for k in ("clone", "bmm", "mm", "add"))
    assert n(plain) - n(planned) >= 140, (plain.ops, planned.ops)


@pytest.mark.parametrize("mode", ["sweep", "parallel"])
def test_soup_counts_of_a_sectored_sweep(mode):
    """A CPU sectored f32 ECW.CCSD_GS: each lambda's solve_log entry carries
    the same last_solve['soup'] counts (counted once per set-up, inside
    the set-up's span), no two-operand ERI contraction left on
    sector_einsum; the batched sweep (vmap) builds no plan, and its
    energies agree with the planned sweep's."""
    import ecw_cc_torch
    from ecw_cc_torch import ECW

    def sweep(mode):
        ecw_cc_torch.set_config(ladder_mode="packed")
        try:
            ecw = ECW("h2o", "6-31g", device="cpu", dtype=torch.float32)
            ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
            ecw.CCSD_GS([0.0, 0.2], diis="tl", mode=mode)
        finally:
            ecw_cc_torch.set_config(ladder_mode="auto")
        return ecw

    ecw = sweep(mode)
    log = ecw.solve_log
    assert {s["route"] for s in log} == {"sectored"}
    if mode == "parallel":
        assert not any("soup" in s for s in log)
        planned = sweep("sweep")
        np.testing.assert_allclose(ecw.Ep_lamb, planned.Ep_lamb, rtol=0,
                                   atol=2e-6)
        return
    soup = [s["soup"] for s in log]
    assert all(c == soup[0] for c in soup)
    sym = log[0]["sym"]
    entries, no_eri = tcs._record_step(sym, True)
    three = sum(calls for (spec, _, _), (_, calls) in entries.items()
                if spec.count(",") == 2)
    assert soup[0]["fallback"] == no_eri + three
    assert soup[0]["planned"] > 0 and soup[0]["prelaid_mb"] > 0
    parents = {r[0]: r[1] for r in log[0]["spans"]}
    assert parents["solver.soup_plan"] == "solver.setup"
