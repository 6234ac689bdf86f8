"""The port's ERI transform on the device (ecw_cc_torch.models.eris.
build_eris_device) against the JAX package's twin and the host f64 build_eris,
and the f32 ECW entry point that uses it, on the CPU:

  - f64: every GEris block and the SectoredVVVV operand equal the JAX
    build_eris_device to 1e-12, sorted and unsorted, dense and packed;
  - f64: the device build equals the host ErisHost (+ sorted_from_host)
    to 1e-10 (the host build zeroes |x| < 1e-13);
  - f32: the compensated transform matches the host f64 blocks to 3e-6 at
    an ill-conditioned diffuse basis (H2O/6-311+G*, cond(S) ~ 1e3), as
    tests/test_scf.py::test_device_eris_f32_compensated_ill_conditioned
    does for the JAX package;
  - the f32 ECW (device build, no host G-format ERIs) converges to the
    f64 ECW's Ep within 1e-5 Ha.
"""

import numpy as np
import pytest
import torch

import ecw_cc_torch
from ecw_cc_tpu.models.eris import build_eris_device as j_build
from ecw_cc_torch.models import eris as teris
from ecw_cc_torch.models.molecule import Molecule
from ecw_cc_torch.models.scf import GHF, RHF
from ecw_cc_torch.ops.ladder import pack_vvvv_sorted, spin_sort_perm

torch.set_num_threads(1)


def _port_system(name, basis):
    mol = Molecule(name, basis)
    mf = RHF(mol, conv_tol=1e-11)
    mf.kernel()
    return mol, GHF(mf)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_geris_close(a, b, atol):
    for f in teris.GEris._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.shape == y.shape, f
        if x.size:
            assert np.max(np.abs(x - y)) <= atol, f


@pytest.mark.parametrize("pack_ladder,sort_spin", [
    (False, False), (False, True), (True, True), (True, False)],
    ids=["dense-alternating", "dense-sorted", "sectored", "packed"])
def test_build_eris_device_matches_jax(h2o_631g, pack_ladder, sort_spin):
    mol, ghf, _, _ = h2o_631g
    ref = j_build(mol, ghf, dtype="float64", pack_ladder=pack_ladder,
                  sort_spin=sort_spin)
    out = teris.build_eris_device(mol, ghf, dtype=torch.float64,
                                  device="cpu", pack_ladder=pack_ladder,
                                  sort_spin=sort_spin)
    if pack_ladder:
        (ref, ref_op), (out, op) = ref, out
        assert out.vvvv.shape == (out.nvir, 0, 0, 0)
        assert type(op).__name__ == type(ref_op).__name__
        assert op._fields == ref_op._fields
        for f in op._fields:
            x, y = _np(getattr(op, f)), _np(getattr(ref_op, f))
            assert x.shape == y.shape, f
            assert np.max(np.abs(x - y)) <= 1e-12, f
        # from_numpy carries the JAX operand over as the port's type
        _, op_np = teris.from_numpy(ref, ref_op, dtype=torch.float64,
                                    device="cpu")
        assert type(op_np) is type(op)
        for x, y in zip(op_np, ref_op):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert out.fock.dtype == torch.float64
    _assert_geris_close(out, ref, 1e-12)


def test_packed_unsorted_build_raises(h2o_631g):
    """pack_ladder=True, sort_spin=False builds a PackedVVVV beside a vvvv
    placeholder; rebuilding a ladder operand from that placeholder raises,
    as the JAX package's make_vvvv_op does."""
    from ecw_cc_torch.ops.ladder import (PackedVVVV, make_vvvv_op,
                                         pack_vvvv)

    mol, ghf, eris_host, _ = h2o_631g
    er, op = teris.build_eris_device(mol, ghf, dtype=torch.float64,
                                     device="cpu", pack_ladder=True,
                                     sort_spin=False)
    assert isinstance(op, PackedVVVV)
    ref = pack_vvvv(torch.as_tensor(eris_host.vvvv))
    assert float((op.wc - ref.wc).abs().max()) <= 1e-10
    with pytest.raises(ValueError, match="not materialized"):
        make_vvvv_op(er.vvvv)


@pytest.fixture(scope="module")
def port_h2o():
    mol, ghf = _port_system("h2o", "6-31g")
    return mol, ghf, teris.build_eris(mol, ghf)


def test_device_build_matches_host_build(port_h2o):
    """The port's own pair: device transform vs host build_eris (f64), in the
    alternating layout and through sorted_from_host in the sorted one."""
    mol, ghf, host = port_h2o
    dense = teris.build_eris_device(mol, ghf, dtype=torch.float64,
                                    device="cpu")
    _assert_geris_close(dense, host, 1e-10)
    perm = spin_sort_perm(ghf.orbspin, host.nocc)
    ref, ref_sect = teris.sorted_from_host(host, perm, dtype=torch.float64,
                                           device="cpu")
    er, sect = teris.build_eris_device(mol, ghf, dtype=torch.float64,
                                       device="cpu", pack_ladder=True,
                                       sort_spin=True)
    _assert_geris_close(er, ref, 1e-10)
    for x, y in zip(sect, ref_sect):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) <= 1e-10


def test_permute_geris_round_trip(port_h2o):
    """A sorted dense build, permuted back with argsort(perm), is the
    alternating build; warn_if_sorted_layout flags only the sorted one."""
    mol, ghf, host = port_h2o
    nocc = host.nocc
    perm = spin_sort_perm(ghf.orbspin, nocc)
    srt = teris.build_eris_device(mol, ghf, dtype=torch.float64,
                                  device="cpu", sort_spin=True)
    ip = np.argsort(perm)
    alt = teris.permute_geris(srt, ip[:nocc], ip[nocc:] - nocc, ip)
    _assert_geris_close(alt, host, 1e-10)
    with pytest.warns(RuntimeWarning, match="spin-SORTED"):
        teris.warn_if_sorted_layout(srt, "test")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        teris.warn_if_sorted_layout(alt, "test")


def test_f32_build_matches_host_f64_at_a_diffuse_basis():
    """Compensated transform in f32: <= 3e-6 max-abs per block and for the
    sectored ladder operand, at cond(S) ~ 1e3."""
    mol, ghf = _port_system("h2o", "6-311+g*")
    host = teris.build_eris(mol, ghf)
    er, sect = teris.build_eris_device(mol, ghf, dtype=torch.float32,
                                       device="cpu", pack_ladder=True,
                                       sort_spin=True)
    assert er.oovv.dtype == torch.float32
    perm = spin_sort_perm(ghf.orbspin, host.nocc)
    ref, _ = teris.sorted_from_host(host, perm, dtype=torch.float64,
                                    device="cpu")
    _assert_geris_close(er, ref, 3e-6)
    v = host.nvir
    vvvv = torch.from_numpy(host.vvvv)
    p = torch.as_tensor(perm[host.nocc:] - host.nocc)
    vvvv = vvvv[p][:, p][:, :, p][:, :, :, p]
    ma = int(np.sum(np.asarray(ghf.orbspin)[perm[host.nocc:]] == 0))
    ref_sect = pack_vvvv_sorted(vvvv, ma)
    assert v == 2 * ma
    for x, y in zip(sect, ref_sect):
        assert float((x.double() - y).abs().max()) <= 3e-6


def test_f32_ecw_uses_the_device_build_and_converges():
    out = {}
    for dt in (torch.float64, torch.float32):
        ecw = ecw_cc_torch.ECW("h2o", "6-31g", device="cpu", dtype=dt)
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        res = ecw.CCSD_GS([0.5], diis="tl")
        assert "Convergence reached" in res[0]
        out[dt] = (ecw, float(res[1][-1]), len(res[1]))
    ecw32, ep32, it32 = out[torch.float32]
    ecw64, ep64, it64 = out[torch.float64]
    assert ecw32._eris_host is None          # no host G-format ERIs at f32
    assert {"x_half_s", "device_s"} <= ecw32.timings.keys()
    assert ecw32.eris.oovv.dtype == torch.float32
    assert abs(ep32 - ep64) <= 1e-5
    assert abs(it32 - it64) <= 1
    # host fock back in the alternating order, from the sorted device fock
    np.testing.assert_allclose(ecw32.fock, ecw64.fock, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ecw64.fock, np.diag(ecw64.mf.mo_energy),
                               rtol=0, atol=0)
    # the lazy host ERIs are build_eris's
    _assert_geris_close(ecw32.eris_host, ecw64.eris_host, 0.0)
