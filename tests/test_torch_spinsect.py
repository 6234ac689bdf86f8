"""Parity of the PyTorch port's spin-sector machinery
(ecw_cc_torch.ops.spinsect) with the JAX package on identical f64 inputs,
CPU: sector_einsum, the balanced pack, div_eijab and the structure gates."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecw_cc_tpu.ops import spinsect as jss
from ecw_cc_torch.ops import spinsect as tss

torch.set_num_threads(1)

INFO = tss.SectorInfo(3, 3, 4, 4)
INFO_J = jss.SectorInfo(*INFO)
DIMS = {"o": INFO.nocc, "v": INFO.nvir}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _balanced(kinds, rng, mirror=False):
    """Random dense sorted-layout tensor with balanced spin support
    (and exact alpha<->beta mirror symmetry when `mirror`)."""
    sl = jss._slices(INFO_J)
    arr = np.zeros(tuple(DIMS[k] for k in kinds))
    for key in itertools.product((0, 1), repeat=len(kinds)):
        if not jss._balanced(key) or (mirror and not jss._is_canon(key)):
            continue
        idx = tuple(sl[(k, s)] for k, s in zip(kinds, key))
        blk = rng.standard_normal(arr[idx].shape)
        arr[idx] = blk
        if mirror:
            arr[tuple(sl[(k, 1 - s)] for k, s in zip(kinds, key))] = blk
    return arr


# (spec, kinds of each operand): the rdm1, soup, 3-operand and scalar forms
SPECS = [
    ("imef,jmef->ij", ("oovv", "oovv")),
    ("ijef,mnef->ijmn", ("oovv", "oovv")),
    ("imae,mbej->ijab", ("oovv", "ovvo")),
    ("jf,nb,mnef->mbej", ("ov", "ov", "oovv")),
    ("ia,jb->ijab", ("ov", "ov")),
    ("ijab,ijab->", ("oovv", "oovv")),
    ("ia,jb,ijab->", ("ov", "ov", "oovv")),
]


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("spec,kinds", SPECS, ids=[s for s, _ in SPECS])
def test_sector_einsum_matches_jax(spec, kinds, sym):
    rng = np.random.default_rng(len(spec))
    arrs = [_balanced(k, rng, mirror=sym) for k in kinds]
    ref = jss.sector_einsum(spec, *[jss.wrap(jnp.asarray(a), k, INFO_J,
                                             sym=sym)
                                    for a, k in zip(arrs, kinds)])
    out = tss.sector_einsum(spec, *[tss.wrap(_t(a), k, INFO, sym=sym)
                                    for a, k in zip(arrs, kinds)])
    assert out.sym == sym and out.kinds == ref.kinds
    assert sorted(out.blocks) == sorted(ref.blocks)
    np.testing.assert_allclose(out.dense().numpy(), np.asarray(ref.dense()),
                               rtol=0, atol=1e-12)
    # the blocked result equals the dense einsum of the dense operands
    dense = np.einsum(spec, *arrs)
    np.testing.assert_allclose(out.dense().numpy(), dense, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("kinds", ["ov", "oovv"])
def test_pack_balanced_roundtrip(kinds, sym):
    arr = _balanced(kinds, np.random.default_rng(3), mirror=sym)
    flat = tss.pack_balanced(_t(arr), kinds, INFO, sym=sym)
    assert flat.numel() == tss.packed_size(kinds, INFO, sym=sym)
    assert flat.numel() == jss.packed_size(kinds, INFO_J, sym=sym)
    np.testing.assert_array_equal(
        flat.numpy(),
        np.asarray(jss.pack_balanced(jnp.asarray(arr), kinds, INFO_J,
                                     sym=sym)))
    back = tss.unpack_balanced(flat, kinds, INFO, sym=sym)
    np.testing.assert_array_equal(back.numpy(), arr)


def test_blocked_ops_match_jax():
    """transpose / scale / add / div_eijab on SpinBlocked tensors."""
    rng = np.random.default_rng(11)
    a, b = _balanced("oovv", rng), _balanced("oovv", rng)
    d = rng.standard_normal(INFO.nocc + INFO.nvir) + 3.0 * np.r_[
        -np.ones(INFO.nocc), np.ones(INFO.nvir)]
    dj, dt = jnp.asarray(d), _t(d)
    A_j = jss.wrap(jnp.asarray(a), "oovv", INFO_J)
    B_j = jss.wrap(jnp.asarray(b), "oovv", INFO_J)
    A_t, B_t = tss.wrap(_t(a), "oovv", INFO), tss.wrap(_t(b), "oovv", INFO)
    ref = (A_j.transpose(1, 0, 3, 2) + B_j.scale(-0.5))
    out = (A_t.transpose(1, 0, 3, 2) + B_t.scale(-0.5))
    np.testing.assert_array_equal(out.dense().numpy(), np.asarray(ref.dense()))
    no = INFO.nocc
    ref = jss.div_eijab(ref, dj[:no], dj[no:]).dense()
    out = tss.div_eijab(out, dt[:no], dt[no:]).dense()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-15,
                               atol=0)


def test_sliced_support_matches_jax():
    for fixed in ({0: 0}, {0: 1, 2: 0}, {1: 1}):
        assert tss.sliced_support("oovv", fixed) == jss.sliced_support(
            "oovv", fixed)


def _block_diag_mat(rng, restricted):
    n = INFO.nocc + INFO.nvir
    spin = np.zeros(n, int)
    spin[INFO.oa:INFO.nocc] = 1
    spin[INFO.nocc + INFO.va:] = 1
    m = rng.standard_normal((n, n))
    m = m + m.T
    m[spin[:, None] != spin[None, :]] = 0.0
    if restricted:   # beta-beta block := alpha-alpha block
        a = np.r_[np.arange(INFO.oa), INFO.nocc + np.arange(INFO.va)]
        b = np.r_[INFO.oa + np.arange(INFO.ob),
                  INFO.nocc + INFO.va + np.arange(INFO.vb)]
        m[np.ix_(b, b)] = m[np.ix_(a, a)]
    return m


def test_gates_positive_and_negative():
    rng = np.random.default_rng(5)
    restricted = _block_diag_mat(rng, restricted=True)
    unrestricted = _block_diag_mat(rng, restricted=False)
    coupled = restricted.copy()
    coupled[0, INFO.nocc - 1] = coupled[INFO.nocc - 1, 0] = 0.1
    cases = [(restricted, True, True), (unrestricted, True, False),
             (coupled, False, False)]
    for m, block_diag, spin_restricted in cases:
        assert tss.is_block_diagonal(m, INFO) is block_diag
        assert jss.is_block_diagonal(m, INFO_J) is block_diag
        assert tss.is_spin_restricted(m, INFO) is spin_restricted
        assert jss.is_spin_restricted(m, INFO_J) is spin_restricted
    # unequal sector sizes are never spin-restricted
    assert not tss.is_spin_restricted(unrestricted,
                                      tss.SectorInfo(4, 2, 4, 4))

    mirror = _balanced("oovv", rng, mirror=True)
    broken = _balanced("oovv", rng)
    for arr, zero in ((mirror, True), (broken, False)):
        got = float(tss.spin_flip_asymmetry(_t(arr), "oovv", INFO))
        ref = float(jss.spin_flip_asymmetry(jnp.asarray(arr), "oovv",
                                            INFO_J))
        assert got == ref
        assert (got == 0.0) is zero
    assert np.isinf(float(tss.spin_flip_asymmetry(
        _t(broken), "oovv", tss.SectorInfo(4, 2, 4, 4))))
