"""ecw_cc_torch.models.tdscf (CIS, TDHF, get_init_r) against the JAX
package's module, on host arrays and on the port's device ERIs (mirrors
tests/test_props_tdscf.py:12-48)."""

import numpy as np
import pytest
import torch

from ecw_cc_tpu.models import tdscf as jtdscf
from ecw_cc_torch.models import tdscf
from ecw_cc_torch.models.eris import from_numpy

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", params=["host_arrays", "torch_eris"])
def eris_pair(request, h2o_631g):
    mol, ghf, eris_host, eris_dev = h2o_631g
    mine = eris_host if request.param == "host_arrays" \
        else from_numpy(eris_dev, **F64)
    return mol, ghf, eris_host, mine


def test_build_AB_matches_jax(eris_pair):
    mol, ghf, ref, mine = eris_pair
    A, B = tdscf._build_AB(mine, ghf.mo_energy)
    Aj, Bj = jtdscf._build_AB(ref, ghf.mo_energy)
    assert np.abs(A - Aj).max() < 1e-12 and np.abs(B - Bj).max() < 1e-12
    assert np.abs(A - A.T).max() < 1e-10          # real orbitals


def test_cis_matches_jax(eris_pair):
    mol, ghf, ref, mine = eris_pair
    es, X = tdscf.cis(mine, ghf.mo_energy, nroots=4)
    ej, Xj = jtdscf.cis(ref, ghf.mo_energy, nroots=4)
    assert X.shape == (4, ref.nocc, ref.nvir)
    assert np.abs(es - ej).max() < 1e-12
    assert np.all(es > 0)


def test_tdhf_below_cis(eris_pair):
    mol, ghf, ref, mine = eris_pair
    e_cis, _ = tdscf.cis(mine, ghf.mo_energy, nroots=3)
    e_rpa, X, Y = tdscf.tdhf(mine, ghf.mo_energy, nroots=3)
    assert e_rpa[0] <= e_cis[0] + 1e-10
    assert np.all(e_rpa > 0)
    ej, Xj, Yj = jtdscf.tdhf(ref, ghf.mo_energy, nroots=3)
    assert np.abs(e_rpa - ej).max() < 1e-10
    # <X|X> - <Y|Y> = 1 for every root kept
    for x, y in zip(X, Y):
        assert abs(np.sum(x * x) - np.sum(y * y) - 1.0) < 1e-9


def test_get_init_r(eris_pair):
    mol, ghf, ref, mine = eris_pair
    r_ini, tdms, es = tdscf.get_init_r(mol, ghf, mine, roots=4)
    assert r_ini.shape == (ref.nocc, ref.nvir)
    assert tdms.shape[1] == 3
    assert np.all(es > 0)
    rj, tj, ej = jtdscf.get_init_r(mol, ghf, ref, roots=4)
    assert np.abs(es - ej).max() < 1e-10
    # degenerate roots may rotate among themselves; the moduli of the
    # transition dipoles of a non-degenerate root do not
    gaps = np.abs(np.diff(es))
    for k in range(len(es)):
        lone = (k == 0 or gaps[k - 1] > 1e-6) and (
            k == len(es) - 1 or gaps[k] > 1e-6)
        if lone:
            assert np.abs(np.abs(tdms[k]) - np.abs(tj[k])).max() < 1e-8
