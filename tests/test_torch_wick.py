"""The port's copy of the Wick engine (ecw_cc_torch/ops/wick.py) gives the
JAX package's term lists for every generator at the kinds the port calls:
the EOM-EE transition densities (ops/eom.py), the Dyson orbitals and the
EOM-IP/EA sigma (ops/eom_ipea.py), whose connected terms the port reads
from its table (eom_ipea_terms.json), held here equal to both
generators."""

import itertools

import pytest

from ecw_cc_tpu.ops import wick as jwick
from ecw_cc_torch.ops import eom_ipea as tip
from ecw_cc_torch.ops import wick as twick

TRDM = [("gs", "ree"), ("gs", "ref"), ("lee", "ref"), ("lee", "ree")]
SPACES = ["o", "v"]


def _canon(terms):
    return [(c, [tuple(p) for p in pieces], out) for c, pieces, out in terms]


@pytest.mark.parametrize("bra,ket,ps,qs", [
    (b, k, p, q) for (b, k), p, q in itertools.product(TRDM, SPACES,
                                                       SPACES)])
def test_trdm_terms_equal_jax(bra, ket, ps, qs):
    assert _canon(twick.generate_trdm_terms(bra, ket, ps, qs)) == \
        _canon(jwick.generate_trdm_terms(bra, ket, ps, qs))


@pytest.mark.parametrize("kind,side,p_space", list(itertools.product(
    ("ip", "ea"), ("left", "right"), SPACES)))
def test_dyson_terms_equal_jax(kind, side, p_space):
    assert _canon(twick.generate_dyson_terms(kind, side, p_space)) == \
        _canon(jwick.generate_dyson_terms(kind, side, p_space))


@pytest.fixture(scope="module")
def eom_terms():
    """{(kind, rank): (port terms, JAX terms)}, connected, generated once
    (about 35 s per doubles block and package)."""
    return {(k, r): (_canon(twick.generate_eom_terms(k, r)),
                     _canon(jwick.generate_eom_terms(k, r)))
            for k in ("ip", "ea") for r in (1, 2)}


@pytest.mark.parametrize("kind,rank", list(itertools.product(("ip", "ea"),
                                                             (1, 2))))
def test_eom_terms_equal_jax_and_the_table(eom_terms, kind, rank):
    port, jax_terms = eom_terms[(kind, rank)]
    assert port == jax_terms
    assert _canon(tip._terms(kind, rank, True)) == port
    assert len(port) > 5


def test_raw_ccsd_terms_equal_jax():
    """The generator's own CCSD residual terms (singles), the terms the
    engine is certified on."""
    assert _canon(twick.generate_terms(1, t_levels=(1, 2))) == \
        _canon(jwick.generate_terms(1, t_levels=(1, 2)))
