"""tools/mesh_cards.py's rank side on the CPU: two gloo ranks each build the
f32 ECW (H2O/6-31G with the ladder packed, as 'auto' does at nvir >= 48)
in the layout of the config, and solve it alone and split over a 1 x 2
mesh, as the runner does on the cards.

With config.spin_sorted (the default) the ECW is spin-sorted with a
SectoredVVVV and mo_perm: every solve takes the sectored route with the
mirror symmetry, each sector is split by rows, and the split solves equal
the lone one.  With spin_sorted=False the same on the packed route.  The
runner's own verdict holds, but for the launch counts: a ladder product on
the CPU is its plain version, and no launch is counted.
"""

import os
import sys

import pytest

from ecw_cc_torch.parallel import dryrun

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import mesh_cards  # noqa: E402

N_RANKS = 2


@pytest.mark.parametrize("spin_sorted", [True, False])
def test_mesh_cards_split_solve_on_the_ecw_layout(spin_sorted):
    config = {"ladder_mode": "packed", "spin_sorted": spin_sorted}
    out = dryrun.run_ranks(N_RANKS, mesh_cards.rank_solves, N_RANKS, "h2o",
                           "6-31g", "cpu", config)
    route = "sectored" if spin_sorted else "packed"
    for rank in out:
        assert rank["route"] == route
        assert mesh_cards.verdict(rank, counted=False)
        assert {r["route"] for r in rank["runs"]} == {route}
        assert all(r["sym"] for r in rank["runs"]) == spin_sorted
    first = out[0]["runs"]
    assert [r["split"] for r in first] == [False, True, True, False, False,
                                          True]
    # every rank ends on the same energy
    for rank in out[1:]:
        assert [r["Ep"] for r in rank["runs"] if r["split"]] == [
            r["Ep"] for r in first if r["split"]]
    # each rank holds its half of the operand's rows: one PackedVVVV, or
    # the three sectors of a SectoredVVVV (rows padded to a multiple of 2)
    split = [r for r in first if r["split"]]
    shapes = split[0]["operand_local"]
    assert len(shapes) == (3 if spin_sorted else 1)
    for rows, cols in shapes:
        assert rows == (cols + cols % 2) // 2
    # the logged split solve gathered its products' columns, and no
    # collective moved an operand-sized tensor
    assert split[0]["collectives"] > 0
    assert split[0]["collectives_on_operand"] == 0
    assert mesh_cards.route_launches(split[0]) == (2 if spin_sorted else 1)
