"""The control on the card, at a size a test run holds (C2H2/STO-3G): the
reference put in the program's place in float32 with TF32 matmuls fails
the limits the cells hold the program to, where the reference itself
would pass them.  Marked `gpu`: it skips without a card.

At the cells' own sizes the control is ecwbench/control.py's run (PERF.md
gives its readings)."""

import pytest

from ecwbench import check
from ecwbench.reference.solve import solve
from ecwbench.spec import Spec

C2H2 = [("C", (0.0012, -0.0021, 0.6034010)),
        ("C", (-0.0008, 0.0017, -0.6034010)),
        ("H", (0.0025, 0.0003, 1.6667490)),
        ("H", (-0.0014, -0.0029, -1.6667490))]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["sweep.c2h2_6-31pgss",
                                      "target.c2h2_6-311ppg2d2p"])
def test_control_fails_the_cells_limits(card, workload):
    from ecwbench.reference.aoints import load_basis

    sp = Spec()
    c = sp.cell(workload)
    basis = load_basis(sp.path("ecwbench/reference/basis/sto-3g.json"))
    lams = ([0.0, 0.35, 0.7] if c.traffic["job"] == "sweep" else None)
    ref = solve(C2H2, basis, lams, device=card)
    ctl = solve(C2H2, basis, lams, device=card, precision="tf32")
    got = {"jobs": []}
    if lams is None:
        got["jobs"].append({"eexp": ctl.eexp, "target_ao": ctl.target_ao})
    else:
        got.update(eexp=ctl.eexp, target_ao=ctl.target_ao)
        got["jobs"].append({"ep": ctl.ep, "delta": ctl.delta,
                            "rdm1_ao": ctl.rdm1_ao, "status": [1, 1, 1]})
    nums, per_job = check.numbers(c.traffic["job"], got, ref)
    correct, failed, rows = check.judge(nums, per_job, c.limits)
    assert not correct, rows
