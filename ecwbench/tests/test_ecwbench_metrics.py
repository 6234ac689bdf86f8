"""Each per-layer metric reader on recorded inputs: job records shaped as
the program's logs are, and profiler records, with values worked out by
hand."""

import pytest

from ecwbench.harness import Ctx, sum_keys
from ecwbench.spec import Spec

SP = Spec()
CFG = {"nocc": 14, "nvir": 134, "dtype": "float32"}


def solve(ms, iters, capture=None, route="sectored", sym=True):
    loop = {"graph": True, "iterations": iters}
    if capture is not None:
        loop.update(capture_ms=capture[0], empty_cache_ms=capture[1])
    return {"ms": ms, "iterations": iters, "route": route, "sym": sym,
            "status": 1, "loops": [loop]}


def sweep(wall, solves, traced=False):
    return {"kind": "sweep", "wall_ms": wall, "traced": traced,
            "solve_log": solves}


def target(wall, et, eg, captures, traced=False):
    log = {"energy_t_s": et, "energy_t": {"scans": [
        {"capture_ms": captures[0], "empty_cache_ms": captures[1]}]},
        "adjoint": {"energy_grad_s": eg,
                    "loop": {"capture_ms": captures[2]}},
        "ccsd": {"loop": {"capture_ms": captures[3],
                          "empty_cache_ms": captures[4]}}}
    return {"kind": "target", "wall_ms": wall, "traced": traced,
            "target_log": log}


def ctx(jobs, dev=(), window_s=None):
    return Ctx(jobs=list(jobs), dev=list(dev), host=[], window_s=window_s,
               cfg=CFG, traffic={}, families=SP.kernel_families(),
               sum_keys=sum_keys)


SWEEPS = [sweep(1000.0, [solve(400.0, 15, (80.0, 10.0)),
                         solve(300.0, 12)]),
          sweep(900.0, [solve(350.0, 15, (60.0, 0.0)), solve(250.0, 11)])]
# traced: 2 + 3 iterations; device records in us: two ladder kernels
# (one a split pass), two soup kernels, a copy, and a 500 us gap
DEV = [("_Z12ladder_mm_f32tcILi3EEvv", 0.0, 100.0),
       ("_ZN12_GLOBAL__N_17split_aILi3EEEvPKfPfS3_ii", 100.0, 110.0),
       ("elementwise_kernel", 110.0, 400.0),
       ("ampere_sgemm_64x32", 350.0, 500.0),
       ("Memcpy DtoD (Device -> Device)", 1000.0, 1100.0)]
TRACED = [sweep(50.0, [solve(20.0, 2), solve(20.0, 3)], traced=True)]


def read(name, c):
    return SP.metric_reader(name)(c)


def test_driver_ms_sweep():
    # (1000 - 700 + 900 - 600) / 2
    assert read("driver_ms.sweep", ctx(SWEEPS)) == pytest.approx(300.0)


def test_capture_ms_sweep():
    assert read("capture_ms.sweep", ctx(SWEEPS)) == pytest.approx(75.0)


def test_iters_sweep():
    assert read("iters.sweep", ctx(SWEEPS)) == pytest.approx(26.5)


def test_soup_dev_ms_sweep():
    # (290 + 150 + 100) us over 5 traced iterations
    c = ctx(SWEEPS + TRACED, DEV, 0.0012)
    assert read("soup_dev_ms.sweep", c) == pytest.approx(0.540 / 5)


def test_ladder_roofline_sweep():
    # 5 iterations x (6.354480 + 25.111600) us of bound over 110 us
    c = ctx(SWEEPS + TRACED, DEV, 0.0012)
    assert read("ladder_roofline.sweep", c) == pytest.approx(
        100 * 5 * 31.46608 / 110, rel=1e-6)


def test_ladder_roofline_off_its_route():
    other = [sweep(50.0, [solve(20.0, 2, route="dense", sym=False)],
                   traced=True)]
    assert read("ladder_roofline.sweep", ctx(other, DEV, 0.0012)) is None


def test_idle_pct():
    # busy = union [0, 500] + [1000, 1100] = 600 us of 1200
    c = ctx(SWEEPS + TRACED, DEV, 0.0012)
    assert read("idle_pct.sweep", c) == pytest.approx(50.0)
    assert read("idle_pct.target", c) is None


TARGETS = [target(5000.0, 0.3, 0.6, (10.0, 5.0, 20.0, 30.0, 5.0)),
           target(5200.0, 0.4, 0.7, (12.0, 3.0, 20.0, 30.0, 5.0))]


def test_t_pairs_s_target():
    assert read("t_pairs_s.target", ctx(TARGETS)) == pytest.approx(1.0)


def test_capture_ms_target():
    assert read("capture_ms.target", ctx(TARGETS)) == pytest.approx(70.0)


@pytest.mark.parametrize("name", ["driver_ms.sweep", "capture_ms.sweep",
                                  "iters.sweep", "soup_dev_ms.sweep",
                                  "ladder_roofline.sweep", "idle_pct.sweep",
                                  "t_pairs_s.target", "capture_ms.target",
                                  "idle_pct.target"])
def test_nothing_to_read_gives_nothing(name):
    assert read(name, ctx([], [], 1.0)) is None


def test_every_per_layer_metric_has_a_reader():
    for m in SP.bench["per_layer"]:
        assert callable(SP.metric_reader(m["name"]))
