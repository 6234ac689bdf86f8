"""The port's spans and counters (ecw_cc_torch.utils.metrics.span and
job, StageClock, the device loops' counts) and the benchmark's readers
of them (ecwbench/metrics/), on the CPU:

  - a span's row (name, parent, start_ns, end_ns) lands in its job with
    the right parent, and its duration under its key in the key's unit;
  - a span enters torch.profiler.record_function only while the profiler
    runs: then its name is among ecwbench.trace.split_events' host
    records; with the profiler off nothing is entered;
  - a CPU ECW.CCSD_GS leaves 'driver' and 'spans' on every solve_log
    entry, and each solve's child spans add up to no more than its ms;
  - a CPU ECW.Build_GS_exp('mat', 'CCSD(T)') leaves the stages' seconds
    (scf_s, ghf_s, store_s, ...) and 'spans' in target_log;
  - each reader the spans feed, on records shaped as the program's, and
    None on records of a program without them;
  - a Loop's log carries no 'memory';
  - tools/replay_split.py's sums and means;
  - on a card (marked `gpu`, skipped without one): the node and device-
    time counts of a captured loop, and the ladder launch counters after
    a sweep.
"""

import contextlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import ecw_cc_torch
from ecw_cc_torch import ECW
from ecw_cc_torch.kernels.ladder_mm import ladder_mm
from ecw_cc_torch.solvers import device_loop
from ecw_cc_torch.utils import metrics

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from ecwbench.harness import Ctx, sum_keys  # noqa: E402
from ecwbench.spec import Spec  # noqa: E402
from ecwbench.trace import split_events  # noqa: E402

SP = Spec()


@contextlib.contextmanager
def _port_config(**kw):
    ecw_cc_torch.set_config(**kw)
    try:
        yield
    finally:
        ecw_cc_torch.set_config(ladder_mode="auto")


@pytest.fixture
def entered(monkeypatch):
    """metrics.record_function replaced by a recorder: the names entered."""
    names = []

    class Recorder:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            names.append(self.name)

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(metrics, "record_function", Recorder)
    return names


# ---------------------------------------------------------------------------
# (a) the mechanism
# ---------------------------------------------------------------------------

def test_span_rows_parents_and_jobs():
    log = {}
    with metrics.job() as outer:
        with metrics.span("a.top", log, "top_ms"):
            with metrics.span("a.inner"):
                with metrics.job() as inner:
                    with metrics.span("b.alone", log, "alone_s"):
                        pass
                    assert metrics.current_job() is inner
            with metrics.span("a.second", log, "top_ms"):
                pass
        assert metrics.current_job() is outer
    assert metrics.current_job() is None
    assert outer.id != inner.id
    # rows in the order the spans ended
    assert [r[:2] for r in outer.rows] == [("a.inner", "a.top"),
                                          ("a.second", "a.top"),
                                          ("a.top", None)]
    assert [r[:2] for r in inner.rows] == [("b.alone", None)]
    for name, _, t0, t1 in outer.rows + inner.rows:
        assert isinstance(t0, int) and t1 >= t0, name
    top, second = outer.rows[2], outer.rows[1]
    # two spans under one key add up; '_ms' in ms, '_s' in seconds
    assert log["top_ms"] == pytest.approx(
        (top[3] - top[2] + second[3] - second[2]) / 1e6)
    alone = inner.rows[0]
    assert log["alone_s"] == pytest.approx((alone[3] - alone[2]) / 1e9)


def test_span_outside_a_job_keeps_no_row_and_checks_its_key():
    log = {}
    with metrics.span("x", log, "ms"):
        pass
    assert log["ms"] >= 0.0 and metrics.current_job() is None
    with pytest.raises(ValueError):
        metrics.span("x", None, "ms")
    with pytest.raises(ValueError):
        with metrics.span("x", {}, "seconds"):
            pass


def test_job_decorates_one_job_per_call():
    @metrics.job()
    def call():
        with metrics.span("c"):
            pass
        return metrics.current_job()

    a, b = call(), call()
    assert a is not b and a.id != b.id
    assert [r[0] for r in a.rows] == ["c"] and len(b.rows) == 1


def test_stage_clock_stages_are_spans():
    log = {}
    clock = metrics.StageClock(torch.device("cpu"), log, "t.")
    with metrics.job() as jb:
        with clock("first_s"):
            pass
        with clock("second_s"):
            with metrics.span("t.child"):
                pass
        assert clock.sub("part") == {} and log["part"] is clock.sub("part")
    assert [r[:2] for r in jb.rows] == [("t.first", None),
                                       ("t.child", "t.second"),
                                       ("t.second", None)]
    assert log["first_s"] >= 0.0 and log["second_s"] >= 0.0
    quiet = metrics.StageClock(torch.device("cpu"), None, "q.")
    with metrics.job() as jb:
        with quiet("x_s"):
            pass
    assert quiet.sub("part") is None and [r[0] for r in jb.rows] == ["q.x"]


def test_span_enters_record_function_only_while_profiling(entered):
    with metrics.span("ecw.off"):
        pass
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with metrics.span("ecw.on"):
            pass
    assert entered == ["ecw.on"]


def test_span_names_reach_the_harness_host_records():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with metrics.job(), metrics.span("ecw.outer"):
            with metrics.span("solver.inner"):
                torch.ones(16) @ torch.ones(16)
    _, host = split_events(prof)
    spans = {n: (s, e) for n, s, e in host
             if n in ("ecw.outer", "solver.inner")}
    assert set(spans) == {"ecw.outer", "solver.inner"}
    (os_, oe), (is_, ie) = spans["ecw.outer"], spans["solver.inner"]
    assert os_ <= is_ <= ie <= oe


# ---------------------------------------------------------------------------
# (b) the program's spans on the CPU
# ---------------------------------------------------------------------------

def _check_sweep_log(solve_log, parallel=False):
    assert solve_log
    names = {r[0] for e in solve_log for r in e["spans"]}
    for i, entry in enumerate(solve_log):
        drv, rows = entry["driver"], entry["spans"]
        want = {"record_ms"} | (set() if parallel
                                else {"enter_ms", "exit_ms"})
        if i == 0:
            want.add("prepare_ms")
        if i == len(solve_log) - 1:
            want |= {"release_ms", "fetch_ms"}
        assert set(drv) == want, (i, drv)
        assert all(v >= 0.0 for v in drv.values())
        assert [r[0] for r in rows].count("ecw.sweep.lambda") == 1
        if not parallel:
            # the solve's children: within its ms
            kids = sum(r[3] - r[2] for r in rows if r[1] == "solver.solve")
            assert kids / 1e6 <= entry["ms"]
            assert {r[0] for r in rows if r[1] == "solver.solve"} >= {
                "solver.lanes", "solver.leg", "solver.finish"}
            assert entry["lanes_ms"] > 0 and entry["finish_ms"] > 0
            assert ("setup_ms" in entry) == (i == 0)
            assert "solver.enter" in {r[0] for r in rows}
        for name, parent, t0, t1 in rows:
            assert t1 >= t0 and (parent is None or parent in names), name
    assert {"ecw.sweep.prepare", "ecw.sweep.record",
            "ecw.sweep.release", "ecw.sweep.fetch"} <= names
    return names


@pytest.mark.parametrize("case", ["dense_f64", "sectored_f32", "parallel"])
def test_ccsd_gs_files_spans_and_driver_ms(case, entered):
    dtype = torch.float64 if case == "dense_f64" else torch.float32
    mode = "parallel" if case == "parallel" else "sweep"
    with _port_config(ladder_mode="dense" if case == "dense_f64"
                      else "packed"):
        ecw = ECW("h2o", "6-31g", device="cpu", dtype=dtype)
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        ecw.CCSD_GS([0.0, 0.2, 0.4], diis="tl", mode=mode)
    names = _check_sweep_log(ecw.solve_log, parallel=mode == "parallel")
    routes = {s["route"] for s in ecw.solve_log}
    einsums = {n for n in names if n.startswith("ops.sector_einsum.")}
    if case == "dense_f64":
        assert routes == {"dense"} and not einsums
    else:
        # one span per spin assignment of the soup, named by spec and spins
        assert routes == {"sectored"} and einsums
        assert all(n.rsplit(".", 1)[1].isdigit() for n in einsums)
    # the profiler is off: nothing entered its record_function
    assert entered == []


def test_ccsd_gs_spans_reach_the_profiler(entered):
    ecw = ECW("h2o", "sto-3g", device="cpu", dtype=torch.float64)
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ecw.CCSD_GS([0.0, 0.3], diis="tl")
    rows = [r for e in ecw.solve_log for r in e["spans"]]
    assert entered and sorted(entered) == sorted(r[0] for r in rows)


def test_build_gs_exp_files_target_spans():
    ecw = ECW("h2o", "sto-3g", device="cpu", dtype=torch.float64)
    ecw.Build_GS_exp("mat", "CCSD(T)", field=[0.05, 0.01, 0.0])
    log = ecw.target_log
    for key in ("init_s", "scf_s", "ghf_s", "eris_s", "ccsd_s",
                "energy_t_s", "adjoint_s", "store_s", "target_store_s"):
        assert log[key] >= 0.0, key
    assert set(log["adjoint"]) >= {"energy_grad_s", "map_s",
                                   "iterations_s"}
    rows = log["spans"]
    top = [r[0] for r in rows if r[1] is None]
    assert top == ["ecw.target.init", "gexp.scf", "gexp.ghf", "gexp.eris",
                   "gexp.ccsd", "gexp.energy_t", "gexp.adjoint",
                   "gexp.store", "ecw.target.store"]
    assert {r[0] for r in rows if r[1] == "gexp.adjoint"} == {
        "ops.ccsd_t.energy_grad", "ops.ccsd_t.map",
        "ops.ccsd_t.iterations"}
    # the stages' keys are their spans' durations
    dur = {r[0]: (r[3] - r[2]) / 1e9 for r in rows}
    assert log["scf_s"] == pytest.approx(dur["gexp.scf"])
    assert log["ccsd_s"] == pytest.approx(dur["gexp.ccsd"])
    # an HF target times its SCF too
    ecw.Build_GS_exp("mat", "HF")
    assert ecw.target_log["scf_s"] > 0.0
    assert [r[0] for r in ecw.target_log["spans"] if r[1] is None] == [
        "ecw.target.init", "gexp.scf", "ecw.target.store"]


@pytest.mark.parametrize("n", [0, 1, 4])
def test_cpu_loop_log_has_no_memory(n):
    body = lambda s: (s[1] + 1 < n, s[1] + 1)   # noqa: E731
    log = {}
    state = device_loop.Loop(body)((torch.tensor(n > 0), torch.tensor(0)),
                                   log)
    assert int(state[1]) == n
    assert log == {"graph": False, "iterations": n}


# ---------------------------------------------------------------------------
# (c) the readers, on records shaped as the program's
# ---------------------------------------------------------------------------

def _loop(iters, replays=None, warm=None, dev=None, nodes=None):
    lp = {"graph": replays is not None, "iterations": iters}
    if replays is not None:
        lp["replays"] = replays
    for k, v in (("warm_up_ms", warm), ("replay_dev_ms", dev),
                 ("nodes", nodes)):
        if v is not None:
            lp[k] = v
    return lp


def _solve(ms, loops, driver=None, **host):
    s = {"ms": ms, "iterations": sum(lp["iterations"] for lp in loops),
         "loops": loops, "route": "sectored", "sym": True, "status": 1,
         **host}
    if driver is not None:
        s["driver"] = driver
    return s


def _sweep(solves, traced=False, wall=1000.0):
    return {"kind": "sweep", "wall_ms": wall, "traced": traced,
            "solve_log": solves}


def _ctx(jobs):
    return Ctx(jobs=list(jobs), dev=[], host=[], window_s=None,
               cfg={"nocc": 14, "nvir": 134, "dtype": "float32"},
               traffic={}, families=SP.kernel_families(),
               sum_keys=sum_keys)


def _read(name, jobs):
    return SP.metric_reader(name)(_ctx(jobs))


SWEEPS = [
    _sweep([_solve(400.0, [_loop(15, 14, warm=30.0, dev=80.0, nodes=300)],
                   driver={"prepare_ms": 5.0, "enter_ms": 1.0,
                           "exit_ms": 2.0, "record_ms": 0.5},
                   setup_ms=20.0, lanes_ms=3.0, finish_ms=4.0),
            _solve(300.0, [_loop(12, 12, dev=70.0, nodes=300)],
                   driver={"enter_ms": 1.5, "exit_ms": 2.5,
                           "record_ms": 0.5, "release_ms": 6.0},
                   lanes_ms=2.0, finish_ms=3.0)]),
    _sweep([_solve(350.0, [_loop(10, 9, warm=40.0, dev=60.0, nodes=320),
                           _loop(3, 3, dev=10.0, nodes=100)],
                   driver={"prepare_ms": 4.0, "release_ms": 1.0},
                   setup_ms=10.0, lanes_ms=1.0, finish_ms=1.0)]),
    # a traced sweep: not read
    _sweep([_solve(1.0, [_loop(2, 1, warm=999.0, dev=999.0, nodes=9)],
                   driver={"prepare_ms": 999.0}, setup_ms=999.0,
                   lanes_ms=999.0, finish_ms=999.0)], traced=True),
]


@pytest.mark.parametrize("name,value", [
    # (5 + 1 + 2 + 0.5 + 1.5 + 2.5 + 0.5 + 6) + (4 + 1), over 2 sweeps
    ("driver_span_ms.sweep", (19.0 + 5.0) / 2),
    # (20 + 3 + 4 + 2 + 3) + (10 + 1 + 1)
    ("solve_host_ms.sweep", (32.0 + 12.0) / 2),
    ("warmup_ms.sweep", (30.0 + 40.0) / 2),
    ("replay_dev_ms.sweep", (150.0 + 70.0) / 2),
    # (300 * 14 + 300 * 12 + 320 * 9 + 100 * 3) / (14 + 12 + 9 + 3)
    ("graph_nodes.sweep", 10980.0 / 38),
])
def test_sweep_span_readers(name, value):
    assert _read(name, SWEEPS) == pytest.approx(value)


@pytest.mark.parametrize("name", ["driver_span_ms.sweep",
                                  "solve_host_ms.sweep", "warmup_ms.sweep",
                                  "replay_dev_ms.sweep",
                                  "graph_nodes.sweep"])
def test_sweep_span_readers_without_the_spans(name):
    """A program without the spans (the records before them): None, no
    error; and None on a window with no sweep."""
    old = [_sweep([_solve(400.0, [{"graph": True, "iterations": 15,
                                   "replays": 14, "capture_ms": 80.0}])])]
    assert _read(name, old) is None
    assert _read(name, []) is None


def _build(scf, traced=False):
    log = {"eris_s": 0.5, "energy_t_s": 0.4,
           "adjoint": {"energy_grad_s": 0.6}}
    if scf is not None:
        log["scf_s"] = scf
    return {"kind": "target", "wall_ms": 7000.0, "traced": traced,
            "target_log": log}


def test_scf_s_target():
    assert _read("scf_s.target", [_build(3.0), _build(4.0),
                                  _build(9.0, traced=True)]) == \
        pytest.approx(3.5)
    assert _read("scf_s.target", [_build(None)]) is None
    assert _read("scf_s.target", []) is None


def test_new_metrics_are_declared_with_their_cells():
    layer = {m["name"]: m for m in SP.bench["per_layer"]}
    sweeps = ["sweep.c2h2_6-311ppg2d2p", "sweep.c2h2_6-31pgss"]
    for name in ("driver_span_ms.sweep", "solve_host_ms.sweep",
                 "warmup_ms.sweep", "replay_dev_ms.sweep",
                 "graph_nodes.sweep"):
        assert layer[name]["workloads"] == sweeps
        assert layer[name]["moves"] == "sweep_ms"
    assert layer["scf_s.target"]["workloads"] == ["target.c2h2_6-311ppg2d2p"]


def _replay_split():
    spec = importlib.util.spec_from_file_location(
        "replay_split", pathlib.Path(ROOT) / "tools" / "replay_split.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replay_split_sums_a_sweeps_driver_and_loop_keys():
    """tools/replay_split.py's sweep line on a CPU sweep: each driver key
    summed over the lambdas (release and fetch in the last entry only)."""
    tool = _replay_split()
    ecw = ECW("h2o", "sto-3g", device="cpu", dtype=torch.float64)
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    ecw.CCSD_GS([0.0, 0.3], diis="tl")
    line = tool.sweep_line(ecw.solve_log, 12.5)
    last = ecw.solve_log[-1]["driver"]
    assert line["wall_ms"] == 12.5
    assert line["release_ms"] == last["release_ms"]
    assert line["fetch_ms"] == last["fetch_ms"]
    assert line["record_ms"] == pytest.approx(
        sum(e["driver"]["record_ms"] for e in ecw.solve_log))
    assert line["iterations"] == sum(e["iterations"]
                                     for e in ecw.solve_log)
    assert line["replays"] == 0 and line["replay_dev_ms"] == 0


def test_replay_split_means_and_launch():
    """The split line: means by kind, launch = idle - busy, and a busy
    replay whose spin ended before the host's replay() returned counted
    as short."""
    tool = _replay_split()
    rows = [("idle", 7.5, 0.05, 0.0), ("busy", 6.3, 0.05, 2.0),
            ("idle", 7.7, 0.07, 0.0), ("busy", 6.5, 0.30, 0.2)]
    out = tool.split_line(rows)
    assert out["idle"] == {"replays": 2, "event_ms": pytest.approx(7.6),
                           "host_replay_ms": pytest.approx(0.06)}
    assert out["busy"]["event_ms"] == pytest.approx(6.4)
    assert out["launch_ms"] == pytest.approx(1.2)
    assert out["spin_ms"] == pytest.approx(1.1)
    assert out["short_spins"] == 1
    assert "launch_ms" not in tool.split_line(rows[:1])


def test_replay_split_restores_graph_replay():
    tool = _replay_split()
    orig = torch.cuda.CUDAGraph.replay
    with tool.SplitReplays(1000) as split:
        assert torch.cuda.CUDAGraph.replay is not orig
    assert torch.cuda.CUDAGraph.replay is orig and split.raw == []


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_captured_loop_counts_nodes_and_device_time(monkeypatch):
    """A captured Loop: its graph's kernel nodes counted (> 0), the device
    time of its replays (> 0), no allocator reads, and a kept loop's next
    call reports the same nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def no_read(*a, **k):
        raise AssertionError("the loop read the allocator's counters")

    monkeypatch.setattr(torch.cuda, "memory_allocated", no_read)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", no_read)
    x = torch.randn(256, 256, device="cuda")

    def body(s):
        k = s[1] + 1
        return (k < 20, k, torch.tanh(s[2] @ x))

    loop = device_loop.Loop(body)
    state = (torch.tensor(True, device="cuda"),
             torch.tensor(0, device="cuda"), torch.eye(256, device="cuda"))
    first, again = {}, {}
    loop(state, first)
    loop(state, again)
    # the first call's first iteration is its warm-up; the kept graph's
    # next call replays every iteration
    for log, replays in ((first, 19), (again, 20)):
        assert log["graph"] and log["iterations"] == 20
        assert log["replays"] == replays and log["replay_dev_ms"] > 0.0
        assert log["nodes"] > 0 and log["other_nodes"] >= 0
        assert "memory" not in log
    assert "capture_ms" in first and "warm_up_ms" in first
    assert "capture_ms" not in again and "warm_up_ms" not in again
    assert again["nodes"] == first["nodes"]


@pytest.mark.gpu
def test_sweep_launch_counters_on_card():
    """C2H2/cc-pVDZ f32 (the sorted sectored route, 2 ladder launches an
    iteration): after a sweep the launch counters, added once per loop
    call, equal 2 x its iterations, as when they were added per replay;
    every loop log has its nodes and device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ecw = ECW("c2h2", "cc-pvdz", dtype=torch.float32)
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    n0 = ladder_mm.launches
    ecw.CCSD_GS([0.0, 0.25, 0.5], diis="tl", conv_thres=1e-6)
    its = sum(s["iterations"] for s in ecw.solve_log)
    assert {s["route"] for s in ecw.solve_log} == {"sectored"}
    assert ladder_mm.launches - n0 == 2 * its
    loops = [lp for s in ecw.solve_log for lp in s["loops"]]
    assert all(lp["nodes"] > 0 and lp["replay_dev_ms"] > 0 for lp in loops)
    assert np.isfinite(ecw.Ep_lamb).all()
