"""Observability: iteration metrics, spans and stage seconds.

Replaces the reference's print-based convergence tables (SURVEY.md section 5)
with a structured collector that can also emit JSON lines.

Copy of ecw_cc_tpu/utils/metrics.py (the PyTorch port imports
nothing of the JAX package), its jax.profiler wrappers `profile_trace`
and `annotate` written over torch.profiler.  `span`, `job` and
`StageClock` are the port's own.

Spans.  `span(name, log, key)` times a block on the host clock
(time.perf_counter_ns).  Inside a `job()` (ECW.CCSD_GS and
ECW.Build_GS_exp open one per call) it appends the row (name, parent,
start_ns, end_ns) to the job's `rows`, parent being the name of the
innermost enclosing span (None at the top); the caller files the rows
into its log (each lambda's solve_log entry, target_log).  With a `log`
and a `key` it also adds its duration to log[key], in the unit the key
names ('ms' or '*_ms': milliseconds, '*_s': seconds).  While
torch.profiler runs, the span also enters
torch.profiler.record_function(name), so that the profiler's host
records carry the program's stages; otherwise it costs two clock reads
and, in a job, a list append.  Names are dotted under the layer's prefix
('ecw.', 'solver.', 'loop.', 'gexp.', 'ops.'), apart from aten's.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function


class IterationMetrics:
    """Collects per-iteration scalars for one solve; renders a table or JSONL."""

    def __init__(self, solver="", L=None):
        self.solver = solver
        self.L = L
        self.rows = []
        self._t0 = time.perf_counter()

    def record(self, ite, **scalars):
        self.rows.append({"ite": int(ite),
                          "t_wall_s": round(time.perf_counter() - self._t0, 6),
                          **{k: float(v) for k, v in scalars.items()}})

    def table(self, tablefmt="rst"):
        try:
            from tabulate import tabulate
        except ImportError:
            return "\n".join(json.dumps(r) for r in self.rows)
        if not self.rows:
            return ""
        headers = list(self.rows[0])
        return tabulate([[r.get(h) for h in headers] for r in self.rows],
                        headers, tablefmt=tablefmt)

    def jsonl(self):
        head = {"solver": self.solver, "L": self.L}
        return "\n".join(json.dumps({**head, **r}) for r in self.rows)

    def write(self, path):
        with open(path, "a") as f:
            f.write(self.jsonl() + "\n")


# (the open job or None, the name of the innermost open span or None)
_OPEN = contextvars.ContextVar("ecw_cc_torch_span", default=(None, None))


class job(contextlib.ContextDecorator):
    """The spans of one call of the program: `id`, and `rows`, the
    (name, parent, start_ns, end_ns) of each span in the order they
    ended.  A context manager, current until its block ends (the
    enclosing job, if any, is current again after it), or the decorator
    of a function, one job per call."""

    _ids = itertools.count(1)

    def __init__(self):
        self.id = next(job._ids)
        self.rows = []

    def _recreate_cm(self):
        return job()

    def __enter__(self):
        self._token = _OPEN.set((self, None))
        return self

    def __exit__(self, *exc):
        _OPEN.reset(self._token)


def current_job():
    """The job that spans are recorded into now, or None."""
    return _OPEN.get()[0]


def _unit_ns(key):
    if key == "ms" or key.endswith("_ms"):
        return 1e6
    if key.endswith("_s"):
        return 1e9
    raise ValueError(f"span key {key!r} names no unit ('ms', '*_ms', "
                     "'*_s')")


class span:
    """Context manager: one span of the program (module docstring).
    log, key: the dict and the key its duration is added to."""

    __slots__ = ("name", "log", "key", "_unit", "_token", "_job",
                 "_parent", "_rf", "_t0")

    def __init__(self, name, log=None, key=None):
        if key is not None:
            if log is None:
                raise ValueError("span: a key needs a log")
            self._unit = _unit_ns(key)
        self.name, self.log, self.key = name, log, key

    def __enter__(self):
        self._job, self._parent = _OPEN.get()
        self._token = _OPEN.set((self._job, self.name))
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _OPEN.reset(self._token)
        if self._job is not None:
            self._job.rows.append((self.name, self._parent, self._t0, t1))
        if self.key is not None:
            self.log[self.key] = (self.log.get(self.key, 0.0)
                                  + (t1 - self._t0) / self._unit)


class StageClock:
    """Host-clock seconds of the stages of a computation on `device`:
    `with clock(key):` is span(prefix + key less its '_s', log, key),
    the device synchronized as it opens and as it closes, so that the
    stage's seconds hold its device work.  With log=None a stage is a
    span that stores nothing and costs no synchronization."""

    def __init__(self, device, log, prefix):
        self.device, self.log, self.prefix = device, log, prefix

    def _sync(self):
        if self.log is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sub(self, name):
        """The dict log[name] for a callee's own log (None without a log)."""
        return None if self.log is None else self.log.setdefault(name, {})

    @contextlib.contextmanager
    def __call__(self, key):
        self._sync()
        with span(self.prefix + key.removesuffix("_s"), self.log,
                  None if self.log is None else key):
            yield
            self._sync()


@contextlib.contextmanager
def profile_trace(logdir):
    """torch.profiler trace of the body, host and (where a card is present)
    CUDA activity, written into `logdir` as a TensorBoard-compatible
    Chrome trace (*.pt.trace.json).  Yields the profiler, whose
    key_averages() the caller may read."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name):
    """Named region in the profiler's traces: span(name), which enters
    torch.profiler.record_function(name) while the profiler runs."""
    return span(name)
