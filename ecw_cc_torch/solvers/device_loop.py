"""The solver loops' counterpart of jax.jit + lax.while_loop: one iteration
captured once as a CUDA graph and replayed while the loop runs; and of a
jitted program called once per host round trip (`Program`).

The JAX package compiles each solve (JAX gs.py:681-1041, :203-310, es.py:
615-842) as one lax.while_loop on the device.  Here a solver writes its
iteration as `body(state) -> state` over a flat tuple of device tensors:
state[0] is `go`, a 0-d bool tensor that says whether another iteration
is due, and the body returns the next state with every tensor of the same
shape, dtype and device.  A `Loop` iterates it until `go` is false,
reading that one flag to the host after each iteration.

On CUDA tensors the first iteration runs eagerly (the warm-up: the
kernel library, the cuBLAS and cuSOLVER handles and the kernel plans are
set up there), then one iteration is captured into a torch.cuda.CUDAGraph
with its own memory pool, ending in copies of the new state into static
buffers that the graph also reads, and the graph is replayed while `go`
says so.  A body may therefore make no host read and issue the same
launches at every iteration: every decision is a tensor (torch.where, a
mask), every write at a data-dependent place goes to a tensor index
(ops/diis.py's ring, the solvers' history columns).  A capture or a replay
that fails raises: no eager loop takes over on the card.  The warm-up,
the capture and the replays run on one side stream per device, shared
by every Loop, ordered after the caller's work and before what follows:
torch keeps a cuBLAS workspace for each stream it runs cuBLAS on for as
long as the process lives, so a stream per Loop would leave a workspace
behind for each stream of torch's pool.  A Loop keeps its graph, its
pool and its static state for its lifetime: its next call starts
replaying at once (Solver_CCSD, Solver_CCS and SolverES_Device keep
their loops across the lambdas of a sweep, the weights a device tensor
the body reads, until their release_graphs()).

A replay launches the ladder kernel without passing through its wrapper,
so the loop takes the wrapper's launch counters' change over the capture
(which launched nothing) and adds it times the replays once per call:
after each call the counts are those of the kernel launches made.

A Loop counts its graph's nodes once, at the capture (`_graph_nodes`,
through the CUDA driver's cuGraphGetNodes on the graph kept for it):
'nodes', its kernel nodes, the launches of one replay, and
'other_nodes', its memcpy and memset nodes.  The stages of a call are
spans (utils/metrics.py): 'loop.warm_up', 'loop.empty_cache',
'loop.capture', 'loop.replays'.

On the CPU the same body is called eagerly.

`scan(body, state, n)` is the counterpart of a lax.scan of known length
(JAX ccsd_t.py:185, the (T) pairs): the body runs n times, with no flag
and no host read between steps; on the card the first step is the
warm-up, the second is captured and the graph replayed n - 1 times, then
freed.  A scan body may take gradients inside itself (torch.enable_grad()
around its part): autograd runs each backward operation on its forward
operation's stream, here the capture's, so the backward is captured with
its forward.  A Loop body that applies an autograd graph evaluated before
the loop (the (T) adjoint's map) needs that graph evaluated on the side
stream (`on_side_stream`) for the same reason.

`Program(body, inputs)` is the third form, the counterpart of a jitted
program that the host calls once per round trip: the pipelined Davidson
of the EOM-EE/IP/EA solves and of Solver_ES.SCF_diag(davidson=True)
(utils/linalg.davidson_device; JAX linalg.py:613-642), whose host solves
the small eigenproblem between cycles.  Each call copies the host's
small inputs into a static buffer, runs the body (the first call eagerly,
the second captured and replayed, the rest replayed) and reads its one
packed output: on the card a cycle is one copy, one graph launch and one
read.  The EOM matvecs inside apply autograd graphs built before the
solve on the side stream (ops/eom._linearize, ops/eom_ipea._mv_factory),
as the adjoint's map.

The bordered DIIS system is solved by torch.linalg.solve_ex; the warm-up
and the capture run with cuSOLVER as the preferred linear-algebra library,
whose LU factorization and solve are device routines that a graph
captures (MAGMA, which torch may pick for small batched systems, factors
on the host).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc

import numpy as np
import torch

from ecw_cc_torch.config import matmul_precision
from ecw_cc_torch.kernels import ladder_mm as _lmm
from ecw_cc_torch.utils.metrics import span


@contextlib.contextmanager
def _cusolver():
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


class Loop:
    """A loop body with its captured graph.  Calling it iterates the body
    from a state until state[0] is false, under config.matmul_precision(
    mode) and torch.no_grad(), and returns the final state; log:
    a dict that receives 'graph' (whether the iterations after the first
    replayed a captured graph), 'iterations', where this call ran the
    warm-up 'warm_up_ms' (the eager first iteration with its flag read),
    where it captured 'empty_cache_ms' and 'capture_ms' (the capture and
    the graph's instantiation, wall time), and where it replayed
    'replays', 'replay_ms' (their wall time, each flag read included),
    'replay_dev_ms' (CUDA events around each replay, read after its flag
    read: the graph's launch and its execution, since the stream is idle
    when the first event is recorded), 'nodes' and 'other_nodes' (the
    graph's, as counted at its capture).

    The graph and its static state live as long as the Loop: a next call
    copies its state into the static buffers and replays at once (no
    warm-up, no capture), so a solver that runs the same body again (the
    lambdas of a sweep, the weights a device tensor the body reads) keeps
    its Loop.  A call returns the static state, which the next call
    overwrites: the caller copies what must outlive that."""

    def __init__(self, body, *, mode="highest"):
        self.body, self.mode = body, mode
        self.graph = self.static = self.per_replay = self.nodes = None
        self.events = None

    def __call__(self, state, log=None):
        state = tuple(state)
        log = {} if log is None else log
        log.update(graph=False, iterations=0)
        with torch.no_grad(), matmul_precision(self.mode):
            if state[0].device.type != "cuda":
                while bool(state[0]):          # the one read per iteration
                    state = tuple(self.body(state))
                    log["iterations"] += 1
                return state
            caller = torch.cuda.current_stream(state[0].device)
            side = _side_stream(state[0].device)
            side.wait_stream(caller)
            try:
                with torch.cuda.stream(side), _cusolver():
                    return self._run_graph(state, log)
            finally:
                caller.wait_stream(side)

    def _run_graph(self, state, log):
        if not bool(state[0]):
            return state
        if self.graph is None:
            with span("loop.warm_up", log, "warm_up_ms"):
                state = tuple(self.body(state))
                log["iterations"] = 1
                go = bool(state[0])
            if not go:
                return state
            self.static = _owned(state)
            del state
            self.graph, self.per_replay = _capture(self.body, self.static,
                                                   log)
            self.nodes = _graph_nodes(self.graph.raw_cuda_graph())
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        else:
            for s, t in zip(self.static, state):
                s.copy_(t)
            del state
        log.update(graph=True, nodes=self.nodes[0],
                   other_nodes=self.nodes[1])
        start, end = self.events
        n0, dev_ms = log["iterations"], 0.0
        with span("loop.replays", log, "replay_ms"):
            while True:
                start.record()
                self.graph.replay()
                end.record()
                log["iterations"] += 1
                go = bool(self.static[0])      # the one read per iteration
                dev_ms += start.elapsed_time(end)
                if not go:
                    break
        replays = log["iterations"] - n0
        _lmm.add_launch_counts(self.per_replay, replays)
        log.update(replays=replays, replay_dev_ms=dev_ms)
        return self.static

    @property
    def captured(self):
        """Whether the next call replays at once (a kept graph)."""
        return self.graph is not None


def _capture(body, static, log):
    """(graph, launch counts per replay) of one call of body on the static
    state, its outputs copied into the static buffers at its end; log
    receives 'empty_cache_ms' and 'capture_ms'."""
    ptrs = {t.untyped_storage().data_ptr() for t in static}
    # the warm-up's blocks go back before the graph's pool is filled
    with span("loop.empty_cache", log, "empty_cache_ms"):
        torch.cuda.empty_cache()
    before = _lmm.launch_counts()
    # the graph is kept after instantiation, so that a Loop can count its
    # nodes
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    # capture_begin/end on the side stream (the current one here), not
    # the torch.cuda.graph context, which runs a full garbage
    # collection first.  The collector is off during the capture
    # instead: a graph it freed there (one left in a reference cycle)
    # would invalidate the capture
    with span("loop.capture", log, "capture_ms"):
        gc_was_on = gc.isenabled()
        gc.disable()
        graph.capture_begin()
        try:
            out = tuple(body(static))
            if len(out) != len(static):
                raise ValueError("device_loop: the body returned "
                                 f"{len(out)} tensors for a state of "
                                 f"{len(static)}")
            for s, o in zip(static, out):
                if (o.data_ptr() == s.data_ptr() and o.shape == s.shape
                        and o.stride() == s.stride()):
                    continue                   # written in place
                if o.untyped_storage().data_ptr() in ptrs:
                    raise ValueError("device_loop: the body returned a "
                                     "view of a state tensor in another "
                                     "place; the copies into the static "
                                     "state would overwrite it")
                s.copy_(o)
        finally:
            graph.capture_end()
            if gc_was_on:
                gc.enable()
        del out
        graph.instantiate()
    per_replay = _lmm.launch_counts(since=before)
    # the capture launched nothing
    _lmm.add_launch_counts(per_replay, -1)
    return graph, per_replay


# CUgraphNodeType (cuda.h): kernel, memcpy, memset
_KERNEL_NODE, _MEMCPY_NODE, _MEMSET_NODE = 0, 1, 2


@functools.cache
def _libcuda():
    """The CUDA driver, which every CUDA process has loaded, with the two
    graph queries declared."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t))
    cu.cuGraphGetNodes.restype = ctypes.c_int
    cu.cuGraphNodeGetType.argtypes = (ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int))
    cu.cuGraphNodeGetType.restype = ctypes.c_int
    return cu


def _graph_nodes(raw):
    """(kernel nodes, memcpy + memset nodes) of the cudaGraph_t `raw` (an
    int), by the driver's cuGraphGetNodes and cuGraphNodeGetType (a
    runtime graph is a driver graph)."""
    cu = _libcuda()
    n = ctypes.c_size_t(0)
    _cu_check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)),
              "cuGraphGetNodes")
    handles = (ctypes.c_void_p * n.value)()
    _cu_check(cu.cuGraphGetNodes(raw, handles, ctypes.byref(n)),
              "cuGraphGetNodes")
    kinds = []
    kind = ctypes.c_int(0)
    for h in handles[:n.value]:
        _cu_check(cu.cuGraphNodeGetType(h, ctypes.byref(kind)),
                  "cuGraphNodeGetType")
        kinds.append(kind.value)
    return (kinds.count(_KERNEL_NODE),
            kinds.count(_MEMCPY_NODE) + kinds.count(_MEMSET_NODE))


def _cu_check(status, what):
    if status != 0:
        raise RuntimeError(f"device_loop: {what} returned CUresult "
                           f"{status}")


def scan(body, state, n, log=None):
    """state after n calls of body(state) -> state (a flat tuple of
    tensors of fixed shapes, dtypes and devices), with no host read
    between the steps: the counterpart of lax.scan.  A step index the body
    needs lives in the state as a 0-d int64 tensor that the body
    increments.

    On the CPU the body runs n times as it is called (the caller's grad
    mode).  On CUDA tensors, under torch.no_grad() (the body enables grad
    for its own part) and matmul_precision('highest'): the first step runs
    eagerly (the warm-up), the second is captured (which runs nothing)
    and the graph replayed for steps 2 to n, n - 1 replays, on the side
    stream, ordered after the caller's work and before what follows; the
    graph and its pool are freed on return.  The launch counters grow by
    the capture's count times the replays, as in Loop.  n = 0 and n = 1
    capture nothing.  log: a dict that receives 'steps', 'graph', and where
    a graph ran 'empty_cache_ms', 'capture_ms', 'replays' and 'replay_ms'
    (the replays' wall time, enqueue only)."""
    state = tuple(state)
    log = {} if log is None else log
    log.update(steps=n, graph=False)
    if n <= 0:
        return state
    if state[0].device.type != "cuda":
        for _ in range(n):
            state = tuple(body(state))
        return state
    caller = torch.cuda.current_stream(state[0].device)
    side = _side_stream(state[0].device)
    side.wait_stream(caller)
    try:
        with (torch.no_grad(), matmul_precision("highest"),
              torch.cuda.stream(side), _cusolver()):
            with span("loop.warm_up"):
                state = tuple(body(state))
            if n == 1:
                return state
            static = _owned(state)
            del state
            graph, per_replay = _capture(body, static, log)
            log["graph"] = True
            with span("loop.replays", log, "replay_ms"):
                for _ in range(n - 1):
                    graph.replay()
            _lmm.add_launch_counts(per_replay, n - 1)
            log["replays"] = n - 1
            del graph
            return static
    finally:
        caller.wait_stream(side)


class Program:
    """A body run once per call, with host data in and one host read out:
    the counterpart of a jitted program that the host calls once per round
    trip, for a loop whose decisions are made on the host between its
    iterations (the pipelined Davidson's cycle, utils/linalg.py, whose
    host solves the small eigenproblem; JAX linalg.py:613-642).

    body() takes no argument.  It reads `inputs`, a static device buffer
    that each call first fills from a host array (one copy), and the
    tensors it keeps and updates in place, and returns one flat tensor,
    which the call reads to the host (one read) and returns as a NumPy
    array.  Calls run under torch.no_grad() and matmul_precision(mode).
    On CUDA tensors the first call runs body eagerly (the warm-up), the
    second captures it as a CUDA graph (as Loop does: `_capture`, the
    launch counters' change over the capture added at each replay) and
    replays it, and the later calls replay it, all on the Loops' side
    stream: one copy, one graph launch and one read per call.  A body may
    therefore make no host read and issues the same launches at every
    call.  A capture or replay that fails raises.  On the CPU the body runs
    eagerly at every call.  Counts: `replays`, and where a capture ran
    `capture_ms` and `empty_cache_ms`.  release() frees the graph and its
    pool."""

    def __init__(self, body, inputs, *, mode="highest"):
        self.body, self.inputs, self.mode = body, inputs, mode
        self.graph = self.out = self.per_replay = None
        self.replays = 0
        self.capture_ms = self.empty_cache_ms = None

    def __call__(self, host=None):
        """body's output after one call, as NumPy; `host`: the values of
        `inputs` for this call (None: keep the last call's)."""
        with torch.no_grad(), matmul_precision(self.mode), \
                on_side_stream(self.inputs.device):
            if host is not None:
                self.inputs.copy_(torch.from_numpy(np.ascontiguousarray(
                    host)).to(self.inputs.dtype))
            if self.inputs.device.type != "cuda":
                return self.body().numpy().copy()
            if self.out is None:
                self.out = self.body()          # the warm-up call
                return self.out.cpu().numpy()
            if self.graph is None:
                log = {}
                self.graph, self.per_replay = _capture(
                    lambda static: (self.body(),), (self.out,), log)
                self.capture_ms = log["capture_ms"]
                self.empty_cache_ms = log["empty_cache_ms"]
            self.graph.replay()
            _lmm.add_launch_counts(self.per_replay)
            self.replays += 1
            return self.out.cpu().numpy()

    def release(self):
        self.graph = self.out = None


@contextlib.contextmanager
def on_side_stream(device):
    """Run the block on `device`'s side stream (a no-op on the CPU),
    ordered after the caller's work and before what follows it: an
    autograd graph that a Loop body applies is evaluated here, so that
    its backward is launched on the capture's stream."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    caller = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(caller)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        caller.wait_stream(side)


_SIDE = {}      # device index -> the Loops' side stream


def _side_stream(device):
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SIDE:
        _SIDE[idx] = torch.cuda.Stream(idx)
    return _SIDE[idx]


def _owned(state):
    """The state as static buffers: each tensor that alone spans its
    storage as it is, the others (views, tensors that share a storage)
    copied."""
    seen = {}
    for t in state:
        p = t.untyped_storage().data_ptr()
        seen[p] = seen.get(p, 0) + 1
    return tuple(
        t if (seen[t.untyped_storage().data_ptr()] == 1
              and t.storage_offset() == 0 and t.is_contiguous()
              and t.untyped_storage().nbytes() == t.numel()
              * t.element_size()) else t.clone()
        for t in state)
