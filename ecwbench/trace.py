"""The traced run's reduction: device intervals from torch.profiler, the
busy time (their union), the device operations that took most time, and
the longest idle gaps by what the host was doing.  Kept in memory; no
trace file is written.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def profiled():
    """Yields a holder whose .events, after the block, are the profiled
    window's (device operations, host operations, window seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    class Holder:
        events = None

    holder = Holder()
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        yield holder
        sync()
        window = time.perf_counter() - t0
    holder.events = split_events(prof) + (window,)


def split_events(prof):
    """([(name, start_us, end_us)] of device operations, the same of host
    operations), from the profiler's raw records."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        rec = (e.name(), start, start + e.duration_ns() / 1e3)
        if not str(e.device_type()).endswith("CUDA"):
            host.append(rec)
        elif not _annotation(e):
            dev.append(rec)
    return dev, host


def _annotation(e):
    """Whether a device record is a user annotation's span, which is no
    device work (the harness sets none; torch versions differ in how a
    record says what it is)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind())
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals):
    """[(start, end)] of the idle gaps between the device intervals."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def breakdown(dev, host, top=10):
    """{'device_ops': [[name, seconds]] of the most time, 'idle_gaps':
    [[host op covering the gap's middle, seconds]] of the longest gaps}."""
    by = {}
    for name, s, e in dev:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps([(s, e) for _, s, e in dev]),
                     key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in longest:
        mid = 0.5 * (s + e)
        cover = [(he - hs, n) for n, hs, he in host if hs <= mid <= he]
        # the innermost host operation running at the gap's middle
        name = min(cover)[1] if cover else "host (no profiled op)"
        named.append([name, (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
