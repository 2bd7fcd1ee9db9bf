"""Observability of the port: spans and counters, and the profiler trace.

`span(name)` times one stage of the program where the work happens;
`count(name, n)` keeps an integer counter beside it.  Both
keep host totals for the life of the process, which `snapshot()` reads
and `reset()` clears.  While a torch.profiler session runs, a span also
opens a `record_function` of its name, so it lands in the profiler's
trace on that trace's clock, beside the device's kernels and copies;
with no profiler running it opens none.  A span or counter that
overlaps a profiler session adds nothing to the totals, which thereby
stay on the untraced host clock.

`trace()` wraps torch.profiler and writes a Chrome trace (viewable in
Perfetto), and device_time_from_trace / op_breakdown_from_trace read
the device's busy time and per-kernel totals back from it, with the
JAX module's keys (port of gps_sdr_tpu/utils/profiling.py).
enable_compile_cache has no counterpart: the port compiles nothing per
shape (its kernels are built once, ops/_build.py).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch

RING = 8192           # durations a span name keeps for its percentiles

_pc = time.perf_counter
_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()      # guards _threads
_threads: list = []           # every thread's (spans, counts)


class _Totals:
    __slots__ = ("count", "total_s", "self_s", "ring")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.self_s = 0.0
        self.ring = deque(maxlen=RING)


class _Local(threading.local):
    """A thread's open spans and its own totals: only the thread writes
    them, so the hot path takes no lock; snapshot() sums the threads."""

    def __init__(self):
        self.open = []        # open spans, innermost last
        self.spans = {}       # name -> _Totals
        self.counts = {}      # name -> int
        with _lock:
            _threads.append((self.spans, self.counts))


_local = _Local()


class span:
    """Time the `with` block as stage `name`.

    On exit `seconds` holds the block's duration, whatever the profiler
    did.  The totals of `name` gain a count, the duration, its self time
    (the duration less what the spans nested in it on this thread
    cover) and a ring entry, unless the block overlapped a profiler
    session: the profiler was on at its entry or exit, or at the entry
    or exit of a span or counter inside it.  Its duration counts as
    child time of the enclosing span either way.  A span inside a
    generator is closed before the generator yields: the consumer's
    work must not land in it."""

    __slots__ = ("name", "seconds", "_t0", "_child", "_rf", "_traced")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            self._traced = True
        else:
            self._rf = None
            self._traced = False
        self._child = 0.0
        _local.open.append(self)
        self._t0 = _pc()
        return self

    def __exit__(self, *exc) -> None:
        dt = self.seconds = _pc() - self._t0
        loc = _local
        opened = loc.open
        opened.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        elif _profiling():
            self._traced = True
        if opened:
            parent = opened[-1]
            parent._child += dt
            if self._traced:
                parent._traced = True
        if self._traced:
            return
        t = loc.spans.get(self.name)
        if t is None:
            t = loc.spans[self.name] = _Totals()
        t.count += 1
        t.total_s += dt
        t.self_s += dt - self._child
        t.ring.append(dt)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name`; under a profiler session nothing is
    added and the enclosing span counts as traced."""
    loc = _local
    if _profiling():
        if loc.open:
            loc.open[-1]._traced = True
        return
    loc.counts[name] = loc.counts.get(name, 0) + n


def snapshot() -> dict:
    """The totals of every thread summed, as plain data: {"spans":
    {name: {"count", "total_s", "self_s", "durations_s" (the last RING
    durations of each thread, oldest first)}}, "counts": {name: n}}."""
    spans: dict = {}
    counts: dict = {}
    with _lock:
        threads = list(_threads)
    for thread_spans, thread_counts in threads:
        for k, t in list(thread_spans.items()):
            s = spans.setdefault(k, {"count": 0, "total_s": 0.0,
                                     "self_s": 0.0, "durations_s": []})
            s["count"] += t.count
            s["total_s"] += t.total_s
            s["self_s"] += t.self_s
            s["durations_s"] += list(t.ring)
        for k, n in list(thread_counts.items()):
            counts[k] = counts.get(k, 0) + n
    return {"spans": spans, "counts": counts}


def reset() -> None:
    """Clear every thread's span totals and counters."""
    with _lock:
        threads = list(_threads)
    for thread_spans, thread_counts in threads:
        thread_spans.clear()
        thread_counts.clear()


TRACE_SUFFIX = ".pt.trace.json.gz"
# device events of a torch.profiler (Kineto) trace; the host's operators
# are "cpu_op"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host operators and, where CUDA is available,
    its device kernels and copies; on exit write a Chrome trace
    (gzipped, `*.pt.trace.json.gz`) into `log_dir`.  Yields the
    torch.profiler.profile object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.time_ns()}{TRACE_SUFFIX}"))


def _newest_trace(log_dir: str) -> list:
    """The events of the newest trace under `log_dir`."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*" + TRACE_SUFFIX),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with gzip.open(paths[-1], "rt") as f:
        return json.load(f)["traceEvents"]


def _timed_events(events: list) -> tuple[list, str]:
    """(the complete events of the device lanes, "device"), or those of
    the host's operators and "host" when the trace holds no device
    event (a CPU run), so the parser still works there and says so."""
    timed = [ev for ev in events if ev.get("ph") == "X"
             and ev.get("ts") is not None and ev.get("dur") is not None]
    dev = [ev for ev in timed if ev.get("cat") in _DEVICE_CATS]
    if dev:
        return dev, "device"
    return [ev for ev in timed if ev.get("cat") == "cpu_op"], "host"


def _union(iv: list) -> float:
    """Length of the union of (start, end) intervals."""
    iv.sort()
    tot, cur0, cur1 = 0.0, None, None
    for a, b in iv:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                tot += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        tot += cur1 - cur0
    return tot


def device_time_from_trace(log_dir: str) -> dict:
    """Parse the newest trace() under `log_dir` and return device-side
    timing:

      {"busy_s":  the busiest lane's busy time,
       "busy_all_lanes_s": the lanes' busy times summed,
       "span_s":  last event end - first start (includes gaps),
       "n_ops":   events counted, "n_lanes": lanes,
       "lane":    "device", or "host" for a trace without device events}

    A lane is a (pid, tid) of the trace: a CUDA stream of a device, or a
    host thread.  Nested events (a host operator that calls others) and
    several lanes would double-count a plain sum of durations, so busy
    time is the union of the intervals of each lane, as the JAX
    module's."""
    events, backend = _timed_events(_newest_trace(log_dir))
    lane_iv: dict = {}
    t0, t1 = None, None
    for ev in events:
        ts, dur = ev["ts"], ev["dur"]
        lane_iv.setdefault((ev.get("pid"), ev.get("tid")),
                           []).append((ts, ts + dur))
        t0 = ts if t0 is None else min(t0, ts)
        t1 = (ts + dur) if t1 is None else max(t1, ts + dur)
    lane_busy = {k: _union(v) for k, v in lane_iv.items()}
    busy = max(lane_busy.values()) if lane_busy else 0.0
    return {"busy_s": busy / 1e6,
            "busy_all_lanes_s": sum(lane_busy.values()) / 1e6,
            "span_s": ((t1 - t0) / 1e6 if t0 is not None else 0.0),
            "n_ops": len(events), "n_lanes": len(lane_busy),
            "lane": backend}


def op_breakdown_from_trace(log_dir: str, top: int = 20) -> list:
    """Per-op totals on the busiest lane of the newest trace() under
    `log_dir`: [(op_name, total_s, count), ...] sorted by total time.
    On a device lane the names are the kernels' (the port's
    wipeoff_kernel, cheap_kernel, ..., cuFFT's, PyTorch's elementwise
    ones) and copies'; a trace without device events reads the host's
    operators."""
    events, _ = _timed_events(_newest_trace(log_dir))
    lane_busy: dict = defaultdict(float)
    for ev in events:
        lane_busy[ev.get("pid"), ev.get("tid")] += ev["dur"]
    if not lane_busy:
        return []
    best = max(lane_busy, key=lane_busy.get)
    ops = defaultdict(lambda: [0.0, 0])
    for ev in events:
        if (ev.get("pid"), ev.get("tid")) == best:
            o = ops[ev.get("name", "?")]
            o[0] += ev["dur"] / 1e6
            o[1] += 1
    out = sorted(((k, v[0], v[1]) for k, v in ops.items()),
                 key=lambda x: -x[1])
    return out[:top]
