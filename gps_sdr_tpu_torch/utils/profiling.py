"""Throughput observability of the port.

Port of gps_sdr_tpu/utils/profiling.py.  RateMeter (copied) tracks
samples/s and the real-time factor over a sliding window; `trace()`
wraps torch.profiler and writes a Chrome trace (viewable in Perfetto),
and device_time_from_trace / op_breakdown_from_trace read the device's
busy time and per-kernel totals back from it, with the JAX module's
keys.  enable_compile_cache has no counterpart: the port compiles
nothing per shape (its kernels are built once, ops/_build.py).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field


@dataclass
class RateMeter:
    """Sliding-window samples/s + real-time-factor meter."""

    sample_rate: float                 # stream samples per stream second
    window_sec: float = 10.0
    _events: deque = field(default_factory=deque)   # (wall_t, n_samples)
    total_samples: int = 0
    t0: float | None = None

    def add(self, n_samples: int) -> None:
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        self.total_samples += n_samples
        self._events.append((now, n_samples))
        cutoff = now - self.window_sec
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    @property
    def samples_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        span = self._events[-1][0] - self._events[0][0]
        n = sum(e[1] for e in self._events) - self._events[0][1]
        return n / span if span > 0 else 0.0

    @property
    def realtime_factor(self) -> float:
        """Processing speed relative to the stream's own rate."""
        return self.samples_per_sec / self.sample_rate

    def summary(self) -> dict:
        wall = (time.perf_counter() - self.t0) if self.t0 else 0.0
        return {
            "total_samples": self.total_samples,
            "wall_sec": round(wall, 3),
            "mean_rtf": round(
                self.total_samples / self.sample_rate / wall, 2)
            if wall > 0 else 0.0,
            "window_rtf": round(self.realtime_factor, 2),
            "window_msamples_per_sec": round(
                self.samples_per_sec / 1e6, 2),
        }


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
