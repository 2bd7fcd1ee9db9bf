"""Reading a torch.profiler trace: device busy time, kernels, idle gaps.

The interval arithmetic is a frozen copy of
gps_sdr_tpu_torch/utils/profiling.py (the union of a lane's intervals,
device events told apart by category) and of examples/roofline.py's
bucketing by kernel name.  Only the events inside the one host span
named MEASURED count, each clipped to it: a profiler session can lose
its first device events, so the harness opens that span only after a
lead-in of traced work.
"""

from __future__ import annotations

import heapq
import json
from collections import defaultdict

MEASURED = "gsbench.measured"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
KERNELS = {"wipeoff": ("wipeoff_kernel", "wipeoff_vpu_kernel"),
           "cheap": ("cheap_kernel",)}


def union(iv: list) -> float:
    """Length of the union of (start, end) intervals."""
    iv = sorted(iv)
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


def gaps(iv: list, a0: float, a1: float) -> list:
    """The (start, end) stretches of [a0, a1] that no interval covers."""
    out, t = [], a0
    for a, b in sorted(iv):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < a1:
        out.append((t, a1))
    return out


def kernel_kind(name: str) -> str | None:
    """"wipeoff" or "cheap" for the receiver's hand-written kernels (by
    the CUDA function's name, which the trace shows with its template
    arguments and signature), else None."""
    for kind, names in KERNELS.items():
        if any(n in name for n in names):
            return kind
    return None


def short(name: str, n: int = 96) -> str:
    """A kernel's name without its namespace noise, cut to n letters."""
    name = name.replace("(anonymous namespace)::", "").replace(
        "at::native::", "")
    if name.startswith("void "):
        name = name[5:]
    return name[:n]


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def summarize(events: list, top: int = 10) -> dict:
    """The measured span's device time: {"window_s", "devices": {pid:
    busy_s}, "busy_s" (mean over devices), "kernels": {kind: {"s",
    "count"}} (summed over devices), "device_ops": [[name, s]] (mean
    over devices), "idle_gaps": [[host activity, s]] (mean over
    devices)}."""
    spans = [e for e in events if e.get("name") == MEASURED
             and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} {MEASURED!r} spans in the trace")
    a0 = spans[0]["ts"]
    a1 = a0 + spans[0]["dur"]
    dev_iv = defaultdict(list)
    ops = defaultdict(float)
    kinds = {k: {"s": 0.0, "count": 0} for k in KERNELS}
    host = []
    for e in events:
        if e.get("ph") != "X" or e.get("ts") is None or e.get("dur") is None:
            continue
        s, t = max(e["ts"], a0), min(e["ts"] + e["dur"], a1)
        cat = e.get("cat")
        if cat in HOST_CATS and e["ts"] <= a1 and e["ts"] + e["dur"] >= a0:
            host.append(e)
        if cat not in DEVICE_CATS or t <= s:
            continue
        dev_iv[e.get("pid")].append((s, t))
        name = e.get("name", "?")
        ops[name] += (t - s) / 1e6
        kind = kernel_kind(name) if cat == "kernel" else None
        if kind is not None and e["ts"] >= a0:
            kinds[kind]["s"] += (t - s) / 1e6
            kinds[kind]["count"] += 1
    n_dev = max(1, len(dev_iv))
    busy = {pid: union(iv) / 1e6 for pid, iv in dev_iv.items()}
    idle = defaultdict(float)
    for iv in dev_iv.values():
        for name, s in _gap_activity(gaps(iv, a0, a1), host):
            idle[name] += s / n_dev
    return {
        "window_s": (a1 - a0) / 1e6,
        "devices": busy,
        "busy_s": sum(busy.values()) / n_dev,
        "kernels": kinds,
        "device_ops": [[short(k), v / n_dev] for k, v in
                       sorted(ops.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[k, v] for k, v in
                      sorted(idle.items(), key=lambda x: -x[1])[:top]],
    }


def _gap_activity(gap_iv: list, host: list) -> list:
    """[(what the host was doing at the gap's middle, gap seconds)]: the
    innermost benchmark span ("gsbench.*", else "receiver loop") and
    the innermost host operator or runtime call there ("python" where
    none is)."""
    evs = sorted(host, key=lambda e: e["ts"])
    out = []
    heap_op: list = []
    heap_span: list = []
    i = 0
    for g0, g1 in sorted(gap_iv, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while i < len(evs) and evs[i]["ts"] <= mid:
            e = evs[i]
            item = (-e["ts"], i, e["ts"] + e["dur"], e.get("name", "?"))
            if e.get("name", "").startswith("gsbench."):
                heapq.heappush(heap_span, item)
            else:
                heapq.heappush(heap_op, item)
            i += 1
        for heap in (heap_op, heap_span):
            # drop ended events that sit on top; an ended event under a
            # live one is dropped when it surfaces
            while heap and heap[0][2] < mid:
                heapq.heappop(heap)
        span = (heap_span[0][3][len("gsbench."):] if heap_span
                else "receiver loop")
        if span == MEASURED[len("gsbench."):]:
            span = "receiver loop"
        op = heap_op[0][3] if heap_op else "python"
        out.append((f"{span}: {op}", (g1 - g0) / 1e6))
    return out
