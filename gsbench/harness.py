"""One run of one cell: set-up, the measured window, the check.

Set-up builds the program's kernels and host libraries where the
checkout lacks them (timed apart as build_s), makes the cell's captures
(generator.py), builds the entry's driver (gsbench/drivers/<entry>.py)
and warms it with one whole session or pass over the cell's own
captures, which loads every kernel and plan the window uses.  The window then runs the entry closed
loop for `seconds`; with a trace, the loop goes on under torch.profiler
for a lead-in and then for the traced span (traceio.MEASURED), whose
edges wait for the devices so that the program's counters and the
device timeline cover the same work.  After the window the peak memory
is read, the program's state is freed and the answers are judged
(judge.py); the metrics' readers (gsbench/metrics/<name>.py) then take
their numbers from the run.
"""

from __future__ import annotations

import gc
import importlib
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from gsbench import generator, judge, manifest, traceio

_pc = time.perf_counter


def kernel_launches() -> dict:
    """The program's own launch counters of its hand-written kernels."""
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff
    return {"wipeoff": (hopper_wipeoff.mix_wipeoff.launches
                        + hopper_wipeoff.mix_wipeoff_vpu.launches),
            "cheap": hopper_cheap.cheap_scan.launches}


def build_s(devices: list) -> float:
    """Seconds the program spends compiling its host libraries and, for
    a card, its kernels: the whole build in a checkout's first run, 0
    once they are built."""
    from gps_sdr_tpu_torch import nativecore
    from gps_sdr_tpu_torch.ops import _build
    s = nativecore.build()[1]
    if any(d.type == "cuda" for d in devices):
        s += _build.build()[1]
    return s


def host_probe_ms(reps: int = 3) -> float:
    """Best of `reps` walls of a fixed NumPy and Python workload shaped as
    the evaluator's (small batched float64 solves, transcendentals, plain
    interpreter work): the host's speed, printed beside each run's
    numbers (gps_sdr_tpu_torch/bench.py host_probe_ms, copied)."""
    rng = np.random.default_rng(42)
    a = rng.normal(size=(256, 8, 4))
    v = rng.normal(size=(256, 8))
    big = rng.normal(size=200_000)
    best = float("inf")
    for _ in range(reps):
        t0 = _pc()
        m = a.transpose(0, 2, 1) @ a + np.eye(4)
        rhs = a.transpose(0, 2, 1) @ v[:, :, None]
        np.linalg.solve(m, rhs)
        np.sqrt(np.abs(np.sin(big))).sum()
        acc = 0
        for i in range(20_000):
            acc += i & 7
        best = min(best, _pc() - t0)
    return best * 1e3


def sync(devices: list) -> None:
    import torch
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Window:
    """The measured window and, with a trace, the traced span after it.
    Drivers call tick() at each epoch that leaves the evaluator and
    between sessions; it says when to stop."""

    def __init__(self, seconds: float, trace: dict | None, devices: list,
                 counters, tmpdir: str):
        self.seconds = seconds
        self.trace = trace
        self.devices = devices
        self.counters = counters
        self.tmpdir = tmpdir
        self.phase = "idle"
        self.t0 = self.t_end = None
        self.trace_path = None
        self.delta: dict = {}
        self._prof = self._span = self._base = None
        self._next = None

    def start(self) -> None:
        self.t0 = _pc()
        self.t_end = self.t0 + self.seconds
        self.phase = "window"

    @property
    def done(self) -> bool:
        return self.phase == "done"

    @property
    def tracing(self) -> bool:
        return self.phase in ("lead", "traced")

    def tick(self, now: float) -> bool:
        import torch
        if self.phase == "window" and now >= self.t_end:
            if self.trace is None:
                self.phase = "done"
            else:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if any(d.type == "cuda" for d in self.devices):
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.start()
                self.phase = "lead"
                self._next = _pc() + self.trace["lead_s"]
        elif self.phase == "lead" and now >= self._next:
            sync(self.devices)
            self._span = torch.profiler.record_function(traceio.MEASURED)
            self._span.__enter__()
            self._base = self.counters()
            self.phase = "traced"
            self._next = _pc() + self.trace["seconds"]
        elif self.phase == "traced" and now >= self._next:
            after = self.counters()
            sync(self.devices)
            self._span.__exit__(None, None, None)
            self._prof.stop()
            self.delta = {k: after[k] - self._base[k] for k in after}
            self.trace_path = os.path.join(self.tmpdir, "trace.json")
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
            self.phase = "done"
        return self.done


@dataclass
class Context:
    """What a metric's reader reads."""

    config: dict
    shape: dict
    seconds: float
    setup_s: float
    stats: dict                       # the driver's window counters
    trace: dict | None = None         # traceio.summarize of the span
    delta: dict = field(default_factory=dict)   # counters over the span
    streams_per_launch: int = 1


def program_config(config: dict):
    """The receiver's ReceiverConfig for a configuration file."""
    import dataclasses

    from gps_sdr_tpu_torch.config import ReceiverConfig
    names = {f.name for f in dataclasses.fields(ReceiverConfig)}
    return ReceiverConfig(**{k: v for k, v in config["receiver"].items()
                             if k in names})


def run(workload: str, seed: int, seconds: float, trace: bool,
        devices: list, t_start: float, root: str = manifest.ROOT,
        resize: dict | None = None) -> dict:
    """One run of cell `workload`; returns the result line's object
    (correct, attempted, failed, metrics, device, breakdown, checks).
    `resize` ({"traffic": {...}, "config": {...}}) overrides sizes of
    the cell's files, for runs on the CPU at a test's size."""
    import torch

    man = manifest.load(root)
    cell, config, traffic = manifest.cell(man, workload, root)
    if resize:
        traffic = dict(traffic, **resize.get("traffic", {}))
        config = dict(config, **resize.get("config", {}))
    cfg = program_config(config)
    shape = generator.shape_of(config)
    if (cfg.code_samples, cfg.n_cyc) != (shape["code_samples"],
                                         shape["n_cyc"]):
        raise ValueError("configuration and receiver disagree on shapes")
    devices = [torch.device(d) for d in devices]
    built_s = build_s(devices)
    tmpdir = tempfile.mkdtemp(prefix="gsbench-")
    try:
        captures = generator.make(traffic, config, seed, devices, tmpdir)
        drv = importlib.import_module(
            f"gsbench.drivers.{config['entry']}").Driver(
            cfg, config, traffic, captures, devices, seed)
        drv.warm_up()
        sync(devices)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)
        setup_s = _pc() - t_start
        probe = [host_probe_ms()]
        win = Window(seconds, traffic["trace"] if trace else None, devices,
                     drv.counters, tmpdir)
        # set-up's objects out of the collector's way for the window
        gc.collect()
        gc.freeze()
        records = drv.run_window(win)
        gc.unfreeze()
        sync(devices)
        t_window = _pc() - win.t0
        probe.append(host_probe_ms())
        peak = max([torch.cuda.max_memory_allocated(d) for d in devices
                    if d.type == "cuda"] or [0])
        stats = drv.stats
        n_launch_streams = drv.streams_per_launch
        del drv
        for c in captures:
            c.data = None
        gc.collect()
        if any(d.type == "cuda" for d in devices):
            torch.cuda.empty_cache()
        summary = (traceio.summarize(traceio.load(win.trace_path))
                   if trace else None)
        t_judge = _pc()
        verdict = judge.judge(records, judge.Reference(captures, shape),
                              config, traffic["due"])
        stats = dict(stats, setup_s=setup_s, build_s=built_s,
                     host_probe_ms=probe, window_and_trace_s=t_window,
                     check_s=_pc() - t_judge)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    ctx = Context(config, shape, seconds, setup_s, stats, summary,
                  win.delta, n_launch_streams)
    metrics = {}
    for m in manifest.metrics_for(man, workload, trace):
        value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev0 = devices[0]
    device = {"platform": "gpu" if dev0.type == "cuda" else dev0.type,
              "kind": (torch.cuda.get_device_name(dev0)
                       if dev0.type == "cuda" else "cpu"),
              "count": len(devices), "memory_peak_bytes": peak}
    out = {"correct": verdict["correct"], "attempted": verdict["attempted"],
           "failed": verdict["failed"], "metrics": metrics,
           "device": device}
    if summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        out["per_device_busy_s"] = summary["devices"]
    out["stats"] = stats
    out["notes"] = verdict["notes"]
    out["checks"] = verdict["checks"]
    return out
