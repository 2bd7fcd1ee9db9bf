"""The port's profiler (gps_sdr_tpu_torch/utils/profiling.py) against the
JAX module's trace parsers, on the CPU.

  * the same events, written once as a jax.profiler trace (device lanes
    named by process_name metadata) and once as a torch.profiler trace
    (device events by category), give the same device_time_from_trace
    dict (the per-lane interval union: nested and overlapping events
    counted once) and the same op_breakdown_from_trace;
  * a trace without device events falls back to the host's lane and
    says so ("host"), as the JAX module's does on the CPU;
  * trace() over real work on the CPU writes a trace both parsers of the
    port read, and the newest trace under a directory is the one read."""

import gzip
import json
import os
import time

import pytest
import torch

from gps_sdr_tpu.utils import profiling as jprof
from gps_sdr_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

# (lane, name, ts us, dur us): lane 0 has a nested and an overlapping
# event, lane 1 a gap
EVENTS = [(0, "wipeoff_kernel", 0.0, 10.0), (0, "cheap_kernel", 2.0, 3.0),
          (0, "wipeoff_kernel", 8.0, 6.0), (0, "fft", 30.0, 4.0),
          (1, "copy", 5.0, 2.0), (1, "fft", 50.0, 1.5)]


def _write(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _jax_trace(tmp_path, host=False):
    name = "/host:CPU" if host else "/device:GPU:0"
    events = [{"ph": "M", "name": "process_name", "pid": 7,
               "args": {"name": name}}]
    events += [{"ph": "X", "pid": 7, "tid": lane, "name": n, "ts": ts,
                "dur": dur} for lane, n, ts, dur in EVENTS]
    d = tmp_path / "jax"
    d.mkdir()
    _write(d / "x.trace.json.gz", events)
    return str(d)


def _torch_trace(tmp_path, host=False):
    events = [{"ph": "M", "name": "process_name", "pid": 99,
               "args": {"name": "python"}},
              # a host operator that launched the kernels: not device time
              {"ph": "X", "cat": "cpu_op", "pid": 99, "tid": 99,
               "name": "aten::mul", "ts": 0.0, "dur": 100.0}]
    events += [{"ph": "X", "cat": "cpu_op" if host else "kernel",
                "pid": 99 if host else 0, "tid": lane, "name": n, "ts": ts,
                "dur": dur} for lane, n, ts, dur in EVENTS]
    d = tmp_path / "torch"
    d.mkdir()
    _write(d / f"trace_1{tprof.TRACE_SUFFIX}", events)
    return str(d)


def test_device_time_matches_jax_parser(tmp_path):
    got = tprof.device_time_from_trace(_torch_trace(tmp_path))
    want = jprof.device_time_from_trace(_jax_trace(tmp_path))
    assert got == want
    assert got["lane"] == "device" and got["n_lanes"] == 2
    assert got["busy_s"] == pytest.approx(18e-6)      # [0, 14) + [30, 34)
    assert got["busy_all_lanes_s"] == pytest.approx(21.5e-6)
    assert got["span_s"] == pytest.approx(51.5e-6)
    assert tprof.op_breakdown_from_trace(str(tmp_path / "torch")) == \
        jprof.op_breakdown_from_trace(str(tmp_path / "jax"))


def test_host_lane_without_device_events(tmp_path):
    got = tprof.device_time_from_trace(_torch_trace(tmp_path, host=True))
    assert got["lane"] == "host"
    # the launching operator aten::mul [0, 100) covers lane 99's events
    assert got["n_ops"] == len(EVENTS) + 1
    with pytest.raises(FileNotFoundError):
        tprof.device_time_from_trace(str(tmp_path / "none"))


def test_trace_of_real_work(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(256, 256)
    with tprof.trace(log_dir):
        torch.fft.fft(x @ x)
    time.sleep(0.01)
    with tprof.trace(log_dir):
        (x * 2.0).sum()
    assert len(os.listdir(log_dir)) == 2
    got = tprof.device_time_from_trace(log_dir)
    assert got["lane"] == ("device" if torch.cuda.is_available() else "host")
    assert got["n_ops"] > 0 and 0 < got["busy_s"] <= got["span_s"] + 1e-9
    names = [n for n, _, _ in tprof.op_breakdown_from_trace(log_dir)]
    # the newest trace: the second block's ops, not the first's
    assert "aten::mul" in names and "aten::mm" not in names
