"""Roofline of the K-fused tracking step on one NVIDIA GPU.

    python -m gps_sdr_tpu_torch.examples.roofline [--k 16] [--blocks 2048]
        [--channels 12] [--cpu] [--hbm-gbps 3350] [--peak-tflops 67]
        [--tf32-tflops 495] [--out ROOFLINE_torch.json]

Port of examples/roofline.py, with its workload: 12 satellites drawn
from default_rng(0), noise 0.7, seed 1, synthesized on the card
(models/sim_dev.py DeviceSynth) and tracked by track_chunk_batched_impl
at ReceiverConfig(max_sat=channels, blocks_per_step=K), after two warm
runs, under utils/profiling.trace: once, then once more inside an
annotated span that alone is read (a session late in a long process can
lose its first device events).  The device time of that run is
bucketed into the step's stages by kernel name (`stage_buckets`): the
wipeoff kernel, cuFFT, the peak metrics and other PyTorch ops, the cheap
kernel and the copies; each bucket's µs a block, launches a K-step and
share of the busy time.

The floor is `work_per_block`, a count of the work a block needs
whatever implements it: the IQ block read once (8 B a sample) and, a
channel, the wipeoff (8 flops a sample), the correlation as FFT work
(a forward and an inverse cs-point FFT, 5 cs log2 cs each, and the 6 cs
of the spectrum product) and the cheap stage (40 n_cyc, the JAX tool's
term).  The floor is the larger of the bytes over the memory rate and
the flops over the f32 rate; each share (achieved over peak, also
against the TF32 tensor-core rate of kernel 1's 3xTF32 products) must be
at most 1, and a larger one raises: it would mean the count is wrong.
The JAX tool's count (the TPU's matmul DFT, 4.9x this one a block at the
product config) is printed as flops_per_block_jax_count beside it and
divides nothing.

--cpu runs the plain path on the CPU and reads the host's operators;
its numbers are the CPU's (the result says "lane": "host") and no share
is computed.  On the card the trace must hold every launch of the two
hand-written kernels (check_complete), or the tool raises.  Writes the
JSON report to --out (default
ROOFLINE_torch.json under the repository root; the JAX tool's
ROOFLINE_r0*.json are not touched).
"""

from __future__ import annotations

import argparse
import heapq
import json
import math
import os
import shutil
import tempfile
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# one NVIDIA H100 SXM at its 700 W limit (data sheet): device memory
# rate, the f32 rate outside the tensor cores, and the dense TF32 rate
# of the tensor cores (kernel 1's 3xTF32 products run there)
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12
H100_TF32_PER_S = 495e12

# the step's stages, in trace order, as stage_buckets names them
BUCKETS = ("wipeoff", "fft", "elementwise", "cheap", "copies")
_COPY_CATS = {"gpu_memcpy", "gpu_memset"}
# the traced run is two steps: a profiler session late in a long process
# was seen to drop its first device events (the first K-step's wipeoff,
# FFT and ~20 small kernels, 7 minutes into chip_smoke.py; never in a
# fresh process), so the first step takes that loss and only the second,
# inside this annotation with SETTLE_S of idle on either side, is read
MEASURED = "roofline_measured_step"
SETTLE_S = 0.25


def work_per_block(cfg, channels: int) -> dict:
    """The work one block of `channels` tracked channels needs, whatever
    implements it: {"bytes", "flops", "flops_by_stage"}.  Bytes: the IQ
    block read once, 8 B a sample.  Flops a channel: wipeoff 8 a sample;
    correlation 2 x 5 cs log2 cs + 6 cs (forward and inverse FFT of the
    mean center period and the spectrum product); cheap 40 n_cyc."""
    cs = cfg.code_samples
    stages = {"wipeoff": 8 * cfg.ngps,
              "correlation": round(2 * 5 * cs * math.log2(cs)) + 6 * cs,
              "cheap": 40 * cfg.n_cyc}
    by_stage = {k: channels * v for k, v in stages.items()}
    return {"bytes": 8 * cfg.ngps, "flops": sum(by_stage.values()),
            "flops_by_stage": by_stage}


def flops_per_block_jax_count(cfg, channels: int) -> int:
    """examples/roofline.py's count: the correlation as the TPU's
    matmul DFT (ops/dft.py, f1 = 64), forward and inverse, plus the
    wipeoff and cheap terms.  Printed beside work_per_block, never a
    denominator."""
    cs = cfg.code_samples
    f1 = 64
    f2 = cs // f1
    dft_one = cs * f1 * 8 + cs * f2 * 8 + 6 * cs
    return channels * (8 * cfg.ngps + 2 * dft_one + 6 * cs
                       + 40 * cfg.n_cyc)


def floor_us(work: dict, bytes_per_s: float = H100_BYTES_PER_S,
             flops_per_s: float = H100_F32_PER_S) -> tuple[float, str]:
    """(least µs a block, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the flops over the f32 rate."""
    t_bytes = work["bytes"] / bytes_per_s * 1e6
    t_ops = work["flops"] / flops_per_s * 1e6
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def shares(work: dict, busy_us_per_block: float,
           bytes_per_s: float = H100_BYTES_PER_S,
           flops_per_s: float = H100_F32_PER_S,
           tf32_per_s: float = H100_TF32_PER_S) -> dict:
    """Achieved rate over peak, for the bytes, the f32 flops and the
    same flops at the TF32 rate.  Raises ValueError for a share over
    1.0: the card cannot beat its peak, so the count would be wrong."""
    out = {
        "bytes": work["bytes"] / bytes_per_s * 1e6 / busy_us_per_block,
        "f32": work["flops"] / flops_per_s * 1e6 / busy_us_per_block,
        "tf32": work["flops"] / tf32_per_s * 1e6 / busy_us_per_block}
    for name, share in out.items():
        if not share <= 1.0:
            raise ValueError(
                f"{name} share {share:.4g} > 1.0 at {busy_us_per_block:.4g} "
                "µs a block: the work count is wrong")
    return out


def bucket_of(name: str, cat: str | None = None) -> str:
    """The stage an event of the trace belongs to, by its category and
    kernel name: copies and memsets; the wipeoff kernels (wipeoff_kernel,
    wipeoff_vpu_kernel); the cheap kernel (cheap_kernel); cuFFT's
    kernels (regular_fft, vector_fft, the radix kernels, whose
    arguments name fft types); everything else is PyTorch's peak
    metrics and other elementwise ops."""
    low = name.lower()
    if cat in _COPY_CATS or low.startswith(("memcpy", "memset")):
        return "copies"
    if "wipeoff" in low:
        return "wipeoff"
    if "cheap" in low:
        return "cheap"
    if "fft" in low or "radix" in low or "c2c" in low:
        return "fft"
    return "elementwise"


def stage_buckets(log_dir: str, window: str | None = None) -> dict:
    """The newest trace under log_dir (utils/profiling.trace), its
    busiest lane's time by stage: {"lane", "busy_s", "n_events",
    "n_lanes", "buckets": {stage: {"s", "count", "top": [(name, s,
    count), ...]}}}.  With `window`, only the events inside the host
    span of that name (a torch.profiler.record_function) count.  Where
    events nest or overlap, each instant belongs to the innermost event
    (the latest started), so every instant counts once and the buckets
    sum to the lane's busy time (device_time_from_trace's busy_s over
    the same events); each event counts once in its bucket's count."""
    from gps_sdr_tpu_torch.utils.profiling import (_newest_trace,
                                                   _timed_events, _union)

    trace_events = _newest_trace(log_dir)
    events, lane = _timed_events(trace_events)
    if window is not None:
        spans = [e for e in trace_events if e.get("name") == window
                 and e.get("cat") == "user_annotation"]
        if len(spans) != 1:
            raise ValueError(f"{len(spans)} {window!r} spans in the trace")
        a0 = spans[0]["ts"]
        a1 = a0 + spans[0]["dur"]
        events = [e for e in events
                  if e["ts"] >= a0 and e["ts"] + e["dur"] <= a1]
    by_lane = defaultdict(list)
    for ev in events:
        by_lane[ev.get("pid"), ev.get("tid")].append(ev)
    buckets = {b: {"s": 0.0, "count": 0, "top": {}} for b in BUCKETS}
    if not by_lane:
        return {"lane": lane, "busy_s": 0.0, "n_events": 0, "n_lanes": 0,
                "buckets": buckets}
    best = max(by_lane, key=lambda k: _union(
        [(e["ts"], e["ts"] + e["dur"]) for e in by_lane[k]]))
    evs = sorted(by_lane[best], key=lambda e: e["ts"])
    names = [(bucket_of(e.get("name", "?"), e.get("cat")),
              e.get("name", "?")) for e in evs]
    excl = [0.0] * len(evs)
    bounds = sorted({t for e in evs for t in (e["ts"], e["ts"] + e["dur"])})
    heap: list = []                 # (-start, duration, index): innermost
    i = 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(evs) and evs[i]["ts"] <= a:
            heapq.heappush(heap, (-evs[i]["ts"], evs[i]["dur"], i))
            i += 1
        while heap and evs[heap[0][2]]["ts"] + evs[heap[0][2]]["dur"] <= a:
            heapq.heappop(heap)
        if heap:
            excl[heap[0][2]] += b - a
    for (bucket, name), t in zip(names, excl):
        bk = buckets[bucket]
        bk["s"] += t / 1e6
        bk["count"] += 1
        top = bk["top"].setdefault(name, [0.0, 0])
        top[0] += t / 1e6
        top[1] += 1
    for bk in buckets.values():
        bk["top"] = sorted(((n, s, c) for n, (s, c) in bk["top"].items()),
                           key=lambda x: -x[1])[:4]
    return {"lane": lane, "busy_s": sum(excl) / 1e6, "n_events": len(evs),
            "n_lanes": len(by_lane), "buckets": buckets}


def check_complete(stages: dict, launches: dict, wipeoff: str) -> None:
    """Raises RuntimeError unless the device trace behind `stages`
    (stage_buckets) holds every launch the counters saw of the wipeoff
    kernel `wipeoff` and of cheap: a trace that missed some would
    understate the busy time."""
    got = {b: stages["buckets"][b]["count"] for b in ("wipeoff", "cheap")}
    want = {"wipeoff": launches[wipeoff], "cheap": launches["cheap"]}
    if got != want:
        raise RuntimeError(f"the trace holds {got} kernel events of the "
                           f"{want} launched: it dropped device events")


def card(dev) -> dict:
    """{name, power_limit} as nvidia-smi prints them for the card that
    ran; "cpu" for both on the CPU."""
    from gps_sdr_tpu_torch.bench import device_entry

    row = device_entry(dev)["nvidia_smi"]
    if row is None:
        return {"name": "cpu", "power_limit": "cpu"}
    name, _, limit = row.rpartition(", ")
    return {"name": name, "power_limit": limit}


def workload(cfg, dev):
    """examples/roofline.py's cfg.max_sat satellites (default_rng(0):
    PRNs 2-32 without repeats, Doppler +-4500 Hz, code delay in [0, cs),
    4096 nav bits of seed i) and their synth (noise 0.7, seed 1) on dev:
    (sats, synth)."""
    import numpy as np

    from gps_sdr_tpu_torch.models.sim_dev import DeviceSynth
    from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits

    rng = np.random.default_rng(0)
    prns = rng.choice(np.arange(2, 33), cfg.max_sat, replace=False)
    sats = [SatSignal(prn=int(p), doppler=float(rng.uniform(-4500, 4500)),
                      code_delay=float(rng.uniform(0, cfg.code_samples)),
                      nav_bits=random_bits(4096, seed=i))
            for i, p in enumerate(prns)]
    return sats, DeviceSynth(cfg, sats, noise_std=0.7, seed=1, device=dev)


def tracking_step(cfg, blocks: int, dev):
    """(sats, chunk, step) of the workload at cfg (cfg.max_sat
    channels): step() tracks the chunk, its first `blocks` blocks, from
    fresh states through track_chunk_batched_impl, waits for the result
    and returns (states, outs).  The chunk is synthesized once, in the
    layout the wipeoff kernel of cfg reads, so the step converts
    nothing."""
    from gps_sdr_tpu_torch.bench import code_tables, fresh_states
    from gps_sdr_tpu_torch.ops.tracking import track_chunk_batched_impl

    sats, synth = workload(cfg, dev)
    codes, ffts = code_tables(cfg, sats, dev)
    states0 = fresh_states(cfg, sats, dev)
    blk = (synth.chunk(0, blocks) if cfg.use_mxu_wipeoff
           else synth.chunk_planar(0, blocks))

    def step():
        states, outs = track_chunk_batched_impl(cfg, states0, blk, 1, codes,
                                                ffts)
        float(outs.code_phase.sum())
        return states, outs

    return sats, blk, step


def run(k: int = 16, blocks: int = 2048, channels: int = 12, device="cuda",
        use_mxu_wipeoff: bool = True, bytes_per_s: float = H100_BYTES_PER_S,
        flops_per_s: float = H100_F32_PER_S,
        tf32_per_s: float = H100_TF32_PER_S) -> dict:
    """The roofline report of `blocks` blocks tracked at K = k (kernel 1
    and cheap, or with use_mxu_wipeoff=False kernel 2 and cheap)."""
    from torch.profiler import record_function

    from gps_sdr_tpu_torch.bench import read_counts, reset_counts, sync
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.device import resolve_device
    from gps_sdr_tpu_torch.utils.profiling import trace

    dev = resolve_device(device)
    cfg = ReceiverConfig(max_sat=channels, blocks_per_step=k,
                         use_mxu_wipeoff=use_mxu_wipeoff)
    _, _, step = tracking_step(cfg, blocks, dev)
    step()                                   # warm: cuFFT plans, caches
    step()
    sync(dev)
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    tdir = tempfile.mkdtemp(prefix="roofline_")
    try:
        with trace(tdir):
            step()
            time.sleep(SETTLE_S)
            reset_counts()
            with record_function(MEASURED):
                time.sleep(SETTLE_S)
                step()
                time.sleep(SETTLE_S)
            launches = {n: v for n, v in read_counts().items()
                        if n != "k_steps"}
        stages = stage_buckets(tdir, MEASURED)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    on_card = stages["lane"] == "device"
    if on_card:
        check_complete(stages, launches,
                       "wipeoff" if use_mxu_wipeoff else "wipeoff_vpu")

    k_steps = blocks // k
    busy = stages["busy_s"]
    busy_us = busy / blocks * 1e6
    work = work_per_block(cfg, channels)
    floor, bound_by = floor_us(work, bytes_per_s, flops_per_s)
    return {
        "k": k, "channels": channels, "blocks": blocks,
        "use_mxu_wipeoff": use_mxu_wipeoff, "backend": dev.type,
        "device": card(dev), "lane": stages["lane"],
        "busy_us_per_block": busy_us,
        "wall_us_per_block": wall / blocks * 1e6,
        "busy_share_of_wall": busy / wall,
        "rtf_busy": blocks * cfg.block_sec / busy if busy else None,
        "n_ops": stages["n_events"], "n_lanes": stages["n_lanes"],
        "bytes_per_block": work["bytes"],
        "flops_per_block": work["flops"],
        "flops_by_stage": work["flops_by_stage"],
        "flops_per_block_jax_count": flops_per_block_jax_count(cfg,
                                                               channels),
        "peaks": {"bytes_per_s": bytes_per_s, "f32_per_s": flops_per_s,
                  "tf32_per_s": tf32_per_s},
        "floor_us_per_block": floor, "bound_by": bound_by,
        "headroom_vs_floor": busy_us / floor if busy_us else None,
        # shares against the card's peaks; a host lane is no device
        "shares": (shares(work, busy_us, bytes_per_s, flops_per_s,
                          tf32_per_s) if on_card else None),
        "k_steps": k_steps, "launches": launches,
        "buckets": {
            b: {"us_per_block": v["s"] / blocks * 1e6,
                "launches": v["count"],
                "launches_per_k_step": v["count"] / k_steps,
                "share_of_busy": v["s"] / busy if busy else 0.0,
                "top": [{"name": n[:90], "us_per_block": s / blocks * 1e6,
                         "count": c} for n, s, c in v["top"]]}
            for b, v in stages["buckets"].items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "gps_sdr_tpu_torch.examples.roofline")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=2048)
    ap.add_argument("--channels", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain path on the CPU (no shares)")
    ap.add_argument("--hbm-gbps", type=float,
                    default=H100_BYTES_PER_S / 1e9,
                    help="device memory rate (H100 SXM data sheet)")
    ap.add_argument("--peak-tflops", type=float,
                    default=H100_F32_PER_S / 1e12,
                    help="f32 rate outside the tensor cores")
    ap.add_argument("--tf32-tflops", type=float,
                    default=H100_TF32_PER_S / 1e12,
                    help="dense TF32 tensor-core rate")
    ap.add_argument("--out", default="ROOFLINE_torch.json")
    args = ap.parse_args(argv)

    doc = run(args.k, args.blocks, args.channels,
              "cpu" if args.cpu else "cuda",
              bytes_per_s=args.hbm_gbps * 1e9,
              flops_per_s=args.peak_tflops * 1e12,
              tf32_per_s=args.tf32_tflops * 1e12)
    out = os.path.abspath(os.path.join(ROOT, args.out))
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({k: v for k, v in doc.items() if k != "buckets"},
                     indent=1))
    for name, b in doc["buckets"].items():
        print(f"  {name:11s} {b['us_per_block']:8.3f} µs/block  "
              f"{b['launches_per_k_step']:7.2f} /K-step  "
              f"{100 * b['share_of_busy']:5.1f}%")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
