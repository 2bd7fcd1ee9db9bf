"""Device time of the port's kernels and of its two slices, from
torch.profiler (CUPTI), on one NVIDIA GPU.

    python -m gps_sdr_tpu_torch.kernel_profile [--out PATH]

  1. each hand-written kernel at the product shapes (11 channels, K=8,
     n_cyc=32, cs=2048), 50 calls of its wrapper under the profiler: the
     kernel's own device time per call (the wrapper's host work is not
     in it), beside the wall time per call.  The cheap kernel runs twice:
     on fresh states ("cheap") and on slice-like states ("cheap_slice":
     locked channels, full wrapped rings, counters at their caps);
  2. the host-fed replay slice of chip_smoke.py phase 4 (the
     synthetic_fix default scenario, 40 s of IQ synthesized on the host,
     through Session.run_source at use_mxu_wipeoff=True) and the
     device-resident slice of phase 6 (the same scenario synthesized on
     the card, 39 s of signal through Session.run_device_source at
     use_mxu_wipeoff=False).  Each slice runs once as a short warm-up,
     once unprofiled for its wall, then once profiled whole: the
     device's busy time (sum of its kernels and copies), its share of
     the unprofiled wall, the device-to-device copies per K-step, and
     the device time by item.
Prints one JSON object (also written to PATH with --out).  Fails without
a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

N_SATS, SEED, NOISE = 6, 3, 0.5     # the synthetic_fix default scenario


def _device_times(prof) -> dict:
    """Device microseconds and call counts by device event (kernel or
    copy).  The host ops that launched them (aten::mul, ...) carry the
    same device time again and are left out, so the values add up to
    the device's busy time."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            out[e.key] = (e.self_device_time_total, e.count)
    return out


def synth_iq(scn, n_blocks: int, step: int, workers: int = 8):
    """The scenario's IQ, complex64 [n_blocks, ngps], synthesized on the
    host in parallel threads of `step` blocks (numpy over whole arrays
    releases the GIL).  Threads, not processes, so that no process
    outlives the caller."""
    import concurrent.futures as cf

    import numpy as np

    from gps_sdr_tpu_torch.models.scenario import synth_scenario_blocks

    firsts = list(range(0, n_blocks, step))
    workers = max(1, min(workers, os.cpu_count() or 1, len(firsts)))
    with cf.ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(
            lambda f: synth_scenario_blocks(scn, f, min(step, n_blocks - f),
                                            noise_std=NOISE), firsts))
    return np.concatenate(parts)


def _kernel_inputs(cfg, dev, seed=7):
    import torch

    from gps_sdr_tpu_torch.ops import tracking

    g = torch.Generator(device="cpu").manual_seed(seed)
    n_ch, k, cs = cfg.max_sat, cfg.blocks_per_step, cfg.code_samples
    chunk = torch.randn((cfg.no_sec, 2, cfg.n_cyc, cs), generator=g)
    codes = torch.where(torch.rand((n_ch, cs), generator=g) < 0.5, -1.0, 1.0)
    freq = (torch.rand(n_ch, generator=g) - 0.5) * 9000.0
    delay = torch.randint(0, cs, (n_ch,), generator=g, dtype=torch.int32)
    phase = torch.rand(n_ch, generator=g) * 2 * math.pi
    s = 2 * math.pi * freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2 * math.pi)
    wipe = tracking.predict_wipe_delays(cfg, k, freq, delay)
    planar = chunk.to(dev)
    cplx = tracking.dsp.as_complex_input(planar).contiguous()
    return dict(s=s.to(dev), snp=snp.to(dev), phase=phase.to(dev),
                wipe=wipe.to(dev), codes=codes.to(dev), planar=planar,
                cplx=cplx)


def slice_like_states(cfg, dev, seed=7):
    """Tracking states as a slice holds them after a minute: every
    channel active and locked, bit chains started, ms_time large, the
    correlation and df rings full and wrapped, counters at their caps."""
    import torch

    from gps_sdr_tpu_torch.ops import tracking

    g = torch.Generator(device="cpu").manual_seed(seed)
    n_ch, hist, no_sec = cfg.max_sat, cfg.corr_hist_len, cfg.no_sec
    sign = torch.where(torch.rand(n_ch, generator=g) < 0.5, -1, 1).to(
        torch.int8)
    st = tracking.init_channel_states(cfg, n_ch, "cpu")._replace(
        active=torch.ones(n_ch, dtype=torch.bool),
        locked=torch.ones(n_ch, dtype=torch.bool),
        sign0=sign, prev_sign=sign,
        prev_signal=torch.randn(n_ch, generator=g),
        ms_time=torch.full((n_ch,), 60_000, dtype=torch.int32),
        std_dev=torch.full((n_ch,), 0.05),
        corr_buf=torch.where(torch.rand((n_ch, hist), generator=g) < 0.9,
                             1, -1).to(torch.int8),
        corr_cnt=torch.full((n_ch,), hist, dtype=torch.int32),
        corr_idx=torch.randint(0, hist, (n_ch,), generator=g,
                               dtype=torch.int32),
        df_buf=1e-3 * torch.randn((n_ch, no_sec), generator=g),
        df_cnt=torch.full((n_ch,), no_sec, dtype=torch.int32),
        df_idx=torch.randint(0, no_sec, (n_ch,), generator=g,
                             dtype=torch.int32))
    return tracking.ChannelState(*(v.to(dev) for v in st))


def profile_kernels(cfg, dev, reps: int = 50) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff, tracking

    x = _kernel_inputs(cfg, dev)
    k = cfg.blocks_per_step
    st = tracking.init_channel_states(cfg, cfg.max_sat, dev)
    st = st._replace(active=torch.ones_like(st.active),
                     locked=torch.ones_like(st.locked))
    st_slice = slice_like_states(cfg, dev)
    _, head, seg = hopper_wipeoff.mix_wipeoff_vpu(
        cfg, k, x["s"], x["snp"], x["phase"], x["wipe"], x["planar"], 1,
        x["codes"])
    delay = x["wipe"].clone()
    calls = {
        "wipeoff": lambda: hopper_wipeoff.mix_wipeoff(
            cfg, k, x["s"], x["snp"], x["phase"], x["wipe"], x["cplx"], 1,
            x["codes"]),
        "wipeoff_vpu": lambda: hopper_wipeoff.mix_wipeoff_vpu(
            cfg, k, x["s"], x["snp"], x["phase"], x["wipe"], x["planar"], 1,
            x["codes"]),
        "cheap": lambda: hopper_cheap.cheap_scan(cfg, k, head, seg, delay,
                                                 x["wipe"], st),
        "cheap_slice": lambda: hopper_cheap.cheap_scan(
            cfg, k, head, seg, delay, x["wipe"], st_slice),
    }
    # device-side names of each wrapper's kernels (csrc/*.cu)
    names = {"wipeoff": ("wipeoff_kernel",),
             "wipeoff_vpu": ("wipeoff_vpu_kernel",),
             "cheap": ("cheap_kernel",), "cheap_slice": ("cheap_kernel",)}
    out = {}
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        times = _device_times(prof)
        parts = {key: us / n for key, (us, n) in times.items()
                 if any(s in key for s in names[name])}
        out[name] = {"device_us_per_call": sum(parts.values()),
                     "by_kernel_us": parts,
                     "wall_us_per_call": wall / reps * 1e6}
    return out


def _profile_slice(run, n_warm, n_full, truth) -> dict:
    """run(n) -> (session, summary, wall s) over the first n units of a
    slice: a warm-up (the first sweep builds cuFFT plans, the first
    chunks grow the allocator's pools), the slice unprofiled for its
    wall, then profiled."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    run(n_warm)
    _, _, wall = run(n_full)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session, summary, wall_prof = run(n_full)
    times = _device_times(prof)
    total = sum(us for us, _ in times.values())
    k_steps = session.receiver.status.k_steps
    d2d = sum(n for key, (_, n) in times.items() if "DtoD" in key)
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:15]
    stat = summary["stat"]
    return {"wall_s": wall,
            "wall_s_profiled": wall_prof,
            "device_busy_s": total / 1e6,
            "device_busy_share": total / 1e6 / wall,
            "err_m": (float(np.linalg.norm(stat[0] - truth))
                      if stat is not None else None),
            "k_steps": k_steps,
            "dtod_copies": d2d,
            "dtod_copies_per_k_step": d2d / max(k_steps, 1),
            "top_device_us": {k: {"us": us, "calls": n}
                              for k, (us, n) in top}}


def profile_replay_slice(cfg, dev, sec: float = 40.0) -> dict:
    """The host-fed slice (kernel 1 and cheap)."""
    import torch

    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.runtime.session import Session

    cfg = cfg.replace(use_mxu_wipeoff=True)
    scn = make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                        duration_sec=sec + 12.0)
    n_blocks = int(round(sec / cfg.block_sec))
    blocks = synth_iq(scn, n_blocks, 4 * cfg.no_sec)

    def run(n):
        session = Session(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = session.run_source(iter(blocks[:n]))
        torch.cuda.synchronize()
        return session, summary, time.perf_counter() - t0

    res = _profile_slice(run, 1 + 2 * cfg.no_sec, n_blocks, scn.rec_ecef)
    return {"signal_s": n_blocks * cfg.block_sec, **res}


def profile_device_slice(cfg, dev, sec: float = 40.0) -> dict:
    """The device-resident slice (kernel 2 and cheap)."""
    import torch

    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.runtime.session import Session

    cfg = cfg.replace(use_mxu_wipeoff=False)
    scn = make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                        duration_sec=sec + 12.0)
    synth = DeviceScenarioSynth(scn, noise_std=NOISE, knot_interp_step=0.1,
                                device=dev)
    n_chunks = int(round(sec / cfg.block_sec)) // cfg.no_sec

    def run(n):
        session = Session(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = session.run_device_source(synth.chunk_planar, n)
        torch.cuda.synchronize()
        return session, summary, time.perf_counter() - t0

    res = _profile_slice(run, cfg.chunks_per_download + 1, n_chunks,
                         scn.rec_ecef)
    return {"signal_s": n_chunks * cfg.no_sec * cfg.block_sec, **res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    _build.load()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cfg = ReceiverConfig()
    res = {"card": card, "kernels": profile_kernels(cfg, dev),
           "replay_slice": profile_replay_slice(cfg, dev),
           "device_slice": profile_device_slice(cfg, dev)}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
