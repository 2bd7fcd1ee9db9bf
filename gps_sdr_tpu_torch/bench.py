"""Benchmark of the PyTorch port: acquisition + 12-channel tracking
realtime factor on one NVIDIA GPU.

    python -m gps_sdr_tpu_torch.bench [t_large] [--device cuda|cpu]

Port of bench.py at the repository root (the JAX package's bench).  The
reference's envelope is "up to 12 satellites in real time" at 2.048 MS/s
on a multicore CPU, so the baseline realtime factor is 1.0.  The bench
measures on one card:

  * cold-start acquisition: the full 31-PRN x 51-Doppler x 2048-lag grid
    on one 32 ms block (ops/acquisition.py acquire_impl);
  * streaming tracking: 12 channels through the K-fused tracking loop
    (ops/tracking.py track_chunk_batched_impl: the wipeoff kernel
    csrc/wipeoff.cu and the cheap kernel csrc/cheap.cu once a K-step)
    over IQ resident on the card, at three chunk sizes; the headline is
    the least-squares slope of wall against blocks, beside bench.py's
    two-point difference and the device-time rate from a profiler trace;
  * the extras, in bench.py's order and under its keys, selected by
    BENCH_EXTRAS (comma-separated, default all): widegrid, snapshot,
    ch32, streams, ncyc8, fullloop, serving (servecurve: its curve over
    stream counts), msps16, frontend.

Environment and argv as bench.py, with the same defaults: BENCH_K (32),
BENCH_TSMALL (512), argv[1] t_large (8192), BENCH_EXTRAS, BENCH_STREAMS,
BENCH_FULL_SEC, BENCH_SERVE_SEC, BENCH_SERVE_STREAMS, BENCH_SERVE_SCALE,
BENCH_SERVE_W.  --device defaults to cuda; the CPU runs the kernels'
plain versions, only when asked for by name, and its numbers are CPU
numbers (the result says which device ran).

Layout: bench.py feeds JaxSynth.chunk_planar, the TPU's f32-pair layout.
Kernel 1 reads complex64, so the tracking extras here feed
DeviceSynth.chunk (models/sim_dev.py), complex64, synthesized before the
timed window as bench.py's chunks are.

What bench.py does that this bench does not: the XLA fallback when a
Pallas call fails, the halving retry of the large size, the "failed:"
markers of a failing extra and BENCH_BF16.  Here a kernel that fails to
build or launch raises, any extra's failure propagates and the bench
exits non-zero, and BENCH_BF16 (a flag of the TPU's matmul DFT, which
the port does not have) raises ValueError.

Added keys: "backend" is the torch device type; "device" holds the
card's name, count and nvidia-smi's name and power limit;
"kernel_launches" holds, for the headline and each extra, the launches
of each kernel (the counters chip_smoke.py reads) and the
K-steps that extra enqueued; every serving-curve point holds
torch.cuda.memory_allocated and max_memory_allocated.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"extra"}; vs_baseline is the speedup over the reference's realtime
factor 1.0.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.models.sim_dev import DeviceSynth
from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits
from gps_sdr_tpu_torch.ops import cacode, hopper_cheap, hopper_wipeoff
from gps_sdr_tpu_torch.ops import tracking
from gps_sdr_tpu_torch.ops.acquisition import acquire_impl

N_CHANNELS = 12
EXTRAS = ("widegrid", "snapshot", "ch32", "streams", "ncyc8", "fullloop",
          "serving", "servecurve", "msps16", "frontend")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_probe_ms(reps: int = 3) -> float:
    """Fixed numpy+Python workload wall time in ms (bench.py's probe).

    Host-bound metrics (full_loop, serving) move with the host's state;
    this probe makes that state visible in every result.  The mix
    mirrors the evaluator's op shapes: small batched f64 matmul/solve,
    transcendentals, and plain interpreter overhead."""
    rng = np.random.default_rng(42)
    a = rng.normal(size=(256, 8, 4))
    v = rng.normal(size=(256, 8))
    big = rng.normal(size=200_000)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        m = a.transpose(0, 2, 1) @ a + np.eye(4)
        rhs = a.transpose(0, 2, 1) @ v[:, :, None]
        np.linalg.solve(m, rhs)
        np.sqrt(np.abs(np.sin(big))).sum()
        acc = 0
        for i in range(20_000):
            acc += i & 7
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def bench_config(k: int) -> ReceiverConfig:
    """The bench's receiver: the product config with 12 channels and K
    blocks a step."""
    return ReceiverConfig(max_sat=N_CHANNELS, blocks_per_step=k)


def sync(dev: torch.device) -> None:
    """Wait for the card (bench.py's force_f32); nothing on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --- the kernels' launch counters and the K-steps they are held to ---------

def _counters() -> dict:
    return {"wipeoff": hopper_wipeoff.mix_wipeoff,
            "wipeoff_vpu": hopper_wipeoff.mix_wipeoff_vpu,
            "cheap": hopper_cheap.cheap_scan}


def count_steps(n: int) -> None:
    """Add n to count_steps.total, the K-steps the bench enqueued: every
    K-step launches the wipeoff kernel and the cheap kernel once."""
    count_steps.total += n


count_steps.total = 0


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
    count_steps.total = 0


def read_counts() -> dict:
    out = {name: fn.launches for name, fn in _counters().items()}
    out["k_steps"] = count_steps.total
    return out


# --- signals and tracking ---------------------------------------------------

def headline_sats(rng: np.random.Generator) -> list:
    """The 12 satellites of bench.py:129-136, drawn from `rng` (bench.py's
    default_rng(0), which the extras then draw on from)."""
    prns = rng.choice(np.arange(2, 33), N_CHANNELS, replace=False)
    return [SatSignal(prn=int(p),
                      doppler=float(rng.uniform(-4500, 4500)),
                      code_delay=float(rng.uniform(0, 2048)),
                      amplitude=float(rng.uniform(0.8, 1.2)),
                      nav_bits=random_bits(8192, seed=i))
            for i, p in enumerate(prns)]


def code_tables(cfg: ReceiverConfig, sats: list, dev) -> tuple:
    """(codes f32[C, cs], code FFTs complex64[C, cs]) of `sats` on dev."""
    tab, ftab = cacode.ca_table(cfg), cacode.ca_fft_table(cfg)
    return (torch.as_tensor(np.stack([tab[s.prn] for s in sats]),
                            device=dev),
            torch.as_tensor(np.stack([ftab[s.prn] for s in sats]),
                            device=dev))


def fresh_states(cfg: ReceiverConfig, sats: list, dev
                 ) -> tracking.ChannelState:
    """One channel a satellite, at its Doppler and code delay."""
    st = tracking.init_channel_states(cfg, len(sats), dev)
    for i, s in enumerate(sats):
        st = tracking.reset_channel(st, i, s.prn, s.doppler,
                                    int(s.code_delay) % cfg.code_samples,
                                    cfg)
    return st


def track(cfg: ReceiverConfig, states, blocks, codes, ffts):
    """One chunk through the K-fused tracking loop from stream number 1
    (bench.py's track_chunk_batched call); returns (states, outs)."""
    k = cfg.blocks_per_step
    count_steps(blocks.shape[0] // k if k > 1 else 0)
    return tracking.track_chunk_batched_impl(cfg, states, blocks, 1, codes,
                                             ffts)


def track_streams(cfg: ReceiverConfig, states, blocks, codes, ffts):
    """S streams' chunks [S, T, ngps] in one K-step loop (bench.py's
    track_streams call): one launch of each kernel a K-step for all
    streams."""
    k = cfg.blocks_per_step
    count_steps(blocks.shape[1] // k if k > 1 else 0)
    return tracking.track_streams_impl(cfg, states, blocks, 1, codes, ffts)


def timed_track(cfg, sats, blocks, codes, ffts, dev):
    """(wall s, states, outs) of track() from fresh states; the states
    are built and the device idle before the clock starts."""
    states = fresh_states(cfg, sats, dev)
    sync(dev)
    t0 = time.perf_counter()
    states, outs = track(cfg, states, blocks, codes, ffts)
    sync(dev)
    return time.perf_counter() - t0, states, outs


def amortized_rtf(sig_s: float, d_wall: float, sig_l: float,
                  w_l: float) -> float:
    """bench.py's two-size rate with its guard: the signal difference
    over the wall difference, or the large call's own rate when the
    wall difference is under 5 ms."""
    return sig_s / d_wall if d_wall >= 0.005 else sig_l / w_l


# --- the headline -----------------------------------------------------------

def bench_acquisition(cfg: ReceiverConfig, block, dev) -> dict:
    """bench.py:142-154: one full-grid acquisition (warm), then the mean
    wall of 3."""
    ftab = cacode.ca_fft_table(cfg)
    dopplers = torch.as_tensor(cfg.doppler_bins, dtype=torch.float32,
                               device=dev)
    all_ffts = torch.as_tensor(ftab[np.asarray(cfg.prns)], device=dev)
    res = acquire_impl(cfg, block, dopplers, all_ffts)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        res = acquire_impl(cfg, block, dopplers, all_ffts)
        sync(dev)
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    return {"acq_full_grid_wall_ms": round(wall_ms, 1),
            "acq_prns_found": int(res.found.sum())}


def bench_synth_rate(cfg: ReceiverConfig, synth: DeviceSynth, t_small: int,
                     dev) -> dict:
    """bench.py:156-162: signal seconds synthesized per wall second, one
    chunk of t_small blocks after a warm one."""
    sync(dev)
    synth.chunk(0, t_small)
    sync(dev)
    t0 = time.perf_counter()
    synth.chunk(0, t_small)
    sync(dev)
    wall = time.perf_counter() - t0
    return {"synth_rtf_device": round(t_small * cfg.block_sec
                                      / max(wall, 1e-9), 1)}


def device_time_rtf(cfg, sats, blocks, codes, ffts, dev) -> tuple:
    """bench.py:240-260: one more large run under utils/profiling.trace;
    (signal over the device's busy time, or None where the trace holds
    no device lane, the trace's summary)."""
    from gps_sdr_tpu_torch.utils.profiling import (device_time_from_trace,
                                                   trace)

    tdir = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with trace(tdir):
            timed_track(cfg, sats, blocks, codes, ffts, dev)
        info = device_time_from_trace(tdir)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    sig = blocks.shape[0] * cfg.block_sec
    rtf = (sig / info["busy_s"]
           if info["lane"] == "device" and info["busy_s"] > 0 else None)
    return rtf, info


def bench_headline(cfg: ReceiverConfig, sats: list, synth: DeviceSynth,
                   dev, t_small: int, t_large: int) -> dict:
    """bench.py:164-241 and 836-862: tracking at t_small (5 runs after a
    warm one), t_large (5 after a warm one) and t_mid = t_large // 4 (3),
    the minimum of each; the least-squares slope of wall against blocks
    (the headline), the two-point difference and its per-trial spread,
    the device-time rate, and the lock and accuracy of the last large
    run."""
    codes, ffts = code_tables(cfg, sats, dev)
    blk_small = synth.chunk(0, t_small)
    timed_track(cfg, sats, blk_small, codes, ffts, dev)        # warm
    w_small = min(timed_track(cfg, sats, blk_small, codes, ffts, dev)[0]
                  for _ in range(5))
    del blk_small
    blk_large = synth.chunk(0, t_large)
    timed_track(cfg, sats, blk_large, codes, ffts, dev)        # warm
    wl_trials = []
    for _ in range(5):
        w, st2, outs2 = timed_track(cfg, sats, blk_large, codes, ffts, dev)
        wl_trials.append(w)
    w_large = min(wl_trials)
    t_mid = t_large // 4
    w_mid = min(timed_track(cfg, sats, blk_large[:t_mid], codes, ffts,
                            dev)[0] for _ in range(3))

    sig_small = t_small * cfg.block_sec
    sig_large = t_large * cfg.block_sec
    rtf_raw = sig_large / w_large
    rtf_amortized = (sig_large - sig_small) / max(w_large - w_small, 1e-9)
    rtf_t = sorted((sig_large - sig_small) / max(w - w_small, 1e-9)
                   for w in wl_trials)
    sizes = np.array([t_small, t_mid, t_large], np.float64)
    walls = np.array([w_small, w_mid, w_large], np.float64)
    sec_per_block = np.polyfit(sizes, walls, 1)[0]
    rtf_slope = cfg.block_sec / max(sec_per_block, 1e-12)
    rtf_device, dev_info = device_time_rtf(cfg, sats, blk_large, codes,
                                           ffts, dev)
    del blk_large

    summary = tracking.summarize_states(cfg, st2)
    freq_err = float(np.max(np.abs(
        summary["freq"] - np.array([s.doppler for s in sats]))))
    cp_found = float((outs2.code_phase >= 0).float().mean())
    return {
        "rtf_slope": rtf_slope,
        "rtf_two_point_amortized": round(rtf_amortized, 2),
        "rtf_trials": {"median": round(float(np.median(rtf_t)), 1),
                       "min": round(rtf_t[0], 1),
                       "max": round(rtf_t[-1], 1), "n": len(rtf_t)},
        "rtf_device_time": (round(rtf_device, 1) if rtf_device else None),
        "device_trace": dev_info,
        "rtf_single_call_incl_latency": round(rtf_raw, 2),
        "iq_msamples_per_sec": round(2.048 * rtf_slope, 1),
        "channels_locked": int((summary["locked"] > 0.5).sum()),
        "max_freq_err_hz": round(freq_err, 2),
        "code_phase_found_frac": round(cp_found, 4),
        "signal_sec_large_run": round(sig_large, 1),
    }


# --- the extras -------------------------------------------------------------

def bench_widegrid(cfg: ReceiverConfig, block, dev) -> dict:
    """bench.py:277-287: the +-10 kHz grid on the acquisition block, one
    timed call after a warm one."""
    wide = cfg.replace(min_freq=-10000.0, max_freq=10000.0)
    ftab = cacode.ca_fft_table(cfg)
    dw = torch.as_tensor(wide.doppler_bins, dtype=torch.float32, device=dev)
    all_ffts = torch.as_tensor(ftab[np.asarray(cfg.prns)], device=dev)
    acquire_impl(wide, block, dw, all_ffts)
    sync(dev)
    t0 = time.perf_counter()
    acquire_impl(wide, block, dw, all_ffts)
    sync(dev)
    return {"acq_31prn_pm10khz_ms": round(
        (time.perf_counter() - t0) * 1e3, 1)}


def bench_snapshot(cfg: ReceiverConfig, dev) -> dict:
    """bench.py:293-326: snapshot_fix on block 8 of make_scenario(n_sats=7,
    seed=11) synthesized on the host (noise 0.6, seed 7; cached under
    .synth_cache/ by bench.py's key), a 47 km prior and a tow 20 s off;
    one timed call after a warm one."""
    from gps_sdr_tpu_torch.models.scenario import (make_scenario,
                                                   synth_scenario_blocks)
    from gps_sdr_tpu_torch.ops.snapshot import snapshot_fix

    scn = make_scenario(cfg, n_sats=7, duration_sec=4.0, seed=11)
    cache = os.path.join(ROOT, ".synth_cache",
                         f"bench_snapshot_g{cfg.ngps}_s7_seed11_n0.6.npy")
    if os.path.exists(cache):
        blk = np.load(cache)
    else:
        blk = synth_scenario_blocks(scn, 8, 1, noise_std=0.6, seed=7)[0]
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.save(cache, blk)
    ftab = cacode.ca_fft_table(cfg)
    ephs = {s.prn: s.eph for s in scn.sats}
    t_rx = scn.t_rx0 + 8 * cfg.ngps / cfg.sample_rate
    prior = scn.rec_ecef + np.array([30e3, -30e3, 20e3])
    snapshot_fix(cfg, blk, ftab, ephs, t_rx - 20.0, prior, device=dev)
    t0 = time.perf_counter()
    snap = snapshot_fix(cfg, blk, ftab, ephs, t_rx - 20.0, prior,
                        device=dev)
    wall = time.perf_counter() - t0
    if snap is None:
        raise RuntimeError("snapshot: fewer than 5 satellites found")
    return {"snapshot_ttff_ms": round(wall * 1e3, 1),
            "snapshot_err_m": round(float(np.linalg.norm(
                snap.rec_pos - scn.rec_ecef)), 1)}


def bench_ch32(cfg: ReceiverConfig, rng: np.random.Generator, dev,
               t_small: int) -> dict:
    """bench.py:332-387: 32 channels (PRNs 2-32 and 2 again) at t_small
    and 4 t_small blocks, the two-size rate."""
    n32 = 32
    cfg32 = cfg.replace(max_sat=n32)
    prns32 = np.resize(np.arange(2, 33), n32)
    sats32 = [SatSignal(prn=int(p), doppler=float(rng.uniform(-4500, 4500)),
                        code_delay=float(rng.uniform(0, 2048)),
                        nav_bits=random_bits(4096, seed=100 + i))
              for i, p in enumerate(prns32)]
    synth32 = DeviceSynth(cfg32, sats32, noise_std=0.7, seed=2, device=dev)
    codes32, ffts32 = code_tables(cfg32, sats32, dev)
    blk32 = synth32.chunk(0, t_small)
    timed_track(cfg32, sats32, blk32, codes32, ffts32, dev)    # warm
    w32s = min(timed_track(cfg32, sats32, blk32, codes32, ffts32, dev)[0]
               for _ in range(2))
    del blk32
    t32l = 4 * t_small
    blk32l = synth32.chunk(0, t32l)
    timed_track(cfg32, sats32, blk32l, codes32, ffts32, dev)   # warm
    w32l, st32b, _ = timed_track(cfg32, sats32, blk32l, codes32, ffts32,
                                 dev)
    w32l = min(w32l, timed_track(cfg32, sats32, blk32l, codes32, ffts32,
                                 dev)[0])
    s32 = tracking.summarize_states(cfg32, st32b)
    sig_small = t_small * cfg.block_sec
    return {"track_32ch_rtf": round(amortized_rtf(
                (t32l - t_small) * cfg.block_sec, w32l - w32s,
                t32l * cfg.block_sec, w32l), 1),
            "track_32ch_rtf_single_call": round(sig_small / w32s, 1),
            "track_32ch_locked": int((s32["locked"] > 0.5).sum())}


def bench_streams(cfg: ReceiverConfig, rng: np.random.Generator, dev,
                  t_small: int, n_streams: int) -> dict:
    """bench.py:393-456: n_streams independent 12-channel receivers in
    one K-step loop, at t_small // 4 and t_small blocks, the two-size
    aggregate rate."""
    per = []
    for s_i in range(n_streams):
        prns_s = rng.choice(np.arange(2, 33), N_CHANNELS, replace=False)
        sats_s = [SatSignal(prn=int(p),
                            doppler=float(rng.uniform(-4500, 4500)),
                            code_delay=float(rng.uniform(0, 2048)),
                            nav_bits=random_bits(4096, seed=500 + s_i))
                  for p in prns_s]
        sy = DeviceSynth(cfg, sats_s, noise_std=0.7, seed=20 + s_i,
                         device=dev)
        per.append((sats_s, sy.chunk(0, t_small),
                    *code_tables(cfg, sats_s, dev)))
    bl = torch.stack([p[1] for p in per])
    cd = torch.stack([p[2] for p in per])
    ff = torch.stack([p[3] for p in per])
    per = [p[0] for p in per]
    t_s4 = t_small // 4

    def run_streams(blocks):
        sts = [fresh_states(cfg, sats_s, dev) for sats_s in per]
        sts = tracking.ChannelState(*(torch.stack(f) for f in zip(*sts)))
        sync(dev)
        t0 = time.perf_counter()
        _, o = track_streams(cfg, sts, blocks, cd, ff)
        sync(dev)
        return time.perf_counter() - t0, o

    run_streams(bl[:, :t_s4])                                  # warm
    ws = min(run_streams(bl[:, :t_s4])[0] for _ in range(2))
    run_streams(bl)                                            # warm
    wm, om = run_streams(bl)
    wm = min(wm, run_streams(bl)[0])
    sig_small = t_small * cfg.block_sec
    skey = f"streams_{n_streams}x12"
    return {skey + "_aggregate_rtf": round(amortized_rtf(
                n_streams * (t_small - t_s4) * cfg.block_sec, wm - ws,
                n_streams * sig_small, wm), 1),
            skey + "_single_call_rtf": round(n_streams * sig_small / wm, 1),
            skey + "_locked": int(om.locked[:, -1].sum())}


def bench_ncyc8(cfg: ReceiverConfig, sats: list, dev, t8s: int = 512,
                t8l: int = 2048) -> dict:
    """bench.py:462-500: 8 ms blocks (n_cyc 8, corr_avg 4, K = min(K,
    8)), the headline's 12 satellites, the two-size rate at t8s and t8l
    blocks."""
    cfg8 = cfg.replace(n_cyc=8, corr_avg=4,
                       blocks_per_step=min(cfg.blocks_per_step, 8))
    synth8 = DeviceSynth(cfg8, sats, noise_std=0.7, seed=4, device=dev)
    codes8, ffts8 = code_tables(cfg8, sats, dev)
    blk8 = synth8.chunk(0, t8l)
    timed_track(cfg8, sats, blk8[:t8s], codes8, ffts8, dev)    # warm
    w8s = min(timed_track(cfg8, sats, blk8[:t8s], codes8, ffts8, dev)[0]
              for _ in range(2))
    timed_track(cfg8, sats, blk8, codes8, ffts8, dev)          # warm
    w8l, st8, _ = timed_track(cfg8, sats, blk8, codes8, ffts8, dev)
    w8l = min(w8l, timed_track(cfg8, sats, blk8, codes8, ffts8, dev)[0])
    s8 = tracking.summarize_states(cfg8, st8)
    return {"track_ncyc8_rtf": round(amortized_rtf(
                (t8l - t8s) * cfg8.block_sec, w8l - w8s,
                t8l * cfg8.block_sec, w8l), 1),
            "track_ncyc8_locked": int((s8["locked"] > 0.5).sum())}


def scenario_buffer(cfg: ReceiverConfig, seed: int, sec: float, dev
                    ) -> tuple:
    """(scenario, its IQ on the card, complex64[n_chunks * no_sec, ngps],
    chunk count): make_scenario(n_sats=10, seed) synthesized by
    DeviceScenarioSynth (noise 0.5) a chunk at a time into one buffer, as
    bench.py's full loop and serving pre-synthesize their capture."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth

    t = cfg.no_sec
    n_chunks = int(round(sec / (t * cfg.block_sec)))
    scn = make_scenario(cfg, n_sats=10, seed=seed, duration_sec=sec + 12.0)
    syn = DeviceScenarioSynth(scn, noise_std=0.5, device=dev)
    buf = torch.empty((n_chunks * t, cfg.ngps), dtype=torch.complex64,
                      device=dev)
    for ci in range(n_chunks):
        buf[ci * t:(ci + 1) * t] = syn.chunk(ci * t, t)
    sync(dev)
    return scn, buf, n_chunks


def bench_fullloop(cfg: ReceiverConfig, dev, fl_sec: float) -> dict:
    """bench.py:506-582: the whole receiver (Receiver.run_device: tracking,
    compact download, nav decode, pseudoranges, fixes in an Evaluator)
    over fl_sec of a 10-satellite scenario pre-synthesized on the card,
    in throughput mode (windows of up to 16 chunks, 4 in flight, one
    epoch a window); the first window is warm-up; the median of 3."""
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    t_fl = cfg.no_sec
    scn, buf, n_chunks = scenario_buffer(cfg, 3, fl_sec, dev)
    w_fl = min(16, max(1, n_chunks // 2))
    warm_fl = min(w_fl, n_chunks - 1)
    cfg_fl = cfg.replace(download_windows_in_flight=4,
                         chunks_per_download=w_fl, epoch_per_window=True)
    sig_fl = (n_chunks - warm_fl) * t_fl * cfg.block_sec
    rtfs = []
    for _ in range(3):
        rec = Receiver(cfg_fl, device=dev)
        ev = Evaluator(cfg_fl)
        t0 = None
        for epoch in rec.run_device(lambda first, n: buf[first:first + n],
                                    n_chunks):
            ev.process(epoch)
            if t0 is None:
                t0 = time.perf_counter()
        rtfs.append(sig_fl / (time.perf_counter() - t0))
        count_steps(rec.status.k_steps)
    rtfs.sort()
    return {"full_loop_rtf": round(float(np.median(rtfs)), 1),
            "full_loop_rtf_spread": {"min": round(rtfs[0], 1),
                                     "max": round(rtfs[-1], 1),
                                     "n": len(rtfs)},
            "full_loop_fixes": len(ev.positions),
            "full_loop_err_m": (
                round(float(np.linalg.norm(ev.stat[0] - scn.rec_ecef)), 2)
                if ev.stat is not None else "no fixes")}


def _dev_mem_mb(dev) -> tuple:
    """(allocated, peak allocated since the last reset) in MB on the card;
    (None, None) on the CPU."""
    if dev.type != "cuda":
        return None, None
    return (round(torch.cuda.memory_allocated(dev) / 1e6, 1),
            round(torch.cuda.max_memory_allocated(dev) / 1e6, 1))


def serve_once(cfg_sv: ReceiverConfig, s_count: int, buf, chunks: int,
               dev) -> tuple:
    """bench.py's serve_once: s_count replicas of the buffer's capture
    through StreamServer, each window's epochs evaluated across streams
    (process_many); the first window of every stream is warm-up.
    Returns (wall, signal seconds a stream, evaluators, stage seconds
    with the evaluation and the device-memory estimates)."""
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator, process_many
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_sv = cfg_sv.no_sec
    w_sv = cfg_sv.chunks_per_download
    srv = StreamServer(cfg_sv, s_count, device=dev)
    evs = [Evaluator(cfg_sv) for _ in range(s_count)]
    t0 = None
    n_ep = 0
    t_eval = 0.0
    pend = []
    perf0 = {}
    for s, epoch in srv.run(lambda first, n: buf[first:first + n], chunks):
        pend.append((evs[s], epoch))
        if len(pend) == s_count:
            te = time.perf_counter()
            process_many(pend)
            t_eval += time.perf_counter() - te
            pend = []
        n_ep += 1
        if n_ep == s_count and t0 is None:
            t0 = time.perf_counter()
            perf0 = dict(srv.perf)          # exclude warm-up stages
            t_eval = 0.0
    process_many(pend)
    wall = time.perf_counter() - t0
    count_steps(srv.receivers[0].status.k_steps)
    warm_c = min(w_sv, chunks - 1)
    sig = (chunks - warm_c) * t_sv * cfg_sv.block_sec
    perf = {k: v - perf0.get(k, 0.0) for k, v in srv.perf.items()}
    perf["evaluate"] = t_eval
    state_b = sum(x.numel() * x.element_size()
                  for g in srv._stacked for x in g)
    win_iq_b = (cfg_sv.download_windows_in_flight * w_sv * t_sv * 2
                * cfg_sv.ngps * 4)
    perf["dev_state_mb"] = round(state_b / 1e6, 1)
    perf["dev_window_iq_mb"] = round(win_iq_b / 1e6, 1)
    perf["dev_mem_mb"], perf["dev_mem_peak_mb"] = _dev_mem_mb(dev)
    return wall, sig, evs, perf


def _curve_entry(s_count, wall, sig, evs, pf) -> dict:
    host = sum(pf.get(k, 0.0) for k in ("unpack", "consume", "evaluate"))
    return {
        "aggregate_rtf": round(s_count * sig / wall, 1),
        "fixes_per_sec": round(sum(len(e.positions) for e in evs) / wall, 1),
        "streams_with_fixes": int(sum(1 for e in evs if e.positions)),
        "wall_s": round(wall, 2),
        "host_stage_s": round(host, 2),
        "host_share_pct": round(100 * host / wall, 1),
        "stages_s": {k: round(v, 3) for k, v in pf.items()
                     if not k.startswith("dev_")},
        "dev_state_mb": pf["dev_state_mb"],
        "dev_window_iq_mb": pf["dev_window_iq_mb"],
        "dev_mem_mb": pf["dev_mem_mb"],
        "dev_mem_peak_mb": pf["dev_mem_peak_mb"],
    }


def bench_serving(cfg: ReceiverConfig, dev, sv_sec: float, n_sv: int,
                  scale: list, w_sv: int | None, curve: bool) -> dict:
    """bench.py:593-737: n_sv full receivers off one card through
    StreamServer on one capture (a 10-satellite scenario of seed 5,
    pre-synthesized), with fixes; with `curve`, the same at every stream
    count of `scale` (the aggregate rate, fixes a second, host share and
    device memory against S)."""
    scn, buf, n_chunks = scenario_buffer(cfg, 5, sv_sec, dev)
    if w_sv is None:
        w_sv = min(16, max(1, n_chunks // 2))
    cfg_sv = cfg.replace(download_windows_in_flight=4,
                         chunks_per_download=w_sv, epoch_per_window=True)
    wall, sig, evs, perf = serve_once(cfg_sv, n_sv, buf, n_chunks, dev)
    out = {"serving_stage_sec": {k: round(v, 3) for k, v in perf.items()
                                 if not k.startswith("dev_")}}
    fixes = [len(e.positions) for e in evs]
    errs = [float(np.linalg.norm(e.stat[0] - scn.rec_ecef))
            for e in evs if e.stat is not None]
    skey = f"serving_{n_sv}x12"
    out[skey + "_aggregate_rtf"] = round(n_sv * sig / wall, 1)
    out[skey + "_fixes"] = int(sum(fixes))
    out[skey + "_streams_with_fixes"] = int(sum(f > 0 for f in fixes))
    out[skey + "_max_err_m"] = (round(max(errs), 2) if errs
                                else "no fixes")
    if curve:
        points = {str(n_sv): _curve_entry(n_sv, wall, sig, evs, perf)}
        for s_count in scale:
            if s_count == n_sv:
                continue              # the flagship measurement above
            points[str(s_count)] = _curve_entry(
                s_count, *serve_once(cfg_sv, s_count, buf, n_chunks, dev))
        out["serving_scale_curve"] = points
    return out


def bench_msps16(rng: np.random.Generator, dev, t16: int = 512) -> dict:
    """bench.py:744-807: 16.384 MS/s (cs 16384, n_cyc 8, corr_avg 4): the
    full grid on one block (3 satellites, noise 0.3), then 3 channels at
    K=16 over t16 blocks, the best of 3 single calls."""
    cfg16 = ReceiverConfig(code_samples=16384, n_cyc=8, corr_avg=4,
                           sweep_corr_avg=2)
    sats16 = [SatSignal(prn=int(p), doppler=float(rng.uniform(-4500, 4500)),
                        code_delay=float(rng.uniform(0, 16384)))
              for p in (4, 9, 27)]
    s16 = DeviceSynth(cfg16, sats16, noise_std=0.3, seed=3, device=dev)
    b16 = s16.chunk(0, 1)
    ftab16 = cacode.ca_fft_table(cfg16)
    ffts_all = torch.as_tensor(ftab16[np.asarray(cfg16.prns)], device=dev)
    d16 = torch.as_tensor(cfg16.doppler_bins, dtype=torch.float32,
                          device=dev)
    acquire_impl(cfg16, b16[0], d16, ffts_all)
    sync(dev)
    t0 = time.perf_counter()
    r16 = acquire_impl(cfg16, b16[0], d16, ffts_all)
    sync(dev)
    out = {"acq_16msps_full_grid_ms": round(
               (time.perf_counter() - t0) * 1e3, 1),
           "acq_16msps_found": int(r16.found.sum())}

    cfg16t = cfg16.replace(max_sat=3, blocks_per_step=16)
    blk16 = s16.chunk(0, t16)
    codes16, f16s = code_tables(cfg16t, sats16, dev)
    timed_track(cfg16t, sats16, blk16, codes16, f16s, dev)     # warm
    w16, o16 = 1e9, None
    for _ in range(3):
        w, _, o = timed_track(cfg16t, sats16, blk16, codes16, f16s, dev)
        if w < w16:
            w16, o16 = w, o
    out["track_16msps_rtf"] = round(t16 * cfg16t.block_sec / w16, 1)
    out["track_16msps_locked"] = int(o16.locked[-1].sum())
    return out


def bench_frontend(cfg: ReceiverConfig, dev) -> dict:
    """bench.py:813-830: the front end's FIR decimation by 4
    (ops/frontend.py fir_decimate, a strided conv1d) of 1.024 s of an
    8.192 MS/s capture, the mean of 4 calls after a warm one."""
    from gps_sdr_tpu_torch.ops.frontend import decimation_taps, fir_decimate

    taps = torch.as_tensor(decimation_taps(4), device=dev)
    n_in = 4 * cfg.ngps * 32
    xhi = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, n_in)).astype(np.float32), device=dev)
    fir_decimate(xhi, taps, 4)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(4):
        fir_decimate(xhi, taps, 4)
        sync(dev)
    w = (time.perf_counter() - t0) / 4
    return {"frontend_decimate_msps_in": round(n_in / w / 1e6, 1)}


# --- the result line --------------------------------------------------------

def device_entry(dev) -> dict:
    """The device that ran: torch's name and count, and on a card
    nvidia-smi's name and power limit."""
    if dev.type != "cuda":
        return {"name": "cpu", "count": 1, "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    idx = dev.index or 0
    return {"name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[idx] if idx < len(smi) else None}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def run(t_large: int, device="cuda") -> dict:
    """The whole bench in bench.py's order; returns the result dict."""
    if os.environ.get("BENCH_BF16"):
        raise ValueError("BENCH_BF16 selects bf16 inputs of the TPU's "
                         "matmul DFT, which the port does not have "
                         "(torch.fft); unset it")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    probe_start_ms = host_probe_ms()
    cfg = bench_config(_env_int("BENCH_K", 32))
    t_small = _env_int("BENCH_TSMALL", 512)
    selected = set(os.environ.get("BENCH_EXTRAS", "all").split(","))
    unknown = selected - set(EXTRAS) - {"all"}
    if unknown:
        raise ValueError(f"BENCH_EXTRAS: unknown extras {sorted(unknown)}; "
                         f"known: {', '.join(EXTRAS)}")

    def want(name: str) -> bool:
        return "all" in selected or name in selected

    rng = np.random.default_rng(0)
    sats = headline_sats(rng)
    synth = DeviceSynth(cfg, sats, noise_std=0.7, seed=1, device=dev)
    blk1 = synth.chunk(0, 1)
    launches = {}
    extra = {}

    def measured(name, fn, *args):
        reset_counts()
        out = fn(*args)
        launches[name] = read_counts()
        return out

    extra.update(bench_acquisition(cfg, blk1[0], dev))
    extra.update(bench_synth_rate(cfg, synth, t_small, dev))
    head = measured("headline", bench_headline, cfg, sats, synth, dev,
                    t_small, t_large)
    rtf_slope = head.pop("rtf_slope")

    stress = {}
    if want("widegrid"):
        stress.update(measured("widegrid", bench_widegrid, cfg, blk1[0],
                               dev))
    if want("snapshot"):
        stress.update(measured("snapshot", bench_snapshot, cfg, dev))
    if want("ch32"):
        stress.update(measured("ch32", bench_ch32, cfg, rng, dev, t_small))
    if want("streams"):
        stress.update(measured("streams", bench_streams, cfg, rng, dev,
                               t_small, _env_int("BENCH_STREAMS", 8)))
    if want("ncyc8"):
        stress.update(measured("ncyc8", bench_ncyc8, cfg, sats, dev))
    if want("fullloop"):
        stress.update(measured(
            "fullloop", bench_fullloop, cfg, dev,
            float(os.environ.get("BENCH_FULL_SEC", "96"))))
    if want("serving"):
        w_env = os.environ.get("BENCH_SERVE_W")
        stress.update(measured(
            "serving", bench_serving, cfg, dev,
            float(os.environ.get("BENCH_SERVE_SEC", "64")),
            _env_int("BENCH_SERVE_STREAMS", 8),
            [int(x) for x in os.environ.get(
                "BENCH_SERVE_SCALE", "1,2,4,8,16,32,48,64").split(",") if x],
            int(w_env) if w_env else None, want("servecurve")))
    if want("msps16"):
        stress.update(measured("msps16", bench_msps16, rng, dev))
    if want("frontend"):
        stress.update(measured("frontend", bench_frontend, cfg, dev))

    return {
        "metric": "realtime_factor_12ch_track",
        "value": round(rtf_slope, 2),
        "unit": "x_realtime_2.048MSps",
        "vs_baseline": round(rtf_slope, 2),
        "extra": {
            **head,
            **extra,
            "host_probe_ms": {"start": round(probe_start_ms, 1),
                              "end": round(host_probe_ms(), 1)},
            "backend": dev.type,
            # bench.py's flag of its XLA fallback; the port has none
            "pallas_fallback": False,
            "device": device_entry(dev),
            "kernel_launches": launches,
            **stress,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_tpu_torch.bench",
        description="Acquisition + 12-channel tracking realtime factor of "
                    "the PyTorch port (bench.py's workload).")
    ap.add_argument("t_large", nargs="?", type=int, default=8192,
                    help="blocks of the large tracking run (default 8192)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu by name")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.t_large, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
