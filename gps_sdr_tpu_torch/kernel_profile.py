"""Device time of the port's kernels and of its two slices, from
torch.profiler (CUPTI), on one NVIDIA GPU.

    python -m gps_sdr_tpu_torch.kernel_profile [--out PATH] [--only PART ...]

  1. each hand-written kernel at the product shapes (11 channels, K=8,
     n_cyc=32, cs=2048), 50 calls of its wrapper under the profiler: the
     kernel's own device time per call (the wrapper's host work is not
     in it), beside the wall time per call.  The cheap kernel runs twice:
     on fresh states ("cheap") and on slice-like states ("cheap_slice":
     locked channels, full wrapped rings, counters at their caps).  Then
     each kernel's stream-axis launch for 3 and 8 streams of those 11
     channels ("<name>_S3", "<name>_S8": one shared chunk, the cheap
     kernel on slice-like states);
  2. the host-fed replay slice of chip_smoke.py phase 4 (the
     synthetic_fix default scenario, 40 s of IQ synthesized on the host,
     through Session.run_source at use_mxu_wipeoff=True) and the
     device-resident slice of phase 6 (the same scenario synthesized on
     the card, 39 s of signal through Session.run_device_source at
     use_mxu_wipeoff=False).  Each slice runs once as a short warm-up,
     once unprofiled for its wall, then once profiled whole: the
     device's busy time (sum of its kernels and copies), its share of
     the unprofiled wall, the device-to-device copies per K-step, and
     the device time by item;
  3. the serving slice of chip_smoke.py phase 7b: 8 replicas of that
     scenario synthesized on the card, through StreamServer with the
     CLI's `serve` settings at ReceiverConfig() (kernel 1), evaluated
     with process_many: warmed up, run unprofiled for its wall and the
     launch counts, then profiled whole: the kernel bodies per K-step
     (one launch of each serves all 8 streams), the device's busy share
     of the wall, the launches per K-step of a stream, the server's
     stage totals and the device time by item;
  4. the front-end slices of chip_smoke.py phase 8, as in 2:
     frontend_slice (8b: the scenario synthesized at 8.192 MS/s on the
     card, downloaded a chunk at a time, decimated by the front end's
     FIR on the card, then Session.run_source) and cw_slice (8c:
     tests/test_multipath.py's CW scenario through
     Session.run_device_source with cw_excision=12, then without);
     each slice also sums the device time of the cuFFT and the
     convolution kernels;
  5. the wideband slice of chip_smoke.py phase 9: wideband_kernels, each
     kernel's device time a call at cs 16384, n_cyc 8, corr_avg 4, K=8
     for 8 and 11 channels; wideband_slice (9c: tests/test_multipath.py's
     ray scenario synthesized on the card at 16.384 MS/s through
     Session.run_device_source, kernel 1 and cheap), as in 2, with the
     kernels' bodies a K-step;
  6. the host slice of chip_smoke.py phase 10: ncyc64_kernels, each
     kernel's device time a call at n_cyc 64 for 11 and 32 channels;
     host_slice, the two-process run (phase 4's scenario as an iq8
     capture, `--role recv` on the card, epochs over UDP to an `eval`
     child): its wall, the device's busy share and the eval's output;
  7. bench_kernels: each kernel's device time a call at the bench's and
     the soak's K-steps (bench_kernel_configs: K=16 and 32 at 12
     channels, and K=16 at cs 16384 with 3 channels);
  8. rate_kernels: each kernel's device time a call at 12 channels, K=8,
     n_cyc 32, at the code periods of RATE_CS: 2.048 MS/s (cs 2048, on
     the wipeoff kernels' 128-column grid) and 2.0, 2.4 and 2.5 MS/s
     (cs 2000, 2400, 2500: a partial last tile).
Every slice also sums its hand-written kernels' device time.
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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the host slice's iq8 capture holds the scenario's IQ times HOST_SCALE
# (unclipped); its eval child ends after EVAL_IDLE_SEC without an epoch
HOST_SCALE = 0.1
EVAL_IDLE_SEC = 5.0
# rate_kernels' code periods: 2.048, 2.0, 2.4 and 2.5 MS/s
RATE_CS = (2048, 2000, 2400, 2500)


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


def synth_iq(scn, n_blocks: int, step: int, workers: int = 8,
             noise_std: float = NOISE):
    """The scenario's IQ, complex64 [n_blocks, ngps], synthesized on the
    host in parallel threads of `step` blocks (numpy over whole arrays
    releases the GIL); the bytes of one synth_scenario_blocks call a
    step, in order.  Threads, not processes, so that no process
    outlives the caller."""
    import concurrent.futures as cf

    import numpy as np

    from gps_sdr_tpu_torch.models.scenario import synth_scenario_blocks

    firsts = list(range(0, n_blocks, step))
    workers = max(1, min(workers, os.cpu_count() or 1, len(firsts)))
    with cf.ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(
            lambda f: synth_scenario_blocks(scn, f, min(step, n_blocks - f),
                                            noise_std=noise_std), firsts))
    return np.concatenate(parts)


HI_FACTOR = 4                       # 8.192 MS/s captures, decimated by 4
CW_SEC, CW_SATS, CW_SEED, CW_NOISE = 36.0, 8, 2, 1.0
CW_TONE = (1500.0, 10.0, 0.4)       # Hz, amplitude, phase (+40 dB J/S)


def hi_rate_synth(cfg, dev, sec: float = 40.0):
    """(scenario, synth): the synthetic_fix default scenario synthesized
    on the card at HI_FACTOR x the rate (code_samples 8192, 8.192 MS/s),
    as an Airspy-class capture of it would hold it."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth

    hi = cfg.replace(code_samples=HI_FACTOR * cfg.code_samples)
    scn = make_scenario(hi, n_sats=N_SATS, seed=SEED, duration_sec=sec + 12.0)
    return scn, DeviceScenarioSynth(scn, noise_std=NOISE,
                                    knot_interp_step=0.1, device=dev)


def decimated_blocks(synth, cfg, n_blocks: int, dev, step: int = 16,
                     timer: dict | None = None):
    """The first n_blocks 2.048 MS/s blocks of a hi-rate synth, as
    `replay --input-rate` makes them: the capture downloaded `step` of its
    blocks at a time, then ops/frontend.py frontend_blocks (the FIR on
    `dev`).  timer["synth_s"] accumulates the synthesis and download."""
    from gps_sdr_tpu_torch.ops.frontend import frontend_blocks

    def raw():
        for first in range(0, n_blocks, step):
            t0 = time.perf_counter()
            x = synth.chunk(first, min(step, n_blocks - first))
            x = x.reshape(-1).cpu().numpy()
            if timer is not None:
                timer["synth_s"] = timer.get("synth_s", 0.0) + (
                    time.perf_counter() - t0)
            yield x

    return frontend_blocks(raw(), cfg, HI_FACTOR, device=dev)


def ray_scenario(cfg, sec: float = CW_SEC, cw: tuple = ()):
    """tests/test_multipath.py's multipath scenario: 8 satellites (seed
    2), each with a specular ray (0.3-0.7 chips, half amplitude, seeded
    phase), and the narrowband tones `cw` ((Hz, amplitude, phase) each)."""
    import numpy as np

    from gps_sdr_tpu_torch.models.scenario import make_scenario

    scn = make_scenario(cfg, n_sats=CW_SATS, duration_sec=sec + 12.0,
                        seed=CW_SEED, cw=cw)
    rng = np.random.default_rng(7)
    for s in scn.sats:
        s.multipath = (float(rng.uniform(0.3, 0.7)), 0.5,
                       float(rng.uniform(0, 2 * np.pi)))
    return scn


def cw_scenario(cfg, sec: float = CW_SEC):
    """ray_scenario with a +40 dB J/S tone at 1500 Hz (CW_TONE)."""
    return ray_scenario(cfg, sec, (CW_TONE,))


# the JAX package's 16.384 MS/s multipath mode (tests/test_multipath.py
# test_multipath_bias_collapses_at_16msps): 16384-sample code periods,
# 8 ms blocks, 4 center periods a correlation
WIDE_FACTOR = 8


def wide_config(cfg, factor: int = WIDE_FACTOR):
    """cfg at factor x 2.048 MS/s with n_cyc 8 and corr_avg 4 (factor 8:
    the 16.384 MS/s multipath mode; factor 1: the same blocks at the
    reference rate)."""
    return cfg.replace(code_samples=2048 * factor, n_cyc=8, corr_avg=4)


def wideband_synth(cfg, dev, factor: int = WIDE_FACTOR, sec: float = CW_SEC):
    """(config, scenario, synth) of ray_scenario at factor x 2.048 MS/s,
    synthesized on the card at the C/N0 of noise NOISE at 2.048 MS/s: the
    per-sample noise is NOISE x sqrt(factor), since the same noise density
    spreads over factor x the band."""
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth

    c = wide_config(cfg, factor)
    scn = ray_scenario(c, sec)
    return c, scn, DeviceScenarioSynth(scn, noise_std=NOISE * math.sqrt(factor),
                                       knot_interp_step=0.1, device=dev)


def doppler_errors(scn, rx, t_end: float) -> dict:
    """PRN -> (tracked - true) Doppler, Hz, of each locked channel at
    t_end seconds into the scenario (test_multipath.py's check)."""
    import numpy as np

    from gps_sdr_tpu_torch.config import L1_FREQ
    from gps_sdr_tpu_torch.ops.tracking import summarize_states

    st = summarize_states(rx.cfg, rx.states)
    out = {}
    for slot, prn in enumerate(rx.slots.slot_prn):
        if prn == 0 or not st["locked"][slot]:
            continue
        sat = next(s for s in scn.sats if s.prn == prn)
        tau = scn.sat_states(scn.t_rx0 + np.array([t_end, t_end + 1.0]),
                             sat)[0]
        out[prn] = float(st["freq"][slot] + L1_FREQ * (tau[1] - tau[0]))
    return out


def _kernel_inputs(cfg, dev, seed=7, n_blocks=None):
    """Random kernel inputs of cfg.max_sat channels over a chunk of
    n_blocks blocks (default a whole chunk, cfg.no_sec)."""
    import torch

    from gps_sdr_tpu_torch.ops import tracking

    g = torch.Generator(device="cpu").manual_seed(seed)
    n_ch, k, cs = cfg.max_sat, cfg.blocks_per_step, cfg.code_samples
    chunk = torch.randn((n_blocks or cfg.no_sec, 2, cfg.n_cyc, cs),
                        generator=g)
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


def free_udp_ports(n: int) -> list:
    """n distinct UDP ports the OS reports free (held open together while
    they are chosen)."""
    import socket

    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def udp_port_bound(port: int) -> bool:
    """Whether some socket of this machine is bound to UDP `port` (read
    from /proc/net/udp and udp6; binding a probe instead could take the
    port from the process that is about to bind it)."""
    want = f":{port:04X}"
    for table in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except FileNotFoundError:
            continue
        if any(row.split()[1].endswith(want) for row in rows):
            return True
    return False


def wait_until_bound(proc, port: int, timeout: float = 120.0) -> None:
    """Wait until process `proc` has bound UDP `port`, or raise if it
    exits first or never does."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"eval process exited early (rc "
                                 f"{proc.returncode}): {proc.stdout.read()}")
        if udp_port_bound(port):
            return
        time.sleep(0.1)
    raise AssertionError(f"eval process never bound UDP port {port}")


def start_eval(argv, data_port: int, ctrl_port: int, idle_sec: float):
    """`python -m gps_sdr_tpu_torch` with `argv` (eval or --role eval) in a
    child process whose transport uses data_port/ctrl_port and whose eval
    loop ends after idle_sec without an epoch; returns the Popen once the
    child has bound data_port.  The caller kills it in a `finally`."""
    code = ("import sys\n"
            "from gps_sdr_tpu_torch import cli\n"
            "from gps_sdr_tpu_torch.runtime import transport\n"
            f"transport.DATA_PORT, transport.CTRL_PORT = {data_port}, "
            f"{ctrl_port}\n"
            f"cli.EVAL_IDLE_SEC = {idle_sec!r}\n"
            f"sys.exit(cli.main({list(argv)!r}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        wait_until_bound(proc, data_port)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return proc



def profile_kernels(cfg, dev, reps: int = 50, stream_counts=(3, 8),
                    n_blocks=None) -> dict:
    """Each kernel's device time a call at cfg (cfg.max_sat channels),
    and on the stream axis for each count in stream_counts; the inputs span
    n_blocks blocks (_kernel_inputs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff, tracking

    x = _kernel_inputs(cfg, dev, n_blocks=n_blocks)
    k = cfg.blocks_per_step
    st = tracking.init_channel_states(cfg, cfg.max_sat, dev)
    st = st._replace(active=torch.ones_like(st.active),
                     locked=torch.ones_like(st.locked))
    st_slice = slice_like_states(cfg, dev)
    _, head, seg = hopper_wipeoff.mix_wipeoff_vpu(
        cfg, k, x["s"], x["snp"], x["phase"], x["wipe"], x["planar"], 1,
        x["codes"])
    delay = x["wipe"].clone()

    def streams(n):
        """The stream axis: n copies of the channels' inputs over one
        shared chunk, and the stacked state."""
        cat = {key: torch.cat([x[key]] * n) for key in
               ("s", "snp", "phase", "wipe", "codes")}
        cat["st"] = tracking.ChannelState(*(torch.cat([v] * n)
                                            for v in st_slice))
        cat["head"], cat["seg"] = torch.cat([head] * n), torch.cat([seg] * n)
        return cat

    def on_streams(name, n):
        y = streams(n)
        if name == "cheap":
            return lambda: hopper_cheap.cheap_scan(
                cfg, k, y["head"], y["seg"], y["wipe"], y["wipe"], y["st"])
        fn = getattr(hopper_wipeoff, name)
        chunk = x["cplx"] if name == "mix_wipeoff" else x["planar"]
        return lambda: fn(cfg, k, y["s"], y["snp"], y["phase"], y["wipe"],
                          chunk, 1, y["codes"], n)

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
    # the stream axis, one launch for n streams (slice-like states)
    for n in stream_counts:
        for name, fn, kernel in (("wipeoff", "mix_wipeoff", "wipeoff_kernel"),
                                 ("wipeoff_vpu", "mix_wipeoff_vpu",
                                  "wipeoff_vpu_kernel"),
                                 ("cheap", "cheap", "cheap_kernel")):
            calls[f"{name}_S{n}"] = on_streams(fn, n)
            names[f"{name}_S{n}"] = (kernel,)
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


def _family(times: dict, word: str) -> dict:
    """Device us and calls of the device events whose name holds `word`
    (e.g. "fft": cuFFT's kernels)."""
    hits = [v for key, v in times.items() if word in key.lower()]
    return {"us": sum(us for us, _ in hits),
            "calls": sum(n for _, n in hits)}


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
            "fft_device_us": _family(times, "fft"),
            "conv_device_us": _family(times, "conv"),
            "kernels_device_us": {name: _family(times, name) for name in (
                "wipeoff_kernel", "wipeoff_vpu_kernel", "cheap_kernel")},
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


def profile_frontend_slice(cfg, dev, sec: float = 40.0) -> dict:
    """The decimated replay slice (chip_smoke.py phase 8b): the scenario
    synthesized at 8.192 MS/s on the card, downloaded a chunk at a time,
    decimated by the front end's FIR on the card, then Session.run_source
    (kernel 1 and cheap).  The wall holds the synthesis and the FIR."""
    import torch

    from gps_sdr_tpu_torch.runtime.session import Session

    cfg = cfg.replace(use_mxu_wipeoff=True)
    scn, synth = hi_rate_synth(cfg, dev, sec)
    n_blocks = int(round(sec / cfg.block_sec))

    def run(n):
        session = Session(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = session.run_source(decimated_blocks(synth, cfg, n, dev))
        torch.cuda.synchronize()
        return session, summary, time.perf_counter() - t0

    res = _profile_slice(run, 1 + 2 * cfg.no_sec, n_blocks, scn.rec_ecef)
    return {"signal_s": n_blocks * cfg.block_sec, **res}


def profile_cw_slice(cfg, dev, sec: float = CW_SEC) -> dict:
    """The CW excision slice (chip_smoke.py phase 8c): the CW scenario
    synthesized on the card, through Session.run_device_source with
    cw_excision=12 (kernel 2 and cheap on excised grouped planar
    chunks); then the same without excision ("no_excision"), whose FFT
    time is the tracking's alone."""
    import torch

    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.runtime.session import Session

    out = {}
    for thr in (12.0, 0.0):
        c = cfg.replace(cw_excision=thr, use_mxu_wipeoff=False)
        scn = cw_scenario(c, sec)
        synth = DeviceScenarioSynth(scn, noise_std=CW_NOISE,
                                    knot_interp_step=0.1, device=dev)
        n_chunks = int(round(sec / c.block_sec)) // c.no_sec

        def run(n):
            session = Session(c, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = session.run_device_source(synth.chunk_planar, n)
            torch.cuda.synchronize()
            return session, summary, time.perf_counter() - t0

        res = _profile_slice(run, c.chunks_per_download + 1, n_chunks,
                             scn.rec_ecef)
        res = {"signal_s": n_chunks * c.no_sec * c.block_sec, **res}
        if thr:
            out.update(res)
        else:
            out["no_excision"] = res
    return out


def profile_wideband_kernels(cfg, dev) -> dict:
    """Each kernel's device time a call at the 16.384 MS/s multipath mode
    (cs 16384, n_cyc 8, corr_avg 4, K=8) for 8 and 11 channels, one
    stream, on random inputs of 2 K-steps."""
    wide = wide_config(cfg)
    return {f"ch{n}": profile_kernels(
        wide.replace(max_sat=n), dev, stream_counts=(),
        n_blocks=2 * wide.blocks_per_step) for n in (8, 11)}


def profile_wideband_slice(cfg, dev, sec: float = CW_SEC) -> dict:
    """The wideband slice (chip_smoke.py phase 9c): ray_scenario
    synthesized on the card at 16.384 MS/s and run closed loop through
    Session.run_device_source with kernel 1 and cheap; the kernels'
    bodies a K-step beside the slice's device time by item."""
    import torch

    from gps_sdr_tpu_torch.runtime.session import Session

    c, scn, synth = wideband_synth(cfg.replace(use_mxu_wipeoff=True), dev,
                                   WIDE_FACTOR, sec)
    n_chunks = int(round(sec / c.block_sec)) // c.no_sec

    def run(n):
        session = Session(c, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = session.run_device_source(synth.chunk_planar, n)
        torch.cuda.synchronize()
        return session, summary, time.perf_counter() - t0

    res = _profile_slice(run, c.chunks_per_download + 1, n_chunks,
                         scn.rec_ecef)
    k_steps = max(res["k_steps"], 1)
    return {"signal_s": n_chunks * c.no_sec * c.block_sec,
            "kernel_us_per_k_step": {
                name: v["us"] / k_steps
                for name, v in res["kernels_device_us"].items()}, **res}


def profile_ncyc64_kernels(cfg, dev) -> dict:
    """Each kernel's device time a call at n_cyc 64 (65 slots: the cheap
    kernel's four-slot build) for 11 and 32 channels, on random inputs
    of 2 K-steps."""
    c64 = cfg.replace(n_cyc=64)
    return {f"ch{n}": profile_kernels(
        c64.replace(max_sat=n), dev, stream_counts=(),
        n_blocks=2 * c64.blocks_per_step) for n in (11, 32)}


def bench_kernel_configs(cfg) -> dict:
    """The K-steps of the bench (gps_sdr_tpu_torch/bench.py) and the soak
    beyond the product's K=8: 12 channels at K=16 (the soak's) and K=32
    (the bench's), and msps16's 3 channels at cs 16384, n_cyc 8, corr_avg
    4, K=16."""
    return {"k16": cfg.replace(max_sat=12, blocks_per_step=16),
            "k32": cfg.replace(max_sat=12, blocks_per_step=32),
            "msps16_k16": wide_config(cfg).replace(max_sat=3,
                                                   blocks_per_step=16)}


def profile_bench_kernels(cfg, dev) -> dict:
    """Each kernel's device time a call at bench_kernel_configs, on random
    inputs of 2 K-steps."""
    return {tag: profile_kernels(c, dev, stream_counts=(),
                                 n_blocks=2 * c.blocks_per_step)
            for tag, c in bench_kernel_configs(cfg).items()}


def profile_rate_kernels(cfg, dev) -> dict:
    """Each kernel's device time a call at 12 channels and cfg's K and
    n_cyc for each code period of RATE_CS, on random inputs of 2
    K-steps."""
    return {f"cs{cs}": profile_kernels(
        cfg.replace(code_samples=cs, max_sat=12), dev, stream_counts=(),
        n_blocks=2 * cfg.blocks_per_step) for cs in RATE_CS}


def profile_host_slice(cfg, dev, sec: float = 40.0) -> dict:
    """The two-process topology of chip_smoke.py phase 10b: the synthetic
    fix scenario (host IQ times HOST_SCALE in an iq8 capture) replayed by
    `--role recv` in this process on the card, its epochs over UDP to an
    `eval` child with the native host core.  A short in-process replay
    warms up, one run gives the wall, a second runs under the profiler:
    the device's busy time and its share of the unprofiled wall, and the
    eval child's output (epochs received, evaluation seconds)."""
    import contextlib
    import io
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gps_sdr_tpu_torch import cli
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.runtime import _native, transport

    scn = make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                        duration_sec=sec + 12.0)
    n_blocks = int(round(sec / cfg.block_sec))
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "cap.bin")
        _native.pack_iq(HOST_SCALE * synth_iq(scn, n_blocks,
                                              4 * cfg.no_sec)).tofile(cap)
        dev_arg = str(dev)

        def run_two(profiled):
            """(wall s, recv output, eval output, profiler or None)."""
            data, ctrl = free_udp_ports(2)
            proc = start_eval(["eval", "--ui", "none"], data, ctrl,
                              EVAL_IDLE_SEC)
            saved = transport.DATA_PORT, transport.CTRL_PORT
            prof = (profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
                    if profiled else contextlib.nullcontext())
            out = io.StringIO()
            try:
                transport.DATA_PORT, transport.CTRL_PORT = data, ctrl
                with contextlib.redirect_stdout(out), prof:
                    t0 = time.perf_counter()
                    cli.main(["replay", cap, "--role", "recv", "--device",
                              dev_arg, "--ui", "none"])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                eval_out, _ = proc.communicate(timeout=EVAL_IDLE_SEC + 60)
            finally:
                transport.DATA_PORT, transport.CTRL_PORT = saved
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            return (wall, out.getvalue().strip(), eval_out.strip(),
                    prof if profiled else None)

        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["replay", cap, "--device", dev_arg, "--ui", "none",
                      "--max-sec", "2"])
        wall, recv_out, eval_out, _ = run_two(False)
        wall_prof, _, _, prof = run_two(True)
    times = _device_times(prof)
    total = sum(us for us, _ in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:15]
    return {"signal_s": n_blocks * cfg.block_sec, "wall_s": wall,
            "rtf": n_blocks * cfg.block_sec / wall,
            "wall_s_profiled": wall_prof,
            "device_busy_s": total / 1e6,
            "device_busy_share": total / 1e6 / wall,
            "recv": recv_out, "eval": eval_out,
            "kernels_device_us": {name: _family(times, name) for name in (
                "wipeoff_kernel", "wipeoff_vpu_kernel", "cheap_kernel")},
            "top_device_us": {k: {"us": us, "calls": n}
                              for k, (us, n) in top}}


def profile_serving_slice(cfg, dev, n_streams: int = 8,
                          sec: float = 40.0) -> dict:
    """The serving slice: n_streams replicas of the scenario through
    StreamServer (kernel 1 and cheap on the stream axis)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator, process_many
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    cfg = cfg.replace(chunks_per_download=16, download_windows_in_flight=4,
                      epoch_per_window=True)
    scn = make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                        duration_sec=sec + 12.0)
    synth = DeviceScenarioSynth(scn, noise_std=NOISE, knot_interp_step=0.1,
                                device=dev)
    n_chunks = int(round(sec / cfg.block_sec)) // cfg.no_sec
    counters = {"wipeoff": hopper_wipeoff.mix_wipeoff,
                "wipeoff_vpu": hopper_wipeoff.mix_wipeoff_vpu,
                "cheap": hopper_cheap.cheap_scan}

    def run(n):
        srv = StreamServer(cfg, n_streams, device=dev)
        evs = [Evaluator(cfg) for _ in range(n_streams)]
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pend = []
        for s, epoch in srv.run(synth.chunk_planar, n):
            pend.append((evs[s], epoch))
            if len(pend) == n_streams:
                process_many(pend)
                pend = []
        if pend:
            process_many(pend)
        torch.cuda.synchronize()
        return srv, evs, time.perf_counter() - t0

    run(cfg.chunks_per_download + 1)
    srv, evs, wall = run(n_chunks)
    launches = {name: fn.launches for name, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv_p, _, wall_prof = run(n_chunks)
    times = _device_times(prof)
    total = sum(us for us, _ in times.values())
    k_steps = srv_p.receivers[0].status.k_steps
    bodies = {name: sum(us for key, (us, _) in times.items()
                        if kernel in key) / max(k_steps, 1)
              for name, kernel in (("wipeoff", "wipeoff_kernel"),
                                   ("cheap", "cheap_kernel"))}
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:15]
    sig = n_chunks * cfg.no_sec * cfg.block_sec
    return {"streams": n_streams, "signal_s": sig, "wall_s": wall,
            "aggregate_rtf": n_streams * sig / wall,
            "wall_s_profiled": wall_prof,
            "device_busy_s": total / 1e6,
            "device_busy_share": total / 1e6 / wall,
            "k_steps_per_stream": k_steps,
            "launches": launches,
            "launches_per_k_step": {n: v / max(k_steps, 1)
                                    for n, v in launches.items()},
            "kernel_us_per_k_step": bodies,
            "perf_s": dict(srv.perf),
            "err_m": [float(np.linalg.norm(ev.stat[0] - scn.rec_ecef))
                      if ev.stat is not None else None for ev in evs],
            "fft_device_us": _family(times, "fft"),
            "conv_device_us": _family(times, "conv"),
            "top_device_us": {k: {"us": us, "calls": n}
                              for k, (us, n) in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--only", nargs="+", default=None,
                    choices=("kernels", "replay_slice", "device_slice",
                             "serving_slice", "frontend_slice", "cw_slice",
                             "wideband_kernels", "wideband_slice",
                             "ncyc64_kernels", "host_slice",
                             "bench_kernels", "rate_kernels"),
                    help="run only these parts (default: all)")
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
    parts = {"kernels": profile_kernels,
             "replay_slice": profile_replay_slice,
             "device_slice": profile_device_slice,
             "serving_slice": profile_serving_slice,
             "frontend_slice": profile_frontend_slice,
             "cw_slice": profile_cw_slice,
             "wideband_kernels": profile_wideband_kernels,
             "wideband_slice": profile_wideband_slice,
             "ncyc64_kernels": profile_ncyc64_kernels,
             "host_slice": profile_host_slice,
             "bench_kernels": profile_bench_kernels,
             "rate_kernels": profile_rate_kernels}
    res = {"card": card}
    for name, fn in parts.items():
        if args.only is None or name in args.only:
            res[name] = fn(cfg, dev)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
