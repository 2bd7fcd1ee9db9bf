#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gps_sdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and the script exits non-zero):
  0. device: CUDA must be available; prints the card's name and power
     limit (nvidia-smi);
  1. build: compiles the port's CUDA kernels and its native host core
     from the repository's sources (one nvcc per kernel source, sm_90a,
     and one g++ per host source, csrc/{evalcore,navscan,ingest}.cpp,
     all at once) and prints the seconds taken;
  2. the wipeoff kernel (csrc/wipeoff.cu) against its plain PyTorch
     version on the card, at the product shapes (11 channels, K=8, one
     32-block chunk), then with wipe delays 0, 1, 127, 128 and cs - 1 at
     the product and the tests' small configuration;
  3. the cheap-stage kernel against its plain version on the card, at
     the product shapes: 8 chained K-steps, one from a full wrapped
     correlation ring, one with ms_time past 2^24; then the crafted case
     (cheap_case) at the product and the small configuration, with the
     kernel's input state checked unchanged (the kernel takes n_cyc + 1
     <= 128 slots, n_cyc 8 to 64: phase 10e runs these checks at 64);
     3b. the packed-IQ unpack kernel (csrc/unpack.cu) against the host's
     table bit for bit on all 65,536 words and a product chunk, timed;
  4. the replay slice: the examples/synthetic_fix.py default scenario
     (6 satellites, seed 3, noise 0.5, 40 s of IQ synthesized on the
     host) through the port's Session.run_source on the card; the
     wipeoff and cheap kernels must have run on every K-step and the
     wipeoff_vpu kernel never, the acquired PRNs must be the scenario's,
     at least 4 ephemerides must decode and the mean fix must be within
     8 m of the truth;
  5. the wipeoff_vpu kernel (csrc/wipeoff_vpu.cu) against its plain
     version on the card, on the phase-2 cases in the grouped planar
     layout (the predicted delays, then the crafted ones at the product
     and the small configuration), with phase 2's tolerances;
  6. the device-resident slice: the same scenario synthesized on the
     card (models/scenario_dev.py) and run through
     Session.run_device_source with ReceiverConfig(use_mxu_wipeoff=False)
     (fused windows of 8 chunks, compact transport); the wipeoff_vpu and
     cheap kernels must have run on every K-step and the wipeoff kernel
     never, and the same PRN, ephemeris and fix checks hold, with no
     bit edge dropped by the transport;
  7. the serving slice (runtime/serving.py StreamServer) at the product
     shapes:
     a. the stream axis of the kernels: at S = 4 streams of 11 channels,
        with one shared chunk and with 4 distinct ones, each wipeoff
        kernel's stream-axis launch against its plain version with
        phase 2's tolerances, and bit for bit against 4 single-stream
        launches; the cheap kernel over S*C = 44 channels likewise, with
        phase 3's tolerances; then 8 replicas of one chunk 3 Hz apart,
        whose far streams' channels are led by noise (the df ring's
        tolerance grows with their rotation angle, df_ring_tolerance);
     b. 8 replicas of phase 6's scenario synthesized on the card, served
        with the CLI's `serve` settings (windows of 16 chunks, 4 in
        flight, one epoch a window) at ReceiverConfig()'s kernel 1, and
        evaluated with process_many: every stream acquires the
        scenario's PRNs, decodes >= 4 ephemerides, fixes within 8 m and
        drops no bit edge; the acquisition grid ran once; the wipeoff
        and cheap kernels launched once a K-step of one stream (not S
        times); stream 0's subframes equal those of a single
        Receiver.run_device of the same synthesis, and its code phases,
        keyed by block, agree within 5e-3 samples;
     c. 3 independent front ends (scenarios of seeds 3, 5 and 7) at
        use_mxu_wipeoff=False (kernel 2 on stacked windows), windows of
        8 chunks: the same checks per stream, and the streams' PRN sets
        differ;
  8. the front-end slice (ops/frontend.py, ops/snapshot.py,
     models/sim_dev.py):
     a. the front end's conv1d decimation on the card at factors 4 and
        8, complex and real-IF, against a float64 numpy reference (atol
        2e-6, TF32 off) and its CPU version (4e-6), and the CW excision
        on the card against its CPU version (the same bins nulled but
        for <= 2 a block within 1e-5 of the threshold); the device ms of
        one raw chunk of each;
     b. decimated replay: the phase-4 scenario synthesized on the card at
        8.192 MS/s, downloaded a chunk at a time, decimated by 4 on the
        card (frontend_blocks), through Session.run_source at
        ReceiverConfig(): phase 4's PRN, ephemeris and fix bars, kernel 1
        and cheap on every K-step; then `replay --input-rate 8192000`
        through cli.main on a 3 s iq8 capture of it (pack scale 0.1,
        unclipped): rc 0 and its first blocks equal to the in-memory
        front end's;
     c. CW excision: tests/test_multipath.py's scenario (8 satellites,
        seed 2, specular rays, a +40 dB J/S tone) synthesized on the card
        at noise 1.0, 36 s, through Session.run_device_source at
        cw_excision=12 (excised grouped planar chunks into kernel 2):
        >= 200 fixes, mean fix < 60 m, >= 5 locked channels within 10 Hz
        of their true Doppler, kernel 2 and cheap on every K-step; then
        once without excision, logged only;
     d. snapshot_fix on the card on block 8 of make_scenario(n_sats=7,
        seed=11), 47 km prior, tow 20 s off: n_sat >= 5, error < 50 m,
        |t_gps - t_rx| < 0.01 s; the `snapshot` CLI on a one-block iq8
        file: rc 0, lat/lon within 0.002/0.003 degrees;
     e. DeviceSynth on the card against its CPU version, noise off, 11
        satellites, one 32-block chunk (within the f32 spacing of the
        code position and the carrier angle, times the summed
        amplitude), and its ms a chunk;
  9. the wideband slice (the JAX package's 16.384 MS/s multipath mode,
     cs 16384, n_cyc 8, corr_avg 4):
     a. both wipeoff kernels past one cluster of column tiles, against
        their plain versions with phase 2's tolerances: cs 4096, 8192 and
        16384 at K=8, 8 and 11 channels with the predicted wipe delays
        and with 0, 1, 127, 128, 2047, 2048 and cs - 1, 32 channels at cs
        16384; repeated launches bit-identical, and a 2-stream launch
        (shared and distinct chunks) bit for bit two single launches;
        wrapper times and bounds at cs 16384, 8 and 11 channels;
     b. tests/test_multipath.py's single-satellite bias bars through the
        port's K-fused tracking on the card with kernel 2: clean < 4 m,
        a half-chip ray in and against phase and a quarter-chip ray
        < 12 m;
     c. its ray scenario (8 satellites, seed 2, rays of 0.3-0.7 chips at
        half amplitude), no tone, 36 s synthesized on the card at 16.384
        MS/s and run closed loop through Session.run_device_source with
        kernel 1 and cheap: the scenario's PRNs, >= 4 ephemerides, >= 200
        fixes, mean fix < 10 m, kernel 1 and cheap once a K-step, kernel 2
        never; then at 2.048 MS/s with n_cyc 8 at the same C/N0 (the
        per-sample noise sqrt(8) x smaller), logged against
        test_multipath's 60 m bar;
 10. the host slice (runtime/transport.py, the native host core, the
     CLI's two-process topology, `epochs` and `live`), on phase 4's
     blocks written as an iq8 capture (times HOST_SCALE, unclipped):
     b. `replay --role both` through cli.main in this process on the
        card, its native-core calls and its epochs recorded; then `eval`
        in a child process on two free UDP ports (never 61431/61432),
        its idle limit set to EVAL_IDLE_SEC, fed by `replay --role recv`
        through cli.main in this process on the card: the eval exits 0,
        the scenario's PRNs are acquired, >= 4 ephemerides decode, the
        mean fix is within 8 m of the truth, kernel 1 and cheap launch
        once a K-step and kernel 2 never, every epoch sent is received,
        and the positions equal the in-process run's epoch by epoch
        within 1e-3 m; the child is killed in a `finally`;
     a. the native host core against the port's numpy paths on the
        calls 10b recorded, at tests/test_native.py's tolerances (ECEF,
        the fix solver, sigma/slope, the unwrap, the subframe scan), the
        IQ unpack and the native ring; the evaluator's ms per epoch over
        10b's epochs, native and numpy;
     c. `epochs` of 10b's recorded epochs: the in-process run's
        positions exactly;
     d. `live --max-sec 12` through a stand-in `rtlsdr` module whose
        RtlSdr reads the capture's blocks: rc 0, the scenario's PRNs,
        kernel 1 and cheap once a K-step, and its --record-iq file read
        back by replay_blocks to the same blocks;
     e. phase 3's cheap checks at n_cyc 64 (the kernel's four-slot
        build) with 11 and 32 channels, and the cheap kernel's wrapper
        and plain times and bound at cs 16384, n_cyc 8, 11 channels;
 11. the sharding slice (gps_sdr_tpu_torch/parallel), every mesh of
     cuda:0 repeated (and of the real devices too where there are more
     than one); each sub-phase's wall and CUDA-event span logged:
     a. acquire_sharded on block 0 of phase 4's blocks, the product grid
        on a (2, 4) mesh and the +-10 kHz grid on (4, 2), against the
        unsharded acquire_impl (found, delay, freq exact, norm_max rtol
        2e-5) under utils/profiling.trace (its device busy time read
        back by device_time_from_trace): the scenario's PRNs found;
     b. TRACK_BLOCKS blocks of phase 4's blocks from the 11 slots 11a's
        acquisitions fill: the sequential K=1 scan on the card (its ms a
        block), the exact stitch on a (2, 2) mesh (12 slots) against it
        (code_phase 1e-4, freq 1e-3, locked and edge_valid exact, final
        freq/phase 1e-3), both through the receiver's consume pipeline
        and an Evaluator: the sequential run >= 4 ephemerides and a mean
        fix within 8 m, the stitched run the same subframes and fixes
        within 1e-3 m epoch by epoch; then the state handoff at
        HANDOFF_GRID, each row's lost subframes, fixes, error and median
        separation from the sequential fixes logged;
     c. phase 7b's 8 replicas (kernel 1) over a stream mesh of 4 and 7c's
        3 front ends (kernel 2) over a stream mesh of 3: each stream's
        epochs equal phase 7's unsharded server's (code phases within
        1e-5, frames' SAT and tow), 7b's fix bars, the wipeoff kernel and
        cheap once per group per K-step and the other wipeoff kernel
        never; the replicas saved halfway, resumed by load_server(mesh=)
        and run on: the uninterrupted sharded run's subframes and code
        phases exactly;
     d. two child processes (gloo on a free TCP port, each rank cuda:0 x
        2, a global (2, 2) mesh): track_sharded (exact) on 11b's first
        MP_BLOCKS blocks and acquire_sharded on block 0 equal the
        in-process (2, 2) mesh's and 11a's; neither child holds jax or
        gps_sdr_tpu; the children are killed in a `finally`;
 12. the bench slice (gps_sdr_tpu_torch/bench.py, examples/soak.py,
     examples/endurance.py):
     a. the three kernels at K=16 and K=32 against their
        plain versions with phase 2's and phase 3's tolerances, at the
        bench's product shapes (12 channels) and at its msps16 shapes
        (cs 16384, n_cyc 8, corr_avg 4, 3 channels, K=16): the predicted
        and the crafted wipe delays, 8 chained cheap steps and the
        crafted cheap case; each wrapper's and plain version's times
        and bounds; then both wipeoff kernels' times at n_cyc 64;
     b. the bench's main() in this process at cut sizes (BENCH_T_LARGE,
        BENCH_ENV), every extra, its JSON line parsed
        (check_bench_result): every extra that tracks launched kernel 1
        and cheap once a K-step and kernel 2 never, every channel
        locked, the headline's found fraction >= 0.85 and frequency
        error < 5 Hz, the snapshot within 50 m, the full loop's and
        every serving stream's fix within 8 m;
     c. the soak at SOAK_MINUTES of signal with its checkpoint and
        resume at half time, at 1 stream and at 8: soak.py's pass rule;
     d. endurance at ENDURANCE_MINUTES: PASS;
 13. the envelope slice: the JAX package's operating-envelope tests, each
     with its seed, satellites, duration, noise, scale and config fields
     (ENVELOPE), at ReceiverConfig() otherwise; every capture synthesized
     on the card (DeviceScenarioSynth), packed as iq8 and replayed
     through Session.run_source (kernel 1 and cheap once a K-step, kernel
     2 never), its first ENVELOPE_PREFIX chunks also through the plain
     path on the CPU and held to the card's (compare_chunks: the same
     acquisitions and slots; on channels converged in a chunk FRQ 1e-2
     Hz and the same bit edges, elsewhere FRQ within 0.6 Hz; code phases
     5e-3 samples, AMP and CRM rtol 1e-3 where locked on both; the same
     decoded subframes); each run's realtime factor and device busy
     share (a CUDA-only torch.profiler trace) logged, one line a run:
     a. test_sensitivity.py's stream at 50/45/42 dB-Hz and
        test_codephase_precision.py's through acquire_all and the K-fused
        tracking, card against CPU, with their bars (PRN 9 alone, locked,
        FRQ < 5 Hz, C/N0 within 2 dB, BER 0; RMS < 0.08, bias < 0.05);
     b. test_impaired_replay.py (+2 ppm, 2.6 Hz/s, 53 Doppler bins,
        solve_clock_rate) replayed, then synthesized on the card through
        run_device_source at use_mxu_wipeoff=False (kernel 2 and cheap
        once a K-step, kernel 1 never): its four bars on both runs;
     c. test_reference_degraded.py (noise 2.0, a 6758-sample gap at 30
        s): 1-4 phase-error trips, >= 6 satellites tracked before and
        after, >= 10 fixes before and after, the post-event mean error
        within max(2 m, half) of the pre-event one;
     d. test_channel_elasticity.py's A+B -> B+C stream with a requested
        sweep, every chunk card against CPU: the set ends {12, 23} and
        PRN 23 yields > 20 code phases;
     e. test_raim.py's faulted capture, RAIM on and off: its three bars;
     f. test_velocity.py's moving capture: its track and Doppler
        velocity bars;
     g. test_atmos_closed_loop.py's capture, corrections on and off,
        preloaded coefficients, the static velocity, and a second replay
        with almanac_resweep_sec 2: its bars.
 14. the examples slice (gps_sdr_tpu_torch/examples/synthetic_fix.py and
     analysis.py, the notebook's module), each run's error, realtime
     factor and device busy share logged:
     a. synthetic_fix.run at its defaults on phase 4's blocks: phase 4's
        fix count and ephemerides, its mean within 1 mm, PASS, kernel 1
        and cheap once a K-step and kernel 2 never; then `python -m
        gps_sdr_tpu_torch.examples.synthetic_fix --on-device --quiet` (no
        --device) in a child process: exit 0 and PASS;
     b. synthetic_fix --on-device with each of EXAMPLE_FLAG_SETS (TCXO
        offset and drift, iono + tropo, moving + track filter, SV-clock
        fault + RAIM, carrier smoothing): kernel 1 and cheap once a
        K-step, and the JAX example's verdict (PASS);
     c. analysis.ideal_epochs + evaluate = IDEAL_PINS; live_parallel on
        the card over two free UDP ports: >= 3 epochs, kernel 1 and cheap
        once a K-step, its epochs = an in-process Session run's (frames
        equal, code phases within 1.22e-4 samples);
     d. `replay --record-epochs` of phase 4's blocks on the card, read
        back in a child process by the `epochs` mode and by
        analysis.load_epochs: no jax or gps_sdr_tpu module loaded, the
        recording run's fixes.
 15. the parity slice, the card half of tests/test_torch_parity_*.py (the
     JAX package's tests twinned on the CPU), at ReceiverConfig():
     a. the cheap kernel's bit-edge chain against its plain version over
        8 chained K-steps of 11 channels (edge_chain_args: sign0 -1, 0
        and 1, prev_signal 0, exact-zero means, slots at and one f32
        step past the gate, unlocked channels, two chains erased
        mid-run): edges, sign0, prev_sign, prev_signal and ms_time bit
        for bit, the rest within _compare_cheap;
     b. test_tracking_batched.py's fresh pull-in on phase 4's capture:
        every satellite's channel 100 Hz off its true Doppler, K = 8, 16
        and 32, through kernel 1 and through kernel 2 (with cheap):
        locked from block 40, within 3 Hz at the end, the peak on > 80%
        of the blocks; the plain path on the card locks on the same
        blocks and agrees from block 40 (compare_chunks);
     c. T = 11 K + 4 blocks at K = 8 and 32: the 4-block tail through
        track_chunk_impl, the plain path's lock and code phases, and
        test_batched_remainder_tail's bar against the K=1 loop;
     d. a Session on the card through run_source (kernel 1) and
        run_device_source (fused windows, 2 in flight, kernel 2) with a
        scripted UI: CLEAR, HEIGHT and SET_HEIGHT after epoch 1 and STOP
        after epoch 2, or CLOSE after epoch 1; each run ends at the
        epoch and block the CPU Session ends at, with the CPU's effects;
     e. phase 4's capture replayed cold with --ephem-cache, then warm
        from the written cache: the first fix >= 1 epoch earlier, >= as
        many fixes; a cache aged past 2 h refused.
 16. the tools slice, the analysis tools of gps_sdr_tpu_torch/examples
     at their smallest sizes that reach a steady state and a fix, each
     run with the launch counters set to 0 just before it:
     a. roofline.run at K=16 with 12 channels on 512 blocks, through
        kernel 1 and then kernel 2 (with cheap): every stage bucket
        present, each kernel launched blocks / K times and every launch
        in the trace (roofline.check_complete), every share <= 1.0 and
        the busy µs a block at or above work_per_block's floor;
     b. probe_device_loop.probe at its defaults (40 s of the phase-4
        scenario on the card; at 24 s no fix has come yet): the phase
        split, the scenario's PRNs, >= 4 ephemerides, the mean fix
        within 8 m, one launch of kernel 1 and cheap a K-step;
     c. the host profilers, each on 40 s of its scenario (the first fix
        comes ~25 s in): profile_fullloop's run_device, profile_serving's
        8 streams, profile_evalhost's capture of 4 streams and its host
        cap; the same fix checks for every receiver and stream, the
        same launches, and each profile's top host functions;
     d. scaling_sweep.sweep_rows at 1/2/4 time shards on a mesh of
        cuda:0 repeated (4 channels, 32 blocks): the work factors, the
        exact stitch equal to the sequential scan as 11b holds it, and
        no kernel launched (the K=1 scan).
 17. the 2.4 MS/s slice (one RTL-SDR dongle: code_samples 2400; kernel
     1 in 16 column tiles of 152, the last 120 columns, kernel 2 in 19
     of 128, the last 96), K=8, 12 channels:
     a. both wipeoff wrappers on card tensors against their plain
        versions with phase 2's tolerances, with the predicted delays and
        with crafted ones around the first tile's edge and the last
        tile's first column, and inside the partial tile (RATE24_DELAYS);
        repeated launches bit-identical;
     b. a receiver chunk of two K-steps at that period
        (track_chunk_batched_impl), through kernel 1 and then kernel 2,
        the launch counters and the profiling counters zeroed just
        before each: the chosen wipeoff kernel and cheap launch once a
        K-step, the other wipeoff kernel never, track.partial_tile_steps
        counts every K-step; the correlation delays equal the CPU plain
        path's, its code phases within 5e-3 samples.
The line before the last holds the kernels' launches (launches_bench: a
count for each of the bench's extras; launches_envelope: one for each
phase-13 run; launches_examples: one for each phase-14 run in this
process; launches_parity: one for each phase-15 sub-phase;
launches_tools: one for each phase-16 run), errors, times and bounds as
JSON; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SLICE_SEC = 40.0
N_SATS, SEED, NOISE = 6, 3, 0.5
CHEAP_STEPS = 8                 # chained K-steps of the cheap-kernel check
# phase 14b: synthetic_fix's flag sets run --on-device (the JAX example
# passes each on the CPU: PERF.md)
EXAMPLE_FLAG_SETS = (("--osc-ppm", "2", "--osc-ppm-rate", "1.65e-3"),
                     ("--iono", "--tropo"),
                     ("--moving", "13,0", "--track-filter", "1"),
                     ("--fault-us", "1"),
                     ("--carrier-smoothing", "50"))


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# kernel-vs-plain cases (also used by tests/test_torch_cuda.py)


def _channels(cfg, n_ch, seed):
    """n_ch simulated satellites (distinct PRNs while there are enough)."""
    import numpy as np
    from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits

    rng = np.random.default_rng(seed)
    pool = np.arange(cfg.prn_min, cfg.prn_max + 1)
    # more channels than PRNs (32 against 31): some PRN twice, each copy
    # at its own Doppler and delay
    prns = rng.choice(pool, n_ch, replace=n_ch > len(pool))
    return [SatSignal(prn=int(p),
                      doppler=float(rng.uniform(-4500, 4500)),
                      code_delay=float(rng.uniform(0, cfg.code_samples)),
                      amplitude=float(rng.uniform(0.3, 1.0)),
                      carrier_phase=float(rng.uniform(0, 6.28)),
                      nav_bits=random_bits(256, seed=int(p)))
            for p in prns]


def make_case(cfg, n_ch, n_blocks, seed, device, on_card: bool = False):
    """(states, chunk, codes, code_ffts) on `device`: n_ch channels set
    to the Doppler and code delay of n_ch simulated satellites of an
    n_blocks chunk (noise 0.5), synthesized on the host
    (models/simulator.py) or with on_card=True by DeviceSynth on `device`
    (the same signal model, torch's noise), which the 16.384 MS/s cases
    take."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.models.sim_dev import DeviceSynth
    from gps_sdr_tpu_torch.models.simulator import synth_stream
    from gps_sdr_tpu_torch.ops import cacode, tracking

    sats = _channels(cfg, n_ch, seed)
    if on_card:
        chunk = DeviceSynth(cfg, sats, noise_std=0.5, seed=seed,
                            device=device).chunk(0, n_blocks)
    else:
        chunk = torch.as_tensor(synth_stream(cfg, sats, n_blocks,
                                             noise_std=0.5, seed=seed),
                                device=device)
    st = tracking.init_channel_states(cfg, n_ch, device)
    for i, s in enumerate(sats):
        st = tracking.reset_channel(st, i, s.prn, s.doppler,
                                    int(s.code_delay) % cfg.code_samples,
                                    cfg)
    codes = np.stack([cacode.ca_table(cfg)[s.prn] for s in sats])
    ffts = np.stack([cacode.ca_fft_table(cfg)[s.prn] for s in sats])
    return (st, chunk, torch.as_tensor(codes, device=device),
            torch.as_tensor(ffts, device=device))


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() in ms over `reps` calls (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms on one H100, what sets it): the larger of the bytes
    over the memory rate and the f32 operations over the f32 rate (the
    peaks of the whole-step roofline, examples/roofline.py)."""
    from gps_sdr_tpu_torch.examples.roofline import (H100_BYTES_PER_S,
                                                     H100_F32_PER_S)

    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = n_ops / H100_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_unpack(cfg, dev) -> dict:
    """The packed-IQ unpack kernel (csrc/unpack.cu) against the host's
    table bit for bit: all 65,536 words, then a chunk of no_sec random
    blocks of words, timed (median device ms) beside its bound: 2 bytes
    read and 8 written a sample."""
    import numpy as np
    import torch

    from gps_sdr_tpu_torch.ops.hopper_unpack import unpack_iq8
    from gps_sdr_tpu_torch.runtime.sources import unpack_iq_numpy

    words = np.random.default_rng(7).integers(
        0, 1 << 16, (cfg.no_sec, cfg.ngps), dtype=np.uint16)
    out = {}
    for tag, w in (("all_words", np.arange(1 << 16, dtype=np.uint16)),
                   ("chunk", words)):
        t = torch.from_numpy(w).view(torch.int16).to(dev)
        got = unpack_iq8(t).cpu().numpy().view(np.uint32)
        if not np.array_equal(got, unpack_iq_numpy(w).view(np.uint32)):
            raise AssertionError(f"[3b] unpack kernel differs from the "
                                 f"table on {tag}")
    bound, _ = _bound(10 * words.size, 0)
    out.update(bit_identical=True, chunk_words=int(words.size),
               ms=time_ms(lambda: unpack_iq8(t)), bound_ms=bound)
    return out


def wipeoff_bound(cfg, wipe) -> tuple[float, str]:
    """Bound of one K-step of either wipeoff kernel for wipeoff delays
    `wipe` i32[C, K].  Bytes: the K blocks read once (8 B a sample in
    either layout), the codes and per-channel parameters, the center
    periods, head and segment sums written once.  Operations, per
    channel, block and sample: 16 (oscillator 6, mix 6, wipeoff 2
    products and 2 sums), plus 2 for each head sample (column < w) and
    for each center-period sample, plus one sincos (2) per channel,
    block and column."""
    n_ch, k = wipe.shape
    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    n = n_ch * k * n_cyc * cs
    n_bytes = (k * n_cyc * cs * 8 + n_ch * cs * 4 + n_ch * (3 + k) * 4
               + k * n_ch * cs * 8 + n_ch * k * (n_cyc + 1) * 8)
    n_ops = (16 * n + 2 * n_cyc * int(wipe.sum())
             + 2 * n_ch * k * cfg.corr_avg * cs + 2 * n_ch * k * cs)
    return _bound(n_bytes, n_ops)


def crafted_wipe(cfg, n_ch):
    """Wipeoff delays i32[n_ch, K] cycling through 0, 1, 127, 128, (past
    cs 2048: 2047 and 2048, the edge of the first cluster's span) and
    cs - 1: the head mask and the code roll on both sides of a 128-column
    tile edge and at both ends of the code period."""
    import torch

    cs, k = cfg.code_samples, cfg.blocks_per_step
    vals = [0, 1, 127, 128] + ([2047, 2048] if cs > 2048 else []) + [cs - 1]
    vals = torch.tensor(vals, dtype=torch.int32)
    return vals[torch.arange(n_ch * k).reshape(n_ch, k) % len(vals)]


def check_wipeoff(cfg, states, chunk, step, codes, code_ffts,
                  timing: bool = False, vpu: bool = False,
                  wipe=None, n_streams: int = 1) -> dict:
    """A wipeoff kernel vs its plain version on the same CUDA inputs:
    mix_wipeoff on the complex chunk, or with vpu=True mix_wipeoff_vpu
    on the chunk in the grouped planar layout; `wipe` overrides the
    predicted wipeoff delays.  With n_streams > 1 the channels are those
    of that many streams (stream_case) and the chunk is shared
    ([T, ngps]) or one a stream ([S, T, ngps]).  Tolerances:
    head/seg/center max abs error <= 1e-4 of the largest magnitude (f32
    sums over 2048 samples in another order), and on the derived
    correlation delay exact, code_phase atol 5e-3, norm_max rtol
    2e-3."""
    import math

    import torch
    from gps_sdr_tpu_torch.ops import corr, hopper_wipeoff, tracking

    k = cfg.blocks_per_step
    s = 2.0 * math.pi * states.freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2.0 * math.pi)
    if wipe is None:
        wipe = tracking.predict_wipe_delays(cfg, k, states.freq,
                                            states.delay)
    wipe = wipe.to(chunk.device)
    if vpu:
        kernel = hopper_wipeoff.mix_wipeoff_vpu
        plain = hopper_wipeoff.mix_wipeoff_vpu_plain
        chunk = tracking.to_grouped_planar(cfg, chunk)
    else:
        kernel = hopper_wipeoff.mix_wipeoff
        plain = hopper_wipeoff.mix_wipeoff_plain
    name = kernel.__name__
    args = (cfg, k, s, snp, states.phase, wipe, chunk, step, codes,
            n_streams)
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for part, g, w in zip(("center", "head", "seg"), got, want):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        errs[part] = err
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{name} {part}: max err {err:.3g} > "
                                 f"1e-4 x {scale:.3g}")
    spec = corr.prep_spec(code_ffts)
    dg, cg, ng = corr.corr_peaks(got[0], spec, cfg.corr_min)
    dw, cw, nw = corr.corr_peaks(want[0], spec, cfg.corr_min)
    if not torch.equal(dg, dw):
        raise AssertionError(f"{name}: correlator delays differ "
                             f"{dg.tolist()} vs {dw.tolist()}")
    if not (dw >= 0).any():
        raise AssertionError(f"{name} case found no correlation peak")
    cp_err = float((cg - cw).abs().max())
    nm_err = float(((ng - nw).abs() / nw.abs()).max())
    if not (cp_err <= 5e-3 and nm_err <= 2e-3):
        raise AssertionError(f"{name}: code_phase err {cp_err:.3g}, "
                             f"norm_max rel err {nm_err:.3g}")
    errs.update(code_phase=cp_err, norm_max_rel=nm_err,
                max_abs_err=max(errs["center"], errs["head"], errs["seg"]))
    if timing:
        errs["ms"] = time_ms(lambda: kernel(*args))
        errs["plain_ms"] = time_ms(lambda: plain(*args))
        errs["bound_ms"], errs["bound_by"] = wipeoff_bound(cfg, wipe)
    return errs


def df_ring_tolerance(cfg, want, st):
    """Per channel, the df ring's tolerance on the step from state `st`:
    1e-5, or for a channel that was unlocked in some block of the step
    and whose virtual-NCO rotation angle grows large, twice the unlocked
    PLL gain times the f32 spacing of that angle, whichever is larger.

    The kernel and the plain version each round the rotation angle
    dphi + 2 pi df_sum t (it reaches 35 rad on a channel pulled
    23 Hz in one K-step) once in f32, in a different order; one spacing
    of the angle moves every rotated mean's arctan by that much, and
    the unlocked PLL multiplies phase_dev by pll_gain_unlocked into df
    (cheap_trace.py on an H100, PERF.md section 6: in the unlocked
    blocks the df differences stayed within 1.3 x gain x spacing, with
    no unwrap decision flipped).  The angle is bounded by the step's
    final |dphi| + 2 pi |df_sum| t_blk.  A channel locked in every block
    has gain 1 (pll_gain_locked) and is held at 1e-5, as are channels
    whose angle stays below 4 rad."""
    import numpy as np
    import torch

    t_blk = cfg.ngps / cfg.sample_rate
    ang = (want.dphi.abs() + 2.0 * np.pi * want.df_sum.abs() * t_blk
           ).double().cpu().numpy().astype(np.float32)
    tol = 2.0 * cfg.pll_gain_unlocked * np.spacing(ang).astype(np.float64)
    # the lock state each block starts from; locks only rise in a step
    locked_in = torch.cat([st.locked[:, None], want.locked_seq[:, :-1]],
                          dim=1)
    unlocked = (~locked_in.all(dim=1)).cpu().numpy()
    tol = np.where(unlocked, np.maximum(tol, 1e-5), 1e-5)
    return torch.from_numpy(tol).to(want.df_buf.device,
                                    torch.float32)[:, None]


def _compare_cheap(got, want, cfg, st) -> float:
    """CheapOut kernel vs plain on the step from state `st`.  Tolerances:
    amplitude rtol 1e-3, corr_q/corr_l atol 1e-6, float state atol 1e-3
    (carry_sum 1e-4 of its scale), df ring atol 1e-5 (more only for an
    unlocked channel, where df_ring_tolerance derives it from a large
    rotation angle); signs, locks, edges, counters and rings exact.
    Returns the largest absolute float error."""
    import torch

    worst = 0.0

    def close(name, atol=0.0, rtol=0.0):
        nonlocal worst
        g, w = getattr(got, name), getattr(want, name)
        err = (g - w).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        bound = atol + rtol * w.abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"cheap {name}: max err "
                                 f"{float(err.max()):.3g}")

    close("amplitude", rtol=1e-3)
    close("corr_q", atol=1e-6)
    close("corr_l", atol=1e-6)
    for name in ("prev_signal", "std_dev", "dphi", "df_sum"):
        close(name, atol=1e-3)
    close("carry_sum", atol=1e-4 * float(want.carry_sum.abs().max() + 1))
    close("df_buf", atol=df_ring_tolerance(cfg, want, st))
    for name in ("carry_cnt", "sign0", "prev_sign", "ms_time", "locked",
                 "df_cnt", "df_idx", "corr_buf", "corr_cnt", "corr_idx",
                 "locked_seq", "sign0_seq", "edge_valid"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"cheap {name} differs")
    v = want.edge_valid
    for name in ("edge_ms", "edge_local"):
        if not torch.equal(getattr(got, name)[v], getattr(want, name)[v]):
            raise AssertionError(f"cheap {name} differs at valid edges")
    return worst


def cheap_bound(cfg, args, out) -> tuple[float, str]:
    """Bound of one cheap-kernel call.  Bytes: every input tensor (head
    and segment sums, delays, the carried state) read once and every
    output (CheapOut) written once.  Operations, per channel and block:
    the correlation-quality ring sum (corr_hist_len adds) and ~60 per
    means slot (means assembly, retune rotation with a sincos counted
    as 2, arctan, unwrap, amplitude, edge scan)."""
    from gps_sdr_tpu_torch.ops import hopper_cheap

    _, k, head, seg, delay, wipe, st = args
    n_ch = head.shape[0]
    n_bytes = sum(x.numel() * x.element_size()
                  for x in (head, seg, delay, wipe, *out))
    n_bytes += sum(getattr(st, f).numel() * getattr(st, f).element_size()
                   for f in hopper_cheap._STATE)
    n_ops = n_ch * k * (cfg.corr_hist_len + 60 * (cfg.n_cyc + 1))
    return _bound(n_bytes, n_ops)


def cheap_chain_args(cfg, states, chunk, codes, code_ffts):
    """The arguments of cheap_scan at each of CHEAP_STEPS chained K-steps
    (yielded; when the caller resumes, the chain advances by
    tracking.channel_step_k): each step's erased state and heavy result.  Step 2
    starts from a full, wrapped correlation ring and df ring; step 5
    from ms_time = 2^25 + 3."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import tracking

    k = cfg.blocks_per_step
    n_ch = states.prn.shape[0]
    steps_per_chunk = chunk.shape[0] // k
    hist, no_sec = cfg.corr_hist_len, cfg.no_sec
    rng = np.random.default_rng(11)
    dev = chunk.device
    st = states
    for i in range(CHEAP_STEPS):
        if i == 2:
            st = st._replace(
                corr_buf=torch.as_tensor(rng.choice(
                    np.array([-1, 1], np.int8), (n_ch, hist)), device=dev),
                corr_cnt=torch.full_like(st.corr_cnt, hist),
                corr_idx=torch.as_tensor(
                    rng.integers(0, hist, n_ch, dtype=np.int32), device=dev),
                df_cnt=torch.full_like(st.df_cnt, no_sec),
                df_idx=torch.as_tensor(
                    rng.integers(0, no_sec, n_ch, dtype=np.int32),
                    device=dev))
        if i == 5:
            st = st._replace(ms_time=torch.full_like(st.ms_time,
                                                     2 ** 25 + 3),
                             locked=torch.ones_like(st.locked))
        sno = 1 + k * i
        heavy = tracking.heavy_stage(cfg, k, st, chunk, i % steps_per_chunk,
                                     codes, code_ffts)
        _, erased = tracking._erased(st, sno)
        yield (cfg, k, heavy.head_k, heavy.seg_sums_k, heavy.delay_k,
               heavy.wipe_delay, erased)
        st, _ = tracking.channel_step_k(cfg, k, st, heavy, sno)


def check_cheap_chain(cfg, states, chunk, codes, code_ffts,
                      timing: bool = False) -> dict:
    """CHEAP_STEPS chained K-steps (cheap_chain_args); at each, the cheap
    kernel and its plain version take the same erased state and heavy
    result."""
    import torch
    from gps_sdr_tpu_torch.ops import hopper_cheap

    worst, n_edges, ms_checked = 0.0, 0, False
    times = {}
    for i, args in enumerate(cheap_chain_args(cfg, states, chunk, codes,
                                              code_ffts)):
        erased = args[-1]
        got = hopper_cheap.cheap_scan(*args)
        want = hopper_cheap.cheap_scan_plain(*args)
        torch.cuda.synchronize()
        worst = max(worst, _compare_cheap(got, want, cfg, erased))
        n_edges += int(want.edge_valid.sum())
        if i == 5:
            ms_checked = bool((got.ms_time > 2 ** 25 + 3).any())
        if timing and i == 0:
            times["ms"] = time_ms(lambda: hopper_cheap.cheap_scan(*args))
            times["plain_ms"] = time_ms(
                lambda: hopper_cheap.cheap_scan_plain(*args))
            times["bound_ms"], times["bound_by"] = cheap_bound(cfg, args,
                                                               got)
    if not ms_checked:
        raise AssertionError("ms_time > 2^24 case counted no ms")
    return dict(max_abs_err=worst, edges=n_edges, **times)


def design_block(cfg, st, b, want, head, seg, delay, wipe, c_cnt, c_sum):
    """Fill block b of the cheap stage's wipeoff sums head c64[C, K] and
    seg c64[C, K, n_cyc] (CPU) so that its means after the retune
    rotation are `want` c64[C, n_cyc + 1] (by source: 0 = the slot that
    closes at the block's first boundary, j = segment j - 1): the raw
    sums are `want` rotated forward by the angle the plain version
    applies, found by running it on blocks 0 .. b - 1 from state `st`.
    Source 0 is carry + head, and carry + head + segment 0 where the
    boundary crossed the period upward after a carry
    (tracking._means_from_sums); where it crossed downward the carry's
    period keeps what the block before left and source 0 is the head's
    period alone; after a block that ended on a boundary a head under
    half a period is dropped.  c_cnt, c_sum: the partial code period
    carried into block b (numpy); returns the one carried out of it."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import hopper_cheap

    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    if b:
        prior = hopper_cheap.cheap_scan_plain(
            cfg, b, head[:, :b], seg[:, :b], delay[:, :b], wipe[:, :b], st)
        dphi, df_sum = prior.dphi, prior.df_sum
    else:
        dphi = df_sum = torch.zeros(head.shape[0])
    w = wipe[:, b].numpy()
    cnt0 = c_cnt + w
    merged = (c_cnt > 0) & (2 * cnt0 < cs)
    split = 2 * cnt0 > 3 * cs
    used = (cnt0 > 0) & ~((c_cnt == 0) & (2 * w < cs))
    starts = np.concatenate(
        [np.where(split, w - cs, -c_cnt)[:, None],
         w[:, None] + cs * np.arange(n_cyc)], axis=1)
    t_m = (torch.from_numpy(starts.astype(np.float32)) + 0.5 * cs) \
        / cfg.sample_rate
    ang = dphi[:, None] + hopper_cheap.TWO_PI * df_sum[:, None] * t_m
    raw = want * torch.complex(torch.cos(ang), torch.sin(ang))
    seg[:, b] = raw[:, 1:] * cs
    n0 = np.where(merged, cnt0 + cs, np.where(split, w, np.maximum(cnt0, 1)))
    zero = torch.zeros_like(head[:, b])
    rest = torch.where(torch.from_numpy(split), zero, torch.from_numpy(c_sum)) \
        + torch.where(torch.from_numpy(merged), seg[:, b, 0], zero)
    head[:, b] = torch.where(
        torch.from_numpy(used),
        raw[:, 0] * torch.from_numpy(n0.astype(np.float32)) - rest, zero)
    c_sum = np.where(w > 0, seg[:, b, n_cyc - 1].numpy(), 0).astype(
        np.complex64)
    return np.where(w > 0, cs - w, 0), c_sum


def cheap_case(cfg, n_ch, seed, device, wraps: bool = True):
    """A crafted cheap-kernel case made with numpy from `seed`: the
    arguments of cheap_scan (cfg, K, head, seg, delay, wipe, state) on
    `device`, and what the case holds (`facts`).

    The per-ms means are designed after the retune rotation (the raw
    sums are the designed means rotated forward by the angle the plain
    version applies, found by running it on the blocks before): unit
    means with sign flips forced into the last two slots (31 and 32 at
    the product's n_cyc), or, in odd blocks of locked channels, phases
    alternating across +-pi/2 (a PLL unwrap step at every slot); wipe
    delays 0, 1, cs / 2 and cs - 1 in every channel (slot compaction
    when the carry is empty; all n_cyc + 1 slots after a 1 block; the
    period boundary crossed downward, 1 to cs - 1, which splits slot 0
    in two, and upward, cs - 1 to 0, which merges slot 0 into segment
    0; a head of 1 after delay 0, which is dropped);
    channels 0, 3, 6, 9 start unlocked with a 0.2 rad offset that
    vanishes from block 2, so they lock inside the step; full, wrapped
    correlation and df rings; ms_time past 2^24 in even channels.
    wraps=False: the wipe delays 0, 1, cs / 2 and cs - 1 in an order in
    which none crosses the period boundary (nor drops a head), and each
    channel's carry in the block before the step's, the case on which
    the JAX package, which shares fault A, is an oracle."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import tracking

    rng = np.random.default_rng(seed)
    k, cs, n_cyc = cfg.blocks_per_step, cfg.code_samples, cfg.n_cyc
    hist, no_sec, sl = cfg.corr_hist_len, cfg.no_sec, n_cyc + 1
    ch = np.arange(n_ch)
    locked = ch % 3 != 0
    carry_cnt = np.where(ch % 2 == 0, rng.integers(1, cs, n_ch), 0)
    st = tracking.init_channel_states(cfg, n_ch, "cpu")._replace(
        active=torch.ones(n_ch, dtype=torch.bool),
        locked=torch.from_numpy(locked),
        std_dev=torch.full((n_ch,), 0.05),
        sign0=torch.from_numpy(np.where(ch % 4 < 2, rng.choice(
            [-1, 1], n_ch), 0).astype(np.int8)),
        prev_sign=torch.from_numpy(rng.choice([-1, 1], n_ch).astype(
            np.int8)),
        prev_signal=torch.from_numpy(rng.choice([-1.0, 1.0], n_ch).astype(
            np.float32)),
        ms_time=torch.from_numpy(np.where(
            ch % 2 == 0, 2 ** 25 + 3, rng.integers(0, 10 ** 6, n_ch)
        ).astype(np.int32)),
        carry_sum=torch.from_numpy((carry_cnt * np.exp(
            1j * rng.uniform(-0.1, 0.1, n_ch))).astype(np.complex64)),
        carry_cnt=torch.from_numpy(carry_cnt.astype(np.int32)),
        corr_buf=torch.from_numpy(rng.choice([-1, 1], (n_ch, hist)).astype(
            np.int8)),
        corr_cnt=torch.full((n_ch,), hist, dtype=torch.int32),
        corr_idx=torch.from_numpy(rng.integers(0, hist, n_ch).astype(
            np.int32)),
        df_buf=torch.from_numpy((1e-3 * rng.standard_normal(
            (n_ch, no_sec))).astype(np.float32)),
        df_cnt=torch.full((n_ch,), no_sec, dtype=torch.int32),
        df_idx=torch.from_numpy(rng.integers(0, no_sec, n_ch).astype(
            np.int32)))

    seq = np.resize([0, 0, 1, cs - 1, 0, cs // 2, 1, 0] if wraps
                    else [0, 0, cs - 1, cs // 2, 1, 0, cs // 2, 1], k)
    wipe = np.stack([np.roll(seq, c) for c in ch]).astype(np.int32)
    if not wraps:
        before = np.roll(seq, 1)[(-ch) % k]
        carry_cnt = np.where(before > 0, cs - before, 0)
        st = st._replace(
            carry_sum=torch.from_numpy((carry_cnt * np.exp(1j * np.angle(
                st.carry_sum.numpy()))).astype(np.complex64)),
            carry_cnt=torch.from_numpy(carry_cnt.astype(np.int32)))
    delay = np.where(rng.random((n_ch, k)) < 0.3, -1,
                     rng.integers(0, cs, (n_ch, k))).astype(np.int32)
    head = torch.zeros((n_ch, k), dtype=torch.complex64)
    seg = torch.zeros((n_ch, k, n_cyc), dtype=torch.complex64)
    wipe_t, delay_t = torch.from_numpy(wipe), torch.from_numpy(delay)
    c_cnt, c_sum = st.carry_cnt.numpy(), st.carry_sum.numpy()
    n_compact = n_jump_blocks = n_dropped = n_merged = n_split = 0
    for b in range(k):
        # designed means, by source: 0 = carry + head, j = segment j - 1
        jumps = locked & (b % 2 == 1)
        signs = rng.choice([-1.0, 1.0], (n_ch, sl))
        signs[:, n_cyc - 1] = -signs[:, n_cyc - 2]
        signs[:, n_cyc] = -signs[:, n_cyc - 1]
        theta = rng.normal(0.0, 0.02, (n_ch, sl)) + np.where(
            ~locked & (b < 2), 0.2, 0.0)[:, None]
        alt = np.where(np.arange(sl) % 2 == 0, 1.3, np.pi - 1.3)
        theta = np.where(jumps[:, None], alt + 0.02 * theta, theta)
        signs = np.where(jumps[:, None], 1.0, signs)
        amp = 1.0 + 0.02 * rng.standard_normal((n_ch, sl))
        want = torch.from_numpy((amp * signs * np.exp(1j * theta)).astype(
            np.complex64))
        n_jump_blocks += int(jumps.sum())
        cnt0 = c_cnt + wipe[:, b]
        n_compact += int((cnt0 == 0).sum())
        n_dropped += int(((c_cnt == 0) & (0 < cnt0) & (2 * cnt0 < cs)).sum())
        n_merged += int(((c_cnt > 0) & (2 * cnt0 < cs)).sum())
        n_split += int((2 * cnt0 > 3 * cs).sum())
        c_cnt, c_sum = design_block(cfg, st, b, want, head, seg, delay_t,
                                    wipe_t, c_cnt, c_sum)
    st = tracking.ChannelState(*(v.to(device) for v in st))
    facts = dict(compacted_blocks=n_compact, jump_blocks=n_jump_blocks,
                 dropped_blocks=n_dropped, merged_blocks=n_merged,
                 split_blocks=n_split, wraps=wraps,
                 wipes=sorted(set(wipe.ravel().tolist())))
    return ((cfg, k, head.to(device), seg.to(device), delay_t.to(device),
             wipe_t.to(device), st), facts)


def check_cheap_case(cfg, n_ch, seed, device) -> dict:
    """The cheap kernel against its plain version on cheap_case: the
    _compare_cheap tolerances, the state left unchanged, and the case
    reaching what it was made for (edges accepted in the last two slots,
    a channel locking inside the step, compacted blocks, PLL steps)."""
    import torch
    from gps_sdr_tpu_torch.ops import hopper_cheap

    args, facts = cheap_case(cfg, n_ch, seed, device)
    st = args[-1]
    before = [v.clone() for v in st]
    got = hopper_cheap.cheap_scan(*args)
    want = hopper_cheap.cheap_scan_plain(*args)
    torch.cuda.synchronize()
    worst = _compare_cheap(got, want, cfg, st)
    if not all(torch.equal(a, b) for a, b in zip(before, st)):
        raise AssertionError("cheap kernel modified its input state")
    check_cheap_facts(cfg, want, facts)
    return dict(max_abs_err=worst, **facts)


def check_cheap_facts(cfg, out, facts) -> None:
    """What cheap_case must reach, read from the plain version's output
    `out`."""
    sl = cfg.n_cyc + 1
    ev, ls = out.edge_valid.cpu(), out.locked_seq.cpu()
    if not (ev[..., sl - 1].any() and ev[..., sl - 2].any()):
        raise AssertionError("crafted cheap case: no edge in the last two "
                             "slots")
    if not (~ls[:, 0] & ls[:, -1]).any():
        raise AssertionError("crafted cheap case: no channel locked "
                             "inside the step")
    crossings = [facts[name] for name in ("dropped_blocks", "merged_blocks",
                                          "split_blocks")]
    if not (facts["compacted_blocks"] and facts["jump_blocks"]
            and (all(crossings) if facts["wraps"] else not any(crossings))
            and {0, cfg.code_samples - 1} <= set(facts["wipes"])):
        raise AssertionError(f"crafted cheap case: {facts}")


# --------------------------------------------------------------------------
# the stream axis (phase 7a; also used by tests/test_torch_cuda.py)


def stream_case(cfg, n_streams, shared, n_blocks, seed, device,
                dopp_step: float = 0.5, on_card: bool = False):
    """(states, chunk, codes, code_ffts) of n_streams streams of
    cfg.max_sat channels, flattened stream after stream ([S*C, ...]).
    Distinct: stream z's channels and chunk are make_case(seed + z)'s,
    the chunks stacked [S, T, ngps].  Shared: every stream tracks the
    satellites of make_case(seed)'s chunk [T, ngps], as replicas of one
    capture do, stream z with its NCO phase 0.5 z rad and its Doppler
    dopp_step z Hz off (so that a stream reading another's parameters
    would show; at 0.5 Hz every channel stays on its signal, at 3 Hz the
    far streams' channels are led by noise).  on_card: make_case's."""
    import math

    import torch
    from gps_sdr_tpu_torch.ops import tracking

    if shared:
        st, chunk, codes, ffts = make_case(cfg, cfg.max_sat, n_blocks, seed,
                                           device, on_card)
        cases = [(st._replace(
            phase=torch.remainder(st.phase + 0.5 * z, 2.0 * math.pi),
            freq=st.freq + dopp_step * z), chunk, codes, ffts)
            for z in range(n_streams)]
    else:
        cases = [make_case(cfg, cfg.max_sat, n_blocks, seed + z, device,
                           on_card) for z in range(n_streams)]
    states = tracking.ChannelState(*(torch.cat(f) for f in
                                     zip(*[c[0] for c in cases])))
    chunk = cases[0][1] if shared else torch.stack([c[1] for c in cases])
    return (states, chunk, torch.cat([c[2] for c in cases]),
            torch.cat([c[3] for c in cases]))


def _same_bits(a, b) -> bool:
    """Equal bit for bit (floats compared as their integer images)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if a.is_floating_point():
        a = a.contiguous().view(torch.int32)
        b = b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def check_stream_bits(cfg, states, chunk, step, codes, n_streams, shared,
                      vpu: bool = False) -> None:
    """A wipeoff kernel's launch over n_streams streams gives the bits of
    n_streams single-stream launches on the streams' slices."""
    import math

    import torch
    from gps_sdr_tpu_torch.ops import hopper_wipeoff, tracking

    k = cfg.blocks_per_step
    kernel = (hopper_wipeoff.mix_wipeoff_vpu if vpu
              else hopper_wipeoff.mix_wipeoff)
    if vpu:
        chunk = tracking.to_grouped_planar(cfg, chunk)
    s = 2.0 * math.pi * states.freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2.0 * math.pi)
    wipe = tracking.predict_wipe_delays(cfg, k, states.freq, states.delay)
    got = kernel(cfg, k, s, snp, states.phase, wipe, chunk, step, codes,
                 n_streams)
    c = s.shape[0] // n_streams
    for z in range(n_streams):
        ch = slice(z * c, (z + 1) * c)
        one = kernel(cfg, k, s[ch], snp[ch], states.phase[ch], wipe[ch],
                     chunk if shared else chunk[z], step, codes[ch])
        for part, g, w in zip(("center", "head", "seg"),
                              (got[0][:, ch], got[1][ch], got[2][ch]), one):
            if not _same_bits(g, w):
                raise AssertionError(
                    f"{kernel.__name__} stream {z} {part}: the stream-axis "
                    "launch differs from a single-stream launch")
    torch.cuda.synchronize()


def check_cheap_streams(cfg, cases) -> dict:
    """The cheap kernel over the channels of all `cases` (cheap_scan
    argument tuples of one stream each), concatenated: against its plain
    version (_compare_cheap) and bit for bit against one launch a
    case."""
    import torch
    from gps_sdr_tpu_torch.ops import hopper_cheap, tracking

    k = cases[0][1]
    cat = [torch.cat(f) for f in zip(*[c[2:6] for c in cases])]
    st = tracking.ChannelState(*(torch.cat(f) for f in
                                 zip(*[c[6] for c in cases])))
    args = (cfg, k, *cat, st)
    got = hopper_cheap.cheap_scan(*args)
    want = hopper_cheap.cheap_scan_plain(*args)
    torch.cuda.synchronize()
    worst = _compare_cheap(got, want, cfg, st)
    c0 = 0
    for case in cases:
        c = case[2].shape[0]
        one = hopper_cheap.cheap_scan(*case)
        for name, g, w in zip(one._fields, got, one):
            if not _same_bits(g[c0:c0 + c], w):
                raise AssertionError(f"cheap {name}: the {len(cases)}-stream "
                                     "launch differs from a one-stream one")
        c0 += c
    torch.cuda.synchronize()
    return dict(max_abs_err=worst, channels=c0)


def check_stream_axis(cfg, n_streams, shared, seed, dev,
                      dopp_step: float = 0.5) -> dict:
    """The three kernels' stream-axis launches on stream_case (replicas'
    Dopplers dopp_step Hz apart): each against its plain version
    (check_wipeoff, check_cheap_streams) and bit for bit against
    n_streams single-stream launches.  Returns the largest absolute
    errors against the plain versions."""
    from gps_sdr_tpu_torch.ops import tracking

    k = cfg.blocks_per_step
    st, chunk, codes, ffts = stream_case(cfg, n_streams, shared, 2 * k,
                                         seed, dev, dopp_step=dopp_step)
    out = {}
    for name, vpu in (("wipeoff", False), ("wipeoff_vpu", True)):
        out[name] = check_wipeoff(cfg, st, chunk, 1, codes, ffts, vpu=vpu,
                                  n_streams=n_streams)["max_abs_err"]
        check_stream_bits(cfg, st, chunk, 1, codes, n_streams, shared, vpu)
    # the cheap kernel on the stream-axis heavy stage's sums
    heavy = tracking.heavy_stage(cfg, k, st, chunk, 0, codes, ffts,
                                 n_streams=n_streams)
    _, erased = tracking._erased(st, 1)
    c = cfg.max_sat
    cases = []
    for z in range(n_streams):
        ch = slice(z * c, (z + 1) * c)
        cases.append((cfg, k, heavy.head_k[ch], heavy.seg_sums_k[ch],
                      heavy.delay_k[ch], heavy.wipe_delay[ch],
                      tracking.ChannelState(*(x[ch] for x in erased))))
    out["cheap"] = check_cheap_streams(cfg, cases)["max_abs_err"]
    return out


def run_stream_axis(cfg, dev, n_streams: int = 4) -> dict:
    """Phase 7a: each kernel's stream-axis launch at the product shapes,
    shared and distinct chunks, and the cheap kernel on crafted cases of
    n_streams streams; also the stream-axis launch's time at S = 1, 4
    and 8 (shared)."""
    import math

    import torch
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff, tracking

    k = cfg.blocks_per_step
    out = {}
    for shared in (True, False):
        tag = "shared" if shared else "distinct"
        errs = check_stream_axis(cfg, n_streams, shared, 7, dev)
        out[tag] = errs
        log(f"[7a] {n_streams} streams x {cfg.max_sat} channels, {tag} "
            f"chunks: wipeoff, wipeoff_vpu and cheap ({n_streams * cfg.max_sat}"
            f" channels) within tolerance of their plain versions (max abs "
            f"errors {json.dumps(errs)}) and bit-identical to "
            f"{n_streams} single-stream launches")
    # replicas 3 Hz apart: the far streams' channels are pulled tens of
    # Hz, their rotation angles reach tens of radians (df_ring_tolerance)
    errs = check_stream_axis(cfg, 8, True, 7, dev, dopp_step=3.0)
    out["shared_3hz"] = errs
    log(f"[7a] 8 streams x {cfg.max_sat} channels, one chunk, replicas 3 Hz "
        f"apart (noise-led far streams): within tolerance of the plain "
        f"versions (max abs errors {json.dumps(errs)}) and bit-identical "
        f"to single-stream launches")
    cases = [cheap_case(cfg, cfg.max_sat, 3 + z, dev)[0]
             for z in range(n_streams)]
    r = check_cheap_streams(cfg, cases)
    out["cheap_crafted"] = r["max_abs_err"]
    log(f"[7a] cheap, crafted cases of {n_streams} streams: max abs err "
        f"{r['max_abs_err']:.3g}, bit-identical to single-stream launches")
    # stream-axis launch times (wrapper medians, CUDA events)
    times = {}
    for n in (1, 4, 8):
        st, chunk, codes, _ = stream_case(cfg, n, True, k, 7, dev)
        s = 2.0 * math.pi * st.freq / cfg.sample_rate
        snp = torch.remainder(s * cfg.ngps, 2.0 * math.pi)
        wipe = tracking.predict_wipe_delays(cfg, k, st.freq, st.delay)
        planar = tracking.to_grouped_planar(cfg, chunk)
        times[f"wipeoff_S{n}_ms"] = time_ms(lambda: hopper_wipeoff.mix_wipeoff(
            cfg, k, s, snp, st.phase, wipe, chunk, 0, codes, n))
        times[f"wipeoff_vpu_S{n}_ms"] = time_ms(
            lambda: hopper_wipeoff.mix_wipeoff_vpu(
                cfg, k, s, snp, st.phase, wipe, planar, 0, codes, n))
        _, head, seg = hopper_wipeoff.mix_wipeoff(
            cfg, k, s, snp, st.phase, wipe, chunk, 0, codes, n)
        times[f"cheap_S{n}_ms"] = time_ms(lambda: hopper_cheap.cheap_scan(
            cfg, k, head, seg, wipe, wipe, st))
    log(f"[7a] stream-axis wrapper medians (ms, shared chunk): "
        f"{json.dumps(times)}")
    out.update(times)
    return out


# --------------------------------------------------------------------------
# the slice


def _launch_counters():
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff
    return {"wipeoff": hopper_wipeoff.mix_wipeoff,
            "wipeoff_vpu": hopper_wipeoff.mix_wipeoff_vpu,
            "cheap": hopper_cheap.cheap_scan}


def _reset_launches() -> None:
    for fn in _launch_counters().values():
        fn.launches = 0


def _read_launches() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def _check_fix(tag: str, scn, rx, summary) -> float:
    """The slice's checks against the scenario's truth; returns the mean
    fix error in m."""
    import numpy as np

    found = sorted(f[1] for f in rx.found_sats)
    truth = sorted(s.prn for s in scn.sats)
    ephs = sorted(summary["ephemerides"])
    stat = summary["stat"]
    err = (float(np.linalg.norm(stat[0] - scn.rec_ecef))
           if stat is not None else float("nan"))
    log(f"[{tag}] acquired PRNs {found}; ephemerides {ephs}; "
        f"fixes {summary['n_positions']} (failures "
        f"{summary['n_fix_failures']}, outliers {summary['n_outliers']})")
    if found != truth:
        raise AssertionError(f"acquired PRNs {found} != scenario {truth}")
    if len(ephs) < 4:
        raise AssertionError(f"only {len(ephs)} ephemerides decoded")
    if not err < 8.0:                       # also false for NaN / no fix
        raise AssertionError(f"mean fix {err:.2f} m from truth (> 8 m)")
    return err


def run_slice(cfg) -> dict:
    """Phase 4: host-synthesized IQ through Session.run_source."""
    import torch
    from gps_sdr_tpu_torch.kernel_profile import synth_iq
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.runtime.session import Session

    scn = make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                        duration_sec=SLICE_SEC + 12.0)
    n_blocks = int(round(SLICE_SEC / cfg.block_sec))
    t0 = time.perf_counter()
    blocks = synth_iq(scn, n_blocks, 4 * cfg.no_sec)
    log(f"[4] synthesized {n_blocks} blocks ({SLICE_SEC:.0f} s) in "
        f"{time.perf_counter() - t0:.1f} s")

    session = Session(cfg, device="cuda")
    _reset_launches()
    t0 = time.perf_counter()
    summary = session.run_source(iter(blocks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()

    rx = session.receiver
    t, k = cfg.no_sec, cfg.blocks_per_step
    tracked = n_blocks - 1                          # block 0: cold sweep
    want_steps = (tracked // t) * (t // k) + (tracked % t) // k
    err = _check_fix("4", scn, rx, summary)
    log(f"[4] mean fix error vs truth {err:.3f} m; wall {wall:.3f} s for "
        f"{SLICE_SEC:.0f} s of IQ = {SLICE_SEC / wall:.2f}x realtime; "
        f"K-steps {want_steps}, launches {launches}")
    if not (launches["wipeoff"] == launches["cheap"] == want_steps
            == rx.status.k_steps and launches["wipeoff_vpu"] == 0):
        raise AssertionError(f"kernel launches {launches} != K-steps "
                             f"{want_steps} (receiver {rx.status.k_steps}) "
                             "or wipeoff_vpu launched")
    return dict(launches=launches, err_m=err, wall_s=wall,
                rtf=SLICE_SEC / wall, fixes=summary["n_positions"],
                ephemerides=sorted(summary["ephemerides"]),
                mean=summary["stat"][0], scn=scn, blocks=blocks)


def run_device_slice(base_cfg) -> dict:
    """Phase 6: the scenario synthesized on the card, through
    Session.run_device_source at use_mxu_wipeoff=False."""
    import torch
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.runtime.session import Session

    cfg = base_cfg.replace(use_mxu_wipeoff=False)
    scn = make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                        duration_sec=SLICE_SEC + 12.0)
    synth = DeviceScenarioSynth(scn, noise_std=NOISE, knot_interp_step=0.1,
                                device="cuda")
    t = cfg.no_sec
    n_chunks = int(round(SLICE_SEC / cfg.block_sec)) // t
    sig_sec = n_chunks * t * cfg.block_sec
    synth_sec = 0.0

    def provider(first, n):
        nonlocal synth_sec
        t0 = time.perf_counter()
        out = synth.chunk_planar(first, n)
        synth_sec += time.perf_counter() - t0
        return out

    session = Session(cfg, device="cuda")
    _reset_launches()
    t0 = time.perf_counter()
    summary = session.run_device_source(provider, n_chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()

    rx = session.receiver
    want_steps = n_chunks * (t // cfg.blocks_per_step)
    err = _check_fix("6", scn, rx, summary)
    log(f"[6] mean fix error vs truth {err:.3f} m; synthesis {synth_sec:.3f}"
        f" s (host time in chunk_planar calls, device work overlapped); "
        f"wall {wall:.3f} s for {sig_sec:.2f} s of IQ = "
        f"{sig_sec / wall:.2f}x realtime; K-steps {want_steps}, launches "
        f"{launches}, edge overflows {rx.status.edge_overflows}")
    if not (launches["wipeoff_vpu"] == launches["cheap"] == want_steps
            == rx.status.k_steps and launches["wipeoff"] == 0):
        raise AssertionError(f"kernel launches {launches} != K-steps "
                             f"{want_steps} (receiver {rx.status.k_steps}) "
                             "or wipeoff launched")
    if rx.status.edge_overflows:
        raise AssertionError(f"{rx.status.edge_overflows} bit edges "
                             "dropped by the compact transport")
    return dict(launches=launches, err_m=err, wall_s=wall,
                synth_s=synth_sec, rtf=sig_sec / wall,
                fixes=summary["n_positions"])


SERVE_SKIP = {"AMP", "CN0", "CRM", "FRQ", "SWP", "EPH"}


def _stream_record(epochs) -> tuple[set, dict]:
    """(the decoded subframes as a set of their nav fields, code phases
    keyed by (PRN, block)) of one stream's epochs: what does not depend
    on how the chunks fall into download windows."""
    from gps_sdr_tpu_torch.utils.cplist import cp_arrays

    frames, coph = set(), {}
    for e in epochs:
        frames |= {tuple(sorted((k, v) for k, v in f.items()
                                if k not in SERVE_SKIP
                                and isinstance(v, (int, float, str, bool))))
                   for f in e.frames if "ID" in f}
        for prn, lst in e.code_phases.items():
            snos, cps = cp_arrays(lst)
            coph.update({(prn, int(n)): float(c) for n, c in zip(snos, cps)})
    return frames, coph


def _ev_summary(ev) -> dict:
    """The parts of Session.final_summary that _check_fix reads."""
    return {"n_positions": len(ev.positions), "stat": ev.stat,
            "n_outliers": len(ev.outliers),
            "n_fix_failures": len(ev.fix_failures),
            "ephemerides": {sat: eng.ephem for sat, eng in ev.engines.items()
                            if eng.ephem_ok}}


def serve(cfg, n_streams, providers, n_chunks, keep_epochs=(), mesh=None,
          server=None):
    """Drive a StreamServer on the card as `python -m gps_sdr_tpu_torch
    serve` does (process_many over each round of streams), a new one
    (over `mesh` if given) or `server` = (StreamServer, evaluators);
    returns (server, evaluators, wall s, {stream: epochs} for
    keep_epochs, acquisition grids run)."""
    import torch
    from gps_sdr_tpu_torch.runtime import receiver as receiver_mod
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator, process_many
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    if server is None:
        srv = StreamServer(cfg, n_streams, device="cuda", mesh=mesh)
        evs = [Evaluator(cfg) for _ in range(n_streams)]
    else:
        srv, evs = server
    kept = {s: [] for s in keep_epochs}
    grids = []
    real = receiver_mod.acquire_all

    def counting(*a, **kw):
        grids.append(kw.get("prns"))
        return real(*a, **kw)

    receiver_mod.acquire_all = counting
    try:
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pend = []
        for s, epoch in srv.run(providers, n_chunks):
            pend.append((evs[s], epoch))
            if s in kept:
                kept[s].append(epoch)
            if len(pend) == n_streams:
                process_many(pend)
                pend = []
        if pend:
            process_many(pend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        receiver_mod.acquire_all = real
    return srv, evs, wall, kept, len(grids)


def _check_streams(tag, scns, srv, evs, launches, wall, sig_sec, name,
                   groups: int = 1):
    """Phase 7b/7c/11c checks common to all: every stream's PRNs,
    ephemerides and fix (_check_fix), no dropped edge, and one launch of
    `name` and of cheap per K-step of one stream and group of streams
    (a stream mesh's device; one without a mesh)."""
    errs = []
    for s, (scn, rx, ev) in enumerate(zip(scns, srv.receivers, evs)):
        errs.append(_check_fix(f"{tag} stream {s}", scn, rx, _ev_summary(ev)))
        if rx.status.edge_overflows:
            raise AssertionError(f"stream {s}: {rx.status.edge_overflows} "
                                 "bit edges dropped by the transport")
    k_steps = srv.receivers[0].status.k_steps
    other = "wipeoff_vpu" if name == "wipeoff" else "wipeoff"
    per_step = {n: v / max(k_steps, 1) for n, v in launches.items()}
    log(f"[{tag}] {srv.n_streams} streams: mean fix errors "
        f"{[round(e, 3) for e in errs]} m; wall {wall:.3f} s for "
        f"{srv.n_streams} x {sig_sec:.2f} s = "
        f"{srv.n_streams * sig_sec / wall:.2f}x aggregate realtime; stages "
        f"{json.dumps({k: round(v, 4) for k, v in srv.perf.items()})}; "
        f"K-steps of a stream {k_steps}, launches {launches}, per K-step "
        f"{per_step}")
    if not (launches[name] == launches["cheap"] == k_steps * groups
            and launches[other] == 0 and k_steps > 0):
        raise AssertionError(f"launches {launches}: want one {name} and one "
                             f"cheap launch per K-step of one stream "
                             f"({k_steps}) and group ({groups}) and no "
                             f"{other}")
    return errs


def run_serving_slice(base_cfg, n_streams: int = 8) -> dict:
    """Phase 7b: n_streams replicas of phase 6's scenario, synthesized on
    the card, through StreamServer with the CLI's serve settings."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    cfg = base_cfg.replace(chunks_per_download=16,
                           download_windows_in_flight=4,
                           epoch_per_window=True)
    scn = make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                        duration_sec=SLICE_SEC + 12.0)
    synth = DeviceScenarioSynth(scn, noise_std=NOISE, knot_interp_step=0.1,
                                device="cuda")
    t = cfg.no_sec
    n_chunks = int(round(SLICE_SEC / cfg.block_sec)) // t
    sig_sec = n_chunks * t * cfg.block_sec
    srv, evs, wall, kept, grids = serve(cfg, n_streams, synth.chunk_planar,
                                        n_chunks,
                                        keep_epochs=range(n_streams))
    launches = _read_launches()
    errs = _check_streams("7b", [scn] * n_streams, srv, evs, launches, wall,
                          sig_sec, "wipeoff")
    if grids != 1:
        raise AssertionError(f"{grids} acquisition grids for {n_streams} "
                             "replicas of one capture (want 1)")
    # stream 0 against a single receiver on the same synthesis
    rx = Receiver(cfg, device="cuda")
    ref = list(rx.run_device(synth.chunk_planar, n_chunks))
    fr_s, cp_s = _stream_record(kept[0])
    fr_r, cp_r = _stream_record(ref)
    if fr_s != fr_r or not fr_s:
        raise AssertionError(f"stream 0 decoded {len(fr_s)} subframes, a "
                             f"single receiver {len(fr_r)}; "
                             f"{len(fr_s ^ fr_r)} differ")
    if cp_s.keys() != cp_r.keys():
        raise AssertionError(f"stream 0 has code phases at "
                             f"{len(cp_s.keys() - cp_r.keys())} (PRN, block)s "
                             f"a single receiver has not, and misses "
                             f"{len(cp_r.keys() - cp_s.keys())}")
    cp_err = max(abs(cp_s[key] - cp_r[key]) for key in cp_r)
    if not cp_err <= 5e-3:
        raise AssertionError(f"stream 0 code phases differ from a single "
                             f"receiver's by up to {cp_err:.3g} samples")
    log(f"[7b] stream 0 vs a single Receiver.run_device: {len(fr_s)} "
        f"subframes identical, {len(cp_s)} code phases within "
        f"{cp_err:.3g} samples; acquisition grids run: {grids}")
    return dict(launches=launches, err_m=errs, wall_s=wall,
                rtf=n_streams * sig_sec / wall, perf=dict(srv.perf),
                cp_err_vs_single=cp_err, subframes=len(fr_s), epochs=kept)


def run_independent_slice(base_cfg, seeds=(3, 5, 7)) -> dict:
    """Phase 7c: one scenario a stream (independent front ends), kernel
    2 on the stacked windows."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth

    cfg = base_cfg.replace(use_mxu_wipeoff=False, chunks_per_download=8,
                           download_windows_in_flight=4,
                           epoch_per_window=True)
    scns = [make_scenario(cfg, n_sats=N_SATS, seed=sd,
                          duration_sec=SLICE_SEC + 12.0) for sd in seeds]
    synths = [DeviceScenarioSynth(sc, noise_std=NOISE, knot_interp_step=0.1,
                                  device="cuda") for sc in scns]
    t = cfg.no_sec
    n_chunks = int(round(SLICE_SEC / cfg.block_sec)) // t
    sig_sec = n_chunks * t * cfg.block_sec
    srv, evs, wall, kept, grids = serve(cfg, len(seeds),
                                        [sy.chunk_planar for sy in synths],
                                        n_chunks,
                                        keep_epochs=range(len(seeds)))
    launches = _read_launches()
    errs = _check_streams("7c", scns, srv, evs, launches, wall, sig_sec,
                          "wipeoff_vpu")
    prns = [sorted(f[1] for f in rx.found_sats) for rx in srv.receivers]
    if len({tuple(p) for p in prns}) < 2:
        raise AssertionError(f"independent streams acquired the same PRNs "
                             f"{prns}")
    log(f"[7c] PRNs by stream {prns}; acquisition grids run: {grids}")
    return dict(launches=launches, err_m=errs, wall_s=wall,
                rtf=len(seeds) * sig_sec / wall, perf=dict(srv.perf),
                epochs=kept)


# --------------------------------------------------------------------------
# the front-end slice (phase 8; the checks of 8a also used by
# tests/test_torch_cuda.py)


def check_decimation(factor: int, real_if: bool, dev, n_out: int = 65536,
                     seed: int = 0) -> dict:
    """The front end's conv1d decimation on the card against a float64
    numpy reference, on one raw chunk (n_out output samples): complex IQ,
    or with real_if a real-IF chunk mixed to baseband by the front end's
    DDC on the card first (the reference then filters the same mixed f32
    samples; the mix's f32 angle is the DDC's, not the FIR's).  Tolerance
    atol 2e-6 (tests/test_frontend.py), with TF32 off; and against the
    plain version, the same conv1d on the CPU, within 4e-6 (each within
    2e-6 of float64)."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import frontend

    rng = np.random.default_rng(seed)
    taps = frontend.decimation_taps(factor)
    n = factor * n_out
    if real_if:
        x = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                            device=dev)
        planar = frontend.mix_real_to_baseband(x, 0.2734375, 0.125)
    else:
        planar = torch.as_tensor(rng.standard_normal((2, n)).astype(
            np.float32), device=dev)
    buf = torch.cat([torch.zeros((2, len(taps) - 1), device=dev), planar],
                    dim=1)
    t_dev = torch.as_tensor(taps, device=dev)
    got = frontend.fir_decimate(buf, t_dev, factor)
    torch.cuda.synchronize()
    p = buf.cpu().numpy().astype(np.float64)
    ref = np.stack([np.convolve(p[i], taps.astype(np.float64),
                                mode="valid")[::factor] for i in range(2)])
    err = float(np.abs(got.cpu().numpy() - ref).max())
    cpu = frontend.fir_decimate(buf.cpu(), torch.as_tensor(taps), factor)
    err_cpu = float((got.cpu() - cpu).abs().max())
    if not (err <= 2e-6 and err_cpu <= 4e-6):
        raise AssertionError(f"decimation x{factor} "
                             f"{'real-IF' if real_if else 'complex'}: max "
                             f"err {err:.3g} against float64 (2e-6), "
                             f"{err_cpu:.3g} against the CPU (4e-6)")
    ms = time_ms(lambda: frontend.fir_decimate(buf, t_dev, factor))
    return dict(max_abs_err=err, max_abs_err_cpu=err_cpu, ms=ms, n_in=n)


def check_excision(cfg, blocks, dev) -> dict:
    """excise_cw_chunk on the card against its CPU version on host
    complex64 blocks [T, ngps] (tests/test_torch_frontend.py's rule): the
    same bins nulled except bins within 1e-5 relative of the threshold
    (at most 2 a block), outputs within 1e-4 plus the differing bins'
    share |X_k|/n."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import frontend

    x = torch.from_numpy(blocks)
    got = frontend.excise_cw_chunk(cfg, x.to(dev))
    want = frontend.excise_cw_chunk(cfg, x)
    spec_d, spec_h = torch.fft.fft(x.to(dev)), torch.fft.fft(x)
    thr_d = cfg.cw_excision * spec_d.abs().mean(dim=-1, keepdim=True)
    thr_h = cfg.cw_excision * spec_h.abs().mean(dim=-1, keepdim=True)
    keep_d = (spec_d.abs() <= thr_d).cpu()
    keep_h = spec_h.abs() <= thr_h
    n = blocks.shape[-1]
    worst, nulled, differ_max = 0.0, 0, 0
    for b in range(blocks.shape[0]):
        differ = torch.nonzero(keep_d[b] != keep_h[b])[:, 0]
        mag, thr = spec_h[b].abs(), float(thr_h[b])
        if len(differ) > 2 or not bool(
                ((mag[differ] - thr).abs() <= 1e-5 * thr).all()):
            raise AssertionError(f"excision block {b}: {len(differ)} bins "
                                 "nulled on one device only")
        err = float((got[b].cpu() - want[b]).abs().max())
        if not err <= 1e-4 + float(mag[differ].sum()) / n:
            raise AssertionError(f"excision block {b}: max err {err:.3g}")
        worst = max(worst, err)
        nulled += int((~keep_h[b]).sum())
        differ_max = max(differ_max, len(differ))
    chunk = x.to(dev)
    ms = time_ms(lambda: frontend.excise_cw_chunk(cfg, chunk))
    return dict(max_abs_err=worst, bins_nulled=nulled,
                bins_differing_max=differ_max, ms=ms,
                blocks=int(blocks.shape[0]))


def jammed_blocks(cfg, n_blocks: int, seed: int):
    """Host complex64 [n_blocks, ngps]: make_case's satellites plus
    tests/test_multipath.py's 1500 Hz, amplitude-100 tone."""
    import numpy as np
    from gps_sdr_tpu_torch.models.simulator import synth_stream

    sats = _channels(cfg, 4, seed)
    x = synth_stream(cfg, sats, n_blocks, noise_std=0.5, seed=seed)
    t = np.arange(n_blocks * cfg.ngps) / cfg.sample_rate
    tone = (100.0 * np.exp(2j * np.pi * 1500.0 * t)).astype(np.complex64)
    return x + tone.reshape(n_blocks, cfg.ngps)


def run_frontend_checks(cfg, dev) -> dict:
    """Phase 8a: the front end's conv1d and excision on the card against
    their plain references, and their device ms for one raw chunk."""
    out = {}
    for factor in (4, 8):
        for real_if in (False, True):
            tag = f"fir_x{factor}_{'real' if real_if else 'complex'}"
            out[tag] = check_decimation(factor, real_if, dev)
    out["excision"] = check_excision(cfg.replace(cw_excision=12.0),
                                     jammed_blocks(cfg, cfg.no_sec, 5), dev)
    log(f"[8a] front end on the card: {json.dumps(out)}")
    return out


def run_frontend_slice(cfg, dev="cuda", sec: float = SLICE_SEC,
                       cap_blocks: int = 94) -> dict:
    """Phase 8b: the scenario synthesized at 8.192 MS/s on the card,
    downloaded a chunk at a time, decimated by frontend_blocks (factor
    4), then Session.run_source at ReceiverConfig(); then `replay
    --input-rate` through cli.main on an iq8 capture of its first blocks."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from gps_sdr_tpu_torch import cli
    from gps_sdr_tpu_torch.kernel_profile import (HI_FACTOR,
                                                  decimated_blocks,
                                                  hi_rate_synth)
    from gps_sdr_tpu_torch.ops.frontend import Frontend
    from gps_sdr_tpu_torch.runtime import sources
    from gps_sdr_tpu_torch.runtime.session import Session

    scn, synth = hi_rate_synth(cfg, dev, sec)
    n_blocks = int(round(sec / cfg.block_sec))
    timer = {}
    session = Session(cfg, device=dev)
    _reset_launches()
    t0 = time.perf_counter()
    summary = session.run_source(decimated_blocks(synth, cfg, n_blocks,
                                                  dev, timer=timer))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    rx = session.receiver
    t, k = cfg.no_sec, cfg.blocks_per_step
    tracked = n_blocks - 1                          # block 0: cold sweep
    want_steps = (tracked // t) * (t // k) + (tracked % t) // k
    err = _check_fix("8b", scn, rx, summary)
    log(f"[8b] decimated x{HI_FACTOR} replay: mean fix error vs truth "
        f"{err:.3f} m, fixes {summary['n_positions']}; wall {wall:.3f} s "
        f"for {sec:.0f} s of IQ = {sec / wall:.2f}x realtime "
        f"(of it {timer['synth_s']:.3f} s synthesis at 8.192 MS/s and "
        f"download); K-steps {want_steps}, launches {launches}")
    if not (launches["wipeoff"] == launches["cheap"] == want_steps
            == rx.status.k_steps and launches["wipeoff_vpu"] == 0):
        raise AssertionError(f"kernel launches {launches} != K-steps "
                             f"{want_steps} (receiver {rx.status.k_steps})")

    # the product path: a short iq8 capture of the same synthesis through
    # `python -m gps_sdr_tpu_torch replay --input-rate`
    scale = 0.1         # the synthesis peaks near 7.3: no clipping
    raw = synth.chunk(0, cap_blocks).reshape(-1).cpu().numpy() * scale
    peak = float(max(np.abs(raw.real).max(), np.abs(raw.imag).max()))
    if not peak < 1.0:
        raise AssertionError(f"capture scale {scale} clips ({peak:.3f})")
    seen, real_rd = [], sources.replay_decimated

    def teeing(*a, **kw):
        for i, b in enumerate(real_rd(*a, **kw)):
            if i < 3:
                seen.append(b)
            yield b

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hi.bin")
        sources.pack_iq(raw).tofile(path)
        words = np.fromfile(path, np.uint16)
        sources.replay_decimated = teeing
        buf = io.StringIO()
        try:
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["replay", path, "--input-rate",
                               str(HI_FACTOR * cfg.sample_rate), "--ui",
                               "none", "--device", str(dev)])
            cli_wall = time.perf_counter() - t1
        finally:
            sources.replay_decimated = real_rd
    # the in-memory path: the same words through a Frontend in the same
    # raw chunks replay_decimated reads
    fe = Frontend(HI_FACTOR, device=dev)
    step = HI_FACTOR * cfg.ngps
    mem = np.concatenate([fe.feed(sources.unpack_iq(words[i:i + step]))
                          for i in range(0, 4 * step, step)])
    same = len(seen) == 3 and all(
        np.array_equal(b, mem[i * cfg.ngps:(i + 1) * cfg.ngps])
        for i, b in enumerate(seen))
    log(f"[8b] cli replay --input-rate {HI_FACTOR * cfg.sample_rate:.0f} on "
        f"a {cap_blocks}-block iq8 capture (pack scale {scale}, peak "
        f"{peak:.3f}): rc {rc} in {cli_wall:.2f} s; first 3 blocks equal "
        f"to the in-memory path: {same}; {buf.getvalue().strip()[-200:]!r}")
    if rc != 0 or not same:
        raise AssertionError("cli replay --input-rate failed or its blocks "
                             "differ from the in-memory front end's")
    return dict(launches=launches, err_m=err, wall_s=wall,
                rtf=sec / wall, synth_s=timer["synth_s"],
                fixes=summary["n_positions"], cli_wall_s=cli_wall)


def run_cw_slice(cfg, dev="cuda", sec: float | None = None) -> dict:
    """Phase 8c: tests/test_multipath.py's CW scenario synthesized on the
    card, through Session.run_device_source with cw_excision=12 at
    use_mxu_wipeoff=False; then once more without excision (logged)."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.kernel_profile import (CW_NOISE, CW_SEC,
                                                  cw_scenario, doppler_errors)
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.runtime.session import Session

    sec = CW_SEC if sec is None else sec
    out = {}
    for thr in (12.0, 0.0):
        c = cfg.replace(cw_excision=thr, use_mxu_wipeoff=False)
        scn = cw_scenario(c, sec)
        synth = DeviceScenarioSynth(scn, noise_std=CW_NOISE,
                                    knot_interp_step=0.1, device=dev)
        t = c.no_sec
        n_chunks = int(round(sec / c.block_sec)) // t
        sig = n_chunks * t * c.block_sec
        session = Session(c, device=dev)
        _reset_launches()
        t0 = time.perf_counter()
        summary = session.run_device_source(synth.chunk_planar, n_chunks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        rx = session.receiver
        stat = summary["stat"]
        err = (float(np.linalg.norm(stat[0] - scn.rec_ecef))
               if stat is not None else float("nan"))
        dop = doppler_errors(scn, rx, sig - 1.0)
        good = sorted(p for p, e in dop.items() if abs(e) < 10.0)
        tag = "excision" if thr else "no_excision"
        out[tag] = dict(fixes=summary["n_positions"], err_m=err, wall_s=wall,
                        rtf=sig / wall, launches=launches,
                        doppler_err_hz={p: round(e, 3)
                                        for p, e in dop.items()},
                        locked_on_doppler=good)
        log(f"[8c] {tag} (cw_excision={thr}): {summary['n_positions']} "
            f"fixes, mean fix error {err:.3f} m; wall {wall:.3f} s for "
            f"{sig:.2f} s = {sig / wall:.2f}x realtime; locked channels' "
            f"Doppler error {json.dumps(out[tag]['doppler_err_hz'])} Hz; "
            f"launches {launches}")
        if not thr:
            continue
        want_steps = n_chunks * (t // c.blocks_per_step)
        if not (summary["n_positions"] >= 200 and err < 60.0
                and len(good) >= 5):
            raise AssertionError(f"CW slice with excision: "
                                 f"{summary['n_positions']} fixes, {err:.2f}"
                                 f" m, {len(good)} channels within 10 Hz")
        if not (launches["wipeoff_vpu"] == launches["cheap"] == want_steps
                == rx.status.k_steps and launches["wipeoff"] == 0):
            raise AssertionError(f"kernel launches {launches} != K-steps "
                                 f"{want_steps}")
    out["launches"] = out["excision"]["launches"]
    return out


def run_snapshot_phase(cfg, dev) -> dict:
    """Phase 8d: snapshot_fix on the card on block 8 of make_scenario(
    n_sats=7, seed=11) with a 47 km prior and a tow 20 s off; then the
    `snapshot` CLI on a one-block iq8 file of it."""
    import contextlib
    import io
    import re
    import tempfile

    import numpy as np
    from gps_sdr_tpu_torch import cli
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.ops import cacode
    from gps_sdr_tpu_torch.ops.snapshot import snapshot_fix
    from gps_sdr_tpu_torch.runtime.sources import pack_iq
    from gps_sdr_tpu_torch.utils.io import save_ephemerides

    scn = make_scenario(cfg, n_sats=7, duration_sec=4.0, seed=11)
    block = DeviceScenarioSynth(scn, noise_std=0.6, seed=7,
                                device=dev).chunk(8, 1)[0]
    t_rx = scn.t_rx0 + 8 * cfg.ngps / cfg.sample_rate
    ephs = {s.prn: s.eph for s in scn.sats}
    prior = scn.rec_ecef + np.array([30e3, -30e3, 20e3])
    t0 = time.perf_counter()
    res = snapshot_fix(cfg, block, cacode.ca_fft_table(cfg), ephs,
                       t_rx - 20.0, prior, device=dev)
    fix_s = time.perf_counter() - t0
    if res is None:
        raise AssertionError("snapshot: no fix")
    err = float(np.linalg.norm(res.rec_pos - scn.rec_ecef))
    dt = abs(res.t_gps - t_rx)
    log(f"[8d] snapshot_fix on the card: n_sat {res.n_sat}, error {err:.3f}"
        f" m, |t_gps - t_rx| {dt:.2e} s, residual {res.residual_m:.2f} m, "
        f"{fix_s:.3f} s")
    if not (res.n_sat >= 5 and err < 50.0 and dt < 0.01):
        raise AssertionError("snapshot fix outside its bars")
    lat, lon, h = scn.rec_geo
    with tempfile.TemporaryDirectory() as d:
        cap, eph = os.path.join(d, "cap.bin"), os.path.join(d, "eph.json")
        pack_iq(block.cpu().numpy()).tofile(cap)
        save_ephemerides(eph, ephs)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["snapshot", cap, "--ephem-cache", eph,
                           "--prior-geo", f"{lat + 0.3},{lon - 0.3},{h}",
                           "--tow", str(t_rx - 20.0), "--device",
                           str(dev)])
    text = buf.getvalue()
    m = re.search(r"snapshot fix: ([-\d.]+) deg, ([-\d.]+) deg", text)
    dlat = abs(float(m.group(1)) - lat) if m else float("nan")
    dlon = abs(float(m.group(2)) - lon) if m else float("nan")
    log(f"[8d] cli snapshot: rc {rc}; |dlat| {dlat:.2e}, |dlon| {dlon:.2e} "
        f"deg; {text.strip().splitlines()[0] if text.strip() else ''!r}")
    if not (rc == 0 and dlat < 0.002 and dlon < 0.003):
        raise AssertionError("cli snapshot outside its bars")
    return dict(err_m=err, n_sat=res.n_sat, dt_s=dt, fix_s=fix_s,
                cli_dlat=dlat, cli_dlon=dlon)


def run_device_synth(cfg, dev) -> dict:
    """Phase 8e: DeviceSynth on the card against its CPU version, noise
    off, 11 satellites, one 32-block chunk.  The same f32 operations,
    but the card may fuse a multiply-add the CPU rounds twice: one
    spacing of the code position (< cs) moves the interpolated chip by
    twice that at a chip edge, one spacing of the carrier angle moves
    the phase by that; the bound is their sum times the satellites'
    summed amplitude, plus 1e-5 for cos/sin ulps."""
    import numpy as np
    from gps_sdr_tpu_torch.models.sim_dev import DeviceSynth

    sats = _channels(cfg, 11, 9)
    card = DeviceSynth(cfg, sats, noise_std=0.0, device=dev)
    host = DeviceSynth(cfg, sats, noise_std=0.0, device="cpu")
    got = card.chunk_planar(100, 32)
    want = host.chunk_planar(100, 32)
    err = float((got.cpu() - want).abs().max())
    ang = max(abs(s.doppler) for s in sats) * 2 * np.pi / cfg.sample_rate \
        * cfg.ngps + 2 * np.pi
    tol = sum(s.amplitude for s in sats) * float(
        2 * np.spacing(np.float32(cfg.code_samples))
        + np.spacing(np.float32(ang))) + 1e-5
    ms = time_ms(lambda: card.chunk_planar(100, 32), reps=5)
    noisy = DeviceSynth(cfg, sats, noise_std=0.7, device=dev)
    ms_noise = time_ms(lambda: noisy.chunk_planar(100, 32), reps=5)
    log(f"[8e] DeviceSynth card vs CPU, {len(sats)} satellites, 32 "
        f"blocks: max abs err {err:.3g} (bound {tol:.3g}); {ms:.3f} ms a "
        f"chunk ({ms_noise:.3f} with noise)")
    if not err <= tol:
        raise AssertionError(f"DeviceSynth: card vs CPU max err {err:.3g} "
                             f"> {tol:.3g}")
    return dict(max_abs_err=err, tol=tol, ms=ms, ms_noise=ms_noise)


# --------------------------------------------------------------------------
# the wideband slice (phase 9; the checks of 9a and 9b also used by
# tests/test_torch_cuda.py)


def check_repeat_bits(cfg, states, chunk, step, codes, vpu: bool,
                      wipe=None, n_calls: int = 3) -> None:
    """A wipeoff kernel called again on the same inputs gives the same
    bits: its column groups, tiles and cluster ranks are added in a fixed
    order, with no float atomics."""
    import math

    import torch
    from gps_sdr_tpu_torch.ops import hopper_wipeoff, tracking

    k = cfg.blocks_per_step
    kernel = (hopper_wipeoff.mix_wipeoff_vpu if vpu
              else hopper_wipeoff.mix_wipeoff)
    if vpu:
        chunk = tracking.to_grouped_planar(cfg, chunk)
    s = 2.0 * math.pi * states.freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2.0 * math.pi)
    if wipe is None:
        wipe = tracking.predict_wipe_delays(cfg, k, states.freq,
                                            states.delay)
    args = (cfg, k, s, snp, states.phase, wipe.to(chunk.device), chunk,
            step, codes)
    first = kernel(*args)
    for _ in range(n_calls):
        again = kernel(*args)
        for part, a, b in zip(("center", "head", "seg"), first, again):
            if not _same_bits(a, b):
                raise AssertionError(f"{kernel.__name__} {part}: a repeated "
                                     "launch gave other bits")
    torch.cuda.synchronize()


def run_wideband_kernels(dev) -> dict:
    """Phase 9a: both wipeoff kernels past one cluster of column tiles,
    at cs 4096, 8192 and 16384 with n_cyc 8, corr_avg 4, K=8: 8 and 11
    channels with the predicted and the crafted wipe delays, 32 channels
    (two channel groups) at cs 16384, each against its plain version with
    phase 2's tolerances; repeated launches and a 2-stream launch (shared
    and distinct chunks) bit for bit.  Returns the errors and, at cs
    16384, the wrapper times and bounds of 8 and 11 channels."""
    from gps_sdr_tpu_torch import ReceiverConfig
    from gps_sdr_tpu_torch.kernel_profile import wide_config

    out = {}
    for factor in (2, 4, 8):
        cfg = wide_config(ReceiverConfig(), factor)
        cs, k = cfg.code_samples, cfg.blocks_per_step
        for n_ch in (8, 11, 32) if factor == 8 else (8, 11):
            st, chunk, codes, ffts = make_case(cfg, n_ch, 2 * k, 7 + n_ch,
                                               dev, on_card=True)
            for name, vpu in (("wipeoff", False), ("wipeoff_vpu", True)):
                timing = factor == 8 and n_ch != 32
                r = check_wipeoff(cfg, st, chunk, 1, codes, ffts,
                                  timing=timing, vpu=vpu)
                rc = check_wipeoff(cfg, st, chunk, 0, codes, ffts, vpu=vpu,
                                   wipe=crafted_wipe(cfg, n_ch))
                check_repeat_bits(cfg, st, chunk, 1, codes, vpu,
                                  wipe=crafted_wipe(cfg, n_ch))
                r["crafted_max_abs_err"] = rc["max_abs_err"]
                out[f"{name}_cs{cs}_ch{n_ch}"] = r
                log(f"[9a] {name}, cs {cs}, {n_ch} channels: max abs err "
                    f"{r['max_abs_err']:.3g} (crafted delays "
                    f"{rc['max_abs_err']:.3g}); repeats bit-identical"
                    + (f"; wrapper {r['ms']:.4f} ms, plain "
                       f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                       f"ms ({r['bound_by']})" if timing else ""))
    cfg = wide_config(ReceiverConfig())           # cs 16384
    for shared in (True, False):
        st, chunk, codes, ffts = stream_case(cfg, 2, shared, 2 * k, 7, dev,
                                             on_card=True)
        for vpu in (False, True):
            check_wipeoff(cfg, st, chunk, 1, codes, ffts, vpu=vpu,
                          n_streams=2)
            check_stream_bits(cfg, st, chunk, 1, codes, 2, shared, vpu)
        log(f"[9a] 2 streams x {cfg.max_sat} channels at cs {cs}, "
            f"{'shared' if shared else 'distinct'} chunks: both kernels "
            "within tolerance of their plain versions and bit-identical "
            "to 2 single-stream launches")
    return out


# phase 17: the 2.4 MS/s period and the crafted delays on both sides of
# the first tile's edge and of the last tile's first column, and inside
# that tile: kernel 1's tiles of 152 columns (the last 120) and kernel
# 2's of 128 (the last 96)
RATE24_CS, RATE24_CH = 2400, 12
RATE24_DELAYS = (0, 1, 127, 128, 151, 152, 2279, 2280, 2303, 2304, 2305,
                 2351, 2398, 2399)


def run_rate24_phase(dev) -> dict:
    """Phase 17: the wipeoff kernels and a receiver's K-steps at cs 2400
    (2.4 MS/s), whose last column tile is partial in both kernels, K=8
    and 12 channels."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch import ReceiverConfig
    from gps_sdr_tpu_torch.ops import hopper_wipeoff, tracking
    from gps_sdr_tpu_torch.utils import profiling

    cfg = ReceiverConfig(code_samples=RATE24_CS, max_sat=RATE24_CH)
    k = cfg.blocks_per_step
    assert hopper_wipeoff.partial_tile(cfg.code_samples)
    st, chunk, codes, ffts = make_case(cfg, RATE24_CH, 2 * k, 24, dev)
    vals = torch.tensor(RATE24_DELAYS, dtype=torch.int32)
    crafted = vals[torch.arange(RATE24_CH * k).reshape(RATE24_CH, k)
                   % len(vals)]
    out = {}
    # a. the wrappers against their plain versions
    for name, vpu in (("wipeoff", False), ("wipeoff_vpu", True)):
        r = check_wipeoff(cfg, st, chunk, 1, codes, ffts, vpu=vpu)
        rc = check_wipeoff(cfg, st, chunk, 0, codes, ffts, vpu=vpu,
                           wipe=crafted)
        check_repeat_bits(cfg, st, chunk, 1, codes, vpu, wipe=crafted)
        r["crafted_max_abs_err"] = rc["max_abs_err"]
        out[name] = r
        log(f"[17a] {name}, cs {RATE24_CS}, {RATE24_CH} channels: max abs "
            f"err {r['max_abs_err']:.3g} (delays in the partial tile "
            f"{rc['max_abs_err']:.3g}); repeats bit-identical")
    # b. the receiver's K-steps, launches counted from zero
    host = [x.cpu() for x in (chunk, codes, ffts)]
    st_cpu = type(st)(*(x.cpu() for x in st))
    for mxu in (True, False):
        c = cfg.replace(use_mxu_wipeoff=mxu)
        _, want = tracking.track_chunk_batched_impl(c, st_cpu, host[0], 0,
                                                    host[1], host[2])
        _reset_launches()
        profiling.reset()
        _, got = tracking.track_chunk_batched_impl(c, st, chunk, 0, codes,
                                                   ffts)
        torch.cuda.synchronize()
        launches = _read_launches()
        partial = profiling.snapshot()["counts"].get(
            "track.partial_tile_steps", 0)
        name = "wipeoff" if mxu else "wipeoff_vpu"
        other = "wipeoff_vpu" if mxu else "wipeoff"
        if not (launches[name] == launches["cheap"] == 2
                and launches[other] == 0 and partial == 2):
            raise AssertionError(f"[17b] {name}: launches {launches}, "
                                 f"partial-tile K-steps {partial}, want "
                                 f"2 of {name} and cheap")
        dg, dw = got.delay.cpu().numpy(), want.delay.numpy()
        if not np.array_equal(dg, dw):
            raise AssertionError(f"[17b] {name}: correlation delays differ "
                                 f"from the CPU's: {dg.tolist()} vs "
                                 f"{dw.tolist()}")
        ok = dw >= 0
        if not ok.any():
            raise AssertionError(f"[17b] {name}: no correlation peak")
        cp = float(np.abs(got.code_phase.cpu().numpy()[ok]
                          - want.code_phase.numpy()[ok]).max())
        if not cp <= 5e-3:
            raise AssertionError(f"[17b] {name}: code phase err {cp:.3g} "
                                 "from the CPU's")
        out[f"kstep_{name}"] = {"launches": launches, "partial_steps": partial,
                                "code_phase_err": cp}
        log(f"[17b] receiver K-steps at cs {RATE24_CS} on {name}: "
            f"launches {launches}, partial-tile K-steps {partial}, "
            f"delays equal the CPU's, code phase err {cp:.3g}")
    profiling.reset()
    _reset_launches()
    return out


# tests/test_multipath.py _track_bias: PRN 17 at -1500 Hz, code delay
# 900.25 samples, 24 blocks at noise 0.5, an optional specular ray
BIAS_BITS_SEED, BIAS_BLOCKS, BIAS_NOISE = 17, 24, 0.5


def track_bias(cfg, delay_chips, rel_amp, rel_phase, dev) -> float:
    """Mean tracked code-phase error in m of test_multipath's
    single-satellite case (one satellite and an optional ray delay_chips
    later at rel_amp and rel_phase), synthesized on `dev` (DeviceSynth,
    seed 4) and tracked by the port's K-fused tracking there (kernel 2
    at use_mxu_wipeoff=False), as _track_bias measures it."""
    import torch
    from gps_sdr_tpu_torch.models.sim_dev import DeviceSynth
    from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits
    from gps_sdr_tpu_torch.ops import cacode, tracking

    bits = random_bits(128, seed=BIAS_BITS_SEED)
    direct = SatSignal(prn=17, doppler=-1500.0, code_delay=900.25,
                       nav_bits=bits)
    sats = [direct]
    if rel_amp > 0:
        sats.append(SatSignal(
            prn=17, doppler=-1500.0,
            code_delay=900.25 + delay_chips * cfg.code_samples / 1023.0,
            amplitude=rel_amp, carrier_phase=rel_phase, nav_bits=bits))
    chunk = DeviceSynth(cfg, sats, noise_std=BIAS_NOISE, seed=4,
                        device=dev).chunk_planar(0, BIAS_BLOCKS)
    st = tracking.init_channel_states(cfg, 1, dev)
    st = tracking.reset_channel(st, 0, 17, direct.doppler,
                                int(direct.code_delay), cfg)
    codes = torch.as_tensor(cacode.ca_table(cfg)[17][None], device=dev)
    ffts = torch.as_tensor(cacode.ca_fft_table(cfg)[17][None], device=dev)
    _, outs = tracking.track_chunk_batched_impl(cfg, st, chunk, 1, codes,
                                                ffts)
    got = tracking.outs_to_numpy(outs).code_phase[:, 0]
    return bias_m(cfg, direct, got)


def bias_m(cfg, direct, got) -> float:
    """_track_bias's measure: the mean code-phase error in m past block 5
    of the blocks with a correlation (which must be > 90% of them)."""
    import numpy as np
    from gps_sdr_tpu_torch.config import GPS_C

    cs, fs = cfg.code_samples, cfg.sample_rate
    true = np.array([(direct.code_delay + direct.delay_rate(cfg)
                      * ((b * cfg.ngps + cfg.ngps // 2) / fs)) % cs
                     for b in range(len(got))])
    ok = got >= 0
    if not ok.mean() > 0.9:
        raise AssertionError("correlation lost under multipath")
    err = ((got[ok] - true[ok] + cs / 2) % cs - cs / 2)[5:]
    return float(err.mean()) * GPS_C / fs


# (delay chips, ray amplitude, ray phase, bar m): test_multipath's 16 MS/s
# cases and bars
BIAS_CASES = ((0.0, 0.0, 0.0, 4.0), (0.5, 0.5, 0.0, 12.0),
              (0.5, 0.5, 3.141592653589793, 12.0), (0.25, 0.5, 0.0, 12.0))


def run_bias_phase(dev) -> dict:
    """Phase 9b: test_multipath's single-satellite bias bars at 16.384
    MS/s through the port's K-fused tracking on the card, kernel 2
    (use_mxu_wipeoff=False) and cheap."""
    from gps_sdr_tpu_torch import ReceiverConfig
    from gps_sdr_tpu_torch.kernel_profile import wide_config

    cfg = wide_config(ReceiverConfig(use_mxu_wipeoff=False))
    _reset_launches()
    out = {}
    for d, amp, ph, bar in BIAS_CASES:
        b = track_bias(cfg, d, amp, ph, dev)
        tag = f"d{d}_ph{ph:.2f}" if amp else "clean"
        out[tag] = b
        log(f"[9b] 16.384 MS/s bias, {tag}: {b:+.3f} m (bar |bias| < {bar})")
        if not abs(b) < bar:
            raise AssertionError(f"bias {tag} {b:.2f} m outside {bar} m")
    launches = _read_launches()
    steps = len(BIAS_CASES) * BIAS_BLOCKS // cfg.blocks_per_step
    if not (launches["wipeoff_vpu"] == launches["cheap"] == steps
            and launches["wipeoff"] == 0):
        raise AssertionError(f"kernel launches {launches} != {steps} "
                             "K-steps of kernel 2 and cheap")
    out["launches"] = launches
    return out


def run_wideband_loop(dev, factor: int, sec: float) -> dict:
    """One closed loop of ray_scenario at factor x 2.048 MS/s (n_cyc 8,
    corr_avg 4, kernel 1 and cheap) through Session.run_device_source;
    returns its fixes, mean fix error, launches, wall and realtime
    factor."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch import ReceiverConfig
    from gps_sdr_tpu_torch.kernel_profile import wideband_synth
    from gps_sdr_tpu_torch.runtime.session import Session

    cfg, scn, synth = wideband_synth(ReceiverConfig(), dev, factor, sec)
    t = cfg.no_sec
    n_chunks = int(round(sec / cfg.block_sec)) // t
    sig = n_chunks * t * cfg.block_sec
    session = Session(cfg, device=dev)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = session.run_device_source(synth.chunk_planar, n_chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rx = session.receiver
    stat = summary["stat"]
    return dict(cfg=cfg, scn=scn, rx=rx, summary=summary,
                launches=_read_launches(), wall_s=wall, signal_s=sig,
                rtf=sig / wall, fixes=summary["n_positions"],
                noise_std=synth.noise_std,
                want_steps=n_chunks * (t // cfg.blocks_per_step),
                err_m=(float(np.linalg.norm(stat[0] - scn.rec_ecef))
                       if stat is not None else float("nan")))


def run_wideband_slice(dev, sec: float = 36.0) -> dict:
    """Phase 9c: test_multipath's ray scenario (no tone) synthesized on
    the card at 16.384 MS/s and run closed loop through
    Session.run_device_source with kernel 1 and cheap: the scenario's
    PRNs, >= 4 ephemerides, >= 200 fixes, mean fix error < 10 m, kernel 1
    and cheap once a K-step, kernel 2 never.  Then the same scenario at
    2.048 MS/s, n_cyc 8, corr_avg 4 and the same C/N0 (its per-sample
    noise sqrt(8) x smaller), logged against test_multipath's 60 m bar."""
    wide = run_wideband_loop(dev, 8, sec)
    cfg, rx, summary, launches = (wide["cfg"], wide["rx"], wide["summary"],
                                  wide["launches"])
    found = sorted(f[1] for f in rx.found_sats)
    truth = sorted(s.prn for s in wide["scn"].sats)
    ephs = sorted(summary["ephemerides"])
    log(f"[9c] 16.384 MS/s (noise {wide['noise_std']:.4f} a sample): "
        f"acquired PRNs {found}; ephemerides {ephs}; {wide['fixes']} fixes "
        f"at mean error {wide['err_m']:.3f} m; wall {wide['wall_s']:.3f} s "
        f"for {wide['signal_s']:.2f} s = {wide['rtf']:.2f}x realtime; "
        f"K-steps {wide['want_steps']}, launches {launches}")
    if found != truth:
        raise AssertionError(f"acquired PRNs {found} != scenario {truth}")
    if not (len(ephs) >= 4 and wide["fixes"] >= 200
            and wide["err_m"] < 10.0):
        raise AssertionError(f"16.384 MS/s loop: {len(ephs)} ephemerides, "
                             f"{wide['fixes']} fixes, {wide['err_m']:.2f} m")
    if not (launches["wipeoff"] == launches["cheap"] == wide["want_steps"]
            == rx.status.k_steps and launches["wipeoff_vpu"] == 0):
        raise AssertionError(f"kernel launches {launches} != K-steps "
                             f"{wide['want_steps']} or wipeoff_vpu launched")
    if rx.status.edge_overflows:
        raise AssertionError(f"{rx.status.edge_overflows} bit edges "
                             "dropped by the compact transport")
    narrow = run_wideband_loop(dev, 1, sec)
    log(f"[9c] 2.048 MS/s, same C/N0 (noise {narrow['noise_std']:.4f} a "
        f"sample): {narrow['fixes']} fixes at mean error "
        f"{narrow['err_m']:.3f} m ({'within' if narrow['err_m'] < 60.0 else 'outside'}"
        f" test_multipath's 60 m bar); wall {narrow['wall_s']:.3f} s = "
        f"{narrow['rtf']:.2f}x realtime; launches {narrow['launches']}")
    if not narrow["fixes"]:
        raise AssertionError("2.048 MS/s comparison loop: no fix")
    keep = ("launches", "wall_s", "signal_s", "rtf", "fixes", "noise_std",
            "err_m")
    return {"wide": {n: wide[n] for n in keep},
            "narrow": {n: narrow[n] for n in keep},
            "ephemerides": len(ephs), "launches": launches}


# --------------------------------------------------------------------------
# the host slice (phase 10; the native-core check and the UDP helpers also
# used by tests/test_torch_native.py and tests/test_torch_cli_modes.py)

LIVE_SEC = 12.0


def cli_run(argv, ports=None) -> tuple[int, str]:
    """(rc, standard output) of cli.main(argv) in this process, with the
    transport's ports set to `ports` (data, ctrl) for the call."""
    import contextlib
    import io

    from gps_sdr_tpu_torch import cli
    from gps_sdr_tpu_torch.runtime import transport

    saved = transport.DATA_PORT, transport.CTRL_PORT
    buf = io.StringIO()
    try:
        if ports is not None:
            transport.DATA_PORT, transport.CTRL_PORT = ports
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
    finally:
        transport.DATA_PORT, transport.CTRL_PORT = saved
    out = buf.getvalue()
    for line in out.splitlines():
        log("      " + line)
    return rc, out


def printed_prns(out: str) -> list:
    """The PRN list of the CLI's `acquired PRNs [...]`."""
    import re

    m = re.search(r"acquired PRNs \[([\d, ]*)\]", out)
    if m is None:
        raise AssertionError(f"no acquired PRNs in {out!r}")
    return [int(v) for v in m.group(1).split(",") if v.strip()]


def host_core(native: bool):
    """Context: the native host core on (GSDR_EVALCORE=GSDR_NAVSCAN=1) or
    off (0, the numpy paths)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = {k: os.environ.get(k) for k in ("GSDR_EVALCORE",
                                                "GSDR_NAVSCAN")}
        os.environ.update(GSDR_EVALCORE=str(int(native)),
                          GSDR_NAVSCAN=str(int(native)))
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return ctx()


def record_native_calls():
    """Context yielding {name: [(args, kwargs, result, args after)]}: a
    deep copy of every call of the native host core while it is open
    (_evalcore's ecef_batch, sigma_slope and unwrap, the evaluator's
    solve_fix_batch, which reaches _evalcore.fix_batch, and _navscan's
    navscan), made by wrapping them."""
    import contextlib
    import copy

    from gps_sdr_tpu_torch import _evalcore
    from gps_sdr_tpu_torch.models import _navscan
    from gps_sdr_tpu_torch.runtime import evaluator

    targets = {"ecef_batch": _evalcore, "sigma_slope": _evalcore,
               "unwrap": _evalcore, "solve_fix_batch": evaluator,
               "navscan": _navscan}

    @contextlib.contextmanager
    def ctx():
        calls = {name: [] for name in targets}
        saved = {name: getattr(mod, name) for name, mod in targets.items()}

        def recorder(name, fn):
            def call(*args, **kw):
                before = copy.deepcopy((args, kw))
                out = fn(*args, **kw)
                calls[name].append((*before, copy.deepcopy(out),
                                    copy.deepcopy(args)))
                return out
            return call
        for name, mod in targets.items():
            setattr(mod, name, recorder(name, saved[name]))
        try:
            yield calls
        finally:
            for name, mod in targets.items():
                setattr(mod, name, saved[name])
    return ctx()


def _worst(worst: dict, name: str, got, want, atol=0.0, rtol=0.0) -> None:
    """Raise unless |got - want| <= atol + rtol |want|; keep the largest
    absolute difference under `name`."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"native {name}: shape {got.shape} != "
                             f"{want.shape}")
    err = np.abs(got - want)
    if err.size:
        worst[name] = max(worst.get(name, 0.0), float(err.max()))
    if not (err <= atol + rtol * np.abs(want)).all():
        raise AssertionError(f"native {name}: max err {float(err.max()):.3g}")


def check_native_core(cfg, calls, records, words) -> dict:
    """Phase 10a: the native host core against the port's numpy paths, at
    tests/test_native.py's tolerances, on the calls `calls` recorded
    (record_native_calls) while a run made the epochs `records`: ECEF
    (1e-6 m, 1e-18 s), the fix solver (1e-5 m; cov rtol 1e-6), sigma/slope and the slope history (rtol 1e-9 / 1e-12),
    the unwrap (rtol 1e-12, the same flagged steps), the subframe scan
    (the same subframes and buffer trim); then the IQ unpack of `words`
    (bit for bit, also from a file) and the native ring against the
    deque (drop-oldest accounting, bit for bit).  Then the evaluator over
    `records` with the core on and off, in turns: its ms per epoch each
    way, and their positions within 1e-3 m of each other."""
    import tempfile

    import numpy as np

    from gps_sdr_tpu_torch.config import GPS_C
    from gps_sdr_tpu_torch.models import navmsg, orbits
    from gps_sdr_tpu_torch.models.pseudorange import (EPHEM_KEYS,
                                                      PseudorangeEngine,
                                                      max_slope)
    from gps_sdr_tpu_torch.ops import pvt
    from gps_sdr_tpu_torch.runtime import _native, buffer, sources
    from gps_sdr_tpu_torch.runtime.evaluator import (EpochInput, Evaluator,
                                                     unwrap_numpy)

    worst, n_iter_diff = {}, 0
    for args, _, (x, y, z, dts), _ in calls["ecef_batch"]:
        tow, dt, mat, rel = args
        cols = {k: mat[:, i] for i, k in enumerate(EPHEM_KEYS)}
        xp, yp, zp, dtp = orbits.ecef_coord(tow, cols, dt_from_tow=dt,
                                            rel_corr=rel)
        _worst(worst, "ecef_m", np.stack([x, y, z]), np.stack([xp, yp, zp]),
               atol=1e-6)
        _worst(worst, "ecef_dtsv_s", dts, dtp, atol=1e-18)
    with host_core(False):
        for args, kw, got, _ in calls["solve_fix_batch"]:
            want = pvt.solve_fix_batch(*args, **kw)
            for name in ("pos", "range_est", "meas_delay", "res_m"):
                _worst(worst, f"fix_{name}_m", getattr(got, name),
                       getattr(want, name), atol=1e-5)
            if (got.cov is None) != (want.cov is None):
                raise AssertionError("native fix: covariance differs")
            if got.cov is not None:
                _worst(worst, "fix_cov", got.cov, want.cov, atol=1e-9,
                       rtol=1e-6)
            # the iteration counts are not compared: at the evaluator's
            # gate (1e-8) both solvers stop at the rounding floor of the
            # residual, after 8 to 15 iterations in either order
            n_iter_diff = max(n_iter_diff, int(np.abs(
                got.n_iter - want.n_iter).max(initial=0)))
        for args, _, (sig, slp), after in calls["sigma_slope"]:
            snos, cps, no_sec, n_cyc, cap, m_per_smp, hist = args
            if (no_sec, n_cyc, cap, m_per_smp) != (
                    cfg.no_sec, cfg.n_cyc, max_slope(cfg),
                    GPS_C / cfg.sample_rate):
                raise AssertionError("sigma_slope call of another config")
            eng = PseudorangeEngine(1, cfg)
            eng.slope_hist = list(hist)
            sig_p, slp_p = eng._sigma_and_slope(snos, cps)
            _worst(worst, "sigma_m", sig, sig_p, atol=1e-12, rtol=1e-9)
            _worst(worst, "slope", slp, slp_p, atol=1e-15, rtol=1e-9)
            _worst(worst, "slope_hist", after[6], eng.slope_hist, rtol=1e-12)
        for args, _, (corr, flagged), _ in calls["unwrap"]:
            corr_p, flagged_p = unwrap_numpy(*args)
            _worst(worst, "unwrap_samples", corr, corr_p, rtol=1e-12)
            if not np.array_equal(flagged, flagged_p):
                raise AssertionError("native unwrap: flagged steps differ")
        n_sub = 0
        for args, _, (starts, rows, final), _ in calls["navscan"]:
            bits = args[0]
            nd = navmsg.NavDecoder(ngps=cfg.ngps)
            nd.bits = np.asarray(bits, np.int8).copy()
            nd.bits_st = np.arange(len(bits), dtype=np.int64)
            want = nd._scan_buffer()
            got = []
            for si, row in zip(starts.tolist(), rows):
                sf = navmsg.fields_from_source(row)
                sf["ST"] = si
                got.append(sf)
            if got != want or len(nd.bits) != len(bits) - final:
                raise AssertionError("native navscan differs from the "
                                     "numpy walk")
            n_sub += len(got)

    n_words = min(words.size, 1 << 22)
    w = np.ascontiguousarray(words.reshape(-1)[:n_words])
    if not np.array_equal(_native.unpack_iq(w), sources.unpack_iq_numpy(w)):
        raise AssertionError("native unpack differs from numpy")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cap.bin")
        w.tofile(path)
        blk = _native.unpack_iq_file(path, 1000, cfg.ngps)
        if not np.array_equal(blk, sources.unpack_iq_numpy(
                w[1000:1000 + cfg.ngps])):
            raise AssertionError("native file unpack differs from numpy")
    ring, deque = buffer.make_buffer(4, cfg.ngps), buffer.BlockBuffer(4)
    blocks = sources.unpack_iq_numpy(w[:6 * cfg.ngps]).reshape(6, cfg.ngps)
    for b in blocks:                       # the 5th push drops blocks 0-3
        ring.push(b)
        deque.push(b)
    for _ in range(3):
        (gb, gs), (wb, ws) = ring.pull(), deque.pull()
        if gs != ws or (wb is None) != (gb is None) or (
                wb is not None and not np.array_equal(gb, wb)):
            raise AssertionError("native ring differs from the deque")

    def evaluate(native):
        with host_core(native):
            ev = Evaluator(cfg)
            t0 = time.perf_counter()
            for rec in records:
                ev.process(EpochInput(*rec))
            return (time.perf_counter() - t0) / len(records) * 1e3, ev
    ms = {False: [], True: []}
    evs = {}
    for native in (False, True, True, False):
        t, evs[native] = evaluate(native)
        ms[native].append(t)
    pos_n, pos_p = (np.asarray(evs[k].positions) for k in (True, False))
    if pos_n.shape != pos_p.shape or not len(pos_n):
        raise AssertionError(f"evaluator fixes differ in number: "
                             f"{pos_n.shape} vs {pos_p.shape}")
    _worst(worst, "evaluator_positions_m", pos_n[:, 1:], pos_p[:, 1:],
           atol=1e-3)
    return dict(max_abs_err=worst, fix_iterations_max_diff=n_iter_diff,
                subframes_scanned=n_sub,
                calls={k: len(v) for k, v in calls.items()},
                epochs=len(records), fixes=len(pos_n),
                eval_ms_per_epoch_native=sum(ms[True]) / 2,
                eval_ms_per_epoch_numpy=sum(ms[False]) / 2)


def _positions(prefix: str):
    import numpy as np

    with open(f"{prefix}_gpsPos.json") as f:
        return np.asarray(json.load(f), np.float64)


def _records_prns(records) -> list:
    return sorted({prn for rec in records for prn, lst in rec[2].items()
                   if lst})


class StandInRtlSdr:
    """A stand-in for pyrtlsdr's RtlSdr: read_samples hands out the
    blocks of BLOCKS in order; the settings are plain attributes, and
    each instance is kept in `opened`."""

    BLOCKS = ()
    opened: list = []

    def __init__(self):
        self._it = iter(type(self).BLOCKS)
        type(self).opened.append(self)

    def set_bias_tee(self, on):
        self.bias_tee = on

    def read_samples(self, n):
        block = next(self._it)
        if block.shape != (n,):
            raise ValueError(f"asked for {n} samples, block has "
                             f"{block.shape}")
        return block

    def close(self):
        pass


def stand_in_rtlsdr(blocks):
    """Context yielding the class RtlSdr of a module `rtlsdr`, put in
    sys.modules (the live source imports it), whose instances read
    `blocks`."""
    import contextlib
    import types

    @contextlib.contextmanager
    def ctx():
        mod = types.ModuleType("rtlsdr")
        mod.RtlSdr = type("RtlSdr", (StandInRtlSdr,),
                          {"BLOCKS": blocks, "opened": []})
        saved = sys.modules.get("rtlsdr")
        sys.modules["rtlsdr"] = mod
        try:
            yield mod.RtlSdr
        finally:
            if saved is None:
                sys.modules.pop("rtlsdr", None)
            else:
                sys.modules["rtlsdr"] = saved
    return ctx()


def _want_steps(cfg, n_blocks: int) -> int:
    """K-steps of Receiver.run over n_blocks blocks (block 0: the cold
    sweep; whole chunks of no_sec blocks, then the tail's whole
    K-steps)."""
    t, k = cfg.no_sec, cfg.blocks_per_step
    tracked = n_blocks - 1
    return (tracked // t) * (t // k) + (tracked % t) // k


def _check_launches(tag, launches, steps, name="wipeoff") -> None:
    """One launch of wipeoff kernel `name` and of cheap a K-step, none of
    the other wipeoff kernel."""
    other = "wipeoff_vpu" if name == "wipeoff" else "wipeoff"
    if not (launches[name] == launches["cheap"] == steps
            and launches[other] == 0):
        raise AssertionError(f"[{tag}] kernel launches {launches} != "
                             f"K-steps {steps}, or {other} launched")


def run_host_slice(cfg, scn, blocks, device: str = "cuda",
                   build_s: float | None = None) -> dict:
    """Phase 10: the host slice on the card.  Phase 4's blocks, scaled by
    HOST_SCALE and packed into an iq8 capture (unclipped), then:
      b. `replay --role both` in this process (the native core's calls
         recorded for 10a, the epochs recorded for 10c), then `eval` in a
         child process on two free UDP ports with the native core, fed by
         `replay --role recv` in this process on the card: the eval exits
         0, the scenario's PRNs acquired, >= 4 ephemerides, the mean fix
         within 8 m, kernel 1 and cheap once a K-step and kernel 2
         never, every epoch sent received, and the positions equal to
         the in-process run's epoch by epoch within 1e-3 m;
      a. check_native_core on what 10b recorded;
      c. `epochs` of the recorded epochs: the in-process run's positions;
      d. `live --max-sec 12` with a stand-in rtlsdr reading the capture's
         blocks: rc 0, the scenario's PRNs, kernel 1 and cheap on every
         K-step, and its --record-iq capture read back by replay_blocks
         and unpacked to the same blocks.
    No child process outlives a failure.  `device` is the receivers'
    (the CPU runs the plain path, which counts no launches); build_s,
    phase 1's seconds to build the kernels and the host libraries
    together, goes into 10a's record."""
    import re
    import tempfile

    import numpy as np

    from gps_sdr_tpu_torch.kernel_profile import (EVAL_IDLE_SEC, HOST_SCALE,
                                                  free_udp_ports, start_eval)
    from gps_sdr_tpu_torch.runtime import _native
    from gps_sdr_tpu_torch.runtime.sources import replay_blocks
    from gps_sdr_tpu_torch.utils import io
    from gps_sdr_tpu_torch.utils.io import load_epoch_records

    truth = sorted(s.prn for s in scn.sats)
    n_blocks = len(blocks)
    steps = _want_steps(cfg, n_blocks)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "cap.bin")
        words = _native.pack_iq(HOST_SCALE * blocks)
        words.tofile(cap)
        one, two, three = (os.path.join(tmp, n) for n in ("one", "two",
                                                         "three"))
        ep_path = os.path.join(tmp, "epochs.pickle")

        # 10b, the in-process run of the same capture
        _reset_launches()
        t0 = time.perf_counter()
        with record_native_calls() as calls:
            rc, out = cli_run(["replay", cap, "--device", device, "--ui",
                               "none", "--out", one, "--record-epochs",
                               ep_path])
        wall_both = time.perf_counter() - t0
        launches = _read_launches()
        if rc != 0 or printed_prns(out) != truth:
            raise AssertionError(f"[10b] in-process replay rc {rc}, PRNs "
                                 f"{printed_prns(out)} != {truth}")
        _check_launches("10b in-process", launches, steps)
        records = load_epoch_records(ep_path)
        pos_one = _positions(one)

        # 10a
        na = dict(check_native_core(cfg, calls, records, words),
                  build_s_with_kernels=build_s)
        log(f"[10a] native host core vs numpy on {na['epochs']} epochs: "
            f"{json.dumps(na)}")
        res["native"] = na

        # 10b, the two processes
        data, ctrl = free_udp_ports(2)
        eph = os.path.join(tmp, "eph.json")
        t0 = time.perf_counter()
        proc = start_eval(["eval", "--ui", "none", "--out", two,
                           "--ephem-cache", eph], data, ctrl, EVAL_IDLE_SEC)
        try:
            t_bound = time.perf_counter() - t0
            _reset_launches()
            t1 = time.perf_counter()
            rc, out = cli_run(["replay", cap, "--role", "recv", "--device",
                               device, "--ui", "none"], ports=(data, ctrl))
            wall_recv = time.perf_counter() - t1
            launches_two = _read_launches()
            eval_out, _ = proc.communicate(timeout=EVAL_IDLE_SEC + 60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for line in eval_out.splitlines():
            log("      eval: " + line)
        sent = int(re.search(r"(\d+) epochs sent", out).group(1))
        got = re.search(r"(\d+) epochs received", eval_out)
        got = int(got.group(1)) if got else -1
        ephs = sorted(io.load_ephemerides(eph))
        pos_two = _positions(two)
        err = float(np.linalg.norm(pos_two[:, 1:].mean(axis=0)
                                   - scn.rec_ecef))
        log(f"[10b] two processes: eval rc {proc.returncode} (bound its "
            f"port after {t_bound:.2f} s); recv rc {rc}, wall "
            f"{wall_recv:.3f} s for {n_blocks * cfg.block_sec:.1f} s of IQ "
            f"= {n_blocks * cfg.block_sec / wall_recv:.2f}x realtime "
            f"(in-process {wall_both:.3f} s); epochs sent {sent}, received "
            f"{got}, lost {sent - got}; PRNs {printed_prns(out)}; "
            f"ephemerides {ephs}; {len(pos_two)} fixes, mean fix "
            f"{err:.3f} m from truth; launches {launches_two}")
        if proc.returncode != 0 or rc != 0:
            raise AssertionError(f"[10b] eval rc {proc.returncode}, recv "
                                 f"rc {rc}")
        if printed_prns(out) != truth or len(ephs) < 4 or not err < 8.0:
            raise AssertionError("[10b] PRNs, ephemerides or fix bar "
                                 "missed")
        _check_launches("10b recv", launches_two, steps)
        if got != sent:
            raise AssertionError(f"[10b] {sent - got} of {sent} epochs lost")
        if pos_two.shape != pos_one.shape:
            raise AssertionError(f"[10b] {len(pos_two)} fixes over UDP, "
                                 f"{len(pos_one)} in process")
        d_pos = float(np.abs(pos_two - pos_one).max())
        if not d_pos <= 1e-3:
            raise AssertionError(f"[10b] positions differ by {d_pos:.3g} m "
                                 "from the in-process run")
        log(f"[10b] positions equal the in-process run's epoch by epoch "
            f"(max diff {d_pos:.3g} m)")
        res["two_process"] = dict(
            launches=launches_two, wall_s=wall_recv, wall_in_process_s=wall_both,
            rtf=n_blocks * cfg.block_sec / wall_recv,
            rtf_in_process=n_blocks * cfg.block_sec / wall_both,
            epochs_sent=sent, epochs_received=got, fixes=len(pos_two),
            err_m=err, max_pos_diff_m=d_pos)

        # 10c
        rc, out = cli_run(["epochs", ep_path, "--ui", "none", "--out",
                           three])
        pos_three = _positions(three)
        if rc != 0 or not np.array_equal(pos_three, pos_one):
            raise AssertionError("[10c] `epochs` positions differ from the "
                                 "in-process run's")
        log(f"[10c] epochs of {len(records)} recorded epochs: "
            f"{len(pos_three)} positions equal to the in-process run's")

        # 10d
        n_live = int(LIVE_SEC / cfg.block_sec)
        live = [np.ascontiguousarray(b) for b in _native.unpack_iq(
            words[:n_live])]
        rec_iq = os.path.join(tmp, "live.bin")
        ep_live = os.path.join(tmp, "live.pickle")
        _reset_launches()
        with stand_in_rtlsdr(live):
            rc, out = cli_run(["live", "--max-sec", str(LIVE_SEC),
                               "--device", device, "--ui", "none",
                               "--record-iq", rec_iq, "--record-epochs",
                               ep_live])
        launches_live = _read_launches()
        # replay_blocks yields the packed words: unpacked, the blocks
        sources_blocks = [_native.unpack_iq(w)
                          for w in replay_blocks(rec_iq, cfg)]
        same = len(sources_blocks) == n_live and all(
            np.array_equal(a, b) for a, b in zip(sources_blocks, live))
        log(f"[10d] live with a stand-in rtlsdr, {LIVE_SEC:.0f} s: rc {rc}, "
            f"PRNs {printed_prns(out)}, launches {launches_live}, "
            f"--record-iq read back {len(sources_blocks)} blocks "
            f"{'equal' if same else 'DIFFERENT'}")
        if rc != 0 or printed_prns(out) != truth or not same:
            raise AssertionError("[10d] live run failed its bars")
        _check_launches("10d", launches_live, _want_steps(cfg, n_live))
        res["live"] = dict(launches=launches_live)
    return res


def run_cheap_ncyc64(cfg, dev) -> dict:
    """Phase 10e: phase 3's cheap checks at n_cyc 64 (65 slots, the
    kernel's four-slot build) with 11 and 32 channels: 8 chained K-steps
    and the crafted case, with phase 3's tolerances; the wrapper and
    plain times and the bound at 11 channels; then the wrapper and plain
    times and the bound at the 16.384 MS/s configuration (cs 16384,
    n_cyc 8, corr_avg 4, 11 channels)."""
    from gps_sdr_tpu_torch.kernel_profile import wide_config

    out = {}
    c64 = cfg.replace(n_cyc=64)
    for n_ch in (11, 32):
        st, chunk, codes, ffts = make_case(c64, n_ch, c64.no_sec, 5 + n_ch,
                                           dev, on_card=True)
        c = check_cheap_chain(c64, st, chunk, codes, ffts,
                              timing=n_ch == 11)
        cc = check_cheap_case(c64, n_ch, 3, dev)
        out[f"ncyc64_ch{n_ch}"] = dict(c, crafted=cc)
        log(f"[10e] cheap kernel at n_cyc 64, {n_ch} channels, 8 chained "
            f"steps: {json.dumps(c)}; crafted case: {json.dumps(cc)}")
    wide = wide_config(cfg)
    st, chunk, codes, ffts = make_case(wide, wide.max_sat,
                                       2 * wide.blocks_per_step, 7, dev,
                                       on_card=True)
    w = check_cheap_chain(wide, st, chunk, codes, ffts, timing=True)
    out["wide_ch11"] = w
    log(f"[10e] cheap kernel at cs 16384, n_cyc 8, 11 channels: "
        f"{json.dumps(w)}")
    return out


# --------------------------------------------------------------------------
# the sharding slice (phase 11; check_acquire_sharded, epochs_equal and
# the multi-process helpers also used by tests/test_torch_parallel.py and
# tests/test_torch_cuda.py)

TRACK_BLOCKS = 1000             # 11b: 32 s of the phase-4 scenario
MP_BLOCKS = 256                 # 11d: the first blocks of 11b
# 11b: (time shards, warmup blocks) of the state-handoff rows.  Each row
# is a K=1 scan of the whole stream, ~7 s on the card (host-bound); the
# full 3 x 3 grid of 2/4/8 shards x warmups 2/4/8 took 67 s, so the smoke
# run keeps the rows that bound the operating point (PERF.md §6)
HANDOFF_GRID = ((2, 4), (2, 8), (8, 8))


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def sub_phase(tag: str | None, dev="cuda"):
    """Time the block: yields a dict that gets its wall (s) and, on the
    card, its CUDA-event span on cuda:0 (ms: device time from the first
    to the last work enqueued in it, idle gaps included; NaN on the
    CPU); logged under `tag` unless it is None."""
    import torch

    span = {}
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        ev0.record()
    t0 = time.perf_counter()
    yield span
    if on_card:
        ev1.record()
        torch.cuda.synchronize()
    span["wall_s"] = time.perf_counter() - t0
    span["event_ms"] = ev0.elapsed_time(ev1) if on_card else float("nan")
    if tag is not None:
        log(f"[{tag}] wall {span['wall_s']:.3f} s, CUDA-event span "
            f"{span['event_ms']:.1f} ms")


def mesh_device_sets(n: int, dev="cuda") -> list:
    """The device lists a phase-11 mesh of n runs on: cuda:0 repeated,
    and the real devices (cycled) when the machine has more than one
    (dev="cpu": the CPU repeated, a rehearsal's)."""
    import torch

    if torch.device(dev).type == "cpu":
        return [["cpu"] * n]
    sets = [["cuda:0"] * n]
    count = torch.cuda.device_count()
    if count > 1:
        sets.append([f"cuda:{i % count}" for i in range(n)])
    return sets


def check_acquire_sharded(cfg, block, devices, time_shards, prns=None):
    """acquire_sharded over a (time_shards, len(devices) / time_shards)
    mesh of `devices` against the unsharded acquire_impl on the mesh's
    first device: found, delay and freq exact, norm_max rtol 2e-5
    (tests/test_parallel.py).  Returns the sharded AcqResult (numpy)."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import cacode
    from gps_sdr_tpu_torch.ops.acquisition import acquire_impl
    from gps_sdr_tpu_torch.parallel import acquire_sharded, make_mesh

    mesh = make_mesh(len(devices), time_shards, devices)
    prns = np.asarray(cfg.prns if prns is None else prns)
    ffts = cacode.ca_fft_table(cfg)[prns]
    dop = cfg.doppler_bins.astype(np.float32)
    got = acquire_sharded(cfg, mesh, block, dop, ffts)
    dev = mesh.home
    ref = acquire_impl(cfg, torch.as_tensor(np.asarray(block)).to(dev),
                       torch.as_tensor(dop).to(dev),
                       torch.as_tensor(ffts).to(dev))
    for name in ("found", "delay", "freq"):
        want = getattr(ref, name).cpu().numpy()
        if not np.array_equal(getattr(got, name), want):
            raise AssertionError(f"sharded acquisition {name} differs from "
                                 f"the unsharded: {getattr(got, name)} vs "
                                 f"{want}")
    np.testing.assert_allclose(got.norm_max, ref.norm_max.cpu().numpy(),
                               rtol=2e-5)
    return got


def found_list(res, prns) -> list:
    """(norm_max, prn, freq, delay) of the found rows, strongest first:
    acquire_all's answer."""
    return sorted(((float(res.norm_max[i]), int(p), float(res.freq[i]),
                    int(res.delay[i])) for i, p in enumerate(prns)
                   if res.found[i]), reverse=True)


def run_sharded_acquisition(cfg, block, truth, dev="cuda") -> dict:
    """Phase 11a: block 0 of the phase-4 scenario at the product grid on a
    (2, 4) mesh and at the +-10 kHz grid on (4, 2), against the
    unsharded acquire_impl; the scenario's PRNs are found."""
    import torch

    import tempfile

    from gps_sdr_tpu_torch.utils import profiling

    out = {}
    wide = cfg.replace(min_freq=-10000.0, max_freq=10000.0)
    for tag, c, ts in (("product", cfg, 2), ("wide", wide, 4)):
        for devices in mesh_device_sets(8, dev):
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                with profiling.trace(tmp):
                    res = check_acquire_sharded(c, block, devices, ts)
                    _sync(dev)
                busy = profiling.device_time_from_trace(tmp)
                top = profiling.op_breakdown_from_trace(tmp, 3)
            wall = time.perf_counter() - t0
            if busy["lane"] != ("host" if dev == "cpu" else "device"):
                raise AssertionError(f"the trace holds no device event: "
                                     f"{busy}")
            found = found_list(res, c.prns)
            prns = sorted(f[1] for f in found)
            log(f"[11a] {tag} grid ({len(c.doppler_bins)} bins x "
                f"{len(c.prns)} PRNs) on a ({ts}, {8 // ts}) mesh of "
                f"{devices[0]}..{devices[-1]}: = unsharded; found {prns}; "
                f"wall {wall * 1e3:.1f} ms with the profiler, sharded and "
                f"unsharded; device busy {busy['busy_s'] * 1e3:.3f} ms over "
                f"{busy['n_ops']} device events on {busy['n_lanes']} "
                f"lane(s); top (name, ms, count) "
                f"{[(n[:40], round(t * 1e3, 3), k) for n, t, k in top]}")
            if prns != truth:
                raise AssertionError(f"sharded acquisition found {prns}, "
                                     f"the scenario has {truth}")
            out.setdefault(tag, found)
    return out


def decode_fix(cfg, found, blocks, outs, stream0: int = 1):
    """The receiver's own consume pipeline (Receiver._consume_chunk, one
    chunk of no_sec blocks at a time) and an Evaluator on tracking
    outputs of the channel slots that `found` fills: (the decoded
    subframes as a set of their nav fields, the evaluator).  Bits are
    framed by absolute sample time (NavDecoder ms_from_st), so a stitch
    seam's ms_time restart cannot move them (examples/scaling_sweep.py
    decode_fix)."""
    from gps_sdr_tpu_torch.models.navmsg import NavDecoder
    from gps_sdr_tpu_torch.ops.tracking import ChannelOut, outs_to_numpy
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    rx = Receiver(cfg, device="cpu")
    rx._serve_sweep_all(None, found=found)
    rx.decoders = {slot: NavDecoder(ngps=cfg.ngps,
                                    ms_from_st=cfg.code_samples)
                   for slot in rx.decoders}
    host = outs_to_numpy(outs)
    host = ChannelOut(*(x[:, :cfg.max_sat] for x in host))
    ev = Evaluator(cfg)
    epochs = []
    t = cfg.no_sec
    for c0 in range(0, host.code_phase.shape[0], t):
        part = ChannelOut(*(x[c0:c0 + t] for x in host))
        epochs.append(rx._consume_chunk(blocks[c0:c0 + t], part,
                                        stream0 + c0, 0))
        ev.process(epochs[-1])
    frames, _ = _stream_record(epochs)
    return frames, ev


def _fix_positions(ev) -> dict:
    import numpy as np

    return {round(p[0], 3): np.asarray(p[1:4]) for p in ev.positions}


def run_sharded_tracking(cfg, scn, blocks, found, dev="cuda",
                         n_blocks: int = TRACK_BLOCKS,
                         grid=HANDOFF_GRID) -> dict:
    """Phase 11b: TRACK_BLOCKS blocks of the phase-4 scenario (blocks
    1.., as a receiver tracks after its cold sweep on block 0) from the
    11 slots that 11a's acquisitions fill, padded to 12 over ch 2:
    the sequential K=1 scan (track_chunk_impl) on the card, then the
    exact stitch on a (2, 2) mesh against it (code_phase atol 1e-4, freq
    atol 1e-3, locked and edge_valid exact, final freq/phase atol 1e-3:
    tests/test_parallel.py), both through decode_fix (the sequential
    run: >= 4 ephemerides and a mean fix within 8 m; the stitched run:
    the same subframes and fixes within 1e-3 m epoch by epoch); then the
    state handoff at HANDOFF_GRID on (n, 1) meshes, each row's lost
    subframes, fixes, mean error and median separation from the
    sequential fixes logged."""
    import tempfile

    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops.tracking import track_chunk_impl
    from gps_sdr_tpu_torch.parallel import (make_mesh, pad_channels,
                                            track_sharded)
    from gps_sdr_tpu_torch.runtime.receiver import Receiver
    from gps_sdr_tpu_torch.utils import profiling

    rx = Receiver(cfg, device=dev)
    rx._serve_sweep_all(None, found=found)
    states, codes, ffts = rx.states, rx._codes_dev, rx._ffts_dev
    tb = np.ascontiguousarray(blocks[1:1 + n_blocks])
    sig_sec = n_blocks * cfg.block_sec
    out = {}

    def timed(fn):
        with sub_phase(None, dev) as span:
            res = fn()
        return res, span["wall_s"], span["event_ms"]

    blocks_dev = torch.as_tensor(tb).to(dev)
    (seq_final, seq), wall, ev_ms = timed(lambda: track_chunk_impl(
        cfg, states, blocks_dev, 1, codes, ffts))
    # the scan's device time: 32 of its blocks again under the profiler
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            track_chunk_impl(cfg, states, blocks_dev[:32], 1, codes, ffts)
            _sync(dev)
        busy = profiling.device_time_from_trace(tmp)
    del blocks_dev
    out["scan_ms_per_block"] = wall * 1e3 / n_blocks
    out["scan_event_ms_per_block"] = ev_ms / n_blocks
    out["scan_busy_ms_per_block"] = busy["busy_s"] * 1e3 / 32
    out["scan_ops_per_block"] = busy["n_ops"] / 32
    seq_frames, seq_ev = decode_fix(cfg, found, tb, seq)
    summ = _ev_summary(seq_ev)
    err = _check_fix("11b sequential", scn, rx, summ)
    seq_pos = _fix_positions(seq_ev)
    n_bytes = sum(x.element_size() * x[:1].numel() for x in states)
    out.update(seq_err_m=err, seq_fixes=len(seq_pos),
               subframes=len(seq_frames), state_bytes_per_channel=n_bytes)
    log(f"[11b] sequential K=1 scan of {n_blocks} blocks x "
        f"{cfg.max_sat} slots ({len(found)} active): wall {wall:.3f} s = "
        f"{out['scan_ms_per_block']:.3f} ms a block, CUDA-event span "
        f"{ev_ms:.1f} ms; {busy['lane']} busy "
        f"{out['scan_busy_ms_per_block']:.4f} ms a block over "
        f"{out['scan_ops_per_block']:.1f} {busy['lane']} events (32 blocks "
        f"profiled); {len(seq_frames)} subframes, {len(seq_pos)} fixes, "
        f"mean error {err:.3f} m")

    def host(x):
        return x[:, :cfg.max_sat].cpu().numpy()

    for devices in mesh_device_sets(4, dev):
        mesh = make_mesh(4, 2, devices)
        st12, co12, ff12 = pad_channels(states, codes, ffts,
                                        mesh.shape["ch"])
        (final, got), wall, ev_ms = timed(lambda: track_sharded(
            cfg, mesh, st12, tb, 1, co12, ff12))
        for name, atol in (("code_phase", 1e-4), ("freq", 1e-3)):
            np.testing.assert_allclose(host(getattr(got, name)),
                                       host(getattr(seq, name)), atol=atol,
                                       err_msg=name)
        for name in ("locked", "edge_valid"):
            if not np.array_equal(host(getattr(got, name)),
                                  host(getattr(seq, name))):
                raise AssertionError(f"exact stitch: {name} differs from "
                                     "the sequential scan")
        for name in ("freq", "phase"):
            np.testing.assert_allclose(
                getattr(final, name)[:cfg.max_sat].cpu().numpy(),
                getattr(seq_final, name).cpu().numpy(), atol=1e-3,
                err_msg=f"final {name}")
        frames, ev = decode_fix(cfg, found, tb, got)
        pos = _fix_positions(ev)
        if frames != seq_frames:
            raise AssertionError(f"exact stitch decoded {len(frames)} "
                                 f"subframes, the sequential scan "
                                 f"{len(seq_frames)}; "
                                 f"{len(frames ^ seq_frames)} differ")
        if pos.keys() != seq_pos.keys():
            raise AssertionError(f"exact stitch fixed {len(pos)} epochs, "
                                 f"the sequential scan {len(seq_pos)}")
        sep = max((float(np.linalg.norm(pos[k] - seq_pos[k]))
                   for k in pos), default=0.0)
        if not sep <= 1e-3:
            raise AssertionError(f"exact-stitch fixes {sep:.3g} m from "
                                 "the sequential scan's")
        log(f"[11b] exact stitch on a (2, 2) mesh of {devices[0]}.."
            f"{devices[-1]} (n_stitch 2, 12 slots): = sequential within "
            f"tolerance; {len(frames)} subframes identical, {len(pos)} "
            f"fixes within {sep:.3g} m; wall {wall:.3f} s "
            f"({sig_sec / wall:.2f}x realtime), CUDA-event span "
            f"{ev_ms:.1f} ms; handoff {n_bytes} bytes a channel, "
            f"{n_bytes * st12.prn.shape[0]} a boundary")
        out.setdefault("exact_wall_s", wall)

    rows = []
    t_grid = time.perf_counter()
    for n_sh, warm in grid:
        mesh = make_mesh(n_sh, n_sh, mesh_device_sets(n_sh, dev)[0])
        (_, got), wall, _ = timed(lambda: track_sharded(
            cfg, mesh, states, tb, 1, codes, ffts, warmup_blocks=warm))
        frames, ev = decode_fix(cfg, found, tb, got)
        pos = _fix_positions(ev)
        stat = ev.stat
        err = (float(np.linalg.norm(stat[0] - scn.rec_ecef))
               if stat is not None else float("nan"))
        common = sorted(pos.keys() & seq_pos.keys())
        sep = (float(np.median([np.linalg.norm(pos[k] - seq_pos[k])
                                for k in common]))
               if common else float("nan"))
        rows.append(dict(time_shards=n_sh, warmup_blocks=warm,
                         subframes_lost=len(seq_frames - frames),
                         fixes=len(pos), err_m=err, median_sep_m=sep,
                         wall_s=wall))
        log(f"[11b] handoff {n_sh} shards, warmup {warm}: subframes lost "
            f"{rows[-1]['subframes_lost']}, fixes {len(pos)}, mean error "
            f"{err:.3f} m, median separation from sequential {sep:.3g} m; "
            f"wall {wall:.3f} s")
    ok = [r for r in rows if r["subframes_lost"] == 0]
    best = min(ok, key=lambda r: (r["warmup_blocks"], r["time_shards"]),
               default=None)
    log(f"[11b] handoff grid {time.perf_counter() - t_grid:.1f} s; smallest "
        f"warmup with no lost subframe: "
        f"{best['warmup_blocks'] if best else 'none'}")
    out["handoff"] = rows
    out.update(states=states, codes=codes, ffts=ffts, seq=seq,
               seq_final=seq_final)
    return out


def epochs_equal(a, b) -> None:
    """tests/test_serving.py _epochs_equal: the skipped samples, the code
    phases (within 1e-5) and the frames' SAT and tow of two epochs."""
    import numpy as np
    from gps_sdr_tpu_torch.utils.cplist import cp_arrays

    if a.skipped_samples != b.skipped_samples:
        raise AssertionError("skipped samples differ")
    if sorted(a.code_phases) != sorted(b.code_phases):
        raise AssertionError(f"code-phase PRNs {sorted(a.code_phases)} != "
                             f"{sorted(b.code_phases)}")
    for prn in a.code_phases:
        sa, va = cp_arrays(a.code_phases[prn])
        sb, vb = cp_arrays(b.code_phases[prn])
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_allclose(va, vb, atol=1e-5)
    if len(a.frames) != len(b.frames):
        raise AssertionError(f"{len(a.frames)} frames != {len(b.frames)}")
    for fa, fb in zip(a.frames, b.frames):
        if (fa.get("SAT"), fa.get("tow")) != (fb.get("SAT"), fb.get("tow")):
            raise AssertionError(f"frame SAT/tow {fa.get('SAT')}/"
                                 f"{fa.get('tow')} != {fb.get('SAT')}/"
                                 f"{fb.get('tow')}")


def run_sharded_serving(base_cfg, ref7b, ref7c) -> dict:
    """Phase 11c: phase 7b's replicas (kernel 1) over a stream mesh of 4
    and phase 7c's independent front ends (kernel 2) over a stream mesh
    of 3: each stream's epochs equal the unsharded server's of phase 7
    (epochs_equal), phase 7b's fix bars, one launch of the wipeoff kernel
    and of cheap per group per K-step; then the replicas saved halfway
    (save_server), resumed by load_server(mesh=...) and run on: the code
    phases and subframes of the uninterrupted sharded run, exactly."""
    import tempfile

    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.parallel.mesh import make_stream_mesh
    from gps_sdr_tpu_torch.runtime import checkpoint

    out = {}
    cfg7b = base_cfg.replace(chunks_per_download=16,
                             download_windows_in_flight=4,
                             epoch_per_window=True)
    cfg7c = base_cfg.replace(use_mxu_wipeoff=False, chunks_per_download=8,
                             download_windows_in_flight=4,
                             epoch_per_window=True)
    t = base_cfg.no_sec
    n_chunks = int(round(SLICE_SEC / base_cfg.block_sec)) // t
    sig_sec = n_chunks * t * base_cfg.block_sec
    scn = make_scenario(cfg7b, n_sats=N_SATS, seed=SEED,
                        duration_sec=SLICE_SEC + 12.0)
    synth = DeviceScenarioSynth(scn, noise_std=NOISE, knot_interp_step=0.1,
                                device="cuda")
    scns = [make_scenario(cfg7c, n_sats=N_SATS, seed=sd,
                          duration_sec=SLICE_SEC + 12.0) for sd in (3, 5, 7)]
    synths = [DeviceScenarioSynth(sc, noise_std=NOISE, knot_interp_step=0.1,
                                  device="cuda") for sc in scns]
    cases = (("replicas", cfg7b, 8, 4, synth.chunk_planar, [scn] * 8,
              "wipeoff", ref7b),
             ("independent", cfg7c, 3, 3, [s.chunk_planar for s in synths],
              scns, "wipeoff_vpu", ref7c))
    for tag, cfg, n_st, n_dev, provs, case_scns, name, ref in cases:
        for devices in mesh_device_sets(n_dev):
            mesh = make_stream_mesh(n_dev, devices)
            srv, evs, wall, kept, _ = serve(cfg, n_st, provs, n_chunks,
                                            keep_epochs=range(n_st),
                                            mesh=mesh)
            launches = _read_launches()
            _check_streams("11c", case_scns, srv, evs, launches, wall,
                           sig_sec, name, groups=n_dev)
            for s in range(n_st):
                if len(kept[s]) != len(ref["epochs"][s]) or not kept[s]:
                    raise AssertionError(f"stream {s}: {len(kept[s])} "
                                         f"epochs sharded, "
                                         f"{len(ref['epochs'][s])} not")
                for a, b in zip(kept[s], ref["epochs"][s]):
                    epochs_equal(a, b)
            rtf = n_st * sig_sec / wall
            log(f"[11c] {tag}: {n_st} streams over a stream mesh of "
                f"{n_dev} ({devices[0]}..{devices[-1]}), each stream's "
                f"epochs = the unsharded server's; {rtf:.2f}x aggregate "
                f"realtime against {ref['rtf']:.2f}x unsharded (phase 7)")
            out.setdefault(tag, dict(launches=launches, rtf=rtf,
                                     wall_s=wall, perf=dict(srv.perf),
                                     kept=kept))
    # save halfway, resume over the mesh, run on
    rep = out["replicas"]
    half = n_chunks // 2
    mesh = make_stream_mesh(4, ["cuda:0"] * 4)
    s1, evs1, _, kept1, _ = serve(cfg7b, 8, synth.chunk_planar, half,
                                  keep_epochs=range(8), mesh=mesh)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "server.pkl")
        checkpoint.save_server(s1, evs1, path)
        s2, evs2 = checkpoint.load_server(path, "cuda", mesh=mesh)
    off = half * t
    _, _, _, kept2, _ = serve(
        cfg7b, 8, lambda f, n: synth.chunk_planar(f + off, n),
        n_chunks - half, keep_epochs=range(8), server=(s2, evs2))
    for s in range(8):
        want = _stream_record(rep["kept"][s])
        got = _stream_record(kept1[s] + kept2[s])
        if got != want:
            raise AssertionError(f"stream {s}: the resumed run's subframes "
                                 "or code phases differ from the "
                                 "uninterrupted sharded run's")
    log(f"[11c] replicas saved after {half} chunks, resumed by "
        f"load_server(mesh=stream mesh of 4) and run on: every stream's "
        f"subframes and code phases = the uninterrupted sharded run's")
    for v in out.values():
        v.pop("kept")
    return out


def free_tcp_port() -> int:
    """A TCP port the OS has free on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_child(port: int, rank: int, n_proc: int, devices: list,
               job_dir: str) -> int:
    """One rank of a multi-process mesh (make_multihost_mesh on
    tcp://127.0.0.1:port, `devices` this rank's): runs the job in
    job_dir (job.pkl and blocks.npy, written by run_mesh_processes) -
    track_sharded, exact, and acquire_sharded - and writes what it
    returned, its backend, wall and modules to result_<rank>.pkl."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    from gps_sdr_tpu_torch.ops.tracking import (outs_to_numpy,
                                                states_from_numpy,
                                                states_to_numpy)
    from gps_sdr_tpu_torch.parallel import acquire_sharded, track_sharded
    from gps_sdr_tpu_torch.parallel.mesh import make_multihost_mesh

    with open(os.path.join(job_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    blocks = np.load(os.path.join(job_dir, "blocks.npy"))
    mesh = make_multihost_mesh(f"127.0.0.1:{port}", n_proc, rank,
                               time_shards=job["time_shards"],
                               devices=devices)
    try:
        cfg = job["cfg"]
        states = states_from_numpy(job["states"], mesh.home)
        t0 = time.perf_counter()
        final, outs = track_sharded(cfg, mesh, states, blocks,
                                    job["stream_no0"], job["codes"],
                                    job["ffts"])
        acq = acquire_sharded(cfg, mesh, job["acq_block"], job["dopplers"],
                              job["acq_ffts"])
        if mesh.home.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = {"final": states_to_numpy(final),
               "outs": outs_to_numpy(outs)._asdict(),
               "acq": acq._asdict(), "backend": mesh.backend,
               "mesh": dict(mesh.shape), "wall_s": wall,
               "foreign": sorted(m for m in sys.modules if m.split(".")[0]
                                 in ("jax", "gps_sdr_tpu"))}
        with open(os.path.join(job_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh_processes(job: dict, blocks, devices: list, job_dir: str,
                       timeout: float = 120.0, meanwhile=None) -> list:
    """Run mesh_child in one child process a rank, rank r with the device
    list devices[r], on a free TCP port, and `meanwhile()` (if given) in
    this process while they start; returns their results in rank order.
    The children are killed in a `finally`, so none outlives a
    failure."""
    import pickle

    import numpy as np

    with open(os.path.join(job_dir, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    np.save(os.path.join(job_dir, "blocks.npy"), blocks)
    port = free_tcp_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = []
    try:
        for rank, devs in enumerate(devices):
            code = ("import sys\nimport chip_smoke\n"
                    f"sys.exit(chip_smoke.mesh_child({port}, {rank}, "
                    f"{len(devices)}, {list(devs)!r}, {job_dir!r}))\n")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        if meanwhile is not None:
            meanwhile()
        deadline = time.monotonic() + timeout
        outs = []
        for rank, p in enumerate(procs):
            left = max(1.0, deadline - time.monotonic())
            text, _ = p.communicate(timeout=left)
            outs.append(text)
            if p.returncode != 0:
                raise AssertionError(f"mesh rank {rank} exited "
                                     f"{p.returncode}:\n{text}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, text in enumerate(outs):
        with open(os.path.join(job_dir, f"result_{rank}.pkl"), "rb") as f:
            results.append(dict(pickle.load(f), log=text))
    return results


def mesh_job(cfg, states, codes, ffts, acq_block, time_shards: int) -> dict:
    """The multi-process job: track the blocks (blocks.npy) from `states`
    at stream number 1, and acquire acq_block at cfg's grid."""
    import numpy as np
    from gps_sdr_tpu_torch.ops import cacode
    from gps_sdr_tpu_torch.ops.tracking import states_to_numpy

    return {"cfg": cfg, "states": states_to_numpy(states),
            "codes": np.asarray(codes.cpu()), "ffts": np.asarray(ffts.cpu()),
            "stream_no0": 1, "time_shards": time_shards,
            "acq_block": np.asarray(acq_block),
            "dopplers": cfg.doppler_bins.astype(np.float32),
            "acq_ffts": cacode.ca_fft_table(cfg)[np.asarray(cfg.prns)]}


def check_mesh_results(results, final, outs, acq, atol_cp=1e-4,
                       atol_freq=1e-3) -> None:
    """Every rank's results against the in-process mesh's (final state,
    outs) and acquisition: tracking at 11b's tolerances (code_phase,
    freq; locked and edge_valid exact; final freq/phase 1e-3), the
    acquisition's found/delay/freq exact and norm_max rtol 2e-5; no
    rank holds a module of jax or gps_sdr_tpu."""
    import numpy as np
    from gps_sdr_tpu_torch.ops.tracking import outs_to_numpy, states_to_numpy

    want = outs_to_numpy(outs)._asdict()
    want_final = states_to_numpy(final)
    for rank, r in enumerate(results):
        if r["foreign"]:
            raise AssertionError(f"rank {rank} loaded {r['foreign']}")
        for name, atol in (("code_phase", atol_cp), ("freq", atol_freq)):
            np.testing.assert_allclose(r["outs"][name], want[name],
                                       atol=atol, err_msg=name)
        for name in ("locked", "edge_valid"):
            np.testing.assert_array_equal(r["outs"][name], want[name],
                                          err_msg=name)
        for name in ("freq", "phase"):
            np.testing.assert_allclose(r["final"][name], want_final[name],
                                       atol=1e-3, err_msg=f"final {name}")
        for name in ("found", "delay", "freq"):
            np.testing.assert_array_equal(r["acq"][name],
                                          getattr(acq, name),
                                          err_msg=f"acquisition {name}")
        np.testing.assert_allclose(r["acq"]["norm_max"], acq.norm_max,
                                   rtol=2e-5)


def run_mesh_slice(cfg, blocks, trk, found, dev="cuda",
                   n_blocks: int = MP_BLOCKS) -> dict:
    """Phase 11d: two child processes on the card, each rank a mesh of
    cuda:0 x 2 (gloo), a global (2, 2) mesh: track_sharded (exact) on the
    first n_blocks of 11b's blocks and acquire_sharded on block 0,
    against the in-process (2, 2) mesh's outputs, and the acquisition's
    found PRNs, Doppler bins and delays against 11a's (`found`)."""
    import tempfile

    import numpy as np
    from gps_sdr_tpu_torch.parallel import (acquire_sharded, make_mesh,
                                            pad_channels, track_sharded)

    tb = np.ascontiguousarray(blocks[1:1 + n_blocks])
    mesh = make_mesh(4, 2, mesh_device_sets(4, dev)[0])
    st12, co12, ff12 = pad_channels(trk["states"], trk["codes"],
                                    trk["ffts"], mesh.shape["ch"])
    job = mesh_job(cfg, st12, co12, ff12, blocks[0], 2)
    ref = {}

    def in_process():
        # while the children import torch and reach the card
        with sub_phase(None, dev) as span:
            ref["track"] = track_sharded(cfg, mesh, st12, tb, 1, co12, ff12)
            ref["acq"] = acquire_sharded(cfg, mesh, blocks[0],
                                         job["dopplers"], job["acq_ffts"])
        ref["wall_s"] = span["wall_s"]

    # every rank cuda:0 x 2 (gloo: two ranks on one card); with more
    # cards also one pair of distinct cards a rank (nccl)
    sets = [[d[:2], d[2:]] for d in mesh_device_sets(4, dev)]
    out = {}
    for i, ranks in enumerate(sets):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            results = run_mesh_processes(
                job, tb, ranks, tmp, meanwhile=in_process if i == 0 else None)
        wall_mp = time.perf_counter() - t0
        (final, outs), acq = ref["track"], ref["acq"]
        check_mesh_results(results, final, outs, acq)
        got = [f[1:] for f in found_list(acq, cfg.prns)]
        if got != [f[1:] for f in found]:
            raise AssertionError(f"(2, 2) acquisition {got} != 11a's "
                                 f"{found}")
        log(f"[11d] 2 processes, devices {ranks}, backend "
            f"{[r['backend'] for r in results]}, global mesh "
            f"{results[0]['mesh']}: track_sharded of {n_blocks} blocks and "
            f"acquire_sharded = the in-process (2, 2) mesh's; ranks' work "
            f"{[round(r['wall_s'], 3) for r in results]} s against "
            f"{ref['wall_s']:.3f} s in process (run while the first "
            f"children started); {wall_mp:.1f} s in all; no jax or "
            f"gps_sdr_tpu module in either child")
        out.setdefault("wall_ranks_s", [r["wall_s"] for r in results])
    return dict(out, wall_in_process_s=ref["wall_s"])


# --------------------------------------------------------------------------
# the bench slice (phase 12; bench_kernel_cases and check_bench_kernels
# also used by tests/test_torch_cuda.py)

# 12b's cut sizes of gps_sdr_tpu_torch/bench.py: argv[1] and environment
BENCH_T_LARGE = 1024
BENCH_ENV = {"BENCH_TSMALL": "256", "BENCH_FULL_SEC": "48",
             "BENCH_SERVE_SEC": "48", "BENCH_SERVE_SCALE": "1,8"}
# the bench's extras that track, and the channels each tracks a stream
BENCH_TRACKING = {"headline": 12, "ch32": 32, "streams": 96, "ncyc8": 12,
                  "fullloop": None, "serving": None, "msps16": 3}
SOAK_MINUTES = 10.0             # 12c, at 1 and 8 streams
ENDURANCE_MINUTES = 5.0         # 12d


def bench_kernel_cases(cfg):
    """(tag, config, channels) of phase 12a: the bench's product shapes
    (12 channels, cs 2048, n_cyc 32) at K=16 (the soak's) and K=32 (the
    bench's), and msps16's (cs 16384, n_cyc 8, corr_avg 4, 3 channels,
    K=16)."""
    from gps_sdr_tpu_torch.kernel_profile import bench_kernel_configs

    return [(tag, c, c.max_sat)
            for tag, c in bench_kernel_configs(cfg).items()]


def check_bench_kernels(cfg, n_ch, dev, timing: bool = False) -> dict:
    """The three kernels at cfg's K against their plain versions with
    phase 2's and phase 3's tolerances, on a 2K-block chunk synthesized
    on the card: both wipeoff kernels at step 1 with the predicted wipe
    delays and at step 0 with the crafted ones; the cheap kernel
    over 8 chained steps (full rings, ms_time past 2^24) and the crafted
    case; with `timing`, each wrapper's and plain version's times and
    bounds."""
    k = cfg.blocks_per_step
    st, chunk, codes, ffts = make_case(cfg, n_ch, 2 * k, 40 + k, dev,
                                       on_card=True)
    out = {}
    for name in ("wipeoff", "wipeoff_vpu"):
        vpu = name == "wipeoff_vpu"
        w = check_wipeoff(cfg, st, chunk, 1, codes, ffts, timing=timing,
                          vpu=vpu)
        wc = check_wipeoff(cfg, st, chunk, 0, codes, ffts, vpu=vpu,
                           wipe=crafted_wipe(cfg, n_ch))
        out[name] = dict(w, crafted_max_abs_err=wc["max_abs_err"])
    c = check_cheap_chain(cfg, st, chunk, codes, ffts, timing=timing)
    cc = check_cheap_case(cfg, n_ch, 3, dev)
    return dict(out, cheap=dict(c, crafted=cc))


def run_bench_kernels(cfg, dev) -> dict:
    """Phase 12a: check_bench_kernels at every bench_kernel_cases case,
    timed; then both wipeoff kernels' wrapper and plain times at n_cyc
    64 (11 channels, K=8)."""
    out = {}
    for tag, c, n_ch in bench_kernel_cases(cfg):
        out[tag] = check_bench_kernels(c, n_ch, dev, timing=True)
        log(f"[12a] {tag} ({n_ch} ch, K={c.blocks_per_step}, cs "
            f"{c.code_samples}, n_cyc {c.n_cyc}): "
            f"{json.dumps(out[tag])}")
    c64 = cfg.replace(n_cyc=64)
    st, chunk, codes, ffts = make_case(c64, c64.max_sat,
                                       2 * c64.blocks_per_step, 64, dev,
                                       on_card=True)
    out["n64_ch11"] = {
        name: check_wipeoff(c64, st, chunk, 1, codes, ffts, timing=True,
                            vpu=name == "wipeoff_vpu")
        for name in ("wipeoff", "wipeoff_vpu")}
    log(f"[12a] both wipeoff kernels at n_cyc 64, 11 ch: "
        f"{json.dumps(out['n64_ch11'])}")
    return out


@contextlib.contextmanager
def _environ(values: dict):
    """os.environ with `values` set, restored on exit."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_bench_result(res: dict) -> None:
    """Phase 12b's bars on the bench's JSON line: every extra that tracks
    launched kernel 1 and the cheap kernel once a K-step and kernel 2
    never; every channel locked at the end of each tracking extra; the
    headline's found fraction >= 0.85 and frequency error < 5 Hz
    (examples/endurance.py's bars); the snapshot within 50 m
    (tests/test_snapshot.py's one-block bar); the full loop's and every
    serving stream's fix within 8 m (the slices' bar)."""
    ex = res["extra"]
    for name in BENCH_TRACKING:
        n = ex["kernel_launches"][name]
        if not (n["wipeoff"] == n["cheap"] == n["k_steps"] > 0
                and n["wipeoff_vpu"] == 0):
            raise AssertionError(f"bench {name}: launches {n} are not one "
                                 "of kernel 1 and cheap a K-step")
    locked = {"headline": ex["channels_locked"],
              "ch32": ex["track_32ch_locked"],
              "streams": ex["streams_8x12_locked"],
              "ncyc8": ex["track_ncyc8_locked"],
              "msps16": ex["track_16msps_locked"]}
    for name, n_locked in locked.items():
        if n_locked != BENCH_TRACKING[name]:
            raise AssertionError(f"bench {name}: {n_locked} of "
                                 f"{BENCH_TRACKING[name]} channels locked")
    if not (ex["code_phase_found_frac"] >= 0.85
            and ex["max_freq_err_hz"] < 5.0):
        raise AssertionError("bench headline: found fraction "
                             f"{ex['code_phase_found_frac']}, freq error "
                             f"{ex['max_freq_err_hz']} Hz")
    if not ex["snapshot_err_m"] < 50.0:
        raise AssertionError(f"bench snapshot {ex['snapshot_err_m']} m")
    if not (isinstance(ex["full_loop_err_m"], float)
            and ex["full_loop_err_m"] < 8.0):
        raise AssertionError(f"bench full loop: {ex['full_loop_err_m']}")
    if not (ex["serving_8x12_streams_with_fixes"] == 8
            and isinstance(ex["serving_8x12_max_err_m"], float)
            and ex["serving_8x12_max_err_m"] < 8.0):
        raise AssertionError("bench serving: "
                             f"{ex['serving_8x12_streams_with_fixes']} "
                             "streams with fixes, worst "
                             f"{ex['serving_8x12_max_err_m']} m")
    for s, point in ex["serving_scale_curve"].items():
        if point["streams_with_fixes"] != int(s):
            raise AssertionError(f"bench serving curve at S={s}: "
                                 f"{point['streams_with_fixes']} streams "
                                 "with fixes")


def run_bench_phase(dev) -> dict:
    """Phase 12b: gps_sdr_tpu_torch.bench's main() in this process at
    BENCH_T_LARGE blocks and BENCH_ENV, every extra; its one JSON line
    parsed and held to check_bench_result."""
    import io
    from contextlib import redirect_stdout

    from gps_sdr_tpu_torch import bench

    buf = io.StringIO()
    t0 = time.perf_counter()
    with _environ(dict(BENCH_ENV, BENCH_EXTRAS="all")), \
            redirect_stdout(buf):
        rc = bench.main([str(BENCH_T_LARGE), "--device", str(dev)])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"bench: rc {rc}, {len(lines)} JSON lines")
    res = json.loads(lines[0])
    log(f"[12b] bench ({time.perf_counter() - t0:.1f} s): {lines[0]}")
    check_bench_result(res)
    return res


def run_soak_phase(dev) -> dict:
    """Phase 12c: gps_sdr_tpu_torch.examples.soak at SOAK_MINUTES of
    signal (K=16, checkpoint and resume at half time), 1 stream and 8:
    exit 0, every stream passing soak.py's rule."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    from gps_sdr_tpu_torch.examples import soak

    out = {}
    for n_streams in (1, 8):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "soak.json")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with redirect_stdout(buf):
                rc = soak.main(["--hours", str(SOAK_MINUTES / 60.0),
                                "--streams", str(n_streams), "--device",
                                str(dev), "--out", path])
            with open(path) as f:
                doc = json.load(f)
        log(f"[12c] soak, {n_streams} stream(s), {SOAK_MINUTES:g} min "
            f"({time.perf_counter() - t0:.1f} s): rc {rc}; "
            f"{json.dumps(doc)}")
        if not (rc == 0 and doc["pass"]):
            raise AssertionError(f"soak at {n_streams} streams failed")
        out[n_streams] = doc
    return out


def run_endurance_phase(dev) -> dict:
    """Phase 12d: gps_sdr_tpu_torch.examples.endurance at
    ENDURANCE_MINUTES (12 channels, chunks of 512 blocks, K=8): PASS."""
    import io
    from contextlib import redirect_stdout

    from gps_sdr_tpu_torch.examples import endurance

    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = endurance.main(["--minutes", str(ENDURANCE_MINUTES),
                             "--device", str(dev)])
    text = buf.getvalue().strip()
    log(f"[12d] endurance, {ENDURANCE_MINUTES:g} min "
        f"({time.perf_counter() - t0:.1f} s): rc {rc}; "
        + " | ".join(text.splitlines()[-3:]))
    if not (rc == 0 and text.endswith("PASS")):
        raise AssertionError("endurance failed")
    return {"rc": rc, "wall_s": time.perf_counter() - t0}


# --------------------------------------------------------------------------
# the envelope slice (phase 13): the JAX package's operating-envelope
# tests replayed through the port's entry points at ReceiverConfig()


# capture: (ReceiverConfig fields, make_scenario arguments, seconds, noise,
# pack scale, (gap second, gap samples) or None), each its JAX test's own
# (tests/test_impaired_replay.py, test_reference_degraded.py, test_raim.py,
# test_velocity.py, test_atmos_closed_loop.py)
ENVELOPE = {
    "impaired": (dict(min_freq=-8200.0, max_freq=2200.0,
                      solve_clock_rate=True),
                 dict(n_sats=8, seed=3, osc_ppm=2.0, osc_ppm_rate=1.65e-3),
                 40.0, 0.5, 0.12, None),
    "degraded": ({}, dict(n_sats=8, seed=2, osc_ppm=0.6,
                          osc_ppm_rate=3.0e-4),
                 64.0, 2.0, 0.05, (30.0, 6758)),
    "faulted": (dict(raim=True, carrier_smoothing=64),
                dict(n_sats=7, seed=35), 30.0, 0.5, 0.13, None),
    "moving": (dict(carrier_smoothing=64),
               dict(n_sats=7, seed=35, rec_vel_enu=(12.0, -5.0, 0.0)),
               48.0, 0.5, 0.13, None),
    "atmos": (dict(iono_corr=True, tropo_corr=True),
              dict(n_sats=7, seed=21, iono=True, tropo=True),
              30.0, 0.5, 0.13, None),
}
FAULT_SAT, FAULT_S = 2, 1.0e-6          # test_raim.py: sats[2], 1 us
ENVELOPE_PREFIX = 12                    # chunks (~12.3 s) held card vs CPU
FRQ_UNCONVERGED = 0.6                   # Hz: ROADMAP §3's traced 0.545 Hz
# test_sensitivity.py's levels (dB-Hz, noise) and its and
# test_codephase_precision.py's satellites: (prn, doppler, code delay,
# nav-bit count, bit seed)
SENS_LEVELS = ((50, 3.18), (45, 5.66), (42, 8.0))
SENS_SAT = (9, 1234.0, 800.0, 400, 5)
PREC_SAT = (17, -3456.0, 1023.37, 128, 17)
# test_channel_elasticity.py: A sets, C rises
ELASTIC_SATS = ((5, 1500.0, 300.0), (12, -2200.0, 900.0),
                (23, 3100.0, 1500.0))


def envelope_scenario(name: str, cfg):
    """The port's make_scenario of ENVELOPE[name] (the faulted capture's
    third satellite's SV clock 1 us off)."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario

    _, kw, sec, _, _, _ = ENVELOPE[name]
    scn = make_scenario(cfg, duration_sec=sec + 12.0, **kw)
    if name == "faulted":
        scn.sats[FAULT_SAT].fault_dtsv = FAULT_S
    return scn


U32 = 0xFFFFFFFF


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & U32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) that jax.random's default
    generator runs, on int64 tensors holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & U32, (x1 + ks[1]) & U32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & U32
    return x0, x1


# XLA's float32 erf_inv (M. Giles' polynomials, w < 5 and w >= 5)
_ERFINV = ((2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
            0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
            1.50140941),
           (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
            0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
            2.83297682))


def jax_normals(k0, k1, n: int):
    """jax.random.normal(key, (n,), float32) for the keys (k0, k1) [B]
    (int64 tensors of uint32 words) -> float32 [B, n]: the partitionable
    threefry bits of each element's index, JAX's uniform on
    (nextafter(-1, 0), 1) and sqrt(2) erf_inv.  The bits and the uniform
    are exact; log1p rounds apart from XLA's in the last bits (<= 3 ulps
    of the normal)."""
    import numpy as np
    import torch

    idx = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(idx),
                          idx)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.clamp((bits.to(torch.int32).view(torch.float32) - 1.0) * 2.0
                    + lo, min=lo)
    w = -torch.log1p(-u * u)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = list(zip(*_ERFINV))
    p = torch.where(small, *coef[0])
    for a, b in coef[1:]:
        p = torch.where(small, a, b) + p * w
    return float(np.float32(np.sqrt(2.0))) * (p * u)


def jax_synth_noise(cfg, first: int, n_blocks: int, dev, seed: int = 1):
    """The noise of the JAX package's DeviceScenarioSynth
    (models/scenario_jax.py _synth_chunk_dev) for blocks first .. first
    + n_blocks - 1: per block the key fold_in(PRNGKey(0), (seed * 7919 +
    block) % 2^23), re = normal(key), im = normal(fold_in(key, 1)), as
    grouped planar float32 [n_blocks, 2, n_cyc, cs]."""
    import torch

    blocks = torch.arange(first, first + n_blocks, dtype=torch.int64,
                          device=dev)
    zero = torch.zeros_like(blocks)
    k0, k1 = threefry2x32(zero, zero, zero, (seed * 7919 + blocks) % 8388608)
    j0, j1 = threefry2x32(k0, k1, zero, torch.ones_like(blocks))
    n = cfg.ngps
    return torch.stack([jax_normals(k0, k1, n), jax_normals(j0, j1, n)],
                       dim=1).reshape(n_blocks, 2, cfg.n_cyc,
                                      cfg.code_samples)


def envelope_capture(name: str, cfg, scn, path: str, dev,
                     max_blocks: int | None = None) -> float:
    """ENVELOPE[name]'s iq8 capture into `path` as its JAX test builds
    it: the signal synthesized on `dev` (DeviceScenarioSynth, noise
    off), plus the JAX synth's own noise (jax_synth_noise), one chunk of
    no_sec blocks at a time, packed at the test's scale (and cut by its
    sample gap), or its first max_blocks blocks.  The bytes are the JAX
    test's but where f32 rounding of the signal (a chip edge) or of the
    noise's last bits crosses a quantization step
    (tests/test_torch_envelope_noise.py counts them).  Returns the
    seconds taken."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.runtime.sources import pack_iq

    _, _, sec, noise, scale, gap = ENVELOPE[name]
    t0 = time.perf_counter()
    synth = DeviceScenarioSynth(scn, noise_std=0.0, device=dev)
    n_blocks = min(int(round(sec / cfg.block_sec)), max_blocks or 1 << 62)
    words = []
    for first in range(0, n_blocks, cfg.no_sec):
        k = min(cfg.no_sec, n_blocks - first)
        iq = (synth.chunk_planar(first, k)
              + noise * jax_synth_noise(cfg, first, k, dev))
        iq = torch.complex(iq[:, 0], iq[:, 1]).reshape(k, cfg.ngps)
        words.append(pack_iq(scale * iq.cpu().numpy()).ravel())
    raw = np.concatenate(words)
    if gap is not None:
        at = int(gap[0] * cfg.sample_rate)
        raw = np.concatenate([raw[:at], raw[at + gap[1]:]])
    raw.tofile(path)
    return time.perf_counter() - t0


@contextlib.contextmanager
def device_busy(dev):
    """Yields a dict that gets the block's wall (s) and, on the card, the
    device's busy time and share of that wall from a torch.profiler
    trace of the CUDA activity only (no host operators, whose recording
    would slow the host-bound loop); NaN on the CPU."""
    import tempfile

    import torch
    from gps_sdr_tpu_torch.utils import profiling

    out = {"busy_s": float("nan"), "busy_share": float("nan")}
    if torch.device(dev).type != "cuda":
        t0 = time.perf_counter()
        yield out
        out["wall_s"] = time.perf_counter() - t0
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(os.path.join(
            tmp, "envelope" + profiling.TRACE_SUFFIX))
        busy = profiling.device_time_from_trace(tmp)
    if busy["lane"] != "device":
        raise AssertionError(f"the trace holds no device events: {busy}")
    out["busy_s"] = busy["busy_s"]
    out["busy_share"] = busy["busy_s"] / out["wall_s"]


def record_chunks(rx, n: int) -> list:
    """Wrap rx._dispatch_chunk to keep the first n chunks' outputs (the
    device tensors; converted after the run, so no sync is added) with
    the slot map and acquisitions they were tracked with."""
    kept = []
    dispatch = rx._dispatch_chunk

    def recording(chunk):
        outs, stream0 = dispatch(chunk)
        if len(kept) < n:
            kept.append((outs, list(rx.slots.slot_prn),
                         list(rx.found_sats)))
        return outs, stream0

    rx._dispatch_chunk = recording
    return kept


def _host_chunks(kept) -> list:
    from gps_sdr_tpu_torch.ops.tracking import outs_to_numpy

    return [(outs_to_numpy(o), slots, found) for o, slots, found in kept]


def compare_chunks(tag: str, got: list, want: list) -> dict:
    """The card's chunks against the plain path's (CPU): the same
    acquisitions (PRN, frequency, delay exact; norm_max rtol 1e-3) and
    slot maps.  A channel locked in every block of a chunk on both sides
    is converged there: FRQ atol 1e-2 Hz and the same bit edges (valid
    flags, ms and local sample).  Elsewhere FRQ within FRQ_UNCONVERGED
    (cuFFT against pocketfft on a channel pulling in, ROADMAP §3).  On
    every block locked on both: code phases (both valid) atol 5e-3
    samples, AMP (amplitude) and CRM (norm_max) rtol 1e-3.  Returns the
    largest differences and the counts checked."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"[{tag}] {len(got)} card chunks against "
                             f"{len(want)} CPU chunks")
    worst = {"code_phase": 0.0, "frq_converged": 0.0,
             "frq_unconverged": 0.0, "amp_rel": 0.0, "crm_rel": 0.0}
    n_conv = n_edges = n_cp = 0
    for i, ((g, gs, gf), (w, ws, wf)) in enumerate(zip(got, want)):
        if [f[1:] for f in gf] != [f[1:] for f in wf] or gs != ws:
            raise AssertionError(f"[{tag}] chunk {i}: acquisitions or slots"
                                 f" differ: {gf} {gs} against {wf} {ws}")
        np.testing.assert_allclose([f[0] for f in gf], [f[0] for f in wf],
                                   rtol=1e-3)
        both = g.locked & w.locked                       # [T, C]
        conv = both.all(axis=0) & np.array([p != 0 for p in ws])
        dfrq = np.abs(g.freq - w.freq)
        worst["frq_converged"] = max(worst["frq_converged"],
                                     float(dfrq[:, conv].max(initial=0.0)))
        worst["frq_unconverged"] = max(
            worst["frq_unconverged"], float(dfrq[:, ~conv].max(initial=0.0)))
        cp = both & (g.code_phase >= 0) & (w.code_phase >= 0)
        worst["code_phase"] = max(worst["code_phase"], float(
            np.abs(g.code_phase - w.code_phase)[cp].max(initial=0.0)))
        for key, name in (("amp_rel", "amplitude"), ("crm_rel", "norm_max")):
            a, b = getattr(g, name)[both], getattr(w, name)[both]
            worst[key] = max(worst[key], float(
                (np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max(
                    initial=0.0)))
        for c in np.nonzero(conv)[0]:
            ev = w.edge_valid[:, c]
            if not (np.array_equal(g.edge_valid[:, c], ev)
                    and np.array_equal(g.edge_ms[:, c][ev], w.edge_ms[:, c][ev])
                    and np.array_equal(g.edge_local[:, c][ev],
                                       w.edge_local[:, c][ev])):
                raise AssertionError(f"[{tag}] chunk {i} slot {c}: the bit "
                                     "edges differ on a converged channel")
            n_edges += int(ev.sum())
        n_conv += int(conv.sum())
        n_cp += int(cp.sum())
    bad = (worst["code_phase"] > 5e-3 or worst["frq_converged"] > 1e-2
           or worst["frq_unconverged"] > FRQ_UNCONVERGED
           or worst["amp_rel"] > 1e-3 or worst["crm_rel"] > 1e-3)
    out = dict(worst, chunks=len(got), converged_channel_chunks=n_conv,
               code_phases=n_cp, edges=n_edges)
    if bad or not n_conv:
        raise AssertionError(f"[{tag}] card against the plain path: {out}")
    return out


def compare_subframes(tag: str, got_records, want_records) -> int:
    """The decoded subframes of the CPU run's epochs against the card's
    first epochs: every nav field and the sample anchor ST equal."""
    def subs(records):
        return {(sf["SAT"], sf["ID"], sf["tow"]): sf
                for rec in records for sf in rec[1] if "ID" in sf}

    skip = {"SAT", "AMP", "CN0", "CRM", "FRQ", "SWP", "EPH"}
    g, w = subs(got_records[:len(want_records)]), subs(want_records)
    if sorted(g) != sorted(w) or any(
            {k: v for k, v in g[key].items() if k not in skip}
            != {k: v for k, v in w[key].items() if k not in skip}
            for key in w):
        raise AssertionError(f"[{tag}] the decoded subframes differ")
    return len(w)


def envelope_replay(tag: str, cfg, path: str, dev, prefix: int = 0,
                    **session_kw) -> dict:
    """Session.run_source over the capture at `path` on `dev`, epochs
    recorded, the first `prefix` chunks' outputs kept (record_chunks):
    kernel 1 and cheap once a K-step, kernel 2 never."""
    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.runtime.sources import replay_blocks

    session = Session(cfg, device=dev, record_epochs_to="memory",
                      **session_kw)
    kept = record_chunks(session.receiver, prefix)
    _reset_launches()
    with device_busy(dev) as busy:
        session.run_source(replay_blocks(path, cfg))
    launches = _read_launches()
    rx = session.receiver
    if torch_device_type(dev) == "cuda":
        _check_launches(tag, launches, rx.status.k_steps)
    sig = rx.status.blocks_processed * cfg.block_sec
    return dict(session=session, chunks=_host_chunks(kept),
                launches=launches, wall_s=busy["wall_s"],
                rtf=sig / busy["wall_s"], busy_share=busy["busy_share"],
                signal_s=sig)


def torch_device_type(dev) -> str:
    import torch

    return torch.device(dev).type


def check_prefix(tag: str, cfg, path: str, run: dict) -> dict:
    """The capture's first ENVELOPE_PREFIX chunks (and its cold-sweep
    block) through the port's plain path on the CPU, held to the card's
    run (compare_chunks, compare_subframes)."""
    import torch

    if torch_device_type(run["session"].receiver.device) == "cpu":
        return {}
    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.runtime.sources import replay_blocks

    t0 = time.perf_counter()
    cpu = Session(cfg, device="cpu", record_epochs_to="memory")
    kept = record_chunks(cpu.receiver, ENVELOPE_PREFIX)
    cpu.run_source(replay_blocks(path, cfg, max_blocks=1 + ENVELOPE_PREFIX
                                 * cfg.no_sec))
    out = compare_chunks(tag, run["chunks"], _host_chunks(kept))
    out["subframes"] = compare_subframes(tag, run["session"].records,
                                         cpu.records)
    if not out["subframes"]:
        raise AssertionError(f"[{tag}] no subframe decoded in the prefix")
    out["cpu_s"] = time.perf_counter() - t0
    out["cpu_threads"] = torch.get_num_threads()
    return out


def _fix_err(ev, truth) -> float:
    import numpy as np

    return (float(np.linalg.norm(ev.stat[0] - truth))
            if ev.stat is not None else float("nan"))


def _bar(tag: str, ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"[{tag}] {what}")


def log_envelope(tag: str, what: str, run: dict, extra: str = "") -> None:
    ev = run["session"].evaluator
    log(f"[{tag}] {what}: {len(ev.positions)} fixes, phase errors "
        f"{ev.n_phase_errors}, RAIM events {len(ev.raim_events)}; "
        f"{extra}wall {run['wall_s']:.3f} s for {run['signal_s']:.2f} s = "
        f"{run['rtf']:.2f}x realtime, device busy "
        f"{100 * run['busy_share']:.1f}%; launches {run['launches']}")


def impaired_bars(tag: str, cfg, scn, session, sec: float) -> dict:
    """test_impaired_replay.py's four bars."""
    import numpy as np
    from gps_sdr_tpu_torch.config import L1_FREQ
    from gps_sdr_tpu_torch.ops.tracking import summarize_states

    _, kw, _, _, _, _ = ENVELOPE["impaired"]
    ppm, rate = kw["osc_ppm"], kw["osc_ppm_rate"]
    ev, rx = session.evaluator, session.receiver
    err = _fix_err(ev, scn.rec_ecef)
    _bar(tag, ev.stat is not None and ev.stat[2] >= 8 and err < 8.0
         and ev.n_phase_errors == 0, f"golden fix: {err:.2f} m, "
         f"{ev.n_phase_errors} phase errors")
    states = summarize_states(cfg, rx.states)
    t_end = sec - 1.0
    common = -1e-6 * (ppm + rate * t_end) * L1_FREQ
    worst, n_locked = 0.0, 0
    for slot, prn in enumerate(rx.slots.slot_prn):
        if prn == 0 or states["locked"][slot] < 0.5:
            continue
        sat = next(s for s in scn.sats if s.prn == prn)
        tau, _ = scn.sat_states(scn.t_rx0 + np.array([t_end - 0.5,
                                                      t_end + 0.5]), sat)
        off = abs(float(states["freq"][slot])
                  - (-L1_FREQ * (tau[1] - tau[0]) + common))
        worst, n_locked = max(worst, off), n_locked + 1
    _bar(tag, n_locked >= 4 and worst < 25.0,
         f"drift ramp: {n_locked} locked, worst {worst:.1f} Hz off")
    pos = ev.positions
    _bar(tag, len(pos) >= 8 and pos[-1][0] - pos[0][0] >= 5.0,
         "code-clock skew: fixes do not span 5 s")
    y_mid = 1e-6 * (ppm + rate * 30.0)
    _bar(tag, abs(ev.clock_rate_est - y_mid) < 1.5e-7,
         f"clock rate {ev.clock_rate_est:.4e} against {y_mid:.4e}")
    return dict(err_m=err, locked=n_locked, ramp_worst_hz=worst,
                clock_rate=ev.clock_rate_est)


def run_envelope_impaired(cfg0, dev, tmp: str) -> dict:
    """13b: the impaired capture replayed (kernel 1, cheap) with its
    prefix held to the plain path, then the same scenario and noise
    synthesized on the card (unscaled, unquantized) through
    run_device_source at use_mxu_wipeoff=False (kernel 2, cheap);
    test_impaired_replay.py's bars on both."""
    import torch
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.runtime.session import Session

    fields, _, sec, noise, _, _ = ENVELOPE["impaired"]
    cfg = cfg0.replace(**fields)
    scn = envelope_scenario("impaired", cfg)
    path = os.path.join(tmp, "impaired.bin")
    synth_s = envelope_capture("impaired", cfg, scn, path, dev)
    run = envelope_replay("13b", cfg, path, dev, ENVELOPE_PREFIX)
    bars = impaired_bars("13b", cfg, scn, run["session"], sec)
    prefix = check_prefix("13b", cfg, path, run)
    os.remove(path)
    log_envelope("13b", f"impaired replay ({len(cfg.doppler_bins)} "
                 f"Doppler bins, synthesized in {synth_s:.1f} s)", run,
                 f"{json.dumps(bars)}; card vs CPU {json.dumps(prefix)}; ")

    dcfg = cfg.replace(use_mxu_wipeoff=False)
    synth = DeviceScenarioSynth(scn, noise_std=0.0, device=dev)

    def provider(first, n):
        return (synth.chunk_planar(first, n)
                + noise * jax_synth_noise(dcfg, first, n, dev))

    n_chunks = int(round(sec / dcfg.block_sec)) // dcfg.no_sec
    session = Session(dcfg, device=dev)
    _reset_launches()
    with device_busy(dev) as busy:
        session.run_device_source(provider, n_chunks)
    launches = _read_launches()
    rx = session.receiver
    if torch.device(dev).type == "cuda" and not (
            launches["wipeoff_vpu"] == launches["cheap"] == rx.status.k_steps
            > 0 and launches["wipeoff"] == 0):
        raise AssertionError(f"[13b] device run: launches {launches}, "
                             f"K-steps {rx.status.k_steps}")
    _bar("13b", rx.status.edge_overflows == 0, "bit edges dropped")
    dbars = impaired_bars("13b device", dcfg, scn, session, sec)
    sig = rx.status.blocks_processed * dcfg.block_sec
    dev_run = dict(session=session, launches=launches,
                   wall_s=busy["wall_s"], rtf=sig / busy["wall_s"],
                   busy_share=busy["busy_share"], signal_s=sig)
    log_envelope("13b", "impaired, synthesized on the card, "
                 "run_device_source (kernel 2)", dev_run,
                 f"{json.dumps(dbars)}; ")
    return {"replay": dict(bars, launches=run["launches"], rtf=run["rtf"],
                           busy_share=run["busy_share"], prefix=prefix),
            "device": dict(dbars, launches=launches, rtf=dev_run["rtf"],
                           busy_share=dev_run["busy_share"])}


def _tracked_between(session, lo_s: float, hi_s: float, block_sec) -> set:
    lo, hi = int(lo_s / block_sec), int(hi_s / block_sec)
    return {int(sat) for rec in session.records
            for sat, lst in rec[2].items()
            if any(lo <= int(n) < hi for n, _ in lst)}


def run_envelope_degraded(cfg, dev, tmp: str) -> dict:
    """13c: the degraded capture (noise 2.0, a 6758-sample gap at 30 s)
    replayed; test_reference_degraded.py's claims for the port: the
    phase-error vote trips 1-4 times, >= 6 satellites tracked in the 10 s
    before and the 20 s after the gap, >= 10 fixes before and after, and
    the post-event mean error within max(2 m, half) of the pre-event
    one."""
    import numpy as np

    _, _, sec, _, _, gap = ENVELOPE["degraded"]
    scn = envelope_scenario("degraded", cfg)
    path = os.path.join(tmp, "degraded.bin")
    envelope_capture("degraded", cfg, scn, path, dev)
    run = envelope_replay("13c", cfg, path, dev, ENVELOPE_PREFIX)
    prefix = check_prefix("13c", cfg, path, run)
    os.remove(path)
    session = run["session"]
    ev = session.evaluator
    _bar("13c", 1 <= ev.n_phase_errors <= 4,
         f"{ev.n_phase_errors} phase-error trips (1-4)")
    before = _tracked_between(session, gap[0] - 10.0, gap[0], cfg.block_sec)
    after = _tracked_between(session, sec - 20.0, sec, cfg.block_sec)
    _bar("13c", len(before) >= 6 and len(after) >= 6,
         f"tracked before {sorted(before)}, after {sorted(after)}")
    fixes = np.array([p[:4] for p in ev.positions], np.float64)
    _bar("13c", len(fixes) > 0, "no fix")
    t_event = fixes[0, 0] - 14.0 + gap[0]
    pre = fixes[fixes[:, 0] < t_event - 1.0]
    post = fixes[fixes[:, 0] > t_event + 10.0]
    _bar("13c", len(pre) >= 10 and len(post) >= 10,
         f"{len(pre)} fixes before, {len(post)} after")
    e_pre = float(np.mean(np.linalg.norm(pre[:, 1:4] - scn.rec_ecef,
                                         axis=1)))
    e_post = float(np.mean(np.linalg.norm(post[:, 1:4] - scn.rec_ecef,
                                          axis=1)))
    _bar("13c", e_post < e_pre + max(2.0, 0.5 * e_pre),
         f"post-event {e_post:.2f} m against pre-event {e_pre:.2f} m")
    out = dict(phase_errors=ev.n_phase_errors, tracked_before=len(before),
               tracked_after=len(after), fixes_before=len(pre),
               fixes_after=len(post), err_pre_m=e_pre, err_post_m=e_post,
               err_m=_fix_err(ev, scn.rec_ecef))
    log_envelope("13c", "degraded replay (noise 2.0, gap at 30 s)", run,
                 f"{json.dumps(out)}; card vs CPU {json.dumps(prefix)}; ")
    return dict(out, launches=run["launches"], rtf=run["rtf"],
                busy_share=run["busy_share"], prefix=prefix)


def elastic_stream(cfg):
    """test_channel_elasticity.py's stream: 3 s of A+B, then 3 s of B+C."""
    import numpy as np
    from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                    synth_stream)

    a, b, c = (SatSignal(prn=p, doppler=f, code_delay=d,
                         nav_bits=random_bits(64, seed=p))
               for p, f, d in ELASTIC_SATS)
    n = 3 * cfg.no_sec
    return np.concatenate([synth_stream(cfg, [a, b], n, noise_std=0.4,
                                        seed=1),
                           synth_stream(cfg, [b, c], n, noise_std=0.4,
                                        seed=2)])


def elastic_run(cfg, blocks, dev) -> dict:
    """Receiver.run over the stream on `dev`, a re-sweep requested once
    PRN 5 should have set (the JAX test's loop); every chunk recorded."""
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    rx = Receiver(cfg, device=dev)
    kept = record_chunks(rx, len(blocks))
    n_half = 3 * cfg.no_sec
    epochs = []
    _reset_launches()
    with device_busy(dev) as busy:
        for epoch in rx.run(iter(blocks)):
            epochs.append(epoch)
            if rx.status.blocks_processed >= n_half + 2 * cfg.no_sec \
                    and 5 in rx.slots.active:
                rx.request_sweep()
    return dict(rx=rx, epochs=epochs, chunks=_host_chunks(kept),
                launches=_read_launches(), busy=busy)


def run_envelope_elasticity(cfg0, dev) -> dict:
    """13d: the A+B -> B+C stream with a requested sweep (max_sat 2, a 2 s
    quality window) on the card and on the CPU, every chunk held card vs
    CPU; the set ends {12, 23}, PRN 23 yields > 20 code phases in the
    last epoch."""
    cfg = cfg0.replace(max_sat=2, corr_q_window_sec=2)
    blocks = elastic_stream(cfg)
    run = elastic_run(cfg, blocks, dev)
    rx, epochs = run["rx"], run["epochs"]
    if torch_device_type(dev) == "cuda":
        _check_launches("13d", run["launches"], rx.status.k_steps)
    cold = {sf["SAT"] for e in epochs[:2] for sf in e.frames}
    last = epochs[-1].code_phases
    _bar("13d", {5, 12} <= cold and rx.slots.active == {12, 23}
         and len(last.get(23, ())) > 20 and 12 in last,
         f"cold {sorted(cold)}, final set {sorted(rx.slots.active)}, PRN 23"
         f" code phases {len(last.get(23, ()))}")
    prefix = {}
    if torch_device_type(dev) == "cuda":
        t0 = time.perf_counter()
        cpu = elastic_run(cfg, blocks, "cpu")
        _bar("13d", cpu["rx"].slots.active == rx.slots.active,
             "the CPU run ends with another set")
        prefix = compare_chunks("13d", run["chunks"], cpu["chunks"])
        prefix["cpu_s"] = time.perf_counter() - t0
    sig = len(blocks) * cfg.block_sec
    wall = run["busy"]["wall_s"]
    log(f"[13d] elasticity: final set {sorted(rx.slots.active)}, PRN 23 "
        f"{len(last[23])} code phases in the last epoch, sweeps "
        f"{rx.status.sweeps_served}; wall {wall:.3f} s for {sig:.2f} s = "
        f"{sig / wall:.2f}x realtime, device busy "
        f"{100 * run['busy']['busy_share']:.1f}%; launches "
        f"{run['launches']}; card vs CPU {json.dumps(prefix)}")
    return dict(launches=run["launches"], rtf=sig / wall,
                busy_share=run["busy"]["busy_share"], prefix=prefix)


def run_envelope_raim(cfg0, dev, tmp: str) -> dict:
    """13e: the faulted capture with RAIM on (carrier_smoothing 64) and
    off: the unprotected fix > 15 m off, RAIM names the faulted
    satellite alone (<= 2 events, statistic down > 20x) and repairs the
    fix (< 6 m and < 0.2 x the unprotected error)."""
    fields, _, _, _, _, _ = ENVELOPE["faulted"]
    cfg = cfg0.replace(**fields)
    scn = envelope_scenario("faulted", cfg)
    path = os.path.join(tmp, "faulted.bin")
    envelope_capture("faulted", cfg, scn, path, dev)
    on = envelope_replay("13e", cfg, path, dev, ENVELOPE_PREFIX)
    prefix = check_prefix("13e", cfg, path, on)
    off = envelope_replay("13e", cfg.replace(raim=False), path, dev)
    os.remove(path)
    ev_on, ev_off = on["session"].evaluator, off["session"].evaluator
    err_on, err_off = (_fix_err(e, scn.rec_ecef) for e in (ev_on, ev_off))
    bad = scn.sats[FAULT_SAT].prn
    events = ev_on.raim_events
    _bar("13e", err_off > 15.0, f"unprotected fix only {err_off:.2f} m off")
    _bar("13e", events and {e[1] for e in events} == {bad}
         and len(events) <= 2 and events[0][2] > 20 * events[0][3],
         f"RAIM events {events}, faulted PRN {bad}")
    _bar("13e", err_on < 6.0 and err_on < 0.2 * err_off,
         f"RAIM fix {err_on:.2f} m against {err_off:.2f} m")
    out = dict(err_raim_m=err_on, err_off_m=err_off, faulted_prn=bad,
               raim_events=[list(e) for e in events])
    log_envelope("13e", "faulted replay, RAIM on", on,
                 f"{json.dumps(out)}; card vs CPU {json.dumps(prefix)}; ")
    log_envelope("13e", "faulted replay, RAIM off", off)
    return dict(out, launches=on["launches"], launches_off=off["launches"],
                rtf=on["rtf"], busy_share=on["busy_share"], prefix=prefix)


def run_envelope_moving(cfg0, dev, tmp: str) -> dict:
    """13f: the moving capture (13 m/s, carrier_smoothing 64): >= 100
    fixes over > 10 s whose linear fit is within 1 m/s of the velocity
    and whose mean trajectory error is < 10 m; >= 5 Doppler velocity
    solves whose median is within 0.5 m/s; clock drift < 2e-8."""
    import numpy as np
    from gps_sdr_tpu_torch.utils.gpstime import gps_datetime

    fields, _, _, _, _, _ = ENVELOPE["moving"]
    cfg = cfg0.replace(**fields)
    scn = envelope_scenario("moving", cfg)
    path = os.path.join(tmp, "moving.bin")
    envelope_capture("moving", cfg, scn, path, dev)
    run = envelope_replay("13f", cfg, path, dev, ENVELOPE_PREFIX)
    prefix = check_prefix("13f", cfg, path, run)
    os.remove(path)
    ev = run["session"].evaluator
    t = np.array([p[0] for p in ev.positions])
    pos = np.array([p[1:] for p in ev.positions])
    _bar("13f", len(t) >= 100 and t[-1] - t[0] > 10.0,
         f"{len(t)} fixes")
    v_fit = np.array([np.polyfit(t - t[0], pos[:, ax], 1)[0]
                      for ax in range(3)])
    t0 = gps_datetime(scn.tow0, scn.week).timestamp() + 0.25
    bias = float(np.linalg.norm((pos - (scn.rec_ecef + (t - t0)[:, None]
                                        * scn.rec_vel)).mean(axis=0)))
    v = np.array([row[1:] for row in ev.velocities], np.float64)
    fit_err = float(np.linalg.norm(v_fit - scn.rec_vel))
    vel_err = (float(np.linalg.norm(np.median(v, axis=0) - scn.rec_vel))
               if len(v) else float("nan"))
    _bar("13f", fit_err < 1.0 and bias < 10.0,
         f"track: fit {fit_err:.2f} m/s off, bias {bias:.2f} m")
    _bar("13f", len(v) >= 5 and vel_err < 0.5
         and abs(ev.vel_result.clock_drift) < 2e-8,
         f"Doppler velocity: {len(v)} solves, {vel_err:.3f} m/s off")
    out = dict(fit_err_mps=fit_err, track_bias_m=bias,
               velocity_err_mps=vel_err, velocity_solves=len(v))
    log_envelope("13f", "moving replay (13 m/s)", run,
                 f"{json.dumps(out)}; card vs CPU {json.dumps(prefix)}; ")
    return dict(out, launches=run["launches"], rtf=run["rtf"],
                busy_share=run["busy_share"], prefix=prefix)


def run_envelope_atmos(cfg0, dev, tmp: str) -> dict:
    """13g: the atmospheric capture with corrections on (page 18
    decoded, >= 8 averaged fixes, < 6 m) and, on the same epochs, off
    (> 1 m worse); with coefficients preloaded (first fix < 30 m, mean
    < 2 m); the static velocity < 0.3 m/s; then the capture again with
    almanac_resweep_sec 2 from the scenario's almanac: >= 2 warm sweeps,
    < 6 m, >= 6 satellites kept."""
    import numpy as np
    from gps_sdr_tpu_torch import ReceiverConfig
    from gps_sdr_tpu_torch.models.almanac import almanac_from_ephem
    from gps_sdr_tpu_torch.runtime.evaluator import EpochInput, Evaluator
    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.utils.io import save_almanac

    fields, _, _, _, _, _ = ENVELOPE["atmos"]
    cfg = cfg0.replace(**fields)
    scn = envelope_scenario("atmos", cfg)
    path = os.path.join(tmp, "atmos.bin")
    envelope_capture("atmos", cfg, scn, path, dev)
    run = envelope_replay("13g", cfg, path, dev, ENVELOPE_PREFIX)
    prefix = check_prefix("13g", cfg, path, run)
    session = run["session"]
    ev = session.evaluator
    err = _fix_err(ev, scn.rec_ecef)
    off = Session(ReceiverConfig(), device=dev)
    off.run_epoch_records(session.records)
    err_off = _fix_err(off.evaluator, scn.rec_ecef)
    _bar("13g", ev.iono_params is not None and ev.stat is not None
         and ev.stat[2] >= 8 and err < 6.0 and err_off > err + 1.0,
         f"corrected {err:.2f} m, uncorrected {err_off:.2f} m")
    pre = Evaluator(cfg, iono_params={"alpha": scn.iono_alpha,
                                      "beta": scn.iono_beta})
    for rec in session.records:
        pre.process(EpochInput(*rec))
    first = (float(np.linalg.norm(np.asarray(pre.positions[0][1:])
                                  - scn.rec_ecef))
             if pre.positions else float("nan"))
    err_pre = _fix_err(pre, scn.rec_ecef)
    _bar("13g", len(pre.positions) >= 5 and first < 30.0 and err_pre < 2.0,
         f"preloaded: first fix {first:.2f} m, mean {err_pre:.2f} m")
    v = np.array([row[1:] for row in ev.velocities], np.float64)
    speed = (float(np.linalg.norm(np.median(v, axis=0))) if len(v)
             else float("nan"))
    _bar("13g", len(v) >= 3 and speed < 0.3, f"static velocity {speed}")
    alm = os.path.join(tmp, "almanac.json")
    save_almanac(alm, {s.prn: almanac_from_ephem(s.eph) for s in scn.sats})
    maint = envelope_replay("13g", cfg.replace(almanac_resweep_sec=2.0),
                            path, dev, almanac_cache_path=alm)
    os.remove(path)
    mrx = maint["session"].receiver
    err_maint = _fix_err(maint["session"].evaluator, scn.rec_ecef)
    _bar("13g", mrx.status.warm_sweeps >= 2 and err_maint < 6.0
         and len(mrx.slots.active) >= 6,
         f"maintenance: {mrx.status.warm_sweeps} warm sweeps, "
         f"{err_maint:.2f} m, {len(mrx.slots.active)} satellites")
    out = dict(err_m=err, err_uncorrected_m=err_off, first_fix_m=first,
               err_preloaded_m=err_pre, static_speed_mps=speed,
               warm_sweeps=mrx.status.warm_sweeps, err_maint_m=err_maint)
    log_envelope("13g", "atmosphere replay, corrections on", run,
                 f"{json.dumps(out)}; card vs CPU {json.dumps(prefix)}; ")
    log_envelope("13g", "atmosphere replay, almanac re-sweep every 2 s",
                 maint)
    return dict(out, launches=run["launches"],
                launches_maint=maint["launches"], rtf=run["rtf"],
                busy_share=run["busy_share"], prefix=prefix)


def sens_sat(spec):
    from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits

    prn, dopp, delay, n_bits, seed = spec
    return SatSignal(prn=prn, doppler=dopp, code_delay=delay,
                     nav_bits=random_bits(n_bits, seed=seed))


def track_one(cfg, blocks, prn, freq, delay, dev):
    """K-fused tracking of one channel from reset on `dev`; numpy outs."""
    import torch
    from gps_sdr_tpu_torch.ops import cacode
    from gps_sdr_tpu_torch.ops.tracking import (init_channel_states,
                                                outs_to_numpy, reset_channel,
                                                track_chunk_batched_impl)

    st = reset_channel(init_channel_states(cfg, 1, dev), 0, prn, freq, delay,
                       cfg)
    codes = torch.tensor(cacode.ca_table(cfg)[prn][None], device=dev)
    ffts = torch.tensor(cacode.ca_fft_table(cfg)[prn][None], device=dev)
    _, outs = track_chunk_batched_impl(cfg, st, torch.as_tensor(blocks,
                                                                device=dev),
                                       1, codes, ffts)
    return outs_to_numpy(outs)


def decoded_ber(cfg, o, sat) -> float:
    """Bit error rate of one channel's decoded bits against the
    satellite's (first 48-bit alignment, either polarity); NaN if none
    aligns or fewer than 61 bits framed."""
    import numpy as np
    from gps_sdr_tpu_torch.models.navmsg import NavDecoder

    dec = NavDecoder(ngps=cfg.ngps)
    for b in range(o.sign0.shape[0]):
        dec.push_block(o.sign0[b, 0], o.edge_ms[b, 0], o.edge_local[b, 0],
                       o.edge_valid[b, 0], stream_no=1 + b,
                       erased=bool(o.erased[b, 0]))
    bits, _ = dec._frame_bits()
    ref = sat.nav_bits.astype(np.int8)
    if len(bits) <= 60:
        return float("nan")
    for pol in (1, -1):
        g = np.asarray(bits) * pol
        for off in range(len(ref) - 48):
            if np.array_equal(ref[off:off + 48], g[:48]):
                n = min(len(g), len(ref) - off)
                return float((ref[off:off + n] != g[:n]).mean())
    return float("nan")


def _halves(o, prn, found) -> list:
    """One channel's 64-block outputs as two 32-block chunks for
    compare_chunks: the pull-in, then (converged) the rest."""
    from gps_sdr_tpu_torch.ops.tracking import ChannelOut

    return [(ChannelOut(*[x[sl] for x in o]), [prn], found)
            for sl in (slice(0, 32), slice(32, None))]


def run_envelope_sensitivity(cfg, dev) -> dict:
    """13a: test_sensitivity.py's stream (PRN 9, 64 blocks) at 50/45/42
    dB-Hz and test_codephase_precision.py's (PRN 17, noise 0.5) through
    acquire_all and the K-fused tracking on `dev`, each against the same
    calls on the CPU (compare_chunks), with the JAX tests' bars: PRN 9
    alone, frequency within step_freq, delay within 1.5, locked, code
    phase valid > 0.7, FRQ within 5 Hz, C/N0 within 2 dB, BER 0; code
    phase RMS < 0.08 and bias < 0.05 samples."""
    import numpy as np
    from gps_sdr_tpu_torch.models.simulator import synth_stream
    from gps_sdr_tpu_torch.ops import cacode
    from gps_sdr_tpu_torch.ops.acquisition import acquire_all
    from gps_sdr_tpu_torch.ops.tracking import cn0_from_amp

    n_blocks, out = 64, {}
    sat = sens_sat(SENS_SAT)
    on_card = torch_device_type(dev) == "cuda"
    _reset_launches()
    for cn0, noise in SENS_LEVELS:
        blocks = synth_stream(cfg, [sat], n_blocks, noise_std=noise, seed=3)
        found = acquire_all(cfg, blocks[0], cacode.ca_fft_table(cfg),
                            prns=list(range(2, 33)), device=dev)
        tag = f"13a {cn0} dB-Hz"
        _bar(tag, [f[1] for f in found] == [9], f"acquired {found}")
        _, _, freq, delay = found[0]
        _bar(tag, abs(freq - sat.doppler) <= cfg.step_freq
             and abs(delay - sat.code_delay) <= 1.5,
             f"acquired at {freq} Hz, delay {delay}")
        o = track_one(cfg, blocks, 9, freq, delay, dev)
        est = float(np.mean(cn0_from_amp(o.amplitude[32:, 0])))
        truth = 10 * np.log10(cfg.sample_rate / (2 * noise ** 2))
        ber = decoded_ber(cfg, o, sat)
        valid = float((o.code_phase[:, 0] >= 0).mean())
        _bar(tag, bool(o.locked[-1, 0]) and valid > 0.7
             and abs(o.freq[-1, 0] - sat.doppler) < 5.0
             and abs(est - truth) < 2.0 and ber == 0.0,
             f"locked {bool(o.locked[-1, 0])}, valid {valid:.3f}, FRQ "
             f"{o.freq[-1, 0]:.2f}, C/N0 {est:.2f} against {truth:.2f}, "
             f"BER {ber}")
        res = dict(valid=valid, frq_err_hz=float(o.freq[-1, 0] - sat.doppler),
                   cn0_est=est, cn0_truth=float(truth), ber=ber)
        if on_card:
            cfound = acquire_all(cfg, blocks[0], cacode.ca_fft_table(cfg),
                                 prns=list(range(2, 33)), device="cpu")
            res["vs_cpu"] = compare_chunks(
                tag, _halves(o, 9, found),
                _halves(track_one(cfg, blocks, 9, freq, delay, "cpu"), 9,
                        cfound))
        out[cn0] = res
        log(f"[{tag}] {json.dumps(res)}")
    psat = sens_sat(PREC_SAT)
    blocks = synth_stream(cfg, [psat], n_blocks, noise_std=0.5, seed=4)
    o = track_one(cfg, blocks, 17, psat.doppler, int(psat.code_delay), dev)
    got = o.code_phase[:, 0]
    n_center = np.arange(n_blocks) * cfg.ngps + cfg.ngps // 2
    cs = cfg.code_samples
    true = (psat.code_delay + psat.delay_rate(cfg) * (n_center
                                                      / cfg.sample_rate)) % cs
    ok = got >= 0
    err = ((got[ok] - true[ok] + cs / 2) % cs - cs / 2)[5:]
    rms, bias = float(np.sqrt(np.mean(err ** 2))), float(np.mean(err))
    _bar("13a precision", ok.mean() > 0.9 and rms < 0.08 and abs(bias) < 0.05,
         f"valid {ok.mean():.3f}, RMS {rms:.4f}, bias {bias:.4f}")
    res = dict(rms=rms, bias=bias)
    if on_card:
        res["vs_cpu"] = compare_chunks(
            "13a precision", _halves(o, 17, []),
            _halves(track_one(cfg, blocks, 17, psat.doppler,
                              int(psat.code_delay), "cpu"), 17, []))
    out["precision"] = res
    launches = _read_launches()
    log(f"[13a] code-phase precision: {json.dumps(res)}; launches "
        f"{launches} (4 streams x 8 K-steps)")
    if on_card:
        _check_launches("13a", launches, 4 * n_blocks // cfg.blocks_per_step)
    return dict(out, launches=launches)


def run_envelope(cfg, dev="cuda") -> dict:
    """Phase 13: the envelope scenarios 13a-13g on `dev` (captures in a
    temporary directory, removed after each scenario)."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["sensitivity"] = run_envelope_sensitivity(cfg, dev)
        out["impaired"] = run_envelope_impaired(cfg, dev, tmp)
        out["degraded"] = run_envelope_degraded(cfg, dev, tmp)
        out["elasticity"] = run_envelope_elasticity(cfg, dev)
        out["raim"] = run_envelope_raim(cfg, dev, tmp)
        out["moving"] = run_envelope_moving(cfg, dev, tmp)
        out["atmos"] = run_envelope_atmos(cfg, dev, tmp)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[13] phase 13 took {out['wall_s']:.1f} s")
    return out


def envelope_launches(env: dict, name: str) -> dict:
    """Each phase-13 run's launches of kernel `name`."""
    return {"sensitivity": env["sensitivity"]["launches"][name],
            "impaired_replay": env["impaired"]["replay"]["launches"][name],
            "impaired_device": env["impaired"]["device"]["launches"][name],
            "degraded": env["degraded"]["launches"][name],
            "elasticity": env["elasticity"]["launches"][name],
            "raim": env["raim"]["launches"][name],
            "raim_off": env["raim"]["launches_off"][name],
            "moving": env["moving"]["launches"][name],
            "atmos": env["atmos"]["launches"][name],
            "atmos_almanac_resweep": env["atmos"]["launches_maint"][name]}


# --------------------------------------------------------------------------
# the examples slice (phase 14; IDEAL_PINS also used by
# tests/test_torch_notebook.py)

# analysis.ideal_epochs + evaluate at ReceiverConfig(): fixes, fix
# failures, outliers, phase errors and the mean fix's error vs truth (m;
# host arithmetic, the native core and numpy agree within 1e-8 m)
IDEAL_PINS = {"fixes": 416, "failures": 0, "outliers": 0,
              "phase_errors": 0, "err_m": 0.2797575}
IDEAL_ERR_ATOL = 1e-6
LIVE_CP_ATOL = 1.22e-4          # samples: live vs in-process code phases


def _check_card_launches(tag, launches, steps, dev) -> None:
    """_check_launches on the card (the CPU's plain path counts none)."""
    if torch_device_type(dev) == "cuda":
        _check_launches(tag, launches, steps)


def _example(argv, dev, blocks=None) -> dict:
    """synthetic_fix.run(argv + --device dev, blocks) with the launches
    counted and the device's busy share traced: its values, launches and
    busy share."""
    from gps_sdr_tpu_torch.examples import synthetic_fix

    args = synthetic_fix.parse_args(list(argv) + ["--device", str(dev)])
    _reset_launches()
    with device_busy(dev) as busy:
        res = synthetic_fix.run(args, blocks=blocks)
    return dict(res, launches=_read_launches(),
                busy_share=busy["busy_share"])


def _example_line(tag: str, res: dict) -> None:
    what = (f"median trajectory error {res['median_m']:.3f} m"
            if "median_m" in res else f"error {res['err_m']:.3f} m")
    log(f"[{tag}] {'PASS' if res['ok'] else 'FAIL'}: {what}, "
        f"{res['n_positions']} fixes, RAIM excluded {res['raim_excluded']}; "
        f"{res['rtf']:.2f}x realtime, device busy "
        f"{100 * res['busy_share']:.1f}%; K-steps {res['k_steps']}, "
        f"launches {res['launches']}")


def run_quickstart(cfg, sl: dict, blocks, dev) -> dict:
    """14a: synthetic_fix.run at its defaults on phase 4's blocks: phase
    4's fix count and ephemerides, its mean within 1 mm, PASS, kernel 1
    and cheap once a K-step; then `python -m
    gps_sdr_tpu_torch.examples.synthetic_fix --on-device --quiet` (no
    --device) in a child process: exit 0 and PASS."""
    import numpy as np

    res = _example(("--quiet",), dev, blocks)
    launches = res["launches"]
    d_mean = float(np.linalg.norm(res["mean"] - sl["mean"]))
    _example_line("14a", res)
    log(f"[14a] phase 4's blocks: {res['n_positions']} fixes (phase 4 "
        f"{sl['fixes']}), mean {d_mean:.3g} m from phase 4's")
    if not (res["ok"] and res["n_positions"] == sl["fixes"]
            and res["ephemerides"] == sl["ephemerides"] and d_mean <= 1e-3):
        raise AssertionError("[14a] the quick start differs from phase 4")
    steps = _want_steps(cfg, len(blocks))
    if res["k_steps"] != steps:
        raise AssertionError(f"[14a] K-steps {res['k_steps']} != {steps}")
    _check_card_launches("14a", launches, steps, dev)

    # no --device: the entry point's default, the card (a rehearsal on
    # the CPU names it)
    on_cpu = [] if torch_device_type(dev) == "cuda" else ["--device", "cpu"]
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "gps_sdr_tpu_torch.examples.synthetic_fix",
         "--on-device", "--quiet", *on_cpu], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in child.stdout.splitlines():
        log("      child: " + line)
    lines = child.stdout.strip().splitlines()
    log(f"[14a] python -m gps_sdr_tpu_torch.examples.synthetic_fix "
        f"--on-device --quiet: rc {child.returncode} in {wall:.1f} s")
    if child.returncode != 0 or not lines or lines[-1] != "PASS":
        raise AssertionError(f"[14a] the entry point failed: "
                             f"{child.stderr[-2000:]}")
    return dict(launches=launches, err_m=res["err_m"], rtf=res["rtf"],
                busy_share=res["busy_share"], child_wall_s=wall)


def run_example_flags(cfg, dev) -> dict:
    """14b: synthetic_fix --on-device with each EXAMPLE_FLAG_SETS entry:
    kernel 1 and cheap once a K-step and the JAX example's verdict
    (PASS for every set, PERF.md)."""
    n_chunks = int(round(SLICE_SEC / cfg.block_sec)) // cfg.no_sec
    steps = n_chunks * (cfg.no_sec // cfg.blocks_per_step)
    out = {}
    for flags in EXAMPLE_FLAG_SETS:
        tag = " ".join(flags)
        res = _example(("--on-device", "--quiet") + flags, dev)
        _example_line(f"14b {tag}", res)
        if not res["ok"]:
            raise AssertionError(f"[14b] {tag}: FAIL where the JAX example "
                                 "passes")
        _check_card_launches(f"14b {tag}", res["launches"], steps, dev)
        if res["k_steps"] != steps:
            raise AssertionError(f"[14b] {tag}: K-steps {res['k_steps']}")
        out[tag] = {k: res[k] for k in (
            "launches", "err_m", "median_m", "vel_err_mps", "rtf",
            "busy_share", "raim_excluded", "n_positions") if k in res}
    return out


def run_notebook_phase(cfg, dev) -> dict:
    """14c: the notebook's functions on the card.  ideal_epochs + evaluate
    give IDEAL_PINS; live_parallel on `dev` over two free UDP ports
    consumes >= 3 epochs with kernel 1 and cheap once a K-step, and its
    epochs equal an in-process Session run of the same blocks on the card
    (frames equal, code phases within LIVE_CP_ATOL)."""
    import io

    import numpy as np

    from gps_sdr_tpu_torch.examples import analysis
    from gps_sdr_tpu_torch.kernel_profile import free_udp_ports
    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.utils.cplist import cp_arrays

    epochs, truth = analysis.ideal_epochs(cfg)
    ev = analysis.evaluate(cfg, epochs)
    got = {"fixes": len(ev.positions), "failures": len(ev.fix_failures),
           "outliers": len(ev.outliers), "phase_errors": ev.n_phase_errors,
           "err_m": float(np.linalg.norm(ev.stat[0] - truth))}
    log(f"[14c] ideal_epochs + evaluate: {json.dumps(got)}")
    if {k: v for k, v in got.items() if k != "err_m"} != {
            k: v for k, v in IDEAL_PINS.items() if k != "err_m"} or \
            abs(got["err_m"] - IDEAL_PINS["err_m"]) > IDEAL_ERR_ATOL:
        raise AssertionError(f"[14c] {got} != pinned {IDEAL_PINS}")

    blocks = analysis.live_capture(cfg)
    data, ctrl = free_udp_ports(2)
    live = []
    _reset_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, n = analysis.live_parallel(cfg, blocks, device=dev, data_port=data,
                                      ctrl_port=ctrl, epochs=live)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    steps = _want_steps(cfg, len(blocks))
    log(f"[14c] live_parallel on {dev}, UDP ports {data}/{ctrl}: consumed "
        f"{n} epochs in {wall:.2f} s; launches {launches}")
    if n < 3:
        raise AssertionError(f"[14c] only {n} live epochs")
    _check_card_launches("14c live", launches, steps, dev)

    session = Session(cfg, device=dev, record_epochs_to="memory")
    session.run_source(iter(blocks))
    want = session.records
    if len(want) != n:
        raise AssertionError(f"[14c] {n} live epochs, {len(want)} in "
                             "process")
    d_cp = 0.0
    for e, rec in zip(live, want):
        if e.skipped_samples != rec[0] or e.frames != rec[1] \
                or sorted(e.code_phases) != sorted(rec[2]):
            raise AssertionError("[14c] live frames differ from the "
                                 "in-process run's")
        for prn, lst in rec[2].items():
            s_want, v_want = cp_arrays(lst)
            s_got, v_got = cp_arrays(e.code_phases[prn])
            if not np.array_equal(s_got, s_want):
                raise AssertionError(f"[14c] PRN {prn}: stream numbers")
            if len(v_want):
                d_cp = max(d_cp, float(np.abs(v_got - v_want).max()))
    if not d_cp <= LIVE_CP_ATOL:
        raise AssertionError(f"[14c] live code phases {d_cp:.3g} samples "
                             "from the in-process run's")
    log(f"[14c] live epochs = the in-process Session's: frames equal, code "
        f"phases within {d_cp:.3g} samples")
    return dict(ideal=got, live_epochs=n, launches=launches, wall_s=wall,
                max_cp_diff=d_cp)


# the child of 14d: the `epochs` mode and analysis.load_epochs on the
# recorded fixture (argv: fixture, --out prefix), then the modules loaded
FIXTURE_CHILD = """
import json, sys
from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.examples import analysis
fixture, prefix = sys.argv[1:3]
rc = cli.main(["epochs", fixture, "--ui", "none", "--out", prefix])
ev = analysis.evaluate(ReceiverConfig(), analysis.load_epochs(fixture))
print("ANALYSIS", json.dumps([list(map(float, p)) for p in ev.positions]))
print("FOREIGN_MODULES", sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "gps_sdr_tpu")))
sys.exit(rc)
"""


def run_fixture_phase(cfg, blocks, dev) -> dict:
    """14d: `replay --record-epochs` of phase 4's blocks (an iq8 capture,
    as phase 10 packs it) through cli_run on the card, kernel 1 and cheap
    once a K-step; then a child process reads the fixture back with the
    `epochs` mode and analysis.load_epochs: no jax or gps_sdr_tpu module
    loaded, and both give the recording run's fixes."""
    import tempfile

    import numpy as np

    from gps_sdr_tpu_torch.kernel_profile import HOST_SCALE
    from gps_sdr_tpu_torch.runtime import _native

    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "cap.bin")
        _native.pack_iq(HOST_SCALE * blocks).tofile(cap)
        rec, one, two = (os.path.join(tmp, n) for n in (
            "epochs.pickle", "one", "two"))
        _reset_launches()
        rc, _ = cli_run(["replay", cap, "--device", str(dev), "--ui", "none",
                         "--out", one, "--record-epochs", rec])
        launches = _read_launches()
        if rc != 0:
            raise AssertionError(f"[14d] replay rc {rc}")
        _check_card_launches("14d", launches, _want_steps(cfg, len(blocks)),
                             dev)
        child = subprocess.run(
            [sys.executable, "-c", FIXTURE_CHILD, rec, two], cwd=ROOT,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=ROOT))
        lines = child.stdout.splitlines()
        if child.returncode != 0:
            raise AssertionError(f"[14d] child rc {child.returncode}: "
                                 f"{child.stderr[-2000:]}")
        pos_one, pos_two = _positions(one), _positions(two)
        (ana,) = [ln for ln in lines if ln.startswith("ANALYSIS ")]
        pos_ana = np.asarray(json.loads(ana.split(" ", 1)[1]), np.float64)
        (mods,) = [ln for ln in lines if ln.startswith("FOREIGN_MODULES")]
        log(f"[14d] recorded {len(pos_one)} fixes; the child's `epochs` "
            f"{len(pos_two)} and load_epochs + evaluate {len(pos_ana)}; "
            f"{mods}")
        if mods != "FOREIGN_MODULES []":
            raise AssertionError(f"[14d] the child loaded {mods}")
        if not (len(pos_one) > 100 and np.array_equal(pos_two, pos_one)
                and np.array_equal(pos_ana, pos_one)):
            raise AssertionError("[14d] the fixture's fixes differ from "
                                 "the recording run's")
    return dict(launches=launches, fixes=len(pos_one))


def run_examples(cfg, sl: dict, blocks, dev) -> dict:
    """Phase 14: 14a-14d, each one's seconds logged."""
    t0 = time.perf_counter()
    out = {}
    for key, tag, run in (
            ("quickstart", "14a", lambda: run_quickstart(cfg, sl, blocks,
                                                         dev)),
            ("flags", "14b", lambda: run_example_flags(cfg, dev)),
            ("notebook", "14c", lambda: run_notebook_phase(cfg, dev)),
            ("fixture", "14d", lambda: run_fixture_phase(cfg, blocks, dev))):
        t1 = time.perf_counter()
        out[key] = run()
        log(f"[{tag}] took {time.perf_counter() - t1:.1f} s")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[14] phase 14 took {out['wall_s']:.1f} s")
    return out


def examples_launches(ex: dict, name: str) -> dict:
    """Each phase-14 run's launches of kernel `name`."""
    out = {"quickstart": ex["quickstart"]["launches"][name]}
    for tag, res in ex["flags"].items():
        out[tag] = res["launches"][name]
    out["live_parallel"] = ex["notebook"]["launches"][name]
    out["fixture_record"] = ex["fixture"]["launches"][name]
    return out


# --------------------------------------------------------------------------
# the parity slice (phase 15): the card half of tests/test_torch_parity_*.py
# (the JAX package's tests twinned on the CPU), at the product width

EDGE_STEPS = 8                  # 15a: chained K-steps
EDGE_UNLOCKED = (9, 10)         # 15a: channels kept unlocked
EDGE_ERASED = (2, 5)            # 15a: channels erased before step 4
PULL_IN_BLOCKS = 64             # 15b: test_tracking_batched.py's stream[:64]
PULL_IN_OFFSET = 100.0          # Hz off the true Doppler (a 200 Hz grid)
PULL_IN_K = (8, 16, 32)
TAIL_K = (8, 32)                # 15c: T = 11 K + 4


@contextlib.contextmanager
def plain_path():
    """Run the port's plain versions in place of the three kernels, on
    whatever device the tensors are (the card's plain path): the
    wrappers that ops/tracking.py calls are swapped for the plain
    functions while the block runs."""
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff

    saved = (hopper_wipeoff.mix_wipeoff, hopper_wipeoff.mix_wipeoff_vpu,
             hopper_cheap.cheap_scan)
    hopper_wipeoff.mix_wipeoff = hopper_wipeoff.mix_wipeoff_plain
    hopper_wipeoff.mix_wipeoff_vpu = hopper_wipeoff.mix_wipeoff_vpu_plain
    hopper_cheap.cheap_scan = hopper_cheap.cheap_scan_plain
    try:
        yield
    finally:
        (hopper_wipeoff.mix_wipeoff, hopper_wipeoff.mix_wipeoff_vpu,
         hopper_cheap.cheap_scan) = saved


def edge_chain_state(cfg, n_ch, rng):
    """15a's starting state (CPU): every channel but EDGE_UNLOCKED locked,
    with test_edge_scan_equiv._case's mix of chains: sign0 in {-1, 0, 1}
    (0: a fresh chain, prev_sign 0), prev_signal 0 on channels 0 and 1
    and else +-U(0, 2) on a 1/64 grid, ms_time U[0, 50000) and 2^25 + 3
    on channel 4; the df ring zero (a locked channel's PLL then commands
    nothing, see edge_chain_args), full wrapped correlation rings."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import tracking

    cs, hist, no_sec = cfg.code_samples, cfg.corr_hist_len, cfg.no_sec
    ch = np.arange(n_ch)
    sign0 = np.resize([0, 1, -1], n_ch).astype(np.int8)
    prev_sign = np.where(sign0 == 0, 0, rng.choice([-1, 1], n_ch))
    prev_signal = np.where(ch < 2, 0.0, rng.choice([-1.0, 1.0], n_ch)
                           * np.round(rng.uniform(0.0, 2.0, n_ch) * 64) / 64)
    ms_time = np.where(ch == 4, 2 ** 25 + 3, rng.integers(0, 50000, n_ch))
    carry_cnt = np.where(ch % 2 == 0, rng.integers(1, cs, n_ch), 0)
    carry_sum = np.round(rng.uniform(-2, 2, n_ch) * 64) / 64 * carry_cnt
    locked = ~np.isin(ch, EDGE_UNLOCKED)
    return tracking.init_channel_states(cfg, n_ch, "cpu")._replace(
        active=torch.ones(n_ch, dtype=torch.bool),
        locked=torch.from_numpy(locked),
        std_dev=torch.from_numpy(np.where(locked, 0.25, 0.05).astype(
            np.float32)),
        sign0=torch.from_numpy(sign0),
        prev_sign=torch.from_numpy(prev_sign.astype(np.int8)),
        prev_signal=torch.from_numpy(prev_signal.astype(np.float32)),
        ms_time=torch.from_numpy(ms_time.astype(np.int32)),
        carry_sum=torch.from_numpy(carry_sum.astype(np.complex64)),
        carry_cnt=torch.from_numpy(carry_cnt.astype(np.int32)),
        corr_buf=torch.from_numpy(rng.choice([-1, 1], (n_ch, hist)).astype(
            np.int8)),
        corr_cnt=torch.full((n_ch,), hist, dtype=torch.int32),
        corr_idx=torch.from_numpy(rng.integers(0, hist, n_ch).astype(
            np.int32)),
        df_cnt=torch.full((n_ch,), no_sec, dtype=torch.int32),
        df_idx=torch.from_numpy(rng.integers(0, no_sec, n_ch).astype(
            np.int32)))


def edge_chain_args(cfg, st, rng, step: int):
    """The arguments of cheap_scan for one K-step of 15a from state `st`
    (CPU), and what the step holds.

    The per-ms means are designed after the retune rotation, as
    cheap_case designs them (the raw sums are the designed means rotated
    forward by the angle the plain version applies).  On the locked
    channels they are real, +-U(0.2, 2) on a 1/64 grid with 15% exact
    zeros: the PLL then measures no phase, its df ring stays zero and
    the rotation is the identity, so the means reach both the kernel and
    its plain version exactly (segment sums are means times cs, the
    carry-completed slot's sum a multiple of its count) and every edge
    decision is an exact one.  In block 0 the gate is the state's
    sigma, the same number on both sides, and two slot pairs sit at it:
    |mean - previous| equal to edge_sigma * sigma in f32 (no edge), and
    one f32 step past it.  The EDGE_UNLOCKED channels hold a 0.8 rad
    phase, so their PLL never locks and their edge chain never runs.
    Wipe delays 0 and cs - 1 in every channel (compaction, all n_cyc + 1
    slots)."""
    import numpy as np
    import torch

    k, cs, n_cyc = cfg.blocks_per_step, cfg.code_samples, cfg.n_cyc
    n_ch, sl = st.prn.shape[0], n_cyc + 1
    exact = st.locked.numpy().copy()
    seq = np.resize([0, 0, cs - 1, 0, cs // 2, cs - 1, 1, 0], k)
    wipe = np.stack([np.roll(seq, c + step) for c in range(n_ch)]).astype(
        np.int32)
    delay = np.where(rng.random((n_ch, k)) < 0.3, -1,
                     rng.integers(0, cs, (n_ch, k))).astype(np.int32)
    head = torch.zeros((n_ch, k), dtype=torch.complex64)
    seg = torch.zeros((n_ch, k, n_cyc), dtype=torch.complex64)
    wipe_t, delay_t = torch.from_numpy(wipe), torch.from_numpy(delay)
    c_cnt, c_sum = st.carry_cnt.numpy(), st.carry_sum.numpy()
    gate = np.float32(cfg.edge_sigma) * st.std_dev.numpy()
    facts = dict(zeros=0, at_gate=0, past_gate=0)
    for b in range(k):
        mag = np.round(rng.uniform(0.2, 2.0, (n_ch, sl)) * 64) / 64
        re = rng.choice([-1.0, 1.0], (n_ch, sl)) * mag
        re[rng.random((n_ch, sl)) < 0.15] = 0.0
        if b == 0:
            for lo, past in ((5, False), (9, True)):
                re[:, lo] = 0.5
                v = (np.float32(0.5) - gate).astype(np.float32)
                re[:, lo + 1] = np.nextafter(v, np.float32(-np.inf)) \
                    if past else v
        facts["zeros"] += int((re[exact] == 0).sum())
        if b == 0:
            d = np.abs(re[:, 6].astype(np.float32) - np.float32(0.5))
            facts["at_gate"] += int((exact & (d == gate)).sum())
            d = np.abs(re[:, 10].astype(np.float32) - np.float32(0.5))
            facts["past_gate"] += int((exact & (d > gate)).sum())
        theta = 0.8 + rng.normal(0.0, 0.02, (n_ch, sl))
        want = np.where(exact[:, None], re,
                        re * np.exp(1j * theta)).astype(np.complex64)
        c_cnt, c_sum = design_block(cfg, st, b, torch.from_numpy(want),
                                    head, seg, delay_t, wipe_t, c_cnt, c_sum)
    return (cfg, k, head, seg, delay_t, wipe_t, st), facts


def edge_chain_next(st, co):
    """The next step's state from a CheapOut `co` (CPU), as
    tracking.channel_step_k carries it (carry_sum de-rotated by dphi)."""
    import torch

    keep = {name: getattr(co, name) for name in (
        "carry_cnt", "sign0", "prev_sign", "prev_signal", "ms_time",
        "std_dev", "locked", "df_buf", "df_cnt", "df_idx", "corr_buf",
        "corr_cnt", "corr_idx")}
    carry = co.carry_sum * torch.complex(torch.cos(co.dphi),
                                         -torch.sin(co.dphi))
    return st._replace(carry_sum=carry, **keep)


EDGE_EXACT_FIELDS = ("edge_valid", "sign0_seq", "sign0", "prev_sign",
                     "prev_signal", "ms_time")


def run_edge_chain(cfg, dev, on_step=None) -> dict:
    """15a: the cheap kernel's bit-edge chain against its plain version on
    the card, over EDGE_STEPS chained K-steps of edge_chain_args at the
    product width (cfg.max_sat channels): the edges (valid flags, their
    ms and local sample), the per-block sign0, and the carried sign0,
    prev_sign, prev_signal and ms_time bit for bit; every other field
    within _compare_cheap's tolerances.  Channels EDGE_ERASED are erased
    before step 4 (a fresh chain mid-run, as a stream gap does).  The
    run must reach what it is made for: edges accepted, fresh chains
    started, means exactly zero, slots at and one step past the gate,
    and the unlocked channels unlocked throughout.  (n_valid 0 of
    test_edge_scan_equiv.py has no counterpart here: a K-step block
    holds n_cyc - 1 to n_cyc + 1 valid slots; a channel whose chain does
    not run is the unlocked one.)  on_step(args, out), if given, gets
    each step's arguments and the plain version's result on the CPU
    (tests/test_torch_parity_tracking.py holds them to the JAX
    package's reference chain)."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import hopper_cheap, tracking

    rng = np.random.default_rng(15)
    n_ch = cfg.max_sat
    st = edge_chain_state(cfg, n_ch, rng)
    totals = dict(steps=EDGE_STEPS, edges=0, fresh_chains=0, zeros=0,
                  at_gate=0, past_gate=0, max_abs_err=0.0)
    _reset_launches()
    for step in range(EDGE_STEPS):
        if step == 4:
            idx = torch.tensor(EDGE_ERASED)
            st = st._replace(**{name: getattr(st, name).index_fill(0, idx, 0)
                                for name in ("sign0", "prev_sign",
                                             "carry_sum", "carry_cnt")})
        args, facts = edge_chain_args(cfg, st, rng, step)
        on_dev = args[:2] + tuple(a.to(dev) for a in args[2:6]) + (
            tracking.ChannelState(*(v.to(dev) for v in st)),)
        got = hopper_cheap.cheap_scan(*on_dev)
        want = hopper_cheap.cheap_scan_plain(*on_dev)
        totals["max_abs_err"] = max(totals["max_abs_err"], _compare_cheap(
            got, want, cfg, on_dev[-1]))
        for name in EDGE_EXACT_FIELDS:
            if not torch.equal(getattr(got, name), getattr(want, name)):
                raise AssertionError(f"[15a] step {step}: {name} differs "
                                     "from the plain version")
        v = want.edge_valid
        for name in ("edge_ms", "edge_local"):
            if not torch.equal(getattr(got, name)[v],
                               getattr(want, name)[v]):
                raise AssertionError(f"[15a] step {step}: {name} differs "
                                     "at valid edges")
        co = hopper_cheap.CheapOut(*(x.cpu() for x in want))
        if on_step is not None:
            on_step(args, co)
        if co.locked_seq[list(EDGE_UNLOCKED)].any():
            raise AssertionError(f"[15a] step {step}: an unlocked channel "
                                 "locked")
        totals["edges"] += int(co.edge_valid.sum())
        totals["fresh_chains"] += int(((st.sign0 == 0)
                                       & (co.sign0 != 0)).sum())
        for key in ("zeros", "at_gate", "past_gate"):
            totals[key] += facts[key]
        st = edge_chain_next(st, co)
    _sync(dev)
    totals["launches"] = _read_launches()
    if torch_device_type(dev) == "cuda" and totals["launches"] != dict(
            wipeoff=0, wipeoff_vpu=0, cheap=EDGE_STEPS):
        raise AssertionError(f"[15a] launches {totals['launches']}")
    if not (totals["edges"] and totals["zeros"] and totals["at_gate"]
            and totals["past_gate"]
            and totals["fresh_chains"] >= 1 + len(EDGE_ERASED)):
        raise AssertionError(f"[15a] the case missed its purpose: {totals}")
    log(f"[15a] cheap kernel edge chain vs plain, {n_ch} channels x "
        f"{EDGE_STEPS} K-steps: {json.dumps(totals)}")
    return totals


def true_doppler(scn, blocks) -> dict:
    """{prn: Hz} at the centres of the given block indices: the carrier
    frequency an ideal tracker reports (-L1 d tau / dt over +-0.5 s, as
    tests/test_carrier_smoothing.py computes it)."""
    import numpy as np
    from gps_sdr_tpu_torch.config import L1_FREQ

    cfg = scn.cfg
    t = scn.t_rx0 + (np.asarray(blocks, np.float64) * cfg.ngps
                     + cfg.ngps / 2) / cfg.sample_rate
    out = {}
    for sat in scn.sats:
        tau0, _ = scn.sat_states(t - 0.5, sat)
        tau1, _ = scn.sat_states(t + 0.5, sat)
        out[sat.prn] = -(tau1 - tau0) * L1_FREQ
    return out


def parity_start(cfg, scn, block0, dev, offset: float = 0.0):
    """(states, codes, ffts, slot PRNs, found) on `dev`: the scenario's
    satellites in slots 0..5 in PRN order, each reset at its
    acquisition delay on block 0 and at its true Doppler +offset (even
    slots) or -offset (odd slots), or at its acquired frequency when
    offset is 0; the other slots empty."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import cacode, tracking
    from gps_sdr_tpu_torch.ops.acquisition import acquire_all

    truth = sorted(s.prn for s in scn.sats)
    found = acquire_all(cfg, block0, cacode.ca_fft_table(cfg), prns=truth,
                        device=dev)
    by_prn = {f[1]: f for f in found}
    if sorted(by_prn) != truth:
        raise AssertionError(f"[15] block 0 acquired {sorted(by_prn)}, "
                             f"not {truth}")
    f0 = true_doppler(scn, [0])
    st = tracking.init_channel_states(cfg, cfg.max_sat, dev)
    codes = np.zeros((cfg.max_sat, cfg.code_samples), np.float32)
    ffts = np.zeros((cfg.max_sat, cfg.code_samples), np.complex64)
    for i, prn in enumerate(truth):
        freq = (float(f0[prn][0]) + (offset if i % 2 == 0 else -offset)
                if offset else by_prn[prn][2])
        st = tracking.reset_channel(st, i, prn, freq,
                                    int(by_prn[prn][3]) % cfg.code_samples,
                                    cfg)
        codes[i] = cacode.ca_table(cfg)[prn]
        ffts[i] = cacode.ca_fft_table(cfg)[prn]
    slots = truth + [0] * (cfg.max_sat - len(truth))
    return (st, torch.as_tensor(codes, device=dev),
            torch.as_tensor(ffts, device=dev), slots, found)


def track_kernels_and_plain(cfg, start, blocks_dev, dev) -> dict:
    """One chunk from `start` through the kernels (their launches counted)
    and through the plain path on the same device: both runs' states and
    host outputs."""
    from gps_sdr_tpu_torch.ops import tracking

    st, codes, ffts = start[:3]
    _reset_launches()
    ks, ko = tracking.track_chunk_batched_impl(cfg, st, blocks_dev, 1,
                                               codes, ffts)
    _sync(dev)
    launches = _read_launches()
    with plain_path():
        ps, po = tracking.track_chunk_batched_impl(cfg, st, blocks_dev, 1,
                                                   codes, ffts)
    return dict(kernel=(ks, tracking.outs_to_numpy(ko)),
                plain=(ps, tracking.outs_to_numpy(po)), launches=launches)


def _same_lock(tag: str, run: dict) -> None:
    """The kernels' run locks on the same blocks as the plain path's."""
    import numpy as np

    (_, ko), (_, po) = run["kernel"], run["plain"]
    if not np.array_equal(ko.locked, po.locked):
        diff = np.argwhere(ko.locked != po.locked)
        raise AssertionError(f"[{tag}] kernels and plain path lock on "
                             f"other blocks: (block, slot) {diff[:8]}")


def _sliced(outs, lo: int):
    return type(outs)(*(x[lo:] for x in outs))


def run_pull_in(cfg0, scn, blocks, dev) -> dict:
    """15b: the first PULL_IN_BLOCKS blocks of phase 4's capture, every
    satellite's channel reset PULL_IN_OFFSET Hz off its true Doppler,
    at K in PULL_IN_K through each wipeoff kernel and cheap.  The bar of
    test_tracking_batched.py::test_fresh_channel_pull_in on every
    satellite: locked from block 40, within 3 Hz of the true Doppler at
    the end, the peak found on > 80% of the blocks from block 8.  The
    plain path on the card locks on the same blocks, and from block 40
    holds the kernels' run to compare_chunks."""
    import numpy as np
    import torch

    n = PULL_IN_BLOCKS
    chunk = torch.as_tensor(np.ascontiguousarray(blocks[:n]), device=dev)
    f_end = true_doppler(scn, [n - 1])
    out, launches = {}, {}
    for mxu in (True, False):
        for k in PULL_IN_K:
            cfg = cfg0.replace(blocks_per_step=k, use_mxu_wipeoff=mxu)
            tag = f"15b K={k} {'kernel 1' if mxu else 'kernel 2'}"
            start = parity_start(cfg, scn, blocks[0], dev, PULL_IN_OFFSET)
            run = track_kernels_and_plain(cfg, start, chunk, dev)
            slots, found = start[3], start[4]
            res = {}
            for side in ("kernel", "plain"):
                st, o = run[side]
                freq = st.freq.cpu().numpy()
                worst = 0.0
                for i, prn in enumerate(slots[:len(scn.sats)]):
                    df = abs(float(freq[i]) - float(f_end[prn][0]))
                    found_frac = float((o.code_phase[8:, i] >= 0).mean())
                    if not (o.locked[40:, i].all() and df < 3.0
                            and found_frac > 0.8):
                        raise AssertionError(
                            f"[{tag}] {side}: PRN {prn} locked from 40 "
                            f"{bool(o.locked[40:, i].all())}, |df| "
                            f"{df:.2f} Hz, peak on {found_frac:.2f}")
                    worst = max(worst, df)
                res[f"{side}_max_df_hz"] = worst
            _same_lock(tag, run)
            cmp = compare_chunks(tag, [(_sliced(run["kernel"][1], 40), slots,
                                        found)],
                                 [(_sliced(run["plain"][1], 40), slots,
                                   found)])
            steps = n // k
            if torch_device_type(dev) == "cuda":
                want = {"wipeoff": steps if mxu else 0,
                        "wipeoff_vpu": 0 if mxu else steps, "cheap": steps}
                if run["launches"] != want:
                    raise AssertionError(f"[{tag}] launches "
                                         f"{run['launches']} != {want}")
            first = [int(np.argmax(run["kernel"][1].locked[:, i]))
                     for i in range(len(scn.sats))]
            log(f"[{tag}]: every PRN locked from block {max(first)} "
                f"(first lock {first}), final |df| kernel "
                f"{res['kernel_max_df_hz']:.3f} / plain "
                f"{res['plain_max_df_hz']:.3f} Hz; plain path from block "
                f"40: {json.dumps(cmp)}; launches {run['launches']}")
            out[(k, mxu)] = dict(res, first_lock=first, compare=cmp)
            for name, v in run["launches"].items():
                launches[name] = launches.get(name, 0) + v
    return dict(runs=out, launches=launches)


def run_tail(cfg0, scn, blocks, dev) -> dict:
    """15c: T = 11 K + 4 blocks of phase 4's capture at K in TAIL_K from
    the acquired channels: 11 fused K-steps (kernel 1 and cheap once
    each) and a 4-block tail through track_chunk_impl (counted), locking
    as the plain path on the card does and held to it by
    compare_chunks from block 40; against the K=1 loop over the same
    blocks, test_batched_remainder_tail.py's bar: the same final lock,
    the frequency within 1 Hz, the tail's code phases within 0.2
    samples where both found the peak."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import tracking

    out, launches = {}, {}
    for k in TAIL_K:
        t = 11 * k + 4
        cfg = cfg0.replace(blocks_per_step=k)
        tag = f"15c K={k} T={t}"
        chunk = torch.as_tensor(np.ascontiguousarray(blocks[:t]), device=dev)
        start = parity_start(cfg, scn, blocks[0], dev)
        tails = []
        real = tracking.track_chunk_impl

        def counted(*args, **kw):
            tails.append(int(args[2].shape[0]))
            return real(*args, **kw)
        tracking.track_chunk_impl = counted
        try:
            run = track_kernels_and_plain(cfg, start, chunk, dev)
        finally:
            tracking.track_chunk_impl = real
        if tails != [4, 4]:
            raise AssertionError(f"[{tag}] tails through track_chunk_impl "
                                 f"{tails}, not 4 blocks on each run")
        _same_lock(tag, run)
        slots, found = start[3], start[4]
        cmp = compare_chunks(tag, [(_sliced(run["kernel"][1], 40), slots,
                                    found)],
                             [(_sliced(run["plain"][1], 40), slots, found)])
        seq_st, seq_o = tracking.track_chunk_impl(cfg, *start[:1], chunk, 1,
                                                  *start[1:3])
        seq_o = tracking.outs_to_numpy(seq_o)
        ks, ko = run["kernel"]
        if ko.code_phase.shape[0] != t or not torch.equal(
                ks.locked.cpu(), seq_st.locked.cpu()):
            raise AssertionError(f"[{tag}] final lock differs from the K=1 "
                                 "loop")
        dfreq = float((ks.freq - seq_st.freq).abs().max())
        both = (seq_o.code_phase[-4:] >= 0) & (ko.code_phase[-4:] >= 0)
        dcp = float(np.abs(seq_o.code_phase[-4:] - ko.code_phase[-4:])[
            both].max(initial=0.0))
        if dfreq > 1.0 or dcp > 0.2 or not both.any():
            raise AssertionError(f"[{tag}] against the K=1 loop: freq "
                                 f"{dfreq:.3f} Hz, tail code phase {dcp:.3f}")
        steps = (t - 4) // k
        if torch_device_type(dev) == "cuda" and run["launches"] != {
                "wipeoff": steps, "wipeoff_vpu": 0, "cheap": steps}:
            raise AssertionError(f"[{tag}] launches {run['launches']}")
        dtail = float(np.abs(ko.code_phase[-4:] - run["plain"][1].code_phase[
            -4:])[both].max(initial=0.0))
        log(f"[{tag}]: tail of 4 blocks through track_chunk_impl; plain "
            f"path from block 40: {json.dumps(cmp)}; tail code phases "
            f"kernels vs plain {dtail:.3g}, vs the K=1 loop {dcp:.3g} "
            f"samples, final freq vs K=1 {dfreq:.3g} Hz; launches "
            f"{run['launches']}")
        out[k] = dict(compare=cmp, tail_vs_plain=dtail, tail_vs_k1=dcp,
                      freq_vs_k1=dfreq)
        for name, v in run["launches"].items():
            launches[name] = launches.get(name, 0) + v
    return dict(runs=out, launches=launches)


class ScriptedUI:
    """A reporter that emits events[n] after its n-th epoch (1-based),
    counts the epochs and records close() (tests/test_session_controls.py's
    FakeUI and EventOnceUI in one)."""

    def __init__(self, events: dict):
        self.events, self.n, self.closed = events, 0, False

    def update(self, frames, summary, ev):
        self.n += 1

    def get_events(self):
        return list(self.events.get(self.n, ()))

    def close(self):
        self.closed = True


# 15d's two scripts: the controls after epoch 1 and STOP after epoch 2;
# CLOSE after epoch 1
UI_SCRIPTS = {"stop": {1: ["CLEAR", "HEIGHT", ("SET_HEIGHT", 123.0)],
                       2: ["STOP"]},
              "close": {1: ["CLOSE"]}}


def _scripted_session(cfg, dev, script: str, run):
    """A Session on `dev` with the evaluator's statistics seeded (so CLEAR
    has something to clear) and UI_SCRIPTS[script], driven by
    run(session); returns what the script must have done."""
    from gps_sdr_tpu_torch.runtime.session import Session

    ui = ScriptedUI(UI_SCRIPTS[script])
    s = Session(cfg, device=dev, reporter=ui)
    s.evaluator.positions = [[0.0, 1.0, 2.0, 3.0]]
    s.evaluator.stat = (0.0, 0.0, 1, 0)
    _reset_launches()
    run(s)
    _sync(dev)
    ev = s.evaluator
    return dict(epochs=ui.n, stopped=s.receiver._stop, closed=ui.closed,
                blocks=s.receiver.status.blocks_processed,
                k_steps=s.receiver.status.k_steps,
                cleared=ev.positions == [] and ev.stat is None,
                conf_height=ev.cfg.conf_height, height=ev.cfg.height,
                launches=_read_launches())


def run_session_controls(cfg0, scn, blocks, dev) -> dict:
    """15d: the UI controls on a Session on the card, through run_source
    (phase 4's blocks, kernel 1) and run_device_source (the scenario
    synthesized on the card, fused windows of 2 chunks, 2 windows in
    flight, kernel 2).  Each script ends the run at the epoch (and block)
    where the same Session on the CPU ends it; STOP's run cleared the
    statistics, toggled the height constraint and set the height to 123
    m; CLOSE stopped the run and closed the reporter; the kernels ran
    once a K-step of the card's runs."""
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth

    paths = {
        "run_source": (cfg0, lambda s: s.run_source(iter(blocks))),
        "run_device_source": (
            cfg0.replace(use_mxu_wipeoff=False, chunks_per_download=2,
                         download_windows_in_flight=2),
            lambda s: s.run_device_source(DeviceScenarioSynth(
                scn, noise_std=NOISE, knot_interp_step=0.1,
                device=s.device).chunk_planar, 8))}
    out, launches = {}, {}
    for path, (cfg, run) in paths.items():
        for script in UI_SCRIPTS:
            tag = f"15d {path} {script.upper()}"
            card = _scripted_session(cfg, dev, script, run)
            cpu = _scripted_session(cfg, "cpu", script, run)
            keys = ("epochs", "blocks", "stopped", "closed", "cleared",
                    "conf_height", "height")
            if any(card[key] != cpu[key] for key in keys):
                raise AssertionError(f"[{tag}] card {card} against the CPU "
                                     f"{cpu}")
            want = (dict(stopped=True, closed=False, cleared=True,
                         conf_height=True, height=123.0)
                    if script == "stop" else dict(stopped=True, closed=True))
            if any(card[key] != v for key, v in want.items()):
                raise AssertionError(f"[{tag}] {card}: not {want}")
            if torch_device_type(dev) == "cuda":
                k1 = path == "run_source"
                n = card["k_steps"]
                if card["launches"] != {"wipeoff": n if k1 else 0,
                                        "wipeoff_vpu": 0 if k1 else n,
                                        "cheap": n} or not n:
                    raise AssertionError(f"[{tag}] launches "
                                         f"{card['launches']}, K-steps {n}")
            log(f"[{tag}]: ended after epoch {card['epochs']} (block "
                f"{card['blocks']}) as on the CPU; {json.dumps(card)}")
            out[(path, script)] = card
            for name, v in card["launches"].items():
                launches[name] = launches.get(name, 0) + v
    return dict(runs=out, launches=launches)


def run_warm_start(cfg, scn, blocks, dev) -> dict:
    """15e: phase 4's capture (as phase 10 packs it) replayed cold through
    the CLI with --ephem-cache, which writes the decoded ephemerides,
    then warm from that cache: the warm run's first fix at least one
    epoch earlier, at least as many fixes, the scenario's PRNs in the
    cache; kernel 1 and cheap once a K-step of each run.  The cache
    backdated past 2 h loads empty and preloads no Session (the CPU's
    rule, tests/test_torch_parity_session.py)."""
    import tempfile

    from gps_sdr_tpu_torch.kernel_profile import HOST_SCALE
    from gps_sdr_tpu_torch.runtime import _native
    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.utils import io

    truth = sorted(s.prn for s in scn.sats)
    steps = _want_steps(cfg, len(blocks))
    epoch_s = cfg.no_sec * cfg.block_sec
    res, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cap, cache = (os.path.join(tmp, n) for n in ("cap.bin", "eph.json"))
        _native.pack_iq(HOST_SCALE * blocks).tofile(cap)
        for run in ("cold", "warm"):
            prefix = os.path.join(tmp, run)
            _reset_launches()
            rc, out = cli_run(["replay", cap, "--device", str(dev), "--ui",
                               "none", "--out", prefix, "--ephem-cache",
                               cache])
            got = _read_launches()
            _check_card_launches(f"15e {run}", got, steps, dev)
            if rc != 0 or printed_prns(out) != truth:
                raise AssertionError(f"[15e] {run} replay rc {rc}")
            pos = _positions(prefix)
            res[run] = dict(fixes=len(pos), first_fix_t=float(pos[0, 0]),
                            cached=sorted(io.load_ephemerides(cache)))
            for name, v in got.items():
                launches[name] = launches.get(name, 0) + v
        earlier = (res["cold"]["first_fix_t"] - res["warm"]["first_fix_t"]) \
            / epoch_s
        if not (res["cold"]["cached"] == truth and earlier >= 1.0
                and res["warm"]["fixes"] >= res["cold"]["fixes"]):
            raise AssertionError(f"[15e] warm start: {res}, first fix "
                                 f"{earlier:.2f} epochs earlier")
        with open(cache) as f:
            doc = json.load(f)
        doc["POSIX-Time"] = int(time.time()) - 2 * 3600 - 60
        aged = os.path.join(tmp, "aged.json")
        with open(aged, "w") as f:
            json.dump(doc, f)
        refused = Session(cfg, device=dev, ephem_cache_path=aged)
        if io.load_ephemerides(aged) != {} or \
                refused.evaluator.preloaded_ephem != {}:
            raise AssertionError("[15e] a cache older than 2 h was taken")
    log(f"[15e] cold {json.dumps(res['cold'])}; warm from the cache "
        f"{json.dumps(res['warm'])}: first fix {earlier:.2f} epochs "
        f"earlier; the cache aged 2 h 1 min refused; launches {launches}")
    return dict(res, epochs_earlier=earlier, launches=launches)


def run_parity(cfg, scn, blocks, dev) -> dict:
    """Phase 15: 15a-15e, each one's seconds logged; the launches of each
    sub-phase."""
    t0 = time.perf_counter()
    out = {}
    for key, tag, run in (
            ("edge_chain", "15a", lambda: run_edge_chain(cfg, dev)),
            ("pull_in", "15b", lambda: run_pull_in(cfg, scn, blocks, dev)),
            ("tail", "15c", lambda: run_tail(cfg, scn, blocks, dev)),
            ("session", "15d", lambda: run_session_controls(cfg, scn,
                                                            blocks, dev)),
            ("warm_start", "15e", lambda: run_warm_start(cfg, scn, blocks,
                                                         dev))):
        t1 = time.perf_counter()
        out[key] = run()
        log(f"[{tag}] took {time.perf_counter() - t1:.1f} s")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[15] phase 15 took {out['wall_s']:.1f} s")
    return out


def parity_launches(par: dict, name: str) -> dict:
    """Each phase-15 sub-phase's launches of kernel `name`."""
    return {key: par[key]["launches"][name] for key in (
        "edge_chain", "pull_in", "tail", "session", "warm_start")}


# --------------------------------------------------------------------------
# the tools slice (phase 16): gps_sdr_tpu_torch/examples' analysis tools

ROOF_K, ROOF_BLOCKS, ROOF_CHANNELS = 16, 512, 12
# the scenarios' first fixes come ~25 s in; at profile_evalhost's 32 s
# the mean of seed 5's first fixes is 9.55 m from the truth (on the CPU)
TOOLS_SEC = 40.0
EVALHOST_STREAMS = 4
SERVING_STREAMS = 8
SWEEP_BLOCKS, SWEEP_SHARDS, SWEEP_MESH = 32, (1, 2, 4), 4


def _top_functions(stats, n: int = 8) -> str:
    """The n host functions of a cProfile run with the most time of
    their own: "name (file:line) own s / cumulative s", one a line."""
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:n]
    return "\n".join(
        f"      {fn} ({os.path.basename(path)}:{line}) {tt:.3f} s own / "
        f"{ct:.3f} s cumulative, {nc} calls"
        for (path, line, fn), (_, nc, tt, ct, _) in rows)


def _run_steps(cfg, n_chunks: int) -> int:
    """K-steps of a device loop over n_chunks whole chunks (run_device,
    StreamServer: every block of every chunk is tracked)."""
    return n_chunks * (cfg.no_sec // cfg.blocks_per_step)


def run_roofline_phase(dev, blocks: int = ROOF_BLOCKS) -> dict:
    """16a: roofline.run through kernel 1 and through kernel 2; the
    report of each, by kernel name."""
    from gps_sdr_tpu_torch.examples import roofline

    on_card = torch_device_type(dev) == "cuda"
    steps = blocks // ROOF_K
    out = {}
    for name, mxu in (("wipeoff", True), ("wipeoff_vpu", False)):
        doc = roofline.run(ROOF_K, blocks, ROOF_CHANNELS, dev,
                           use_mxu_wipeoff=mxu)
        bk = doc["buckets"]
        log(f"[16a] {name} + cheap, K={ROOF_K}, {ROOF_CHANNELS} channels, "
            f"{blocks} blocks ({doc['lane']}): busy "
            f"{doc['busy_us_per_block']:.4f} µs a block of "
            f"{doc['wall_us_per_block']:.4f} µs wall "
            f"({100 * doc['busy_share_of_wall']:.1f}% busy); floor "
            f"{doc['floor_us_per_block']:.4f} µs ({doc['bound_by']}), "
            f"{doc['bytes_per_block']} B and {doc['flops_per_block']} flops "
            f"a block (JAX count {doc['flops_per_block_jax_count']}); "
            f"shares {json.dumps(doc['shares'])}; launches "
            f"{doc['launches']}")
        for b, v in bk.items():
            top = [(t["name"][:60], round(t["us_per_block"], 4))
                   for t in v["top"][:2]]
            log(f"[16a]   {b:11s} {v['us_per_block']:.4f} µs a block, "
                f"{v['launches_per_k_step']:.2f} a K-step, "
                f"{100 * v['share_of_busy']:.1f}% of busy; top {top}")
        if on_card:
            _check_launches(f"16a {name}", doc["launches"], steps, name)
            # roofline.run raised if its trace missed a kernel launch
            missing = [b for b, v in bk.items() if v["launches"] == 0]
            if missing or doc["lane"] != "device":
                raise AssertionError(f"[16a] buckets without an event: "
                                     f"{missing} (lane {doc['lane']})")
            if not doc["busy_us_per_block"] >= doc["floor_us_per_block"]:
                raise AssertionError("[16a] busy time under the floor")
        out[name] = doc
    return out


def run_probe_phase(dev, sec: float = TOOLS_SEC) -> dict:
    """16b: probe_device_loop at its defaults but --sec: the phase split,
    the fix checks, the launches."""
    from gps_sdr_tpu_torch import ReceiverConfig
    from gps_sdr_tpu_torch.examples import probe_device_loop as probe

    cfg = ReceiverConfig(chunks_per_download=8)
    scn, provider, n = probe.scenario_provider(cfg, sec, N_SATS, False, dev)
    _reset_launches()
    res = probe.probe(cfg, provider, n, 8, dev)
    launches = _read_launches()
    for line in probe.report(res).splitlines():
        log(f"[16b] {line}")
    err = _check_fix("16b", scn, res["receiver"],
                     _ev_summary(res["evaluator"]))
    _check_card_launches("16b", launches, _run_steps(cfg, n), dev)
    return dict(launches=launches, err_m=err, times=res["times"],
                wall_s=res["wall_s"], signal_s=res["signal_s"])


def run_profilers(dev, sec: float = TOOLS_SEC) -> dict:
    """16c: profile_fullloop, profile_serving and profile_evalhost on sec
    seconds of their scenarios; each one's rate, fixes, launches and top
    host functions."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch import ReceiverConfig
    from gps_sdr_tpu_torch.bench import scenario_buffer
    from gps_sdr_tpu_torch.examples import (profile_evalhost,
                                            profile_fullloop,
                                            profile_serving)

    dev = torch.device(dev)
    out = {}
    cfg = ReceiverConfig().replace(download_windows_in_flight=2)
    scn, buf, n = scenario_buffer(cfg, 3, sec, dev)
    _reset_launches()
    res = profile_fullloop.profile_fullloop(
        cfg, lambda first, m: buf[first:first + m], n, dev)
    launches = _read_launches()
    err = _check_fix("16c fullloop", scn, res["receiver"],
                     _ev_summary(res["evaluator"]))
    _check_card_launches("16c fullloop", launches, _run_steps(cfg, n), dev)
    log(f"[16c] fullloop: {res['chunks']} steady chunks, "
        f"{res['signal_s']:.1f} s in {res['wall_s']:.3f} s = "
        f"{res['rtf']:.2f}x realtime under cProfile "
        f"({1e3 * res['wall_s'] / res['chunks']:.2f} ms a chunk); "
        f"{len(res['evaluator'].positions)} fixes; launches {launches}; "
        f"top host functions:\n{_top_functions(res['stats'])}")
    out["fullloop"] = dict(launches=launches, err_m=err, rtf=res["rtf"])
    del buf

    cfg = profile_serving.serving_config(ReceiverConfig(), 2)
    scn, buf, n = scenario_buffer(cfg, 5, sec, dev)
    _reset_launches()
    res = profile_serving.profile_serving(
        cfg, lambda first, m: buf[first:first + m], n, SERVING_STREAMS,
        dev)
    launches = _read_launches()
    errs = [_check_fix(f"16c serving stream {s}", scn, rx, _ev_summary(ev))
            for s, (rx, ev) in enumerate(zip(res["server"].receivers,
                                             res["evaluators"]))]
    _check_card_launches("16c serving", launches, _run_steps(cfg, n), dev)
    log(f"[16c] serving: {SERVING_STREAMS} streams x {res['signal_s']:.1f} "
        f"s in {res['wall_s']:.3f} s = {res['rtf']:.2f}x aggregate under "
        f"cProfile; fixes "
        f"{[len(ev.positions) for ev in res['evaluators']]}; launches "
        f"{launches}; top host functions:\n{_top_functions(res['stats'])}")
    out["serving"] = dict(launches=launches, err_m=max(errs), rtf=res["rtf"])
    del buf

    cfg = ReceiverConfig()
    n = int(round(sec / (cfg.no_sec * cfg.block_sec)))
    cfg_sv = profile_evalhost.serving_config(cfg, n)
    scn, buf, n = scenario_buffer(cfg, 5, sec, dev)
    _reset_launches()
    pairs = profile_evalhost.capture(cfg_sv, lambda first, m:
                                     buf[first:first + m], n,
                                     EVALHOST_STREAMS, dev)
    launches = _read_launches()
    del buf
    _check_card_launches("16c evalhost capture", launches,
                         _run_steps(cfg_sv, n), dev)
    evs = profile_evalhost.replay(cfg_sv, pairs, EVALHOST_STREAMS)
    errs = []
    for s, ev in enumerate(evs):
        stat = ev.stat
        errs.append(float(np.linalg.norm(stat[0] - scn.rec_ecef))
                    if stat is not None else float("nan"))
        if not errs[-1] < 8.0:
            raise AssertionError(f"[16c] evalhost stream {s}: mean fix "
                                 f"{errs[-1]:.2f} m from truth (> 8 m)")
    cap = profile_evalhost.host_cap(cfg_sv, pairs, EVALHOST_STREAMS, sec, 3)
    log(f"[16c] evalhost: {len(pairs)} epochs of {EVALHOST_STREAMS} streams "
        f"x {sec:.0f} s, {cap['fixes']} fixes, mean errors "
        f"{[round(e, 3) for e in errs]} m; replay {cap['wall_s']:.4f} s => "
        f"host cap {cap['host_cap']:.1f}x aggregate realtime; capture "
        f"launches {launches}; top host functions:\n"
        f"{_top_functions(cap['stats'])}")
    out["evalhost_capture"] = dict(launches=launches, err_m=max(errs),
                                   host_cap=cap["host_cap"])
    return out


def run_sweep_phase(cfg, dev, n_blocks: int = SWEEP_BLOCKS) -> dict:
    """16d: scaling_sweep.sweep_rows at SWEEP_SHARDS on a mesh of dev
    repeated: each row logged, the exact rows held to the sequential
    scan as 11b holds it."""
    import numpy as np
    from gps_sdr_tpu_torch.examples import scaling_sweep

    case = scaling_sweep.stream_case(cfg, 4, n_blocks, dev)
    _reset_launches()
    res = scaling_sweep.sweep_rows(cfg, case, [dev] * SWEEP_MESH,
                                   SWEEP_SHARDS, warmup=4, reps=1)
    launches = _read_launches()
    ref_final, ref = res["reference"]
    for row in res["rows"]:
        log(f"[16d] {json.dumps(row)}")
        n_sh, mode = row["time_shards"], row["mode"]
        local = n_blocks // n_sh
        if row["work_scans_per_device"] != round(scaling_sweep.work_scans(
                n_sh, mode, 4, local), 3):
            raise AssertionError(f"[16d] work factor of {row}")
        if mode != "exact_rescan":
            continue
        final, got = res["tracked"][n_sh, mode]
        for name, atol in (("code_phase", 1e-4), ("freq", 1e-3)):
            np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                       getattr(ref, name).cpu().numpy(),
                                       atol=atol, err_msg=name)
        for name in ("locked", "edge_valid"):
            if not np.array_equal(getattr(got, name).cpu().numpy(),
                                  getattr(ref, name).cpu().numpy()):
                raise AssertionError(f"[16d] exact stitch at {n_sh} shards: "
                                     f"{name} differs from the sequential "
                                     "scan")
        for name in ("freq", "phase"):
            np.testing.assert_allclose(
                getattr(final, name).cpu().numpy(),
                getattr(ref_final, name).cpu().numpy(), atol=1e-3,
                err_msg=f"final {name}")
    if any(launches.values()):
        raise AssertionError(f"[16d] the K=1 scan launched {launches}")
    log(f"[16d] exact stitch = the sequential scan at {SWEEP_SHARDS} shards; "
        f"launches {launches}")
    return dict(launches=launches, rows=res["rows"])


def run_tools(cfg, dev) -> dict:
    """Phase 16: 16a-16d, each one's seconds logged."""
    t0 = time.perf_counter()
    out = {}
    for key, tag, run in (
            ("roofline", "16a", lambda: run_roofline_phase(dev)),
            ("probe", "16b", lambda: run_probe_phase(dev)),
            ("profilers", "16c", lambda: run_profilers(dev)),
            ("sweep", "16d", lambda: run_sweep_phase(cfg, dev))):
        t1 = time.perf_counter()
        out[key] = run()
        log(f"[{tag}] took {time.perf_counter() - t1:.1f} s")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[16] phase 16 took {out['wall_s']:.1f} s")
    return out


def tools_launches(tl: dict, name: str) -> dict:
    """Each phase-16 run's launches of kernel `name`."""
    prof = tl["profilers"]
    return {"roofline_kernel1": tl["roofline"]["wipeoff"]["launches"][name],
            "roofline_kernel2":
                tl["roofline"]["wipeoff_vpu"]["launches"][name],
            "probe": tl["probe"]["launches"][name],
            "fullloop": prof["fullloop"]["launches"][name],
            "serving": prof["serving"]["launches"][name],
            "evalhost_capture": prof["evalhost_capture"]["launches"][name],
            "scaling_sweep": tl["sweep"]["launches"][name]}


# --------------------------------------------------------------------------


def _kernel_entry(name, source, replaces, launches, res) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"gps_sdr_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None}


def main() -> int:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gps_sdr_tpu_torch import ReceiverConfig, nativecore
    from gps_sdr_tpu_torch.ops import _build, hopper_cheap, hopper_wipeoff

    # 0. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(card[0] if card else "nvidia-smi: no output")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda}; {name}")

    # 1. build: the kernels (nvcc) and the host core (g++), all at once
    jobs = {**_build.kernel_jobs(), **nativecore.host_jobs()}
    secs = _build.compile_libraries(jobs)
    _build.load()
    for lib_name in nativecore.HOST_SOURCES:
        nativecore.load_native_lib(lib_name)
    libs = {name: lib for name, (_, lib) in jobs.items()}
    log(f"[1] built {len(_build.ENTRIES)} kernel libraries and "
        f"{len(nativecore.HOST_SOURCES)} host libraries in {secs:.1f} s")
    for lib_path in libs.values():
        log(f"    {os.path.relpath(lib_path, ROOT)}")
        ptxas = lib_path.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "Compiling entry" in line:
                    log("      " + line.strip())

    cfg = ReceiverConfig()                       # product: 11 ch, K=8
    states, chunk, codes, ffts = make_case(cfg, cfg.max_sat, cfg.no_sec,
                                           seed=7, device=dev)

    # the tests' small configuration (cs 256, n_cyc 8, K=4, no_sec 128)
    small = cfg.replace(code_samples=256, n_cyc=8, corr_avg=4,
                        sweep_corr_avg=2, blocks_per_step=4,
                        corr_q_window_sec=2)
    small_case = make_case(small, 4, small.blocks_per_step, seed=5,
                           device=dev)

    # 2. wipeoff kernel vs plain, then crafted wipe delays
    w = check_wipeoff(cfg, states, chunk, 1, codes, ffts, timing=True)
    log(f"[2] wipeoff kernel vs plain: {json.dumps(w)}")
    for tag, c2, (st2, ch2, co2, ff2) in (
            ("product", cfg, (states, chunk, codes, ffts)),
            ("small", small, small_case)):
        cw = check_wipeoff(c2, st2, ch2, 0, co2, ff2,
                           wipe=crafted_wipe(c2, st2.prn.shape[0]))
        log(f"[2] wipeoff kernel, wipe delays 0, 1, 127, 128, cs-1, "
            f"{tag}: max abs err {cw['max_abs_err']:.3g}")

    # 3. cheap kernel vs plain, then the crafted cases
    c = check_cheap_chain(cfg, states, chunk, codes, ffts, timing=True)
    log(f"[3] cheap kernel vs plain over 8 chained steps: {json.dumps(c)}")
    for tag, c3, n3 in (("product", cfg, cfg.max_sat), ("small", small, 4)):
        cc = check_cheap_case(c3, n3, 3, dev)
        log(f"[3] cheap kernel, crafted case, {tag}: {json.dumps(cc)}")

    # 3b. the packed-IQ unpack kernel vs the table
    log(f"[3b] unpack kernel vs table: {json.dumps(check_unpack(cfg, dev))}")

    # 4. the replay slice
    sl = run_slice(cfg)

    # 5. wipeoff_vpu kernel vs plain
    v = check_wipeoff(cfg, states, chunk, 1, codes, ffts, timing=True,
                      vpu=True)
    log(f"[5] wipeoff_vpu kernel vs plain: {json.dumps(v)}")
    for tag, c5, (st5, ch5, co5, ff5) in (
            ("product", cfg, (states, chunk, codes, ffts)),
            ("small", small, small_case)):
        cv = check_wipeoff(c5, st5, ch5, 0, co5, ff5, vpu=True,
                           wipe=crafted_wipe(c5, st5.prn.shape[0]))
        log(f"[5] wipeoff_vpu kernel, wipe delays 0, 1, 127, 128, cs-1, "
            f"{tag}: max abs err {cv['max_abs_err']:.3g}")

    # 6. the device-resident slice
    ds = run_device_slice(cfg)

    # 7. the serving slice
    run_stream_axis(cfg, dev)
    sv = run_serving_slice(cfg)
    ind = run_independent_slice(cfg)

    # 8. the front-end slice
    t8 = time.perf_counter()
    run_frontend_checks(cfg, dev)
    fe = run_frontend_slice(cfg)
    cw = run_cw_slice(cfg)
    run_snapshot_phase(cfg, dev)
    run_device_synth(cfg, dev)
    log(f"[8] phase 8 took {time.perf_counter() - t8:.1f} s")

    # 9. the wideband slice
    t9 = time.perf_counter()
    wk = run_wideband_kernels(dev)
    bias = run_bias_phase(dev)
    wb = run_wideband_slice(dev)
    log(f"[9] phase 9 took {time.perf_counter() - t9:.1f} s")

    # 10. the host slice, then the cheap kernel at n_cyc 64
    t10 = time.perf_counter()
    scn, blocks = sl.pop("scn"), sl.pop("blocks")
    hs = run_host_slice(cfg, scn, blocks, build_s=secs)
    c64 = run_cheap_ncyc64(cfg, dev)
    log(f"[10] phase 10 took {time.perf_counter() - t10:.1f} s")

    # 11. the sharding slice
    t11 = time.perf_counter()
    truth = sorted(s.prn for s in scn.sats)
    with sub_phase("11a"):
        acq = run_sharded_acquisition(cfg, blocks[0], truth)
    with sub_phase("11b"):
        trk = run_sharded_tracking(cfg, scn, blocks, acq["product"])
    with sub_phase("11c"):
        ss = run_sharded_serving(cfg, sv, ind)
    with sub_phase("11d"):
        run_mesh_slice(cfg, blocks, trk, acq["product"])
    log(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s")

    # 12. the bench slice: the kernels at K=16/32, the bench, soak and
    # endurance
    t12 = time.perf_counter()
    bk = run_bench_kernels(cfg, dev)
    bn = run_bench_phase(dev)
    run_soak_phase(dev)
    run_endurance_phase(dev)
    log(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s")

    # 13. the envelope slice
    env = run_envelope(cfg, dev)

    # 14. the examples slice: synthetic_fix and the analysis notebook
    ex = run_examples(cfg, sl, blocks, dev)

    # 15. the parity slice: the card half of the JAX tests' twins
    par = run_parity(cfg, scn, blocks, dev)

    # 16. the tools slice: the analysis tools of the examples
    tl = run_tools(cfg, dev)

    # 17. the 2.4 MS/s slice: the partial column tile
    r24 = run_rate24_phase(dev)

    kernels = [
        _kernel_entry("wipeoff", "wipeoff.cu",
                      "gps_sdr_tpu/ops/pallas_kernels.py:171",
                      sl["launches"]["wipeoff"], w),
        _kernel_entry("wipeoff_vpu", "wipeoff_vpu.cu",
                      "gps_sdr_tpu/ops/pallas_kernels.py:44",
                      ds["launches"]["wipeoff_vpu"], v),
        _kernel_entry("cheap", "cheap.cu",
                      "gps_sdr_tpu/ops/pallas_cheap.py:61",
                      ds["launches"]["cheap"], c)]
    kernels[2]["launches_replay_slice"] = sl["launches"]["cheap"]
    for entry in kernels:
        entry["launches_serving"] = {
            "shared_8_streams": sv["launches"][entry["name"]],
            "independent_3_streams": ind["launches"][entry["name"]]}
        entry["launches_frontend"] = {
            "decimated_replay": fe["launches"][entry["name"]],
            "cw_excision": cw["launches"][entry["name"]]}
        entry["launches_wideband"] = {
            "bias_16msps": bias["launches"][entry["name"]],
            "closed_loop_16msps": wb["launches"][entry["name"]],
            "closed_loop_2msps": wb["narrow"]["launches"][entry["name"]]}
    wipe_range = {"code_samples": f"multiple of {hopper_wipeoff.CS_STEP} "
                                  f"from {hopper_wipeoff.TILE} to "
                                  f"{hopper_wipeoff.MAX_CS}",
                  "n_cyc": list(hopper_wipeoff.N_CYC),
                  "corr_avg_max": hopper_wipeoff.MAX_CA,
                  "channels_per_stream_max": hopper_wipeoff.MAX_CH}
    for entry in kernels[:2]:
        entry["shapes"] = wipe_range
        entry["cs2400_ch12"] = {
            key: r24[entry["name"]][key]
            for key in ("max_abs_err", "crafted_max_abs_err")}
        for n_ch in (8, 11):
            r = wk[f"{entry['name']}_cs16384_ch{n_ch}"]
            entry[f"cs16384_ch{n_ch}"] = {
                key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by")}
    for entry in kernels:
        entry["launches_sharded_serving"] = {
            "replicas_8_streams_4_groups":
                ss["replicas"]["launches"][entry["name"]],
            "independent_3_streams_3_groups":
                ss["independent"]["launches"][entry["name"]]}
    for entry in (kernels[0], kernels[2]):
        entry["launches_two_process"] = {
            "recv": hs["two_process"]["launches"][entry["name"]],
            "live": hs["live"]["launches"][entry["name"]]}
    kernels[2]["shapes"] = {
        "n_cyc": f"n_cyc + 1 <= {hopper_cheap.MAX_SLOTS} slots (8, 16, 32, "
                 "64)",
        "channels": "any (S x C in one launch)"}
    for key in ("ncyc64_ch11", "wide_ch11"):
        kernels[2][key] = {k: c64[key][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    kernels[2]["ncyc64_ch32"] = {"max_abs_err":
                                 c64["ncyc64_ch32"]["max_abs_err"]}
    launches_bench = bn["extra"]["kernel_launches"]
    for entry in kernels:
        entry["launches_bench"] = {
            extra: n[entry["name"]] for extra, n in launches_bench.items()}
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for entry, part in ((kernels[0], "wipeoff"), (kernels[2], "cheap")):
        for tag, _, _ in bench_kernel_cases(cfg):
            entry[tag] = {k: bk[tag][part][k] for k in timed}
    for tag, _, _ in bench_kernel_cases(cfg):
        kernels[1][tag] = {k: bk[tag]["wipeoff_vpu"][k] for k in timed}
    for entry in kernels[:2]:
        entry["n64_ch11"] = {k: bk["n64_ch11"][entry["name"]][k]
                             for k in timed}
    for entry in kernels:
        entry["launches_envelope"] = envelope_launches(env, entry["name"])
        entry["launches_examples"] = examples_launches(ex, entry["name"])
        entry["launches_parity"] = parity_launches(par, entry["name"])
        entry["launches_tools"] = tools_launches(tl, entry["name"])
    log(f"[end] chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
