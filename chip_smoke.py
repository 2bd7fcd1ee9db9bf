#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gps_sdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and the script exits non-zero):
  0. device: CUDA must be available; prints the card's name and power
     limit (nvidia-smi);
  1. build: compiles the port's CUDA kernels from the repository's
     sources (one nvcc per source, all at once, sm_90a) and prints the
     seconds taken;
  2. the wipeoff kernel (csrc/wipeoff.cu) against its plain PyTorch
     version on the card, at the product shapes (11 channels, K=8, one
     32-block chunk), then with wipe delays 0, 1, 127, 128 and cs - 1 at
     the product and the tests' small configuration;
  3. the cheap-stage kernel against its plain version on the card, at
     the product shapes: 8 chained K-steps, one from a full wrapped
     correlation ring, one with ms_time past 2^24; then the crafted case
     (cheap_case) at the product and the small configuration, with the
     kernel's input state checked unchanged;
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
        test_multipath's 60 m bar.
The line before the last holds the kernels' launches, errors, times and
bounds as JSON; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SLICE_SEC = 40.0
N_SATS, SEED, NOISE = 6, 3, 0.5
CHEAP_STEPS = 8                 # chained K-steps of the cheap-kernel check
# one NVIDIA H100 SXM at its 700 W limit (data sheet): device memory
# rate and the f32 rate outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12


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
    over the memory rate and the f32 operations over the f32 rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = n_ops / H100_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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


def check_cheap_chain(cfg, states, chunk, codes, code_ffts,
                      timing: bool = False) -> dict:
    """CHEAP_STEPS chained K-steps; at each, the cheap kernel and its plain
    version take the same erased state and heavy result, and the chain
    advances on the plain result.  Step 2 starts from a full, wrapped
    correlation ring and df ring; step 5 from ms_time = 2^25 + 3."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import hopper_cheap, tracking

    k = cfg.blocks_per_step
    n_ch = states.prn.shape[0]
    steps_per_chunk = chunk.shape[0] // k
    hist, no_sec = cfg.corr_hist_len, cfg.no_sec
    rng = np.random.default_rng(11)
    dev = chunk.device
    st = states
    worst, n_edges, ms_checked = 0.0, 0, False
    times = {}
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
        args = (cfg, k, heavy.head_k, heavy.seg_sums_k, heavy.delay_k,
                heavy.wipe_delay, erased)
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
        st, _ = tracking.channel_step_k(cfg, k, st, heavy, sno)
    if not ms_checked:
        raise AssertionError("ms_time > 2^24 case counted no ms")
    return dict(max_abs_err=worst, edges=n_edges, **times)


def cheap_case(cfg, n_ch, seed, device):
    """A crafted cheap-kernel case made with numpy from `seed`: the
    arguments of cheap_scan (cfg, K, head, seg, delay, wipe, state) on
    `device`, and what the case holds (`facts`).

    The per-ms means are designed after the retune rotation (the raw
    sums are the designed means rotated forward by the angle the plain
    version applies, found by running it on the blocks before): unit
    means with sign flips forced into the last two slots (31 and 32 at
    the product's n_cyc), or, in odd blocks of locked channels, phases
    alternating across +-pi/2 (a PLL unwrap step at every slot); wipe
    delays 0 and cs - 1 in every channel (slot compaction when the
    carry is empty, the full n_cyc + 1 slots after a cs - 1 block);
    channels 0, 3, 6, 9 start unlocked with a 0.2 rad offset that
    vanishes from block 2, so they lock inside the step; full, wrapped
    correlation and df rings; ms_time past 2^24 in even channels."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.ops import hopper_cheap, tracking

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

    seq = np.resize([0, 0, cs - 1, 0, cs // 2, cs - 1, 1, 0], k)
    wipe = np.stack([np.roll(seq, c) for c in ch]).astype(np.int32)
    delay = np.where(rng.random((n_ch, k)) < 0.3, -1,
                     rng.integers(0, cs, (n_ch, k))).astype(np.int32)
    head = torch.zeros((n_ch, k), dtype=torch.complex64)
    seg = torch.zeros((n_ch, k, n_cyc), dtype=torch.complex64)
    wipe_t, delay_t = torch.from_numpy(wipe), torch.from_numpy(delay)
    c_cnt, c_sum = st.carry_cnt.numpy(), st.carry_sum.numpy()
    n_compact = n_jump_blocks = 0
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
        # the plain version's retune angle for this block
        if b:
            prior = hopper_cheap.cheap_scan_plain(
                cfg, b, head[:, :b], seg[:, :b], delay_t[:, :b],
                wipe_t[:, :b], st)
            dphi, df_sum = prior.dphi, prior.df_sum
        else:
            dphi = df_sum = torch.zeros(n_ch)
        w = wipe[:, b]
        starts = np.concatenate(
            [-c_cnt[:, None], w[:, None] + cs * np.arange(n_cyc)], axis=1)
        t_m = (torch.from_numpy(starts.astype(np.float32)) + 0.5 * cs) \
            / cfg.sample_rate
        ang = dphi[:, None] + hopper_cheap.TWO_PI * df_sum[:, None] * t_m
        raw = want * torch.complex(torch.cos(ang), torch.sin(ang))
        seg[:, b] = raw[:, 1:] * cs
        cnt0 = c_cnt + w
        n_compact += int((cnt0 == 0).sum())
        head[:, b] = torch.where(
            torch.from_numpy(cnt0 > 0),
            raw[:, 0] * torch.from_numpy(np.maximum(cnt0, 1).astype(
                np.float32)) - torch.from_numpy(c_sum), 0)
        c_sum = np.where(w > 0, seg[:, b, n_cyc - 1].numpy(), 0).astype(
            np.complex64)
        c_cnt = np.where(w > 0, cs - w, 0)
    st = tracking.ChannelState(*(v.to(device) for v in st))
    facts = dict(compacted_blocks=n_compact, jump_blocks=n_jump_blocks,
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
    if not (facts["compacted_blocks"] and facts["jump_blocks"]
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
                rtf=SLICE_SEC / wall, fixes=summary["n_positions"])


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


def serve(cfg, n_streams, providers, n_chunks, keep_epochs=()):
    """Drive a StreamServer on the card as `python -m gps_sdr_tpu_torch
    serve` does (process_many over each round of streams); returns
    (server, evaluators, wall s, {stream: epochs} for keep_epochs,
    acquisition grids run)."""
    import torch
    from gps_sdr_tpu_torch.runtime import receiver as receiver_mod
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator, process_many
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    srv = StreamServer(cfg, n_streams, device="cuda")
    evs = [Evaluator(cfg) for _ in range(n_streams)]
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


def _check_streams(tag, scns, srv, evs, launches, wall, sig_sec, name):
    """Phase 7b/7c checks common to both: every stream's PRNs, ephemerides
    and fix (_check_fix), no dropped edge, and one launch of `name` and
    of cheap per K-step of one stream."""
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
    if not (launches[name] == launches["cheap"] == k_steps
            and launches[other] == 0 and k_steps > 0):
        raise AssertionError(f"launches {launches}: want one {name} and one "
                             f"cheap launch per K-step of one stream "
                             f"({k_steps}) and no {other}")
    return errs


def run_serving_slice(base_cfg, n_streams: int = 8) -> dict:
    """Phase 7b: n_streams replicas of phase 6's scenario, synthesized on
    the card, through StreamServer with the CLI's serve settings."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    cfg = base_cfg.replace(chunks_per_download=16,
                           download_windows_in_flight=4,
                           defer_subframe_poll=True, epoch_per_window=True)
    scn = make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                        duration_sec=SLICE_SEC + 12.0)
    synth = DeviceScenarioSynth(scn, noise_std=NOISE, knot_interp_step=0.1,
                                device="cuda")
    t = cfg.no_sec
    n_chunks = int(round(SLICE_SEC / cfg.block_sec)) // t
    sig_sec = n_chunks * t * cfg.block_sec
    srv, evs, wall, kept, grids = serve(cfg, n_streams, synth.chunk_planar,
                                        n_chunks, keep_epochs=(0,))
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
                cp_err_vs_single=cp_err, subframes=len(fr_s))


def run_independent_slice(base_cfg, seeds=(3, 5, 7)) -> dict:
    """Phase 7c: one scenario a stream (independent front ends), kernel
    2 on the stacked windows."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth

    cfg = base_cfg.replace(use_mxu_wipeoff=False, chunks_per_download=8,
                           download_windows_in_flight=4,
                           defer_subframe_poll=True, epoch_per_window=True)
    scns = [make_scenario(cfg, n_sats=N_SATS, seed=sd,
                          duration_sec=SLICE_SEC + 12.0) for sd in seeds]
    synths = [DeviceScenarioSynth(sc, noise_std=NOISE, knot_interp_step=0.1,
                                  device="cuda") for sc in scns]
    t = cfg.no_sec
    n_chunks = int(round(SLICE_SEC / cfg.block_sec)) // t
    sig_sec = n_chunks * t * cfg.block_sec
    srv, evs, wall, _, grids = serve(cfg, len(seeds),
                                     [sy.chunk_planar for sy in synths],
                                     n_chunks)
    launches = _read_launches()
    errs = _check_streams("7c", scns, srv, evs, launches, wall, sig_sec,
                          "wipeoff_vpu")
    prns = [sorted(f[1] for f in rx.found_sats) for rx in srv.receivers]
    if len({tuple(p) for p in prns}) < 2:
        raise AssertionError(f"independent streams acquired the same PRNs "
                             f"{prns}")
    log(f"[7c] PRNs by stream {prns}; acquisition grids run: {grids}")
    return dict(launches=launches, err_m=errs, wall_s=wall,
                rtf=len(seeds) * sig_sec / wall, perf=dict(srv.perf))


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


def _kernel_entry(name, source, replaces, launches, res) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"gps_sdr_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gps_sdr_tpu_torch import ReceiverConfig
    from gps_sdr_tpu_torch.ops import _build, hopper_wipeoff

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

    # 1. build
    libs, secs = _build.build()
    _build.load()
    log(f"[1] built {len(libs)} kernel libraries in {secs:.1f} s")
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
    wipe_range = {"code_samples": f"multiple of {hopper_wipeoff.TILE} up to "
                                  f"{hopper_wipeoff.MAX_CS}",
                  "n_cyc": list(hopper_wipeoff.N_CYC),
                  "corr_avg_max": hopper_wipeoff.MAX_CA,
                  "channels_per_stream_max": hopper_wipeoff.MAX_CH}
    for entry in kernels[:2]:
        entry["shapes"] = wipe_range
        for n_ch in (8, 11):
            r = wk[f"{entry['name']}_cs16384_ch{n_ch}"]
            entry[f"cs16384_ch{n_ch}"] = {
                key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by")}
    kernels[2]["shapes"] = {"n_cyc": "n_cyc + 1 <= 64 slots (8, 16, 32)",
                            "channels": "any (S x C in one launch)"}
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
