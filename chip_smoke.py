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
     bit edge dropped by the transport.
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
    """n_ch simulated satellites and a tracking state aligned with them."""
    import numpy as np
    from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits

    rng = np.random.default_rng(seed)
    prns = rng.choice(np.arange(cfg.prn_min, cfg.prn_max + 1), n_ch,
                      replace=False)
    return [SatSignal(prn=int(p),
                      doppler=float(rng.uniform(-4500, 4500)),
                      code_delay=float(rng.uniform(0, cfg.code_samples)),
                      amplitude=float(rng.uniform(0.3, 1.0)),
                      carrier_phase=float(rng.uniform(0, 6.28)),
                      nav_bits=random_bits(256, seed=int(p)))
            for p in prns]


def make_case(cfg, n_ch, n_blocks, seed, device):
    """(states, chunk, codes, code_ffts) on `device`: n_ch channels set
    to the Doppler and code delay of n_ch simulated satellites of an
    n_blocks chunk."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch.models.simulator import synth_stream
    from gps_sdr_tpu_torch.ops import cacode, tracking

    sats = _channels(cfg, n_ch, seed)
    chunk = synth_stream(cfg, sats, n_blocks, noise_std=0.5, seed=seed)
    st = tracking.init_channel_states(cfg, n_ch, device)
    for i, s in enumerate(sats):
        st = tracking.reset_channel(st, i, s.prn, s.doppler,
                                    int(s.code_delay) % cfg.code_samples,
                                    cfg)
    codes = np.stack([cacode.ca_table(cfg)[s.prn] for s in sats])
    ffts = np.stack([cacode.ca_fft_table(cfg)[s.prn] for s in sats])
    return (st, torch.as_tensor(chunk, device=device),
            torch.as_tensor(codes, device=device),
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
    """Wipeoff delays i32[n_ch, K] cycling through 0, 1, 127, 128 and
    cs - 1: the head mask and the code roll on both sides of a 128-column
    tile edge and at both ends of the code period."""
    import torch

    cs, k = cfg.code_samples, cfg.blocks_per_step
    vals = torch.tensor([0, 1, 127, 128, cs - 1], dtype=torch.int32)
    return vals[torch.arange(n_ch * k).reshape(n_ch, k) % len(vals)]


def check_wipeoff(cfg, states, chunk, step, codes, code_ffts,
                  timing: bool = False, vpu: bool = False,
                  wipe=None) -> dict:
    """A wipeoff kernel vs its plain version on the same CUDA inputs:
    mix_wipeoff on the complex chunk, or with vpu=True mix_wipeoff_vpu
    on the chunk in the grouped planar layout; `wipe` overrides the
    predicted wipeoff delays.  Tolerances:
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
    args = (cfg, k, s, snp, states.phase, wipe, chunk, step, codes)
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


def _compare_cheap(got, want) -> float:
    """CheapOut kernel vs plain.  Tolerances: amplitude rtol 1e-3,
    corr_q/corr_l atol 1e-6, float state atol 1e-3 (carry_sum 1e-4 of
    its scale), df ring atol 1e-5; signs, locks, edges, counters and
    rings exact.  Returns the largest absolute float error."""
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
    close("df_buf", atol=1e-5)
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
        worst = max(worst, _compare_cheap(got, want))
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
    worst = _compare_cheap(got, want)
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
    from gps_sdr_tpu_torch.ops import _build

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

    cheap = _kernel_entry("cheap", "cheap.cu",
                          "gps_sdr_tpu/ops/pallas_cheap.py:61",
                          ds["launches"]["cheap"], c)
    cheap["launches_replay_slice"] = sl["launches"]["cheap"]
    log(json.dumps({"kernels": [
        _kernel_entry("wipeoff", "wipeoff.cu",
                      "gps_sdr_tpu/ops/pallas_kernels.py:171",
                      sl["launches"]["wipeoff"], w),
        _kernel_entry("wipeoff_vpu", "wipeoff_vpu.cu",
                      "gps_sdr_tpu/ops/pallas_kernels.py:44",
                      ds["launches"]["wipeoff_vpu"], v),
        cheap]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
