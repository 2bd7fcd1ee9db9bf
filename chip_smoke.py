#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gps_sdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and the script exits non-zero):
  0. device: CUDA must be available; prints the card's name and power
     limit (nvidia-smi);
  1. build: compiles the port's CUDA kernels from the repository's
     sources (nvcc, sm_90a) and prints the seconds taken;
  2. the wipeoff kernel against its plain PyTorch version on the card,
     at the product shapes (11 channels, K=8, one 32-block chunk);
  3. the cheap-stage kernel against its plain version on the card, at
     the product shapes: 8 chained K-steps, one from a full wrapped
     correlation ring, one with ms_time past 2^24;
  4. the replay slice: the examples/synthetic_fix.py default scenario
     (6 satellites, seed 3, noise 0.5, 40 s of IQ) through the port's
     Session on the card; both kernels must have run on every K-step, the
     acquired PRNs must be the scenario's, at least 4 ephemerides must
     decode and the mean fix must be within 8 m of the truth.
The line before the last holds the kernels' launches, errors and times
as JSON; the last line is {"ok": true, "device": {...}}.
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
SYNTH_WORKERS = 8               # threads synthesizing the slice's IQ


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# kernel-vs-plain cases (also used by tests/test_torch_cuda.py)


def _channels(cfg, n_ch, seed):
    """n_ch simulated satellites and a tracking state aligned with them."""
    import numpy as np
    from gps_sdr_tpu_torch import host

    rng = np.random.default_rng(seed)
    prns = rng.choice(np.arange(cfg.prn_min, cfg.prn_max + 1), n_ch,
                      replace=False)
    return [host.SatSignal(prn=int(p),
                           doppler=float(rng.uniform(-4500, 4500)),
                           code_delay=float(rng.uniform(0, cfg.code_samples)),
                           amplitude=float(rng.uniform(0.3, 1.0)),
                           carrier_phase=float(rng.uniform(0, 6.28)),
                           nav_bits=host.random_bits(256, seed=int(p)))
            for p in prns]


def make_case(cfg, n_ch, n_blocks, seed, device):
    """(states, chunk, codes, code_ffts) on `device`: n_ch channels set
    to the Doppler and code delay of n_ch simulated satellites of an
    n_blocks chunk."""
    import numpy as np
    import torch
    from gps_sdr_tpu_torch import host
    from gps_sdr_tpu_torch.ops import tracking

    sats = _channels(cfg, n_ch, seed)
    chunk = host.synth_stream(cfg, sats, n_blocks, noise_std=0.5, seed=seed)
    st = tracking.init_channel_states(cfg, n_ch, device)
    for i, s in enumerate(sats):
        st = tracking.reset_channel(st, i, s.prn, s.doppler,
                                    int(s.code_delay) % cfg.code_samples,
                                    cfg)
    codes = np.stack([host.ca_table(cfg)[s.prn] for s in sats])
    ffts = np.stack([host.ca_fft_table(cfg)[s.prn] for s in sats])
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


def check_wipeoff(cfg, states, chunk, step, codes, code_ffts,
                  timing: bool = False) -> dict:
    """Wipeoff kernel vs plain on the same CUDA inputs.  Tolerances:
    head/seg/center max abs error <= 1e-4 of the largest magnitude
    (f32 sums over 2048 samples in another order), and on the derived
    correlation delay exact, code_phase atol 5e-3, norm_max rtol 2e-3."""
    import math

    import torch
    from gps_sdr_tpu_torch.ops import corr, hopper_wipeoff, tracking

    k = cfg.blocks_per_step
    s = 2.0 * math.pi * states.freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2.0 * math.pi)
    wipe = tracking.predict_wipe_delays(cfg, k, states.freq, states.delay)
    args = (cfg, k, s, snp, states.phase, wipe, chunk, step, codes)
    got = hopper_wipeoff.mix_wipeoff(*args)
    want = hopper_wipeoff.mix_wipeoff_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("center", "head", "seg"), got, want):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        errs[name] = err
        if not err <= 1e-4 * scale:
            raise AssertionError(f"wipeoff {name}: max err {err:.3g} > "
                                 f"1e-4 x {scale:.3g}")
    spec = corr.prep_spec(code_ffts)
    dg, cg, ng = corr.corr_peaks(got[0], spec, cfg.corr_min)
    dw, cw, nw = corr.corr_peaks(want[0], spec, cfg.corr_min)
    if not torch.equal(dg, dw):
        raise AssertionError(f"wipeoff: correlator delays differ "
                             f"{dg.tolist()} vs {dw.tolist()}")
    if not (dw >= 0).any():
        raise AssertionError("wipeoff case found no correlation peak")
    cp_err = float((cg - cw).abs().max())
    nm_err = float(((ng - nw).abs() / nw.abs()).max())
    if not (cp_err <= 5e-3 and nm_err <= 2e-3):
        raise AssertionError(f"wipeoff: code_phase err {cp_err:.3g}, "
                             f"norm_max rel err {nm_err:.3g}")
    errs.update(code_phase=cp_err, norm_max_rel=nm_err,
                max_abs_err=max(errs["center"], errs["head"], errs["seg"]))
    if timing:
        errs["ms"] = time_ms(lambda: hopper_wipeoff.mix_wipeoff(*args))
        errs["plain_ms"] = time_ms(
            lambda: hopper_wipeoff.mix_wipeoff_plain(*args))
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
        st, _ = tracking.channel_step_k(cfg, k, st, heavy, sno)
    if not ms_checked:
        raise AssertionError("ms_time > 2^24 case counted no ms")
    return dict(max_abs_err=worst, edges=n_edges, **times)


# --------------------------------------------------------------------------
# the slice


def _synth_part(scn, first, n):
    from gps_sdr_tpu_torch import host
    return host.synth_scenario_blocks(scn, first, n, noise_std=NOISE)


def synth_iq(scn, n_blocks: int, step: int):
    """The scenario's IQ, synthesized in parallel threads (the synthesis
    is numpy over whole arrays, which releases the GIL).  Threads, not
    worker processes, so that the script starts no process that could
    outlive it."""
    import concurrent.futures as cf

    import numpy as np

    firsts = list(range(0, n_blocks, step))
    workers = max(1, min(SYNTH_WORKERS, os.cpu_count() or 1, len(firsts)))
    with cf.ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(_synth_part, [scn] * len(firsts), firsts,
                            [min(step, n_blocks - f) for f in firsts]))
    return np.concatenate(parts)


def run_slice(cfg) -> dict:
    import numpy as np
    import torch
    from gps_sdr_tpu_torch import host
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff
    from gps_sdr_tpu_torch.runtime.session import Session

    scn = host.make_scenario(cfg, n_sats=N_SATS, seed=SEED,
                             duration_sec=SLICE_SEC + 12.0)
    n_blocks = int(round(SLICE_SEC / cfg.block_sec))
    t0 = time.perf_counter()
    blocks = synth_iq(scn, n_blocks, 4 * cfg.no_sec)
    log(f"[4] synthesized {n_blocks} blocks ({SLICE_SEC:.0f} s) in "
        f"{time.perf_counter() - t0:.1f} s")

    session = Session(cfg, device="cuda")
    hopper_wipeoff.mix_wipeoff.launches = 0
    hopper_cheap.cheap_scan.launches = 0
    t0 = time.perf_counter()
    summary = session.run_source(iter(blocks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"wipeoff": hopper_wipeoff.mix_wipeoff.launches,
                "cheap": hopper_cheap.cheap_scan.launches}

    rx = session.receiver
    t, k = cfg.no_sec, cfg.blocks_per_step
    tracked = n_blocks - 1                          # block 0: cold sweep
    want_steps = (tracked // t) * (t // k) + (tracked % t) // k
    found = sorted(f[1] for f in rx.found_sats)
    truth = sorted(s.prn for s in scn.sats)
    ephs = sorted(summary["ephemerides"])
    stat = summary["stat"]
    err = (float(np.linalg.norm(stat[0] - scn.rec_ecef))
           if stat is not None else float("nan"))
    log(f"[4] acquired PRNs {found}; ephemerides {ephs}; "
        f"fixes {summary['n_positions']} (failures "
        f"{summary['n_fix_failures']}, outliers {summary['n_outliers']})")
    log(f"[4] mean fix error vs truth {err:.3f} m; wall {wall:.3f} s for "
        f"{SLICE_SEC:.0f} s of IQ = {SLICE_SEC / wall:.2f}x realtime; "
        f"K-steps {want_steps}, launches {launches}")
    if found != truth:
        raise AssertionError(f"acquired PRNs {found} != scenario {truth}")
    if len(ephs) < 4:
        raise AssertionError(f"only {len(ephs)} ephemerides decoded")
    if not err < 8.0:                       # also false for NaN / no fix
        raise AssertionError(f"mean fix {err:.2f} m from truth (> 8 m)")
    if not (launches["wipeoff"] == launches["cheap"] == want_steps
            == rx.status.k_steps):
        raise AssertionError(f"kernel launches {launches} != K-steps "
                             f"{want_steps} (receiver {rx.status.k_steps})")
    return dict(launches=launches, err_m=err, wall_s=wall,
                rtf=SLICE_SEC / wall, fixes=summary["n_positions"])


# --------------------------------------------------------------------------


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
    lib_path, secs = _build.build()
    _build.load()
    log(f"[1] built {os.path.relpath(lib_path, ROOT)} in {secs:.1f} s")
    ptxas = lib_path.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                log("    " + line.strip())

    cfg = ReceiverConfig()                       # product: 11 ch, K=8
    states, chunk, codes, ffts = make_case(cfg, cfg.max_sat, cfg.no_sec,
                                           seed=7, device=dev)

    # 2. wipeoff kernel vs plain
    w = check_wipeoff(cfg, states, chunk, 1, codes, ffts, timing=True)
    log(f"[2] wipeoff kernel vs plain: {json.dumps(w)}")

    # 3. cheap kernel vs plain
    c = check_cheap_chain(cfg, states, chunk, codes, ffts, timing=True)
    log(f"[3] cheap kernel vs plain over 8 chained steps: {json.dumps(c)}")

    # 4. the slice
    sl = run_slice(cfg)

    log(json.dumps({"kernels": [
        {"name": "wipeoff", "route": "cuda",
         "source": "gps_sdr_tpu_torch/csrc/wipeoff.cu",
         "replaces": "gps_sdr_tpu/ops/pallas_kernels.py:171",
         "launches": sl["launches"]["wipeoff"],
         "max_abs_err": w["max_abs_err"], "ms": w["ms"],
         "plain_ms": w["plain_ms"]},
        {"name": "cheap", "route": "cuda",
         "source": "gps_sdr_tpu_torch/csrc/cheap.cu",
         "replaces": "gps_sdr_tpu/ops/pallas_cheap.py:61",
         "launches": sl["launches"]["cheap"],
         "max_abs_err": c["max_abs_err"], "ms": c["ms"],
         "plain_ms": c["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
