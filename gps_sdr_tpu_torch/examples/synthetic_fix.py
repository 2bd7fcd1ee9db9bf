"""Full-stack demo of the port: physical scenario -> IQ -> receiver ->
position fix.

    python -m gps_sdr_tpu_torch.examples.synthetic_fix [--sec 40]
        [--sats 6] [--noise 0.5] [--seed 3] [--device cuda|cpu] [--cpu]
        [--device-synth] [--on-device] [--chunk-sec S] [--osc-ppm P]
        [--osc-ppm-rate R] [--carrier-smoothing N] [--iono] [--tropo]
        [--moving E,N] [--track-filter Q] [--fault-us US] [--quiet]

Port of examples/synthetic_fix.py, with its flags and defaults, its
printed report and its exit codes: it synthesizes a physically
consistent multi-satellite GPS L1 signal (models/scenario.py), runs the
whole receiver through the port's Session (cold-start acquisition,
tracking, bit sync, subframe decode, ephemerides, pseudoranges, fixes)
and judges the mean fix against the scenario's truth: PASS (exit 0)
below 8 m, else FAIL (exit 1); no fix exits 1.  A moving receiver
(--moving) is judged on its trajectory (median error below 15 m) and
its Doppler velocity (within 1 m/s).

The receiver runs on --device (default cuda; --cpu means --device cpu
and runs the kernels' plain PyTorch versions); asking for CUDA where
there is none raises.  The host IQ comes from the float64 numpy oracle,
cached under .synth_cache/ at the repository's root with the JAX
example's key, so both examples read the same bytes; --device-synth
synthesizes it on the device instead (models/scenario_dev.py), and
--on-device keeps it there: the IQ never crosses to the host.

The functions parse_args, build, run and main drive it from Python:
run(args, blocks) takes IQ blocks already in hand (the host path) and
returns the report's values.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(ROOT, ".synth_cache")
SYNTH_WORKERS = 4       # host synthesis threads (each holds ~1 GB)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_tpu_torch.examples.synthetic_fix",
        description=__doc__.split("\n")[0])
    ap.add_argument("--sec", type=float, default=40.0,
                    help="signal duration in seconds")
    ap.add_argument("--sats", type=int, default=6)
    ap.add_argument("--noise", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu by name")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device-synth", action="store_true",
                    help="synthesize the IQ on the device "
                         "(models/scenario_dev.py) instead of the "
                         "float64 numpy oracle")
    ap.add_argument("--on-device", action="store_true",
                    help="fully device-resident pipeline: the IQ never "
                         "crosses to the host (implies --device-synth)")
    ap.add_argument("--chunk-sec", type=float, default=None,
                    help="on-device chunk length in seconds (default "
                         "~1 s, the reference's reporting cadence)")
    ap.add_argument("--osc-ppm", type=float, default=0.0,
                    help="receiver TCXO fractional offset in ppm (common "
                         "Doppler offset + sample-clock skew; widens "
                         "the search band and enables the clock-rate "
                         "solver)")
    ap.add_argument("--osc-ppm-rate", type=float, default=0.0,
                    help="TCXO drift in ppm/s (1.65e-3 ~ 2.6 Hz/s "
                         "at L1)")
    ap.add_argument("--carrier-smoothing", type=int, default=0,
                    metavar="N",
                    help="Hatch-filter window in blocks (0 = off): "
                         "carrier-smoothed pseudoranges")
    ap.add_argument("--iono", action="store_true",
                    help="inject Klobuchar ionospheric delays (and "
                         "broadcast the page-18 coefficients) AND "
                         "enable the receiver's correction")
    ap.add_argument("--tropo", action="store_true",
                    help="inject tropospheric delays AND enable the "
                         "receiver's Saastamoinen correction")
    ap.add_argument("--moving", default=None, metavar="E,N",
                    help="move the receiver at this constant east,"
                         "north velocity [m/s]; reports the Doppler "
                         "velocity solve and trajectory error")
    ap.add_argument("--track-filter", type=float, default=0.0,
                    metavar="Q",
                    help="enable the position/velocity Kalman track "
                         "filter (process noise Q m/s^2)")
    ap.add_argument("--fault-us", type=float, default=0.0,
                    metavar="US",
                    help="inject an SV-clock fault of this many "
                         "microseconds on one satellite (~300 m/us) "
                         "and enable RAIM fault exclusion")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-second status table")
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def _velocity(args):
    if not args.moving:
        return None
    e, n = (float(v) for v in args.moving.split(","))
    return (e, n, 0.0)


def build(args):
    """(config, scenario) of the flags, as the JAX example builds them;
    prints the scenario line (and the injected fault)."""
    from gps_sdr_tpu_torch.config import L1_FREQ, ReceiverConfig
    from gps_sdr_tpu_torch.models.scenario import make_scenario

    cfg = ReceiverConfig(carrier_smoothing=args.carrier_smoothing,
                         iono_corr=args.iono, tropo_corr=args.tropo,
                         track_filter_q=args.track_filter,
                         raim=args.fault_us != 0.0)
    if args.osc_ppm or args.osc_ppm_rate:
        # an uncorrected TCXO shifts every Doppler by ~ -ppm*1575.42 Hz
        # in common: widen the search band around the shifted center and
        # solve the matching sample-clock skew in the fix
        f_off = -1e-6 * args.osc_ppm * L1_FREQ
        cfg = cfg.replace(min_freq=round(f_off - 5000., -2),
                          max_freq=round(f_off + 5000., -2),
                          solve_clock_rate=True)
    n_blocks = int(round(args.sec / cfg.block_sec))
    print(f"synthesizing scenario: {args.sats} sats, {args.sec:.0f} s "
          f"({n_blocks} blocks), noise={args.noise}")
    scn = make_scenario(cfg, n_sats=args.sats, seed=args.seed,
                        duration_sec=args.sec + 12.0,
                        osc_ppm=args.osc_ppm,
                        osc_ppm_rate=args.osc_ppm_rate,
                        iono=args.iono, tropo=args.tropo,
                        rec_vel_enu=_velocity(args))
    if args.fault_us:
        scn.sats[1].fault_dtsv = args.fault_us * 1e-6
        print(f"injected {args.fault_us} us SV-clock fault on "
              f"PRN {scn.sats[1].prn}")
    return cfg, scn


def cache_path(args) -> str:
    """The host IQ's file under .synth_cache/: the JAX example's key."""
    tag = (f"_{args.osc_ppm}_{args.osc_ppm_rate}"
           if (args.osc_ppm or args.osc_ppm_rate) else "")
    if args.iono or args.tropo:
        tag += f"_atm{int(args.iono)}{int(args.tropo)}"
    vel = _velocity(args)
    if vel is not None:
        tag += f"_v{vel[0]}_{vel[1]}"
    if args.fault_us:
        tag += f"_f{args.fault_us}"
    key = hashlib.sha1(
        f"scn_{args.sats}_{args.sec}_{args.noise}_{args.seed}{tag}_v3"
        .encode()).hexdigest()[:16]
    return os.path.join(CACHE_DIR, f"{key}.npy")


def cached(path: str, build) -> np.ndarray:
    """The array saved at `path`, else build()'s, saved there first
    (through a temporary file, so a reader never sees a partial one)."""
    if os.path.exists(path):
        return np.load(path)
    arr = build()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)
    return arr


def host_blocks(args, cfg, scn, device) -> np.ndarray:
    """The IQ as complex64 [n_blocks, ngps] on the host: synthesized on
    `device` (--device-synth), else the cached oracle's, else the
    oracle's written to the cache."""
    n_blocks = int(round(args.sec / cfg.block_sec))
    step = 4 * cfg.no_sec
    t0 = time.time()
    if args.device_synth:
        from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
        dev = DeviceScenarioSynth(scn, noise_std=args.noise, device=device)
        blocks = np.concatenate([
            dev.chunk(first, min(step, n_blocks - first)).cpu().numpy()
            for first in range(0, n_blocks, step)])
    else:
        from gps_sdr_tpu_torch.kernel_profile import synth_iq
        path = cache_path(args)
        if os.path.exists(path):
            print(f"loaded cached IQ from {path}")
        blocks = cached(path, lambda: synth_iq(
            scn, n_blocks, step, workers=SYNTH_WORKERS, noise_std=args.noise))
    print(f"IQ ready in {time.time() - t0:.1f} s")
    return blocks


def run(args, blocks=None) -> dict:
    """Run the example; prints the report and returns its values (`ok`
    is the verdict).  `blocks`, IQ already synthesized for these flags,
    skips the host synthesis (not with --on-device)."""
    import torch

    from gps_sdr_tpu_torch.device import resolve_device
    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.ui.headless import HeadlessReporter

    device = resolve_device(args.device)
    cfg, scn = build(args)
    reporter = None if args.quiet else HeadlessReporter()
    session = Session(cfg, device=device, reporter=reporter)
    if args.on_device:
        from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
        n_blocks = int(round(args.sec / cfg.block_sec))
        synth = DeviceScenarioSynth(scn, noise_std=args.noise, device=device)
        cb = cfg.no_sec if args.chunk_sec is None else max(
            cfg.no_sec, int(args.chunk_sec / cfg.block_sec))
        t0 = time.time()
        session.run_device_source(synth.chunk_planar, n_blocks // cb,
                                  chunk_blocks=cb)
    else:
        if blocks is None:
            blocks = host_blocks(args, cfg, scn, device)
        t0 = time.time()
        session.run_source(iter(blocks))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return _report(args, scn, session, time.time() - t0)


def _report(args, scn, session, wall: float) -> dict:
    """The JAX example's report, printed; returns its values."""
    from gps_sdr_tpu_torch.utils.geodesy import ecef_to_geo

    s = session.final_summary()
    ev = session.evaluator
    res = {"wall_s": wall, "rtf": args.sec / wall,
           "n_positions": s["n_positions"],
           "n_fix_failures": s["n_fix_failures"],
           "n_outliers": s["n_outliers"],
           "n_phase_errors": s["n_phase_errors"],
           "ephemerides": sorted(s["ephemerides"]),
           "raim_excluded": [sat for _, sat, _, _ in ev.raim_events],
           "k_steps": session.receiver.status.k_steps,
           "mean": None, "err_m": None, "ok": False}
    print(f"\nprocessed {args.sec:.0f} s of IQ in {wall:.1f} s "
          f"({res['rtf']:.1f}x realtime)")
    print(f"fixes: {s['n_positions']}   lsf failures: {s['n_fix_failures']}"
          f"   outliers: {s['n_outliers']}"
          f"   phase errors: {s['n_phase_errors']}")
    print(f"ephemerides decoded: {res['ephemerides']}")
    for t, sat, before, after in ev.raim_events:
        print(f"RAIM: excluded PRN {sat} "
              f"(sse/dof {before:.0f} -> {after:.2f})")
    if s["stat"] is None:
        print("NO FIX (need >= 4 sats with ephemerides + time reference)")
        return res
    if scn.rec_vel is not None:
        return _report_moving(scn, session, res)
    mean, dev, n, n_out = s["stat"]
    err = float(np.linalg.norm(mean - scn.rec_ecef))
    lat, lon, alt = ecef_to_geo(mean)
    print(f"mean position: {lat:.6f} deg, {lon:.6f} deg, {alt:.1f} m "
          f"(n={n})")
    print(f"truth:         {scn.rec_geo[0]:.6f} deg, {scn.rec_geo[1]:.6f} "
          f"deg, {scn.rec_geo[2]:.1f} m")
    print(f"3D error vs ground truth: {err:.2f} m   "
          f"per-axis sd: ({dev[0]:.2f}, {dev[1]:.2f}, {dev[2]:.2f}) m")
    # the reference's absolute accuracy envelope is 1-10 m at ~6 sats
    # (the upstream README.md:26)
    res.update(mean=np.asarray(mean, np.float64), err_m=err, ok=err < 8.0)
    print("PASS" if res["ok"] else "FAIL")
    return res


def _report_moving(scn, session, res: dict) -> dict:
    """Moving receiver: the fixes against the true trajectory and the
    Doppler velocity series against the true velocity."""
    from gps_sdr_tpu_torch.utils.gpstime import gps_datetime

    ev = session.evaluator
    rows = ev.filtered if ev.filtered else ev.positions
    t = np.array([r[0] for r in rows])
    pos = np.array([list(r)[1:4] for r in rows])
    t0 = gps_datetime(scn.tow0, scn.week).timestamp() + 0.25
    err = np.linalg.norm(
        pos - (scn.rec_ecef + (t - t0)[:, None] * scn.rec_vel), axis=1)
    med = float(np.median(err))
    src = "filtered" if ev.filtered else "raw"
    print(f"trajectory error ({src}, n={len(err)}): "
          f"median {med:.2f} m, p90 {np.percentile(err, 90):.2f} m")
    ok = med < 15.0
    res.update(median_m=med, p90_m=float(np.percentile(err, 90)))
    if ev.velocities:
        v = np.median(np.array([r[1:] for r in ev.velocities]), axis=0)
        verr = float(np.linalg.norm(v - scn.rec_vel))
        print(f"Doppler velocity: |v| {np.linalg.norm(v):.2f} m/s, "
              f"error vs truth {verr:.3f} m/s")
        res["vel_err_mps"] = verr
        ok = ok and verr < 1.0
    res["ok"] = ok
    print("PASS" if ok else "FAIL")
    return res


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
