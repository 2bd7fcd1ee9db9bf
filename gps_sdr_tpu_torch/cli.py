"""Command-line launcher of the PyTorch port.

    python -m gps_sdr_tpu_torch replay capture.bin --ui headless --out run1
    python -m gps_sdr_tpu_torch synth --sec 40 --sats 6 --ui plot
    python -m gps_sdr_tpu_torch live --ui plot --ephem-cache eph.json
    python -m gps_sdr_tpu_torch epochs run1_epochs.pickle    # fixture replay
    python -m gps_sdr_tpu_torch replay cap.bin --role recv --udp-to 10.0.0.2
    python -m gps_sdr_tpu_torch eval --ui plot               # other machine
    python -m gps_sdr_tpu_torch serve synth --streams 8 --save-state s.pkl
    python -m gps_sdr_tpu_torch replay hi.bin --input-rate 8192000
    python -m gps_sdr_tpu_torch replay rtl24.bin --sample-rate 2.4e6
    python -m gps_sdr_tpu_torch snapshot cap.bin --ephem-cache e.json
        --prior-geo LAT,LON,H --tow TOW

Every mode, role and UI of gps_sdr_tpu/cli.py, whose parser, main
dispatch, make_config, make_reporter, block_source, run_recv_process,
run_eval_process, run_snapshot, _save_outputs and _arm_warm_start are
copied here.  The modes that run a receiver (replay, synth, live, serve,
snapshot) take `--device` (default cuda: without a GPU they raise unless
`--device cpu` is given); `epochs` and `eval` run the evaluator only, on
the host.  The two-process topology: `--role recv` runs the receiver
and sends each epoch over UDP (runtime/transport.py) to `eval` (or
`--role eval`), which solves the fixes; the receiver polls the SWEEP and
STOP commands back, and the eval loop ends after EVAL_IDLE_SEC without
an epoch.  `--ui plot` imports matplotlib (optional) and `live` pyrtlsdr
(optional) only when asked for.  `replay --input-rate` decimates (and
with --input-if downconverts) a higher-rate capture through the digital
front end on the device; `snapshot` solves a coarse-time fix from one
block.  `--sample-rate` (replay, synth, live, serve, and the evaluator
modes) sets the processing rate, a multiple of 4 kHz: code_samples =
rate / 1000 (2.048 MS/s by default; an RTL-SDR dongle's 2.4 MS/s gives
2400).  A resumed run (`--resume-state`) keeps the checkpoint's config
and continues the source at the block where the saved run stopped; the
port's `serve` does so too (unlike the JAX package's, which replays
its source from block 0 against the resumed receivers).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gps_sdr_tpu_torch.config import ReceiverConfig

# modes that run a receiver, and so take --device
DEVICE_MODES = ("replay", "synth", "live", "serve", "snapshot")
# the eval loop ends after this many seconds without an epoch (and, with
# --max-sec, this long after max_sec)
EVAL_IDLE_SEC = 30.0
# --sample-rate's default (code_samples 2048) and the step its values
# take: a code period of rate / 1000 samples, a multiple of 4, which the
# wipeoff kernels take (ops/hopper_wipeoff.py CS_STEP)
SAMPLE_RATE = 2.048e6
RATE_STEP = 4000.0


def sample_rate(text: str) -> float:
    """--sample-rate's value in Hz; refuses a rate that is not a positive
    multiple of RATE_STEP."""
    try:
        rate = float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not a rate in Hz")
    if not rate > 0 or rate % RATE_STEP:
        raise argparse.ArgumentTypeError(
            f"{text} Hz is not a multiple of {RATE_STEP / 1e3:g} kHz (the "
            f"code period, rate / 1000 samples, must be a multiple of 4)")
    return rate


def code_samples(args) -> int:
    """The code period, in samples, of the --sample-rate given."""
    return int(round(args.sample_rate / 1000.0))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gps_sdr_tpu_torch",
        description="GPS L1 C/A software receiver on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="mode", required=True)

    def rate(p):
        p.add_argument("--sample-rate", type=sample_rate,
                       default=SAMPLE_RATE, metavar="HZ",
                       help="processing sample rate, a multiple of 4 kHz "
                            "(code_samples = rate / 1000; default "
                            "2.048e6; an RTL-SDR at 2.4e6)")

    def common(p):
        rate(p)
        p.add_argument("--n-cyc", type=int, default=32, choices=(8, 16, 32),
                       help="code periods per block (32 -> 32 ms epochs)")
        p.add_argument("--max-sat", type=int, default=11)
        p.add_argument("--conf-height", type=float, default=None,
                       metavar="METERS",
                       help="constrain GPS height (enables 3-sat fixes)")
        p.add_argument("--ui", choices=("headless", "plot", "none"),
                       default="headless")
        p.add_argument("--out", default=None,
                       help="prefix for JSON result dumps")
        p.add_argument("--save-track", action="store_true",
                       help="write a GPX track next to --out")
        p.add_argument("--save-map", action="store_true",
                       help="write a standalone HTML map next to --out")
        p.add_argument("--ephem-cache", default=None,
                       help="JSON ephemeris cache (2 h warm start)")
        p.add_argument("--record-epochs", default=None,
                       help="record receiver->evaluator epochs (fixture)")
        p.add_argument("--role", choices=("both", "recv", "eval"),
                       default="both")
        p.add_argument("--udp-to", default="127.0.0.1",
                       help="evaluator host for --role recv")
        p.add_argument("--max-sec", type=float, default=None,
                       help="stop after this much stream time")
        p.add_argument("--save-state", default=None, metavar="PATH",
                       help="checkpoint the full receiver+evaluator "
                            "state at exit (runtime/checkpoint.py)")
        p.add_argument("--resume-state", default=None, metavar="PATH",
                       help="resume from a --save-state checkpoint "
                            "(continues mid-stream: locked channels, "
                            "bit framing, and time references intact)")
        p.add_argument("--solve-clock-rate", action="store_true",
                       help="estimate the receiver sample-clock skew "
                            "from the common carrier offset and "
                            "de-bias pseudoranges (use when the SDR's "
                            "ppm correction is unknown; replaces the "
                            "reference's SDR_FREQCORR calibration)")
        p.add_argument("--carrier-smoothing", type=int, default=0,
                       metavar="N",
                       help="Hatch-filter window in blocks (0 = off): "
                            "smooth pseudoranges with the tracked "
                            "carrier's integrated Doppler")
        p.add_argument("--almanac-cache", default=None, metavar="PATH",
                       help="JSON almanac + iono-coefficient cache "
                            "(decoded SF4/5 pages; written at exit, "
                            "preloaded at start — valid for weeks)")
        p.add_argument("--warm-start", default=None,
                       metavar="LAT,LON[,ALT[,TOW]]",
                       help="arm an almanac warm start: predict the "
                            "visible PRNs/Dopplers at this rough "
                            "position (and optional GPS TOW; default: "
                            "now) and shrink the cold sweep; needs "
                            "--almanac-cache with a valid almanac")
        p.add_argument("--iono-corr", action="store_true",
                       help="correct pseudoranges with the Klobuchar "
                            "ionosphere model from the decoded "
                            "subframe-4 page-18 coefficients")
        p.add_argument("--tropo-corr", action="store_true",
                       help="correct pseudoranges with the "
                            "Saastamoinen troposphere model")
        p.add_argument("--acq-noncoherent", type=int, default=1,
                       metavar="K",
                       help="average acquisition correlation magnitude "
                            "over K 4 ms windows (8 = whole block, "
                            "~4 dB more sensitivity; 1 = reference)")
        p.add_argument("--track-filter", type=float, default=0.0,
                       metavar="Q",
                       help="enable the position/velocity Kalman track "
                            "filter with white-acceleration process "
                            "noise Q m/s^2 (~0.5 walking, ~3 driving)")

    p = sub.add_parser("replay", help="replay a recorded IQ capture")
    p.add_argument("path")
    p.add_argument("--start-stream", type=int, default=0,
                   help="skip this many blocks first (START_STREAM)")
    p.add_argument("--input-rate", type=float, default=None,
                   metavar="HZ",
                   help="capture sample rate if it exceeds the "
                        "processing rate (integer multiple): the "
                        "digital front end decimates it on-device")
    p.add_argument("--input-if", type=float, default=0.0, metavar="HZ",
                   help="IF of a REAL-sampled capture (digital "
                        "downconversion; use with --input-format "
                        "real16)")
    p.add_argument("--input-format", choices=("iq8", "real16"),
                   default="iq8",
                   help="capture sample format (iq8 = the reference's "
                        "packed uint16 IQ)")
    common(p)

    p = sub.add_parser("synth", help="run on a synthetic scenario")
    p.add_argument("--sec", type=float, default=40.0)
    p.add_argument("--sats", type=int, default=6)
    p.add_argument("--noise", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=3)
    common(p)

    p = sub.add_parser("live", help="live RTL-SDR capture (needs pyrtlsdr)")
    p.add_argument("--gain-db", type=float, default=50.0)
    p.add_argument("--record-iq", default=None,
                   help="also record the capture (gpsbin.py's role)")
    common(p)

    p = sub.add_parser("epochs", help="replay a recorded epoch fixture "
                       "through the evaluator only (LOAD_PICKLE)")
    p.add_argument("path")
    p.add_argument("--then-udp", action="store_true",
                   help="at fixture end, keep listening for live epochs "
                        "over UDP (the reference's LOAD_PICKLE "
                        "fall-through, gpseval.py:516-524)")
    common(p)

    p = sub.add_parser("eval", help="evaluator half of the two-process "
                       "topology (listens on UDP)")
    common(p)

    p = sub.add_parser("serve", help="serve S receiver replicas of one "
                       "IQ source through the stream-stacked device "
                       "program (runtime/serving.py StreamServer): "
                       "throughput mode, cross-stream batched "
                       "evaluation")
    p.add_argument("source", help="recorded .bin capture (iq8) or the "
                   "literal 'synth' for a synthetic scenario")
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--sec", type=float, default=40.0,
                   help="synth scenario length [s]")
    p.add_argument("--sats", type=int, default=6)
    p.add_argument("--noise", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--n-cyc", type=int, default=32, choices=(8, 16, 32))
    p.add_argument("--max-sat", type=int, default=11)
    p.add_argument("--conf-height", type=float, default=None,
                   metavar="METERS")
    p.add_argument("--carrier-smoothing", type=int, default=0,
                   metavar="N")
    p.add_argument("--max-sec", type=float, default=None)
    p.add_argument("--out", default=None,
                   help="prefix for per-stream JSON result dumps "
                        "(<out>_s<k>_gps*.json)")
    p.add_argument("--save-state", default=None, metavar="PATH",
                   help="checkpoint every stream's receiver+evaluator "
                        "at exit (runtime/checkpoint.py save_server)")
    p.add_argument("--resume-state", default=None, metavar="PATH",
                   help="resume all streams from a save-state "
                        "checkpoint")
    p.add_argument("--windows", type=int, default=16,
                   help="chunks per download window")
    rate(p)

    p = sub.add_parser("snapshot", help="coarse-time snapshot fix from "
                       "one block of a capture — no nav decode; needs "
                       "cached ephemerides + a coarse position/time "
                       "prior (ops/snapshot.py)")
    p.add_argument("path", help="recorded IQ capture (.bin, iq8)")
    p.add_argument("--ephem-cache", required=True, metavar="PATH",
                   help="ephemeris JSON cache (save with --ephem-cache "
                        "on a normal run)")
    p.add_argument("--prior-geo", required=True, metavar="LAT,LON,H",
                   help="coarse position prior, good to ~100 km")
    p.add_argument("--tow", type=float, required=True,
                   help="coarse GPS time of week at capture start [s], "
                        "good to ~1 min")
    p.add_argument("--start-stream", type=int, default=0,
                   help="block number of the capture to snapshot")
    p.add_argument("--n-cyc", type=int, default=32, choices=(8, 16, 32))
    p.add_argument("--height", type=float, default=None,
                   help="WGS84 height constraint [m] (4-sat fixes)")
    for mode in DEVICE_MODES:
        sub.choices[mode].add_argument(
            "--device", default="cuda",
            help="torch device: cuda (default; fails without a GPU) or "
                 "cpu (the plain PyTorch path)")
    return ap


def make_config(args) -> ReceiverConfig:
    kw = dict(code_samples=code_samples(args), n_cyc=args.n_cyc,
              max_sat=args.max_sat)
    if args.conf_height is not None:
        kw.update(conf_height=True, height=args.conf_height)
    if getattr(args, "solve_clock_rate", False):
        kw.update(solve_clock_rate=True)
    if getattr(args, "carrier_smoothing", 0):
        kw.update(carrier_smoothing=args.carrier_smoothing)
    if getattr(args, "iono_corr", False):
        kw.update(iono_corr=True)
    if getattr(args, "tropo_corr", False):
        kw.update(tropo_corr=True)
    if getattr(args, "track_filter", 0.0):
        kw.update(track_filter_q=args.track_filter)
    if getattr(args, "acq_noncoherent", 1) > 1:
        kw.update(acq_noncoherent=args.acq_noncoherent)
    return ReceiverConfig(**kw)


def make_reporter(args):
    if args.ui == "headless":
        from gps_sdr_tpu_torch.ui.headless import HeadlessReporter
        return HeadlessReporter()
    if args.ui == "plot":
        from gps_sdr_tpu_torch.ui.plot import PlotUI
        return PlotUI()
    return None


def block_source(args, cfg):
    if args.mode == "replay":
        from gps_sdr_tpu_torch.runtime.sources import (replay_blocks,
                                                       replay_decimated)
        max_blocks = (None if args.max_sec is None
                      else int(args.max_sec / cfg.block_sec))
        if getattr(args, "input_rate", None):
            return replay_decimated(args.path, cfg, args.input_rate,
                                    f_if=args.input_if,
                                    fmt=args.input_format,
                                    start_stream=args.start_stream,
                                    max_blocks=max_blocks,
                                    device=args.device)
        return replay_blocks(args.path, cfg,
                             start_stream=args.start_stream,
                             max_blocks=max_blocks)
    if args.mode == "synth":
        from gps_sdr_tpu_torch.models.scenario import (make_scenario,
                                                       synth_scenario_blocks)
        sec = args.sec if args.max_sec is None else min(args.sec,
                                                        args.max_sec)
        scn = make_scenario(cfg, n_sats=args.sats, seed=args.seed,
                            duration_sec=sec + 12.0)
        n_blocks = int(round(sec / cfg.block_sec))
        # a resumed run continues the scenario where the saved one stopped
        start = getattr(args, "start_stream", 0)

        def gen():
            step = 4 * cfg.no_sec
            for first in range(start, n_blocks, step):
                n = min(step, n_blocks - first)
                chunk = synth_scenario_blocks(scn, first, n,
                                              noise_std=args.noise,
                                              seed=args.seed)
                yield from chunk
        return gen()
    if args.mode == "live":
        from gps_sdr_tpu_torch.runtime.sources import live_blocks
        src = live_blocks(cfg, gain_db=args.gain_db)
        if args.record_iq:
            from gps_sdr_tpu_torch.runtime.sources import pack_iq

            def recording(src=src, path=args.record_iq):
                with open(path, "wb") as f:
                    for b in src:
                        pack_iq(b).tofile(f)
                        yield b
            src = recording()
        if args.max_sec is not None:
            import itertools
            src = itertools.islice(src, int(args.max_sec / cfg.block_sec))
        return src
    raise ValueError(args.mode)


def _found_prns(receiver) -> list:
    return sorted(f[1] for f in receiver.found_sats)


def run_recv_process(args, cfg) -> int:
    """Receiver half: DSP on --device, epochs out over UDP, the SWEEP and
    STOP commands polled back after each epoch."""
    from gps_sdr_tpu_torch.runtime.receiver import Receiver
    from gps_sdr_tpu_torch.runtime.transport import EpochSender

    recv = Receiver(cfg, device=args.device)
    sender = EpochSender(host=args.udp_to)
    n = n_dgrams = 0
    try:
        for epoch in recv.run(block_source(args, cfg)):
            n_dgrams += sender.send(epoch)
            n += 1
            cmd = sender.poll_command()
            if cmd == "SWEEP":
                recv.request_sweep()
            elif cmd == "STOP":
                recv.stop()
    finally:
        sender.close()
    print(f"receiver done: {n} epochs sent in {n_dgrams} datagrams on "
          f"{recv.device}; acquired PRNs {_found_prns(recv)}")
    return 0


def run_eval_process(args, cfg) -> int:
    """Evaluator half: epochs in over UDP, fixes and UI out.  Ends after
    EVAL_IDLE_SEC without an epoch."""
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator
    from gps_sdr_tpu_torch.runtime.transport import EpochReceiver
    from gps_sdr_tpu_torch.utils import io, profiling

    def eval_s() -> float:
        return profiling.snapshot()["spans"].get(
            "eval.process", {}).get("total_s", 0.0)

    preloaded = (io.load_ephemerides(args.ephem_cache)
                 if args.ephem_cache else {})
    ev = Evaluator(cfg, preloaded_ephem=preloaded)
    reporter = make_reporter(args)
    rx = EpochReceiver()
    t0 = time.time()
    eval0 = eval_s()
    idle = 0.0
    n = 0
    try:
        while True:
            epoch = rx.recv()
            if epoch is None:
                time.sleep(0.05)
                idle += 0.05
                if idle > EVAL_IDLE_SEC or (
                        args.max_sec is not None
                        and time.time() - t0 > args.max_sec + EVAL_IDLE_SEC):
                    break
                continue
            idle = 0.0
            n += 1
            summary = ev.process(epoch)
            if reporter is not None:
                reporter.update(epoch.frames, summary, ev)
    except KeyboardInterrupt:
        rx.request_stop()
    finally:
        rx.close()
    _save_outputs(args, cfg, ev)
    print(f"evaluator done: {n} epochs received, {len(ev.positions)} "
          f"fixes, {eval_s() - eval0:.3f} s evaluating")
    return 0


def _save_outputs(args, cfg, ev) -> None:
    from gps_sdr_tpu_torch.utils import io

    if args.out:
        io.save_results(args.out, sat_results=ev.sat_results,
                        positions=ev.positions,
                        velocities=ev.velocities or None,
                        filtered=ev.filtered or None)
    if args.ephem_cache:
        io.save_ephemerides(args.ephem_cache,
                            {s: e.ephem for s, e in ev.engines.items()
                             if e.ephem_ok})
    if args.out and ev.positions:
        from gps_sdr_tpu_torch.utils.geodesy import ecef_to_geo
        track = [ecef_to_geo(p[1:]) for p in ev.positions]
        if args.save_track:
            io.save_gpx_track(f"{args.out}_track.gpx", track)
        if args.save_map and ev.stat is not None:
            from gps_sdr_tpu_torch.ui.webmap import save_map
            save_map(f"{args.out}_map.html", ecef_to_geo(ev.stat[0]), track)


def _arm_warm_start(spec: str, session) -> None:
    """--warm-start LAT,LON[,ALT[,TOW]]: shrink the cold sweep from the
    cached almanac (models/almanac.py; the reference always sweeps all
    31 PRNs over the full band)."""
    from gps_sdr_tpu_torch.utils.geodesy import geo_to_ecef
    from gps_sdr_tpu_torch.utils.gpstime import gps_week_tow

    parts = [float(v) for v in spec.split(",")]
    lat, lon = parts[0], parts[1]
    alt = parts[2] if len(parts) > 2 else 0.0
    tow = int(parts[3]) if len(parts) > 3 else gps_week_tow()[1]
    alms = session.evaluator.almanacs
    if not alms:
        print("warm start: no almanac cached - full sweep")
        return
    ok = session.receiver.warm_start(alms, geo_to_ecef(lat, lon, alt),
                                     tow)
    print("warm start: sweep narrowed to "
          f"{len(session.receiver.warm_hints[0])} PRNs" if ok
          else "warm start: too few predicted sats - full sweep")


def run_in_process(args, cfg) -> int:
    """Single-process topology over the port's Session (`epochs` runs its
    evaluator only; its receiver, which never runs, lives on the
    CPU)."""
    from gps_sdr_tpu_torch.runtime.session import Session

    device = getattr(args, "device", "cpu")
    if args.resume_state:
        from gps_sdr_tpu_torch.runtime.checkpoint import load_session
        session = load_session(args.resume_state,
                               reporter=make_reporter(args),
                               device=device)
        session.record_epochs_to = args.record_epochs
        session.ephem_cache_path = args.ephem_cache
        # the checkpoint's config governs the resumed run: the restored
        # tracking state belongs to its block framing, so the source is
        # built with it too (the CLI's shape flags are ignored)
        if cfg.n_cyc != session.cfg.n_cyc:
            print(f"resume: using checkpoint n_cyc={session.cfg.n_cyc} "
                  f"(ignoring --n-cyc {cfg.n_cyc})")
        cfg = session.cfg
        if getattr(args, "start_stream", 0) == 0:
            # continue the source where the saved run stopped
            args.start_stream = session.receiver.status.stream_no
            print(f"resume: continuing at stream block "
                  f"{args.start_stream}")
    else:
        session = Session(cfg, device=device,
                          ephem_cache_path=args.ephem_cache,
                          almanac_cache_path=args.almanac_cache,
                          record_epochs_to=args.record_epochs,
                          reporter=make_reporter(args))
    if args.warm_start:
        _arm_warm_start(args.warm_start, session)
    n_prior = len(session.summaries)
    if args.mode == "epochs":
        from gps_sdr_tpu_torch.utils.io import load_epoch_records
        summary = session.run_epoch_records(load_epoch_records(args.path))
        if args.then_udp:
            summary = session.run_udp_followup(max_sec=args.max_sec)
    else:
        t0 = time.time()
        summary = session.run_source(block_source(args, cfg))
        wall = time.time() - t0
        sec = (len(session.summaries) - n_prior) * cfg.no_sec \
            * cfg.block_sec
        print(f"processed {sec:.1f} s of stream in {wall:.1f} s "
              f"({sec / max(wall, 1e-9):.1f}x realtime) on "
              f"{session.receiver.device}; acquired PRNs "
              f"{_found_prns(session.receiver)}")
    if args.save_state:
        from gps_sdr_tpu_torch.runtime.checkpoint import save_session
        save_session(session, args.save_state)
        print(f"checkpoint saved to {args.save_state}")
    if args.out or args.ephem_cache:
        _save_outputs(args, cfg, session.evaluator)
    if args.record_epochs:
        from gps_sdr_tpu_torch.utils.io import save_epoch_records
        save_epoch_records(args.record_epochs, session.records)
    print(f"fixes: {summary['n_positions']}  "
          f"failures: {summary['n_fix_failures']}  "
          f"outliers: {summary['n_outliers']}  "
          f"phase errors: {summary['n_phase_errors']}  "
          f"skipped blocks: {summary['skipped_blocks']}")
    stat = summary.get("stat")
    if stat is not None:
        from gps_sdr_tpu_torch.utils.geodesy import ecef_to_geo
        mean, dev, n, _ = stat
        lat, lon, alt = ecef_to_geo(mean)
        print(f"mean position: {lat:.6f} deg, {lon:.6f} deg, {alt:.1f} m "
              f"(n={n}, sd {np.linalg.norm(dev):.2f} m)")
    else:
        print("no position fix")
    return 0


def run_snapshot(args) -> int:
    """One-block coarse-time fix from a capture and cached ephemerides
    (the acquisition on --device)."""
    from gps_sdr_tpu_torch.config import GPS_C
    from gps_sdr_tpu_torch.models.pseudorange import EPHEM_KEYS
    from gps_sdr_tpu_torch.ops import cacode
    from gps_sdr_tpu_torch.ops.snapshot import snapshot_fix
    from gps_sdr_tpu_torch.runtime.sources import replay_blocks
    from gps_sdr_tpu_torch.utils.geodesy import ecef_to_geo, geo_to_ecef
    from gps_sdr_tpu_torch.utils.io import load_ephemerides

    cfg = ReceiverConfig(n_cyc=args.n_cyc)
    ephs = load_ephemerides(args.ephem_cache)
    # a normal cache only holds ephem_ok entries, but a hand-edited or
    # third-party file may carry partial dicts: require the full key
    # set _stack_ephs needs and report what was skipped
    complete = {prn: e for prn, e in ephs.items()
                if isinstance(e, dict) and all(k in e for k in EPHEM_KEYS)}
    skipped = sorted(set(ephs) - set(complete))
    if skipped:
        print(f"snapshot: skipping PRNs with incomplete ephemeris: "
              f"{skipped}", file=sys.stderr)
    ephs = complete
    if not ephs:
        print("error: ephemeris cache empty, expired, or not decoded",
              file=sys.stderr)
        return 2
    lat, lon, h = (float(v) for v in args.prior_geo.split(","))
    prior = np.asarray(geo_to_ecef(lat, lon, h), np.float64)
    block = None
    for block in replay_blocks(args.path, cfg,
                               start_stream=args.start_stream,
                               max_blocks=1):
        break
    if block is None:
        print("error: capture shorter than start stream", file=sys.stderr)
        return 2
    t_gps = args.tow + args.start_stream * cfg.block_sec
    res = snapshot_fix(cfg, block, cacode.ca_fft_table(cfg), ephs,
                       t_gps, prior, height=args.height, device=args.device)
    if res is None:
        print("snapshot: not enough acquired satellites with ephemeris")
        return 1
    gla, glo, gal = ecef_to_geo(res.rec_pos)
    # a mis-resolved millisecond integer (prior outside the ~150 km /
    # ~1 min validity) leaves hundreds of meters of post-fit residual:
    # flag the fix rather than print it as trustworthy
    suspect = res.residual_m > 300.0 or not res.converged
    if suspect:
        print("snapshot: WARNING - fix is suspect "
              f"(residual {res.residual_m:.0f} m, converged="
              f"{res.converged}); check the position/time prior",
              file=sys.stderr)
    print(f"snapshot fix: {gla:.6f} deg, {glo:.6f} deg, {gal:.1f} m "
          f"(n_sat={res.n_sat}, resid {res.residual_m:.1f} m)")
    print(f"  ecef: {res.rec_pos[0]:.1f} {res.rec_pos[1]:.1f} "
          f"{res.rec_pos[2]:.1f} m")
    print(f"  corrected tow: {res.t_gps:.4f} s "
          f"(coarse-time error {res.dt_s:+.4f} s, "
          f"clock bias {res.clock_bias_m / GPS_C * 1e3:+.4f} ms)")
    return 0


def serve_config(args) -> ReceiverConfig:
    """The serving configuration: download windows of --windows chunks, 4
    windows in flight, subframes polled once a window, one epoch a
    window."""
    kw = dict(code_samples=code_samples(args), n_cyc=args.n_cyc,
              max_sat=args.max_sat, chunks_per_download=args.windows,
              download_windows_in_flight=4,
              epoch_per_window=True)
    if args.conf_height is not None:
        kw.update(conf_height=True, height=args.conf_height)
    if args.carrier_smoothing:
        kw.update(carrier_smoothing=args.carrier_smoothing)
    return ReceiverConfig(**kw)


def open_server(args):
    """(server, evaluators, first block) for `serve`: a new server at
    serve_config, or with --resume-state the checkpoint's server, which
    keeps the checkpoint's config and continues at the block where it
    stopped."""
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    if args.resume_state:
        from gps_sdr_tpu_torch.runtime.checkpoint import load_server
        srv, evs = load_server(args.resume_state, device=args.device)
        if srv.n_streams != args.streams:
            print(f"note: checkpoint has {srv.n_streams} streams; "
                  f"ignoring --streams {args.streams}")
        start = srv.receivers[0].status.stream_no
        print(f"resume: {srv.n_streams} streams continue at stream block "
              f"{start} with the checkpoint's config")
        return srv, evs, start
    cfg = serve_config(args)
    srv = StreamServer(cfg, args.streams, device=args.device)
    return srv, [Evaluator(cfg) for _ in range(srv.n_streams)], 0


def serve_source(args, cfg: ReceiverConfig, start: int, device):
    """(provider, n_chunks, truth ECEF or None): whole chunks of the
    `serve` source on `device` from stream block `start` on, built with
    `cfg`.  A synthetic scenario is synthesized on the device
    (DeviceScenarioSynth.chunk_planar); a .bin capture is read from
    block `start`, its packed words unpacked on the device and laid out
    grouped planar there."""
    from gps_sdr_tpu_torch.ops import dsp
    from gps_sdr_tpu_torch.ops.tracking import to_grouped_planar

    t = cfg.no_sec
    if args.source == "synth":
        from gps_sdr_tpu_torch.models.scenario import make_scenario
        from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
        sec = args.sec if args.max_sec is None else min(args.sec,
                                                        args.max_sec)
        scn = make_scenario(cfg, n_sats=args.sats, seed=args.seed,
                            duration_sec=sec + 12.0)
        synth = DeviceScenarioSynth(scn, noise_std=args.noise,
                                    knot_interp_step=0.1, device=device)
        n_chunks = max(0, int(sec / (t * cfg.block_sec)) - start // t)
        return ((lambda first, n: synth.chunk_planar(start + first, n)),
                n_chunks, scn.rec_ecef)
    from gps_sdr_tpu_torch.runtime.sources import replay_blocks
    max_blocks = (None if args.max_sec is None
                  else max(0, int(args.max_sec / cfg.block_sec) - start))
    blocks = list(replay_blocks(args.source, cfg, start_stream=start,
                                max_blocks=max_blocks))
    n_chunks = len(blocks) // t
    if not n_chunks:
        return None, 0, None
    buf = to_grouped_planar(cfg, dsp.host_iq(np.stack(blocks[:n_chunks * t]),
                                             device))
    del blocks
    return (lambda first, n: buf[first:first + n]), n_chunks, None


def run_serve(args) -> int:
    """S receivers off one card (the serving path): fused windows, the
    sparse window consume, cross-stream batched evaluation
    (process_many)."""
    from gps_sdr_tpu_torch.runtime.evaluator import process_many

    srv, evs, start = open_server(args)
    cfg = srv.cfg
    provider, n_chunks, truth = serve_source(args, cfg, start, srv.device)
    t0 = time.time()
    pend = []
    for s, epoch in srv.run(provider, n_chunks):
        pend.append((evs[s], epoch))
        if len(pend) == srv.n_streams:
            process_many(pend)
            pend = []
    if pend:
        process_many(pend)
    wall = time.time() - t0
    sig = n_chunks * cfg.no_sec * cfg.block_sec

    for s, ev in enumerate(evs):
        n_fix = len(ev.positions)
        line = f"stream {s}: {n_fix} fixes"
        if n_fix and ev.stat is not None:
            line += (f", mean ECEF ({ev.stat[0][0]:.1f}, "
                     f"{ev.stat[0][1]:.1f}, {ev.stat[0][2]:.1f})")
            if truth is not None:
                err = float(np.linalg.norm(ev.stat[0] - truth))
                line += f", err vs truth {err:.2f} m"
        print(line)
    stages = ", ".join(f"{k}: {v:.2f}" for k, v in srv.perf.items())
    print(f"{srv.n_streams} streams x {sig:.1f} s in {wall:.2f} s = "
          f"{srv.n_streams * sig / max(wall, 1e-9):.1f}x aggregate realtime "
          f"on {srv.device}; stages {{{stages}}}")

    if args.out:
        from gps_sdr_tpu_torch.utils import io
        for s, ev in enumerate(evs):
            io.save_results(f"{args.out}_s{s}", sat_results=ev.sat_results,
                            positions=ev.positions)
    if args.save_state:
        from gps_sdr_tpu_torch.runtime.checkpoint import save_server
        save_server(srv, evs, args.save_state)
        print(f"checkpointed {srv.n_streams} streams to {args.save_state}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "snapshot":
        return run_snapshot(args)
    if args.mode == "serve":
        return run_serve(args)
    cfg = make_config(args)
    if args.mode == "eval" or args.role in ("eval", "recv"):
        if args.save_state or args.resume_state:
            print("error: --save-state/--resume-state are only "
                  "supported in the single-process topology "
                  "(--role both)", file=sys.stderr)
            return 2
    if args.mode == "eval" or args.role == "eval":
        return run_eval_process(args, cfg)
    if args.role == "recv":
        return run_recv_process(args, cfg)
    return run_in_process(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
