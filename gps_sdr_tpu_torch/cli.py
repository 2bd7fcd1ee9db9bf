"""Command-line launcher of the PyTorch port.

    python -m gps_sdr_tpu_torch replay capture.bin --ui headless --out run1
    python -m gps_sdr_tpu_torch synth --sec 40 --sats 6 --device cuda

The parser, config, reporters and block sources are gps_sdr_tpu.cli's
(JAX-free for `replay` and `synth`); this module adds `--device`
(default cuda) and runs the port's Session in process.  Modes and
options the port does not have yet stop with an error instead of
falling back to the JAX package.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gps_sdr_tpu import cli as base_cli

PORTED_MODES = ("replay", "synth")


def build_parser() -> argparse.ArgumentParser:
    ap = base_cli.build_parser()
    ap.prog = "gps_sdr_tpu_torch"
    ap.description = "GPS L1 C/A software receiver on PyTorch/CUDA"
    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    for mode in PORTED_MODES:
        sub.choices[mode].add_argument(
            "--device", default="cuda",
            help="torch device: cuda (default; fails without a GPU) or "
                 "cpu (the plain PyTorch path)")
    return ap


def _not_ported(args) -> str | None:
    """Why `args` asks for something the port does not have, or None."""
    if args.mode not in PORTED_MODES:
        return f"mode {args.mode!r} is not yet ported to PyTorch"
    if args.role != "both":
        return f"--role {args.role} is not yet ported to PyTorch"
    if args.save_state or args.resume_state:
        return "--save-state/--resume-state are not yet ported to PyTorch"
    if getattr(args, "input_rate", None):
        return "--input-rate (the digital front end) is not yet ported"
    return None


def run_in_process(args, cfg) -> int:
    """Single-process topology over the port's Session."""
    from gps_sdr_tpu_torch.runtime.session import Session

    session = Session(cfg, device=args.device,
                      ephem_cache_path=args.ephem_cache,
                      almanac_cache_path=args.almanac_cache,
                      record_epochs_to=args.record_epochs,
                      reporter=base_cli.make_reporter(args))
    if args.warm_start:
        base_cli._arm_warm_start(args.warm_start, session)
    t0 = time.time()
    summary = session.run_source(base_cli.block_source(args, cfg))
    wall = time.time() - t0
    sec = len(session.summaries) * cfg.no_sec * cfg.block_sec
    print(f"processed {sec:.1f} s of stream in {wall:.1f} s "
          f"({sec / max(wall, 1e-9):.1f}x realtime) on "
          f"{session.receiver.device}")
    if args.out or args.ephem_cache:
        base_cli._save_outputs(args, cfg, session.evaluator)
    if args.record_epochs:
        from gps_sdr_tpu.utils.io import save_epoch_records
        save_epoch_records(args.record_epochs, session.records)
    print(f"fixes: {summary['n_positions']}  "
          f"failures: {summary['n_fix_failures']}  "
          f"outliers: {summary['n_outliers']}  "
          f"phase errors: {summary['n_phase_errors']}  "
          f"skipped blocks: {summary['skipped_blocks']}")
    stat = summary.get("stat")
    if stat is not None:
        from gps_sdr_tpu.utils.geodesy import ecef_to_geo
        mean, dev, n, _ = stat
        lat, lon, alt = ecef_to_geo(mean)
        print(f"mean position: {lat:.6f} deg, {lon:.6f} deg, {alt:.1f} m "
              f"(n={n}, sd {np.linalg.norm(dev):.2f} m)")
    else:
        print("no position fix")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _not_ported(args)
    if why is not None:
        print(f"error: {why}; use `python -m gps_sdr_tpu` for it",
              file=sys.stderr)
        return 2
    return run_in_process(args, base_cli.make_config(args))


if __name__ == "__main__":
    sys.exit(main())
