"""Profile the host side of the full receiver loop on the card.

    python -m gps_sdr_tpu_torch.examples.profile_fullloop [--sec 24] [--cpu]

Port of examples/profile_fullloop.py, with its flags and defaults but
--tpu: the card is the default and --cpu asks for the CPU.  A
10-satellite scenario (seed 3, noise 0.5) is synthesized on the card
into one buffer; Receiver.run_device tracks it (two download windows in
flight) and an Evaluator fixes each epoch.  The first window is warm-up
(acquisition, cuFFT plans); the rest runs under cProfile: the steady
state's realtime factor and where the host's time goes (unpack, nav
decode, evaluation, and the enqueue of the tracking ops, which on the
card is host time too).
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import time


def profile_fullloop(cfg, provider, n_chunks: int, dev) -> dict:
    """run_device over provider, the first window untimed, the rest
    under cProfile: {"chunks", "signal_s", "wall_s", "rtf", "receiver",
    "evaluator", "stats"}."""
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    t = cfg.no_sec
    rec = Receiver(cfg, device=dev)
    ev = Evaluator(cfg)
    it = rec.run_device(provider, n_chunks)
    for _ in range(min(cfg.chunks_per_download, n_chunks - 1)):
        ev.process(next(it))
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    done = 0
    for epoch in it:
        ev.process(epoch)
        done += 1
    prof.disable()
    wall = time.perf_counter() - t0
    sig = done * t * cfg.block_sec
    return {"chunks": done, "signal_s": sig, "wall_s": wall,
            "rtf": sig / wall, "receiver": rec, "evaluator": ev,
            "stats": pstats.Stats(prof)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gps_sdr_tpu_torch.examples."
                                 "profile_fullloop")
    ap.add_argument("--sec", type=float, default=24.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from gps_sdr_tpu_torch.bench import scenario_buffer
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = ReceiverConfig().replace(download_windows_in_flight=2)
    _, buf, n_chunks = scenario_buffer(cfg, 3, args.sec, dev)
    res = profile_fullloop(cfg, lambda first, n: buf[first:first + n],
                           n_chunks, dev)
    print(f"steady-state: {res['chunks']} chunks, {res['signal_s']:.1f}s "
          f"signal in {res['wall_s']:.2f}s = {res['rtf']:.1f}x realtime  "
          f"({1e3 * res['wall_s'] / res['chunks']:.1f} ms/chunk)")
    print(f"fixes: {len(res['evaluator'].positions)}")
    res["stats"].sort_stats("cumulative").print_stats(30)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
