"""Profile the host side of serving with fixes on the card.

    python -m gps_sdr_tpu_torch.examples.profile_serving [--sec 24]
        [--streams 8] [--wif 2] [--cpu]

Port of examples/profile_serving.py, with its flags and defaults but
--tpu: the card is the default and --cpu asks for the CPU.  A
10-satellite scenario (seed 5, noise 0.5) is synthesized on the card
into one buffer and served to --streams replicas by StreamServer
(windows of 16 chunks, --wif in flight, subframes polled at each
window's end, one epoch a window), one Evaluator a stream, a window's
epochs evaluated across streams (process_many).  The first window is
warm-up; the rest runs under cProfile: the aggregate realtime factor and
where the host's time goes as S grows.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import time


def serving_config(cfg, wif: int):
    """profile_serving.py's settings on cfg."""
    return cfg.replace(download_windows_in_flight=wif,
                       chunks_per_download=16, defer_subframe_poll=True,
                       epoch_per_window=True)


def profile_serving(cfg, provider, n_chunks: int, streams: int,
                    dev) -> dict:
    """StreamServer over provider, each stream's first window untimed,
    the rest under cProfile: {"epochs", "signal_s" (a stream),
    "wall_s", "rtf" (aggregate), "server", "evaluators", "stats"}."""
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator, process_many
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    srv = StreamServer(cfg, streams, device=dev)
    evs = [Evaluator(cfg) for _ in range(streams)]
    it = srv.run(provider, n_chunks)
    for _ in range(streams):
        s, epoch = next(it)
        evs[s].process(epoch)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    done = 0
    pend = []
    for s, epoch in it:
        pend.append((evs[s], epoch))
        if len(pend) == streams:           # cross-stream batched window
            process_many(pend)
            pend = []
        done += 1
    process_many(pend)
    prof.disable()
    wall = time.perf_counter() - t0
    sig = ((n_chunks - min(cfg.chunks_per_download, n_chunks - 1))
           * cfg.no_sec * cfg.block_sec)
    return {"epochs": done, "signal_s": sig, "wall_s": wall,
            "rtf": streams * sig / wall, "server": srv, "evaluators": evs,
            "stats": pstats.Stats(prof)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gps_sdr_tpu_torch.examples."
                                 "profile_serving")
    ap.add_argument("--sec", type=float, default=24.0)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--wif", type=int, default=2,
                    help="download_windows_in_flight")
    args = ap.parse_args(argv)

    from gps_sdr_tpu_torch.bench import scenario_buffer
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = serving_config(ReceiverConfig(), args.wif)
    _, buf, n_chunks = scenario_buffer(cfg, 5, args.sec, dev)
    res = profile_serving(cfg, lambda first, n: buf[first:first + n],
                          n_chunks, args.streams, dev)
    print(f"steady-state: {res['epochs']} epochs, {args.streams} streams, "
          f"{res['signal_s']:.1f}s signal in {res['wall_s']:.2f}s = "
          f"aggregate {res['rtf']:.1f}x realtime")
    print(f"fixes: {sum(len(e.positions) for e in res['evaluators'])}")
    res["stats"].sort_stats("cumulative").print_stats(25)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
