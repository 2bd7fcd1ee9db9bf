"""Profile the host evaluator alone: the host cap on aggregate realtime.

    python -m gps_sdr_tpu_torch.examples.profile_evalhost [--sec 32]
        [--streams 4] [--reps 3] [--cache PATH] [--cpu]

Port of examples/profile_evalhost.py, with its flags and defaults.  The
(stream, EpochInput) pairs of a short serving run are captured once: a
10-satellite scenario (seed 5) synthesized on the card and served to
--streams replicas by StreamServer in the throughput settings (windows
of min(16, chunks / 2) chunks, 4 in flight, subframes polled at each
window's end, one epoch a window).  They are then replayed through fresh
Evaluators, a window's epochs across streams at a time
(runtime/evaluator.py process_many), --reps times under cProfile.  No
device is in the replay: its wall is the pure host cost of evaluating
the streams, and signal seconds over that wall are the host cap on the
serving path's aggregate realtime factor.

The capture is cached in --cache (default
build/gps_sdr_tpu_torch/evalhost_epochs.pkl under the repository root)
under a key that holds the package ("torch"), the device that captured
it, --sec, --streams and the window; it is read back through
utils/cplist.CodePhaseUnpickler, which refuses every class of the JAX
package or of JAX before importing it, so a JAX tool's pickle is never
loaded: it is captured anew.  --cpu captures on the CPU (the plain
path); the JAX tool always does.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pickle
import pstats
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, "build", "gps_sdr_tpu_torch",
                     "evalhost_epochs.pkl")


def serving_config(cfg, n_chunks: int):
    """profile_evalhost.py's cfg_sv: download windows of min(16,
    n_chunks / 2) chunks, 4 in flight, deferred subframe polls, one
    epoch a window."""
    w = min(16, max(1, n_chunks // 2))
    return cfg.replace(download_windows_in_flight=4, chunks_per_download=w,
                       epoch_per_window=True)


def capture(cfg_sv, provider, n_chunks: int, streams: int, dev) -> list:
    """The (stream, EpochInput) pairs StreamServer yields for `streams`
    replicas of provider's capture."""
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    srv = StreamServer(cfg_sv, streams, device=dev)
    return list(srv.run(provider, n_chunks))


def replay(cfg_sv, pairs: list, streams: int) -> list:
    """Fresh Evaluators fed the captured pairs, `streams` epochs at a
    time through process_many; returns the Evaluators."""
    from gps_sdr_tpu_torch.runtime.evaluator import Evaluator, process_many

    evs = [Evaluator(cfg_sv) for _ in range(streams)]
    pend = []
    for s, epoch in pairs:
        pend.append((evs[s], epoch))
        if len(pend) == streams:
            process_many(pend)
            pend = []
    if pend:
        process_many(pend)
    return evs


def load_capture(path: str, key: tuple):
    """The cached pairs under `key`, or None (no file, another key, or a
    file this package did not write)."""
    from gps_sdr_tpu_torch.utils.cplist import CodePhaseUnpickler

    try:
        with open(path, "rb") as f:
            k, pairs = CodePhaseUnpickler(f, f"epoch cache {path}").load()
    except (OSError, EOFError, ValueError, pickle.UnpicklingError):
        return None
    return pairs if k == key else None


def host_cap(cfg_sv, pairs: list, streams: int, sec: float,
             reps: int) -> dict:
    """A warm replay, then `reps` replays under cProfile: {"fixes" (of
    the warm replay), "wall_s" (a replay), "host_cap" (aggregate signal
    seconds over that wall), "stats" (pstats.Stats)}."""
    fixes = sum(len(e.positions) for e in replay(cfg_sv, pairs, streams))
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(reps):
        replay(cfg_sv, pairs, streams)
    prof.disable()
    wall = (time.perf_counter() - t0) / reps
    return {"fixes": fixes, "wall_s": wall,
            "host_cap": sec * streams / wall, "stats": pstats.Stats(prof)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gps_sdr_tpu_torch.examples."
                                 "profile_evalhost")
    ap.add_argument("--sec", type=float, default=32.0)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cache", default=CACHE)
    ap.add_argument("--cpu", action="store_true",
                    help="capture on the CPU (the plain path)")
    args = ap.parse_args(argv)

    from gps_sdr_tpu_torch.bench import scenario_buffer
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = ReceiverConfig()
    n_chunks = int(round(args.sec / (cfg.no_sec * cfg.block_sec)))
    cfg_sv = serving_config(cfg, n_chunks)
    key = ("torch", str(dev), args.sec, args.streams,
           cfg_sv.chunks_per_download)
    pairs = load_capture(args.cache, key)
    if pairs is None:
        t0 = time.time()
        _, buf, n_chunks = scenario_buffer(cfg, 5, args.sec, dev)
        pairs = capture(cfg_sv, lambda first, n: buf[first:first + n],
                        n_chunks, args.streams, dev)
        print(f"captured {len(pairs)} epochs in {time.time() - t0:.1f}s",
              flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.cache)),
                    exist_ok=True)
        with open(args.cache, "wb") as f:
            pickle.dump((key, pairs), f)
    else:
        print(f"loaded {len(pairs)} cached epochs", flush=True)

    res = host_cap(cfg_sv, pairs, args.streams, args.sec, args.reps)
    print(f"warm replay: {res['fixes']} fixes total", flush=True)
    print(f"host-only: {args.sec * args.streams:.0f}s aggregate signal in "
          f"{res['wall_s']:.2f}s/rep => host cap {res['host_cap']:.0f}x "
          "aggregate RTF", flush=True)
    res["stats"].sort_stats("cumulative").print_stats(35)
    res["stats"].sort_stats("tottime").print_stats(25)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
