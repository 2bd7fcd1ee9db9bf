"""Endurance stress of the port: hours-class synthetic streams through
the K-fused tracker.

    python -m gps_sdr_tpu_torch.examples.endurance [--minutes 10]
        [--channels 12] [--chunk-blocks 512] [--k 8] [--device cuda|cpu]

Port of examples/endurance.py, with its arguments and defaults.  The IQ
is synthesized on the card (models/sim_dev.py DeviceSynth, complex64
chunks) and fed chunk by chunk into track_chunk_batched_impl without
crossing to the host, so the wall is the card's work plus one small
download a chunk.  It checks that the tracking state (the cheap kernel's
float32 phase accumulators, the quality rings, the delay wrapping as the
code phase drifts through whole code periods) stays healthy over long
streams.  PASS (exit 0): every channel locked at the end, every
frequency within 5 Hz of the truth, and the worst found fraction of a
chunk after the first above 0.85 (endurance.py's rule); else FAIL (1).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "gps_sdr_tpu_torch.examples.endurance")
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--channels", type=int, default=12)
    ap.add_argument("--chunk-blocks", type=int, default=512)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu by name")
    args = ap.parse_args(argv)
    return run(args.minutes, args.channels, args.chunk_blocks, args.k,
               args.device)


def run(minutes: float, channels: int, chunk_blocks: int, k: int,
        device="cuda") -> int:
    """endurance.py's run at the product config with `channels` channels
    and K = k; returns the exit code (0 PASS, 1 FAIL)."""
    from gps_sdr_tpu_torch.bench import code_tables, fresh_states, sync
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.device import resolve_device
    from gps_sdr_tpu_torch.models.sim_dev import DeviceSynth
    from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits
    from gps_sdr_tpu_torch.ops.tracking import (summarize_states,
                                                track_chunk_batched_impl)

    dev = resolve_device(device)
    cfg = ReceiverConfig(max_sat=channels, blocks_per_step=k)
    n_blocks = int(minutes * 60 / cfg.block_sec)
    n_chunks = max(1, n_blocks // chunk_blocks)
    n_bits = int(minutes * 60 * 50) + 4096

    rng = np.random.default_rng(7)
    prns = rng.choice(np.arange(2, 33), channels, replace=False)
    sats = [SatSignal(prn=int(p), doppler=float(rng.uniform(-4500, 4500)),
                      code_delay=float(rng.uniform(0, cfg.code_samples)),
                      amplitude=float(rng.uniform(0.8, 1.2)),
                      nav_bits=random_bits(n_bits, seed=i))
            for i, p in enumerate(prns)]
    synth = DeviceSynth(cfg, sats, noise_std=0.7, seed=3, device=dev)
    codes, ffts = code_tables(cfg, sats, dev)
    states = fresh_states(cfg, sats, dev)

    print(f"endurance: {minutes:.0f} min = {n_blocks} blocks, {channels} "
          f"channels, chunk {chunk_blocks}, K={k}, device {dev}",
          flush=True)
    t0 = time.time()
    worst_found = 1.0
    for ci in range(n_chunks):
        first = ci * chunk_blocks
        blk = synth.chunk(first, chunk_blocks)
        states, outs = track_chunk_batched_impl(cfg, states, blk, first + 1,
                                                codes, ffts)
        found = float((outs.code_phase >= 0).float().mean())
        locked = int(outs.locked[-1].sum())
        worst_found = min(worst_found, found) if ci > 0 else worst_found
        if ci % max(1, n_chunks // 10) == 0 or ci == n_chunks - 1:
            mins = (first + chunk_blocks) * cfg.block_sec / 60
            print(f"  t={mins:6.1f} min  found={found:.4f} "
                  f"locked={locked}/{channels} "
                  f"(wall {time.time() - t0:.0f} s)", flush=True)
    sync(dev)

    summary = summarize_states(cfg, states)
    freq_err = np.abs(summary["freq"] - np.array([s.doppler for s in sats]))
    sig_sec = n_chunks * chunk_blocks * cfg.block_sec
    wall = time.time() - t0
    n_locked = int((summary["locked"] > 0.5).sum())
    print(f"\n{sig_sec:.0f} s of signal in {wall:.1f} s wall "
          f"({sig_sec / wall:.0f}x realtime incl. per-chunk synthesis and "
          f"download)")
    print(f"final locked: {n_locked}/{channels}   max freq err: "
          f"{freq_err.max():.2f} Hz   worst steady-state found frac: "
          f"{worst_found:.4f}")
    ok = n_locked == channels and freq_err.max() < 5.0 and worst_found > 0.85
    print("PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
