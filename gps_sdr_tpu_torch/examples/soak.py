"""Hours-scale soak of the port: the full receiver loop over hours of
signal with every stateful accuracy feature on and a checkpoint/resume
in the middle.

    python -m gps_sdr_tpu_torch.examples.soak [--hours 2] [--k 16]
        [--streams 1] [--sats 8] [--device cuda|cpu] [--out PATH]

Port of examples/soak.py.  What it shows that unit tests cannot: the
long counters (int32 ms_time, the stream numbers) and the float32 phase
accumulators of the cheap kernel (csrc/cheap.cu; the port keeps no
ms_time rebase) and the 20 ms bit framing survive hundreds of thousands
of blocks without desync, and the fix error stays flat from the first
ten minutes to the last, through a checkpoint/resume boundary.

  * --streams 1 (default): one Session through the device path
    (Session.run_device_source), checkpointed at half time with
    save_session/load_session, with the track filter and RAIM on;
  * --streams S > 1: S full receivers of one capture through
    StreamServer, evaluated across streams (process_many), checkpointed
    with save_server/load_server.

Each stream passes when its error in the second half stays within
max(2 e1, e1 + 2 m) of the first half's e1, no phase error and no
unhealthy decode occurred, at least sats - 1 channels are locked at the
end, and it fixed in more than 0.8 of the signal seconds (soak.py's
rule).  The IQ is synthesized on the card chunk by chunk
(DeviceScenarioSynth with knot_interp_step=0.1, complex64 chunks, which
kernel 1 reads).

Writes the JSON report only to --out (default
build/gps_sdr_tpu_torch/soak_s<streams>.json under the repository; the
JAX package's SOAK_r0*.json are not touched) and keeps the checkpoint in
a temporary directory that it removes.  Exits 0 on PASS, 1 on FAIL.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def soak_config(k: int, n_streams: int):
    """soak.py's receiver: carrier smoothing 16, the track filter and RAIM
    for one stream, throughput-mode download windows."""
    from gps_sdr_tpu_torch.config import ReceiverConfig

    return ReceiverConfig(blocks_per_step=k, carrier_smoothing=16,
                          track_filter_q=0.5 if n_streams == 1 else 0.0,
                          raim=n_streams == 1,
                          download_windows_in_flight=2,
                          chunks_per_download=16, defer_subframe_poll=True,
                          epoch_per_window=True)


def run_streams(cfg, synth, n_chunks: int, n_streams: int, device,
                resume_at: int | None) -> dict:
    """n_chunks chunks of `synth` through one Session (n_streams == 1) or
    a StreamServer of n_streams replicas.  With resume_at, the run stops
    after that many chunks, is checkpointed to a temporary file, loaded
    back and run on; None runs straight through.  Returns the streams'
    evaluators and final states, the blocks consumed at the checkpoint
    and the checkpoint's size."""
    from gps_sdr_tpu_torch.runtime import checkpoint

    t = cfg.no_sec

    def provider(offset_chunks):
        return lambda first, n: synth.chunk(offset_chunks * t + first, n)

    parts = ([(0, n_chunks)] if resume_at is None else
             [(0, resume_at), (resume_at, n_chunks - resume_at)])
    consumed, ckpt_kb = None, None
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "soak_ckpt.pkl")
        if n_streams == 1:
            from gps_sdr_tpu_torch.runtime.session import Session

            sess = Session(cfg, device=device)
            for i, (off, count) in enumerate(parts):
                if i:
                    consumed = sess.receiver.status.blocks_processed
                    checkpoint.save_session(sess, ckpt)
                    ckpt_kb = os.path.getsize(ckpt) // 1024
                    sess = checkpoint.load_session(ckpt, device=device)
                sess.run_device_source(provider(off), count)
            evs = [sess.evaluator]
            states = [sess.receiver.states]
        else:
            from gps_sdr_tpu_torch.runtime.evaluator import (Evaluator,
                                                             process_many)
            from gps_sdr_tpu_torch.runtime.serving import StreamServer

            srv = StreamServer(cfg, n_streams, device=device)
            evs = [Evaluator(cfg) for _ in range(n_streams)]
            for i, (off, count) in enumerate(parts):
                if i:
                    consumed = srv.receivers[0].status.blocks_processed
                    checkpoint.save_server(srv, evs, ckpt)
                    ckpt_kb = os.path.getsize(ckpt) // 1024
                    srv, evs = checkpoint.load_server(ckpt, device=device)
                pend = []
                for s, epoch in srv.run(provider(off), count):
                    pend.append((evs[s], epoch))
                    if len(pend) == n_streams:
                        process_many(pend)
                        pend = []
                process_many(pend)
            states = [r.states for r in srv.receivers]
    return {"evaluators": evs, "states": states, "consumed": consumed,
            "checkpoint_kb": ckpt_kb}


def positions(ev) -> np.ndarray:
    """An evaluator's fixes as [n, 4] rows (time, x, y, z)."""
    return np.array(ev.positions, np.float64).reshape(-1, 4)


def stream_report(cfg, scn, ev, states, sig_sec: float, n_sats: int,
                  si: int) -> dict:
    """soak.py's per-stream record and pass rule."""
    from gps_sdr_tpu_torch.ops.tracking import summarize_states

    pos = positions(ev)
    if len(pos) == 0:
        return {"stream": si, "fixes": 0, "pass": False}
    err = np.linalg.norm(pos[:, 1:4] - scn.rec_ecef, axis=1)
    t_rel = pos[:, 0] - pos[0, 0]
    mid_t = t_rel[-1] / 2
    e1 = float(err[t_rel < mid_t].mean())
    e2 = float(err[t_rel >= mid_t].mean())
    locked_end = int(summarize_states(cfg, states)["locked"].sum())
    unhealthy = sum(1 for m in ev.err_msgs.values() if m == "UNHEALTHY")
    flat = e2 < max(2.0 * e1, e1 + 2.0)
    ok = bool(flat and ev.n_phase_errors == 0 and unhealthy == 0
              and locked_end >= n_sats - 1
              and len(pos) > 0.8 * sig_sec * (1024 // cfg.n_cyc)
              / cfg.no_sec)
    return {"stream": si, "fixes": int(len(pos)),
            "err_mean_m": round(float(err.mean()), 2),
            "err_first_half_m": round(e1, 2),
            "err_second_half_m": round(e2, 2),
            "n_phase_errors": int(ev.n_phase_errors),
            "unhealthy_decodes": int(unhealthy),
            "n_outliers": int(len(ev.outliers)),
            "locked_channels_end": locked_end, "pass": ok}


def error_profile(scn, ev, period: float = 600.0) -> list:
    """Mean fix error of each `period` seconds (soak.py: ten minutes)."""
    pos = positions(ev)
    if not len(pos):
        return []
    err = np.linalg.norm(pos[:, 1:4] - scn.rec_ecef, axis=1)
    tr = pos[:, 0] - pos[0, 0]
    out = []
    for q0 in np.arange(0, tr[-1], period):
        m = (tr >= q0) & (tr < q0 + period)
        if m.any():
            out.append(round(float(err[m].mean()), 2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "gps_sdr_tpu_torch.examples.soak")
    ap.add_argument("--hours", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--sats", type=int, default=8)
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu by name")
    ap.add_argument("--out", default=None,
                    help="report path (default build/gps_sdr_tpu_torch/"
                         "soak_s<streams>.json under the repository)")
    args = ap.parse_args(argv)

    from gps_sdr_tpu_torch.bench import device_entry
    from gps_sdr_tpu_torch.device import resolve_device
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth

    dev = resolve_device(args.device)
    cfg = soak_config(args.k, args.streams)
    sig_sec = args.hours * 3600.0
    n_chunks = int(round(sig_sec / (cfg.no_sec * cfg.block_sec)))
    scn = make_scenario(cfg, n_sats=args.sats, duration_sec=sig_sec + 12.0,
                        seed=2)
    synth = DeviceScenarioSynth(scn, noise_std=0.5, knot_interp_step=0.1,
                                device=dev)
    print(f"soak: {sig_sec:.0f} s of signal, {n_chunks} chunks, K={args.k}, "
          f"streams={args.streams}, device={dev}", flush=True)
    t0 = time.time()
    res = run_streams(cfg, synth, n_chunks, args.streams, dev,
                      resume_at=n_chunks // 2)
    wall = time.time() - t0
    per_stream = [stream_report(cfg, scn, ev, st, sig_sec, args.sats, si)
                  for si, (ev, st) in enumerate(zip(res["evaluators"],
                                                    res["states"]))]
    doc = {
        "signal_sec": sig_sec,
        "streams": args.streams,
        "aggregate_signal_sec": sig_sec * args.streams,
        "wall_sec": round(wall, 1),
        "rtf": round(sig_sec / wall, 1),
        "aggregate_rtf": round(sig_sec * args.streams / wall, 1),
        "k": args.k,
        "backend": dev.type,
        "device": device_entry(dev),
        "features": ("carrier_smoothing=16 "
                     + ("track_filter raim" if args.streams == 1
                        else "serving process_many")),
        "synth": "knot_interp_step=0.1 (Catmull-Rom light-time nodes)",
        "checkpoint_at_blocks": int(res["consumed"]),
        "checkpoint_kb": res["checkpoint_kb"],
        "err_per_10min_m_stream0": error_profile(scn,
                                                 res["evaluators"][0]),
        "per_stream": per_stream,
        "pass": all(p["pass"] for p in per_stream),
    }
    out = args.out or os.path.join(ROOT, "build", "gps_sdr_tpu_torch",
                                   f"soak_s{args.streams}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    print(f"wrote {out} - {'PASS' if doc['pass'] else 'FAIL'}", flush=True)
    return 0 if doc["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
