"""Time-shard scaling sweep: accuracy and work cost of the stitch modes.

    python -m gps_sdr_tpu_torch.examples.scaling_sweep [--blocks 64]
        [--warmup 4] [--channels 4] [--skip-fix-parity] [--fix-sec 30]
        [--cpu] [--out SCALING_torch.json]

Port of examples/scaling_sweep.py, with its flags, defaults and rows.
The same stream (up to 4 channels, noise 0.5, seed 7) runs over a
(time, ch) mesh of 8 devices (parallel/ make_mesh and track_sharded) at
1/2/4/8 time shards in both stitch modes, and each row reports:

  * the work a device does, in scans of its local stream (`work_scans`):
    the exact re-scan stitch costs n_shards scans, the boundary-state
    handoff 1 + W/L for a warm-up of W blocks over a local length L;
  * the accuracy against the sequential K=1 scan (track_chunk_impl):
    code-phase agreement, lock agreement, the final carrier-frequency
    delta;
  * the wall on this machine.  The mesh's devices are one device
    repeated (cuda:0 eight times on one card, as chip_smoke.py phase 11
    builds its meshes; the JAX tool pins 8 virtual CPU devices), whose
    shards run one after the other: the wall does not scale, and the
    work factor is the hardware-independent model.

Then the fix-level parity (skipped with --skip-fix-parity): --fix-sec of
a 6-satellite scenario (seed 2, noise 0.6) synthesized on the card,
tracked sequentially and through the state handoff at 2/4/8 shards and
warm-ups 2/4/8, each decoded (NavDecoder framed by absolute sample time)
and fixed by the same Evaluator: subframes decoded and lost, fixes, fix
error, the median separation from the sequential fixes.

Writes the JSON report to --out (default SCALING_torch.json under the
repository root; the JAX tool's SCALING_r0*.json are not touched).
--cpu runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MESH = 8                # devices of the JAX tool's virtual mesh


def work_scans(n_shards: int, mode: str, warmup: int, local: int) -> float:
    """Scans of its local stream (`local` blocks) that one device runs:
    n_shards for the exact re-scan; 1 + min(W, L)/L for the state
    handoff with W = warmup blocks (1 on one shard)."""
    if mode == "exact_rescan":
        return float(n_shards)
    return 1.0 + (min(warmup, local) / local if n_shards > 1 else 0.0)


def stream_case(cfg, channels: int, n_blocks: int, dev) -> dict:
    """examples/scaling_sweep.py's stream: PRNs 5, 12, 21, 29 (the first
    `channels`), Doppler +-4000 Hz and code delay from default_rng(0),
    256 nav bits of seed prn; n_blocks blocks of noise 0.5, seed 7,
    synthesized on the host (models/simulator.py) and put on dev; the
    states of a fresh start at each satellite's Doppler and delay."""
    import torch

    from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                    synth_stream_chunk)
    from gps_sdr_tpu_torch.ops import cacode
    from gps_sdr_tpu_torch.ops.tracking import (init_channel_states,
                                                reset_channel)

    rng = np.random.default_rng(0)
    sats = [SatSignal(prn=p, doppler=float(rng.uniform(-4000, 4000)),
                      code_delay=float(rng.uniform(0, 2048)),
                      nav_bits=random_bits(256, seed=p))
            for p in [5, 12, 21, 29][:channels]]
    blocks = synth_stream_chunk(cfg, sats, first_block=0, n_blocks=n_blocks,
                                noise_std=0.5, seed=7)
    states = init_channel_states(cfg, len(sats), dev)
    for i, s in enumerate(sats):
        states = reset_channel(states, i, s.prn, s.doppler,
                               int(s.code_delay), cfg)
    tab, ftab = cacode.ca_table(cfg), cacode.ca_fft_table(cfg)
    return {"sats": sats, "blocks": torch.as_tensor(blocks, device=dev),
            "states": states,
            "codes": np.stack([tab[s.prn] for s in sats]),
            "ffts": np.stack([ftab[s.prn] for s in sats])}


def sweep_rows(cfg, case: dict, devices: list, shard_counts=(1, 2, 4, 8),
               warmup: int = 4, reps: int = 3) -> dict:
    """The sweep's rows over a (time, ch) mesh of `devices` (names or
    torch devices, repeats allowed): per shard count, the exact re-scan
    and the state handoff against the sequential scan.  Each row's
    tracking runs once, then `reps` more times for its wall (the least;
    with reps 0 the first run's).  Returns {"reference": (final states,
    outs) of the sequential scan, "rows": [...], "tracked": {(shards,
    mode): (final states, outs)}}."""
    import torch

    from gps_sdr_tpu_torch.bench import sync
    from gps_sdr_tpu_torch.ops.tracking import (ChannelOut, ChannelState,
                                                track_chunk_impl)
    from gps_sdr_tpu_torch.parallel import make_mesh, pad_channels
    from gps_sdr_tpu_torch.parallel import track_sharded

    blocks, states = case["blocks"], case["states"]
    dev = blocks.device
    n_ch = len(case["sats"])
    t = blocks.shape[0]
    codes = torch.as_tensor(case["codes"], device=dev)
    ffts = torch.as_tensor(case["ffts"], device=dev)
    ref_states, ref_outs = track_chunk_impl(cfg, states, blocks, 1, codes,
                                            ffts)
    ref_cp = ref_outs.code_phase.cpu().numpy()
    ref_freq = ref_states.freq.cpu().numpy()
    ref_lock = ref_outs.locked.cpu().numpy()

    rows, tracked = [], {}
    for n_sh in shard_counts:
        local = t // n_sh
        mesh = make_mesh(len(devices), time_shards=n_sh, devices=devices)
        st0, cod, ff = pad_channels(states, case["codes"], case["ffts"],
                                    mesh.shape["ch"])
        for mode, kw in (("exact_rescan", dict(n_stitch=n_sh)),
                         ("state_handoff", dict(warmup_blocks=warmup))):
            def run():
                st, outs = track_sharded(cfg, mesh, st0, blocks, 1, cod, ff,
                                         **kw)
                out = (ChannelState(*(x[:n_ch] for x in st)),
                       ChannelOut(*(x[:, :n_ch] for x in outs)))
                sync(dev)
                return out

            walls = []
            for _ in range(1 + reps):
                t0 = time.perf_counter()
                st, outs = run()
                walls.append(time.perf_counter() - t0)
            cp = outs.code_phase.cpu().numpy()
            both = (ref_cp >= 0) & (cp >= 0)
            work = work_scans(n_sh, mode, warmup, local)
            rows.append({
                "time_shards": n_sh, "mode": mode,
                "work_scans_per_device": round(work, 3),
                "model_speedup": round(n_sh / work, 2),
                "wall_s": min(walls[1:] or walls),
                "code_phase_agreement": float(
                    (np.abs(ref_cp - cp)[both] < 0.5).mean()),
                "lock_agreement": float(
                    (outs.locked.cpu().numpy() == ref_lock).mean()),
                "max_final_freq_err_hz": float(np.max(np.abs(
                    st.freq.cpu().numpy() - ref_freq))),
            })
            tracked[n_sh, mode] = (st, outs)
    return {"reference": (ref_states, ref_outs), "rows": rows,
            "tracked": tracked}


def decode_fix(cfg, prns: list, ephs: dict, outs) -> tuple[int, np.ndarray]:
    """examples/scaling_sweep.py decode_fix: the receiver's per-second
    decode and evaluation (as Receiver._consume_chunk) on raw tracking
    outputs of the channels `prns`, ephemerides preloaded: (subframes
    decoded, fixes [N, 4] of time and ECEF).  Bits are framed by
    absolute sample time: the channel-relative ms_time restarts at the
    stitch's warm-up seams and would break the 20 ms framing there."""
    from gps_sdr_tpu_torch.models.navmsg import NavDecoder
    from gps_sdr_tpu_torch.ops.tracking import outs_to_numpy
    from gps_sdr_tpu_torch.runtime.evaluator import EpochInput, Evaluator

    o = outs_to_numpy(outs)
    decs = [NavDecoder(ngps=cfg.ngps, ms_from_st=cfg.code_samples)
            for _ in prns]
    ev = Evaluator(cfg, preloaded_ephem=ephs)
    n_subs = 0
    step = cfg.no_sec
    tt = o.code_phase.shape[0]
    for c0 in range(0, tt, step):
        sl = slice(c0, min(c0 + step, tt))
        stream0 = 1 + c0
        coph, frames = {}, []
        for slot, prn in enumerate(prns):
            decs[slot].push_chunk(
                o.sign0[sl, slot], o.edge_ms[sl, slot],
                o.edge_local[sl, slot], o.edge_valid[sl, slot],
                stream_no0=stream0, erased=o.erased[sl, slot])
            cp = o.code_phase[sl, slot]
            ok = np.nonzero(cp >= 0)[0]
            if ok.size:
                coph[prn] = list(zip((stream0 + ok).tolist(),
                                     cp[ok].astype(float).tolist()))
            subs = (decs[slot].poll_subframes()
                    if o.locked[sl, slot][-1] else [])
            if not subs:
                subs = [{}]
            for sf in subs:
                if "ID" in sf:
                    n_subs += 1
                sf["SAT"] = prn
                sf["FRQ"] = float(o.freq[sl, slot][-1])
            frames += subs
        ev.process(EpochInput(0, frames, coph))
    return n_subs, np.array([p[:4] for p in ev.positions], np.float64)


def fix_parity(cfg, fix_sec: float, devices: list, dev) -> dict:
    """The fix-level rows: the sequential scan and the state handoff at
    2/4/8 shards x warm-ups 2/4/8 over fix_sec of a 6-satellite scenario
    (seed 2, noise 0.6), channels seeded from the truth."""
    import torch

    from gps_sdr_tpu_torch.config import L1_FREQ
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.ops import cacode
    from gps_sdr_tpu_torch.ops.tracking import (ChannelOut,
                                                init_channel_states,
                                                reset_channel,
                                                track_chunk_impl)
    from gps_sdr_tpu_torch.parallel import (make_mesh, pad_channels,
                                            track_sharded)

    # a multiple of 8 so that every shard count divides the stream
    fix_blocks = (int(round(fix_sec / cfg.block_sec)) // 8) * 8
    scn = make_scenario(cfg, n_sats=6, duration_sec=fix_sec + 12.0, seed=2)
    fb = DeviceScenarioSynth(scn, noise_std=0.6, device=dev).chunk(
        0, fix_blocks)
    prns = [s.prn for s in scn.sats]
    tab, ftab = cacode.ca_table(cfg), cacode.ca_fft_table(cfg)
    codes = np.stack([tab[p] for p in prns])
    ffts = np.stack([ftab[p] for p in prns])
    ephs = {s.prn: {"SAT": s.prn, **s.eph} for s in scn.sats}
    # seeded from the truth: acquisition parity is covered elsewhere,
    # this isolates the stitched tracking path
    states = init_channel_states(cfg, len(prns), dev)
    for i, s in enumerate(scn.sats):
        tau = scn.sat_states(scn.t_rx0 + np.array([0.0, 1.0]), s)[0]
        dop = -L1_FREQ * (tau[1] - tau[0])
        delay = int((tau[0] * cfg.sample_rate) % cfg.code_samples)
        states = reset_channel(states, i, s.prn, float(dop), delay, cfg)

    def err_of(pos):
        return (float(np.mean(np.linalg.norm(pos[:, 1:4] - scn.rec_ecef,
                                             axis=1)))
                if len(pos) else float("nan"))

    _, ro = track_chunk_impl(cfg, states, fb, 1,
                             torch.as_tensor(codes, device=dev),
                             torch.as_tensor(ffts, device=dev))
    ref_subs, ref_pos = decode_fix(cfg, prns, ephs, ro)
    ref_by_t = {round(p[0], 3): p[1:4] for p in ref_pos}
    print(f"sequential: {ref_subs} subframes, {len(ref_pos)} fixes, mean "
          f"err {err_of(ref_pos):.2f} m", flush=True)
    rows = []
    for n_sh in (2, 4, 8):
        for warm in (2, 4, 8):
            mesh = make_mesh(len(devices), time_shards=n_sh, devices=devices)
            st0, cod, ff = pad_channels(states, codes, ffts,
                                        mesh.shape["ch"])
            _, outs = track_sharded(cfg, mesh, st0, fb, 1, cod, ff,
                                    warmup_blocks=warm)
            subs, pos = decode_fix(cfg, prns, ephs, ChannelOut(
                *(x[:, :len(prns)] for x in outs)))
            by_t = {round(p[0], 3): p[1:4] for p in pos}
            common = sorted(set(ref_by_t) & set(by_t))
            sep = (float(np.median([np.linalg.norm(
                np.subtract(ref_by_t[k], by_t[k])) for k in common]))
                if common else None)
            rows.append({"time_shards": n_sh, "warmup_blocks": warm,
                         "mode": "state_handoff", "subframes": subs,
                         "subframes_lost": ref_subs - subs,
                         "fixes": len(pos), "fix_err_m": err_of(pos),
                         "common_epochs": len(common),
                         "median_sep_vs_sequential_m": sep})
            print(rows[-1], flush=True)
    return {"sequential": {"subframes": ref_subs, "fixes": len(ref_pos),
                           "fix_err_m": err_of(ref_pos)},
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gps_sdr_tpu_torch.examples."
                                 "scaling_sweep")
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--skip-fix-parity", action="store_true")
    ap.add_argument("--fix-sec", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="SCALING_torch.json")
    args = ap.parse_args(argv)

    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.device import resolve_device
    from gps_sdr_tpu_torch.examples.roofline import card

    dev = resolve_device("cpu" if args.cpu else "cuda")
    devices = [dev] * MESH
    cfg = ReceiverConfig()
    print(f"synthesizing {args.blocks} blocks "
          f"({args.blocks * cfg.block_sec:.1f} s)...", flush=True)
    case = stream_case(cfg, args.channels, args.blocks, dev)
    res = sweep_rows(cfg, case, devices, warmup=args.warmup)
    for row in res["rows"]:
        print(row, flush=True)
    fix = (None if args.skip_fix_parity
           else fix_parity(cfg, args.fix_sec, devices, dev))
    doc = {
        "blocks": args.blocks, "channels": len(case["sats"]),
        "warmup_blocks": args.warmup, "backend": dev.type,
        "device": card(dev), "mesh": [str(d) for d in devices],
        "note": ("the mesh is one device repeated, whose shards run one "
                 "after the other, so the wall does not scale; "
                 "model_speedup = n_shards / work_scans_per_device is the "
                 "hardware-independent scaling, valid while the stitch's "
                 "state handoff (a few KB a channel) stays negligible "
                 "next to a shard's scan"),
        "rows": res["rows"],
        "fix_parity": fix or {"sequential": None, "rows": []},
    }
    out = os.path.join(ROOT, args.out)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
