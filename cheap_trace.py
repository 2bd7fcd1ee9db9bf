#!/usr/bin/env python3
"""Trace the cheap-stage kernel's PLL against its plain version, block by
block, on one NVIDIA GPU.

    python3 cheap_trace.py > trace.jsonl      # from the repository root

The inputs are chip_smoke.stream_case's replicas of one shared chunk,
their Dopplers 3 Hz apart (the far streams' channels are pulled off
their signal) or 0.5 Hz apart (every channel stays on it), at the
product and the tests' small configuration (CASES); then each K-step of
chip_smoke.py's chained cheap checks at n_cyc 32 (phase 3) and n_cyc 64
(phase 10e) (CHAINS).

The kernel side is a copy of gps_sdr_tpu_torch/csrc/cheap.cu into which
this script inserts, at fixed lines of the PLL warp (TRACE_INSERTS),
writes of the warp's intermediates per channel and block: the rotated
means, the arctan phases, phase_dev, mean_df, the df-ring sum and df,
and the dphi, df_sum and lock state the block started from.  The copy
is compiled with the product flags beside the product libraries and
launched through cheap_scan's own argument struct; its results are
checked bit for bit against the product kernel's.  The plain side
records the same values from cheap_scan_plain's calls of tracking._pll.

One JSON line a case: the largest df-ring difference; of the channels
over 1e-5, how many were unlocked in some block, their smallest
rotation angle and their largest difference in units of the f32
spacing of that angle times the PLL gain (df_ring_tolerance's unit in
chip_smoke.py).  Then, for the worst
channel of the worst case, one line a block with each value's
difference in the order the PLL computes them, the rotated means and
arctans of both sides in ulps from a float64 recomputation, and the
unwrap's decisions, so that the first value that diverges can be read
off.  The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from unittest import mock

import numpy as np

import chip_smoke

SLOTS = 128                     # csrc/cheap.cu kMaxSlots
# kTraceLen below: a block's SLOTS slots of real parts, imaginary parts
# and arctans, then 8 scalars
TRACE_LEN = 3 * SLOTS + 8
_SCALARS = ("phase_dev", "mean_df", "dsum", "df", "dphi_in", "df_sum_in",
            "locked_in")
# (cases' configuration, streams, Doppler step Hz, seed)
CASES = [(cfg, n, step, seed) for cfg in ("product", "small")
         for n in (3, 8) for step in (3.0, 0.5) for seed in (5, 7)]
# (n_cyc, channels): chip_smoke.py's chained K-steps (cheap_chain_args)
# on make_case(seed 5 + channels), as phase 3 (n_cyc 32) and phase 10e
# (n_cyc 64) run them
CHAINS = [(32, 11), (64, 11), (64, 32)]

# (line of csrc/cheap.cu, text inserted before it): the trace buffer,
# the per-slot writes once a block's arctans are formed, the scalars
# before the lock update, and an entry that sets the buffer
TRACE_INSERTS = [
    ("__device__ __forceinline__ int pmod(int a, int n) {",
     "constexpr int kTraceLen = 3 * kMaxSlots + 8;\n"
     "__device__ float* g_trace;\n\n"),
    ("    if (lane == 0) m.locked[b] = locked;",
     "    float* const tr = g_trace + cb * kTraceLen;\n"
     "    for (int h = 0; h < H; ++h) {\n"
     "      const int r = lane + 32 * h;\n"
     "      tr[r] = mr[h];\n"
     "      tr[kMaxSlots + r] = mi[h];\n"
     "      tr[2 * kMaxSlots + r] = ph[h];\n"
     "    }\n"),
    ("    locked = locked || fabsf(phase_dev) < a.lock_threshold;",
     "    if (lane == 0) {\n"
     "      float* const t8 = tr + 3 * kMaxSlots;\n"
     "      t8[0] = phase_dev; t8[1] = mean_df; t8[2] = dsum; t8[3] = df;\n"
     "      t8[4] = dphi; t8[5] = df_sum; t8[6] = locked ? 1.f : 0.f;\n"
     "    }\n"),
    ('extern "C" const char* gsdr_error_string(int code) {',
     'extern "C" int gsdr_cheap_set_trace(float* p) {\n'
     "  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n"
     "}\n\n"),
]


def traced_library():
    """csrc/cheap.cu with TRACE_INSERTS, compiled with the product flags
    into the build directory: the loaded library."""
    from gps_sdr_tpu_torch.ops import _build

    text = (_build.CSRC / "cheap.cu").read_text()
    for anchor, insert in TRACE_INSERTS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"csrc/cheap.cu: trace anchor {anchor!r} "
                               f"found {text.count(anchor)} times, not once")
        text = text.replace(anchor, insert + anchor)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "cheap_trace.cu"
    lib = _build.BUILD_DIR / "libgsdr_cheap_trace.so"
    src.write_text(text)
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on the traced copy:\n{out.stdout}"
                           f"{out.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.gsdr_cheap_launch.argtypes = [ctypes.POINTER(_build.CheapArgs),
                                      ctypes.c_void_p]
    dll.gsdr_cheap_set_trace.argtypes = [ctypes.c_void_p]
    return dll


def kernel_trace(dll, args):
    """(CheapOut, trace dict of [C, K, ...] tensors) of the traced kernel
    on the cheap_scan arguments `args`."""
    import torch

    from gps_sdr_tpu_torch.ops import _build, hopper_cheap

    head = args[2]
    trace = torch.zeros((head.shape[0], args[1], TRACE_LEN),
                        dtype=torch.float32, device=head.device)

    def traced(name, cargs, device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = dll.gsdr_cheap_set_trace(trace.data_ptr()) or \
            dll.gsdr_cheap_launch(ctypes.byref(cargs), stream)
        if rc != 0:
            raise RuntimeError(f"traced cheap launch: CUDA error {rc}")

    with mock.patch.object(_build, "launch", traced):
        out = hopper_cheap.cheap_scan(*args)
    torch.cuda.synchronize()
    tr = {"rot": trace[..., :2 * SLOTS].reshape(trace.shape[:2]
                                                + (2, SLOTS)),
          "ph": trace[..., 2 * SLOTS:3 * SLOTS]}
    for i, name in enumerate(_SCALARS):
        tr[name] = trace[..., 3 * SLOTS + i]
    return out, tr


def plain_trace(args):
    """(CheapOut, trace dict) of cheap_scan_plain on `args`, the values
    recorded from its calls of tracking._pll: the rotated means it is
    given, their arctans, the ring sum and mean_df it starts from, df;
    dphi and df_sum advanced as cheap_scan_plain advances them."""
    import torch

    from gps_sdr_tpu_torch.ops import hopper_cheap
    from gps_sdr_tpu_torch.ops import tracking as trk

    cfg = args[0]
    t_blk = cfg.ngps / cfg.sample_rate
    pll = trk._pll
    rec = {n: [] for n in ("rot", "ph", "mean_df", "dsum", "df",
                           "dphi_in", "df_sum_in", "locked_in", "n_valid")}
    acc = {}

    def recording(means, mask, n_valid, locked, df_buf, df_cnt, df_idx, c):
        res = pll(means, mask, n_valid, locked, df_buf, df_cnt, df_idx, c)
        df, phase_offset = res[0], res[1]
        dphi = acc.get("dphi", torch.zeros_like(df))
        df_sum = acc.get("df_sum", torch.zeros_like(df))
        rot = torch.zeros((df.shape[0], 2, SLOTS), dtype=torch.float32,
                          device=df.device)
        rot[:, 0, :means.shape[1]] = means.real
        rot[:, 1, :means.shape[1]] = means.imag
        ph = torch.zeros((df.shape[0], SLOTS), dtype=torch.float32,
                         device=df.device)
        ph[:, :means.shape[1]] = torch.atan(means.imag / means.real)
        dsum = df_buf.double().sum(dim=-1).float()        # as _pll sums
        for name, v in (("rot", rot), ("ph", ph), ("dsum", dsum),
                        ("mean_df", dsum / torch.clamp(df_cnt, min=1).to(
                            torch.float32)),
                        ("df", df), ("dphi_in", dphi), ("df_sum_in", df_sum),
                        ("locked_in", locked.to(torch.float32)),
                        ("n_valid", n_valid)):
            rec[name].append(v)
        acc["dphi"] = dphi + phase_offset + hopper_cheap.TWO_PI * df_sum \
            * t_blk
        acc["df_sum"] = df_sum + df
        return res

    with mock.patch.object(trk, "_pll", recording):
        out = hopper_cheap.cheap_scan_plain(*args)
    if not (chip_smoke._same_bits(acc["dphi"], out.dphi)
            and chip_smoke._same_bits(acc["df_sum"], out.df_sum)):
        raise AssertionError("plain trace: dphi/df_sum do not reproduce "
                             "cheap_scan_plain's")
    return out, {n: torch.stack(v, dim=1) for n, v in rec.items()}


def f64_ulps(args, side, c, b):
    """Channel c, block b: `side`'s rotated means (re) and arctans against
    a float64 recomputation from the same f32 sums and that side's own
    f32 dphi and df_sum, as the largest error in f32 spacings at each
    value."""
    import torch

    from gps_sdr_tpu_torch.ops import tracking as trk

    cfg, _, head, seg, _, wipe, st = args
    carry_sum = st.carry_sum[c:c + 1].to(torch.complex128)
    carry_cnt = st.carry_cnt[c:c + 1]
    for j in range(b + 1):
        means, starts, _, n_valid, carry_sum, carry_cnt = \
            trk._means_from_sums(head[c:c + 1, j].to(torch.complex128),
                                 seg[c:c + 1, j].to(torch.complex128),
                                 wipe[c:c + 1, j], carry_sum, carry_cnt,
                                 trk._continues(carry_cnt,
                                                st.corr_cnt[c:c + 1] + j),
                                 cfg)
    nv = int(n_valid[0])
    t_m = (starts[0, :nv].double() + 0.5 * cfg.code_samples) \
        / cfg.sample_rate
    ang = float(side["dphi_in"][c, b]) + 2.0 * math.pi * float(
        side["df_sum_in"][c, b]) * t_m
    rot = means[0, :nv] * torch.exp(-1j * ang)
    ph = torch.atan(rot.imag / rot.real)

    def ulps(got, ref):
        ref = ref.cpu().numpy()
        sp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
        return float(np.max(np.abs(got.double().cpu().numpy() - ref) / sp))

    return {"re": ulps(side["rot"][c, b, 0, :nv], rot.real),
            "ph": ulps(side["ph"][c, b, :nv], ph)}


def step_angle(cfg, out):
    """Per channel, the bound of the largest rotation angle a step reaches
    (chip_smoke.df_ring_tolerance's): |dphi| + 2 pi |df_sum| t_blk of the
    step's result `out`, float64."""
    t_blk = cfg.ngps / cfg.sample_rate
    return (out.dphi.abs() + 2.0 * math.pi * out.df_sum.abs() * t_blk
            ).double().cpu().numpy()


def stream_args(cfg, n_streams, dopp_step, seed, dev):
    """cheap_scan's arguments on chip_smoke.stream_case's first K-step."""
    from gps_sdr_tpu_torch.ops import tracking

    k = cfg.blocks_per_step
    st, chunk, codes, ffts = chip_smoke.stream_case(
        cfg, n_streams, True, 2 * k, seed, dev, dopp_step=dopp_step)
    heavy = tracking.heavy_stage(cfg, k, st, chunk, 0, codes, ffts,
                                 n_streams=n_streams)
    _, erased = tracking._erased(st, 1)
    return (cfg, k, heavy.head_k, heavy.seg_sums_k, heavy.delay_k,
            heavy.wipe_delay, erased)


def trace_case(dll, args, label: dict):
    """One call of cheap_scan on `args`: the summary dict (`label` and
    the findings), and the per-block rows of its worst channel."""
    import torch

    from gps_sdr_tpu_torch.ops import hopper_cheap

    cfg, k, erased = args[0], args[1], args[-1]
    prod = hopper_cheap.cheap_scan(*args)
    got, kt = kernel_trace(dll, args)
    want, pt = plain_trace(args)
    ring = (got.df_buf - want.df_buf).abs().amax(dim=-1).double().cpu()
    locked_in = torch.cat([erased.locked[:, None], want.locked_seq[:, :-1]],
                          dim=1)
    unlocked = (~locked_in.all(dim=1)).cpu().numpy()
    gain = np.where(unlocked, cfg.pll_gain_unlocked, cfg.pll_gain_locked)
    ang = step_angle(cfg, want)
    sp = np.spacing(ang.astype(np.float32)).astype(np.float64)
    over = ring.numpy() > 1e-5
    c = int(ring.argmax())
    summary = {
        **label, "n_cyc": cfg.n_cyc,
        "channels": int(ring.numel()),
        "df_ring_max_err": float(ring.max()),
        "over_1e-5": int(over.sum()),
        "over_1e-5_unlocked": int((over & unlocked).sum()),
        "over_1e-5_min_angle": float(ang[over].min()) if over.any()
        else None,
        "over_1e-5_max_in_gain_spacings": float(
            (ring.numpy() / (gain * sp))[over].max()) if over.any()
        else None,
        "traced_build_bit_identical": all(
            chip_smoke._same_bits(a, b) for a, b in zip(got, prod)),
        "worst_channel": c, "worst_unlocked": bool(unlocked[c])}
    blocks = []
    for b in range(k):
        nv = int(pt["n_valid"][c, b])
        row = {"block": b, "locked_in": [float(kt["locked_in"][c, b]),
                                         float(pt["locked_in"][c, b])],
               "angle": float(abs(pt["dphi_in"][c, b]) + 2.0 * math.pi
                              * abs(pt["df_sum_in"][c, b]) * cfg.ngps
                              / cfg.sample_rate)}
        for name in ("dphi_in", "df_sum_in", "dsum", "mean_df", "df"):
            kv, pv = float(kt[name][c, b]), float(pt[name][c, b])
            row[name] = [kv, pv, kv - pv]
        row["rot_max_diff"] = float((kt["rot"][c, b, :, :nv]
                                     - pt["rot"][c, b, :, :nv]).abs().max())
        row["ph_max_diff"] = float((kt["ph"][c, b, :nv]
                                    - pt["ph"][c, b, :nv]).abs().max())
        row["f64_ulps_kernel"] = f64_ulps(args, kt, c, b)
        row["f64_ulps_plain"] = f64_ulps(args, pt, c, b)
        d_k = np.diff(kt["ph"][c, b, :nv].cpu().numpy())
        d_p = np.diff(pt["ph"][c, b, :nv].cpu().numpy())
        jump = np.float32(cfg.pll_phase_jump)
        row["unwrap_steps_differ"] = int(((np.abs(d_k) > jump)
                                          != (np.abs(d_p) > jump)).sum())
        row["closest_jump_margin"] = float(np.min(np.abs(np.abs(d_p)
                                                         - jump)))
        g = cfg.pll_gain_locked if row["locked_in"][1] else \
            cfg.pll_gain_unlocked
        row["df_diff_in_gain_spacings"] = abs(row["df"][2]) / (
            g * float(np.spacing(np.float32(max(row["angle"], 1e-30)))))
        blocks.append(row)
    order = ("dphi_in", "df_sum_in", "rot", "ph", "dsum", "mean_df", "df")
    first = next(((r["block"], name) for r in blocks for name in order
                  if (r[f"{name}_max_diff"] if name in ("rot", "ph")
                      else abs(r[name][2])) > 0), (None, None))
    summary["first_block"], summary["first_value"] = first
    return summary, blocks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cheap_trace: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    _build.load()
    dll = traced_library()
    product = ReceiverConfig()
    cfgs = {"product": product,
            "small": product.replace(code_samples=256, n_cyc=8, corr_avg=4,
                                     sweep_corr_avg=2, blocks_per_step=4,
                                     corr_q_window_sec=2)}
    cases = [(stream_args(cfgs[name], n, step, seed, dev),
              {"cfg": name, "n_streams": n, "dopp_step": step,
               "seed": seed}) for name, n, step, seed in CASES]
    for n_cyc, n_ch in CHAINS:
        cfg = product.replace(n_cyc=n_cyc)
        case = chip_smoke.make_case(cfg, n_ch, cfg.no_sec, 5 + n_ch, dev,
                                    on_card=True)
        for i, args in enumerate(chip_smoke.cheap_chain_args(cfg, *case)):
            cases.append((args, {"cfg": "chain", "channels_in": n_ch,
                                 "step": i}))
    worst = None
    for args, label in cases:
        summary, blocks = trace_case(dll, args, label)
        print(json.dumps(summary), flush=True)
        if worst is None or summary["df_ring_max_err"] > \
                worst[0]["df_ring_max_err"]:
            worst = (summary, blocks)
    print("worst case, worst channel, per block:", flush=True)
    for row in worst[1]:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
