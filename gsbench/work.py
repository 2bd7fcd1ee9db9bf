"""The work that the receiver's device path needs, counted from shapes.

Frozen copies of gps_sdr_tpu_torch/examples/roofline.py
(work_per_block, floor_us, shares and the H100's peaks) and of
chip_smoke.py's wipeoff_bound, and a bound of the cheap stage counted
from the configuration's shapes.  Nothing here reads a tensor of the
receiver, so a change to how it lays out its state cannot move the
yardstick.  Each count is of the least work: an input byte read once,
an output byte written once, whatever an implementation reads again.
"""

from __future__ import annotations

import math

# one NVIDIA H100 SXM at its 700 W limit (data sheet): the memory rate,
# the float32 rate outside the tensor cores and the dense TF32 rate
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12
H100_TF32_PER_S = 495e12


def work_per_block(shape: dict, channels: int) -> dict:
    """{"bytes", "flops"} one block of `channels` tracked channels needs:
    the IQ block read once (8 B a sample); a channel's wipeoff (8 flops
    a sample), correlation as FFT work (a forward and an inverse
    cs-point FFT, 5 cs log2 cs each, and the 6 cs of the spectrum
    product) and cheap stage (40 n_cyc)."""
    cs, n_cyc = shape["code_samples"], shape["n_cyc"]
    ngps = cs * n_cyc
    per_ch = (8 * ngps + round(2 * 5 * cs * math.log2(cs)) + 6 * cs
              + 40 * n_cyc)
    return {"bytes": 8 * ngps, "flops": channels * per_ch}


def floor_s(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(least seconds on one H100, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the flops over the f32 rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = n_flops / H100_F32_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def floor_us(work: dict) -> tuple[float, str]:
    t, what = floor_s(work["bytes"], work["flops"])
    return t * 1e6, what


def share(least_s: float, busy_s: float, name: str) -> float:
    """least_s / busy_s; raises ValueError over 1.0, where the count
    would be wrong (the card cannot beat its peak)."""
    out = least_s / busy_s
    if not out <= 1.0:
        raise ValueError(f"{name}: share of peak {out:.4g} > 1.0 "
                         f"({least_s:.4g} s least against {busy_s:.4g} s "
                         "measured): the work count is wrong")
    return out


def wipeoff_bound(shape: dict, n_streams: int, channels: int, k: int
                  ) -> tuple[float, float]:
    """(bytes, flops) of one K-step launch of either wipeoff kernel over
    n_streams streams of `channels` channels, each stream reading its
    own K blocks, at wipeoff delays of 0 (the least work).  Bytes: the
    blocks read once (8 B a sample), the codes and per-channel
    parameters read once, the center periods and the head and segment
    sums written once.  Operations, per channel, block and sample: 16
    (oscillator 6, mix 6, wipeoff 2 products and 2 sums), plus 2 for
    each center-period sample, plus one sincos (2) per channel, block
    and column."""
    cs, n_cyc, corr_avg = (shape["code_samples"], shape["n_cyc"],
                           shape["corr_avg"])
    n_ch = n_streams * channels
    n = n_ch * k * n_cyc * cs
    n_bytes = (n_streams * k * n_cyc * cs * 8 + n_ch * cs * 4
               + n_ch * (3 + k) * 4 + k * n_ch * cs * 8
               + n_ch * k * (n_cyc + 1) * 8)
    n_ops = 16 * n + 2 * n_ch * k * corr_avg * cs + 2 * n_ch * k * cs
    return n_bytes, n_ops


def cheap_bound(shape: dict, n_channels: int, k: int) -> tuple[float, float]:
    """(bytes, flops) of one cheap-stage launch over n_channels channels
    and K blocks, counted from what the stage needs by definition.
    Bytes: its inputs read once (head sums c64[C, K], segment sums
    c64[C, K, n_cyc], measured and wipeoff delays i32[C, K]); the
    carried channel state read once and written once (the carry c64,
    its count, the two signs, the last signal, the ms clock, the noise
    estimate, the lock flag, the 1 s frequency ring f32[no_sec] and the
    correlation-quality ring i8[corr_hist_len] with their counts and
    indices); the per-block outputs written once (amplitude, two
    correlation qualities, lock and sign, f32/bool/i8 [C, K], and the
    n_cyc + 1 edge slots: ms i32, offset i32, valid bool) and the two
    accumulated corrections f32[C].  Operations, per channel and block:
    the correlation-quality ring sum (corr_hist_len adds) and ~60 per
    means slot."""
    n_cyc, no_sec, hist = (shape["n_cyc"], shape["no_sec"],
                           shape["corr_hist_len"])
    c = n_channels
    inputs = c * k * (8 + 8 * n_cyc + 4 + 4)
    state = c * (8 + 4 + 1 + 1 + 4 + 4 + 4 + 1 + 4 * no_sec + 4 + 4
                 + hist + 4 + 4)
    outputs = c * k * (4 * 3 + 1 + 1 + (n_cyc + 1) * (4 + 4 + 1)) + c * 8
    n_ops = c * k * (hist + 60 * (n_cyc + 1))
    return inputs + 2 * state + outputs, n_ops
