"""K-block cheap feedback stage of the fused tracking step.

Replaces gps_sdr_tpu/ops/pallas_cheap.py::_cheap_kernel (called through
cheap_stage_call by cheap_stage_pallas) with the hand-written CUDA
kernel csrc/cheap.cu for sm_90a.  The surrounding work of
cheap_stage_pallas (erase on a stream gap, active masking, carry
de-rotation by dphi, freq clip, sweep request, output assembly) stays
in PyTorch, in ops/tracking.py channel_step_k.

What it computes: the scan body of channel_step_k for each of the K
blocks in order, per channel: means assembly with the tail carry; the
virtual-NCO-retune rotation; the correlation-quality ring and its 1 s
window; the bit-edge scan; amplitude and sigma; the PLL (arctan with
the re == 0 guard, pi-step unwrap, df ring, slew clip, lock).  Integer
state stays integer (int32 ms_time and counters, int8 signs and ring),
so ms_time past 2^24 and the +-1 ring sums are exact.

What bounds it on the H100: latency, not bytes or flops.  A step moves
~40 KB and does a few thousand operations per channel, but each block
depends on the previous one.  The kernel runs one CTA of 64 threads per
channel (n_cyc+1 <= 33 slots per block), loops over the K blocks inside
the kernel and keeps the channel's state in shared memory, so a step is
one launch instead of the hundreds of small PyTorch ops of the plain
version.  The per-slot work (means, rotation, arctan) runs one slot per
thread; the prefix scans and sums over the 33 slots run in one thread.

The plain PyTorch twin below computes the same results; a CPU tensor
runs it, a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu_torch.ops import _build

TWO_PI = 2.0 * math.pi

# state fields the scan carries and returns (ChannelState names)
_STATE = ("carry_sum", "carry_cnt", "sign0", "prev_sign", "prev_signal",
          "ms_time", "std_dev", "locked", "df_buf", "df_cnt", "df_idx",
          "corr_buf", "corr_cnt", "corr_idx")


class CheapOut(NamedTuple):
    """Final carried state [C, ...] plus per-block outputs [C, K, ...]."""

    carry_sum: torch.Tensor     # c64[C]; NOT yet de-rotated by dphi
    carry_cnt: torch.Tensor     # i32[C]
    sign0: torch.Tensor         # i8[C]
    prev_sign: torch.Tensor     # i8[C]
    prev_signal: torch.Tensor   # f32[C]
    ms_time: torch.Tensor       # i32[C]
    std_dev: torch.Tensor       # f32[C]
    locked: torch.Tensor        # bool[C]
    df_buf: torch.Tensor        # f32[C, no_sec]
    df_cnt: torch.Tensor        # i32[C]
    df_idx: torch.Tensor        # i32[C]
    corr_buf: torch.Tensor      # i8[C, hist]
    corr_cnt: torch.Tensor      # i32[C]
    corr_idx: torch.Tensor      # i32[C]
    dphi: torch.Tensor          # f32[C]; accumulated phase correction
    df_sum: torch.Tensor        # f32[C]; accumulated frequency correction
    amplitude: torch.Tensor     # f32[C, K]
    corr_q: torch.Tensor        # f32[C, K]
    corr_l: torch.Tensor        # f32[C, K]
    locked_seq: torch.Tensor    # bool[C, K]
    sign0_seq: torch.Tensor     # i8[C, K]
    edge_ms: torch.Tensor       # i32[C, K, n_cyc+1]
    edge_local: torch.Tensor    # i32[C, K, n_cyc+1]
    edge_valid: torch.Tensor    # bool[C, K, n_cyc+1]


def cheap_scan_plain(cfg: ReceiverConfig, k: int, head: torch.Tensor,
                     seg: torch.Tensor, delay: torch.Tensor,
                     wipe: torch.Tensor, st) -> CheapOut:
    """Plain PyTorch version of the cheap-stage kernel (same arguments
    and result as cheap_scan)."""
    from gps_sdr_tpu_torch.ops import tracking as trk

    cs, fs = cfg.code_samples, cfg.sample_rate
    t_blk = cfg.ngps / cfg.sample_rate
    carry = {name: getattr(st, name) for name in _STATE}
    dphi = torch.zeros_like(st.prev_signal)
    df_sum = torch.zeros_like(st.prev_signal)
    per_block = []
    for b in range(k):
        means, starts, mask, n_valid, carry["carry_sum"], \
            carry["carry_cnt"] = trk._means_from_sums(
                head[:, b], seg[:, b], wipe[:, b], carry["carry_sum"],
                carry["carry_cnt"], cfg)
        # virtual NCO retune: the frequency corrections already commanded
        # this step as a per-ms phase ramp, plus the accumulated offset
        t_m = (starts.to(torch.float32) + 0.5 * cs) / fs
        ang = dphi[:, None] + TWO_PI * df_sum[:, None] * t_m
        means = means * torch.complex(torch.cos(ang), -torch.sin(ang))

        (carry["corr_buf"], carry["corr_cnt"], carry["corr_idx"], corr_q,
         corr_l) = trk._corr_quality(delay[:, b] >= 0, carry["corr_buf"],
                                     carry["corr_cnt"], carry["corr_idx"],
                                     cfg)
        min_edge_amp = cfg.edge_sigma * carry["std_dev"]
        (carry["sign0"], carry["prev_sign"], carry["prev_signal"],
         carry["ms_time"], ems, est, evalid) = trk._edge_scan(
            means, starts, mask, carry["locked"], min_edge_amp,
            carry["sign0"], carry["prev_sign"], carry["prev_signal"],
            carry["ms_time"])
        amplitude, carry["std_dev"] = trk._amplitude(means, mask, n_valid)
        (df, phase_offset, carry["locked"], carry["df_buf"],
         carry["df_cnt"], carry["df_idx"]) = trk._pll(
            means, mask, n_valid, carry["locked"], carry["df_buf"],
            carry["df_cnt"], carry["df_idx"], cfg)
        dphi = dphi + phase_offset + TWO_PI * df_sum * t_blk
        df_sum = df_sum + df
        per_block.append((amplitude, corr_q, corr_l, carry["locked"],
                          carry["sign0"], ems, est, evalid))
    seqs = [torch.stack(x, dim=1) for x in zip(*per_block)]
    return CheapOut(**carry, dphi=dphi, df_sum=df_sum,
                    **dict(zip(CheapOut._fields[16:], seqs)))


def cheap_scan(cfg: ReceiverConfig, k: int, head: torch.Tensor,
               seg: torch.Tensor, delay: torch.Tensor, wipe: torch.Tensor,
               st) -> CheapOut:
    """The K-block cheap scan for all channels.

    head c64[C, K], seg c64[C, K, n_cyc]: wipeoff sums; delay i32[C, K]:
    measured correlator delays (a block is "found" where >= 0); wipe
    i32[C, K]: wipeoff boundary delays; st: the step's starting
    ChannelState, already erased on a stream gap.  The kernel updates
    clones of the carried state in place; `st` is not modified."""
    if head.device.type == "cpu":
        return cheap_scan_plain(cfg, k, head, seg, delay, wipe, st)
    if head.device.type != "cuda":
        raise ValueError(f"cheap kernel: no path for {head.device}")
    dev = head.device
    n_ch, n_cyc = head.shape[0], cfg.n_cyc
    sl = n_cyc + 1
    if sl > 64:
        raise ValueError(f"cheap kernel: n_cyc+1 = {sl} slots > 64")
    want = {"head": (head, torch.complex64, (n_ch, k)),
            "seg": (seg, torch.complex64, (n_ch, k, n_cyc)),
            "delay": (delay, torch.int32, (n_ch, k)),
            "wipe": (wipe, torch.int32, (n_ch, k))}
    for name, (v, dt, shape) in want.items():
        if v.dtype != dt or tuple(v.shape) != shape or v.device != dev:
            raise ValueError(f"cheap kernel: {name} must be {dt} {shape} "
                             f"on {dev}, got {v.dtype} {tuple(v.shape)}")
    head, seg, delay, wipe = (x.contiguous() for x in (head, seg, delay,
                                                        wipe))
    carry = {name: getattr(st, name).clone(
        memory_format=torch.contiguous_format) for name in _STATE}
    if any(v.device != dev or v.shape[0] != n_ch for v in carry.values()) \
            or carry["df_buf"].shape != (n_ch, cfg.no_sec) \
            or carry["corr_buf"].shape != (n_ch, cfg.corr_hist_len):
        raise ValueError("cheap kernel: state tensors must be on "
                         f"{dev} with {n_ch} channels and rings sized "
                         "by cfg")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out = dict(dphi=f32(n_ch), df_sum=f32(n_ch), amplitude=f32(n_ch, k),
               corr_q=f32(n_ch, k), corr_l=f32(n_ch, k),
               locked_seq=torch.empty((n_ch, k), dtype=torch.bool,
                                      device=dev),
               sign0_seq=torch.empty((n_ch, k), dtype=torch.int8,
                                     device=dev),
               edge_ms=torch.empty((n_ch, k, sl), dtype=torch.int32,
                                   device=dev),
               edge_local=torch.empty((n_ch, k, sl), dtype=torch.int32,
                                      device=dev),
               edge_valid=torch.empty((n_ch, k, sl), dtype=torch.bool,
                                      device=dev))
    ptrs = [x.data_ptr() for x in (head, seg, delay, wipe)]
    ptrs += [carry[name].data_ptr() for name in _STATE]
    ptrs += [v.data_ptr() for v in out.values()]
    args = _build.CheapArgs(
        *ptrs, n_ch, k, n_cyc, cfg.code_samples, cfg.no_sec,
        cfg.corr_hist_len, cfg.pll_offset_avg, cfg.sample_rate,
        cfg.edge_sigma, cfg.pll_gain_locked, cfg.pll_gain_unlocked,
        cfg.pll_lock_threshold, cfg.pll_max_df_per_sec / cfg.no_sec,
        cfg.pll_phase_jump, cfg.ngps / cfg.sample_rate)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.gsdr_cheap_launch(ctypes.byref(args), stream),
                     "cheap kernel launch")
    cheap_scan.launches += 1
    return CheapOut(**carry, **out)


cheap_scan.launches = 0
