"""Mix + code-wipeoff kernel of the K-block tracking heavy stage.

Replaces gps_sdr_tpu/ops/pallas_kernels.py::_mxu_wipeoff_kernel (called
through mix_wipeoff_mxu by heavy_stage_pallas) with the hand-written
CUDA kernel csrc/wipeoff.cu for sm_90a.

What it computes, per channel c and block b of K-block step `step`:
  * the block mixed with the frozen NCO, factorized as
    ang(q, i) = base_b + s*(i+1) + s*cs*q with base_b = phase + snp*b
    and snp = (s*ngps) mod 2*pi (q = code period, i = sample in period);
  * the mean of the corr_avg center code periods, complex64 [K, C, cs];
  * the code wipeoff with the C/A code rolled by the block's predicted
    delay w (out[i] = code[(i - w) mod cs], np.roll semantics) and the
    head mask i < w: head sum lo[0], complex64 [C, K], and per-ms
    segment sums seg[q] = hi[q] + lo[q+1] (the last has no following
    head), complex64 [C, K, n_cyc].

What bounds it on the H100: bytes.  At the product shapes (C=11, K=8,
n_cyc=32, cs=2048) a step reads 8 blocks of 512 KB and the arithmetic
is ~20 flops per sample and channel.  The kernel runs one CTA per
(channel, block), 88 CTAs, and each CTA reads its block once; the 11
channels of a block re-read it from L2 (4 MB of blocks against 50 MB of
L2), so device-memory traffic stays one pass over the step's blocks.
Removing the 11 L2 re-reads (one CTA per block for all channels, or
tensor-core contractions as in the MXU formulation) is the first thing
a faster version does.

The plain PyTorch twin below computes the same quantities; a CPU tensor
runs it, a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu_torch.ops import _build, dsp


def mix_wipeoff_plain(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                      snp: torch.Tensor, phase: torch.Tensor,
                      wipe: torch.Tensor, chunk: torch.Tensor, step: int,
                      codes: torch.Tensor):
    """Plain PyTorch version of the wipeoff kernel (same arguments and
    results as mix_wipeoff)."""
    from gps_sdr_tpu_torch.ops.tracking import _segment_sums_rolled

    cs, n_cyc, ca = cfg.code_samples, cfg.n_cyc, cfg.corr_avg
    n_ch = s.shape[0]
    dev = chunk.device
    first = (n_cyc - ca) // 2
    blocks = chunk[step * k:(step + 1) * k].reshape(k, n_cyc, cs)
    col = torch.arange(cs, dtype=torch.float32, device=dev)
    row = torch.arange(n_cyc, dtype=torch.float32, device=dev)
    base = phase[:, None] + snp[:, None] * torch.arange(
        k, dtype=torch.float32, device=dev)                   # [C, K]
    ang_r = base[..., None] + s[:, None, None] * (col + 1.0)  # [C, K, cs]
    ang_q = (s * cs)[:, None] * row                           # [C, n_cyc]
    cr, sr = torch.cos(ang_r)[:, :, None], torch.sin(ang_r)[:, :, None]
    cq, sq = torch.cos(ang_q)[:, None, :, None], \
        torch.sin(ang_q)[:, None, :, None]
    osc_re = cq * cr - sq * sr                                # [C,K,n,cs]
    osc_im = sq * cr + cq * sr
    xr, xi = blocks.real[None], blocks.imag[None]
    mixed = torch.complex(xr * osc_re + xi * osc_im,
                          xi * osc_re - xr * osc_im)
    center = mixed[:, :, first:first + ca].mean(dim=2)        # [C, K, cs]
    rolled = dsp.roll_code(codes[:, None, :], wipe)           # [C, K, cs]
    head, seg = _segment_sums_rolled(
        mixed.reshape(n_ch, k, n_cyc * cs), rolled, wipe, cfg)
    return center.transpose(0, 1).contiguous(), head, seg


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(
            f"wipeoff kernel: {name} must be a contiguous {dtype} "
            f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def mix_wipeoff(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                snp: torch.Tensor, phase: torch.Tensor, wipe: torch.Tensor,
                chunk: torch.Tensor, step: int, codes: torch.Tensor):
    """Mix + wipeoff of K-block step `step` of `chunk`, all channels.

    s, snp, phase: f32[C] (rad/sample, per-block phase advance mod 2*pi,
    NCO phase at the step's first sample); wipe: i32[C, K] wipeoff
    delays in [0, cs); chunk: complex64[T, ngps] (the whole chunk: the
    kernel reads block step*K + b itself); codes: f32[C, cs] unrolled.
    Returns (center c64[K, C, cs], head c64[C, K], seg c64[C, K, n_cyc]).
    """
    if chunk.device.type == "cpu":
        return mix_wipeoff_plain(cfg, k, s, snp, phase, wipe, chunk, step,
                                 codes)
    if chunk.device.type != "cuda":
        raise ValueError(f"wipeoff kernel: no path for {chunk.device}")
    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    n_ch, dev = s.shape[0], chunk.device
    t = chunk.shape[0]
    if step < 0 or (step + 1) * k > t:
        raise ValueError(f"wipeoff kernel: step {step} x K={k} outside "
                         f"a chunk of {t} blocks")
    _check(chunk, "chunk", torch.complex64, (t, cfg.ngps), dev)
    _check(codes, "codes", torch.float32, (n_ch, cs), dev)
    for name, v in (("s", s), ("snp", snp), ("phase", phase)):
        _check(v, name, torch.float32, (n_ch,), dev)
    _check(wipe, "wipe", torch.int32, (n_ch, k), dev)
    center = torch.empty((k, n_ch, cs), dtype=torch.complex64, device=dev)
    head = torch.empty((n_ch, k), dtype=torch.complex64, device=dev)
    seg = torch.empty((n_ch, k, n_cyc), dtype=torch.complex64, device=dev)
    args = _build.WipeoffArgs(
        chunk.data_ptr(), codes.data_ptr(), s.data_ptr(), snp.data_ptr(),
        phase.data_ptr(), wipe.data_ptr(), center.data_ptr(),
        head.data_ptr(), seg.data_ptr(), n_ch, k, step, n_cyc, cs,
        cfg.corr_avg)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.gsdr_wipeoff_launch(ctypes.byref(args), stream),
                     "wipeoff kernel launch")
    mix_wipeoff.launches += 1
    return center, head, seg


mix_wipeoff.launches = 0
