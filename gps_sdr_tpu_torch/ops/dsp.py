"""Core DSP primitives for acquisition and tracking, on PyTorch.

Port of gps_sdr_tpu/ops/dsp.py.  complex64/float32 throughout, with
the reference's conventions unchanged:
  * Doppler wipeoff multiplies by exp(-j(phase + 2*pi*f*t)) with
    one-based sample times t = (1..N)/fs.
  * Circular correlation is |ifft(fft(data_seg_mean) * conj(fft(code)))|;
    a peak at index DS means the code starts DS samples into the data.
  * A peak is accepted if (max - mean)/std > corr_min.
  * The sub-sample code phase is the mean of a triangle and a parabola
    fit around the peak.

Where the JAX functions act on one vector under vmap, these act on the
LAST axis and broadcast over the leading ones (the batch axis is
written out instead of vmapped).  The transforms are torch.fft (cuFFT
on the card): the matmul DFT of ops/dft.py existed only because the
TPU had no FFT, and is not ported.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def as_complex_input(x: torch.Tensor) -> torch.Tensor:
    """Accept complex64[...], f32[..., 2] re/im pairs or f32[..., 2, N]
    planar re/im; return complex64."""
    if x.is_complex():
        return x.to(torch.complex64)
    if x.shape[-1] == 2:
        return torch.complex(x[..., 0], x[..., 1])
    if x.ndim >= 2 and x.shape[-2] == 2:
        return torch.complex(x[..., 0, :], x[..., 1, :])
    raise ValueError(f"not an IQ layout: {x.dtype}{tuple(x.shape)}")


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def doppler_mix(data: torch.Tensor, freq, phase,
                sample_rate: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Wipe off Doppler: data * exp(-j(phase + 2*pi*f*t)), t=(1..N)/fs.

    data: complex64[..., N]; freq/phase: scalars or f32 tensors that
    broadcast against data.shape[:-1].  Returns the mixed data and the
    carrier phase advanced to the end of the block, wrapped to [0, 2*pi).

    The oscillator is factorized exactly as in the JAX version: with
    ang = phase + s*(1..N) and N = Q*R, exp(-i*ang) is the outer product
    of a Q-point table (angles s*R*q, the per-period advance taken
    mod 2*pi) and an R-point table.  Both tables are evaluated directly,
    and their small angles are what keep f32 accurate.
    """
    n = data.shape[-1]
    freq = _f32(freq, data)
    phase = _f32(phase, data)
    s = (TWO_PI * freq / sample_rate)[..., None]            # [..., 1]
    new_phase = torch.remainder(phase + s[..., 0] * n, TWO_PI)
    r_len = 2048 if n % 2048 == 0 else n
    q_len = n // r_len
    ar = torch.arange(1, r_len + 1, dtype=torch.float32, device=data.device)
    aq = torch.arange(q_len, dtype=torch.float32, device=data.device)
    ang_r = phase[..., None] + s * ar                       # [..., R]
    ang_q = torch.remainder(s * r_len, TWO_PI) * aq         # [..., Q]
    osc_r = torch.complex(torch.cos(ang_r), -torch.sin(ang_r))
    osc_q = torch.complex(torch.cos(ang_q), -torch.sin(ang_q))
    osc = (osc_q[..., :, None] * osc_r[..., None, :])
    osc = osc.reshape(osc.shape[:-2] + (n,))
    return data * osc, new_phase


def segment_fft_mean(data: torch.Tensor, code_samples: int, first_seg: int,
                     n_avg: int) -> torch.Tensor:
    """FFT of the mean of `n_avg` code-length segments of data[..., N],
    starting at segment `first_seg` (the DFT is linear, so this equals
    the mean of the segment FFTs, as the reference computes it)."""
    segs = data[..., first_seg * code_samples:
                (first_seg + n_avg) * code_samples]
    segs = segs.reshape(segs.shape[:-1] + (n_avg, code_samples))
    return torch.fft.fft(segs.mean(dim=-2))


def circ_correlate(fft_data: torch.Tensor,
                   code_fft: torch.Tensor) -> torch.Tensor:
    """|ifft(fft_data * conj(code_fft))|: circular correlation magnitude."""
    return torch.fft.ifft(fft_data * torch.conj(code_fft)).abs()


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def fit_peak(corr: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Sub-sample peak location on the last axis: mean of the triangle
    and parabola fits, neighbours wrapping circularly."""
    n = corr.shape[-1]
    mx = mx.long()
    cm = _take(corr, (mx - 1) % n)
    cp = _take(corr, (mx + 1) % n)
    c0 = _take(corr, mx)
    tri = torch.where(cm > cp,
                      0.5 * (cp - cm) / (c0 - cp),
                      0.5 * (cp - cm) / (c0 - cm))
    par = 0.5 * (cp - cm) / (2.0 * c0 - cp - cm)
    return mx.to(torch.float32) + 0.5 * (tri + par)


def peak_metrics(corr: torch.Tensor, corr_min: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(delay i32, code_phase f32, norm_max f32) over the last axis.

    delay = argmax if the normalized peak exceeds corr_min, else -1;
    code_phase is the sub-sample fit (or -1.0)."""
    mean = corr.mean(dim=-1)
    std = corr.std(dim=-1, correction=0)
    mx = corr.argmax(dim=-1)
    norm_max = (_take(corr, mx) - mean) / std
    found = norm_max > corr_min
    delay = torch.where(found, mx.to(torch.int32),
                        torch.full_like(mx, -1, dtype=torch.int32))
    code_phase = torch.where(found, fit_peak(corr, mx),
                             torch.full_like(norm_max, -1.0))
    return delay, code_phase, norm_max


def roll_code(code: torch.Tensor, delay: torch.Tensor) -> torch.Tensor:
    """Circularly roll code[..., n] right by `delay` samples
    (np.roll(code, +delay)); delay broadcasts against code.shape[:-1]."""
    n = code.shape[-1]
    delay = torch.as_tensor(delay, device=code.device).long()
    idx = (torch.arange(n, device=code.device) - delay[..., None]) % n
    shape = torch.broadcast_shapes(code.shape, idx.shape)
    return torch.gather(code.expand(shape), -1, idx.expand(shape))
