"""Digital front end on PyTorch: FIR decimation, digital downconversion
(DDC) and narrowband-interference excision.

Port of gps_sdr_tpu/ops/frontend.py.  It lets captures from hardware
faster than the receiver's 2.048 MS/s feed the same processing chain:

  * integer-factor decimation of higher-rate complex IQ (Airspy, HackRF
    or SDRplay captures at M x 2.048 MS/s), and
  * digital downconversion of REAL-sampled IF captures (mix to
    baseband, then decimate).

The anti-alias FIR is one strided 'valid' convolution,
torch.nn.functional.conv1d with stride = the decimation factor (cuDNN on
the card; the JAX module's lax.conv_general_dilated), run with TF32
off: cuDNN's default TF32 would round the samples to 10 mantissa bits.
`Frontend` carries the (taps-1)-sample seam and the NCO phase across
chunks, so long captures decimate with no boundary artifacts.  The
filter is a Hamming-windowed sinc, designed on the host in numpy.

excise_cw_block / excise_cw_chunk null the spectral bins of each block
whose magnitude exceeds a multiple of the block's mean |X| (a CW tone
at J/S above ~+15 dB captures every channel's PLL; the C/A signal
spreads over +-1 MHz and loses only the nulled bins).  The transforms
are torch.fft (cuFFT on the card), one batched FFT for a whole chunk:
the JAX module's matmul DFT (ops/dft.py) existed only because the TPU
had no FFT, and is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops import dsp


def design_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed-sinc lowpass; `cutoff` is the -6 dB edge as a
    fraction of the INPUT Nyquist (0 < cutoff < 1).  Odd-length,
    unit-DC-gain, linear phase."""
    if num_taps % 2 == 0:
        num_taps += 1
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = np.sinc(cutoff * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def decimation_taps(factor: int, taps_per_phase: int = 16) -> np.ndarray:
    """Anti-alias filter for an integer decimation: passband covers the
    C/A main lobe (+-1.024 MHz of the 2.048 MS/s output), stopband at
    the output Nyquist."""
    return design_lowpass(factor * taps_per_phase, 1.0 / factor)


def fir_decimate(x_planar: torch.Tensor, taps: torch.Tensor,
                 factor: int) -> torch.Tensor:
    """Strided 'valid' convolution: x_planar f32[2, n] (re/im rows), taps
    f32[t] -> f32[2, (n - t)//factor + 1].  conv1d is a
    cross-correlation, as lax.conv is, hence the flipped taps."""
    cudnn = torch.backends.cudnn
    # TF32 off for this call only (cuDNN's default rounds the inputs to
    # TF32 and misses the 2e-6 bound); the other flags stay as they are
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv1d(x_planar[:, None, :], taps.flip(0)[None, None],
                       stride=factor)
    return out[:, 0, :]


def mix_real_to_baseband(x: torch.Tensor, f_ratio: float,
                         phase0: float) -> torch.Tensor:
    """Real IF samples f32[n] * exp(-j 2 pi (phase0 + f_ratio * k)) ->
    planar f32[2, n]; f_ratio = f_if / fs_in (cycles per sample).

    The angle is the JAX module's f32 2 pi (phase0 + f_ratio k).  Its
    rounding grows with k: at replay_decimated's chunk of factor * ngps
    samples it is a few degrees of phase jitter at the chunk's end, a
    loss under 0.01 dB."""
    k = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
    ang = 2.0 * math.pi * (torch.tensor(phase0, dtype=torch.float32,
                                        device=x.device)
                           + torch.tensor(f_ratio, dtype=torch.float32,
                                          device=x.device) * k)
    return torch.stack([x * torch.cos(ang), -x * torch.sin(ang)])


class Frontend:
    """Stateful chunked decimator / DDC on `device`.

    feed(samples) -> complex64 output samples at fs_in / factor.
    `samples` is host complex IQ (factor-rate capture) or real IF samples
    (when f_if is given).  The seam starts zero-filled, so every chunk
    is processed uniformly and output sample k carries the filtered
    signal at input time k*factor - (taps-1)/2: a pure group delay of
    (taps-1)/2 input samples (the first (taps-1)//factor outputs are
    the startup transient), common to every satellite and absorbed by
    the receiver's clock unknown like any front-end filter's latency.
    """

    def __init__(self, factor: int, f_if: float = 0.0, fs_in: float = 0.0,
                 taps: np.ndarray | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.factor = int(factor)
        taps = decimation_taps(self.factor) if taps is None else taps
        self.taps = torch.as_tensor(np.asarray(taps, np.float32),
                                    device=self.device)
        self.n_taps = int(self.taps.shape[0])
        self.f_if = float(f_if)
        self.fs_in = float(fs_in)
        if self.f_if and not self.fs_in:
            raise ValueError("fs_in required with f_if")
        self._tail = torch.zeros((2, self.n_taps - 1), dtype=torch.float32,
                                 device=self.device)
        self._phase = 0.0            # NCO phase [cycles], host float64

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Consume host input samples, return the decimated complex64
        samples (possibly none while the seam fills): one upload, the
        mix and the FIR on the device, one download."""
        if self.f_if:
            x = torch.as_tensor(np.asarray(samples, np.float32),
                                device=self.device)
            planar = mix_real_to_baseband(x, self.f_if / self.fs_in,
                                          self._phase)
            self._phase = float(
                (self._phase + self.f_if / self.fs_in * x.shape[0]) % 1.0)
        else:
            c = torch.as_tensor(np.asarray(samples, np.complex64),
                                device=self.device)
            planar = torch.stack([c.real, c.imag])
        buf = torch.cat([self._tail, planar], dim=1)
        n_out = (buf.shape[1] - self.n_taps) // self.factor + 1
        if n_out <= 0:
            self._tail = buf
            return np.zeros(0, np.complex64)
        used = (n_out - 1) * self.factor + self.n_taps
        out = fir_decimate(buf[:, :used], self.taps, self.factor)
        # seam: keep everything the NEXT output sample's window needs
        self._tail = buf[:, n_out * self.factor:]
        return torch.complex(out[0], out[1]).cpu().numpy()


def frontend_blocks(sample_iter, cfg, factor: int, f_if: float = 0.0,
                    fs_in: float = 0.0, device="cuda"):
    """Adapt a raw high-rate sample stream into standard ngps-sample
    complex64 host blocks (the shape every Receiver source yields)."""
    fe = Frontend(factor, f_if=f_if, fs_in=fs_in, device=device)
    pend = np.zeros(0, np.complex64)
    for chunk in sample_iter:
        pend = np.concatenate([pend, fe.feed(chunk)])
        while pend.shape[0] >= cfg.ngps:
            yield pend[:cfg.ngps]
            pend = pend[cfg.ngps:]


# -- narrowband (CW) interference excision ---------------------------------

def excise_cw_block(block: torch.Tensor, threshold: float) -> torch.Tensor:
    """Null spectral bins above threshold*mean|X| in each IQ block.

    block: complex64[..., n] (or any layout dsp.as_complex_input takes);
    the blocks are the last axis, and any leading axes are one batched
    FFT.  Returns complex64[..., n].  A CW interferer concentrates its
    power in a few of the n bins; GPS signal and noise spread evenly, so
    the block's mean magnitude is a robust floor estimate and bins above
    `threshold` times it are interference by construction."""
    spec = torch.fft.fft(dsp.as_complex_input(block), dim=-1)
    mag = spec.abs()
    keep = mag <= threshold * mag.mean(dim=-1, keepdim=True)
    return torch.fft.ifft(spec * keep, dim=-1)


def excise_cw_chunk(cfg, stacked: torch.Tensor) -> torch.Tensor:
    """excise_cw_block over every block of a tracking chunk [..., T, *iq]
    (one batched FFT), preserving the input layout: complex [..., n],
    planar f32 [..., 2, n] or grouped planar f32 [..., 2, n_cyc, cs]."""
    out = excise_cw_block(stacked, cfg.cw_excision)
    if stacked.is_complex():
        return out
    planar = torch.stack([out.real, out.imag], dim=-2)
    if dsp.is_grouped_iq(cfg, stacked):
        planar = planar.reshape(stacked.shape)
    return planar
