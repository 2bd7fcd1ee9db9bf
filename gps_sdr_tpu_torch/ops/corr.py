"""Tracking correlator: circular correlation + peak metrics, on torch.fft.

Port of gps_sdr_tpu/ops/corr.py.  The JAX module computes the
correlation as Cooley-Tukey matmuls in a permuted layout because the
TPU had no FFT primitive; on the card cuFFT does the transform in the
natural layout, so only the natural-layout path of that module is
ported.  Its `_peak_metrics_flat` with identity index remaps is
dsp.peak_metrics.
"""

from __future__ import annotations

import torch

from gps_sdr_tpu_torch.ops import dsp


def prep_spec(code_ffts: torch.Tensor) -> torch.Tensor:
    """conj(code_ffts) as complex64, hoisted out of the K-step loop."""
    return torch.conj(code_ffts).resolve_conj()


def corr_peaks(x: torch.Tensor, spec: torch.Tensor, corr_min: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(delay, code_phase, norm_max) over the last axis.

    x: complex64[..., n] mean center code periods; spec: prep_spec of
    the code FFTs, broadcastable against x."""
    corr = torch.fft.ifft(torch.fft.fft(x) * spec).abs()
    return dsp.peak_metrics(corr, corr_min)
