"""Batched cold-start / re-acquisition over the PRN x Doppler grid.

Port of gps_sdr_tpu/ops/acquisition.py: every Doppler bin x every PRN x
all code phases is evaluated on one block in one batched program —
mix the block with all bins at once ([D, k, n]), FFT-average
`sweep_corr_avg` code periods per bin, multiply against all code FFTs
([D, k, P, cs]), inverse FFT, and reduce.  Like the JAX version it
records the BEST Doppler bin per PRN (the reference records the first
bin above the threshold).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops import dsp
from gps_sdr_tpu_torch.ops.frontend import excise_cw_block
from gps_sdr_tpu_torch.utils.profiling import span


class AcqResult(NamedTuple):
    """Per-PRN acquisition result (row index = position in the PRN list)."""

    found: torch.Tensor       # bool[P]; peak above threshold
    freq: torch.Tensor        # f32[P]; best Doppler bin
    delay: torch.Tensor       # i32[P]; integer code phase (-1 if none)
    norm_max: torch.Tensor    # f32[P]; peak height in sigmas, best bin
    code_phase: torch.Tensor  # f32[P]; sub-sample peak fit (-1 if none)


def acquire_impl(cfg: ReceiverConfig, block: torch.Tensor,
                 dopplers: torch.Tensor, code_ffts: torch.Tensor
                 ) -> AcqResult:
    """Full-grid acquisition on one block.

    block: complex64[>= acq_noncoherent * sweep_corr_avg * code_samples];
    dopplers: f32[D]; code_ffts: complex64[P, code_samples].
    cfg.acq_noncoherent = k > 1 averages the correlation MAGNITUDE over
    k consecutive sweep windows, each mixed from phase 0.
    """
    cs = cfg.code_samples
    k = max(1, int(cfg.acq_noncoherent))
    n = cfg.sweep_corr_avg * cs
    data = dsp.as_complex_input(block)[:k * n].reshape(1, k, n)
    mixed, _ = dsp.doppler_mix(data, dopplers.to(torch.float32)[:, None],
                               0.0, cfg.sample_rate)            # [D, k, n]
    fft_means = dsp.segment_fft_mean(mixed, cs, 0, cfg.sweep_corr_avg)
    corr = torch.fft.ifft(fft_means[:, :, None, :]
                          * torch.conj(code_ffts)[None, None]
                          ).abs().mean(dim=1)                   # [D, P, cs]
    mean = corr.mean(dim=-1)
    std = corr.std(dim=-1, correction=0)
    peak, mx = corr.max(dim=-1)
    norm = (peak - mean) / std                                  # [D, P]

    best_d = norm.argmax(dim=0)                                 # [P]
    p_idx = torch.arange(code_ffts.shape[0], device=corr.device)
    best_norm = norm[best_d, p_idx]
    best_mx = mx[best_d, p_idx]
    code_phase = dsp.fit_peak(corr[best_d, p_idx], best_mx)
    found = best_norm > cfg.corr_min
    return AcqResult(
        found=found,
        freq=dopplers.to(torch.float32)[best_d],
        delay=torch.where(found, best_mx.to(torch.int32),
                          torch.full_like(best_mx, -1, dtype=torch.int32)),
        norm_max=best_norm,
        code_phase=torch.where(found, code_phase,
                               torch.full_like(code_phase, -1.0)),
    )


def acquire_all(cfg: ReceiverConfig, block, code_fft_table: np.ndarray,
                prns=None, dopplers=None, device="cuda"
                ) -> list[tuple[float, int, float, int]]:
    """Acquire `prns` (default: the full search list) on one host block
    and return the found satellites sorted by correlation strength, as
    (norm_max, prn, freq, delay) tuples.  `dopplers` overrides the
    config's search bins (almanac warm start).  With cfg.cw_excision > 0
    the block's narrowband interference is nulled before the grid
    search, as the tracking chunks' is; acquire_impl does not excise."""
    with span("acq.sweep"):
        dev = resolve_device(device)
        prns = list(cfg.prns if prns is None else prns)
        if dopplers is None:
            dopplers = cfg.doppler_bins
        blk = torch.as_tensor(np.asarray(block, np.complex64), device=dev)
        if cfg.cw_excision > 0:
            blk = excise_cw_block(blk, cfg.cw_excision)
        ffts = torch.as_tensor(
            np.asarray(code_fft_table[np.asarray(prns)], np.complex64),
            device=dev)
        res = acquire_impl(cfg, blk,
                           torch.as_tensor(np.asarray(dopplers, np.float32),
                                           device=dev), ffts)
        found = res.found.cpu().numpy()
        norm = res.norm_max.cpu().numpy()
        freq = res.freq.cpu().numpy()
        delay = res.delay.cpu().numpy()
        out = [(float(norm[i]), prns[i], float(freq[i]), int(delay[i]))
               for i in range(len(prns)) if found[i]]
    return sorted(out, reverse=True)
