"""Batched cold-start / re-acquisition over the PRN x Doppler grid.

Port of gps_sdr_tpu/ops/acquisition.py: every Doppler bin x every PRN x
all code phases is evaluated on one block in one batched program —
mix the block with all bins at once ([D, k, n]), FFT-average
`sweep_corr_avg` code periods per bin, multiply against all code FFTs
([D, k, P, cs]), inverse FFT, and reduce.  Like the JAX version it
records the BEST Doppler bin per PRN (the reference records the first
bin above the threshold), the bin of the largest normalized peak
(peak - mean) / std, but only among the bins of the PRN's main lobe:
those whose peak reaches half the PRN's largest.  The JAX version ranks
every bin, and with many satellites above the noise their
cross-correlation raises the right bin's std enough that a sidelobe bin
~400 Hz off can win.  A PRN is found only if its peak also recurs, at
its bin and code phase, in one of the block's next two sweep windows
(peak_recurs): with many satellites above the noise, a noise peak lifted
by their cross-correlation passes the threshold in one window now and
then, and the JAX version takes it for a satellite.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops import dsp
from gps_sdr_tpu_torch.ops.frontend import excise_cw_block
from gps_sdr_tpu_torch.utils.profiling import count, span


class AcqResult(NamedTuple):
    """Per-PRN acquisition result (row index = position in the PRN list)."""

    found: torch.Tensor       # bool[P]; peak above threshold
    freq: torch.Tensor        # f32[P]; best Doppler bin
    delay: torch.Tensor       # i32[P]; integer code phase (-1 if none)
    norm_max: torch.Tensor    # f32[P]; peak height in sigmas, best bin
    code_phase: torch.Tensor  # f32[P]; sub-sample peak fit (-1 if none)


def grid_stats(cfg: ReceiverConfig, block: torch.Tensor,
               dopplers: torch.Tensor, code_ffts: torch.Tensor):
    """The correlation over the grid and its per-bin statistics:
    (corr f32[D, P, cs], peak f32[D, P], its code phase mx i64[D, P],
    norm = (peak - mean) / std f32[D, P]).

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
    return corr, peak, mx, (peak - mean) / std


def main_lobe_bins(peak: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Per PRN (axis 1), the bin (axis 0) of the largest norm among the
    bins whose peak reaches half the PRN's largest: the main lobe of the
    Doppler response, whose sidelobes stay under a quarter of it.  The
    first such bin on a tie."""
    main = peak >= 0.5 * peak.amax(dim=0, keepdim=True)
    return torch.where(main, norm, torch.full_like(norm, -torch.inf)
                       ).argmax(dim=0)


RECUR_WINDOWS = 2


def peak_recurs(cfg: ReceiverConfig, block: torch.Tensor,
                freq: torch.Tensor, mx: torch.Tensor,
                code_ffts: torch.Tensor) -> torch.Tensor:
    """bool[P]: whether each PRN's peak, found in the block's first sweep
    window at Doppler freq[P] and code phase mx[P], shows again in one
    of the next RECUR_WINDOWS windows: the correlation there, at mx or
    one sample either side, stands more than cfg.corr_min stds above its
    mean.  A satellite's peak stays put from window to window, and a bit
    edge can cancel it in one window only; a noise peak does not recur.
    All True where the block holds no window past the first."""
    cs = cfg.code_samples
    k = max(1, int(cfg.acq_noncoherent))
    n = cfg.sweep_corr_avg * cs
    data = dsp.as_complex_input(block)
    w = min(RECUR_WINDOWS, data.shape[-1] // (k * n) - 1)
    if w < 1:
        return torch.ones(mx.shape, dtype=torch.bool, device=mx.device)
    wins = data[k * n:(w + 1) * k * n].reshape(w, 1, k, n)
    mixed, _ = dsp.doppler_mix(wins, freq.to(torch.float32)[:, None], 0.0,
                               cfg.sample_rate)                 # [w, P, k, n]
    spec = dsp.segment_fft_mean(mixed, cs, 0, cfg.sweep_corr_avg)
    corr = torch.fft.ifft(spec * torch.conj(code_ffts)[None, :, None]
                          ).abs().mean(dim=2)                   # [w, P, cs]
    at = (mx.to(torch.int64)[:, None]
          + torch.arange(-1, 2, device=mx.device)) % cs         # [P, 3]
    near = corr.gather(-1, at.expand(w, -1, -1)).amax(dim=-1)   # [w, P]
    stat = (near - corr.mean(dim=-1)) / corr.std(dim=-1, correction=0)
    return (stat > cfg.corr_min).any(dim=0)


def result(cfg: ReceiverConfig, dopplers: torch.Tensor,
           best_d: torch.Tensor, norm: torch.Tensor, mx: torch.Tensor,
           code_phase: torch.Tensor, recurs: torch.Tensor) -> AcqResult:
    """The AcqResult of the bins `best_d` [P], from the [P] statistics
    of those bins and whether each peak recurs (peak_recurs)."""
    found = (norm > cfg.corr_min) & recurs
    return AcqResult(
        found=found,
        freq=dopplers.to(torch.float32)[best_d],
        delay=torch.where(found, mx.to(torch.int32),
                          torch.full_like(mx, -1, dtype=torch.int32)),
        norm_max=norm,
        code_phase=torch.where(found, code_phase,
                               torch.full_like(code_phase, -1.0)),
    )


def acquire_impl(cfg: ReceiverConfig, block: torch.Tensor,
                 dopplers: torch.Tensor, code_ffts: torch.Tensor
                 ) -> AcqResult:
    """Full-grid acquisition on one block (arguments as grid_stats)."""
    corr, peak, mx, norm = grid_stats(cfg, block, dopplers, code_ffts)
    best_d = main_lobe_bins(peak, norm)                         # [P]
    p_idx = torch.arange(code_ffts.shape[0], device=corr.device)
    best_mx = mx[best_d, p_idx]
    code_phase = dsp.fit_peak(corr[best_d, p_idx], best_mx)
    recurs = peak_recurs(cfg, block, dopplers[best_d], best_mx, code_ffts)
    return result(cfg, dopplers, best_d, norm[best_d, p_idx], best_mx,
                  code_phase, recurs)


def acquire_all(cfg: ReceiverConfig, block, code_fft_table: np.ndarray,
                prns=None, dopplers=None, device="cuda"
                ) -> list[tuple[float, int, float, int]]:
    """Acquire `prns` (default: the full search list) on one host block
    (complex64, or a capture's packed words: dsp.host_iq) and return
    the found satellites sorted by correlation strength, as
    (norm_max, prn, freq, delay) tuples.  `dopplers` overrides the
    config's search bins (almanac warm start).  With cfg.cw_excision > 0
    the block's narrowband interference is nulled before the grid
    search, as the tracking chunks' is; acquire_impl does not excise."""
    with span("acq.sweep"):
        dev = resolve_device(device)
        prns = list(cfg.prns if prns is None else prns)
        if dopplers is None:
            dopplers = cfg.doppler_bins
        blk = dsp.host_iq(block, dev)
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
        count("acq.prns", len(prns))
        count("acq.found", len(out))
    return sorted(out, reverse=True)
