"""Sharded cold-start acquisition: (Doppler bins x PRNs) over the mesh.

Port of gps_sdr_tpu/parallel/acquisition.py.  The single-device
acquire_impl evaluates the whole grid at once; here the grid itself is
partitioned, Doppler bins over the ``time`` axis and PRN rows over the
``ch`` axis, so a stress-size grid (32 PRNs x +-10 kHz) splits over
devices.  Every bin's peak and normalized-peak statistic come from its
own correlation curve, so sharding the grid is exact; the only
collective is an all_gather of the small per-(bin, PRN) statistics,
from which the bins are picked as acquire_impl picks them.
"""

from __future__ import annotations

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.ops import dsp
from gps_sdr_tpu_torch.ops.acquisition import (AcqResult, grid_stats,
                                               main_lobe_bins, peak_recurs,
                                               result)
from gps_sdr_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh


def _pad_to(x: np.ndarray, mult: int, axis: int = 0) -> np.ndarray:
    """Pad `axis` up to a multiple of `mult` by repeating index 0: a
    padded Doppler bin then ties with bin 0, and the first-maximum pick
    keeps bin 0."""
    n = x.shape[axis]
    rem = (-n) % mult
    if rem == 0:
        return x
    take = np.take(x, np.zeros(rem, np.int64), axis=axis)
    return np.concatenate([x, take], axis=axis)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def acquire_sharded(cfg: ReceiverConfig, mesh: Mesh, block,
                    dopplers: np.ndarray, code_ffts) -> AcqResult:
    """Full-grid acquisition sharded over `mesh`; host-friendly wrapper.

    block: complex64[>= sweep_corr_avg*code_samples] or any IQ layout
    acquire_impl takes; dopplers: f32[D]; code_ffts: complex64[P, cs]
    (numpy or tensors).
    Pads D / P up to mesh-axis multiples (padded rows repeat row 0;
    padded PRN rows are dropped from the result).  Each shard hands back
    every bin's peak, normalized peak, code phase and sub-sample fit;
    per PRN the bin is then picked over the whole grid by acquire_impl's
    rule (main_lobe_bins), and its peak held to the block's next sweep
    windows (peak_recurs) on the home device.  Returns an AcqResult of
    numpy arrays; across processes every rank returns the whole
    result."""
    t_size = mesh.shape[TIME_AXIS]
    c_size = mesh.shape[CH_AXIS]
    ffts = _host(code_ffts).astype(np.complex64)
    n_prn = ffts.shape[0]
    dop = _pad_to(np.asarray(dopplers, np.float32), t_size)
    ffts = _pad_to(ffts, c_size)
    d_loc, p_loc = dop.shape[0] // t_size, ffts.shape[0] // c_size
    blk = _host(block)
    on_dev = {}
    res = {}
    for ti, ci in mesh.local_positions():
        dev = mesh.devices[ti, ci]
        if dev not in on_dev:
            on_dev[dev] = torch.as_tensor(blk).to(dev)
        corr, peak, mx, norm = grid_stats(
            cfg, on_dev[dev],
            torch.as_tensor(dop[ti * d_loc:(ti + 1) * d_loc]).to(dev),
            torch.as_tensor(ffts[ci * p_loc:(ci + 1) * p_loc]).to(dev))
        res[ti, ci] = (peak, norm, mx, dsp.fit_peak(corr, mx))
    res = mesh.all_gather(res, mesh.home)
    dop_t = torch.from_numpy(dop).to(mesh.home)
    blk_home = torch.as_tensor(blk).to(mesh.home)
    cols = []
    for ci in range(c_size):
        # [D, p_loc] a statistic, the Doppler shards in order
        peak, norm, mx, fit = (torch.cat([res[ti, ci][j]
                                          for ti in range(t_size)])
                               for j in range(4))
        best = main_lobe_bins(peak, norm)
        p_idx = torch.arange(peak.shape[1], device=peak.device)
        col_ffts = torch.as_tensor(ffts[ci * p_loc:(ci + 1) * p_loc]
                                   ).to(mesh.home)
        recurs = peak_recurs(cfg, blk_home, dop_t[best], mx[best, p_idx],
                             col_ffts)
        cols.append(result(cfg, dop_t, best, norm[best, p_idx],
                           mx[best, p_idx], fit[best, p_idx], recurs))
    return AcqResult(*(torch.cat(f)[:n_prn].cpu().numpy()
                       for f in zip(*cols)))
