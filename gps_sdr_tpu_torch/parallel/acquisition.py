"""Sharded cold-start acquisition: (Doppler bins x PRNs) over the mesh.

Port of gps_sdr_tpu/parallel/acquisition.py.  The single-device
acquire_impl evaluates the whole grid at once; here the grid itself is
partitioned, Doppler bins over the ``time`` axis and PRN rows over the
``ch`` axis, so a stress-size grid (32 PRNs x +-10 kHz) splits over
devices.  Every bin's normalized-peak statistic comes from its own
correlation curve, so sharding the grid is exact; the only collective
is an all_gather of the small per-(shard, PRN) best records over the
Doppler axis.
"""

from __future__ import annotations

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.ops.acquisition import AcqResult, acquire_impl
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
    padded PRN rows are dropped from the result).  Per PRN the Doppler
    shard with the largest norm_max wins (the first on a tie, as
    jnp.argmax).  Returns an AcqResult of numpy arrays; across processes
    every rank returns the whole result."""
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
        res[ti, ci] = tuple(acquire_impl(
            cfg, on_dev[dev],
            torch.as_tensor(dop[ti * d_loc:(ti + 1) * d_loc]).to(dev),
            torch.as_tensor(ffts[ci * p_loc:(ci + 1) * p_loc]).to(dev)))
    res = mesh.all_gather(res, mesh.home)
    cols = []
    for ci in range(c_size):
        # [t_size, p_loc] a field; pick the Doppler shard with the best
        # peak, per PRN row
        fields = [torch.stack(f) for f in zip(*(res[ti, ci]
                                                for ti in range(t_size)))]
        best = torch.argmax(fields[AcqResult._fields.index("norm_max")],
                            dim=0)
        cols.append([torch.take_along_dim(f, best[None], dim=0)[0]
                     for f in fields])
    return AcqResult(*(torch.cat(f)[:n_prn].cpu().numpy()
                       for f in zip(*cols)))
