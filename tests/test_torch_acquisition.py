"""PyTorch port vs JAX: full-grid acquisition (ops/acquisition.py).

One synthesized block goes through both acquire_all functions.  The
found list (PRN, Doppler bin, integer delay) must match exactly; the
peak heights norm_max to rtol 1e-4 (f32 FFT sums in a different order,
~1e-6 relative, divided by a std over 256 lags)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr_tpu.ops import acquisition as jacq
from gps_sdr_tpu.ops import cacode
from gps_sdr_tpu_torch.ops import acquisition as tacq

torch.set_num_threads(2)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(64, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(64, seed=12))]


def _compare(want, got):
    assert [w[1:] for w in want] == [g[1:] for g in got]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)


@pytest.mark.parametrize("noncoherent", [1, 4])
def test_acquire_all_matches_jax(noncoherent):
    cfg = CFG.replace(acq_noncoherent=noncoherent)
    block = synth_stream(cfg, SATS, 1, noise_std=0.2, seed=9)[0]
    table = cacode.ca_fft_table(cfg)
    want = jacq.acquire_all(cfg, block, table)
    got = tacq.acquire_all(cfg, block, table, device="cpu")
    assert {g[1] for g in got} >= {5, 12}
    _compare(want, got)


def test_acquire_all_warm_grid_matches_jax():
    """Narrowed PRN list and Doppler grid (the almanac warm start)."""
    block = synth_stream(CFG, SATS, 1, noise_std=0.2, seed=9)[0]
    table = cacode.ca_fft_table(CFG)
    prns, bins = [3, 5, 12, 20], np.arange(-2400.0, 1201.0, 200.0)
    want = jacq.acquire_all(CFG, block, table, prns=prns, dopplers=bins)
    got = tacq.acquire_all(CFG, block, table, prns=prns, dopplers=bins,
                           device="cpu")
    _compare(want, got)


def test_acquire_impl_fields_match_jax():
    """Every per-PRN field of the raw result, found or not."""
    block = synth_stream(CFG, SATS, 1, noise_std=0.2, seed=9)[0]
    ffts = cacode.ca_fft_table(CFG)[np.asarray(CFG.prns)]
    bins = CFG.doppler_bins.astype(np.float32)
    want = jacq.acquire(CFG, jnp.asarray(block), jnp.asarray(bins),
                        jnp.asarray(ffts))
    got = tacq.acquire_impl(CFG, torch.from_numpy(block),
                            torch.from_numpy(bins), torch.from_numpy(ffts))
    np.testing.assert_array_equal(got.found.numpy(),
                                  np.asarray(want.found) > 0.5)
    np.testing.assert_array_equal(got.freq.numpy(), np.asarray(want.freq))
    np.testing.assert_array_equal(got.delay.numpy(),
                                  np.asarray(want.delay).astype(np.int32))
    np.testing.assert_allclose(got.norm_max.numpy(),
                               np.asarray(want.norm_max), rtol=1e-4)
    # sub-sample fit: ratios of f32 correlation values near the peak
    np.testing.assert_allclose(got.code_phase.numpy(),
                               np.asarray(want.code_phase), atol=1e-3)
