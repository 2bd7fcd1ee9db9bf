"""PyTorch port vs JAX: device-side parametric synthesis
(models/sim_dev.py DeviceSynth against models/sim_jax.py JaxSynth).

  * with noise off, DeviceSynth on the CPU against JaxSynth on the same
    satellites, at the product config and the small test config, with
    tests/test_sim_jax.py's tolerance (the 0.999 quantile of |error| <
    6e-3, the mean < 1e-3: f32 code positions round differently at chip
    transitions), and the per-block origins equal;
  * chunking: a two-block request equals two one-block requests bit for
    bit, with noise on (noise is keyed by the absolute block);
  * the grouped planar layout equals the complex one, bit for bit."""

import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.models.sim_jax import JaxSynth
from gps_sdr_tpu_torch import DeviceSynth
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits
from tests.test_torch_device_path import CFG as SMALL
from tests.test_torch_device_path import _jax

torch.set_num_threads(2)


def _sats(cs):
    """tests/test_sim_jax.py's satellites (delays scaled to cs), plus
    one with a bit offset."""
    f = cs / 2048
    return [
        SatSignal(prn=9, doppler=3211.0, code_delay=731.6 * f,
                  amplitude=1.1, carrier_phase=0.8,
                  nav_bits=random_bits(256, seed=9)),
        SatSignal(prn=17, doppler=-4790.0, code_delay=2047.2 * f,
                  amplitude=0.8, nav_bits=random_bits(256, seed=17)),
        # near-zero drift: exercises the no-drift-step path
        SatSignal(prn=21, doppler=10.0, code_delay=0.4,
                  nav_bits=random_bits(256, seed=21)),
        SatSignal(prn=3, doppler=-1234.5, code_delay=100.3 * f,
                  amplitude=0.6, bit_offset_ms=13,
                  nav_bits=random_bits(256, seed=3)),
    ]


@pytest.mark.parametrize("cfg,first_block", [
    (ReceiverConfig(), 0), (ReceiverConfig(), 200), (SMALL, 0),
    (SMALL, 7), (SMALL, 3001)], ids=["product-0", "product-200",
                                     "small-0", "small-7", "small-3001"])
def test_matches_jax_synth(cfg, first_block):
    sats = _sats(cfg.code_samples)
    jcfg = JaxConfig() if cfg == ReceiverConfig() else _jax(cfg)
    want = np.asarray(JaxSynth(jcfg, sats, noise_std=0.0).chunk(
        first_block, 2))
    dev = DeviceSynth(cfg, sats, noise_std=0.0, device="cpu")
    got = dev.chunk(first_block, 2).numpy()
    assert got.shape == want.shape == (2, cfg.ngps)
    assert got.dtype == np.complex64
    err = np.abs(got - want)
    assert np.quantile(err, 0.999) < 6e-3
    assert err.mean() < 1e-3
    idx = np.arange(first_block, first_block + 2)
    jo = JaxSynth(jcfg, sats, noise_std=0.0)._origins(idx)
    for a, b in zip(dev._origins(idx), jo):
        np.testing.assert_array_equal(a, b)


def test_chunk_continuity():
    dev = DeviceSynth(SMALL, _sats(SMALL.code_samples), noise_std=0.5,
                      seed=4, device="cpu")
    whole = dev.chunk_planar(3, 20)
    parts = torch.cat([dev.chunk_planar(3, 9), dev.chunk_planar(12, 11)])
    assert torch.equal(whole, parts)
    assert torch.equal(dev.chunk(3, 20), dev.chunk(3, 20))
    blocks = list(dev.blocks(3, 2))
    assert torch.equal(torch.stack(blocks), dev.chunk(3, 2))


def test_planar_layout_matches_complex():
    cfg = SMALL
    dev = DeviceSynth(cfg, _sats(cfg.code_samples), noise_std=0.3, seed=9,
                      device="cpu")
    planar = dev.chunk_planar(1, 2)
    cplx = dev.chunk(1, 2)
    assert tuple(planar.shape) == (2, 2, cfg.n_cyc, cfg.code_samples)
    assert planar.dtype == torch.float32
    flat = planar.reshape(2, 2, cfg.ngps)
    assert torch.equal(flat[:, 0], cplx.real)
    assert torch.equal(flat[:, 1], cplx.imag)
    assert torch.equal(dev.block(1), cplx[0])
