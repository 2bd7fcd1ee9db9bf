"""PyTorch port vs JAX at realistic signal levels: tests/test_sensitivity.py
(PRN 9 alone at 50, 45 and 42 dB-Hz) and tests/test_codephase_precision.py
(PRN 17 at noise 0.5), through the K-fused tracking that carries the
kernels on the card (track_chunk_batched / track_chunk_batched_impl at
ReceiverConfig(), K=8; the JAX tests track with the K=1 track_chunk).

The same host streams (the simulator is the same numpy code in both
packages) go through the JAX package and the port's plain path:
acquisition exact (norm_max rtol 1e-4), tracking outputs and states to
tests/test_torch_tracking.py's tolerances.  The JAX tests' bars are then
applied to the port's K-fused outputs: PRN 9 alone, frequency within
step_freq, delay within 1.5 samples, locked, code phase valid > 0.7,
FRQ within 5 Hz, C/N0 within 2 dB, BER 0; code phase RMS < 0.08 and
bias < 0.05 samples, fractional parts spread."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.ops.acquisition import acquire_all as jax_acquire_all
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import cacode
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.ops.acquisition import acquire_all
from tests.test_torch_tracking import _compare

torch.set_num_threads(2)

CFG = ReceiverConfig()
N_BLOCKS = 64
SENS = SatSignal(prn=9, doppler=1234.0, code_delay=800.0,
                 nav_bits=random_bits(400, seed=5))
PREC = SatSignal(prn=17, doppler=-3456.0, code_delay=1023.37,
                 nav_bits=random_bits(128, seed=17))
LEVELS = [(50, 3.18), (45, 5.66), (42, 8.0)]



def _track_both(blocks, prn, freq, delay):
    """K-fused tracking of one channel from reset, in both packages;
    returns the port's outputs as numpy after comparing them to JAX's."""
    jc = JaxConfig(**dataclasses.asdict(CFG))
    states = jtrk.reset_channel(jtrk.init_channel_states(jc, 1), 0, prn,
                                freq, delay, jc)
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(states).items()}
    codes = cacode.ca_table(CFG)[prn][None]
    ffts = cacode.ca_fft_table(CFG)[prn][None]
    jst, jo = jtrk.track_chunk_batched(jc, states, jnp.asarray(blocks),
                                       jnp.int32(1), jnp.asarray(codes),
                                       jnp.asarray(ffts))
    tst, to = ttrk.track_chunk_batched_impl(
        CFG, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks),
        1, torch.from_numpy(codes), torch.from_numpy(ffts))
    # the states' float fields to test_torch_tracking.py's 1e-2, except
    # where carry_sum (the partial ms's sum, ~1000 samples) is large: at
    # cs 2048 it reaches |700-860| against ~1 there, and the two
    # packages' f32 sums differ by ~2e-5 of it (1.3e-2 at noise 0.5,
    # rotated 1.9e-5 rad), so it is held to 1e-4 of its magnitude
    tree = jtrk.pack_states(jst)
    carry = float(np.hypot(tree["carry_sum__re"],
                           tree["carry_sum__im"]).max())
    _compare(jst, jo, tst, to, state_atol=max(1e-2, 1e-4 * carry))
    return ttrk.outs_to_numpy(to)


@pytest.mark.parametrize("cn0,noise", LEVELS)
def test_sensitivity_k_fused_matches_jax(cn0, noise):
    blocks = synth_stream(CFG, [SENS], N_BLOCKS, noise_std=noise, seed=3)
    prns = list(range(2, 33))
    found = acquire_all(CFG, blocks[0], cacode.ca_fft_table(CFG),
                        prns=prns, device="cpu")
    jfound = jax_acquire_all(JaxConfig(**dataclasses.asdict(CFG)),
                             blocks[0], cacode.ca_fft_table(CFG), prns=prns)
    assert [f[1:] for f in found] == [f[1:] for f in jfound]
    np.testing.assert_allclose([f[0] for f in found],
                               [f[0] for f in jfound], rtol=1e-4)
    assert len(CFG.doppler_bins) == 51

    # the JAX test's bars, on the port
    assert [f[1] for f in found] == [9], f"at {cn0} dB-Hz: {found}"
    _, _, freq, delay = found[0]
    assert abs(freq - SENS.doppler) <= CFG.step_freq
    assert abs(delay - SENS.code_delay) <= 1.5
    o = _track_both(blocks, 9, freq, delay)
    assert o.locked[-1, 0]
    assert (o.code_phase[:, 0] >= 0).mean() > 0.7
    assert abs(o.freq[-1, 0] - SENS.doppler) < 5.0
    truth = 10 * np.log10(CFG.sample_rate / (2 * noise ** 2))
    est = float(np.mean(ttrk.cn0_from_amp(o.amplitude[32:, 0])))
    assert abs(est - truth) < 2.0, (est, truth)
    assert chip_smoke.decoded_ber(CFG, o, SENS) == 0.0


def test_codephase_precision_k_fused_matches_jax():
    blocks = synth_stream(CFG, [PREC], N_BLOCKS, noise_std=0.5, seed=4)
    o = _track_both(blocks, 17, PREC.doppler, int(PREC.code_delay))
    got = o.code_phase[:, 0]
    fs, cs = CFG.sample_rate, CFG.code_samples
    n_center = np.arange(N_BLOCKS) * CFG.ngps + CFG.ngps // 2
    true = (PREC.code_delay + PREC.delay_rate(CFG) * (n_center / fs)) % cs
    ok = got >= 0
    assert ok.mean() > 0.9
    err = ((got[ok] - true[ok] + cs / 2) % cs - cs / 2)[5:]
    assert float(np.sqrt(np.mean(err ** 2))) < 0.08
    assert abs(float(np.mean(err))) < 0.05
    frac = o.code_phase[5:, 0]
    assert np.std(frac[frac >= 0] % 1.0) > 0.05
