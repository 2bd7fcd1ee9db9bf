"""PyTorch port vs JAX: the DSP primitives (ops/dsp.py).

The same numpy inputs go through gps_sdr_tpu.ops.dsp (JAX on the CPU)
and gps_sdr_tpu_torch.ops.dsp (plain PyTorch on the CPU).  Tolerance:
rtol 1e-5 with an absolute floor of 1e-5 for unit-scale f32 values
(the two frameworks round the oscillator and the FFT sums in a
different order, ~1e-7 relative per op)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr_tpu.ops import cacode
from gps_sdr_tpu.ops import dsp as jdsp
from gps_sdr_tpu_torch.ops import dsp as tdsp

torch.set_num_threads(2)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2)
SAT = SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                nav_bits=random_bits(64, seed=5))
RTOL, ATOL = 1e-5, 1e-5


def _block():
    return synth_stream(CFG, [SAT], 1, noise_std=0.2, seed=9)[0]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("layout", ["complex", "pairs", "planar"])
def test_as_complex_input(layout):
    x = _block()[:64]
    if layout == "pairs":
        x = np.stack([x.real, x.imag], axis=-1)
    elif layout == "planar":
        x = np.stack([x.real, x.imag], axis=-2)
    _close(tdsp.as_complex_input(torch.from_numpy(x)).numpy(),
           jdsp.as_complex_input(jnp.asarray(x)))


@pytest.mark.parametrize("freq,phase", [(987.0, 0.3), (-2210.0, 5.9)])
def test_doppler_mix(freq, phase):
    x = _block()
    jm, jp = jdsp.doppler_mix(jnp.asarray(x), freq, phase, CFG.sample_rate)
    tm, tp = tdsp.doppler_mix(torch.from_numpy(x), freq, phase,
                              CFG.sample_rate)
    _close(tm.numpy(), jm)
    _close(tp.numpy(), jp)


def test_segment_fft_mean_and_circ_correlate():
    x = _block()
    code_fft = cacode.ca_fft_table(CFG)[SAT.prn].copy()
    jf = jdsp.segment_fft_mean(jnp.asarray(x), CFG.code_samples, 2, 4)
    tf = tdsp.segment_fft_mean(torch.from_numpy(x), CFG.code_samples, 2, 4)
    scale = float(np.abs(np.asarray(jf)).max())
    _close(tf.numpy(), jf, atol=ATOL * scale)
    jc = jdsp.circ_correlate(jf, jnp.asarray(code_fft))
    tc = tdsp.circ_correlate(tf, torch.from_numpy(code_fft))
    _close(tc.numpy(), jc, atol=ATOL * float(np.asarray(jc).max()))


def _corr_curve():
    x = _block()
    code_fft = cacode.ca_fft_table(CFG)[SAT.prn].copy()
    return np.array(jdsp.circ_correlate(
        jdsp.segment_fft_mean(jnp.asarray(x), CFG.code_samples, 2, 4),
        jnp.asarray(code_fft)))


@pytest.mark.parametrize("mx", [0, 77, 255])
def test_fit_peak(mx):
    corr = _corr_curve()
    _close(tdsp.fit_peak(torch.from_numpy(corr), torch.tensor(mx)).numpy(),
           jdsp.fit_peak(jnp.asarray(corr), jnp.int32(mx)))


@pytest.mark.parametrize("corr_min", [8.0, 1e6])
def test_peak_metrics(corr_min):
    corr = _corr_curve()
    jd, jc, jn = jdsp.peak_metrics(jnp.asarray(corr), corr_min)
    td, tc, tn = tdsp.peak_metrics(torch.from_numpy(corr), corr_min)
    assert int(td) == int(jd)                      # integer: exact
    _close(tc.numpy(), jc)
    _close(tn.numpy(), jn)


@pytest.mark.parametrize("delay", [0, 1, 77, 255])
def test_roll_code(delay):
    code = cacode.ca_table(CFG)[SAT.prn].copy()
    got = tdsp.roll_code(torch.from_numpy(code), torch.tensor(delay))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jdsp.roll_code(jnp.asarray(code), jnp.int32(delay))))
    np.testing.assert_array_equal(got.numpy(), np.roll(code, delay))
