"""PyTorch port vs JAX: the K-block heavy stage (ops/hopper_wipeoff.py).

The port's heavy stage on a CPU tensor runs the plain PyTorch twin of
the CUDA wipeoff kernel.  It is held against
  * heavy_stage_pallas with the MXU wipeoff kernel, in Pallas interpret
    mode on the CPU (as tests/test_pallas_kernels.py runs it), and
  * the XLA heavy stage,
with the tolerances the JAX package holds its own Pallas kernel to:
delay exact, code_phase atol 5e-3 samples, norm_max rtol 2e-3, head and
segment sums atol 2e-3, phase_end atol 1e-3 rad (the MXU kernel rounds
its inputs to bf16; the XLA path factorizes the NCO over the whole
K-block step instead of per block)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr_tpu.ops import cacode
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.ops.pallas_kernels import heavy_stage_pallas
from gps_sdr_tpu_torch.ops import hopper_wipeoff
from gps_sdr_tpu_torch.ops import tracking as ttrk

torch.set_num_threads(2)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2)
K = CFG.blocks_per_step
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(64, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(64, seed=12))]


def _setup(n_blocks, delays=None):
    blocks = synth_stream(CFG, SATS, n_blocks, noise_std=0.2, seed=9)
    states = jtrk.init_channel_states(CFG, 2)
    codes = np.zeros((2, CFG.code_samples), np.float32)
    ffts = np.zeros((2, CFG.code_samples), np.complex64)
    for i, s in enumerate(SATS):
        d = int(s.code_delay) if delays is None else delays[i]
        states = jtrk.reset_channel(states, i, s.prn, s.doppler, d, CFG)
        codes[i] = cacode.ca_table(CFG)[s.prn]
        ffts[i] = cacode.ca_fft_table(CFG)[s.prn]
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(states).items()}
    return states, tree, blocks, codes, ffts


def _port_heavy(tree, blocks, codes, ffts, step=0):
    return ttrk.heavy_stage(CFG, K, ttrk.states_from_numpy(tree, "cpu"),
                            torch.from_numpy(blocks), step,
                            torch.from_numpy(codes), torch.from_numpy(ffts))


def _compare(want, got):
    np.testing.assert_array_equal(got.delay_k.numpy(),
                                  np.asarray(want.delay_k))
    np.testing.assert_array_equal(got.new_delay_k.numpy(),
                                  np.asarray(want.new_delay_k))
    np.testing.assert_array_equal(got.wipe_delay.numpy(),
                                  np.asarray(want.wipe_delay))
    np.testing.assert_allclose(got.code_phase_k.numpy(),
                               np.asarray(want.code_phase_k), atol=5e-3)
    np.testing.assert_allclose(got.norm_max_k.numpy(),
                               np.asarray(want.norm_max_k), rtol=2e-3)
    np.testing.assert_allclose(got.head_k.numpy(), np.asarray(want.head_k),
                               atol=2e-3)
    np.testing.assert_allclose(got.seg_sums_k.numpy(),
                               np.asarray(want.seg_sums_k), atol=2e-3)
    np.testing.assert_allclose(got.phase_end.numpy(),
                               np.asarray(want.phase_end), atol=1e-3)


# delays near both ends of the code period exercise the roll direction
# and the head mask (col < delay) on the rolled code
@pytest.mark.parametrize("delays", [None, (0, 255), (1, 128)])
def test_heavy_stage_matches_pallas_mxu(delays):
    states, tree, blocks, codes, ffts = _setup(K, delays)
    cfg = CFG.replace(use_mxu_wipeoff=True)
    want = heavy_stage_pallas(cfg, K, states, jnp.asarray(blocks),
                              jnp.asarray(codes), jnp.asarray(ffts))
    _compare(want, _port_heavy(tree, blocks, codes, ffts))


@pytest.mark.parametrize("delays", [None, (0, 255)])
def test_heavy_stage_matches_xla(delays):
    states, tree, blocks, codes, ffts = _setup(K, delays)
    want = jtrk.heavy_stage(CFG, K, states, jnp.asarray(blocks),
                            jnp.asarray(codes), jnp.asarray(ffts))
    _compare(want, _port_heavy(tree, blocks, codes, ffts))


def test_heavy_stage_reads_its_step_of_the_chunk():
    """The kernel contract reads block step*K + b of the WHOLE chunk."""
    states, tree, blocks, codes, ffts = _setup(3 * K)
    cfg = CFG.replace(use_mxu_wipeoff=True)
    want = heavy_stage_pallas(cfg, K, states, jnp.asarray(blocks[2 * K:]),
                              jnp.asarray(codes), jnp.asarray(ffts))
    _compare(want, _port_heavy(tree, blocks, codes, ffts, step=2))


def test_plain_wipeoff_matches_numpy_definition():
    """The plain twin against a direct float64 numpy evaluation of the
    kernel contract: np.roll for the code, col < w for the head."""
    _, tree, blocks, codes, _ = _setup(K)
    st = ttrk.states_from_numpy(tree, "cpu")
    s = 2 * np.pi * st.freq / CFG.sample_rate
    snp = torch.remainder(s * CFG.ngps, 2 * np.pi)
    wipe = torch.tensor([[3, 60, 200, 255], [0, 1, 2, 128]],
                        dtype=torch.int32)
    center, head, seg = hopper_wipeoff.mix_wipeoff(
        CFG, K, s, snp, st.phase, wipe, torch.from_numpy(blocks), 0,
        torch.from_numpy(codes))
    cs, n_cyc = CFG.code_samples, CFG.n_cyc
    n = np.arange(CFG.ngps)
    for c in range(2):
        for b in range(K):
            ang = (float(st.phase[c]) + float(snp[c]) * b
                   + float(s[c]) * (n + 1))
            mixed = (blocks[b].astype(np.complex128)
                     * np.exp(-1j * ang)).reshape(n_cyc, cs)
            prod = mixed * np.roll(codes[c], int(wipe[c, b]))
            lo = prod[:, :int(wipe[c, b])].sum(axis=1)
            full = prod.sum(axis=1)
            want_seg = full - lo + np.append(lo[1:], 0)
            first = (n_cyc - CFG.corr_avg) // 2
            scale = np.abs(want_seg).max()
            np.testing.assert_allclose(head[c, b].numpy(), lo[0],
                                       atol=1e-4 * scale)
            np.testing.assert_allclose(seg[c, b].numpy(), want_seg,
                                       atol=1e-4 * scale)
            np.testing.assert_allclose(
                center[b, c].numpy(),
                mixed[first:first + CFG.corr_avg].mean(axis=0), atol=1e-4)
