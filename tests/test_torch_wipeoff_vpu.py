"""PyTorch port vs JAX: the block-stationary wipeoff kernel's plain
version (ops/hopper_wipeoff.py mix_wipeoff_vpu, csrc/wipeoff_vpu.cu).

On a CPU tensor the port's heavy stage with use_mxu_wipeoff=False runs
mix_wipeoff_vpu_plain on the grouped planar chunk.  It is held against
heavy_stage_pallas with use_pallas_kernels=True, use_mxu_wipeoff=False
(the per-channel VPU Pallas kernel, in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it), with that test's tolerances:
delay exact, code_phase atol 5e-3 samples, norm_max rtol 2e-3, head and
segment sums atol 2e-3, phase_end atol 1e-3 rad.  The two plain versions
of the port (planar and complex input) share their arithmetic, so they
agree exactly, and so does fused tracking over either layout.

The CUDA kernel sums the raw samples against per-column weights and
rotates each period's sums once; _mix_wipeoff_vpu_math mirrors that
order of arithmetic on the CPU and is held against the interpret-mode
Pallas mix_wipeoff and the plain math within the card check's bound
(1e-4 of the largest magnitude: f32 sums over up to 2048 samples taken
in another order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.ops.pallas_kernels import heavy_stage_pallas
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import cacode, hopper_wipeoff
from gps_sdr_tpu_torch.ops import tracking as ttrk

torch.set_num_threads(2)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2, use_mxu_wipeoff=False)
K = CFG.blocks_per_step
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(64, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(64, seed=12))]


def _jax(cfg):
    """The JAX package's config with the same fields."""
    return JaxConfig(**dataclasses.asdict(cfg))


def _setup(n_blocks, delays=None):
    blocks = synth_stream(CFG, SATS, n_blocks, noise_std=0.2, seed=9)
    states = jtrk.init_channel_states(_jax(CFG), 2)
    codes = np.zeros((2, CFG.code_samples), np.float32)
    ffts = np.zeros((2, CFG.code_samples), np.complex64)
    for i, s in enumerate(SATS):
        d = int(s.code_delay) if delays is None else delays[i]
        states = jtrk.reset_channel(states, i, s.prn, s.doppler, d,
                                    _jax(CFG))
        codes[i] = cacode.ca_table(CFG)[s.prn]
        ffts[i] = cacode.ca_fft_table(CFG)[s.prn]
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(states).items()}
    return states, tree, blocks, codes, ffts


def _planar(blocks):
    return ttrk.to_grouped_planar(CFG, torch.from_numpy(blocks))


def _wipeoff_args(tree, k=K):
    st = ttrk.states_from_numpy(tree, "cpu")
    s = 2 * np.pi * st.freq / CFG.sample_rate
    snp = torch.remainder(s * CFG.ngps, 2 * np.pi)
    wipe = ttrk.predict_wipe_delays(CFG, k, st.freq, st.delay)
    return s, snp, st.phase, wipe


# delays 0, 1, 128 and 255 (cs = 256): both ends of the code period for
# the roll direction and the head mask (col < delay), and the middle
@pytest.mark.parametrize("delays", [None, (0, 255), (1, 128)])
def test_heavy_stage_matches_pallas_vpu(delays):
    states, tree, blocks, codes, ffts = _setup(K, delays)
    jcfg = _jax(CFG).replace(use_pallas_kernels=True)
    want = heavy_stage_pallas(jcfg, K, states, jnp.asarray(blocks),
                              jnp.asarray(codes), jnp.asarray(ffts))
    got = ttrk.heavy_stage(CFG, K, ttrk.states_from_numpy(tree, "cpu"),
                           _planar(blocks), 0, torch.from_numpy(codes),
                           torch.from_numpy(ffts))
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


@pytest.mark.parametrize("step", [0, 2])
@pytest.mark.parametrize("delays", [(0, 255), (1, 128)])
def test_vpu_plain_equals_mxu_plain(delays, step):
    """The planar plain version reads block step*K + b of the whole
    grouped planar chunk and gives what the complex one gives."""
    _, tree, blocks, codes, _ = _setup(3 * K, delays)
    s, snp, phase, wipe = _wipeoff_args(tree)
    codes = torch.from_numpy(codes)
    got = hopper_wipeoff.mix_wipeoff_vpu(CFG, K, s, snp, phase, wipe,
                                         _planar(blocks), step, codes)
    want = hopper_wipeoff.mix_wipeoff_plain(CFG, K, s, snp, phase, wipe,
                                            torch.from_numpy(blocks), step,
                                            codes)
    assert [tuple(g.shape) for g in got] == [(K, 2, CFG.code_samples),
                                             (2, K), (2, K, CFG.n_cyc)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("n_blocks", [16, 18])   # 18: a K=1 tail
def test_tracking_over_planar_equals_complex(n_blocks):
    """track_chunk_batched_impl on the grouped planar chunk (wipeoff_vpu
    route) and on the complex chunk (wipeoff route): identical."""
    _, tree, blocks, codes, ffts = _setup(n_blocks)
    args = (torch.from_numpy(codes), torch.from_numpy(ffts))
    st_v, out_v = ttrk.track_chunk_batched_impl(
        CFG, ttrk.states_from_numpy(tree, "cpu"), _planar(blocks), 1, *args)
    st_m, out_m = ttrk.track_chunk_batched_impl(
        CFG.replace(use_mxu_wipeoff=True),
        ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks), 1,
        *args)
    for a, b in zip(st_v + out_v, st_m + out_m):
        assert torch.equal(a, b)


def test_grouped_planar_layout():
    """to_grouped_planar / as_complex_input round trip, and the layout
    test is exact against the config."""
    blocks = torch.from_numpy(synth_stream(CFG, SATS, 3, noise_std=0.2,
                                           seed=9))
    planar = ttrk.to_grouped_planar(CFG, blocks)
    assert planar.shape == (3, 2, CFG.n_cyc, CFG.code_samples)
    assert planar.dtype == torch.float32
    assert torch.equal(planar[:, 0].reshape(3, -1), blocks.real)
    assert torch.equal(ttrk.dsp.as_complex_input(planar), blocks)
    assert ttrk.to_grouped_planar(CFG, planar).data_ptr() \
        == planar.data_ptr()
    assert not ttrk.dsp.is_grouped_iq(CFG, planar.reshape(3, 2, -1))


def test_vpu_wrapper_refuses_other_devices():
    meta = torch.empty((K, 2, CFG.n_cyc, CFG.code_samples),
                       dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no path"):
        hopper_wipeoff.mix_wipeoff_vpu(CFG, K, None, None, None, None, meta,
                                       0, None)
    # what the kernel takes: cs a multiple of 4 from 128 to 16384 (past
    # one cluster of 16 column tiles from 4096 up; off the 128-column grid
    # with a partial last tile), up to 32 channels a stream; and what it
    # does not: cs off the multiple-of-4 grid, under 128 or past 16384, a
    # channel past 32, a configuration outside its tiling
    limits = hopper_wipeoff._limits
    wide = ReceiverConfig(code_samples=16384, n_cyc=8, corr_avg=4)
    for cfg, n_ch in ((CFG, 1), (CFG, 12), (ReceiverConfig(), 11),
                      (CFG.replace(code_samples=4096, n_cyc=32), 2),
                      (CFG.replace(code_samples=2176), 2), (wide, 11),
                      (CFG.replace(code_samples=192), 2),
                      (CFG.replace(code_samples=4160), 2),
                      (ReceiverConfig(code_samples=2400), 12),
                      (wide, hopper_wipeoff.MAX_CH),
                      (ReceiverConfig(n_cyc=64), hopper_wipeoff.MAX_CH)):
        limits("wipeoff_vpu", cfg, n_ch, 0)
        limits("wipeoff_vpu", cfg, n_ch, 4096)
    for cfg, n_ch in ((CFG, hopper_wipeoff.MAX_CH + 1), (wide, 33),
                      (CFG, 0), (CFG.replace(code_samples=194), 2),
                      (CFG.replace(code_samples=4162), 2),
                      (CFG.replace(code_samples=124), 2),
                      (wide.replace(code_samples=16384 + 128), 2),
                      (CFG.replace(code_samples=32768), 2),
                      (CFG.replace(n_cyc=24), 2),
                      (CFG.replace(n_cyc=32, corr_avg=20), 2)):
        with pytest.raises(ValueError, match="wipeoff_vpu kernel: needs"):
            limits("wipeoff_vpu", cfg, n_ch, 0)
    planar = torch.empty(K * 2 * CFG.n_cyc * CFG.code_samples + 4)
    assert planar.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte boundary"):
        limits("wipeoff_vpu", CFG, 2, planar[1:].data_ptr())


# ---------------------------------------------------------------------------
# the CUDA kernel's order of arithmetic (_mix_wipeoff_vpu_math), on the CPU


def _vpu_case(cfg, delays, k):
    """Two channels of SATS' stream at `cfg`, made from a numpy seed: (s,
    snp, phase, wipe, re and im planes [k, n_cyc, cs], codes), with wipe
    delays `delays` (one row of k per channel)."""
    blocks = synth_stream(cfg, SATS, k, noise_std=0.5, seed=9)
    planar = ttrk.to_grouped_planar(cfg, torch.from_numpy(blocks))
    codes = torch.from_numpy(np.stack([cacode.ca_table(cfg)[s.prn]
                                       for s in SATS]))
    freq = torch.tensor([s.doppler for s in SATS], dtype=torch.float32)
    s = 2 * np.pi * freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2 * np.pi)
    phase = torch.tensor([0.3, 5.9], dtype=torch.float32)
    wipe = torch.tensor(delays, dtype=torch.int32)
    return s, snp, phase, wipe, planar[:, 0], planar[:, 1], codes


def _jax_vpu(cfg, k, s, snp, phase, wipe, xr, xi, codes):
    """The JAX package's mix_wipeoff (Pallas, interpret mode on the CPU)
    on the same inputs: (center [k, C, cs], head [C, k],
    seg [C, k, n_cyc])."""
    from gps_sdr_tpu.ops.pallas_kernels import mix_wipeoff

    n_cyc = cfg.n_cyc
    s, snp, phase = (jnp.asarray(v.numpy()) for v in (s, snp, phase))
    params = jnp.stack([s, phase, snp, jnp.zeros_like(s)], axis=1)
    blocks2 = jnp.asarray(np.stack([xr.numpy(), xi.numpy()], axis=1))
    center, sums = mix_wipeoff(_jax(cfg), k, params,
                               jnp.asarray(wipe.numpy()), blocks2,
                               jnp.asarray(codes.numpy()))
    center, sums = np.asarray(center), np.asarray(sums)
    center = center[:, 0::2] + 1j * center[:, 1::2]          # [k, C, cs]
    sums = sums[:, 0::2] + 1j * sums[:, 1::2]                # [k, C, pad]
    head = sums[:, :, 0].T
    seg = np.transpose(sums[:, :, 1:n_cyc + 1], (1, 0, 2))
    return center, head, seg


def _within(got, want, rel=1e-4):
    """check_wipeoff's bound: max abs error <= rel x the largest
    magnitude, part by part (center, head, seg)."""
    for name, g, w in zip(("center", "head", "seg"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, f"{name}: {g.shape} != {w.shape}"
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= rel * scale, f"{name}: {err:.3g} > {rel} x {scale:.3g}"


# wipe delays 0, 1, 127-129 and 255 (cs = 256): both ends of the code
# period and both sides of the kernel's 128-column tile edge, for the
# roll and the head mask
@pytest.mark.parametrize("delays", [((0, 255, 1, 128), (255, 0, 128, 1)),
                                    ((1, 127, 128, 0), (128, 129, 255, 2))])
def test_vpu_mirror_matches_jax_and_plain(delays):
    args = _vpu_case(CFG, delays, K)
    got = hopper_wipeoff._mix_wipeoff_vpu_math(CFG, K, *args)
    assert [tuple(g.shape) for g in got] == [(K, 2, CFG.code_samples),
                                             (2, K), (2, K, CFG.n_cyc)]
    _within(got, _jax_vpu(CFG, K, *args))
    _within(got, hopper_wipeoff._mix_wipeoff_math(CFG, K, *args))


@pytest.mark.parametrize("delays", [((0, 2047), (128, 127)),
                                    ((1, 1029), (1920, 2046))])
def test_vpu_mirror_meets_card_bound_at_product_shapes(delays):
    """At the product's cs and n_cyc (2 channels, K=2, noise 0.5) the
    kernel's order of arithmetic keeps center, head and seg within
    check_wipeoff's 1e-4 of the largest magnitude of the plain version's.
    """
    cfg = ReceiverConfig(use_mxu_wipeoff=False)
    args = _vpu_case(cfg, delays, 2)
    got = hopper_wipeoff._mix_wipeoff_vpu_math(cfg, 2, *args)
    _within(got, hopper_wipeoff._mix_wipeoff_math(cfg, 2, *args))
