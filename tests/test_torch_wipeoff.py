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
from gps_sdr_tpu_torch.ops import cacode
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
        states = jtrk.reset_channel(states, i, s.prn, s.doppler, d, _jax(CFG))
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
    want = heavy_stage_pallas(_jax(cfg), K, states, jnp.asarray(blocks),
                              jnp.asarray(codes), jnp.asarray(ffts))
    _compare(want, _port_heavy(tree, blocks, codes, ffts))


@pytest.mark.parametrize("delays", [None, (0, 255)])
def test_heavy_stage_matches_xla(delays):
    states, tree, blocks, codes, ffts = _setup(K, delays)
    want = jtrk.heavy_stage(_jax(CFG), K, states, jnp.asarray(blocks),
                            jnp.asarray(codes), jnp.asarray(ffts))
    _compare(want, _port_heavy(tree, blocks, codes, ffts))


def test_heavy_stage_reads_its_step_of_the_chunk():
    """The kernel contract reads block step*K + b of the WHOLE chunk."""
    states, tree, blocks, codes, ffts = _setup(3 * K)
    cfg = CFG.replace(use_mxu_wipeoff=True)
    want = heavy_stage_pallas(_jax(cfg), K, states, jnp.asarray(blocks[2 * K:]),
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


def test_wipeoff_wrapper_limits():
    """What csrc/wipeoff.cu takes: cs a multiple of 128 up to 16384 (past
    one cluster of 16 column tiles from 4096 up), n_cyc 8 to 64, up to 32
    channels a stream; and what it does not: cs off the 128-column tiling
    or past 16384, 33 channels, a configuration outside its tiling, a
    misaligned chunk; and a tensor on neither the CPU nor a card."""
    meta = torch.empty((K, CFG.ngps), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="no path"):
        hopper_wipeoff.mix_wipeoff(CFG, K, None, None, None, None, meta, 0,
                                   None)
    limits = hopper_wipeoff._limits
    wide = ReceiverConfig(code_samples=16384, n_cyc=8, corr_avg=4)
    for cfg, n_ch in ((CFG, 2), (ReceiverConfig(), 11),
                      (CFG.replace(code_samples=4096), 2),
                      (CFG.replace(code_samples=8192, n_cyc=16), 11),
                      (CFG.replace(code_samples=2176), 2), (wide, 8),
                      (wide, hopper_wipeoff.MAX_CH),
                      (ReceiverConfig(n_cyc=64), hopper_wipeoff.MAX_CH)):
        limits("wipeoff", cfg, n_ch, 4096)
    for cfg, n_ch in ((wide, hopper_wipeoff.MAX_CH + 1), (CFG, 0),
                      (CFG.replace(code_samples=200), 2),
                      (wide.replace(code_samples=16384 + 128), 2),
                      (CFG.replace(code_samples=32768), 2),
                      (CFG.replace(n_cyc=12), 2),
                      (CFG.replace(corr_avg=9), 2)):
        with pytest.raises(ValueError, match="wipeoff kernel: needs"):
            limits("wipeoff", cfg, n_ch, 0)
    chunk = torch.empty(K * CFG.ngps + 2, dtype=torch.complex64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        limits("wipeoff", CFG, 2, chunk[1:].data_ptr())


# ---------------------------------------------------------------------------
# the CUDA kernel's contraction form (_mix_wipeoff_mxu_math), on the CPU


def _mxu_case(cfg, delays, k):
    """Two channels of SATS' stream at `cfg`: (s, snp, phase, wipe, re and
    im planes [k, n_cyc, cs], codes), with wipe delays `delays` (one row
    of k per channel)."""
    blocks = synth_stream(cfg, SATS, k, noise_std=0.5, seed=9)
    planes = torch.from_numpy(blocks).reshape(k, cfg.n_cyc,
                                              cfg.code_samples)
    codes = torch.from_numpy(np.stack([cacode.ca_table(cfg)[s.prn]
                                       for s in SATS]))
    freq = torch.tensor([s.doppler for s in SATS], dtype=torch.float32)
    s = 2 * np.pi * freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2 * np.pi)
    phase = torch.tensor([0.3, 5.9], dtype=torch.float32)
    wipe = torch.tensor(delays, dtype=torch.int32)
    return s, snp, phase, wipe, planes.real, planes.imag, codes


def _jax_mxu(cfg, k, s, snp, phase, wipe, xr, xi, codes):
    """The JAX package's mix_wipeoff_mxu (Pallas, interpret mode on the
    CPU) on the same inputs, its inputs built as heavy_stage_pallas
    builds them: (center [k, C, cs], head [C, k], seg [C, k, n_cyc])."""
    from gps_sdr_tpu.ops.pallas_kernels import mix_wipeoff_mxu

    cs, n_cyc, ca = cfg.code_samples, cfg.n_cyc, cfg.corr_avg
    s, snp, phase = (jnp.asarray(v.numpy()) for v in (s, snp, phase))
    params = jnp.stack([s, phase, snp, jnp.zeros_like(s)], axis=1)
    base = phase[None, :] + snp[None, :] * jnp.arange(
        k, dtype=jnp.float32)[:, None]
    rotrow = jnp.stack([jnp.cos(base), jnp.sin(base)], axis=1)
    q = jnp.arange(n_cyc, dtype=jnp.float32)
    angq = s[:, None] * jnp.float32(cs) * q[None, :]
    first = (n_cyc - ca) // 2
    cmask = (((q >= first) & (q < first + ca)).astype(jnp.float32)
             / jnp.float32(ca))[None, :]
    g = jnp.concatenate([jnp.cos(angq) * cmask, jnp.sin(angq) * cmask])
    cqsq = jnp.stack([jnp.cos(angq).T, jnp.sin(angq).T])
    blocks2 = jnp.asarray(np.stack([xr.numpy(), xi.numpy()], axis=1))
    cre, cim, sums = mix_wipeoff_mxu(
        _jax(cfg), k, jnp.zeros((1,), jnp.int32), params,
        jnp.asarray(wipe.numpy()), rotrow, rotrow.reshape(k, -1, 1), g,
        cqsq, blocks2, jnp.asarray(codes.numpy()))
    sl = n_cyc + 1
    sums = np.asarray(sums)
    center = np.asarray(cre) + 1j * np.asarray(cim)
    head = (sums[:, 0] + 1j * sums[:, sl]).T
    seg = np.transpose(sums[:, 1:sl] + 1j * sums[:, sl + 1:2 * sl],
                       (2, 0, 1))
    return center, head, seg


def _within(got, want, rel=1e-4):
    """check_wipeoff's bound: max abs error <= rel x the largest
    magnitude, part by part (center, head, seg)."""
    for name, g, w in zip(("center", "head", "seg"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= rel * scale, f"{name}: {err:.3g} > {rel} x {scale:.3g}"


# wipe delays 0, 1, 128 and 255 (cs = 256) on both sides of the kernel's
# 128-column tile edge, for the roll and the head mask
@pytest.mark.parametrize("delays", [((0, 255, 1, 128), (255, 0, 128, 1)),
                                    ((1, 127, 128, 0), (128, 129, 255, 2))])
def test_mxu_mirror_matches_jax_and_plain(delays):
    args = _mxu_case(CFG, delays, K)
    got = hopper_wipeoff._mix_wipeoff_mxu_math(CFG, K, *args, "3xtf32")
    _within(got, _jax_mxu(CFG, K, *args))
    _within(got, hopper_wipeoff._mix_wipeoff_math(CFG, K, *args))


@pytest.mark.parametrize("rounding,meets", [("f32", True), ("3xtf32", True),
                                             ("tf32", False)])
def test_mxu_mirror_meets_card_bound_at_product_shapes(rounding, meets):
    """At the product's cs and n_cyc (2 channels, K=2, noise 0.5), the
    kernel's input rounding (3xTF32) keeps center, head and seg within
    check_wipeoff's 1e-4 of the largest magnitude of the plain version's;
    single-pass TF32 does not, which is why the kernel splits."""
    cfg = ReceiverConfig()
    cs = cfg.code_samples
    args = _mxu_case(cfg, ((0, cs - 1), (128, 127)), 2)
    got = hopper_wipeoff._mix_wipeoff_mxu_math(cfg, 2, *args, rounding)
    want = hopper_wipeoff._mix_wipeoff_math(cfg, 2, *args)
    if meets:
        _within(got, want)
    else:
        with pytest.raises(AssertionError):
            _within(got, want)
