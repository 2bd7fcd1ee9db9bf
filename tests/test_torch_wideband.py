"""PyTorch port vs JAX at code periods past one cluster of column tiles:
the JAX package's 16.384 MS/s multipath mode (cs 16384, n_cyc 8,
corr_avg 4; tests/test_multipath.py) and cs 4096.

  (a) at cs 4096 (2 channels, K=2: the first shape past one cluster of
      16 column tiles), the plain versions (mix_wipeoff_plain,
      mix_wipeoff_vpu_plain) and the mirrors of the kernels' arithmetic
      (_mix_wipeoff_mxu_math in 3xTF32, _mix_wipeoff_vpu_math) against
      the interpret-mode Pallas kernels mix_wipeoff_mxu / mix_wipeoff,
      with tests/test_torch_wipeoff*.py's bound: 1e-4 of the largest
      magnitude, part by part;
  (b) at cs 16384 the port's heavy stage on the CPU (the plain versions)
      against a float64 numpy evaluation of the kernel contract (2e-5 of
      the largest magnitude: f32 angles of up to ~200 rad and f32 sums of
      16384 terms) and against the JAX XLA heavy stage: delays exact,
      code_phase atol 5e-3, norm_max rtol 2e-3, phase_end atol 1e-3 (the
      kernel tolerances), head and seg within 2e-4 of the largest
      magnitude.  That last bound is the XLA reference's own: it mixes a
      whole K-step with one NCO whose per-2048-sample table angles are
      q x remainder(s 2048, 2 pi) in f32, q up to 512 at cs 16384, so its
      phase is off by up to ~1.2e-4 rad by the step's last sample (the
      port mixes per block, as the kernels do; measured on this case:
      XLA 8e-5 of the largest seg from float64, the port 3.6e-6);
  (c) tests/test_multipath.py _track_bias's clean and half-chip cases
      (its cached blocks) through the port's track_chunk_batched_impl and
      JAX track_chunk_batched: code phases atol 5e-3 samples, norm_max
      rtol 2e-3, FRQ atol 1e-2 Hz, delays, locks, signs and edges exact,
      and both sides within test_multipath's bias bars.  The amplitude
      (mean over std of the block's means, ~250 here) is not compared:
      the XLA reference's ~1e-4 rad NCO error moves the std of the means
      by a few percent;
  (d) acquire_impl against JAX acquire on one cs 16384 block of the JAX
      bench's 3-satellite 16 MS/s case (bench.py's acquisition stress):
      found, Doppler bin and delay exact, norm_max rtol 1e-4, code phase
      atol 1e-3, as tests/test_torch_acquisition.py holds them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.ops import acquisition as jacq
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import acquisition as tacq
from gps_sdr_tpu_torch.ops import cacode, hopper_wipeoff
from gps_sdr_tpu_torch.ops import tracking as ttrk
from tests.conftest import cached_synth
from tests.test_torch_wipeoff import _jax_mxu, _within
from tests.test_torch_wipeoff_vpu import _jax_vpu, _vpu_case

torch.set_num_threads(2)

WIDE = ReceiverConfig(code_samples=16384, n_cyc=8, corr_avg=4)
CS4096 = WIDE.replace(code_samples=4096)


def _jax(cfg):
    """The JAX package's config with the same fields."""
    return JaxConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# (a) cs 4096 against the interpret-mode Pallas kernels

# wipe delays at both ends of the code period, both sides of the first
# cluster's 2048-column span and of a 128-column tile edge
@pytest.mark.parametrize("delays", [((0, 4095), (2047, 2048)),
                                    ((1, 127), (128, 4094))])
@pytest.mark.parametrize("kernel", ["wipeoff", "wipeoff_vpu"])
def test_cs4096_plain_and_mirror_match_pallas(kernel, delays):
    k = 2
    s, snp, phase, wipe, xr, xi, codes = _vpu_case(CS4096, delays, k)
    args = (s, snp, phase, wipe, xr, xi, codes)
    if kernel == "wipeoff":
        want = _jax_mxu(CS4096, k, *args)
        mirror = hopper_wipeoff._mix_wipeoff_mxu_math(CS4096, k, *args,
                                                      "3xtf32")
        chunk = torch.complex(xr, xi).reshape(k, -1)
        plain = hopper_wipeoff.mix_wipeoff_plain(CS4096, k, s, snp, phase,
                                                 wipe, chunk, 0, codes)
    else:
        want = _jax_vpu(CS4096, k, *args)
        mirror = hopper_wipeoff._mix_wipeoff_vpu_math(CS4096, k, *args)
        planar = torch.stack([xr, xi], dim=1).contiguous()
        plain = hopper_wipeoff.mix_wipeoff_vpu_plain(
            CS4096, k, s, snp, phase, wipe, planar, 0, codes)
    assert [tuple(g.shape) for g in plain] == [(k, 2, 4096), (2, k),
                                               (2, k, CS4096.n_cyc)]
    _within(mirror, want)
    _within(plain, want)


# ---------------------------------------------------------------------------
# the _track_bias case of tests/test_multipath.py at 16.384 MS/s

BITS = random_bits(128, seed=17)
DIRECT = SatSignal(prn=17, doppler=-1500.0, code_delay=900.25,
                   nav_bits=BITS)


def _bias_blocks(delay_chips, key):
    """test_multipath's 24 blocks (its cache key, so its fixture) of the
    direct signal and, for delay_chips > 0, a half-amplitude in-phase ray
    that many chips later."""
    sats = [DIRECT]
    if delay_chips:
        sats.append(SatSignal(
            prn=17, doppler=-1500.0,
            code_delay=900.25 + delay_chips * WIDE.code_samples / 1023.0,
            amplitude=0.5, carrier_phase=0.0, nav_bits=BITS))
    return cached_synth(key, lambda: synth_stream(WIDE, sats, 24,
                                                  noise_std=0.5, seed=4))


def _states(prns_dopp_delay):
    """JAX states for (prn, doppler, delay) channels, their f32 tree,
    codes and code FFTs."""
    cfg = _jax(WIDE)
    st = jtrk.init_channel_states(cfg, len(prns_dopp_delay))
    for i, (prn, dop, delay) in enumerate(prns_dopp_delay):
        st = jtrk.reset_channel(st, i, prn, dop, delay, cfg)
    codes = np.stack([cacode.ca_table(WIDE)[p] for p, _, _ in
                      prns_dopp_delay])
    ffts = np.stack([cacode.ca_fft_table(WIDE)[p] for p, _, _ in
                     prns_dopp_delay])
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(st).items()}
    return st, tree, codes, ffts


# ---------------------------------------------------------------------------
# (b) the heavy stage at cs 16384

@pytest.mark.parametrize("mxu", [True, False], ids=["wipeoff", "vpu"])
def test_cs16384_heavy_stage_matches_float64_and_xla(mxu):
    cfg = WIDE.replace(use_mxu_wipeoff=mxu)
    k = cfg.blocks_per_step
    blocks = _bias_blocks(0.5, "mp16_d05_v1")[:k]
    # the signal's channel and a noise-led one
    st, tree, codes, ffts = _states([(17, -1500.0, 900), (5, 1200.0, 10000)])
    want = jtrk.heavy_stage(_jax(cfg), k, st, jnp.asarray(blocks),
                            jnp.asarray(codes), jnp.asarray(ffts))
    tst = ttrk.states_from_numpy(tree, "cpu")
    chunk = torch.from_numpy(blocks)
    if not mxu:
        chunk = ttrk.to_grouped_planar(cfg, chunk)
    got = ttrk.heavy_stage(cfg, k, tst, chunk, 0, torch.from_numpy(codes),
                           torch.from_numpy(ffts))
    for name in ("delay_k", "new_delay_k", "wipe_delay"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert (got.delay_k.numpy()[0] >= 0).all()
    np.testing.assert_allclose(got.code_phase_k.numpy(),
                               np.asarray(want.code_phase_k), atol=5e-3)
    np.testing.assert_allclose(got.norm_max_k.numpy(),
                               np.asarray(want.norm_max_k), rtol=2e-3)
    np.testing.assert_allclose(got.phase_end.numpy(),
                               np.asarray(want.phase_end), atol=1e-3)
    parts = (got.head_k.numpy(), got.seg_sums_k.numpy())
    for g, w in zip(parts, (np.asarray(want.head_k),
                            np.asarray(want.seg_sums_k))):
        assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max()

    # the kernel contract in float64 on the same f32 parameters
    s = 2 * np.pi * tst.freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2 * np.pi)
    wipe = got.wipe_delay.numpy()
    n = np.arange(cfg.ngps)
    head = np.zeros((2, k), complex)
    seg = np.zeros((2, k, cfg.n_cyc), complex)
    for c in range(2):
        for b in range(k):
            ang = (float(tst.phase[c]) + float(snp[c]) * b
                   + float(s[c]) * (n + 1))
            prod = (blocks[b].astype(np.complex128) * np.exp(-1j * ang)
                    ).reshape(cfg.n_cyc, cfg.code_samples) \
                * np.roll(codes[c].astype(np.float64), int(wipe[c, b]))
            lo = prod[:, :int(wipe[c, b])].sum(axis=1)
            head[c, b] = lo[0]
            seg[c, b] = prod.sum(axis=1) - lo + np.append(lo[1:], 0)
    for g, w in zip(parts, (head, seg)):
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max()


# ---------------------------------------------------------------------------
# (c) K-fused tracking at cs 16384 against JAX, and the bias bars

@pytest.mark.parametrize("delay_chips,key,bar",
                         [(0.0, "mp16_clean_v1", 4.0),
                          (0.5, "mp16_d05_v1", 12.0)], ids=["clean", "d05"])
def test_cs16384_tracking_matches_jax_and_bias_bars(delay_chips, key, bar):
    blocks = _bias_blocks(delay_chips, key)
    st, tree, codes, ffts = _states([(17, DIRECT.doppler,
                                      int(DIRECT.code_delay))])
    jst, jo = jtrk.track_chunk_batched(_jax(WIDE), st, jnp.asarray(blocks),
                                       jnp.int32(1), jnp.asarray(codes),
                                       jnp.asarray(ffts))
    tst, to = ttrk.track_chunk_batched_impl(
        WIDE, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks),
        1, torch.from_numpy(codes), torch.from_numpy(ffts))
    jo, to = jtrk.outs_to_numpy(jo), ttrk.outs_to_numpy(to)
    np.testing.assert_allclose(to.code_phase, jo.code_phase, atol=5e-3)
    np.testing.assert_allclose(to.norm_max, jo.norm_max, rtol=2e-3)
    np.testing.assert_allclose(to.freq, jo.freq, atol=1e-2)
    for name in ("delay", "locked", "erased", "sign0", "edge_valid"):
        np.testing.assert_array_equal(getattr(to, name), getattr(jo, name),
                                      err_msg=name)
    np.testing.assert_array_equal(to.edge_ms[to.edge_valid],
                                  jo.edge_ms[jo.edge_valid])
    np.testing.assert_array_equal(to.edge_local[to.edge_valid],
                                  jo.edge_local[jo.edge_valid])
    assert abs(chip_smoke.bias_m(WIDE, DIRECT, jo.code_phase[:, 0])) < bar
    assert abs(chip_smoke.bias_m(WIDE, DIRECT, to.code_phase[:, 0])) < bar
    assert to.locked[-1, 0]


# ---------------------------------------------------------------------------
# (d) acquisition on one cs 16384 block

def test_cs16384_acquire_impl_matches_jax():
    cfg = WIDE.replace(sweep_corr_avg=2)
    rng = np.random.default_rng(3)
    sats = [SatSignal(prn=p, doppler=float(rng.uniform(-4500, 4500)),
                      code_delay=float(rng.uniform(0, cfg.code_samples)),
                      nav_bits=random_bits(64, seed=p)) for p in (4, 9, 27)]
    block = synth_stream(cfg, sats, 1, noise_std=0.3, seed=3)[0]
    prns = [2, 4, 9, 11, 20, 27]
    ffts = cacode.ca_fft_table(cfg)[np.asarray(prns)]
    bins = cfg.doppler_bins.astype(np.float32)
    want = jacq.acquire(_jax(cfg), jnp.asarray(block), jnp.asarray(bins),
                        jnp.asarray(ffts))
    got = tacq.acquire_impl(cfg, torch.from_numpy(block),
                            torch.from_numpy(bins), torch.from_numpy(ffts))
    found = got.found.numpy()
    np.testing.assert_array_equal(found, np.asarray(want.found) > 0.5)
    assert [p for p, f in zip(prns, found) if f] == [4, 9, 27]
    np.testing.assert_array_equal(got.freq.numpy(), np.asarray(want.freq))
    np.testing.assert_array_equal(got.delay.numpy(),
                                  np.asarray(want.delay).astype(np.int32))
    np.testing.assert_allclose(got.norm_max.numpy(),
                               np.asarray(want.norm_max), rtol=1e-4)
    np.testing.assert_allclose(got.code_phase.numpy(),
                               np.asarray(want.code_phase), atol=1e-3)
    for s in sats:                     # the peaks sit on the true delays
        assert abs(int(got.delay[prns.index(s.prn)]) - s.code_delay) <= 1.0
