"""PyTorch port vs JAX: chunk tracking (ops/tracking.py).

The same synthesized chunk and starting state go through the JAX
track_chunk_batched / track_chunk (XLA on the CPU) and the port's
plain PyTorch path.  Tolerances: code_phase atol 5e-3 samples and
norm_max rtol 2e-3 (the heavy-stage kernel tolerances), freq atol
1e-2 Hz (PLL feedback over the chunk carries the heavy stage's f32
differences forward), amplitude rtol 1e-3 (f32 reduction order,
amplified by mean/std); locked, sign0, edges and integer state exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr_tpu.ops import cacode
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu_torch.ops import tracking as ttrk

torch.set_num_threads(2)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(64, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(64, seed=12))]
INT_STATE = ("prn", "active", "delay", "locked", "ms_time", "prev_stream",
             "sign0", "prev_sign", "carry_cnt", "df_cnt", "df_idx",
             "corr_buf", "corr_cnt", "corr_idx")


def _setup(n_blocks):
    blocks = synth_stream(CFG, SATS, n_blocks, noise_std=0.2, seed=9)
    states = jtrk.init_channel_states(CFG, 2)
    codes = np.zeros((2, CFG.code_samples), np.float32)
    ffts = np.zeros((2, CFG.code_samples), np.complex64)
    for i, s in enumerate(SATS):
        states = jtrk.reset_channel(states, i, s.prn, s.doppler,
                                    int(s.code_delay), CFG)
        codes[i] = cacode.ca_table(CFG)[s.prn]
        ffts[i] = cacode.ca_fft_table(CFG)[s.prn]
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(states).items()}
    return states, tree, blocks, codes, ffts


def _compare(jst, jo, tst, to):
    jo, to = jtrk.outs_to_numpy(jo), ttrk.outs_to_numpy(to)
    np.testing.assert_allclose(to.code_phase, jo.code_phase, atol=5e-3)
    np.testing.assert_allclose(to.norm_max, jo.norm_max, rtol=2e-3)
    np.testing.assert_allclose(to.freq, jo.freq, atol=1e-2)
    np.testing.assert_allclose(to.amplitude, jo.amplitude, rtol=1e-3)
    np.testing.assert_allclose(to.corr_q, jo.corr_q, atol=1e-6)
    np.testing.assert_allclose(to.corr_l, jo.corr_l, atol=1e-6)
    for name in ("delay", "locked", "erased", "sweep_request", "sign0",
                 "edge_valid"):
        np.testing.assert_array_equal(getattr(to, name),
                                      getattr(jo, name), err_msg=name)
    np.testing.assert_array_equal(to.edge_ms[to.edge_valid],
                                  jo.edge_ms[jo.edge_valid])
    np.testing.assert_array_equal(to.edge_local[to.edge_valid],
                                  jo.edge_local[jo.edge_valid])
    want = {k: np.asarray(v) for k, v in jtrk.pack_states(jst).items()}
    have = ttrk.states_to_numpy(tst)
    for name, v in want.items():
        if name.split("__")[0] in INT_STATE:
            np.testing.assert_array_equal(have[name], v, err_msg=name)
        else:
            np.testing.assert_allclose(have[name], v, atol=1e-2,
                                       err_msg=name)


@pytest.mark.parametrize("n_blocks", [16, 18])   # 18: 16 fused + K=1 tail
def test_track_chunk_batched_matches_jax(n_blocks):
    states, tree, blocks, codes, ffts = _setup(n_blocks)
    jst, jo = jtrk.track_chunk_batched(CFG, states, jnp.asarray(blocks),
                                       jnp.int32(1), jnp.asarray(codes),
                                       jnp.asarray(ffts))
    tst, to = ttrk.track_chunk_batched_impl(
        CFG, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks),
        1, torch.from_numpy(codes), torch.from_numpy(ffts))
    assert to.code_phase.shape == (n_blocks, 2)
    _compare(jst, jo, tst, to)


def test_track_chunk_k1_matches_jax():
    """The sequential K=1 path (the batched path's tail)."""
    states, tree, blocks, codes, ffts = _setup(6)
    jst, jo = jtrk.track_chunk(CFG, states, jnp.asarray(blocks),
                               jnp.int32(1), jnp.asarray(codes),
                               jnp.asarray(ffts))
    tst, to = ttrk.track_chunk_impl(
        CFG, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks),
        1, torch.from_numpy(codes), torch.from_numpy(ffts))
    _compare(jst, jo, tst, to)


def test_predict_wipe_delays_matches_jax():
    freq = np.array([4990.0, -4990.0, 987.0, 0.0], np.float32)
    delay0 = np.array([0, 255, 77, 3], np.int32)
    import jax
    want = jax.vmap(lambda f, d: jtrk.predict_wipe_delays(CFG, 32, f, d))(
        jnp.asarray(freq), jnp.asarray(delay0))
    got = ttrk.predict_wipe_delays(CFG, 32, torch.from_numpy(freq),
                                   torch.from_numpy(delay0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_states_numpy_roundtrip():
    """states_from_numpy/states_to_numpy share the JAX pack_states
    layout, and the round trip is exact (ms_time past 2^24 included)."""
    states, tree, *_ = _setup(1)
    states = states._replace(ms_time=jnp.asarray([2 ** 25 + 3, 7],
                                                 jnp.int32))
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(states).items()}
    st = ttrk.states_from_numpy(tree, "cpu")
    assert st.ms_time.dtype == torch.int32
    assert st.ms_time.tolist() == [2 ** 25 + 3, 7]
    assert st.corr_buf.dtype == torch.int8
    back = ttrk.states_to_numpy(st)
    assert back.keys() == tree.keys()
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k], err_msg=k)
    for name, v in jtrk.unpack_states(back)._asdict().items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(getattr(states, name)))


def test_init_and_reset_match_jax():
    st = jtrk.init_channel_states(CFG, 3)
    st = jtrk.reset_channel(st, 1, 7, 1234.5, 99, CFG)
    tt = ttrk.init_channel_states(CFG, 3, "cpu")
    tt = ttrk.reset_channel(tt, 1, 7, 1234.5, 99, CFG)
    want = {k: np.asarray(v) for k, v in jtrk.pack_states(st).items()}
    have = ttrk.states_to_numpy(tt)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
