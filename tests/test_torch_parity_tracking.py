"""Twins of the JAX package's tracking-chain tests on the port's plain path
(the CPU versions of the kernels): tests/test_edge_scan_equiv.py
(ops/tracking.py `_edge_scan`), test_tracking_batched.py
(`track_chunk_batched_impl`, `track_chunk_impl`) and
test_formats_ncyc.py (iq8 capture format, `replay_blocks`, tracking at
n_cyc 16 and 8).

The edge scan is held slot for slot and state for state against the JAX
package's sequential reference chain `_edge_scan_seq` (the oracle of
the JAX test), exactly.  Tracking runs the JAX test's stream (cached
under its key) through the JAX function and the port's counterpart from
the same state; their outputs and states are held to each other with
tests/test_torch_tracking.py's `_compare` tolerances, and the JAX
test's bars are applied to both.  Capture bytes and replayed blocks are
held exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.models.navmsg import NavDecoder as JaxDecoder
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.ops.acquisition import acquire_all as jax_acquire_all
from gps_sdr_tpu.runtime import sources as jsrc
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.navmsg import NavDecoder
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import cacode
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.ops.acquisition import acquire_all
from gps_sdr_tpu_torch.runtime import sources
from tests.conftest import cached_synth
from tests.test_edge_scan_equiv import SL, _case
from tests.test_formats_ncyc import SAT
from tests.test_torch_frontend import amp_rtol
from tests.test_torch_tracking import _compare

torch.set_num_threads(2)


def _jax(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


def carry_tolerance(cfg, jst) -> np.ndarray:
    """Per channel, carry_sum's tolerance: 1e-2, or 4 f32 spacings of the
    NCO's angle over one block (2 pi |freq| ngps / fs) times |carry_sum|,
    whichever is larger.  carry_sum is the sum of the block's last
    partial code period (~1300 at the product config's strong channels)
    under the NCO; the two packages round that angle (623 rad at 3100
    Hz and 32 ms blocks) each in its own order, which turns carry_sum by
    up to 2.8 spacings on test_tracking_batched.py's stream (every K,
    the pull-in and the tail)."""
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(jst).items()}
    ang = (2 * np.pi * np.abs(tree["freq"]) * cfg.ngps
           / cfg.sample_rate).astype(np.float32)
    carry = np.hypot(tree["carry_sum__re"], tree["carry_sum__im"])
    return np.maximum(1e-2, 4.0 * np.spacing(ang) * carry)


def compare_product(cfg, jst, jo, tst, to) -> None:
    """`_compare` at the product config: its output and state tolerances,
    but amplitude held by tests/test_torch_frontend.py's strong-channel
    rule (rtol 1e-3 + 2 eps A^2; A ~ 83 here, where one f32 rounding
    moves the amplitude by ~eps A^2 / 4) and carry_sum by
    carry_tolerance."""
    _compare(jst, jo, tst, to, amplitude=False,
             carry_atol=carry_tolerance(cfg, jst))
    want = jtrk.outs_to_numpy(jo).amplitude
    got = ttrk.outs_to_numpy(to).amplitude
    assert (np.abs(got - want) <= amp_rtol(want) * np.abs(want)).all()


# --- tests/test_edge_scan_equiv.py ------------------------------------------

_SCAN = ("sign0", "prev_sign", "prev_signal", "ms_time", "ems", "est",
         "evalid")
_seq = jax.jit(jax.vmap(jtrk._edge_scan_seq))


def _scan_both(cases):
    """The JAX reference chain (vmapped) and the port's batched scan on
    the same channels; every output equal exactly.  Returns the port's
    outputs as numpy arrays."""
    cols = [np.stack([np.asarray(c[i]) for c in cases]) for i in range(9)]
    want = _seq(*[jnp.asarray(c) for c in cols])
    got = ttrk._edge_scan(*[torch.from_numpy(c) for c in cols])
    got = [g.numpy() for g in got]
    for name, g, w in zip(_SCAN, got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    return got


@pytest.mark.parametrize("seed", range(8))
def test_random_cases(seed):
    rng = np.random.default_rng(seed)
    _scan_both([_case(rng) for _ in range(40)])


@pytest.mark.parametrize("force", [{"sign0": 0}, {"locked": False},
                                   {"n_valid": 0},
                                   {"sign0": 0, "n_valid": 1},
                                   {"n_valid": SL}],
                         ids=["fresh", "unlocked", "empty", "fresh_one",
                              "full"])
def test_fresh_chain_and_unlocked(force):
    rng = np.random.default_rng(99)
    out = _scan_both([_case(rng, force) for _ in range(20)])
    if force.get("locked") is False or force.get("n_valid") == 0:
        assert not out[-1].any()            # nothing scanned, no edge


def test_chained_blocks_match():
    """The JAX test's chain (seed 7): a fresh locked chain, then 12 blocks
    whose state each side threads from its own outputs."""
    rng = np.random.default_rng(7)
    args = _case(rng, {"sign0": 0, "locked": True, "n_valid": SL})
    state = [np.asarray(a) for a in args[5:]]
    n_edges = 0
    for _ in range(12):
        blk = _case(rng, {"locked": True,
                          "n_valid": int(rng.integers(28, SL + 1))})
        out = _scan_both([tuple(blk[:5]) + tuple(state)])
        n_edges += int(out[-1].sum())
        state = [o[0] for o in out[:4]]
    assert n_edges > 0


def test_vmapped_over_channels():
    rng = np.random.default_rng(3)
    _scan_both([_case(rng) for _ in range(6)])


def test_card_edge_chain_matches_jax_reference():
    """chip_smoke.py's 15a case (8 chained K-steps of 11 channels, which
    the card holds bit for bit to the plain cheap stage) on the CPU: on
    every locked channel, block after block, the plain cheap stage's
    edges, per-block sign0 and carried chain state equal the JAX
    package's reference chain `_edge_scan_seq` on the same means (the
    case designs them to reach the scan unrotated) and the same gate
    (edge_sigma times the previous block's sigma); and the case reaches
    what it is made for (chip_smoke.run_edge_chain's checks)."""
    import chip_smoke

    cfg = ReceiverConfig()
    exact = ~np.isin(np.arange(cfg.max_sat), chip_smoke.EDGE_UNLOCKED)
    n_blocks = []

    def against_reference(args, co):
        _, k, head, seg, _, wipe, st = args
        carry_sum, carry_cnt, std = st.carry_sum, st.carry_cnt, st.std_dev
        chain = [np.asarray(getattr(st, f))[exact] for f in (
            "sign0", "prev_sign", "prev_signal", "ms_time")]
        for b in range(k):
            # (the quality ring's count grows a block each)
            means, starts, mask, n_valid, carry_sum, carry_cnt = \
                ttrk._means_from_sums(
                    head[:, b], seg[:, b], wipe[:, b], carry_sum, carry_cnt,
                    ttrk._continues(carry_cnt, st.corr_cnt + b), cfg)
            gate = cfg.edge_sigma * std
            ref = _seq(*[jnp.asarray(x) for x in (
                means.numpy()[exact], starts.numpy()[exact],
                mask.numpy()[exact], st.locked.numpy()[exact],
                gate.numpy()[exact], *chain)])
            ref = [np.asarray(r) for r in ref]
            valid = co.edge_valid[:, b].numpy()[exact]
            np.testing.assert_array_equal(valid, ref[6])
            np.testing.assert_array_equal(
                co.edge_ms[:, b].numpy()[exact][valid], ref[4][valid])
            np.testing.assert_array_equal(
                co.edge_local[:, b].numpy()[exact][valid], ref[5][valid])
            np.testing.assert_array_equal(co.sign0_seq[:, b].numpy()[exact],
                                          ref[0])
            chain = ref[:4]
            std = ttrk._amplitude(means, mask, n_valid)[1]
        for name, r in zip(("sign0", "prev_sign", "prev_signal", "ms_time"),
                           chain):
            np.testing.assert_array_equal(
                getattr(co, name).numpy()[exact], r, err_msg=name)
        n_blocks.append(k)

    got = chip_smoke.run_edge_chain(cfg, "cpu", on_step=against_reference)
    assert sum(n_blocks) == chip_smoke.EDGE_STEPS * cfg.blocks_per_step
    assert got["edges"] > 0 and got["at_gate"] and got["past_gate"]


# --- tests/test_tracking_batched.py -----------------------------------------

CFG = ReceiverConfig()
SATS = [SatSignal(prn=5, doppler=1234.0, code_delay=300.25,
                  nav_bits=random_bits(128, seed=5)),
        SatSignal(prn=21, doppler=-3100.0, code_delay=777.0,
                  nav_bits=random_bits(128, seed=21))]


@pytest.fixture(scope="module")
def stream():
    """test_tracking_batched.py's 96 blocks (cached under its key)."""
    return cached_synth("batched_track_v1", lambda: synth_stream(
        CFG, SATS, 96, noise_std=0.4, seed=11))


def _start(cfg, offset=0.0):
    """Both packages' states with the JAX test's two channels (channel 0
    `offset` Hz off its Doppler), and the code tables."""
    jst = jtrk.init_channel_states(_jax(cfg), 2)
    codes = np.zeros((2, cfg.code_samples), np.float32)
    ffts = np.zeros((2, cfg.code_samples), np.complex64)
    for i, s in enumerate(SATS):
        jst = jtrk.reset_channel(jst, i, s.prn,
                                 s.doppler + (offset if i == 0 else 0.0),
                                 int(s.code_delay), _jax(cfg))
        codes[i] = cacode.ca_table(cfg)[s.prn]
        ffts[i] = cacode.ca_fft_table(cfg)[s.prn]
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(jst).items()}
    return jst, tree, codes, ffts


def _track_both(cfg, blocks, offset=0.0, batched=True):
    """(JAX states, JAX outs, port states, port outs) of one chunk from
    the same start, held to each other with `_compare`."""
    jst, tree, codes, ffts = _start(cfg, offset)
    jfn = jtrk.track_chunk_batched if batched else jtrk.track_chunk
    tfn = ttrk.track_chunk_batched_impl if batched else ttrk.track_chunk_impl
    js, jo = jfn(_jax(cfg), jst, jnp.asarray(blocks), jnp.int32(1),
                 jnp.asarray(codes), jnp.asarray(ffts))
    ts, to = tfn(cfg, ttrk.states_from_numpy(tree, "cpu"),
                 torch.from_numpy(blocks), 1, torch.from_numpy(codes),
                 torch.from_numpy(ffts))
    compare_product(cfg, js, jo, ts, to)
    return js, jtrk.outs_to_numpy(jo), ts, ttrk.outs_to_numpy(to)


@pytest.fixture(scope="module")
def sequential(stream):
    """The K=1 loop over the whole stream, in both packages."""
    return _track_both(CFG, stream, batched=False)


def _decode_bits(decoder_cls, o, n_blocks):
    """test_tracking_batched._decode_bits with either package's decoder."""
    bits = []
    for c in range(2):
        dec = decoder_cls(ngps=CFG.ngps)
        for b in range(n_blocks):
            dec.push_block(o.sign0[b, c], o.edge_ms[b, c], o.edge_local[b, c],
                           o.edge_valid[b, c], stream_no=1 + b,
                           erased=bool(o.erased[b, c]))
        bits.append(dec._frame_bits()[0])
    return bits


def test_k1_equals_sequential(stream, sequential):
    """K=1: the batched entry point is the sequential loop (the JAX bar:
    equal code phases and frequencies), in both packages."""
    cfg1 = CFG.replace(blocks_per_step=1)
    _, jo, _, to = _track_both(cfg1, stream[:32])
    _, jref, _, tref = sequential
    np.testing.assert_allclose(jo.code_phase, jref.code_phase[:32])
    np.testing.assert_allclose(jo.freq, jref.freq[:32])
    np.testing.assert_array_equal(to.code_phase, tref.code_phase[:32])
    np.testing.assert_array_equal(to.freq, tref.freq[:32])


@pytest.mark.parametrize("k", [4, 8, 16, 32])
def test_batched_tracks_like_sequential(stream, sequential, k):
    """Any K tracks like the sequential loop, in both packages: lock, the
    final frequency within 3 Hz, code phases within 0.2 samples where
    both found the peak, and > 99% equal decoded bits."""
    n = stream.shape[0]
    _, jo, _, to = _track_both(CFG.replace(blocks_per_step=k), stream)
    _, jref, _, tref = sequential
    for dec, ref, got in ((JaxDecoder, jref, jo), (NavDecoder, tref, to)):
        ref_bits = _decode_bits(dec, ref, n)
        got_bits = _decode_bits(dec, got, n)
        for c in range(2):
            assert got.locked[-1, c] and ref.locked[-1, c]
            assert abs(got.freq[-1, c] - SATS[c].doppler) < 3.0
            both = (ref.code_phase[:, c] >= 0) & (got.code_phase[:, c] >= 0)
            assert both.mean() > 0.9
            np.testing.assert_allclose(ref.code_phase[both, c],
                                       got.code_phase[both, c], atol=0.2)
            a, b = ref_bits[c], got_bits[c]
            m = min(len(a), len(b))
            assert m > 100 and (a[:m] == b[:m]).mean() > 0.99


@pytest.mark.parametrize("k", [8, 16, 32])
def test_fresh_channel_pull_in(stream, k):
    """Channel 0 reset 100 Hz off its Doppler pulls in at K = 8, 16 and
    32 in both packages: locked from block 40, within 3 Hz at the end,
    the peak found on > 80% of the blocks from block 8."""
    js, jo, ts, to = _track_both(CFG.replace(blocks_per_step=k),
                                 stream[:64], offset=100.0)
    for st, o in ((js, jo), (ts, to)):
        assert o.locked[40:, 0].all()
        assert abs(float(np.asarray(st.freq)[0]) - SATS[0].doppler) < 3.0
        assert (o.code_phase[8:, 0] >= 0).mean() > 0.8


def test_batched_remainder_tail(stream, sequential):
    """T = 11 * 8 + 4: the fused prefix and the K=1 tail end with the
    sequential loop's lock and frequency, in both packages."""
    t = 92
    js, jo, ts, to = _track_both(CFG.replace(blocks_per_step=8), stream[:t])
    jseq, jref_o, tseq, tref_o = _track_both(CFG, stream[:t], batched=False)
    for st_ref, st, ro, go in ((jseq, js, jref_o, jo),
                               (tseq, ts, tref_o, to)):
        assert go.code_phase.shape[0] == t
        np.testing.assert_array_equal(np.asarray(st_ref.locked),
                                      np.asarray(st.locked))
        np.testing.assert_allclose(np.asarray(st_ref.freq),
                                   np.asarray(st.freq), atol=1.0)
        both = (ro.code_phase[-4:] >= 0) & (go.code_phase[-4:] >= 0)
        np.testing.assert_allclose(ro.code_phase[-4:][both],
                                   go.code_phase[-4:][both], atol=0.2)


SMALL = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                       sweep_corr_avg=2, blocks_per_step=4)
SMALL_SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                        nav_bits=random_bits(64, seed=5)),
              SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                        nav_bits=random_bits(64, seed=12))]


@pytest.mark.parametrize("mxu", [True, False])
def test_planar_input_equals_complex(mxu):
    """Planar f32[T, 2, ngps] IQ gives the complex blocks' results through
    either wipeoff layout of the port (the JAX bar: code phase 1e-5,
    amplitude rtol 1e-4, frequency 1e-4 Hz), and both equal the JAX
    package's XLA path within `_compare`."""
    cfg = SMALL.replace(use_mxu_wipeoff=mxu)
    blocks = synth_stream(cfg, SMALL_SATS, 16, noise_std=0.2, seed=9)
    planar = np.stack([blocks.real, blocks.imag], axis=1)
    jst = jtrk.init_channel_states(_jax(cfg), 2)
    codes = np.stack([cacode.ca_table(cfg)[s.prn] for s in SMALL_SATS])
    ffts = np.stack([cacode.ca_fft_table(cfg)[s.prn] for s in SMALL_SATS])
    for i, s in enumerate(SMALL_SATS):
        jst = jtrk.reset_channel(jst, i, s.prn, s.doppler,
                                 int(s.code_delay), _jax(cfg))
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(jst).items()}
    js, jo = jtrk.track_chunk_batched(_jax(cfg), jst, jnp.asarray(blocks),
                                      jnp.int32(1), jnp.asarray(codes),
                                      jnp.asarray(ffts))
    runs = [ttrk.track_chunk_batched_impl(
        cfg, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(x), 1,
        torch.from_numpy(codes), torch.from_numpy(ffts))
        for x in (blocks, planar)]
    (ts_c, to_c), (ts_p, to_p) = runs
    np.testing.assert_allclose(to_p.code_phase.numpy(),
                               to_c.code_phase.numpy(), atol=1e-5)
    np.testing.assert_allclose(to_p.amplitude.numpy(),
                               to_c.amplitude.numpy(), rtol=1e-4)
    np.testing.assert_allclose(ts_p.freq.numpy(), ts_c.freq.numpy(),
                               atol=1e-4)
    for ts, to in runs:
        _compare(js, jo, ts, to)


# --- tests/test_formats_ncyc.py ---------------------------------------------


def test_pack_unpack_quantization():
    rng = np.random.default_rng(0)
    x = (0.3 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
         ).astype(np.complex64)
    words = sources.pack_iq(x)
    np.testing.assert_array_equal(words, jsrc.pack_iq(x))
    y = sources.unpack_iq(words)
    np.testing.assert_array_equal(y, jsrc.unpack_iq(words))
    xc = np.clip(x.real, -1, 1) + 1j * np.clip(x.imag, -1, 1)
    assert np.abs(y - xc).max() <= 1.0 / 127.5


def test_capture_replay_roundtrip(tmp_path):
    """The JAX test's 4-block capture at x0.25: both packages write the
    same bytes and replay the same blocks (START_STREAM skip included);
    both acquire PRN 13 at the same frequency and delay."""
    cfg = ReceiverConfig()
    blocks = 0.25 * cached_synth("fmt_cap_v1", lambda: synth_stream(
        cfg, [SAT], n_blocks=4, noise_std=0.4, seed=2))
    paths = []
    for src in (jsrc, sources):
        path = tmp_path / f"cap_{src.__name__}.bin"
        with open(path, "wb") as f:
            for b in blocks:
                src.pack_iq(b).tofile(f)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    # the port's replay yields the packed words; unpacked, the JAX blocks
    got = sources.unpack_iq(np.stack(list(sources.replay_blocks(
        str(paths[1]), cfg))))
    np.testing.assert_array_equal(got, np.stack(list(jsrc.replay_blocks(
        str(paths[0]), _jax(cfg)))))
    assert got.shape == blocks.shape
    assert np.abs(got - blocks).max() <= 1.0 / 127.5
    skip = [sources.unpack_iq(w) for w in sources.replay_blocks(
        str(paths[1]), cfg, start_stream=2)]
    jskip = list(jsrc.replay_blocks(str(paths[0]), _jax(cfg),
                                    start_stream=2))
    assert len(skip) == len(jskip) == 2
    np.testing.assert_array_equal(skip[0], got[2])
    np.testing.assert_array_equal(np.stack(skip), np.stack(jskip))
    table = cacode.ca_fft_table(cfg)
    want = jax_acquire_all(_jax(cfg), got[0], table, prns=[13])
    found = acquire_all(cfg, got[0], table, prns=[13], device="cpu")
    assert found and found[0][1] == 13
    assert [f[1:] for f in found] == [f[1:] for f in want]
    np.testing.assert_allclose([f[0] for f in found], [f[0] for f in want],
                               rtol=1e-4)


@pytest.mark.parametrize("n_cyc", [16, 8])
def test_tracking_other_epoch_lengths(n_cyc):
    """~2 s at n_cyc 16 and 8 (the JAX test's capture): both packages
    acquire PRN 13 alike and track it alike within `_compare`; both meet
    the JAX bars (lock, the peak on > 90% of the blocks, the frequency
    within 5 Hz, edges framed into 20 ms bits)."""
    cfg = ReceiverConfig(n_cyc=n_cyc)
    n_blocks = 2 * cfg.no_sec
    blocks = cached_synth(f"fmt_ncyc{n_cyc}_v1", lambda: synth_stream(
        cfg, [SAT], n_blocks=n_blocks, noise_std=0.4, seed=3))
    table = cacode.ca_fft_table(cfg)
    want = jax_acquire_all(_jax(cfg), blocks[0], table, prns=[13])
    found = acquire_all(cfg, blocks[0], table, prns=[13], device="cpu")
    assert [f[1:] for f in found] == [f[1:] for f in want]
    _, _, freq, delay = found[0]
    jst = jtrk.reset_channel(jtrk.init_channel_states(_jax(cfg), 1), 0, 13,
                             freq, delay, _jax(cfg))
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(jst).items()}
    code = cacode.ca_table(cfg)[13][None].copy()
    cfft = table[13][None].copy()
    js, jo = jtrk.track_chunk(_jax(cfg), jst, jnp.asarray(blocks),
                              jnp.int32(1), jnp.asarray(code),
                              jnp.asarray(cfft))
    ts, to = ttrk.track_chunk_impl(cfg, ttrk.states_from_numpy(tree, "cpu"),
                                   torch.from_numpy(blocks), 1,
                                   torch.from_numpy(code),
                                   torch.from_numpy(cfft))
    compare_product(cfg, js, jo, ts, to)
    for o in (jtrk.outs_to_numpy(jo), ttrk.outs_to_numpy(to)):
        assert o.locked[-1, 0]
        assert (o.code_phase[:, 0] >= 0).mean() > 0.9
        assert abs(o.freq[-1, 0] - SAT.doppler) < 5.0
        assert o.edge_valid[:, 0].sum() > n_blocks // (40 // n_cyc + 1) // 4
