"""PyTorch port vs JAX: the K-block cheap stage (ops/hopper_cheap.py).

The port's channel_step_k on CPU tensors runs the plain PyTorch twin of
the CUDA cheap-stage kernel.  One numpy state and one heavy-stage
result feed three versions:
  * the port (plain PyTorch),
  * cheap_stage_pallas in Pallas interpret mode on the CPU,
  * the vmapped XLA channel_step_k,
compared with the tolerances of tests/test_pallas_cheap.py: amplitude
rtol 1e-3 (f32 reduction order, amplified by mean/std), corr_q/corr_l
atol 1e-6 (exact +-1 sums divided in f32), freq and float state atol
1e-3, df ring atol 1e-5; locked, sign0, edges and integer state exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.ops.pallas_cheap import cheap_stage_pallas
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import cacode, hopper_cheap
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


def _tables(cfg=CFG):
    codes = np.zeros((2, cfg.code_samples), np.float32)
    ffts = np.zeros((2, cfg.code_samples), np.complex64)
    for i, s in enumerate(SATS):
        codes[i] = cacode.ca_table(cfg)[s.prn]
        ffts[i] = cacode.ca_fft_table(cfg)[s.prn]
    return jnp.asarray(codes), jnp.asarray(ffts)


def _fresh(cfg=CFG):
    st = jtrk.init_channel_states(_jax(cfg), 2)
    for i, s in enumerate(SATS):
        st = jtrk.reset_channel(st, i, s.prn, s.doppler, int(s.code_delay),
                                _jax(cfg))
    return st


def _tracked(n_warm, cfg=CFG):
    """(state after n_warm tracked blocks, heavy result of the next K)."""
    blocks = jnp.asarray(synth_stream(cfg, SATS, n_warm + K,
                                      noise_std=0.2, seed=9))
    codes, ffts = _tables(cfg)
    st = _fresh(cfg)
    if n_warm:
        st, _ = jtrk.track_chunk_batched(_jax(cfg), st, blocks[:n_warm],
                                         jnp.int32(1), codes, ffts)
    heavy = jtrk.heavy_stage(_jax(cfg), K, st, blocks[n_warm:], codes, ffts)
    return st, heavy


def _three_ways(states, heavy, stream_no0, cfg=CFG):
    xla = jax.vmap(functools.partial(jtrk.channel_step_k, _jax(cfg), K),
                   in_axes=(0, 0, None), out_axes=0)
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(states).items()}
    got_st, got = ttrk.channel_step_k(
        cfg, K, ttrk.states_from_numpy(tree, "cpu"),
        ttrk.HeavyOut(*[torch.from_numpy(np.array(x)) for x in heavy]),
        stream_no0)
    ref = [xla(states, heavy, jnp.int32(stream_no0)),
           cheap_stage_pallas(_jax(cfg), K, states, heavy, jnp.int32(stream_no0))]
    return (got_st, got), ref


def _compare(got_pair, ref_pair, state_atol=None):
    """Outputs and state at the cheap tolerances; with `state_atol`, every
    float state (df ring included) at that tolerance instead."""
    got_st, got = got_pair
    ref_st, ref = ref_pair
    go = {k: v.numpy() for k, v in got._asdict().items()}
    for name in ("code_phase", "norm_max", "freq"):
        np.testing.assert_allclose(go[name], np.asarray(getattr(ref, name)),
                                   atol=1e-3)
    np.testing.assert_allclose(go["amplitude"], np.asarray(ref.amplitude),
                               rtol=1e-3)
    for name in ("corr_q", "corr_l"):
        np.testing.assert_allclose(go[name], np.asarray(getattr(ref, name)),
                                   atol=1e-6)
    for name in ("delay", "locked", "erased", "sweep_request", "sign0",
                 "edge_valid"):
        np.testing.assert_array_equal(
            go[name], np.asarray(getattr(ref, name)).astype(go[name].dtype))
    valid = go["edge_valid"]
    for name in ("edge_ms", "edge_local"):
        np.testing.assert_array_equal(
            go[name][valid],
            np.asarray(getattr(ref, name)).astype(np.int64)[valid])
    want = {k: np.asarray(v) for k, v in jtrk.pack_states(ref_st).items()}
    have = ttrk.states_to_numpy(got_st)
    for name, v in want.items():
        if name.startswith(("freq", "phase", "std_dev", "prev_signal",
                            "carry_sum")):
            np.testing.assert_allclose(have[name], v, atol=state_atol or 1e-3,
                                       err_msg=name)
        elif name == "df_buf":
            np.testing.assert_allclose(have[name], v, atol=state_atol or 1e-5)
        else:                                       # integer-valued
            np.testing.assert_array_equal(have[name], v, err_msg=name)


@pytest.mark.parametrize("n_warm", [0, 8])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_cheap_stage_matches_jax(n_warm, ref):
    states, heavy = _tracked(n_warm)
    got, refs = _three_ways(states, heavy, n_warm + 1)
    _compare(got, refs[ref == "pallas"])


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_full_wrapped_ring(ref):
    """A full, wrapped correlation ring and df ring: the 1 s window and
    the ring sums must come out exact."""
    states, heavy = _tracked(8)
    rng = np.random.default_rng(4)
    hist = CFG.corr_hist_len
    ring = rng.choice(np.array([-1, 1], np.int8), size=(2, hist))
    states = states._replace(
        corr_buf=jnp.asarray(ring), corr_cnt=jnp.full(2, hist, jnp.int32),
        corr_idx=jnp.asarray([hist - 2, 7], jnp.int32),
        df_cnt=jnp.full(2, CFG.no_sec, jnp.int32),
        df_idx=jnp.asarray([0, CFG.no_sec - 1], jnp.int32),
        df_buf=jnp.asarray(0.01 * rng.standard_normal((2, CFG.no_sec)),
                           jnp.float32))
    got, refs = _three_ways(states, heavy, 9)
    _compare(got, refs[ref == "pallas"])


def test_large_ms_time_exact():
    """ms_time past 2^24 stays integer-exact (odd offset: an f32 counter
    would round it); the port keeps ms_time as int32 throughout."""
    base = 2 ** 25 + 3
    states, heavy = _tracked(8)
    states = states._replace(ms_time=jnp.full_like(states.ms_time, base),
                             locked=jnp.ones(2, bool))
    got, refs = _three_ways(states, heavy, 9)
    for ref in refs:
        _compare(got, ref)
    got_st, out = got
    assert (out.edge_ms.numpy()[out.edge_valid.numpy()] >= base).all()
    assert (got_st.ms_time.numpy() > base).all()
    assert ((got_st.ms_time.numpy() - base) % 2
            == (np.asarray(refs[0][0].ms_time) - base) % 2).all()


def test_delay_wrap_zero_mean_no_nan():
    """wipe delay 0 with an empty carry makes the slot-0 mean exactly
    0+0j; the PLL's arctan(Q/I) guard must keep NaN out of the state."""
    n_ch, cs, n_cyc = 2, CFG.code_samples, CFG.n_cyc
    states = jtrk.init_channel_states(_jax(CFG), n_ch)
    for i, s in enumerate(SATS):
        states = jtrk.reset_channel(states, i, s.prn, s.doppler, 0, _jax(CFG))
    states = states._replace(
        locked=jnp.ones(n_ch, bool),
        std_dev=jnp.full((n_ch,), 0.05, jnp.float32),
        prev_stream=jnp.zeros(n_ch, jnp.int32))
    rng = np.random.default_rng(3)
    segs = (cs * 0.05 * (1.0 + 0.1 * rng.standard_normal((n_ch, K, n_cyc)))
            ).astype(np.float32) + 1j * (cs * 0.005 * rng.standard_normal(
                (n_ch, K, n_cyc))).astype(np.float32)
    heavy = jtrk.HeavyOut(
        delay_k=jnp.zeros((n_ch, K), jnp.int32),
        code_phase_k=jnp.full((n_ch, K), 0.25, jnp.float32),
        norm_max_k=jnp.full((n_ch, K), 12.0, jnp.float32),
        new_delay_k=jnp.zeros((n_ch, K), jnp.int32),
        head_k=jnp.zeros((n_ch, K), jnp.complex64),
        seg_sums_k=jnp.asarray(segs, jnp.complex64),
        phase_end=jnp.zeros((n_ch,), jnp.float32),
        wipe_delay=jnp.zeros((n_ch, K), jnp.int32))
    got, refs = _three_ways(states, heavy, 1)
    got_st, _ = got
    for name in ("freq", "phase", "std_dev", "prev_signal"):
        assert np.isfinite(getattr(got_st, name).numpy()).all()
    for ref in refs:
        _compare(got, ref)


def test_erase_on_gap():
    """A stream gap before the step erases the bit/edge carry and flags
    the step's first block only."""
    states, heavy = _tracked(8)
    got, refs = _three_ways(states, heavy, 20)      # 9 expected: gap
    got_st, out = got
    assert out.erased[:, 0].all() and not out.erased[:, 1:].any()
    for ref in refs:
        _compare(got, ref)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_crafted_case_matches_jax(ref):
    """chip_smoke.cheap_case, the card's crafted case for the cheap
    kernel (sign flips in the last two slots, PLL unwrap steps, wipe
    delays 0 and cs - 1 with slot compaction, channels locking inside the
    step, full wrapped rings at no_sec = 128), through the port's plain
    version and the JAX cheap stage.  Made without its crossings of the
    code period boundary (wraps=False): the JAX package shares fault A,
    so the case with them is held to the plain version on the card and
    to the period rule here (test_crafted_wrap_case_keeps_one_period_a_slot)."""
    args, facts = chip_smoke.cheap_case(CFG, 4, 3, "cpu", wraps=False)
    _, k, head, seg, delay, wipe, st = args
    chip_smoke.check_cheap_facts(CFG, hopper_cheap.cheap_scan_plain(*args),
                                 facts)
    n_ch = head.shape[0]
    zeros = jnp.zeros((n_ch, k), jnp.float32)
    heavy = jtrk.HeavyOut(
        delay_k=jnp.asarray(delay.numpy()), code_phase_k=zeros,
        norm_max_k=zeros, new_delay_k=jnp.asarray(delay.numpy()),
        head_k=jnp.asarray(head.numpy()), seg_sums_k=jnp.asarray(seg.numpy()),
        phase_end=jnp.zeros((n_ch,), jnp.float32),
        wipe_delay=jnp.asarray(wipe.numpy()))
    states = jtrk.unpack_states(ttrk.states_to_numpy(st))
    got, refs = _three_ways(states, heavy, 1)
    _compare(got, refs[ref == "pallas"])


def test_crafted_wrap_case_keeps_one_period_a_slot(monkeypatch):
    """chip_smoke.cheap_case with its crossings of the code period
    boundary (slot 0 dropped after delay 0, merged into segment 0, split
    in two) through the port's plain version: it reaches every fact it
    was made for, and each channel's valid slots start one code period
    apart, from half a period to one and a half (the case's own jumps of
    cs / 2 included): no sliver of a period reads as a millisecond and
    no slot holds two."""
    seen = []
    real = ttrk._means_from_sums

    def record(*args):
        out = real(*args)
        seen.append((out[1], out[2]))                  # starts, mask
        return out

    monkeypatch.setattr(ttrk, "_means_from_sums", record)
    args, facts = chip_smoke.cheap_case(CFG, 4, 3, "cpu")
    seen.clear()                    # the design ran the blocks before
    chip_smoke.check_cheap_facts(CFG, hopper_cheap.cheap_scan_plain(*args),
                                 facts)
    assert facts["wraps"]
    cs = CFG.code_samples
    for c in range(4):
        starts = np.concatenate([b * CFG.ngps + st[c][m[c]].numpy()
                                 for b, (st, m) in enumerate(seen)])
        gaps = np.diff(starts)
        assert ((cs // 2 <= gaps) & (gaps <= 3 * cs // 2)).all(), (c, gaps)


def test_cheap_trace_plain_side():
    """cheap_trace.py, the card-side trace of the kernel's PLL: each line
    it inserts its writes before is found once in csrc/cheap.cu, and its
    plain side, recorded from cheap_scan_plain's calls of _pll on
    replicas 3 Hz apart, gives cheap_scan_plain's results bit for bit
    (and itself checks the dphi and df_sum it advances)."""
    import cheap_trace
    from gps_sdr_tpu_torch.ops import _build

    text = (_build.CSRC / "cheap.cu").read_text()
    assert [text.count(a) for a, _ in cheap_trace.TRACE_INSERTS] == [1] * 4
    st, chunk, codes, ffts = chip_smoke.stream_case(CFG, 3, True, 2 * K, 5,
                                                    "cpu", dopp_step=3.0)
    heavy = ttrk.heavy_stage(CFG, K, st, chunk, 0, codes, ffts, n_streams=3)
    _, erased = ttrk._erased(st, 1)
    args = (CFG, K, heavy.head_k, heavy.seg_sums_k, heavy.delay_k,
            heavy.wipe_delay, erased)
    out, tr = cheap_trace.plain_trace(args)
    want = hopper_cheap.cheap_scan_plain(*args)
    assert all(chip_smoke._same_bits(a, b) for a, b in zip(out, want))
    assert tr["df"].shape == (3 * CFG.max_sat, K)
    assert torch.equal(tr["locked_in"][:, 0], erased.locked.float())


# n_cyc 64: 65 means slots a block, past the two slots a lane that the
# kernel took before (its four-slot build, csrc/cheap.cu H = 4)
CFG64 = CFG.replace(n_cyc=64)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_cheap_stage_at_n_cyc_64(ref):
    states, heavy = _tracked(8, CFG64)
    got, refs = _three_ways(states, heavy, 9, CFG64)
    _compare(got, refs[ref == "pallas"])
    assert got[1].edge_valid.shape[-1] == 65


def test_k_fused_tracking_at_n_cyc_64():
    """The JAX package's track_chunk_batched_impl (XLA cheap stage)
    against the port's plain K-fused path at n_cyc 64: every block's
    outputs at the cheap tests' tolerances; the final float state (df
    ring included) at tests/test_torch_tracking.py's 1e-2, since over a
    chunk it carries the heavy stage's f32 sums forward, not only the
    cheap stage's (carry_sum, the last segment's raw sum of ~cs samples,
    2.6e-3 apart here; the df ring 2.6e-4).  One second of 16 blocks,
    four K-steps."""
    n_blocks = CFG64.no_sec
    blocks = synth_stream(CFG64, SATS, n_blocks, noise_std=0.2, seed=9)
    codes, ffts = _tables(CFG64)
    states = _fresh(CFG64)
    tree = {k: np.asarray(v) for k, v in jtrk.pack_states(states).items()}
    jst, jo = jtrk.track_chunk_batched_impl(
        _jax(CFG64), states, jnp.asarray(blocks), jnp.int32(1), codes, ffts)
    tst, to = ttrk.track_chunk_batched_impl(
        CFG64, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks),
        1, torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(ffts)))
    _compare((tst, to), (jst, jo), state_atol=1e-2)
    assert to.edge_valid.shape == (n_blocks, 2, 65)
    assert to.locked.any() and to.edge_valid.any()
