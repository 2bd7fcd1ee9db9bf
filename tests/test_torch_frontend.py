"""PyTorch port vs JAX: the digital front end (ops/frontend.py), CW
excision on every tracking path, replay_decimated and the CLI's
--input-rate.

  * Frontend (conv1d decimation) against the JAX Frontend, complex input
    at factors 4 and 8, in one feed and in awkward chunk sizes: atol 2e-6
    (tests/test_frontend.py's bound against numpy);
  * the real-IF DDC against the JAX DDC at n = 65536, fed in two chunks
    (the NCO phase carried across them): per output sample, the
    tolerance the f32 angle allows.  Both packages form the f32 angle
    2 pi (phase0 + f_ratio k), but may round phase0 + f_ratio k once or
    twice (a fused multiply-add or not): one spacing of that f32 value
    times 2 pi, one spacing of the angle, and the cos/sin ulps, times
    sum|taps| and max|x|, plus the 2e-6 of the FIR;
  * excise_cw_block / excise_cw_chunk against the JAX functions on
    blocks with a 1500 Hz, amplitude-100 tone, in the complex, flat
    planar and grouped planar layouts: the same bins nulled, except bins
    within 1e-5 relative of the threshold (counted, at most 2); outputs
    within 1e-4 plus the differing bins' share |X_k|/n;
  * tracking with cw_excision=12 (track_chunk_batched with a fused prefix
    and a K=1 tail, and track_chunk) against JAX at the small config,
    with tests/test_torch_tracking.py's tolerances;
  * Receiver.run, Receiver.run_device and StreamServer with excision
    against the JAX ones, with tests/test_torch_device_path.py's
    tolerances.  The stream-axis chunk is excised once and equals the
    per-stream excision;
  * in both, but for PRN 5's amplitude and AMP (amp_rtol): with excision
    the two packages track inputs that differ by their FFTs' rounding of
    the tone (up to 4e-5 on these blocks), and JAX's CPU excision is not
    the same in the last bit from one process to the next (its clean
    runs are).  PRN 5 is the strong channel; its amplitude, the mean
    over the std of a block's two means, reaches 90-122 here, where one
    f32 rounding moves it by about eps_f32 A^2 / 4 relative.  Over 12
    processes the port and JAX differed by up to 1.2 eps A^2 in it, and
    JAX's own AMP took five values 2.4e-3 apart on the same input
    (`python -m tests.test_torch_frontend`, PERF.md "PR 6"), so it is
    held to rtol 1e-3 + 2 eps A^2;
  * replay_decimated against JAX on iq8 and real16 files, the
    non-integer rate refused, and `replay --input-rate` through
    cli.main."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.ops import frontend as jfe
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.runtime.receiver import Receiver as JaxReceiver
from gps_sdr_tpu.runtime.serving import StreamServer as JaxServer
from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import frontend as tfe
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.runtime.serving import StreamServer
from gps_sdr_tpu_torch.runtime.sources import (pack_iq, replay_decimated,
                                               unpack_iq)
from tests import test_torch_tracking as tt
from tests.test_torch_device_path import (CFG, SATS, T, _compare_decoders,
                                          _compare_epochs, _jax)

torch.set_num_threads(2)

PRODUCT = ReceiverConfig()
CW = (1500.0, 100.0)            # tone Hz, amplitude (tests/test_multipath.py)


def _tone(cfg, n_blocks, freq_hz, amp):
    """Continuous-phase CW tone across blocks: complex64 [n_blocks, ngps]."""
    t = np.arange(n_blocks * cfg.ngps, dtype=np.float64) / cfg.sample_rate
    return (amp * np.exp(2j * np.pi * freq_hz * t)).astype(
        np.complex64).reshape(n_blocks, cfg.ngps)


# -- decimation and DDC ------------------------------------------------------

@pytest.mark.parametrize("factor", [4, 8])
def test_frontend_matches_jax(factor):
    rng = np.random.default_rng(factor)
    n = 40_000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    want = jfe.Frontend(factor).feed(x)
    got = tfe.Frontend(factor, device="cpu").feed(x)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # the seam: awkward chunk sizes (tests/test_frontend.py:44)
    fe = tfe.Frontend(factor, device="cpu")
    outs, i = [], 0
    for size in (7, 1000, 3, 8191, 12345, n):
        outs.append(fe.feed(x[i:i + size]))
        i += size
        if i >= n:
            break
    chunked = np.concatenate(outs)
    assert chunked.shape == want.shape
    np.testing.assert_allclose(chunked, want, rtol=0, atol=2e-6)


def test_ddc_matches_jax():
    fs_in, f_if, factor, n = 8.192e6, 2.048e6 + 1234.5, 4, 65536
    rng = np.random.default_rng(1)
    t = np.arange(n) / fs_in
    x = (np.cos(2 * np.pi * (f_if + 1300.0) * t)
         + 0.3 * rng.standard_normal(n)).astype(np.float32)
    parts = (x[:40_000], x[40_000:])
    jf = jfe.Frontend(factor, f_if=f_if, fs_in=fs_in)
    tf = tfe.Frontend(factor, f_if=f_if, fs_in=fs_in, device="cpu")
    want = np.concatenate([jf.feed(p) for p in parts])
    got = np.concatenate([tf.feed(p) for p in parts])
    assert got.shape == want.shape and got.size > 16000
    assert tf._phase == jf._phase
    # the bound per output sample j, from the largest angle its window
    # reads (input samples up to j*factor of the chunk that holds it)
    f_ratio = np.float32(f_if / fs_in)
    k_in = np.arange(got.size) * factor
    k_chunk = np.where(k_in < 40_000, k_in, k_in - 40_000).astype(
        np.float32)
    v = np.abs(np.float32(jf._phase) + f_ratio * k_chunk) + 1.0
    ang_ulp = 2 * np.pi * np.spacing(v) + np.spacing(
        np.float32(2 * np.pi) * v)
    taps = np.abs(tfe.decimation_taps(factor)).sum()
    tol = taps * np.abs(x).max() * (ang_ulp + 4 * np.spacing(
        np.float32(1))) + 2e-6
    err = np.abs(got - want)
    assert (err <= tol).all(), float((err / tol).max())


def test_design_matches_jax():
    for factor in (2, 4, 8):
        np.testing.assert_array_equal(tfe.decimation_taps(factor),
                                      jfe.decimation_taps(factor))
    np.testing.assert_array_equal(tfe.design_lowpass(64, 0.3),
                                  jfe.design_lowpass(64, 0.3))


# -- CW excision -------------------------------------------------------------

def _jammed(cfg, n_blocks, seed):
    sats = [SatSignal(prn=17, doppler=-1500.0, code_delay=900.25 % (
        cfg.code_samples - 1), nav_bits=random_bits(64, seed=17))]
    blocks = synth_stream(cfg, sats, n_blocks, noise_std=0.5, seed=seed)
    return blocks + _tone(cfg, n_blocks, *CW)


def _jax_mask(block, thr):
    """The JAX function's keep mask, with its own operations (the CPU
    DFT is jnp.fft)."""
    spec = jnp.fft.fft(jnp.asarray(block))
    mag = jnp.abs(spec)
    return np.asarray(mag <= jnp.float32(thr) * jnp.mean(mag)), \
        np.asarray(mag), float(jnp.float32(thr) * jnp.mean(mag))


@pytest.mark.parametrize("layout", ["complex", "planar", "grouped"])
def test_excision_matches_jax(layout):
    cfg = PRODUCT.replace(cw_excision=12.0)
    blocks = _jammed(cfg, 2, seed=4)
    chunk = torch.from_numpy(blocks)
    if layout == "planar":
        chunk = torch.stack([chunk.real, chunk.imag], dim=1)
    elif layout == "grouped":
        chunk = ttrk.to_grouped_planar(cfg, chunk)
    got = tfe.excise_cw_chunk(cfg, chunk)
    want = np.asarray(jfe.excise_cw_chunk(cfg, jnp.asarray(chunk.numpy())))
    assert tuple(got.shape) == want.shape and got.dtype == chunk.dtype
    got_c = ttrk.dsp.as_complex_input(got).numpy()
    want_c = np.asarray(jtrk.dsp.as_complex_input(jnp.asarray(want)))
    n = cfg.ngps
    for b in range(2):
        spec = torch.fft.fft(torch.from_numpy(blocks[b]))
        mag = spec.abs()
        keep = (mag <= 12.0 * mag.mean()).numpy()
        jkeep, jmag, jthr = _jax_mask(blocks[b], 12.0)
        # the tone is nulled, and a handful of bins with it
        tone_bin = int(round(CW[0] / cfg.sample_rate * n))
        assert not keep[tone_bin] and 0 < (~keep).sum() < 64
        differ = np.nonzero(keep != jkeep)[0]
        assert len(differ) <= 2
        assert (np.abs(jmag[differ] - jthr) <= 1e-5 * jthr).all()
        share = jmag[differ].sum() / n
        np.testing.assert_allclose(got_c[b], want_c[b], rtol=0,
                                   atol=1e-4 + share)
    # the single-block entry on one block
    one = tfe.excise_cw_block(torch.from_numpy(blocks[0]), 12.0).numpy()
    np.testing.assert_allclose(one, np.asarray(jfe.excise_cw_block(
        jnp.asarray(blocks[0]), 12.0)), rtol=0, atol=1e-4)


def test_excision_stream_axis_is_per_stream():
    """A stacked [S, T, ...] chunk is one batched FFT; it equals the
    excision of each stream's chunk, and a shared chunk's excision is
    every stream's."""
    cfg = CFG.replace(cw_excision=12.0)
    x = np.stack([_jammed(cfg, 3, seed=s) for s in (1, 2)])
    planar = ttrk.to_grouped_planar(cfg, torch.from_numpy(x))
    both = tfe.excise_cw_chunk(cfg, planar)
    for s in range(2):
        np.testing.assert_array_equal(
            both[s].numpy(), tfe.excise_cw_chunk(cfg, planar[s]).numpy())


# -- tracking with excision ---------------------------------------------------

EPS = float(np.finfo(np.float32).eps)
STRONG_PRN = 5          # SATS[0] here and in tests/test_torch_tracking.py


def amp_rtol(a):
    """rtol of PRN 5's amplitude or AMP `a` with excision (docstring)."""
    return 1e-3 + 2 * EPS * np.square(a)


def _compare_excised(jst, jo, tst, to):
    """tests/test_torch_tracking.py _compare, with amp_rtol on PRN 5's
    amplitude (column 0)."""
    tt._compare(jst, jo, tst, to, amplitude=False)
    want = jtrk.outs_to_numpy(jo).amplitude                 # [T, C]
    got = ttrk.outs_to_numpy(to).amplitude
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-3)
    a, b = want[:, 0], got[:, 0]
    assert (np.abs(b - a) <= amp_rtol(a) * np.abs(a)).all(), (a, b)


def _excision_setup(n_blocks):
    states, tree, blocks, codes, ffts = tt._setup(n_blocks)
    blocks = blocks + _tone(tt.CFG, n_blocks, *CW)
    return states, tree, blocks, codes, ffts


@pytest.mark.parametrize("n_blocks", [16, 18])   # 18: 16 fused + K=1 tail
def test_track_chunk_batched_excision_matches_jax(n_blocks):
    cfg = tt.CFG.replace(cw_excision=12.0)
    states, tree, blocks, codes, ffts = _excision_setup(n_blocks)
    jst, jo = jtrk.track_chunk_batched(_jax(cfg), states, jnp.asarray(blocks),
                                       jnp.int32(1), jnp.asarray(codes),
                                       jnp.asarray(ffts))
    tst, to = ttrk.track_chunk_batched_impl(
        cfg, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks),
        1, torch.from_numpy(codes), torch.from_numpy(ffts))
    _compare_excised(jst, jo, tst, to)
    # through the tone the excised channels find their code on nearly
    # every block (unexcised, PRN 12 finds it on none of them)
    assert (ttrk.outs_to_numpy(to).code_phase >= 0).mean() > 0.9


def test_track_chunk_k1_excision_matches_jax():
    cfg = tt.CFG.replace(cw_excision=12.0)
    states, tree, blocks, codes, ffts = _excision_setup(6)
    jst, jo = jtrk.track_chunk(_jax(cfg), states, jnp.asarray(blocks),
                               jnp.int32(1), jnp.asarray(codes),
                               jnp.asarray(ffts))
    tst, to = ttrk.track_chunk_impl(
        cfg, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks),
        1, torch.from_numpy(codes), torch.from_numpy(ffts))
    _compare_excised(jst, jo, tst, to)


N_CHUNKS = 3


def _compare_run_epochs(jep, tep):
    """_compare_epochs, with amp_rtol on PRN 5's AMP."""
    for je, te in zip(jep, tep):
        for jf, tf in zip(je.frames, te.frames):
            if jf["SAT"] == STRONG_PRN and "AMP" in jf:
                a, b = jf.pop("AMP"), tf.pop("AMP")
                assert abs(b - a) <= amp_rtol(a) * abs(a), (a, b)
    _compare_epochs(jep, tep)


def _jammed_planar(n_blocks):
    blocks = synth_stream(CFG, SATS, n_blocks, noise_std=0.2, seed=9) \
        + _tone(CFG, n_blocks, *CW)
    return ttrk.to_grouped_planar(CFG, torch.from_numpy(blocks)).numpy()


def test_receiver_run_excision_matches_jax():
    """Host-fed Receiver.run (cold sweep on an excised block, then
    excised chunks)."""
    cfg = CFG.replace(cw_excision=12.0)
    iq = _jammed_planar(1 + N_CHUNKS * T)
    blocks = ttrk.dsp.as_complex_input(torch.from_numpy(iq)).numpy()
    jr, tr = JaxReceiver(_jax(cfg)), Receiver(cfg, device="cpu")
    jep = list(jr.run(iter(blocks)))
    tep = list(tr.run(iter(blocks)))
    assert [f[1:] for f in tr.found_sats] == [f[1:] for f in jr.found_sats]
    assert sorted(f[1] for f in tr.found_sats) == [5, 12]
    _compare_run_epochs(jep, tep)
    _compare_decoders(jr, tr)


@pytest.mark.parametrize("per_window", [False, True],
                         ids=["chunk-epochs", "window-epochs"])
def test_run_device_excision_matches_jax(per_window):
    cfg = CFG.replace(cw_excision=12.0, chunks_per_download=2,
                      epoch_per_window=per_window)
    iq = _jammed_planar(N_CHUNKS * T)
    jr, tr = JaxReceiver(_jax(cfg)), Receiver(cfg, device="cpu")
    jep = list(jr.run_device(lambda f, n: jnp.asarray(iq[f:f + n]),
                             N_CHUNKS, chunk_blocks=T))
    tep = list(tr.run_device(lambda f, n: torch.from_numpy(iq[f:f + n]),
                             N_CHUNKS, chunk_blocks=T))
    assert [f[1:] for f in tr.found_sats] == [f[1:] for f in jr.found_sats]
    assert tr.status.edge_overflows == jr.status.edge_overflows
    _compare_run_epochs(jep, tep)
    _compare_decoders(jr, tr)


def test_stream_server_excision_matches_jax():
    """Replicas of one jammed capture through the two servers (cold
    start: the shared sweep excises too)."""
    from tests.test_torch_serving import stream_epochs

    cfg = CFG.replace(cw_excision=12.0, chunks_per_download=2)
    iq = _jammed_planar(N_CHUNKS * T)
    js, ts = JaxServer(_jax(cfg), 2), StreamServer(cfg, 2, device="cpu")
    jep = stream_epochs(js, lambda f, n: jnp.asarray(iq[f:f + n]), N_CHUNKS)
    tep = stream_epochs(ts, lambda f, n: torch.from_numpy(iq[f:f + n]),
                        N_CHUNKS)
    for s in range(2):
        jr, tr = js.receivers[s], ts.receivers[s]
        assert [f[1:] for f in tr.found_sats] == \
            [f[1:] for f in jr.found_sats]
        assert tr.slots.slot_prn == jr.slots.slot_prn
        assert tr.status.edge_overflows == jr.status.edge_overflows
        _compare_run_epochs(jep[s], tep[s])
        _compare_decoders(jr, tr)


# -- sources and the CLI ------------------------------------------------------

CFG_HI = PRODUCT.replace(code_samples=4 * 2048)           # 8.192 MS/s
HI_SATS = [SatSignal(prn=5, doppler=1850.0, code_delay=1200.0),
           SatSignal(prn=12, doppler=-3200.0, code_delay=6000.0,
                     amplitude=0.9),
           SatSignal(prn=29, doppler=400.0, code_delay=8188.0,
                     amplitude=0.9)]


@pytest.fixture(scope="module")
def hi_capture(tmp_path_factory):
    """Two blocks of an 8.192 MS/s capture on disk, packed iq8 and as a
    real-IF int16 file (tests/test_frontend.py:148-188)."""
    from gps_sdr_tpu.runtime.sources import pack_iq as jax_pack

    d = tmp_path_factory.mktemp("hi")
    hi = synth_stream(CFG_HI, HI_SATS, n_blocks=2, noise_std=0.3,
                      seed=7).reshape(-1)
    p_iq = str(d / "hi_iq.bin")
    jax_pack(0.25 * hi).tofile(p_iq)
    fs_in = CFG_HI.sample_rate
    t = np.arange(hi.size) / fs_in
    real_if = np.real(0.2 * hi * np.exp(2j * np.pi * (fs_in / 4) * t))
    p_re = str(d / "hi_if.bin")
    (real_if * 32767).astype(np.int16).tofile(p_re)
    return p_iq, p_re


def test_replay_decimated_matches_jax(hi_capture):
    from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
    from gps_sdr_tpu.runtime.sources import \
        replay_decimated as jax_replay_decimated

    p_iq, p_re = hi_capture
    fs_in = CFG_HI.sample_rate
    jcfg = JaxConfig()
    got = list(replay_decimated(p_iq, PRODUCT, fs_in, device="cpu"))
    want = list(jax_replay_decimated(p_iq, jcfg, fs_in))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (PRODUCT.ngps,) and g.dtype == np.complex64
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    # in memory: the same samples through Frontend
    fe = tfe.Frontend(4, device="cpu")
    mem = fe.feed(unpack_iq(np.fromfile(p_iq, np.uint16)))
    np.testing.assert_array_equal(np.concatenate(got), mem[:2 * PRODUCT.ngps])
    # start_stream / max_blocks count OUTPUT blocks
    b1 = list(replay_decimated(p_iq, PRODUCT, fs_in, start_stream=1,
                               device="cpu"))
    assert len(b1) == 1 and np.array_equal(b1[0], got[1])
    assert len(list(replay_decimated(p_iq, PRODUCT, fs_in, max_blocks=1,
                                     device="cpu"))) == 1
    # real-IF int16
    got = list(replay_decimated(p_re, PRODUCT, fs_in, f_if=fs_in / 4,
                                fmt="real16", device="cpu"))
    want = list(jax_replay_decimated(p_re, jcfg, fs_in, f_if=fs_in / 4,
                                     fmt="real16"))
    assert len(got) == len(want) == 2
    # f_ratio = 1/4: the f32 angle is exact in both packages
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="integer multiple"):
        list(replay_decimated(p_iq, PRODUCT, 3.5 * PRODUCT.sample_rate,
                              device="cpu"))


def test_cli_replay_input_rate(hi_capture, capsys, tmp_path):
    """`replay --input-rate` decimates through the front end on the
    given device and runs the receiver on the 2.048 MS/s blocks: its
    cold sweep acquires the capture's satellites."""
    from gps_sdr_tpu_torch.utils.io import load_epoch_records

    p_iq, _ = hi_capture
    rec = str(tmp_path / "ep.pickle")
    rc = cli.main(["replay", p_iq, "--input-rate", str(CFG_HI.sample_rate),
                   "--device", "cpu", "--ui", "none", "--record-epochs",
                   rec])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "processed" in out and "on cpu" in out
    recs = load_epoch_records(rec)
    assert len(recs) == 1                   # block 0 swept, block 1 tracked
    assert {5, 12, 29} <= set(recs[0][2])


def test_pack_iq_is_the_jax_packing():
    from gps_sdr_tpu.runtime.sources import pack_iq as jax_pack

    x = (np.random.default_rng(0).uniform(-1, 1, 4096)
         + 1j * np.random.default_rng(1).uniform(-1, 1, 4096)).astype(
        np.complex64)
    np.testing.assert_array_equal(pack_iq(x), jax_pack(x))


# -- the readings behind amp_rtol ---------------------------------------------
#
#     python -m tests.test_torch_frontend        # from the repository root
#
# runs SPREAD_RUNS fresh interpreters (JAX's CPU excision is the same within
# a process, not from one process to the next), each with the tests' JAX
# settings (tests/conftest.py), and prints per interpreter the largest
# difference between the two packages' excised chunks (_excision_setup(16)),
# PRN 5's tracking amplitude with cw_excision=12 and its AMP at epoch 1 of
# tests/test_torch_recovery.py's receiver run with excision, in both
# packages (relative, and in eps_f32 A^2); then the distinct JAX values, their
# spread, and the largest port-vs-JAX differences.

SPREAD_RUNS = 12


def _spread_one() -> dict:
    """One interpreter's readings (the __main__ block below)."""
    from tests import test_torch_recovery as rec
    from tests.test_torch_device_path import _primed

    cfg = tt.CFG.replace(cw_excision=12.0)
    states, tree, blocks, codes, ffts = _excision_setup(16)
    ex_j = np.asarray(jfe.excise_cw_chunk(_jax(cfg), jnp.asarray(blocks)))
    ex_t = tfe.excise_cw_chunk(cfg, torch.from_numpy(blocks)).numpy()
    _, jo = jtrk.track_chunk_batched(_jax(cfg), states, jnp.asarray(blocks),
                                     jnp.int32(1), jnp.asarray(codes),
                                     jnp.asarray(ffts))
    _, to = ttrk.track_chunk_batched_impl(
        cfg, ttrk.states_from_numpy(tree, "cpu"), torch.from_numpy(blocks),
        1, torch.from_numpy(codes), torch.from_numpy(ffts))
    a = jtrk.outs_to_numpy(jo).amplitude[:, 0]              # PRN 5
    b = ttrk.outs_to_numpy(to).amplitude[:, 0]
    i = int(np.argmax(np.abs(b - a) / np.abs(a)))

    rcfg = rec._cfg(True)
    iq = rec._iq(rcfg, True)
    jr = _primed(JaxReceiver(_jax(rcfg)))
    tr = _primed(Receiver(rcfg, device="cpu"))
    jep = list(jr.run_device(lambda f, n: jnp.asarray(iq[f:f + n]),
                             rec.N_CHUNKS, chunk_blocks=T))
    tep = list(tr.run_device(lambda f, n: torch.from_numpy(iq[f:f + n]),
                             rec.N_CHUNKS, chunk_blocks=T))

    def amp(ep):
        return next(f["AMP"] for f in ep[1].frames if f["SAT"] == 5)

    ja, ta = amp(jep), amp(tep)
    return {"excised_max_abs_diff": float(np.abs(ex_j - ex_t).max()),
            "track_amp_jax": float(a[i]), "track_amp_port": float(b[i]),
            "track_amp_rel": float(abs(b[i] - a[i]) / a[i]),
            "track_amp_eps_a2": float(abs(b[i] - a[i]) / a[i]
                                      / (EPS * a[i] ** 2)),
            "resweep_amp_jax": ja, "resweep_amp_port": ta,
            "resweep_amp_rel": abs(ta - ja) / ja,
            "resweep_amp_eps_a2": abs(ta - ja) / ja / (EPS * ja ** 2)}


if __name__ == "__main__":
    import json
    import subprocess
    import sys

    rows = []
    for _ in range(SPREAD_RUNS):
        out = subprocess.run(
            [sys.executable, "-c", "import json, tests.conftest; "
             "from tests.test_torch_frontend import _spread_one; "
             "print(json.dumps(_spread_one()))"],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            sys.exit(out.stderr)
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for key in ("track_amp_jax", "resweep_amp_jax"):
        vals = sorted({r[key] for r in rows})
        print(json.dumps({key: vals,
                          "spread_rel": (vals[-1] - vals[0]) / vals[0]}))
    print(json.dumps({k: max(r[k] for r in rows) for k in (
        "excised_max_abs_diff", "track_amp_rel", "track_amp_eps_a2",
        "resweep_amp_rel", "resweep_amp_eps_a2")}))
