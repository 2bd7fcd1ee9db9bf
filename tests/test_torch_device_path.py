"""PyTorch port vs JAX: the device-resident receiver (Receiver.run_device)
and its compact transport (ops/tracking.py pack_outs_compact and the host
inverses).

  * pack_outs_compact / unpack_outs_compact / unpack_window_compact of
    the port against the JAX functions on the same ChannelOut: exact,
    overflow counting included (the same f32 values packed the same way);
  * the port's run_device against JAX Receiver.run_device on identical
    numpy grouped planar IQ (JAX's XLA path on the CPU, the port's plain
    versions), fused and per-chunk windows, with and without one epoch
    per window: exact frame keys, satellites, code-phase block numbers
    and the bits and edges each NavDecoder received; code phases atol
    5e-3 samples, AMP and CRM rtol 1e-3, FRQ atol 1e-2 Hz (the tolerances
    of tests/test_torch_receiver.py: f32 reduction order carried through
    the PLL feedback);
  * the port's run_device against its own run(): identical epochs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.runtime.receiver import Receiver as JaxReceiver
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.utils.cplist import cp_arrays

torch.set_num_threads(2)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2, max_sat=2,
                     use_mxu_wipeoff=False)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(512, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(512, seed=12))]
T = 24                  # blocks per chunk (<< no_sec: a fast test)
N_CHUNKS = 5            # windows of 2: two windows and a tail chunk


def _jax(cfg):
    """The JAX package's config with the same fields."""
    return JaxConfig(**dataclasses.asdict(cfg))


def _planar_iq(n_blocks):
    blocks = synth_stream(CFG, SATS, n_blocks, noise_std=0.2, seed=9)
    return ttrk.to_grouped_planar(CFG, torch.from_numpy(blocks)).numpy()


def _tracked_outs(n_blocks=16):
    blocks = synth_stream(CFG, SATS, n_blocks, noise_std=0.2, seed=9)
    st = ttrk.init_channel_states(CFG, 2, "cpu")
    codes = np.zeros((2, CFG.code_samples), np.float32)
    ffts = np.zeros((2, CFG.code_samples), np.complex64)
    rx = Receiver(CFG, device="cpu")
    for i, s in enumerate(SATS):
        st = ttrk.reset_channel(st, i, s.prn, s.doppler, int(s.code_delay),
                                CFG)
        codes[i] = rx._codes_tab[s.prn]
        ffts[i] = rx._ffts_tab[s.prn]
    _, outs = ttrk.track_chunk_batched_impl(
        CFG, st, torch.from_numpy(blocks), 1, torch.from_numpy(codes),
        torch.from_numpy(ffts))
    return outs


def _as_jax(outs):
    return jtrk.ChannelOut(**{k: jnp.asarray(v.numpy())
                              for k, v in outs._asdict().items()})


@pytest.mark.parametrize("with_freq", [False, True])
@pytest.mark.parametrize("overflow", [False, True])
def test_compact_transport_matches_jax(overflow, with_freq):
    outs = _tracked_outs()
    t, c, sl = outs.edge_valid.shape
    n_edges = outs.edge_valid.sum(dim=(0, 2)).numpy()
    assert n_edges.min() > 2
    cap = int(n_edges.max()) - 2 if overflow else 64
    got = ttrk.pack_outs_compact(outs, cap, with_freq).numpy()
    want = np.asarray(jtrk.pack_outs_compact(_as_jax(outs), cap, with_freq))
    np.testing.assert_array_equal(got, want)

    tu, tdrop = ttrk.unpack_outs_compact(got, t, c, sl, cap, with_freq)
    ju, jdrop = jtrk.unpack_outs_compact(want, t, c, sl, cap, with_freq)
    np.testing.assert_array_equal(tdrop, jdrop)
    np.testing.assert_array_equal(tdrop, np.maximum(n_edges - cap, 0))
    assert (tdrop.sum() > 0) == overflow
    for name in ttrk.ChannelOut._fields:
        np.testing.assert_array_equal(getattr(tu, name), getattr(ju, name),
                                      err_msg=name)

    rows = np.stack([got, got])
    tw = ttrk.unpack_window_compact(rows, t, c, sl, cap, with_freq)
    jw = jtrk.unpack_window_compact(rows, t, c, sl, cap, with_freq)
    for name in ttrk.CompactWindow._fields:
        a, b = getattr(tw, name), getattr(jw, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_compact_roundtrip_matches_dense():
    """Where the host reads, the compact round trip is the dense
    outputs exactly."""
    outs = _tracked_outs()
    dense = ttrk.outs_to_numpy(outs)
    t, c, sl = dense.edge_valid.shape
    buf = ttrk.pack_outs_compact(outs, 64).numpy()
    got, dropped = ttrk.unpack_outs_compact(buf, t, c, sl, 64)
    assert dropped.sum() == 0
    for name in ("code_phase", "sign0", "erased", "edge_valid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(dense, name))
    v = dense.edge_valid
    np.testing.assert_array_equal(got.edge_ms[v], dense.edge_ms[v])
    np.testing.assert_array_equal(got.edge_local[v], dense.edge_local[v])
    for name in ("amplitude", "corr_q", "corr_l", "freq", "norm_max",
                 "locked", "sweep_request"):
        np.testing.assert_array_equal(getattr(got, name)[-1],
                                      getattr(dense, name)[-1])


def _primed(rx):
    rx.sweep_all = False
    for s in SATS:
        rx._activate(s.prn, s.doppler, int(s.code_delay) % CFG.code_samples)
    rx._refresh_code_tables()
    return rx


def _compare_epochs(jep, tep):
    assert len(tep) == len(jep)
    for je, te in zip(jep, tep):
        assert te.skipped_samples == je.skipped_samples
        assert [sorted(f) for f in te.frames] == \
            [sorted(f) for f in je.frames]
        for jf, tf in zip(je.frames, te.frames):
            for key in jf:
                if key in ("AMP", "CRM"):
                    np.testing.assert_allclose(tf[key], jf[key], rtol=1e-3)
                elif key == "FRQ":
                    np.testing.assert_allclose(tf[key], jf[key], atol=1e-2)
                elif key != "CN0":
                    assert tf[key] == jf[key], key
        assert sorted(te.code_phases) == sorted(je.code_phases)
        for prn in je.code_phases:
            js, jv = cp_arrays(je.code_phases[prn])
            ts, tv = cp_arrays(te.code_phases[prn])
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_allclose(tv, jv, atol=5e-3)


def _compare_decoders(jr, tr):
    assert tr.decoders.keys() == jr.decoders.keys()
    n_edges = 0
    for slot, jd in jr.decoders.items():
        td = tr.decoders[slot]
        assert td.last_sign == jd.last_sign
        np.testing.assert_array_equal(np.asarray(td.edges),
                                      np.asarray(jd.edges))
        np.testing.assert_array_equal(td.bits, jd.bits)
        np.testing.assert_array_equal(td.bits_st, jd.bits_st)
        n_edges += len(jd.edges)
    assert n_edges > 0


# (fused windows, one epoch per window, cold start)
@pytest.mark.parametrize("fused,per_window,cold", [
    (False, False, True), (True, False, False), (True, True, False),
    (False, True, False)],
    ids=["chunks-cold", "fused", "fused-window-epochs",
         "chunks-window-epochs"])
def test_run_device_matches_jax(fused, per_window, cold):
    cfg = CFG.replace(chunks_per_download=2, download_windows_in_flight=2,
                      fused_window_dispatch=fused,
                      epoch_per_window=per_window)
    iq = _planar_iq(N_CHUNKS * T)
    jr, tr = JaxReceiver(_jax(cfg)), Receiver(cfg, device="cpu")
    if not cold:
        _primed(jr), _primed(tr)
    jep = list(jr.run_device(lambda f, n: jnp.asarray(iq[f:f + n]),
                             N_CHUNKS, chunk_blocks=T))
    tep = list(tr.run_device(lambda f, n: torch.from_numpy(iq[f:f + n]),
                             N_CHUNKS, chunk_blocks=T))
    want_epochs = 3 if per_window and not cold else N_CHUNKS
    assert len(tep) == want_epochs
    # a cold start tracks from a 200 Hz Doppler bin: its edge storm
    # overflows the transport cap, and both count the same drops
    assert tr.status.edge_overflows == jr.status.edge_overflows
    assert (tr.status.edge_overflows > 0) == cold
    assert tr.status.k_steps == N_CHUNKS * T // cfg.blocks_per_step
    assert tr.status.stream_no == jr.status.stream_no == N_CHUNKS * T
    if cold:
        assert [f[1:] for f in tr.found_sats] == \
            [f[1:] for f in jr.found_sats]
    assert tr.slots.slot_prn == jr.slots.slot_prn
    _compare_epochs(jep, tep)
    _compare_decoders(jr, tr)


def _frames_key(epochs):
    return [(e.skipped_samples,
             [sorted(f.items()) for f in e.frames],
             sorted((p, cp_arrays(v)[0].tolist(), cp_arrays(v)[1].tolist())
                    for p, v in e.code_phases.items()))
            for e in epochs]


@pytest.mark.parametrize("mxu", [False, True])
def test_run_device_matches_run(mxu):
    """run_device (compact transport, fused windows of 3 chunks) yields
    the epochs of the host path run(), chunk for chunk."""
    cfg = CFG.replace(chunks_per_download=3, use_mxu_wipeoff=mxu)
    n_chunks = 3
    iq = _planar_iq(n_chunks * T)
    rd = _primed(Receiver(cfg, device="cpu"))
    dev_epochs = list(rd.run_device(
        lambda f, n: torch.from_numpy(iq[f:f + n]), n_chunks,
        chunk_blocks=T))
    rh = _primed(Receiver(cfg, device="cpu"))
    blocks = ttrk.dsp.as_complex_input(torch.from_numpy(iq)).numpy()
    host_epochs = []
    for ci in range(n_chunks):
        rh.status.stream_no = ci * T
        host_epochs.append(rh._run_chunk(
            [blocks[ci * T + i] for i in range(T)], 0))
    assert rd.status.edge_overflows == 0
    assert _frames_key(dev_epochs) == _frames_key(host_epochs)


def test_window_consume_matches_concat_outs():
    """_consume_window_compact on the sparse window view gives the epoch
    of _consume_chunk over the window's concatenated dense outputs with
    window=True, and feeds the decoders the same edges and signs."""
    from gps_sdr_tpu_torch.runtime.receiver import _DeviceChunk, concat_outs

    w = 3
    iq = torch.from_numpy(_planar_iq(w * T))
    ra = _primed(Receiver(CFG, device="cpu"))
    rb = _primed(Receiver(CFG, device="cpu"))
    cap, sl = ra._edge_cap(T), ra._edge_sl
    _, rows = ttrk.track_window_impl(
        CFG, ra.states, iq.reshape((w, T) + tuple(iq.shape[1:])), 1,
        ra._codes_dev, ra._ffts_dev, cap)
    rows = rows.numpy()
    last = _DeviceChunk(iq[(w - 1) * T:])
    cw = ttrk.unpack_window_compact(rows, T, CFG.max_sat, sl, cap)
    got = ra._consume_window_compact(last, cw, 1, T)
    outs = concat_outs([ttrk.unpack_outs_compact(r, T, CFG.max_sat, sl,
                                                 cap)[0] for r in rows])
    want = rb._consume_chunk(last, outs, 1, 0, window=True)
    assert _frames_key([got]) == _frames_key([want])
    _compare_decoders(rb, ra)


def test_run_device_session_counts_blocks():
    """Session.run_device_source feeds every epoch to the evaluator and
    counts every tracked block (the rx.blocks counter)."""
    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.utils import profiling

    cfg = CFG.replace(chunks_per_download=2)
    iq = _planar_iq(4 * T)
    s = Session(cfg, device="cpu")
    _primed(s.receiver)
    profiling.reset()
    summary = s.run_device_source(lambda f, n: torch.from_numpy(iq[f:f + n]),
                                  4, chunk_blocks=T)
    assert len(s.summaries) == 4
    assert profiling.snapshot()["counts"]["rx.blocks"] == 4 * T
    assert summary["n_positions"] == 0          # 1 s of signal: no fix
