"""PyTorch port vs JAX: the serving path (runtime/serving.py StreamServer,
ops/tracking.py track_streams_impl / track_streams_window_impl, the
stream axis of the wipeoff kernels' plain versions).

  * the port's StreamServer against the JAX StreamServer on identical
    numpy grouped planar IQ (JAX's XLA path on the CPU, the port's plain
    versions): replicas of one capture and independent front ends,
    fused windows and per-chunk dispatch, one epoch per window or per
    chunk, cold and primed starts.  Exact: frame keys, satellites,
    code-phase block numbers, acquired PRNs, slots, dropped-edge counts
    and the bits and edges each NavDecoder received.  Code phases atol
    5e-3 samples, AMP and CRM rtol 1e-3, FRQ atol 1e-2 Hz (the
    device-path tolerances of tests/test_torch_device_path.py);
  * each stream of the port's server against the port's own single
    Receiver.run_device, with the same tolerances: PyTorch's CPU
    reductions are not batch-invariant (a sum over a [S*C, n] tensor may
    round otherwise than over [C, n]), so stacking the streams moves
    AMP by up to ~6e-4 relative here while code phases and FRQ agree
    bit for bit;
  * the shared cold start runs the acquisition grid once;
  * the stream-axis pack_outs_compact against JAX's _pack_streams
    (vmap of pack_outs_compact): exact;
  * the stream-axis plain versions of both wipeoff kernels against
    jax.vmap of the interpret-mode Pallas kernels (mix_wipeoff_mxu,
    mix_wipeoff), within check_wipeoff's 1e-4 of the largest magnitude,
    and against S per-stream plain calls: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.runtime.serving import StreamServer as JaxServer
from gps_sdr_tpu.runtime.serving import _pack_streams
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import cacode, hopper_wipeoff
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.runtime import receiver as receiver_mod
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.runtime.serving import StreamServer
from tests.test_torch_device_path import (CFG, SATS, T, _compare_decoders,
                                          _compare_epochs, _jax)

torch.set_num_threads(2)

N_CHUNKS = 5            # windows of 2: two windows and a tail chunk
# the second independent front end sees another sky
SATS_B = [SatSignal(prn=7, doppler=-1530.0, code_delay=31.5,
                    nav_bits=random_bits(512, seed=7)),
          SatSignal(prn=21, doppler=2480.0, code_delay=150.25,
                    nav_bits=random_bits(512, seed=21))]
SKIES = (SATS, SATS_B)


def _planar_iq(sats, seed, n_blocks=N_CHUNKS * T):
    blocks = synth_stream(CFG, sats, n_blocks, noise_std=0.2, seed=seed)
    return ttrk.to_grouped_planar(CFG, torch.from_numpy(blocks)).numpy()


IQ = [_planar_iq(SATS, 9), _planar_iq(SATS_B, 4)]


def _primed(rx, sats):
    rx.sweep_all = False
    for s in sats:
        rx._activate(s.prn, s.doppler, int(s.code_delay) % CFG.code_samples)
    rx._refresh_code_tables()


def _providers(shared, wrap, n_streams):
    if shared:
        return lambda f, n: wrap(IQ[0][f:f + n])
    return [lambda f, n, iq=IQ[s]: wrap(iq[f:f + n])
            for s in range(n_streams)]


def _sky(shared, s):
    return SATS if shared else SKIES[s]


def stream_epochs(server, providers, n_chunks, chunk_blocks=T):
    """Drive server.run to its end; each stream's epochs, in order."""
    out = [[] for _ in range(server.n_streams)]
    for s, epoch in server.run(providers, n_chunks, chunk_blocks):
        out[s].append(epoch)
    return out


def _serve(server, shared, wrap, cold):
    if not cold:
        for s, rx in enumerate(server.receivers):
            _primed(rx, _sky(shared, s))
    return stream_epochs(server, _providers(shared, wrap, server.n_streams),
                         N_CHUNKS)


# (shared capture, fused windows, one epoch per window, cold start)
@pytest.mark.parametrize("shared,fused,per_window,cold", [
    (True, True, False, True), (True, False, True, False),
    (False, True, True, False), (False, False, False, True)],
    ids=["shared-fused-cold", "shared-chunks-window-epochs",
         "independent-fused-window-epochs", "independent-chunks-cold"])
def test_stream_server_matches_jax(shared, fused, per_window, cold):
    cfg = CFG.replace(chunks_per_download=2, download_windows_in_flight=2,
                      fused_window_dispatch=fused,
                      epoch_per_window=per_window)
    js = JaxServer(_jax(cfg), 2)
    ts = StreamServer(cfg, 2, device="cpu")
    jep = _serve(js, shared, jnp.asarray, cold)
    tep = _serve(ts, shared, torch.from_numpy, cold)
    want_epochs = 3 if per_window else N_CHUNKS
    for s in range(2):
        jr, tr = js.receivers[s], ts.receivers[s]
        assert len(tep[s]) == len(jep[s]) == want_epochs
        # a cold start tracks from a 200 Hz Doppler bin: an edge storm
        # may overflow the transport cap, and both count the same drops
        assert tr.status.edge_overflows == jr.status.edge_overflows
        assert cold or tr.status.edge_overflows == 0
        assert tr.status.stream_no == jr.status.stream_no == N_CHUNKS * T
        assert tr.status.k_steps == N_CHUNKS * T // cfg.blocks_per_step
        if cold:
            assert [f[1:] for f in tr.found_sats] == \
                [f[1:] for f in jr.found_sats]
        assert tr.slots.slot_prn == jr.slots.slot_prn
        assert sorted(p for p in tr.slots.slot_prn if p) == \
            sorted(x.prn for x in _sky(shared, s))
        _compare_epochs(jep[s], tep[s])
        _compare_decoders(jr, tr)
    # the final states handed back to the receivers agree too
    for s in range(2):
        tst = ttrk.states_to_numpy(ts.receivers[s].states)
        jst = {k: np.asarray(v) for k, v in
               jtrk.pack_states(js.receivers[s].states).items()}
        assert tst.keys() == jst.keys()
        for name in ("prn", "delay", "locked", "ms_time__lo", "carry_cnt"):
            np.testing.assert_array_equal(tst[name], jst[name], err_msg=name)
    if not shared:
        assert tep[0][-1].code_phases.keys() != tep[1][-1].code_phases.keys()


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared", "independent"])
@pytest.mark.parametrize("fused", [False, True], ids=["chunks", "fused"])
def test_streams_match_single_receivers(shared, fused):
    """Each of 3 streams against a Receiver.run_device of its own IQ,
    epoch for epoch (one epoch per chunk, the same windows)."""
    cfg = CFG.replace(chunks_per_download=2, download_windows_in_flight=2,
                      fused_window_dispatch=fused)
    srv = StreamServer(cfg, 3, device="cpu")
    for s, rx in enumerate(srv.receivers):
        _primed(rx, _sky(shared, s % 2))
    iq = [IQ[0]] * 3 if shared else [IQ[0], IQ[1], IQ[0]]
    provs = (_providers(True, torch.from_numpy, 3) if shared else
             [lambda f, n, x=x: torch.from_numpy(x[f:f + n]) for x in iq])
    got = stream_epochs(srv, provs, N_CHUNKS, T)
    for s in range(3):
        rx = Receiver(cfg, device="cpu")
        _primed(rx, _sky(shared, s % 2))
        want = list(rx.run_device(
            lambda f, n, x=iq[s]: torch.from_numpy(x[f:f + n]), N_CHUNKS,
            chunk_blocks=T))
        _compare_epochs(want, got[s])
        _compare_decoders(rx, srv.receivers[s])
        assert srv.receivers[s].status == rx.status


def test_shared_cold_start_sweeps_once(monkeypatch):
    """Replicas of one capture see the same blocks: the cold start runs
    the acquisition grid once and gives every stream its result."""
    calls = []
    real = receiver_mod.acquire_all

    def counting(*a, **k):
        calls.append(k.get("prns"))
        return real(*a, **k)

    monkeypatch.setattr(receiver_mod, "acquire_all", counting)
    cfg = CFG.replace(chunks_per_download=2)
    srv = StreamServer(cfg, 3, device="cpu")
    got = stream_epochs(srv, lambda f, n: torch.from_numpy(IQ[0][f:f + n]),
                        2, T)
    assert calls == [None]
    assert [len(e) for e in got] == [2, 2, 2]
    for rx in srv.receivers:
        assert [f[1:] for f in rx.found_sats] == \
            [f[1:] for f in srv.receivers[0].found_sats]
        assert sorted(p for p in rx.slots.slot_prn if p) == [5, 12]
    # independent front ends each sweep their own block
    calls.clear()
    srv = StreamServer(cfg, 2, device="cpu")
    stream_epochs(srv, _providers(False, torch.from_numpy, 2), 1, T)
    assert calls == [None, None]
    assert [sorted(p for p in rx.slots.slot_prn if p)
            for rx in srv.receivers] == [[5, 12], [7, 21]]


def _stacked_case(n_streams, shared):
    """Stacked states, codes and code FFTs of n_streams primed receivers
    (the skies alternate) and their chunk, [T, ...] or [S, T, ...]."""
    rxs = []
    for s in range(n_streams):
        rx = Receiver(CFG, device="cpu")
        _primed(rx, _sky(shared, s % 2))
        rxs.append(rx)
    states = ttrk.ChannelState(*(torch.stack(f) for f in
                                 zip(*[r.states for r in rxs])))
    codes = torch.stack([r._codes_dev for r in rxs])
    ffts = torch.stack([r._ffts_dev for r in rxs])
    iq = (torch.from_numpy(IQ[0][:T]) if shared else
          torch.stack([torch.from_numpy(IQ[s % 2][:T])
                       for s in range(n_streams)]))
    return states, codes, ffts, iq


@pytest.mark.parametrize("with_freq", [False, True])
def test_stream_pack_matches_jax(with_freq):
    states, codes, ffts, iq = _stacked_case(3, False)
    _, outs = ttrk.track_streams_impl(CFG, states, iq, 1, codes, ffts)
    assert outs.edge_valid.shape == (3, T, CFG.max_sat, CFG.n_cyc + 1)
    cap = 24
    got = ttrk.pack_outs_compact(outs, cap, with_freq).numpy()
    jouts = jtrk.ChannelOut(**{k: jnp.asarray(v.numpy()) for k, v in
                               outs._asdict().items()})
    want = np.asarray(_pack_streams(jouts, cap, with_freq))
    assert got.shape == want.shape and got.shape[0] == 3
    np.testing.assert_array_equal(got, want)
    for s in range(3):             # each row is that stream's own packing
        one = ttrk.ChannelOut(*(x[s] for x in outs))
        np.testing.assert_array_equal(
            got[s], ttrk.pack_outs_compact(one, cap, with_freq).numpy())


def test_states_numpy_keep_stream_axis():
    """states_to_numpy / states_from_numpy carry a stacked [S, C, ...]
    state across packages: the JAX pack_states of the same stack."""
    states, *_ = _stacked_case(2, False)
    states = states._replace(
        ms_time=torch.tensor([[40_000_000, 3], [17_000_001, 0]],
                             dtype=torch.int32))
    tree = ttrk.states_to_numpy(states)
    assert tree["prn"].shape == (2, CFG.max_sat)
    back = ttrk.states_from_numpy(tree, "cpu")
    for a, b in zip(states, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jst = jtrk.unpack_states({k: jnp.asarray(v) for k, v in tree.items()})
    jtree = {k: np.asarray(v) for k, v in jtrk.pack_states(jst).items()}
    for k, v in tree.items():
        np.testing.assert_array_equal(v, jtree[k], err_msg=k)


# --- the stream axis of the wipeoff kernels' plain versions ----------------


def _stream_args(n_streams, shared, k):
    """Inputs of both wipeoff kernels for n_streams streams of 2
    channels (alternating skies, per-stream NCO phases): s, snp, phase
    f32[S*C], wipe i32[S*C, k] crossing the 128-column tile edge and the
    code period's ends, the complex chunk [k, ngps] or [S, k, ngps],
    codes f32[S*C, cs]."""
    rng = np.random.default_rng(5)
    sats = [_sky(shared, z % 2) for z in range(n_streams)]
    freq = torch.tensor([x.doppler for sk in sats for x in sk],
                        dtype=torch.float32)
    s = 2 * np.pi * freq / CFG.sample_rate
    snp = torch.remainder(s * CFG.ngps, 2 * np.pi)
    phase = torch.from_numpy(rng.uniform(0, 6.28, s.shape[0]).astype(
        np.float32))
    edge = [0, 1, 127, 128, 129, 255]
    wipe = torch.tensor([[edge[(c + b) % 6] for b in range(k)]
                         for c in range(s.shape[0])], dtype=torch.int32)
    codes = torch.from_numpy(np.stack([cacode.ca_table(CFG)[x.prn]
                                       for sk in sats for x in sk]))
    chunks = [ttrk.dsp.as_complex_input(torch.from_numpy(
        IQ[z % 2][2 * k:3 * k])) for z in range(n_streams)]
    chunk = chunks[0] if shared else torch.stack(chunks)
    return s, snp, phase, wipe, chunk, codes


def _jax_streams(vpu, k, s, snp, phase, wipe, chunk, codes, n_streams,
                 shared):
    """jax.vmap over the streams of the JAX package's Pallas kernel
    (interpret mode on the CPU), its inputs built as heavy_stage_pallas
    builds them: (center [k, S*C, cs], head [S*C, k], seg [S*C, k,
    n_cyc])."""
    from gps_sdr_tpu.ops.pallas_kernels import mix_wipeoff, mix_wipeoff_mxu

    cfg = _jax(CFG)
    cs, n_cyc, ca, sl = CFG.code_samples, CFG.n_cyc, CFG.corr_avg, \
        CFG.n_cyc + 1

    def per_stream(x):
        return jnp.asarray(x.numpy().reshape((n_streams, -1)
                                             + tuple(x.shape[1:])))

    s, snp, phase, wipe, codes = (per_stream(x) for x in
                                  (s, snp, phase, wipe, codes))
    x = chunk.numpy()
    blocks2 = jnp.asarray(np.stack([x.real, x.imag], axis=-2).reshape(
        x.shape[:-1] + (2, n_cyc, cs)))

    def one(s, snp, phase, wipe, blocks2, codes):
        params = jnp.stack([s, phase, snp, jnp.zeros_like(s)], axis=1)
        if vpu:
            center, sums = mix_wipeoff(cfg, k, params, wipe, blocks2, codes)
            return (center[:, 0::2] + 1j * center[:, 1::2],
                    (sums[:, 0::2, 0] + 1j * sums[:, 1::2, 0]).T,
                    jnp.transpose(sums[:, 0::2, 1:n_cyc + 1]
                                  + 1j * sums[:, 1::2, 1:n_cyc + 1],
                                  (1, 0, 2)))
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
        cre, cim, sums = mix_wipeoff_mxu(
            cfg, k, jnp.zeros((1,), jnp.int32), params, wipe, rotrow,
            rotrow.reshape(k, -1, 1), g, cqsq, blocks2, codes)
        return (cre + 1j * cim, (sums[:, 0] + 1j * sums[:, sl]).T,
                jnp.transpose(sums[:, 1:sl] + 1j * sums[:, sl + 1:2 * sl],
                              (2, 0, 1)))

    center, head, seg = jax.vmap(one, in_axes=(0, 0, 0, 0,
                                               None if shared else 0, 0))(
        s, snp, phase, wipe, blocks2, codes)
    center = np.asarray(center)                      # [S, k, C, cs]
    return (np.transpose(center, (1, 0, 2, 3)).reshape(k, -1, cs),
            np.asarray(head).reshape(-1, k),
            np.asarray(seg).reshape(-1, k, n_cyc))


def _within(got, want, rel=1e-4):
    """check_wipeoff's bound, part by part (center, head, seg)."""
    for name, g, w in zip(("center", "head", "seg"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, f"{name}: {g.shape} != {w.shape}"
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= rel * scale, f"{name}: {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared", "independent"])
@pytest.mark.parametrize("vpu", [False, True], ids=["wipeoff", "vpu"])
def test_stream_axis_plain_matches_vmapped_pallas(vpu, shared):
    k, n_streams = 4, 3
    s, snp, phase, wipe, chunk, codes = _stream_args(n_streams, shared, k)
    if vpu:
        chunk = ttrk.to_grouped_planar(CFG, chunk)
        fn = hopper_wipeoff.mix_wipeoff_vpu
    else:
        fn = hopper_wipeoff.mix_wipeoff
    got = fn(CFG, k, s, snp, phase, wipe, chunk, 0, codes, n_streams)
    assert [tuple(g.shape) for g in got] == [
        (k, 6, CFG.code_samples), (6, k), (6, k, CFG.n_cyc)]
    x = ttrk.dsp.as_complex_input(chunk)
    _within(got, _jax_streams(vpu, k, s, snp, phase, wipe, x, codes,
                              n_streams, shared))
    # S per-stream plain calls, exactly
    for z in range(n_streams):
        ch = slice(2 * z, 2 * z + 2)
        one = fn(CFG, k, s[ch], snp[ch], phase[ch], wipe[ch],
                 chunk if shared else chunk[z], 0, codes[ch])
        for g, w in zip((got[0][:, ch], got[1][ch], got[2][ch]), one):
            assert torch.equal(g, w)


def test_stream_axis_layouts_refused():
    s, snp, phase, wipe, chunk, codes = _stream_args(2, False, 4)
    with pytest.raises(ValueError, match=r"\[3, T, \.\.\.\]"):
        hopper_wipeoff.mix_wipeoff(CFG, 4, s, snp, phase, wipe, chunk, 0,
                                   codes, 3)
    with pytest.raises(ValueError, match="n_streams must be"):
        hopper_wipeoff.mix_wipeoff(CFG, 4, s, snp, phase, wipe, chunk, 0,
                                   codes, 0)


def test_mesh_not_ported():
    """A stream mesh is ported (tests/test_torch_parallel.py); what stays
    refused is JAX's: streams that do not divide over the mesh, and a
    mesh that is not a one-axis stream mesh."""
    from gps_sdr_tpu_torch.parallel.mesh import make_mesh, make_stream_mesh

    with pytest.raises(ValueError, match="2 streams not divisible over 3 "
                                         "devices"):
        StreamServer(CFG, 2, device="cpu",
                     mesh=make_stream_mesh(3, ["cpu"] * 3))
    with pytest.raises(ValueError, match="one axis"):
        StreamServer(CFG, 2, device="cpu", mesh=make_mesh(2, 1, ["cpu"] * 2))
