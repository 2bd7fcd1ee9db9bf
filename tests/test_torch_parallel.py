"""PyTorch port vs JAX: the sharding slice (gps_sdr_tpu_torch/parallel and
the stream-sharded StreamServer), on the CPU.

The JAX functions run on the conftest's virtual 8-device CPU mesh, the
port's on make_mesh(..., devices=["cpu"] * 8): one device repeated, the
port's counterpart of those virtual devices.  Both get the same inputs:
tests/test_parallel.py's stream8 fixture (4 satellites, 8 blocks at the
product configuration) and states seeded from its satellites.

  * mesh shapes, JAX's ValueError for an indivisible time axis, a CUDA
    mesh without CUDA raising;
  * acquire_sharded at (2, 4) (product grid, with absent PRNs) and at
    the +-10 kHz grid on (4, 2) against JAX's and the port's unsharded
    acquire_impl: found/delay/freq exact, norm_max rtol 2e-5
    (tests/test_parallel.py), padded Doppler bins tying with bin 0;
  * track_sharded, exact stitch, at 1, 2 and 4 time shards against the
    port's sequential track_chunk_impl at test_parallel.py's tolerances
    (code_phase atol 1e-4, freq atol 1e-3, locked/edge_valid exact,
    final freq/phase atol 1e-3) and against JAX's track_sharded: code
    phases atol 1e-4, lock and edge flags exact, FRQ atol 1e-2 Hz (the
    port's tolerance against JAX since the first slice,
    tests/test_torch_device_path.py: f32 rounding through the PLL);
  * the state handoff (W = 2) and n_stitch = 2 at 4 shards against
    JAX's outputs, the boundary window's code phases within 1e-3;
  * pad_channels (padded slots zero and inactive, code phase -1);
  * the stream-sharded StreamServer (a stream mesh of 4) against JAX's
    sharded server and the port's unsharded one, and load_server with a
    mesh against an uninterrupted sharded run;
  * a 2-process gloo mesh (chip_smoke.run_mesh_processes, each rank
    ["cpu"] * 4 on a free TCP port) equal to the single-process mesh of
    8, with no process left behind."""

import numpy as np
import pytest
import torch

import chip_smoke
import plain_acquisition
from gps_sdr_tpu.ops import cacode as jcacode
from gps_sdr_tpu.parallel import acquire_sharded as jax_acquire_sharded
from gps_sdr_tpu.parallel import make_mesh as jax_make_mesh
from gps_sdr_tpu.parallel import track_sharded as jax_track_sharded
from gps_sdr_tpu.parallel.mesh import make_stream_mesh as jax_stream_mesh
from gps_sdr_tpu.runtime.serving import StreamServer as JaxServer
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.ops import cacode
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.ops.acquisition import acquire_impl
from gps_sdr_tpu_torch.parallel import (acquire_sharded, make_mesh,
                                        pad_channels, track_sharded)
from gps_sdr_tpu_torch.parallel.mesh import (CH_AXIS, STREAM_AXIS, TIME_AXIS,
                                             make_multihost_mesh,
                                             make_stream_mesh)
from gps_sdr_tpu_torch.runtime import checkpoint
from gps_sdr_tpu_torch.runtime.evaluator import Evaluator
from gps_sdr_tpu_torch.runtime.serving import StreamServer
from tests.test_parallel import SATS, stream8  # fixture  # noqa: F401
from tests.test_parallel import CFG as JCFG
from tests.test_parallel import _init_states as _jax_states
from tests.test_torch_checkpoint import _collect
from tests.test_torch_device_path import (CFG as SMALL, _compare_decoders,
                                          _compare_epochs, _jax)
from tests.test_torch_serving import IQ, T, _primed, _sky, stream_epochs

torch.set_num_threads(2)

CFG = ReceiverConfig()
CPU8 = ["cpu"] * 8


def _states(n_ch):
    """The port's counterpart of test_parallel._init_states."""
    states = ttrk.init_channel_states(CFG, n_ch, "cpu")
    codes = np.zeros((n_ch, CFG.code_samples), np.float32)
    ffts = np.zeros((n_ch, CFG.code_samples), np.complex64)
    tab, ftab = cacode.ca_table(CFG), cacode.ca_fft_table(CFG)
    for i, s in enumerate(SATS[:n_ch]):
        states = ttrk.reset_channel(states, i, s.prn, s.doppler,
                                    int(s.code_delay), CFG)
        codes[i] = tab[s.prn]
        ffts[i] = ftab[s.prn]
    return states, codes, ffts


def _sequential(blocks, n_ch=4):
    states, codes, ffts = _states(n_ch)
    return ttrk.track_chunk_impl(CFG, states, torch.from_numpy(blocks), 1,
                                 torch.from_numpy(codes),
                                 torch.from_numpy(ffts))


def _np(outs):
    return ttrk.outs_to_numpy(outs)


def _assert_exact_stitch(got_final, got, want_final, want):
    """tests/test_parallel.py test_track_sharded_exact_vs_sequential."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got.code_phase, want.code_phase, atol=1e-4)
    np.testing.assert_allclose(got.freq, want.freq, atol=1e-3)
    np.testing.assert_array_equal(got.locked, want.locked)
    np.testing.assert_array_equal(got.edge_valid, want.edge_valid)
    for name in ("freq", "phase"):
        np.testing.assert_allclose(getattr(got_final, name).numpy(),
                                   getattr(want_final, name).numpy(),
                                   atol=1e-3)


def _assert_like_jax(got, jax_outs, cp_atol=1e-4):
    got = _np(got)
    np.testing.assert_allclose(got.code_phase,
                               np.asarray(jax_outs.code_phase), atol=cp_atol)
    np.testing.assert_allclose(got.freq, np.asarray(jax_outs.freq),
                               atol=1e-2)
    np.testing.assert_array_equal(got.locked, np.asarray(jax_outs.locked))
    np.testing.assert_array_equal(got.edge_valid,
                                  np.asarray(jax_outs.edge_valid))


@pytest.mark.parametrize("n,time_shards,want", [
    (8, None, (2, 4)), (8, 2, (2, 4)), (8, 4, (4, 2)), (4, 1, (1, 4)),
    (6, None, (2, 3))])
def test_mesh_shapes_match_jax(n, time_shards, want):
    mesh = make_mesh(n, time_shards=time_shards, devices=CPU8)
    jm = jax_make_mesh(n, time_shards=time_shards)
    assert (mesh.shape[TIME_AXIS], mesh.shape[CH_AXIS]) == want \
        == (jm.shape["time"], jm.shape["ch"])
    assert mesh.axis_names == tuple(jm.axis_names)
    assert mesh.size == n and mesh.devices.shape == want
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert len(mesh.local_positions()) == n
    sm = make_stream_mesh(4, CPU8)
    assert sm.shape == {STREAM_AXIS: 4} and sm.axis_names == ("stream",)


def test_mesh_errors():
    with pytest.raises(ValueError, match="not divisible into 3 time shards"):
        make_mesh(8, time_shards=3, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible into 3 time shards"):
        jax_make_mesh(8, time_shards=3)
    with pytest.raises(ValueError, match="9 devices requested"):
        make_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        # a CUDA mesh never becomes a CPU one
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2, devices=["cuda:0"] * 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_stream_mesh()
    # no coordinator, no process count, no torchrun environment: one
    # process, make_mesh
    mesh = make_multihost_mesh(time_shards=2, devices=CPU8)
    assert mesh.group is None and mesh.shape == {"time": 2, "ch": 4}


@pytest.mark.parametrize("time_shards,wide", [(2, False), (4, True)],
                         ids=["product-2x4", "wide-4x2"])
def test_acquire_sharded_matches_jax(stream8, time_shards, wide):  # noqa: F811
    """The sharded search against JAX's, the unsharded port and the plain
    search.  JAX ranks every Doppler bin, the port only the bins of a
    PRN's main lobe (fault B): on a PRN that is not found the lobe is
    noise and the two may take other bins, so there the bin and norm_max
    are held to the unsharded port and to the plain search
    (tests/plain_acquisition.py), which hold every PRN on them."""
    cfg, jcfg = CFG, JCFG
    if wide:
        cfg = cfg.replace(min_freq=-10000.0, max_freq=10000.0)
        jcfg = jcfg.replace(min_freq=-10000.0, max_freq=10000.0)
        prns = np.asarray(cfg.prns)
    else:
        prns = np.asarray([s.prn for s in SATS] + [7, 9])   # absentees
    block = stream8[0]
    dop = cfg.doppler_bins.astype(np.float32)
    mesh = make_mesh(8, time_shards, CPU8)
    got = acquire_sharded(cfg, mesh, block, dop,
                          cacode.ca_fft_table(cfg)[prns])
    want = jax_acquire_sharded(jcfg, jax_make_mesh(8, time_shards), block,
                               dop, jcacode.ca_fft_table(jcfg)[prns])
    one = acquire_impl(cfg, torch.from_numpy(block), torch.from_numpy(dop),
                       torch.from_numpy(cacode.ca_fft_table(cfg)[prns]))
    jfound = np.asarray(want.found) > 0.5
    for ref, rows in (((jfound, np.asarray(want.delay),
                        np.asarray(want.freq), np.asarray(want.norm_max)),
                       jfound),
                      ((one.found.numpy(), one.delay.numpy(),
                        one.freq.numpy(), one.norm_max.numpy()),
                       slice(None))):
        np.testing.assert_array_equal(got.found, ref[0])
        np.testing.assert_array_equal(got.delay, ref[1])
        np.testing.assert_array_equal(got.freq[rows], ref[2][rows])
        np.testing.assert_allclose(got.norm_max[rows], ref[3][rows],
                                   rtol=2e-5)
    plain_acquisition.check(got, block, cacode.ca_table(cfg)[prns], dop,
                            cfg.sample_rate, cfg.sweep_corr_avg,
                            cfg.acq_noncoherent, cfg.corr_min)
    assert {int(p) for p in prns[got.found]} == {s.prn for s in SATS}
    # dopplers padded to the time axis by repeating bin 0: 51 bins over 2
    # shards and 101 over 4 both pad
    assert len(dop) % time_shards


@pytest.mark.parametrize("time_shards", [1, 2, 4])
def test_track_sharded_exact(stream8, time_shards):  # noqa: F811
    """Exact stitching (n_stitch = time shards) = the sequential scan for
    any shard count, and = JAX's track_sharded on the same mesh."""
    n = 8 if time_shards > 1 else 4
    states, codes, ffts = _states(4)
    final, outs = track_sharded(CFG, make_mesh(n, time_shards, CPU8),
                                states, stream8, 1, codes, ffts)
    _assert_exact_stitch(final, outs, *_sequential(stream8))
    _, jouts = jax_track_sharded(JCFG, jax_make_mesh(n, time_shards),
                                 _jax_states(4)[0], stream8, 1, codes, ffts)
    _assert_like_jax(outs, jouts)
    # the inputs stay as they were
    assert torch.equal(states.prn, _states(4)[0].prn)


@pytest.mark.parametrize("kw", [dict(warmup_blocks=2), dict(n_stitch=2)],
                         ids=["handoff-w2", "stitch-2"])
def test_track_sharded_approximate_matches_jax(stream8, kw):  # noqa: F811
    """The state handoff and a 2-pass stitch at 4 time shards: JAX's
    outputs (lock and edge flags exact, code phases atol 1e-4); the
    handoff's boundary window (shard 1's first W blocks, from the handed
    off state) = the sequential run within 1e-3."""
    states, codes, ffts = _states(4)
    _, outs = track_sharded(CFG, make_mesh(8, 4, CPU8), states, stream8, 1,
                            codes, ffts, **kw)
    _, jouts = jax_track_sharded(JCFG, jax_make_mesh(8, 4),
                                 _jax_states(4)[0], stream8, 1, codes, ffts,
                                 **kw)
    _assert_like_jax(outs, jouts)
    ref = _np(_sequential(stream8)[1]).code_phase
    cp = _np(outs).code_phase
    both = (ref >= 0) & (cp >= 0)
    assert (np.abs(ref - cp)[both] < 0.5).mean() > 0.9
    if "warmup_blocks" in kw:
        np.testing.assert_allclose(cp[2:4][both[2:4]], ref[2:4][both[2:4]],
                                   atol=1e-3)


def test_track_sharded_channel_padding(stream8):  # noqa: F811
    mesh = make_mesh(8, time_shards=2, devices=CPU8)        # ch axis 4
    states, codes, ffts = _states(3)
    states, codes, ffts = pad_channels(states, codes, ffts,
                                       mesh.shape["ch"])
    assert states.prn.shape[0] == codes.shape[0] == ffts.shape[0] == 4
    assert isinstance(codes, np.ndarray)
    for name, x in states._asdict().items():
        assert x.dtype == ttrk._STATE_DTYPES[name], name
        assert not x[3].any(), name             # zeros: prn 0, inactive
    padded_t = pad_channels(*(_states(3)[:1]), torch.from_numpy(codes[:3]),
                            torch.from_numpy(ffts[:3]), 4)
    assert isinstance(padded_t[1], torch.Tensor)
    _, outs = track_sharded(CFG, mesh, states, stream8, 1, codes, ffts)
    cp = outs.code_phase.numpy()
    assert cp.shape[1] == 4
    assert np.all(cp[:, 3] == -1.0)           # padded slot stays inactive
    assert (cp[:, :3] >= 0).mean() >= 0.75
    jst, jco, jff = _jax_states(3)
    from gps_sdr_tpu.parallel import pad_channels as jax_pad_channels
    jst, jco, jff = jax_pad_channels(jst, jco, jff, 4)
    _, jouts = jax_track_sharded(JCFG, jax_make_mesh(8, 2), jst, stream8, 1,
                                 jco, jff)
    _assert_like_jax(outs, jouts)


def test_track_sharded_refuses_indivisible(stream8):  # noqa: F811
    states, codes, ffts = _states(3)
    with pytest.raises(ValueError, match="use pad_channels"):
        track_sharded(CFG, make_mesh(8, 2, CPU8), states, stream8, 1,
                      codes, ffts)
    with pytest.raises(ValueError, match="not divisible by time shards 4"):
        track_sharded(CFG, make_mesh(8, 4, CPU8), *_states(4)[:1],
                      stream8[:6], 1, codes, ffts)


def _sharded_servers(cfg, n_streams=4):
    return (JaxServer(_jax(cfg), n_streams, mesh=jax_stream_mesh(4)),
            StreamServer(cfg, n_streams, device="cpu",
                         mesh=make_stream_mesh(4, CPU8)),
            StreamServer(cfg, n_streams, device="cpu"))


# (shared capture, fused windows, one epoch per window, cold start)
@pytest.mark.parametrize("shared,fused,per_window,cold", [
    (True, True, False, True), (False, False, True, False)],
    ids=["shared-fused-cold", "independent-chunks-window-epochs"])
def test_stream_sharded_server_matches_jax(shared, fused, per_window, cold):
    """4 streams over a stream mesh of 4 against JAX's sharded server
    and the port's unsharded one: epochs (frame keys, satellites,
    code-phase block numbers exact; code phases atol 5e-3, AMP/CRM rtol
    1e-3, FRQ atol 1e-2: the device-path tolerances, since the port's CPU
    plain versions round a 1-stream group otherwise than a 4-stream
    stack), decoders, slots and stream counters."""
    cfg = SMALL.replace(chunks_per_download=2, download_windows_in_flight=2,
                        fused_window_dispatch=fused,
                        epoch_per_window=per_window)
    servers = _sharded_servers(cfg)
    iq = [IQ[0]] * 4 if shared else [IQ[s % 2] for s in range(4)]
    got = []
    for srv, wrap in zip(servers, (lambda x: x, torch.from_numpy,
                                   torch.from_numpy)):
        if not cold:
            for s, rx in enumerate(srv.receivers):
                _primed(rx, _sky(shared, s % 2))
        if shared:
            provs = lambda f, n: wrap(IQ[0][f:f + n])  # noqa: E731
        else:
            provs = [lambda f, n, x=x: wrap(x[f:f + n]) for x in iq]
        got.append(stream_epochs(srv, provs, 5, T))
    (js, ts, us), (jep, tep, uep) = servers, got
    assert [rx.device for rx in ts.receivers] == [torch.device("cpu")] * 4
    for s in range(4):
        assert len(tep[s]) == (3 if per_window else 5)
        for other, oep in ((js, jep), (us, uep)):
            _compare_epochs(oep[s], tep[s])
            _compare_decoders(other.receivers[s], ts.receivers[s])
            assert ts.receivers[s].slots.slot_prn == \
                other.receivers[s].slots.slot_prn
            assert ts.receivers[s].status.stream_no == \
                other.receivers[s].status.stream_no == 5 * T
    # the handed-back states equal the unsharded server's exactly where
    # no reduction rounds (slots, delays, lock, counters)
    for a, b in zip(ts.receivers, us.receivers):
        for name in ("prn", "delay", "locked", "ms_time", "carry_cnt"):
            assert torch.equal(getattr(a.states, name),
                               getattr(b.states, name)), name


def test_load_server_with_a_mesh(tmp_path):
    """A sharded server saved halfway and resumed by load_server(mesh=...)
    gives the code phases and subframes of an uninterrupted sharded run,
    exactly; the resumed receivers live on the mesh's devices."""
    cfg = SMALL.replace(chunks_per_download=2, download_windows_in_flight=2,
                        defer_subframe_poll=True, epoch_per_window=True)
    n_chunks, half = 5, 2

    def provider(offset):
        return lambda f, n: torch.from_numpy(
            IQ[0][offset * T + f:offset * T + f + n])

    def empty():
        return [{"coph": {}, "frames": []} for _ in range(4)]

    def sharded():
        return StreamServer(cfg, 4, device="cpu",
                            mesh=make_stream_mesh(2, CPU8))

    want = _collect(sharded(), provider(0), n_chunks, empty())
    s1 = sharded()
    got = _collect(s1, provider(0), half, empty())
    path = str(tmp_path / "server.pkl")
    checkpoint.save_server(s1, [Evaluator(cfg) for _ in range(4)], path)
    s2, evs = checkpoint.load_server(path, device="cpu",
                                     mesh=make_stream_mesh(4, CPU8))
    assert len(evs) == 4 and s2._per == 1
    assert [r.status for r in s2.receivers] == [r.status
                                                for r in s1.receivers]
    got = _collect(s2, provider(half), n_chunks - half, got)
    for s in range(4):
        assert set(got[s]["coph"]) == {5, 12}
        assert got[s]["coph"] == want[s]["coph"]
        assert got[s]["frames"] == want[s]["frames"]
    with pytest.raises(ValueError, match="not divisible over 3 devices"):
        checkpoint.load_server(path, device="cpu",
                               mesh=make_stream_mesh(3, CPU8))


def test_two_process_gloo_mesh_equals_single_process(  # noqa: F811
        stream8, tmp_path, monkeypatch):
    """Two ranks (chip_smoke.run_mesh_processes: a free TCP port, gloo,
    each rank ["cpu"] * 4, a global (2, 4) mesh whose time boundary
    crosses the ranks) run track_sharded (exact) and acquire_sharded;
    each returns the single-process mesh of 8's results.  The children
    get 120 s and are killed on failure; none holds jax or gps_sdr_tpu."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    states, codes, ffts = _states(4)
    mesh = make_mesh(8, 2, CPU8)
    final, outs = track_sharded(CFG, mesh, states, stream8, 1, codes, ffts)
    job = chip_smoke.mesh_job(CFG, states, torch.from_numpy(codes),
                              torch.from_numpy(ffts), stream8[0], 2)
    acq = acquire_sharded(CFG, mesh, stream8[0], job["dopplers"],
                          job["acq_ffts"])
    results = chip_smoke.run_mesh_processes(job, stream8, [["cpu"] * 4] * 2,
                                            str(tmp_path), timeout=120.0)
    chip_smoke.check_mesh_results(results, final, outs, acq)
    for r in results:
        assert r["backend"] == "gloo" and r["mesh"] == {"time": 2, "ch": 4}
        assert "backend gloo" in r["log"]


def test_chip_smoke_sharded_acquisition_on_cpu(stream8):  # noqa: F811
    """chip_smoke.py's phase 11a (run_sharded_acquisition) on the CPU
    (meshes of ["cpu"] * 8, the full PRN list at the product and the
    +-10 kHz grids, under the profiler, whose trace then reads as the
    host's): the stream's four satellites, strongest first, at the
    Doppler bin nearest each."""
    found = chip_smoke.run_sharded_acquisition(
        CFG, stream8[0], sorted(s.prn for s in SATS), dev="cpu")
    for tag in ("product", "wide"):
        assert sorted(f[1] for f in found[tag]) == \
            sorted(s.prn for s in SATS)
        assert [f[0] for f in found[tag]] == \
            sorted((f[0] for f in found[tag]), reverse=True)
        for _, prn, freq, _ in found[tag]:
            truth = next(s for s in SATS if s.prn == prn)
            assert abs(freq - truth.doppler) <= CFG.step_freq


def test_multihost_mesh_from_torchrun_environment(tmp_path):
    """make_multihost_mesh() with no arguments under torchrun's
    environment (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK) starts the
    group from it: two ranks of ["cpu"] * 2 make one (2, 2) mesh on gloo,
    each owning its row.  Each child has its own 120 s limit."""
    import os
    import subprocess
    import sys

    code = ("from gps_sdr_tpu_torch.parallel.mesh import "
            "make_multihost_mesh\n"
            "import torch.distributed as dist\n"
            "m = make_multihost_mesh(time_shards=2, devices=['cpu'] * 2)\n"
            "print('MESH', m.rank, m.shape, m.backend, "
            "m.local_positions())\n"
            "dist.destroy_process_group()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = chip_smoke.free_tcp_port()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=root, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        row = [(rank, 0), (rank, 1)]
        assert (f"MESH {rank} {{'time': 2, 'ch': 2}} gloo {row}" in out), out
