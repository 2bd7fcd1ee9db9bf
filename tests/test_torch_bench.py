"""The port's bench (gps_sdr_tpu_torch/bench.py) and its long-run tools
(gps_sdr_tpu_torch/examples/{soak,endurance}.py) on the CPU.

  * the headline satellites are bench.py:129-136's draws from
    default_rng(0), recomputed here with numpy;
  * the headline, ch32, streams and ncyc8 functions at the small test
    configuration (cs 256, n_cyc 8, K=4): the last chunk each tracked
    (recorded through bench.track / bench.track_streams) against the
    JAX package's track_chunk_batched / track_streams on the same numpy
    blocks and states, with tests/test_torch_tracking.py's tolerances
    (code_phase 5e-3, norm_max rtol 2e-3, freq 1e-2 Hz, amplitude rtol
    1e-3, the rest exact), per stream for streams;
  * the acquisition and widegrid functions' grids against JAX's
    acquire on the same block (tests/test_torch_acquisition.py's
    tolerances);
  * main() at tiny sizes prints one JSON line with every key bench.py
    prints for the same extras (the list below, each found in bench.py's
    source), plus device and kernel_launches; an extra that raises makes
    main raise (python -m then exits 1) and print nothing; BENCH_BF16
    raises;
  * the soak at a few seconds of signal (1.024 MS/s, ephemerides
    preloaded as tests/test_checkpoint.py's device-path resume test
    does): the run checkpointed and resumed at half time gives the fixes
    of an uninterrupted run within 1e-3 m, at 1 and 2 streams; its main
    writes nothing but --out;
  * endurance at 3 s of signal and 4 channels passes."""

import dataclasses
import io
import json
import os
import re
import tempfile
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.ops import acquisition as jacq
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu_torch import bench
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.examples import endurance, soak
from gps_sdr_tpu_torch.models.sim_dev import DeviceSynth
from gps_sdr_tpu_torch.ops import tracking as ttrk
from tests.test_torch_tracking import _compare

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                       sweep_corr_avg=2, blocks_per_step=4,
                       corr_q_window_sec=2, max_sat=12)

# bench.py's keys: the headline's, then each extra's (streams and serving
# at BENCH_STREAMS / BENCH_SERVE_STREAMS = 2)
HEADLINE_KEYS = {
    "rtf_two_point_amortized", "rtf_trials", "rtf_device_time",
    "device_trace", "rtf_single_call_incl_latency", "acq_full_grid_wall_ms",
    "acq_prns_found", "iq_msamples_per_sec", "synth_rtf_device",
    "channels_locked", "max_freq_err_hz", "code_phase_found_frac",
    "signal_sec_large_run", "host_probe_ms", "backend", "pallas_fallback"}
EXTRA_KEYS = {
    "widegrid": {"acq_31prn_pm10khz_ms"},
    "ch32": {"track_32ch_rtf", "track_32ch_rtf_single_call",
             "track_32ch_locked"},
    "streams": {"streams_2x12_aggregate_rtf", "streams_2x12_single_call_rtf",
                "streams_2x12_locked"},
    "fullloop": {"full_loop_rtf", "full_loop_rtf_spread", "full_loop_fixes",
                 "full_loop_err_m"},
    "serving": {"serving_stage_sec", "serving_2x12_aggregate_rtf",
                "serving_2x12_fixes", "serving_2x12_streams_with_fixes",
                "serving_2x12_max_err_m"},
    "servecurve": {"serving_scale_curve"},
    "frontend": {"frontend_decimate_msps_in"},
}
CURVE_KEYS = {"aggregate_rtf", "fixes_per_sec", "streams_with_fixes",
              "wall_s", "host_stage_s", "host_share_pct", "stages_s",
              "dev_state_mb", "dev_window_iq_mb", "dev_mem_mb"}


def _jax(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


def _jax_states(cfg, sats):
    """bench.py's fresh_states on the JAX package."""
    jcfg = _jax(cfg)
    st = jtrk.init_channel_states(jcfg, len(sats))
    for i, s in enumerate(sats):
        st = jtrk.reset_channel(st, i, s.prn, s.doppler,
                                int(s.code_delay) % cfg.code_samples, jcfg)
    return st


def _record(monkeypatch, name):
    """Record every call of bench.<name> with its result."""
    calls = []
    real = getattr(bench, name)

    def rec(*args):
        out = real(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(bench, name, rec)
    return calls


def _to_jax(states):
    tree = ttrk.states_to_numpy(states)
    return jtrk.unpack_states({k: jnp.asarray(v) for k, v in tree.items()})


def _check_last_track(calls):
    """The last recorded bench.track call against JAX's
    track_chunk_batched on the same blocks and state."""
    (cfg, states, blocks, codes, ffts), (tst, to) = calls[-1]
    jst, jo = jtrk.track_chunk_batched(
        _jax(cfg), _to_jax(states), jnp.asarray(blocks.numpy()),
        jnp.int32(1), jnp.asarray(codes.numpy()), jnp.asarray(ffts.numpy()))
    _compare(jst, jo, tst, to)


def _check_fresh_states(cfg, sats, states):
    """bench.fresh_states is bench.py's fresh_states on the JAX package."""
    want = {k: np.asarray(v)
            for k, v in jtrk.pack_states(_jax_states(cfg, sats)).items()}
    have = ttrk.states_to_numpy(states)
    for k, v in want.items():
        np.testing.assert_array_equal(have[k], v, err_msg=k)


def test_headline_draws_are_bench_py_draws():
    rng = np.random.default_rng(0)
    prns = rng.choice(np.arange(2, 33), 12, replace=False)
    want = []
    for i, p in enumerate(prns):
        want.append((int(p), rng.uniform(-4500, 4500), rng.uniform(0, 2048),
                     rng.uniform(0.8, 1.2),
                     2 * np.random.default_rng(i).integers(0, 2, 8192) - 1))
    after = rng.uniform()
    rng2 = np.random.default_rng(0)
    got = bench.headline_sats(rng2)
    assert len(got) == 12
    for s, (prn, dop, delay, amp, bits) in zip(got, want):
        assert (s.prn, s.doppler, s.code_delay, s.amplitude) == (
            prn, dop, delay, amp)
        np.testing.assert_array_equal(s.nav_bits, bits)
    assert rng2.uniform() == after      # the extras draw on from here


def test_headline_tracking_matches_jax(monkeypatch):
    calls = _record(monkeypatch, "track")
    sats = bench.headline_sats(np.random.default_rng(0))
    synth = DeviceSynth(SMALL, sats, noise_std=0.7, seed=1, device="cpu")
    bench.reset_counts()
    out = bench.bench_headline(SMALL, sats, synth, CPU, 8, 32)
    # warm + 5 small, warm + 5 large, 3 mid, the profiled large run
    assert [c[0][2].shape[0] for c in calls] == [8] * 6 + [32] * 6 \
        + [8] * 3 + [32]
    assert bench.read_counts() == {"wipeoff": 0, "wipeoff_vpu": 0,
                                   "cheap": 0, "k_steps": 74}
    assert HEADLINE_KEYS - {"acq_full_grid_wall_ms", "acq_prns_found",
                            "synth_rtf_device", "host_probe_ms", "backend",
                            "pallas_fallback"} <= set(out)
    assert out["rtf_device_time"] is None      # a CPU trace: no device lane
    assert out["device_trace"]["lane"] == "host"
    assert out["channels_locked"] == 12
    _check_fresh_states(SMALL, sats, calls[-1][0][1])
    _check_last_track(calls)
    _, (st, outs) = calls[-1]
    assert out["code_phase_found_frac"] == round(
        float((outs.code_phase >= 0).float().mean()), 4)


def test_ch32_and_ncyc8_tracking_match_jax(monkeypatch):
    calls = _record(monkeypatch, "track")
    rng = np.random.default_rng(0)
    sats = bench.headline_sats(rng)
    out = bench.bench_ch32(SMALL, rng, CPU, 8)
    assert set(out) == EXTRA_KEYS["ch32"]
    assert [c[0][2].shape[0] for c in calls] == [8] * 3 + [32] * 3
    cfg32, st32 = calls[-1][0][:2]
    assert cfg32.max_sat == 32
    assert st32.prn.tolist() == list(range(2, 33)) + [2]
    _check_last_track(calls)

    calls.clear()
    out = bench.bench_ncyc8(SMALL, sats, CPU, t8s=8, t8l=32)
    assert set(out) == {"track_ncyc8_rtf", "track_ncyc8_locked"}
    assert calls[-1][0][0] == SMALL.replace(n_cyc=8, corr_avg=4,
                                            blocks_per_step=4)
    _check_fresh_states(calls[-1][0][0], sats, calls[-1][0][1])
    _check_last_track(calls)


def test_streams_tracking_matches_jax(monkeypatch):
    calls = _record(monkeypatch, "track_streams")
    rng = np.random.default_rng(0)
    bench.headline_sats(rng)
    out = bench.bench_streams(SMALL, rng, CPU, 16, 2)
    assert set(out) == EXTRA_KEYS["streams"]
    assert [c[0][2].shape[:2] for c in calls] == [(2, 4)] * 3 + [(2, 16)] * 3
    (cfg, states, blocks, codes, ffts), (tst, to) = calls[-1]
    jst, jo = jtrk.track_streams(_jax(cfg), _to_jax(states),
                                 jnp.asarray(blocks.numpy()),
                                 jnp.int32(1), jnp.asarray(codes.numpy()),
                                 jnp.asarray(ffts.numpy()))
    # a channel whose code phase crosses the code period boundary in the
    # call (stream 0's eighth: delay 255 to 0 at block 0, so the wipe
    # delays, predicted from the delay a K-step began with, cross at the
    # next K-step): from there on, the JAX package reads a one-sample
    # sliver of a period as a millisecond of its own (fault A), so its
    # amplitude and its carrier loop read another mean there; that
    # channel's amplitude and carrier loop (frequency, phase, df ring)
    # are held to JAX before that K-step (and it stays locked), every
    # other field and channel throughout
    k, cs = cfg.blocks_per_step, cfg.code_samples
    n_ch = to.delay.shape[-1]
    delays = torch.cat([states.delay.reshape(2, 1, n_ch), to.delay], dim=1)
    steps = (delays.diff(dim=1).abs() > cs // 2).int().argmax(dim=1)
    crossed = (delays.diff(dim=1).abs() > cs // 2).any(dim=1)     # [S, C]
    assert crossed.sum() == 1
    first = ((steps // k + 1) * k)[crossed].item()
    assert 0 < first < to.freq.shape[1]
    jfreq = torch.from_numpy(np.asarray(jo.freq))
    jamp = torch.from_numpy(np.asarray(jo.amplitude))
    np.testing.assert_allclose(to.freq.transpose(1, 2)[crossed][:, :first],
                               jfreq.transpose(1, 2)[crossed][:, :first],
                               atol=1e-2)
    np.testing.assert_allclose(
        to.amplitude.transpose(1, 2)[crossed][:, :first],
        jamp.transpose(1, 2)[crossed][:, :first], rtol=1e-3)
    assert to.locked.transpose(1, 2)[crossed][:, -1].all()
    tst = tst._replace(**{name: torch.where(
        crossed.reshape(getattr(tst, name).shape[:2] + (1,) * (
            getattr(tst, name).ndim - 2)),
        torch.from_numpy(np.asarray(getattr(jst, name))).reshape(
            getattr(tst, name).shape), getattr(tst, name))
        for name in ("freq", "phase", "df_buf")})
    to = to._replace(freq=torch.where(crossed[:, None], jfreq, to.freq),
                     amplitude=torch.where(crossed[:, None], jamp,
                                           to.amplitude))
    for s in range(2):
        _compare(jtrk.ChannelState(*(x[s] for x in jst)),
                 jtrk.ChannelOut(*(x[s] for x in jo)),
                 ttrk.ChannelState(*(x[s] for x in tst)),
                 ttrk.ChannelOut(*(x[s] for x in to)))
    assert out["streams_2x12_locked"] == int(to.locked[:, -1].sum())


def test_acquisition_and_widegrid_match_jax(monkeypatch):
    calls = _record(monkeypatch, "acquire_impl")
    sats = bench.headline_sats(np.random.default_rng(0))
    block = DeviceSynth(SMALL, sats, noise_std=0.7, seed=1,
                        device="cpu").chunk(0, 1)[0]
    out = bench.bench_acquisition(SMALL, block, CPU)
    assert len(calls) == 4 and out["acq_prns_found"] >= 4
    out.update(bench.bench_widegrid(SMALL, block, CPU))
    assert len(calls) == 6 and set(out) == {
        "acq_full_grid_wall_ms", "acq_prns_found", "acq_31prn_pm10khz_ms"}
    for i in (3, 5):
        (cfg, blk, dops, ffts), got = calls[i]
        assert dops.shape[0] == (51 if i == 3 else 101)
        want = jacq.acquire(_jax(cfg), jnp.asarray(blk.numpy()),
                            jnp.asarray(dops.numpy()),
                            jnp.asarray(ffts.numpy()))
        np.testing.assert_array_equal(got.found.numpy(),
                                      np.asarray(want.found) > 0.5)
        np.testing.assert_array_equal(got.freq.numpy(),
                                      np.asarray(want.freq))
        np.testing.assert_array_equal(
            got.delay.numpy(), np.asarray(want.delay).astype(np.int32))
        np.testing.assert_allclose(got.norm_max.numpy(),
                                   np.asarray(want.norm_max), rtol=1e-4)


def _tiny_env(monkeypatch, extras):
    monkeypatch.setattr(bench, "bench_config",
                        lambda k: SMALL.replace(blocks_per_step=k))
    for name, value in dict(BENCH_K="4", BENCH_TSMALL="8",
                            BENCH_EXTRAS=extras, BENCH_STREAMS="2",
                            BENCH_FULL_SEC="3", BENCH_SERVE_SEC="3",
                            BENCH_SERVE_STREAMS="2",
                            BENCH_SERVE_SCALE="1,2").items():
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("BENCH_BF16", raising=False)
    monkeypatch.delenv("BENCH_SERVE_W", raising=False)


def test_main_prints_bench_py_keys(monkeypatch):
    extras = sorted(EXTRA_KEYS)
    _tiny_env(monkeypatch, ",".join(extras))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench.main(["16", "--device", "cpu"]) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert res["metric"] == "realtime_factor_12ch_track"
    want = HEADLINE_KEYS.union(*EXTRA_KEYS.values()) | {
        "device", "kernel_launches"}
    assert set(res["extra"]) == want
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    for key in want - {"device", "kernel_launches"}:
        assert re.sub(r"^(streams|serving)_2x12", "", key) in src, key
    ex = res["extra"]
    assert ex["backend"] == "cpu" and ex["device"]["name"] == "cpu"
    assert set(ex["serving_scale_curve"]) == {"1", "2"}
    for point in ex["serving_scale_curve"].values():
        assert CURVE_KEYS <= set(point)
    # the CPU runs the plain versions: no kernel launch, K-steps counted
    launches = ex["kernel_launches"]
    assert set(launches) == {"headline"} | set(extras) - {"servecurve"}
    for name in ("headline", "ch32", "streams", "fullloop", "serving"):
        assert launches[name]["k_steps"] > 0, name
        assert launches[name]["wipeoff"] == launches[name]["cheap"] == 0
    assert launches["widegrid"]["k_steps"] == 0


def test_failing_extra_fails_main(monkeypatch):
    _tiny_env(monkeypatch, "widegrid,frontend")

    def boom(*args):
        raise RuntimeError("widegrid broke")
    monkeypatch.setattr(bench, "bench_widegrid", boom)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(RuntimeError,
                                             match="widegrid broke"):
        bench.main(["16", "--device", "cpu"])
    assert "{" not in buf.getvalue()


def test_bench_bf16_raises(monkeypatch):
    _tiny_env(monkeypatch, "frontend")
    monkeypatch.setenv("BENCH_BF16", "1")
    with pytest.raises(ValueError, match="BENCH_BF16"):
        bench.main(["16", "--device", "cpu"])


class _Sliced:
    """A synth that hands out slices of one pre-synthesized buffer
    (DeviceScenarioSynth chunks are chunking-invariant bit for bit), so
    the runs share the IQ."""

    def __init__(self, buf):
        self.buf = buf

    def chunk(self, first, n):
        return self.buf[first:first + n]


# chunks of each soak run: 14 (session) and 12 (server) chunks of 1.024 s,
# checkpointed at half time as soak.py does
SOAK_CHUNKS = {1: 14, 2: 12}


@pytest.fixture(scope="module")
def soak_case():
    """soak.py's scenario cut to 6 satellites at 1.024 MS/s (cs 1024; the
    soak's K=16) with windows of 2 chunks, synthesized once (14.3 s)."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth

    cfg = soak.soak_config(16, 1).replace(code_samples=1024,
                                          chunks_per_download=2)
    n = max(SOAK_CHUNKS.values()) * cfg.no_sec
    scn = make_scenario(cfg, n_sats=6, duration_sec=n * cfg.block_sec + 12,
                        seed=2)
    syn = DeviceScenarioSynth(scn, noise_std=0.5, knot_interp_step=0.1,
                              device="cpu")
    return cfg, scn, _Sliced(syn.chunk(0, n))


@pytest.mark.parametrize("n_streams", [1, 2])
def test_soak_resume_gives_uninterrupted_fixes(soak_case, n_streams,
                                               monkeypatch):
    """With ephemerides preloaded (fixes need only a decoded time
    reference, ~9 s here) the resumed run's fixes are the uninterrupted
    run's.  Both runs group the same chunks into download windows (one
    epoch a window): half time falls on a window boundary of the
    uninterrupted run (the session's first window is the cold-start
    chunk alone, so 7 = 1 + 3 x 2; the server's are all full, 6 = 3 x
    2).  Where it does not, the epochs and so the fixes differ (the
    subframes are polled at each window's end) though both are right."""
    from gps_sdr_tpu_torch.runtime import evaluator

    cfg0, scn, syn = soak_case
    cfg = cfg0.replace(track_filter_q=0.5 if n_streams == 1 else 0.0,
                       raim=n_streams == 1)
    ephs = {s.prn: {"SAT": s.prn, **s.eph} for s in scn.sats}
    real_init = evaluator.Evaluator.__init__

    def preloaded(self, *a, **kw):
        real_init(self, *a, **kw)
        self.preloaded_ephem.update(ephs)
    monkeypatch.setattr(evaluator.Evaluator, "__init__", preloaded)
    n_chunks = SOAK_CHUNKS[n_streams]
    ref = soak.run_streams(cfg, syn, n_chunks, n_streams, "cpu", None)
    got = soak.run_streams(cfg, syn, n_chunks, n_streams, "cpu",
                           n_chunks // 2)
    assert got["consumed"] == n_chunks // 2 * cfg.no_sec
    assert got["checkpoint_kb"] > 0 and ref["consumed"] is None
    for ev_r, ev_g in zip(ref["evaluators"], got["evaluators"]):
        pr, pg = soak.positions(ev_r), soak.positions(ev_g)
        assert len(pr) >= 40 and pr.shape == pg.shape
        np.testing.assert_allclose(pg, pr, rtol=0, atol=1e-3)
        assert ev_g.n_phase_errors == ev_r.n_phase_errors == 0
    for i, (ev, st) in enumerate(zip(got["evaluators"], got["states"])):
        rep = soak.stream_report(cfg, scn, ev, st,
                                 n_chunks * cfg.no_sec * cfg.block_sec, 6, i)
        assert rep["fixes"] == len(ev.positions)
        assert rep["locked_channels_end"] >= 5


def test_soak_main_writes_only_out(tmp_path, monkeypatch):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    out = tmp_path / "soak.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = soak.main(["--hours", "0.001", "--sats", "4", "--device",
                        "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == (0 if doc["pass"] else 1) and not doc["pass"]
    assert doc["checkpoint_at_blocks"] == 2 * 32
    assert doc["streams"] == 1 and doc["backend"] == "cpu"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["soak.json", "tmp"]
    assert list(tmp.iterdir()) == []


def test_endurance_tiny_passes(capsys):
    assert endurance.main(["--minutes", "0.05", "--channels", "4",
                           "--chunk-blocks", "32", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith("PASS")
