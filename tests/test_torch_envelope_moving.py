"""PyTorch port vs JAX on tests/test_velocity.py's moving capture: 48 s,
7 satellites (seed 35), a receiver moving at (12, -5, 0) m/s ENU
(~13 m/s), noise 0.5, packed at x0.13, carrier_smoothing 64.  The same
bytes go through the JAX Session and the port's Session on the CPU
(tests/torch_envelope.py's comparisons, the Doppler velocity series
included), and the JAX test's track and velocity bars are applied to
the port's run.  tests/test_trackfilter.py's three capture cases are
twinned on the port's recorded epochs (test_track_filter_*).

PRN 9's code phase crosses the code period boundary in this capture
(2002 samples at the start, 51 at the end), where the JAX package reads
the sliver of a period at the crossing as a millisecond of its own
(fault A, which the port mends) and its PLL takes another step there.
The reports' Doppler, which reads that step, is held on the capture's
twin: the same bytes from half a code period in, at whose alignment
every code phase lies 1024 samples lower and none crosses."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from gps_sdr_tpu.models.scenario import make_scenario as jax_scenario
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.scenario import make_scenario
from gps_sdr_tpu_torch.utils.gpstime import gps_datetime
from tests import torch_envelope as env
from tests.test_trackfilter import _err_vs_truth

torch.set_num_threads(2)

SEC = 48.0
VEL_ENU = (12.0, -5.0, 0.0)
CFG = ReceiverConfig(carrier_smoothing=64)


def _scenario(make, cfg):
    return make(cfg, n_sats=7, duration_sec=SEC + 12.0, seed=35,
                rec_vel_enu=VEL_ENU)


@pytest.fixture(scope="module")
def runs():
    scn = _scenario(jax_scenario, env.jax_cfg(CFG))
    n_blocks = int(round(SEC / CFG.block_sec))
    path = env.build_capture("torch_envelope_moving_v1.bin", scn, CFG,
                             n_blocks, noise=0.5, scale=0.13)
    return (_scenario(make_scenario, CFG),) + env.run_pair(CFG, path)


@pytest.fixture(scope="module")
def twin_runs():
    scn = _scenario(jax_scenario, env.jax_cfg(CFG))
    twin = env.build_capture("torch_envelope_moving_half_v1.bin", scn, CFG,
                             int(round(SEC / CFG.block_sec)), noise=0.5,
                             scale=0.13, gap=(0, CFG.code_samples // 2))
    return env.run_pair(CFG, twin)


@pytest.mark.parametrize("check", sorted(env.CHECKS))
def test_port_matches_jax(runs, check, request):
    if check == "reports":
        js, ts = request.getfixturevalue("twin_runs")
    else:
        _, js, ts = runs
    env.CHECKS[check](js, ts)


def test_moving_receiver_track(runs):
    scn, _, ts = runs
    ev = ts.evaluator
    assert len(ev.positions) >= 100
    t = np.array([p[0] for p in ev.positions])
    pos = np.array([p[1:] for p in ev.positions])
    assert t[-1] - t[0] > 10.0
    v_fit = np.array([np.polyfit(t - t[0], pos[:, ax], 1)[0]
                      for ax in range(3)])
    assert np.linalg.norm(v_fit - scn.rec_vel) < 1.0
    t0 = gps_datetime(scn.tow0, scn.week).timestamp() + 0.25
    err = pos - (scn.rec_ecef + (t - t0)[:, None] * scn.rec_vel)
    assert np.linalg.norm(err.mean(axis=0)) < 10.0


def test_doppler_velocity_series(runs):
    scn, _, ts = runs
    ev = ts.evaluator
    assert len(ev.velocities) >= 5
    v = np.array([row[1:] for row in ev.velocities], np.float64)
    assert np.linalg.norm(np.median(v, axis=0) - scn.rec_vel) < 0.5
    assert abs(ev.vel_result.clock_drift) < 2e-8


def _filter_runs(ts, cfg_kw, strip_freqs=False, edit=None):
    """The port's recorded epochs (its Session on this capture) through
    the JAX Evaluator and the port's at CFG.replace(**cfg_kw), numpy host
    paths; edit(i, epoch, evaluator module, evaluator) may change epoch
    i.  The two evaluators' fixes,
    filtered track and coasted predictions must be equal; returns both."""
    from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
    from gps_sdr_tpu.runtime import evaluator as jev
    from gps_sdr_tpu_torch.runtime import evaluator as tev
    from tests.torch_parity import same

    out = []
    with pytest.MonkeyPatch.context() as m:
        m.setenv("GSDR_EVALCORE", "0")
        m.setenv("GSDR_NAVSCAN", "0")
        for ev_mod, cfg_cls in ((jev, JaxConfig), (tev, ReceiverConfig)):
            cfg = cfg_cls(**{**dataclasses.asdict(CFG), **cfg_kw})
            ev = ev_mod.Evaluator(cfg)
            sums = []
            for i, rec in enumerate(ts.records):
                rec = copy.deepcopy(rec)
                e = ev_mod.EpochInput(*(rec[:3] if strip_freqs else rec))
                sums.append(ev.process(edit(i, e, ev_mod, ev) if edit else e))
            out.append((ev, sums))
    for name in ("positions", "filtered", "coasted", "velocities"):
        same(getattr(out[1][0], name), getattr(out[0][0], name), name)
    same(out[1][1], out[0][1], "summaries")
    return out


def _rms(e):
    return float(np.sqrt(np.mean(np.sum(e ** 2, axis=1))))


def test_track_filter_raw_fixes(runs):
    """test_moving_capture_filtered_track: raw fixes (no smoothing, so no
    carrier frequencies) and the track filter at q 1: both packages'
    filtered tracks equal, each cutting the truth-relative RMS by > 2x,
    under 8 m, ending within 0.5 m/s of the true velocity."""
    scn, _, ts = runs
    for ev, _ in _filter_runs(ts, {"carrier_smoothing": 0,
                                   "track_filter_q": 1.0}, strip_freqs=True):
        assert len(ev.filtered) >= 0.9 * len(ev.positions)
        raw = _rms(_err_vs_truth(ev.positions, scn, 64))
        filt = _rms(_err_vs_truth(ev.filtered, scn, 64))
        assert filt < 0.5 * raw and filt < 8.0, (filt, raw)
        assert np.linalg.norm(np.array(ev.filtered[-1][4:])
                              - scn.rec_vel) < 0.5


def test_track_filter_coasts_through_an_outage(runs):
    """test_outage_coasting_bridges_gap: the two epochs three after the
    first fix starved to 2 satellites; both packages coast alike, with
    at least two predictions in the outage, each within 25 m of the
    trajectory, and fixes resume."""
    scn, _, ts = runs
    first = next(i for i, s in enumerate(
        _filter_runs(ts, {"track_filter_q": 1.0})[1][1]) if s["n_fixes"])
    n_before = {}

    def starve(i, e, ev_mod, ev):
        if i == first + 3:
            n_before[ev_mod.__name__] = len(ev.coasted)
        if first + 3 <= i <= first + 4:
            keep = sorted(e.code_phases)[:2]
            e = ev_mod.EpochInput(
                e.skipped_samples, e.frames,
                {s: e.code_phases[s] for s in keep},
                {s: e.carrier_freqs[s] for s in keep
                 if s in e.carrier_freqs} if e.carrier_freqs else None)
        return e
    t0 = gps_datetime(scn.tow0, scn.week).timestamp() + 0.25
    for ev, _ in _filter_runs(ts, {"track_filter_q": 1.0}, edit=starve):
        n0 = n_before[type(ev).__module__]
        assert len(ev.coasted) >= n0 + 2, "no coasted predictions"
        for row in ev.coasted[n0:]:
            truth = scn.rec_ecef + (row[0] - t0) * scn.rec_vel
            assert np.linalg.norm(np.array(row[1:4]) - truth) < 25.0
        assert len(ev.filtered) > 0 and ev.positions


def test_track_filter_with_carrier_smoothing(runs):
    """test_filter_with_carrier_smoothing_stays_healthy: smoothing 64 and
    the filter at q 1; both packages alike, the gate not starving and
    the filtered tail no worse than 1.1x the raw fixes."""
    scn, _, ts = runs
    for ev, _ in _filter_runs(ts, {"track_filter_q": 1.0}):
        assert len(ev.filtered) >= 0.9 * len(ev.positions)
        skip = max(len(ev.filtered) - 450, 64)
        assert _rms(_err_vs_truth(ev.filtered, scn, skip)) <= \
            1.1 * _rms(_err_vs_truth(ev.positions, scn, skip))
