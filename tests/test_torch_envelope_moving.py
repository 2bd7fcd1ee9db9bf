"""PyTorch port vs JAX on tests/test_velocity.py's moving capture: 48 s,
7 satellites (seed 35), a receiver moving at (12, -5, 0) m/s ENU
(~13 m/s), noise 0.5, packed at x0.13, carrier_smoothing 64.  The same
bytes go through the JAX Session and the port's Session on the CPU
(tests/torch_envelope.py's comparisons, the Doppler velocity series
included), and the JAX test's track and velocity bars are applied to
the port's run."""

import numpy as np
import pytest
import torch

from gps_sdr_tpu.models.scenario import make_scenario as jax_scenario
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.scenario import make_scenario
from gps_sdr_tpu_torch.utils.gpstime import gps_datetime
from tests import torch_envelope as env

torch.set_num_threads(2)

SEC = 48.0
VEL_ENU = (12.0, -5.0, 0.0)
CFG = ReceiverConfig(carrier_smoothing=64)


def _scenario(make, cfg):
    return make(cfg, n_sats=7, duration_sec=SEC + 12.0, seed=35,
                rec_vel_enu=VEL_ENU)


@pytest.fixture(scope="module")
def runs():
    path = env.build_capture(
        "torch_envelope_moving_v1.bin",
        _scenario(jax_scenario, env.jax_cfg(CFG)), CFG,
        int(round(SEC / CFG.block_sec)), noise=0.5, scale=0.13)
    return (_scenario(make_scenario, CFG),) + env.run_pair(CFG, path)


@pytest.mark.parametrize("check", sorted(env.CHECKS))
def test_port_matches_jax(runs, check):
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
