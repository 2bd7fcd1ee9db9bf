"""PyTorch port vs JAX on tests/test_impaired_replay.py's capture: a
40 s, 8-satellite scenario (seed 3) under a +2 ppm TCXO with a 2.6 Hz/s
drift at L1 and the matching code-clock skew, noise 0.5, packed at x0.12,
searched over min_freq -8200 .. max_freq 2200 Hz (53 bins) with
solve_clock_rate.  The same bytes go through the JAX Session and the
port's Session on the CPU (tests/torch_envelope.py's comparisons), and
the JAX test's four bars are applied to the port's run."""

import numpy as np
import pytest
import torch

from gps_sdr_tpu.models.scenario import make_scenario as jax_scenario
from gps_sdr_tpu_torch.config import L1_FREQ, ReceiverConfig
from gps_sdr_tpu_torch.models.scenario import make_scenario
from gps_sdr_tpu_torch.ops.tracking import summarize_states
from tests import torch_envelope as env

torch.set_num_threads(2)

SEC = 40.0
OSC_PPM = 2.0
OSC_PPM_RATE = 1.65e-3
CFG = ReceiverConfig(min_freq=-8200.0, max_freq=2200.0,
                     solve_clock_rate=True)


def _scenario(make, cfg):
    return make(cfg, n_sats=8, duration_sec=SEC + 12.0, seed=3,
                osc_ppm=OSC_PPM, osc_ppm_rate=OSC_PPM_RATE)


@pytest.fixture(scope="module")
def runs():
    path = env.build_capture(
        "torch_envelope_impaired_v1.bin",
        _scenario(jax_scenario, env.jax_cfg(CFG)), CFG,
        int(round(SEC / CFG.block_sec)), noise=0.5, scale=0.12)
    return (_scenario(make_scenario, CFG),) + env.run_pair(CFG, path)


@pytest.mark.parametrize("check", sorted(env.CHECKS))
def test_port_matches_jax(runs, check):
    _, js, ts = runs
    env.CHECKS[check](js, ts)


def test_search_grid_has_53_bins():
    assert len(CFG.doppler_bins) == 53


def test_golden_fix_under_full_envelope(runs):
    scn, _, ts = runs
    ev = ts.evaluator
    assert ev.stat[2] >= 8
    assert env.fix_error(ev, scn.rec_ecef) < 8.0
    assert ev.n_phase_errors == 0


def test_drift_feed_forward_tracked_the_ramp(runs):
    scn, _, ts = runs
    rec = ts.receiver
    states = summarize_states(CFG, rec.states)
    t_end = SEC - 1.0
    common = -1e-6 * (OSC_PPM + OSC_PPM_RATE * t_end) * L1_FREQ
    n_checked = 0
    for slot, prn in enumerate(rec.slots.slot_prn):
        if prn == 0 or states["locked"][slot] < 0.5:
            continue
        sat = next(s for s in scn.sats if s.prn == prn)
        tau, _ = scn.sat_states(scn.t_rx0 + np.array([t_end - 0.5,
                                                      t_end + 0.5]), sat)
        dopp_true = -L1_FREQ * (tau[1] - tau[0])
        assert abs(float(states["freq"][slot]) - (dopp_true + common)) < 25.0
        n_checked += 1
    assert n_checked >= 4


def test_code_clock_skew_absorbed(runs):
    _, _, ts = runs
    pos = ts.evaluator.positions
    assert len(pos) >= 8
    assert pos[-1][0] - pos[0][0] >= 5.0


def test_clock_rate_estimated(runs):
    _, _, ts = runs
    y_mid = 1e-6 * (OSC_PPM + OSC_PPM_RATE * 30.0)
    assert abs(ts.evaluator.clock_rate_est - y_mid) < 1.5e-7
