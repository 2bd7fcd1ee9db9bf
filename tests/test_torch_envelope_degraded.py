"""PyTorch port vs JAX on tests/test_reference_degraded.py's capture: 64 s,
8 satellites (seed 2), noise 2.0 (correlations graze the 8 sigma gates),
0.6 ppm plus 3e-4 ppm/s, packed at x0.05, and a 6758-sample gap at 30 s
(every channel's code phase jumps by the same 614 samples).  The same
bytes go through the JAX Session and the port's Session on the CPU
(tests/torch_envelope.py's comparisons), and test_reference_degraded's
event-aligned claims are held between the two packages in place of the
upstream receiver: both trip the phase-error vote 1-4 times, both track
the same >= 6 satellites before and after the event, and both give >= 10
fixes before and after it, the port's post-event fixes as accurate as
JAX's and the same epoch by epoch."""

import numpy as np
import pytest
import torch

from gps_sdr_tpu.models.scenario import make_scenario as jax_scenario
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.scenario import make_scenario
from tests import torch_envelope as env

torch.set_num_threads(2)

SEC = 64.0
GAP_AT_SEC = 30.0
GAP_SAMPLES = 6758
CFG = ReceiverConfig()


def _scenario(make, cfg):
    return make(cfg, n_sats=8, duration_sec=SEC + 12.0, seed=2,
                osc_ppm=0.6, osc_ppm_rate=3.0e-4)


@pytest.fixture(scope="module")
def runs():
    path = env.build_capture(
        "torch_envelope_degraded_v1.bin",
        _scenario(jax_scenario, env.jax_cfg(CFG)), CFG,
        int(round(SEC / CFG.block_sec)), noise=2.0, scale=0.05,
        gap=(int(GAP_AT_SEC * CFG.sample_rate), GAP_SAMPLES))
    return (_scenario(make_scenario, CFG),) + env.run_pair(CFG, path)


def _tracked(session, after: bool) -> set:
    """Satellites with code phases in the 20 s after the event (after)
    or in the 10 s before it."""
    lo, hi = ((SEC - 20.0, SEC) if after
              else (GAP_AT_SEC - 10.0, GAP_AT_SEC))
    lo, hi = (int(x / CFG.block_sec) for x in (lo, hi))
    return {int(sat) for _, _, coph, *_ in session.records
            for sat, lst in coph.items()
            if any(lo <= int(n) < hi for n, _ in lst)}


def _event_split(ev, t_event):
    fixes = np.array([p[:4] for p in ev.positions], np.float64)
    return (fixes[fixes[:, 0] < t_event - 1.0],
            fixes[fixes[:, 0] > t_event + 10.0])


@pytest.mark.parametrize("check", sorted(env.CHECKS))
def test_port_matches_jax(runs, check):
    _, js, ts = runs
    env.CHECKS[check](js, ts)


def test_both_packages_trip_phase_error(runs):
    _, js, ts = runs
    n_jax, n_port = js.evaluator.n_phase_errors, ts.evaluator.n_phase_errors
    assert 1 <= n_port <= 4 and 1 <= n_jax <= 4, (n_jax, n_port)
    assert n_port == n_jax


@pytest.mark.parametrize("after", [False, True], ids=["before", "after"])
def test_same_satellites_through_event(runs, after):
    _, js, ts = runs
    acquired = {int(p) for p in ts.receiver.slots.slot_prn if p}
    assert acquired == {int(p) for p in js.receiver.slots.slot_prn if p}
    assert len(acquired) >= 6
    port, jax = _tracked(ts, after), _tracked(js, after)
    assert port == jax and len(port) >= 6, (port, jax)


def test_fixes_reconverge_after_event(runs):
    scn, js, ts = runs
    # the event on the fixes' clock, anchored as test_reference_degraded
    # does: the first fix comes ~14 s into the capture
    t_event = js.evaluator.positions[0][0] - 14.0 + GAP_AT_SEC
    (pre_j, post_j), (pre_t, post_t) = (_event_split(s.evaluator, t_event)
                                        for s in (js, ts))
    for pre, post in ((pre_j, post_j), (pre_t, post_t)):
        assert len(pre) >= 10 and len(post) >= 10
    err_j = np.linalg.norm(post_j[:, 1:4] - scn.rec_ecef, axis=1)
    err_t = np.linalg.norm(post_t[:, 1:4] - scn.rec_ecef, axis=1)
    scatter = float(np.mean(err_j))
    assert np.mean(err_t) < scatter + max(2.0, 0.5 * scatter)
    np.testing.assert_array_equal(post_t[:, 0], post_j[:, 0])
    sep = np.linalg.norm(post_t[:, 1:4] - post_j[:, 1:4], axis=1)
    assert np.median(sep) < max(2.0, scatter)
    assert sep.max() <= env.POS_ATOL
