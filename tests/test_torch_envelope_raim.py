"""PyTorch port vs JAX on tests/test_raim.py's capture: 30 s, 7 satellites
(seed 35), the third satellite's SV clock faulted by 1 us (~300 m) with
its broadcast clock model untouched, noise 0.5, packed at x0.13.  It is
replayed with RAIM on (carrier_smoothing 64) and off (carrier smoothing
only), each through the JAX Session and the port's Session on the CPU
(tests/torch_envelope.py's comparisons: the same RAIM events, PRN and
epoch exact, statistics rtol 1e-4), and the JAX test's three bars are
applied to the port's runs.  test_aux_units.py's DOP check is twinned
on the port's recorded epochs (test_dop_matches_jax)."""

import copy

import numpy as np
import pytest
import torch

from gps_sdr_tpu.models.scenario import make_scenario as jax_scenario
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.scenario import make_scenario
from tests import torch_envelope as env

torch.set_num_threads(2)

SEC = 30.0
FAULT_S = 1.0e-6
CFG = ReceiverConfig(raim=True, carrier_smoothing=64)
CFG_OFF = ReceiverConfig(carrier_smoothing=64)


def _scenario(make, cfg):
    scn = make(cfg, n_sats=7, duration_sec=SEC + 12.0, seed=35)
    scn.sats[2].fault_dtsv = FAULT_S
    return scn


@pytest.fixture(scope="module")
def runs():
    path = env.build_capture(
        "torch_envelope_faulted_v1.bin",
        _scenario(jax_scenario, env.jax_cfg(CFG)), CFG,
        int(round(SEC / CFG.block_sec)), noise=0.5, scale=0.13)
    return {"scn": _scenario(make_scenario, CFG),
            "raim": env.run_pair(CFG, path),
            "off": env.run_pair(CFG_OFF, path)}


@pytest.mark.parametrize("run", ["raim", "off"])
@pytest.mark.parametrize("check", sorted(env.CHECKS))
def test_port_matches_jax(runs, run, check):
    env.CHECKS[check](*runs[run])


def test_raim_events_match_jax(runs):
    js, ts = runs["raim"]
    assert ts.evaluator.raim_events
    assert [e[:2] for e in ts.evaluator.raim_events] == \
        [e[:2] for e in js.evaluator.raim_events]


def test_fault_biases_unprotected_fix(runs):
    assert env.fix_error(runs["off"][1].evaluator,
                         runs["scn"].rec_ecef) > 15.0


def test_raim_names_and_excludes_the_faulted_sat(runs):
    ev = runs["raim"][1].evaluator
    assert {e[1] for e in ev.raim_events} == {runs["scn"].sats[2].prn}
    assert len(ev.raim_events) <= 2
    _, _, before, after = ev.raim_events[0]
    assert before > 20 * after


def test_raim_repairs_the_fix(runs):
    truth = runs["scn"].rec_ecef
    err = env.fix_error(runs["raim"][1].evaluator, truth)
    assert err < 6.0
    assert err < 0.2 * env.fix_error(runs["off"][1].evaluator, truth)


def test_dop_matches_jax(runs):
    """tests/test_aux_units.py::test_dop_reported_and_matches_geometry on
    this capture at ReceiverConfig(): the port's recorded epochs (its
    RAIM-off run; carrier frequencies dropped, as a receiver without
    smoothing ships none) through the JAX Evaluator and the port's, the
    numpy host paths of both: the same fixes and DOP exactly, and the
    JAX test's geometry bars on both."""
    from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
    from gps_sdr_tpu.runtime import evaluator as jev
    from gps_sdr_tpu_torch.runtime import evaluator as tev
    from tests.torch_parity import same

    with pytest.MonkeyPatch.context() as m:
        m.setenv("GSDR_EVALCORE", "0")
        m.setenv("GSDR_NAVSCAN", "0")
        out = []
        for ev_mod, cfg in ((jev, JaxConfig()), (tev, ReceiverConfig())):
            ev = ev_mod.Evaluator(cfg)
            sums = [ev.process(ev_mod.EpochInput(*copy.deepcopy(r[:3])))
                    for r in runs["off"][1].records]
            g, p, h, v = ev.dop
            assert 1.0 < g < 10.0 and p < g
            assert np.isclose(np.hypot(h, v), p, rtol=1e-9)
            assert sums[-1]["dop"] == ev.dop
            out.append((ev.dop, ev.positions, sums))
    same(out[1], out[0])
