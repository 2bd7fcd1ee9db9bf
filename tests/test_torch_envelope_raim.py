"""PyTorch port vs JAX on tests/test_raim.py's capture: 30 s, 7 satellites
(seed 35), the third satellite's SV clock faulted by 1 us (~300 m) with
its broadcast clock model untouched, noise 0.5, packed at x0.13.  It is
replayed with RAIM on (carrier_smoothing 64) and off (carrier smoothing
only), each through the JAX Session and the port's Session on the CPU
(tests/torch_envelope.py's comparisons: the same RAIM events, PRN and
epoch exact, statistics rtol 1e-4), and the JAX test's three bars are
applied to the port's runs.  test_aux_units.py's DOP check is twinned
on the port's recorded epochs (test_dop_matches_jax).

PRN 9's code phase crosses the code period boundary in this capture
(2002 samples at the start, 16 at the end).  The JAX package reads the
sliver of a period at the crossing as a millisecond of its own (fault
A, which the port mends): it slips PRN 9's bit grid and loses its
subframe 3.  On the checks that the crossing reaches (the subframes,
the reports' Doppler, the fixes and RAIM) the packages are held on the
capture's twin instead: the same bytes from half a code period in, at
whose alignment every code phase lies 1024 samples lower and none
crosses.  The port's run on the capture itself keeps every subframe of
its run on the twin (test_boundary_crossing_keeps_every_subframe)."""

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
# the checks that PRN 9's crossing of the code period boundary reaches
CROSSED = {"subframes", "reports", "evaluator"}


def _scenario(make, cfg):
    scn = make(cfg, n_sats=7, duration_sec=SEC + 12.0, seed=35)
    scn.sats[2].fault_dtsv = FAULT_S
    return scn


@pytest.fixture(scope="module")
def runs():
    scn = _scenario(jax_scenario, env.jax_cfg(CFG))
    n_blocks = int(round(SEC / CFG.block_sec))
    path = env.build_capture("torch_envelope_faulted_v1.bin", scn, CFG,
                             n_blocks, noise=0.5, scale=0.13)
    twin = env.build_capture("torch_envelope_faulted_half_v1.bin", scn,
                             CFG, n_blocks, noise=0.5, scale=0.13,
                             gap=(0, CFG.code_samples // 2))
    return {"scn": _scenario(make_scenario, CFG),
            "raim": env.run_pair(CFG, path),
            "off": env.run_pair(CFG_OFF, path),
            "raim_twin": env.run_pair(CFG, twin),
            "off_twin": env.run_pair(CFG_OFF, twin)}


@pytest.mark.parametrize("run", ["raim", "off"])
@pytest.mark.parametrize("check", sorted(env.CHECKS))
def test_port_matches_jax(runs, run, check):
    env.CHECKS[check](*runs[run + "_twin" if check in CROSSED else run])


@pytest.mark.parametrize("run", ["raim", "off"])
def test_boundary_crossing_keeps_every_subframe(runs, run):
    """The port decodes on the capture every subframe it decodes on the
    twin, PRN 9's subframe 3 included, nav field for nav field; the JAX
    package loses that one (fault A)."""
    def fields(session):
        return {key: {k: v for k, v in f.items()
                      if k not in env.TRANSPORT_KEYS}
                for key, f in env.subframes(session).items()}

    js, ts = runs[run]
    got, twin = fields(ts), fields(runs[run + "_twin"][1])
    assert got == twin
    lost = set(twin) - set(fields(js))
    assert lost and {key[0] for key in lost} == {9}, lost


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
