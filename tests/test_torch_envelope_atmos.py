"""PyTorch port vs JAX on tests/test_atmos_closed_loop.py's capture: 30 s,
7 satellites (seed 21) with Klobuchar and Saastamoinen delays injected
and the page-18 coefficients broadcast, noise 0.5, packed at x0.13,
iono_corr and tropo_corr on.  The same bytes go through the JAX Session
and the port's Session on the CPU, once as the JAX test runs it and
once with almanac_resweep_sec 2 from a cached almanac
(tests/torch_envelope.py's comparisons for both), and the JAX test's
bars are applied to the port: corrections buy > 1 m on the same epochs,
the maintenance sweeps keep the set, preloaded coefficients correct
from the first fix, and the static receiver's velocity sits near 0."""

import os

import numpy as np
import pytest
import torch

from gps_sdr_tpu.models.scenario import make_scenario as jax_scenario
from gps_sdr_tpu.runtime.session import Session as JaxSession
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.almanac import almanac_from_ephem
from gps_sdr_tpu_torch.models.scenario import make_scenario
from gps_sdr_tpu_torch.runtime.evaluator import EpochInput, Evaluator
from gps_sdr_tpu_torch.runtime.session import Session
from gps_sdr_tpu_torch.utils.io import save_almanac
from tests import torch_envelope as env
from tests.conftest import _SYNTH_CACHE

torch.set_num_threads(2)

SEC = 30.0
CFG = ReceiverConfig(iono_corr=True, tropo_corr=True)
CFG_MAINT = CFG.replace(almanac_resweep_sec=2.0)


def _scenario(make, cfg):
    return make(cfg, n_sats=7, duration_sec=SEC + 12.0, seed=21, iono=True,
                tropo=True)


def _almanac(scn) -> str:
    """The scenario's almanac as a cache file of this process's own."""
    path = os.path.join(_SYNTH_CACHE,
                        f"torch_envelope_almanac.{os.getpid()}.json")
    save_almanac(path, {s.prn: almanac_from_ephem(s.eph) for s in scn.sats})
    return path


@pytest.fixture(scope="module")
def runs():
    path = env.build_capture(
        "torch_envelope_atmos_v1.bin",
        _scenario(jax_scenario, env.jax_cfg(CFG)), CFG,
        int(round(SEC / CFG.block_sec)), noise=0.5, scale=0.13)
    scn = _scenario(make_scenario, CFG)
    alm = _almanac(scn)
    try:
        maint = env.run_pair(CFG_MAINT, path, almanac_cache_path=alm)
    finally:
        os.remove(alm)
    return {"scn": scn, "atmos": env.run_pair(CFG, path), "maint": maint}


@pytest.mark.parametrize("run", ["atmos", "maint"])
@pytest.mark.parametrize("check", sorted(env.CHECKS))
def test_port_matches_jax(runs, run, check):
    env.CHECKS[check](*runs[run])


def test_corrected_fix_beats_uncorrected(runs):
    scn = runs["scn"]
    js, ts = runs["atmos"]
    ev = ts.evaluator
    assert ev.iono_params is not None
    assert ev.stat[2] >= 8
    err_corr = env.fix_error(ev, scn.rec_ecef)
    off = Session(ReceiverConfig(), device="cpu")
    off.run_epoch_records(ts.records)
    err_off = env.fix_error(off.evaluator, scn.rec_ecef)
    assert err_corr < 6.0
    assert err_off > err_corr + 1.0
    # the JAX evaluator on its own records, corrections off
    joff = JaxSession(env.jax_cfg(ReceiverConfig()))
    joff.run_epoch_records(js.records)
    assert np.linalg.norm(off.evaluator.stat[0] - joff.evaluator.stat[0]) \
        <= env.MEAN_ATOL


def test_almanac_maintenance_resweeps(runs):
    scn = runs["scn"]
    js, ts = runs["maint"]
    assert ts.receiver.status.warm_sweeps >= 2
    assert env.fix_error(ts.evaluator, scn.rec_ecef) < 6.0
    assert len(ts.receiver.slots.active) >= 6
    assert ts.receiver.slots.active == js.receiver.slots.active


def test_preloaded_iono_corrects_from_first_fix(runs):
    scn = runs["scn"]
    ev = Evaluator(CFG, iono_params={"alpha": scn.iono_alpha,
                                     "beta": scn.iono_beta})
    for rec in runs["atmos"][1].records:
        ev.process(EpochInput(*rec))
    assert len(ev.positions) >= 5
    first = np.asarray(ev.positions[0][1:])
    assert np.linalg.norm(first - scn.rec_ecef) < 30.0
    assert env.fix_error(ev, scn.rec_ecef) < 2.0


def test_static_velocity_near_zero(runs):
    ev = runs["atmos"][1].evaluator
    assert len(ev.velocities) >= 3
    v = np.array([row[1:] for row in ev.velocities], np.float64)
    assert np.linalg.norm(np.median(v, axis=0)) < 0.3
