"""PyTorch port vs JAX at 2.4 MS/s (code_samples 2400, an RTL-SDR's
highest rate without lost samples; 2400 = 18 x 128 + 96, off the port's
wipeoff kernels' 128-column tile grid): a models/scenario.py capture of
six satellites, 30 s, noise 0.5, synthesized by the port's
DeviceScenarioSynth on the CPU and packed as iq8 at x0.13 (the scale of
tests/torch_envelope.py's captures), replayed through the JAX Session
on its XLA path (use_pallas_kernels resolves to False off a TPU) and
through the port's Session on the CPU.  Held as
tests/torch_envelope.py holds the envelope captures: the acquired
satellites (PRN, frequency and delay exact), the decoded subframes
field for field, the code phases within 5e-3 samples (the kernel
tolerance), the reports, and the fixes epoch by epoch within 0.1 m.
No satellite's code phase crosses the period boundary in the capture
(the JAX package would read the crossing as a millisecond of its own:
fault A, which the port mends; tests/test_torch_envelope_raim.py)."""

import os

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.scenario import make_scenario
from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
from gps_sdr_tpu_torch.runtime.sources import pack_iq
from tests import torch_envelope as env
from tests.conftest import _SYNTH_CACHE

torch.set_num_threads(2)

SEC = 30.0
SEED = 2
CFG = ReceiverConfig(code_samples=2400)


def _capture(scn, name: str) -> str:
    """The scenario's iq8 capture under .synth_cache/ (built once,
    through a per-process temporary file)."""
    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, name)
    if os.path.exists(path):
        return path
    synth = DeviceScenarioSynth(scn, noise_std=0.5, device="cpu")
    n_blocks = int(round(SEC / CFG.block_sec))
    words = [pack_iq(0.13 * synth.chunk(first, min(
        CFG.no_sec, n_blocks - first)).numpy()).ravel()
        for first in range(0, n_blocks, CFG.no_sec)]
    tmp = f"{path}.{os.getpid()}.tmp"
    np.concatenate(words).tofile(tmp)
    os.replace(tmp, path)
    return path


@pytest.fixture(scope="module")
def runs():
    scn = make_scenario(CFG, n_sats=6, duration_sec=SEC + 12.0, seed=SEED)
    path = _capture(scn, "torch_parity_rate24_v1.bin")
    return scn, env.run_pair(CFG, path)


@pytest.mark.parametrize("check", sorted(env.CHECKS))
def test_port_matches_jax_at_2_4_msps(runs, check):
    env.CHECKS[check](*runs[1])


def test_port_fixes_at_2_4_msps(runs):
    """The port at cs 2400 acquires every satellite of the scenario,
    decodes subframes 1-3 of each and fixes within 30 m of the truth
    (9.5 m measured; the mean of ~200 fixes over 30 s of noise 0.5); no
    code phase comes within 8 samples of the period boundary."""
    scn, (_, ts) = runs
    assert sorted(f[1] for f in ts.receiver.found_sats) == \
        sorted(s.prn for s in scn.sats)
    ids = {(sf["SAT"], sf["ID"]) for sf in env.subframes(ts).values()}
    assert {(s.prn, i) for s in scn.sats for i in (1, 2, 3)} <= ids
    for _, cp in env.code_phases(ts).values():
        assert ((cp > 8) & (cp < CFG.code_samples - 8)).all()
    assert len(ts.evaluator.positions) > 0
    assert env.fix_error(ts.evaluator, scn.rec_ecef) < 30.0
