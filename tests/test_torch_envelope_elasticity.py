"""PyTorch port vs JAX on tests/test_channel_elasticity.py's stream: two
channels (max_sat 2, a 2 s quality window) on 3 s of A+B (PRNs 5 and
12) then 3 s of B+C (12 and 23), noise 0.4; once A's quality collapses
a global re-sweep is requested.  The same stream goes through the JAX
Receiver and the port's Receiver on the CPU, each requesting the sweep
at the same point (tests/torch_envelope.py's comparisons on the epochs),
and the JAX test's bars are applied to the port: A and B acquired cold,
the set ends {12, 23}, and PRN 23 yields > 20 code phases in the last
epoch."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gps_sdr_tpu.runtime.receiver import Receiver as JaxReceiver
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from tests import torch_envelope as env

torch.set_num_threads(2)

CFG = ReceiverConfig(max_sat=2, corr_q_window_sec=2)
SAT_A = SatSignal(prn=5, doppler=1500.0, code_delay=300.0,
                  nav_bits=random_bits(64, seed=5))
SAT_B = SatSignal(prn=12, doppler=-2200.0, code_delay=900.0,
                  nav_bits=random_bits(64, seed=12))
SAT_C = SatSignal(prn=23, doppler=3100.0, code_delay=1500.0,
                  nav_bits=random_bits(64, seed=23))
N_HALF = 3 * CFG.no_sec


def _run(rx, blocks):
    """The JAX test's loop: request a sweep once A should have set."""
    epochs = []
    for epoch in rx.run(iter(blocks)):
        epochs.append(epoch)
        if rx.status.blocks_processed >= N_HALF + 2 * CFG.no_sec \
                and 5 in rx.slots.active:
            rx.request_sweep()
    return SimpleNamespace(receiver=rx, epochs=epochs, records=[
        (e.skipped_samples, e.frames, e.code_phases) for e in epochs])


@pytest.fixture(scope="module")
def runs():
    blocks = np.concatenate([
        synth_stream(CFG, [SAT_A, SAT_B], N_HALF, noise_std=0.4, seed=1),
        synth_stream(CFG, [SAT_B, SAT_C], N_HALF, noise_std=0.4, seed=2)])
    return (_run(JaxReceiver(env.jax_cfg(CFG)), blocks),
            _run(Receiver(CFG, device="cpu"), blocks))


@pytest.mark.parametrize("check", ["acquisition", "subframes",
                                   "code_phases", "reports"])
def test_port_matches_jax(runs, check):
    env.CHECKS[check](*runs)


def test_sweep_replaces_set_satellite(runs):
    jr, tr = runs
    assert {5, 12} <= {sf["SAT"] for e in tr.epochs[:2] for sf in e.frames}
    assert tr.receiver.slots.active == jr.receiver.slots.active == {12, 23}
    last = tr.epochs[-1]
    assert 23 in last.code_phases and len(last.code_phases[23]) > 20
    assert 12 in last.code_phases
