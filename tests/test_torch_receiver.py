"""PyTorch port vs JAX: the replay slice end to end (Receiver.run).

The same 2-satellite stream (a cold-start sweep block, two full chunks
and a partial one whose length is not a multiple of K) goes through the
JAX Receiver and the port's Receiver on the CPU.  Exact: the acquired
satellites, every epoch's frame keys and code-phase PRNs and block
numbers, and the bits and edges each NavDecoder received.  To
tolerance: code phases atol 5e-3 samples (heavy-stage kernel
tolerance), AMP and CRM rtol 1e-3 and FRQ atol 1e-2 Hz (f32 reduction
order carried through the PLL feedback), acquisition norm_max rtol
1e-4."""

import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr_tpu.runtime.receiver import Receiver as JaxReceiver
from gps_sdr_tpu.utils.cplist import cp_arrays
from gps_sdr_tpu_torch.runtime.receiver import Receiver

torch.set_num_threads(2)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2, max_sat=3)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(256, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(256, seed=12))]
N_BLOCKS = 1 + 2 * CFG.no_sec + 42     # sweep + 2 chunks + 42-block tail


def _skips(at, n):
    return iter([n if i == at else 0 for i in range(N_BLOCKS)])


# skip: (block index, blocks dropped before it) — a stream gap forces a
# chunk boundary and the erase-on-gap path at the next chunk's first step
@pytest.mark.parametrize("skip", [None, (150, 5)], ids=["no_gap", "gap"])
def test_receiver_run_matches_jax(skip):
    blocks = synth_stream(CFG, SATS, N_BLOCKS, noise_std=0.2, seed=9)
    jr = JaxReceiver(CFG)
    tr = Receiver(CFG, device="cpu")
    jep = list(jr.run(iter(blocks),
                      skip_iter=_skips(*skip) if skip else None))
    tep = list(tr.run(iter(blocks),
                      skip_iter=_skips(*skip) if skip else None))

    assert [f[1:] for f in tr.found_sats] == [f[1:] for f in jr.found_sats]
    assert {f[1] for f in tr.found_sats} == {5, 12}
    np.testing.assert_allclose([f[0] for f in tr.found_sats],
                               [f[0] for f in jr.found_sats], rtol=1e-4)
    assert tr.slots.slot_prn == jr.slots.slot_prn
    assert len(tep) == len(jep) == (4 if skip else 3)
    assert tr.status.skipped_blocks == jr.status.skipped_blocks
    if not skip:
        assert tr.status.k_steps == (2 * CFG.no_sec + 40) // 4

    for je, te in zip(jep, tep):
        assert te.skipped_samples == je.skipped_samples
        assert [sorted(f) for f in te.frames] == \
            [sorted(f) for f in je.frames]
        for jf, tf in zip(je.frames, te.frames):
            assert tf["SAT"] == jf["SAT"] and tf["SWP"] == jf["SWP"]
            np.testing.assert_allclose(tf["AMP"], jf["AMP"], rtol=1e-3)
            np.testing.assert_allclose(tf["CRM"], jf["CRM"], rtol=1e-3)
            np.testing.assert_allclose(tf["FRQ"], jf["FRQ"], atol=1e-2)
        assert sorted(te.code_phases) == sorted(je.code_phases)
        for prn in je.code_phases:
            js, jv = cp_arrays(je.code_phases[prn])
            ts, tv = cp_arrays(te.code_phases[prn])
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_allclose(tv, jv, atol=5e-3)

    assert tr.decoders.keys() == jr.decoders.keys()
    for slot, jd in jr.decoders.items():
        td = tr.decoders[slot]
        assert td.last_sign == jd.last_sign
        np.testing.assert_array_equal(np.asarray(td.edges),
                                      np.asarray(jd.edges))
        np.testing.assert_array_equal(td.bits, jd.bits)
        np.testing.assert_array_equal(td.bits_st, jd.bits_st)
    assert sum(len(jd.edges) for jd in jr.decoders.values()) > 0
