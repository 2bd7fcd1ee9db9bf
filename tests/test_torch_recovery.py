"""PyTorch port vs JAX: receiver behaviours that need a whole run to show
(tests/test_recovery.py's signal loss, tests/test_carrier_smoothing.py's
carrier input), on the CPU at the small test configuration.

  * a mid-run re-sweep: one of two satellites fades out after 10 blocks
    and is back 130 blocks later; once the 1 s correlation-quality ring
    is full of misses the channel raises its sweep request, the chunk's
    last block (with the signal back) is searched, the channel is reset
    on what the search found and tracks again.  Through
    Receiver.run_device and through StreamServer (two replicas of the
    capture, where the sweep runs on a slice of the stacked state,
    _slice_stream, and is scattered back, _scatter_stream): the epochs,
    the swept flags, the decoders and the sweep counts against the JAX
    receiver and server, with tests/test_torch_device_path.py's
    tolerances, but for PRN 5's AMP with excision
    (tests/test_torch_frontend.py amp_rtol);
  * carrier smoothing (cfg.carrier_smoothing > 0) end to end through
    Session.run_device_source: the per-block carrier frequencies the
    evaluator receives (block numbers exact, values atol 1e-2 Hz), the
    epochs and the evaluator's summary against JAX's Session;
  * each once more with a CW tone and cw_excision=12, where the
    re-sweep's acquisition excises its block too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.runtime.receiver import Receiver as JaxReceiver
from gps_sdr_tpu.runtime.serving import StreamServer as JaxServer
from gps_sdr_tpu.runtime.session import Session as JaxSession
from gps_sdr_tpu_torch.models.simulator import synth_stream
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.runtime.serving import StreamServer
from gps_sdr_tpu_torch.runtime.session import Session
from gps_sdr_tpu_torch.utils.cplist import cp_arrays
from tests.test_torch_device_path import (CFG, SATS, T, _compare_decoders,
                                          _compare_epochs, _jax, _primed)
from tests.test_torch_frontend import CW, _compare_run_epochs, _tone
from tests.test_torch_serving import stream_epochs

torch.set_num_threads(2)

N_CHUNKS = 8
LOSS = (10, 140)        # PRN 12 absent from block 10 up to block 140
SWEEP_EPOCH = 5         # the chunk ending at block 143: ring full, signal back


def _cfg(cw: bool, **kw):
    """corr_q_window_sec=1: a 125-block quality ring fills within the
    test; one chunk a download window."""
    return CFG.replace(corr_q_window_sec=1, chunks_per_download=1,
                       cw_excision=12.0 if cw else 0.0, **kw)


def _iq(cfg, cw: bool) -> np.ndarray:
    """Grouped planar IQ of SATS with PRN 12 faded out over LOSS."""
    n = N_CHUNKS * T
    a = synth_stream(cfg, SATS[:1], n, noise_std=0.2, seed=9)
    b = synth_stream(cfg, SATS[1:], n, noise_std=0.0, seed=9)
    gate = np.ones((n, 1), np.float32)
    gate[LOSS[0]:LOSS[1]] = 0.0
    x = a + gate * b
    if cw:
        x = x + _tone(cfg, n, *CW)
    return ttrk.to_grouped_planar(cfg, torch.from_numpy(
        x.astype(np.complex64))).numpy()


def _swept(epochs):
    """Per epoch, the PRNs whose frames carry the swept flag."""
    return [sorted({f["SAT"] for f in e.frames if f["SWP"]})
            for e in epochs]


@pytest.mark.parametrize("cw", [False, True], ids=["clean", "cw"])
def test_receiver_resweep_matches_jax(cw):
    cfg = _cfg(cw)
    iq = _iq(cfg, cw)
    jr = _primed(JaxReceiver(_jax(cfg)))
    tr = _primed(Receiver(cfg, device="cpu"))
    jep = list(jr.run_device(lambda f, n: jnp.asarray(iq[f:f + n]),
                             N_CHUNKS, chunk_blocks=T))
    tep = list(tr.run_device(lambda f, n: torch.from_numpy(iq[f:f + n]),
                             N_CHUNKS, chunk_blocks=T))
    want = [[12] if i == SWEEP_EPOCH else [] for i in range(N_CHUNKS)]
    assert _swept(tep) == _swept(jep) == want
    assert tr.status.sweeps_served == jr.status.sweeps_served == 1
    # PRN 12 lost its code during the fade and tracks again after the
    # re-acquisition
    assert 12 not in tep[3].code_phases
    assert len(cp_arrays(tep[-1].code_phases[12])[0]) == T
    (_compare_run_epochs if cw else _compare_epochs)(jep, tep)
    _compare_decoders(jr, tr)


@pytest.mark.parametrize("cw", [False, True], ids=["clean", "cw"])
def test_server_resweep_matches_jax(cw, monkeypatch):
    cfg = _cfg(cw)
    iq = _iq(cfg, cw)
    calls = {"slice": 0, "scatter": 0}
    real_slice, real_scatter = (StreamServer._slice_stream,
                                StreamServer._scatter_stream)

    def counting_slice(self, s):
        calls["slice"] += 1
        return real_slice(self, s)

    def counting_scatter(self, s):
        calls["scatter"] += 1
        return real_scatter(self, s)

    monkeypatch.setattr(StreamServer, "_slice_stream", counting_slice)
    monkeypatch.setattr(StreamServer, "_scatter_stream", counting_scatter)
    js, ts = JaxServer(_jax(cfg), 2), StreamServer(cfg, 2, device="cpu")
    for rx in js.receivers + ts.receivers:
        _primed(rx)
    jep = stream_epochs(js, lambda f, n: jnp.asarray(iq[f:f + n]), N_CHUNKS)
    before = dict(calls)
    tep = stream_epochs(ts, lambda f, n: torch.from_numpy(iq[f:f + n]),
                        N_CHUNKS)
    # one mid-run sweep per stream: a slice to serve it and a scatter of
    # its result, plus the final hand-back slices
    assert calls["scatter"] - before["scatter"] == 2
    assert calls["slice"] - before["slice"] == 2 + 2
    want = [[12] if i == SWEEP_EPOCH else [] for i in range(N_CHUNKS)]
    for s in range(2):
        jr, tr = js.receivers[s], ts.receivers[s]
        assert _swept(tep[s]) == _swept(jep[s]) == want
        assert tr.status.sweeps_served == jr.status.sweeps_served == 1
        (_compare_run_epochs if cw else _compare_epochs)(jep[s], tep[s])
        _compare_decoders(jr, tr)
    # the swept stream's state was written back into the stack: both
    # streams track PRN 12 again, on what the search found
    for s in range(2):
        assert len(cp_arrays(tep[s][-1].code_phases[12])[0]) == T


@pytest.mark.parametrize("cw", [False, True], ids=["clean", "cw"])
def test_carrier_smoothing_session_matches_jax(cw):
    cfg = _cfg(cw, carrier_smoothing=8)
    iq = _iq(cfg, cw)
    js = JaxSession(_jax(cfg), record_epochs_to="-")
    ts = Session(cfg, device="cpu", record_epochs_to="-")
    _primed(js.receiver), _primed(ts.receiver)
    jsum = js.run_device_source(lambda f, n: jnp.asarray(iq[f:f + n]),
                                N_CHUNKS, chunk_blocks=T)
    tsum = ts.run_device_source(lambda f, n: torch.from_numpy(iq[f:f + n]),
                                N_CHUNKS, chunk_blocks=T)
    assert len(ts.records) == len(js.records) == N_CHUNKS
    n_freqs = 0
    for jr, tr in zip(js.records, ts.records):
        assert len(tr) == len(jr) == 4          # carrier_freqs recorded
        assert sorted(tr[3]) == sorted(jr[3])
        for prn in jr[3]:
            jn, jv = cp_arrays(jr[3][prn])
            tn, tv = cp_arrays(tr[3][prn])
            np.testing.assert_array_equal(tn, jn)
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-2)
            n_freqs += len(jn)
        assert sorted(tr[2]) == sorted(jr[2])
    assert n_freqs > N_CHUNKS * T
    for key in ("n_positions", "n_fix_failures", "n_outliers",
                "n_phase_errors", "skipped_blocks"):
        assert tsum[key] == jsum[key], key
    assert ts.receiver.status.sweeps_served == 1
