"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  CUDA kernels have no interpret mode, so these tests need an
NVIDIA GPU and skip without one; run them there with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(--noconftest: tests/conftest.py configures JAX, which a machine that
runs only the port need not have.)  The cases and tolerances are chip_smoke.py's (check_wipeoff,
check_cheap_chain), here also at the small test configuration, plus the
slice with the kernels against the slice with their plain versions, and
the slice on the card against the slice on the CPU."""

import numpy as np
import pytest
import torch

import chip_smoke
from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr_tpu.utils.cplist import cp_arrays

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

SMALL = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                       sweep_corr_avg=2, blocks_per_step=4,
                       corr_q_window_sec=2)
PRODUCT = ReceiverConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cfg,n_ch", [(SMALL, 2), (PRODUCT, 11)],
                         ids=["small", "product"])
def test_wipeoff_kernel_matches_plain(cuda, cfg, n_ch):
    st, chunk, codes, ffts = chip_smoke.make_case(cfg, n_ch, 2 *
                                                  cfg.blocks_per_step,
                                                  seed=5, device=cuda)
    for step in (0, 1):
        chip_smoke.check_wipeoff(cfg, st, chunk, step, codes, ffts)


@pytest.mark.parametrize("cfg,n_ch", [(SMALL, 2), (PRODUCT, 11)],
                         ids=["small", "product"])
def test_cheap_kernel_matches_plain(cuda, cfg, n_ch):
    st, chunk, codes, ffts = chip_smoke.make_case(cfg, n_ch, 2 *
                                                  cfg.blocks_per_step,
                                                  seed=5, device=cuda)
    res = chip_smoke.check_cheap_chain(cfg, st, chunk, codes, ffts)
    assert res["edges"] > 0


SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(256, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(256, seed=12))]


def _small_stream():
    """tests/test_torch_receiver.py's 2-satellite stream and config."""
    cfg = SMALL.replace(max_sat=3)
    return cfg, synth_stream(cfg, SATS, 1 + 2 * cfg.no_sec + 42,
                             noise_std=0.2, seed=9)


def _run_recording(rx, blocks):
    """rx.run over blocks; returns each chunk's tracking outputs (numpy)."""
    from gps_sdr_tpu_torch.ops.tracking import outs_to_numpy

    outs = []
    dispatch = rx._dispatch_chunk

    def recording(chunk):
        o, stream0 = dispatch(chunk)
        outs.append(outs_to_numpy(o))
        return o, stream0

    rx._dispatch_chunk = recording
    list(rx.run(iter(blocks)))
    return outs


def test_receiver_card_matches_cpu_on_converged_channels(cuda):
    """The slice on the card (kernels, cuFFT) against the slice on the
    CPU (plain versions, pocketfft).  Exact: the acquired satellites.
    On each channel whose carrier has converged (CPU FRQ within 10 Hz of
    the simulated Doppler by the last chunk), over every block: FRQ atol
    1e-2 Hz and code phase atol 5e-3 samples, as
    tests/test_torch_receiver.py.  A channel still pulling in is left
    out: PRN 5 sits 140-185 Hz from its Doppler here, its means rotate
    through zero within a block, and f32 rounding that differs by a few
    ulps between the two devices flips one of its bit-edge decisions,
    after which its FRQ differs by up to 0.55 Hz."""
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    cfg, blocks = _small_stream()
    gr, pr = Receiver(cfg, device=cuda), Receiver(cfg, device="cpu")
    got, want = _run_recording(gr, blocks), _run_recording(pr, blocks)
    assert [f[1:] for f in gr.found_sats] == [f[1:] for f in pr.found_sats]
    assert len(got) == len(want) == 3
    doppler = {s.prn: s.doppler for s in SATS}
    converged = [slot for slot, prn in enumerate(pr.slots.slot_prn)
                 if prn in doppler
                 and abs(want[-1].freq[-1, slot] - doppler[prn]) < 10.0]
    assert converged
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.freq[:, converged],
                                   w.freq[:, converged], atol=1e-2)
        gc, wc = g.code_phase[:, converged], w.code_phase[:, converged]
        both = (gc >= 0) & (wc >= 0)
        assert both.any()
        np.testing.assert_allclose(gc[both], wc[both], atol=5e-3)


def test_receiver_kernels_match_plain_on_card(cuda, monkeypatch):
    """The slice on the card with its kernels against the slice on the
    card with the kernels' plain versions (same cuFFT correlation, so
    only the kernels differ); tolerances as tests/test_torch_receiver.py.
    """
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    cfg, blocks = _small_stream()
    with monkeypatch.context() as m:
        m.setattr(hopper_wipeoff, "mix_wipeoff",
                  hopper_wipeoff.mix_wipeoff_plain)
        m.setattr(hopper_cheap, "cheap_scan", hopper_cheap.cheap_scan_plain)
        pr = Receiver(cfg, device=cuda)
        want = list(pr.run(iter(blocks)))
    hopper_wipeoff.mix_wipeoff.launches = 0
    hopper_cheap.cheap_scan.launches = 0
    gr = Receiver(cfg, device=cuda)
    got = list(gr.run(iter(blocks)))
    assert hopper_wipeoff.mix_wipeoff.launches == gr.status.k_steps > 0
    assert hopper_cheap.cheap_scan.launches == gr.status.k_steps
    assert [f[1:] for f in gr.found_sats] == [f[1:] for f in pr.found_sats]
    for ge, pe in zip(got, want):
        assert [sorted(f) for f in ge.frames] == \
            [sorted(f) for f in pe.frames]
        for gf, pf in zip(ge.frames, pe.frames):
            np.testing.assert_allclose(gf["AMP"], pf["AMP"], rtol=1e-3)
            np.testing.assert_allclose(gf["FRQ"], pf["FRQ"], atol=1e-2)
        assert sorted(ge.code_phases) == sorted(pe.code_phases)
        for prn in pe.code_phases:
            gs, gv = cp_arrays(ge.code_phases[prn])
            ps, pv = cp_arrays(pe.code_phases[prn])
            np.testing.assert_array_equal(gs, ps)
            np.testing.assert_allclose(gv, pv, atol=5e-3)
    for slot, pd in pr.decoders.items():
        np.testing.assert_array_equal(gr.decoders[slot].bits, pd.bits)
