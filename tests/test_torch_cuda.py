"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  CUDA kernels have no interpret mode, so these tests need an
NVIDIA GPU and skip without one; run them there with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(--noconftest: tests/conftest.py configures JAX, which a machine that
runs only the port need not have.)  The cases and tolerances are
chip_smoke.py's (check_wipeoff for both wipeoff kernels, with crafted
wipe delays, check_cheap_chain and check_cheap_case), here
also at the small test configuration, plus the
slice with the kernels against the slice with their plain versions, and
the slice on the card (run and run_device) against the slice on the
CPU."""

import numpy as np
import pytest
import torch

import chip_smoke
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.utils.cplist import cp_arrays

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
def test_wipeoff_kernel_crafted_delays(cuda, cfg, n_ch):
    """Wipe delays 0, 1, 127, 128 and cs - 1: the head mask and the roll
    on both sides of the kernel's 128-column tile edge."""
    st, chunk, codes, ffts = chip_smoke.make_case(cfg, n_ch,
                                                  cfg.blocks_per_step,
                                                  seed=5, device=cuda)
    chip_smoke.check_wipeoff(cfg, st, chunk, 0, codes, ffts,
                             wipe=chip_smoke.crafted_wipe(cfg, n_ch))


@pytest.mark.parametrize("cfg,n_ch", [(SMALL, 2), (PRODUCT, 11)],
                         ids=["small", "product"])
def test_wipeoff_vpu_kernel_matches_plain(cuda, cfg, n_ch):
    st, chunk, codes, ffts = chip_smoke.make_case(cfg, n_ch, 3 *
                                                  cfg.blocks_per_step,
                                                  seed=5, device=cuda)
    for step in (0, 2):
        chip_smoke.check_wipeoff(cfg, st, chunk, step, codes, ffts,
                                 vpu=True)


@pytest.mark.parametrize("n_ch", [1, 4, 11, 12])
@pytest.mark.parametrize("cfg", [SMALL, PRODUCT], ids=["small", "product"])
def test_wipeoff_vpu_kernel_crafted_delays(cuda, cfg, n_ch):
    """Wipe delays 0, 1, 127, 128 and cs - 1 (the head mask and the roll
    on both sides of the kernel's 128-column tile edge), for 1 to 12
    channels: an odd and an even number of table rounds per thread, and
    one more channel than the product runs."""
    st, chunk, codes, ffts = chip_smoke.make_case(cfg, n_ch,
                                                  cfg.blocks_per_step,
                                                  seed=5, device=cuda)
    chip_smoke.check_wipeoff(cfg, st, chunk, 0, codes, ffts, vpu=True,
                             wipe=chip_smoke.crafted_wipe(cfg, n_ch))


@pytest.mark.parametrize("cfg,n_ch", [(SMALL, 2), (PRODUCT, 11)],
                         ids=["small", "product"])
def test_wipeoff_vpu_kernel_repeats_bit_identical(cuda, cfg, n_ch):
    """Two calls on the same inputs give the same bits: the column
    groups and the cluster's tiles are added in a fixed order, with no
    float atomics."""
    import math

    from gps_sdr_tpu_torch.ops import hopper_wipeoff, tracking

    st, chunk, codes, _ = chip_smoke.make_case(cfg, n_ch,
                                               2 * cfg.blocks_per_step,
                                               seed=5, device=cuda)
    k = cfg.blocks_per_step
    s = 2.0 * math.pi * st.freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, 2.0 * math.pi)
    args = (cfg, k, s, snp, st.phase, chip_smoke.crafted_wipe(cfg, n_ch).to(
        cuda), tracking.to_grouped_planar(cfg, chunk), 1, codes)
    first = hopper_wipeoff.mix_wipeoff_vpu(*args)
    for _ in range(3):
        again = hopper_wipeoff.mix_wipeoff_vpu(*args)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(torch.view_as_real(a).view(torch.int32),
                               torch.view_as_real(b).view(torch.int32))


@pytest.mark.parametrize("cfg,n_ch", [(SMALL, 2), (PRODUCT, 11)],
                         ids=["small", "product"])
def test_cheap_kernel_matches_plain(cuda, cfg, n_ch):
    st, chunk, codes, ffts = chip_smoke.make_case(cfg, n_ch, 2 *
                                                  cfg.blocks_per_step,
                                                  seed=5, device=cuda)
    res = chip_smoke.check_cheap_chain(cfg, st, chunk, codes, ffts)
    assert res["edges"] > 0


@pytest.mark.parametrize("cfg,n_ch", [(SMALL, 4), (PRODUCT, 11)],
                         ids=["small", "product"])
def test_cheap_kernel_crafted_case(cuda, cfg, n_ch):
    """chip_smoke.cheap_case: edges in the last two slots, PLL unwrap
    steps, slot compaction, channels locking inside the step, full
    wrapped rings; the kernel leaves its input state unchanged."""
    chip_smoke.check_cheap_case(cfg, n_ch, 3, cuda)


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


def test_run_device_card_matches_cpu_on_converged_channels(cuda):
    """Receiver.run_device at use_mxu_wipeoff=False on the card
    (wipeoff_vpu and cheap kernels, fused windows, compact transport)
    against the same on the CPU (plain versions), both primed on the
    stream's two satellites.  Exact: the epoch count and frame keys.  On
    channels whose carrier has converged (CPU FRQ within 10 Hz of the
    simulated Doppler in the last epoch): FRQ atol 1e-2 Hz and code
    phases atol 5e-3 samples over every epoch, as above."""
    from gps_sdr_tpu_torch.ops import hopper_wipeoff, tracking
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    cfg, blocks = _small_stream()
    cfg = cfg.replace(use_mxu_wipeoff=False, chunks_per_download=2)
    t, n_chunks = 24, 5
    planar = tracking.to_grouped_planar(
        cfg, torch.from_numpy(blocks[:t * n_chunks]))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        rx = Receiver(cfg, device=dev)
        rx.sweep_all = False
        for s in SATS:
            rx._activate(s.prn, s.doppler, int(s.code_delay))
        rx._refresh_code_tables()
        iq = planar.to(dev)
        hopper_wipeoff.mix_wipeoff_vpu.launches = 0
        runs[dev.type] = list(rx.run_device(lambda f, n: iq[f:f + n],
                                            n_chunks, chunk_blocks=t))
        if dev.type == "cuda":
            assert hopper_wipeoff.mix_wipeoff_vpu.launches \
                == rx.status.k_steps > 0
        assert rx.status.edge_overflows == 0
    got, want = runs["cuda"], runs["cpu"]
    assert len(got) == len(want) == n_chunks
    doppler = {s.prn: s.doppler for s in SATS}
    converged = {f["SAT"] for f in want[-1].frames
                 if abs(f["FRQ"] - doppler[f["SAT"]]) < 10.0}
    assert converged
    for ge, we in zip(got, want):
        assert [sorted(f) for f in ge.frames] == \
            [sorted(f) for f in we.frames]
        for gf, wf in zip(ge.frames, we.frames):
            if wf["SAT"] in converged:
                np.testing.assert_allclose(gf["FRQ"], wf["FRQ"], atol=1e-2)
        for prn in converged:
            gs, gv = cp_arrays(ge.code_phases[prn])
            ws, wv = cp_arrays(we.code_phases[prn])
            both = np.intersect1d(gs, ws)
            assert both.size
            np.testing.assert_allclose(gv[np.isin(gs, both)],
                                       wv[np.isin(ws, both)], atol=5e-3)
