"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  CUDA kernels have no interpret mode, so these tests need an
NVIDIA GPU and skip without one; run them there with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(--noconftest: tests/conftest.py configures JAX, which a machine that
runs only the port need not have.)  The cases and tolerances are
chip_smoke.py's (check_wipeoff for both wipeoff kernels, with crafted
wipe delays, check_cheap_chain and check_cheap_case, and
check_stream_axis for the serving path's stream axis, also with
noise-led channels; check_decimation and check_excision for the front
end; check_repeat_bits and track_bias for the wideband slice), here also
at the small test configuration, plus the
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
    st, chunk, codes, _ = chip_smoke.make_case(cfg, n_ch,
                                               2 * cfg.blocks_per_step,
                                               seed=5, device=cuda)
    chip_smoke.check_repeat_bits(cfg, st, chunk, 1, codes, True,
                                 wipe=chip_smoke.crafted_wipe(cfg, n_ch))


@pytest.mark.parametrize("vpu", [False, True], ids=["wipeoff", "vpu"])
@pytest.mark.parametrize("n_ch", [11, 32])
@pytest.mark.parametrize("cs", [4096, 16384])
def test_wideband_kernels_match_plain(cuda, cs, n_ch, vpu):
    """chip_smoke phase 9a: both wipeoff kernels past one cluster of
    column tiles (cs 4096: 2 tiles a CTA; 16384: 8), at n_cyc 8, corr_avg
    4, K=8, with 11 and 32 channels (two channel groups), against their
    plain versions with phase 2's tolerances, with the predicted and the
    crafted wipe delays (0, 1, 127, 128, 2047, 2048, cs - 1), and a
    repeated launch bit for bit."""
    from gps_sdr_tpu_torch.kernel_profile import wide_config

    cfg = wide_config(PRODUCT, cs // 2048)
    st, chunk, codes, ffts = chip_smoke.make_case(
        cfg, n_ch, 2 * cfg.blocks_per_step, 7 + n_ch, cuda, on_card=True)
    chip_smoke.check_wipeoff(cfg, st, chunk, 1, codes, ffts, vpu=vpu)
    wipe = chip_smoke.crafted_wipe(cfg, n_ch)
    chip_smoke.check_wipeoff(cfg, st, chunk, 0, codes, ffts, vpu=vpu,
                             wipe=wipe)
    chip_smoke.check_repeat_bits(cfg, st, chunk, 1, codes, vpu, wipe=wipe)


@pytest.mark.parametrize("vpu", [False, True], ids=["wipeoff", "vpu"])
@pytest.mark.parametrize("n_cyc", [32, 64])
def test_kernels_at_32_channels_and_long_blocks(cuda, n_cyc, vpu):
    """The largest shared-memory carve both kernels take: 32 channels a
    stream at n_cyc 32 and 64 (cs 2048), against the plain versions."""
    cfg = PRODUCT.replace(n_cyc=n_cyc, max_sat=32)
    st, chunk, codes, ffts = chip_smoke.make_case(
        cfg, 32, 2 * cfg.blocks_per_step, 3, cuda, on_card=True)
    chip_smoke.check_wipeoff(cfg, st, chunk, 1, codes, ffts, vpu=vpu,
                             wipe=chip_smoke.crafted_wipe(cfg, 32))


@pytest.mark.parametrize("case", chip_smoke.BIAS_CASES,
                         ids=["clean", "d05", "d05pi", "d025"])
def test_wideband_bias_bars_through_kernel_2(cuda, case):
    """chip_smoke phase 9b: tests/test_multipath.py's 16.384 MS/s bias
    bars (clean < 4 m, rays < 12 m) through the port's K-fused tracking
    on the card with kernel 2 and cheap."""
    from gps_sdr_tpu_torch.kernel_profile import wide_config
    from gps_sdr_tpu_torch.ops import hopper_wipeoff

    d, amp, ph, bar = case
    cfg = wide_config(PRODUCT.replace(use_mxu_wipeoff=False))
    hopper_wipeoff.mix_wipeoff_vpu.launches = 0
    assert abs(chip_smoke.track_bias(cfg, d, amp, ph, cuda)) < bar
    assert hopper_wipeoff.mix_wipeoff_vpu.launches \
        == chip_smoke.BIAS_BLOCKS // cfg.blocks_per_step


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


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared", "distinct"])
@pytest.mark.parametrize("n_streams", [1, 3, 8])
@pytest.mark.parametrize("cfg", [SMALL, PRODUCT], ids=["small", "product"])
def test_stream_axis_launch_bit_identical(cuda, cfg, n_streams, shared):
    """chip_smoke phase 7a: one launch of each kernel over n_streams
    streams of 11 channels (one shared chunk, or one a stream) gives the
    bits of n_streams single-stream launches, and matches the plain
    versions with the tolerances of phases 2 and 3."""
    chip_smoke.check_stream_axis(cfg, n_streams, shared, 5, cuda)


@pytest.mark.parametrize("n_streams", [3, 8])
@pytest.mark.parametrize("cfg", [SMALL, PRODUCT], ids=["small", "product"])
def test_stream_axis_noise_led_channels(cuda, cfg, n_streams):
    """Replicas of one chunk 3 Hz apart: the far streams' channels are
    led by noise, and the cheap kernel's df ring still matches its plain
    version (chip_smoke phase 7a's noise-led case)."""
    chip_smoke.check_stream_axis(cfg, n_streams, True, 5, cuda,
                                 dopp_step=3.0)


@pytest.mark.parametrize("real_if", [False, True], ids=["complex", "real_if"])
@pytest.mark.parametrize("factor", [4, 8])
def test_frontend_decimation_on_card(cuda, factor, real_if):
    """The front end's conv1d decimation on the card (TF32 off) against
    a float64 numpy reference (atol 2e-6) and against its CPU version
    (4e-6; chip_smoke phase 8a)."""
    chip_smoke.check_decimation(factor, real_if, cuda, n_out=8192)


@pytest.mark.parametrize("cfg", [SMALL, PRODUCT], ids=["small", "product"])
def test_excision_on_card_matches_cpu(cuda, cfg):
    """excise_cw_chunk on the card (cuFFT) against the CPU (pocketfft) on
    blocks with a 1500 Hz, amplitude-100 tone: the same bins nulled but
    for at most 2 a block within 1e-5 of the threshold (chip_smoke
    phase 8a)."""
    res = chip_smoke.check_excision(cfg.replace(cw_excision=12.0),
                                    chip_smoke.jammed_blocks(cfg, 4, 5),
                                    cuda)
    assert res["bins_nulled"] > 0


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


@pytest.mark.parametrize("mxu", [True, False], ids=["wipeoff", "vpu"])
def test_stream_server_card_matches_cpu(cuda, mxu):
    """StreamServer on the card (3 replicas of the stream, fused windows,
    the kernels on the stream axis) against the same server on the CPU
    (plain versions), all primed on the stream's two satellites: one
    launch of each kernel per K-step of a stream, no dropped edge, and
    per stream the epoch count and frame keys exact; on converged
    channels FRQ atol 1e-2 Hz and code phases atol 5e-3 samples, as
    test_run_device_card_matches_cpu_on_converged_channels."""
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff, tracking
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    cfg, blocks = _small_stream()
    cfg = cfg.replace(use_mxu_wipeoff=mxu, chunks_per_download=2)
    t, n_chunks = 24, 5
    planar = tracking.to_grouped_planar(
        cfg, torch.from_numpy(blocks[:t * n_chunks]))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        srv = StreamServer(cfg, 3, device=dev)
        for rx in srv.receivers:
            rx.sweep_all = False
            for s in SATS:
                rx._activate(s.prn, s.doppler, int(s.code_delay))
            rx._refresh_code_tables()
        iq = planar.to(dev)
        kernel = (hopper_wipeoff.mix_wipeoff if mxu
                  else hopper_wipeoff.mix_wipeoff_vpu)
        kernel.launches = hopper_cheap.cheap_scan.launches = 0
        runs[dev.type] = [[] for _ in range(3)]
        for s, epoch in srv.run(lambda f, n: iq[f:f + n], n_chunks, t):
            runs[dev.type][s].append(epoch)
        k_steps = srv.receivers[0].status.k_steps
        if dev.type == "cuda":
            assert kernel.launches == hopper_cheap.cheap_scan.launches \
                == k_steps == n_chunks * t // cfg.blocks_per_step
        assert all(rx.status.edge_overflows == 0 for rx in srv.receivers)
    doppler = {s.prn: s.doppler for s in SATS}
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert len(got) == len(want) == n_chunks
        converged = {f["SAT"] for f in want[-1].frames
                     if abs(f["FRQ"] - doppler[f["SAT"]]) < 10.0}
        assert converged
        for ge, we in zip(got, want):
            assert [sorted(f) for f in ge.frames] == \
                [sorted(f) for f in we.frames]
            for gf, wf in zip(ge.frames, we.frames):
                if wf["SAT"] in converged:
                    np.testing.assert_allclose(gf["FRQ"], wf["FRQ"],
                                               atol=1e-2)
            for prn in converged:
                gs, gv = cp_arrays(ge.code_phases[prn])
                ws, wv = cp_arrays(we.code_phases[prn])
                both = np.intersect1d(gs, ws)
                assert both.size
                np.testing.assert_allclose(gv[np.isin(gs, both)],
                                           wv[np.isin(ws, both)], atol=5e-3)
