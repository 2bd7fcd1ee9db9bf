"""A full sky on the port: the cold sweep's bin (fault B) and the code
period boundary inside a fused K-step (fault A), the counters that watch
them, and their readers in gsbench/metrics.

Fault B: with ten satellites above the noise, their cross-correlation
raises the std of the right Doppler bin, and a bin chosen by the largest
(peak - mean) / std over the whole grid put a satellite on a sidelobe
~400 Hz off; the port ranks only the bins of a PRN's main lobe (those
whose peak reaches half its largest), as tests/plain_acquisition.py's
search does.  Fault A: where a channel's code phase crossed the period
boundary between two blocks, the means assembly read the sliver of a
period on either side of the crossing as a millisecond of its own, with
its own sign: a millisecond too many, and two false bit edges that
slipped the nav stream (gps_sdr_tpu_torch/ops/tracking.py
_means_from_sums).

The recorded cases are captures of gsbench's generator (gsbench/synth.py,
on the CPU: another noise draw than the card's), held to gsbench's
float64 reference (gsbench/reference.py).  The card test at the end runs
the serving path on one seed of the serve32.replay cell; run it with

    python -m pytest tests/test_torch_full_sky.py -q -m cuda --noconftest
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch

import plain_acquisition
from gps_sdr_tpu_torch.config import BIT_MS, ReceiverConfig
from gps_sdr_tpu_torch.models import navmsg
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import acquisition, cacode, tracking
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.runtime.session import Session
from gps_sdr_tpu_torch.utils import profiling
from gsbench import generator, harness, reference, synth
from gsbench import scenario as sc
from gsbench.metrics import acq_found_pct, edge_overflows_per_s

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                       sweep_corr_avg=2, blocks_per_step=4,
                       corr_q_window_sec=2)


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "gsbench", "configs", name + ".json")) as f:
        return json.load(f)


RTL = _config("rtl2048_12ch")
CFG = harness.program_config(RTL)
SHAPE = generator.shape_of(RTL)
N_BLOCKS = 2048                     # a capture of the cells' traffic


def _scenario(seed: int, index: int):
    bs = SHAPE["n_cyc"] * SHAPE["code_samples"] / SHAPE["fs"]
    return sc.make_scenario(synth.capture_seed(seed, index), 10,
                            N_BLOCKS * bs + 6.0)


def _capture_blocks(scn, seed: int, index: int, first: int,
                    last: int) -> torch.Tensor:
    """Blocks [first, last) of the capture gsbench's generator makes for
    (seed, index) on the CPU, complex64: synth.make_capture's loop, which
    draws each pass's noise whole, with the signal expanded only where
    it is kept."""
    cs, n_cyc = SHAPE["code_samples"], SHAPE["n_cyc"]
    params = torch.as_tensor(synth.interval_params(scn, SHAPE, last))
    chips = torch.as_tensor(np.stack([sc.ca_chips(s.prn)
                                      for s in scn.sats]).astype(np.float32))
    amp = torch.tensor([s.amplitude for s in scn.sats], dtype=torch.float32)
    levels = torch.as_tensor(synth.LEVELS)
    gen = torch.Generator()
    gen.manual_seed(synth.noise_seed(seed, index))
    parts = []
    for b0 in range(0, last, synth.PASS_BLOCKS):
        b1 = min(last, b0 + synth.PASS_BLOCKS)
        noise = torch.randn((2, (b1 - b0) * n_cyc, cs), generator=gen)
        lo = max(first, b0)
        if lo >= b1:
            continue
        re, im = synth.expand(params[:, lo * n_cyc:b1 * n_cyc], chips, amp,
                              cs)
        keep = slice((lo - b0) * n_cyc, (b1 - b0) * n_cyc)
        qre = synth.quantize(re.add_(noise[0, keep], alpha=0.5), 0.12)
        qim = synth.quantize(im.add_(noise[1, keep], alpha=0.5), 0.12)
        parts.append(torch.complex(levels[qre], levels[qim]).reshape(
            b1 - lo, -1))
    return torch.cat(parts)


# -- fault B ------------------------------------------------------------


@pytest.mark.parametrize("seed,index", [(8006, 0), (11101, 2)])
def test_recorded_sky_takes_each_satellite_bin(seed, index):
    """Block 0 of the cells' traffic at full width, seeds and captures
    of the recorded fault-B cases: every satellite of the scenario is
    found in the plain search's bin, within 200 Hz of the reference's
    Doppler.  On 11101/2 the whole grid ranked by (peak - mean) / std
    puts PRNs 20 and 22 on sidelobes ~370 Hz off."""
    scn = _scenario(seed, index)
    block = _capture_blocks(scn, seed, index, 0, 1)[0]
    prns = np.asarray(CFG.prns)
    bins = CFG.doppler_bins.astype(np.float32)
    ffts = torch.from_numpy(cacode.ca_fft_table(CFG)[prns])
    res = acquisition.acquire_impl(CFG, block, torch.from_numpy(bins), ffts)
    plain = plain_acquisition.check(
        res, block.numpy(), cacode.ca_table(CFG)[prns], bins,
        CFG.sample_rate, CFG.sweep_corr_avg, CFG.acq_noncoherent,
        CFG.corr_min)
    truth = reference.acquisition(scn, SHAPE)
    found = {int(p): float(f) for p, f, ok in zip(prns, plain.freq,
                                                  plain.found) if ok}
    assert set(found) == set(truth)
    for prn, (dopp, _) in truth.items():
        assert abs(found[prn] - dopp) <= 200.0, (prn, found[prn], dopp)
    norm = acquisition.grid_stats(CFG, block, torch.from_numpy(bins),
                                  ffts)[3]
    whole = dict(zip(prns.tolist(), bins[norm.argmax(dim=0)].tolist()))
    off = {prn for prn, (dopp, _) in truth.items()
           if abs(whole[prn] - dopp) > 200.0}
    assert off == ({20, 22} if seed == 11101 else set())


def _random_sky(seed: int, n_sats: int = 10):
    rng = np.random.default_rng(seed)
    prns = rng.choice(np.arange(2, 33), n_sats, replace=False)
    return [SatSignal(prn=int(p), doppler=float(rng.uniform(-4500, 4500)),
                      code_delay=float(rng.uniform(0, SMALL.code_samples)),
                      amplitude=float(rng.uniform(0.7, 1.2)),
                      nav_bits=random_bits(64, seed=int(p)))
            for p in prns]


@pytest.mark.parametrize("seed", range(6))
def test_random_sky_found_list_is_the_plain_search(seed):
    """Seeded random 10-satellite skies at the small configuration: the
    port's found list is the plain search's, bin for bin and delay for
    delay, and holds every satellite within a bin of its Doppler."""
    sats = _random_sky(seed)
    block = synth_stream(SMALL, sats, 1, noise_std=2.0, seed=seed)[0]
    got = acquisition.acquire_all(SMALL, block, cacode.ca_fft_table(SMALL),
                                  device="cpu")
    prns = list(SMALL.prns)
    plain = plain_acquisition.search(
        block, cacode.ca_table(SMALL)[np.asarray(prns)],
        SMALL.doppler_bins, SMALL.sample_rate, SMALL.sweep_corr_avg,
        SMALL.acq_noncoherent, SMALL.corr_min)
    want = {p: (float(plain.freq[i]), int(plain.delay[i]))
            for i, p in enumerate(prns) if plain.found[i]}
    assert {g[1]: (g[2], g[3]) for g in got} == want
    for s in sats:
        if s.prn in want:
            assert abs(want[s.prn][0] - s.doppler) <= SMALL.step_freq


# -- a noise peak above the threshold -----------------------------------


@pytest.mark.parametrize("seed,index,ghost", [(2147525019, 19, 16),
                                              (2147525020, 30, 31)])
def test_recorded_noise_peak_is_not_a_satellite(seed, index, ghost):
    """Block 0 of two captures of the cells' traffic whose first sweep
    window holds a PRN that is absent from the sky with a peak just over
    corr_min (8.35 and 8.10 stds; on 20/30 PRN 22's cross-correlation
    lifts a noise peak): its peak does not recur in the next windows, so
    the found list is the sky's, and the plain search's."""
    scn = _scenario(seed, index)
    block = _capture_blocks(scn, seed, index, 0, 1)[0]
    prns = np.asarray(CFG.prns)
    bins = torch.from_numpy(CFG.doppler_bins.astype(np.float32))
    ffts = torch.from_numpy(cacode.ca_fft_table(CFG)[prns])
    res = acquisition.acquire_impl(CFG, block, bins, ffts)
    plain_acquisition.check(
        res, block.numpy(), cacode.ca_table(CFG)[prns],
        CFG.doppler_bins.astype(np.float32), CFG.sample_rate,
        CFG.sweep_corr_avg, CFG.acq_noncoherent, CFG.corr_min)
    truth = reference.acquisition(scn, SHAPE)
    found = {int(p) for p, ok in zip(prns, res.found) if ok}
    assert found == set(truth)
    i = prns.tolist().index(ghost)
    assert ghost not in truth and res.norm_max[i] > CFG.corr_min


def test_peak_cancelled_by_a_bit_edge_in_one_window_still_recurs():
    """A satellite whose data bit flips in the middle of the second sweep
    window (the coherent average there cancels its peak) is found from
    the third; a block that ends after the second window loses it."""
    avg = SMALL.sweep_corr_avg
    sat = SatSignal(prn=7, doppler=1200.0, code_delay=77.0,
                    nav_bits=np.array([1, -1], np.int8),
                    bit_offset_ms=BIT_MS - avg - avg // 2)
    block = synth_stream(SMALL, [sat], 1, noise_std=2.0, seed=3)[0]
    ffts = cacode.ca_fft_table(SMALL)
    got = acquisition.acquire_all(SMALL, block, ffts, prns=[7],
                                  device="cpu")
    assert [(g[1], g[2], g[3]) for g in got] == [(7, 1200.0, 77)]
    short = block[:2 * avg * SMALL.code_samples]
    assert acquisition.acquire_all(SMALL, short, ffts, prns=[7],
                                   device="cpu") == []


# -- fault A ------------------------------------------------------------

# blocks [1024, 1728) of the capture: PRN 22's subframes 1 to 3 start at
# blocks ~1120, 1307 and 1495, and its code phase crosses the period
# boundary at ~1388; multiples of 32, so that the K-steps fall where the
# device path's do
WRAP_BLOCKS = (1024, 1728)
WRAP_PRN = 22


def _edge_log(monkeypatch) -> dict:
    """Every edge each nav decoder is fed: {id(decoder): [(ms, st)]}."""
    log: dict = {}
    push = navmsg.NavDecoder.push_chunk

    def record(self, sign0, edge_ms, edge_local, edge_valid, stream_no0,
               erased):
        sel = np.asarray(edge_valid).astype(bool)
        t = stream_no0 + np.arange(sign0.shape[0])
        st = t[:, None] * np.int64(self.ngps) + edge_local
        log.setdefault(id(self), []).extend(
            zip(np.asarray(edge_ms)[sel].tolist(), st[sel].tolist()))
        return push(self, sign0, edge_ms, edge_local, edge_valid,
                    stream_no0, erased)

    monkeypatch.setattr(navmsg.NavDecoder, "push_chunk", record)
    return log


def test_recorded_wrap_keeps_the_bit_grid_and_the_ephemeris(monkeypatch):
    """Seed 2008, capture 0 of the cells' traffic: PRN 22's code phase
    crosses the period boundary at block ~1388.  Blocks 1024 to 1728,
    tracked as the device path tracks them (K-steps on multiples of 8
    from block 0, compact transport) from the bin and delay a sweep would
    hand over:
    every edge stays on the 20 ms grid of the first (the sliver of a
    period at the crossing read as its own millisecond put two false
    edges at its block's start and moved every later edge a millisecond)
    and the satellite's ephemeris decodes."""
    scn = _scenario(2008, 0)
    sat = next(s for s in scn.sats if s.prn == WRAP_PRN)
    first, last = WRAP_BLOCKS
    cp = reference.code_phase(scn, sat, SHAPE, np.arange(first, last))
    assert (np.abs(np.diff(cp)) > SHAPE["code_samples"] / 2).any()
    data = _capture_blocks(scn, 2008, 0, first, last)
    log = _edge_log(monkeypatch)
    sess = Session(CFG, device="cpu")
    rx = sess.receiver
    dopp = float(reference.doppler(scn, sat, SHAPE, [first])[0])
    rx._activate(WRAP_PRN, round(dopp / CFG.step_freq) * CFG.step_freq,
                 int(cp[0]))
    rx._refresh_code_tables()
    rx.sweep_all = False
    before = profiling.snapshot()["counts"].get("track.delay_wraps", 0)
    sess.run_device_source(lambda f, n: data[f:f + n],
                           (last - first) // CFG.no_sec)
    slot = rx.slots.slot_prn.index(WRAP_PRN)
    edges = np.asarray(log[id(rx.decoders[slot])])
    assert len(edges) > 100
    ms, st = edges[:, 0], edges[:, 1]
    assert ((ms - ms[0]) % 20 == 0).all(), ms[(ms - ms[0]) % 20 != 0]
    # the edges are 20 ms of samples apart on the sample clock too
    blocks = st / CFG.ngps + first - 1
    assert blocks.min() < 1380 < 1400 < blocks.max()
    assert sess.evaluator.engines[WRAP_PRN].ephem_ok
    assert profiling.snapshot()["counts"]["track.delay_wraps"] > before


def _wrap_signal(delay0: float) -> SatSignal:
    # -3000 Hz: the code phase grows 0.125 samples a 32 ms block
    return SatSignal(prn=9, doppler=-3000.0, code_delay=delay0,
                     nav_bits=random_bits(200, seed=9))


@pytest.mark.parametrize("mxu", [True, False], ids=["mxu", "vpu"])
def test_wrap_inside_a_kstep_reports_the_edges_of_no_wrap(monkeypatch, mxu):
    """One satellite whose code phase crosses the period boundary inside
    a fused K-step (the wipe delays predicted for the step go cs - 1 to
    0 within it), against the same signal half a period earlier, which
    never crosses: the same edges, a millisecond count apart that stays
    constant, and half a period of samples apart (the first's later);
    track.delay_wraps counts the crossing of the first and none of the
    second.  Both wipeoff layouts."""
    cfg = CFG.replace(use_mxu_wipeoff=mxu, max_sat=1)
    cs, n_blocks = cfg.code_samples, 96
    wipes = []
    predict = tracking.predict_wipe_delays

    def record(cfg_, k, freq, delay0):
        out = predict(cfg_, k, freq, delay0)
        wipes.append(out.numpy().copy())
        return out

    monkeypatch.setattr(tracking, "predict_wipe_delays", record)
    log = _edge_log(monkeypatch)
    runs = []
    for delay0 in (cs - 5.0, cs / 2 - 5.0):
        sat = _wrap_signal(delay0)
        iq = torch.from_numpy(synth_stream(cfg, [sat], n_blocks,
                                           noise_std=0.5, seed=4))
        rx = Receiver(cfg, device="cpu")
        rx._activate(sat.prn, sat.doppler, int(round(delay0)) % cs)
        rx._refresh_code_tables()
        rx.sweep_all = False
        wipes.clear()
        before = profiling.snapshot()["counts"].get("track.delay_wraps", 0)
        list(rx.run_device(lambda f, n: iq[f:f + n], n_blocks // cfg.no_sec))
        wraps = profiling.snapshot()["counts"]["track.delay_wraps"] - before
        steps = np.stack(wipes)[:, 0, :]                  # [steps, K]
        crossed_inside = (np.diff(steps, axis=1) < -cs // 2).any()
        runs.append((np.asarray(log.pop(id(rx.decoders[0]))), wraps,
                     crossed_inside))
    (wrapped, n_wrapped, inside), (plain, n_plain, inside_plain) = runs
    assert inside and not inside_plain
    assert n_wrapped >= 1 and n_plain == 0
    assert len(wrapped) == len(plain) > 10
    d_ms = wrapped[:, 0] - plain[:, 0]
    assert (d_ms == d_ms[0]).all()
    d_st = wrapped[:, 1] - plain[:, 1]
    assert (np.abs(d_st - cs // 2) <= 1).all()


# -- counters and their readers -------------------------------------------


def test_acquisition_counters_count_what_acquire_all_searched_and_found():
    sats = _random_sky(0, 4)
    block = synth_stream(SMALL, sats, 1, noise_std=0.5, seed=1)[0]
    table = cacode.ca_fft_table(SMALL)
    for prns in (None, [s.prn for s in sats] + [30, 31]):
        before = dict(profiling.snapshot()["counts"])
        got = acquisition.acquire_all(SMALL, block, table, prns=prns,
                                      device="cpu")
        after = profiling.snapshot()["counts"]
        searched = len(SMALL.prns) if prns is None else len(prns)
        assert after["acq.prns"] - before.get("acq.prns", 0) == searched
        assert after["acq.found"] - before.get("acq.found", 0) == len(got)
        assert {g[1] for g in got} == {s.prn for s in sats}


def _ctx(shape):
    return types.SimpleNamespace(shape=shape, stats={})


def test_edge_overflows_counter_and_readers_on_a_serving_run(monkeypatch):
    """A tiny serving run whose cold start tracks from ~200 Hz off (a
    600 Hz grid), so that its edge storm overflows the transport cap:
    rx.edge_overflows counts what the receivers' ReceiverStatus
    .edge_overflows count, as it happens; both readers give a number on
    the run's counters and None on an empty snapshot."""
    from gps_sdr_tpu_torch.runtime.serving import StreamServer
    cfg = SMALL.replace(chunks_per_download=2, epoch_per_window=True,
                        min_freq=-4800.0, max_freq=4800.0, step_freq=600.0)
    sats = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                      nav_bits=random_bits(512, seed=5)),
            SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                      nav_bits=random_bits(512, seed=12))]
    iq = torch.from_numpy(synth_stream(cfg, sats, 4 * cfg.no_sec,
                                       noise_std=0.2, seed=9))
    profiling.reset()
    srv = StreamServer(cfg, 2, device="cpu")
    list(srv.run(lambda f, n: iq[f:f + n], 4))
    counts = profiling.snapshot()["counts"]
    dropped = sum(r.status.edge_overflows for r in srv.receivers)
    assert dropped > 0
    assert counts["rx.edge_overflows"] == dropped
    assert counts["rx.blocks"] == 2 * 4 * cfg.no_sec
    assert counts["acq.prns"] >= len(cfg.prns)
    shape = {"code_samples": cfg.code_samples, "n_cyc": cfg.n_cyc,
             "fs": cfg.sample_rate}
    ctx = _ctx(shape)
    signal_s = counts["rx.blocks"] * cfg.block_sec
    assert edge_overflows_per_s.read(ctx) == pytest.approx(dropped
                                                          / signal_s)
    assert acq_found_pct.read(ctx) == pytest.approx(
        100.0 * counts["acq.found"] / counts["acq.prns"])
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "counts": {}})
    assert edge_overflows_per_s.read(ctx) is None
    assert acq_found_pct.read(ctx) is None


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147522022, 2147524112])
def test_serve32_cold_sweep_bins_are_the_plain_search(cuda, seed):
    """Seeds of the serve32.replay cell on the card: each stream's
    capture (its first pass of blocks, which holds block 0 as the cell's
    does), the serving path's own cold sweep over all 32 streams, and
    per found satellite the plain search's bin and delay on the same
    block, on the card; the found list is the sky's, every satellite
    within 200 Hz.  On 2147524112 capture 6 an absent PRN 14 peaks 8.01
    stds over the mean in the first sweep window and does not recur."""
    from gps_sdr_tpu_torch.ops import _build
    from gps_sdr_tpu_torch.runtime.serving import StreamServer
    config = _config("rtl2048_serve32")
    cfg = harness.program_config(config)
    shape = generator.shape_of(config)
    _build.build()
    traffic = {"source": "device", "layout": "planar",
               "captures_per_stream": 1, "blocks": synth.PASS_BLOCKS,
               "satellites": 10, "noise_std": 0.5, "gain": 0.12}
    caps = generator.make(traffic, config, seed, [cuda], None)
    assert len(caps) == config["streams"] == 32
    srv = StreamServer(cfg, len(caps), device=cuda)
    providers = [(lambda f, n, x=c.data: x[f:f + n]) for c in caps]
    list(srv.run(providers, 1))
    prns = np.asarray(cfg.prns)
    codes = cacode.ca_table(cfg)[prns]
    for cap, rx in zip(caps, srv.receivers):
        blk = torch.complex(cap.data[0, 0], cap.data[0, 1]).reshape(-1)
        plain = plain_acquisition.search(
            blk.cpu().numpy(), codes, cfg.doppler_bins, cfg.sample_rate,
            cfg.sweep_corr_avg, cfg.acq_noncoherent, cfg.corr_min,
            device=cuda)
        want = {int(p): (float(plain.freq[i]), int(plain.delay[i]))
                for i, p in enumerate(prns) if plain.found[i]}
        got = {f[1]: (f[2], f[3]) for f in rx.found_sats}
        assert got == want, cap.index
        truth = reference.acquisition(cap.scn, shape)
        assert set(got) == set(truth), cap.index
        for prn, (dopp, _) in truth.items():
            assert abs(got[prn][0] - dopp) <= 200.0, (cap.index, prn)
