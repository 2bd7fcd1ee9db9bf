"""The fused K-step replayed as CUDA graphs (ops/kstep_graphs.py)
against the same K-steps enqueued one by one.

A sequence of chunks goes through track_chunk_batched_impl and
track_streams_impl twice, once eagerly and once through the graph
cache: a key's first chunk (eager on the side stream, then the
capture), replays, a channel reset with a new codes table, a stream gap
(erase), a chunk of 3 K-steps and a K=1 tail (another family), a return
to the first family, and S = 3 streams, one chunk a stream and shared.
Every ChannelState and ChannelOut leaf must have the same bits.

On the card (marker cuda, both wipeoff layouts, at the small and the
product configuration) the replays are real graphs and the kernels'
launch counters must equal the eager run's; run there with

    python -m pytest tests/test_torch_kstep_graph.py -q -m cuda --noconftest

On the CPU an emulated graph maker (tests/kstep_emulation.py) drives the
cache, the staging and the chained steps through the plain path.  Also
on the CPU: the stream number as an int32 scalar tensor (what a
captured K-step reads) against the int, and the cache's key."""

import functools

import pytest
import torch

import chip_smoke
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.ops import (cacode, corr, hopper_cheap,
                                   hopper_wipeoff, kstep_graphs)
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.utils import profiling
from kstep_emulation import Emulated, emulated

torch.set_num_threads(2)

SMALL = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                       sweep_corr_avg=2, blocks_per_step=4,
                       corr_q_window_sec=2)
PRODUCT = ReceiverConfig(max_sat=12)
# 2.4 MS/s: the wipeoff kernels' last column tile is partial (96 of 128)
RATE24 = PRODUCT.replace(code_samples=2400)
N_STREAMS = 3
# the sequence's graphs: families of 2 and 3 K-steps (one stream), of 2
# (a chunk a stream) and of 2 (shared chunk), each captured at its first
# chunk, which runs eagerly; then 2 + 2 + 3 + 2 and 2 replays
CAPTURES, REPLAYS = 2 + 3 + 2 + 2, 2 + 2 + 3 + 2 + 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _launches() -> tuple:
    return (hopper_wipeoff.mix_wipeoff.launches,
            hopper_wipeoff.mix_wipeoff_vpu.launches,
            hopper_cheap.cheap_scan.launches)


def _sequence(cfg, dev, n_ch: int) -> list:
    """(name, states, outs) of every call of the sequence, in order."""
    k = cfg.blocks_per_step
    st, iq, codes, ffts = chip_smoke.make_case(cfg, n_ch, 14 * k + 4,
                                               seed=5, device=dev)
    st0 = st
    res = []
    pos, sno = 0, 1

    def chunk(name, n, gap=0):
        nonlocal st, pos, sno
        sno += gap
        st, out = ttrk.track_chunk_batched_impl(cfg, st, iq[pos:pos + n],
                                                sno, codes, ffts)
        res.append((name, st, out))
        pos += n
        sno += n

    chunk("first sight", 2 * k)
    chunk("replay", 2 * k)
    # a re-sweep's reset and the new tables Receiver._refresh_code_tables
    # makes
    prn = 17 if 17 not in st.prn.tolist() else 18
    st = ttrk.reset_channel(st, 1, prn, 1234.0, 101, cfg)
    codes, ffts = codes.clone(), ffts.clone()
    codes[1] = torch.tensor(cacode.ca_table(cfg)[prn])
    ffts[1] = torch.tensor(cacode.ca_fft_table(cfg)[prn])
    chunk("reset, new codes, stream gap", 2 * k, gap=5)
    chunk("3 K-steps + K=1 tail", 3 * k + 2)
    chunk("3 K-steps + K=1 tail, replay", 3 * k + 2)
    chunk("first family again", 2 * k)

    sts = ttrk.ChannelState(*(torch.stack([x] * N_STREAMS) for x in st0))
    cds = torch.stack([codes] * N_STREAMS)
    fts = torch.stack([ffts] * N_STREAMS)
    t = 2 * k
    for i in range(2):
        blocks = torch.stack([iq[z * k + i * t:z * k + (i + 1) * t]
                              for z in range(N_STREAMS)])
        sts, out = ttrk.track_streams_impl(cfg, sts, blocks, 1 + i * t,
                                           cds, fts)
        res.append((f"{N_STREAMS} streams, chunk {i}", sts, out))
    sts, out = ttrk.track_streams_impl(cfg, sts, iq[2 * t:3 * t + 2],
                                       1 + 2 * t, cds, fts, shared=True)
    res.append((f"{N_STREAMS} streams, shared chunk + tail", sts, out))
    return res


def _bits(x: torch.Tensor) -> tuple:
    a = x.detach().cpu().numpy()
    return a.dtype.str, a.shape, a.tobytes()


def _assert_same_bits(eager: list, graphs: list) -> None:
    assert [r[0] for r in eager] == [r[0] for r in graphs]
    for (name, st_e, out_e), (_, st_g, out_g) in zip(eager, graphs):
        for tree_e, tree_g in ((st_e, st_g), (out_e, out_g)):
            for field, a, b in zip(tree_e._fields, tree_e, tree_g):
                assert _bits(a) == _bits(b), f"{name}: {field}"


def _eager_and_graphs(monkeypatch, cfg, dev, n_ch, backends):
    """(eager results, graph results, launches of each, the graph run's
    counters)."""
    monkeypatch.setattr(kstep_graphs, "BACKENDS", {})
    l0 = _launches()
    eager = _sequence(cfg, dev, n_ch)
    l1 = _launches()
    monkeypatch.setattr(kstep_graphs, "BACKENDS", backends)
    monkeypatch.setattr(kstep_graphs, "_CACHE",
                        type(kstep_graphs._CACHE)())
    profiling.reset()
    graphs = _sequence(cfg, dev, n_ch)
    l2 = _launches()
    snap = profiling.snapshot()
    counts = dict(snap["counts"], kstep=snap["spans"]["track.kstep"]["count"])
    profiling.reset()
    return (eager, graphs, [b - a for a, b in zip(l0, l1)],
            [b - a for a, b in zip(l1, l2)], counts)


@pytest.mark.parametrize("mxu", [True, False], ids=["wipeoff", "vpu"])
def test_emulated_graphs_give_the_eager_bits(monkeypatch, mxu):
    cfg = SMALL.replace(use_mxu_wipeoff=mxu)
    eager, graphs, _, _, counts = _eager_and_graphs(
        monkeypatch, cfg, torch.device("cpu"), 2, {"cpu": Emulated})
    _assert_same_bits(eager, graphs)
    assert counts["track.graph_captures"] == CAPTURES
    assert counts["track.graph_replays"] == REPLAYS


@pytest.mark.parametrize("cs,partial", [(320, True), (256, False)])
def test_partial_tile_steps_count_eager_and_replayed_steps(monkeypatch, cs,
                                                           partial):
    """track.partial_tile_steps counts every K-step of a period off the
    128-column grid, eager or replayed, as track.kstep counts them (the
    emulated graphs run on the CPU, which the predicate admits here)."""
    monkeypatch.setattr(kstep_graphs, "partial_tile_steps",
                        lambda cfg, chunk: hopper_wipeoff.partial_tile(
                            cfg.code_samples))
    cfg = SMALL.replace(code_samples=cs)
    _, _, _, _, counts = _eager_and_graphs(
        monkeypatch, cfg, torch.device("cpu"), 2, {"cpu": Emulated})
    assert counts["track.graph_replays"] == REPLAYS
    assert counts["kstep"] == CAPTURES + REPLAYS
    assert counts.get("track.partial_tile_steps", 0) == (
        counts["kstep"] if partial else 0)


def test_partial_tile_steps_only_on_the_card():
    chunk = torch.zeros(1)
    assert not kstep_graphs.partial_tile_steps(RATE24, chunk)
    assert not kstep_graphs.partial_tile_steps(PRODUCT, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", [True, False], ids=["wipeoff", "vpu"])
@pytest.mark.parametrize("cfg,n_ch", [(SMALL, 2), (PRODUCT, 12),
                                      (RATE24, 12)],
                         ids=["small", "product", "rate24"])
def test_graphs_give_the_eager_bits_on_the_card(cuda, monkeypatch, cfg,
                                                n_ch, mxu):
    cfg = cfg.replace(use_mxu_wipeoff=mxu)
    eager, graphs, n_eager, n_graphs, counts = _eager_and_graphs(
        monkeypatch, cfg, cuda, n_ch,
        {"cuda": kstep_graphs.CudaGraphs})
    _assert_same_bits(eager, graphs)
    assert n_graphs == n_eager
    assert n_eager[0 if mxu else 1] == n_eager[2] > 0
    assert counts["track.graph_captures"] == CAPTURES
    assert counts["track.graph_replays"] == REPLAYS
    # every K-step of the graph run, eager or replayed, at 2.4 MS/s only
    assert counts.get("track.partial_tile_steps", 0) == (
        counts["kstep"] if hopper_wipeoff.partial_tile(cfg.code_samples)
        else 0)


def _state_at(cfg, prev_stream: int, reset_slot: bool):
    st, chunk, codes, ffts = chip_smoke.make_case(
        cfg, 3, cfg.blocks_per_step, seed=11, device="cpu")
    st = st._replace(prev_stream=torch.full_like(st.prev_stream,
                                                 prev_stream))
    if reset_slot:
        st = ttrk.reset_channel(st, 1, 7, -800.0, 33, cfg)
    return st, chunk, codes, corr.prep_spec(ffts)


@pytest.mark.parametrize("case,prev,sno,erase", [
    ("no gap", 40, 41, False), ("gap", 40, 47, True),
    ("first block after a reset", 0, 1, False)])
def test_scalar_stream_number_gives_the_int_results(case, prev, sno,
                                                    erase):
    """_erased, the prev_stream update and a whole K-step, fed the stream
    number as an int32 scalar tensor and as an int."""
    cfg = SMALL
    st, chunk, codes, spec = _state_at(cfg, prev, case.endswith("reset"))
    tensor = torch.tensor(sno, dtype=torch.int32)
    flag_i, st_i = ttrk._erased(st, sno)
    flag_t, st_t = ttrk._erased(st, tensor)
    assert _bits(flag_i) == _bits(flag_t)
    assert flag_i.tolist() == [erase] * 3
    for a, b in zip(st_i, st_t):
        assert _bits(a) == _bits(b)
    k = cfg.blocks_per_step
    fill_i = ttrk._filled(st.prev_stream, sno + k - 1)
    fill_t = ttrk._filled(st.prev_stream, tensor + k - 1)
    assert _bits(fill_i) == _bits(fill_t)
    assert fill_t.is_contiguous() and fill_t.tolist() == [sno + k - 1] * 3
    res_i = ttrk._kstep(cfg, 1, st, chunk, 0, sno, codes, spec)
    res_t = ttrk._kstep(cfg, 1, st, chunk, 0, tensor, codes, spec)
    for tree_i, tree_t in zip(res_i, res_t):
        for a, b in zip(tree_i, tree_t):
            assert _bits(a) == _bits(b)
    assert res_t[0].prev_stream.tolist() == [sno + k - 1] * 3
    assert res_t[1].erased[:, 0].tolist() == [erase] * 3


def test_graph_key_tells_every_shape_apart():
    cfg = SMALL
    ngps = cfg.ngps
    st = ttrk.init_channel_states(cfg, 3, "cpu")
    chunk = torch.zeros((8, ngps), dtype=torch.complex64)
    key = kstep_graphs.graph_key(cfg, 1, st, chunk)
    # another chunk and state of the same shapes: the same family
    other = ttrk.reset_channel(ttrk.init_channel_states(cfg, 3, "cpu"), 0,
                               5, 100.0, 7, cfg)
    assert kstep_graphs.graph_key(cfg, 1, other, torch.ones_like(chunk)) \
        == key
    assert kstep_graphs.graph_key(ReceiverConfig(**vars(cfg)), 1, st,
                                  chunk.clone()) == key
    planar = torch.zeros((8, 2, cfg.n_cyc, cfg.code_samples))
    apart = {
        "K": kstep_graphs.graph_key(cfg.replace(blocks_per_step=2), 1, st,
                                    chunk),
        "a field the step reads": kstep_graphs.graph_key(
            cfg.replace(corr_min=cfg.corr_min + 0.5), 1, st, chunk),
        "wipeoff kernel": kstep_graphs.graph_key(
            cfg.replace(use_mxu_wipeoff=False), 1, st, chunk),
        "channel count": kstep_graphs.graph_key(
            cfg, 1, ttrk.init_channel_states(cfg, 4, "cpu"), chunk),
        "stream count": kstep_graphs.graph_key(cfg, 3, st, chunk),
        "block count": kstep_graphs.graph_key(
            cfg, 1, st, torch.zeros((12, ngps), dtype=torch.complex64)),
        "grouped planar layout": kstep_graphs.graph_key(cfg, 1, st, planar),
        "a chunk a stream": kstep_graphs.graph_key(
            cfg, 3, st, torch.zeros((3, 8, ngps), dtype=torch.complex64)),
        "dtype": kstep_graphs.graph_key(cfg, 1, st,
                                        chunk.to(torch.complex128)),
        "device": kstep_graphs.graph_key(cfg, 1, st,
                                         torch.empty_like(chunk,
                                                          device="meta")),
    }
    assert len({key, *apart.values()}) == len(apart) + 1, apart


def test_codes_are_staged_only_when_replaced(monkeypatch):
    """A replay copies the codes table in only when the caller's tensor
    is another or was written in place since it was last staged; a
    view of the staged tensor (the serving path's flattened tables)
    counts as the same."""
    emulated(monkeypatch)
    cfg = SMALL
    k = cfg.blocks_per_step
    st, iq, codes, ffts = chip_smoke.make_case(cfg, 2, 5 * k, seed=3,
                                               device="cpu")
    staged = []
    real = kstep_graphs.corr.prep_spec

    def prep(x):
        staged.append(x)
        return real(x)
    monkeypatch.setattr(kstep_graphs.corr, "prep_spec", prep)
    step = functools.partial(ttrk._kstep, cfg, 1)

    def run(codes, ffts, pos):
        return kstep_graphs.run(cfg, 1, step, st, iq[pos:pos + k], 1,
                                1 + pos, codes, ffts)
    run(codes, ffts, 0)                   # first sight: eager, capture
    n = len(staged)
    run(codes, ffts, k)
    run(codes.view(codes.shape), ffts.view(ffts.shape), 2 * k)
    assert len(staged) == n
    ffts[0, 0] += 1                        # written in place
    run(codes, ffts, 3 * k)
    assert len(staged) == n + 1
    run(codes.clone(), ffts, 4 * k)        # another tensor
    assert len(staged) == n + 2
    fam = kstep_graphs._CACHE[kstep_graphs.graph_key(cfg, 1, st, iq[:k])]
    assert torch.equal(fam.spec, real(ffts))


def test_lru_keeps_the_newest_families(monkeypatch):
    emulated(monkeypatch)
    monkeypatch.setattr(kstep_graphs, "MAX_FAMILIES", 2)
    cfg = SMALL
    k = cfg.blocks_per_step
    st, iq, codes, ffts = chip_smoke.make_case(cfg, 2, 3 * k, seed=3,
                                               device="cpu")
    for n in (1, 2, 3, 1):
        ttrk.track_chunk_batched_impl(cfg, st, iq[:n * k], 1, codes, ffts)
    kept = [key[4][0] for key in kstep_graphs._CACHE]
    assert kept == [3 * k, k]


def test_returned_state_is_not_overwritten_by_a_later_replay(monkeypatch):
    """Two callers of one family in turns: each keeps its own state."""
    emulated(monkeypatch)
    cfg = SMALL
    k = cfg.blocks_per_step
    st, iq, codes, ffts = chip_smoke.make_case(cfg, 2, 4 * k, seed=3,
                                               device="cpu")
    a1, _ = ttrk.track_chunk_batched_impl(cfg, st, iq[:k], 1, codes, ffts)
    a2, _ = ttrk.track_chunk_batched_impl(cfg, a1, iq[k:2 * k], 1 + k,
                                          codes, ffts)
    kept = [_bits(x) for x in a2]
    b2, _ = ttrk.track_chunk_batched_impl(cfg, st, iq[2 * k:3 * k], 1,
                                          codes, ffts)
    assert [_bits(x) for x in a2] == kept
    assert any(_bits(x) != _bits(y) for x, y in zip(a2, b2))
    monkeypatch.setattr(kstep_graphs, "BACKENDS", {})
    e1, _ = ttrk.track_chunk_batched_impl(cfg, st, iq[:k], 1, codes, ffts)
    e2, _ = ttrk.track_chunk_batched_impl(cfg, e1, iq[k:2 * k], 1 + k,
                                          codes, ffts)
    assert [_bits(x) for x in e2] == kept
