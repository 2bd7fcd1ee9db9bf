"""The port's spans and counters (gps_sdr_tpu_torch/utils/profiling.py)
and the benchmark readers that read them, on the CPU.

  * nesting and self time on a scripted clock, a span inside a
    generator closed before its yield, threads summed by snapshot();
  * with no profiler running no record_function is opened; under
    torch.profiler the exported trace holds the spans as user_annotation
    events nested by time, and the host totals take nothing from spans
    or counters that overlap the profiler session;
  * a tiny Session.run_source over a capture file records every span the
    readers read: rx.blocks is the blocks tracked (blocks_processed less
    the cold sweep's), the fused track.kstep count is status.k_steps,
    rx.upload_bytes is rx.blocks x ngps x 2 (packed words), source.read
    times every block's wait and the end, source.fill the reader
    thread's reads, source.blocks counts the blocks handed out; each
    reader gives a number from that run and None from an empty snapshot;
  * StreamServer.perf keeps its six stages, each the sum of its
    serve.<stage> span;
  * track.graph_captures and track.graph_replays count where the
    K-steps run as graphs (on the CPU through tests/kstep_emulation.py)
    and not on the plain path, and kstep_graph_share reads them."""

import json
import threading

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.runtime.serving import StreamServer
from gps_sdr_tpu_torch.runtime.session import Session
from gps_sdr_tpu_torch.runtime.sources import pack_iq, replay_blocks
from gps_sdr_tpu_torch.utils import profiling
from gps_sdr_tpu_torch.utils.profiling import count, span
from kstep_emulation import emulated

torch.set_num_threads(2)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2, max_sat=3)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(256, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(256, seed=12))]
# the cold sweep's block, one chunk, and a 6-block tail: 4 fused + 2 K=1
N_BLOCKS = 1 + CFG.no_sec + 6
READERS = ("source_ms_per_s", "upload_gbps", "kstep_enqueue_us",
           "download_wait_ms_per_s", "nav_ms_per_s", "acq_ms_per_sweep",
           "chunk_p95_ms", "loop_self_ms_per_s", "packed_upload_share",
           "source_ready_share")
PERF_KEYS = ("dispatch", "stack", "transfer", "unpack", "consume")


@pytest.fixture(autouse=True)
def _fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def clock(monkeypatch):
    """The facility's clock, stepped by hand: clock.now = t."""
    class Clock:
        now = 0.0
    c = Clock()
    monkeypatch.setattr(profiling, "_pc", lambda: c.now)
    return c


def _spans():
    return profiling.snapshot()["spans"]


def test_nesting_and_self_time(clock):
    with span("outer") as outer:
        clock.now = 1.0
        with span("inner"):
            clock.now = 3.0
        with span("inner"):
            clock.now = 4.5
        clock.now = 6.0
    got = _spans()
    assert outer.seconds == 6.0
    assert got["outer"] == {"count": 1, "total_s": 6.0, "self_s": 2.5,
                            "durations_s": [6.0]}
    assert got["inner"] == {"count": 2, "total_s": 3.5, "self_s": 3.5,
                            "durations_s": [2.0, 1.5]}


def test_ring_keeps_the_last_durations(clock):
    for i in range(profiling.RING + 5):
        with span("s"):
            clock.now += 1.0 + i
    s = _spans()["s"]
    assert s["count"] == profiling.RING + 5
    assert len(s["durations_s"]) == profiling.RING
    assert s["durations_s"][0] == 6.0 and s["durations_s"][-1] == \
        profiling.RING + 5.0


def test_generator_span_closes_before_its_yield(clock):
    def gen():
        for _ in range(3):
            with span("gen"):
                clock.now += 1.0
            yield

    with span("loop"):
        for _ in gen():
            # the consumer runs with only its own span open
            assert [s.name for s in profiling._local.open] == ["loop"]
            with span("consumer"):
                clock.now += 10.0
    got = _spans()
    assert got["gen"]["total_s"] == 3.0 and got["gen"]["count"] == 3
    assert got["consumer"]["self_s"] == got["consumer"]["total_s"] == 30.0
    assert got["loop"]["self_s"] == 0.0


def test_counters_and_threads_are_summed():
    def work():
        for _ in range(50):
            with span("t"):
                count("c", 2)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    work()
    snap = profiling.snapshot()
    assert snap["counts"] == {"c": 500}
    assert snap["spans"]["t"]["count"] == 250
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("a"):
        with span("b"):
            count("n")
    assert set(_spans()) == {"a", "b"}


def test_spans_land_in_the_trace_and_not_in_the_totals(tmp_path):
    with span("straddles"):                 # open before the profiler
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with span("outer"):
                with span("inner"):
                    torch.ones(64).mul(2.0).sum()
                count("n", 3)
        with span("after"):                 # the session has ended
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"}
    assert {"outer", "inner"} <= set(ann) and "straddles" not in ann
    o, i = ann["outer"], ann["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {"after"}
    assert snap["counts"] == {}


def _capture(tmp_path):
    blocks = synth_stream(CFG, SATS, N_BLOCKS, noise_std=0.2, seed=9)
    path = tmp_path / "capture.bin"
    pack_iq(blocks / np.abs(blocks).max()).tofile(path)
    return str(path)


@pytest.fixture
def session_run(tmp_path):
    """A Session over a capture file, from a clean slate of totals."""
    path = _capture(tmp_path)
    profiling.reset()
    sess = Session(CFG, device="cpu")
    sess.run_source(replay_blocks(path, CFG))
    return sess, profiling.snapshot()


def test_session_records_every_span_the_readers_read(session_run):
    sess, snap = session_run
    st = sess.receiver.status
    spans, counts = snap["spans"], snap["counts"]
    assert {"session.open", "session.run", "source.read", "source.fill",
            "rx.chunk", "rx.upload", "track.kstep", "track.block",
            "rx.download", "rx.nav", "acq.sweep",
            "eval.process"} <= set(spans)
    assert st.blocks_processed == N_BLOCKS
    assert counts["rx.blocks"] == st.blocks_processed - 1  # cold sweep's
    assert spans["track.kstep"]["count"] == st.k_steps
    assert spans["track.block"]["count"] == 2
    # a capture's packed words cross as they are: 2 bytes a sample
    assert counts["rx.upload_bytes"] == counts["rx.blocks"] * CFG.ngps * 2
    assert counts["rx.packed_blocks"] == counts["rx.blocks"]
    assert spans["source.read"]["count"] == N_BLOCKS + 1    # and the EOF
    # the reader thread's reads: a chunk, then the tail and the EOF
    assert spans["source.fill"]["count"] == 2
    assert counts["source.blocks"] == N_BLOCKS
    assert 0 <= counts.get("source.ready", 0) <= N_BLOCKS
    assert spans["rx.chunk"]["count"] == 2
    assert spans["eval.process"]["count"] == 2
    assert spans["session.run"]["count"] == 1
    run = spans["session.run"]
    children = sum(spans[k]["total_s"] for k in (
        "source.read", "rx.chunk", "acq.sweep", "eval.process"))
    assert run["self_s"] == pytest.approx(run["total_s"] - children)


def _ctx():
    from gsbench.harness import Context
    shape = {"code_samples": CFG.code_samples, "n_cyc": CFG.n_cyc,
             "fs": CFG.sample_rate}
    return Context(config={}, shape=shape, seconds=1.0, setup_s=0.0,
                   stats={})


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_run_and_none_without_it(session_run, name):
    from gsbench import manifest
    _, snap = session_run
    reader = manifest.reader(name)
    got = reader.read(_ctx())
    assert isinstance(got, float) and np.isfinite(got) and got > 0
    if name == "source_ms_per_s":
        signal_s = snap["counts"]["rx.blocks"] * CFG.block_sec
        assert got == pytest.approx(
            1e3 * snap["spans"]["source.read"]["total_s"] / signal_s)
    profiling.reset()
    assert reader.read(_ctx()) is None


def test_stream_server_perf_is_its_spans():
    cfg = CFG.replace(max_sat=2, use_mxu_wipeoff=False,
                      chunks_per_download=2)
    t = 24
    blocks = synth_stream(cfg, SATS, 5 * t, noise_std=0.2, seed=9)
    iq = ttrk.to_grouped_planar(cfg, torch.from_numpy(blocks))
    srv = StreamServer(cfg, 2, device="cpu")
    # windows of 2 chunks and a tail chunk: every stage runs
    epochs = list(srv.run(lambda f, n: iq[f:f + n], 5, chunk_blocks=t))
    assert len(epochs) == 2 * 5
    assert tuple(srv.perf) == PERF_KEYS
    spans = _spans()
    for k in PERF_KEYS:
        assert srv.perf[k] > 0, k
        assert srv.perf[k] == pytest.approx(spans[f"serve.{k}"]["total_s"])
    # the tail is tracked and packed by one window call too
    assert {s for s in spans if s.startswith("serve.")} == {
        f"serve.{k}" for k in PERF_KEYS}


GRAPH_COUNTERS = {"track.graph_captures", "track.graph_replays"}


def test_graph_counters_only_where_the_graphs_run(tmp_path, monkeypatch):
    """The plain path counts no capture and no replay.  Through the
    graph cache, a session's first chunk of each shape runs eagerly and
    captures a graph a K-step, and a second session of the same shapes
    replays every K-step; each K-step stays one track.kstep span."""
    from gsbench import manifest
    share = manifest.reader("kstep_graph_share")
    path = _capture(tmp_path)
    Session(CFG, device="cpu").run_source(replay_blocks(path, CFG))
    snap = profiling.snapshot()
    assert not GRAPH_COUNTERS & set(snap["counts"])
    assert snap["spans"]["track.kstep"]["count"] > 0
    assert share.read(_ctx()) is None

    emulated(monkeypatch)
    profiling.reset()
    first = Session(CFG, device="cpu")
    first.run_source(replay_blocks(path, CFG))
    k1 = first.receiver.status.k_steps
    counts = profiling.snapshot()["counts"]
    assert counts["track.graph_captures"] == k1 > 0
    assert "track.graph_replays" not in counts
    assert share.read(_ctx()) == 0.0
    second = Session(CFG, device="cpu")
    second.run_source(replay_blocks(path, CFG))
    k2 = second.receiver.status.k_steps
    snap = profiling.snapshot()
    assert snap["counts"]["track.graph_captures"] == k1
    assert snap["counts"]["track.graph_replays"] == k2 == k1
    assert snap["spans"]["track.kstep"]["count"] == k1 + k2
    assert share.read(_ctx()) == pytest.approx(100.0 * k2 / (k1 + k2))
    # all replayed, the second session ends where the eager one did
    for a, b in zip(first.receiver.states, second.receiver.states):
        assert torch.equal(a, b)


def test_partial_tile_share_reads_the_counter(tmp_path, monkeypatch):
    """partial_tile_share is None where no K-step ran a partial tile (a
    period on the 128-column grid, or the CPU), and the counted share of
    the track.kstep spans where they did: here every K-step, eager or
    replayed, with the predicate admitting the CPU's emulated graphs."""
    from gps_sdr_tpu_torch.ops import kstep_graphs
    from gsbench import manifest
    share = manifest.reader("partial_tile_share")
    path = _capture(tmp_path)
    emulated(monkeypatch)
    Session(CFG, device="cpu").run_source(replay_blocks(path, CFG))
    assert "track.partial_tile_steps" not in profiling.snapshot()["counts"]
    assert share.read(_ctx()) is None

    monkeypatch.setattr(kstep_graphs, "partial_tile_steps",
                        lambda cfg, chunk: True)
    emulated(monkeypatch)               # a family keeps what it was made with
    profiling.reset()
    for _ in range(2):                  # a shape's first chunk, then replays
        Session(CFG, device="cpu").run_source(replay_blocks(path, CFG))
    snap = profiling.snapshot()
    assert snap["counts"]["track.graph_replays"] > 0
    assert snap["counts"]["track.partial_tile_steps"] == \
        snap["spans"]["track.kstep"]["count"] > 0
    assert share.read(_ctx()) == 100.0
