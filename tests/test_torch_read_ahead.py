"""replay_blocks' read-ahead (gps_sdr_tpu_torch/runtime/sources.py): a
reader thread reads the capture a chunk of cfg.no_sec blocks at a time
while the consumer works, and the generator hands out per-block views.

On the CPU:
  * the words equal per-block np.fromfile of the same file, for
    start_stream 0 and 5 and max_blocks None, 1 and 33, on a capture of
    whole chunks, one whose length is not a multiple of a chunk and one
    that ends in a partial block;
  * max_blocks=1 reads that one block and no byte more;
  * blocks the caller holds stay unchanged while the generator runs two
    chunks further;
  * closing the generator early, or dropping it half read, leaves no
    reader thread alive and the capture's file closed, also when it is
    left at any block while threads switch every microsecond;
  * an error of a read in the thread is raised in the consumer after the
    blocks read before it;
  * source.blocks counts every block handed out and source.ready those of
    a chunk that was read before the consumer asked for it."""

import gc
import io
import os
import sys
import threading

import numpy as np
import pytest

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.runtime import sources
from gps_sdr_tpu_torch.runtime.sources import replay_blocks
from gps_sdr_tpu_torch.utils import profiling

# chunks of 16 blocks of 4096 words
CFG = ReceiverConfig(code_samples=64, n_cyc=64)
T = CFG.no_sec
WAIT_S = 10.0       # bound on any wait of a test


@pytest.fixture(autouse=True)
def _fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


def _capture(tmp_path, n_blocks: float, seed=4) -> str:
    """A capture of n_blocks blocks of random words (a fraction leaves a
    partial block at the end)."""
    n = int(round(n_blocks * CFG.ngps))
    words = np.random.default_rng(seed).integers(0, 1 << 16, n,
                                                 dtype=np.uint16)
    path = tmp_path / "cap.bin"
    words.tofile(path)
    return str(path)


def _fromfile(path, start, max_blocks) -> list:
    """The blocks as per-block np.fromfile reads them."""
    out = []
    with open(path, "rb") as f:
        f.seek(2 * CFG.ngps * start)
        while max_blocks is None or len(out) < max_blocks:
            words = np.fromfile(f, dtype=np.uint16, count=CFG.ngps)
            if words.size != CFG.ngps:
                break
            out.append(words)
    return out


def _readers() -> list:
    return [t for t in threading.enumerate() if t.name == "replay_blocks"]


def _open_paths() -> set:
    fds = "/proc/self/fd"
    out = set()
    for fd in os.listdir(fds):
        try:
            out.add(os.readlink(os.path.join(fds, fd)))
        except OSError:
            pass
    return out


def _close(gen) -> None:
    """gen.close(), failing the test where it does not return."""
    closer = threading.Thread(target=gen.close, daemon=True)
    closer.start()
    closer.join(WAIT_S)
    assert not closer.is_alive(), "the generator's close hangs"


class _Spy(io.FileIO):
    """The capture opened as the reader thread opens it, with each
    readinto call's byte count noted; `hook(call)` runs before a call."""

    def __init__(self, path, calls, hook=None):
        super().__init__(path, "r")
        self.calls, self.hook = calls, hook

    def readinto(self, b):
        if self.hook is not None:
            self.hook(len(self.calls))
        n = super().readinto(b)
        self.calls.append(n)
        return n


def _spy(monkeypatch, hook=None) -> list:
    calls: list = []
    monkeypatch.setattr(sources, "open",
                        lambda path, *a, **k: _Spy(path, calls, hook),
                        raising=False)
    return calls


CAPTURES = {"whole_chunks": 3 * T, "ragged": 2 * T + 7,
            "partial_block": 2 * T + 7.5}


@pytest.mark.parametrize("capture", sorted(CAPTURES))
@pytest.mark.parametrize("max_blocks", [None, 1, 33])
@pytest.mark.parametrize("start", [0, 5])
def test_words_equal_per_block_fromfile(tmp_path, start, max_blocks,
                                        capture):
    path = _capture(tmp_path, CAPTURES[capture])
    want = _fromfile(path, start, max_blocks)
    got = list(replay_blocks(path, CFG, start_stream=start,
                             max_blocks=max_blocks))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.uint16 and g.shape == (CFG.ngps,)
        np.testing.assert_array_equal(g, w)
    assert not _readers()


def _one_block_reads_one_block(tmp_path, monkeypatch):
    path = _capture(tmp_path, 2 * T + 3)
    calls = _spy(monkeypatch)
    got = list(replay_blocks(path, CFG, start_stream=5, max_blocks=1))
    assert len(got) == 1
    np.testing.assert_array_equal(got[0], _fromfile(path, 5, 1)[0])
    assert sum(calls) == 2 * CFG.ngps
    assert profiling.snapshot()["spans"]["source.fill"]["count"] == 1


def _held_blocks_unchanged(tmp_path, monkeypatch):
    path = _capture(tmp_path, 4 * T)
    want = _fromfile(path, 0, None)
    gen = replay_blocks(path, CFG)
    held = [next(gen) for _ in range(T)]
    copies = [b.copy() for b in held]
    rest = [next(gen) for _ in range(2 * T)]
    for b, c, w in zip(held, copies, want):
        np.testing.assert_array_equal(b, c)
        np.testing.assert_array_equal(b, w)
    for b, w in zip(rest, want[T:]):
        np.testing.assert_array_equal(b, w)
    gen.close()


def _leaves_nothing_open(tmp_path, monkeypatch, drop):
    path = _capture(tmp_path, 6 * T)
    gen = replay_blocks(path, CFG)
    for _ in range(T + 3):
        next(gen)
    assert len(_readers()) == 1
    if drop:
        del gen
        gc.collect()
    else:
        _close(gen)
    assert not _readers()
    assert os.path.realpath(path) not in _open_paths()


def _read_error_surfaces(tmp_path, monkeypatch):
    path = _capture(tmp_path, 3 * T)

    def hook(call):
        if call == 1:
            raise OSError(5, "injected read error")

    _spy(monkeypatch, hook)
    gen = replay_blocks(path, CFG)
    got = []
    with pytest.raises(OSError, match="injected read error"):
        for b in gen:
            got.append(b)
    assert len(got) == T
    for g, w in zip(got, _fromfile(path, 0, T)):
        np.testing.assert_array_equal(g, w)
    assert not _readers()
    assert os.path.realpath(path) not in _open_paths()


def _counters_count_the_blocks(tmp_path, monkeypatch):
    """The first chunk's read is held until the consumer has waited for
    it; the consumer asks for the second chunk only after the reader has
    handed it over (its third read has begun): 2 chunks handed out, one
    of them ready."""
    path = _capture(tmp_path, 2 * T + 0.5)
    first, third = threading.Event(), threading.Event()

    def hook(call):
        if call == 0:
            first.wait(WAIT_S)
        elif call == 2:
            third.set()

    _spy(monkeypatch, hook)
    timer = threading.Timer(0.3, first.set)
    timer.start()
    gen = replay_blocks(path, CFG)
    got = [next(gen) for _ in range(T)]
    assert third.wait(WAIT_S)
    got += list(gen)
    timer.join(WAIT_S)
    assert len(got) == 2 * T
    counts = profiling.snapshot()["counts"]
    assert counts["source.blocks"] == 2 * T
    assert counts["source.ready"] == T
    spans = profiling.snapshot()["spans"]
    assert spans["source.read"]["count"] == 2 * T + 1     # and the EOF
    assert spans["source.fill"]["count"] == 3


def _abandoned_anywhere_under_fast_switching(tmp_path, monkeypatch):
    """Generators left at every block of a 4-chunk capture, with the
    interpreter switching threads every microsecond: each hands out the
    file's words up to where it was left and stops its reader."""
    path = _capture(tmp_path, 4 * T)
    want = _fromfile(path, 0, None)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for stop_at in range(0, 4 * T + 1, 3):
            gen = replay_blocks(path, CFG)
            for i, b in zip(range(stop_at), gen):
                np.testing.assert_array_equal(b, want[i])
            _close(gen)
            assert not _readers()
    finally:
        sys.setswitchinterval(old)


PROPERTIES = {
    "max_blocks_1_reads_one_block": _one_block_reads_one_block,
    "held_blocks_unchanged": _held_blocks_unchanged,
    "close_leaves_nothing_open":
        lambda tp, mp: _leaves_nothing_open(tp, mp, drop=False),
    "drop_leaves_nothing_open":
        lambda tp, mp: _leaves_nothing_open(tp, mp, drop=True),
    "read_error_surfaces": _read_error_surfaces,
    "counters_count_the_blocks": _counters_count_the_blocks,
    "abandoned_anywhere_under_fast_switching":
        _abandoned_anywhere_under_fast_switching,
}


@pytest.mark.parametrize("prop", list(PROPERTIES))
def test_read_ahead(tmp_path, monkeypatch, prop):
    PROPERTIES[prop](tmp_path, monkeypatch)
    assert not _readers()
