"""IQ sample sources: file replay, synthetic streaming, live SDR.

Replaces the reference's async stream producers (src/gpsrecv.py:109-186)
and the recorder utility (src/gpsbin.py).  The on-disk format is the
reference's: interleaved 8-bit I/Q packed as uint16 little-endian words
with value = 256*Q + I, normalized to complex64 via v/127.5 - (1+1j)
(gpsrecv.py:168-172), so recorded captures replay bit-identically.

replay_blocks yields the words as the file holds them: the host-fed
receiver uploads them as they are, 2 bytes a sample, and unpacks them on
the device (ops/hopper_unpack.py), and every other consumer of a block
takes the packed layout too (ops/dsp.py as_complex_input, host_iq).  On
the host, the port's copy of csrc/ingest.cpp (runtime/_native.py, built
at first use) unpacks, with the numpy version beside it as the reference
(unpack_iq_numpy): recording, replay_decimated's front end input and the
checks.  replay_decimated runs the port's digital front end
(ops/frontend.py) on `device`.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.utils.profiling import count, span


def unpack_iq(words: np.ndarray) -> np.ndarray:
    """uint16 packed IQ -> normalized complex64, natively
    (csrc/ingest.cpp; bit-identical to unpack_iq_numpy)."""
    from gps_sdr_tpu_torch.runtime._native import unpack_iq as native
    return native(words)


def unpack_iq_numpy(words: np.ndarray) -> np.ndarray:
    """uint16 packed IQ -> normalized complex64, in numpy.

    Per-component v/127.5 - 1 evaluated in double and rounded once to
    f32 (identical to the native LUT in csrc/ingest.cpp; the reference
    computes the same value in float64, gpsrecv.py:170-172)."""
    im, re = np.divmod(words, 256)
    return (np.float32(re / 127.5 - 1.0)
            + 1j * np.float32(im / 127.5 - 1.0)).astype(np.complex64)


def pack_iq(samples: np.ndarray) -> np.ndarray:
    """complex64 in [-1-1j, 1+1j) -> packed uint16 (recording format)."""
    re = np.clip(np.round((samples.real + 1.0) * 127.5), 0, 255)
    im = np.clip(np.round((samples.imag + 1.0) * 127.5), 0, 255)
    return (im.astype(np.uint16) * 256 + re.astype(np.uint16))


_AHEAD = 2   # chunks the reader thread keeps ready ahead of the consumer


def replay_blocks(path: str, cfg: ReceiverConfig,
                  start_stream: int = 0,
                  max_blocks: int | None = None) -> Iterator[np.ndarray]:
    """Stream a recorded capture's blocks as their NGPS packed uint16
    words, 256*Q + I (streamData, gpsrecv.py:153-186; START_STREAM skip
    supported); unpack_iq gives a block's complex64 samples.

    The capture is read ahead of the consumer, as the reference's
    producer does: a reader thread (_read_ahead) reads it a chunk of
    cfg.no_sec blocks at a time into a fresh buffer, with at most
    _AHEAD read chunks waiting, never past max_blocks, and the
    generator hands out each chunk's blocks as views of it; no buffer
    is written after it is handed over, so a block the caller holds
    never changes.  A trailing partial block is dropped; an error of
    the read is raised here after the blocks read before it.  Closing
    or dropping the generator stops the thread, which closes the
    file.

    The source.read span times the consumer's wait for each block (the
    end of the capture too), source.fill the thread's reads; the
    counters source.blocks and source.ready count the blocks handed out
    and those of a chunk that was read before the consumer asked for
    it."""
    ready: queue.Queue = queue.Queue(_AHEAD)
    stop = threading.Event()
    reader = threading.Thread(
        target=_read_ahead, name="replay_blocks", daemon=True,
        args=(path, 2 * cfg.ngps * start_stream, cfg.ngps, cfg.no_sec,
              max_blocks, ready, stop))
    reader.start()
    try:
        blocks, i = (), 0
        while True:
            with span("source.read"):
                if i == len(blocks):
                    try:
                        blocks, waited = ready.get_nowait(), False
                    except queue.Empty:
                        blocks, waited = ready.get(), True
                    if blocks is None:
                        return  # EOF
                    if isinstance(blocks, Exception):
                        raise blocks
                    i = 0
                count("source.blocks")
                if not waited:
                    count("source.ready")
            yield blocks[i]
            i += 1
    finally:
        stop.set()
        while True:  # free a put the thread is blocked in
            try:
                ready.get_nowait()
            except queue.Empty:
                break
        reader.join()


def _read_ahead(path: str, offset: int, ngps: int, per_chunk: int,
                max_blocks: int | None, ready: queue.Queue,
                stop: threading.Event) -> None:
    """replay_blocks' reader thread: the file's whole blocks from byte
    `offset` on, at most max_blocks of them, put on `ready` as
    [n, ngps] arrays of up to per_chunk blocks, then None at the end or
    the exception that stopped the read.  Returns at its next put once
    `stop` is set: the consumer sets it, then empties `ready`, which
    frees a put that was waiting for room."""

    def put(item) -> bool:
        if stop.is_set():
            return False
        ready.put(item)
        return True

    try:
        with open(path, "rb", buffering=0) as f:
            if offset:
                f.seek(offset, os.SEEK_SET)
            left = max_blocks
            while left is None or left > 0:
                n = per_chunk if left is None else min(per_chunk, left)
                buf = np.empty((n, ngps), np.uint16)
                view = memoryview(buf).cast("B")
                got, err = 0, None
                with span("source.fill"):
                    try:
                        while got < len(view):
                            k = f.readinto(view[got:])
                            if not k:
                                break
                            got += k
                    except OSError as e:
                        err = e
                whole = got // (2 * ngps)
                if whole and not put(buf[:whole]):
                    return
                if err is not None:
                    put(err)
                    return
                if whole < n:
                    break  # EOF
                if left is not None:
                    left -= n
    except Exception as e:  # the consumer raises it
        put(e)
        return
    put(None)


def replay_decimated(path: str, cfg: ReceiverConfig, input_rate: float,
                     f_if: float = 0.0, fmt: str = "iq8",
                     start_stream: int = 0,
                     max_blocks: int | None = None,
                     device="cuda") -> Iterator[np.ndarray]:
    """Replay a HIGHER-RATE capture through the digital front end
    (ops/frontend.py, on `device`) into standard ngps-sample blocks.

    input_rate must be an integer multiple of cfg.sample_rate; fmt is
    "iq8" (the reference's packed uint16 IQ) or "real16" (int16 real
    samples, e.g. a real-IF front end: give f_if).  The capture is read
    factor * ngps samples at a time.  start_stream/max_blocks apply to
    the decimated OUTPUT blocks."""
    from gps_sdr_tpu_torch.ops.frontend import frontend_blocks

    factor = round(input_rate / cfg.sample_rate)
    if abs(input_rate - factor * cfg.sample_rate) > 1e-6 or factor < 1:
        raise ValueError(
            f"input_rate {input_rate} is not an integer multiple of "
            f"{cfg.sample_rate}")
    chunk = factor * cfg.ngps

    def raw():
        with open(path, "rb") as f:
            while True:
                if fmt == "iq8":
                    words = np.fromfile(f, dtype=np.uint16, count=chunk)
                    if words.size == 0:
                        return
                    yield unpack_iq(words)
                elif fmt == "real16":
                    raw16 = np.fromfile(f, dtype=np.int16, count=chunk)
                    if raw16.size == 0:
                        return
                    yield raw16.astype(np.float32) / 32768.0
                else:
                    raise ValueError(f"unknown capture format {fmt!r}")

    gen = frontend_blocks(raw(), cfg, factor, f_if=f_if, fs_in=input_rate,
                          device=device)
    n = 0
    for blk in gen:
        if start_stream > 0:
            start_stream -= 1
            continue
        if max_blocks is not None and n >= max_blocks:
            return
        yield blk
        n += 1


def record_blocks(path: str, blocks, append: bool = False) -> int:
    """Write complex64 blocks in the capture format (gpsbin.py's role).
    Returns the number of blocks written."""
    mode = "ab" if append else "wb"
    n = 0
    with open(path, mode) as f:
        for b in blocks:
            pack_iq(np.asarray(b)).tofile(f)
            n += 1
    return n


def synthetic_blocks(cfg: ReceiverConfig, sats, n_blocks: int,
                     noise_std: float = 0.7, seed: int = 0,
                     chunk_blocks: int | None = None) -> Iterator[np.ndarray]:
    """Stream synthetic blocks (generated chunkwise to bound memory)."""
    from gps_sdr_tpu_torch.models.simulator import synth_stream_chunk

    step = chunk_blocks or cfg.no_sec
    done = 0
    while done < n_blocks:
        k = min(step, n_blocks - done)
        chunk = synth_stream_chunk(cfg, sats, first_block=done, n_blocks=k,
                                   noise_std=noise_std, seed=seed)
        for i in range(k):
            yield chunk[i]
        done += k


def live_blocks(cfg: ReceiverConfig, gain_db: float = 50.0,
                bias_tee: bool = True) -> Iterator[np.ndarray]:
    """Live RTL-SDR source (streamLive, gpsrecv.py:109-148).

    Requires the optional pyrtlsdr package + hardware; import is gated so
    the framework runs without it.
    """
    try:
        from rtlsdr import RtlSdr  # type: ignore
    except ImportError as e:  # pragma: no cover - hardware path
        raise RuntimeError(
            "live capture requires the optional 'pyrtlsdr' package and an "
            "RTL-SDR dongle; use replay_blocks/synthetic_blocks instead"
        ) from e
    sdr = RtlSdr()  # pragma: no cover - hardware path
    try:
        sdr.set_bias_tee(bias_tee)
        sdr.sample_rate = cfg.sample_rate
        if cfg.sdr_freq_corr_ppm:
            sdr.freq_correction = cfg.sdr_freq_corr_ppm
        sdr.center_freq = 1575.42e6
        sdr.gain = gain_db
        while True:
            samples = sdr.read_samples(cfg.ngps)
            yield np.asarray(samples, dtype=np.complex64)
    finally:
        sdr.close()
