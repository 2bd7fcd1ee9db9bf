"""ctypes bindings for the native host-ingest library (csrc/ingest.cpp).

The port's copy of gps_sdr_tpu/runtime/_native.py over its own library,
which nativecore.py builds with g++ at first use (a failed build raises
with the compiler's output).  runtime/sources.py unpacks captures and
runtime/buffer.py make_buffer queues blocks through it; their numpy
versions stay beside them as the reference.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from gps_sdr_tpu_torch.nativecore import load_native_lib

_F32P = ctypes.POINTER(ctypes.c_float)
_U16P = ctypes.POINTER(ctypes.c_uint16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_native_lib("ingest")
    lib.gst_unpack_iq.argtypes = [_U16P, _F32P, ctypes.c_int64]
    lib.gst_pack_iq.argtypes = [_F32P, _U16P, ctypes.c_int64]
    lib.gst_unpack_iq_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _F32P]
    lib.gst_unpack_iq_file.restype = ctypes.c_int64
    lib.gst_ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.gst_ring_create.restype = ctypes.c_void_p
    lib.gst_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.gst_ring_push.argtypes = [ctypes.c_void_p, _F32P]
    lib.gst_ring_pop.argtypes = [ctypes.c_void_p, _F32P]
    lib.gst_ring_pop.restype = ctypes.c_int64
    lib.gst_ring_size.argtypes = [ctypes.c_void_p]
    lib.gst_ring_size.restype = ctypes.c_int64
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _u16ptr(a: np.ndarray):
    return a.ctypes.data_as(_U16P)


def unpack_iq(words: np.ndarray) -> np.ndarray:
    """uint16 packed IQ -> normalized complex64 (native path)."""
    words = np.ascontiguousarray(words, dtype=np.uint16)
    out = np.empty(words.size * 2, dtype=np.float32)
    _lib().gst_unpack_iq(_u16ptr(words), _fptr(out), words.size)
    return out.view(np.complex64).reshape(words.shape)


def pack_iq(samples: np.ndarray) -> np.ndarray:
    """complex64 -> packed uint16 words (native path)."""
    flat = np.ascontiguousarray(samples, dtype=np.complex64)
    pairs = flat.view(np.float32)
    out = np.empty(flat.size, dtype=np.uint16)
    _lib().gst_pack_iq(_fptr(pairs), _u16ptr(out), flat.size)
    return out.reshape(samples.shape)


def unpack_iq_file(path: str, offset_samples: int,
                   n_samples: int) -> np.ndarray | None:
    """Read + unpack one block straight from a capture file; None at
    EOF/short read."""
    out = np.empty(n_samples * 2, dtype=np.float32)
    got = _lib().gst_unpack_iq_file(path.encode(), offset_samples,
                                    n_samples, _fptr(out))
    if got != n_samples:
        return None
    return out.view(np.complex64)


class NativeRing:
    """Lock-free SPSC block ring with drop-oldest + skip accounting
    (the reference's bounded deque, gpsrecv.py:76-104, off the GIL)."""

    def __init__(self, capacity: int, block_samples: int):
        self.block_samples = block_samples
        self._lib = _lib()
        self._h = self._lib.gst_ring_create(capacity, 2 * block_samples)
        if not self._h:
            raise MemoryError("ring allocation failed")

    def push(self, block: np.ndarray) -> None:
        flat = np.ascontiguousarray(block, dtype=np.complex64)
        self._lib.gst_ring_push(self._h, _fptr(flat.view(np.float32)))

    def pop(self) -> tuple[np.ndarray, int] | None:
        """(block, skipped_blocks) or None if empty."""
        out = np.empty(self.block_samples * 2, dtype=np.float32)
        skipped = self._lib.gst_ring_pop(self._h, _fptr(out))
        if skipped < 0:
            return None
        return out.view(np.complex64), int(skipped)

    def __len__(self) -> int:
        return int(self._lib.gst_ring_size(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.gst_ring_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
