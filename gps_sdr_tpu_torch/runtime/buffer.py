"""Bounded block buffer with drop-oldest overflow and skip accounting.

The port's copy of gps_sdr_tpu/runtime/buffer.py.  Mirrors the
reference's producer/consumer deque (src/gpsrecv.py:45-104): on overflow
the whole buffer is cleared and the number of dropped blocks is credited
to a skip counter that travels with the next pulled block, so downstream
tracking can detect the stream gap and reset demodulation state (the
reference's erasePrevData path).
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np


class BlockBuffer:
    def __init__(self, max_blocks: int = 16):
        self.max_blocks = max_blocks
        self._dq: deque = deque()
        self._skipped = 0
        self._lock = threading.Lock()

    def push(self, block: np.ndarray) -> None:
        with self._lock:
            if len(self._dq) >= self.max_blocks:
                self._skipped += len(self._dq)
                self._dq.clear()
            self._dq.append(block)

    def pull(self):
        """Returns (block | None, n_skipped_blocks_before_it)."""
        with self._lock:
            if not self._dq:
                return None, 0
            block = self._dq.popleft()
            skipped, self._skipped = self._skipped, 0
            return block, skipped

    def __len__(self) -> int:
        return len(self._dq)

    @property
    def skipped(self) -> int:
        return self._skipped


class RingBuffer:
    """BlockBuffer's interface over the native lock-free SPSC ring
    (csrc/ingest.cpp NativeRing, off the GIL)."""

    def __init__(self, max_blocks: int, block_samples: int):
        from gps_sdr_tpu_torch.runtime._native import NativeRing

        self.max_blocks = max_blocks
        self._ring = NativeRing(max_blocks, block_samples)

    def push(self, block: np.ndarray) -> None:
        self._ring.push(block)

    def pull(self):
        """Returns (block | None, n_skipped_blocks_before_it)."""
        out = self._ring.pop()
        return (None, 0) if out is None else out

    def __len__(self) -> int:
        return len(self._ring)


def make_buffer(max_blocks: int = 16, block_samples: int | None = None):
    """The native ring when the block size is known, else the Python
    deque.  Unlike the JAX package, a native ring that cannot be built
    raises instead of falling back to the deque."""
    if block_samples is not None:
        return RingBuffer(max_blocks, block_samples)
    return BlockBuffer(max_blocks)
