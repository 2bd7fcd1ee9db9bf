"""Packed 8-bit IQ -> complex64 where the samples are tracked.

The capture format (runtime/sources.py) packs a sample as one uint16
word, 256*Q + I, and each byte v stands for v/127.5 - 1, evaluated in
double and rounded once to float32: a table of 256 levels (LEVELS, the
values of unpack_iq_numpy and csrc/ingest.cpp).  The host-fed receiver
(runtime/receiver.py) uploads a chunk's words as they are, 2 bytes a
sample against complex64's 8, and unpacks them on the device here, so
tracking reads the same complex64 chunk as the host unpack gave, bit for
bit.

A CUDA tensor launches the hand-written kernel csrc/unpack.cu (a pair
of words a thread, the table in shared memory, coalesced 16-byte
stores); a CPU tensor takes the plain twin below, a gather from the same
table.  The words come as uint16 or as their int16 view (what a pinned
staging buffer holds), of any shape; the result is complex64 of that
shape on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from gps_sdr_tpu_torch.ops import _build

# byte v -> v/127.5 - 1 in double, rounded once to float32
LEVELS = (np.arange(256) / 127.5 - 1.0).astype(np.float32)

PACKED_DTYPES = (torch.uint16, torch.int16)


def unpack_iq8_plain(words: torch.Tensor) -> torch.Tensor:
    """The kernel's twin: each word's low byte (I) and high byte (Q)
    looked up in LEVELS."""
    lut = torch.from_numpy(LEVELS).to(words.device)
    v = _as_int16(words).to(torch.int32)
    return torch.complex(lut[(v & 0xFF).long()], lut[((v >> 8) & 0xFF).long()])


def unpack_iq8(words: torch.Tensor) -> torch.Tensor:
    """Packed words (uint16 or int16, any shape) -> complex64 of the
    same shape on their device."""
    w = _as_int16(words)
    if w.device.type == "cpu":
        return unpack_iq8_plain(w)
    if w.device.type != "cuda":
        raise ValueError(f"unpack kernel: no path for {w.device}")
    w = w.contiguous()
    if w.data_ptr() % 4:                  # a view one word into its storage
        w = w.clone()
    out = torch.empty(w.shape, dtype=torch.complex64, device=w.device)
    if w.numel():
        _build.launch("unpack", _build.UnpackArgs(w.data_ptr(),
                                                  out.data_ptr(), w.numel()),
                      w.device)
        unpack_iq8.launches += 1
    return out


unpack_iq8.launches = 0


def _as_int16(words: torch.Tensor) -> torch.Tensor:
    if words.dtype not in PACKED_DTYPES:
        raise ValueError(f"packed IQ words must be uint16 or int16, got "
                         f"{words.dtype}")
    return words.view(torch.int16)
