"""A plain mix and code wipeoff of K blocks, written apart from the kernels.

For block b of one stream's K blocks and channel c, the block's samples
x[q, i] (q the code period of the block, i the sample in the period of
cs samples) are mixed with the channel's oscillator, frozen over the K
blocks:

    mixed[q, i] = x[q, i] * exp(-1j * (phase + snp * b + s * (i + 1)
                                       + s * cs * q))

and the channel's code is rolled by the block's wipeoff delay w as
np.roll rolls it: rolled[i] = code[(i - w) mod cs].  From these:

  - center[b, c]: the mean of mixed over the corr_avg center periods,
    (n_cyc - corr_avg) // 2 on;
  - head[c, b]: the sum of mixed[0, i] * rolled[i] over the head, i < w;
  - seg[c, b, q]: the sum of mixed[q, i] * rolled[i] over the tail of
    period q, i >= w, plus the head of period q + 1 (none after the
    last period).

Everything is computed in float64 from the parameters as given (their
float32 values).  It imports torch and numpy only, so it runs on the
card as on the CPU; TF32 is off for the card's matmuls while it runs.
"""

from __future__ import annotations

import numpy as np
import torch


def wipeoff(blocks, codes, s, snp, phase, wipe, n_cyc: int, corr_avg: int,
            device="cpu"):
    """One stream.  blocks: complex[K, n_cyc * cs]; codes: real[C, cs];
    s, snp, phase: real[C] (rad/sample, per-block phase advance, phase at
    the first sample); wipe: int[C, K] in [0, cs).  Returns numpy
    complex128 (center [K, C, cs], head [C, K], seg [C, K, n_cyc])."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _wipeoff(blocks, codes, s, snp, phase, wipe, n_cyc, corr_avg,
                        device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _wipeoff(blocks, codes, s, snp, phase, wipe, n_cyc, corr_avg, device):
    f64 = torch.float64
    x = torch.as_tensor(_numpy(blocks).astype(np.complex128), device=device)
    k = x.shape[0]
    cs = x.shape[1] // n_cyc
    x = x.reshape(k, n_cyc, cs)
    codes = _numpy(codes).astype(np.float64)
    s, snp, phase = (_numpy(v).astype(np.float64) for v in (s, snp, phase))
    wipe = _numpy(wipe).astype(np.int64)
    n_ch = codes.shape[0]
    first = (n_cyc - corr_avg) // 2
    i = torch.arange(cs, dtype=f64, device=device)
    q = torch.arange(n_cyc, dtype=f64, device=device)
    b = torch.arange(k, dtype=f64, device=device)
    center = np.zeros((k, n_ch, cs), np.complex128)
    head = np.zeros((n_ch, k), np.complex128)
    seg = np.zeros((n_ch, k, n_cyc), np.complex128)
    for c in range(n_ch):
        ang = (phase[c] + snp[c] * b[:, None, None]
               + s[c] * (i + 1.0)[None, None, :]
               + s[c] * cs * q[None, :, None])               # [K, n_cyc, cs]
        mixed = x * torch.exp(-1j * ang)
        center[:, c] = _numpy(mixed[:, first:first + corr_avg].mean(dim=1))
        for bb in range(k):
            w = int(wipe[c, bb])
            rolled = torch.as_tensor(np.roll(codes[c], w), device=device)
            prod = mixed[bb] * rolled                           # [n_cyc, cs]
            lo = _numpy(prod[:, :w].sum(dim=1))
            hi = _numpy(prod[:, w:].sum(dim=1))
            head[c, bb] = lo[0]
            seg[c, bb] = hi + np.append(lo[1:], 0.0)
    return center, head, seg


def wipeoff_streams(chunks, step: int, k: int, codes, s, snp, phase, wipe,
                    n_streams: int, n_cyc: int, corr_avg: int,
                    device="cpu"):
    """K-block step `step` of n_streams streams, laid out as the kernels
    lay out their results: stream z's C channels at z*C on the flattened
    channel axis of every argument and result.  chunks: complex[T, ngps]
    read by every stream, or [S, T, ngps], one a stream.  Returns numpy
    (center [K, S*C, cs], head [S*C, K], seg [S*C, K, n_cyc])."""
    chunks = _numpy(chunks)
    c = _numpy(s).shape[0] // n_streams
    parts = []
    for z in range(n_streams):
        ch = slice(z * c, (z + 1) * c)
        chunk = chunks[z] if chunks.ndim == 3 else chunks
        parts.append(wipeoff(chunk[step * k:(step + 1) * k],
                             _numpy(codes)[ch], _numpy(s)[ch],
                             _numpy(snp)[ch], _numpy(phase)[ch],
                             _numpy(wipe)[ch], n_cyc, corr_avg, device))
    center, head, seg = zip(*parts)
    return (np.concatenate(center, axis=1), np.concatenate(head),
            np.concatenate(seg))
