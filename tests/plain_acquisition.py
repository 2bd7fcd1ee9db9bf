"""A plain acquisition search, written apart from the receiver.

One block is correlated against each PRN's sampled C/A code over a grid
of Doppler bins by FFT circular correlation.  In each bin a PRN's peak
is its largest |corr| over the code phases, and its statistic the
peak's height (peak - mean) / std.  Each PRN takes, among the bins of
its main lobe (those whose peak reaches half its largest over the
grid), the bin of the largest statistic, and there the code phase of
the peak; the statistic is the detection test, and a PRN that passes it
is found only if its peak recurs: in one of the next two windows of the
block (where the block holds them), the |corr| at that bin, at the code
phase or one sample either side, stands more than corr_min stds above
that window's mean.  The conventions are the receiver's: the Doppler is
wiped off by exp(-j 2 pi f t) with t = (1..n) / fs, each of the k
non-coherent windows from phase 0; `n_avg` code periods are averaged
coherently before the FFT; the k windows average |corr|.

It imports torch and numpy only, so it runs on the card as on the CPU;
TF32 is off for the card's matmuls and convolutions while it runs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Search(NamedTuple):
    """Per PRN, in the order of the codes given."""

    bin: np.ndarray        # int64; index into the Doppler grid
    freq: np.ndarray       # float32; that bin's Doppler, Hz
    delay: np.ndarray      # int64; integer code phase of the largest |corr|
    norm_max: np.ndarray   # float32; (peak - mean) / std at that bin
    found: np.ndarray      # bool; norm_max > corr_min and the peak recurs


def search(block, codes, dopplers, sample_rate: float, n_avg: int,
           noncoherent: int = 1, corr_min: float = 8.0,
           device="cpu") -> Search:
    """block: complex[>= noncoherent * n_avg * cs]; codes: real[P, cs]
    (the codes sampled at the block's rate, one period each); dopplers:
    the grid, Hz."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _search(block, codes, dopplers, sample_rate, n_avg,
                       noncoherent, corr_min, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _search(block, codes, dopplers, sample_rate, n_avg, noncoherent,
            corr_min, device) -> Search:
    codes = torch.as_tensor(np.asarray(codes, np.float32), device=device)
    cs = codes.shape[-1]
    n = n_avg * cs
    k = max(1, int(noncoherent))
    x = torch.as_tensor(np.asarray(block, np.complex64)[:k * n],
                        device=device).reshape(k, n)
    f = torch.as_tensor(np.asarray(dopplers, np.float64), device=device)
    t = torch.arange(1, n + 1, dtype=torch.float64, device=device) \
        / sample_rate
    ang = -2.0 * np.pi * f[:, None] * t[None, :]               # [D, n]
    osc = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    code_f = torch.conj(torch.fft.fft(codes.to(torch.complex64)))
    mag = _magnitude(x, osc, code_f, n_avg)                     # [D, P, cs]
    p = codes.shape[0]
    peak, delays = mag.max(dim=-1)                              # [D, P]
    norms = (peak - mag.mean(dim=-1)) / mag.std(dim=-1, correction=0)
    main = peak >= 0.5 * peak.max(dim=0).values
    d_idx = torch.where(main, norms, -np.inf).argmax(dim=0)    # [P]
    cols = torch.arange(p, device=device)
    delay, norm = delays[d_idx, cols], norms[d_idx, cols]
    found = norm > corr_min
    blk = np.asarray(block, np.complex64)
    n_later = min(2, blk.shape[-1] // (k * n) - 1)
    if n_later > 0:
        recurs = torch.zeros_like(found)
        for w in range(1, n_later + 1):
            later = torch.as_tensor(blk[w * k * n:(w + 1) * k * n],
                                    device=device).reshape(k, n)
            for j in range(p):
                m = _magnitude(later, osc[d_idx[j]][None], code_f[j][None],
                               n_avg)[0, 0]                     # [cs]
                near = m[(delay[j] + torch.arange(-1, 2, device=device))
                         % cs]
                if (near.max() - m.mean()) / m.std(correction=0) > corr_min:
                    recurs[j] = True
        found = found & recurs
    d_idx = d_idx.cpu().numpy()
    norm = norm.cpu().numpy().astype(np.float32)
    return Search(bin=d_idx,
                  freq=np.asarray(dopplers, np.float32)[d_idx],
                  delay=delay.cpu().numpy(), norm_max=norm,
                  found=found.cpu().numpy())


def _magnitude(x, osc, code_f, n_avg: int) -> torch.Tensor:
    """|corr| [D, P, cs] of the k windows x[k, n], each mixed by every
    row of osc[D, n], averaged over the windows."""
    k, n = x.shape
    cs = code_f.shape[-1]
    mixed = x[None, :, :] * osc[:, None, :]                     # [D, k, n]
    avg = mixed.reshape(mixed.shape[:2] + (n_avg, cs)).mean(dim=2)
    mag = torch.zeros((osc.shape[0], code_f.shape[0], cs),
                      dtype=torch.float32, device=x.device)
    for w in range(k):
        spec = torch.fft.fft(avg[:, w])                         # [D, cs]
        mag += torch.fft.ifft(spec[:, None, :] * code_f[None]).abs()
    return mag / k


def check(res, block, codes, dopplers, sample_rate: float, n_avg: int,
          noncoherent: int = 1, corr_min: float = 8.0, rtol: float = 1e-4,
          device="cpu") -> Search:
    """Hold an acquisition result of the receiver (found, freq, delay,
    norm_max per PRN, as tensors or arrays, in the codes' order) to
    search(): every PRN's bin and found flag exactly, its delay where
    found (-1 elsewhere), its norm_max to rtol.  Returns the search."""
    want = search(block, codes, dopplers, sample_rate, n_avg, noncoherent,
                  corr_min, device)

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    found = host(res.found) > 0.5
    np.testing.assert_array_equal(host(res.freq), want.freq)
    np.testing.assert_array_equal(found, want.found)
    np.testing.assert_array_equal(host(res.delay).astype(np.int64),
                                  np.where(want.found, want.delay, -1))
    np.testing.assert_allclose(host(res.norm_max), want.norm_max, rtol=rtol)
    return want
