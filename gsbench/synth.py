"""Captures from scenarios: 8-bit RTL-SDR IQ, made on the device.

The host evaluates each satellite's light time and SV-clock time
exactly (float64, scenario.sat_states) on a grid of nodes every
NODE_STEP_S seconds and interpolates them (Catmull-Rom) to 1 ms knots,
as the receiver's device synthesizer does with knot_interp_step 0.1.
Each knot interval is linearized into float32 parameters (carrier phase
and rate, chip position and rate, the nav bit before and after the at
most one 20 ms boundary); the device expands them into samples, adds
white Gaussian noise from a torch.Generator seeded from the run's seed
and the capture's index, scales by the traffic's gain (the dongle's AGC)
and quantizes to the RTL-SDR's 8-bit levels.  Every cell therefore sees
the same bytes: the uint16 words of the recording format
(256 * Q + I, the upstream receiver's gpsrecv.py), or their values
v / 127.5 - 1 on the card, complex64 or grouped planar float32.
"""

from __future__ import annotations

import numpy as np
import torch

from gsbench import scenario as sc

NODE_STEP_S = 0.1
# blocks expanded per device pass: bounds the [B, n_cyc, cs] temporaries
# (a fixed number, so the noise of a capture does not depend on it)
PASS_BLOCKS = 128
# the value of each 8-bit level as the recording format is unpacked
# (v / 127.5 - 1, evaluated in double and rounded once to float32)
LEVELS = (np.arange(256) / 127.5 - 1.0).astype(np.float32)


def capture_seed(seed: int, index: int) -> np.random.SeedSequence:
    """The scenario's seed of capture `index` of a run with `seed`."""
    return np.random.SeedSequence([seed % (1 << 64), index])


def noise_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed % (1 << 64), index, 1])
               .generate_state(1, np.uint64)[0])


def _taus(scn, sat, knots: np.ndarray):
    """(tau, tau_sv) at the knots by Catmull-Rom over exact nodes."""
    h = NODE_STEP_S
    m0 = int(np.floor((knots[0] - scn.t_rx0) / h)) - 1
    m1 = int(np.ceil((knots[-1] - scn.t_rx0) / h)) + 2
    nodes = scn.t_rx0 + np.arange(m0, m1 + 1, dtype=np.float64) * h
    tau_n, tsv_n, _ = sc.sat_states(scn, sat, nodes)
    x = (knots - scn.t_rx0) / h - m0
    i = np.clip(np.floor(x).astype(np.int64), 1, len(nodes) - 3)
    u = x - i

    def cr(p):
        p0, p1, p2, p3 = p[i - 1], p[i], p[i + 1], p[i + 2]
        return p1 + 0.5 * u * (p2 - p0 + u * (2 * p0 - 5 * p1 + 4 * p2 - p3
                                              + u * (3 * (p1 - p2) + p3
                                                     - p0)))
    return cr(tau_n), cr(tsv_n)


def interval_params(scn, shape: dict, n_blocks: int) -> np.ndarray:
    """float32[7, n_blocks * n_cyc, n_sats]: per 1 ms interval and
    satellite (phase0, phase rate, chip0, chip rate, bit before, bit
    after, crossing sample) of blocks [0, n_blocks)."""
    cs, n_cyc, fs = shape["code_samples"], shape["n_cyc"], shape["fs"]
    n_iv = n_blocks * n_cyc
    knots = scn.t_rx0 + np.arange(n_iv + 1, dtype=np.float64) * cs / fs
    out = np.empty((7, n_iv, len(scn.sats)), np.float32)
    for si, sat in enumerate(scn.sats):
        tau, tsv = _taus(scn, sat, knots)
        tau_ref = float(sc.sat_states(scn, sat, np.array([scn.t_rx0]))[0][0])
        cyc = sc.L1_FREQ * (tau - tau_ref)
        chip = tsv * (sc.CA_CHIPS * 1000.0)
        b0 = np.floor(tsv[:-1] / sc.BIT_SEC).astype(np.int64)
        b1 = np.floor(tsv[1:] / sc.BIT_SEC).astype(np.int64)
        nav = sat.nav_stream

        def bit(b):
            return nav[np.clip(b - sat.bit0, 0, len(nav) - 1)]

        cross = ((b0 + 1) * sc.BIT_SEC - tsv[:-1]) \
            / np.maximum(np.diff(tsv), 1e-12) * cs
        out[0, :, si] = -2.0 * np.pi * np.mod(cyc[:-1], 1.0)
        out[1, :, si] = -2.0 * np.pi * np.diff(cyc) / cs
        out[2, :, si] = np.mod(chip[:-1], sc.CA_CHIPS)
        out[3, :, si] = np.diff(chip) / cs
        out[4, :, si] = bit(b0)
        out[5, :, si] = bit(b1)
        out[6, :, si] = np.where(b1 > b0, cross, cs + 1.0)
    return out


def expand(params: torch.Tensor, chips: torch.Tensor, amp: torch.Tensor,
           cs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Noise-free (re, im) f32[n_iv, cs] of the intervals in params
    (f32[7, n_iv, n_sats] on the device)."""
    k = torch.arange(cs, dtype=torch.float32, device=params.device)
    n_iv = params.shape[1]
    re = torch.zeros((n_iv, cs), dtype=torch.float32, device=params.device)
    im = torch.zeros_like(re)
    for s in range(params.shape[2]):
        p0, pr, c0, cr, ba, bb, bx = (p[:, s, None] for p in params)
        ang = p0 + pr * k
        idx = torch.remainder(torch.floor(c0 + cr * k).to(torch.int64),
                              sc.CA_CHIPS)
        env = chips[s][idx] * torch.where(k < bx, ba, bb) * amp[s]
        re.addcmul_(env, torch.cos(ang))
        im.addcmul_(env, torch.sin(ang))
    return re, im


def quantize(x: torch.Tensor, gain: float) -> torch.Tensor:
    """The 8-bit level (0..255, int32) of each sample after the gain."""
    return torch.clamp(torch.round((x * gain + 1.0) * 127.5), 0,
                       255).to(torch.int32)


def make_capture(scn, shape: dict, n_blocks: int, noise_std: float,
                 gain: float, nseed: int, layout: str, device):
    """One capture of n_blocks blocks in `layout`: "packed" (numpy
    uint16 [n_blocks * ngps], the recording format), "complex"
    (complex64 [n_blocks, ngps] on `device`) or "planar" (grouped planar
    float32 [n_blocks, 2, n_cyc, cs] on `device`)."""
    cs, n_cyc = shape["code_samples"], shape["n_cyc"]
    params = torch.as_tensor(interval_params(scn, shape, n_blocks),
                             device=device)
    chips = torch.as_tensor(np.stack([sc.ca_chips(s.prn) for s in scn.sats])
                            .astype(np.float32), device=device)
    amp = torch.as_tensor([s.amplitude for s in scn.sats],
                          dtype=torch.float32, device=device)
    levels = torch.as_tensor(LEVELS, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(nseed)
    if layout == "packed":
        out = torch.empty((n_blocks, n_cyc * cs), dtype=torch.int16,
                          device=device)
    elif layout == "complex":
        out = torch.empty((n_blocks, n_cyc * cs), dtype=torch.complex64,
                          device=device)
    else:
        out = torch.empty((n_blocks, 2, n_cyc, cs), dtype=torch.float32,
                          device=device)
    for b0 in range(0, n_blocks, PASS_BLOCKS):
        b1 = min(n_blocks, b0 + PASS_BLOCKS)
        re, im = expand(params[:, b0 * n_cyc:b1 * n_cyc], chips, amp, cs)
        noise = torch.randn((2,) + re.shape, generator=gen,
                            dtype=torch.float32, device=device)
        qre = quantize(re.add_(noise[0], alpha=noise_std), gain)
        qim = quantize(im.add_(noise[1], alpha=noise_std), gain)
        del noise, re, im
        if layout == "packed":
            word = qim * 256 + qre                  # 0..65535
            word -= 65536 * (word >= 32768).to(torch.int32)
            out[b0:b1] = word.to(torch.int16).reshape(b1 - b0, -1)
        elif layout == "complex":
            out[b0:b1] = torch.complex(levels[qre], levels[qim]).reshape(
                b1 - b0, -1)
        else:
            out[b0:b1, 0] = levels[qre].reshape(b1 - b0, n_cyc, cs)
            out[b0:b1, 1] = levels[qim].reshape(b1 - b0, n_cyc, cs)
    if layout == "packed":
        return out.cpu().numpy().view(np.uint16).reshape(-1)
    return out
