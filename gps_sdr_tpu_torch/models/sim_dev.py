"""Device-side parametric IQ synthesis, on PyTorch.

Port of gps_sdr_tpu/models/sim_jax.py (JaxSynth), here DeviceSynth:

  sim_jax.py                           here
  -----------------------------------  -----------------------------------
  JaxSynth._origins (host, f64          DeviceSynth._origins, the same
  per-block origins -> f32)             numpy code
  _synth_block / _synth_chunk (jitted   _synth_blocks: torch ops on the
  per-block expansion, lax.map over     synth's device, a few blocks at a
  blocks)                               time
  jax.random noise keyed per block      one torch.Generator per block,
                                        seeded from (seed, absolute block)
  chunk_planar / chunk / block /        the same
  blocks

The numpy simulator (models/simulator.py) is exact but host-bound; for
long streams generation runs on the card with the same signal model in
f32-safe per-block arithmetic: the host carries exact float64 origins
(code position, carrier phase, bit index) per satellite per block, and
the device only sees block-relative values, which fit f32 (65536
samples times the rates stay far inside the f32 mantissa).

The JAX module avoids per-sample gathers (the TPU's slowest primitive)
with two dynamic slices of a tiled code table; that trick is not
ported: the chips and bits are plain index lookups, code[i0 % cs] and
bits[period // 20], which give the same values.  Noise is keyed by the
ABSOLUTE block, so a chunked request equals one long request bit for
bit; torch's normals are not jax.random's, so the two packages agree
only with noise off.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gps_sdr_tpu_torch.config import BIT_MS, ReceiverConfig
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops.cacode import ca_table

MAX_BITS = 2048     # nav bit window uploaded per satellite
# blocks expanded per pass of _synth_blocks (bounds its [B, ngps]
# intermediates; the result does not depend on it)
_EXPAND_BLOCKS = 8


def _synth_blocks(cfg: ReceiverConfig, codes: torch.Tensor,
                  bits: torch.Tensor, amp: torch.Tensor,
                  origins: torch.Tensor) -> torch.Tensor:
    """Noise-free IQ of B blocks for all satellites.

    codes: f32[S, code_samples]; bits: f32[S, n_bits] nav bits (+-1);
    amp: f32[S]; origins: f32[5, B, S] stacked (pos0: code position at
    sample 0 in [0, cs); pos_rate: code position change per sample (~1);
    phase0: carrier phase at sample 0; phase_rate: carrier phase change
    per sample; bit_base: code-period index of pos0's period in the
    bits' time base, times BIT_MS).  Returns grouped planar f32[B, 2,
    n_cyc, cs].  The satellites are summed in a fixed-order loop."""
    pos0, pos_rate, phase0, phase_rate, bit_base = origins
    cs, n = cfg.code_samples, cfg.ngps
    b_n, s_n = pos0.shape
    dev = codes.device
    k = torch.arange(n, dtype=torch.float32, device=dev)
    ki = torch.arange(n, dtype=torch.int64, device=dev)
    re = torch.zeros((b_n, n), dtype=torch.float32, device=dev)
    im = torch.zeros_like(re)
    for s in range(s_n):
        # code index i0(k) = k + floor(drift), drift = p0 + (pr - 1) k,
        # linearly interpolated by the sub-sample phase
        drift = pos0[:, s, None] + (pos_rate[:, s, None] - 1.0) * k
        d = torch.floor(drift)
        frac = drift - d
        di = d.to(torch.int64)
        i0 = ki + di
        c0 = codes[s][torch.remainder(i0, cs)]
        c1 = codes[s][torch.remainder(i0 + 1, cs)]
        cv = c0 * (1.0 - frac) + c1 * frac
        # nav bit of each sample's code period, counted from pos0's
        d0 = di[:, :1]
        period = torch.div(i0 - d0 + torch.remainder(d0, cs), cs,
                           rounding_mode="floor")
        bidx = torch.div(bit_base[:, s, None].to(torch.int64) + period,
                         BIT_MS, rounding_mode="floor")
        bv = bits[s][torch.clamp(bidx, 0, bits.shape[1] - 1)]
        ang = phase0[:, s, None] + phase_rate[:, s, None] * k
        env = amp[s] * bv * cv
        re += env * torch.cos(ang)
        im += env * torch.sin(ang)
    return torch.stack([re, im], dim=1).reshape(b_n, 2, cfg.n_cyc, cs)


@dataclass
class DeviceSynth:
    """Streaming device-side generator for a fixed satellite set
    (models/simulator.py SatSignal), on `device`."""

    cfg: ReceiverConfig
    sats: list            # [SatSignal]
    noise_std: float = 0.7
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        cfg = self.cfg
        self.device = resolve_device(self.device)
        table = ca_table(cfg)
        self._codes = torch.as_tensor(
            np.stack([table[s.prn] for s in self.sats]).astype(np.float32),
            device=self.device)
        # the window grows with the longest provided stream, so long runs
        # never clamp into constant bits
        n_bits = max(MAX_BITS, max(len(s.nav_bits) for s in self.sats))
        bits = np.zeros((len(self.sats), n_bits), np.float32)
        for i, s in enumerate(self.sats):
            m = min(len(s.nav_bits), n_bits)
            bits[i, :m] = s.nav_bits[:m]
            bits[i, m:] = s.nav_bits[-1] if m else 1
        self._bits = torch.as_tensor(bits, device=self.device)
        self._amp = torch.as_tensor(
            np.asarray([s.amplitude for s in self.sats], np.float32),
            device=self.device)

    def _origins(self, blocks: np.ndarray):
        """Exact per-block f64 origins for each satellite (host side)."""
        cfg = self.cfg
        fs = cfg.sample_rate
        n0 = blocks[:, None] * cfg.ngps                      # [T, 1]
        rate = np.array([1.0 - s.delay_rate(cfg) / fs
                         for s in self.sats])                # [S]
        drate = np.array([s.delay_rate(cfg) for s in self.sats])
        delay0 = np.array([s.code_delay for s in self.sats])
        dop = np.array([s.doppler for s in self.sats])
        cph = np.array([s.carrier_phase for s in self.sats])
        boff = np.array([s.bit_offset_ms for s in self.sats])
        p_abs = n0 - (delay0 + drate * n0 / fs)              # [T, S]
        period0 = np.floor(p_abs / cfg.code_samples)
        pos0 = p_abs - period0 * cfg.code_samples
        ph = np.mod(2.0 * np.pi * dop * n0 / fs + cph, 2.0 * np.pi)
        ph_rate = np.broadcast_to(2.0 * np.pi * dop / fs, pos0.shape)
        pos_rate = np.broadcast_to(rate, pos0.shape)
        bit_base = period0 + boff
        return (pos0.astype(np.float32), pos_rate.astype(np.float32),
                ph.astype(np.float32), ph_rate.astype(np.float32),
                bit_base.astype(np.float32))

    def _noise_seed(self, block: int) -> int:
        """Generator seed of absolute block `block`: (seed, block) mixed
        by splitmix64, so that every bit of both reaches the low 32 bits
        the CPU generator keeps."""
        m = (1 << 64) - 1
        z = ((((self.seed & 0xFFFFFFFF) << 32) | (block & 0xFFFFFFFF))
             + 0x9E3779B97F4A7C15) & m
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        return (z ^ (z >> 31)) >> 1

    def chunk_planar(self, first_block: int, n_blocks: int
                     ) -> torch.Tensor:
        """Blocks [first_block, first_block + n_blocks) as grouped planar
        f32[n_blocks, 2, n_cyc, cs] re/im on the synth's device (the
        layout the wipeoff_vpu kernel reads): one upload of the origins,
        the expansion on the device."""
        cfg = self.cfg
        idx = np.arange(first_block, first_block + n_blocks)
        origins = torch.as_tensor(np.stack(self._origins(idx)),
                                  device=self.device)
        out = torch.cat([
            _synth_blocks(cfg, self._codes, self._bits, self._amp,
                          origins[:, i:i + _EXPAND_BLOCKS])
            for i in range(0, n_blocks, _EXPAND_BLOCKS)])
        if self.noise_std > 0:
            gen = torch.Generator(device=self.device)
            shape = (2, cfg.n_cyc, cfg.code_samples)
            for b in range(n_blocks):
                gen.manual_seed(self._noise_seed(first_block + b))
                out[b] += self.noise_std * torch.randn(
                    shape, generator=gen, dtype=torch.float32,
                    device=self.device)
        return out

    def chunk(self, first_block: int, n_blocks: int) -> torch.Tensor:
        """Like chunk_planar but complex64[n_blocks, ngps]."""
        x = self.chunk_planar(first_block, n_blocks)
        return torch.complex(x[:, 0], x[:, 1]).reshape(n_blocks, -1)

    def block(self, b: int) -> torch.Tensor:
        """One block (convenience; prefer chunk())."""
        return self.chunk(b, 1)[0]

    def blocks(self, first: int, count: int):
        for b in range(first, first + count):
            yield self.block(b)
