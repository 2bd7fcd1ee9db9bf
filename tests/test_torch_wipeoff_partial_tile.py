"""Both wipeoff kernels at code periods off the 128-column tile grid:
cs 2000, 2400 and 2500 (2.0, 2.4 and 2.5 MS/s; 2400 = 18 x 128 + 96),
beside cs 2048 on the grid, against tests/plain_wipeoff.py (float64,
written apart from the kernels and from ops/hopper_wipeoff.py).

The cases: 12 channels a stream, one stream reading one chunk or three
streams reading one chunk each, K=2 on the CPU and K=8 on the card, the
second K-step of the chunk; wipeoff delays 0, 1, 37, 127 and 128 (the
first tile and its edge), both sides of the last tile's first column,
inside it and cs - 1 (a partial tile where cs is off the grid).  The
signal: four satellites at amplitude 0.2 in complex noise of std 0.5,
so most channels are noise-led, where the sums are least forgiving.

  (a) on the CPU, the mirrors of the kernels' arithmetic: the plain
      version's (_mix_wipeoff_math), kernel 1's contraction in the
      3xTF32 split (_mix_wipeoff_mxu_math) and kernel 2's order of
      arithmetic (_mix_wipeoff_vpu_math);
  (b) on the card (skips without CUDA), mix_wipeoff and mix_wipeoff_vpu
      at the same shapes and at 32 channels a stream;
  (c) one-pass TF32 (the mirror with rounding="tf32") misses the bound,
      so a kernel built that way cannot pass (b);
  (d) _limits admits the new periods and still refuses what the kernels
      do not take.

The bound, part by part (center, head, seg): max abs error <= 1e-4 of
the reference's largest magnitude, what tests/test_torch_wipeoff*.py,
tests/test_torch_wideband.py (a) and chip_smoke.py check_wipeoff hold
the kernels to against their plain versions.  Against float64 it has
to cover the float32 angles (s * cs * q reaches ~1000 rad at 5 kHz:
~6e-5 rad) and float32 sums of up to 2500 terms.  Run the card cases
with

    python -m pytest tests/test_torch_wipeoff_partial_tile.py -q -m cuda --noconftest
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

import plain_wipeoff
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.ops import cacode, hopper_wipeoff, tracking

torch.set_num_threads(2)

CS = (2000, 2048, 2400, 2500)
N_CH = 12
REL = 1e-4
N_SIG = 4                   # channels 0-3 track the four satellites


def _cfg(cs: int, k: int) -> ReceiverConfig:
    return ReceiverConfig(code_samples=cs, blocks_per_step=k)


def _mxu_tile(cs: int) -> int:
    """Columns of mix_wipeoff's tiles (csrc/wipeoff.cu tile_width): 128
    on the grid; off it a multiple of 8 up to 160 that spreads the
    period over 16 ranks in as few tiles a rank as it can."""
    if cs % hopper_wipeoff.TILE == 0:
        return hopper_wipeoff.TILE
    per_rank = -(-cs // (16 * 160))
    return max(hopper_wipeoff.TILE, -(-cs // (128 * per_rank)) * 8)


def _delays(cs: int) -> list:
    """0, the first tile, its edge, both sides of the last tile's first
    column (partial where cs is off the grid), inside it, cs - 1: for
    128-column tiles (mix_wipeoff_vpu) and mix_wipeoff's own."""
    out = [0, 1, 37, cs - 40, cs - 1]
    for tile in sorted({hopper_wipeoff.TILE, _mxu_tile(cs)}):
        last = (cs - 1) // tile * tile
        out += [tile - 1, tile, last - 1, last, last + 5]
    return sorted(set(out))


@functools.lru_cache(maxsize=None)
def _case(cs: int, k: int, n_streams: int, n_ch: int = N_CH):
    """(cfg, chunk complex64 [T, ngps] or [S, T, ngps], s, snp, phase,
    wipe, codes) on the CPU: a chunk of two K-steps a stream, made from
    a numpy seed."""
    cfg = _cfg(cs, k)
    rng = np.random.default_rng(cs + 10 * k + 1000 * n_streams + n_ch)
    n = 2 * k * cfg.ngps
    t = np.arange(1, n + 1) / cfg.sample_rate
    table = cacode.ca_table(cfg)
    prns = np.arange(1, n_ch + 1)
    sig_freq = rng.uniform(-4500.0, 4500.0, N_SIG)
    sig_delay = rng.integers(0, cs, N_SIG)
    chunks = []
    for _ in range(n_streams):
        x = 0.5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for p, f, d in zip(prns[:N_SIG], sig_freq, sig_delay):
            code = np.roll(table[p], d)[np.arange(n) % cs]
            x += 0.2 * code * np.exp(2j * np.pi * f * t + 1j * rng.uniform(
                0, 2 * np.pi))
        chunks.append(x.astype(np.complex64).reshape(2 * k, cfg.ngps))
    chunk = torch.from_numpy(np.stack(chunks) if n_streams > 1
                             else chunks[0])
    n_all = n_streams * n_ch
    freq = np.concatenate([np.concatenate(
        [sig_freq + rng.uniform(-20.0, 20.0, N_SIG),
         rng.uniform(-5000.0, 5000.0, n_ch - N_SIG)])
        for _ in range(n_streams)])
    s = torch.tensor(2 * math.pi * freq / cfg.sample_rate,
                     dtype=torch.float32)
    snp = torch.remainder(s * cfg.ngps, 2 * math.pi)
    phase = torch.tensor(rng.uniform(0, 2 * math.pi, n_all),
                         dtype=torch.float32)
    vals = _delays(cs)
    wipe = torch.tensor([[vals[(c * k + b) % len(vals)] for b in range(k)]
                         for c in range(n_all)], dtype=torch.int32)
    codes = torch.from_numpy(np.tile(table[prns], (n_streams, 1)))
    return cfg, chunk, s, snp, phase, wipe, codes


def _reference(cfg, chunk, s, snp, phase, wipe, codes, n_streams,
               device="cpu"):
    return plain_wipeoff.wipeoff_streams(
        chunk, 1, cfg.blocks_per_step, codes, s, snp, phase, wipe,
        n_streams, cfg.n_cyc, cfg.corr_avg, device)


def _errors(got, want) -> dict:
    """Max abs error over the reference's largest magnitude, part by
    part."""
    out = {}
    for name, g, w in zip(("center", "head", "seg"), got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        out[name] = float(np.abs(g - w).max() / np.abs(w).max())
    return out


def _within(got, want) -> None:
    errs = _errors(got, want)
    assert all(e <= REL for e in errs.values()), errs


def _mirror(name: str, rounding: str = "3xtf32"):
    """A single-stream mirror as the plain versions' `one` (its K blocks
    taken from the chunk at `step`)."""
    def one(cfg, k, s, snp, phase, wipe, chunk, step, codes):
        blocks = chunk[step * k:(step + 1) * k].reshape(
            k, cfg.n_cyc, cfg.code_samples)
        args = (cfg, k, s, snp, phase, wipe, blocks.real.contiguous(),
                blocks.imag.contiguous(), codes)
        if name == "mxu":
            return hopper_wipeoff._mix_wipeoff_mxu_math(*args, rounding)
        return getattr(hopper_wipeoff, name)(*args)
    return one


def _run_mirror(name, cfg, chunk, s, snp, phase, wipe, codes, n_streams,
                rounding="3xtf32"):
    return hopper_wipeoff._over_streams(
        _mirror(name, rounding), 2, name, cfg, cfg.blocks_per_step, s, snp,
        phase, wipe, chunk, 1, codes, n_streams)


# ---------------------------------------------------------------------------
# (a) the mirrors on the CPU

@pytest.mark.parametrize("n_streams", [1, 3])
@pytest.mark.parametrize("cs", CS)
@pytest.mark.parametrize("mirror", ["_mix_wipeoff_math", "mxu",
                                    "_mix_wipeoff_vpu_math"])
def test_mirror_matches_plain_reference(mirror, cs, n_streams):
    cfg, chunk, s, snp, phase, wipe, codes = _case(cs, 2, n_streams)
    want = _reference(cfg, chunk, s, snp, phase, wipe, codes, n_streams)
    got = _run_mirror(mirror, cfg, chunk, s, snp, phase, wipe, codes,
                      n_streams)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    _within(got, want)


# ---------------------------------------------------------------------------
# (c) one-pass TF32 misses the bound

@pytest.mark.parametrize("cs", CS)
def test_one_pass_tf32_misses_the_bound(cs):
    """The mirror in one TF32 pass fails head or seg on every period:
    the 3xTF32 split is what holds the kernel inside the bound."""
    cfg, chunk, s, snp, phase, wipe, codes = _case(cs, 2, 1)
    want = _reference(cfg, chunk, s, snp, phase, wipe, codes, 1)
    errs = _errors(_run_mirror("mxu", cfg, chunk, s, snp, phase, wipe,
                               codes, 1, "tf32"), want)
    assert max(errs["head"], errs["seg"]) > REL, errs


# ---------------------------------------------------------------------------
# (d) the kernels' domain

def test_limits_admit_periods_off_the_tile_grid():
    for cs in (128, 2000, 2400, 2500, 16380, 16384):
        hopper_wipeoff._limits("wipeoff", _cfg(cs, 8), 12, 0)
    assert hopper_wipeoff.partial_tile(2400)
    assert not hopper_wipeoff.partial_tile(2048)
    for cfg, rule in ((_cfg(2402, 8), "multiple of 4"),
                      (_cfg(16512, 8), "to 16384"),
                      (_cfg(124, 8), "from 128"),
                      (ReceiverConfig(code_samples=2400, n_cyc=12), "n_cyc")):
        with pytest.raises(ValueError, match=rule):
            hopper_wipeoff._limits("wipeoff", cfg, 12, 0)
    with pytest.raises(ValueError, match="channels a stream"):
        hopper_wipeoff._limits("wipeoff_vpu", _cfg(2400, 8), 33, 0)


# ---------------------------------------------------------------------------
# (b) the kernels on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _kernel(vpu: bool, cfg, chunk, s, snp, phase, wipe, codes, n_streams,
            dev):
    on = [t.to(dev) for t in (s, snp, phase, wipe, codes)]
    chunk = chunk.to(dev)
    if vpu:
        chunk = tracking.to_grouped_planar(cfg, chunk)
        fn = hopper_wipeoff.mix_wipeoff_vpu
    else:
        fn = hopper_wipeoff.mix_wipeoff
    out = fn(cfg, cfg.blocks_per_step, *on[:4], chunk, 1, on[4], n_streams)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_streams,n_ch", [(1, 12), (3, 12), (1, 32)])
@pytest.mark.parametrize("cs", CS)
@pytest.mark.parametrize("vpu", [False, True], ids=["wipeoff", "vpu"])
def test_kernel_matches_plain_reference(cuda, vpu, cs, n_streams, n_ch):
    case = _case(cs, 8, n_streams, n_ch)
    want = _reference(*case, n_streams)
    got = _kernel(vpu, *case, n_streams, cuda)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    _within(got, want)
    # a second launch gives the same bits
    again = _kernel(vpu, *case, n_streams, cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if not vpu and n_streams == 1:
        # the one-pass TF32 mirror on the same inputs misses the bound
        errs = _errors(_run_mirror("mxu", *case, n_streams, "tf32"), want)
        assert max(errs["head"], errs["seg"]) > REL, errs
