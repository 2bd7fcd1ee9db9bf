"""Per-channel code/carrier tracking on PyTorch.

Port of gps_sdr_tpu/ops/tracking.py.  Channels are the leading axis of
every state tensor (the batch axis the JAX package got from vmap is
written out), blocks are consumed by a Python loop over K-block steps,
and the two kernels of the K-fused step live in ops/hopper_wipeoff.py
(mix + code wipeoff) and ops/hopper_cheap.py (means, edges, PLL,
rings).  Each dispatches on the device of its inputs: a CPU tensor runs
the plain PyTorch twin, a CUDA tensor launches the hand-written kernel.

The K-fused step takes a chunk in either layout the JAX module takes
on the device: complex64 [T, ngps] or grouped planar f32[T, 2, n_cyc,
cs] (what models/scenario_dev.py synthesizes).  cfg.use_mxu_wipeoff
picks the wipeoff kernel as in the JAX package: True runs
hopper_wipeoff.mix_wipeoff on a complex64 chunk (a planar chunk is
converted once per chunk), False runs hopper_wipeoff.mix_wipeoff_vpu on
the grouped planar chunk (a complex chunk is converted once per chunk).

The compact transport of the device-resident receiver (pack_outs_compact
and its host inverses) and the window program (track_window_impl) are
ported too; packing runs on the device, unpacking on the host in numpy.

The serving path (runtime/serving.py) tracks S streams at once
(track_streams_impl, track_streams_window_impl).  Where the JAX module
vmaps the chunk program over a stream axis, here the streams' channels
run as one flattened S*C channel axis through the same K-step loop: the
wipeoff kernels take the stream count as their grid's z extent and the
cheap kernel takes S*C channels, so a K-step is one launch of each
whatever S is.

With cfg.cw_excision > 0 each chunk entry point nulls the narrowband
interference of every block first (ops/frontend.py excise_cw_chunk, one
batched FFT a chunk) and tracks the excised chunk, as the JAX module
does; the window functions and the receiver inherit it.

Differences from the JAX module, none of which changes a result:
  * integer state stays integer (ms_time, counters, int8 signs and the
    correlation ring); there is no f32 packing and no ms_time rebase;
  * no f32-pair transport: host chunks upload as complex64;
  * the K=1 code wipeoff rolls the code in the time domain
    (dsp.roll_code) instead of through its FFT.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops import (corr, dsp, frontend, hopper_cheap,
                                   hopper_wipeoff, kstep_graphs)
from gps_sdr_tpu_torch.utils.profiling import span

TWO_PI = 2.0 * math.pi


class ChannelState(NamedTuple):
    """Per-channel tracking state, leading axis = channel slot."""

    prn: torch.Tensor          # i32; 0 = slot empty
    active: torch.Tensor       # bool
    freq: torch.Tensor         # f32, Doppler estimate
    phase: torch.Tensor        # f32, carrier phase accumulator
    delay: torch.Tensor        # i32, integer code phase
    locked: torch.Tensor       # bool
    ms_time: torch.Tensor      # i32, ms since lock
    std_dev: torch.Tensor      # f32 (edge gate uses the previous block's)
    prev_stream: torch.Tensor  # i32
    prev_signal: torch.Tensor  # f32
    sign0: torch.Tensor        # i8; sign of the first mean after lock
    prev_sign: torch.Tensor    # i8; sign after the last accepted edge
    carry_sum: torch.Tensor    # c64; sum of the partial tail segment
    carry_cnt: torch.Tensor    # i32; samples in the tail
    df_buf: torch.Tensor       # f32[C, no_sec]; ring of recent df
    df_cnt: torch.Tensor       # i32
    df_idx: torch.Tensor       # i32; next write slot
    corr_buf: torch.Tensor     # i8[C, corr_hist_len]
    corr_cnt: torch.Tensor     # i32
    corr_idx: torch.Tensor     # i32


class ChannelOut(NamedTuple):
    """Per-block outputs; a tracked chunk stacks them as [T, C, ...]."""

    code_phase: torch.Tensor     # f32; sub-sample code phase, -1 if none
    delay: torch.Tensor          # i32
    norm_max: torch.Tensor       # f32
    amplitude: torch.Tensor      # f32
    corr_q: torch.Tensor         # f32; long-window correlation quality
    corr_l: torch.Tensor         # f32; 1 s correlation quality
    freq: torch.Tensor           # f32
    locked: torch.Tensor         # bool
    erased: torch.Tensor         # bool; stream skip wiped bit continuity
    sweep_request: torch.Tensor  # bool
    sign0: torch.Tensor          # i8
    edge_ms: torch.Tensor        # i32[..., n_cyc+1]
    edge_local: torch.Tensor     # i32[..., n_cyc+1]
    edge_valid: torch.Tensor     # bool[..., n_cyc+1]


class HeavyOut(NamedTuple):
    """Heavy-stage results for one K-block step, leading axis = channel."""

    delay_k: torch.Tensor        # i32[C, k]; measured delay (-1 = miss)
    code_phase_k: torch.Tensor   # f32[C, k]
    norm_max_k: torch.Tensor     # f32[C, k]
    new_delay_k: torch.Tensor    # i32[C, k]; miss -> previous delay
    head_k: torch.Tensor         # c64[C, k]; wipeoff head sums
    seg_sums_k: torch.Tensor     # c64[C, k, n_cyc]
    phase_end: torch.Tensor      # f32[C]; NCO phase after the k blocks
    wipe_delay: torch.Tensor     # i32[C, k]; wipeoff boundary delays


_STATE_DTYPES = {
    "prn": torch.int32, "active": torch.bool, "freq": torch.float32,
    "phase": torch.float32, "delay": torch.int32, "locked": torch.bool,
    "ms_time": torch.int32, "std_dev": torch.float32,
    "prev_stream": torch.int32, "prev_signal": torch.float32,
    "sign0": torch.int8, "prev_sign": torch.int8,
    "carry_sum": torch.complex64, "carry_cnt": torch.int32,
    "df_buf": torch.float32, "df_cnt": torch.int32, "df_idx": torch.int32,
    "corr_buf": torch.int8, "corr_cnt": torch.int32,
    "corr_idx": torch.int32,
}


def init_channel_states(cfg: ReceiverConfig, n_channels: int,
                        device="cuda") -> ChannelState:
    """Fresh state for `n_channels` empty slots on `device`.

    The counters corr_cnt, df_cnt and df_idx start at 1 and the ring
    slot 0 is only reached on wrap-around: the reference's quirk,
    reproduced."""
    dev = resolve_device(device)
    c = n_channels
    fields = {name: torch.zeros(c, dtype=dt, device=dev)
              for name, dt in _STATE_DTYPES.items()}
    fields["std_dev"].fill_(0.005)
    for name in ("df_cnt", "df_idx", "corr_cnt", "corr_idx"):
        fields[name].fill_(1)
    fields["df_buf"] = torch.zeros((c, cfg.no_sec), dtype=torch.float32,
                                   device=dev)
    fields["corr_buf"] = torch.zeros((c, cfg.corr_hist_len),
                                     dtype=torch.int8, device=dev)
    return ChannelState(**fields)


def reset_channel(state: ChannelState, slot: int, prn: int, freq: float,
                  delay: int, cfg: ReceiverConfig,
                  active: bool = True) -> ChannelState:
    """(Re)initialize one channel slot; returns a new state.  The slot's
    stream counter is kept (skip detection continues across resets)."""
    one = init_channel_states(cfg, 1, state.prn.device)._asdict()
    one.update(prn=torch.full_like(one["prn"], prn),
               active=torch.full_like(one["active"], active),
               freq=torch.full_like(one["freq"], freq),
               delay=torch.full_like(one["delay"], delay),
               prev_stream=state.prev_stream[slot:slot + 1])
    fields = {}
    for name, v in state._asdict().items():
        v = v.clone()
        v[slot] = one[name][0]
        fields[name] = v
    return ChannelState(**fields)


def _select(active: torch.Tensor, computed: ChannelState,
            frozen: ChannelState) -> ChannelState:
    """Per slot: computed where active, frozen elsewhere."""
    def pick(c, s):
        return torch.where(active.reshape((-1,) + (1,) * (c.ndim - 1)), c, s)
    return ChannelState(*[pick(c, s) for c, s in zip(computed, frozen)])


# ---------------------------------------------------------------------------


def _segment_sums_rolled(mixed: torch.Tensor, rolled: torch.Tensor,
                         delay: torch.Tensor, cfg: ReceiverConfig):
    """Head sum + per-ms segment sums for boundaries delay + q*cs.

    mixed: c64[..., ngps]; rolled: f32[..., cs] (code already rolled by
    delay); delay: i32[...].  Segment q spans the tail of code period q
    plus the head of period q+1, so two masked row sums give every
    boundary sum.  Returns (head c64[...], seg_sums c64[..., n_cyc])."""
    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    rows = mixed.reshape(mixed.shape[:-1] + (n_cyc, cs)) \
        * rolled[..., None, :]
    in_head = (torch.arange(cs, device=mixed.device)
               < delay[..., None]).to(torch.float32)[..., None, :]
    lo = (rows * in_head).sum(dim=-1)             # cols <  delay
    hi = rows.sum(dim=-1) - lo                    # cols >= delay
    seg = hi + torch.cat([lo[..., 1:], torch.zeros_like(lo[..., :1])],
                         dim=-1)
    return lo[..., 0], seg


def _means_from_sums(head, seg_sums, delay, carry_sum, carry_cnt, cont,
                     cfg: ReceiverConfig):
    """Assemble the fixed n_cyc+1 means layout from (head, seg_sums).

    Slot 0 is the carry-completed mean (valid only if the carry plus
    head hold samples), slots 1..n_cyc the full segments (the last one
    invalid unless delay == 0); valid means are then compacted to the
    front.  All inputs have the channel axis first; carry_cnt < 0 marks
    a channel erased by a stream gap (no carry), and `cont` the channels
    that continue a block of their stream (neither erased nor fresh
    from a reset).

    The boundary delay is a code phase mod cs, so where it crossed the
    period boundary since the last block, slot 0 (carry_cnt + delay
    samples, from the last block's last boundary to this block's first)
    is no longer ~cs long.  Under cs / 2 after a carry (the delay went
    up through cs), the last block's last boundary and this block's
    first are one: slot 0 runs on through segment 0.  Under cs / 2 after
    a block that ended on a boundary (delay 0, no carry), the head is
    the tail of the period that block closed and is dropped.  Over
    3 cs / 2 (the delay went down through 0), slot 0 holds two periods:
    the carry and the head each close one, the head's from delay - cs.
    Either way each code period is one slot, so no sliver of a period
    reads as a millisecond with a sign of its own."""
    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    dev = head.device
    cc = torch.clamp(carry_cnt, min=0)
    cnt0 = cc + delay
    mean0 = (carry_sum + head) / torch.clamp(cnt0, min=1).to(torch.float32)
    tail = cont & (cc == 0) & (2 * delay < cs)
    merged = (cc > 0) & (2 * cnt0 < cs)
    split = 2 * cnt0 > 3 * cs
    v0 = (cnt0 > 0) & ~tail
    k_full = n_cyc - (delay > 0).to(torch.int32)

    means = torch.cat([mean0[:, None], seg_sums / cs], dim=-1)
    q = torch.arange(n_cyc, dtype=torch.int32, device=dev)
    starts = torch.cat([(-cc)[:, None], delay[:, None] + cs * q],
                       dim=-1).to(torch.int32)
    new_carry_sum = torch.where(delay > 0, seg_sums[:, n_cyc - 1],
                                torch.zeros_like(carry_sum))
    new_carry_cnt = torch.where(delay > 0, cs - delay,
                                torch.zeros_like(delay)).to(torch.int32)

    # slot 0 empty, dropped or merged into segment 0: the segments move
    # up one
    up = (~v0 | merged)[:, None]
    means = torch.where(up, torch.roll(means, -1, dims=-1), means)
    starts = torch.where(up, torch.roll(starts, -1, dims=-1), starts)
    at0 = merged[:, None] & (torch.arange(n_cyc + 1, device=dev) == 0)
    first = (carry_sum + head + seg_sums[:, 0]) \
        / (cnt0 + cs).to(torch.float32)
    means = torch.where(at0, first[:, None], means)
    starts = torch.where(at0, (-cc)[:, None], starts)
    # slot 0 split in two: the segments move down one
    halves = torch.stack([
        carry_sum / torch.clamp(cc, min=1).to(torch.float32),
        head / torch.clamp(delay, min=1).to(torch.float32)], dim=-1)
    down = split[:, None]
    means = torch.where(down, torch.cat(
        [halves, means[:, 1:-1]], dim=-1), means)
    starts = torch.where(down, torch.cat(
        [(-cc)[:, None], (delay - cs)[:, None], starts[:, 1:-1]],
        dim=-1), starts)
    n_valid = (k_full + v0.to(torch.int32) - merged.to(torch.int32)
               + split.to(torch.int32)).to(torch.int32)
    mask = torch.arange(n_cyc + 1, device=dev) < n_valid[:, None]
    return means, starts, mask, n_valid, new_carry_sum, new_carry_cnt


def _continues(carry_cnt, corr_cnt):
    """The channels that continue a block of their stream: not erased
    (carry_cnt < 0, _erased) and not fresh from a reset (corr_cnt, which
    a reset sets to 1, counts every block from 2 on)."""
    return (carry_cnt >= 0) & (corr_cnt > 1)


def _sign8(cond: torch.Tensor) -> torch.Tensor:
    """+1 where cond else -1, as int8."""
    return torch.where(cond, 1, -1).to(torch.int8)


def _edge_scan(means, starts, mask, locked, min_edge_amp, sign0,
               prev_sign, prev_signal, ms_time):
    """Bit-edge event detection over the n_cyc+1 slots of one block.

    The prefix form of the JAX module: an edge can only be accepted at a
    candidate slot (sign flip against the previous slot's signal, past
    the amplitude gate), and after any candidate the chain's reference
    sign equals that slot's sign, so the reference sign before slot r is
    the sign at the last candidate before r (a cummax over
    position-encoded signs).  Inputs [C, sl] / [C]."""
    sl = means.shape[-1]
    re = means.real
    do = mask & locked[:, None]
    doi = do.to(torch.int32)
    n_do = doi.sum(dim=-1, dtype=torch.int32)
    has = n_do > 0
    msign = _sign8(re >= 0)
    psig = torch.cat([prev_signal[:, None], re[:, :-1]], dim=-1)
    spm = _sign8(psig >= 0)
    gate = (re - psig).abs() > min_edge_amp[:, None]
    r = torch.arange(sl, dtype=torch.int32, device=means.device)
    chain_started = sign0 != 0
    first_slot = (~chain_started)[:, None] & (r == 0)
    cand = do & (msign != spm) & (psig != 0) & gate & ~first_slot
    base = torch.where(chain_started, prev_sign, msign[:, 0])
    key = torch.where(cand, 2 * (r + 1) + (msign > 0).to(torch.int32), 0)
    cum = torch.cummax(key, dim=-1).values
    cum_excl = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1)
    psign_pre = torch.where(cum_excl > 0, _sign8(cum_excl % 2 == 1),
                            base[:, None])
    accept = cand & (psign_pre == spm)

    ems = ms_time[:, None] + doi.cumsum(dim=-1, dtype=torch.int32) - doi
    new_ms = ms_time + n_do
    new_sign0 = torch.where(chain_started | ~has, sign0, msign[:, 0])
    last_key = cum[:, -1]
    psign_end = torch.where(last_key > 0, _sign8(last_key % 2 == 1), base)
    new_psign = torch.where(has, psign_end, prev_sign)
    last_re = torch.gather(re, 1, torch.clamp(n_do - 1, min=0)
                           .long()[:, None])[:, 0]
    new_psig = torch.where(has, last_re, prev_signal)
    return new_sign0, new_psign, new_psig, new_ms, ems, starts, accept


def _amplitude(means, mask, n_valid):
    """(amplitude, std_dev) of the valid means' magnitudes."""
    mag = means.abs()
    fmask = mask.to(torch.float32)
    nv = torch.clamp(n_valid, min=1).to(torch.float32)
    amp_mean = (mag * fmask).sum(dim=-1) / nv
    std_dev = torch.sqrt(torch.clamp(
        (mag * mag * fmask).sum(dim=-1) / nv - amp_mean * amp_mean,
        min=1e-12))
    return amp_mean / std_dev, std_dev


def _pll(means, mask, n_valid, locked, df_buf, df_cnt, df_idx,
         cfg: ReceiverConfig):
    """Carrier PLL: arctan(Q/I) (not atan2: the pi-step unwrap depends on
    the (-pi/2, pi/2) range), pi-step unwrap as a cumulative sum of jump
    indicators, drift feed-forward from the df ring, slew clip, lock.
    A mean of exactly 0+0j takes sign(Q)*pi/2 instead of 0/0.  The phase
    and df-ring sums run in float64 and are rounded once to float32, so
    that no order of summation shows in them (the cheap kernel's n_cyc
    64 build, csrc/cheap.cu plain_phase_sums, sums the same way)."""
    no_sec = cfg.no_sec
    max_df = cfg.pll_max_df_per_sec / no_sec
    ns = means.shape[-1]
    dev = means.device
    re, im = means.real, means.imag
    re_nz = re != 0
    phase = torch.atan(im / torch.where(re_nz, re, torch.ones_like(re)))
    phase = torch.where(re_nz, phase, torch.sign(im) * (math.pi / 2))
    deltas = torch.diff(phase, dim=-1)
    dmask = torch.arange(1, ns, device=dev) < n_valid[:, None]
    steps = torch.where(dmask & (deltas.abs() > cfg.pll_phase_jump),
                        -torch.sign(deltas), torch.zeros_like(deltas))
    real_phase = phase + torch.cat(
        [torch.zeros_like(steps[:, :1]), steps.cumsum(dim=-1)],
        dim=-1) * math.pi
    fmask = mask.to(torch.float32)
    nv = torch.clamp(n_valid, min=1).to(torch.float32)
    phase_dev = (real_phase * fmask).double().sum(dim=-1).float() / nv
    tail = ((torch.arange(ns, device=dev)
             >= (n_valid - cfg.pll_offset_avg)[:, None]) & mask
            ).to(torch.float32)
    phase_offset = (real_phase * tail).double().sum(dim=-1).float() \
        / torch.clamp(tail.sum(dim=-1), min=1.0)

    mean_df = df_buf.double().sum(dim=-1).float() / torch.clamp(
        df_cnt, min=1).to(torch.float32)
    df_locked = torch.clamp(cfg.pll_gain_locked * phase_dev + mean_df,
                            -max_df, max_df)
    df_unlocked = cfg.pll_gain_unlocked * phase_dev
    df = torch.where(locked, df_locked, df_unlocked)

    # locked: push df into the ring; unlocked: reset the ring to [df]
    pos = torch.where(df_cnt < no_sec, df_cnt, df_idx % no_sec).long()
    buf_locked = df_buf.scatter(1, pos[:, None], df[:, None])
    cnt_locked = torch.clamp(df_cnt + 1, max=no_sec)
    idx_locked = torch.where(df_cnt < no_sec, df_idx, (df_idx + 1) % no_sec)
    buf_unlocked = torch.zeros_like(df_buf)
    buf_unlocked[:, 0] = df
    df_buf = torch.where(locked[:, None], buf_locked, buf_unlocked)
    df_cnt = torch.where(locked, cnt_locked, 1).to(torch.int32)
    df_idx = torch.where(locked, idx_locked, 1).to(torch.int32)
    new_locked = locked | (phase_dev.abs() < cfg.pll_lock_threshold)
    return df, phase_offset, new_locked, df_buf, df_cnt, df_idx


def _corr_quality(found, buf, cnt, idx, cfg: ReceiverConfig):
    """Correlation-quality history ring.  The write index is updated
    from the already-incremented count, as in the reference."""
    hist, no_sec = cfg.corr_hist_len, cfg.no_sec
    dev = buf.device
    cpq = _sign8(found)
    pos = torch.where(cnt < hist, cnt, idx % hist).long()
    buf = buf.scatter(1, pos[:, None], cpq[:, None])
    cnt = torch.clamp(cnt + 1, max=hist)
    idx = torch.where(cnt < hist, idx, (idx + 1) % hist)
    corr_q = buf.sum(dim=-1, dtype=torch.float32) / cnt.to(torch.float32)
    offs = torch.arange(no_sec, device=dev)
    last_pos = torch.where((cnt < hist)[:, None], cnt[:, None] - 1 - offs,
                           (idx[:, None] - 1 - offs) % hist)
    lmask = offs < torch.clamp(cnt, max=no_sec)[:, None]
    vals = torch.where(
        lmask, torch.gather(buf, 1, torch.clamp(last_pos, 0, hist - 1)
                            .long()), torch.zeros((), dtype=torch.int8,
                                                  device=dev))
    corr_l = vals.sum(dim=-1, dtype=torch.float32) \
        / torch.clamp(lmask.sum(dim=-1), min=1).to(torch.float32)
    return buf, cnt.to(torch.int32), idx.to(torch.int32), corr_q, corr_l


def _erased(state: ChannelState, stream_no0):
    """Stream-skip erase at a step's first block: (erase flag, state with
    the bit/edge carry wiped where erased, carry_cnt -1 there to tell
    the means assembly that no block continues).  stream_no0 is an int
    or an int32 scalar tensor on the state's device (a captured
    K-step's)."""
    erase = ((stream_no0 - 1) != state.prev_stream) & state.active
    z8 = torch.zeros_like(state.sign0)
    return erase, state._replace(
        sign0=torch.where(erase, z8, state.sign0),
        prev_sign=torch.where(erase, z8, state.prev_sign),
        carry_sum=torch.where(erase, torch.zeros_like(state.carry_sum),
                              state.carry_sum),
        carry_cnt=torch.where(erase, torch.full_like(state.carry_cnt, -1),
                              state.carry_cnt))


def channel_step(cfg: ReceiverConfig, state: ChannelState,
                 block: torch.Tensor, stream_no: int, codes: torch.Tensor,
                 code_ffts: torch.Tensor
                 ) -> tuple[ChannelState, ChannelOut]:
    """One block for all channels with the per-block PLL (K=1)."""
    erase, st = _erased(state, stream_no)

    mixed, phase_end = dsp.doppler_mix(block[None, :], st.freq, st.phase,
                                       cfg.sample_rate)        # [C, ngps]
    first_seg = (cfg.n_cyc - cfg.corr_avg) // 2
    fft_mean = dsp.segment_fft_mean(mixed, cfg.code_samples, first_seg,
                                    cfg.corr_avg)
    delay, code_phase, norm_max = dsp.peak_metrics(
        dsp.circ_correlate(fft_mean, code_ffts), cfg.corr_min)

    corr_buf, corr_cnt, corr_idx, corr_q, corr_l = _corr_quality(
        delay >= 0, st.corr_buf, st.corr_cnt, st.corr_idx, cfg)
    new_delay = torch.where(delay >= 0, delay, st.delay)

    head, seg = _segment_sums_rolled(mixed, dsp.roll_code(codes, new_delay),
                                     new_delay, cfg)
    means, starts, mask, n_valid, carry_sum, carry_cnt = _means_from_sums(
        head, seg, new_delay, st.carry_sum, st.carry_cnt,
        _continues(st.carry_cnt, st.corr_cnt), cfg)

    min_edge_amp = cfg.edge_sigma * st.std_dev
    sign0, prev_sign, prev_signal, ms_time, ems, est, evalid = _edge_scan(
        means, starts, mask, st.locked, min_edge_amp, st.sign0,
        st.prev_sign, st.prev_signal, st.ms_time)
    amplitude, std_dev = _amplitude(means, mask, n_valid)
    df, phase_offset, locked, df_buf, df_cnt, df_idx = _pll(
        means, mask, n_valid, st.locked, st.df_buf, st.df_cnt, st.df_idx,
        cfg)
    new_phase = torch.remainder(phase_end + phase_offset, TWO_PI)
    new_freq = torch.clamp(st.freq + df, cfg.min_freq, cfg.max_freq)
    sweep_request = ((corr_cnt >= cfg.corr_hist_len)
                     & (corr_q < cfg.min_corr_q) & st.active)

    sno = torch.full_like(st.prev_stream, stream_no)
    computed = ChannelState(
        prn=st.prn, active=st.active, freq=new_freq, phase=new_phase,
        delay=new_delay, locked=locked, ms_time=ms_time, std_dev=std_dev,
        prev_stream=sno, prev_signal=prev_signal, sign0=sign0,
        prev_sign=prev_sign, carry_sum=carry_sum, carry_cnt=carry_cnt,
        df_buf=df_buf, df_cnt=df_cnt, df_idx=df_idx, corr_buf=corr_buf,
        corr_cnt=corr_cnt, corr_idx=corr_idx)
    new_state = _select(st.active, computed,
                        state._replace(prev_stream=sno))

    act = st.active
    out = ChannelOut(
        code_phase=torch.where(act, code_phase, -1.0),
        delay=torch.where(act, new_delay, 0),
        norm_max=torch.where(act, norm_max, 0.0),
        amplitude=torch.where(act, amplitude, 0.0),
        corr_q=torch.where(act, corr_q, 0.0),
        corr_l=torch.where(act, corr_l, 0.0),
        freq=torch.where(act, new_freq, 0.0),
        locked=act & locked,
        erased=erase,
        sweep_request=sweep_request,
        sign0=torch.where(act, sign0, torch.zeros_like(sign0)),
        edge_ms=ems, edge_local=est, edge_valid=evalid & act[:, None])
    return new_state, out


def _stack_outs(outs: list[ChannelOut]) -> ChannelOut:
    return ChannelOut(*[torch.stack(f) for f in zip(*outs)])


def track_chunk_impl(cfg: ReceiverConfig, states: ChannelState,
                     blocks: torch.Tensor, stream_no0: int,
                     codes: torch.Tensor, code_ffts: torch.Tensor
                     ) -> tuple[ChannelState, ChannelOut]:
    """Track all channels over T consecutive blocks, one block per step.

    blocks: complex64[T, ngps]; stream_no0: stream number of blocks[0];
    codes f32[C, cs], code_ffts c64[C, cs].  Outputs are [T, C, ...].
    With cfg.cw_excision > 0 the chunk is excised first
    (frontend.excise_cw_chunk)."""
    if cfg.cw_excision > 0:
        blocks = frontend.excise_cw_chunk(cfg, blocks)
        cfg = cfg.replace(cw_excision=0.0)
    blocks = dsp.as_complex_input(blocks)
    outs = []
    for i in range(blocks.shape[0]):
        with span("track.block"):
            states, out = channel_step(cfg, states, blocks[i],
                                       stream_no0 + i, codes, code_ffts)
        outs.append(out)
    return states, _stack_outs(outs)


# ---------------------------------------------------------------------------
# K-block fused tracking step (see the JAX module for the derivation):
# the mixer NCO is frozen for K blocks, the expensive stages run batched
# over them (hopper_wipeoff), and the per-block PLL feedback runs as a
# scan over cheap per-ms means (hopper_cheap) with the intra-step
# frequency corrections applied as a virtual NCO retune.
# ---------------------------------------------------------------------------


def to_grouped_planar(cfg: ReceiverConfig, blocks: torch.Tensor
                      ) -> torch.Tensor:
    """A chunk in any IQ layout -> contiguous grouped planar
    f32[..., T, 2, n_cyc, cs] (returned as is if it already is one)."""
    if dsp.is_grouped_iq(cfg, blocks):
        return blocks.to(torch.float32).contiguous()
    x = dsp.as_complex_input(blocks)
    return torch.stack([x.real, x.imag], dim=-2).reshape(
        tuple(x.shape[:-1]) + (2, cfg.n_cyc, cfg.code_samples)).contiguous()


def predict_wipe_delays(cfg: ReceiverConfig, k: int, freq: torch.Tensor,
                        delay0: torch.Tensor) -> torch.Tensor:
    """Per-block code-wipeoff boundary delays i32[C, k], following the
    code Doppler freq/1540 from the step-start delay."""
    drift = -(freq / 1540.0) * (cfg.code_samples / 1023.0) \
        * (cfg.ngps / cfg.sample_rate)
    j = torch.arange(k, dtype=torch.float32, device=freq.device)
    w = delay0.to(torch.float32)[:, None] + torch.round(drift[:, None] * j)
    return torch.remainder(w.to(torch.int32), cfg.code_samples)


def _resolve_delays(delay0: torch.Tensor, delay_k: torch.Tensor
                    ) -> torch.Tensor:
    """Per block, the measured delay or (on a miss) the last measured
    one before it, starting from delay0: i32[C, k]."""
    k = delay_k.shape[-1]
    pos = torch.where(delay_k >= 0,
                      torch.arange(k, device=delay_k.device), -1)
    last = torch.cummax(pos, dim=-1).values
    got = torch.gather(delay_k, 1, torch.clamp(last, min=0))
    return torch.where(last >= 0, got, delay0[:, None]).to(torch.int32)


def heavy_stage(cfg: ReceiverConfig, k: int, states: ChannelState,
                chunk: torch.Tensor, step: int, codes: torch.Tensor,
                code_ffts: torch.Tensor, corr_spec=None,
                n_streams: int = 1) -> HeavyOut:
    """Feedback-free stages of K-block step `step` of `chunk` for all
    channels: frozen-NCO mixing and code wipeoff (hopper_wipeoff), then
    the center-period correlation and peak metrics on torch.fft.

    chunk is complex64[T, ngps] when cfg.use_mxu_wipeoff (kernel
    mix_wipeoff) and grouped planar f32[T, 2, n_cyc, cs] otherwise
    (kernel mix_wipeoff_vpu).  With n_streams > 1 the channel axis holds
    the channels of that many streams, stream after stream, and chunk is
    read by all of them or, with a leading stream axis, is one chunk a
    stream (the layouts hopper_wipeoff takes)."""
    freq, phase, delay0 = states.freq, states.phase, states.delay
    s = TWO_PI * freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, TWO_PI)
    wipe = predict_wipe_delays(cfg, k, freq, delay0)
    wipeoff = (hopper_wipeoff.mix_wipeoff if cfg.use_mxu_wipeoff
               else hopper_wipeoff.mix_wipeoff_vpu)
    center, head_k, seg_sums_k = wipeoff(cfg, k, s, snp, phase, wipe, chunk,
                                         step, codes, n_streams)
    spec = corr.prep_spec(code_ffts) if corr_spec is None else corr_spec
    delay_k, code_phase_k, norm_max_k = corr.corr_peaks(
        center, spec, cfg.corr_min)                       # [k, C]
    delay_k = delay_k.T
    return HeavyOut(
        delay_k=delay_k, code_phase_k=code_phase_k.T,
        norm_max_k=norm_max_k.T,
        new_delay_k=_resolve_delays(delay0, delay_k),
        head_k=head_k, seg_sums_k=seg_sums_k,
        phase_end=torch.remainder(phase + snp * k, TWO_PI),
        wipe_delay=wipe)


def _filled(like: torch.Tensor, value) -> torch.Tensor:
    """A fresh tensor shaped and typed as `like`, every element `value`:
    an int, or an int32 scalar tensor on like's device."""
    if isinstance(value, torch.Tensor):
        return value.to(like.dtype).expand(like.shape).clone()
    return torch.full_like(like, value)


def channel_step_k(cfg: ReceiverConfig, k: int, states: ChannelState,
                   heavy: HeavyOut, stream_no0
                   ) -> tuple[ChannelState, ChannelOut]:
    """Cheap feedback for one K-block step, all channels: erase on a
    stream gap, the per-block scan (hopper_cheap.cheap_scan: means,
    retune rotation, quality ring, edges, amplitude, PLL), then the
    carry de-rotation, NCO update and output assembly.  Outputs are
    [C, k, ...].  stream_no0, the step's first stream number, is an int
    or an int32 scalar tensor on the states' device."""
    erase, st = _erased(states, stream_no0)
    co = hopper_cheap.cheap_scan(cfg, k, heavy.head_k, heavy.seg_sums_k,
                                 heavy.delay_k, heavy.wipe_delay, st)

    # the step's accumulated PLL correction dphi folds into the NCO
    # phase, so the next step's samples arrive de-rotated; the stored
    # carry tail was summed under this step's NCO and is de-rotated here
    carry_sum = co.carry_sum * torch.complex(torch.cos(co.dphi),
                                             -torch.sin(co.dphi))
    new_freq = torch.clamp(states.freq + co.df_sum, cfg.min_freq,
                           cfg.max_freq)
    new_phase = torch.remainder(heavy.phase_end + co.dphi, TWO_PI)
    sweep_request = ((co.corr_cnt >= cfg.corr_hist_len)
                     & (co.corr_q[:, -1] < cfg.min_corr_q) & states.active)

    sno = _filled(states.prev_stream, stream_no0 + k - 1)
    computed = ChannelState(
        prn=states.prn, active=states.active, freq=new_freq,
        phase=new_phase, delay=heavy.new_delay_k[:, -1], locked=co.locked,
        ms_time=co.ms_time, std_dev=co.std_dev, prev_stream=sno,
        prev_signal=co.prev_signal, sign0=co.sign0,
        prev_sign=co.prev_sign, carry_sum=carry_sum,
        carry_cnt=co.carry_cnt, df_buf=co.df_buf, df_cnt=co.df_cnt,
        df_idx=co.df_idx, corr_buf=co.corr_buf, corr_cnt=co.corr_cnt,
        corr_idx=co.corr_idx)
    new_state = _select(states.active, computed,
                        states._replace(prev_stream=sno))

    act = states.active[:, None]
    last = torch.arange(k, device=act.device) == k - 1
    first = torch.arange(k, device=act.device) == 0
    out = ChannelOut(
        code_phase=torch.where(act, heavy.code_phase_k, -1.0),
        delay=torch.where(act, heavy.new_delay_k, 0),
        norm_max=torch.where(act, heavy.norm_max_k, 0.0),
        amplitude=torch.where(act, co.amplitude, 0.0),
        corr_q=torch.where(act, co.corr_q, 0.0),
        corr_l=torch.where(act, co.corr_l, 0.0),
        freq=torch.where(act, new_freq[:, None].expand(-1, k), 0.0),
        locked=act & co.locked_seq,
        erased=erase[:, None] & first,
        sweep_request=sweep_request[:, None] & last,
        sign0=torch.where(act, co.sign0_seq,
                          torch.zeros_like(co.sign0_seq)),
        edge_ms=co.edge_ms, edge_local=co.edge_local,
        edge_valid=co.edge_valid & act[:, :, None])
    return new_state, out


def track_chunk_batched_impl(cfg: ReceiverConfig, states: ChannelState,
                             blocks: torch.Tensor, stream_no0: int,
                             codes: torch.Tensor, code_ffts: torch.Tensor
                             ) -> tuple[ChannelState, ChannelOut]:
    """track_chunk_impl with cfg.blocks_per_step blocks fused per step.

    blocks: complex64[T, ngps] or grouped planar f32[T, 2, n_cyc, cs].
    A chunk whose length is not a multiple of K runs fused steps over
    the divisible prefix and the K=1 path over the tail.  Outputs come
    back in stream order [T, C, ...].  With cfg.cw_excision > 0 the
    chunk is excised once, here, and the fused prefix and the tail see
    the same excised blocks."""
    if cfg.cw_excision > 0:
        blocks = frontend.excise_cw_chunk(cfg, blocks)
        cfg = cfg.replace(cw_excision=0.0)
    k = cfg.blocks_per_step
    if k <= 1:
        return track_chunk_impl(cfg, states, blocks, stream_no0, codes,
                                code_ffts)
    t = blocks.shape[0]
    if t % k:
        tm = t - t % k
        if tm == 0:
            return track_chunk_impl(cfg, states, blocks, stream_no0, codes,
                                    code_ffts)
        st1, o1 = track_chunk_batched_impl(cfg, states, blocks[:tm],
                                           stream_no0, codes, code_ffts)
        st2, o2 = track_chunk_impl(cfg, st1, blocks[tm:], stream_no0 + tm,
                                   codes, code_ffts)
        return st2, ChannelOut(*[torch.cat([a, b]) for a, b in zip(o1, o2)])
    return _fused_steps(cfg, states, blocks, t, stream_no0, codes,
                        code_ffts)


def _kstep(cfg: ReceiverConfig, n_streams: int, states: ChannelState,
           chunk: torch.Tensor, step: int, stream_no0, codes: torch.Tensor,
           spec: torch.Tensor) -> tuple[ChannelState, ChannelOut]:
    """K-step `step` of a chunk whose first block has stream number
    stream_no0 (an int, or an int32 scalar tensor on the chunk's
    device): heavy_stage, then channel_step_k."""
    k = cfg.blocks_per_step
    heavy = heavy_stage(cfg, k, states, chunk, step, codes, None,
                        corr_spec=spec, n_streams=n_streams)
    return channel_step_k(cfg, k, states, heavy, stream_no0 + k * step)


def _fused_steps(cfg: ReceiverConfig, states: ChannelState,
                 blocks: torch.Tensor, t: int, stream_no0: int,
                 codes: torch.Tensor, code_ffts: torch.Tensor,
                 n_streams: int = 1) -> tuple[ChannelState, ChannelOut]:
    """The K-step loop over a chunk of t blocks, t a multiple of K: per
    step one wipeoff launch and one cheap launch for every channel (of
    n_streams streams; see heavy_stage).  On a CUDA device the steps
    replay as CUDA graphs (ops/kstep_graphs.py).  Outputs [T, C, ...]."""
    k = cfg.blocks_per_step
    # the wipeoff kernel's layout, converted at most once per chunk
    if cfg.use_mxu_wipeoff:
        blocks = dsp.as_complex_input(blocks).contiguous()
    else:
        blocks = to_grouped_planar(cfg, blocks)
    states, outs = kstep_graphs.run(
        cfg, n_streams, functools.partial(_kstep, cfg, n_streams), states,
        blocks, t // k, stream_no0, codes, code_ffts)
    # per step [C, k, ...] -> [T, C, ...]
    return states, ChannelOut(*[torch.cat([x.transpose(0, 1) for x in f])
                                for f in zip(*outs)])


# --- host views ---------------------------------------------------------------

_OUT_DTYPES = {
    "delay": np.int32, "locked": bool, "erased": bool,
    "sweep_request": bool, "sign0": np.int8, "edge_ms": np.int32,
    "edge_local": np.int32, "edge_valid": bool,
}


def outs_to_numpy(outs: ChannelOut) -> ChannelOut:
    """ChannelOut with every leaf on the host as numpy, natural dtypes."""
    return ChannelOut(**{
        name: v.cpu().numpy().astype(_OUT_DTYPES.get(name, np.float32),
                                     copy=False)
        for name, v in outs._asdict().items()})


def cn0_from_amp(amp, code_period_hz: float = 1000.0):
    """C/N0 [dB-Hz] from the amplitude ratio AMP = mean|m| / std|m| of
    the 1 ms prompt sums: A^2/s^2 = AMP^2 - 1, C/N0 = A^2/(2 s^2) * rate."""
    amp = np.asarray(amp, np.float64)
    snr = np.maximum(amp * amp - 1.0, 1e-2)
    return 10.0 * np.log10(snr * 0.5 * code_period_hz)


def summarize_states(cfg: ReceiverConfig, states: ChannelState) -> dict:
    """Host numpy view of the per-channel state for policy/reporting."""
    return {
        "prn": states.prn.cpu().numpy(),
        "active": states.active.cpu().numpy(),
        "freq": states.freq.cpu().numpy(),
        "delay": states.delay.cpu().numpy(),
        "locked": states.locked.cpu().numpy(),
        "ms_time": states.ms_time.cpu().numpy(),
        "amplitude_sigma": states.std_dev.cpu().numpy(),
        "corr_cnt": states.corr_cnt.cpu().numpy(),
    }


# --- compact transport (run_device streaming) --------------------------------
#
# The host consumes per BLOCK only code_phase, sign0 and erased; per
# CHUNK the last block's amplitude/corr_q/corr_l/freq/locked/norm_max/
# sweep_request; and the SPARSE bit-edge events (<= 50/s/channel at the
# 20 ms bit length, against a dense [T, n_cyc+1] plane).
# pack_outs_compact reduces a chunk's ChannelOut to exactly that on the
# device, so one small download per window of chunks carries everything
# the host reads; the host inverses below restore dense planes (or a
# sparse window view).  Bit-exact where the host reads, unless a channel
# exceeds `cap` edges in a chunk (counted, never silent).

# f32 holds integers exactly only below 2^24; edge_ms counts ms since
# lock and exceeds that after ~4.66 h, so the ms base crosses as hi/lo
_EDGE_MS_SPLIT = 4096

_LAST_FIELDS = ("amplitude", "corr_q", "corr_l", "freq", "locked",
                "norm_max", "sweep_request")
# _LAST_FIELDS column indices (CompactWindow.last[..., i])
_LAST_IDX = {n: i for i, n in enumerate(_LAST_FIELDS)}


def pack_outs_compact(outs: ChannelOut, cap: int,
                      with_freq: bool = False) -> torch.Tensor:
    """Pack one chunk's ChannelOut into a flat f32[L] transport buffer,
    on the outputs' device.

    Layout: [T*C*nb per-block | C*7 last-block | C*2 ms base (hi/lo) |
    C*cap*3 edges | C counts].  Per-block columns are (code_phase,
    sign0+1 + 4*erased[, freq if with_freq — carrier smoothing]).
    Edge entries are (flat_pos, ms - base, local) sorted by flat_pos =
    block*(n_cyc+1)+slot, -1 past the valid count; base is the
    channel's first edge ms.  The JAX module's lax.sort is a stable
    torch.sort on the masked position key here.

    Leading axes before [T, C, ...] (the stream axis of the serving
    path, [S, T, C, ...]) are kept: the result is [..., L], each row the
    packing of its own chunk, as the JAX serving path's vmap of this
    function (serving.py _pack_streams) gives."""
    lead = tuple(outs.edge_valid.shape[:-3])
    t, c, sl = outs.edge_valid.shape[-3:]
    d = t * sl
    cap = min(cap, d)
    f32 = torch.float32
    dev = outs.edge_valid.device

    aux = (outs.sign0.to(f32) + 1.0 + 4.0 * outs.erased.to(f32))
    cols = [outs.code_phase.to(f32), aux]
    if with_freq:
        cols.append(outs.freq.to(f32))
    blocky = torch.stack(cols, dim=-1)              # [..., T, C, 2 or 3]
    last = torch.stack([getattr(outs, n)[..., -1, :].to(f32)
                        for n in _LAST_FIELDS], dim=-1)   # [..., C, 7]

    def by_channel(x):                  # [..., T, C, sl] -> [..., C, T*sl]
        return x.transpose(-3, -2).reshape(lead + (c, d))

    valid = by_channel(outs.edge_valid)
    ms = by_channel(outs.edge_ms).to(torch.int32)
    loc = by_channel(outs.edge_local).to(torch.int32)
    pos = torch.arange(d, dtype=torch.int32, device=dev).expand(lead + (c, d))
    key = torch.where(valid, pos, d)
    skey, order = torch.sort(key, dim=-1, stable=True)
    skey = skey[..., :cap]
    sms = torch.gather(ms, -1, order[..., :cap])
    sloc = torch.gather(loc, -1, order[..., :cap])
    ok = skey < d
    base = sms[..., 0] * ok[..., 0].to(torch.int32)            # [..., C]
    edges = torch.stack([
        torch.where(ok, skey, -1).to(f32),
        torch.where(ok, sms - base[..., None], 0).to(f32),
        torch.where(ok, sloc, 0).to(f32)], dim=-1)        # [..., C, cap, 3]
    nv = valid.to(f32).sum(dim=-1)                             # [..., C]
    return torch.cat([blocky.reshape(lead + (-1,)),
                      last.reshape(lead + (-1,)),
                      (base // _EDGE_MS_SPLIT).to(f32),
                      (base % _EDGE_MS_SPLIT).to(f32),
                      edges.reshape(lead + (-1,)), nv], dim=-1)


def unpack_outs_compact(buf: np.ndarray, t: int, c: int, sl: int,
                        cap: int,
                        with_freq: bool = False
                        ) -> tuple[ChannelOut, np.ndarray]:
    """Host inverse of pack_outs_compact: rebuild a dense ChannelOut of
    numpy arrays (dropped fields zero-filled; last-block fields
    broadcast over T — the consume path only reads their [-1] row).
    Returns (outs, n_dropped_edges[c])."""
    cap = min(cap, t * sl)
    nb = 3 if with_freq else 2
    off = 0
    blocky = buf[off:off + t * c * nb].reshape(t, c, nb)
    off += t * c * nb
    last = buf[off:off + c * 7].reshape(c, 7)
    off += c * 7
    base = (np.rint(buf[off:off + c]).astype(np.int64) * _EDGE_MS_SPLIT
            + np.rint(buf[off + c:off + 2 * c]).astype(np.int64))
    off += 2 * c
    edges = buf[off:off + c * cap * 3].reshape(c, cap, 3)
    off += c * cap * 3
    nv = np.rint(buf[off:off + c]).astype(np.int64)

    edge_ms = np.zeros((t, c, sl), np.int32)
    edge_local = np.zeros((t, c, sl), np.int32)
    edge_valid = np.zeros((t, c, sl), bool)
    pos = np.rint(edges[..., 0]).astype(np.int64)            # [C, cap]
    ch, pe = np.nonzero(pos >= 0)
    if ch.size:
        fp = pos[ch, pe]
        tb, es = fp // sl, fp % sl
        edge_ms[tb, ch, es] = (base[ch]
                               + np.rint(edges[ch, pe, 1]).astype(np.int64)
                               ).astype(np.int32)
        edge_local[tb, ch, es] = np.rint(edges[ch, pe, 2]).astype(np.int32)
        edge_valid[tb, ch, es] = True

    lastv = {n: np.broadcast_to(last[:, i], (t, c)) for i, n in
             enumerate(_LAST_FIELDS)}
    aux = np.rint(blocky[..., 1]).astype(np.int8)
    outs = ChannelOut(
        code_phase=blocky[..., 0],
        delay=np.zeros((t, c), np.int32),
        norm_max=lastv["norm_max"],
        amplitude=lastv["amplitude"],
        corr_q=lastv["corr_q"],
        corr_l=lastv["corr_l"],
        freq=(blocky[..., 2] if with_freq   # per-block: Hatch input
              else lastv["freq"]),
        locked=lastv["locked"] > 0.5,
        erased=aux >= 4,
        sweep_request=lastv["sweep_request"] > 0.5,
        sign0=(aux % 4 - 1).astype(np.int8),
        edge_ms=edge_ms, edge_local=edge_local, edge_valid=edge_valid)
    return outs, np.maximum(nv - cap, 0)


class CompactWindow(NamedTuple):
    """Host view of a whole download window's packed transport rows
    WITHOUT the dense edge-plane scatter: the edges stay sparse exactly
    as packed (sorted by flat block*sl+slot), and the whole [w, L]
    window is sliced in one pass."""

    code_phase: np.ndarray        # [w*t, C] f32
    aux: np.ndarray               # [w*t, C] int8: sign0+1 + 4*erased
    freq: np.ndarray | None       # [w*t, C] f32 (with_freq only)
    last: np.ndarray              # [w, C, 7] f32, _LAST_FIELDS columns
    edge_pos: np.ndarray          # [w, C, cap] int64 flat pos, -1 pad
    edge_ms: np.ndarray           # [w, C, cap] int64 absolute ms
    edge_local: np.ndarray        # [w, C, cap] int32 sample-in-block
    dropped: np.ndarray           # [w, C] int64 edges past cap


def unpack_window_compact(rows: np.ndarray, t: int, c: int, sl: int,
                          cap: int,
                          with_freq: bool = False) -> CompactWindow:
    """One host pass over a window's packed rows [w, L] (layout:
    pack_outs_compact) -> CompactWindow."""
    rows = np.asarray(rows)
    w = rows.shape[0]
    cap = min(cap, t * sl)
    nb = 3 if with_freq else 2
    off = t * c * nb
    blocky = rows[:, :off].reshape(w, t, c, nb)
    last = rows[:, off:off + c * 7].reshape(w, c, 7)
    off += c * 7
    base = (np.rint(rows[:, off:off + c]).astype(np.int64)
            * _EDGE_MS_SPLIT
            + np.rint(rows[:, off + c:off + 2 * c]).astype(np.int64))
    off += 2 * c
    edges = rows[:, off:off + c * cap * 3].reshape(w, c, cap, 3)
    off += c * cap * 3
    nv = np.rint(rows[:, off:off + c]).astype(np.int64)
    pos = np.rint(edges[..., 0]).astype(np.int64)
    ms = base[:, :, None] + np.rint(edges[..., 1]).astype(np.int64)
    return CompactWindow(
        code_phase=blocky[..., 0].reshape(w * t, c),
        aux=np.rint(blocky[..., 1]).astype(np.int8).reshape(w * t, c),
        freq=(blocky[..., 2].reshape(w * t, c) if with_freq else None),
        last=last, edge_pos=pos, edge_ms=ms,
        edge_local=np.rint(edges[..., 2]).astype(np.int32),
        dropped=np.maximum(nv - cap, 0))


def track_window_impl(cfg: ReceiverConfig, states: ChannelState,
                      blocks: torch.Tensor, stream_no0: int,
                      codes: torch.Tensor, code_ffts: torch.Tensor,
                      cap: int, with_freq: bool = False
                      ) -> tuple[ChannelState, torch.Tensor]:
    """Track + pack a download window of w chunks (one stream).

    blocks [w, t, *iq]; returns (states, packed f32[w, L]) where row i
    is pack_outs_compact of chunk i tracked at stream_no0 + i*t.  The
    JAX module scans the chunks inside one program; here a Python loop
    enqueues them, and nothing waits for the device until the caller
    downloads the stacked rows."""
    w, t = blocks.shape[0], blocks.shape[1]
    rows = []
    for i in range(w):
        states, outs = track_chunk_batched_impl(
            cfg, states, blocks[i], stream_no0 + i * t, codes, code_ffts)
        rows.append(pack_outs_compact(outs, cap, with_freq))
    return states, torch.stack(rows)


def _flat_streams(x: torch.Tensor) -> torch.Tensor:
    """[S, C, ...] -> [S*C, ...], a view."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def track_streams_impl(cfg: ReceiverConfig, states: ChannelState,
                       blocks: torch.Tensor, stream_no0: int,
                       codes: torch.Tensor, code_ffts: torch.Tensor,
                       shared: bool = False
                       ) -> tuple[ChannelState, ChannelOut]:
    """Track S IQ streams, each with its own channel set, as one
    stream-stacked chunk (the serving path, runtime/serving.py).

    states: ChannelState with leaves [S, C, ...]; codes, code_ffts
    [S, C, cs]; blocks: one chunk a stream, [S, T, *iq], or with
    shared=True one chunk every stream reads, [T, *iq]; stream_no0: the
    stream number of the chunk's first block, one for all streams.
    Semantics per stream are those of track_chunk_batched_impl.  The
    JAX module vmaps that over the streams; here the channels of all
    streams run as one flattened S*C channel axis, so each K-step is one
    wipeoff launch (grid z = S) and one cheap launch (S*C channels)
    whatever S is.  A tail shorter than K runs the K=1 path stream by
    stream.  Returns (states [S, C, ...], ChannelOut [S, T, C, ...]).

    With cfg.cw_excision > 0 the chunk is excised first: a shared chunk
    once for all streams (the JAX module excises it once a stream, to
    the same values), a stacked one as one batched FFT."""
    if cfg.cw_excision > 0:
        blocks = frontend.excise_cw_chunk(cfg, blocks)
        cfg = cfg.replace(cw_excision=0.0)
    s_n, c = states.prn.shape[:2]
    flat = ChannelState(*(_flat_streams(x) for x in states))
    codes, code_ffts = _flat_streams(codes), _flat_streams(code_ffts)
    t = blocks.shape[0 if shared else 1]
    k = cfg.blocks_per_step
    tm = t - t % k if k > 1 else 0
    parts = []
    if tm:
        flat, out = _fused_steps(
            cfg, flat, blocks[:tm] if shared else blocks[:, :tm], tm,
            stream_no0, codes, code_ffts, n_streams=s_n)
        parts.append(out)                                 # [tm, S*C, ...]
    if tm < t:
        new, outs = [], []
        for z in range(s_n):
            ch = slice(z * c, (z + 1) * c)
            st, out = track_chunk_impl(
                cfg, ChannelState(*(x[ch] for x in flat)),
                blocks[tm:] if shared else blocks[z, tm:], stream_no0 + tm,
                codes[ch], code_ffts[ch])
            new.append(st)
            outs.append(out)
        flat = ChannelState(*(torch.cat(f) for f in zip(*new)))
        parts.append(ChannelOut(*(torch.cat(f, dim=1) for f in zip(*outs))))
    out = parts[0] if len(parts) == 1 else ChannelOut(
        *(torch.cat(f) for f in zip(*parts)))
    states = ChannelState(*(x.reshape((s_n, c) + tuple(x.shape[1:]))
                            for x in flat))
    return states, ChannelOut(*(
        x.reshape((t, s_n, c) + tuple(x.shape[2:])).transpose(0, 1)
        for x in out))


def track_streams_window_impl(cfg: ReceiverConfig, states: ChannelState,
                              blocks: torch.Tensor, stream_no0: int,
                              codes: torch.Tensor, code_ffts: torch.Tensor,
                              cap: int, with_freq: bool = False,
                              shared: bool = True
                              ) -> tuple[ChannelState, torch.Tensor]:
    """Track + pack a download window of w chunks for S streams.

    shared=True (serving replicas of one capture): blocks [w, t, *iq],
    read by every stream; shared=False (independent front ends): blocks
    [w, S, t, *iq].  Returns (states, packed f32[w, S, L]), row [i, s]
    pack_outs_compact of stream s's chunk i tracked at stream_no0 + i*t:
    the layout of the JAX module's track_streams_window.  A Python loop
    enqueues the chunks; nothing waits for the device."""
    t = blocks.shape[1 if shared else 2]
    rows = []
    for i in range(blocks.shape[0]):
        states, outs = track_streams_impl(cfg, states, blocks[i],
                                          stream_no0 + i * t, codes,
                                          code_ffts, shared)
        rows.append(pack_outs_compact(outs, cap, with_freq))
    return states, torch.stack(rows)


# pack_states' key layout (gps_sdr_tpu/ops/tracking.py): complex leaves
# split into __re/__im, the long counters into __hi/__lo of base 4096
_STATE_SPLIT = {"ms_time", "prev_stream"}
_SPLIT_BASE = 4096


def states_from_numpy(tree: dict, device="cuda") -> ChannelState:
    """ChannelState on `device` from a dict of f32 arrays in the JAX
    pack_states layout (so one numpy state feeds both packages).  The
    arrays may carry a leading stream axis ([S, C, ...]: a serving
    path's stacked state); it is kept."""
    dev = resolve_device(device)
    fields = {}
    for name, dt in _STATE_DTYPES.items():
        if dt == torch.complex64:
            v = (np.asarray(tree[name + "__re"], np.float32)
                 + 1j * np.asarray(tree[name + "__im"], np.float32))
        elif name in _STATE_SPLIT:
            v = (np.rint(tree[name + "__hi"]).astype(np.int64) * _SPLIT_BASE
                 + np.rint(tree[name + "__lo"]).astype(np.int64))
        elif dt == torch.bool:
            v = np.asarray(tree[name]) > 0.5
        elif dt == torch.float32:
            v = np.asarray(tree[name], np.float32)
        else:
            v = np.rint(tree[name]).astype(np.int64)
        fields[name] = torch.as_tensor(np.array(v)).to(device=dev,
                                                         dtype=dt)
    return ChannelState(**fields)


def states_to_numpy(states: ChannelState) -> dict:
    """Inverse of states_from_numpy: dict of f32 numpy arrays in the JAX
    pack_states layout, with whatever leading axes the leaves have."""
    out = {}
    for name, v in states._asdict().items():
        v = v.cpu()
        if v.is_complex():
            out[name + "__re"] = v.real.numpy().astype(np.float32)
            out[name + "__im"] = v.imag.numpy().astype(np.float32)
        elif name in _STATE_SPLIT:
            x = v.numpy().astype(np.int64)
            out[name + "__hi"] = (x // _SPLIT_BASE).astype(np.float32)
            out[name + "__lo"] = (x % _SPLIT_BASE).astype(np.float32)
        else:
            out[name] = v.numpy().astype(np.float32)
    return out
