"""Per-channel code/carrier tracking on PyTorch.

Port of gps_sdr_tpu/ops/tracking.py.  Channels are the leading axis of
every state tensor (the batch axis the JAX package got from vmap is
written out), blocks are consumed by a Python loop over K-block steps,
and the two kernels of the K-fused step live in ops/hopper_wipeoff.py
(mix + code wipeoff) and ops/hopper_cheap.py (means, edges, PLL,
rings).  Each dispatches on the device of its inputs: a CPU tensor runs
the plain PyTorch twin, a CUDA tensor launches the hand-written kernel.

Differences from the JAX module, none of which changes a result:
  * integer state stays integer (ms_time, counters, int8 signs and the
    correlation ring); there is no f32 packing and no ms_time rebase;
  * blocks stay complex64 (native on CUDA): no f32-pair or planar
    transport;
  * the K=1 code wipeoff rolls the code in the time domain
    (dsp.roll_code) instead of through its FFT.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops import corr, dsp, hopper_cheap, hopper_wipeoff

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


def _means_from_sums(head, seg_sums, delay, carry_sum, carry_cnt,
                     cfg: ReceiverConfig):
    """Assemble the fixed n_cyc+1 means layout from (head, seg_sums).

    Slot 0 is the carry-completed mean (valid only if the carry plus
    head hold samples), slots 1..n_cyc the full segments (the last one
    invalid unless delay == 0); valid means are then compacted to the
    front.  All inputs have the channel axis first."""
    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    dev = head.device
    cnt0 = carry_cnt + delay
    mean0 = (carry_sum + head) / torch.clamp(cnt0, min=1).to(torch.float32)
    v0 = cnt0 > 0
    k_full = n_cyc - (delay > 0).to(torch.int32)

    means = torch.cat([mean0[:, None], seg_sums / cs], dim=-1)
    q = torch.arange(n_cyc, dtype=torch.int32, device=dev)
    starts = torch.cat([(-carry_cnt)[:, None], delay[:, None] + cs * q],
                       dim=-1).to(torch.int32)
    new_carry_sum = torch.where(delay > 0, seg_sums[:, n_cyc - 1],
                                torch.zeros_like(carry_sum))
    new_carry_cnt = torch.where(delay > 0, cs - delay,
                                torch.zeros_like(delay)).to(torch.int32)

    keep = v0[:, None]
    means = torch.where(keep, means, torch.roll(means, -1, dims=-1))
    starts = torch.where(keep, starts, torch.roll(starts, -1, dims=-1))
    n_valid = (k_full + v0.to(torch.int32)).to(torch.int32)
    mask = torch.arange(n_cyc + 1, device=dev) < n_valid[:, None]
    return means, starts, mask, n_valid, new_carry_sum, new_carry_cnt


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
    A mean of exactly 0+0j takes sign(Q)*pi/2 instead of 0/0."""
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
    phase_dev = (real_phase * fmask).sum(dim=-1) / nv
    tail = ((torch.arange(ns, device=dev)
             >= (n_valid - cfg.pll_offset_avg)[:, None]) & mask
            ).to(torch.float32)
    phase_offset = (real_phase * tail).sum(dim=-1) \
        / torch.clamp(tail.sum(dim=-1), min=1.0)

    mean_df = df_buf.sum(dim=-1) / torch.clamp(df_cnt, min=1).to(
        torch.float32)
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


def _erased(state: ChannelState, stream_no0: int):
    """Stream-skip erase at a step's first block: (erase flag, state with
    the bit/edge carry wiped where erased)."""
    erase = ((stream_no0 - 1) != state.prev_stream) & state.active
    z8 = torch.zeros_like(state.sign0)
    return erase, state._replace(
        sign0=torch.where(erase, z8, state.sign0),
        prev_sign=torch.where(erase, z8, state.prev_sign),
        carry_sum=torch.where(erase, torch.zeros_like(state.carry_sum),
                              state.carry_sum),
        carry_cnt=torch.where(erase, torch.zeros_like(state.carry_cnt),
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
        head, seg, new_delay, st.carry_sum, st.carry_cnt, cfg)

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
    codes f32[C, cs], code_ffts c64[C, cs].  Outputs are [T, C, ...]."""
    if cfg.cw_excision > 0:
        raise NotImplementedError(
            "cw_excision needs the front end, not yet ported")
    blocks = dsp.as_complex_input(blocks)
    outs = []
    for i in range(blocks.shape[0]):
        states, out = channel_step(cfg, states, blocks[i], stream_no0 + i,
                                   codes, code_ffts)
        outs.append(out)
    return states, _stack_outs(outs)


# ---------------------------------------------------------------------------
# K-block fused tracking step (see the JAX module for the derivation):
# the mixer NCO is frozen for K blocks, the expensive stages run batched
# over them (hopper_wipeoff), and the per-block PLL feedback runs as a
# scan over cheap per-ms means (hopper_cheap) with the intra-step
# frequency corrections applied as a virtual NCO retune.
# ---------------------------------------------------------------------------


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
                code_ffts: torch.Tensor, corr_spec=None) -> HeavyOut:
    """Feedback-free stages of K-block step `step` of `chunk`
    (complex64[T, ngps]) for all channels: frozen-NCO mixing and code
    wipeoff (hopper_wipeoff), then the center-period correlation and
    peak metrics on torch.fft."""
    freq, phase, delay0 = states.freq, states.phase, states.delay
    s = TWO_PI * freq / cfg.sample_rate
    snp = torch.remainder(s * cfg.ngps, TWO_PI)
    wipe = predict_wipe_delays(cfg, k, freq, delay0)
    center, head_k, seg_sums_k = hopper_wipeoff.mix_wipeoff(
        cfg, k, s, snp, phase, wipe, chunk, step, codes)
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


def channel_step_k(cfg: ReceiverConfig, k: int, states: ChannelState,
                   heavy: HeavyOut, stream_no0: int
                   ) -> tuple[ChannelState, ChannelOut]:
    """Cheap feedback for one K-block step, all channels: erase on a
    stream gap, the per-block scan (hopper_cheap.cheap_scan: means,
    retune rotation, quality ring, edges, amplitude, PLL), then the
    carry de-rotation, NCO update and output assembly.  Outputs are
    [C, k, ...]."""
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

    sno = torch.full_like(states.prev_stream, stream_no0 + k - 1)
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

    A chunk whose length is not a multiple of K runs fused steps over
    the divisible prefix and the K=1 path over the tail.  Outputs come
    back in stream order [T, C, ...]."""
    if cfg.cw_excision > 0:
        raise NotImplementedError(
            "cw_excision needs the front end, not yet ported")
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
    blocks = dsp.as_complex_input(blocks).contiguous()
    spec = corr.prep_spec(code_ffts)
    outs = []
    for step in range(t // k):
        heavy = heavy_stage(cfg, k, states, blocks, step, codes, code_ffts,
                            corr_spec=spec)
        states, out = channel_step_k(cfg, k, states, heavy,
                                     stream_no0 + k * step)
        outs.append(out)
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


# pack_states' key layout (gps_sdr_tpu/ops/tracking.py): complex leaves
# split into __re/__im, the long counters into __hi/__lo of base 4096
_STATE_SPLIT = {"ms_time", "prev_stream"}
_SPLIT_BASE = 4096


def states_from_numpy(tree: dict, device="cuda") -> ChannelState:
    """ChannelState on `device` from a dict of f32 arrays in the JAX
    pack_states layout (so one numpy state feeds both packages)."""
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
    pack_states layout."""
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
