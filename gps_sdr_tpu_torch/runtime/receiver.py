"""Receiver orchestrator on PyTorch: sample stream -> per-chunk epochs.

Port of gps_sdr_tpu/runtime/receiver.py: cold-start acquisition,
channel lifecycle, chunked tracking on the device, nav-bit assembly,
the re-acquisition service and epoch emission.  Two loops:

  * run(): host blocks are batched into chunks of `no_sec` blocks
    (~1 s) and uploaded: a capture's packed words (sources.replay_blocks)
    as they are, through a pinned staging buffer, and unpacked on the
    device; complex64 blocks as complex64 [T, ngps]; stream gaps are
    applied at chunk boundaries and detected on the device (erase
    semantics);
  * run_device(): device-resident streaming.  A chunk provider hands
    out chunks that already live on the device (models/scenario_dev.py,
    grouped planar); whole download windows of chunks are tracked and
    packed to the compact transport on the device (fused windows, or
    one chunk at a time), and one copy per window into a pinned host
    buffer, waited on by a CUDA event, brings the results to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.navmsg import NavDecoder
from gps_sdr_tpu_torch.ops import cacode, dsp
from gps_sdr_tpu_torch.runtime.channelmgr import SlotTable, select_sats
from gps_sdr_tpu_torch.runtime.evaluator import EpochInput
from gps_sdr_tpu_torch.utils.cplist import CodePhaseList
from gps_sdr_tpu_torch.utils.profiling import count, span
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops.acquisition import acquire_all
from gps_sdr_tpu_torch.ops.tracking import (_LAST_IDX, ChannelOut,
                                            cn0_from_amp,
                                            init_channel_states,
                                            outs_to_numpy,
                                            pack_outs_compact,
                                            reset_channel,
                                            summarize_states,
                                            track_chunk_batched_impl,
                                            track_chunk_impl,
                                            track_window_impl,
                                            unpack_outs_compact,
                                            unpack_window_compact)


@dataclass
class ReceiverStatus:
    stream_no: int = 0
    sweeps_served: int = 0
    warm_sweeps: int = 0        # cold sweeps on an almanac-narrowed grid
    blocks_processed: int = 0
    skipped_blocks: int = 0
    k_steps: int = 0            # K-block fused steps tracked
    edge_overflows: int = 0     # edges dropped by the compact download
                                # cap (cfg.edge_rate_cap); nonzero means
                                # nav bits may be corrupted that second


class Receiver:
    def __init__(self, cfg: ReceiverConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._codes_tab = cacode.ca_table(cfg)
        self._ffts_tab = cacode.ca_fft_table(cfg)
        n = cfg.max_sat
        self.states = init_channel_states(cfg, n, self.device)
        self.slots = SlotTable(n)
        self._codes = np.zeros((n, cfg.code_samples), np.float32)
        self._ffts = np.zeros((n, cfg.code_samples), np.complex64)
        self._refresh_code_tables()
        self.decoders = {}                 # slot -> NavDecoder
        self.sweep_all = True              # cold start
        self._stop = False
        self.status = ReceiverStatus()
        self.corr_quality: dict = {}       # prn -> (corr_q, corr_l)
        self.found_sats: list = []
        self.warm_hints: tuple | None = None   # (prns, doppler_bins)
        self._last_cp: dict = {}           # slot -> last code phase seen
        self._stage = None                 # pinned packed-word buffer
        self._staged = None                # event: its last copy is done

    # -- control surface
    def request_sweep(self) -> None:
        self.sweep_all = True

    def warm_start(self, almanacs: dict, rec_ecef, tow: int) -> bool:
        """Arm the next cold-start sweep with an almanac prediction: only
        the predicted-visible PRNs over the predicted Doppler span.
        Returns True if the hint was armed."""
        from gps_sdr_tpu_torch.models.almanac import acquisition_hints

        prns, bins = acquisition_hints(
            almanacs, rec_ecef, tow, step_freq=self.cfg.step_freq,
            max_prns=max(self.cfg.max_sat + 4, 12))
        if prns is None:
            return False
        self.warm_hints = (prns, bins)
        return True

    def stop(self) -> None:
        self._stop = True

    # -- channel lifecycle
    def _activate(self, prn: int, freq: float, delay: int) -> None:
        slot = self.slots.assign(prn)
        self.states = reset_channel(self.states, slot, prn, freq, delay,
                                    self.cfg)
        self._codes[slot] = self._codes_tab[prn]
        self._ffts[slot] = self._ffts_tab[prn]
        self.decoders[slot] = NavDecoder(ngps=self.cfg.ngps)
        self._last_cp.pop(slot, None)

    def _deactivate(self, prn: int) -> None:
        slot = self.slots.free(prn)
        self.states = reset_channel(self.states, slot, 0, 0.0, 0, self.cfg,
                                    active=False)
        self._codes[slot] = 0
        self._ffts[slot] = 0
        self.decoders.pop(slot, None)
        self._last_cp.pop(slot, None)

    def _refresh_code_tables(self) -> None:
        self._codes_dev = torch.as_tensor(self._codes, device=self.device)
        self._ffts_dev = torch.as_tensor(self._ffts, device=self.device)

    def _serve_sweep_all(self, block: np.ndarray,
                         found: list | None = None) -> None:
        """Cold start / global re-sweep: one full-grid acquisition and the
        channel-set update.  An armed warm hint narrows the first sweep;
        if it finds too few satellites the full grid runs.  `found`
        skips the acquisition and takes another receiver's result: the
        serving path's replicas of one capture see the same blocks, so
        StreamServer runs the grid once and hands its result on."""
        hints, self.warm_hints = self.warm_hints, None
        if found is not None:
            self.found_sats = list(found)
        else:
            self.found_sats = []
            if hints is not None:
                self.found_sats = acquire_all(
                    self.cfg, block, self._ffts_tab, prns=hints[0],
                    dopplers=hints[1], device=self.device)
                self.status.warm_sweeps += 1
            if len(self.found_sats) < self.cfg.min_sat:
                self.found_sats = acquire_all(self.cfg, block,
                                              self._ffts_tab,
                                              device=self.device)
        del_set, new_set = select_sats(self.slots.active, self.found_sats,
                                       self.corr_quality, self.cfg.max_sat)
        for prn in del_set:
            self._deactivate(prn)
        by_prn = {f[1]: f for f in self.found_sats}
        for prn in new_set:
            _, _, freq, delay = by_prn[prn]
            self._activate(prn, freq, delay)
        self._refresh_code_tables()
        self.sweep_all = False

    def _serve_channel_sweeps(self, block: np.ndarray,
                              request_slots: list[int]) -> list[int]:
        """Re-acquire the channels whose long-window correlation quality
        collapsed, as one batched grid search.  Returns served slots."""
        prns = [self.slots.slot_prn[s] for s in request_slots]
        found = acquire_all(self.cfg, block, self._ffts_tab, prns=prns,
                            device=self.device)
        by_prn = {f[1]: f for f in found}
        summary = summarize_states(self.cfg, self.states)
        for slot, prn in zip(request_slots, prns):
            if prn in by_prn:
                _, _, freq, delay = by_prn[prn]
            else:                               # restore on failure
                freq = float(summary["freq"][slot])
                delay = int(summary["delay"][slot])
            self.states = reset_channel(self.states, slot, prn, freq,
                                        delay, self.cfg)
            self.decoders[slot] = NavDecoder(ngps=self.cfg.ngps)
            self._last_cp.pop(slot, None)
            self.status.sweeps_served += 1
        return request_slots

    # -- main loop
    def run(self, block_iter, skip_iter=None):
        """Consume NGPS-sample blocks; yield EpochInput once per chunk.

        block_iter yields complex64[ngps] blocks, or a capture's packed
        uint16[ngps] words (sources.replay_blocks); skip_iter (optional)
        yields the number of blocks dropped before each block."""
        t = self.cfg.no_sec
        chunk: list[np.ndarray] = []
        skipped_before_chunk = 0

        for item in block_iter:
            if self._stop:
                return
            skip = next(skip_iter) if skip_iter is not None else 0
            if skip:
                # force a chunk boundary so the gap lands between chunks
                if chunk:
                    yield self._run_chunk(chunk, skipped_before_chunk)
                    chunk = []
                skipped_before_chunk = skip
                self.status.stream_no += skip
                self.status.skipped_blocks += skip

            if self.sweep_all:
                self._serve_sweep_all(item)
                self.status.stream_no += 1
                self.status.blocks_processed += 1
                continue

            chunk.append(item)
            if len(chunk) == t:
                yield self._run_chunk(chunk, skipped_before_chunk)
                skipped_before_chunk = 0
                chunk = []
        if chunk:
            yield self._run_chunk(chunk, skipped_before_chunk)

    def _run_chunk(self, chunk: list[np.ndarray],
                   skipped: int) -> EpochInput:
        with span("rx.chunk"):
            outs_dev, stream0 = self._dispatch_chunk(chunk)
            return self._consume_chunk(chunk, outs_dev, stream0, skipped)

    def _dispatch_chunk(self, chunk):
        """Enqueue one chunk's tracking; returns the device outputs and
        the chunk's first stream number.  `chunk` is a list of host
        blocks (see _upload) or a _DeviceChunk (already on the device,
        in any layout track_chunk_batched_impl takes)."""
        cfg = self.cfg
        stream0 = self.status.stream_no + 1
        if isinstance(chunk, _DeviceChunk):
            blocks = chunk.blocks_dev
        else:
            blocks = self._upload(chunk)
        if cfg.blocks_per_step > 1:
            self.states, outs = track_chunk_batched_impl(
                cfg, self.states, blocks, stream0, self._codes_dev,
                self._ffts_dev)
        else:
            self.states, outs = track_chunk_impl(
                cfg, self.states, blocks, stream0, self._codes_dev,
                self._ffts_dev)
        nb = len(chunk)
        self.status.k_steps += self._k_steps(nb)
        self.status.stream_no += nb
        self.status.blocks_processed += nb
        count("rx.blocks", nb)
        return outs, stream0

    def _upload(self, chunk: list) -> torch.Tensor:
        """A chunk of host blocks on the device as complex64 [T, ngps].
        A capture's packed words (uint16 or int16 blocks) cross as they
        are, 2 bytes a sample, and are unpacked on the device: on a card
        they are stacked into a pinned buffer kept across chunks and
        copied without blocking, and the next chunk's stack first waits
        for that copy.  Other blocks cross as complex64.  A chunk of
        both kinds is an error."""
        packed = [dsp.is_packed_words(b) for b in chunk]
        if any(packed) and not all(packed):
            raise ValueError("a chunk mixes packed IQ words with other "
                             "blocks")
        with span("rx.upload"):
            if packed[0] and self.device.type == "cuda":
                blocks = dsp.as_complex_input(self._pinned_copy(chunk))
            else:
                blocks = dsp.host_iq(np.stack(chunk), self.device)
        if packed[0]:
            count("rx.upload_bytes", 2 * blocks.numel())
            count("rx.packed_blocks", len(chunk))
        else:
            count("rx.upload_bytes", 8 * blocks.numel())
        return blocks

    def _pinned_copy(self, chunk: list) -> torch.Tensor:
        """The chunk's packed words stacked into the pinned staging
        buffer and copied to the card without blocking; the copy's event
        guards the buffer until the next chunk's stack."""
        n, shape = len(chunk), np.shape(chunk[0])
        if (self._stage is None or self._stage.shape[0] < n
                or tuple(self._stage.shape[1:]) != shape):
            self._stage = torch.empty((n,) + shape, dtype=torch.int16,
                                      pin_memory=True)
            self._staged = None
        if self._staged is not None:
            self._staged.synchronize()
        host = self._stage[:n]
        np.stack([np.asarray(b).view(np.uint16) for b in chunk],
                 out=host.numpy().view(np.uint16))
        words = host.to(self.device, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record(torch.cuda.current_stream(self.device))
        return words

    def _k_steps(self, n_blocks: int) -> int:
        """Fused K-block steps that tracking a chunk of n_blocks runs."""
        k = self.cfg.blocks_per_step
        return n_blocks // k if k > 1 else 0

    def _consume_chunk(self, chunk, outs_dev: ChannelOut, stream0: int,
                       skipped: int, poll: bool = True,
                       window: bool = False, dropped: int = 0):
        """One chunk's (or, with window=True, one concatenated download
        window's) tracking outputs -> EpochInput (host side).

        outs_dev holds tensors, or numpy arrays (unpack_outs_compact,
        which dropped `dropped` edges over its cap).  poll=False leaves
        the subframes in the decoders (cfg.defer_subframe_poll).
        window=True widens the last-block gates to the whole window:
        subframes poll if the channel was locked at ANY block, and a
        sweep request raised at ANY block is served."""
        cfg = self.cfg
        if isinstance(outs_dev.code_phase, np.ndarray):
            outs = outs_dev
        else:
            with span("rx.download"):
                outs = outs_to_numpy(outs_dev)
        with span("rx.nav"):
            self._note_dropped(dropped)
            coph: dict = {}
            cfrq: dict = {}
            wraps = 0
            for slot, prn in enumerate(self.slots.slot_prn):
                if prn == 0:
                    continue
                self.decoders[slot].push_chunk(
                    outs.sign0[:, slot], outs.edge_ms[:, slot],
                    outs.edge_local[:, slot], outs.edge_valid[:, slot],
                    stream_no0=stream0, erased=outs.erased[:, slot])
                cp = outs.code_phase[:, slot]
                ok = np.nonzero(cp >= 0)[0]
                wraps += self._delay_wraps(slot, cp[ok])
                if ok.size:
                    snos = stream0 + ok
                    coph[prn] = CodePhaseList(snos, cp[ok])
                    if cfg.carrier_smoothing > 0:
                        cfrq[prn] = CodePhaseList(snos, outs.freq[ok, slot])
                self.corr_quality[prn] = (float(outs.corr_q[-1, slot]),
                                          float(outs.corr_l[-1, slot]))

            frames: list = []
            for slot, prn in enumerate(self.slots.slot_prn):
                if prn == 0:
                    continue
                was_locked = (bool(outs.locked[:, slot].any()) if window
                              else bool(outs.locked[-1, slot]))
                subs = (self.decoders[slot].poll_subframes()
                        if poll and was_locked else [])
                if not subs:
                    subs = [{}]
                for sf in subs:
                    sf["SAT"] = prn
                    sf["AMP"] = float(outs.amplitude[-1, slot])
                    sf["CN0"] = float(cn0_from_amp(outs.amplitude[-1, slot]))
                    sf["CRM"] = float(outs.norm_max[-1, slot])
                    sf["FRQ"] = float(outs.freq[-1, slot])
                    sf["SWP"] = False
                frames += subs

            # per-channel sweep requests raised on the chunk's last block
            # (window mode: on any block)
            req_flags = (outs.sweep_request.any(axis=0) if window
                         else outs.sweep_request[-1])
            count("track.delay_wraps", wraps)
        self._serve_requests(chunk, req_flags, frames)
        return EpochInput(skipped_samples=skipped * cfg.ngps,
                          frames=frames, code_phases=coph,
                          carrier_freqs=cfrq or None)

    def _serve_requests(self, chunk, req_flags, frames: list) -> None:
        """Serve the sweep requests of the slots flagged in req_flags on
        the chunk's last block, and mark the swept satellites' frames."""
        req = [s for s in range(self.cfg.max_sat)
               if req_flags[s] and self.slots.slot_prn[s] != 0]
        if req:
            swept = self._serve_channel_sweeps(np.asarray(chunk[-1]), req)
            swept_prns = {self.slots.slot_prn[s] for s in swept}
            for sf in frames:
                if sf.get("SAT") in swept_prns:
                    sf["SWP"] = True

    def _consume_window_compact(self, chunk, cw, stream0: int, t: int,
                                poll: bool = True) -> EpochInput:
        """Window-mode consume straight from a CompactWindow (the sparse
        transport view, ops/tracking.py unpack_window_compact), without
        the dense-plane scatter: epoch for epoch identical to
        _consume_chunk(concat_outs(...), window=True).  `chunk` is the
        window's last chunk (sweep service)."""
        with span("rx.nav"):
            cfg = self.cfg
            sl = self._edge_sl
            w = cw.last.shape[0]
            li = _LAST_IDX
            self._note_dropped(int(cw.dropped.sum()))

            coph: dict = {}
            cfrq: dict = {}
            wraps = 0
            for slot, prn in enumerate(self.slots.slot_prn):
                if prn == 0:
                    continue
                aux = cw.aux[:, slot]
                dec = self.decoders[slot]
                pos = cw.edge_pos[:, slot]                     # [w, cap]
                valid = pos >= 0
                if (aux >= 4).any():
                    # rare (slot reset mid-window): rebuild this channel's
                    # dense planes and take the exact per-block erase path
                    n = w * t
                    ms_d = np.zeros((n, sl), np.int32)
                    loc_d = np.zeros((n, sl), np.int32)
                    val_d = np.zeros((n, sl), bool)
                    wk, ek = np.nonzero(valid)
                    if wk.size:
                        fp = pos[wk, ek]
                        tb = wk * t + fp // sl
                        es = fp % sl
                        ms_d[tb, es] = cw.edge_ms[:, slot][wk, ek]
                        loc_d[tb, es] = cw.edge_local[:, slot][wk, ek]
                        val_d[tb, es] = True
                    dec.push_chunk((aux % 4 - 1).astype(np.int8), ms_d,
                                   loc_d, val_d, stream_no0=stream0,
                                   erased=aux >= 4)
                else:
                    if dec.last_sign == 0:
                        nz = np.nonzero(aux != 1)[0]
                        if nz.size:
                            dec.last_sign = int(aux[nz[0]]) - 1
                    wk, ek = np.nonzero(valid)
                    if wk.size:
                        fp = pos[wk, ek]
                        blk = np.int64(stream0) + wk * t + fp // sl
                        st = blk * cfg.ngps \
                            + cw.edge_local[:, slot][wk, ek]
                        ms = (st // dec.ms_from_st if dec.ms_from_st
                              else cw.edge_ms[:, slot][wk, ek])
                        dec.edge_parts.append((ms.astype(np.int64), st))
                cp = cw.code_phase[:, slot]
                ok = np.nonzero(cp >= 0)[0]
                wraps += self._delay_wraps(slot, cp[ok])
                if ok.size:
                    snos = stream0 + ok
                    coph[prn] = CodePhaseList(snos, cp[ok])
                    if cfg.carrier_smoothing > 0:
                        cfrq[prn] = CodePhaseList(snos,
                                                  cw.freq[:, slot][ok])
                self.corr_quality[prn] = (
                    float(cw.last[-1, slot, li["corr_q"]]),
                    float(cw.last[-1, slot, li["corr_l"]]))

            frames: list = []
            for slot, prn in enumerate(self.slots.slot_prn):
                if prn == 0:
                    continue
                was_locked = bool(
                    (cw.last[:, slot, li["locked"]] > 0.5).any())
                subs = (self.decoders[slot].poll_subframes()
                        if poll and was_locked else [])
                if not subs:
                    subs = [{}]
                amp = float(cw.last[-1, slot, li["amplitude"]])
                for sf in subs:
                    sf["SAT"] = prn
                    sf["AMP"] = amp
                    sf["CN0"] = float(cn0_from_amp(amp))
                    sf["CRM"] = float(cw.last[-1, slot, li["norm_max"]])
                    sf["FRQ"] = float(cw.last[-1, slot, li["freq"]])
                    sf["SWP"] = False
                frames += subs

            req_flags = (cw.last[:, :, li["sweep_request"]] > 0.5).any(axis=0)
            count("track.delay_wraps", wraps)
        self._serve_requests(chunk, req_flags, frames)
        return EpochInput(skipped_samples=0, frames=frames,
                          code_phases=coph, carrier_freqs=cfrq or None)

    def run_device(self, chunk_provider, n_chunks: int,
                   chunk_blocks: int | None = None):
        """Device-resident streaming: IQ never crosses to the host.

        chunk_provider(first_block, n_blocks) -> tensor on this
        receiver's device, [n_blocks, ngps] complex64 or grouped planar
        f32[n_blocks, 2, n_cyc, cs] (DeviceScenarioSynth.chunk_planar).
        Yields EpochInput once per chunk like run(), or once per
        download window with cfg.epoch_per_window.

        cfg.chunks_per_download chunks form a download window.  With
        cfg.fused_window_dispatch a whole window is tracked and packed
        by track_window_impl; otherwise each chunk is dispatched and
        packed (pack_outs_compact) on its own.  Either way the window's
        packed rows come to the host in one copy, started as soon as
        the window is enqueued; with cfg.download_windows_in_flight = 2
        the host consumes window k while the device computes window
        k+1.  Channel sweeps take effect up to chunks_per_download
        chunks later than in run()."""
        cfg = self.cfg
        t = chunk_blocks or cfg.no_sec
        cap = self._edge_cap(t)
        w = max(1, cfg.chunks_per_download)
        inflight = max(1, cfg.download_windows_in_flight)
        with_freq = cfg.carrier_smoothing > 0
        held = []                       # [(chunk, packed_dev, stream0)]
        windows = []                    # [(items, _Download)]

        def flush_held():
            if held:
                windows.append((held[:], _Download(
                    torch.stack([p[1] for p in held]))))
                held.clear()

        def drain(count=None):
            n = len(windows) if count is None else count
            while n > 0 and windows:
                take, download = windows.pop(0)
                with span("rx.download"):
                    host = download.result()
                n -= 1
                if cfg.epoch_per_window:
                    # one consume pass over the whole window, straight
                    # from the sparse transport view
                    cw = unpack_window_compact(
                        host, len(take[0][0]), cfg.max_sat, self._edge_sl,
                        cap, with_freq)
                    yield self._consume_window_compact(
                        take[-1][0], cw, take[0][2], len(take[0][0]))
                    continue
                for i, ((chunk, _, stream0), row) in enumerate(
                        zip(take, host)):
                    outs, dropped = unpack_outs_compact(
                        row, len(chunk), cfg.max_sat, self._edge_sl, cap,
                        with_freq)
                    poll = (not cfg.defer_subframe_poll
                            or i == len(take) - 1)
                    yield self._consume_chunk(chunk, outs, stream0, 0,
                                              poll=poll,
                                              dropped=int(dropped.sum()))

        # stream numbering continues from wherever this receiver left
        # off; the provider's `first` stays relative to this call
        base = self.status.stream_no
        fused = cfg.fused_window_dispatch and w > 1
        ci = 0
        while ci < n_chunks:
            if self._stop:
                break
            first = ci * t
            if fused and ci + w <= n_chunks and not self.sweep_all:
                flush_held()          # partial window from a cold start
                blocks = chunk_provider(first, w * t)
                win = blocks.reshape((w, t) + tuple(blocks.shape[1:]))
                self.status.stream_no = base + first
                stream0 = self.status.stream_no + 1
                self.states, packed = track_window_impl(
                    cfg, self.states, win, stream0, self._codes_dev,
                    self._ffts_dev, cap, with_freq)
                self.status.stream_no += w * t
                self.status.blocks_processed += w * t
                self.status.k_steps += w * self._k_steps(t)
                count("rx.blocks", w * t)
                # win[i] is a view: nothing is copied unless a channel
                # sweep reads one of its blocks
                windows.append((
                    [(_DeviceChunk(win[i]), None, stream0 + i * t)
                     for i in range(w)], _Download(packed)))
                ci += w
                if len(windows) >= inflight:
                    yield from drain(1)
                continue
            blocks_dev = chunk_provider(first, t)
            if self.sweep_all:
                # the channel set changes the states: drain the pipeline
                # first; acquisition takes one block on the host
                flush_held()
                yield from drain()
                self._serve_sweep_all(_download_block(blocks_dev, 0))
            chunk = _DeviceChunk(blocks_dev)
            self.status.stream_no = base + first
            outs_dev, stream0 = self._dispatch_chunk(chunk)
            held.append((chunk, pack_outs_compact(outs_dev, cap, with_freq),
                         stream0))
            ci += 1
            if len(held) == w:
                flush_held()
            if len(windows) >= inflight:
                yield from drain(1)
        flush_held()
        yield from drain()

    def _note_dropped(self, n: int) -> None:
        """Count edges the compact download dropped over its cap (0
        where the outputs came whole)."""
        self.status.edge_overflows += n
        count("rx.edge_overflows", n)

    def _delay_wraps(self, slot: int, cp: np.ndarray) -> int:
        """How often the slot's code phase crossed the period boundary
        from one block to the next over `cp`, its valid code phases in
        block order, counting from the last one seen before them."""
        if not cp.size:
            return 0
        prev = self._last_cp.get(slot)
        self._last_cp[slot] = float(cp[-1])
        seq = cp if prev is None else np.concatenate([[prev], cp])
        return int((np.abs(np.diff(seq))
                    > 0.5 * self.cfg.code_samples).sum())

    def _edge_cap(self, chunk_blocks: int) -> int:
        """Compact-download edge capacity for a chunk of this length."""
        cfg = self.cfg
        return max(16, int(np.ceil(
            chunk_blocks * cfg.block_sec * cfg.edge_rate_cap)))

    @property
    def _edge_sl(self) -> int:
        return self.cfg.n_cyc + 1


class _DeviceChunk:
    """Adapter: lets the consume path treat a device chunk as the chunk
    (the sweep service reads its first or last block on the host).  A
    chunk of a fused window is a view, win[i], or win[i, s] for stream s
    of a serving window of independent front ends: nothing is copied
    unless a sweep reads one of its blocks."""

    def __init__(self, blocks_dev: torch.Tensor):
        self.blocks_dev = blocks_dev

    def __len__(self):
        return self.blocks_dev.shape[0]

    def __getitem__(self, i):
        if i == 0 or i == -1:
            return _download_block(self.blocks_dev, i)
        raise IndexError(i)


def concat_outs(outs_list: list) -> ChannelOut:
    """Concatenate per-chunk host ChannelOuts along the block axis (the
    window-merge contract: consume with the window's FIRST stream0 and
    the LAST chunk's blocks, and window=True)."""
    if len(outs_list) == 1:
        return outs_list[0]
    return ChannelOut(*[np.concatenate(f, axis=0) for f in zip(*outs_list)])


class _Download:
    """A device->host copy in flight: a pinned host buffer filled with
    non_blocking=True and a CUDA event that result() waits on.  A CPU
    tensor is its own host copy."""

    def __init__(self, arr: torch.Tensor):
        self.event = None
        if arr.device.type == "cuda":
            self.host = torch.empty(arr.shape, dtype=arr.dtype,
                                    pin_memory=True)
            self.host.copy_(arr, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(arr.device))
        else:
            self.host = arr

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _download_block(blocks_dev: torch.Tensor, i: int) -> np.ndarray:
    """Block i of a device chunk on the host as complex64[ngps].  Takes
    complex64 [T, ngps], planar f32[T, 2, ngps] or grouped planar
    f32[T, 2, n_cyc, cs] chunks."""
    blk = blocks_dev[i]
    if not blk.is_complex():
        blk = blk.reshape(2, -1)
        blk = torch.complex(blk[0], blk[1])
    return blk.cpu().numpy()
