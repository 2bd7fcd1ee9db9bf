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
    grouped planar); each download window of chunks is tracked and
    packed to the compact transport on the device by one call, and one
    copy per window into a pinned host buffer, waited on by a CUDA
    event, brings the results to the host.
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
                                            reset_channel,
                                            summarize_states,
                                            track_chunk_batched_impl,
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
        self.states, outs = track_chunk_batched_impl(
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
                       skipped: int, window: bool = False, dropped: int = 0):
        """One chunk's (or, with window=True, one concatenated download
        window's) tracking outputs -> EpochInput (host side).

        outs_dev holds tensors, or numpy arrays (unpack_outs_compact,
        which dropped `dropped` edges over its cap).  window=True widens
        the last-block gates to the whole window: subframes poll if the
        channel was locked at ANY block, and a sweep request raised at
        ANY block is served."""
        if isinstance(outs_dev.code_phase, np.ndarray):
            outs = outs_dev
        else:
            with span("rx.download"):
                outs = outs_to_numpy(outs_dev)
        with span("rx.nav"):
            self._note_dropped(dropped)
            for slot, _ in self._live():
                self.decoders[slot].push_chunk(
                    outs.sign0[:, slot], outs.edge_ms[:, slot],
                    outs.edge_local[:, slot], outs.edge_valid[:, slot],
                    stream_no0=stream0, erased=outs.erased[:, slot])
            gate = (lambda x: x.any(axis=0)) if window else (lambda x: x[-1])
            epoch = self._epoch(
                stream0, skipped, outs.code_phase, outs.freq,
                {k: getattr(outs, k)[-1] for k in _LAST_IDX},
                gate(outs.locked))
            req_flags = gate(outs.sweep_request)
        self._serve_requests(chunk, req_flags, epoch.frames)
        return epoch

    def _consume_window_compact(self, chunk, cw, stream0: int,
                                t: int) -> EpochInput:
        """Window-mode consume straight from a CompactWindow (the sparse
        transport view, ops/tracking.py unpack_window_compact), without
        the dense-plane scatter: epoch for epoch identical to
        _consume_chunk(concat_outs(...), window=True).  `chunk` is the
        window's last chunk (sweep service)."""
        with span("rx.nav"):
            self._note_dropped(int(cw.dropped.sum()))
            for slot, _ in self._live():
                self._push_window(self.decoders[slot], cw, slot, stream0, t)

            def gate(name):
                return (cw.last[:, :, _LAST_IDX[name]] > 0.5).any(axis=0)
            epoch = self._epoch(
                stream0, 0, cw.code_phase, cw.freq,
                {k: cw.last[-1, :, i] for k, i in _LAST_IDX.items()},
                gate("locked"))
            req_flags = gate("sweep_request")
        self._serve_requests(chunk, req_flags, epoch.frames)
        return epoch

    def _push_window(self, dec: NavDecoder, cw, slot: int, stream0: int,
                     t: int) -> None:
        """Feed one channel's signs and edges of a CompactWindow to its
        decoder: the edge list as it is, or, where the slot was reset
        mid-window (rare), its dense planes rebuilt for the exact
        per-block erase path."""
        sl = self._edge_sl
        aux = cw.aux[:, slot]
        pos = cw.edge_pos[:, slot]                             # [w, cap]
        wk, ek = np.nonzero(pos >= 0)
        fp = pos[wk, ek]
        if (aux >= 4).any():
            n = cw.last.shape[0] * t
            ms_d = np.zeros((n, sl), np.int32)
            loc_d = np.zeros((n, sl), np.int32)
            val_d = np.zeros((n, sl), bool)
            if wk.size:
                tb = wk * t + fp // sl
                es = fp % sl
                ms_d[tb, es] = cw.edge_ms[:, slot][wk, ek]
                loc_d[tb, es] = cw.edge_local[:, slot][wk, ek]
                val_d[tb, es] = True
            dec.push_chunk((aux % 4 - 1).astype(np.int8), ms_d, loc_d,
                           val_d, stream_no0=stream0, erased=aux >= 4)
            return
        if dec.last_sign == 0:
            nz = np.nonzero(aux != 1)[0]
            if nz.size:
                dec.last_sign = int(aux[nz[0]]) - 1
        if wk.size:
            blk = np.int64(stream0) + wk * t + fp // sl
            st = blk * self.cfg.ngps + cw.edge_local[:, slot][wk, ek]
            ms = (st // dec.ms_from_st if dec.ms_from_st
                  else cw.edge_ms[:, slot][wk, ek])
            dec.edge_parts.append((ms.astype(np.int64), st))

    def _epoch(self, stream0: int, skipped: int, code_phase: np.ndarray,
               freq, last: dict, locked: np.ndarray) -> EpochInput:
        """The epoch both consumes build once the decoders are fed: the
        code-phase (and carrier) lists from the per-block planes [n, C],
        each channel's correlation quality and frame from `last` (its
        final block's outputs by _LAST_IDX name, [C] each), subframes
        polled where `locked`."""
        cfg = self.cfg
        coph: dict = {}
        cfrq: dict = {}
        wraps = 0
        for slot, prn in self._live():
            cp = code_phase[:, slot]
            ok = np.nonzero(cp >= 0)[0]
            wraps += self._delay_wraps(slot, cp[ok])
            if ok.size:
                snos = stream0 + ok
                coph[prn] = CodePhaseList(snos, cp[ok])
                if cfg.carrier_smoothing > 0:
                    cfrq[prn] = CodePhaseList(snos, freq[ok, slot])
            self.corr_quality[prn] = (float(last["corr_q"][slot]),
                                      float(last["corr_l"][slot]))

        frames: list = []
        for slot, prn in self._live():
            subs = (self.decoders[slot].poll_subframes() if locked[slot]
                    else [])
            if not subs:
                subs = [{}]
            amp = float(last["amplitude"][slot])
            for sf in subs:
                sf["SAT"] = prn
                sf["AMP"] = amp
                sf["CN0"] = float(cn0_from_amp(amp))
                sf["CRM"] = float(last["norm_max"][slot])
                sf["FRQ"] = float(last["freq"][slot])
                sf["SWP"] = False
            frames += subs
        count("track.delay_wraps", wraps)
        return EpochInput(skipped_samples=skipped * cfg.ngps, frames=frames,
                          code_phases=coph, carrier_freqs=cfrq or None)

    def _live(self) -> list:
        """(slot, prn) of every slot that tracks a satellite."""
        return [(s, p) for s, p in enumerate(self.slots.slot_prn) if p]

    def _serve_requests(self, chunk, req_flags, frames: list) -> None:
        """Serve the sweep requests of the slots flagged in req_flags on
        the chunk's last block, and mark the swept satellites' frames."""
        req = [s for s, _ in self._live() if req_flags[s]]
        if req:
            swept = self._serve_channel_sweeps(np.asarray(chunk[-1]), req)
            swept_prns = {self.slots.slot_prn[s] for s in swept}
            for sf in frames:
                if sf.get("SAT") in swept_prns:
                    sf["SWP"] = True

    def run_device(self, chunk_provider, n_chunks: int,
                   chunk_blocks: int | None = None):
        """Device-resident streaming: IQ never crosses to the host.

        chunk_provider(first_block, n_blocks) -> tensor on this
        receiver's device, [n_blocks, ngps] complex64 or grouped planar
        f32[n_blocks, 2, n_cyc, cs] (DeviceScenarioSynth.chunk_planar).
        Yields EpochInput once per chunk like run(), or once per
        download window with cfg.epoch_per_window.

        cfg.chunks_per_download chunks form a download window: one
        provider call hands out its blocks, track_window_impl tracks and
        packs them, and its packed rows come to the host in one copy,
        started as soon as the window is enqueued; with
        cfg.download_windows_in_flight = 2 the host consumes window k
        while the device computes window k+1.  A full sweep drains the
        windows in flight first; the swept chunk then forms a window of
        its own where a whole window still follows, and that window
        stays in flight until the next is enqueued.  These are the JAX
        module's boundaries and order, and they decide the epochs: a
        channel sweep served while a window is consumed resets the
        state after the windows already enqueued.  Channel sweeps take
        effect up to chunks_per_download chunks later than in run()."""
        cfg = self.cfg
        t = chunk_blocks or cfg.no_sec
        cap = self._edge_cap(t)
        w = max(1, cfg.chunks_per_download)
        inflight = max(1, cfg.download_windows_in_flight)
        with_freq = cfg.carrier_smoothing > 0
        windows = []                    # [(chunks, stream0, _Download)]

        def drain(count=None):
            n = len(windows) if count is None else count
            while n > 0 and windows:
                chunks, stream0, download = windows.pop(0)
                with span("rx.download"):
                    host = download.result()
                n -= 1
                if cfg.epoch_per_window:
                    # one consume pass over the whole window, straight
                    # from the sparse transport view
                    cw = unpack_window_compact(
                        host, t, cfg.max_sat, self._edge_sl, cap, with_freq)
                    yield self._consume_window_compact(chunks[-1], cw,
                                                       stream0, t)
                    continue
                for i, (chunk, row) in enumerate(zip(chunks, host)):
                    outs, dropped = unpack_outs_compact(
                        row, t, cfg.max_sat, self._edge_sl, cap, with_freq)
                    yield self._consume_chunk(chunk, outs, stream0 + i * t,
                                              0, dropped=int(dropped.sum()))

        # stream numbering continues from wherever this receiver left
        # off; the provider's `first` stays relative to this call
        base = self.status.stream_no
        ci = 0
        while ci < n_chunks:
            if self._stop:
                break
            first = ci * t
            n = min(w, n_chunks - ci)
            if self.sweep_all and ci + 1 + w <= n_chunks:
                n = 1
            blocks = chunk_provider(first, n * t)
            if self.sweep_all:
                # the channel set changes the states: drain the pipeline
                # first; acquisition takes one block on the host
                yield from drain()
                self._serve_sweep_all(_download_block(blocks, 0))
            win = blocks.reshape((n, t) + tuple(blocks.shape[1:]))
            self.status.stream_no = base + first
            stream0 = self.status.stream_no + 1
            self.states, packed = track_window_impl(
                cfg, self.states, win, stream0, self._codes_dev,
                self._ffts_dev, cap, with_freq)
            self.status.stream_no += n * t
            self.status.blocks_processed += n * t
            self.status.k_steps += n * self._k_steps(t)
            count("rx.blocks", n * t)
            # win[i] is a view: nothing is copied unless a channel sweep
            # reads one of its blocks
            windows.append(([_DeviceChunk(x) for x in win], stream0,
                            _Download(packed)))
            ci += n
            if n == w and len(windows) >= inflight:
                yield from drain(1)
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
    chunk of a download window is a view, win[i], or win[i, s] for
    stream s of a serving window of independent front ends: nothing is
    copied unless a sweep reads one of its blocks."""

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
