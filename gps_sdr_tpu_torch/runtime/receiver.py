"""Receiver orchestrator on PyTorch: sample stream -> per-chunk epochs.

Port of the host-fed path of gps_sdr_tpu/runtime/receiver.py: cold-start
acquisition, channel lifecycle, chunked tracking on the device, nav-bit
assembly, the re-acquisition service and epoch emission.  Blocks are
batched into chunks of `no_sec` blocks (~1 s) and uploaded as
complex64 [T, ngps]; stream gaps are applied at chunk boundaries and
detected on the device (erase semantics).  The device-resident
`run_device` loop and its compact transport are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.models.navmsg import NavDecoder
from gps_sdr_tpu.ops import cacode
from gps_sdr_tpu.runtime.channelmgr import SlotTable, select_sats
from gps_sdr_tpu.runtime.evaluator import EpochInput
from gps_sdr_tpu.utils.cplist import CodePhaseList
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops.acquisition import acquire_all
from gps_sdr_tpu_torch.ops.tracking import (ChannelOut, cn0_from_amp,
                                            init_channel_states,
                                            outs_to_numpy, reset_channel,
                                            summarize_states,
                                            track_chunk_batched_impl,
                                            track_chunk_impl)


@dataclass
class ReceiverStatus:
    stream_no: int = 0
    sweeps_served: int = 0
    warm_sweeps: int = 0        # cold sweeps on an almanac-narrowed grid
    blocks_processed: int = 0
    skipped_blocks: int = 0
    k_steps: int = 0            # K-block fused steps tracked


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

    # -- control surface
    def request_sweep(self) -> None:
        self.sweep_all = True

    def warm_start(self, almanacs: dict, rec_ecef, tow: int) -> bool:
        """Arm the next cold-start sweep with an almanac prediction: only
        the predicted-visible PRNs over the predicted Doppler span.
        Returns True if the hint was armed."""
        from gps_sdr_tpu.models.almanac import acquisition_hints

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

    def _deactivate(self, prn: int) -> None:
        slot = self.slots.free(prn)
        self.states = reset_channel(self.states, slot, 0, 0.0, 0, self.cfg,
                                    active=False)
        self._codes[slot] = 0
        self._ffts[slot] = 0
        self.decoders.pop(slot, None)

    def _refresh_code_tables(self) -> None:
        self._codes_dev = torch.as_tensor(self._codes, device=self.device)
        self._ffts_dev = torch.as_tensor(self._ffts, device=self.device)

    def _serve_sweep_all(self, block: np.ndarray) -> None:
        """Cold start / global re-sweep: one full-grid acquisition and the
        channel-set update.  An armed warm hint narrows the first sweep;
        if it finds too few satellites the full grid runs."""
        hints, self.warm_hints = self.warm_hints, None
        self.found_sats = []
        if hints is not None:
            self.found_sats = acquire_all(
                self.cfg, block, self._ffts_tab, prns=hints[0],
                dopplers=hints[1], device=self.device)
            self.status.warm_sweeps += 1
        if len(self.found_sats) < self.cfg.min_sat:
            self.found_sats = acquire_all(self.cfg, block, self._ffts_tab,
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
            self.status.sweeps_served += 1
        return request_slots

    # -- main loop
    def run(self, block_iter, skip_iter=None):
        """Consume NGPS-sample blocks; yield EpochInput once per chunk.

        block_iter yields complex64[ngps]; skip_iter (optional) yields the
        number of blocks dropped before each block."""
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
        outs_dev, stream0 = self._dispatch_chunk(chunk)
        return self._consume_chunk(chunk, outs_dev, stream0, skipped)

    def _dispatch_chunk(self, chunk):
        """Upload one chunk and enqueue its tracking; returns the device
        outputs and the chunk's first stream number."""
        cfg = self.cfg
        stream0 = self.status.stream_no + 1
        blocks = torch.as_tensor(np.stack(chunk).astype(np.complex64,
                                                        copy=False),
                                 device=self.device)
        k = cfg.blocks_per_step
        if k > 1:
            self.states, outs = track_chunk_batched_impl(
                cfg, self.states, blocks, stream0, self._codes_dev,
                self._ffts_dev)
            self.status.k_steps += len(chunk) // k
        else:
            self.states, outs = track_chunk_impl(
                cfg, self.states, blocks, stream0, self._codes_dev,
                self._ffts_dev)
        nb = len(chunk)
        self.status.stream_no += nb
        self.status.blocks_processed += nb
        return outs, stream0

    def _consume_chunk(self, chunk, outs_dev: ChannelOut, stream0: int,
                       skipped: int):
        """One chunk's tracking outputs -> EpochInput (host side)."""
        cfg = self.cfg
        outs = outs_to_numpy(outs_dev)

        coph: dict = {}
        cfrq: dict = {}
        for slot, prn in enumerate(self.slots.slot_prn):
            if prn == 0:
                continue
            self.decoders[slot].push_chunk(
                outs.sign0[:, slot], outs.edge_ms[:, slot],
                outs.edge_local[:, slot], outs.edge_valid[:, slot],
                stream_no0=stream0, erased=outs.erased[:, slot])
            cp = outs.code_phase[:, slot]
            ok = np.nonzero(cp >= 0)[0]
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
            subs = (self.decoders[slot].poll_subframes()
                    if outs.locked[-1, slot] else [])
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
        req = [s for s in range(cfg.max_sat)
               if outs.sweep_request[-1, s] and self.slots.slot_prn[s] != 0]
        if req:
            swept = self._serve_channel_sweeps(np.asarray(chunk[-1]), req)
            swept_prns = {self.slots.slot_prn[s] for s in swept}
            for sf in frames:
                if sf.get("SAT") in swept_prns:
                    sf["SWP"] = True

        return EpochInput(skipped_samples=skipped * cfg.ngps,
                          frames=frames, code_phases=coph,
                          carrier_freqs=cfrq or None)
