"""Multi-receiver serving on PyTorch: S independent streams on one card.

Port of gps_sdr_tpu/runtime/serving.py.  One card serves many
concurrent front ends (fleets of receivers, wide-area monitoring), or
many replicas of one capture.  Each stream keeps its own Receiver (slot
table, nav decoders, status) and, by the caller, its own Evaluator; the
tracking state of all streams lives on the card stacked [S, C, ...],
and a chunk of every stream is tracked by one stream-stacked step
(ops/tracking.py track_streams_impl): per K-step one wipeoff launch,
with the streams on its grid's z axis, and one cheap launch over the
S*C channels, whatever S is.  The packed outputs of all streams cross
to the host as one pinned copy per download window.

The device loop mirrors Receiver.run_device (fused or per-chunk
dispatch, windowed downloads in flight); host-side channel management
(the cold-start sweep, per-channel re-sweeps) runs per stream and
scatters its slot updates back into the stacked state.  Where the JAX
module indexes a stacked window through _WindowChunk, a torch window is
indexed by a view (win[i], win[i, s]).
"""

from __future__ import annotations

import time

import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops.tracking import (_LAST_IDX, ChannelState,
                                            pack_outs_compact,
                                            track_streams_impl,
                                            track_streams_window_impl,
                                            unpack_outs_compact,
                                            unpack_window_compact)
from gps_sdr_tpu_torch.runtime.receiver import (Receiver, _DeviceChunk,
                                                _Download, _download_block)


class StreamServer:
    """Serve S independent receivers from one card."""

    def __init__(self, cfg: ReceiverConfig, n_streams: int, device="cuda",
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "sharding the stream axis over a device mesh is not yet "
                "ported to PyTorch")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.receivers = [Receiver(cfg, device=self.device)
                          for _ in range(n_streams)]
        self._stacked = None        # ChannelState with leading [S]
        self._codes_dev = None      # [S, C, cs]
        self._ffts_dev = None
        self.perf: dict = {}

    @property
    def n_streams(self) -> int:
        return len(self.receivers)

    def _restack(self) -> None:
        rs = self.receivers
        self._stacked = ChannelState(*(torch.stack(f) for f in
                                       zip(*[r.states for r in rs])))
        self._codes_dev = torch.stack([r._codes_dev for r in rs])
        self._ffts_dev = torch.stack([r._ffts_dev for r in rs])

    def _slice_stream(self, s: int) -> ChannelState:
        """Stream s's state: views into the stack (every step makes new
        tensors, and _scatter_stream writes into copies, so a view stays
        the state it was taken of)."""
        return ChannelState(*(x[s] for x in self._stacked))

    def _scatter_stream(self, s: int) -> None:
        """Push receiver s's (host-managed) state back into the stack."""
        def put(big, x):
            big = big.clone()
            big[s] = x
            return big
        rec = self.receivers[s]
        self._stacked = ChannelState(*(put(b, x) for b, x in
                                       zip(self._stacked, rec.states)))
        self._codes_dev = put(self._codes_dev, rec._codes_dev)
        self._ffts_dev = put(self._ffts_dev, rec._ffts_dev)

    def run(self, providers, n_chunks: int,
            chunk_blocks: int | None = None):
        """Yield (stream_idx, EpochInput) pairs, chunk-major.

        providers: one callable(first_block, n_blocks) -> device chunk
        ([n_blocks, ngps] complex64 or grouped planar f32[n_blocks, 2,
        n_cyc, cs]) shared by every stream (replicas of one capture), or
        a list of S callables (independent front ends).  `first_block`
        is relative to this call; stream numbers continue from where the
        receivers left off.

        Wall-clock stage totals accumulate in `self.perf` (seconds):
        dispatch (provider + tracking enqueue), pack, stack (window
        stacking + the start of its pinned copy), transfer (waiting for a
        window's copy), unpack (host decode of packed rows), consume
        (receiver nav/epoch build).  The evaluator's time is the
        caller's: everything outside the generator."""
        perf = self.perf = {k: 0.0 for k in (
            "dispatch", "pack", "stack", "transfer", "unpack", "consume")}
        _pc = time.perf_counter
        cfg = self.cfg
        s_n = self.n_streams
        if callable(providers):
            providers = [providers] * s_n
        shared = all(p is providers[0] for p in providers)
        t = chunk_blocks or cfg.no_sec
        cap = self.receivers[0]._edge_cap(t)
        sl = cfg.n_cyc + 1
        w = max(1, cfg.chunks_per_download)
        inflight = max(1, cfg.download_windows_in_flight)
        with_freq = cfg.carrier_smoothing > 0
        held = []                 # [(chunks, packed [S, L], stream0)]
        windows = []              # [(items [(chunks, stream0)], _Download)]

        def flush_held():
            if not held:
                return
            t0 = _pc()
            windows.append(([(c, n0) for c, _, n0 in held], _Download(
                torch.stack([p for _, p, _ in held]))))   # [w', S, L]
            held.clear()
            perf["stack"] += _pc() - t0

        def want_state(s, want_sweep):
            # expose this stream's device state to the host-side channel
            # manager only when a re-sweep will fire (it resets slots on
            # it); returns the sweeps served so far, to see if one was
            rec = self.receivers[s]
            if bool(want_sweep):
                rec.states = self._slice_stream(s)
            return rec.status.sweeps_served

        def consume_one(s, chunks, outs, stream0, poll):
            rec = self.receivers[s]
            before = want_state(s, outs.sweep_request[-1].any())
            epoch = rec._consume_chunk(chunks[0 if shared else s], outs,
                                       stream0, 0, poll=poll)
            if rec.status.sweeps_served != before:
                self._scatter_stream(s)
            return epoch

        def consume_window(s, chunks, cw, stream0):
            # window-mode consume over the sparse transport view
            rec = self.receivers[s]
            before = want_state(
                s, (cw.last[:, :, _LAST_IDX["sweep_request"]] > 0.5).any())
            epoch = rec._consume_window_compact(chunks[0 if shared else s],
                                                cw, stream0, t)
            if rec.status.sweeps_served != before:
                self._scatter_stream(s)
            return epoch

        def drain(count=None):
            n = len(windows) if count is None else count
            while n > 0 and windows:
                take, download = windows.pop(0)
                n -= 1
                t0 = _pc()
                host = download.result()           # [w', S, L]
                perf["transfer"] += _pc() - t0
                if cfg.epoch_per_window:
                    # one consume pass per stream over the whole window,
                    # straight from the sparse transport view
                    for s, rec in enumerate(self.receivers):
                        t2 = _pc()
                        cw = unpack_window_compact(
                            host[:, s], t, cfg.max_sat, sl, cap, with_freq)
                        rec.status.edge_overflows += int(cw.dropped.sum())
                        t3 = _pc()
                        perf["unpack"] += t3 - t2
                        # timed before the yield: the generator suspends
                        # there, and the caller's work is not consume's
                        out = consume_window(s, take[-1][0], cw, take[0][1])
                        perf["consume"] += _pc() - t3
                        yield s, out
                    continue
                for i, ((chunks, stream0), row) in enumerate(zip(take,
                                                                 host)):
                    poll = (not cfg.defer_subframe_poll
                            or i == len(take) - 1)
                    for s, rec in enumerate(self.receivers):
                        t2 = _pc()
                        outs, dropped = unpack_outs_compact(
                            row[s], t, cfg.max_sat, sl, cap, with_freq)
                        rec.status.edge_overflows += int(dropped.sum())
                        t3 = _pc()
                        perf["unpack"] += t3 - t2
                        out = consume_one(s, chunks, outs, stream0, poll)
                        perf["consume"] += _pc() - t3
                        yield s, out

        def advance(n_blocks):
            for rec in self.receivers:
                rec.status.stream_no += n_blocks
                rec.status.blocks_processed += n_blocks
                rec.status.k_steps += rec._k_steps(t) * (n_blocks // t)

        # fused window dispatch: a whole window of w chunks is tracked and
        # packed by one enqueue pass (track_streams_window_impl); shared
        # providers hand out one window read by every stream, independent
        # front ends S windows stacked [w, S, t, *iq] (each window in
        # flight then holds S chunks of IQ on the card until drained)
        fused = cfg.fused_window_dispatch and w > 1
        if self._stacked is None and not any(r.sweep_all
                                             for r in self.receivers):
            # resumed from a checkpoint (runtime/checkpoint.py
            # load_server): the receivers carry live states but there is
            # no stack yet
            self._restack()
        ci = 0
        while ci < n_chunks:
            t0 = _pc()
            first = ci * t
            if any(r.sweep_all for r in self.receivers):
                flush_held()
                yield from drain()
                acq = ([providers[0](first, t)] if shared
                       else [p(first, t) for p in providers])
                # replicas of one capture see the same blocks, so the
                # full-grid acquisition gives the same result: run it
                # once and hand it to the other streams.  Warm-hinted
                # receivers sweep their own narrowed grid.
                shared_found = None
                for s, rec in enumerate(self.receivers):
                    if not rec.sweep_all:
                        continue
                    blk0 = _download_block(acq[0 if shared else s], 0)
                    if self._stacked is not None:
                        rec.states = self._slice_stream(s)
                    had_hints = rec.warm_hints is not None
                    if (shared and not had_hints
                            and shared_found is not None):
                        rec._serve_sweep_all(blk0, found=shared_found)
                    else:
                        rec._serve_sweep_all(blk0)
                        if shared and not had_hints:
                            shared_found = rec.found_sats
                    if self._stacked is not None:
                        self._scatter_stream(s)
                if self._stacked is None:      # cold start: first stack
                    self._restack()
            stream0 = self.receivers[0].status.stream_no + 1
            if fused and ci + w <= n_chunks:
                flush_held()          # a partial window from a cold start
                if shared:
                    blocks = providers[0](first, w * t)
                    win = blocks.reshape((w, t) + tuple(blocks.shape[1:]))

                    def mk(i):
                        return [_DeviceChunk(win[i])]
                else:
                    win = torch.stack([
                        b.reshape((w, t) + tuple(b.shape[1:]))
                        for b in (p(first, w * t) for p in providers)],
                        dim=1)

                    def mk(i):
                        return [_DeviceChunk(win[i, s]) for s in range(s_n)]
                self._stacked, packed = track_streams_window_impl(
                    cfg, self._stacked, win, stream0, self._codes_dev,
                    self._ffts_dev, cap, with_freq, shared)
                advance(w * t)
                t1 = _pc()
                perf["dispatch"] += t1 - t0
                windows.append(([(mk(i), stream0 + i * t) for i in range(w)],
                                _Download(packed)))
                perf["stack"] += _pc() - t1
                ci += w
                if len(windows) >= inflight:
                    yield from drain(1)
                continue
            chunks = ([providers[0](first, t)] if shared
                      else [p(first, t) for p in providers])
            self._stacked, outs = track_streams_impl(
                cfg, self._stacked,
                chunks[0] if shared else torch.stack(chunks), stream0,
                self._codes_dev, self._ffts_dev, shared)
            advance(t)
            t1 = _pc()
            perf["dispatch"] += t1 - t0
            held.append(([_DeviceChunk(c) for c in chunks],
                         pack_outs_compact(outs, cap, with_freq), stream0))
            perf["pack"] += _pc() - t1
            ci += 1
            if len(held) == w:
                flush_held()
            if len(windows) >= inflight:
                yield from drain(1)
        flush_held()
        yield from drain()
        # hand the final device states back to the receivers
        for s, rec in enumerate(self.receivers):
            rec.states = self._slice_stream(s)

