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

With a stream mesh (parallel/mesh.py make_stream_mesh) the streams
split into contiguous groups, one a mesh device: each group keeps its
own stacked state, codes and FFTs on its device, a K-step runs one
wipeoff and one cheap launch a group, and each group's packed rows
cross to the host as one pinned copy a window, joined there in stream
order.  Streams share no state, so the split gives the same bits.

The device loop mirrors Receiver.run_device (one tracking call a
download window, windowed downloads in flight); host-side channel
management (the cold-start sweep, per-channel re-sweeps) runs per
stream and scatters its slot updates back into the stacked state.
Where the JAX module indexes a stacked window through _WindowChunk, a
torch window is indexed by a view (win[i] of the shared window or of a
stream's own).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.device import resolve_device
from gps_sdr_tpu_torch.ops.tracking import (_LAST_IDX, ChannelState,
                                            track_streams_window_impl,
                                            unpack_outs_compact,
                                            unpack_window_compact)
# not called here: kept importable for the benchmark's fault test, which
# patches it by this module's name
from gps_sdr_tpu_torch.ops.tracking import track_streams_impl  # noqa: F401
from gps_sdr_tpu_torch.runtime.receiver import (Receiver, _DeviceChunk,
                                                _Download, _download_block)
from gps_sdr_tpu_torch.utils.profiling import count, span


class _GroupDownload:
    """The stream groups' packed rows [w', S_g, L] in flight, one pinned
    copy a group; result() joins them on the host in stream order."""

    def __init__(self, parts: list):
        self.parts = [_Download(p) for p in parts]

    def result(self) -> np.ndarray:
        if len(self.parts) == 1:
            return self.parts[0].result()
        return np.concatenate([p.result() for p in self.parts], axis=1)


class StreamServer:
    """Serve S independent receivers from one card, or from the devices
    of a stream mesh."""

    def __init__(self, cfg: ReceiverConfig, n_streams: int, device="cuda",
                 mesh=None):
        """mesh: optional one-axis stream mesh
        (parallel.mesh.make_stream_mesh) to split the streams over its
        devices in contiguous groups, one a device; n_streams must divide
        by its size, and the streams then live on the mesh's devices
        (`device` is not used)."""
        self.cfg = cfg
        if mesh is None:
            devs = [resolve_device(device)]
        else:
            from gps_sdr_tpu_torch.parallel.mesh import STREAM_AXIS
            if mesh.axis_names != (STREAM_AXIS,):
                raise ValueError(f"a stream mesh has the one axis "
                                 f"({STREAM_AXIS!r},), not "
                                 f"{mesh.axis_names}")
            if n_streams % mesh.shape[STREAM_AXIS]:
                raise ValueError(
                    f"{n_streams} streams not divisible over "
                    f"{mesh.shape[STREAM_AXIS]} devices")
            devs = list(mesh.devices)
        self.device = devs[0]
        self._per = n_streams // len(devs)      # streams a group
        self._group_devs = devs
        self.receivers = [Receiver(cfg, device=devs[s // self._per])
                          for s in range(n_streams)]
        # per group, on its device: the stacked ChannelState with leading
        # [S_g] and the codes and FFTs [S_g, C, cs]
        self._stacked = None
        self._codes_dev = None
        self._ffts_dev = None
        self.perf: dict = {}

    @property
    def n_streams(self) -> int:
        return len(self.receivers)

    def _group_streams(self, g: int) -> range:
        return range(g * self._per, (g + 1) * self._per)

    def _restack(self) -> None:
        groups = [[self.receivers[s] for s in self._group_streams(g)]
                  for g in range(len(self._group_devs))]
        self._stacked = [ChannelState(*(torch.stack(f) for f in
                                        zip(*[r.states for r in rs])))
                         for rs in groups]
        self._codes_dev = [torch.stack([r._codes_dev for r in rs])
                           for rs in groups]
        self._ffts_dev = [torch.stack([r._ffts_dev for r in rs])
                          for rs in groups]

    def _slice_stream(self, s: int) -> ChannelState:
        """Stream s's state: views into its group's stack (every step
        makes new tensors, and _scatter_stream writes into copies, so a
        view stays the state it was taken of)."""
        g, r = divmod(s, self._per)
        return ChannelState(*(x[r] for x in self._stacked[g]))

    def _scatter_stream(self, s: int) -> None:
        """Push receiver s's (host-managed) state back into its group's
        stack."""
        g, r = divmod(s, self._per)

        def put(big, x):
            big = big.clone()
            big[r] = x
            return big
        rec = self.receivers[s]
        self._stacked[g] = ChannelState(*(put(b, x) for b, x in
                                          zip(self._stacked[g], rec.states)))
        self._codes_dev[g] = put(self._codes_dev[g], rec._codes_dev)
        self._ffts_dev[g] = put(self._ffts_dev[g], rec._ffts_dev)

    def _track(self, wins: list, shared: bool, stream0: int, cap: int,
               with_freq: bool) -> list:
        """track_streams_window_impl on every group, on its device:
        `wins` holds the one window [n, t, *iq] every stream reads
        (shared), or one a stream, stacked [n, S_g, t, *iq] for the
        group.  Returns the groups' packed rows, in stream order."""
        outs = []
        for g, dev in enumerate(self._group_devs):
            if shared:
                x = wins[0].to(dev)
            else:
                x = torch.stack([wins[s].to(dev)
                                 for s in self._group_streams(g)], dim=1)
            self._stacked[g], out = track_streams_window_impl(
                self.cfg, self._stacked[g], x, stream0, self._codes_dev[g],
                self._ffts_dev[g], cap, with_freq, shared)
            outs.append(out)
        return outs

    def _sweep_streams(self, providers: list, shared: bool, first: int,
                       t: int) -> None:
        """Serve the full-grid sweep of every stream that asks for one,
        on the first block of its chunk at `first`, and push the new
        channel sets into the stacked state."""
        acq = ([providers[0](first, t)] if shared
               else [p(first, t) for p in providers])
        # replicas of one capture see the same blocks, so the full-grid
        # acquisition gives the same result: run it once and hand it to
        # the other streams.  Warm-hinted receivers sweep their own
        # narrowed grid.
        shared_found = None
        for s, rec in enumerate(self.receivers):
            if not rec.sweep_all:
                continue
            blk0 = _download_block(acq[0 if shared else s], 0)
            if self._stacked is not None:
                rec.states = self._slice_stream(s)
            had_hints = rec.warm_hints is not None
            if shared and not had_hints and shared_found is not None:
                rec._serve_sweep_all(blk0, found=shared_found)
            else:
                rec._serve_sweep_all(blk0)
                if shared and not had_hints:
                    shared_found = rec.found_sats
            if self._stacked is not None:
                self._scatter_stream(s)
        if self._stacked is None:      # cold start: first stack
            self._restack()

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Time a stage of run() as span serve.<name> and add its
        seconds to self.perf[name]."""
        with span("serve." + name) as sp:
            yield
        self.perf[name] += sp.seconds

    def run(self, providers, n_chunks: int,
            chunk_blocks: int | None = None):
        """Yield (stream_idx, EpochInput) pairs, chunk-major.

        providers: one callable(first_block, n_blocks) -> device chunk
        ([n_blocks, ngps] complex64 or grouped planar f32[n_blocks, 2,
        n_cyc, cs]) shared by every stream (replicas of one capture), or
        a list of S callables (independent front ends).  `first_block`
        is relative to this call; stream numbers continue from where the
        receivers left off.

        cfg.chunks_per_download chunks form a download window: one call
        a provider hands out its blocks (one window read by every
        stream, or S windows, each then held in flight until drained),
        track_streams_window_impl tracks and packs them, and the groups'
        packed rows come to the host as one pinned copy a group.  A
        full sweep drains the windows in flight first; the window that
        follows starts with the swept chunk.

        Wall-clock stage totals of this call accumulate in `self.perf`
        (seconds), each the sum of the stage's span (serve.<stage>):
        dispatch (full sweeps, providers + tracking enqueue), stack (the
        start of a window's pinned copies), transfer (waiting for a
        window's copy), unpack (host decode of packed rows), consume
        (receiver nav/epoch build).  The evaluator's time is the
        caller's: everything outside the generator."""
        self.perf = {k: 0.0 for k in (
            "dispatch", "stack", "transfer", "unpack", "consume")}
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
        windows = []  # [(chunks [n][1 or S], stream0, _GroupDownload)]

        def consume(s, want_sweep, fn, chunks, *args, **kw):
            # expose this stream's device state to the host-side channel
            # manager only when a re-sweep will fire (it resets slots on
            # it), and push it back if one was served
            rec = self.receivers[s]
            if bool(want_sweep):
                rec.states = self._slice_stream(s)
            before = rec.status.sweeps_served
            epoch = fn(rec, chunks[0 if shared else s], *args, **kw)
            if rec.status.sweeps_served != before:
                self._scatter_stream(s)
            return epoch

        def drain(count=None):
            n = len(windows) if count is None else count
            while n > 0 and windows:
                chunks, stream0, download = windows.pop(0)
                n -= 1
                with self._stage("transfer"):
                    host = download.result()           # [n, S, L]
                if cfg.epoch_per_window:
                    # one consume pass per stream over the whole window,
                    # straight from the sparse transport view
                    for s in range(s_n):
                        with self._stage("unpack"):
                            cw = unpack_window_compact(
                                host[:, s], t, cfg.max_sat, sl, cap,
                                with_freq)
                        # closed before the yield: the generator suspends
                        # there, and the caller's work is not consume's
                        with self._stage("consume"):
                            out = consume(
                                s, (cw.last[:, :, _LAST_IDX["sweep_request"]]
                                    > 0.5).any(),
                                Receiver._consume_window_compact,
                                chunks[-1], cw, stream0, t)
                        yield s, out
                    continue
                for i, row in enumerate(host):
                    for s in range(s_n):
                        with self._stage("unpack"):
                            outs, dropped = unpack_outs_compact(
                                row[s], t, cfg.max_sat, sl, cap, with_freq)
                        with self._stage("consume"):
                            out = consume(
                                s, outs.sweep_request[-1].any(),
                                Receiver._consume_chunk, chunks[i], outs,
                                stream0 + i * t, 0,
                                dropped=int(dropped.sum()))
                        yield s, out

        def advance(n_blocks):
            for rec in self.receivers:
                rec.status.stream_no += n_blocks
                rec.status.blocks_processed += n_blocks
                rec.status.k_steps += rec._k_steps(t) * (n_blocks // t)
            count("rx.blocks", n_blocks * s_n)

        if self._stacked is None and not any(r.sweep_all
                                             for r in self.receivers):
            # resumed from a checkpoint (runtime/checkpoint.py
            # load_server): the receivers carry live states but there is
            # no stack yet
            self._restack()
        ci = 0
        while ci < n_chunks:
            first = ci * t
            n = min(w, n_chunks - ci)
            sweep = any(r.sweep_all for r in self.receivers)
            if sweep:
                # a sweep changes the states: drain the pipeline first
                yield from drain()
            with self._stage("dispatch"):
                if sweep:
                    self._sweep_streams(providers, shared, first, t)
                stream0 = self.receivers[0].status.stream_no + 1
                # [n, t, *iq]: the shared window, or one a stream
                wins = [b.reshape((n, t) + tuple(b.shape[1:])) for b in
                        (p(first, n * t) for p in
                         providers[:1 if shared else s_n])]
                packed = self._track(wins, shared, stream0, cap, with_freq)
                advance(n * t)
            with self._stage("stack"):
                windows.append(([[_DeviceChunk(x[i]) for x in wins]
                                 for i in range(n)], stream0,
                                _GroupDownload(packed)))
            ci += n
            if len(windows) >= inflight:
                yield from drain(1)
        yield from drain()
        # hand the final device states back to the receivers
        for s, rec in enumerate(self.receivers):
            rec.states = self._slice_stream(s)
