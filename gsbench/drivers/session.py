"""The single-receiver entry: one Session a capture, back to back.

A file capture runs as `cli replay` runs it,
Session(cfg).run_source(replay_blocks(path, cfg)); a capture on the card
through Session.run_device_source.  Each capture gets a fresh Session,
cycling through the mix's captures, closed loop.  The benchmark puts a
proxy on Session.evaluator that times every call into the evaluator and
keeps each epoch for the check; for a file, it wraps the block source
to note when each block was asked for, so that an epoch's latency runs
from the request of the last block it reports (its chunk's last) to the
epoch leaving the evaluator, however far ahead of that epoch the
receiver has read.
"""

from __future__ import annotations

import time

import numpy as np

from gsbench.judge import StreamRecord, answers, last_sno

_pc = time.perf_counter


class _EvalProxy:
    """Session.evaluator's stand-in: the real evaluator's process() timed
    and counted; every other attribute is the evaluator's."""

    def __init__(self, inner, driver, rec: StreamRecord, session, window,
                 t_req: list):
        self._inner = inner
        self._drv = driver
        self._rec = rec
        self._sess = session
        self._win = window
        self._counted = 0
        self._t_req = t_req       # request time of the session's block i

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def process(self, epoch):
        win = self._win
        if win is not None and win.tracing:
            import torch
            with torch.profiler.record_function("gsbench.evaluator"):
                t0 = _pc()
                out = self._inner.process(epoch)
                t1 = _pc()
        else:
            t0 = _pc()
            out = self._inner.process(epoch)
            t1 = _pc()
        self._rec.epochs.append(answers(epoch))
        if win is not None:
            self._drv.account(self, epoch, t0, t1)
            if win.tick(t1):
                self._sess.receiver.stop()
        return out


class Driver:
    def __init__(self, cfg, config: dict, traffic: dict, captures: list,
                 devices: list, seed: int = 0):
        from gps_sdr_tpu_torch.runtime.sources import replay_blocks
        from gps_sdr_tpu_torch.runtime.session import Session

        self._Session = Session
        self._replay = replay_blocks
        self.cfg = cfg
        self.captures = captures
        self.device = devices[0]
        self.file = traffic["source"] == "file"
        self.win = None
        self._k_done = 0
        self._live = None
        self.signal_blocks = 0
        self.eval_s = 0.0
        self.latencies_ms: list = []
        self.n_sessions = 0
        self.sweeps = self.edge_overflows = 0
        self.streams_per_launch = 1

    def _blocks(self, path: str, t_req: list):
        """The file's blocks, noting in t_req when each was asked for
        (block i has stream number i + 1)."""
        it = self._replay(path, self.cfg)
        while True:
            t_req.append(_pc())
            try:
                blk = next(it)
            except StopIteration:
                return
            yield blk

    def account(self, proxy: _EvalProxy, epoch, t0: float, t1: float):
        """Count an epoch that left the evaluator at t1 into the window."""
        win = self.win
        if t0 < win.t_end:
            self.eval_s += min(t1, win.t_end) - t0
        if t1 > win.t_end:
            return
        end = last_sno(epoch)
        if end is None:
            end = proxy._sess.receiver.status.blocks_processed
        self.signal_blocks += max(0, end - proxy._counted)
        proxy._counted = max(proxy._counted, end)
        if self.file and 0 < end <= len(proxy._t_req):
            self.latencies_ms.append((t1 - proxy._t_req[end - 1]) * 1e3)

    def session(self, cap, window) -> StreamRecord:
        rec = StreamRecord(cap.index, first_sno=2 if self.file else 1)
        sess = self._Session(self.cfg, device=self.device)
        t_req: list = []
        sess.evaluator = _EvalProxy(sess.evaluator, self, rec, sess, window,
                                    t_req)
        self._live = sess
        if self.file:
            sess.run_source(self._blocks(cap.path, t_req))
        else:
            t = self.cfg.no_sec
            sess.run_device_source(
                lambda first, n, x=cap.data: x[first:first + n],
                cap.n_blocks // t)
        self._live = None
        st = sess.receiver.status
        self._k_done += st.k_steps
        if window is not None:
            self.sweeps += st.sweeps_served
            self.edge_overflows += st.edge_overflows
        ev = sess.evaluator._inner
        rec.found = {int(f[1]): (float(f[2]), float(f[3]))
                     for f in sess.receiver.found_sats}
        rec.ephemerides = {int(s): dict(e.ephem) for s, e in
                           ev.engines.items() if e.ephem_ok}
        rec.positions = np.asarray(ev.positions, np.float64).reshape(-1, 4)
        rec.due_end = st.blocks_processed
        rec.complete = st.blocks_processed == cap.n_blocks
        return rec

    def warm_up(self) -> None:
        self.session(self.captures[0], None)

    def counters(self) -> dict:
        from gsbench.harness import kernel_launches
        live = self._live.receiver.status.k_steps if self._live else 0
        return dict(kernel_launches(), k_steps=self._k_done + live)

    def run_window(self, win) -> list:
        self.win = win
        self._k_done = 0
        records = []
        win.start()
        i = 0
        while not win.done:
            cap = self.captures[i % len(self.captures)]
            rec = self.session(cap, win)
            if rec.epochs:
                records.append(rec)
            i += 1
            win.tick(_pc())
        self.n_sessions = i
        return records

    @property
    def stats(self) -> dict:
        lat = np.asarray(self.latencies_ms)
        bs = self.cfg.block_sec
        out = {"signal_s": self.signal_blocks * bs, "eval_s": self.eval_s,
               "receiver_s": self.win.seconds - self.eval_s,
               "sessions": self.n_sessions, "channel_sweeps": self.sweeps,
               "edge_overflows": self.edge_overflows}
        if len(lat):
            out.update(epochs=int(len(lat)),
                       epoch_p50_ms=float(np.percentile(lat, 50)),
                       epoch_p95_ms=float(np.percentile(lat, 95)))
        return out
