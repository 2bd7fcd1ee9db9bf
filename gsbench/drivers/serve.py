"""The serving entry: S independent receivers off one card, or a mesh.

A pass is what `cli serve` does with a capture a stream: a fresh
StreamServer(cfg, S) (over make_stream_mesh(n) where the configuration
has n devices) runs every stream's capture from its own provider, and
each batch of S epochs goes to the evaluators in one process_many call,
as run_serve batches them.  Passes run back to back, closed loop.  The
benchmark times the process_many calls and reads the server's own stage
totals (StreamServer.perf).  The check judges every pass's answers of
at most CHECKED streams, drawn from the run's seed where there are
more, so that it stays shorter than the window.
"""

from __future__ import annotations

import time

import numpy as np

from gsbench.judge import StreamRecord, answers, last_sno

_pc = time.perf_counter
PERF_KEYS = ("dispatch", "pack", "stack", "transfer", "unpack", "consume")
CHECKED = 32


class Driver:
    def __init__(self, cfg, config: dict, traffic: dict, captures: list,
                 devices: list, seed: int = 0):
        from gps_sdr_tpu_torch.runtime.evaluator import (Evaluator,
                                                         process_many)
        from gps_sdr_tpu_torch.runtime.serving import StreamServer

        self._Server = StreamServer
        self._Evaluator = Evaluator
        self._process_many = process_many
        self.cfg = cfg
        self.captures = captures
        self.devices = devices
        self.n_streams = config["streams"]
        self.mesh = None
        if config["devices"] > 1:
            from gps_sdr_tpu_torch.parallel.mesh import make_stream_mesh
            self.mesh = make_stream_mesh(len(devices), devices=devices)
        self.streams_per_launch = self.n_streams // len(devices)
        n = len(captures)
        self.checked = set(range(n)) if n <= CHECKED else set(
            np.random.default_rng([seed % (1 << 64), 2]).choice(
                n, CHECKED, replace=False).tolist())
        self.win = None
        self._live = None
        self._k_done = 0
        self.signal_blocks = 0
        self.eval_s = 0.0
        self.perf = {k: 0.0 for k in PERF_KEYS}
        self.n_passes = 0
        self.sweeps = self.edge_overflows = 0

    def one_pass(self, win) -> list:
        cfg, s_n = self.cfg, self.n_streams
        srv = self._Server(cfg, s_n, device=self.devices[0], mesh=self.mesh)
        self._live = srv
        evs = [self._Evaluator(cfg) for _ in range(s_n)]
        recs = [StreamRecord(c.index, first_sno=1) for c in self.captures]
        counted = [0] * s_n
        providers = [(lambda first, n, x=c.data: x[first:first + n])
                     for c in self.captures]
        gen = srv.run(providers, self.captures[0].n_blocks // cfg.no_sec)
        pend: list = []
        for s, epoch in gen:
            pend.append((evs[s], epoch))
            if s in self.checked:
                recs[s].epochs.append(answers(epoch))
            if len(pend) < s_n:
                continue
            if win is not None and win.tracing:
                import torch
                with torch.profiler.record_function("gsbench.evaluator"):
                    t0 = _pc()
                    self._process_many(pend)
                    t1 = _pc()
            else:
                t0 = _pc()
                self._process_many(pend)
                t1 = _pc()
            if win is not None:
                self._account(pend, evs, counted, t0, t1)
            pend = []
            if win is not None and win.tick(t1):
                break
        else:
            if pend:
                self._process_many(pend)
        gen.close()
        if win is not None:
            for k in PERF_KEYS:
                self.perf[k] += srv.perf.get(k, 0.0)
        due = max((last_sno(e) or 0) for r in recs for e in r.epochs) \
            if any(r.epochs for r in recs) else 0
        for s, (rec, ev) in enumerate(zip(recs, evs)):
            rx = srv.receivers[s]
            self._k_done += rx.status.k_steps
            if win is not None:
                self.sweeps += rx.status.sweeps_served
                self.edge_overflows += rx.status.edge_overflows
            rec.found = {int(f[1]): (float(f[2]), float(f[3]))
                         for f in rx.found_sats}
            rec.ephemerides = {int(p): dict(e.ephem) for p, e in
                               ev.engines.items() if e.ephem_ok}
            rec.positions = np.asarray(ev.positions,
                                       np.float64).reshape(-1, 4)
            rec.due_end = due
            rec.complete = due == self.captures[s].n_blocks
        self._live = None
        return [r for r in recs if r.epochs]

    def _account(self, pend, evs, counted, t0, t1) -> None:
        win = self.win
        if t0 < win.t_end:
            self.eval_s += min(t1, win.t_end) - t0
        if t1 > win.t_end:
            return
        index = {id(ev): s for s, ev in enumerate(evs)}
        for ev, epoch in pend:
            s = index[id(ev)]
            end = last_sno(epoch)
            if end is not None and end > counted[s]:
                self.signal_blocks += end - counted[s]
                counted[s] = end

    def warm_up(self) -> None:
        self.one_pass(None)

    def counters(self) -> dict:
        from gsbench.harness import kernel_launches
        live = (sum(r.status.k_steps for r in self._live.receivers)
                if self._live is not None else 0)
        return dict(kernel_launches(), k_steps=self._k_done + live)

    def run_window(self, win) -> list:
        self.win = win
        self._k_done = 0
        records = []
        win.start()
        while not win.done:
            records += self.one_pass(win)
            self.n_passes += 1
            win.tick(_pc())
        return records

    @property
    def stats(self) -> dict:
        out = {"signal_s": self.signal_blocks * self.cfg.block_sec,
               "eval_s": self.eval_s, "passes": self.n_passes,
               "channel_sweeps": self.sweeps,
               "edge_overflows": self.edge_overflows}
        out.update({f"perf_{k}_s": v for k, v in self.perf.items()})
        return out
