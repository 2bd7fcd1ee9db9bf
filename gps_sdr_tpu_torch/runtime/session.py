"""Top-level receiver session on PyTorch: source -> receiver -> evaluator.

Port of gps_sdr_tpu/runtime/session.py over the port's Receiver: the
host-fed run_source, the device-resident run_device_source, and the
evaluator-only paths: run_epoch_records (a recorded epoch fixture, the
reference's LOAD_PICKLE) and run_udp_followup (then live epochs over
UDP, runtime/transport.py).  The evaluator, I/O and reporters are the
port's copies of the JAX package's host modules, so fix-level results
differ from the JAX session only through the device half.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.runtime.evaluator import EpochInput, Evaluator
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.utils import io
from gps_sdr_tpu_torch.utils.profiling import span


@dataclass
class Session:
    cfg: ReceiverConfig
    device: str = "cuda"
    ephem_cache_path: str | None = None
    almanac_cache_path: str | None = None
    record_epochs_to: str | None = None
    reporter: object | None = None

    receiver: Receiver = None
    evaluator: Evaluator = None
    records: list = field(default_factory=list)
    summaries: list = field(default_factory=list)

    def __post_init__(self):
        with span("session.open"):
            preloaded = {}
            if self.ephem_cache_path:
                preloaded = io.load_ephemerides(self.ephem_cache_path)
            almanacs, iono = {}, None
            if self.almanac_cache_path:
                almanacs, iono = io.load_almanac(self.almanac_cache_path)
            self.receiver = Receiver(self.cfg, device=self.device)
            self.evaluator = Evaluator(self.cfg, preloaded_ephem=preloaded,
                                       iono_params=iono, almanacs=almanacs)

    def run_source(self, block_iter, skip_iter=None,
                   max_wall_sec: float | None = None) -> dict:
        """Run the full pipeline over a block source; returns a summary."""
        t0 = time.time()
        with span("session.run"):
            for epoch in self.receiver.run(block_iter, skip_iter=skip_iter):
                self._consume(epoch)
                if (max_wall_sec is not None
                        and time.time() - t0 > max_wall_sec):
                    self.receiver.stop()
        return self.final_summary()

    def run_device_source(self, chunk_provider, n_chunks: int,
                          chunk_blocks: int | None = None) -> dict:
        """Device-resident pipeline: IQ chunks live on the device
        (chunk_provider(first_block, n_blocks) -> tensor, e.g.
        DeviceScenarioSynth.chunk_planar); only epoch results cross to
        the host.  Returns the summary."""
        with span("session.run"):
            for epoch in self.receiver.run_device(chunk_provider, n_chunks,
                                                  chunk_blocks):
                self._consume(epoch)
        return self.final_summary()

    def run_epoch_records(self, records: list) -> dict:
        """Replay recorded epoch inputs through the evaluator only (the
        reference's LOAD_PICKLE path, gpseval.py:516-524)."""
        for rec in records:
            self._consume(rec if isinstance(rec, EpochInput)
                          else EpochInput(*rec))
        return self.final_summary()

    def run_udp_followup(self, max_sec: float | None = None,
                         idle_timeout: float = 30.0) -> dict:
        """Continue consuming epochs from the live UDP transport after a
        fixture replay ends (the reference's LOAD_PICKLE fall-through at
        list end, gpseval.py:516-524): statistics, ephemerides and the
        reporter carry over from the replayed prefix.  Ends after
        idle_timeout s without an epoch, or after max_sec s."""
        from gps_sdr_tpu_torch.runtime.transport import EpochReceiver

        rx = EpochReceiver()
        t0 = time.time()
        idle = 0.0
        try:
            while True:
                epoch = rx.recv()
                if epoch is None:
                    time.sleep(0.05)
                    idle += 0.05
                    if idle > idle_timeout or (
                            max_sec is not None
                            and time.time() - t0 > max_sec):
                        break
                    continue
                idle = 0.0
                self._consume(epoch)
        except KeyboardInterrupt:
            rx.request_stop()
        finally:
            rx.close()
        return self.final_summary()

    def _consume(self, epoch: EpochInput) -> None:
        if self.record_epochs_to is not None:
            rec = (epoch.skipped_samples, epoch.frames, epoch.code_phases)
            if epoch.carrier_freqs:
                rec += (epoch.carrier_freqs,)
            self.records.append(rec)
        summary = self.evaluator.process(epoch)
        self.summaries.append(summary)
        if self.cfg.almanac_resweep_sec > 0:
            self._almanac_maintenance(summary)
        if self.reporter is not None:
            self.reporter.update(epoch.frames, summary, self.evaluator)
            self._handle_ui_events()

    _last_maint = None

    def _almanac_maintenance(self, summary: dict) -> None:
        """Every cfg.almanac_resweep_sec, re-arm the sweep from the
        almanac and the current position (non-disruptive: the channel
        policy keeps locked satellites)."""
        gps_time = summary.get("gps_time")
        ev = self.evaluator
        if gps_time is None or not ev.almanacs or ev.warm_start is None:
            return
        if self._last_maint is None:
            self._last_maint = gps_time
            return
        if (gps_time - self._last_maint).total_seconds() \
                < self.cfg.almanac_resweep_sec:
            return
        self._last_maint = gps_time
        from gps_sdr_tpu_torch.utils.gpstime import gps_week_tow
        _, tow = gps_week_tow(gps_time)
        if self.receiver.warm_start(ev.almanacs, ev.warm_start[1:4], tow):
            self.receiver.request_sweep()

    def _handle_ui_events(self) -> None:
        """UI -> receiver control surface (sweep, stop, close, height)."""
        get = getattr(self.reporter, "get_events", None)
        if get is None:
            return
        for ev in get():
            if ev == "SWEEP":
                self.receiver.request_sweep()
            elif ev in ("STOP", "CLOSE"):
                self.receiver.stop()
                close = getattr(self.reporter, "close", None)
                if ev == "CLOSE" and close is not None:
                    close()
            elif isinstance(ev, tuple) and ev[0] == "SET_HEIGHT":
                self.evaluator.cfg = self.evaluator.cfg.replace(
                    height=float(ev[1]))
            elif ev == "MAP" and hasattr(self.reporter, "save_map"):
                path = self.reporter.save_map("gps_map.html")
                if path:
                    print(f"map written to {path}")
            elif ev == "CLEAR":
                # restart statistics/track without touching tracking
                ev_ = self.evaluator
                ev_.all_pos, ev_.positions = [], []
                ev_.outliers, ev_.fix_failures = [], []
                ev_.stat, ev_.last_pos_time = None, None
            elif ev == "HEIGHT":
                cfg = self.evaluator.cfg
                self.evaluator.cfg = cfg.replace(
                    conf_height=not cfg.conf_height)
                print(f"height constraint: "
                      f"{self.evaluator.cfg.conf_height}")

    def final_summary(self) -> dict:
        ev = self.evaluator
        return {
            "n_positions": len(ev.positions),
            "stat": ev.stat,
            "n_outliers": len(ev.outliers),
            "n_fix_failures": len(ev.fix_failures),
            "n_phase_errors": ev.n_phase_errors,
            "skipped_blocks": ev.skipped_blocks,
            "ephemerides": {sat: eng.ephem for sat, eng in
                            ev.engines.items() if eng.ephem_ok},
        }

    def save_outputs(self, prefix: str, save_track: bool = False) -> None:
        ev = self.evaluator
        io.save_results(prefix, sat_results=ev.sat_results,
                        positions=ev.positions,
                        velocities=ev.velocities or None,
                        filtered=ev.filtered or None)
        if self.ephem_cache_path:
            io.save_ephemerides(self.ephem_cache_path,
                                self.final_summary()["ephemerides"])
        if self.record_epochs_to:
            io.save_epoch_records(self.record_epochs_to, self.records)
        if self.almanac_cache_path and (ev.almanacs or ev.iono_params):
            io.save_almanac(self.almanac_cache_path, ev.almanacs,
                            iono_params=ev.iono_params)
        if save_track and ev.positions:
            from gps_sdr_tpu_torch.utils.geodesy import ecef_to_geo
            track = [ecef_to_geo(p[1:]) for p in ev.positions]
            io.save_gpx_track(f"{prefix}_track.gpx", track)
