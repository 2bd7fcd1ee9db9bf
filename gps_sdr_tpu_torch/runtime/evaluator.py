"""Evaluation pipeline: subframes + code phases -> position fixes.

Host-side replacement for the reference evaluator process
(src/gpseval.py): code-phase overflow/phase-error hygiene
(cpOflCorrection/prepCodePhase, gpseval.py:372-457), routing into the
per-satellite pseudorange engines (evalData, gpseval.py:197-232), epoch
grouping + weighted Gauss-Newton fixes (ecefPositions,
gpseval.py:235-317), and outlier-gated running statistics
(ecefStatistics/meanSecPosition, gpseval.py:320-369).

In the reference this runs in its own OS process fed by UDP pickles; here
it's a plain object fed by the tracking runtime's epoch results — the
pipeline boundary is a host-side function call (SURVEY.md P2).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

import numpy as np

from gps_sdr_tpu_torch.config import GPS_C, L1_FREQ, ReceiverConfig
from gps_sdr_tpu_torch.models.ephemeris import SatStatus
from gps_sdr_tpu_torch.models.pseudorange import (PseudorangeEngine,
                                                  finish_deferred)
from gps_sdr_tpu_torch.nativecore import native_evalcore
from gps_sdr_tpu_torch.ops.pvt import (FixBatch, FixResult, solve_fix,
                                       solve_fix_batch,
                                       solve_velocity)
from gps_sdr_tpu_torch.utils.cplist import CodePhaseList, cp_arrays, cp_concat
from gps_sdr_tpu_torch.utils.gpstime import gps_datetime
from gps_sdr_tpu_torch.utils.profiling import span
from gps_sdr_tpu_torch.utils.tuplelog import TupleLog


# -- code-phase hygiene -------------------------------------------------------

def unwrap_numpy(nos, raw, cs, diff_tol):
    """The numpy unwrap core (what csrc/evalcore.cpp gsdr_unwrap
    computes): (corrected copy of raw, indices i of the physically
    impossible steps between entries i and i + 1)."""
    d = raw[:-1] - raw[1:]
    s = np.where(np.abs(np.abs(d) - cs) <= diff_tol, np.sign(d), 0.0)
    corr = raw.copy()
    corr[1:] += np.cumsum(s) * cs
    step = np.abs(np.diff(corr))
    gaps = np.diff(nos)
    return corr, np.nonzero(step > 1 + (gaps - 1) * 0.2)[0]


def unwrap_code_phases(sat_no: int, cplst: list, err_stream: dict,
                       prev_tail: tuple | None, cfg: ReceiverConfig,
                       log: list | None = None):
    """Unwrap 0<->2047 overflows within one code-phase list and vote
    for phase errors (cpOflCorrection, gpseval.py:377-417).

    A step between neighbours larger than (1 + 0.2*(gap-1)) samples is
    physically impossible (max drift 6.6 samples/s) and counts as a
    possible phase error for every stream in the gap; `err_stream`
    accumulates votes across satellites.  `prev_tail` is the previous
    list's last (sno, cp) for cross-list continuity checks.
    """
    diff_tol = 200
    max_diff_no = cfg.n_cyc // 4
    cs = cfg.code_samples
    n = len(cplst)
    if n > 1:
        # Vectorized unwrap.  In the sequential walk both the previous
        # and current phase carry the same accumulated offset when the
        # wrap test runs, so the test only ever sees RAW neighbour
        # differences — the correction is a plain cumulative sum of
        # per-step wrap signs.  Bit-identical to the reference loop.
        nos, raw = cp_arrays(cplst)
        core = native_evalcore()
        corr, flagged = (core.unwrap if core else unwrap_numpy)(
            nos, raw, cs, diff_tol)
        for i in flagged:
            no, pno = int(nos[i + 1]), int(nos[i])
            if log is not None:
                step_i = abs(float(corr[i + 1]) - float(corr[i]))
                log.append(f"{no} [{no-pno}]: code-phase step "
                           f"{step_i:.2f} - possible phase error")
            for j in range(no - pno):
                err_stream[no - j] = err_stream.get(no - j, 0) + 1
        cpl = CodePhaseList(nos, corr)
    else:
        cpl = (cplst if isinstance(cplst, CodePhaseList)
               else list(cplst))

    if len(cpl) and prev_tail is not None:
        no, cp = cpl[0]
        pno, pcp = prev_tail
        if no - pno <= max_diff_no:
            diff = pcp - cp
            if abs(abs(diff) - cs) <= diff_tol:
                cp += np.sign(diff) * cs
            if abs(cp - pcp) > (1 + (no - pno - 1) * 0.2):
                if log is not None:
                    log.append(f"{no} [{no-pno}]: cross-list step "
                               f"{abs(cp-pcp):.2f} - possible phase error")
                for j in range(no - pno):
                    err_stream[no - j] = err_stream.get(no - j, 0) + 1
    return cpl, err_stream


# -- evaluator ----------------------------------------------------------------

@dataclass
class EpochInput:
    """One reporting interval's worth of receiver output (the payload the
    reference pickles over UDP once per second, gpsrecv.py:509-519)."""

    skipped_samples: int
    frames: list                      # subframe dicts incl. SAT/AMP/CRM/FRQ
    code_phases: dict                 # {sat_no: [(stream_no, cp), ...]}
    carrier_freqs: dict | None = None
    # {sat_no: [(stream_no, tracked Hz)]}, aligned 1:1 with code_phases
    # entries; present when cfg.carrier_smoothing > 0 (Hatch filter)


def merge_epochs(epochs: list) -> EpochInput:
    """Concatenate consecutive reporting intervals into one EpochInput
    (throughput mode).

    One Evaluator.process call per download window instead of per chunk
    divides the per-call host overhead by the window length; the
    pseudorange engines keep per-second fit/slope segmentation
    internally (PseudorangeEngine._sigma_and_slope), so fixes match
    per-chunk processing up to boundary hygiene.  Costs up to one
    window of reporting latency — the latency-critical path stays
    per-chunk."""
    if len(epochs) == 1:
        return epochs[0]
    frames = [sf for e in epochs for sf in e.frames]
    coph: dict = {}
    cfrq: dict = {}
    for e in epochs:
        for sat, lst in e.code_phases.items():
            coph.setdefault(sat, []).append(lst)
        for sat, lst in (e.carrier_freqs or {}).items():
            cfrq.setdefault(sat, []).append(lst)
    coph = {sat: cp_concat(parts) for sat, parts in coph.items()}
    cfrq = {sat: cp_concat(parts) for sat, parts in cfrq.items()}
    return EpochInput(
        skipped_samples=sum(e.skipped_samples for e in epochs),
        frames=frames, code_phases=coph, carrier_freqs=cfrq or None)


@dataclass
class Evaluator:
    cfg: ReceiverConfig
    preloaded_ephem: dict = field(default_factory=dict)

    engines: dict = field(default_factory=dict)     # sat_no -> engine
    sat_log: dict = field(default_factory=dict)
    coph_tails: dict = field(default_factory=dict)  # sat_no -> (sno, cp)
    # per-fix result rows (satNo, tow, cyc, range_est, meas_delay) —
    # a column-chunked log (utils/tuplelog.py): materializing a tuple
    # per row was a measurable slice of the serving evaluate stage
    sat_results: object = field(default_factory=TupleLog)
    positions: list = field(default_factory=list)   # [posix_t, x, y, z]
    outliers: list = field(default_factory=list)
    fix_failures: list = field(default_factory=list)
    n_phase_errors: int = 0
    skipped_blocks: int = 0
    # running statistics: accepted positions in a growing [N, 3] f64
    # buffer (the list-of-rows form re-converted to an array on every
    # per-second stats update — ~25% of the serving evaluate stage at
    # S=32); the `all_pos` property keeps the sequence surface
    _pos_buf: np.ndarray = field(
        default_factory=lambda: np.empty((256, 3), np.float64))
    _pos_n: int = 0
    stat: tuple | None = None        # (mean[3], std[3], n, n_outliers)

    @property
    def all_pos(self) -> np.ndarray:
        return self._pos_buf[:self._pos_n]

    @all_pos.setter
    def all_pos(self, rows) -> None:
        v = np.asarray(rows, np.float64).reshape(-1, 3)
        self._pos_buf = v.copy()
        self._pos_n = v.shape[0]

    def _append_pos(self, pts: np.ndarray) -> None:
        n = self._pos_n + pts.shape[0]
        if n > self._pos_buf.shape[0]:
            grown = np.empty((max(n, 2 * self._pos_buf.shape[0]), 3),
                             np.float64)
            grown[:self._pos_n] = self._pos_buf[:self._pos_n]
            self._pos_buf = grown
        self._pos_buf[self._pos_n:n] = pts
        self._pos_n = n
    dop: tuple | None = None         # (gdop, pdop, hdop, vdop) of the
                                     # latest fixed epoch (unweighted
                                     # geometry; classic receiver
                                     # quality figure the reference
                                     # never reports)
    last_pos_time: float | None = None
    warm_start: np.ndarray | None = None
    clock_rate_est: float = 0.0      # filtered receiver-clock rate error
                                     # (sample-clock skew) when
                                     # cfg.solve_clock_rate; fed by a
                                     # per-chunk free-rate side solve
    iono_params: dict | None = None  # decoded SF4 page-18 coefficients
                                     # {"alpha": (4,), "beta": (4,)}
    almanacs: dict = field(default_factory=dict)   # prn -> almanac page
    velocities: list = field(default_factory=list)
    # [[posix_t, vx, vy, vz], ...] ECEF m/s, one Doppler velocity solve
    # per reporting interval (ops/pvt.py solve_velocity)
    vel_result: object | None = None  # latest VelocityResult
    tfilter: object | None = None     # TrackFilter when
                                      # cfg.track_filter_q > 0
    filtered: list = field(default_factory=list)
    # [[posix_t, x, y, z, vx, vy, vz], ...] filtered track states
    coasted: list = field(default_factory=list)
    # [[posix_t, x, y, z], ...] track-filter PREDICTIONS emitted for
    # intervals where satellites were tracked but too few for a fix
    # (urban-canyon outages) — the filter bridges the gap; the
    # reference simply stops producing positions
    raim_excluded: dict = field(default_factory=dict)
    # sat_no -> exclusion expiry [GPS seconds of week]
    raim_events: list = field(default_factory=list)
    # [(tow_sec, sat_no, sse_norm_before, sse_norm_after), ...]
    # per-epoch status for reporting
    err_msgs: dict = field(default_factory=dict)
    sweep_flags: dict = field(default_factory=dict)

    def engine(self, sat_no: int) -> PseudorangeEngine:
        if sat_no not in self.engines:
            self.sat_log[sat_no] = [f"LOG for Sat {sat_no}"]
            self.engines[sat_no] = PseudorangeEngine(
                sat_no, self.cfg,
                preloaded_ephem=self.preloaded_ephem.get(sat_no))
        return self.engines[sat_no]

    # -- hygiene (prepCodePhase, gpseval.py:436-457) --

    def _prep_code_phases(self, coph: dict) -> dict:
        min_sat_err = 3
        min_entries = self.cfg.n_cyc // 4
        cpl, err_stream = {}, {}
        for sat_no, lst in coph.items():
            if len(lst) >= min_entries:
                cpl[sat_no], err_stream = unwrap_code_phases(
                    sat_no, lst, err_stream, self.coph_tails.get(sat_no),
                    self.cfg, self.sat_log.get(sat_no))
        for sat_no, lst in cpl.items():
            if lst:
                self.coph_tails[sat_no] = lst[-1]
        if err_stream and max(err_stream.values()) >= min_sat_err:
            # >= 3 satellites jumped at the same stream: a global stream
            # loss corrupted every time reference -> poison-pill reset
            key_sno = max(err_stream, key=err_stream.get)
            for sat_no in self.sat_log:
                self.sat_log[sat_no].append(
                    f"{key_sno}: correlated phase error - new time ref")
                cpl[sat_no] = [(key_sno, None)]
            self.n_phase_errors += 1
        return cpl

    # -- per-satellite evaluation (evalData, gpseval.py:197-232) --

    def _eval_sats(self, frames: list, cpl: dict,
                   cfrq: dict | None = None):
        deferred, active = self._eval_sats_begin(frames, cpl, cfrq)
        # ONE vectorized orbit propagation across all satellites' rows
        sat_res = finish_deferred(deferred, self.cfg)
        return sat_res, active, self._gps_time_of(sat_res)

    def _gps_time_of(self, sat_res):
        if not len(sat_res):
            return None
        tow, week, cyc = (int(sat_res.tow[0]), int(sat_res.week[0]),
                          int(sat_res.cyc[0]))
        return gps_datetime(tow, week) + datetime.timedelta(
            seconds=cyc * self.cfg.n_cyc / 1000)

    def _eval_sats_begin(self, frames: list, cpl: dict,
                         cfrq: dict | None = None):
        """Frame ingest + per-satellite code-phase walk, stopping just
        before the orbit propagation — so a serving pool can batch THAT
        across streams (process_many)."""
        for sf in frames:
            sat_no = sf.get("SAT")
            if sat_no is None:
                continue
            eng = self.engine(sat_no)
            sf["EPH"] = "Ok" if eng.ephem_ok else ""
            if sf.get("SWP"):
                self.sweep_flags[sat_no] = "sweep"
            if "ID" in sf:
                eng.read_frame(sf)

        for sf in frames:
            # subframe-4/5 page payloads (models/navmsg.py): iono/UTC
            # coefficients and almanac pages are per-constellation, not
            # per-satellite — collected once, whichever channel decodes
            # them first
            if "alpha0" in sf:
                self.iono_params = {
                    "alpha": tuple(sf[f"alpha{i}"] for i in range(4)),
                    "beta": tuple(sf[f"beta{i}"] for i in range(4))}
            if "almE" in sf and 1 <= sf.get("svID", 0) <= 32:
                from gps_sdr_tpu_torch.models.almanac import ALM_KEYS
                self.almanacs[int(sf["svID"])] = {k: sf[k]
                                                  for k in ALM_KEYS}

        active = set()
        deferred = []
        for sat_no, lst in cpl.items():
            eng = self.engine(sat_no)
            if eng.status > SatStatus.NOT_READY:
                self.err_msgs[sat_no] = eng.status.name
            d = eng.eval_code_phases(lst, defer=True,
                                     freqs=(cfrq or {}).get(sat_no))
            if d:
                deferred.append(d)
                active.add(sat_no)
        return deferred, active

    # -- atmospheric pseudorange corrections (no reference equivalent) --

    def _atmos_correct(self, sat_res) -> None:
        """Subtract modeled ionospheric/tropospheric group delays from
        the measured receive timestamps, in place.

        Line-of-sight geometry comes from the current position estimate
        (warm_start; meter-class errors there move the elevation by
        micro-degrees — irrelevant).  The Klobuchar correction engages
        once a subframe-4 page 18 has been decoded; the troposphere
        needs no broadcast data.  Both delays are common-mode to first
        order (absorbed by the clock unknown) — what this removes is
        the DIFFERENTIAL part, the elevation-dependent meters that bias
        the fix systematically (the reference's 'rare systematic
        deviation >20 m', README.md:26)."""
        cfg = self.cfg
        if not len(sat_res) or self.warm_start is None:
            return
        from gps_sdr_tpu_torch.models.atmosphere import (azim_elev_batch,
                                                         klobuchar_delay,
                                                         tropo_delay)
        from gps_sdr_tpu_torch.utils.geodesy import ecef_to_geo
        rec = np.asarray(self.warm_start[1:4], np.float64)
        el, az = azim_elev_batch(rec, sat_res.pos)
        lat, lon, h = ecef_to_geo(rec)
        corr = np.zeros(len(sat_res), np.float64)
        if cfg.tropo_corr:
            corr += tropo_delay(el, h)
        if cfg.iono_corr and self.iono_params is not None:
            t_sec = (sat_res.tow - 1) * 6.0 \
                + sat_res.cyc * (cfg.n_cyc / 1000.0)
            corr += klobuchar_delay(
                self.iono_params["alpha"], self.iono_params["beta"],
                np.deg2rad(lat), np.deg2rad(lon), el, az, t_sec)
        sat_res.t -= corr

    # -- epoch grouping + fix (ecefPositions, gpseval.py:235-317) --

    def _fix_epochs(self, sat_res):
        prep, sat_pos_list = self._fix_prepare(sat_res)
        if prep is None:
            return sat_pos_list, [], []
        fixes = self._fix_solve(prep)
        rec_pos, fails = self._fix_finish(sat_res, prep, fixes)
        return sat_pos_list, rec_pos, fails

    def _fix_prepare(self, sat_res):
        """Pass 1: epoch grouping + the stacked solver operands.

        Returns (prep, sat_pos_list); prep is None when no epoch has
        enough satellites.  Split from _fix_solve/_fix_finish so the
        serving path (process_many) can stack MANY streams' epochs into
        ONE solve_fix_batch call — the per-stream GN solve was the
        largest single host cost at 8+ streams."""
        cfg = self.cfg
        min_sat = 3 if cfg.conf_height else 4
        calc_sat = max(cfg.min_sat, min_sat)
        sat_pos_list = []
        n = len(sat_res)
        if n == 0:
            return None, sat_pos_list
        # pass 1: group rows into (tow, cyc) epochs — all-array: sort
        # by (tow, cyc, sat), find group boundaries, keep groups with
        # >= calc_sat satellites
        order = np.lexsort((sat_res.sat_no, sat_res.cyc, sat_res.tow))
        tow = sat_res.tow[order]
        cyc = sat_res.cyc[order]
        is_new = np.ones(n, bool)
        is_new[1:] = (tow[1:] != tow[:-1]) | (cyc[1:] != cyc[:-1])
        starts = np.nonzero(is_new)[0]
        counts = np.diff(np.append(starts, n))
        kept = counts >= calc_sat
        gs, gc = starts[kept], counts[kept]
        E = len(gs)
        if E == 0:
            return None, sat_pos_list
        ktow = tow[gs]
        kcyc = cyc[gs]
        # satellite-position reporting once per new TOW (among kept
        # groups, in epoch order — ptow semantics of the reference loop)
        rep = np.ones(E, bool)
        rep[1:] = ktow[1:] != ktow[:-1]
        for e in np.nonzero(rep)[0]:
            rows = order[gs[e]:gs[e] + gc[e]]
            sat_pos_list += [(int(s), (float(p[0]), float(p[1]),
                                       float(p[2])))
                             for s, p in zip(sat_res.sat_no[rows],
                                             sat_res.pos[rows])]

        # pass 2: ONE stacked solve for all epochs (ops/pvt.py
        # solve_fix_batch — one [E, 4, 4] solve per GN iteration).
        # Epochs with fewer satellites pad to the chunk's max count by
        # duplicating their last satellite at sigma 1e7 (weight ~1e-14
        # of a real row — a sub-nanometer perturbation).  GN converges
        # to |delta| < max_residual/10, so sharing the chunk-entry warm
        # start across the batch yields the same optima the sequential
        # warm-start loop found.
        n_max = int(gc.max())
        j = np.arange(n_max)
        idx = order[gs[:, None] + np.minimum(j[None, :],
                                             (gc - 1)[:, None])]
        real = j[None, :] < gc[:, None]
        coords = sat_res.pos[idx].transpose(0, 2, 1)     # [E, 3, n_max]
        delays = sat_res.t[idx]
        sig = np.where(real,
                       sat_res.sigma[idx] if cfg.lsf_weight else 1.0,
                       1.0e7)
        return {"order": order, "gs": gs, "gc": gc, "ktow": ktow,
                "kcyc": kcyc, "coords": coords, "delays": delays,
                "sig": sig, "E": E, "n_max": n_max, "idx": idx,
                "real": real}, sat_pos_list

    def _fix_kw(self) -> dict:
        cfg = self.cfg
        return dict(max_it=cfg.lsf_max_it,
                    max_residual=cfg.max_residual / 10,
                    height=cfg.height if cfg.conf_height else None,
                    height_dev=cfg.height_dev,
                    clock_rate_fix=self.clock_rate_est)

    def _fix_solve(self, prep):
        """Pass 2: the stacked GN solve for one stream's epochs.
        Returns a FixBatch (aligned with epochs 0..E-1), or a dict of
        per-epoch FixResults from the singular-geometry fallback."""
        cfg = self.cfg
        coords, delays, sig = prep["coords"], prep["delays"], prep["sig"]
        gc, E = prep["gc"], prep["E"]
        fixes: dict[int, FixResult] = {}
        kw = self._fix_kw()
        try:
            return solve_fix_batch(coords, delays, std_dev=sig,
                                   rec_pos0=self.warm_start, **kw)
        except Exception:
            # singular geometry somewhere in the stack: retry each
            # epoch alone so only the bad one records EXCEPTION
            for e in range(E):
                ne = int(gc[e])
                try:
                    fixes[e] = solve_fix(
                        coords[e, :, :ne], delays[e, :ne],
                        std_dev=(sig[e, :ne] if cfg.lsf_weight
                                 else None),
                        rec_pos0=self.warm_start, **kw)
                except Exception:
                    pass
        return fixes

    def _fix_finish(self, sat_res, prep, fixes):
        """Pass 3: classification + bookkeeping, in epoch order.  The
        POSIX stamp is one datetime per distinct (tow, week) plus the
        cycle offset — building a datetime per epoch was measurable at
        the merged-window epoch counts.  A FixBatch takes the bulk
        array path (unless the track filter needs its sequential
        per-epoch updates); dict fallbacks keep the per-epoch loop."""
        if isinstance(fixes, FixBatch):
            if self.tfilter is None:
                return self._fix_finish_batch(sat_res, prep, fixes)
            fixes = dict(enumerate(fixes))
        cfg = self.cfg
        order, gs, gc = prep["order"], prep["gs"], prep["gc"]
        ktow, kcyc, E = prep["ktow"], prep["kcyc"], prep["E"]
        rec_pos, fails = [], []
        tcache: dict = {}
        for e in range(E):
            tw, cy = int(ktow[e]), int(kcyc[e])
            fix = fixes.get(e)
            if fix is None:
                fails.append((tw, cy, "EXCEPTION"))
                continue
            if fix.residual <= cfg.max_residual:
                week = int(sat_res.week[order[gs[e]]])
                base = tcache.get((tw, week))
                if base is None:
                    base = gps_datetime(tw, week).timestamp()
                    tcache[(tw, week)] = base
                entry = fix.rec_pos.copy()
                entry[0] = base + cy * cfg.n_cyc / 1000
                rec_pos.append(entry)
                if self.tfilter is not None:
                    # carrier smoothing correlates fix noise over its
                    # ~N-block EMA window while (J'WJ)^-1 prices each
                    # fix as independent; inflating R by N keeps the
                    # filter's information intake at the true rate
                    # (and the innovation gate honest)
                    r = None
                    if fix.cov is not None:
                        r = fix.cov[1:, 1:] * max(
                            1, cfg.carrier_smoothing)
                    if self.tfilter.update_pos(
                            entry[0], fix.rec_pos[1:].copy(), r):
                        self.filtered.append(
                            [entry[0], *map(float, self.tfilter.pos),
                             *map(float, self.tfilter.vel)])
                self.warm_start = np.concatenate(
                    [[0.0], fix.rec_pos[1:]])
                ne = int(gc[e])
                sats = sat_res.sat_no[order[gs[e]:gs[e] + ne]].tolist()
                self.sat_results += list(zip(
                    sats, [tw] * ne, [cy] * ne,
                    np.asarray(fix.range_est[:ne], float).tolist(),
                    np.asarray(fix.meas_delay[:ne], float).tolist()))
            else:
                fails.append((tw, cy, "MAX_RESIDUAL"))
        if rec_pos:
            self._update_dop(np.asarray(self.warm_start[1:4]),
                             sat_res, order, gs, gc)
        return rec_pos, fails

    def _fix_finish_batch(self, sat_res, prep, fixes):
        """Vectorized pass 3 for the FixBatch path: one residual gate,
        one bulk timestamp build, one bulk sat_results extension —
        epoch-for-epoch identical to the sequential loop (the loop's
        progressive warm_start has no in-call effect beyond its final
        value)."""
        cfg = self.cfg
        order, gs, gc = prep["order"], prep["gs"], prep["gc"]
        ktow, kcyc = prep["ktow"], prep["kcyc"]
        ok = fixes.residual <= cfg.max_residual
        ok_idx = np.nonzero(ok)[0]
        fails = [(int(ktow[e]), int(kcyc[e]), "MAX_RESIDUAL")
                 for e in np.nonzero(~ok)[0]]
        if not ok_idx.size:
            return [], fails
        tw = ktow[ok_idx]
        wk = sat_res.week[order[gs[ok_idx]]]
        uniq, inv = np.unique(np.stack([tw, wk], 1), axis=0,
                              return_inverse=True)
        bases = np.array([gps_datetime(int(t), int(w)).timestamp()
                          for t, w in uniq])
        ts = bases[inv] + kcyc[ok_idx] * (cfg.n_cyc / 1000.0)
        entries = np.concatenate([ts[:, None], fixes.pos[ok_idx, 1:4]],
                                 axis=1)
        rec_pos = list(entries)
        self.warm_start = np.concatenate(
            [[0.0], fixes.pos[ok_idx[-1], 1:4]])
        sel, rm = prep["idx"][ok_idx], prep["real"][ok_idx]
        nk = gc[ok_idx]
        nm = prep["n_max"]     # cross-stream stacks pad columns beyond
        #                        this stream's own max satellite count
        self.sat_results.extend_cols(
            sat_res.sat_no[sel][rm],
            np.repeat(tw, nk),
            np.repeat(kcyc[ok_idx], nk),
            fixes.range_est[ok_idx][:, :nm][rm],
            fixes.meas_delay[ok_idx][:, :nm][rm])
        self._update_dop(np.asarray(self.warm_start[1:4]),
                         sat_res, order, gs, gc)
        return rec_pos, fails

    def _update_dop(self, rec, sat_res, order, gs, gc) -> None:
        """Dilution of precision of the last epoch (unweighted
        geometry): GDOP/PDOP/HDOP/VDOP from (G'G)^-1 with the position
        block rotated into the local ENU frame."""
        from gps_sdr_tpu_torch.utils.geodesy import ecef_to_geo
        e = len(gs) - 1
        rows = order[gs[e]:gs[e] + gc[e]]
        los = sat_res.pos[rows] - rec[None, :]
        los /= np.linalg.norm(los, axis=1, keepdims=True)
        g = np.hstack([los, -np.ones((len(rows), 1))])
        try:
            q = np.linalg.inv(g.T @ g)
        except np.linalg.LinAlgError:
            return
        lat, lon, _ = ecef_to_geo(rec)
        lat, lon = np.deg2rad(lat), np.deg2rad(lon)
        sl, cl = np.sin(lat), np.cos(lat)
        so, co = np.sin(lon), np.cos(lon)
        r_enu = np.array([[-so, co, 0.0],
                          [-sl * co, -sl * so, cl],
                          [cl * co, cl * so, sl]])
        q_enu = r_enu @ q[:3, :3] @ r_enu.T
        self.dop = (float(np.sqrt(max(np.trace(q), 0.0))),
                    float(np.sqrt(max(np.trace(q[:3, :3]), 0.0))),
                    float(np.sqrt(max(q_enu[0, 0] + q_enu[1, 1], 0.0))),
                    float(np.sqrt(max(q_enu[2, 2], 0.0))))

    # -- statistics (ecefStatistics, gpseval.py:332-369) --

    def _update_stats(self, rec_pos: list) -> list:
        cfg = self.cfg
        pts = np.array([p[1:] for p in rec_pos], np.float64)
        new_time = rec_pos[0][0]
        if self.last_pos_time is None:
            self.last_pos_time = new_time
        mean = (self.stat[0] if self.stat is not None
                else pts.mean(axis=0))
        gate = cfg.min_out_dist + (new_time - self.last_pos_time) \
            * cfg.max_speed
        dist = np.linalg.norm(pts - mean, axis=1)
        ok = dist <= gate
        self.outliers.extend(rec_pos[i] for i in np.nonzero(~ok)[0])
        keep = [rec_pos[i] for i in np.nonzero(ok)[0]]
        if keep:
            self._append_pos(pts[ok])
            self.last_pos_time = keep[-1][0]
            n_avg = cfg.pos_avg_in_sec * (1024 // cfg.n_cyc)
            a = max(0, self._pos_n - n_avg) if n_avg > 0 else 0
            window = self._pos_buf[a:self._pos_n]
            self.stat = (window.mean(axis=0), window.std(axis=0),
                         len(window), len(self.outliers))
        return keep

    # -- receiver-clock rate (sample-clock skew) estimation --

    def _update_clock_rate(self, frames: list, sat_res: list) -> None:
        """Estimate the fractional receiver-clock rate error y from the
        COMMON carrier-frequency offset: one oscillator drives both the
        LO and the ADC, so every tracked carrier reads
        f_trk = f_geometric - y*L1.  With a position and ephemerides,
        f_geometric is computable per satellite, and the median of
        (f_geo - f_trk)/L1 observes y to ~1e-9 per chunk — unlike a
        free rate unknown in the fix, whose column is near-collinear
        with height and amplifies model noise ~1000x.  The estimate
        de-scales the pseudorange delay differences (solve_fix
        clock_rate_fix), replacing the reference's mandatory
        SDR_FREQCORR calibration (README.md:204-217)."""
        if self.warm_start is None or not len(sat_res):
            return
        rec = np.asarray(self.warm_start[1:4], np.float64)
        i = int(np.lexsort((sat_res.cyc, sat_res.tow))[-1])
        tow, cyc = int(sat_res.tow[i]), int(sat_res.cyc[i])
        dt = cyc * self.cfg.n_cyc / 1000.0
        freq = {sf["SAT"]: sf["FRQ"] for sf in frames
                if sf.get("SAT") is not None and "FRQ" in sf}
        rows = [(f, self.engines[s].ephem) for s, f in freq.items()
                if s in self.engines and self.engines[s].ephem_ok]
        ys = []
        if rows:
            # one batched orbit pass over all satellites x (dt -+ 0.5)
            # (models/pseudorange.py ecef_mat; elementwise, identical
            # to the per-satellite calls)
            from gps_sdr_tpu_torch.models.pseudorange import (EPHEM_KEYS,
                                                              ecef_mat)
            vals = np.array([[e[k] for k in EPHEM_KEYS]
                             for _f, e in rows], np.float64)
            n = len(rows)
            dts = np.concatenate([np.full(n, dt - 0.5),
                                  np.full(n, dt + 0.5)])
            x, y, z, _ = ecef_mat(float(tow), dts,
                                  np.tile(vals, (2, 1)))
            p = np.stack([x, y, z])                 # [3, 2n]
            rate = (np.linalg.norm(p[:, n:] - rec[:, None], axis=0)
                    - np.linalg.norm(p[:, :n] - rec[:, None], axis=0))
            f_geo = -rate / GPS_C * L1_FREQ
            f_trk = np.array([f for f, _e in rows], np.float64)
            ys = (f_geo - f_trk) / L1_FREQ
        if len(ys) >= 4:
            y_obs = float(np.median(ys))
            a = 0.3 if self.clock_rate_est != 0.0 else 1.0
            self.clock_rate_est += a * (y_obs - self.clock_rate_est)

    # -- RAIM fault detection & exclusion (no reference equivalent) --

    def _raim_drop_excluded(self, sat_res):
        """Remove rows of currently-excluded satellites (exclusions
        expire after cfg.raim_exclude_sec of GPS time)."""
        if not self.raim_excluded or not len(sat_res):
            return sat_res
        tsec = (sat_res.tow - 1) * 6.0 \
            + sat_res.cyc * (self.cfg.n_cyc / 1000.0)
        self.raim_excluded = {
            s: exp for s, exp in self.raim_excluded.items()
            if exp > tsec.max()}
        if not self.raim_excluded:
            return sat_res
        keep = ~np.isin(sat_res.sat_no,
                        np.fromiter(self.raim_excluded, np.int64))
        if keep.all():
            return sat_res
        from gps_sdr_tpu_torch.models.pseudorange import SatRows
        return SatRows(sat_no=sat_res.sat_no[keep],
                       tow=sat_res.tow[keep], pos=sat_res.pos[keep],
                       t=sat_res.t[keep], week=sat_res.week[keep],
                       cyc=sat_res.cyc[keep],
                       sigma=sat_res.sigma[keep])

    def _raim_detect(self, sat_res) -> None:
        """Chi-square fault detection BEFORE the reporting solve, on
        one throwaway epoch solve per interval; on a trip with >= 6
        satellites, exclusion search: re-solve leaving each satellite
        out, and bar the one whose removal repairs the statistic.
        Classic RAIM FDE — the reference can only reject whole fixes
        (MAX_RESIDUAL, gpseval.py:298-315), so one faulty SV clock
        silently biases every epoch it is in.

        Test-epoch selection matters: chunk-tail epochs sit in a fresh
        sigma segment and carry the 0.5-sample fallback sigma (73 m),
        deflating the statistic ~300x — pick the epoch with the most
        satellites among those with honest (fitted) sigmas."""
        n_rows = len(sat_res)
        if n_rows == 0:
            return
        order = np.lexsort((sat_res.sat_no, sat_res.cyc, sat_res.tow))
        tow = sat_res.tow[order]
        cyc = sat_res.cyc[order]
        is_new = np.ones(n_rows, bool)
        is_new[1:] = (tow[1:] != tow[:-1]) | (cyc[1:] != cyc[:-1])
        starts = np.nonzero(is_new)[0]
        counts = np.diff(np.append(starts, n_rows))
        best_e, best_score = None, (-1, -1)
        for e in range(len(starts)):
            rows = order[starts[e]:starts[e] + counts[e]]
            score = (int(sat_res.sigma[rows].max() < 50.0),
                     int(counts[e]))
            if score >= best_score:
                best_score, best_e = score, e
        rows = order[starts[best_e]:starts[best_e] + counts[best_e]]
        n = len(rows)
        if n < 6:                    # need redundancy to isolate
            return
        coords = sat_res.pos[rows].T
        delays = sat_res.t[rows]
        sig = sat_res.sigma[rows]
        sats = sat_res.sat_no[rows]
        kw = dict(max_it=self.cfg.lsf_max_it,
                  max_residual=self.cfg.max_residual / 10,
                  rec_pos0=self.warm_start)

        sig_t = np.maximum(sig, self.cfg.raim_sigma_floor)

        def sse_of(keep):
            fx = solve_fix(coords[:, keep], delays[keep],
                           std_dev=sig[keep], **kw)
            w = fx.res_m / sig_t[keep]
            return float(w @ w) / (keep.sum() - 4)

        try:
            sse0 = sse_of(np.ones(n, bool))
        except Exception:
            return
        if sse0 <= self.cfg.raim_threshold:
            return
        best = None
        for i in range(n):
            keep = np.arange(n) != i
            try:
                sse = sse_of(keep)
            except Exception:
                continue
            if best is None or sse < best[1]:
                best = (i, sse)
        # accept if the exclusion repairs the statistic outright OR
        # drops it decisively (20x) — the absolute gate alone misses
        # faults sitting on top of a high benign floor
        if best is None or (best[1] > self.cfg.raim_threshold
                            and best[1] > sse0 / 20.0):
            return                    # no single exclusion repairs it
        bad = int(sats[best[0]])
        tsec = float((tow[starts[best_e]] - 1) * 6.0
                     + cyc[starts[best_e]] * self.cfg.n_cyc / 1000.0)
        self.raim_excluded[bad] = tsec + self.cfg.raim_exclude_sec
        self.raim_events.append((tsec, bad, sse0, best[1]))
        if bad in self.sat_log:
            self.sat_log[bad].append(
                f"RAIM: excluded (sse/dof {sse0:.1f} -> {best[1]:.1f})")
        self.err_msgs[bad] = "RAIM"

    # -- Doppler velocity (no reference equivalent) --

    def _solve_velocity(self, frames: list, sat_res) -> None:
        """One receiver-velocity + clock-drift solve per reporting
        interval from the channels' tracked carrier frequencies (the
        FRQ the reference reports once per second but never uses,
        gpslib.py:1124-1131).  Satellite velocities come from a central
        difference of the same ecef_coord the pseudoranges use, so the
        earth-rotation convention cancels in the measurement model."""
        if self.warm_start is None or not len(sat_res):
            return
        rec = np.asarray(self.warm_start[1:4], np.float64)
        i = int(np.lexsort((sat_res.cyc, sat_res.tow))[-1])
        tow, cyc = int(sat_res.tow[i]), int(sat_res.cyc[i])
        week = int(sat_res.week[i])
        dt = cyc * self.cfg.n_cyc / 1000.0
        freq = {sf["SAT"]: sf["FRQ"] for sf in frames
                if sf.get("SAT") is not None and "FRQ" in sf}
        rows = [(f, self.engines[s].ephem) for s, f in freq.items()
                if s in self.engines and self.engines[s].ephem_ok]
        if len(rows) < 4:
            return
        fqs = np.array([r[0] for r in rows], np.float64)
        # batched orbit propagation at dt -/+ 0.5 s across satellites;
        # static key list (see models/pseudorange.py EPHEM_KEYS) so
        # mixed preloaded/decoded ephemeris dicts batch cleanly
        from gps_sdr_tpu_torch.models.pseudorange import EPHEM_KEYS, ecef_mat
        vals = np.array([[r[1][k] for k in EPHEM_KEYS] for r in rows],
                        np.float64)
        n = len(rows)
        dts = np.concatenate([np.full(n, dt - 0.5), np.full(n, dt + 0.5)])
        x, y, z, _ = ecef_mat(float(tow), dts, np.tile(vals, (2, 1)))
        p = np.stack([x, y, z])                     # [3, 2n]
        sat_pos = 0.5 * (p[:, :n] + p[:, n:])
        sat_vel = p[:, n:] - p[:, :n]
        res = solve_velocity(sat_pos, sat_vel, rec, fqs, L1_FREQ)
        if res is None:
            return
        self.vel_result = res
        t = gps_datetime(tow, week).timestamp() \
            + cyc * self.cfg.n_cyc / 1000.0
        self.velocities.append([t, *map(float, res.vel)])
        if self.tfilter is not None:
            self.tfilter.update_vel(t, res.vel, res.cov)

    # -- public entry --

    def process(self, epoch: EpochInput) -> dict:
        """Consume one reporting interval; returns a summary dict."""
        with span("eval.process"):
            stage = self.process_begin(epoch)
            sat_res = finish_deferred(stage[1], self.cfg)
            return self.process_finish(stage, sat_res)

    def process_begin(self, epoch: EpochInput):
        """Phase 1: frame ingest + code-phase walks, up to (but not
        including) the orbit propagation.  Returns an opaque stage for
        process_finish; the deferred bundles in stage[1] are what
        process_many batches across streams."""
        if self.cfg.track_filter_q > 0 and self.tfilter is None:
            from gps_sdr_tpu_torch.runtime.trackfilter import TrackFilter
            self.tfilter = TrackFilter(q_accel=self.cfg.track_filter_q)
        self.skipped_blocks += epoch.skipped_samples // self.cfg.ngps
        cpl = self._prep_code_phases(epoch.code_phases)
        deferred, active = self._eval_sats_begin(
            epoch.frames, cpl, epoch.carrier_freqs)
        return (epoch, deferred, active)

    def process_finish(self, stage, sat_res) -> dict:
        """Phase 2: atmosphere/RAIM/fixes/velocity/statistics on the
        propagated rows."""
        mid = self.process_finish_pre(stage, sat_res)
        fixes = (self._fix_solve(mid["prep"])
                 if mid["prep"] is not None else {})
        return self.process_finish_post(mid, fixes)

    def process_finish_pre(self, stage, sat_res):
        """Phase 2a: atmosphere/RAIM + the fix preparation.  Returns a
        mid-stage for process_finish_post; process_many runs ONE
        cross-stream stacked GN solve between the two halves."""
        epoch, _deferred, active = stage
        gps_time = self._gps_time_of(sat_res)
        if self.cfg.iono_corr or self.cfg.tropo_corr:
            if self.warm_start is None and len(sat_res):
                # bootstrap: one discarded uncorrected solve seeds the
                # position the elevation/azimuth geometry needs, so
                # even the first reported fixes are corrected
                n0 = len(self.sat_results)
                self._fix_epochs(sat_res)
                del self.sat_results[n0:]
            self._atmos_correct(sat_res)
        if self.cfg.raim:
            # drop first: an already-excluded satellite must not
            # re-trip detection (and pay the exclusion search) every
            # interval of its exclusion window
            sat_res = self._raim_drop_excluded(sat_res)
            self._raim_detect(sat_res)
            sat_res = self._raim_drop_excluded(sat_res)
        prep, sat_pos_list = self._fix_prepare(sat_res)
        return {"stage": stage, "sat_res": sat_res, "gps_time": gps_time,
                "prep": prep, "sat_pos_list": sat_pos_list}

    def process_finish_post(self, mid, fixes) -> dict:
        """Phase 2b: fix bookkeeping, clock rate, velocity, statistics."""
        epoch, _deferred, active = mid["stage"]
        sat_res = mid["sat_res"]
        gps_time = mid["gps_time"]
        sat_pos_list = mid["sat_pos_list"]
        if mid["prep"] is not None:
            rec_pos, fails = self._fix_finish(sat_res, mid["prep"], fixes)
        else:
            rec_pos, fails = [], []
        if self.cfg.solve_clock_rate:
            self._update_clock_rate(epoch.frames, sat_res)
        self._solve_velocity(epoch.frames, sat_res)
        self.fix_failures += fails
        # outlier statistics run once per reporting interval even when
        # the input is a merged multi-chunk window: the speed-allowance
        # gate and the running mean must advance second by second, or a
        # moving receiver's end-of-window fixes would be gated against
        # a window-old mean (min_out_dist + ~1 s * max_speed) and
        # wrongly dropped
        kept = []
        if rec_pos:
            sec_len = self.cfg.no_sec * self.cfg.block_sec
            gid = np.floor(np.array([p[0] for p in rec_pos])
                           / sec_len).astype(np.int64)
            for g in np.unique(gid):
                kept += self._update_stats(
                    [rec_pos[i] for i in np.nonzero(gid == g)[0]])
        self.positions += [list(map(float, p)) for p in kept]
        if (not kept and len(sat_res)
                and self.tfilter is not None
                and self.tfilter.x is not None):
            # outage coasting: satellites in view timestamp the epoch
            # but a fix is impossible (< 4 usable) — emit the filter's
            # prediction so the track bridges the gap (covariance
            # grows with the white-acceleration model; a later fix
            # re-anchors it through the normal update).  Stamp with the
            # interval's LATEST epoch: the Doppler-velocity update has
            # already advanced the filter there (gps_time is the
            # interval's first epoch and would sit in the past)
            i = int(np.lexsort((sat_res.cyc, sat_res.tow))[-1])
            t = gps_datetime(int(sat_res.tow[i]),
                             int(sat_res.week[i])).timestamp() \
                + int(sat_res.cyc[i]) * self.cfg.n_cyc / 1000.0
            if self.tfilter.t is not None and t >= self.tfilter.t:
                self.tfilter._predict(t)
                self.coasted.append(
                    [t, *map(float, self.tfilter.pos)])
        return {
            "gps_time": gps_time,
            "active_sats": active,
            "n_fixes": len(kept),
            "n_fails": len(fails),
            "sat_positions": sat_pos_list,
            "fixes": kept,
            "stat": self.stat,
            "skipped_blocks": self.skipped_blocks,
            "n_outliers": len(self.outliers),
            "n_phase_errors": self.n_phase_errors,
            "velocity": self.vel_result,
            "filtered_pos": self.filtered[-1] if self.filtered else None,
            "dop": self.dop,
        }


def process_many(pairs: list) -> list:
    """Evaluate many independent streams' epochs with the orbit
    propagation batched into ONE vectorized pass.

    pairs: [(evaluator, epoch), ...] — one entry per stream (the
    serving host path: StreamServer yields per-stream epochs, and S
    per-stream evaluators sharing one Python thread each paid the fixed
    numpy cost of their own small orbit batch; concatenating the rows
    first amortizes it S-fold).  All evaluators must share the same
    timing config (sample_rate / n_cyc).  Row-for-row identical to
    calling ev.process(epoch) per pair: ecef_coord is elementwise, so
    stacking streams changes nothing but the batch size
    (tests/test_serving.py pins equality).
    """
    if not pairs:
        return []
    with span("eval.process"):
        stages = [(ev, ev.process_begin(e)) for ev, e in pairs]
        cfg = pairs[0][0].cfg
        all_deferred = [d for _ev, st in stages for d in st[1]]
        rows = finish_deferred(all_deferred, cfg)
        mids = []
        i = 0
        for ev, st in stages:
            n = sum(len(d) for d in st[1])
            mids.append((ev, ev.process_finish_pre(st, rows.rows(i, i + n))))
            i += n
        fixes_per = _solve_fixes_many(mids)
        return [ev.process_finish_post(mid, fx)
                for (ev, mid), fx in zip(mids, fixes_per)]


def _solve_fixes_many(mids: list) -> list[dict]:
    """ONE stacked GN solve for every stream's prepared epochs.

    Stream epochs pad to the global satellite count the same way
    _fix_prepare pads within a stream (repeat a column at sigma 1e7 —
    a ~1e-14 relative weight, sub-nanometer perturbation); per-stream
    warm starts and clock-rate estimates ride solve_fix_batch's
    per-epoch rec_pos0/clock_rate_fix.  Row-for-row identical to the
    per-stream _fix_solve (tests/test_serving.py pins equality); falls
    back to it when solver settings differ across streams or the
    stacked solve throws (per-stream retry isolates the bad epoch).
    """
    live = [(s, ev, mid["prep"]) for s, (ev, mid) in enumerate(mids)
            if mid["prep"] is not None]
    fixes_per: list[dict] = [{} for _ in mids]
    if not live:
        return fixes_per
    kws = [ev._fix_kw() for _s, ev, _p in live]
    kw0 = {k: v for k, v in kws[0].items() if k != "clock_rate_fix"}
    same = all({k: v for k, v in kw.items() if k != "clock_rate_fix"}
               == kw0 for kw in kws[1:])
    if len(live) == 1 or not same:
        for s, ev, prep in live:
            fixes_per[s] = ev._fix_solve(prep)
        return fixes_per
    n_glob = max(p["n_max"] for _s, _ev, p in live)
    coords, delays, sig, rp0, crf = [], [], [], [], []
    for s, ev, p in live:
        e_i, pad = p["E"], n_glob - p["n_max"]
        c, d, g = p["coords"], p["delays"], p["sig"]
        if pad:
            c = np.concatenate([c, np.repeat(c[:, :, -1:], pad, 2)], 2)
            d = np.concatenate([d, np.repeat(d[:, -1:], pad, 1)], 1)
            g = np.concatenate([g, np.full((e_i, pad), 1.0e7)], 1)
        coords.append(c)
        delays.append(d)
        sig.append(g)
        ws = (np.zeros(4) if ev.warm_start is None
              else np.asarray(ev.warm_start, np.float64)[:4])
        rp0.append(np.broadcast_to(ws, (e_i, 4)))
        crf.append(np.full(e_i, ev.clock_rate_est))
    try:
        res = solve_fix_batch(
            np.concatenate(coords), np.concatenate(delays),
            std_dev=np.concatenate(sig), rec_pos0=np.concatenate(rp0),
            clock_rate_fix=np.concatenate(crf), **kw0)
    except Exception:
        for s, ev, prep in live:
            fixes_per[s] = ev._fix_solve(prep)
        return fixes_per
    i = 0
    for s, _ev, p in live:
        fixes_per[s] = res[i:i + p["E"]]        # FixBatch slice view
        i += p["E"]
    return fixes_per
