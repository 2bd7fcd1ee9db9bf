"""Pseudorange assembly: code phases + time references -> satellite
positions and receive timestamps.

Replaces the reference's SatOrbit class (src/gpslib.py:801-1039).  This
is the time-bookkeeping heart of the receiver: a (tow, ST) reference
from a decoded subframe anchors the sample clock to GPS time; the
stream of per-block code phases is then walked forward TOW by TOW
(6 s = 187.5 blocks at n_cyc=32, hence the alternating 16 ms `offms`
parity, gpslib.py:987-1037), unwrapping code-phase overflows across
lists, bridging gaps with a linear fit, and estimating the code-phase
slope and sigma for the LSF weights (getStdDev, gpslib.py:864-883).

Output tuples match the reference exactly:
  (sat_no, tow, x, y, z, smp_time_s, week_num, cyc_no, coph_std_m)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gps_sdr_tpu_torch.config import GPS_C, L1_FREQ, ReceiverConfig
from gps_sdr_tpu_torch.models import orbits
from gps_sdr_tpu_torch.models.ephemeris import (EPHEM_SF1, EPHEM_SF2,
                                                EPHEM_SF3, EphemerisAssembler,
                                                SatStatus)
from gps_sdr_tpu_torch.nativecore import native_evalcore
from gps_sdr_tpu_torch.utils.cplist import cp_arrays

# the ephemeris fields orbit propagation consumes — a STATIC list, so
# batching ephemerides across satellites never depends on any one
# dict's extra keys (a cache-preloaded ephemeris carries "SAT",
# ephemeris.py:51, while a freshly decoded one does not: keying the
# batch off the first satellite's dict raised KeyError in mixed
# warm/cold sessions)
EPHEM_KEYS = EPHEM_SF1 + EPHEM_SF2 + EPHEM_SF3

MAX_SLOPE = 6.55e-3     # samples/ms; max physical code-phase drift
                        # (|doppler| <= 5 kHz -> 6.5 samples/s; gpslib.py:812)


def _linfit(x, y) -> tuple[float, float]:
    """Degree-1 least squares (slope, intercept) in f64 — the closed
    form; np.polyfit's generic Vandermonde/lstsq machinery costs ~10x
    more per call and this runs once per satellite per chunk."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mx = x.mean()
    my = y.mean()
    dx = x - mx
    denom = float(dx @ dx)
    slope = float(dx @ (y - my)) / denom if denom else 0.0
    return slope, my - slope * mx


def max_slope(cfg: ReceiverConfig) -> float:
    """Code-phase slope cap [samples/ms] for this config's envelope.

    The reference's constant (gpslib.py:812) assumes geometric Doppler
    within +-5 kHz; an uncorrected receiver oscillator (its +-2 ppm
    TCXO envelope, README.md:204-217) adds a COMMON code-clock skew of
    ppm*fs samples/s on top, which the config expresses by widening the
    acquisition search band.  Clipping real slope into a too-small cap
    biases the per-code-period timestamp correction (corr_cp)
    differentially across satellites — a position bias — so the cap
    follows the configured band (+500 Hz drift margin between sweeps)
    and never drops below the reference's constant."""
    f_max = max(abs(cfg.min_freq), abs(cfg.max_freq)) + 500.0
    return max(MAX_SLOPE,
               f_max / 1540.0 * (cfg.code_samples / 1023.0) * 1e-3)


@dataclass
class DeferredRows:
    """One satellite's pseudorange bookkeeping, orbit propagation still
    pending — lets the evaluator batch ecef_coord across satellites.
    Parallel arrays, one entry per matched code phase."""

    sat_no: int
    week_num: int
    sigma: np.ndarray       # float64, per row (per reporting segment)
    ephem: dict
    tow: np.ndarray         # int64
    delta_st: np.ndarray    # int64 samples from the TOW epoch start
    smp: np.ndarray         # float64 raw receive sample time
    cyc: np.ndarray         # int64 cycle number within the TOW epoch

    def __len__(self) -> int:
        return self.tow.shape[0]


@dataclass
class SatRows:
    """Per-code-phase satellite results as a struct of arrays.

    Column-for-column the reference's result tuples (satNo, tow, x, y,
    z, smpTime, weekNum, cycNo, cophStd — gpslib.py:1021-1022), kept as
    parallel arrays so epoch grouping and the GN solves stay vectorized
    end-to-end on the host."""

    sat_no: np.ndarray          # int64 [N]
    tow: np.ndarray             # int64 [N]
    pos: np.ndarray             # float64 [N, 3] ECEF
    t: np.ndarray               # float64 [N] receive time (s, sample clock)
    week: np.ndarray            # int64 [N]
    cyc: np.ndarray             # int64 [N]
    sigma: np.ndarray           # float64 [N]

    def __len__(self) -> int:
        return self.sat_no.shape[0]

    def rows(self, a: int, b: int) -> "SatRows":
        """Row-range view [a, b) — used to hand each stream its slice
        of a cross-stream batched orbit pass (evaluator.process_many)."""
        return SatRows(self.sat_no[a:b], self.tow[a:b], self.pos[a:b],
                       self.t[a:b], self.week[a:b], self.cyc[a:b],
                       self.sigma[a:b])

    @classmethod
    def empty(cls) -> "SatRows":
        z = np.zeros(0, np.int64)
        f = np.zeros(0, np.float64)
        return cls(z, z, np.zeros((0, 3), np.float64), f, z, z, f)

    def tuples(self) -> list:
        """Reference-format result tuples (compat surface)."""
        return [(int(s), int(tw), float(p[0]), float(p[1]), float(p[2]),
                 float(t), int(w), int(c), float(sg))
                for s, tw, p, t, w, c, sg in
                zip(self.sat_no, self.tow, self.pos, self.t, self.week,
                    self.cyc, self.sigma)]


def ecef_mat(tow, dt, eph_mat: np.ndarray, rel_corr: bool = True):
    """ecef_coord over rows of an EPHEM_KEYS-ordered [N, 26] matrix —
    the dispatch point between the native core (csrc/evalcore.cpp
    gsdr_ecef) and the numpy path.  tow/dt broadcast to [N]."""
    n = eph_mat.shape[0]
    tow = np.broadcast_to(np.asarray(tow, np.float64), (n,))
    dt = np.broadcast_to(np.asarray(dt, np.float64), (n,))
    core = native_evalcore()
    if core:
        return core.ecef_batch(tow, dt, eph_mat, rel_corr)
    eph = {k: eph_mat[:, i] for i, k in enumerate(EPHEM_KEYS)}
    return orbits.ecef_coord(tow, eph, dt_from_tow=dt,
                             rel_corr=rel_corr)


def finish_deferred(deferred: list, cfg: ReceiverConfig,
                    rel_corr: bool = True) -> SatRows:
    """Run ONE vectorized orbit propagation over every satellite's rows
    and emit a SatRows bundle, grouped per satellite in input order.
    All ecef_coord math is elementwise, so stacking rows across
    satellites is bit-identical to per-satellite calls."""
    if not deferred:
        return SatRows.empty()
    fs = cfg.sample_rate
    counts = [len(d) for d in deferred]
    tow_a = np.concatenate([d.tow for d in deferred]).astype(np.float64)
    dst_a = np.concatenate([d.delta_st for d in deferred]).astype(
        np.float64)
    smp_a = np.concatenate([d.smp for d in deferred])
    cyc_a = np.concatenate([d.cyc for d in deferred])
    keys = EPHEM_KEYS
    vals = np.array([[d.ephem[k] for k in keys] for d in deferred],
                    np.float64)
    rep = np.repeat(vals, counts, axis=0)       # ONE repeat, all keys
    x, y, z, dtsv = ecef_mat(tow_a, dst_a / fs, rep, rel_corr)
    dtsv = np.broadcast_to(np.asarray(dtsv, np.float64), tow_a.shape)
    return SatRows(
        sat_no=np.repeat([d.sat_no for d in deferred], counts),
        tow=tow_a.astype(np.int64),
        pos=np.stack([x, y, z], axis=1).astype(np.float64),
        t=smp_a / fs + dtsv,
        week=np.repeat([d.week_num for d in deferred],
                       counts).astype(np.int64),
        cyc=cyc_a,
        sigma=np.concatenate([d.sigma for d in deferred]))


@dataclass
class PseudorangeEngine:
    """One satellite's code-phase -> pseudorange pipeline."""

    sat_no: int
    cfg: ReceiverConfig
    preloaded_ephem: dict | None = None

    status: SatStatus = SatStatus.OK
    asm: EphemerisAssembler = None
    ref_time: tuple | None = None        # active (tow, ST)
    ref_ephem: dict | None = None
    last_sno: int = 0
    last_cp: float = 0.0
    hatch_state: tuple | None = None     # (sno, freq, smoothed cp)
    # gap-bridge fit window, stored as arrays (the list-of-tuples form
    # cost a tolist/zip churn per satellite per chunk at serving rate);
    # the `cp_hist` property keeps the [(sno, cp)] compat surface
    hist_snos: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))
    hist_cps: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.float64))
    slope_hist: list = field(default_factory=list)  # cp slopes per ms
    phase_err_snos: list = field(default_factory=list)

    @property
    def cp_hist(self) -> list:
        return list(zip(self.hist_snos.tolist(),
                        self.hist_cps.tolist()))

    @cp_hist.setter
    def cp_hist(self, pairs) -> None:
        n = len(pairs)
        self.hist_snos = np.fromiter((e[0] for e in pairs), np.int64, n)
        self.hist_cps = np.fromiter((e[1] for e in pairs), np.float64, n)

    MIN_GAP = 1000        # blocks; larger gaps bridged by linear fit
    MAX_GAP = 10000       # blocks; beyond this the reference is dropped
    MAX_FIT = 100         # fit window length
    DIFF_TOL = 200        # samples; overflow matching tolerance

    def __post_init__(self):
        if self.asm is None:
            self.asm = EphemerisAssembler(self.sat_no, self.preloaded_ephem)

    # -- subframe input -----------------------------------------------------

    def read_frame(self, sf: dict) -> SatStatus:
        """Feed a decoded subframe (readFrame, gpslib.py:848-861): frames
        predating a recorded phase error are rejected; an ephemeris
        change rebuilds the assembler and re-reads the subframe."""
        stream_no = sf["ST"] // self.cfg.ngps
        if self.phase_err_snos and stream_no < self.phase_err_snos[-1]:
            self.status = SatStatus.FLAWED
            return self.status
        self.status = self.asm.read_subframe(sf)
        if self.status == SatStatus.NEW_EPHEM:
            self.asm = EphemerisAssembler(self.sat_no)
            self.asm.read_subframe(sf)
        return self.status

    @property
    def ephem_ok(self) -> bool:
        return self.asm.ephem_ok

    @property
    def ephem(self) -> dict:
        return self.asm.ephem

    # -- internals ----------------------------------------------------------

    def _clear_ref(self):
        """Drop the code-phase continuity state (clearCodePhaseRef,
        gpslib.py:886-891)."""
        self.last_sno = 0
        self.cp_hist = []
        self.slope_hist = []
        self.ref_time = None
        self.ref_ephem = None

    def _sigma_and_slope(self, snos, cps) -> tuple[np.ndarray, np.ndarray]:
        """sigma of the code phases around a linear fit (meters) and the
        averaged, clipped slope in samples/ms (getStdDev,
        gpslib.py:864-883), per entry.

        The list is split into reporting-interval segments (cfg.no_sec
        blocks) with one (sigma, slope-history update) per segment, so
        a MERGED multi-chunk list (merge_epochs throughput mode)
        reproduces the per-chunk calls' progressive slope engagement
        and per-second fit windows.  Segments anchor to the ABSOLUTE
        stream grid ((sno - 1) // no_sec; block 0 has stream number 1),
        matching the receiver's chunk boundaries exactly even when a
        satellite's first valid code phase lands mid-chunk; a
        default-shape per-chunk list is then always one segment —
        identical to the per-call scalar form."""
        cfg = self.cfg
        core = native_evalcore()
        if core:
            # native segment walk (csrc/evalcore.cpp gsdr_sigma_slope);
            # updates self.slope_hist in place like the loop below
            return core.sigma_slope(
                snos, cps, cfg.no_sec, cfg.n_cyc, max_slope(cfg),
                GPS_C / cfg.sample_rate, self.slope_hist)
        n = len(cps)
        seg = (snos - 1) // cfg.no_sec
        bounds = np.nonzero(np.diff(seg))[0] + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [n]])
        counts = ends - starts
        # per-segment LS slope + residual std via reduceat sums over
        # segment-centered coordinates (residuals of a LS line have
        # zero mean, so std^2 = var_y - cov^2/var_x exactly)
        x = (snos - np.repeat(snos[starts], counts)).astype(np.float64)
        y = cps - np.repeat(cps[starts], counts)
        # one reduceat over the stacked moment rows (five separate
        # reduceat calls were pure numpy-call overhead at the serving
        # path's segment rate)
        sx, sy, sxx, sxy, syy = np.add.reduceat(
            np.stack([x, y, x * x, x * y, y * y]), starts, axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            mx = sx / counts
            my = sy / counts
            var_x = sxx / counts - mx * mx
            cov = sxy / counts - mx * my
            var_y = syy / counts - my * my
            sl = np.where(var_x > 0, cov / np.where(var_x > 0, var_x, 1),
                          0.0)
            sig = np.sqrt(np.maximum(var_y - sl * cov, 0.0))
        sig_out = np.empty(n, np.float64)
        slp_out = np.empty(n, np.float64)
        cap = max_slope(cfg)
        max_hist = 1024 // cfg.n_cyc
        m_per_smp = GPS_C / cfg.sample_rate
        hist = self.slope_hist       # sequential: progressive per segment
        for i in range(len(starts)):
            if counts[i] > 3:
                hist.append(sl[i] / cfg.n_cyc)
                if len(hist) > max_hist:
                    del hist[0]
                sigma = sig[i]
            else:
                sigma = 0.5
            slope = sum(hist) / len(hist) if len(hist) > 4 else 0.0
            a, b = starts[i], ends[i]
            sig_out[a:b] = sigma * m_per_smp
            slp_out[a:b] = min(max(slope, -cap), cap)
        return sig_out, slp_out

    # -- carrier smoothing (Hatch filter; no reference equivalent) -----------

    def _hatch(self, snos: np.ndarray, cps: np.ndarray,
               fqs: np.ndarray) -> np.ndarray:
        """Carrier-smoothed code phases.

        The tracked carrier's integrated Doppler predicts the
        code-phase motion exactly (code Doppler = f/1540 chips/s, both
        clocked by the same oscillator), so code noise can be averaged
        over cfg.carrier_smoothing blocks with zero lag on real
        dynamics:  sm_i = a*cp_i + (1-a)*(sm_{i-1} + dphi_i).

        Vectorized via the code-minus-carrier residual: with
        phi = cumsum(dphi), (sm - phi) is a plain EMA of (cp - phi),
        which has the closed form below.  Processed in bounded spans so
        w**-j stays in f64 range; filter state carries across calls and
        resets on stream gaps > 1 s or a predicted-vs-measured jump
        (phase error / realignment)."""
        cfg = self.cfg
        a = 1.0 / cfg.carrier_smoothing
        w = 1.0 - a
        # code phase drifts OPPOSITE to the tracked carrier: with the
        # tracker's convention FRQ = -L1 * d(tau)/dt (see
        # evaluator._update_clock_rate), the code-period start moves by
        # dcp/block = 1000*cs*d(tau - dtsv)/dt * n_cyc*1e-3 = -FRQ*k
        k = -cfg.n_cyc * cfg.code_samples / L1_FREQ  # samples/(Hz*block)
        out = np.empty_like(cps)
        state = self.hatch_state
        n = len(cps)
        i0 = 0
        while i0 < n:
            i1 = min(i0 + 256, n)
            s = snos[i0:i1]
            c = cps[i0:i1]
            f = fqs[i0:i1]
            gaps = np.diff(np.concatenate([[state[0] if state else
                                            s[0]], s])).astype(np.float64)
            fmid = (np.concatenate([[state[1] if state else f[0]],
                                    f[:-1]]) + f) * 0.5
            dphi = k * fmid * gaps
            if state is not None and (
                    gaps[0] > cfg.no_sec
                    or abs(c[0] - (state[2] + dphi[0])) > 100.0):
                state = None
            if state is None:
                dphi[0] = 0.0
            phi = np.cumsum(dphi)
            r = c - phi
            e0 = state[2] if state is not None else r[0]
            j = np.arange(i1 - i0)
            wj = w ** j
            e = wj * w * e0 + a * wj * np.cumsum(r / wj)
            sm = phi + e
            out[i0:i1] = sm
            state = (int(s[-1]), float(f[-1]), float(sm[-1]))
            i0 = i1
        self.hatch_state = state
        return out

    def _aligned_freqs(self, snos: np.ndarray,
                       freqs: list) -> np.ndarray | None:
        """Per-entry tracked carrier freq aligned to `snos`, or None if
        any stream number lacks a freq sample (skip smoothing then)."""
        if freqs is None or not len(freqs):
            return None
        fsno, fval = cp_arrays(freqs)
        idx = np.searchsorted(fsno, snos)
        if (idx >= len(fsno)).any() or (fsno[idx] != snos).any():
            return None
        return fval[idx]

    # -- main entry ----------------------------------------------------------

    def eval_code_phases(self, cpl: list, rel_corr: bool = True,
                         defer: bool = False, freqs: list | None = None):
        """Code-phase list [(stream_no, code_phase), ...] -> result tuples.

        Mirrors evalCodePhase (gpslib.py:897-1039).  A leading
        (stream_no, None) entry is the global phase-error poison pill:
        it invalidates the time reference and excludes older frames.
        """
        cfg = self.cfg
        cs, ngps, n_cyc, fs = (cfg.code_samples, cfg.ngps, cfg.n_cyc,
                               cfg.sample_rate)
        six_sec = int(6 * fs)

        result: list = []
        snos = cps = None
        if len(cpl):
            if cpl[0][1] is None:
                self.phase_err_snos.append(cpl[0][0])
                self.asm.time_refs = []
                self._clear_ref()
                return result
            snos, cps = cp_arrays(cpl)
            keep = snos > self.last_sno
            snos, cps = snos[keep], cps[keep]   # mask copy: cps is
            #                        never written in place below

        # an ephemeris update invalidates the anchored reference
        if (self.ref_time is not None and self.asm.ephem_ok
                and self.asm.ephem["IODC"] != self.ref_ephem["IODC"]):
            self._clear_ref()

        if self.ref_time is None and self.asm.time_refs:
            self.ref_time = self.asm.time_refs[-1]
            self.ref_ephem = dict(self.asm.ephem)

        if snos is None or not snos.size or self.ref_time is None:
            return result

        week_num = self.ref_ephem["weekNum"]
        tow, st_raw = self.ref_time
        st_frac = st_raw % cs                 # sub-period part ~ code phase
        st = (st_raw // cs) * cs              # snap to a code-period boundary
        if st // ngps > self.last_sno:
            self.last_sno = st // ngps
            self.last_cp = st_frac

        # bridge or reject gaps since the last processed stream
        gap = int(snos[0]) - self.last_sno
        if gap > self.MAX_GAP:
            self._clear_ref()
            return result
        if gap > self.MIN_GAP:
            if self.hist_snos.shape[0] >= n_cyc // 2:
                sl, ic = _linfit(self.hist_snos[-self.MAX_FIT:],
                                 self.hist_cps[-self.MAX_FIT:])
                self.last_cp = float(sl * snos[0] + ic)
            else:
                self._clear_ref()
                return result

        # overflow continuation: code phases within a list were already
        # unwrapped upstream (runtime/evaluator.py); align this list's
        # offset with the running unwrap
        ofl = self.last_cp // cs
        if ofl != 0:
            cps = cps + ofl * cs
        diff = self.last_cp - cps[0]
        if abs(abs(diff) - cs) <= self.DIFF_TOL:
            cps = cps + np.sign(diff) * cs

        # carrier smoothing AFTER continuity alignment (the filter
        # state lives in the same unwrapped frame as last_cp)
        if cfg.carrier_smoothing > 0:
            fqs = self._aligned_freqs(snos, freqs)
            if fqs is not None:
                cps = self._hatch(snos, cps, fqs)

        sigma_a, slope_a = self._sigma_and_slope(snos, cps)
        tail = slice(max(0, len(snos) - self.MAX_FIT), None)
        self.hist_snos = np.concatenate(
            [self.hist_snos, snos[tail]])[-self.MAX_FIT:]
        self.hist_cps = np.concatenate(
            [self.hist_cps, cps[tail]])[-self.MAX_FIT:]
        self.last_sno, self.last_cp = int(snos[-1]), float(cps[-1])

        # TOW walking: 6 s = 6000 code periods = 187.5 blocks (n_cyc=32),
        # so each TOW epoch starts offms ms into a block, alternating by
        # 16 ms (gpslib.py:987-1037)
        offms = (tow % 2 ** (n_cyc // 32)) * 16 if n_cyc > 16 else 0
        while (st + six_sec) // ngps < snos[0]:
            st += six_sec
            tow += 1
            offms = (offms + 16) % n_cyc

        # Vectorized walk (the reference steps stream-by-stream,
        # gpslib.py:1001-1037).  Because six_sec mod ngps equals the
        # 16 ms offms step, the absolute code-period start time is
        # exactly contiguous across 6 s rollovers:
        #   T(q) = T(first) + (q - first) * ngps
        # for every stream number q, so each matched stream's
        # (tow, delta_st, cyc_no) has a closed form — no Python loop.
        st = int(st)
        tow = int(tow)
        t0_abs = st + offms * cs               # T(first)
        first = t0_abs // ngps
        code_no = t0_abs // cs - first * n_cyc  # constant over the walk,
        #                                         like the reference's
        mask = snos >= first                   # stale entries skipped
        qm = snos[mask]
        have_rows = bool(qm.size)
        if have_rows:
            cpm = cps[mask]
            T = t0_abs + (qm - first) * ngps
            seg = (T - st) // six_sec
            tow_q = tow + seg
            delta_q = T - st - seg * six_sec
            offms_q = (offms + 16 * seg) % n_cyc
            start_q = (st + seg * six_sec + offms_q * cs) // ngps
            # the correlator measures at the block center; shift the
            # timestamp by the code-phase slope times the offset of
            # this code period from the center
            corr_cp = (code_no + cpm // cs - n_cyc // 2) * slope_a[mask]
            smp = T + cpm + corr_cp

        # roll the time anchor forward at the LAST 6 s boundary crossed
        # strictly before the list's final stream, so the next call
        # doesn't rewalk (REF_TIME update, gpslib.py:1031-1037); CP at
        # that moment is the last code phase matched before the boundary
        last_q = int(snos[-1])
        n_seg = int((t0_abs + (last_q + 1 - first) * ngps - st)
                    // six_sec)
        if n_seg >= 1:
            s_arr = np.arange(1, n_seg + 1, dtype=np.int64)
            bound = first - ((st + s_arr * six_sec - t0_abs) // -ngps)
            elig = bound < last_q
            if elig.any():
                s_star = int(s_arr[elig][-1])
                b_star = int(bound[elig][-1])
                j = int(np.searchsorted(snos, b_star)) - 1
                cp_at = (float(cps[j]) if j >= 0 and snos[j] >= first
                         else float(cps[0]))
                self.ref_time = (tow + s_star,
                                 int(st + s_star * six_sec + cp_at % cs))

        if have_rows:
            d = DeferredRows(self.sat_no, int(week_num), sigma_a[mask],
                             dict(self.ref_ephem), tow=tow_q,
                             delta_st=delta_q, smp=smp, cyc=qm - start_q)
            if defer:
                # cross-satellite orbit batching: hand the bookkeeping
                # back so the evaluator can run ONE vectorized
                # ecef_coord over every satellite's rows (elementwise
                # math -> bit-identical to the per-sat call)
                return d
            return finish_deferred([d], cfg, rel_corr).tuples()

        return result
