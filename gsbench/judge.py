"""Whether the receiver's answers in a run are right.

Each stream-session (one capture run through one receiver, complete or
cut by the window's end) is judged against the plain reference
(reference.py) of its capture, on every answer it gave:

  acq_wrong       satellites the cold-start acquisition missed, found
                  though absent, or put more than one Doppler step or
                  ACQ_DELAY_TOL samples away from the reference (count);
  cp_missing      share of the blocks due, from the first tracked block
                  to the last one the stream's receiver processed, for
                  which a present satellite reported no code phase (1
                  where the stream's epochs came without any);
  code_phase_gap  widest gap, in samples (circular), between a reported
                  code phase and the reference's;
  freq_gap_hz     widest gap between an epoch's reported carrier
                  frequency (its last block's) and the reference's;
  ephem_wrong     decoded ephemeris fields that differ from the
                  broadcast ones, and, in a complete session, present
                  satellites with no ephemeris by the capture's end;
  fix_missing     complete sessions without a single fix;
  fix_gap_m       widest distance of a fix from the reference's fix;
  fix_mean_gap_m  distance of the mean of a session's fixes from the
                  reference's fix (the widest swings with the tail of
                  single fixes; the mean is steady from seed to seed).

A run is correct when it judged at least one session and every number
of every session is within the configuration's limit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gsbench import reference as ref

NUMBERS = ("acq_wrong", "cp_missing", "code_phase_gap", "freq_gap_hz",
           "ephem_wrong", "fix_missing", "fix_gap_m", "fix_mean_gap_m")
# the receiver keeps the health word apart from its ephemeris record
# (gps_sdr_tpu_torch/models/ephemeris.py), so it is not compared
NOT_IN_RECORD = {"satHealth"}
ACQ_DELAY_TOL = 1.5
FIX_TIME_S = 40.0     # receive time (from sample 0) of the reference fix


@dataclass
class Series:
    snos: np.ndarray                  # stream numbers (block + 1)
    vals: np.ndarray


@dataclass
class Answers:
    """One epoch's answers as the check reads them: code phases by PRN
    (objects with .snos and .vals) and the frames' carrier frequencies."""

    code_phases: dict
    frames: list                      # [{"SAT": prn, "FRQ": Hz}]


def answers(epoch) -> Answers:
    """What the check keeps of an EpochInput (not the epoch itself, so
    that a window's worth of records stays small)."""
    return Answers(dict(epoch.code_phases),
                   [{"SAT": f["SAT"], "FRQ": f["FRQ"]} for f in epoch.frames])


@dataclass
class StreamRecord:
    """What one receiver answered for one capture."""

    capture: int
    first_sno: int                    # stream number of its first
    #                                   tracked block (1: block 0)
    found: dict = field(default_factory=dict)      # prn -> (Hz, delay)
    epochs: list = field(default_factory=list)     # [Answers]
    ephemerides: dict = field(default_factory=dict)  # prn -> fields
    positions: np.ndarray = None      # [n, 4]: t, ECEF x, y, z
    due_end: int = 0                  # last stream number due
    complete: bool = False


class Reference:
    """The reference of each capture, worked out once per run."""

    def __init__(self, captures: list, shape: dict):
        self.captures = {c.index: c for c in captures}
        self.shape = shape
        self._cache: dict = {}

    def __call__(self, index: int) -> dict:
        if index not in self._cache:
            cap = self.captures[index]
            scn, sh = cap.scn, self.shape
            blocks = np.arange(cap.n_blocks)
            self._cache[index] = {
                "prns": {s.prn for s in scn.sats},
                "acq": ref.acquisition(scn, sh),
                "cp": {s.prn: ref.code_phase(scn, s, sh, blocks)
                       for s in scn.sats},
                "dop": {s.prn: ref.doppler(scn, s, sh, blocks)
                        for s in scn.sats},
                "eph": ref.ephemerides(scn),
                "fix": ref.fix(scn, scn.t_rx0 + FIX_TIME_S),
            }
        return self._cache[index]


def last_sno(epoch) -> int | None:
    """Stream number of the last block an epoch reports a code phase
    for (None where it reports none)."""
    ends = [int(c.snos[-1]) for c in epoch.code_phases.values()
            if len(c.snos)]
    return max(ends) if ends else None


def session_numbers(rec: StreamRecord, r: dict, shape: dict, config: dict,
                    due: dict) -> dict:
    cs = shape["code_samples"]
    truth = r["prns"]
    acq_wrong = len(truth - set(rec.found)) + len(set(rec.found) - truth)
    for prn, (f_hz, delay) in rec.found.items():
        if prn in truth:
            f0, d0 = r["acq"][prn]
            dd = abs((delay - d0 + cs / 2) % cs - cs / 2)
            if abs(f_hz - f0) > config["step_freq"] or dd > ACQ_DELAY_TOL:
                acq_wrong += 1

    series: dict = {}
    freq_gap = 0.0
    for ep in rec.epochs:
        for prn, cpl in ep.code_phases.items():
            series.setdefault(prn, []).append((np.asarray(cpl.snos),
                                               np.asarray(cpl.vals)))
        end = last_sno(ep)
        if end is None:
            continue
        for fr in ep.frames:
            prn = fr.get("SAT")
            if prn in truth:
                freq_gap = max(freq_gap, float(abs(
                    float(fr["FRQ"]) - r["dop"][prn][end - 1])))
    n_due = max(0, rec.due_end - rec.first_sno + 1)
    missing = 0
    cp_gap = 0.0
    for prn in truth:
        parts = series.get(prn, [])
        snos = (np.concatenate([p[0] for p in parts]) if parts
                else np.zeros(0, np.int64))
        vals = (np.concatenate([p[1] for p in parts]) if parts
                else np.zeros(0))
        keep = (snos >= rec.first_sno) & (snos <= rec.due_end) & (vals >= 0)
        snos, vals = snos[keep], vals[keep]
        missing += n_due - len(np.unique(snos))
        if len(snos):
            d = (vals - r["cp"][prn][snos - 1] + cs / 2) % cs - cs / 2
            cp_gap = max(cp_gap, float(np.abs(d).max()))

    eph_wrong = 0
    eph_detail = []
    for prn, fields in rec.ephemerides.items():
        if prn not in truth:
            eph_wrong += 1
            eph_detail.append(f"PRN {prn} absent")
            continue
        bad = [k for k, v in r["eph"][prn].items()
               if k not in NOT_IN_RECORD and bool(fields.get(k) != v)]
        eph_wrong += len(bad)
        if bad:
            eph_detail.append(f"PRN {prn} fields {bad}")
    if rec.complete and due["ephemeris"]:
        lost = sorted(truth - set(rec.ephemerides))
        eph_wrong += len(lost)
        if lost:
            eph_detail.append(f"no ephemeris for PRNs {lost}")

    pos = (np.zeros((0, 4)) if rec.positions is None
           else np.asarray(rec.positions, np.float64).reshape(-1, 4))
    gaps = np.linalg.norm(pos[:, 1:4] - r["fix"], axis=1)
    fix_gap = float(gaps.max()) if len(pos) else 0.0
    mean_gap = (float(np.linalg.norm(pos[:, 1:4].mean(axis=0) - r["fix"]))
                if len(pos) else 0.0)
    cp_missing = missing / max(1, n_due * len(truth))
    if rec.epochs and not series:
        cp_missing = 1.0        # epochs came, with no answer in them
    return {
        "acq_wrong": int(acq_wrong),
        "cp_missing": cp_missing,
        "code_phase_gap": cp_gap,
        "freq_gap_hz": freq_gap,
        "ephem_wrong": int(eph_wrong),
        "fix_missing": int(rec.complete and due["fixes"] and not len(pos)),
        "fix_gap_m": fix_gap,
        "fix_mean_gap_m": mean_gap,
        "detail": "; ".join(eph_detail),
    }


def judge(records: list, reference: Reference, config: dict,
          due: dict) -> dict:
    """{"correct", "attempted", "failed", "checks": {name: {"value",
    "limit"}}}: each number is the worst over the sessions judged."""
    limits = config["limits"]
    worst = {k: 0.0 for k in NUMBERS}
    failed = 0
    notes = []
    for rec in records:
        nums = session_numbers(rec, reference(rec.capture), reference.shape,
                               config["receiver"], due)
        over = [k for k in NUMBERS if nums[k] > limits[k]]
        if over:
            failed += 1
            if len(notes) < 8:
                notes.append(f"capture {rec.capture}: "
                             + ", ".join(f"{k} {nums[k]:.6g}" for k in over)
                             + (f" ({nums['detail']})" if nums["detail"]
                                else ""))
        for k in NUMBERS:
            worst[k] = max(worst[k], nums[k])
    return {"correct": bool(records) and failed == 0,
            "attempted": len(records), "failed": failed, "notes": notes,
            "checks": {k: {"value": worst[k], "limit": limits[k]}
                       for k in NUMBERS}}
