"""Persistence: ephemeris cache, result export, GPX tracks.

Replaces the reference's JSON/GPX/pickle persistence
(src/gpseval.py:58-156, src/gpsrecv.py:191-213):
  * ephemeris cache with 2 h validity for warm starts
  * JSON dumps of frames / satellite results / positions / code phases
  * GPX track export (self-contained XML writer; the reference uses the
    gpxpy package, which is not assumed here)
  * epoch-record save/replay, the fixture mechanism that decouples the
    evaluation layers from the DSP front half (SURVEY.md section 4.2)
"""

from __future__ import annotations

import datetime
import json
import pickle
from xml.sax.saxutils import escape

import numpy as np

from gps_sdr_tpu_torch.utils.cplist import CodePhaseUnpickler, plain_series

EPHEM_VALID_SEC = 2 * 3600
# an almanac stays useful for weeks (it only has to predict visibility
# and Doppler to a sweep bin or two — models/almanac.py)
ALMANAC_VALID_SEC = 45 * 86400


class NumpyJSONEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        from gps_sdr_tpu_torch.utils.tuplelog import TupleLog
        if isinstance(obj, TupleLog):
            return list(obj)
        return super().default(obj)


def save_ephemerides(path: str, ephems: dict) -> None:
    """{prn: ephem_dict} -> JSON with UTC/POSIX stamps
    (gpseval.py:60-77)."""
    now = datetime.datetime.now(datetime.timezone.utc)
    doc = {"UTC-Time": now.strftime("%Y-%m-%d %H:%M:%S"),
           "POSIX-Time": int(now.timestamp())}
    for prn, eph in ephems.items():
        doc[str(prn)] = eph
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, cls=NumpyJSONEncoder)


def load_ephemerides(path: str, max_age_sec: int = EPHEM_VALID_SEC) -> dict:
    """Load the cache; empty dict if missing or older than ~2 h
    (gpseval.py:80-106)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}
    stamp = doc.get("POSIX-Time", 0)
    now = datetime.datetime.now(datetime.timezone.utc).timestamp()
    if now - stamp > max_age_sec:
        return {}
    return {int(k): v for k, v in doc.items()
            if k not in ("POSIX-Time", "UTC-Time")}


def save_almanac(path: str, almanacs: dict,
                 iono_params: dict | None = None) -> None:
    """{prn: almanac fields} (+ optional page-18 iono coefficients
    under the reserved key 0) -> JSON, same stamped format as the
    ephemeris cache.  No reference equivalent — it decodes no SF4/5."""
    doc = dict(almanacs)
    if iono_params is not None:
        doc[0] = iono_params          # PRN 0 never broadcasts
    save_ephemerides(path, doc)


def load_almanac(path: str, max_age_sec: int = ALMANAC_VALID_SEC
                 ) -> tuple[dict, dict | None]:
    """-> (almanacs, iono_params or None); empties if missing/stale."""
    doc = load_ephemerides(path, max_age_sec)
    iono = doc.pop(0, None)
    if iono is not None:
        iono = {"alpha": tuple(iono["alpha"]),
                "beta": tuple(iono["beta"])}
    return doc, iono


def save_results(prefix: str, frames=None, sat_results=None,
                 positions=None, code_phases=None, velocities=None,
                 filtered=None) -> None:
    """JSON result dumps (SAVE_EVAL_RES, gpseval.py:124-138; the
    velocity series and Kalman-filtered track are new surfaces)."""
    for name, data in (("Frames", frames), ("SatRes", sat_results),
                       ("Pos", positions), ("CP", code_phases),
                       ("Vel", velocities), ("FilteredPos", filtered)):
        if data is not None:
            with open(f"{prefix}_gps{name}.json", "w") as f:
                json.dump(data, f, indent=2, cls=NumpyJSONEncoder)


def save_gpx_track(path: str, geo_track) -> None:
    """Write (lat, lon, elev) points as a GPX 1.1 track
    (gpseval.py:141-156, without the gpxpy dependency)."""
    pts = "\n".join(
        f'      <trkpt lat="{float(lat):.9f}" lon="{float(lon):.9f}">'
        f"<ele>{float(ele):.2f}</ele></trkpt>"
        for lat, lon, ele in geo_track)
    doc = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<gpx version="1.1" creator="{c}" '
        'xmlns="http://www.topografix.com/GPX/1/1">\n'
        "  <trk>\n    <trkseg>\n{p}\n    </trkseg>\n  </trk>\n</gpx>\n"
    ).format(c=escape("gps_sdr_tpu"), p=pts)
    with open(path, "w") as f:
        f.write(doc)


def save_epoch_records(path: str, records: list) -> None:
    """Record the receiver->evaluator epoch stream for deterministic
    replay (the reference's SAVE_PICKLE fixture, gpsrecv.py:205-213).

    Each record is (skipped_samples, frames, code_phases[,
    carrier_freqs]); the series go to the file as plain lists of
    (stream_no, value) tuples, as on the UDP wire, so that the JAX
    package reads a fixture of the port without importing it."""
    plain = [tuple(rec[:2]) + tuple(plain_series(s) for s in rec[2:])
             for rec in records]
    with open(path, "wb") as f:
        pickle.dump(plain, f)


def load_epoch_records(path: str) -> list:
    """The records of a fixture written by either package.  A JAX-written
    fixture's CodePhaseList is read as the port's; any other class of
    the JAX package or of JAX raises a ValueError naming it, before it is
    imported."""
    with open(path, "rb") as f:
        return CodePhaseUnpickler(f, f"epoch fixture {path}").load()
