"""The benchmark's scenario generator: satellites, orbits, nav message.

A frozen copy of what the receiver's own generator does
(gps_sdr_tpu_torch/models/scenario.py make_scenario, models/orbits.py,
models/navmsg.py encode_subframe, ops/cacode.py ca_chips,
utils/geodesy.py geo_to_ecef), cut to the static receiver the cells use
(no atmosphere, motion, multipath, interference or oscillator error).
It imports nothing of the receiver, so a change there cannot move the
benchmark's inputs or its reference.

Every function that the reference evaluates takes a `dtype`: float64 is
the reference, float32 is its control (the same model one precision
below what the receiver's geometry states, reference.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

# IS-GPS-200 and WGS84 constants
GPS_C = 2.99792458e8
GPS_PI = 3.1415926535898
OMEGA_EARTH = 7.292115147e-5
MU_EARTH = 3.986005e14
F_REL = -4.442807633e-10
WEEK_IN_SEC = 604800
L1_FREQ = 1575.42e6
CA_CHIPS = 1023
CA_CHIP_RATE = 1.023e6
BIT_SEC = 0.020
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)

# the receiver's default epoch and place: the upstream receiver's golden
# fix (annappo/GPS-SDR-Receiver README), week 312, subframe tow 11100
REC_GEO = (49.082961, 8.307581, 150.0)
WEEK = 312
TOW0 = 11100
RX_START_OFFSET = 0.25

# G2 phase-select taps per PRN (IS-GPS-200 table 3-I)
G2_TAPS = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9),
    6: (2, 10), 7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3),
    11: (3, 4), 12: (5, 6), 13: (6, 7), 14: (7, 8), 15: (8, 9),
    16: (9, 10), 17: (1, 4), 18: (2, 5), 19: (3, 6), 20: (4, 7),
    21: (5, 8), 22: (6, 9), 23: (1, 3), 24: (4, 6), 25: (5, 7),
    26: (6, 8), 27: (7, 9), 28: (8, 10), 29: (1, 6), 30: (2, 7),
    31: (3, 8), 32: (4, 9),
}


@functools.lru_cache(maxsize=None)
def ca_chips(prn: int) -> np.ndarray:
    """1023 C/A chips of one PRN as +/-1 int8 (G1 xor the G2 taps)."""
    s1, s2 = G2_TAPS[prn]
    g1 = np.ones(10, dtype=np.int64)
    g2 = np.ones(10, dtype=np.int64)
    out = np.empty(CA_CHIPS, dtype=np.int8)
    for i in range(CA_CHIPS):
        out[i] = 2 * (g1[9] ^ g2[s1 - 1] ^ g2[s2 - 1]) - 1
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = np.roll(g1, 1)
        g2 = np.roll(g2, 1)
        g1[0] = fb1
        g2[0] = fb2
    return out


def geo_to_ecef(lat_deg, lon_deg, alt_m) -> np.ndarray:
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    sl, cl = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    return np.array([(n + alt_m) * cl * np.cos(lon),
                     (n + alt_m) * cl * np.sin(lon),
                     ((1.0 - WGS84_E2) * n + alt_m) * sl])


# -- orbits (IS-GPS-200 20.3.3.4.3), any float dtype --------------------------

def tsv_of_tow(tow):
    """Transmit time of the subframe whose HOW holds `tow`."""
    return (np.asarray(tow, np.float64) - 1.0) * 6.0


def _cross_time(t, dtype):
    half = dtype(WEEK_IN_SEC / 2)
    return (t + half) % dtype(WEEK_IN_SEC) - half


def ecef_coord(eph: dict, t_sv, dtype=np.float64):
    """(x, y, z, dtsv) of the satellite at SV transmit times `t_sv`
    (seconds of week), with the two-pass relativistic correction."""
    e_ = {k: dtype(v) for k, v in eph.items()}
    t_sv = np.asarray(t_sv, dtype)
    e, sqrt_a = e_["e"], e_["sqrtA"]
    dtr = dtype(0.0)
    for it in range(2):
        dt = _cross_time(t_sv - e_["Toc"], dtype)
        dtsv = (e_["af0"] + e_["af1"] * dt + e_["af2"] * dt * dt + dtr
                - e_["Tgd"])
        tk = _cross_time(t_sv - dtsv - e_["Toe"], dtype)
        n0 = dtype(np.sqrt(MU_EARTH)) / sqrt_a ** 3
        mk = e_["M0"] + (n0 + e_["deltaN"]) * tk
        ek = mk.copy()
        for _ in range(10):
            ek = ek - (ek - e * np.sin(ek) - mk) / (1 - e * np.cos(ek))
        if it == 0:
            dtr = dtype(F_REL) * e * sqrt_a * np.sin(ek)
    nu = np.arctan2(np.sqrt(1 - e * e) * np.sin(ek), np.cos(ek) - e)
    phi = nu + e_["omegaSmall"]
    s2p, c2p = np.sin(2 * phi), np.cos(2 * phi)
    uk = phi + e_["Cus"] * s2p + e_["Cuc"] * c2p
    rk = sqrt_a * sqrt_a * (1 - e * np.cos(ek)) + e_["Crc"] * c2p \
        + e_["Crs"] * s2p
    ik = e_["i0"] + e_["Cic"] * c2p + e_["Cis"] * s2p + e_["IDOT"] * tk
    xo, yo = rk * np.cos(uk), rk * np.sin(uk)
    om = (e_["omegaBig"] + (e_["omegaDot"] - dtype(OMEGA_EARTH)) * tk
          - dtype(OMEGA_EARTH) * e_["Toe"])
    so, co = np.sin(om), np.cos(om)
    ci, si = np.cos(ik), np.sin(ik)
    return (xo * co - yo * ci * so, xo * so + yo * ci * co, yo * si, dtsv)


def sat_states(scn: "Scenario", sat: "SatScenario", t, dtype=np.float64):
    """(tau, tau_sv, sat ECEF [3, ...] at transmit) at receiver GPS
    times t: light time by three fixed-point passes with the Sagnac
    rotation; tau_sv = t - tau + dtsv is the SV-clock time whose chip
    arrives at t."""
    t = np.asarray(t, dtype)
    rec = scn.rec_ecef.astype(dtype)
    tau = np.full_like(t, dtype(0.07))
    for _ in range(3):
        x, y, z, dtsv = ecef_coord(sat.eph, t - tau, dtype)
        ang = dtype(OMEGA_EARTH) * tau
        c, s = np.cos(ang), np.sin(ang)
        xr, yr = c * x + s * y, -s * x + c * y
        rng = np.sqrt((xr - rec[0]) ** 2 + (yr - rec[1]) ** 2
                      + (z - rec[2]) ** 2)
        tau = rng / dtype(GPS_C)
    return tau, t - tau + dtsv, np.stack([xr, yr, z])


# -- navigation message (IS-GPS-200 20.3.2, 20.3.5) ---------------------------

_PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int8)
_PAR_TAPS = [
    (1, [0, 1, 2, 4, 5, 9, 10, 11, 12, 13, 16, 17, 19, 22]),
    (0, [1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23]),
    (1, [0, 2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21]),
    (0, [1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22]),
    (0, [0, 2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23]),
    (1, [2, 4, 5, 7, 8, 9, 10, 12, 14, 18, 21, 22, 23]),
]   # (seeded by DS29?, source bits) for parity bits D25..D30

# (name, [(word, lo, hi), ...], scale): MSB first across the spans
COMMON = [("tow", [(1, 0, 17)], 1), ("ID", [(1, 19, 22)], 1)]
EPHEMERIS_FIELDS = {
    1: [("weekNum", [(2, 0, 10)], 1), ("satAcc", [(2, 12, 16)], 1),
        ("satHealth", [(2, 16, 22)], 1),
        ("IODC", [(2, 22, 24), (7, 0, 8)], 1),
        ("Tgd", [(6, 16, 24)], 2.0 ** -31), ("Toc", [(7, 8, 24)], 16),
        ("af2", [(8, 0, 8)], 2.0 ** -55), ("af1", [(8, 8, 24)], 2.0 ** -43),
        ("af0", [(9, 0, 22)], 2.0 ** -31)],
    2: [("IODE2", [(2, 0, 8)], 1), ("Crs", [(2, 8, 24)], 2.0 ** -5),
        ("deltaN", [(3, 0, 16)], 2.0 ** -43 * GPS_PI),
        ("M0", [(3, 16, 24), (4, 0, 24)], 2.0 ** -31 * GPS_PI),
        ("Cuc", [(5, 0, 16)], 2.0 ** -29),
        ("e", [(5, 16, 24), (6, 0, 24)], 2.0 ** -33),
        ("Cus", [(7, 0, 16)], 2.0 ** -29),
        ("sqrtA", [(7, 16, 24), (8, 0, 24)], 2.0 ** -19),
        ("Toe", [(9, 0, 16)], 16)],
    3: [("Cic", [(2, 0, 16)], 2.0 ** -29),
        ("omegaBig", [(2, 16, 24), (3, 0, 24)], 2.0 ** -31 * GPS_PI),
        ("Cis", [(4, 0, 16)], 2.0 ** -29),
        ("i0", [(4, 16, 24), (5, 0, 24)], 2.0 ** -31 * GPS_PI),
        ("Crc", [(6, 0, 16)], 2.0 ** -5),
        ("omegaSmall", [(6, 16, 24), (7, 0, 24)], 2.0 ** -31 * GPS_PI),
        ("omegaDot", [(8, 0, 24)], 2.0 ** -43 * GPS_PI),
        ("IDOT", [(9, 8, 22)], 2.0 ** -43 * GPS_PI),
        ("IODE3", [(9, 0, 8)], 1)],
}
# subframes 4 and 5 carry a dummy-SV page: data ID 1, SV ID 0
PAGE_FIELDS = [("dataID", [(2, 0, 2)], 1), ("svID", [(2, 2, 8)], 1)]


def _parity(d: np.ndarray, ds29: int, ds30: int) -> np.ndarray:
    return np.array([((ds29 if s29 else ds30) + int(d[taps].sum())) % 2
                     for s29, taps in _PAR_TAPS], dtype=np.int8)


def _solve_tail(d: np.ndarray, ds29: int, ds30: int) -> np.ndarray:
    """Source bits 23, 24 chosen so that transmitted D29 = D30 = 0."""
    d = d.copy()
    d[22] = d[23] = 0
    p = _parity(d, ds29, ds30)
    d[23] = p[4]
    d[22] = (p[5] + d[23]) % 2
    return d


def encode_subframe(sf_id: int, fields: dict, tow: int) -> np.ndarray:
    """The 300 transmitted bits (0/1) of one subframe; reserved bits are
    pseudo-random, keyed by (sf_id, tow), as real subframes carry
    entropy that bit framing relies on."""
    rng = np.random.default_rng((0x675053, sf_id, tow))
    src = rng.integers(0, 2, size=(10, 24)).astype(np.int8)
    src[0, :8] = _PREAMBLE
    values = dict(fields, tow=tow, ID=sf_id)
    if sf_id in (4, 5):
        values = {"tow": tow, "ID": sf_id, "dataID": 1, "svID": 0}
        layout = COMMON + PAGE_FIELDS
    else:
        layout = COMMON + EPHEMERIS_FIELDS[sf_id]
    for _, spans, _ in layout:
        for wi, lo, hi in spans:
            src[wi, lo:hi] = 0
    for name, spans, scale in layout:
        n = sum(hi - lo for _, lo, hi in spans)
        iv = (int(round(values[name] / scale)) if scale != 1
              else int(values[name])) & ((1 << n) - 1)
        bits = [(iv >> (n - 1 - i)) & 1 for i in range(n)]
        k = 0
        for wi, lo, hi in spans:
            src[wi, lo:hi] = bits[k:k + hi - lo]
            k += hi - lo
    tx = np.zeros((10, 30), dtype=np.int8)
    ds29 = ds30 = 0
    for i in range(10):
        d = _solve_tail(src[i], ds29, ds30) if i in (1, 9) else src[i]
        tx[i, :24] = (d + ds30) % 2
        tx[i, 24:] = _parity(d, ds29, ds30)
        ds29, ds30 = int(tx[i, 28]), int(tx[i, 29])
    return tx.reshape(300)


def quantized_ephemeris(eph: dict) -> dict:
    """Ephemeris values rounded to their broadcast LSBs: what the
    receiver decodes, bit for bit."""
    out = dict(eph)
    for sf_id in (1, 2, 3):
        for name, _, scale in EPHEMERIS_FIELDS[sf_id]:
            if scale != 1:
                out[name] = round(out[name] / scale) * scale
    return out


# -- scenario -----------------------------------------------------------------

@dataclass
class SatScenario:
    prn: int
    eph: dict
    amplitude: float
    nav_stream: np.ndarray = None   # +-1 bits; bit b spans SV time
    bit0: int = 0                   # [20 ms (b + bit0), ...)


@dataclass
class Scenario:
    rec_ecef: np.ndarray
    t_rx0: float                    # GPS time of receiver sample 0
    sats: list


def random_visible_ephemeris(rec_ecef, rng, min_elev_sin: float = 0.3
                             ) -> dict:
    """Orbital elements on the GPS shell, drawn until the satellite is
    above sin(elevation) = min_elev_sin at the scenario's start."""
    toe = float(np.floor(tsv_of_tow(TOW0) / 16) * 16)
    up = rec_ecef / np.linalg.norm(rec_ecef)
    while True:
        eph = {
            "weekNum": WEEK, "satAcc": 0, "satHealth": 0,
            "IODC": int(rng.integers(1, 1023)),
            "Tgd": float(rng.uniform(-1e-8, 1e-8)),
            "Toc": toe, "af2": 0.0,
            "af1": float(rng.uniform(-1e-11, 1e-11)),
            "af0": float(rng.uniform(-5e-4, 5e-4)),
            "Crs": float(rng.uniform(-80, 80)),
            "deltaN": float(rng.uniform(-6e-9, 6e-9)),
            "M0": float(rng.uniform(-np.pi, np.pi)),
            "Cuc": float(rng.uniform(-6e-6, 6e-6)),
            "e": float(rng.uniform(0.001, 0.02)),
            "Cus": float(rng.uniform(-6e-6, 6e-6)),
            "sqrtA": float(np.sqrt(26_560_000.0) + rng.uniform(-5, 5)),
            "Toe": toe,
            "Cic": float(rng.uniform(-2e-7, 2e-7)),
            "omegaBig": float(rng.uniform(-np.pi, np.pi)),
            "Cis": float(rng.uniform(-2e-7, 2e-7)),
            "i0": float(np.deg2rad(55) + rng.uniform(-0.1, 0.1)),
            "Crc": float(rng.uniform(-200, 200)),
            "omegaSmall": float(rng.uniform(-np.pi, np.pi)),
            "omegaDot": float(rng.uniform(-8.5e-9, -7.5e-9)),
            "IDOT": float(rng.uniform(-4e-10, 4e-10)),
        }
        eph["IODE2"] = eph["IODE3"] = eph["IODC"] & 255
        eph = quantized_ephemeris(eph)
        x, y, z, _ = ecef_coord(eph, tsv_of_tow(TOW0))
        d = np.array([x, y, z]) - rec_ecef
        if np.dot(d, up) / np.linalg.norm(d) > min_elev_sin:
            return eph


def make_scenario(seed_seq: np.random.SeedSequence, n_sats: int,
                  duration_sec: float) -> Scenario:
    """A static receiver at REC_GEO and n_sats visible satellites with
    random ephemerides, amplitudes 0.7-1.2 and nav streams covering
    duration_sec; everything drawn from seed_seq."""
    rng = np.random.default_rng(seed_seq)
    rec_ecef = geo_to_ecef(*REC_GEO)
    prns = rng.choice(np.arange(2, 33), size=n_sats, replace=False)
    n_subframes = int(np.ceil(duration_sec / 6)) + 3
    sats = []
    for prn in prns:
        eph = random_visible_ephemeris(rec_ecef, rng)
        sat = SatScenario(prn=int(prn), eph=eph,
                          amplitude=float(rng.uniform(0.7, 1.2)))
        frames = [encode_subframe((tow - 1) % 5 + 1, eph, tow)
                  for tow in range(TOW0, TOW0 + n_subframes)]
        sat.nav_stream = (2 * np.concatenate(frames) - 1).astype(np.int8)
        sat.bit0 = (TOW0 - 1) * 300
        sats.append(sat)
    return Scenario(rec_ecef=rec_ecef,
                    t_rx0=float(tsv_of_tow(TOW0)) + RX_START_OFFSET,
                    sats=sats)
