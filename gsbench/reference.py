"""The plain reference: what a correct receiver reports for a capture.

It works from the scenario that the capture was made from
(scenario.py), in NumPy, and never from the receiver: for each
satellite the acquisition's Doppler and code delay at block 0, the code
phase of every block, the carrier frequency at any block, the broadcast
ephemeris, and the position that a pseudorange fix gives.  `dtype` is
float64 for the reference and float32 for its control, the same model
one precision below the float64 that the receiver's geometry states
(gps_sdr_tpu_torch/config.py GEO_FLOAT).

Conventions, as the receiver defines its outputs:
  * a block's code phase is the sample, in [0, code_samples), at which
    the C/A period that the block's centre lies in starts, plus half a
    sample: the upstream receiver's replica doubles each chip and
    interpolates (gpslib.py:62-77), which puts its correlation peak half
    a sample after the code epoch;
  * a carrier frequency is -L1 times the rate of the light time, taken
    over +-0.5 s about the block's centre;
  * blocks are numbered from 0 at the capture's first sample; the
    receiver's stream numbers are these plus one.
"""

from __future__ import annotations

import numpy as np

from gsbench import scenario as sc

CODE_PHASE_OFFSET = 0.5


def block_centres(scn, shape: dict, blocks, dtype=np.float64):
    """GPS receive times of the centres of `blocks`."""
    bs = shape["n_cyc"] * shape["code_samples"] / shape["fs"]
    b = np.asarray(blocks, dtype)
    return dtype(scn.t_rx0) + (b + dtype(0.5)) * dtype(bs)


def code_phase(scn, sat, shape: dict, blocks, dtype=np.float64):
    """Code phase (samples) of each of `blocks`."""
    _, tsv, _ = sc.sat_states(scn, sat, block_centres(scn, shape, blocks,
                                                        dtype), dtype)
    frac = np.mod(-tsv * dtype(1000.0), dtype(1.0))
    return (frac * dtype(shape["code_samples"])
            + dtype(CODE_PHASE_OFFSET)) % dtype(shape["code_samples"])


def doppler(scn, sat, shape: dict, blocks, dtype=np.float64):
    """Carrier frequency (Hz) at the centre of each of `blocks`."""
    t = block_centres(scn, shape, blocks, dtype)
    tau0, _, _ = sc.sat_states(scn, sat, t - dtype(0.5), dtype)
    tau1, _, _ = sc.sat_states(scn, sat, t + dtype(0.5), dtype)
    return -(tau1 - tau0) * dtype(sc.L1_FREQ)


def acquisition(scn, shape: dict, dtype=np.float64) -> dict:
    """{prn: (Doppler Hz, code delay samples)} at block 0."""
    return {sat.prn: (float(doppler(scn, sat, shape, [0], dtype)[0]),
                      float(code_phase(scn, sat, shape, [0], dtype)[0]))
            for sat in scn.sats}


def ephemerides(scn, dtype=np.float64) -> dict:
    """{prn: {field: value}}: the subframe 1-3 fields broadcast."""
    names = [n for sf in (1, 2, 3) for n, _, _ in sc.EPHEMERIS_FIELDS[sf]]
    return {sat.prn: {n: float(dtype(sat.eph[n])) for n in names}
            for sat in scn.sats}


def fix(scn, t_rx: float, dtype=np.float64, n_iter: int = 12
        ) -> np.ndarray:
    """ECEF position from the pseudoranges at receive time t_rx, solved
    as a receiver does: each satellite's transmit time (its SV-clock
    time tau_sv, what a receiver reads from the nav message, the bit and
    code counts and the code phase), pseudorange c (t_rx - tau_sv),
    corrected by the SV clock; the satellite at its GPS transmit time,
    turned by the Earth's rotation over the flight; Gauss-Newton for
    the position and the receiver's clock bias."""
    t = np.asarray([t_rx], dtype)
    c = dtype(sc.GPS_C)
    pos, rho = [], []
    for sat in scn.sats:
        _, tsv, _ = sc.sat_states(scn, sat, t, dtype)
        x, y, z, dtsv = sc.ecef_coord(sat.eph, tsv, dtype)
        # ecef_coord takes the SV-clock time and corrects it itself
        r = c * (t - tsv) + c * dtsv
        ang = dtype(sc.OMEGA_EARTH) * r / c
        ca, sa = np.cos(ang), np.sin(ang)
        pos.append(np.concatenate([ca * x + sa * y, -sa * x + ca * y, z]))
        rho.append(r[0])
    pos = np.stack(pos).astype(dtype)
    rho = np.asarray(rho, dtype)
    est = np.zeros(4, dtype)
    for _ in range(n_iter):
        d = pos - est[:3]
        rng = np.sqrt((d * d).sum(axis=1))
        h = np.concatenate([-d / rng[:, None], np.ones((len(rng), 1),
                                                       dtype)], axis=1)
        res = rho - (rng + est[3])
        est = est + np.linalg.solve(h.T @ h, h.T @ res).astype(dtype)
    return est[:3].astype(np.float64)
