"""Shared helpers of tests/test_torch_envelope_*.py: the JAX package's
operating-envelope captures replayed through the JAX Session and the
port's Session (plain path, device="cpu"), and the comparisons.

Each capture is built with its JAX test's own recipe (make_scenario,
the JAX DeviceScenarioSynth, pack_iq at the test's scale, one chunk of
no_sec blocks at a time) under a cache name of its own, through a
per-process temporary file, so two workers never write one file.

The comparisons (CHECKS) return the largest differences they
saw, so a test can both assert and report them:
  - the acquired satellites (PRN, frequency and delay exact, norm_max
    rtol 1e-4) and the slot map;
  - the decoded subframes: the same (SAT, ID, tow) keys, and every nav
    field and the sample anchor ST equal;
  - per-block code phases: the same blocks, values within 5e-3
    samples (the heavy-stage kernel tolerance);
  - each epoch's report values: FRQ within 1e-2 Hz, AMP and CRM rtol
    1e-3;
  - the phase-error count and the RAIM events (PRN and epoch exact,
    statistics rtol 1e-4);
  - fix trajectories epoch by epoch (the same epochs, positions within
    POS_ATOL, the mean within MEAN_ATOL), the velocity series within
    VEL_ATOL and clock_rate_est within 1e-11.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu_torch.utils.cplist import cp_arrays
from tests.conftest import _SYNTH_CACHE

# report keys of a frame; everything else is a decoded nav field
TRANSPORT_KEYS = {"SAT", "AMP", "CN0", "CRM", "FRQ", "SWP", "EPH", "ST"}
CP_ATOL = 5e-3
FRQ_ATOL = 1e-2
AMP_RTOL = 1e-3
CLOCK_RATE_ATOL = 1e-11
# fix trajectories: the largest separation of one epoch's fixes seen on
# the seven captures was 0.036 m (impaired), of the mean fixes 0.011 m
# (faulted, RAIM off)
POS_ATOL = 0.1
MEAN_ATOL = 0.02
VEL_ATOL = 0.05


def jax_cfg(cfg):
    """The JAX package's config with the same fields."""
    return JaxConfig(**dataclasses.asdict(cfg))


def build_capture(name: str, scn_jax, cfg, n_blocks: int, noise: float,
                  scale: float, gap: tuple | None = None) -> str:
    """Build (once) the iq8 capture `name` under .synth_cache/ with the
    JAX tests' recipe; gap = (first sample, samples dropped)."""
    from gps_sdr_tpu.models.scenario_jax import DeviceScenarioSynth
    from gps_sdr_tpu.runtime.sources import pack_iq

    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, name)
    if os.path.exists(path):
        return path
    dev = DeviceScenarioSynth(scn_jax, noise_std=noise)
    words, done = [], 0
    while done < n_blocks:
        k = min(cfg.no_sec, n_blocks - done)
        words.append(pack_iq(scale * np.asarray(dev.chunk(done, k))).ravel())
        done += k
    raw = np.concatenate(words)
    if gap is not None:
        at, n = gap
        raw = np.concatenate([raw[:at], raw[at + n:]])
    tmp = f"{path}.{os.getpid()}.tmp"
    raw.tofile(tmp)
    os.replace(tmp, path)
    return path


def run_jax(cfg, path: str, **session_kw):
    """The JAX Session over the capture, epochs recorded."""
    from gps_sdr_tpu.runtime.session import Session as JaxSession
    from gps_sdr_tpu.runtime.sources import replay_blocks as jax_replay

    jc = jax_cfg(cfg)
    session = JaxSession(jc, record_epochs_to="memory", **session_kw)
    session.run_source(jax_replay(path, jc))
    return session


def run_port(cfg, path: str, **session_kw):
    """The port's Session over the capture on the CPU (plain path)."""
    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.runtime.sources import replay_blocks

    session = Session(cfg, device="cpu", record_epochs_to="memory",
                      **session_kw)
    session.run_source(replay_blocks(path, cfg))
    return session


def run_pair(cfg, path: str, **session_kw):
    return run_jax(cfg, path, **session_kw), run_port(cfg, path,
                                                      **session_kw)


def subframes(session) -> dict:
    """{(SAT, ID, tow): frame} of every decoded subframe."""
    out = {}
    for rec in session.records:
        for sf in rec[1]:
            if "ID" in sf:
                out[(sf["SAT"], sf["ID"], sf["tow"])] = sf
    return out


def code_phases(session) -> dict:
    """{prn: (stream numbers, code phases)} over every epoch."""
    per = {}
    for rec in session.records:
        for prn, lst in rec[2].items():
            s, v = cp_arrays(lst)
            per.setdefault(int(prn), []).append((s, v))
    return {prn: (np.concatenate([s for s, _ in p]),
                  np.concatenate([v for _, v in p]))
            for prn, p in per.items()}


def check_acquisition(js, ts) -> None:
    jr, tr = js.receiver, ts.receiver
    assert [f[1:] for f in tr.found_sats] == [f[1:] for f in jr.found_sats]
    np.testing.assert_allclose([f[0] for f in tr.found_sats],
                               [f[0] for f in jr.found_sats], rtol=1e-4)
    assert tr.slots.slot_prn == jr.slots.slot_prn
    for name in ("sweeps_served", "warm_sweeps", "skipped_blocks"):
        assert getattr(tr.status, name) == getattr(jr.status, name), name


def check_subframes(js, ts) -> int:
    """The same decoded subframes, field for field; returns how many."""
    jf, tf = subframes(js), subframes(ts)
    assert sorted(tf) == sorted(jf)
    for key, j in jf.items():
        t = tf[key]
        assert sorted(t) == sorted(j), key
        for name in set(j) - (TRANSPORT_KEYS - {"ST"}):
            assert t[name] == j[name], (key, name, t[name], j[name])
    return len(jf)


def check_code_phases(js, ts) -> float:
    """The same blocks' code phases within CP_ATOL; returns the largest
    difference."""
    jc, tc = code_phases(js), code_phases(ts)
    assert sorted(tc) == sorted(jc)
    worst = 0.0
    for prn, (js_, jv) in jc.items():
        ts_, tv = tc[prn]
        np.testing.assert_array_equal(ts_, js_, err_msg=f"PRN {prn}")
        np.testing.assert_allclose(tv, jv, atol=CP_ATOL,
                                   err_msg=f"PRN {prn}")
        if len(jv):
            worst = max(worst, float(np.max(np.abs(tv - jv))))
    return worst


def check_reports(js, ts) -> dict:
    """Each epoch's frames: the same satellites, sweeps and keys; FRQ,
    AMP and CRM to tolerance.  Returns the largest differences."""
    assert len(ts.records) == len(js.records)
    worst = {"FRQ": 0.0, "AMP": 0.0, "CRM": 0.0}
    for jrec, trec in zip(js.records, ts.records):
        assert trec[0] == jrec[0]                    # skipped samples
        assert [sorted(f) for f in trec[1]] == [sorted(f) for f in jrec[1]]
        for j, t in zip(jrec[1], trec[1]):
            assert (t["SAT"], t["SWP"]) == (j["SAT"], j["SWP"])
            np.testing.assert_allclose(t["FRQ"], j["FRQ"], atol=FRQ_ATOL)
            np.testing.assert_allclose(t["AMP"], j["AMP"], rtol=AMP_RTOL)
            np.testing.assert_allclose(t["CRM"], j["CRM"], rtol=AMP_RTOL)
            worst["FRQ"] = max(worst["FRQ"], abs(t["FRQ"] - j["FRQ"]))
            for name in ("AMP", "CRM"):
                worst[name] = max(worst[name],
                                  abs(t[name] - j[name]) / abs(j[name]))
    return worst


def check_evaluator(js, ts) -> dict:
    """Phase errors, RAIM events, clock rate, the velocity series, and
    the fix trajectory epoch by epoch within POS_ATOL m (the mean fix
    within MEAN_ATOL); returns the largest differences."""
    je, te = js.evaluator, ts.evaluator
    assert te.n_phase_errors == je.n_phase_errors
    assert [e[:2] for e in te.raim_events] == [e[:2] for e in je.raim_events]
    if je.raim_events:
        np.testing.assert_allclose([e[2:] for e in te.raim_events],
                                   [e[2:] for e in je.raim_events],
                                   rtol=1e-4)
    assert abs(te.clock_rate_est - je.clock_rate_est) <= CLOCK_RATE_ATOL
    out = {"fix_m": 0.0, "mean_m": 0.0, "vel_mps": 0.0}
    jv = np.asarray(je.velocities, np.float64)
    tv = np.asarray(te.velocities, np.float64)
    assert tv.shape == jv.shape
    if len(jv):
        np.testing.assert_array_equal(tv[:, 0], jv[:, 0])
        out["vel_mps"] = float(np.abs(tv[:, 1:] - jv[:, 1:]).max())
        assert out["vel_mps"] <= VEL_ATOL, out
    jp = np.asarray(je.positions, np.float64)
    tp = np.asarray(te.positions, np.float64)
    assert tp.shape == jp.shape
    if len(jp):
        np.testing.assert_array_equal(tp[:, 0], jp[:, 0])
        out["fix_m"] = float(np.linalg.norm(tp[:, 1:4] - jp[:, 1:4],
                                            axis=1).max())
        out["mean_m"] = float(np.linalg.norm(te.stat[0] - je.stat[0]))
        assert out["fix_m"] <= POS_ATOL and out["mean_m"] <= MEAN_ATOL, out
    return out


CHECKS = {"acquisition": check_acquisition, "subframes": check_subframes,
          "code_phases": check_code_phases, "reports": check_reports,
          "evaluator": check_evaluator}


def fix_error(ev, truth) -> float:
    """Mean fix's distance from the truth, m (NaN without a fix)."""
    if ev.stat is None:
        return float("nan")
    return float(np.linalg.norm(ev.stat[0] - truth))
