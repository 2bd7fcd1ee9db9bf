"""The port's copies of the JAX package's host modules against the
originals: the Evaluator (runtime/evaluator.py, with pseudorange, pvt,
orbits, cplist and tuplelog behind it) on one recorded epoch stream, and
the NavDecoder (models/navmsg.py) on the bit edges of the scenario's
navigation messages.

The copies keep only the numpy paths of the JAX package's native host
core, so the originals run with GSDR_EVALCORE=0 and GSDR_NAVSCAN=0:
the same numpy code on the same inputs.  Exact: every fix, every
per-epoch summary, the position statistics, and every subframe."""

import copy
import dataclasses

import numpy as np
import pytest

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.models import navmsg as jnav
from gps_sdr_tpu.runtime import evaluator as jev
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models import navmsg
from gps_sdr_tpu_torch.models.scenario import make_scenario
from gps_sdr_tpu_torch.runtime import evaluator as tev

CFG = ReceiverConfig()
N_SEC = 30


@pytest.fixture(autouse=True)
def _numpy_host_core(monkeypatch):
    monkeypatch.setenv("GSDR_EVALCORE", "0")
    monkeypatch.setenv("GSDR_NAVSCAN", "0")


@pytest.fixture(scope="module")
def scn():
    return make_scenario(CFG, n_sats=6, duration_sec=N_SEC + 6.0, seed=3)


def _epoch_stream(scn, n_sec):
    """Per second: the subframes (delivered once their 6 s have arrived)
    and the code phases an ideal tracker measures at each block center
    (tests/test_pipeline.py's geometric oracle)."""
    cfg = scn.cfg
    fs, ngps, cs = cfg.sample_rate, cfg.ngps, cfg.code_samples
    n_blocks = n_sec * cfg.no_sec
    centers = scn.t_rx0 + (np.arange(n_blocks) * ngps + ngps / 2) / fs
    coph, frames = {}, {}
    for sat in scn.sats:
        _, tau_sv = scn.sat_states(centers, sat)
        frac = tau_sv * 1000.0 - np.floor(tau_sv * 1000.0)
        mod = (np.arange(n_blocks) * ngps + ngps + ngps // 2) % cs
        cp = (mod - frac * cs) % cs
        coph[sat.prn] = [(b + 1, float(cp[b])) for b in range(n_blocks)]
        frames[sat.prn] = []
        for k in range(n_sec // 6 + 2):
            tow = scn.tow0 + k
            t_emit = (tow - 1) * 6.0
            t = t_emit + 0.07
            for _ in range(4):
                _, tsv = scn.sat_states(np.array([t]), sat)
                t = t - (tsv[0] - t_emit)
            st = int(round((t - scn.t_rx0) * fs)) + ngps
            sf_id = (tow - 1) % 5 + 1
            sf = navmsg.decode_subframe(navmsg.encode_subframe(
                sf_id, sat.eph if sf_id in (1, 2, 3) else {}, tow))
            sf.update(ST=st, SAT=sat.prn, AMP=9.0, CRM=20.0, FRQ=0.0,
                      SWP=False)
            frames[sat.prn].append((st, sf))
    epochs = []
    for sec in range(n_sec):
        lo, hi = sec * cfg.no_sec + 1, (sec + 1) * cfg.no_sec + 1
        fr = [sf for sat in scn.sats for st, sf in frames[sat.prn]
              if lo * ngps <= st + 6 * fs < hi * ngps]
        cps = {sat.prn: [e for e in coph[sat.prn] if lo <= e[0] < hi]
               for sat in scn.sats}
        epochs.append((0, fr, cps))
    return epochs


def test_evaluator_copy_matches_original(scn):
    epochs = _epoch_stream(scn, N_SEC)
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    je, te = jev.Evaluator(jcfg), tev.Evaluator(CFG)
    n_fixes = 0
    for rec in epochs:
        js = je.process(jev.EpochInput(*copy.deepcopy(rec)))
        ts = te.process(tev.EpochInput(*copy.deepcopy(rec)))
        np.testing.assert_equal(ts, js)
        n_fixes += ts["n_fixes"]
    assert n_fixes > 5 * CFG.no_sec
    np.testing.assert_equal(te.positions, je.positions)
    np.testing.assert_equal(te.stat, je.stat)
    assert float(np.linalg.norm(te.stat[0] - scn.rec_ecef)) < 5.0
    assert te.n_phase_errors == je.n_phase_errors == 0
    assert sorted(te.engines) == sorted(je.engines)
    for sat, eng in te.engines.items():
        assert eng.ephem_ok == je.engines[sat].ephem_ok
        np.testing.assert_equal(eng.ephem, je.engines[sat].ephem)


@pytest.mark.parametrize("n_polls", [1, 7])
def test_nav_decoder_copy_matches_original(scn, n_polls):
    """Edges at every bit transition of each satellite's navigation
    stream (1-3 ms past the 20 ms boundary, r > 17 rounding on the way),
    fed in n_polls parts; both decoders must return the same subframes
    and keep the same tail."""
    ngps, cs = CFG.ngps, CFG.code_samples
    n_sub = 0
    for sat in scn.sats:
        bits = sat.nav_stream.astype(np.int8)
        idx = np.nonzero(np.diff(bits))[0] + 1
        ms = 20 * idx.astype(np.int64) + 1 + idx % 3
        st = ms * cs + 7 * ngps
        parts = np.array_split(np.arange(idx.size), n_polls)
        jd, td = jnav.NavDecoder(ngps=ngps), navmsg.NavDecoder(ngps=ngps)
        got, want = [], []
        for dec, out in ((jd, want), (td, got)):
            dec.last_sign = int(bits[0])
            for p in parts:
                dec.edge_parts.append((ms[p], st[p]))
                out += dec.poll_subframes()
        np.testing.assert_equal(got, want)
        np.testing.assert_array_equal(td.bits, jd.bits)
        np.testing.assert_array_equal(td.bits_st, jd.bits_st)
        n_sub += len(got)
    assert n_sub >= 3 * len(scn.sats)


def test_nav_decoder_drops_edges_from_before_a_restart():
    """A slot re-acquired while a window tracked with its old state was in
    flight (run_device and serving, download_windows_in_flight > 1) hands
    the new decoder that window's edges in the old ms_time base, then
    edges whose ms_time restarts near 0.  The reference decoder raises on
    the negative interval (np.repeat); the port's keeps the edges from
    the restart on and frames them as a fresh decoder does."""
    stale = [(4392, 1_148_718), (4412, 1_189_678)]
    fresh = [(16 + 20 * i + (20 if i % 3 == 0 else 0), 1_333_037 + 40_960 * i)
             for i in range(40)]
    for dec_cls in (jnav.NavDecoder, navmsg.NavDecoder):
        dec = dec_cls(ngps=CFG.ngps)
        dec.edges = stale + fresh
        dec.last_sign = -1
        if dec_cls is jnav.NavDecoder:
            with pytest.raises(ValueError, match="negative"):
                dec._frame_bits()
            continue
        bits, sts = dec._frame_bits()
        ref = navmsg.NavDecoder(ngps=CFG.ngps)
        ref.edges = fresh
        ref.last_sign = -1                  # two stale edges: same parity
        want_bits, want_sts = ref._frame_bits()
        assert bits.size > 30
        np.testing.assert_array_equal(bits, want_bits)
        np.testing.assert_array_equal(sts, want_sts)
        assert dec.edges == ref.edges and dec.last_sign == ref.last_sign
