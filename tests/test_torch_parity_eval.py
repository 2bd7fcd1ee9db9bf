"""Twins of the JAX package's tests of the host evaluation chain on the
port's copies: tests/test_pvt.py, test_pseudorange_walk.py,
test_evaluator_unwrap.py, the unit cases of test_trackfilter.py, the
host cases of test_carrier_smoothing.py, test_pipeline.py's warm start,
poison pill and merged windows, and test_aux_units.py's RAIM expiry and
track-filter guards.

Each twin feeds the same inputs to the JAX package's function and the
port's copy (ops/pvt, models/pseudorange, runtime/{evaluator,
trackfilter}), applies the JAX test's bar to both, and holds the results
equal exactly (tests/torch_parity.py).  Not twinned here, because
tests/test_torch_native.py::test_fix_batch_matches_numpy_and_jax holds
solve_fix_batch against the JAX package with a height constraint and a
shared warm start already: test_pvt.py's
test_batch_matches_single_height_mode and test_batch_warm_start_shared."""

import copy

import numpy as np
import pytest

from tests.test_carrier_smoothing import _truth_series
from tests.test_evaluator_unwrap import _random_list, _unwrap_loop
from tests.test_pipeline import ideal_measurements
from tests.test_pseudorange_walk import _oracle_eval, _random_lists
from tests.test_pvt import REC, _delays, _sat_constellation
from tests.test_navmsg import SF1, SF2, SF3
from tests.torch_parity import numpy_host_core, pair, same, twin  # noqa

pytestmark = pytest.mark.usefixtures("numpy_host_core")


# --- tests/test_pvt.py ------------------------------------------------------


@pytest.mark.parametrize("n_sat", [4, 6, 9])
def test_fix_recovers_position(n_sat):
    sat_pos = _sat_constellation(n_sat)
    delays = _delays(sat_pos)

    def fix(pvt, config):
        f = pvt.solve_fix(sat_pos, delays, max_it=15, max_residual=1e-8)
        assert f.residual < 1e-6
        assert np.linalg.norm(f.rec_pos[1:] - REC) < 0.5
        tau0 = np.linalg.norm(sat_pos[:, 0] - REC) / config.GPS_C
        assert abs(f.rec_pos[0] / config.GPS_C - tau0) < 1e-7
        return f
    twin(fix, "ops.pvt", "config")


def test_fix_weighted_downweights_bad_sat():
    sat_pos = _sat_constellation(7, seed=2)
    delays = _delays(sat_pos)
    delays[3] += 300.0 / 299792458.0
    std = np.full(7, 3.0)
    std[3] = 300.0

    def weighted(pvt):
        fw, fu = pvt.solve_fix(sat_pos, delays, std_dev=std), \
            pvt.solve_fix(sat_pos, delays)
        err_w = np.linalg.norm(fw.rec_pos[1:] - REC)
        assert err_w < np.linalg.norm(fu.rec_pos[1:] - REC) and err_w < 5.0
        return fw, fu
    twin(weighted, "ops.pvt")


def test_fix_three_sats_with_height():
    sat_pos = _sat_constellation(3, seed=4)
    delays = _delays(sat_pos)

    def height(pvt):
        f = pvt.solve_fix(sat_pos, delays, height=150.0, height_dev=1.0,
                          max_it=20)
        assert np.linalg.norm(f.rec_pos[1:] - REC) < 10.0
        return f
    twin(height, "ops.pvt")


def test_batch_matches_single():
    rng = np.random.default_rng(9)
    sat_pos = np.stack([_sat_constellation(6, seed=10 + i)
                        for i in range(5)])
    delays = np.stack([_delays(sat_pos[i], clock_bias=0.03 + 0.001 * i)
                       for i in range(5)])
    stds = rng.uniform(1.0, 5.0, size=(5, 6))

    def batch(pvt):
        fb = pvt.solve_fix_batch(sat_pos, delays, std_dev=stds)
        singles = [pvt.solve_fix(sat_pos[i], delays[i], std_dev=stds[i])
                   for i in range(5)]
        for b, s in zip(fb, singles):
            np.testing.assert_allclose(b.rec_pos, s.rec_pos, atol=1e-5)
            np.testing.assert_allclose(b.range_est, s.range_est, atol=1e-4)
            np.testing.assert_allclose(b.meas_delay, s.meas_delay,
                                       atol=1e-5)
            assert b.residual < 1e-5
        return list(fb), singles
    twin(batch, "ops.pvt")


def test_fix_warm_start_converges_faster():
    sat_pos = _sat_constellation(5, seed=6)
    delays = _delays(sat_pos)

    def warm(pvt):
        cold = pvt.solve_fix(sat_pos, delays)
        w = pvt.solve_fix(sat_pos, delays, rec_pos0=np.array([0.0, *REC]))
        assert w.n_iter <= cold.n_iter
        assert np.linalg.norm(w.rec_pos[1:] - REC) < 0.5
        return cold, w
    twin(warm, "ops.pvt")


def _skewed(n, seed, y=2.0e-6):
    sat_pos = _sat_constellation(n, seed=seed)
    d = _delays(sat_pos)
    return sat_pos, d[0] + (d - d[0]) * (1.0 + y)


def test_clock_rate_fix_removes_skew_bias():
    sat_pos, d_skew = _skewed(8, 7)

    def skew(pvt):
        biased = pvt.solve_fix(sat_pos, d_skew)
        fixed = pvt.solve_fix(sat_pos, d_skew, clock_rate_fix=2.0e-6)
        assert np.linalg.norm(biased.rec_pos[1:] - REC) > 2.0
        assert np.linalg.norm(fixed.rec_pos[1:] - REC) < 0.5
        return biased, fixed
    twin(skew, "ops.pvt")


def test_clock_rate_free_unknown_recovers_y():
    sat_pos, d_skew = _skewed(9, 8)

    def free(pvt):
        f = pvt.solve_fix(sat_pos, d_skew, clock_rate=True, max_it=25)
        assert abs(f.clock_rate - 2.0e-6) < 1e-7
        assert np.linalg.norm(f.rec_pos[1:] - REC) < 0.5
        return f
    twin(free, "ops.pvt")


def test_clock_rate_batch_matches_single():
    sat_pos = np.stack([_sat_constellation(7, seed=40 + i)
                        for i in range(3)])
    delays = np.stack([_delays(sat_pos[i]) for i in range(3)])
    delays = delays[:, :1] + (delays - delays[:, :1]) * (1.0 + 1.5e-6)

    def batch(pvt):
        fb = pvt.solve_fix_batch(sat_pos, delays, clock_rate=True,
                                 max_it=25)
        singles = [pvt.solve_fix(sat_pos[i], delays[i], clock_rate=True,
                                 max_it=25) for i in range(3)]
        for b, s in zip(fb, singles):
            np.testing.assert_allclose(b.rec_pos, s.rec_pos, atol=1e-4)
            assert abs(b.clock_rate - s.clock_rate) < 1e-9
        return list(fb), singles
    twin(batch, "ops.pvt")


# --- tests/test_pseudorange_walk.py -----------------------------------------


def _engine(config, navmsg, pseudorange, cfg_kw, tow0):
    """test_pseudorange_walk._make_engine in either package."""
    cfg = config.ReceiverConfig(**cfg_kw)
    eng = pseudorange.PseudorangeEngine(5, cfg)
    for sf_id, f in ((1, SF1), (2, SF2), (3, SF3)):
        d = navmsg.decode_subframe(navmsg.encode_subframe(sf_id, f,
                                                          tow0 + sf_id))
        d["ST"] = (tow0 + sf_id) * 6 * int(cfg.sample_rate)
        d["SAT"] = 5
        eng.read_frame(d)
    assert eng.ephem_ok
    return eng


def _engine_state(eng) -> dict:
    return {k: getattr(eng, k) for k in (
        "ref_time", "last_sno", "last_cp", "cp_hist", "slope_hist",
        "hatch_state", "phase_err_snos")}


@pytest.mark.parametrize("n_cyc", [32, 16, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_matches_sequential(n_cyc, seed):
    """The JAX test's 30 random code-phase lists through the vectorized
    walk of both packages (equal result tuples and engine state) and the
    sequential oracle on a copy of the JAX engine (the JAX test's bar)."""
    rng = np.random.default_rng(100 * n_cyc + seed)
    tow0 = int(rng.integers(1000, 100000))
    mods = list(zip(pair("config"), pair("models.navmsg"),
                    pair("models.pseudorange")))
    jeng, teng = (_engine(*m, {"n_cyc": n_cyc}, tow0) for m in mods)
    oracle = copy.deepcopy(jeng)
    cfg = jeng.cfg
    ref_sno = ((tow0 + 3) * 6 * int(cfg.sample_rate)) // cfg.ngps
    sno0 = ref_sno + int(rng.integers(-3, 40))
    for lst in _random_lists(rng, cfg, sno0, n_lists=30):
        want = jeng.eval_code_phases(list(lst))
        got = teng.eval_code_phases(list(lst))
        same(got, want)
        same(_engine_state(teng), _engine_state(jeng))
        ref = _oracle_eval(oracle, list(lst))
        assert len(got) == len(ref)
        for g, w in zip(got, ref):
            assert g[0] == w[0] and g[1] == w[1] and g[6:8] == w[6:8]
            assert g[2:6] == pytest.approx(w[2:6], abs=1e-9)
            assert g[8] == pytest.approx(w[8], abs=1e-12)
        assert teng.ref_time == oracle.ref_time
        assert teng.last_sno == oracle.last_sno
        assert teng.last_cp == pytest.approx(oracle.last_cp, abs=1e-9)
        assert teng.cp_hist == pytest.approx(oracle.cp_hist)


def test_finish_deferred_mixed_preloaded_and_decoded_ephems():
    def finish(config, scenario, pseudorange, orbits):
        cfg = config.ReceiverConfig()
        scn = scenario.make_scenario(cfg, n_sats=2, duration_sec=12.0,
                                     seed=6)
        eph_pre = dict(scn.sats[0].eph, SAT=scn.sats[0].prn)
        eph_dec = dict(scn.sats[1].eph)
        one = np.array([0], np.int64)
        res = pseudorange.finish_deferred([pseudorange.DeferredRows(
            sat_no=s.prn, week_num=scn.week, sigma=np.array([1.0]),
            ephem=eph, tow=np.array([scn.tow0], np.int64), delta_st=one,
            smp=np.array([1000.0]), cyc=one)
            for s, eph in zip(scn.sats, (eph_pre, eph_dec))], cfg)
        assert len(res) == 2
        for i, eph in enumerate((eph_pre, eph_dec)):
            x, y, z, _ = orbits.ecef_coord(scn.tow0, eph,
                                           dt_from_tow=1 / cfg.sample_rate)
            assert np.allclose(res.pos[i], [x, y, z])
        return res
    twin(finish, "config", "models.scenario", "models.pseudorange",
         "models.orbits")


# --- tests/test_evaluator_unwrap.py -----------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_unwrap_matches_sequential_walk(seed):
    (jcfg, tcfg), (jev, tev) = (tuple(m.ReceiverConfig() for m in
                                      pair("config")),
                                pair("runtime.evaluator"))
    rng = np.random.default_rng(seed)
    for _ in range(20):
        lst = _random_list(rng, jcfg, int(rng.integers(1, 40)))
        tail = None
        if rng.random() < 0.5:
            tno = lst[0][0] - int(rng.integers(1, jcfg.n_cyc // 4 + 3))
            tail = (tno, float(rng.uniform(-jcfg.code_samples,
                                           2 * jcfg.code_samples)))
        runs = []
        for ev, cfg in ((jev, jcfg), (tev, tcfg)):
            log = []
            cpl, err = ev.unwrap_code_phases(7, list(lst), {}, tail, cfg,
                                             log)
            runs.append((list(cpl), err, log))
        same(runs[1], runs[0])
        want, err_w = _unwrap_loop(lst, {}, tail, jcfg, log_w := [])
        got, err, log = runs[1]
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_allclose([c for _, c in got],
                                   [c for _, c in want], atol=1e-9)
        assert err == err_w and log == log_w


# --- tests/test_trackfilter.py (units) and test_aux_units.py ----------------


def _filter_state(tf) -> dict:
    return {"x": tf.x, "p": tf.p, "t": tf.t}


def test_static_convergence():
    rng = np.random.default_rng(1)
    zs = [np.array([100.0, -50.0, 20.0]) + rng.normal(scale=5.0, size=3)
          for _ in range(200)]

    def static(trackfilter):
        tf = trackfilter.TrackFilter(q_accel=0.05)
        states = []
        for i, z in enumerate(zs):
            assert tf.update_pos(i * 0.032, z, np.eye(3) * 25.0)
            states.append(_filter_state(tf))
        assert np.linalg.norm(tf.pos - [100.0, -50.0, 20.0]) < 2.5
        assert np.linalg.norm(tf.vel) < 0.5
        return states
    twin(static, "runtime.trackfilter")


def test_constant_velocity_tracking_and_fusion():
    v = np.array([10.0, -3.0, 1.0])
    rng = np.random.default_rng(2)
    noise = {use: ([rng.normal(scale=8.0, size=3) for _ in range(300)],
                   [rng.normal(scale=0.1, size=3) for _ in range(300)])
             for use in (False, True)}

    def fusion(trackfilter):
        out = {}
        for use_vel in (False, True):
            tf = trackfilter.TrackFilter(q_accel=0.5)
            pos_n, vel_n = noise[use_vel]
            errs = []
            for i in range(300):
                t = i * 0.032
                tf.update_pos(t, v * t + pos_n[i], np.eye(3) * 64.0)
                if use_vel and i % 32 == 31:
                    tf.update_vel(t, v + vel_n[i], np.eye(3) * 0.01)
                if i > 150:
                    errs.append(np.linalg.norm(tf.pos - v * t))
            out[use_vel] = (float(np.mean(errs)), _filter_state(tf))
        assert out[True][0] < out[False][0] and out[True][0] < 2.5
        assert np.linalg.norm(out[True][1]["x"][3:] - v) < 0.15
        return out
    twin(fusion, "runtime.trackfilter")


def test_innovation_gate_rejects_outliers():
    def gate(trackfilter):
        tf = trackfilter.TrackFilter(q_accel=0.1)
        for i in range(100):
            assert tf.update_pos(i * 0.032, np.zeros(3), np.eye(3) * 4.0)
        assert not tf.update_pos(3.3, np.array([500.0, 0, 0]),
                                 np.eye(3) * 4.0)
        assert np.linalg.norm(tf.pos) < 1.0
        return _filter_state(tf)
    twin(gate, "runtime.trackfilter")


def test_trackfilter_guards():
    def guards(trackfilter):
        tf = trackfilter.TrackFilter(q_accel=1.0)
        assert not tf.update_vel(0.0, np.zeros(3), np.eye(3))
        assert tf.pos is None and tf.vel is None
        assert tf.update_pos(1.0, np.array([1.0, 2.0, 3.0]), np.eye(3))
        assert tf.update_pos(0.5, np.array([1.1, 2.0, 3.0]), np.eye(3))
        assert np.all(np.isfinite(tf.p))
        return _filter_state(tf)
    twin(guards, "runtime.trackfilter")


def test_raim_exclusion_expires():
    def expiry(config, pseudorange, evaluator):
        ev = evaluator.Evaluator(config.ReceiverConfig(
            raim=True, raim_exclude_sec=10.0))
        ev.raim_excluded = {7: 66700.0}

        def rows(tow):
            return pseudorange.SatRows(
                sat_no=np.array([7, 9]), tow=np.full(2, tow, np.int64),
                pos=np.zeros((2, 3)), t=np.zeros(2),
                week=np.full(2, 312, np.int64), cyc=np.zeros(2, np.int64),
                sigma=np.ones(2))
        before = ev._raim_drop_excluded(rows(tow=11100))
        assert before.sat_no.tolist() == [9]
        after = ev._raim_drop_excluded(rows(tow=11120))
        assert after.sat_no.tolist() == [7, 9] and ev.raim_excluded == {}
        return before, after
    twin(expiry, "config", "models.pseudorange", "runtime.evaluator")


# --- tests/test_carrier_smoothing.py (host) ---------------------------------


def _hatch_engine(config, pseudorange, window):
    return pseudorange.PseudorangeEngine(
        5, config.ReceiverConfig(carrier_smoothing=window))


def test_hatch_reduces_noise_without_lag():
    rng = np.random.default_rng(3)
    snos, truth, f = _truth_series(None, pair("config")[0].ReceiverConfig(),
                                   600)
    noisy = truth + rng.normal(0, 0.05, truth.shape)

    def hatch(config, pseudorange):
        sm = _hatch_engine(config, pseudorange, 64)._hatch(snos, noisy, f)
        raw = float(np.sqrt(np.mean((noisy - truth) ** 2)))
        err = sm[128:] - truth[128:]
        assert float(np.sqrt(np.mean(err ** 2))) < raw / 3.5
        assert abs(np.mean(err)) < 0.01
        return sm
    twin(hatch, "config", "models.pseudorange")


def test_hatch_state_carries_across_calls():
    rng = np.random.default_rng(4)
    snos, truth, f = _truth_series(None, pair("config")[0].ReceiverConfig(),
                                   300)
    noisy = truth + rng.normal(0, 0.05, truth.shape)

    def carry(config, pseudorange):
        one = _hatch_engine(config, pseudorange, 32)._hatch(snos, noisy, f)
        eng = _hatch_engine(config, pseudorange, 32)
        parts = np.concatenate([
            eng._hatch(snos[i:i + 31], noisy[i:i + 31], f[i:i + 31])
            for i in range(0, 300, 31)])
        np.testing.assert_allclose(parts, one, atol=1e-9)
        return one, parts, eng.hatch_state
    twin(carry, "config", "models.pseudorange")


def test_hatch_resets_on_gap_and_jump():
    rng = np.random.default_rng(5)
    snos, truth, f = _truth_series(None, pair("config")[0].ReceiverConfig(),
                                   120)
    noisy = truth + rng.normal(0, 0.05, truth.shape)

    def reset(config, pseudorange):
        eng = _hatch_engine(config, pseudorange, 32)
        eng._hatch(snos, noisy, f)
        far = snos + 10_000
        out = eng._hatch(far[:10], noisy[:10], f[:10])
        assert out[0] == noisy[0]
        out2 = eng._hatch(far[10:20] + 1, noisy[10:20] + 800.0, f[10:20])
        assert out2[0] == noisy[10] + 800.0
        return out, out2, eng.hatch_state
    twin(reset, "config", "models.pseudorange")


# --- the evaluator on ideal measurements (tests/test_pipeline.py) -----------


def _ideal(duration, n_sec):
    """The JAX tests' scenario (6 satellites, seed 3) in the JAX package,
    and its ideal measurements for n_sec s; the port's scenario of the
    same seed must hold the same satellites."""
    scns = [m.make_scenario(c.DEFAULT, n_sats=6, duration_sec=duration,
                            seed=3)
            for c, m in zip(pair("config"), pair("models.scenario"))]
    for a, b in zip(*(s.sats for s in scns)):
        same((b.prn, b.eph), (a.prn, a.eph))
    same(scns[1].rec_ecef, scns[0].rec_ecef)
    return (scns[0],) + ideal_measurements(scns[0], n_sec)


@pytest.fixture(scope="module")
def ideal():
    """tests/test_pipeline.py's: 40 s, measurements for 32 s."""
    return _ideal(40.0, 32)


def _epochs(scn, coph, frames, n_sec, edit=None):
    """Per second, the JAX tests' epoch inputs: subframes delivered once
    their 6 s have arrived, code phases of the second's blocks;
    edit(sec, prn, list) may change a satellite's list."""
    cfg = scn.cfg
    out = []
    for sec in range(n_sec):
        lo, hi = sec * cfg.no_sec + 1, (sec + 1) * cfg.no_sec + 1
        fr, cps = [], {}
        for sat in scn.sats:
            fr += [dict(sf) for st, sf in frames[sat.prn]
                   if lo * cfg.ngps <= st + 6 * cfg.sample_rate
                   < hi * cfg.ngps]
            lst = [(s, c) for s, c in coph[sat.prn] if lo <= s < hi]
            cps[sat.prn] = edit(sec, sat.prn, lst) if edit else lst
        out.append((0, fr, cps))
    return out


def _run_evaluators(epochs, cfg_kw=None, **ev_kw):
    """The same epochs (deep copies) through the JAX Evaluator and the
    port's; returns both evaluators and their summaries."""
    out = []
    for config, evaluator in zip(pair("config"), pair("runtime.evaluator")):
        cfg = config.DEFAULT.replace(**(cfg_kw or {}))
        ev = evaluator.Evaluator(cfg, **copy.deepcopy(ev_kw))
        sums = [ev.process(evaluator.EpochInput(*copy.deepcopy(e)))
                for e in epochs]
        out.append((ev, sums))
    return out


def _evaluator_facts(ev) -> dict:
    return {"positions": ev.positions, "all_pos": ev.all_pos,
            "stat": ev.stat, "n_phase_errors": ev.n_phase_errors,
            "fix_failures": ev.fix_failures, "outliers": ev.outliers,
            "ref_time": {s: e.ref_time for s, e in ev.engines.items()}}


def _same_runs(runs):
    (je, js), (te, ts) = runs
    same(ts, js, "summaries")
    same(_evaluator_facts(te), _evaluator_facts(je))


def test_warm_start_from_cached_ephemeris(ideal):
    scn, coph, frames = ideal
    pre = {s.prn: dict(s.eph, IODE2=s.eph["IODC"] & 255,
                       IODE3=s.eph["IODC"] & 255) for s in scn.sats}
    runs = _run_evaluators(_epochs(scn, coph, frames, 12),
                           preloaded_ephem=pre)
    _same_runs(runs)
    for ev, sums in runs:
        assert sum(s["n_fixes"] for s in sums) >= 30
        assert np.linalg.norm(ev.stat[0] - scn.rec_ecef) < 5.0


def test_phase_error_poison_pill(ideal):
    scn, coph, frames = ideal
    cs = scn.cfg.code_samples

    def jump(sec, prn, lst):
        return [(s, (c + 40.0) % cs) for s, c in lst] if sec == 19 else lst
    runs = _run_evaluators(_epochs(scn, coph, frames, 20, jump))
    _same_runs(runs)
    for ev, _ in runs:
        assert ev.n_phase_errors >= 1
        assert all(e.ref_time is None for e in ev.engines.values())


def test_merged_epochs_match_per_chunk(ideal):
    """32 s per second and in merged 8 s windows, both packages: the
    merged run a superset of the per-second fixes agreeing to cm (the
    JAX test's bar), each run equal across the packages."""
    scn, coph, frames = ideal
    epochs = _epochs(scn, coph, frames, 32)
    per_sec = _run_evaluators(epochs)
    _same_runs(per_sec)
    merged = []
    for evaluator in pair("runtime.evaluator"):
        wins = [evaluator.merge_epochs([evaluator.EpochInput(
            *copy.deepcopy(e)) for e in epochs[i:i + 8]])
            for i in range(0, 32, 8)]
        merged.append(wins)
    same(merged[1], merged[0], "merged windows")
    windows = _run_evaluators([(w.skipped_samples, w.frames, w.code_phases)
                               for w in merged[0]])
    _same_runs(windows)
    for (ev_a, _), (ev_b, _) in zip(per_sec, windows):
        na, nb = len(ev_a.positions), len(ev_b.positions)
        assert 0 < na <= nb
        ta = {round(p[0], 4): np.asarray(p[1:]) for p in ev_a.positions}
        tb = {round(p[0], 4): np.asarray(p[1:]) for p in ev_b.positions}
        common = sorted(set(ta) & set(tb))
        assert len(common) >= na - 2
        d = [np.linalg.norm(ta[t] - tb[t]) for t in common]
        assert np.median(d) < 0.5 and max(d) < 5.0
        assert np.linalg.norm(ev_b.stat[0] - scn.rec_ecef) < 5.0


def test_closed_loop_fixes_improve():
    """test_carrier_smoothing.py's closed loop: 48 s of ideal code phases
    (its 52 s scenario) with 0.05-sample noise, raw and carrier-smoothed
    (window 96) with the carrier frequencies an ideal tracker reports."""
    scn, coph, frames = _ideal(52.0, 48)
    cfg = scn.cfg
    rng = np.random.default_rng(11)
    noisy = {prn: [(s, c + rng.normal(0, 0.05)) for s, c in lst]
             for prn, lst in coph.items()}
    n_blocks = 48 * cfg.no_sec
    centers = scn.t_rx0 + (np.arange(n_blocks) * cfg.ngps
                           + cfg.ngps / 2) / cfg.sample_rate
    cfrq = {}
    for sat in scn.sats:
        tau0, _ = scn.sat_states(centers - 0.5, sat)
        tau1, _ = scn.sat_states(centers + 0.5, sat)
        f_geo = -(tau1 - tau0) * 1575.42e6
        cfrq[sat.prn] = [(b + 1, float(f_geo[b])) for b in range(n_blocks)]
    raw = _epochs(scn, noisy, frames, 48)
    with_freq = [rec + ({p: [(s, f) for s, f in cfrq[p]
                             if sec * cfg.no_sec < s
                             <= (sec + 1) * cfg.no_sec]
                         for p in rec[2]},)
                 for sec, rec in enumerate(raw)]
    runs_raw = _run_evaluators(raw)
    runs_sm = _run_evaluators(with_freq, {"carrier_smoothing": 96})
    _same_runs(runs_raw)
    _same_runs(runs_sm)
    for (ev_raw, _), (ev_sm, _) in zip(runs_raw, runs_sm):
        assert np.mean(ev_sm.stat[1]) < np.mean(ev_raw.stat[1]) / 2.5
        err_raw = np.linalg.norm(np.mean(np.asarray(ev_raw.all_pos)[160:],
                                         axis=0) - scn.rec_ecef)
        err_sm = np.linalg.norm(np.mean(np.asarray(ev_sm.all_pos)[160:],
                                        axis=0) - scn.rec_ecef)
        assert err_sm < max(2.0 * err_raw, 5.0)
