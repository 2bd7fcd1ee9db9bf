"""Twins of the JAX package's model and utility tests on the port's copies:
tests/test_cacode.py, test_geodesy.py, test_orbits.py, test_navmsg.py,
test_scenario_synth.py, the models' cases of test_atmosphere.py and of
test_aux_units.py.

Each twin runs the JAX test's computation on the JAX package's modules
and on the port's (ops/cacode, utils/{geodesy,gpstime},
models/{orbits,navmsg,atmosphere,almanac,scenario}), applies the JAX
test's bar to both, and holds the two results equal exactly
(tests/torch_parity.py)."""

import datetime

import numpy as np
import pytest

from tests.test_cacode import FIRST10_OCTAL
from tests.test_navmsg import SF1, SF2, SF3
from tests.test_orbits import EPH, TOW
from tests.torch_parity import numpy_host_core, same, twin  # noqa: F401

pytestmark = pytest.mark.usefixtures("numpy_host_core")

LAT, LON = np.deg2rad(49.08), np.deg2rad(8.31)
NOON = 50400.0 - 4.32e4 * LON / np.pi    # local 14:00 at the pierce point


# --- tests/test_cacode.py ---------------------------------------------------


@pytest.mark.parametrize("prn", sorted(FIRST10_OCTAL))
def test_first_chips_octal(prn):
    def chips(cacode):
        assert cacode.first_chips_octal(prn) == FIRST10_OCTAL[prn]
        return cacode.first_chips_octal(prn), cacode.ca_chips(prn)
    twin(chips, "ops.cacode")


def test_chip_values_and_length():
    def chips(cacode):
        out = [cacode.ca_chips(prn) for prn in (1, 17, 32)]
        for c in out:
            assert c.shape == (1023,)
            assert set(np.unique(c)) <= {-1, 1}
            assert np.sum(c == 1) == 512
        return out
    twin(chips, "ops.cacode")


def test_gold_code_correlation_properties():
    def corr(cacode):
        a = cacode.ca_chips(5).astype(np.int64)
        b = cacode.ca_chips(9).astype(np.int64)
        fa, fb = np.fft.fft(a), np.fft.fft(b)
        auto = np.round(np.fft.ifft(fa * np.conj(fa)).real).astype(int)
        cross = np.round(np.fft.ifft(fa * np.conj(fb)).real).astype(int)
        assert auto[0] == 1023
        assert set(auto[1:]) <= {-65, -1, 63}
        assert set(cross) <= {-65, -1, 63}
        return auto, cross
    twin(corr, "ops.cacode")


def test_resample_semantics():
    def resample(cacode):
        chips = cacode.ca_chips(1)
        code = cacode.resample_code(chips, 2048)
        assert code.shape == (2048,)
        assert code[0] == chips[0] and code[-1] == chips[-1]
        assert np.max(np.abs(code)) <= 1.0
        assert np.mean(np.abs(np.abs(code) - 1.0) < 1e-6) > 0.7
        return code
    twin(resample, "ops.cacode")


def test_tables():
    def tables(cacode, config):
        codes = cacode.ca_table(config.DEFAULT)
        ffts = cacode.ca_fft_table(config.DEFAULT)
        assert codes.shape == ffts.shape == (38, 2048)
        assert codes.dtype == np.float32 and ffts.dtype == np.complex64
        assert np.all(codes[0] == 0)
        np.testing.assert_allclose(np.fft.fft(codes[7]), ffts[7],
                                   rtol=1e-4, atol=1e-2)
        return codes, ffts
    twin(tables, "ops.cacode", "config")


# --- tests/test_geodesy.py --------------------------------------------------


def test_geo_ecef_roundtrip():
    def roundtrip(geodesy):
        out = []
        for lat, lon, alt in [(49.082961, 8.307581, 150.0), (0.0, 0.0, 0.0),
                              (-45.3, 170.1, 2000.0), (89.0, -120.0, 10.0)]:
            x, y, z = geodesy.geo_to_ecef(lat, lon, alt)
            lat2, lon2, alt2 = geodesy.ecef_to_geo((x, y, z))
            assert abs(lat2 - lat) < 1e-9 and abs(lon2 - lon) < 1e-9
            assert abs(alt2 - alt) < 1e-4
            out.append((x, y, z, lat2, lon2, alt2))
        return out
    twin(roundtrip, "utils.geodesy")


def test_ecef_known_point():
    def known(geodesy):
        x, y, z = geodesy.geo_to_ecef(0.0, 0.0, 0.0)
        assert abs(x - geodesy.WGS84_A) < 1e-6 and abs(y) < 1e-6 \
            and abs(z) < 1e-6
        xp, yp, zp = geodesy.geo_to_ecef(90.0, 0.0, 0.0)
        assert abs(zp - geodesy.WGS84_B) < 1e-6 and abs(xp) < 1e-3
        return (x, y, z, xp, yp, zp, geodesy.WGS84_A, geodesy.WGS84_B)
    twin(known, "utils.geodesy")


def test_azim_elev():
    def azel(geodesy):
        obs = np.array(geodesy.geo_to_ecef(45.0, 10.0, 0.0))
        sat_up = obs * (1 + 2e7 / np.linalg.norm(obs))
        up = geodesy.ecef_to_azim_elev(obs, sat_up)
        assert abs(up[0] - 90.0) < 0.2
        sat_n = np.array(geodesy.geo_to_ecef(60.0, 10.0, 2.0e7))
        north = geodesy.ecef_to_azim_elev(obs, sat_n)
        assert abs(north[1]) < 1.0
        return up, north
    twin(azel, "utils.geodesy")


def test_local_offsets():
    def offsets(geodesy):
        home = (49.0, 8.3, 100.0)
        east, north = geodesy.local_offsets_m(home, (49.001, 8.3, 100.0))
        assert abs(east) < 1e-6 and 110.0 < north < 112.5
        east2, north2 = geodesy.local_offsets_m(home, (49.0, 8.301, 100.0))
        assert abs(north2) < 1e-6 and 72.0 < east2 < 74.5
        return east, north, east2, north2
    twin(offsets, "utils.geodesy")


def test_gps_datetime():
    def epoch(gpstime):
        d = gpstime.gps_datetime(1, -2048)
        assert (d.year, d.month, d.day) == (1980, 1, 5)
        s = gpstime.gps_time_str(1, -2048)
        assert "UTC" in s
        return d, s
    twin(epoch, "utils.gpstime")


# --- tests/test_orbits.py ---------------------------------------------------


def test_kepler_solver():
    def kepler(orbits):
        out = []
        for e in (0.0, 0.005, 0.03):
            m = np.linspace(-np.pi, np.pi, 17)
            big_e = orbits.kepler_E(m, e)
            np.testing.assert_allclose(big_e - e * np.sin(big_e), m,
                                       atol=1e-13)
            out.append(big_e)
        return out
    twin(kepler, "models.orbits")


def test_cross_time_wraps_half_week():
    def cross(orbits, config):
        half = config.WEEK_IN_SEC / 2
        out = (orbits.cross_time(half + 10), orbits.cross_time(-half - 10),
               orbits.cross_time(1234.5))
        assert out == pytest.approx((-half + 10, half - 10, 1234.5))
        return out
    twin(cross, "models.orbits", "config")


def test_orbit_radius_and_speed():
    def orbit(orbits):
        x, y, z, dtsv = orbits.ecef_coord(TOW, EPH)
        a = EPH["sqrtA"] ** 2
        assert abs(np.sqrt(x * x + y * y + z * z) - a) < a * EPH["e"] + 300
        v = orbits.sat_velocity(TOW, EPH)
        assert 2500.0 < np.linalg.norm(v) < 4500.0
        return (x, y, z, dtsv), v
    twin(orbit, "models.orbits")


def test_relativistic_correction_magnitude_and_phase():
    def rel(orbits, config):
        bound = 4.442807633e-10 * EPH["e"] * EPH["sqrtA"]
        vals = []
        for k in range(0, 7200, 600):
            on = orbits.ecef_coord(TOW, EPH, dt_from_tow=k * 6)
            off = orbits.ecef_coord(TOW, EPH, dt_from_tow=k * 6,
                                    rel_corr=False)
            vals.append((on, off))
        d = np.asarray([on[3] - off[3] for on, off in vals])
        assert np.all(np.abs(d) <= bound * 1.01)
        assert d.max() > 0.3 * bound and d.min() < -0.3 * bound
        assert bound * config.GPS_C > 5.0
        return vals
    twin(rel, "models.orbits", "config")


def test_sv_clock_polynomial():
    def clock(orbits):
        dtsv = orbits.sv_clock_correction(EPH["Toc"] + 100.0, EPH)
        assert dtsv == pytest.approx(
            EPH["af0"] + EPH["af1"] * 100.0 - EPH["Tgd"], abs=1e-15)
        return dtsv
    twin(clock, "models.orbits")


def test_earth_rotation_during_orbit():
    def rotation(orbits):
        p0 = orbits.ecef_coord(TOW, EPH)
        period = 2 * np.pi / (np.sqrt(orbits.MU_EARTH) / EPH["sqrtA"] ** 3)
        p1 = orbits.ecef_coord(TOW, EPH, dt_from_tow=period)
        assert np.linalg.norm(np.subtract(p1[:3], p0[:3])) > 1_000_000.0
        return p0, p1
    twin(rotation, "models.orbits")


def test_gps_abs_time_rollover():
    def abs_time(orbits, config):
        t = orbits.gps_abs_time(TOW, EPH)
        weeks = EPH["weekNum"] + 2 * 1024
        assert abs(t - (weeks * config.WEEK_IN_SEC + 66600.0)) < 1.0
        return t
    twin(abs_time, "models.orbits", "config")


# --- tests/test_navmsg.py ---------------------------------------------------


@pytest.mark.parametrize("sf_id,fields", [(1, SF1), (2, SF2), (3, SF3),
                                          (4, {}), (5, {})])
def test_subframe_roundtrip(sf_id, fields):
    def roundtrip(navmsg):
        tx = navmsg.encode_subframe(sf_id, fields, 44400)
        assert tx.shape == (300,)
        dec = navmsg.decode_subframe(tx)
        assert dec["ID"] == sf_id and dec["tow"] == 44400
        for name, v in fields.items():
            if isinstance(v, int):
                assert dec[name] == v, name
            else:
                scale = navmsg.field_scale(sf_id, name)
                assert dec[name] == pytest.approx(round(v / scale) * scale,
                                                  rel=1e-12), name
        return tx, dec
    twin(roundtrip, "models.navmsg")


def test_inverted_subframe_decodes():
    def inverted(navmsg):
        dec = navmsg.decode_subframe(1 - navmsg.encode_subframe(2, SF2,
                                                                 tow=101))
        assert dec is not None and dec["ID"] == 2 and dec["tow"] == 101
        return dec
    twin(inverted, "models.navmsg")


@pytest.mark.parametrize("sf_id,fields,bit", [(3, SF3, 75), (1, SF1, 0)],
                         ids=["parity", "preamble"])
def test_corrupted_bit_rejected(sf_id, fields, bit):
    """test_navmsg.py's parity-error and preamble-error cases."""
    def corrupted(navmsg):
        bad = navmsg.encode_subframe(sf_id, fields, tow=7).copy()
        bad[bit] ^= 1
        assert navmsg.decode_subframe(bad) is None
        return bad
    twin(corrupted, "models.navmsg")


def test_forced_zero_tail_words():
    def tail(navmsg):
        tx = navmsg.encode_subframe(1, SF1, tow=12345).reshape(10, 30)
        assert tx[1, 28] == tx[1, 29] == tx[9, 28] == tx[9, 29] == 0
        np.testing.assert_array_equal(tx[0, :8], navmsg.PREAMBLE)
        return tx
    twin(tail, "models.navmsg")


def test_navdecoder_bit_framing():
    def framing(navmsg):
        nd = navmsg.NavDecoder(ngps=65536)
        nd.last_sign = 1
        nd.edges = [(0, 1000), (40, 2000), (58, 3000), (80, 4000),
                    (100, 5000)]
        bits, sts = nd._frame_bits()
        np.testing.assert_array_equal(bits, [1, 1, -1, 1, -1])
        np.testing.assert_array_equal(sts, [1000, 0, 2000, 3000, 4000])
        assert nd.edges == [(100, 5000)] and nd.last_sign == 1
        return bits, sts
    twin(framing, "models.navmsg")


def test_navdecoder_full_chain():
    def chain(navmsg):
        stream = np.concatenate([navmsg.encode_subframe(4, {}, 1200),
                                 navmsg.encode_subframe(1, SF1, 1201)])
        pm = (2 * stream - 1).astype(np.int8)
        nd = navmsg.NavDecoder(ngps=65536)
        nd.last_sign = int(pm[0])
        edges = [(500, 500 * 2048)]
        for i in range(1, len(pm)):
            if pm[i] != pm[i - 1]:
                edges.append((500 + 20 * i, (500 + 20 * i) * 2048))
        t_end = 500 + 20 * len(pm)
        nd.edges = edges + [(t_end, t_end * 2048)]
        subs = nd.poll_subframes()
        assert [(s["ID"], s["tow"]) for s in subs] == [(4, 1200), (1, 1201)]
        assert subs[0]["ST"] == 500 * 2048
        assert subs[1]["ST"] == (500 + 20 * 300) * 2048
        return subs
    twin(chain, "models.navmsg")


def test_frame_bits_matches_sequential():
    """test_navmsg.py's 30 random edge streams: both decoders equal the
    per-edge walk and each other."""
    rng = np.random.default_rng(7)
    for _ in range(30):
        n_edges = int(rng.integers(2, 60))
        t = 100 + np.cumsum(rng.integers(1, 85, size=n_edges))
        edges = [(int(tt), int(tt) * 2048 + int(rng.integers(0, 2048)))
                 for tt in t]
        sign0 = int(rng.choice([-1, 1]))
        obits, osts, sign = [], [], sign0
        t1, st1 = edges[0]
        for t2, st2 in edges[1:]:
            m, r = divmod(t2 - t1, 20)
            m += r > 17
            if m > 0:
                obits += [sign] * m
                osts += [st1] + [0] * (m - 1)
            t1, st1, sign = t2, st2, -sign

        def frame(navmsg):
            nd = navmsg.NavDecoder(ngps=65536)
            nd.edges, nd.last_sign = list(edges), sign0
            bits, sts = nd._frame_bits()
            assert bits.tolist() == obits and sts.tolist() == osts
            assert nd.last_sign == sign and nd.edges == [edges[-1]]
            return bits, sts
        twin(frame, "models.navmsg")


# --- tests/test_atmosphere.py (models) --------------------------------------


def test_klobuchar_properties():
    def klobuchar(atmosphere, scenario):
        a, b = scenario.DEFAULT_IONO_ALPHA, scenario.DEFAULT_IONO_BETA
        el, az = np.deg2rad(40.0), np.deg2rad(180.0)
        night = atmosphere.klobuchar_delay(a, b, LAT, LON, el, az, 3600.0)
        f = 1.0 + 16.0 * (0.53 - 40.0 / 180.0) ** 3
        assert night == pytest.approx(5e-9 * f, rel=1e-12)
        day = atmosphere.klobuchar_delay(a, b, LAT, LON, el, az, NOON)
        assert 5e-9 < day < 50e-9 and day > 2 * night
        els = np.deg2rad(np.array([10.0, 30.0, 60.0, 90.0]))
        d = atmosphere.klobuchar_delay(a, b, LAT, LON, els, az, NOON)
        assert np.all(np.diff(d) < 0) and d.shape == (4,)
        return night, day, d
    twin(klobuchar, "models.atmosphere", "models.scenario")


def test_tropo_properties():
    def tropo(atmosphere, config):
        z = atmosphere.tropo_delay(np.deg2rad(90.0)) * config.GPS_C
        assert 2.2 < z < 2.7
        d = atmosphere.tropo_delay(
            np.deg2rad(np.array([5.0, 10.0, 30.0, 90.0])), 150.0) \
            * config.GPS_C
        assert np.all(np.diff(d) < 0) and d[0] > 5 * d[-1] * 0.8
        hi = atmosphere.tropo_delay(np.deg2rad(45.0), 2000.0)
        lo = atmosphere.tropo_delay(np.deg2rad(45.0), 0.0)
        assert hi < lo
        return z, d, hi, lo
    twin(tropo, "models.atmosphere", "config")


def _scenario(config, scenario, **kw):
    return scenario.make_scenario(config.ReceiverConfig(), **kw)


def _scenario_facts(scn) -> dict:
    """What two packages' scenarios of one seed must share."""
    return {"rec_ecef": scn.rec_ecef, "rec_geo": scn.rec_geo,
            "tow0": scn.tow0, "week": scn.week, "t_rx0": scn.t_rx0,
            "sats": [(s.prn, s.eph, s.nav_stream) for s in scn.sats]}


def test_scenario_injection_matches_evaluator_correction():
    def injection(config, scenario, orbits, atmosphere):
        scn = _scenario(config, scenario, n_sats=5, duration_sec=18.0,
                        seed=2, iono=True, tropo=True)
        t = scn.t_rx0 + np.array([0.0, 5.0, 10.0])
        out = []
        for sat in scn.sats:
            tau_on, _ = scn.sat_states(t, sat)
            scn.iono_alpha, alpha = None, scn.iono_alpha
            scn.model_tropo = False
            tau_off, _ = scn.sat_states(t, sat)
            scn.iono_alpha, scn.model_tropo = alpha, True
            x, y, z, _ = orbits.ecef_coord(
                scn.tow0, sat.eph,
                dt_from_tow=t - orbits.tsv_of_tow(scn.tow0))
            el, az = atmosphere.azim_elev_batch(scn.rec_ecef,
                                                np.stack([x, y, z], axis=1))
            expect = (atmosphere.klobuchar_delay(
                scn.iono_alpha, scn.iono_beta, LAT, LON, el, az,
                np.mod(t, 86400.0)) + atmosphere.tropo_delay(el,
                                                             scn.rec_geo[2]))
            injected = tau_on - tau_off
            assert np.all(np.abs(injected - expect)
                          < 0.02e-9 + 0.01 * expect)
            out.append((injected, expect))
        return _scenario_facts(scn), out
    twin(injection, "config", "models.scenario", "models.orbits",
         "models.atmosphere")


def _frames_of(navmsg, scn, sat, tow):
    off = (tow - scn.tow0) * 300
    bits01 = ((sat.nav_stream[off:off + 300] + 1) // 2).astype(np.int8)
    return navmsg.decode_subframe(bits01)


def test_page18_broadcast_decodes():
    def page18(config, scenario, navmsg):
        scn = _scenario(config, scenario, n_sats=4, duration_sec=40.0,
                        seed=5, iono=True)
        tow = next(t for t in range(scn.tow0, scn.tow0 + 5)
                   if (t - 1) % 5 + 1 == 4)
        sf = _frames_of(navmsg, scn, scn.sats[0], tow)
        assert sf["ID"] == 4 and sf["svID"] == navmsg.IONO_PAGE_SVID
        for i in range(4):
            assert sf[f"alpha{i}"] == pytest.approx(scn.iono_alpha[i],
                                                    abs=1e-20)
            assert sf[f"beta{i}"] == pytest.approx(scn.iono_beta[i],
                                                   abs=1e-9)
        assert sf["dtLS"] == 18
        return sf, scn.iono_alpha, scn.iono_beta
    twin(page18, "config", "models.scenario", "models.navmsg")


def test_almanac_broadcast_and_visibility_prediction():
    def broadcast(config, scenario, navmsg, almanac):
        scn = _scenario(config, scenario, n_sats=6, duration_sec=60.0,
                        seed=7, broadcast_almanac=True)
        alms = {}
        for tow in range(scn.tow0, scn.tow0 + 10):
            if (tow - 1) % 5 + 1 != 5:
                continue
            sf = _frames_of(navmsg, scn, scn.sats[0], tow)
            assert sf is not None and sf["ID"] == 5
            if 1 <= sf.get("svID", 0) <= 32:
                alms[sf["svID"]] = sf
        assert len(alms) >= 2
        for s in scn.sats:
            alms.setdefault(s.prn, {**almanac.almanac_from_ephem(s.eph),
                                    "svID": s.prn})
        vis = almanac.predict_visible(alms, scn.rec_ecef, scn.tow0)
        got = {prn: (el, dop) for prn, el, dop in vis}
        for s in scn.sats:
            el_deg, dop = got[s.prn]
            tau, _ = scn.sat_states(scn.t_rx0 + np.array([-0.5, 0.5]), s)
            assert abs(dop + config.L1_FREQ * (tau[1] - tau[0])) < 150.0
            assert el_deg > 5.0
        return alms, vis
    twin(broadcast, "config", "models.scenario", "models.navmsg",
         "models.almanac")


def test_almanac_cache_roundtrip(tmp_path):
    def cache(config, scenario, almanac, io):
        scn = _scenario(config, scenario, n_sats=3, duration_sec=12.0,
                        seed=4)
        alms = {s.prn: almanac.almanac_from_ephem(s.eph) for s in scn.sats}
        iono = {"alpha": scenario.DEFAULT_IONO_ALPHA,
                "beta": scenario.DEFAULT_IONO_BETA}
        p = str(tmp_path / f"almanac_{config.__name__}.json")
        io.save_almanac(p, alms, iono_params=iono)
        back, iono_back = io.load_almanac(p)
        assert set(back) == set(alms) and iono_back == iono
        vis = almanac.predict_visible(back, scn.rec_ecef, scn.tow0)
        assert {v[0] for v in vis} >= set(alms)
        assert io.load_almanac(p, max_age_sec=-1) == ({}, None)
        return back, iono_back, vis
    twin(cache, "config", "models.scenario", "models.almanac", "utils.io")


def test_almanac_orbit_accuracy():
    def accuracy(config, scenario, navmsg, almanac, orbits):
        scn = _scenario(config, scenario, n_sats=3, duration_sec=12.0,
                        seed=11)
        out = []
        for s in scn.sats:
            alm = almanac.almanac_from_ephem(s.eph)
            tx = navmsg.encode_subframe(5, {**alm, "dataID": 1,
                                            "svID": s.prn},
                                        tow=scn.tow0 + 4)
            eph_c = almanac.ephem_from_almanac(navmsg.decode_subframe(tx),
                                               week_num=scn.week)
            p = orbits.ecef_coord(scn.tow0, s.eph, dt_from_tow=10.0)
            pc = orbits.ecef_coord(scn.tow0, eph_c, dt_from_tow=10.0)
            assert np.linalg.norm(np.subtract(p[:3], pc[:3])) < 5000.0
            out.append((alm, eph_c, p, pc))
        return out
    twin(accuracy, "config", "models.scenario", "models.navmsg",
         "models.almanac", "models.orbits")


# --- tests/test_aux_units.py (models and utilities) -------------------------


def test_gps_week_tow_inverts_gps_datetime():
    def invert(gpstime):
        out = []
        for week, tow in ((312, 11100), (0, 1), (1023, 100800), (500, 7)):
            dt = gpstime.gps_datetime(tow, week)
            assert gpstime.gps_week_tow(dt) == (week, tow)
            out.append(dt)
        aware = gpstime.gps_datetime(11100, 312).replace(
            tzinfo=datetime.timezone.utc)
        assert gpstime.gps_week_tow(aware) == (312, 11100)
        return out
    twin(invert, "utils.gpstime")


def test_enu_to_ecef_vec_is_orthonormal_rotation():
    def enu(geodesy):
        e, n, u = (geodesy.enu_to_ecef_vec(49.08, 8.31, v) for v in
                   ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)))
        for v in (e, n, u):
            assert np.linalg.norm(v) == pytest.approx(1.0)
        assert max(abs(e @ n), abs(e @ u), abs(n @ u)) < 1e-12
        p0 = np.array(geodesy.geo_to_ecef(49.08, 8.31, 0.0))
        p1 = np.array(geodesy.geo_to_ecef(49.08, 8.31, 100.0))
        assert np.allclose((p1 - p0) / 100.0, u, atol=1e-9)
        return e, n, u
    twin(enu, "utils.geodesy")


def test_unhealthy_sv_excluded_from_prediction():
    def unhealthy(config, scenario, almanac):
        scn = _scenario(config, scenario, n_sats=4, duration_sec=12.0,
                        seed=8)
        alms = {s.prn: almanac.almanac_from_ephem(s.eph) for s in scn.sats}
        alms[scn.sats[0].prn]["almHealth"] = 63
        vis = almanac.predict_visible(alms, scn.rec_ecef, scn.tow0)
        assert scn.sats[0].prn not in {v[0] for v in vis}
        assert len(vis) == 3
        return vis
    twin(unhealthy, "config", "models.scenario", "models.almanac")


def test_acquisition_hints_refuses_thin_prediction():
    def thin(config, scenario, almanac):
        scn = _scenario(config, scenario, n_sats=3, duration_sec=12.0,
                        seed=8)
        alms = {s.prn: almanac.almanac_from_ephem(s.eph) for s in scn.sats}
        hints = almanac.acquisition_hints(alms, scn.rec_ecef, scn.tow0)
        assert hints == (None, None)
        return _scenario_facts(scn), hints
    twin(thin, "config", "models.scenario", "models.almanac")


def test_atmosphere_clamps():
    def clamps(atmosphere, scenario):
        a, b = scenario.DEFAULT_IONO_ALPHA, scenario.DEFAULT_IONO_BETA
        low = atmosphere.klobuchar_delay(a, b, np.deg2rad(80.0), 0.0,
                                         np.deg2rad(1.0), 0.0, 50400.0)
        assert np.isfinite(low) and 0 < low < 1e-6
        neg = atmosphere.klobuchar_delay((-1e-7, 0.0, 0.0, 0.0), b, 0.0,
                                         0.0, np.deg2rad(45.0), 0.0,
                                         50400.0)
        assert neg == pytest.approx(5e-9 * (1.0 + 16.0 * 0.28 ** 3))
        floor = (atmosphere.tropo_delay(np.deg2rad(-5.0)),
                 atmosphere.tropo_delay(np.deg2rad(3.0)))
        assert floor[0] == floor[1]
        high = atmosphere.tropo_delay(np.deg2rad(45.0), 99999.0)
        assert np.isfinite(high)
        return low, neg, floor, high
    twin(clamps, "models.atmosphere", "models.scenario")


# --- tests/test_scenario_synth.py -------------------------------------------


@pytest.fixture(scope="module")
def scenarios():
    """The JAX test's scenario (2 satellites, seed 3) in both packages."""
    from tests.torch_parity import pair
    out = []
    for config, scenario in zip(pair("config"), pair("models.scenario")):
        out.append((scenario, _scenario(config, scenario, n_sats=2,
                                        duration_sec=12.0, seed=3)))
    same(_scenario_facts(out[1][1]), _scenario_facts(out[0][1]))
    return out


def _blocks_both(scenarios, *args, **kw):
    """synth_scenario_blocks of both packages on the same arguments; the
    port's equal to the JAX package's bit for bit."""
    want, got = (mod.synth_scenario_blocks(scn, *args, **kw)
                 for mod, scn in scenarios)
    np.testing.assert_array_equal(got, want)
    return got


def test_chunked_equals_single_shot(scenarios):
    whole = _blocks_both(scenarios, 0, 4, noise_std=0.0)
    parts = np.concatenate([_blocks_both(scenarios, 0, 1, noise_std=0.0),
                            _blocks_both(scenarios, 1, 2, noise_std=0.0),
                            _blocks_both(scenarios, 3, 1, noise_std=0.0)])
    np.testing.assert_allclose(parts, whole, atol=2e-4)


def test_noise_chunk_invariant(scenarios):
    whole = _blocks_both(scenarios, 0, 2, noise_std=0.5, seed=9)
    parts = np.concatenate([
        _blocks_both(scenarios, 0, 1, noise_std=0.5, seed=9),
        _blocks_both(scenarios, 1, 1, noise_std=0.5, seed=9)])
    np.testing.assert_allclose(parts, whole, atol=2e-4)


def test_carrier_continuity_across_chunk_boundary(scenarios):
    ngps = scenarios[1][1].cfg.ngps
    a = _blocks_both(scenarios, 0, 1, noise_std=0.0)[0]
    b = _blocks_both(scenarios, 1, 1, noise_std=0.0)[0]
    whole = _blocks_both(scenarios, 0, 2, noise_std=0.0).reshape(-1)
    np.testing.assert_allclose(np.concatenate([a[-4:], b[:4]]),
                               whole[ngps - 4:ngps + 4], atol=2e-4)
