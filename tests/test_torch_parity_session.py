"""Twins of the JAX package's session and CLI control tests on the port:
tests/test_session_controls.py (UI events STOP, CLEAR, HEIGHT, CLOSE,
SET_HEIGHT, the plot UI's buttons, the ephemeris cache's 2 h age gate),
test_cli_ui.py's ephemeris-cache round trip and --solve-clock-rate flag,
and test_atmosphere.py's almanac warm start (Receiver.warm_start, the
Session's almanac cache and cli._arm_warm_start).

The same blocks and the same UI events go to the JAX Session and the
port's Session on the CPU (runtime/session.py, the plain path): each
event must have the same effect on both, at the same epoch.  What the
two receivers track is held by the JAX test's bars and, for the
acquisition, as tests/torch_envelope.py's check_acquisition holds it
(PRN, frequency and delay exact, norm_max rtol 1e-4).  Host state
(caches, configs, UI events, almanacs) is held exactly, on the numpy
host paths of both packages."""

import json
import time

import matplotlib
import numpy as np
import pytest
import torch

from chip_smoke import ScriptedUI
from tests.conftest import cached_synth
from tests.test_cli_ui import epoch_records  # fixture  # noqa: F401
from tests.torch_parity import (numpy_host_core, pair, same,  # noqa: F401
                                same_config)

matplotlib.use("Agg")
torch.set_num_threads(2)
pytestmark = pytest.mark.usefixtures("numpy_host_core")


@pytest.fixture(scope="module")
def blocks():
    """tests/test_session_controls.py's capture: PRN 9, 3 s and a block,
    the default config (cached under the JAX test's key)."""
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                    synth_stream)
    cfg = ReceiverConfig()
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    return cached_synth("recovery_skip_v1", lambda: synth_stream(
        cfg, [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))


def _sessions(blocks, event, at, prepare=None):
    """The JAX Session and the port's (device cpu) over `blocks`, each
    with its own reporter emitting `event` after epoch `at` (chip_smoke's
    ScriptedUI, which phase 15d drives on the card); prepare(session)
    runs first."""
    out = []
    for config, session in zip(pair("config"), pair("runtime.session")):
        kw = {} if session.__name__.startswith("gps_sdr_tpu.") \
            else {"device": "cpu"}
        s = session.Session(config.ReceiverConfig(),
                            reporter=ScriptedUI({at: [event]}), **kw)
        if prepare is not None:
            prepare(s)
        s.run_source(iter(blocks))
        out.append(s)
    js, ts = out
    # the same number of epochs and blocks on both sides
    assert ts.reporter.n == js.reporter.n
    assert ts.receiver.status.blocks_processed == \
        js.receiver.status.blocks_processed
    assert ts.receiver._stop == js.receiver._stop
    assert [f[1:] for f in ts.receiver.found_sats] == \
        [f[1:] for f in js.receiver.found_sats]
    return js, ts


@pytest.mark.parametrize("event", ["STOP", "CLOSE"])
def test_ui_stop_and_close_end_the_run_at_the_same_epoch(blocks, event):
    """STOP after the second epoch ends both runs there (3 chunks
    available); CLOSE after the first also closes both reporters."""
    at = 2 if event == "STOP" else 1
    js, ts = _sessions(blocks, event, at)
    for s in (js, ts):
        assert s.reporter.n == at and s.receiver._stop
        assert s.reporter.closed is (event == "CLOSE")


def test_ui_height_toggle(blocks):
    js, ts = _sessions(blocks, "HEIGHT", 1)
    assert js.evaluator.cfg.conf_height and ts.evaluator.cfg.conf_height
    same_config(ts.evaluator.cfg, js.evaluator.cfg)


def test_ui_clear_event(blocks):
    def seed_stats(s):
        s.evaluator.positions = [[0, 1, 2, 3]]
        s.evaluator.stat = (np.zeros(3), np.zeros(3), 1, 0)
    js, ts = _sessions(blocks, "CLEAR", 1, seed_stats)
    for s in (js, ts):
        assert s.evaluator.positions == [] and s.evaluator.stat is None
        assert len(s.evaluator.all_pos) == 0 and s.evaluator.outliers == []
        assert s.reporter.n >= 3        # the run went on to the end


def test_ui_set_height_event(blocks):
    js, ts = _sessions(blocks, ("SET_HEIGHT", 123.0), 1)
    assert js.evaluator.cfg.height == ts.evaluator.cfg.height == 123.0
    same_config(ts.evaluator.cfg, js.evaluator.cfg)


def test_plotui_buttons_emit_reference_events():
    """Every control of both packages' PlotUI emits the same event in the
    same order; zoom sets the same track axes; "+" drives the zoom."""
    out = []
    for plot in pair("ui.plot"):
        ui = plot.PlotUI(interactive=False)
        try:
            for press in (ui._on_bt_sweep, ui._on_bt_clear, ui._on_bt_stop,
                          ui._on_bt_map, ui._on_bt_close,
                          ui._on_conf_height):
                press()
            ui._on_tb_height("250")
            events = ui.get_events()
            assert events == ["SWEEP", "CLEAR", "STOP", "MAP", "CLOSE",
                              "HEIGHT", ("SET_HEIGHT", 250.0)]
            ui._on_tb_height("abc")
            bad = ui.get_events()
            assert bad == [("SET_HEIGHT", 0.0)]
            ui._track_en = [(0.0, 0.0), (100.0, 50.0)]
            ui._on_zoom_plus()
            lim = [ui.ax_track.get_xlim(), ui.ax_track.get_ylim()]
            x0 = np.diff(lim[0])[0]
            ui._on_zoom_minus()
            ui._on_zoom_minus()
            lim += [ui.ax_track.get_xlim(), ui.ax_track.get_ylim()]
            assert np.isclose(np.diff(lim[2])[0], 4 * x0)

            class Key:
                key = "+"
            ui._on_key(Key())
            assert ui._zoom_span is not None
            out.append((events, bad, lim, ui._zoom_span))
        finally:
            ui.close()
    same(out[1], out[0])


@pytest.mark.parametrize("age_h", [0.0, 1.0, 1.98, 2.02, 3.0])
def test_ephemeris_cache_age_gating(tmp_path, age_h):
    """A cache written by either package and backdated by age_h hours is
    accepted (< 2 h) or refused by both packages alike, whoever reads
    it."""
    ephs = {7: {"IODC": 5, "sqrtA": 5153.6}, 12: {"IODC": 9, "e": 0.01}}
    loads = []
    for writer in pair("utils.io"):
        path = tmp_path / f"eph_{writer.__name__}.json"
        writer.save_ephemerides(str(path), ephs)
        doc = json.loads(path.read_text())
        doc["POSIX-Time"] = int(time.time() - age_h * 3600)
        path.write_text(json.dumps(doc))
        loads.append([reader.load_ephemerides(str(path))
                      for reader in pair("utils.io")])
    for got in sum(loads, []):
        assert got == (ephs if age_h < 2.0 else {})


def test_cli_ephem_cache_roundtrip(tmp_path, epoch_records):  # noqa: F811
    """`epochs --ephem-cache` on the fixture's 36 s: both CLIs write the
    scenario's ephemerides, equal key for key."""
    scn, records = epoch_records
    caches = []
    for cli, io in zip(pair("cli"), pair("utils.io")):
        tag = cli.__name__.split(".")[0]
        rec_path, cache = tmp_path / f"{tag}.pickle", tmp_path / f"{tag}.json"
        io.save_epoch_records(str(rec_path), records)
        assert cli.main(["epochs", str(rec_path), "--ui", "none",
                         "--ephem-cache", str(cache)]) == 0
        loaded = io.load_ephemerides(str(cache))
        assert set(loaded) == {s.prn for s in scn.sats}
        for s in scn.sats:
            assert np.isclose(loaded[s.prn]["sqrtA"], s.eph["sqrtA"])
        doc = json.loads(cache.read_text())
        assert set(doc) == set(map(str, loaded)) | {"UTC-Time",
                                                    "POSIX-Time"}
        caches.append(loaded)
    same(caches[1], caches[0])


@pytest.mark.parametrize("argv", [["synth", "--solve-clock-rate"],
                                  ["synth"]])
def test_cli_solve_clock_rate_flag(argv):
    """The flag reaches ReceiverConfig, and through it the Evaluator, the
    same way in both CLIs; the whole config is equal."""
    cfgs = []
    for cli, evaluator in zip(pair("cli"), pair("runtime.evaluator")):
        cfg = cli.make_config(cli.build_parser().parse_args(argv))
        assert cfg.solve_clock_rate is ("--solve-clock-rate" in argv)
        ev = evaluator.Evaluator(cfg)
        assert ev.cfg.solve_clock_rate is cfg.solve_clock_rate
        cfgs.append(cfg)
    same_config(cfgs[1], cfgs[0])


def test_session_warm_start_plumbing(tmp_path):
    """The almanac cache preloads both Sessions' evaluators (iono
    coefficients included) and both CLIs' --warm-start arm the same
    sweep hints."""
    from gps_sdr_tpu.models.scenario import make_scenario
    from gps_sdr_tpu.config import ReceiverConfig
    scn = make_scenario(ReceiverConfig(), n_sats=5, duration_sec=12.0,
                        seed=9, iono=True)
    lat, lon, alt = scn.rec_geo
    out = []
    for almanac, io, session, cli in zip(
            pair("models.almanac"), pair("utils.io"),
            pair("runtime.session"), pair("cli")):
        alms = {s.prn: almanac.almanac_from_ephem(s.eph) for s in scn.sats}
        p = str(tmp_path / f"alm_{cli.__name__}.json")
        io.save_almanac(p, alms, iono_params={"alpha": scn.iono_alpha,
                                              "beta": scn.iono_beta})
        kw = {} if cli.__name__.startswith("gps_sdr_tpu.") \
            else {"device": "cpu"}
        config = pair("config")[len(out)]
        s = session.Session(config.ReceiverConfig(), almanac_cache_path=p,
                            **kw)
        assert set(s.evaluator.almanacs) == set(alms)
        assert s.evaluator.iono_params["alpha"] == scn.iono_alpha
        cli._arm_warm_start(f"{lat},{lon},{alt},{scn.tow0}", s)
        prns, bins = s.receiver.warm_hints
        assert set(prns) == {sat.prn for sat in scn.sats}
        out.append((s.evaluator.almanacs, s.evaluator.iono_params,
                    (list(prns), np.asarray(bins))))
    same(out[1], out[0])


def test_almanac_warm_start_acquisition():
    """Receiver.warm_start on the JAX test's block (6 satellites, seed
    13): both receivers narrow the sweep to the same PRNs and bins and
    acquire every satellite, the same satellites; hints naming PRNs not
    on the air fall back to the full grid in both."""
    from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
    from gps_sdr_tpu.models.scenario import (make_scenario,
                                             synth_scenario_blocks)
    cfgs = [m.ReceiverConfig() for m in pair("config")]
    scn = make_scenario(JaxConfig(), n_sats=6, duration_sec=8.0, seed=13)
    block = cached_synth("warmstart_block_v1", lambda: synth_scenario_blocks(
        scn, 0, 1, noise_std=0.5))[0]
    truth = {s.prn for s in scn.sats}
    full = len(list(cfgs[0].prns)) * len(cfgs[0].doppler_bins)
    recs, hints = [], []
    for cfg, almanac, receiver in zip(cfgs, pair("models.almanac"),
                                      pair("runtime.receiver")):
        kw = {} if receiver.__name__.startswith("gps_sdr_tpu.") \
            else {"device": "cpu"}
        alms = {s.prn: almanac.almanac_from_ephem(s.eph) for s in scn.sats}
        rec = receiver.Receiver(cfg, **kw)
        assert rec.warm_start(alms, scn.rec_ecef, scn.tow0)
        prns, bins = rec.warm_hints
        hints.append((list(prns), np.asarray(bins)))
        assert set(prns) == truth and len(prns) * len(bins) < 0.5 * full
        rec._serve_sweep_all(block)
        assert truth <= set(rec.slots.active) and rec.warm_hints is None
        wrong = [p for p in range(2, 33) if p not in truth][:6]
        rec2 = receiver.Receiver(cfg, **kw)
        rec2.warm_hints = (wrong, bins)
        rec2._serve_sweep_all(block)
        assert truth <= set(rec2.slots.active)
        recs.append((rec, rec2))
    same(hints[1], hints[0])
    for (jr, tr) in zip(*recs):
        assert [f[1:] for f in tr.found_sats] == \
            [f[1:] for f in jr.found_sats]
        np.testing.assert_allclose([f[0] for f in tr.found_sats],
                                   [f[0] for f in jr.found_sats], rtol=1e-4)
        assert tr.slots.slot_prn == jr.slots.slot_prn
