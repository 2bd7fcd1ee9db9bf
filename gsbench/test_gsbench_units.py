"""CPU tests of the benchmark's yardstick: the manifest, the work counts,
the generator, the reference, its control and the trace arithmetic.

    python -m pytest gsbench -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from gsbench import (control, judge, manifest, reference, scenario, synth,
                     traceio, work)

ROOT = manifest.ROOT
SHAPE = {"code_samples": 2048, "n_cyc": 32, "fs": 2.048e6, "corr_avg": 8,
         "no_sec": 32, "corr_hist_len": 1920}


def test_manifest_names_units_and_files():
    man = manifest.load()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in man["configs"]] + \
        [w["name"] for w in man["workloads"]] + \
        [m["name"] for m in man["end_to_end"] + man["per_layer"]] + \
        [w["traffic"] for w in man["workloads"]]
    for n in names:
        assert manifest.NAME_RE.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert manifest.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(manifest.PKG, "metrics",
                                           m["name"] + ".py"))
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
    for w in man["workloads"]:
        cell, config, traffic = manifest.cell(man, w["name"])
        assert config["name"] == w["config"]
        assert config["devices"] == w["chips"]
    four = [w for w in man["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(man["workloads"]) // 4)


def test_work_counts_match_the_roofline_tool():
    w = work.work_per_block(SHAPE, 12)
    assert w["bytes"] == 524_288
    assert w["flops"] == 9_157_632
    t, what = work.floor_us(w)
    assert what == "bytes" and abs(t - 0.1565) < 1e-3
    with pytest.raises(ValueError):
        work.share(2.0, 1.0, "x")
    b1, f1 = work.wipeoff_bound(SHAPE, 1, 12, 8)
    b2, f2 = work.wipeoff_bound(SHAPE, 32, 12, 8)
    assert b2 > 30 * b1 and f2 == 32 * f1
    cb, cf = work.cheap_bound(SHAPE, 12, 8)
    assert 50_000 < cb < 200_000 and cf == 12 * 8 * (1920 + 60 * 33)


def test_generator_is_deterministic_from_the_seed():
    shape = dict(SHAPE)
    a = sc_capture(7, 0, shape)
    b = sc_capture(7, 0, shape)
    c = sc_capture(7, 1, shape)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    s1 = scenario.make_scenario(synth.capture_seed(2 ** 31 + 5, 3), 10, 20)
    s2 = scenario.make_scenario(synth.capture_seed(2 ** 31 + 5, 3), 10, 20)
    assert [s.prn for s in s1.sats] == [s.prn for s in s2.sats]
    assert len({s.prn for s in s1.sats}) == 10


def sc_capture(seed, index, shape, n_blocks=3):
    scn = scenario.make_scenario(synth.capture_seed(seed, index), 4, 10)
    return synth.make_capture(scn, shape, n_blocks, 0.5, 0.12,
                              synth.noise_seed(seed, index), "packed",
                              torch.device("cpu"))


def test_layouts_hold_the_same_levels():
    scn = scenario.make_scenario(synth.capture_seed(3, 0), 4, 10)
    dev = torch.device("cpu")
    args = (scn, SHAPE, 2, 0.5, 0.12, 11)
    words = synth.make_capture(*args, "packed", dev)
    cplx = synth.make_capture(*args, "complex", dev).numpy().reshape(-1)
    planar = synth.make_capture(*args, "planar", dev).numpy()
    lv = synth.LEVELS
    assert np.array_equal(cplx.real, lv[words % 256])
    assert np.array_equal(cplx.imag, lv[words // 256])
    assert np.array_equal(planar[:, 0].reshape(-1), cplx.real)
    assert np.array_equal(planar[:, 1].reshape(-1), cplx.imag)


def test_nav_message_round_trips_parity_and_fields():
    scn = scenario.make_scenario(synth.capture_seed(5, 0), 2, 30)
    sat = scn.sats[0]
    bits = (sat.nav_stream[:300] + 1) // 2
    assert list(bits[:8]) == [1, 0, 0, 0, 1, 0, 1, 1]
    # every word's parity holds against the previous word's D29, D30
    d29 = d30 = 0
    for w in range(10):
        word = bits[30 * w:30 * w + 30]
        src = (word[:24] + d30) % 2
        assert list(scenario._parity(src, d29, d30)) == list(word[24:])
        d29, d30 = int(word[28]), int(word[29])


def test_reference_fix_and_code_phase():
    scn = scenario.make_scenario(synth.capture_seed(9, 0), 10, 70)
    f = reference.fix(scn, scn.t_rx0 + 40.0)
    assert np.linalg.norm(f - scn.rec_ecef) < 2.0
    sat = scn.sats[0]
    cp = reference.code_phase(scn, sat, SHAPE, np.arange(64))
    assert ((cp >= 0) & (cp < 2048)).all()
    step = np.abs(np.diff(cp))
    assert (np.minimum(step, 2048 - step) < 1.0).all()
    dop = reference.doppler(scn, sat, SHAPE, [0])
    assert abs(dop[0]) < 6000


def test_control_is_not_correct():
    cell = manifest.load()["workloads"][0]["name"]
    v = control.run(cell, 11, resize={"traffic": {"captures": 2}})
    assert not v["correct"]
    c = v["checks"]
    assert c["code_phase_gap"]["value"] > 100
    assert c["fix_gap_m"]["value"] > 1e4
    assert c["ephem_wrong"]["value"] > 0
    same = control.run(cell, 11, dtype=np.float64,
                       resize={"traffic": {"captures": 2}})
    assert same["correct"], same["checks"]


def test_judge_catches_a_shifted_answer():
    caps = control.scenarios({"satellites": 4, "blocks": 128,
                              "captures": 1},
                             {"receiver": {"code_samples": 2048, "n_cyc": 32,
                                           "corr_avg": 8,
                                           "corr_q_window_sec": 60}}, 4)
    recs = control.records(caps, SHAPE, np.float64)
    config = {"receiver": {"step_freq": 200.0},
              "limits": {k: (0 if k in ("acq_wrong", "ephem_wrong",
                                        "fix_missing") else 1.0)
                         for k in judge.NUMBERS}}
    due = {"ephemeris": True, "fixes": True}
    ok = judge.judge(recs, judge.Reference(caps, SHAPE), config, due)
    assert ok["correct"], ok
    ep = recs[0].epochs[1]
    prn = next(iter(ep.code_phases))
    ep.code_phases[prn].vals = (ep.code_phases[prn].vals + 512) % 2048
    bad = judge.judge(recs, judge.Reference(caps, SHAPE), config, due)
    assert not bad["correct"]
    assert bad["checks"]["code_phase_gap"]["value"] > 500


def _trace(events):
    return {"traceEvents": events}


def test_trace_arithmetic_on_a_hand_made_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": traceio.MEASURED,
         "ts": 100.0, "dur": 1000.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "gsbench.evaluator",
         "ts": 600.0, "dur": 300.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
         "ts": 150.0, "dur": 300.0, "pid": 1, "tid": 1},
        # device 0: two overlapping kernels, one clipped at the start
        {"ph": "X", "cat": "kernel", "name": "void wipeoff_kernel(A)",
         "ts": 200.0, "dur": 100.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "void cheap_kernel<2>(C)",
         "ts": 250.0, "dur": 100.0, "pid": 0, "tid": 8},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 50.0, "dur": 100.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "x",
         "ts": 100.0, "dur": 1000.0, "pid": 0, "tid": 9},
        # device 1: one kernel
        {"ph": "X", "cat": "kernel", "name": "elementwise",
         "ts": 700.0, "dur": 200.0, "pid": 2, "tid": 7},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_trace(ev)))
    s = traceio.summarize(traceio.load(str(p)))
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["devices"][0] == pytest.approx((50 + 150) * 1e-6)
    assert s["devices"][2] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(200e-6)
    assert s["kernels"]["wipeoff"] == {"s": pytest.approx(1e-4),
                                       "count": 1}
    assert s["kernels"]["cheap"]["count"] == 1
    gaps = dict(s["idle_gaps"])
    # device 0 idles [150, 200] and [350, 1100], device 1 [100, 700] and
    # [900, 1100]; each gap is named at its middle, halved over 2 devices
    assert gaps == {"evaluator: python": pytest.approx(750e-6 / 2),
                    "receiver loop: aten::copy_": pytest.approx(650e-6 / 2),
                    "receiver loop: python": pytest.approx(200e-6 / 2)}
    assert traceio.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert traceio.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def test_imports_stay_clear_of_jax_and_the_program():
    """In a fresh process: every gsbench module loads no JAX and no JAX
    package (top-level names compared whole), and the reference's
    modules load nothing of the receiver."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import gsbench.reference, gsbench.judge, gsbench.control\n"
        "import gsbench.scenario, gsbench.synth, gsbench.work\n"
        "import gsbench.traceio, gsbench.generator\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'gps_sdr_tpu_torch' not in tops, sorted(tops)\n"
        "import gsbench\n"
        "for m in pkgutil.walk_packages(gsbench.__path__, 'gsbench.'):\n"
        "    if not m.name.split('.')[-1].startswith('test_'):\n"
        "        importlib.import_module(m.name)\n"
        "import gsbench.harness, gsbench.drivers.session\n"
        "import gsbench.drivers.serve\n"
        "gsbench.harness.program_config({'receiver': {}})\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "bad = tops & {'jax', 'jaxlib', 'flax', 'gps_sdr_tpu'}\n"
        "assert not bad, bad\n"
        "assert 'gps_sdr_tpu_torch' in tops\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_epoch_latency_runs_from_its_own_chunk():
    """A receiver that reads two chunks ahead of the epoch it hands out:
    the epoch's latency runs from the request of its own chunk's last
    block, so the wait behind it counts, and not from the request of
    the last block read."""
    from gsbench.drivers import session as sd
    chunk, pause = 4, 0.01
    drv = sd.Driver.__new__(sd.Driver)
    drv._replay = lambda path, cfg: iter(range(3 * chunk))
    drv.cfg, drv.file = None, True
    drv.win = types.SimpleNamespace(t_end=float("inf"))
    drv.latencies_ms, drv.signal_blocks, drv.eval_s = [], 0, 0.0
    t_req: list = []
    proxy = sd._EvalProxy(None, drv, None, None, None, t_req)
    src = drv._blocks("capture", t_req)
    for _ in range(3 * chunk):
        next(src)
        time.sleep(pause)
    # the first chunk's epoch: blocks 0..3, stream numbers 1..4
    epoch = judge.Answers({5: judge.Series(np.arange(1, chunk + 1),
                                           np.zeros(chunk))}, [])
    t1 = time.perf_counter()
    drv.account(proxy, epoch, t1, t1)
    assert drv.latencies_ms == [pytest.approx((t1 - t_req[chunk - 1]) * 1e3)]
    assert drv.latencies_ms[0] >= 2 * chunk * pause * 1e3
    assert drv.signal_blocks == chunk


def test_run_without_a_card_fails_and_prints_no_result():
    cell = manifest.load()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "gsbench/run.py", "--workload",
                          cell, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr, out.stderr
