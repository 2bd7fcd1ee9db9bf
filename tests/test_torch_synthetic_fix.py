"""The port's synthetic_fix (gps_sdr_tpu_torch/examples/synthetic_fix.py)
against the JAX package's examples/synthetic_fix.py, on the CPU (plain
path).

For no flags and for each of chip_smoke.py's phase-14b flag sets, the
port builds the JAX example's config and scenario truth and its
.synth_cache/ key: the JAX example builds them inside main(), so it is
run with its Session (and its device synth) replaced by a stub that
records the config and raises, make_scenario wrapped to record the
scenario and hashlib.sha1 wrapped to record the key.  On one 30 s
capture, the shortest that gives a few hundred fixes, both examples
read the same cached bytes (the port writes them, the JAX oracle is
checked against them) and print the same report: fix count,
ephemerides, verdict and exit code, the mean fixes within
tests/torch_envelope.py's MEAN_ATOL.  --on-device on the CPU passes, and
the entry point without a device raises where CUDA is absent."""

import contextlib
import hashlib
import importlib.util
import io
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
import gps_sdr_tpu.models.scenario as jax_scenario_mod
import gps_sdr_tpu.models.scenario_jax as jax_scenario_dev
import gps_sdr_tpu.runtime.session as jax_session_mod
from gps_sdr_tpu.models.scenario import synth_scenario_blocks as jax_synth
from gps_sdr_tpu_torch.examples import synthetic_fix as sf
from tests.torch_envelope import MEAN_ATOL, jax_cfg
from tests.torch_parity import same_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLE = os.path.join(ROOT, "examples", "synthetic_fix.py")
SEC = "30"
FLAG_SETS = [()] + [tuple(f) for f in chip_smoke.EXAMPLE_FLAG_SETS]


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_example():
    """The JAX example as a module (its import puts the root on
    sys.path, which is restored)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("jax_synthetic_fix",
                                                  JAX_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def _jax_build(mod, monkeypatch, flags):
    """(config, scenario, cache key string) that the JAX example's main
    builds for `flags` --on-device."""
    seen = {}
    real_make = jax_scenario_mod.make_scenario

    def make(*args, **kw):
        seen["scn"] = real_make(*args, **kw)
        return seen["scn"]

    def session(cfg, **kw):
        seen["cfg"] = cfg
        raise _Stop

    def sha1(data):
        seen["key"] = data.decode()
        return hashlib.sha1(data)

    monkeypatch.setattr(jax_scenario_mod, "make_scenario", make)
    monkeypatch.setattr(jax_session_mod, "Session", session)
    monkeypatch.setattr(jax_scenario_dev, "DeviceScenarioSynth",
                        lambda *args, **kw: None)
    monkeypatch.setattr(mod, "hashlib", types.SimpleNamespace(sha1=sha1))
    monkeypatch.setattr(sys, "argv", ["synthetic_fix.py", "--on-device",
                                      "--quiet", *flags])
    with pytest.raises(_Stop), contextlib.redirect_stdout(io.StringIO()):
        mod.main()
    return seen["cfg"], seen["scn"], seen["key"]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f)
                         or "defaults")
def test_config_scenario_and_cache_key_equal_the_jax_examples(
        jax_example, monkeypatch, flags):
    jcfg, jscn, key = _jax_build(jax_example, monkeypatch, flags)
    args = sf.parse_args(["--on-device", "--quiet", "--device", "cpu",
                          *flags])
    with contextlib.redirect_stdout(io.StringIO()):
        cfg, scn = sf.build(args)
    same_config(cfg, jcfg)
    assert [s.prn for s in scn.sats] == [s.prn for s in jscn.sats]
    assert (scn.tow0, scn.week) == (jscn.tow0, jscn.week)
    np.testing.assert_array_equal(scn.rec_ecef, jscn.rec_ecef)
    if jscn.rec_vel is None:
        assert scn.rec_vel is None
    else:
        np.testing.assert_array_equal(scn.rec_vel, jscn.rec_vel)
    assert [s.fault_dtsv for s in scn.sats] == \
        [s.fault_dtsv for s in jscn.sats]
    assert sf.cache_path(args) == os.path.join(
        sf.CACHE_DIR, hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy")


def _port(argv):
    """(values, printed lines) of the port's run."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = sf.run(sf.parse_args(argv))
    return res, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def host_runs(jax_example):
    """The port's and the JAX example's host runs on the same 30 s
    capture: the port's first, so that it writes the cache (the JAX
    example then reads it)."""
    res, lines = _port(["--sec", SEC, "--device", "cpu", "--quiet"])
    seen = {}
    report = jax_example._report

    def keep(args, scn, session, wall):
        seen["stat"] = session.final_summary()["stat"]
        report(args, scn, session, wall)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_example, "_report", keep)
        mp.setattr(sys, "argv", ["synthetic_fix.py", "--sec", SEC, "--cpu",
                                 "--quiet"])
        with pytest.raises(SystemExit) as stop, \
                contextlib.redirect_stdout(out):
            jax_example.main()
    return res, lines, stop.value.code, out.getvalue().splitlines(), seen


def _line(lines, start):
    (line,) = [ln for ln in lines if ln.startswith(start)]
    return line


def test_host_run_prints_the_jax_examples_report(host_runs):
    res, lines, jax_rc, jax_lines, seen = host_runs
    path = sf.cache_path(sf.parse_args(["--sec", SEC]))
    assert f"loaded cached IQ from {path}" in jax_lines
    for start in ("synthesizing scenario", "fixes:", "ephemerides decoded",
                  "truth:"):
        assert _line(lines, start) == _line(jax_lines, start)
    assert res["ok"] and lines[-1] == jax_lines[-1] == "PASS"
    assert jax_rc == 0
    assert res["n_positions"] > 100
    assert np.linalg.norm(res["mean"] - seen["stat"][0]) <= MEAN_ATOL
    assert res["err_m"] < 8.0


def test_cached_bytes_are_the_jax_oracles(host_runs):
    """Blocks of the port's cache file against the JAX package's numpy
    oracle (its noise is seeded per absolute block, so any blocks can be
    drawn alone)."""
    args = sf.parse_args(["--sec", SEC])
    with contextlib.redirect_stdout(io.StringIO()):
        cfg, _ = sf.build(args)
    jscn = jax_scenario_mod.make_scenario(
        jax_cfg(cfg), n_sats=6, seed=3,
        duration_sec=float(SEC) + 12.0)
    cached = np.load(sf.cache_path(args), mmap_mode="r")
    assert cached.shape == (int(round(float(SEC) / cfg.block_sec)),
                            cfg.ngps)
    for first in (0, 500, len(cached) - 2):
        np.testing.assert_array_equal(
            cached[first:first + 2],
            jax_synth(jscn, first, 2, noise_std=0.5))


def test_on_device_on_the_cpu_passes():
    res, lines = _port(["--sec", SEC, "--on-device", "--device", "cpu",
                        "--quiet"])
    assert res["ok"] and lines[-1] == "PASS", lines
    assert res["n_positions"] > 100


def test_default_device_raises_without_cuda():
    """`python -m gps_sdr_tpu_torch.examples.synthetic_fix` where CUDA is
    absent raises before it synthesizes anything, and main() with the
    default device raises too."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-m", "gps_sdr_tpu_torch.examples.synthetic_fix",
         "--quiet"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr, res.stderr
    assert "synthesizing" not in res.stdout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sf.main(["--quiet"])
