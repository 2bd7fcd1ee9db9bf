"""Epoch fixtures across the two packages (utils/io.py save_epoch_records
and load_epoch_records).  A fixture recorded by the JAX Session holds
the JAX package's CodePhaseList: the port reads it as its own class
without importing anything of the JAX package or of JAX, replays it to
the JAX `epochs` run's fixes exactly, and refuses any other class of
those packages before importing it.  A fixture the port writes holds
plain (stream_no, value) lists, which the JAX package reads without the
port."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.models.scenario import make_scenario as jax_scenario
from gps_sdr_tpu.runtime.session import Session as JaxSession
from gps_sdr_tpu.runtime.sources import replay_blocks as jax_replay
from gps_sdr_tpu.utils import io as jax_io
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.runtime.session import Session
from gps_sdr_tpu_torch.utils import io
from gps_sdr_tpu_torch.utils.cplist import CodePhaseList
from tests import torch_envelope as env

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEC = 30.0                      # the shortest capture of a few hundred fixes
CFG = ReceiverConfig()


@pytest.fixture(scope="module")
def jax_fixture(tmp_path_factory):
    """(path, records) of a fixture the JAX Session recorded over a 30 s,
    6-satellite capture (the synthetic_fix scenario, seed 3)."""
    capture = env.build_capture(
        "torch_epoch_fixture_v1.bin",
        jax_scenario(env.jax_cfg(CFG), n_sats=6, seed=3,
                     duration_sec=SEC + 12.0),
        CFG, int(round(SEC / CFG.block_sec)), noise=0.5, scale=0.13)
    jc = env.jax_cfg(CFG)
    session = JaxSession(jc, record_epochs_to="memory")
    session.run_source(jax_replay(capture, jc))
    path = tmp_path_factory.mktemp("fixtures") / "jax_epochs.pickle"
    jax_io.save_epoch_records(str(path), session.records)
    return str(path), session.records


def _fresh(code: str) -> str:
    """Standard output of `code` in a fresh interpreter at the root."""
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env_vars["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env_vars, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def _jax_fixes(path: str) -> np.ndarray:
    session = JaxSession(JaxConfig())
    session.run_epoch_records(jax_io.load_epoch_records(path))
    return np.asarray(session.evaluator.positions, np.float64)


def test_jax_fixture_holds_the_jax_class(jax_fixture):
    from gps_sdr_tpu.utils.cplist import CodePhaseList as JaxCodePhaseList

    _, records = jax_fixture
    series = [lst for rec in records for lst in rec[2].values()]
    assert series and all(isinstance(s, JaxCodePhaseList) for s in series)


def test_port_loads_a_jax_fixture_without_jax(jax_fixture, tmp_path):
    """In a fresh interpreter: the port's loader gives its own
    CodePhaseList, equal to the recorded series, and leaves no module of
    jax or gps_sdr_tpu loaded; a pickled JAX ReceiverConfig is refused
    with a ValueError naming it, before anything is imported."""
    path, records = jax_fixture
    bad = tmp_path / "config.pickle"
    with open(bad, "wb") as f:
        pickle.dump([(0, [], {}), JaxConfig()], f)
    series = tmp_path / "series.pickle"
    out = _fresh(
        "import pickle, sys\n"
        "from gps_sdr_tpu_torch.utils.io import load_epoch_records\n"
        "from gps_sdr_tpu_torch.utils.cplist import CodePhaseList\n"
        f"recs = load_epoch_records({path!r})\n"
        "got = {(i, prn): (l.snos.tolist(), l.vals.tolist())\n"
        "       for i, r in enumerate(recs) for prn, l in r[2].items()}\n"
        f"with open({str(series)!r}, 'wb') as f:\n"
        "    pickle.dump(got, f)\n"
        "print('PORT_CLASS', all(isinstance(l, CodePhaseList)\n"
        "      for r in recs for l in r[2].values()))\n"
        "try:\n"
        f"    load_epoch_records({str(bad)!r})\n"
        "    print('LOADED')\n"
        "except ValueError as e:\n"
        "    print('REFUSED', e)\n"
        "print('FOREIGN_MODULES', sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'gps_sdr_tpu')))\n")
    want = {(i, prn): (lst.snos.tolist(), lst.vals.tolist())
            for i, rec in enumerate(records) for prn, lst in rec[2].items()}
    with open(series, "rb") as f:
        assert pickle.load(f) == want
    assert "PORT_CLASS True" in out, out
    assert "REFUSED" in out and "gps_sdr_tpu.config.ReceiverConfig" in out, out
    assert "FOREIGN_MODULES []" in out, out


def test_port_epochs_give_the_jax_epochs_runs_fixes(jax_fixture):
    path, _ = jax_fixture
    records = io.load_epoch_records(path)
    assert all(isinstance(lst, CodePhaseList)
               for rec in records for lst in rec[2].values())
    session = Session(CFG, device="cpu")
    summary = session.run_epoch_records(records)
    got = np.asarray(session.evaluator.positions, np.float64)
    want = _jax_fixes(path)
    assert summary["n_positions"] == len(want) > 100
    np.testing.assert_array_equal(got, want)


def test_jax_package_loads_a_port_fixture_without_the_port(jax_fixture,
                                                           tmp_path):
    """The port writes plain (stream_no, value) lists: the JAX package
    loads them in a fresh interpreter with no gps_sdr_tpu_torch module,
    and its `epochs` run gives the same fixes as from its own fixture."""
    path, _ = jax_fixture
    port_path = str(tmp_path / "port_epochs.pickle")
    io.save_epoch_records(port_path, io.load_epoch_records(path))
    out = _fresh(
        "import sys\n"
        "from gps_sdr_tpu.utils.io import load_epoch_records\n"
        f"recs = load_epoch_records({port_path!r})\n"
        "print('PLAIN', all(type(l) is list\n"
        "      for r in recs for l in r[2].values()))\n"
        "print('PORT_MODULES', sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] == 'gps_sdr_tpu_torch'))\n")
    assert "PLAIN True" in out, out
    assert "PORT_MODULES []" in out, out
    np.testing.assert_array_equal(_jax_fixes(port_path), _jax_fixes(path))
