"""PyTorch port vs JAX: coarse-time snapshot positioning (ops/snapshot.py)
and the CLI's `snapshot` mode.

  * solve_snapshot equals the JAX function bit for bit (the same host
    float64 numpy) on tests/test_snapshot.py's solver cases: the 47 km
    and 112 km priors, and the 4-satellite case with and without the
    height constraint;
  * snapshot_fix on the cached snapshot_e2e_v1 block (the port's
    acquire_impl on the CPU): the same satellite count and millisecond
    integers as JAX, the position within 0.5 m of JAX's and within 50 m
    of the truth, the time within 0.01 s;
  * `snapshot` through the port's cli.main on the CPU with
    tests/test_snapshot.py's bars (0.002 deg latitude, 0.003 deg
    longitude)."""

import re

import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import DEFAULT as JAX_CFG
from gps_sdr_tpu.models.scenario import make_scenario as jax_make_scenario
from gps_sdr_tpu.models.scenario import synth_scenario_blocks
from gps_sdr_tpu.ops import snapshot as jsnap
from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.ops import cacode
from gps_sdr_tpu_torch.ops import snapshot as tsnap
from gps_sdr_tpu_torch.runtime.sources import pack_iq
from gps_sdr_tpu_torch.utils.io import save_ephemerides

from conftest import cached_synth

torch.set_num_threads(2)

CFG = ReceiverConfig()


def _truth_fracs(scn, t_rx):
    """tests/test_snapshot.py's exact-measurement oracle."""
    fracs, ephs = [], []
    for sat in scn.sats:
        _, tau_sv = scn.sat_states(np.array([t_rx]), sat)
        fracs.append((-tau_sv[0] * 1000.0) % 1.0)
        ephs.append(sat.eph)
    return np.array(fracs), ephs


# (n_sats, seed, prior offset m, time offset s, height constraint)
SOLVER_CASES = {
    "exact": (7, 11, (30e3, -30e3, 20e3), -25.0, False),
    "far_prior": (8, 5, (-80e3, 60e3, -50e3), 50.0, False),
    "four_sats": (4, 2, (0.0, 0.0, 0.0), 0.0, False),
    "four_sats_height": (4, 2, (20e3, -10e3, 5e3), -10.0, True),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solve_snapshot_bit_identical(case):
    n_sats, seed, off, dt, use_h = SOLVER_CASES[case]
    scn = jax_make_scenario(JAX_CFG, n_sats=n_sats, duration_sec=1.0,
                            seed=seed)
    t_rx = scn.t_rx0 + 0.5
    fracs, ephs = _truth_fracs(scn, t_rx)
    prior = scn.rec_ecef + np.array(off)
    kw = dict(height=scn.rec_geo[2]) if use_h else {}
    want = jsnap.solve_snapshot(ephs, fracs, t_rx + dt, prior, **kw)
    got = tsnap.solve_snapshot(ephs, fracs, t_rx + dt, prior, **kw)
    if want is None:
        assert got is None
        return
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert np.linalg.norm(got.rec_pos - scn.rec_ecef) < 30.0


def _e2e():
    scn = jax_make_scenario(JAX_CFG, n_sats=7, duration_sec=4.0, seed=11)
    first_block = 8
    block = cached_synth(
        "snapshot_e2e_v1",
        lambda: synth_scenario_blocks(scn, first_block, 1, noise_std=0.6,
                                      seed=7))[0]
    t_rx = scn.t_rx0 + first_block * JAX_CFG.ngps / JAX_CFG.sample_rate
    return scn, block, t_rx


def test_snapshot_fix_matches_jax():
    scn, block, t_rx = _e2e()
    ephs_by_prn = {sat.prn: sat.eph for sat in scn.sats}
    prior = scn.rec_ecef + np.array([30e3, -30e3, 20e3])
    want = jsnap.snapshot_fix(JAX_CFG, block, cacode.ca_fft_table(CFG),
                              ephs_by_prn, t_rx - 20.0, prior)
    got = tsnap.snapshot_fix(CFG, block, cacode.ca_fft_table(CFG),
                             ephs_by_prn, t_rx - 20.0, prior, device="cpu")
    assert got is not None and want is not None
    assert got.n_sat == want.n_sat >= 5
    np.testing.assert_array_equal(got.ms_int, want.ms_int)
    assert np.linalg.norm(got.rec_pos - want.rec_pos) < 0.5
    assert np.linalg.norm(got.rec_pos - scn.rec_ecef) < 50.0
    assert abs(got.t_gps - t_rx) < 0.01
    # a tensor block on the device gives the same fix
    again = tsnap.snapshot_fix(CFG, torch.from_numpy(block),
                               cacode.ca_fft_table(CFG), ephs_by_prn,
                               t_rx - 20.0, prior, device="cpu")
    np.testing.assert_array_equal(again.rec_pos, got.rec_pos)


def test_snapshot_cli(tmp_path, capsys):
    scn, block, t_rx = _e2e()
    cap = tmp_path / "cap.bin"
    pack_iq(block).tofile(cap)
    eph_path = tmp_path / "eph.json"
    save_ephemerides(str(eph_path), {s.prn: s.eph for s in scn.sats})
    lat, lon, h = scn.rec_geo
    rc = cli.main(["snapshot", str(cap), "--ephem-cache", str(eph_path),
                   "--prior-geo", f"{lat + 0.3},{lon - 0.3},{h}",
                   "--tow", str(t_rx - 20.0), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    m = re.search(r"snapshot fix: ([-\d.]+) deg, ([-\d.]+) deg", out)
    assert m, out
    assert abs(float(m.group(1)) - lat) < 0.002       # ~200 m
    assert abs(float(m.group(2)) - lon) < 0.003
    assert "corrected tow" in out


def test_snapshot_cli_refuses_empty_cache(tmp_path, capsys):
    cap = tmp_path / "cap.bin"
    pack_iq(np.zeros(CFG.ngps, np.complex64)).tofile(cap)
    eph_path = tmp_path / "eph.json"
    save_ephemerides(str(eph_path), {})
    rc = cli.main(["snapshot", str(cap), "--ephem-cache", str(eph_path),
                   "--prior-geo", "0,0,0", "--tow", "100", "--device",
                   "cpu"])
    assert rc == 2
    assert "ephemeris cache empty" in capsys.readouterr().err
