"""chip_smoke.py phase 13 replays the JAX envelope tests' own captures on
the card: the signal from the port's DeviceScenarioSynth with noise off,
plus the JAX synth's noise re-derived without JAX (chip_smoke's
threefry2x32, jax_normals and jax_synth_noise).  Here, on the CPU:

  - the keys equal jax.random's fold_in keys bit for bit, and the
    normals equal jax.random.normal within 4 ulps (the uniform is exact;
    log1p rounds apart from XLA's in the last bits);
  - jax_synth_noise equals the JAX DeviceScenarioSynth's noise (its
    satellites silenced) within 4 ulps of each sample;
  - envelope_capture's first two chunks of every ENVELOPE capture equal
    the JAX test's recipe's bytes but for at most 1e-4 of the samples
    (a chip edge the two synths' f32 code positions place one sample
    apart, or a last-bit noise difference at a quantization step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gps_sdr_tpu.models.scenario import make_scenario as jax_scenario
from gps_sdr_tpu.models.scenario_jax import DeviceScenarioSynth
from gps_sdr_tpu.runtime.sources import pack_iq
from gps_sdr_tpu_torch.config import ReceiverConfig
from tests import torch_envelope as env

torch.set_num_threads(2)

CFG = ReceiverConfig()


def _ulps(got, want) -> float:
    return float(np.max(np.abs(got - want)
                        / np.spacing(np.abs(want).astype(np.float32))))


@pytest.mark.parametrize("seed", [7919, 7919 + 1999, 8_388_607])
def test_jax_normals_match_jax_random(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(seed))
    sub = jax.random.fold_in(key, 1)
    zero = torch.zeros(1, dtype=torch.int64)
    k0, k1 = chip_smoke.threefry2x32(zero, zero, zero,
                                     torch.tensor([seed]))
    j0, j1 = chip_smoke.threefry2x32(k0, k1, zero, torch.ones(1,
                                                              dtype=torch.int64))
    assert [int(k0), int(k1)] == np.asarray(key).tolist()
    assert [int(j0), int(j1)] == np.asarray(sub).tolist()
    for (a, b), k in (((k0, k1), key), ((j0, j1), sub)):
        got = chip_smoke.jax_normals(a, b, CFG.ngps)[0].numpy()
        want = np.asarray(jax.random.normal(k, (CFG.n_cyc, CFG.code_samples),
                                            jnp.float32)).ravel()
        assert _ulps(got, want) <= 4.0


def test_jax_synth_noise_matches_jax_synth():
    scn = jax_scenario(env.jax_cfg(CFG), n_sats=4, seed=3,
                       duration_sec=8.0)
    for sat in scn.sats:
        sat.amplitude = 0.0
    first, n = 37, 3
    want = np.asarray(DeviceScenarioSynth(scn, noise_std=1.0)
                      .chunk_planar(first, n))
    got = chip_smoke.jax_synth_noise(CFG, first, n, "cpu").numpy()
    assert got.shape == want.shape
    assert _ulps(got, want) <= 4.0


@pytest.mark.parametrize("name", sorted(chip_smoke.ENVELOPE))
def test_envelope_capture_is_the_jax_tests_bytes(name, tmp_path):
    fields, kw, sec, noise, scale, _ = chip_smoke.ENVELOPE[name]
    cfg = CFG.replace(**fields)
    n_blocks = 2 * cfg.no_sec
    path = str(tmp_path / "capture.bin")
    chip_smoke.envelope_capture(name, cfg, chip_smoke.envelope_scenario(
        name, cfg), path, "cpu", max_blocks=n_blocks)
    got = np.fromfile(path, np.uint16)

    jscn = jax_scenario(env.jax_cfg(cfg), duration_sec=sec + 12.0, **kw)
    if name == "faulted":
        jscn.sats[chip_smoke.FAULT_SAT].fault_dtsv = chip_smoke.FAULT_S
    synth = DeviceScenarioSynth(jscn, noise_std=noise)
    want = np.concatenate([
        pack_iq(scale * np.asarray(synth.chunk(first, cfg.no_sec))).ravel()
        for first in range(0, n_blocks, cfg.no_sec)])
    assert got.shape == want.shape
    assert np.count_nonzero(got != want) <= 1e-4 * got.size
