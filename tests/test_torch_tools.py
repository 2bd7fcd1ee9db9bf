"""The port's analysis tools (gps_sdr_tpu_torch/examples/roofline.py,
probe_device_loop.py, profile_evalhost.py, profile_fullloop.py,
profile_serving.py, scaling_sweep.py) against the JAX package, on the
CPU.  No JAX examples/*.py script runs here: roofline.py and
scaling_sweep.py write into the repository root, so the JAX side is
called through its package's functions, as those scripts call them.

  * work_per_block at the product config with 12 channels: 524,288 B and
    9,157,632 flops a block, the same with either wipeoff kernel;
    flops_per_block_jax_count 44,497,920 (the JAX tool's); the peaks are
    the ones chip_smoke.py's kernel bounds divide by; a share over 1.0
    raises;
  * the roofline's workload is the JAX tool's (PRNs, Dopplers, delays,
    bits), and its tracked outputs on 64 blocks at K=8 with 4 channels
    hold to the JAX package's track_chunk_batched within
    tests/test_torch_tracking.py::_compare (carry_sum by the product
    config's rule, tests/test_torch_parity_tracking.py carry_tolerance);
  * stage_buckets on a written trace: nested and overlapping events
    count once, each kernel name lands in its bucket, the buckets sum to
    device_time_from_trace's busy time, only the measured step's span
    counts when it is named, and check_complete refuses a trace with
    fewer kernel events than launches; the roofline's main on the CPU
    writes a report that says so;
  * the probe's epochs give exactly the fixes of Receiver.run_device and
    an Evaluator on the same provider, and their count and mean those of
    the JAX package's Receiver.run_device on the same IQ within
    tests/torch_envelope.py's MEAN_ATOL;
  * profile_evalhost's replay of a StreamServer capture gives exactly
    the fixes of process_many over the same epochs, replaying leaves the
    capture as it was, and its cache refuses another key and a JAX
    pickle;
  * the scaling sweep's rows at 2 shards on 16 blocks against the JAX
    tool's rows from the JAX package's track_sharded on the conftest's
    8-device CPU mesh: work factors exactly, the accuracy columns within
    tests/test_parallel.py's tolerances;
  * every tool raises without CUDA unless given --cpu.

The receiver-loop cases run the product config at 1.024 MS/s (cs 1024,
as tests/test_torch_bench.py's soak case) over 18 s of the probe's
scenario with its ephemerides preloaded, so fixes start after the first
decoded time reference; the host core runs its numpy paths
(GSDR_EVALCORE=0 GSDR_NAVSCAN=0, as tests/test_torch_host_copies.py)."""

import copy
import dataclasses
import gzip
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.models.simulator import SatSignal as JaxSat
from gps_sdr_tpu.models.simulator import random_bits as jax_random_bits
from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu.parallel import make_mesh as jax_make_mesh
from gps_sdr_tpu.parallel import pad_channels as jax_pad_channels
from gps_sdr_tpu.parallel import track_sharded as jax_track_sharded
from gps_sdr_tpu.runtime import evaluator as jev
from gps_sdr_tpu.runtime.receiver import Receiver as JaxReceiver
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.examples import (probe_device_loop, profile_evalhost,
                                        profile_fullloop, profile_serving,
                                        roofline, scaling_sweep)
from gps_sdr_tpu_torch.runtime import evaluator as tev
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.utils import profiling as tprof
from tests.test_torch_parity_tracking import carry_tolerance
from tests.test_torch_tracking import _compare
from tests.torch_envelope import MEAN_ATOL

torch.set_num_threads(2)

CPU = torch.device("cpu")
PRODUCT = ReceiverConfig(max_sat=12, blocks_per_step=16)
PROBE_SEC = 18.0


@pytest.fixture(autouse=True)
def _numpy_host_core(monkeypatch):
    monkeypatch.setenv("GSDR_EVALCORE", "0")
    monkeypatch.setenv("GSDR_NAVSCAN", "0")


def _jax(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


# --- roofline ----------------------------------------------------------------

@pytest.mark.parametrize("mxu", [True, False])
def test_work_per_block_at_the_product_config(mxu):
    cfg = PRODUCT.replace(use_mxu_wipeoff=mxu)
    work = roofline.work_per_block(cfg, 12)
    assert work["bytes"] == 524_288
    assert work["flops"] == 9_157_632 == sum(work["flops_by_stage"].values())
    assert roofline.flops_per_block_jax_count(cfg, 12) == 44_497_920
    floor, by = roofline.floor_us(work)
    assert by == "bytes"
    assert floor == pytest.approx(524_288 / 3.35e12 * 1e6)
    # chip_smoke.py's kernel bounds divide by the same peaks
    assert chip_smoke._bound(3.35e9, 0.0) == (1.0, "bytes")
    assert chip_smoke._bound(0.0, 67e9) == (1.0, "operations")


def test_shares_raise_over_one():
    work = roofline.work_per_block(PRODUCT, 12)
    floor, _ = roofline.floor_us(work)
    got = roofline.shares(work, 4 * floor)
    assert got["bytes"] == pytest.approx(0.25)
    assert got["f32"] == pytest.approx(9_157_632 / 67e12 * 1e6 / (4 * floor))
    assert got["tf32"] == pytest.approx(got["f32"] * 67 / 495)
    with pytest.raises(ValueError, match="bytes share .* > 1.0"):
        roofline.shares(work, 0.9 * floor)


def test_roofline_workload_and_tracking_match_jax():
    cfg = ReceiverConfig(max_sat=4, blocks_per_step=8)
    sats, chunk, step = roofline.tracking_step(cfg, 64, CPU)
    # examples/roofline.py:72-78
    rng = np.random.default_rng(0)
    prns = rng.choice(np.arange(2, 33), 4, replace=False)
    want = [JaxSat(prn=int(p), doppler=float(rng.uniform(-4500, 4500)),
                   code_delay=float(rng.uniform(0, cfg.code_samples)),
                   nav_bits=jax_random_bits(4096, seed=i))
            for i, p in enumerate(prns)]
    for got, w in zip(sats, want, strict=True):
        assert (got.prn, got.doppler, got.code_delay, got.amplitude) == \
            (w.prn, w.doppler, w.code_delay, w.amplitude)
        np.testing.assert_array_equal(got.nav_bits, w.nav_bits)
    tst, to = step()
    jcfg = _jax(cfg)
    jst = jtrk.init_channel_states(jcfg, 4)
    for i, s in enumerate(want):
        jst = jtrk.reset_channel(jst, i, s.prn, s.doppler,
                                 int(s.code_delay) % cfg.code_samples, jcfg)
    tab = _jax_code_tables(cfg, want)
    jst, jo = jtrk.track_chunk_batched(jcfg, jst, jnp.asarray(chunk.numpy()),
                                       jnp.int32(1), *tab)
    assert to.code_phase.shape == (64, 4)
    assert (to.locked[-1]).all()
    _compare(jst, jo, tst, to, carry_atol=carry_tolerance(cfg, jst))


def _jax_code_tables(cfg, sats):
    """The JAX package's code and code-FFT tables of `sats`."""
    from gps_sdr_tpu.ops import cacode as jcacode

    tab, ftab = jcacode.ca_table(_jax(cfg)), jcacode.ca_fft_table(_jax(cfg))
    return (jnp.asarray(np.stack([tab[s.prn] for s in sats])),
            jnp.asarray(np.stack([ftab[s.prn] for s in sats])))


# (lane, name, ts µs, dur µs, category): lane 0 holds a nested event (the
# elementwise kernel inside the wipeoff one) and an overlapping pair;
# lane 1 is less busy; the host operator is no device event
TRACE = [
    (0, "wipeoff_kernel", 0.0, 10.0, "kernel"),
    (0, "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>", 2.0, 3.0, "kernel"),
    (0, "void regular_fft<2048u, 16u, 128u>(kernel_arguments_t<unsigned "
        "int>)", 10.0, 4.0, "kernel"),
    (0, "void at::native::reduce_kernel<512, 1>", 12.0, 4.0, "kernel"),
    (0, "void spRadix0064B::kernel1Mem<unsigned int, float, "
        "fftDirection_t=-1>", 20.0, 2.0, "kernel"),
    (0, "cheap_kernel", 22.0, 6.0, "kernel"),
    (0, "Memcpy DtoH (Device -> Pinned)", 30.0, 2.0, "gpu_memcpy"),
    (0, "Memset (Device)", 32.0, 1.0, "gpu_memset"),
    (0, "wipeoff_vpu_kernel", 40.0, 5.0, "kernel"),
    (1, "cheap_kernel", 0.0, 3.0, "kernel"),
]
# the measured step's host span, and a kernel of the step before it
SPAN = (-1.0, 50.0)
OUTSIDE = (0, "wipeoff_kernel", -30.0, 10.0, "kernel")
WANT_BUCKETS = {"wipeoff": (12.0, 2), "elementwise": (7.0, 2),
                "fft": (4.0, 2), "cheap": (6.0, 1), "copies": (3.0, 2)}


def test_stage_buckets_on_a_written_trace(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "pid": 9, "tid": 9,
               "name": "aten::mul", "ts": 0.0, "dur": 100.0}]
    events += [{"ph": "X", "cat": cat, "pid": 0, "tid": lane, "name": name,
                "ts": ts, "dur": dur}
               for lane, name, ts, dur, cat in TRACE + [OUTSIDE]]
    events.append({"ph": "X", "cat": "user_annotation", "pid": 9, "tid": 9,
                   "name": roofline.MEASURED, "ts": SPAN[0],
                   "dur": SPAN[1] - SPAN[0]})
    with gzip.open(tmp_path / f"trace_1{tprof.TRACE_SUFFIX}", "wt") as f:
        json.dump({"traceEvents": events}, f)
    # without a window every device event counts, as the JAX parser's
    whole = roofline.stage_buckets(str(tmp_path))
    dev = tprof.device_time_from_trace(str(tmp_path))
    assert whole["busy_s"] == pytest.approx(dev["busy_s"]) \
        == pytest.approx(42e-6)          # OUTSIDE 10 and lane 0 32
    assert whole["buckets"]["wipeoff"]["count"] == 3
    with pytest.raises(ValueError, match="0 'nothing' spans"):
        roofline.stage_buckets(str(tmp_path), "nothing")
    got = roofline.stage_buckets(str(tmp_path), roofline.MEASURED)
    assert got["lane"] == dev["lane"] == "device"
    assert (got["n_events"], got["n_lanes"]) == (9, 2)
    assert set(got["buckets"]) == set(roofline.BUCKETS)
    for name, (us, count) in WANT_BUCKETS.items():
        bk = got["buckets"][name]
        assert bk["s"] == pytest.approx(us * 1e-6), name
        assert bk["count"] == count, name
    assert got["busy_s"] == pytest.approx(32e-6) \
        == pytest.approx(sum(b["s"] for b in got["buckets"].values()))
    for lane, name, _, _, cat in TRACE:
        if lane == 0:
            bucket = roofline.bucket_of(name, cat)
            assert name in [n for n, _, _ in got["buckets"][bucket]["top"]]
    # the trace holds every launch the counters saw, or it raises
    roofline.check_complete(got, {"wipeoff_vpu": 2, "cheap": 1},
                            "wipeoff_vpu")
    with pytest.raises(RuntimeError, match="dropped device events"):
        roofline.check_complete(got, {"wipeoff": 3, "cheap": 1}, "wipeoff")


def test_roofline_main_on_the_cpu(tmp_path):
    out = tmp_path / "roofline.json"
    assert roofline.main(["--cpu", "--blocks", "16", "--k", "8",
                          "--channels", "2", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["device"] == {"name": "cpu", "power_limit": "cpu"}
    assert doc["lane"] == "host" and doc["shares"] is None
    assert doc["k_steps"] == 2 and doc["bytes_per_block"] == 524_288
    assert doc["flops_per_block"] == roofline.work_per_block(
        ReceiverConfig(max_sat=2), 2)["flops"]
    assert sum(b["us_per_block"] for b in doc["buckets"].values()) == \
        pytest.approx(doc["busy_us_per_block"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["roofline.json"]


# --- the receiver loop: probe, evaluator replay ------------------------------

@pytest.fixture(scope="module")
def sky():
    """(cfg, scenario, provider, chunk count): the probe's scenario (6
    satellites, seed 3) at 1.024 MS/s, PROBE_SEC of it synthesized on
    the CPU into one buffer (--presynth), windows of 4 chunks."""
    cfg = ReceiverConfig(code_samples=1024, chunks_per_download=4)
    scn, provider, n = probe_device_loop.scenario_provider(cfg, PROBE_SEC, 6,
                                                           True, CPU)
    return cfg, scn, provider, n


@pytest.fixture
def preloaded(sky, monkeypatch):
    """Every Evaluator of either package starts with the scenario's
    ephemerides."""
    ephs = {s.prn: {"SAT": s.prn, **s.eph} for s in sky[1].sats}
    for mod in (tev, jev):
        real = mod.Evaluator.__init__

        def init(self, *a, _real=real, **kw):
            _real(self, *a, **kw)
            self.preloaded_ephem.update(ephs)
        monkeypatch.setattr(mod.Evaluator, "__init__", init)


def _positions(evs) -> np.ndarray:
    return np.array([p[:4] for ev in evs for p in ev.positions], np.float64)


def test_probe_gives_run_device_fixes_and_jax_fixes(sky, preloaded):
    cfg, _, provider, n = sky
    res = probe_device_loop.probe(cfg, provider, n, 2, CPU)
    assert list(res["times"]) == list(probe_device_loop.PHASES)
    assert res["chunks"] == n and res["wall_s"] > 0
    assert "download holds the device's wait" in probe_device_loop.report(res)
    ev = tev.Evaluator(cfg)
    for epoch in Receiver(cfg, device=CPU).run_device(provider, n):
        ev.process(epoch)
    got = _positions([res["evaluator"]])
    assert len(got) > 100
    np.testing.assert_array_equal(got, _positions([ev]))

    jcfg = _jax(cfg)
    jax_ev = jev.Evaluator(jcfg)
    for epoch in JaxReceiver(jcfg).run_device(
            lambda first, m: jnp.asarray(provider(first, m).numpy()), n):
        jax_ev.process(epoch)
    want = _positions([jax_ev])
    assert len(want) == len(got)
    np.testing.assert_allclose(got[:, 1:4].mean(axis=0),
                               want[:, 1:4].mean(axis=0), rtol=0,
                               atol=MEAN_ATOL)


def test_evalhost_replay_gives_process_many_fixes(sky, preloaded, tmp_path):
    cfg, _, provider, n = sky
    streams = 2
    cfg_sv = profile_evalhost.serving_config(cfg, n)
    assert cfg_sv.chunks_per_download == n // 2
    pairs = profile_evalhost.capture(cfg_sv, provider, n, streams, CPU)
    kept = copy.deepcopy(pairs)
    evs = [tev.Evaluator(cfg_sv) for _ in range(streams)]
    for i in range(0, len(kept), streams):
        tev.process_many([(evs[s], epoch) for s, epoch in
                          copy.deepcopy(kept[i:i + streams])])
    want = _positions(evs)
    assert len(want) > 100
    for _ in range(2):          # a replay leaves the capture as it was
        got = _positions(profile_evalhost.replay(cfg_sv, pairs, streams))
        np.testing.assert_array_equal(got, want)
    res = profile_evalhost.host_cap(cfg_sv, pairs, streams, PROBE_SEC, 1)
    assert res["fixes"] == len(want) and res["host_cap"] > 0

    path = tmp_path / "epochs.pkl"
    key = ("torch", "cpu", PROBE_SEC, streams, cfg_sv.chunks_per_download)
    with open(path, "wb") as f:
        pickle.dump((key, pairs), f)
    assert len(profile_evalhost.load_capture(str(path), key)) == len(pairs)
    assert profile_evalhost.load_capture(str(path), key[:1] + ("cuda:0",)
                                         + key[2:]) is None
    with open(path, "wb") as f:         # what the JAX tool caches
        pickle.dump(((PROBE_SEC, streams, 8),
                     [(0, jev.EpochInput(0, [], {}))]), f)
    assert profile_evalhost.load_capture(str(path), key) is None
    assert profile_evalhost.load_capture(str(tmp_path / "none"), key) is None


# --- the scaling sweep -------------------------------------------------------

def _jax_rows(cfg, case, n_sh, warmup):
    """examples/scaling_sweep.py:108-150 on the case's blocks, at one
    shard count: (rows, {mode: outs})."""
    jcfg = _jax(cfg)
    blocks = jnp.asarray(case["blocks"].numpy())
    codes, ffts = case["codes"], case["ffts"]

    def fresh():
        st = jtrk.init_channel_states(jcfg, len(case["sats"]))
        for i, s in enumerate(case["sats"]):
            st = jtrk.reset_channel(st, i, s.prn, s.doppler,
                                    int(s.code_delay), jcfg)
        return st

    ref_states, ref_outs = jtrk.track_chunk(jcfg, fresh(), blocks,
                                            jnp.int32(1), jnp.asarray(codes),
                                            jnp.asarray(ffts))
    ref_cp = np.asarray(ref_outs.code_phase)
    rows, outs_by = [], {}
    local = blocks.shape[0] // n_sh
    for mode, kw, work in (
            ("exact_rescan", dict(n_stitch=n_sh), float(n_sh)),
            ("state_handoff", dict(warmup_blocks=warmup),
             1.0 + (min(warmup, local) / local if n_sh > 1 else 0.0))):
        mesh = jax_make_mesh(8, time_shards=n_sh)
        st0, cod, ff = jax_pad_channels(fresh(), codes, ffts,
                                        mesh.shape["ch"])
        st, outs = jax_track_sharded(jcfg, mesh, st0, blocks, jnp.int32(1),
                                     cod, ff, **kw)
        c = len(case["sats"])
        cp = np.asarray(outs.code_phase)[:, :c]
        both = (ref_cp >= 0) & (cp >= 0)
        rows.append({
            "time_shards": n_sh, "mode": mode,
            "work_scans_per_device": round(work, 3),
            "model_speedup": round(n_sh / work, 2),
            "code_phase_agreement": float(
                (np.abs(ref_cp - cp)[both] < 0.5).mean()),
            "lock_agreement": float((np.asarray(outs.locked)[:, :c]
                                     == np.asarray(ref_outs.locked)).mean()),
            "max_final_freq_err_hz": float(np.max(np.abs(
                np.asarray(st.freq)[:c] - np.asarray(ref_states.freq)))),
        })
        outs_by[mode] = outs
    return rows, outs_by


def test_scaling_rows_match_the_jax_tool():
    cfg = ReceiverConfig()
    case = scaling_sweep.stream_case(cfg, 4, 16, CPU)
    res = scaling_sweep.sweep_rows(cfg, case, ["cpu"] * 8, shard_counts=(2,),
                                   warmup=4, reps=0)
    want, jax_outs = _jax_rows(cfg, case, 2, 4)
    for got, w in zip(res["rows"], want, strict=True):
        for key in ("time_shards", "mode", "work_scans_per_device",
                    "model_speedup", "code_phase_agreement",
                    "lock_agreement"):
            assert got[key] == w[key], key
        # the exact stitch's final freq: tests/test_parallel.py's 1e-3 Hz;
        # the handoff's (a warm-up transient, ~2.5 Hz here in both
        # packages): the port's FRQ tolerance against JAX, 1e-2 Hz
        # (tests/test_torch_parallel.py: f32 rounding through the PLL)
        atol = 1e-3 if got["mode"] == "exact_rescan" else 1e-2
        assert abs(got["max_final_freq_err_hz"]
                   - w["max_final_freq_err_hz"]) <= atol
        outs = res["tracked"][2, got["mode"]][1]
        jo = jax_outs[got["mode"]]
        np.testing.assert_allclose(outs.code_phase.numpy(),
                                   np.asarray(jo.code_phase)[:, :4],
                                   atol=1e-4)
        np.testing.assert_array_equal(outs.locked.numpy(),
                                      np.asarray(jo.locked)[:, :4])
    assert res["rows"][0]["max_final_freq_err_hz"] <= 1e-3   # exact stitch
    # the work factor is the shard count, the warm-up and the local length
    assert scaling_sweep.work_scans(8, "exact_rescan", 4, 8) == 8.0
    assert scaling_sweep.work_scans(8, "state_handoff", 4, 8) == 1.5
    assert scaling_sweep.work_scans(2, "state_handoff", 64, 32) == 2.0
    assert scaling_sweep.work_scans(1, "state_handoff", 4, 64) == 1.0


# --- the device rule ---------------------------------------------------------

@pytest.mark.parametrize("tool", [roofline, probe_device_loop,
                                  profile_evalhost, profile_fullloop,
                                  profile_serving, scaling_sweep],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tool_without_cuda_raises(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {profile_evalhost: ["--cache", str(tmp_path / "c.pkl")],
            roofline: ["--out", str(tmp_path / "r.json")],
            scaling_sweep: ["--out", str(tmp_path / "s.json")]}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv.get(tool, []))
    assert list(tmp_path.iterdir()) == []
