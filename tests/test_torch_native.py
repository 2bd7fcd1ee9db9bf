"""The port's native host core (nativecore.py, _evalcore.py,
models/_navscan.py, runtime/_native.py over gps_sdr_tpu_torch/csrc/*.cpp)
against the port's numpy paths, at tests/test_native.py's tolerances,
and against the JAX package's bindings on the same inputs: bit for bit
where the JAX package's libraries load (the same C++ built with the
same flags), at the same tolerances against its numpy paths otherwise.

Also: the sigma/slope binding takes a restored history longer than
max_hist + 1 (the JAX binding raises there), a build that fails raises
with the compiler's output, GSDR_EVALCORE=0 / GSDR_NAVSCAN=0 select the
numpy paths, chip_smoke.py's phase-10a check runs on the CPU, and the
port's process maps no library of gps_sdr_tpu/."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import chip_smoke
from gps_sdr_tpu_torch import _evalcore, nativecore
from gps_sdr_tpu_torch.config import GPS_C, ReceiverConfig
from gps_sdr_tpu_torch.models import _navscan, navmsg, orbits
from gps_sdr_tpu_torch.models.pseudorange import (EPHEM_KEYS,
                                                  PseudorangeEngine, ecef_mat,
                                                  max_slope)
from gps_sdr_tpu_torch.ops import _build
from gps_sdr_tpu_torch.ops.pvt import solve_fix_batch
from gps_sdr_tpu_torch.runtime import _native, buffer, sources
from gps_sdr_tpu_torch.runtime.evaluator import (unwrap_code_phases,
                                                 unwrap_numpy)
from tests.test_cli_ui import epoch_records  # fixture  # noqa: F401
from tests.test_native import _fix_problem, _synth_eph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_native(module: str):
    """The JAX package's binding module, or None where its library does
    not load."""
    try:
        import importlib
        return importlib.import_module(module)
    except ImportError:
        return None


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _ephs(n=64, seed=11):
    rng = np.random.default_rng(seed)
    mat = np.array([[e[k] for k in EPHEM_KEYS]
                    for e in (_synth_eph(rng) for _ in range(n))])
    tow = rng.integers(1, 100000, n).astype(np.float64)
    return tow, rng.uniform(-10, 10, n), mat


@pytest.mark.parametrize("rel", [True, False])
def test_ecef_matches_numpy_and_jax(monkeypatch, rel):
    tow, dt, mat = _ephs()
    got = _evalcore.ecef_batch(tow, dt, mat, rel)
    cols = {k: mat[:, i] for i, k in enumerate(EPHEM_KEYS)}
    want = orbits.ecef_coord(tow, cols, dt_from_tow=dt, rel_corr=rel)
    np.testing.assert_allclose(np.stack(got[:3]), np.stack(want[:3]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-18)
    # the dispatch point takes the native core unless switched off
    _same(ecef_mat(tow, dt, mat, rel), got)
    monkeypatch.setenv("GSDR_EVALCORE", "0")
    _same(ecef_mat(tow, dt, mat, rel), want)
    jcore = _jax_native("gps_sdr_tpu._evalcore")
    if jcore is not None:
        _same(jcore.ecef_batch(tow, dt, mat, rel), got)
    else:
        from gps_sdr_tpu.models import orbits as jorbits
        jw = jorbits.ecef_coord(tow, cols, dt_from_tow=dt, rel_corr=rel)
        np.testing.assert_allclose(np.stack(got[:3]), np.stack(jw[:3]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("height,rp0,crf", [
    (None, None, 0.0),
    (None, "per_epoch", 3e-6),
    (146.0, "shared", 0.0),
])
def test_fix_batch_matches_numpy_and_jax(monkeypatch, height, rp0, crf):
    rng = np.random.default_rng(5)
    E, n = 24, 7
    coords, delays, sig = _fix_problem(rng, E, n, pad=2)
    kw = dict(std_dev=sig, max_it=15, max_residual=1e-9 * 3e8 / 10,
              height=height, height_dev=1.0, clock_rate_fix=crf)
    if rp0 == "per_epoch":
        kw["rec_pos0"] = np.tile(
            np.array([0.0, 4156990.0, 606010.0, 4774980.0]), (E, 1))
    elif rp0 == "shared":
        kw["rec_pos0"] = np.array([0.0, 4156990.0, 606010.0, 4774980.0])
    got = solve_fix_batch(coords, delays, **kw)
    monkeypatch.setenv("GSDR_EVALCORE", "0")
    ref = solve_fix_batch(coords, delays, **kw)
    for name in ("pos", "range_est", "meas_delay", "res_m"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.cov, ref.cov, rtol=1e-6, atol=1e-9)
    assert np.all(np.abs(got.n_iter - ref.n_iter) <= 1)
    assert np.all(got.residual < 0.03) and np.all(ref.residual < 0.03)

    from gps_sdr_tpu.ops import pvt as jpvt
    jcore = _jax_native("gps_sdr_tpu._evalcore")
    monkeypatch.setenv("GSDR_EVALCORE", "1" if jcore else "0")
    jref = jpvt.solve_fix_batch(coords, delays, **kw)
    for name in ("pos", "range_est", "meas_delay", "res_m", "cov",
                 "n_iter", "residual"):
        if jcore is not None:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(jref, name))
        elif name not in ("n_iter", "residual"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(jref, name), rtol=1e-6,
                                       atol=1e-5)


def _sigma_calls(cfg, native, engine_cls):
    """test_native.py's sequential per-chunk calls of _sigma_and_slope:
    (outputs, final slope history)."""
    rng = np.random.default_rng(3)
    eng = engine_cls(5, cfg)
    outs, sno = [], 1
    for _ in range(12):
        k = int(rng.integers(2, 2 * cfg.no_sec))
        snos = sno + np.cumsum(rng.integers(1, 4, k))
        sno = int(snos[-1]) + int(rng.integers(1, 20))
        cps = 1000.0 + 0.003 * snos + rng.normal(0, 0.3, k)
        with pytest.MonkeyPatch.context() as m:
            m.setenv("GSDR_EVALCORE", "1" if native else "0")
            outs.append(eng._sigma_and_slope(snos, cps))
    return outs, list(eng.slope_hist)


def test_sigma_slope_matches_numpy_and_jax():
    cfg = ReceiverConfig()
    got, hist = _sigma_calls(cfg, True, PseudorangeEngine)
    ref, hist_ref = _sigma_calls(cfg, False, PseudorangeEngine)
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-12)
    for (sig, slp), (sig_p, slp_p) in zip(got, ref):
        np.testing.assert_allclose(sig, sig_p, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(slp, slp_p, rtol=1e-9, atol=1e-15)
    from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
    from gps_sdr_tpu.models.pseudorange import PseudorangeEngine as JaxEng
    jcore = _jax_native("gps_sdr_tpu._evalcore")
    jgot, jhist = _sigma_calls(JaxConfig(), jcore is not None, JaxEng)
    if jcore is not None:
        assert jhist == hist
        for a, b in zip(got, jgot):
            _same(a, b)
    else:
        np.testing.assert_allclose(jhist, hist, rtol=1e-12)


def test_sigma_slope_long_restored_history():
    """A slope history longer than max_hist + 1 (restored from a run at a
    smaller n_cyc) goes into the C++, which trims it one entry an append
    as the numpy walk does; the JAX binding's max_hist + 1 buffer raises
    before the C++ runs (the reference fault the port does not copy)."""
    cfg = ReceiverConfig()                        # max_hist 1024 // 32
    long_hist = list(np.linspace(-1e-4, 1e-4, 1024 // 8))
    rng = np.random.default_rng(8)
    snos = 1 + np.arange(3 * cfg.no_sec)
    cps = 500.0 + 0.002 * snos + rng.normal(0, 0.2, snos.size)
    args = (snos, cps, cfg.no_sec, cfg.n_cyc, max_slope(cfg),
            GPS_C / cfg.sample_rate)
    h_native = list(long_hist)
    sig, slp = _evalcore.sigma_slope(*args, h_native)
    eng = PseudorangeEngine(5, cfg)
    eng.slope_hist = list(long_hist)
    with pytest.MonkeyPatch.context() as m:
        m.setenv("GSDR_EVALCORE", "0")
        sig_p, slp_p = eng._sigma_and_slope(snos, cps)
    # 3 segments of more than 3 entries: three appends, three trims
    assert len(h_native) == len(long_hist)
    np.testing.assert_allclose(h_native, eng.slope_hist, rtol=1e-12)
    np.testing.assert_allclose(sig, sig_p * 1.0, rtol=1e-9, atol=1e-12)
    jcore = _jax_native("gps_sdr_tpu._evalcore")
    if jcore is not None:
        with pytest.raises(ValueError):
            jcore.sigma_slope(*args, list(long_hist))


def test_unwrap_matches_numpy_and_jax(monkeypatch):
    cfg = ReceiverConfig()
    cs = cfg.code_samples
    rng = np.random.default_rng(9)
    n = 400
    snos = 1 + np.cumsum(rng.integers(1, 3, n))
    cps = (2000.0 - 0.02 * np.arange(n) + rng.normal(0, 0.2, n)) % cs
    cps[137] += 40.0                                # an impossible step
    corr, flagged = _evalcore.unwrap(snos, cps, cs, 200)
    corr_p, flagged_p = unwrap_numpy(snos, cps, cs, 200)
    np.testing.assert_allclose(corr, corr_p, rtol=1e-12)
    np.testing.assert_array_equal(flagged, flagged_p)
    lst = list(zip(snos.tolist(), cps.tolist()))

    def run(native):
        err, log = {}, []
        monkeypatch.setenv("GSDR_EVALCORE", "1" if native else "0")
        cpl, err = unwrap_code_phases(5, list(lst), err, None, cfg, log)
        return cpl, err, log
    (cn, en, ln), (cp, ep, lp) = run(True), run(False)
    assert en == ep and ln == lp and len(lp) > 0
    np.testing.assert_allclose(cn.vals, cp.vals, rtol=1e-12)
    jcore = _jax_native("gps_sdr_tpu._evalcore")
    if jcore is not None:
        _same(jcore.unwrap(snos, cps, cs, 200), (corr, flagged))


def _nav_stream(rng, flip_prob, invert, corrupt_every):
    chunks = [((rng.integers(0, 2, rng.integers(5, 60)) * 2 - 1)
               .astype(np.int8))]
    for k in range(4):
        sub = navmsg.encode_subframe(1 if k % 2 == 0 else 3, {},
                                     tow=1000 + 6 * k)
        pm = (2 * sub - 1).astype(np.int8)
        if corrupt_every and k % corrupt_every == 1:
            pm[17] = -pm[17]
        chunks.append(pm)
    bits = np.concatenate(chunks)
    if invert:
        bits = (-bits).astype(np.int8)
    flips = rng.random(bits.shape[0]) < flip_prob
    return np.where(flips, -bits, bits).astype(np.int8)


def test_navscan_matches_numpy_and_jax(monkeypatch):
    """test_native.py's scanner cases: the native walk gives the numpy
    walk's subframes, ST anchors and buffer trim, and the JAX scanner's
    raw output."""
    rng = np.random.default_rng(7)
    jscan = _jax_native("gps_sdr_tpu.models._navscan")
    n_decoded = 0
    for case in range(12):
        bits = _nav_stream(rng, [0.0, 0.0, 0.002][case % 3], case % 2 == 1,
                           [0, 2][case % 2])
        outs = []
        for native in (True, False):
            nd = navmsg.NavDecoder(ngps=65536)
            nd.bits = bits.copy()
            nd.bits_st = np.arange(bits.shape[0], dtype=np.int64) * 1313
            monkeypatch.setenv("GSDR_NAVSCAN", "1" if native else "0")
            outs.append((nd._scan_buffer(), nd.bits.copy(),
                         nd.bits_st.copy()))
        (got, b_n, st_n), (want, b_p, st_p) = outs
        assert got == want
        np.testing.assert_array_equal(b_n, b_p)
        np.testing.assert_array_equal(st_n, st_p)
        n_decoded += len(got)
        raw = _navscan.navscan(bits, navmsg._TAPS_MAT, navmsg._SEED29,
                               navmsg._ID_SPAN)
        if jscan is not None:
            _same(raw[:2], jscan.navscan(bits, navmsg._TAPS_MAT,
                                         navmsg._SEED29,
                                         navmsg._ID_SPAN)[:2])
    assert n_decoded >= 20


def test_unpack_pack_file_match_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(0)
    words = rng.integers(0, 65536, size=10000, dtype=np.uint16)
    iq = _native.unpack_iq(words)
    np.testing.assert_array_equal(iq, sources.unpack_iq_numpy(words))
    np.testing.assert_array_equal(sources.unpack_iq(words), iq)
    np.testing.assert_array_equal(_native.pack_iq(iq), words)
    np.testing.assert_array_equal(_native.pack_iq(iq), sources.pack_iq(iq))
    path = tmp_path / "cap.bin"
    words.tofile(path)
    np.testing.assert_array_equal(_native.unpack_iq_file(str(path), 1024,
                                                         2048),
                                  sources.unpack_iq_numpy(words[1024:3072]))
    assert _native.unpack_iq_file(str(path), 9000, 2048) is None
    jnat = _jax_native("gps_sdr_tpu.runtime._native")
    if jnat is not None:
        np.testing.assert_array_equal(jnat.unpack_iq(words), iq)
        np.testing.assert_array_equal(jnat.pack_iq(iq), words)


def test_native_ring_concurrent_overflow():
    """test_native.py's producer/consumer race on a tiny ring: no torn
    block, every push delivered or counted skipped, order kept."""
    n_push, cap, blk = 3000, 4, 64
    ring = _native.NativeRing(capacity=cap, block_samples=blk)
    blocks = [np.full(blk, v + 0j, np.complex64) for v in range(n_push)]
    t = threading.Thread(target=lambda: [ring.push(b) for b in blocks])
    t.start()
    got, skips, done = [], 0, False
    while not done:
        done = not t.is_alive()
        while (r := ring.pop()) is not None:
            vals = np.unique(r[0].real)
            assert vals.size == 1
            got.append(int(vals[0]))
            skips += r[1]
    t.join()
    assert len(got) + skips == n_push
    assert got == sorted(got) and len(set(got)) == len(got)
    assert got[-1] == n_push - 1
    ring.close()
    assert isinstance(buffer.make_buffer(4, 16), buffer.RingBuffer)


def test_switches_select_numpy(monkeypatch):
    monkeypatch.setenv("GSDR_EVALCORE", "0")
    assert nativecore.native_evalcore() is False
    monkeypatch.setenv("GSDR_EVALCORE", "1")
    assert nativecore.native_evalcore() is _evalcore
    monkeypatch.setenv("GSDR_NAVSCAN", "0")
    assert navmsg._native_scan() is False
    monkeypatch.setenv("GSDR_NAVSCAN", "1")
    assert navmsg._native_scan() is _navscan.navscan


def test_failed_build_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    lib = tmp_path / "libbad.so"
    with pytest.raises(RuntimeError, match="bad.cpp") as err:
        _build.compile_libraries(
            {"bad": ([nativecore.CXX, *nativecore.CXX_FLAGS, str(bad)],
                     lib)})
    assert "error" in str(err.value) and not lib.exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_chip_smoke_native_check_on_cpu(epoch_records):  # noqa: F811
    """chip_smoke.py phase 10a on the CPU: the evaluator over
    tests/test_cli_ui.py's 36 recorded seconds (6 satellites), their
    ideal code phases given 0.05 samples of tracking noise (noise-free
    lines put sigma at the rounding floor of its variance, where the two
    paths' sums differ relatively by much more than 1e-9), with every
    native call recorded, then each held against the numpy path, the
    unpack and the ring, and the evaluator native against numpy."""
    from gps_sdr_tpu_torch.runtime.evaluator import EpochInput, Evaluator

    rng = np.random.default_rng(4)
    records = [(skip, frames, {prn: [(sno, cp + 0.05 * rng.standard_normal())
                                     for sno, cp in lst]
                               for prn, lst in coph.items()})
               for skip, frames, coph in epoch_records[1]]
    cfg = ReceiverConfig()
    with chip_smoke.record_native_calls() as calls, \
            chip_smoke.host_core(True):
        ev = Evaluator(cfg)
        for rec in records:
            ev.process(EpochInput(*rec))
    words = np.random.default_rng(1).integers(
        0, 65536, 8 * cfg.ngps, dtype=np.uint16)
    res = chip_smoke.check_native_core(cfg, calls, records, words)
    for name in ("ecef_batch", "sigma_slope", "unwrap", "solve_fix_batch"):
        assert res["calls"][name] > 0, name
    assert res["fixes"] > 100
    assert res["eval_ms_per_epoch_native"] > 0


def test_no_library_of_the_jax_package_in_the_process():
    """A fresh interpreter that calls every entry of the port's three
    libraries maps them and none under gps_sdr_tpu/, and holds no module
    of jax or gps_sdr_tpu."""
    code = """
import sys
import numpy as np
from gps_sdr_tpu_torch import _evalcore
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models import navmsg
from gps_sdr_tpu_torch.models.pseudorange import PseudorangeEngine
from gps_sdr_tpu_torch.ops.pvt import solve_fix_batch
from gps_sdr_tpu_torch.runtime import _native, buffer

rng = np.random.default_rng(0)
_evalcore.ecef_batch(np.ones(2), np.zeros(2), rng.random((2, 26)) + 1.0)
sats = rng.normal(size=(1, 3, 5)) * 2e7
solve_fix_batch(sats, np.full((1, 5), 0.07))
eng = PseudorangeEngine(5, ReceiverConfig())
eng._sigma_and_slope(np.arange(1, 40), rng.random(39))
_evalcore.unwrap(np.arange(1, 9), rng.random(8), 2048.0, 200.0)
navmsg._native_scan()(np.ones(400, np.int8), navmsg._TAPS_MAT,
                      navmsg._SEED29, navmsg._ID_SPAN)
_native.unpack_iq(np.zeros(4, np.uint16))
buffer.make_buffer(2, 8).push(np.zeros(8, np.complex64))
libs = sorted({line.split()[-1] for line in open("/proc/self/maps")
               if line.split()[-1].endswith(".so")})
print("JAX_LIBS", [p for p in libs if "/gps_sdr_tpu/" in p])
print("PORT_LIBS", len([p for p in libs
                        if "/build/gps_sdr_tpu_torch/libgsdr_" in p]))
print("FOREIGN", sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "gps_sdr_tpu")))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_LIBS []" in res.stdout, res.stdout
    assert "PORT_LIBS 3" in res.stdout, res.stdout
    assert "FOREIGN []" in res.stdout, res.stdout


def test_every_compiled_source_is_package_data():
    """An installed port builds its kernels (ops/_build.py) and its
    native host core (nativecore.py) from sources inside the package:
    each of them must match a package-data pattern of pyproject.toml."""
    import fnmatch
    import tomllib
    from pathlib import Path

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["gps_sdr_tpu_torch"]
    pkg = Path(nativecore.__file__).resolve().parent
    srcs = list(_build.sources().values()) + [
        Path(cmd[-1]) for cmd, _ in nativecore.host_jobs().values()]
    assert len(srcs) == len(_build.ENTRIES) + len(nativecore.HOST_SOURCES)
    for src in srcs:
        rel = src.resolve().relative_to(pkg).as_posix()
        assert src.exists(), rel
        assert any(fnmatch.fnmatch(rel, p) for p in patterns), rel
