"""Mid-run checkpoint / resume of the port (runtime/checkpoint.py) and the
CLI's `serve`, --save-state and --resume-state.

  * the state arrays of a port checkpoint are the JAX package's
    pack_states of the same state, exactly, and load back exactly;
  * a Session saved mid-run, loaded and continued gives the epochs of
    an uninterrupted run, exactly, and the same evaluator results;
  * a StreamServer saved mid-run (save_server / load_server) and run on
    gives the code-phase series and subframes of an uninterrupted run,
    exactly (the counterpart of tests/test_checkpoint.py's server test);
  * a checkpoint of another format version is refused;
  * `serve --resume-state` continues at the checkpoint's stream block
    with the checkpoint's config (not the CLI's shape flags), and
    `replay --resume-state` continues the capture where the saved run
    stopped.
All on the CPU at the small test configuration."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_sdr_tpu.ops import tracking as jtrk
from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.models.scenario import make_scenario
from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
from gps_sdr_tpu_torch.models.simulator import synth_stream
from gps_sdr_tpu_torch.ops import tracking as ttrk
from gps_sdr_tpu_torch.runtime import checkpoint
from gps_sdr_tpu_torch.runtime.evaluator import Evaluator
from gps_sdr_tpu_torch.runtime.receiver import Receiver
from gps_sdr_tpu_torch.runtime.serving import StreamServer
from gps_sdr_tpu_torch.runtime.session import Session
from gps_sdr_tpu_torch.runtime.sources import pack_iq
from tests.test_torch_device_path import CFG, SATS, _jax
from tests.test_torch_serving import IQ

torch.set_num_threads(2)

T = 24                  # blocks per chunk of the serving runs


def test_payload_states_are_jax_pack_states():
    jcfg = _jax(CFG)
    st = jtrk.init_channel_states(jcfg, 2)
    st = jtrk.reset_channel(st, 0, 5, 1234.0, 100, jcfg)
    st = jtrk.reset_channel(st, 1, 21, -3100.0, 200, jcfg)
    # the hi/lo counter split past f32's exact 2^24
    st = st._replace(
        ms_time=jnp.asarray([40_000_000, 17_000_001], jnp.int32),
        prev_stream=jnp.asarray([20_000_000, 3], jnp.int32),
        carry_sum=jnp.asarray([1.5 - 2.25j, -0.125 + 7j], jnp.complex64))
    want = {k: np.asarray(v) for k, v in jtrk.pack_states(st).items()}
    rx = Receiver(CFG, device="cpu")
    rx.states = ttrk.states_from_numpy(want, "cpu")
    got = checkpoint._receiver_payload(rx)["states_f32"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = jtrk.unpack_states({k: jnp.asarray(v) for k, v in got.items()})
    for name in st._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(st, name)))


def _epoch_key(e):
    return (e.skipped_samples,
            sorted((sat, tuple(map(tuple, lst)))
                   for sat, lst in e.code_phases.items()),
            [sorted(sf.items()) for sf in e.frames])


def test_session_resume_continues_identically(tmp_path):
    cfg = CFG.replace(max_sat=3)
    blocks = synth_stream(cfg, SATS, 1 + 2 * cfg.no_sec + 40,
                          noise_std=0.2, seed=9)
    path = str(tmp_path / "session.pkl")

    ref = Session(cfg, device="cpu")
    ref_epochs = list(ref.receiver.run(iter(blocks)))
    for e in ref_epochs:
        ref._consume(e)

    # interrupted after the first epoch (the cold sweep took block 0)
    s1 = Session(cfg, device="cpu")
    gen = s1.receiver.run(iter(blocks))
    got = [next(gen)]
    s1._consume(got[0])
    gen.close()
    consumed = s1.receiver.status.stream_no
    checkpoint.save_session(s1, path)

    s2 = checkpoint.load_session(path, device="cpu")
    assert s2.cfg == cfg and s2.receiver.device.type == "cpu"
    for e in s2.receiver.run(iter(blocks[consumed:])):
        s2._consume(e)
        got.append(e)
    assert len(got) == len(ref_epochs) == 3
    for a, b in zip(ref_epochs, got):
        assert _epoch_key(a) == _epoch_key(b)
    assert s2.receiver.status == ref.receiver.status
    assert s2.evaluator.sat_results == ref.evaluator.sat_results
    assert s2.evaluator.positions == ref.evaluator.positions
    assert len(s2.summaries) == len(ref.summaries)


def _collect(server, providers, n_chunks, out):
    """Per stream: the code-phase series and the nav-field frames of the
    subframes (AMP/CN0/CRM/FRQ are sampled at a window's last block,
    which moves when a checkpoint shifts the window boundaries)."""
    skip = {"AMP", "CN0", "CRM", "FRQ", "SWP", "EPH"}
    for s, epoch in server.run(providers, n_chunks, chunk_blocks=T):
        for sat, lst in epoch.code_phases.items():
            out[s]["coph"].setdefault(sat, []).extend(
                (int(n), float(c)) for n, c in lst)
        out[s]["frames"] += [tuple(sorted(
            (k, v) for k, v in sf.items()
            if k not in skip and isinstance(v, (int, float, str, bool))))
            for sf in epoch.frames if "ID" in sf]
    return out


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared", "independent"])
def test_server_resume_matches_uninterrupted(tmp_path, shared):
    cfg = CFG.replace(chunks_per_download=2, download_windows_in_flight=2,
                      epoch_per_window=True)
    n_chunks, half = 5, 2
    iq = [IQ[0]] * 2 if shared else IQ

    def providers(offset):
        provs = [lambda f, n, x=x: torch.from_numpy(
            x[offset * T + f:offset * T + f + n]) for x in iq]
        return provs[0] if shared else provs

    def empty():
        return [{"coph": {}, "frames": []} for _ in range(2)]

    ref = StreamServer(cfg, 2, device="cpu")
    want = _collect(ref, providers(0), n_chunks, empty())

    s1 = StreamServer(cfg, 2, device="cpu")
    got = _collect(s1, providers(0), half, empty())
    path = str(tmp_path / "server.pkl")
    evs = [Evaluator(cfg), Evaluator(cfg)]
    checkpoint.save_server(s1, evs, path)
    s2, evs2 = checkpoint.load_server(path, device="cpu")
    assert s2.cfg == cfg and len(evs2) == 2
    assert [r.status for r in s2.receivers] == [r.status
                                                for r in s1.receivers]
    got = _collect(s2, providers(half), n_chunks - half, got)
    for s in range(2):
        assert set(got[s]["coph"]) == set(want[s]["coph"]) \
            == ({5, 12} if shared or s == 0 else {7, 21})
        for sat in want[s]["coph"]:
            assert got[s]["coph"][sat] == want[s]["coph"][sat], (s, sat)
        assert got[s]["frames"] == want[s]["frames"]
    for a, b in zip(s2.receivers, ref.receivers):
        assert a.status == b.status
        for x, y in zip(a.states, b.states):
            assert torch.equal(x, y)


# fields that ReceiverConfig had once, each at a value a saved run set
REMOVED_FIELDS = {"use_pallas_kernels": False, "use_pallas_cheap": False,
                  "fused_window_dispatch": True, "defer_subframe_poll": True}


@pytest.mark.parametrize("loader", ["load_session", "load_server"])
def test_checkpoint_with_removed_config_fields_loads(tmp_path, loader):
    """A checkpoint whose pickled config still carries fields that the
    config no longer has loads, under the config of today's fields."""
    cfg = CFG.replace(chunks_per_download=2)
    old = cfg.replace()
    for name, value in REMOVED_FIELDS.items():
        object.__setattr__(old, name, value)
    path = str(tmp_path / "old.pkl")
    if loader == "load_session":
        session = Session(old, device="cpu")
        checkpoint.save_session(session, path)
        got = checkpoint.load_session(path, device="cpu").cfg
    else:
        server = StreamServer(old, 2, device="cpu")
        checkpoint.save_server(server, [Evaluator(old)] * 2, path)
        got, evs = checkpoint.load_server(path, device="cpu")
        assert len(got.receivers) == len(evs) == 2
        got = got.cfg
    with open(path, "rb") as f:
        assert set(REMOVED_FIELDS) <= set(vars(pickle.load(f)["cfg"]))
    assert got == cfg
    assert not set(REMOVED_FIELDS) & set(vars(got))


def test_wrong_version_raises(tmp_path):
    path = str(tmp_path / "v1.pkl")
    with open(path, "wb") as f:
        pickle.dump({"version": 1}, f)
    with pytest.raises(ValueError, match="checkpoint version"):
        checkpoint.load_session(path, device="cpu")
    with pytest.raises(ValueError, match="checkpoint version"):
        checkpoint.load_server(path, device="cpu")


@pytest.mark.parametrize("loader", ["load_session", "load_server"])
def test_jax_written_checkpoint_refused(tmp_path, loader):
    """A checkpoint the JAX package wrote holds gps_sdr_tpu objects: the
    port's loader raises a ValueError naming the JAX package, and in a
    fresh interpreter neither gps_sdr_tpu nor jax has been imported by
    the time it has."""
    import os
    import subprocess
    import sys

    from gps_sdr_tpu.runtime.checkpoint import save_session as jax_save
    from gps_sdr_tpu.runtime.session import Session as JaxSession

    path = str(tmp_path / "jax.pkl")
    jax_save(JaxSession(_jax(CFG)), path)
    code = ("import sys\n"
            "from gps_sdr_tpu_torch.runtime import checkpoint\n"
            "try:\n"
            f"    checkpoint.{loader}({path!r}, device='cpu')\n"
            "except ValueError as e:\n"
            "    print('REFUSED', e)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'gps_sdr_tpu'))\n"
            "print('FOREIGN_MODULES', bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "REFUSED checkpoint holds gps_sdr_tpu." in res.stdout, res.stdout
    assert "written by the JAX package" in res.stdout
    assert "FOREIGN_MODULES []" in res.stdout, res.stdout


SERVE_SEC, SERVE_SATS, SERVE_SEED, SERVE_NOISE = 3.2, 3, 3, 0.5


def test_serve_resume_continues_at_the_saved_block(tmp_path, capsys,
                                                   monkeypatch):
    """A server checkpoint at the small configuration, one chunk in;
    `serve synth --resume-state` with other shape flags must build its
    chunks with the checkpoint's config and ask the synthesis for the
    blocks after the saved ones, not for block 0."""
    cfg = CFG.replace(max_sat=4, chunks_per_download=2,
                      download_windows_in_flight=4,
                      epoch_per_window=True)
    t = cfg.no_sec
    scn = make_scenario(cfg, n_sats=SERVE_SATS, seed=SERVE_SEED,
                        duration_sec=SERVE_SEC + 12.0)
    synth = DeviceScenarioSynth(scn, noise_std=SERVE_NOISE,
                                knot_interp_step=0.1, device="cpu")
    srv = StreamServer(cfg, 2, device="cpu")
    list(srv.run(synth.chunk_planar, 1))
    assert srv.receivers[0].status.stream_no == t
    path = str(tmp_path / "serve.pkl")
    checkpoint.save_server(srv, [Evaluator(cfg), Evaluator(cfg)], path)

    calls = []
    real = DeviceScenarioSynth.chunk_planar

    def recording(self, first, n):
        calls.append((self.scn.cfg, first, n))
        return real(self, first, n)

    monkeypatch.setattr(DeviceScenarioSynth, "chunk_planar", recording)
    again = str(tmp_path / "again.pkl")
    rc = cli.main(["serve", "synth", "--resume-state", path, "--streams",
                   "5", "--n-cyc", "32", "--sec", str(SERVE_SEC),
                   "--sats", str(SERVE_SATS), "--seed", str(SERVE_SEED),
                   "--noise", str(SERVE_NOISE), "--device", "cpu",
                   "--save-state", again])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"continue at stream block {t}" in out
    assert "ignoring --streams 5" in out
    assert "stream 0:" in out and "stream 1:" in out
    assert "2 streams x 2.0 s" in out and "aggregate realtime" in out
    assert calls and all(c[0] == cfg for c in calls)
    assert calls[0][1] == t
    assert sum(n for _, _, n in calls) == 2 * t     # the two chunks left
    srv2, evs = checkpoint.load_server(again, device="cpu")
    assert srv2.cfg == cfg and len(evs) == 2
    assert [r.status.stream_no for r in srv2.receivers] == [3 * t, 3 * t]


def test_serve_source_of_a_capture(tmp_path):
    """serve_source on a .bin capture: the capture's whole chunks from
    the given block on, grouped planar."""
    from gps_sdr_tpu_torch.runtime.sources import replay_blocks

    t = CFG.no_sec
    blocks = synth_stream(CFG, SATS, 2 * t + 5, noise_std=0.2, seed=9)
    path = tmp_path / "cap.bin"
    pack_iq(blocks.reshape(-1)).tofile(path)
    read = ttrk.to_grouped_planar(CFG, torch.from_numpy(np.stack(list(
        replay_blocks(str(path), CFG)))))
    args = cli.build_parser().parse_args(["serve", str(path), "--device",
                                          "cpu"])
    cpu = torch.device("cpu")
    provider, n_chunks, truth = cli.serve_source(args, CFG, 0, cpu)
    assert truth is None and n_chunks == 2
    assert torch.equal(provider(t, t), read[t:2 * t])
    provider, n_chunks, _ = cli.serve_source(args, CFG, t, cpu)
    assert n_chunks == 1
    assert torch.equal(provider(0, t), read[t:2 * t])


def test_cli_replay_save_and_resume(tmp_path, capsys):
    """replay --save-state, then --resume-state: the resumed run starts
    at the block the first one stopped at and keeps tracking without a
    new cold sweep."""
    from gps_sdr_tpu_torch.config import ReceiverConfig
    from gps_sdr_tpu_torch.models.simulator import SatSignal, random_bits
    from gps_sdr_tpu_torch.utils.io import load_epoch_records

    cfg = ReceiverConfig(n_cyc=8)
    sats = [SatSignal(prn=5, doppler=987.0, code_delay=770.5,
                      amplitude=0.25, nav_bits=random_bits(64, seed=5)),
            SatSignal(prn=12, doppler=-2210.0, code_delay=1500.0,
                      amplitude=0.25, nav_bits=random_bits(64, seed=12))]
    iq = synth_stream(cfg, sats, 20, noise_std=0.2, seed=9)
    cap = tmp_path / "cap.bin"
    pack_iq(iq.reshape(-1)).tofile(cap)
    ck = str(tmp_path / "state.pkl")
    base = ["replay", str(cap), "--n-cyc", "8", "--device", "cpu", "--ui",
            "none"]
    assert cli.main(base + ["--max-sec", str(10.5 * cfg.block_sec),
                            "--save-state", ck]) == 0
    assert "checkpoint saved" in capsys.readouterr().out
    rec = str(tmp_path / "ep.pickle")
    assert cli.main(base + ["--n-cyc", "16", "--resume-state", ck,
                            "--record-epochs", rec]) == 0
    out = capsys.readouterr().out
    assert "continuing at stream block 10" in out
    assert "using checkpoint n_cyc=8" in out
    recs = load_epoch_records(rec)
    assert len(recs) == 1
    assert sorted(recs[0][2]) == [5, 12]
    snos = [int(n) for n, _ in recs[0][2][5]]
    assert snos and all(11 <= n <= 20 for n in snos)
