"""The port's command line: `replay` through the port's Session (also of
a real-IF capture at 4x the rate, through the front end), `snapshot` at
a later block of a capture, and every mode, role and UI of the JAX CLI
reaching its runner.  `serve` and --save-state/--resume-state are tested
in tests/test_torch_checkpoint.py, `replay --input-rate` of an iq8
capture in tests/test_torch_frontend.py, the `snapshot` bars in
tests/test_torch_snapshot.py, and `epochs`, `eval`, --role recv, `live`
and --ui plot in tests/test_torch_cli_modes.py."""

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.runtime.sources import pack_iq

torch.set_num_threads(2)


def test_replay_runs_the_port_on_cpu(tmp_path, capsys):
    cfg = ReceiverConfig(n_cyc=8)
    sats = [SatSignal(prn=5, doppler=987.0, code_delay=770.5,
                      amplitude=0.25, nav_bits=random_bits(64, seed=5)),
            SatSignal(prn=12, doppler=-2210.0, code_delay=1500.0,
                      amplitude=0.25, nav_bits=random_bits(64, seed=12))]
    iq = synth_stream(cfg, sats, 20, noise_std=0.2, seed=9)
    path = tmp_path / "cap.bin"
    pack_iq(iq.reshape(-1)).tofile(path)
    rc = cli.main(["replay", str(path), "--n-cyc", "8", "--device", "cpu",
                   "--ui", "none", "--record-epochs",
                   str(tmp_path / "ep.pickle")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "processed" in out and "on cpu" in out
    from gps_sdr_tpu_torch.utils.io import load_epoch_records
    recs = load_epoch_records(str(tmp_path / "ep.pickle"))
    assert len(recs) == 1
    assert sorted(recs[0][2]) == [5, 12]          # code phases per PRN


@pytest.mark.parametrize("argv,runner", [
    (["synth", "--role", "eval"], "run_eval_process"),
    (["epochs", "x.pickle"], "run_in_process"),
    (["eval"], "run_eval_process"),
    (["live"], "run_in_process"),
    (["synth", "--role", "recv", "--ui", "plot"], "run_recv_process"),
    (["replay", "x.bin", "--role", "recv"], "run_recv_process"),
    (["replay", "x.bin", "--ui", "plot"], "run_in_process"),
    (["synth", "--ui", "plot"], "run_in_process"),
    (["live", "--role", "recv", "--ui", "plot"], "run_recv_process"),
])
def test_every_mode_reaches_its_runner(argv, runner, monkeypatch):
    """The argv the port once refused by name now reach the JAX CLI's
    runner for them: the evaluator half for `eval` and --role eval, the
    receiver half for --role recv, the Session otherwise."""
    called = []
    for name in ("run_eval_process", "run_recv_process", "run_in_process"):
        monkeypatch.setattr(cli, name,
                            lambda args, cfg, name=name: called.append(
                                (name, args)) or 0)
    assert cli.main(argv) == 0
    ((name, args),) = called
    assert name == runner
    assert args.ui == ("plot" if "plot" in argv else "headless")
    if args.mode in cli.DEVICE_MODES:
        assert args.device == "cuda"


def test_replay_real_if_input_rate(tmp_path, capsys):
    """`replay --input-rate 8192000 --input-if F --input-format real16`
    on the CPU: the DDC and the decimation turn a real-IF capture into
    2.048 MS/s blocks whose cold sweep finds the satellites."""
    from gps_sdr_tpu_torch.utils.io import load_epoch_records

    cfg = ReceiverConfig(n_cyc=8)
    hi_cfg = cfg.replace(code_samples=4 * cfg.code_samples)
    sats = [SatSignal(prn=5, doppler=1850.0, code_delay=1200.0,
                      nav_bits=random_bits(64, seed=5)),
            SatSignal(prn=29, doppler=400.0, code_delay=8188.0,
                      amplitude=0.9, nav_bits=random_bits(64, seed=29))]
    hi = synth_stream(hi_cfg, sats, 3, noise_std=0.3, seed=2).reshape(-1)
    fs_in, f_if = hi_cfg.sample_rate, 2.1e6
    t = np.arange(hi.size) / fs_in
    real_if = np.real(0.2 * hi * np.exp(2j * np.pi * f_if * t))
    path = tmp_path / "if.bin"
    (real_if * 32767).astype(np.int16).tofile(path)
    rec = str(tmp_path / "ep.pickle")
    rc = cli.main(["replay", str(path), "--n-cyc", "8", "--input-rate",
                   str(fs_in), "--input-if", str(f_if), "--input-format",
                   "real16", "--device", "cpu", "--ui", "none",
                   "--record-epochs", rec])
    out = capsys.readouterr().out
    assert rc == 0, out
    recs = load_epoch_records(rec)
    assert len(recs) == 1 and sorted(recs[0][2]) == [5, 29]


def test_snapshot_at_a_later_block(tmp_path, capsys):
    """`snapshot --start-stream 1` fixes from the capture's second block
    (its tow advanced by one block) within tests/test_snapshot.py's bars."""
    import re

    from gps_sdr_tpu_torch.models.scenario import make_scenario
    from gps_sdr_tpu_torch.models.scenario_dev import DeviceScenarioSynth
    from gps_sdr_tpu_torch.utils.io import save_ephemerides

    cfg = ReceiverConfig()
    scn = make_scenario(cfg, n_sats=7, duration_sec=4.0, seed=11)
    iq = DeviceScenarioSynth(scn, noise_std=0.6, seed=7,
                             device="cpu").chunk(7, 2).numpy()
    cap = tmp_path / "cap.bin"
    pack_iq(iq.reshape(-1)).tofile(cap)
    eph = tmp_path / "eph.json"
    save_ephemerides(str(eph), {s.prn: s.eph for s in scn.sats})
    t_rx7 = scn.t_rx0 + 7 * cfg.ngps / cfg.sample_rate
    lat, lon, h = scn.rec_geo
    rc = cli.main(["snapshot", str(cap), "--ephem-cache", str(eph),
                   "--prior-geo", f"{lat - 0.3},{lon + 0.3},{h}",
                   "--tow", str(t_rx7 + 20.0), "--start-stream", "1",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    m = re.search(r"snapshot fix: ([-\d.]+) deg, ([-\d.]+) deg", out)
    assert m, out
    assert abs(float(m.group(1)) - lat) < 0.002
    assert abs(float(m.group(2)) - lon) < 0.003


@pytest.mark.parametrize("argv", [["replay", "x.bin"], ["live"],
                                  ["synth"], ["serve", "synth"]])
def test_sample_rate_sets_code_samples(argv, monkeypatch):
    """--sample-rate 2.4e6 (an RTL-SDR's 2.4 MS/s) reaches each receiver
    mode's configuration as code_samples 2400; without it the
    configuration is the one the mode built before the flag."""
    got = []
    monkeypatch.setattr(cli, "run_in_process",
                        lambda args, cfg: got.append(cfg) or 0)
    monkeypatch.setattr(cli, "run_serve",
                        lambda args: got.append(cli.serve_config(args)) or 0)
    assert cli.main(argv + ["--sample-rate", "2.4e6"]) == 0
    assert cli.main(argv) == 0
    rate24, default = got
    assert (rate24.code_samples, rate24.sample_rate) == (2400, 2.4e6)
    assert rate24 == default.replace(code_samples=2400)
    if argv[0] == "serve":
        assert default == ReceiverConfig(
            n_cyc=32, max_sat=11, chunks_per_download=16,
            download_windows_in_flight=4, epoch_per_window=True)
    else:
        assert default == ReceiverConfig(n_cyc=32, max_sat=11)
        assert default.code_samples == ReceiverConfig().code_samples


@pytest.mark.parametrize("rate", ["2.401e6", "2002000", "0", "-2.4e6",
                                  "fast"])
@pytest.mark.parametrize("mode", [["replay", "x.bin"], ["serve", "synth"]])
def test_sample_rate_off_the_4khz_grid_is_refused(mode, rate, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(mode + [f"--sample-rate={rate}"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--sample-rate" in err
    assert ("multiple of 4 kHz" in err) or ("not a rate in Hz" in err)


def test_replay_at_2_4_msps_on_cpu(tmp_path, capsys):
    """`replay --sample-rate 2.4e6` of a capture recorded at 2.4 MS/s runs
    the port at code_samples 2400 and finds its satellites."""
    from gps_sdr_tpu_torch.utils.io import load_epoch_records

    cfg = ReceiverConfig(code_samples=2400, n_cyc=8)
    sats = [SatSignal(prn=7, doppler=-1320.0, code_delay=2310.5,
                      amplitude=0.25, nav_bits=random_bits(64, seed=7)),
            SatSignal(prn=21, doppler=2650.0, code_delay=415.0,
                      amplitude=0.25, nav_bits=random_bits(64, seed=21))]
    iq = synth_stream(cfg, sats, 20, noise_std=0.2, seed=9)
    path = tmp_path / "cap24.bin"
    pack_iq(iq.reshape(-1)).tofile(path)
    rec = str(tmp_path / "ep.pickle")
    rc = cli.main(["replay", str(path), "--n-cyc", "8", "--sample-rate",
                   "2.4e6", "--device", "cpu", "--ui", "none",
                   "--record-epochs", rec])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "processed" in out
    recs = load_epoch_records(rec)
    assert len(recs) == 1 and sorted(recs[0][2]) == [7, 21]
    for prn, delay in ((7, 2310.5), (21, 415.0)):
        cp = np.asarray(recs[0][2][prn])[:, 1]     # (block, code phase)
        assert cp.size and np.abs(cp - delay).max() < 2.0, (prn, cp)
