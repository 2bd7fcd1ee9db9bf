"""The port's CLI modes beyond `replay`/`synth`/`serve`/`snapshot`: the
`epochs` fixture replay against the JAX CLI's, `eval` as a child process
on free UDP ports (its idle limit shortened in the child), `--role recv`
on the CPU feeding an EpochReceiver, `live` through a stand-in `rtlsdr`
module and without one, `--ui plot` under Agg and its events reaching
the Session, and --save-state/--resume-state refused with --role
recv|eval.  No socket here binds 61431 or 61432."""

import json
import sys
import time

import matplotlib
import numpy as np
import pytest
import torch

import chip_smoke
from gps_sdr_tpu.cli import main as jax_main
from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.kernel_profile import (free_udp_ports, start_eval,
                                              udp_port_bound)
from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                synth_stream)
from gps_sdr_tpu_torch.runtime import transport
from gps_sdr_tpu_torch.runtime.evaluator import EpochInput, Evaluator
from gps_sdr_tpu_torch.runtime.sources import (pack_iq, replay_blocks,
                                               unpack_iq)
from gps_sdr_tpu_torch.utils import io
from tests.test_cli_ui import epoch_records  # fixture  # noqa: F401

matplotlib.use("Agg")
torch.set_num_threads(2)

N_CYC = 8
N_BLOCKS = 20


def _positions(prefix):
    with open(f"{prefix}_gpsPos.json") as f:
        return np.asarray(json.load(f), np.float64)


@pytest.fixture(scope="module")
def capture_blocks():
    """20 blocks at n_cyc 8 (two satellites), quantized to the iq8
    capture format so a recording of them reads back exactly."""
    cfg = ReceiverConfig(n_cyc=N_CYC)
    sats = [SatSignal(prn=5, doppler=987.0, code_delay=770.5,
                      amplitude=0.25, nav_bits=random_bits(64, seed=5)),
            SatSignal(prn=12, doppler=-2210.0, code_delay=1500.0,
                      amplitude=0.25, nav_bits=random_bits(64, seed=12))]
    iq = synth_stream(cfg, sats, N_BLOCKS, noise_std=0.2, seed=9)
    return cfg, unpack_iq(pack_iq(iq))


def test_epochs_matches_jax(tmp_path, epoch_records):  # noqa: F811
    """`epochs` on tests/test_cli_ui.py's fixture (36 s, 6 satellites):
    the JAX CLI's positions within 1e-6 m, and the track and map files."""
    scn, records = epoch_records
    path = tmp_path / "epochs.pickle"
    io.save_epoch_records(str(path), records)
    argv = ["epochs", str(path), "--ui", "none", "--save-track",
            "--save-map"]
    assert jax_main(argv + ["--out", str(tmp_path / "jax")]) == 0
    assert cli.main(argv + ["--out", str(tmp_path / "port")]) == 0
    want, got = _positions(tmp_path / "jax"), _positions(tmp_path / "port")
    assert got.shape == want.shape and len(got) > 100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.linalg.norm(got[:, 1:].mean(axis=0) - scn.rec_ecef) < 5.0
    assert "leaflet" in (tmp_path / "port_map.html").read_text()
    assert (tmp_path / "port_track.gpx").exists()


def test_eval_child_on_free_ports(tmp_path, epoch_records):  # noqa: F811
    """`eval` in a child process on two free UDP ports (its idle limit
    set to 2 s in the child), fed by a port EpochSender: rc 0, every
    epoch received, and the positions of an in-process `epochs` run."""
    _, records = epoch_records
    path = tmp_path / "epochs.pickle"
    io.save_epoch_records(str(path), records)
    assert cli.main(["epochs", str(path), "--ui", "none", "--out",
                     str(tmp_path / "one")]) == 0
    data, ctrl = free_udp_ports(2)
    proc = start_eval(["eval", "--ui", "none", "--out",
                       str(tmp_path / "two")], data, ctrl, 2.0)
    try:
        tx = transport.EpochSender(data_port=data, ctrl_port=ctrl)
        for rec in records:
            tx.send(EpochInput(*rec))
            time.sleep(0.01)
        tx.close()
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert f"{len(records)} epochs received" in out
    np.testing.assert_array_equal(_positions(tmp_path / "two"),
                                  _positions(tmp_path / "one"))


def test_epochs_then_udp(tmp_path, monkeypatch, epoch_records):  # noqa: F811
    """`epochs --then-udp --max-sec 3`: the fixture's first 20 seconds
    from the file, the other 16 over UDP (the transport's ports patched)
    once the follow-up has bound its port; the positions of an `epochs`
    run of all 36."""
    import threading

    _, records = epoch_records
    full, head = tmp_path / "full.pickle", tmp_path / "head.pickle"
    io.save_epoch_records(str(full), records)
    io.save_epoch_records(str(head), records[:20])
    assert cli.main(["epochs", str(full), "--ui", "none", "--out",
                     str(tmp_path / "one")]) == 0
    data, ctrl = free_udp_ports(2)
    monkeypatch.setattr(transport, "DATA_PORT", data)
    monkeypatch.setattr(transport, "CTRL_PORT", ctrl)

    def send_rest():
        while not udp_port_bound(data):     # the follow-up's receiver
            time.sleep(0.02)
        tx = transport.EpochSender()
        for rec in records[20:]:
            tx.send(EpochInput(*rec))
            time.sleep(0.01)
        tx.close()

    sender = threading.Thread(target=send_rest)
    sender.start()
    try:
        assert cli.main(["epochs", str(head), "--then-udp", "--max-sec",
                         "3", "--ui", "none", "--out",
                         str(tmp_path / "two")]) == 0
    finally:
        sender.join(timeout=10)
    np.testing.assert_array_equal(_positions(tmp_path / "two"),
                                  _positions(tmp_path / "one"))


def test_recv_role_feeds_an_epoch_receiver(tmp_path, monkeypatch,
                                           capture_blocks):
    """`replay --role recv --device cpu` sends the epochs an in-process
    run records to an EpochReceiver on the transport's (patched)
    ports."""
    cfg, blocks = capture_blocks
    cap = tmp_path / "cap.bin"
    pack_iq(blocks).tofile(cap)
    rec = tmp_path / "ep.pickle"
    assert cli.main(["replay", str(cap), "--n-cyc", str(N_CYC), "--device",
                     "cpu", "--ui", "none", "--record-epochs",
                     str(rec)]) == 0
    want = io.load_epoch_records(str(rec))
    data, ctrl = free_udp_ports(2)
    monkeypatch.setattr(transport, "DATA_PORT", data)
    monkeypatch.setattr(transport, "CTRL_PORT", ctrl)
    rx = transport.EpochReceiver()
    try:
        assert cli.main(["replay", str(cap), "--n-cyc", str(N_CYC),
                         "--device", "cpu", "--ui", "none", "--role",
                         "recv"]) == 0
        got = []
        while (e := rx.recv()) is not None:
            got.append(e)
    finally:
        rx.close()
    # the in-process run's evaluator has since added EPH to its frames
    assert len(want) == len(got) == 1
    (skipped, frames, coph), e = want[0], got[0]
    assert e.skipped_samples == skipped
    assert e.frames == [{k: v for k, v in f.items() if k != "EPH"}
                        for f in frames]
    assert sorted(e.code_phases) == sorted(coph) == [5, 12]
    for prn, lst in coph.items():
        assert list(e.code_phases[prn]) == list(lst)


def test_recv_role_needs_a_gpu_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["replay", str(tmp_path / "x.bin"), "--role", "recv"])


def test_live_through_a_stand_in_rtlsdr(tmp_path, capture_blocks):
    """`live --gain-db 42 --record-iq F --max-sec` on the CPU through a
    stand-in rtlsdr: rc 0, both satellites tracked, the stand-in set as
    the live source sets a dongle, and F read back by replay_blocks to
    the same blocks."""
    cfg, blocks = capture_blocks
    rec_iq, rec = tmp_path / "live.bin", tmp_path / "ep.pickle"
    with chip_smoke.stand_in_rtlsdr(list(blocks)) as sdr:
        rc = cli.main(["live", "--n-cyc", str(N_CYC), "--device", "cpu",
                       "--ui", "none", "--gain-db", "42", "--max-sec",
                       str((N_BLOCKS + 0.5) * cfg.block_sec), "--record-iq",
                       str(rec_iq), "--record-epochs", str(rec)])
    assert rc == 0
    (dongle,) = sdr.opened
    assert (dongle.gain, dongle.sample_rate, dongle.center_freq) == (
        42.0, cfg.sample_rate, 1575.42e6)
    recs = io.load_epoch_records(str(rec))
    assert sorted({p for r in recs for p, v in r[2].items() if v}) == [5, 12]
    # replay_blocks yields the packed words: unpacked, the same blocks
    back = unpack_iq(np.stack(list(replay_blocks(str(rec_iq), cfg))))
    np.testing.assert_array_equal(back, blocks)


def test_live_without_pyrtlsdr(monkeypatch):
    monkeypatch.setitem(sys.modules, "rtlsdr", None)
    with pytest.raises(RuntimeError, match="pyrtlsdr"):
        cli.main(["live", "--device", "cpu", "--ui", "none", "--max-sec",
                  "1"])


def test_plot_ui_renders(tmp_path, epoch_records):  # noqa: F811
    """The port's PlotUI over the fixture's epochs under Agg: a PNG of the
    four quadrants and an HTML map; then `epochs --ui plot` runs."""
    from gps_sdr_tpu_torch.ui.plot import PlotUI

    _, records = epoch_records
    ev = Evaluator(ReceiverConfig())
    ui = PlotUI(interactive=False)
    for rec in records:
        epoch = EpochInput(*rec)
        ui.update(epoch.frames, ev.process(epoch), ev)
    png = tmp_path / "ui.png"
    ui.savefig(str(png))
    assert png.stat().st_size > 10_000
    html = ui.save_map(str(tmp_path / "m.html"))
    assert html and "leaflet" in open(html).read()
    ui.close()
    path = tmp_path / "epochs.pickle"
    io.save_epoch_records(str(path), records[:8])
    assert cli.main(["epochs", str(path), "--ui", "plot"]) == 0


def test_plot_ui_events_reach_the_session():
    """Sweep, the height entry, the height toggle, Clear, Stop and Close
    of the plot UI reach Session._handle_ui_events as in the JAX
    package."""
    import matplotlib.pyplot as plt

    from gps_sdr_tpu_torch.runtime.session import Session
    from gps_sdr_tpu_torch.ui.plot import PlotUI

    ui = PlotUI(interactive=False)
    s = Session(ReceiverConfig(n_cyc=N_CYC), device="cpu", reporter=ui)
    s.receiver.sweep_all = False
    s.evaluator.positions = [(0, 1.0, 2.0, 3.0)]
    conf = s.evaluator.cfg.conf_height
    ui._on_bt_sweep()
    ui._on_tb_height("146.5")
    ui._on_conf_height()
    ui._on_bt_clear()
    s._handle_ui_events()
    assert s.receiver.sweep_all
    assert s.evaluator.cfg.height == 146.5
    assert s.evaluator.cfg.conf_height is (not conf)
    assert s.evaluator.positions == [] and s.evaluator.stat is None
    ui._on_bt_stop()
    s._handle_ui_events()
    assert s.receiver._stop and plt.fignum_exists(ui.fig.number)
    ui._on_bt_close()
    s._handle_ui_events()
    assert not plt.fignum_exists(ui.fig.number)


@pytest.mark.parametrize("argv", [
    ["eval", "--save-state", "s.pkl"],
    ["synth", "--role", "recv", "--resume-state", "s.pkl"],
    ["replay", "x.bin", "--role", "eval", "--save-state", "s.pkl"],
])
def test_checkpoints_refused_with_two_processes(argv, capsys):
    assert cli.main(argv) == 2
    assert "only supported in the single-process topology" in \
        capsys.readouterr().err
