"""The port's command line: `replay` through the port's Session, and
clear errors for what is not ported yet (never a route to JAX).  `serve`
and --save-state/--resume-state are tested in
tests/test_torch_checkpoint.py."""

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


@pytest.mark.parametrize("argv", [
    ["synth", "--role", "eval"],
    ["epochs", "x.pickle"],
    ["eval"],
    ["live"],
    ["snapshot", "x.bin", "--ephem-cache", "e.json", "--prior-geo",
     "1,2,3", "--tow", "0"],
    ["replay", "x.bin", "--role", "recv"],
    ["replay", "x.bin", "--ui", "plot"],
    ["synth", "--ui", "plot"],
    ["replay", "x.bin", "--input-rate", "4096000"],
])
def test_not_ported_is_an_error(argv, capsys):
    assert cli.main(argv) == 2
    assert "not yet ported" in capsys.readouterr().err
