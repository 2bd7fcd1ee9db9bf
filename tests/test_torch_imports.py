"""The PyTorch port loads no JAX, and never falls back to the CPU.

Importing gps_sdr_tpu_torch and every one of its modules must leave
`jax` out of sys.modules (checked in a fresh interpreter, since this
test process has JAX loaded), and asking for CUDA where there is none
must raise instead of running on the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import gps_sdr_tpu_torch
from gps_sdr_tpu.config import ReceiverConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    names = [m.name for m in pkgutil.walk_packages(
        gps_sdr_tpu_torch.__path__, "gps_sdr_tpu_torch.")
        if m.name != "gps_sdr_tpu_torch.__main__"]
    return ["gps_sdr_tpu_torch"] + sorted(names)


def test_every_module_imports_without_jax():
    mods = _all_modules()
    assert "gps_sdr_tpu_torch.ops.hopper_cheap" in mods
    assert "gps_sdr_tpu_torch.runtime.session" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.'))\n"
            "print('JAX_MODULES', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_MODULES []" in res.stdout, res.stdout


def test_receiver_cuda_raises_without_cuda(monkeypatch):
    from gps_sdr_tpu_torch.runtime.receiver import Receiver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Receiver(ReceiverConfig(), device="cuda")


def test_resolve_device_rules(monkeypatch):
    from gps_sdr_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain twin only for CPU tensors; any other
    device is refused rather than routed to the plain version."""
    from gps_sdr_tpu_torch.ops import hopper_cheap, hopper_wipeoff

    cfg = ReceiverConfig(code_samples=256, n_cyc=8, blocks_per_step=4)
    meta = torch.empty((4, cfg.ngps), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="no path"):
        hopper_wipeoff.mix_wipeoff(cfg, 4, None, None, None, None, meta, 0,
                                   None)
    with pytest.raises(ValueError, match="no path"):
        hopper_cheap.cheap_scan(cfg, 4, meta, None, None, None, None)
