"""The PyTorch port loads neither JAX nor the JAX package, and never
falls back to the CPU.

Importing gps_sdr_tpu_torch and every one of its modules must leave
`jax` and every `gps_sdr_tpu` module out of sys.modules (checked in a
fresh interpreter, since this test process has both loaded): the port
keeps its own copy of the host modules it needs, and its native host
core maps no library of the JAX package.  chip_smoke.py imports only the
standard library, torch, numpy and the port.  Asking for CUDA
where there is none must raise instead of running on the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import gps_sdr_tpu_torch
from gps_sdr_tpu_torch.config import ReceiverConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    names = [m.name for m in pkgutil.walk_packages(
        gps_sdr_tpu_torch.__path__, "gps_sdr_tpu_torch.")
        if m.name != "gps_sdr_tpu_torch.__main__"]
    return ["gps_sdr_tpu_torch"] + sorted(names)


def test_every_module_imports_without_jax():
    mods = _all_modules()
    for m in ("ops.hopper_cheap", "ops.hopper_wipeoff", "runtime.session",
              "runtime.evaluator", "runtime.serving", "runtime.checkpoint",
              "models.scenario_dev", "models.navmsg", "ops.pvt",
              "utils.profiling", "cli", "parallel", "parallel.mesh",
              "parallel.acquisition", "parallel.tracking", "bench",
              "examples.soak", "examples.endurance",
              "examples.synthetic_fix", "examples.analysis"):
        assert f"gps_sdr_tpu_torch.{m}" in mods
    assert "gps_sdr_tpu_torch.host" not in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'gps_sdr_tpu'))\n"
            "print('FOREIGN_MODULES', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "FOREIGN_MODULES []" in res.stdout, res.stdout


def test_port_loads_nothing_of_the_jax_package_nor_optional_packages():
    """Every module of the port imported and its native host core built
    and loaded, in a fresh interpreter: the process maps the port's
    three host libraries and no library under gps_sdr_tpu/ (the JAX
    package's libgsdreval, libgsdrnav, libgstingest), and holds no
    module of jax, gps_sdr_tpu, matplotlib (--ui plot only) or rtlsdr
    (`live` only)."""
    mods = _all_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from gps_sdr_tpu_torch import nativecore\n"
            "for name in nativecore.HOST_SOURCES:\n"
            "    nativecore.load_native_lib(name)\n"
            "libs = {l.split()[-1] for l in open('/proc/self/maps')\n"
            "        if l.split()[-1].endswith('.so')}\n"
            "print('JAX_LIBS', sorted(p for p in libs\n"
            "                         if '/gps_sdr_tpu/' in p))\n"
            "print('PORT_LIBS', sum('/build/gps_sdr_tpu_torch/' in p\n"
            "                       for p in libs))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'gps_sdr_tpu', 'matplotlib', 'rtlsdr'))\n"
            "print('FOREIGN_MODULES', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_LIBS []" in res.stdout, res.stdout
    assert "PORT_LIBS 3" in res.stdout, res.stdout
    assert "FOREIGN_MODULES []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", ["gps_sdr_tpu_torch.parallel",
                                    "gps_sdr_tpu_torch.utils.profiling",
                                    "gps_sdr_tpu_torch.bench",
                                    "gps_sdr_tpu_torch.examples.soak",
                                    "gps_sdr_tpu_torch.examples.endurance",
                                    "gps_sdr_tpu_torch.examples.synthetic_fix",
                                    "gps_sdr_tpu_torch.examples.analysis"])
def test_sharding_and_profiling_import_without_jax(module):
    """The sharding slice, the profiler, the bench and the long-run
    tools, each imported alone in a fresh interpreter, load no module of
    jax or gps_sdr_tpu."""
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'gps_sdr_tpu'))\n"
            "print('FOREIGN_MODULES', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "FOREIGN_MODULES []" in res.stdout, res.stdout


def test_mesh_cuda_raises_without_cuda(monkeypatch):
    from gps_sdr_tpu_torch.parallel.mesh import make_mesh, make_stream_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(4, devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_stream_mesh(2, devices=["cuda:0", "cuda:1"])


def test_chip_smoke_imports_only_the_port():
    """Every import in chip_smoke.py, at any depth, is of the standard
    library, torch, numpy or gps_sdr_tpu_torch."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            roots.add(node.module.split(".")[0])
    assert {"torch", "gps_sdr_tpu_torch"} <= roots
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy",
                                              "gps_sdr_tpu_torch"}
    assert roots <= allowed, sorted(roots - allowed)


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
