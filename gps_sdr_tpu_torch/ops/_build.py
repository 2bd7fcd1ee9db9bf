"""Build and load the port's CUDA kernels.

`nvcc` compiles each gps_sdr_tpu_torch/csrc/<name>.cu for sm_90a into a
shared library of its own with a plain C interface, at first CUDA use,
under build/gps_sdr_tpu_torch/ at the repository root; the compilers of
all sources that need building run at the same time.  A library's name
carries a hash of its source and the flags, so an edited source rebuilds
and an unchanged one is reused.  Each is loaded with ctypes; a kernel's
wrapper passes one argument struct (mirrored below field for field from
the .cu sources) and the current CUDA stream, and the C entry returns
cudaGetLastError(), which `check` turns into an exception.  Nothing is
built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gps_sdr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p


class WipeoffArgs(ctypes.Structure):
    """csrc/wipeoff.cu struct WipeoffArgs."""

    _fields_ = [(name, _P) for name in (
        "chunk", "codes", "s", "snp", "phase", "wipe", "center", "head",
        "seg")] + [(name, ctypes.c_int) for name in (
            "n_ch", "k", "step", "n_cyc", "cs", "corr_avg")]


class WipeoffVpuArgs(ctypes.Structure):
    """csrc/wipeoff_vpu.cu struct WipeoffVpuArgs."""

    _fields_ = [(name, _P) for name in (
        "chunk", "codes", "s", "snp", "phase", "wipe", "center", "head",
        "seg")] + [(name, ctypes.c_int) for name in (
            "n_ch", "k", "step", "n_cyc", "cs", "corr_avg")]


class CheapState(ctypes.Structure):
    """csrc/cheap.cu struct CheapState."""

    _fields_ = [(name, _P) for name in (
        "carry_sum", "carry_cnt", "sign0", "prev_sign", "prev_signal",
        "ms_time", "std_dev", "locked", "df_buf", "df_cnt", "df_idx",
        "corr_buf", "corr_cnt", "corr_idx")]


class CheapArgs(ctypes.Structure):
    """csrc/cheap.cu struct CheapArgs."""

    _fields_ = [(name, _P) for name in ("head", "seg", "delay", "wipe")] + [
        ("state_in", CheapState), ("state_out", CheapState)] + [
        (name, _P) for name in (
            "dphi", "df_sum", "amplitude", "corr_q", "corr_l", "locked_seq",
            "sign0_seq", "edge_ms", "edge_local", "edge_valid")] + [
        (name, ctypes.c_int) for name in (
            "n_ch", "k", "n_cyc", "cs", "no_sec", "hist", "offset_avg")] + [
        (name, ctypes.c_float) for name in (
            "sample_rate", "edge_sigma", "gain_locked", "gain_unlocked",
            "lock_threshold", "max_df", "phase_jump", "t_blk")]


# source name -> (C entry, its argument struct)
ENTRIES = {"wipeoff": ("gsdr_wipeoff_launch", WipeoffArgs),
           "wipeoff_vpu": ("gsdr_wipeoff_vpu_launch", WipeoffVpuArgs),
           "cheap": ("gsdr_cheap_launch", CheapArgs)}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default
    /usr/local/cuda, the toolkit's standard location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH "
                           "or set CUDA_HOME")
    return str(path)


def sources() -> dict[str, Path]:
    """Kernel name -> its source, for every entry of ENTRIES."""
    return {name: CSRC / f"{name}.cu" for name in ENTRIES}


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libgsdr_{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> tuple[dict[str, Path], float]:
    """Compile every kernel library that is missing for the current
    sources, one nvcc per source, all started together.  Returns (kernel
    name -> library path, wall seconds spent compiling).  Each
    compiler's output (with ptxas register/shared-memory use) goes to
    <library>.log."""
    libs = {name: library_path(src) for name, src in sources().items()}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        lib = todo[name]
        lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load() -> dict[str, ctypes.CDLL]:
    """Kernel name -> its library, all built on first use, with their C
    signatures."""
    libs = {}
    for name, path in build()[0].items():
        lib = ctypes.CDLL(str(path))
        entry, args = ENTRIES[name]
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(args), _P]
        fn.restype = ctypes.c_int
        lib.gsdr_error_string.argtypes = [ctypes.c_int]
        lib.gsdr_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def launch(name: str, args: ctypes.Structure, device) -> None:
    """Launch kernel `name` with `args` on the current stream of
    `device`; raise if the C entry returns a CUDA error."""
    import torch

    lib = load()[name]
    entry = ENTRIES[name][0]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(ctypes.byref(args), stream)
    if rc != 0:
        msg = lib.gsdr_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
