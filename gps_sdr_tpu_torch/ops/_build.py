"""Build and load the port's CUDA kernels.

`nvcc` compiles every gps_sdr_tpu_torch/csrc/*.cu for sm_90a into one
shared library with a plain C interface, at first CUDA use, under
build/gps_sdr_tpu_torch/ at the repository root.  The library name
carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.  It is loaded with ctypes; a kernel's
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

    _fields_ = [("chunk", _P), ("codes", _P), ("s", _P), ("snp", _P),
                ("phase", _P), ("wipe", _P), ("center", _P), ("head", _P),
                ("seg", _P), ("n_ch", ctypes.c_int), ("k", ctypes.c_int),
                ("step", ctypes.c_int), ("n_cyc", ctypes.c_int),
                ("cs", ctypes.c_int), ("corr_avg", ctypes.c_int)]


class CheapArgs(ctypes.Structure):
    """csrc/cheap.cu struct CheapArgs."""

    _fields_ = [(name, _P) for name in (
        "head", "seg", "delay", "wipe",
        "carry_sum", "carry_cnt", "sign0", "prev_sign", "prev_signal",
        "ms_time", "std_dev", "locked", "df_buf", "df_cnt", "df_idx",
        "corr_buf", "corr_cnt", "corr_idx",
        "dphi", "df_sum", "amplitude", "corr_q", "corr_l", "locked_seq",
        "sign0_seq", "edge_ms", "edge_local", "edge_valid")] + [
        (name, ctypes.c_int) for name in (
            "n_ch", "k", "n_cyc", "cs", "no_sec", "hist", "offset_avg")] + [
        (name, ctypes.c_float) for name in (
            "sample_rate", "edge_sigma", "gain_locked", "gain_unlocked",
            "lock_threshold", "max_df", "phase_jump", "t_blk")]


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


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgsdr_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for the current sources is
    missing.  Returns (library path, seconds spent compiling).  The
    compiler's output (with ptxas register/shared-memory use) goes to
    <library>.log."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    lib.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib, secs


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = ctypes.CDLL(str(build()[0]))
    lib.gsdr_wipeoff_launch.argtypes = [ctypes.POINTER(WipeoffArgs), _P]
    lib.gsdr_wipeoff_launch.restype = ctypes.c_int
    lib.gsdr_cheap_launch.argtypes = [ctypes.POINTER(CheapArgs), _P]
    lib.gsdr_cheap_launch.restype = ctypes.c_int
    lib.gsdr_error_string.argtypes = [ctypes.c_int]
    lib.gsdr_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = load().gsdr_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
