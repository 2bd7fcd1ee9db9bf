"""The native host core: build, load and the per-call gate.

The port's copy of gps_sdr_tpu/nativecore.py, with its own build.  The
three host libraries, gps_sdr_tpu_torch/csrc/{evalcore,navscan,ingest}.cpp
(copies of the JAX package's csrc/*.cpp), are compiled by g++ at first
use with the JAX Makefile's flags into build/gps_sdr_tpu_torch/ (through
ops/_build.py compile_libraries: a hash of the source, the flags and the
CPU that `-march=native` resolves to in each library's name, the three
compilers at once, under a file lock).  Nothing is built or loaded when
this module is imported.

`native_evalcore()` returns the _evalcore binding module, or False when
GSDR_EVALCORE=0 (the switch that selects the numpy path; models/navmsg.py
reads GSDR_NAVSCAN=0 the same way).  Unlike the JAX package, which warns
and carries on in numpy, a library that fails to build or load raises,
with the compiler's output: a run asks for the native core unless it
switches it off.  Callers keep their numpy paths as the semantic source
of truth and consult the gate per call, so tests can flip the switch
between calls.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

from gps_sdr_tpu_torch.ops import _build

HOST_SOURCES = ("evalcore", "navscan", "ingest")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-Wextra", "-shared"]


@functools.lru_cache(maxsize=None)
def _target() -> str:
    """What `-march=native` means on this machine (the cc1 line of a
    dry run), so a library built for one CPU is not loaded on another."""
    res = subprocess.run([CXX, "-march=native", "-E", "-v", "-x", "c++",
                          os.devnull], capture_output=True, text=True,
                         timeout=60)
    return next((line for line in res.stderr.splitlines()
                 if "cc1" in line), res.stderr)


def host_jobs() -> dict:
    """compile_libraries' jobs for the host libraries: name -> (g++
    command, the library's path for this machine)."""
    flags = [*CXX_FLAGS, _target()]
    jobs = {}
    for name in HOST_SOURCES:
        src = _build.CSRC / f"{name}.cpp"
        jobs[name] = ([CXX, *CXX_FLAGS, str(src)],
                      _build.library_path(src, flags))
    return jobs


def build() -> tuple[dict, float]:
    """Compile the host libraries that are missing, all at once.
    Returns (name -> library path, wall seconds spent compiling)."""
    jobs = host_jobs()
    return ({name: lib for name, (_, lib) in jobs.items()},
            _build.compile_libraries(jobs))


@functools.lru_cache(maxsize=None)
def load_native_lib(name: str) -> ctypes.CDLL:
    """The host library built from csrc/<name>.cpp, built on first use;
    raises (with the compiler's output) if it cannot be built or
    loaded."""
    return ctypes.CDLL(str(build()[0][name]))


def native_evalcore():
    """The _evalcore binding module, or False when GSDR_EVALCORE=0."""
    if os.environ.get("GSDR_EVALCORE", "1") == "0":
        return False
    from gps_sdr_tpu_torch import _evalcore
    return _evalcore
