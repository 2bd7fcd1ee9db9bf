"""Shared helpers of tests/test_torch_parity_*.py: the JAX package's tests
of code the port copied or ported, run on both packages.

A twin feeds the same inputs (numpy, from the JAX test's seeds) to the
JAX package's function and to the port's counterpart, applies the JAX
test's bar to both results, and compares the two.  The host modules the
port copied (numpy only) are held exactly: `same` is np.testing's
assert_equal over dicts, sequences, named tuples, dataclasses and
arrays (NaN equal to NaN).  Both packages run their numpy host paths
(GSDR_EVALCORE=0, GSDR_NAVSCAN=0), as tests/test_torch_host_copies.py
does: the port's copies keep only those paths' semantics.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest


@pytest.fixture
def numpy_host_core(monkeypatch):
    monkeypatch.setenv("GSDR_EVALCORE", "0")
    monkeypatch.setenv("GSDR_NAVSCAN", "0")


def pair(name: str) -> tuple:
    """(the JAX package's module, the port's module) at relative path
    `name`, e.g. "models.orbits"."""
    return (importlib.import_module(f"gps_sdr_tpu.{name}"),
            importlib.import_module(f"gps_sdr_tpu_torch.{name}"))


def plain(x):
    """x with dataclasses and named tuples turned into dicts and code-phase
    series (utils/cplist.CodePhaseList of either package) into their
    stream-number and value arrays, recursively, so that assert_equal
    compares what they hold."""
    if type(x).__name__ == "CodePhaseList":
        return {"snos": np.asarray(x.snos), "vals": np.asarray(x.vals)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: plain(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def same(got, want, what: str = "") -> None:
    """The port's result `got` equals the JAX package's `want` exactly."""
    np.testing.assert_equal(plain(got), plain(want), err_msg=what)


# the JAX config's fields that the port's config does not have, each at
# the value that is the port's one behaviour: kernels picked by the
# backend, one tracking call a download window, subframes polled every
# epoch
JAX_ONLY_FIELDS = {"use_pallas_kernels": None, "use_pallas_cheap": None,
                   "fused_window_dispatch": True,
                   "defer_subframe_poll": False}


def same_config(got, want) -> None:
    """The port's ReceiverConfig `got` equals the JAX package's `want` in
    every field the port's has, and `want`'s other fields hold
    JAX_ONLY_FIELDS."""
    want = dataclasses.asdict(want)
    assert {k: want.pop(k) for k in JAX_ONLY_FIELDS} == JAX_ONLY_FIELDS
    same(dataclasses.asdict(got), want)


def twin(fn, *names: str):
    """fn(*modules) on the JAX package's modules named `names`, then on
    the port's; the two results must be equal.  Returns (JAX, port)."""
    mods = [pair(n) for n in names]
    want = fn(*[m[0] for m in mods])
    got = fn(*[m[1] for m in mods])
    same(got, want, fn.__name__)
    return want, got
