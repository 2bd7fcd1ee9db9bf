"""BENCHMARK.json and the files it names.

The harness finds everything by name: a cell's configuration in
gsbench/configs/<config>.json (the file the manifest gives), its
traffic mix in gsbench/traffic/<traffic>.json, and each metric's reader
in gsbench/metrics/<name>.py.  Adding a cell, a configuration, a mix or
a metric adds files and manifest entries and edits none.
"""

from __future__ import annotations

import importlib
import json
import os
import re

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(man: dict, name: str, root: str = ROOT) -> tuple:
    """(workload entry, configuration dict, traffic dict) of cell
    `name`; KeyError if the manifest has no such cell."""
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[name]
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(PKG, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return w, config, traffic


def metrics_for(man: dict, name: str, trace: bool) -> list:
    """The manifest's metric entries that cell `name` reports: its
    end-to-end metrics untraced, its per-layer metrics traced.  A metric
    without a "workloads" key is every cell's."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    """The module gsbench.metrics.<metric>, whose read(ctx) gives the
    metric's value or None where the run has nothing to read."""
    return importlib.import_module(f"gsbench.metrics.{metric}")
