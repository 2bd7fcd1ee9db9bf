"""The one generator of every traffic mix: captures from a mix's data.

A mix (gsbench/traffic/<name>.json) gives the number of captures (or
one a stream of the configuration), their length in blocks, the
satellites in view, the noise, the dongle's gain, and whether the
captures are files in the recording format or held on the card, with
the layout there.  Each capture has its own scenario and noise, drawn
from the run's seed and its index, so streams never share IQ, and every
seed gives the same sizes and the same work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from gsbench import scenario as sc
from gsbench import synth


@dataclass
class Capture:
    index: int
    scn: sc.Scenario
    n_blocks: int
    path: str | None = None     # a file in the recording format
    data: object = None         # or the capture on its device


def shape_of(config: dict) -> dict:
    """The sizes the yardstick counts with, from the configuration."""
    r = config["receiver"]
    cs, n_cyc = r["code_samples"], r["n_cyc"]
    no_sec = 1024 // n_cyc
    return {"code_samples": cs, "n_cyc": n_cyc, "fs": 1000.0 * cs,
            "corr_avg": r["corr_avg"], "no_sec": no_sec,
            "corr_hist_len": r["corr_q_window_sec"] * no_sec}


def n_captures(traffic: dict, config: dict) -> int:
    return (config["streams"] * traffic["captures_per_stream"]
            if "captures_per_stream" in traffic else traffic["captures"])


def make(traffic: dict, config: dict, seed: int, devices: list,
         tmpdir: str | None) -> list:
    """The mix's captures; files go into tmpdir, device captures are
    spread over `devices` in contiguous groups (stream s on the device
    that serves it)."""
    shape = shape_of(config)
    n = n_captures(traffic, config)
    per_dev = -(-n // len(devices))
    bs = shape["n_cyc"] * shape["code_samples"] / shape["fs"]
    out = []
    for i in range(n):
        dev = devices[i // per_dev]
        scn = sc.make_scenario(synth.capture_seed(seed, i),
                               traffic["satellites"],
                               traffic["blocks"] * bs + 6.0)
        layout = "packed" if traffic["source"] == "file" else \
            traffic["layout"]
        data = synth.make_capture(scn, shape, traffic["blocks"],
                                  traffic["noise_std"], traffic["gain"],
                                  synth.noise_seed(seed, i), layout, dev)
        cap = Capture(i, scn, traffic["blocks"])
        if layout == "packed":
            cap.path = os.path.join(tmpdir, f"capture_{i}.bin")
            with open(cap.path, "wb") as f:
                np.asarray(data).tofile(f)
                f.flush()
                # written back before the window, not during it
                os.fsync(f.fileno())
        else:
            cap.data = data
        out.append(cap)
    return out
