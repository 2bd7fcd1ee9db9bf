"""A run with the program broken underneath is not correct.

Each cell's run is driven here on the CPU at a test's size (the
receiver's plain PyTorch path, without the harness's look for a card),
for the manifest's cells and for the cells the manifest leaves out until
the receiver's faults are mended (PERF.md, Open questions), so that
their files and drivers stay ready:
once sound, which has to come out correct, and once with each fault
the cell can have planted in the receiver, which has to come out not
correct:

  state     the tracking step hands back the state it was given;
  half      half of the step's batch is left out (the second half of a
            chunk's blocks, or of a window's streams, tracked as zeros);
  altered   every code phase is moved a quarter period where the host
            receives it;
  exchange  (the mesh) every card's rows come back as the first card's.

    python -m pytest gsbench -q
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import pytest

from gsbench import control_signal, harness, manifest

# a test's size by the cell's entry and source: one capture of 12 chunks
# (and the file's sweep block), or a stream a device over 8 chunks
SMALL = {
    ("session", "file"): {"traffic": {"captures": 1, "blocks": 385}},
    ("session", "device"): {"traffic": {"captures": 1, "blocks": 384}},
    ("serve", "device"): {"traffic": {"blocks": 256}, "config": {}},
}
# a state handed back unchanged shows once the loop has run some tens of
# seconds of signal from it: that fault runs whole 65.5 s captures, in a
# window long enough for the CPU to get there
WHOLE = {"state"}
WINDOW_S = {"state": 20.0}
LEFT_OUT = [("rtl12.replay", "rtl2048_12ch", "replay4", 1),
            ("serve32.replay", "rtl2048_serve32", "streams", 1),
            ("rtl12.device", "rtl2048_12ch", "device4", 1),
            ("serve32x4.mesh", "rtl2048_serve32x4", "streams", 4)]


def full_manifest() -> dict:
    """BENCHMARK.json with the left-out cells added (config files by
    absolute path, every metric every cell's)."""
    man = copy.deepcopy(manifest.load())
    have = {w["name"] for w in man["workloads"]}
    for c in man["configs"]:
        c["file"] = os.path.join(manifest.ROOT, c["file"])
    names = {c["name"] for c in man["configs"]}
    for name, conf, traffic, chips in LEFT_OUT:
        if name not in have:
            man["workloads"].append({"name": name, "config": conf,
                                     "traffic": traffic, "chips": chips})
        if conf not in names:
            names.add(conf)
            man["configs"].append({"name": conf, "file": os.path.join(
                manifest.PKG, "configs", conf + ".json")})
    for m in man["end_to_end"]:
        m.pop("workloads", None)
    return man


MAN = full_manifest()
CELLS = sorted(w["name"] for w in MAN["workloads"])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("manifest")
    (d / "BENCHMARK.json").write_text(json.dumps(MAN))
    return str(d)


def faults(workload: str) -> tuple:
    """The faults a cell can have: the exchange between cards only where
    the configuration spans several."""
    config = manifest.cell(MAN, workload)[1]
    return ("state", "half", "altered") + (
        ("exchange",) if config["devices"] > 1 else ())


def resize(workload: str, fault: str | None = None) -> dict:
    _, config, traffic = manifest.cell(MAN, workload)
    small = copy.deepcopy(SMALL[config["entry"], traffic["source"]])
    if config["entry"] == "serve":
        small["config"]["streams"] = config["devices"]
    if fault in WHOLE:
        small["traffic"]["blocks"] = traffic["blocks"]
    if fault == "half" and config["entry"] == "serve":
        # two streams a device, so that half of each group is left out
        small["config"]["streams"] = 2 * config["devices"]
    small["traffic"]["due"] = {"ephemeris": False, "fixes": False}
    small["traffic"]["trace"] = None
    receiver = dict(config["receiver"])
    if config["entry"] == "serve":
        receiver["chunks_per_download"] = 2
    small.setdefault("config", {})["receiver"] = receiver
    return small


def run_small(root: str, workload: str, fault: str | None = None) -> dict:
    n_dev = manifest.cell(MAN, workload)[1]["devices"]
    return harness.run(workload, 20240611, WINDOW_S.get(fault, 4.0), False,
                       ["cpu"] * n_dev, time.perf_counter(), root=root,
                       resize=resize(workload, fault))


def _keep_state(fn):
    def wrapped(cfg, states, *args, **kw):
        return states, fn(cfg, states, *args, **kw)[1]
    return wrapped


def _half_blocks(fn):
    def wrapped(cfg, states, blocks, *args, **kw):
        blocks = blocks.clone()
        blocks[blocks.shape[0] // 2:] = 0
        return fn(cfg, states, blocks, *args, **kw)
    return wrapped


def _half_window(fn):
    def wrapped(cfg, states, blocks, *args, **kw):
        blocks = blocks.clone()
        blocks[:, blocks.shape[1] // 2:] = 0
        return fn(cfg, states, blocks, *args, **kw)
    return wrapped


def _shift(x):
    cs = 2048
    return np.where(x >= 0, (x + cs / 4) % cs, x).astype(x.dtype)


def _altered(fn, kind):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if kind == "pair":
            outs, dropped = out
            return outs._replace(code_phase=_shift(outs.code_phase)), dropped
        return out._replace(code_phase=_shift(out.code_phase))
    return wrapped


def plant(monkeypatch, fault: str) -> None:
    from gps_sdr_tpu_torch.runtime import receiver, serving
    if fault == "state":
        for mod, name in ((receiver, "track_chunk_batched_impl"),
                          (receiver, "track_window_impl"),
                          (serving, "track_streams_impl"),
                          (serving, "track_streams_window_impl")):
            monkeypatch.setattr(mod, name, _keep_state(getattr(mod, name)))
    elif fault == "half":
        for mod, name, wrap in (
                (receiver, "track_chunk_batched_impl", _half_blocks),
                (receiver, "track_window_impl", _half_window),
                (serving, "track_streams_impl", _half_blocks),
                (serving, "track_streams_window_impl", _half_window)):
            monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    elif fault == "altered":
        for mod, name, kind in ((receiver, "outs_to_numpy", "one"),
                                (receiver, "unpack_outs_compact", "pair"),
                                (receiver, "unpack_window_compact", "one"),
                                (serving, "unpack_outs_compact", "pair"),
                                (serving, "unpack_window_compact", "one")):
            monkeypatch.setattr(mod, name, _altered(getattr(mod, name), kind))
    elif fault == "exchange":
        def first_card_only(self):
            rows = self.parts[0].result()
            return np.concatenate([rows] * len(self.parts), axis=1)
        monkeypatch.setattr(serving._GroupDownload, "result",
                            first_card_only)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(root, workload):
    out = run_small(root, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and "rtf" in out["metrics"]


@pytest.mark.parametrize("precision", control_signal.PRECISIONS)
def test_signal_control_is_not_seen_by_the_answers(root, precision):
    """The signal half's control (control_signal.py): the wipeoff's
    contraction one precision down runs, and the answers come out as
    the float32 path's, within every limit: rounding at TF32's or
    bfloat16's step lies tens of dB below the capture's own noise
    (PERF.md, section 2)."""
    workload = manifest.load()["workloads"][0]["name"]
    n_dev = manifest.cell(MAN, workload)[1]["devices"]
    out = control_signal.run(workload, 20240611, 4.0, precision,
                             ["cpu"] * n_dev, root=root,
                             resize=resize(workload))
    assert out["stats"]["lowered_launches"] > 0
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in faults(w)])
def test_fault_is_not_correct(monkeypatch, root, workload, fault):
    plant(monkeypatch, fault)
    out = run_small(root, workload, fault)
    assert not out["correct"], out["checks"]
