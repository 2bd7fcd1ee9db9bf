"""The port's analysis notebook (gps_sdr_tpu_torch/examples/analysis.ipynb)
and its module (examples/analysis.py): the notebook executes headlessly
on the CPU with no module of JAX or of the JAX package in its kernel, the
evaluator numbers equal the JAX notebook's cells exactly, and the
live-parallel receiver gives the JAX Receiver's frames.  Every UDP port
here is one the OS hands out: no socket binds 61431 or 61432."""

import contextlib
import io
import json
import os
import sys
import types

import nbformat
import numpy as np
import torch
from nbclient import NotebookClient

import chip_smoke
from gps_sdr_tpu.config import ReceiverConfig as JaxConfig
from gps_sdr_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from gps_sdr_tpu.runtime.receiver import Receiver as JaxReceiver
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.examples import analysis
from gps_sdr_tpu_torch.kernel_profile import free_udp_ports
from tests.test_torch_frontend import amp_rtol
from tests.torch_envelope import (AMP_RTOL, FRQ_ATOL, check_code_phases,
                                  check_subframes)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_NB = os.path.join(ROOT, "gps_sdr_tpu_torch", "examples",
                       "analysis.ipynb")
JAX_NB = os.path.join(ROOT, "examples", "analysis.ipynb")


def _set_parameters(nb, **values) -> None:
    """Rewrite the first code cell's NAME = ... lines to `values`."""
    cell = next(c for c in nb.cells if c.cell_type == "code")
    lines = cell.source.splitlines()
    for name, value in values.items():
        idx = [i for i, line in enumerate(lines)
               if line.startswith(f"{name} = ")]
        assert len(idx) == 1, name
        lines[idx[0]] = f"{name} = {value!r}"
    cell.source = "\n".join(lines)


def test_notebook_executes_on_the_cpu_without_jax():
    nb = nbformat.read(PORT_NB, as_version=4)
    src = "\n".join(c.source for c in nb.cells if c.cell_type == "code")
    assert "import jax" not in src and "gps_sdr_tpu." not in src
    data, ctrl = free_udp_ports(2)
    _set_parameters(nb, DEVICE="cpu", DATA_PORT=data, CTRL_PORT=ctrl)
    nb.cells.append(nbformat.v4.new_code_cell(
        "import sys\n"
        "print('FOREIGN_MODULES', sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'gps_sdr_tpu')))"))
    client = NotebookClient(
        nb, timeout=600, kernel_name="python3",
        resources={"metadata": {"path": os.path.dirname(PORT_NB)}})
    client.execute()
    text = "\n".join(
        "".join(o.get("text", "")) for c in nb.cells
        if c.cell_type == "code" for o in c.get("outputs", []))
    assert "fixes:" in text
    n_live = [int(line.split()[1]) for line in text.splitlines()
              if line.startswith("consumed ") and "epochs live" in line]
    assert len(n_live) == 1 and n_live[0] >= 3, text
    assert "FOREIGN_MODULES []" in text, text


def _jax_cells():
    """The JAX notebook's setup, epoch and evaluator cells (its first
    three code cells), run in this process; their namespace and what the
    evaluator cell printed."""
    nb = nbformat.read(JAX_NB, as_version=4)
    code = [c.source for c in nb.cells if c.cell_type == "code"][:3]
    assert "ideal_measurements" in code[1] and "Evaluator(cfg)" in code[2]
    ns = {"__name__": "jax_notebook"}
    out = io.StringIO()
    cwd, path = os.getcwd(), list(sys.path)
    try:
        os.chdir(os.path.dirname(JAX_NB))
        with contextlib.redirect_stdout(out):
            for src in code:
                exec(compile(src, JAX_NB, "exec"), ns)
    finally:
        os.chdir(cwd)
        sys.path[:] = path
    return ns, out.getvalue()


def test_ideal_epochs_and_evaluate_equal_the_jax_notebook():
    ns, printed = _jax_cells()
    cfg = ReceiverConfig()
    epochs, truth = analysis.ideal_epochs(cfg, n_sats=6, duration_sec=40.0,
                                          n_sec=36, seed=3)
    np.testing.assert_array_equal(truth, ns["truth_ecef"])
    ev, want = analysis.evaluate(cfg, epochs), ns["ev"]
    # (the evaluators mark the frames they processed: compare after both)
    assert len(epochs) == len(ns["epochs"]) == 36
    for got, want_e in zip(epochs, ns["epochs"]):
        assert got.skipped_samples == want_e.skipped_samples
        assert got.frames == want_e.frames
        assert got.code_phases == want_e.code_phases
    assert "fixes: " in printed and len(want.positions) > 100
    # the numbers chip_smoke.py's phase 14c holds the card's run to
    pins = {"fixes": len(ev.positions), "failures": len(ev.fix_failures),
            "outliers": len(ev.outliers), "phase_errors": ev.n_phase_errors}
    assert pins == {k: v for k, v in chip_smoke.IDEAL_PINS.items()
                    if k != "err_m"}
    assert abs(np.linalg.norm(ev.stat[0] - truth)
               - chip_smoke.IDEAL_PINS["err_m"]) <= chip_smoke.IDEAL_ERR_ATOL
    np.testing.assert_array_equal(np.asarray(ev.positions),
                                  np.asarray(want.positions))
    assert list(ev.sat_results) == list(want.sat_results)
    assert len(ev.fix_failures) == len(want.fix_failures)
    assert len(ev.outliers) == len(want.outliers)
    assert ev.n_phase_errors == want.n_phase_errors
    for got_v, want_v in zip(ev.stat, want.stat):
        np.testing.assert_array_equal(got_v, want_v)


def test_live_parallel_gives_the_jax_receivers_frames():
    cfg = ReceiverConfig()
    blocks = analysis.live_capture(cfg)
    assert blocks.shape == (3 * cfg.no_sec + 1, cfg.ngps)
    data, ctrl = free_udp_ports(2)
    got = []
    ev, n = analysis.live_parallel(cfg, blocks, device="cpu",
                                   data_port=data, ctrl_port=ctrl,
                                   epochs=got)
    assert n == len(got) >= 3
    want = list(JaxReceiver(JaxConfig()).run(iter(blocks)))
    jax_ev = JaxEvaluator(JaxConfig())
    for epoch in want:          # marks the frames as the live one did
        jax_ev.process(epoch)
    as_session = [types.SimpleNamespace(records=[
        (e.skipped_samples, e.frames, e.code_phases) for e in epochs])
        for epochs in (want, got)]
    assert check_subframes(*as_session) >= 0
    worst = check_code_phases(*as_session)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.skipped_samples == w.skipped_samples
        assert [sorted(f) for f in g.frames] == [sorted(f) for f in w.frames]
        for j, t in zip(w.frames, g.frames):
            assert (t["SAT"], t["SWP"]) == (j["SAT"], j["SWP"])
            assert abs(t["FRQ"] - j["FRQ"]) <= FRQ_ATOL, (t, j)
            np.testing.assert_allclose(t["CRM"], j["CRM"], rtol=AMP_RTOL)
            # AMP, a mean over the std of two means, is ill-conditioned
            # for a strong channel (A ~ 100): test_torch_frontend's rule
            assert abs(t["AMP"] - j["AMP"]) <= amp_rtol(j["AMP"]) * j["AMP"]
    tracked = sorted({sf["SAT"] for e in got for sf in e.frames})
    assert tracked == [9], tracked
    print(json.dumps({"epochs": n, "max_cp_diff": worst}))
