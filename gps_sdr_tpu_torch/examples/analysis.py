"""The analysis notebook's logic (examples/analysis.ipynb of the port):
the evaluation half of the receiver on ideal measurements or a recorded
epoch fixture, and the live-parallel receiver.

Port of the JAX package's examples/analysis.ipynb, whose cells held this
code.  It imports no plotting package (the notebook imports matplotlib
itself):

  * ideal_epochs: ideal measurements of a physical scenario, one epoch
    a second (the JAX notebook's ideal_measurements);
  * load_epochs: a fixture recorded with `replay ... --record-epochs` by
    either package;
  * evaluate: the evaluator over the epochs;
  * live_capture: the live cell's synthetic capture (PRN 9, the tests'
    `recovery_skip_v1` blocks under .synth_cache/);
  * live_parallel: a Receiver on `device` in a thread streams its epochs
    over the UDP transport into an evaluator in the calling thread, the
    reference's JupyterLab workflow.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

import numpy as np

from gps_sdr_tpu_torch.runtime.evaluator import EpochInput, Evaluator

LIVE_KEY = "recovery_skip_v1"


def _ideal_measurements(cfg, scn, n_sec: int):
    """{prn: [(stream_no, code phase)]} of every block and {prn:
    [(ST, decoded subframe)]} of the scenario, without noise."""
    from gps_sdr_tpu_torch.models import navmsg

    fs = cfg.sample_rate
    n_blocks = n_sec * cfg.no_sec
    base = cfg.ngps
    centers = scn.t_rx0 + (np.arange(n_blocks) * cfg.ngps
                           + cfg.ngps / 2) / fs
    coph, frames = {}, {}
    for sat in scn.sats:
        _, tau_sv = scn.sat_states(centers, sat)
        frac_ms = tau_sv * 1000.0 - np.floor(tau_sv * 1000.0)
        n_center = (np.arange(n_blocks) * cfg.ngps + base
                    + cfg.ngps // 2) % cfg.code_samples
        cp = (n_center - frac_ms * cfg.code_samples) % cfg.code_samples
        coph[sat.prn] = [(b + 1, float(cp[b])) for b in range(n_blocks)]
        sf_list = []
        for k in range(n_sec // 6 + 2):
            tow = scn.tow0 + k
            t = (tow - 1) * 6.0 + 0.07
            for _ in range(4):
                _, tau_sv_t = scn.sat_states(np.array([t]), sat)
                t = t - (tau_sv_t[0] - (tow - 1) * 6.0)
            st = int(round((t - scn.t_rx0) * fs)) + base
            if st < 0:
                continue
            sf_id = (tow - 1) % 5 + 1
            fields = sat.eph if sf_id in (1, 2, 3) else {}
            dec = navmsg.decode_subframe(
                navmsg.encode_subframe(sf_id, fields, tow))
            dec["ST"] = st
            dec["SAT"] = sat.prn
            sf_list.append((st, dec))
        frames[sat.prn] = sf_list
    return coph, frames


def ideal_epochs(cfg, n_sats: int = 6, duration_sec: float = 40.0,
                 n_sec: int = 36, seed: int = 3):
    """(epochs, true receiver ECEF): n_sec epochs of ideal measurements
    of make_scenario(cfg, n_sats, duration_sec, seed), each holding the
    subframes that end in its second and its blocks' code phases."""
    from gps_sdr_tpu_torch.models.scenario import make_scenario

    scn = make_scenario(cfg, n_sats=n_sats, duration_sec=duration_sec,
                        seed=seed)
    coph, frames = _ideal_measurements(cfg, scn, n_sec)
    epochs = []
    for sec in range(n_sec):
        lo, hi = sec * cfg.no_sec + 1, (sec + 1) * cfg.no_sec + 1
        fr, cp = [], {}
        for sat in scn.sats:
            fr += [dict(sf) for st, sf in frames[sat.prn]
                   if lo * cfg.ngps <= st + 6 * cfg.sample_rate
                   < hi * cfg.ngps]
            cp[sat.prn] = [(sno, c) for sno, c in coph[sat.prn]
                           if lo <= sno < hi]
        epochs.append(EpochInput(0, fr, cp))
    return epochs, scn.rec_ecef


def load_epochs(path: str) -> list:
    """The epochs of a fixture recorded by either package (utils/io.py
    load_epoch_records: a JAX-written fixture loads nothing of JAX)."""
    from gps_sdr_tpu_torch.utils.io import load_epoch_records

    return [EpochInput(*rec) for rec in load_epoch_records(path)]


def evaluate(cfg, epochs) -> Evaluator:
    """An Evaluator that has processed `epochs` in order."""
    ev = Evaluator(cfg)
    for epoch in epochs:
        ev.process(epoch)
    return ev


def live_capture(cfg) -> np.ndarray:
    """The live cell's capture: PRN 9 at 1500 Hz, code delay 100, noise
    0.4, 3 no_sec + 1 blocks, read from (or written to) .synth_cache/
    under the key the JAX package's tests and notebook use."""
    from gps_sdr_tpu_torch.examples.synthetic_fix import CACHE_DIR, cached
    from gps_sdr_tpu_torch.models.simulator import (SatSignal, random_bits,
                                                    synth_stream)

    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    return cached(os.path.join(CACHE_DIR, hashlib.sha1(
        LIVE_KEY.encode()).hexdigest()[:16] + ".npy"), lambda: synth_stream(
            cfg, [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))


def live_parallel(cfg, blocks, device="cuda", data_port: int | None = None,
                  ctrl_port: int | None = None, deadline_s: float = 540,
                  epochs: list | None = None):
    """(live evaluator, epochs consumed): a Receiver on `device` runs over
    `blocks` in a thread and sends each epoch over the UDP transport
    (data_port, ctrl_port; None: the transport's 61431 and 61432) while
    this thread receives and evaluates them as they arrive, printing the
    PRNs each epoch tracks.  It polls until the receiver thread has
    ended and the socket has drained (~2 s), or deadline_s passes.  An
    exception of the receiver thread is raised here.  `epochs`, a list,
    gets every epoch received, in order."""
    from gps_sdr_tpu_torch.device import resolve_device
    from gps_sdr_tpu_torch.runtime.receiver import Receiver
    from gps_sdr_tpu_torch.runtime.transport import (EpochReceiver,
                                                     EpochSender)

    device = resolve_device(device)
    failed = []

    def receiver_half():
        try:
            tx = EpochSender(data_port=data_port, ctrl_port=ctrl_port)
            try:
                rec = Receiver(cfg, device=device)
                for epoch in rec.run(iter(blocks)):
                    tx.send(epoch)    # one UDP datagram set per ~1 s epoch
                    time.sleep(0.1)
            finally:
                tx.close()
        except Exception as exc:      # re-raised in the calling thread
            failed.append(exc)

    rx = EpochReceiver(data_port=data_port, ctrl_port=ctrl_port)
    thr = threading.Thread(target=receiver_half, daemon=True)
    live_ev = Evaluator(cfg)
    live_n, drain = 0, 0
    try:
        thr.start()
        deadline = time.time() + deadline_s
        while time.time() < deadline:
            e = rx.recv()
            if e is None:
                if not thr.is_alive():
                    drain += 1
                    if drain > 40:    # ~2 s grace to drain the socket
                        break
                time.sleep(0.05)
                continue
            drain = 0
            live_ev.process(e)
            live_n += 1
            if epochs is not None:
                epochs.append(e)
            tracked = sorted({sf["SAT"] for sf in e.frames if "SAT" in sf})
            print(f"live epoch {live_n}: tracking PRNs {tracked}")
        thr.join(timeout=60)
    finally:
        rx.close()
    if failed:
        raise failed[0]
    if thr.is_alive():
        raise TimeoutError(f"the receiver thread still runs after "
                           f"{deadline_s} s")
    return live_ev, live_n
