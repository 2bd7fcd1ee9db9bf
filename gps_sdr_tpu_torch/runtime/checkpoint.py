"""Mid-run receiver checkpoint / resume on PyTorch.

Port of gps_sdr_tpu/runtime/checkpoint.py.  The whole tracking state is
a ChannelState of device tensors, so a checkpoint is that state in the
JAX package's pack_states layout (ops/tracking.py states_to_numpy: f32
arrays, complex leaves split into re/im, long counters into hi/lo) plus
a pickle of the port's small host-side objects:

  device  ChannelState           (PLL/NCO, code phase, decode carries,
                                  quality rings)
  host    SlotTable, NavDecoders, ReceiverStatus, corr_quality
  host    Evaluator              (pseudorange engines, ephemerides,
                                  time references, positions, stats)

`save_session` / `load_session` round-trip a whole Session and
`save_server` / `load_server` a StreamServer with its streams'
evaluators: a resumed receiver continues mid-stream with locked
channels, bit framing and pseudorange time references intact, epoch
for epoch as if it had not stopped.  The format version is the JAX
package's (2), and the state arrays are laid out as its are, but the
pickled host objects are the port's own.  A checkpoint written by the
JAX package holds gps_sdr_tpu objects: the loader refuses it, before
any of that package (or JAX) is imported, with a ValueError that names
the module.
"""

from __future__ import annotations

import pickle

from gps_sdr_tpu_torch.ops.tracking import states_from_numpy, states_to_numpy

# v2: the Evaluator stores all_pos as _pos_buf/_pos_n and sat_results as
# a TupleLog; PseudorangeEngine stores cp_hist as hist_snos/hist_cps
FORMAT_VERSION = 2

# top-level packages whose classes a port checkpoint never holds
_FOREIGN = frozenset({"gps_sdr_tpu", "jax", "jaxlib"})


class _PortUnpickler(pickle.Unpickler):
    """Unpickles only what does not come from the JAX package or JAX:
    a class is looked up (and its module imported) only after its top
    package passed the check, so a refused checkpoint imports nothing."""

    def find_class(self, module, name):
        # the top package, not a prefix: gps_sdr_tpu_torch is the port's
        if module.split(".")[0] in _FOREIGN:
            raise ValueError(
                f"checkpoint holds {module}.{name}: it was written by the "
                "JAX package (gps_sdr_tpu), which the PyTorch port does not "
                "load; resume it with `python -m gps_sdr_tpu`")
        return super().find_class(module, name)


def _receiver_payload(rec) -> dict:
    return {
        "states_f32": states_to_numpy(rec.states),
        "slot_prn": list(rec.slots.slot_prn),
        "decoders": rec.decoders,
        "status": rec.status,
        "corr_quality": dict(rec.corr_quality),
        "sweep_all": rec.sweep_all,
    }


def _restore_receiver(rec, p: dict) -> None:
    rec.states = states_from_numpy(p["states_f32"], rec.device)
    rec.slots.slot_prn = list(p["slot_prn"])
    rec.decoders = p["decoders"]
    rec.status = p["status"]
    rec.corr_quality = p["corr_quality"]
    rec.sweep_all = p["sweep_all"]
    # the slot code tables are functions of slot_prn: rebuilt from the
    # per-PRN tables instead of stored
    rec._codes[:] = 0
    rec._ffts[:] = 0
    for slot, prn in enumerate(rec.slots.slot_prn):
        if prn:
            rec._codes[slot] = rec._codes_tab[prn]
            rec._ffts[slot] = rec._ffts_tab[prn]
    rec._refresh_code_tables()


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        p = _PortUnpickler(f).load()
    if p.get("version") != FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint version {p.get('version')!r} "
                         f"(this package reads {FORMAT_VERSION})")
    return p


def _dump(payload: dict, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def save_session(session, path: str) -> None:
    """Checkpoint a Session (receiver device + host state and evaluator)
    to `path` (one pickle file; numpy arrays inline)."""
    _dump({"version": FORMAT_VERSION, "cfg": session.receiver.cfg,
           **_receiver_payload(session.receiver),
           "evaluator": session.evaluator,
           "summaries": list(session.summaries)}, path)


def load_session(path: str, reporter=None, device="cuda"):
    """Rebuild a Session on `device` from a checkpoint; tracking resumes
    exactly where save_session left off, under the checkpoint's
    config."""
    from gps_sdr_tpu_torch.runtime.session import Session

    p = _load(path)
    session = Session(p["cfg"], device=device, reporter=reporter)
    _restore_receiver(session.receiver, p)
    session.evaluator = p["evaluator"]
    session.summaries = list(p["summaries"])
    return session


def save_server(server, evaluators: list, path: str) -> None:
    """Checkpoint a StreamServer (every stream's receiver) and the
    caller's per-stream evaluators: the serving counterpart of
    save_session.  Call it between runs: the receivers then hold their
    streams' final states."""
    _dump({"version": FORMAT_VERSION, "cfg": server.cfg,
           "receivers": [_receiver_payload(r) for r in server.receivers],
           "evaluators": list(evaluators)}, path)


def load_server(path: str, device="cuda", mesh=None):
    """Rebuild (StreamServer, evaluators) on `device`, or over the
    devices of a stream mesh (parallel/mesh.py make_stream_mesh), from a
    save_server checkpoint; every stream resumes where it left off (the
    stacked device states are rebuilt on the next run).  The mesh need
    not be the one the server was saved from."""
    from gps_sdr_tpu_torch.runtime.serving import StreamServer

    p = _load(path)
    server = StreamServer(p["cfg"], len(p["receivers"]), device=device,
                          mesh=mesh)
    for rec, rp in zip(server.receivers, p["receivers"]):
        _restore_receiver(rec, rp)
    return server, p["evaluators"]
