"""UDP pipeline transport: receiver process -> evaluator process.

The port's copy of gps_sdr_tpu/runtime/transport.py, with the same
pickle wire format, so a JAX sender and a port receiver interoperate,
and the reverse (tests/test_torch_transport.py).  The code-phase and
carrier series go on the wire as the reference's plain lists of
(stream_no, value) tuples, so that a receiver never needs the sender's
package to unpickle them; a JAX sender's CodePhaseList (the JAX
package's utils/cplist.py) is read back as the port's own copy of that
class, and nothing else of the JAX package or of JAX is unpickled.

Re-creates the reference's two-process deployment option: the receiver
serializes one EpochInput per reporting interval to UDP (reference:
pickle datagrams on port 61431, gpsrecv.py:509-519, payload budget
65,504 B, gpsglob.py:85-88) and polls a reverse control socket for
b'SWEEP' / b'STOP' commands (port 61432, gpsrecv.py:521-536; sender
gpseval.py:591-598).  Oversized epochs are split across datagrams by
chunking the code-phase dict (the reference documents the budget and
asserts); splitting preserves semantics because EpochInput fields are
merged downstream per reporting interval.

DATA_PORT and CTRL_PORT are read when a sender or receiver is made, not
when this module is imported, so a caller (a test's child process) can
set them on the module.
"""

from __future__ import annotations

import io
import pickle
import socket

from gps_sdr_tpu_torch.runtime.evaluator import EpochInput
from gps_sdr_tpu_torch.utils.cplist import CodePhaseList

DATA_PORT = 61431
CTRL_PORT = 61432
MAX_PAYLOAD = 65_504


def _plain(series: dict) -> dict:
    """{sat: [(stream_no, value), ...]} as plain lists of tuples."""
    return {sat: list(lst) for sat, lst in series.items()}


def _wire(epoch: EpochInput) -> bytes:
    """Wire format: 3-tuple, or 4-tuple when carrier freqs ride along
    (carrier_smoothing mode); receivers accept both."""
    base = (epoch.skipped_samples, epoch.frames, _plain(epoch.code_phases))
    if epoch.carrier_freqs:
        return pickle.dumps(base + (_plain(epoch.carrier_freqs),))
    return pickle.dumps(base)


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's CodePhaseList as the port's and refuses
    any other class of the JAX package or of JAX, before importing it."""

    def find_class(self, module, name):
        if (module, name) == ("gps_sdr_tpu.utils.cplist", "CodePhaseList"):
            return CodePhaseList
        if module.split(".")[0] in ("gps_sdr_tpu", "jax", "jaxlib"):
            raise ValueError(f"epoch datagram refers to {module}.{name}")
        return super().find_class(module, name)


def _unwire(payload: bytes) -> EpochInput:
    skipped, frames, coph, *rest = _Unpickler(io.BytesIO(payload)).load()
    return EpochInput(skipped, frames, coph,
                      carrier_freqs=rest[0] if rest else None)


def _sub_freqs(epoch: EpochInput, coph: dict) -> dict | None:
    """carrier_freqs restricted to a code-phase sub-dict's sats (and,
    for list splits, the matching stream-number range)."""
    cf = epoch.carrier_freqs
    if not cf:
        return None
    out = {}
    for sat, lst in coph.items():
        if sat not in cf:
            continue
        snos = {s for s, _ in lst}
        out[sat] = [e for e in cf[sat] if e[0] in snos]
    return out or None


def _split_epoch(epoch: EpochInput):
    """Yield EpochInputs whose pickles fit the datagram budget."""
    if len(_wire(epoch)) <= MAX_PAYLOAD:
        yield epoch
        return
    # split the code-phase dict (the only unbounded part) in half by sat
    sats = sorted(epoch.code_phases)
    if len(sats) <= 1:  # then split one sat's list
        (sat,) = sats or (None,)
        lst = epoch.code_phases.get(sat, [])
        mid = len(lst) // 2
        ha, hb = {sat: lst[:mid]}, {sat: lst[mid:]}
        yield from _split_epoch(EpochInput(
            epoch.skipped_samples, epoch.frames, ha,
            carrier_freqs=_sub_freqs(epoch, ha)))
        yield from _split_epoch(EpochInput(
            0, [], hb, carrier_freqs=_sub_freqs(epoch, hb)))
        return
    mid = len(sats) // 2
    a = {s: epoch.code_phases[s] for s in sats[:mid]}
    b = {s: epoch.code_phases[s] for s in sats[mid:]}
    yield from _split_epoch(EpochInput(
        epoch.skipped_samples, epoch.frames, a,
        carrier_freqs=_sub_freqs(epoch, a)))
    yield from _split_epoch(EpochInput(
        0, [], b, carrier_freqs=_sub_freqs(epoch, b)))


class EpochSender:
    """Receiver side: send epochs, poll for commands."""

    def __init__(self, host: str = "127.0.0.1", data_port: int | None = None,
                 ctrl_port: int | None = None):
        self._addr = (host, DATA_PORT if data_port is None else data_port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._ctrl = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._ctrl.bind(("", CTRL_PORT if ctrl_port is None else ctrl_port))
        self._ctrl.setblocking(False)

    def send(self, epoch: EpochInput) -> int:
        """Send one epoch; returns the number of datagrams."""
        n = 0
        for part in _split_epoch(epoch):
            self._sock.sendto(_wire(part), self._addr)
            n += 1
        return n

    def poll_command(self) -> str | None:
        """'SWEEP' | 'STOP' | None (non-blocking)."""
        try:
            data, _ = self._ctrl.recvfrom(64)
        except BlockingIOError:
            return None
        return data.decode(errors="replace")

    def close(self) -> None:
        self._sock.close()
        self._ctrl.close()


class EpochReceiver:
    """Evaluator side: receive epochs, send commands."""

    def __init__(self, data_port: int | None = None,
                 ctrl_host: str = "127.0.0.1", ctrl_port: int | None = None):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("", DATA_PORT if data_port is None else data_port))
        self._sock.setblocking(False)
        self._ctrl = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._ctrl_addr = (ctrl_host,
                           CTRL_PORT if ctrl_port is None else ctrl_port)

    def recv(self) -> EpochInput | None:
        """One EpochInput or None if nothing is queued (non-blocking,
        mirroring the evaluator's EWOULDBLOCK swallow, gpseval.py:516)."""
        try:
            payload, _ = self._sock.recvfrom(MAX_PAYLOAD + 256)
        except BlockingIOError:
            return None
        return _unwire(payload)

    def request_sweep(self) -> None:
        self._ctrl.sendto(b"SWEEP", self._ctrl_addr)

    def request_stop(self) -> None:
        self._ctrl.sendto(b"STOP", self._ctrl_addr)

    def close(self) -> None:
        self._sock.close()
        self._ctrl.close()
