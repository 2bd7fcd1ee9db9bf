"""The port's UDP transport (runtime/transport.py) and block buffers
(runtime/buffer.py) against the JAX package's.

The wire is a point of equivalence: the same epoch pickles to the same
bytes on both sides, an oversized epoch splits into the same parts, and
a JAX EpochSender feeds a port EpochReceiver (and the reverse) with the
epochs unchanged.  Every socket here binds a port the OS hands out,
never the default 61431/61432."""

import time

import numpy as np
import pytest

from gps_sdr_tpu.runtime import buffer as jbuf
from gps_sdr_tpu.runtime import transport as jtr
from gps_sdr_tpu.runtime.evaluator import EpochInput as JaxEpoch
from gps_sdr_tpu_torch.kernel_profile import free_udp_ports
from gps_sdr_tpu_torch.runtime import buffer as tbuf
from gps_sdr_tpu_torch.runtime import transport as ttr
from gps_sdr_tpu_torch.runtime.evaluator import EpochInput
from tests.test_cli_ui import epoch_records  # fixture  # noqa: F401


def _recv_all(rx, n, timeout=5.0):
    got, t0 = [], time.monotonic()
    while len(got) < n and time.monotonic() - t0 < timeout:
        e = rx.recv()
        if e is None:
            time.sleep(0.005)
        else:
            got.append(e)
    return got


def _as_tuple(e):
    return (e.skipped_samples, e.frames, e.code_phases, e.carrier_freqs)


def _big_epoch(cls, with_freqs, n=4000):
    """An epoch of 3 PRNs x n code phases (n = 4000: past the datagram
    budget many times over)."""
    coph = {prn: [(i, float(i % 2048) + 0.25) for i in range(n)]
            for prn in (2, 3, 4)}
    cf = ({prn: [(i, 10.0 * prn + i * 1e-3) for i in range(n)]
           for prn in (2, 3)} if with_freqs else None)
    return cls(5, [{"SAT": 2, "ID": 1}], coph, carrier_freqs=cf)


def test_wire_bytes_equal_jax(epoch_records):  # noqa: F811
    _, records = epoch_records
    for rec in records[::7]:
        assert ttr._wire(EpochInput(*rec)) == jtr._wire(JaxEpoch(*rec))
    cf = {5: [(1, 12.5)]}
    assert (ttr._wire(EpochInput(*records[3], carrier_freqs=cf))
            == jtr._wire(JaxEpoch(*records[3], carrier_freqs=cf)))


def test_wire_round_trip(epoch_records):  # noqa: F811
    """An epoch through a port sender and receiver comes back unchanged;
    a command goes the other way."""
    _, records = epoch_records
    data, ctrl = free_udp_ports(2)
    tx = ttr.EpochSender(data_port=data, ctrl_port=ctrl)
    rx = ttr.EpochReceiver(data_port=data, ctrl_port=ctrl)
    try:
        for rec in records[:5]:
            assert tx.send(EpochInput(*rec)) == 1
        got = _recv_all(rx, 5)
        assert [_as_tuple(e) for e in got] == [
            _as_tuple(EpochInput(*rec)) for rec in records[:5]]
        assert rx.recv() is None
        rx.request_sweep()
        rx.request_stop()
        time.sleep(0.05)
        assert [tx.poll_command(), tx.poll_command(),
                tx.poll_command()] == ["SWEEP", "STOP", None]
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("with_freqs", [False, True])
def test_split_oversized_epoch(with_freqs):
    """An epoch past the 65,504-byte datagram budget splits into the JAX
    package's parts, each within the budget, that merge back to it."""
    parts = list(ttr._split_epoch(_big_epoch(EpochInput, with_freqs)))
    want = list(jtr._split_epoch(_big_epoch(JaxEpoch, with_freqs)))
    assert len(parts) > 1
    assert [_as_tuple(p) for p in parts] == [_as_tuple(p) for p in want]
    for p in parts:
        assert len(ttr._wire(p)) <= ttr.MAX_PAYLOAD
    big = _big_epoch(EpochInput, with_freqs)
    merged = {}
    for p in parts:
        for k, v in p.code_phases.items():
            merged.setdefault(k, []).extend(v)
    assert merged == big.code_phases
    assert sum(p.skipped_samples for p in parts) == 5
    assert sum((p.frames for p in parts), []) == big.frames
    if with_freqs:
        mf = {}
        for p in parts:
            for k, v in (p.carrier_freqs or {}).items():
                mf.setdefault(k, []).extend(v)
        assert mf == big.carrier_freqs


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_jax_and_port_interoperate(epoch_records, direction):  # noqa: F811
    """A JAX EpochSender to a port EpochReceiver, and the reverse: every
    epoch (one of them oversized, so split in parts that together stay
    within a default socket buffer) arrives unchanged, and the
    receiver's commands reach the sender."""
    _, records = epoch_records
    data, ctrl = free_udp_ports(2)
    send_mod, recv_mod = ((jtr, ttr) if direction == "jax_to_port"
                          else (ttr, jtr))
    send_cls = JaxEpoch if send_mod is jtr else EpochInput
    tx = send_mod.EpochSender(data_port=data, ctrl_port=ctrl)
    rx = recv_mod.EpochReceiver(data_port=data, ctrl_port=ctrl)
    try:
        epochs = [send_cls(*rec) for rec in records[10:14]]
        epochs.append(_big_epoch(send_cls, True, n=1500))
        n = sum(tx.send(e) for e in epochs)
        assert n > 5
        got = _recv_all(rx, n)
        assert len(got) == n
        assert [_as_tuple(e) for e in got[:4]] == [
            _as_tuple(e) for e in epochs[:4]]
        assert [_as_tuple(e) for e in got[4:]] == [
            _as_tuple(p) for p in send_mod._split_epoch(epochs[4])]
        rx.request_sweep()
        time.sleep(0.05)
        assert tx.poll_command() == "SWEEP"
    finally:
        tx.close()
        rx.close()


def test_ports_read_when_made(monkeypatch):
    """DATA_PORT and CTRL_PORT are read when a sender or receiver is
    made, so setting them on the module moves both ends."""
    data, ctrl = free_udp_ports(2)
    monkeypatch.setattr(ttr, "DATA_PORT", data)
    monkeypatch.setattr(ttr, "CTRL_PORT", ctrl)
    tx, rx = ttr.EpochSender(), ttr.EpochReceiver()
    try:
        assert rx._sock.getsockname()[1] == data
        assert tx._ctrl.getsockname()[1] == ctrl
        tx.send(EpochInput(0, [], {7: [(1, 2.5)]}))
        (got,) = _recv_all(rx, 1)
        assert got.code_phases == {7: [(1, 2.5)]}
    finally:
        tx.close()
        rx.close()


def _blocks(n, size=8):
    return [np.full(size, v + 0.5j, np.complex64) for v in range(n)]


@pytest.mark.parametrize("kind", ["deque", "native_ring"])
def test_buffer_drop_oldest_accounting(kind):
    """Overflow clears the buffer and credits every dropped block to the
    next pulled block, as the JAX BlockBuffer does (the reference's
    bounded deque)."""
    buf = (tbuf.make_buffer(4) if kind == "deque"
           else tbuf.make_buffer(4, block_samples=8))
    assert type(buf) is (tbuf.BlockBuffer if kind == "deque"
                         else tbuf.RingBuffer)
    ref = jbuf.BlockBuffer(4)
    pushes = [6, 1, 9, 0, 3]             # blocks pushed before each drain
    v = 0
    for n in pushes:
        for b in _blocks(v + n)[v:]:
            buf.push(b)
            ref.push(b)
        v += n
        assert len(buf) == len(ref)
        while True:
            got, want = buf.pull(), ref.pull()
            assert got[1] == want[1]
            if want[0] is None:
                assert got[0] is None
                break
            np.testing.assert_array_equal(got[0], want[0])
    assert buf.pull() == (None, 0)


def _cp_epoch(cls, cplist_cls):
    """A receiver's epoch: its code phases as CodePhaseList series."""
    rng = np.random.default_rng(2)
    coph = {prn: cplist_cls(np.arange(1, 33) + 100 * prn,
                            rng.uniform(0, 2048, 32)) for prn in (3, 9, 17)}
    cf = {prn: cplist_cls(np.arange(1, 33) + 100 * prn,
                          rng.uniform(-5e3, 5e3, 32)) for prn in (3, 9)}
    return cls(0, [{"SAT": 3, "ID": 2, "AMP": 12.5}], coph,
               carrier_freqs=cf)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_receiver_epochs_cross_without_the_other_package(direction):
    """Epochs as the receivers make them (CodePhaseList series) cross the
    wire both ways: the port sends plain (stream_no, value) lists, which
    a JAX EpochReceiver reads as the reference's lists; a JAX sender's
    CodePhaseList arrives at a port EpochReceiver as the port's class.
    The values are unchanged either way."""
    from gps_sdr_tpu.utils.cplist import CodePhaseList as JaxCpl
    from gps_sdr_tpu_torch.utils.cplist import CodePhaseList as PortCpl

    data, ctrl = free_udp_ports(2)
    if direction == "jax_to_port":
        epoch, tx = _cp_epoch(JaxEpoch, JaxCpl), jtr.EpochSender(
            data_port=data, ctrl_port=ctrl)
        rx, want_cls = ttr.EpochReceiver(data_port=data, ctrl_port=ctrl), \
            PortCpl
    else:
        epoch, tx = _cp_epoch(EpochInput, PortCpl), ttr.EpochSender(
            data_port=data, ctrl_port=ctrl)
        rx, want_cls = jtr.EpochReceiver(data_port=data, ctrl_port=ctrl), \
            list
    try:
        assert tx.send(epoch) == 1
        (got,) = _recv_all(rx, 1)
    finally:
        tx.close()
        rx.close()
    for series, want in ((got.code_phases, epoch.code_phases),
                         (got.carrier_freqs, epoch.carrier_freqs)):
        assert sorted(series) == sorted(want)
        for prn, lst in series.items():
            assert type(lst) is want_cls
            assert list(lst) == list(want[prn])
    assert got.frames == epoch.frames


def test_unwire_imports_nothing_of_the_jax_package(tmp_path):
    """A JAX sender's datagram (its CodePhaseList pickled by reference to
    gps_sdr_tpu) is read in a fresh interpreter by the port alone, which
    then holds no module of gps_sdr_tpu or jax; a datagram naming
    another JAX-package class is refused before any import."""
    import os
    import pickle
    import subprocess
    import sys

    from gps_sdr_tpu.runtime.evaluator import EpochInput as JE
    from gps_sdr_tpu.utils.cplist import CodePhaseList as JaxCpl

    (tmp_path / "ok.bin").write_bytes(jtr._wire(_cp_epoch(JaxEpoch,
                                                          JaxCpl)))
    (tmp_path / "bad.bin").write_bytes(pickle.dumps((0, [JE(0, [], {})],
                                                     {})))
    code = f"""
import sys
from gps_sdr_tpu_torch.runtime import transport
e = transport._unwire(open({str(tmp_path / "ok.bin")!r}, "rb").read())
print("TYPE", type(e.code_phases[3]).__module__, len(e.code_phases[3]))
try:
    transport._unwire(open({str(tmp_path / "bad.bin")!r}, "rb").read())
except ValueError as err:
    print("REFUSED", err)
print("FOREIGN", sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "gps_sdr_tpu")))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "TYPE gps_sdr_tpu_torch.utils.cplist 32" in res.stdout
    assert "REFUSED epoch datagram refers to gps_sdr_tpu" in res.stdout
    assert "FOREIGN []" in res.stdout, res.stdout
