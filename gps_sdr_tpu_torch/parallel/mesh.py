"""Device meshes for the receiver on PyTorch.

Port of gps_sdr_tpu/parallel/mesh.py.  Two mesh axes, as in the JAX
package:

  * ``time`` - contiguous time shards of a long IQ stream; the carry
    state crosses shard boundaries by a ppermute to the right
    neighbour (parallel/tracking.py);
  * ``ch``   - channel (satellite) parallelism.

Acquisition reuses them as (Doppler bins x PRNs), and serving has a
one-axis ``stream`` mesh (runtime/serving.py).

JAX's shard_map runs one program from one controller over a mesh of
devices; the port keeps that model.  A Mesh here is an array of
torch.devices with named axes, and the sharded functions run each
shard's body on its device from the calling Python thread, one shard
after another (the device work of a CUDA shard is enqueued, so shards
on distinct cards overlap as far as the host keeps up).  A device may
appear more than once: a mesh of one card repeated is the port's
counterpart of the JAX tests' virtual CPU devices, and its shards run
one after the other on that card.

A mesh may also span processes (make_multihost_mesh): every process
calls the sharded functions with the same arguments, runs the bodies of
the positions it owns, and exchanges carry states (ppermute) and
results (all_gather) over torch.distributed.
"""

from __future__ import annotations

import math
import os
import socket
import sys

import numpy as np
import torch

from gps_sdr_tpu_torch.device import resolve_device

TIME_AXIS = "time"
CH_AXIS = "ch"
STREAM_AXIS = "stream"


class Mesh:
    """Named axes over an array of torch.devices.

    devices: object ndarray of torch.device, one axis per name;
    `shape` maps each axis name to its size (mesh.shape["time"]), as the
    JAX mesh's does.  A multi-process mesh also holds the process group,
    its backend, this process's rank and the rank that owns each
    position (`owners`); a single-process mesh owns every position."""

    def __init__(self, devices: np.ndarray, axis_names: tuple,
                 owners: np.ndarray | None = None, rank: int = 0,
                 group=None, backend: str | None = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else owners)
        self.rank = rank
        self.group = group
        self.backend = backend

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> list:
        """Every position (index tuple), row-major."""
        return list(np.ndindex(*self.devices.shape))

    def local_positions(self) -> list:
        """The positions this process runs, row-major."""
        return [p for p in self.positions() if self.owners[p] == self.rank]

    @property
    def home(self) -> torch.device:
        """Where this process collects results: its first position's
        device."""
        return self.devices[self.local_positions()[0]]

    # -- collectives ------------------------------------------------------

    def _comm_device(self) -> torch.device:
        # gloo exchanges host tensors (the few KB a channel of carry state
        # are staged through the host); nccl exchanges on this process's
        # first device
        return torch.device("cpu") if self.backend == "gloo" else self.home

    def ppermute(self, values: dict, axis: str) -> dict:
        """Cyclic shift along `axis`: position p's tensors go to the next
        position (mod the axis size), as jax.lax.ppermute with perm
        [(i, (i + 1) % n)].

        values: {local position: tuple of tensors}; returns {local
        position: the tuple received}, each tensor on the receiving
        position's device with its dtype.  Shards along an axis have
        equal shapes, so a receiver allocates its buffers like its own
        values."""
        ax = self.axis_names.index(axis)
        n = self.devices.shape[ax]

        def dest(pos):
            p = list(pos)
            p[ax] = (p[ax] + 1) % n
            return tuple(p)

        out, ops, pending = {}, [], []
        comm = self._comm_device()
        n_leaves = len(next(iter(values.values())))
        tag = 0             # counts cross-rank tensors in one global order
        for pos in self.positions():
            dst = dest(pos)
            src_rank, dst_rank = self.owners[pos], self.owners[dst]
            if src_rank == dst_rank:
                if src_rank == self.rank:
                    out[dst] = tuple(x.to(self.devices[dst])
                                     for x in values[pos])
                continue
            if src_rank == self.rank:
                for j, x in enumerate(values[pos]):
                    ops.append(torch.distributed.P2POp(
                        torch.distributed.isend, x.to(comm).contiguous(),
                        int(dst_rank), self.group, tag + j))
            elif dst_rank == self.rank:
                bufs = [torch.empty(x.shape, dtype=x.dtype, device=comm)
                        for x in values[dst]]
                for j, b in enumerate(bufs):
                    ops.append(torch.distributed.P2POp(
                        torch.distributed.irecv, b, int(src_rank),
                        self.group, tag + j))
                pending.append((dst, bufs))
            tag += n_leaves
        if ops:
            for req in torch.distributed.batch_isend_irecv(ops):
                req.wait()
        for dst, bufs in pending:
            out[dst] = tuple(b.to(self.devices[dst]) for b in bufs)
        return out

    def all_gather(self, values: dict, device) -> dict:
        """Every position's tensors on `device`.

        values: {local position: tuple of tensors}, the same shapes and
        dtypes at every position; returns {position: tuple} for all
        positions.  Across processes each rank stacks its positions'
        tensors and one all_gather a tensor collects them; rank p's
        positions are the p-th run of the row-major order."""
        if self.group is None:
            return {pos: tuple(x.to(device) for x in v)
                    for pos, v in values.items()}
        local = self.local_positions()
        world = torch.distributed.get_world_size(self.group)
        comm = self._comm_device()
        out = {pos: [] for pos in self.positions()}
        for j in range(len(values[local[0]])):
            mine = torch.stack([values[pos][j].to(comm) for pos in local])
            parts = [torch.empty_like(mine) for _ in range(world)]
            torch.distributed.all_gather(parts, mine, group=self.group)
            rows = torch.cat(parts).to(device)
            for pos, row in zip(self.positions(), rows):
                out[pos].append(row)
        return {pos: tuple(v) for pos, v in out.items()}


def _devices(devices, n_devices: int | None) -> list:
    """The first n_devices of `devices` (default: every CUDA device),
    each resolved; a CUDA device without CUDA raises."""
    if devices is None:
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   or ["cuda"])      # resolve_device says why none is
    devs = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    if not 0 < n_devices <= len(devs):
        raise ValueError(f"{n_devices} devices requested, {len(devs)} "
                         "given")
    return devs[:n_devices]


def _object_array(devs: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_stream_mesh(n_devices: int | None = None,
                     devices=None) -> Mesh:
    """One-axis ``stream`` mesh over the first n_devices of `devices`
    (default: every CUDA device) for serving scale-out: S independent
    receiver streams share no state, so the stream axis splits over
    devices without a collective (runtime/serving.py StreamServer)."""
    devs = _devices(devices, n_devices)
    return Mesh(_object_array(devs, (len(devs),)), (STREAM_AXIS,))


def factor2(n: int) -> tuple[int, int]:
    """Split n into (a, b), a*b == n, as square as possible with b >= a."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def _time_ch(n: int, time_shards: int | None) -> tuple[int, int]:
    if time_shards is None:
        return factor2(n)
    if n % time_shards:
        raise ValueError(f"{n} devices not divisible into "
                         f"{time_shards} time shards")
    return time_shards, n // time_shards


def make_mesh(n_devices: int | None = None,
              time_shards: int | None = None, devices=None) -> Mesh:
    """Build a (time, ch) mesh over the first n_devices of `devices`.

    devices: torch devices or their names, default every CUDA device; a
    name may repeat (["cpu"] * 8 in the tests, ["cuda:0"] * 8 on one
    card).  If time_shards is given, the ch axis gets n_devices //
    time_shards; otherwise the factorization is as square as possible."""
    devs = _devices(devices, n_devices)
    t, c = _time_ch(len(devs), time_shards)
    return Mesh(_object_array(devs, (t, c)), (TIME_AXIS, CH_AXIS))


def _pick_backend(peers: list) -> tuple[str, str]:
    """(backend, reason) from every rank's (host, local device names):
    the same on every rank."""
    owned = [(host, d) for host, devs in peers for d in set(devs)]
    if any(not d.startswith("cuda") for _, d in owned):
        return "gloo", "a rank holds CPU devices"
    if len(owned) != len(set(owned)):
        return "gloo", ("ranks share a CUDA device (nccl refuses two ranks "
                        "on one GPU)")
    return "nccl", "the ranks hold distinct CUDA devices"


def make_multihost_mesh(coordinator_address: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None,
                        time_shards: int | None = None,
                        devices=None) -> Mesh:
    """(time, ch) mesh spanning the local devices of every process.

    With a coordinator address ("host:port") or a process count, starts
    the torch.distributed group at tcp://coordinator_address (or from
    the environment when no address is given) with world size
    num_processes and rank process_id; with neither, and torchrun's
    environment (WORLD_SIZE > 1), starts it from the environment; an
    existing default group is used as it is.  Otherwise this is
    make_mesh.  A failed start raises.

    `devices` are this process's devices (default every CUDA device);
    every rank must hold as many.  The mesh lays all ranks' devices out
    in rank order, so rank p owns row-major positions [p*L, (p+1)*L).
    The group starts on gloo; its exchanges run on nccl when the ranks
    hold distinct CUDA devices, else on gloo with CUDA tensors staged
    through the host.  The choice is printed to stderr.  The caller
    ends the group (torch.distributed.destroy_process_group)."""
    import torch.distributed as dist

    want = (coordinator_address is not None or num_processes is not None
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if not dist.is_initialized():
        if not want:
            return make_mesh(None, time_shards, devices)
        # -1: the size or rank comes from the environment (torchrun's)
        dist.init_process_group(
            "gloo", init_method=(f"tcp://{coordinator_address}"
                                 if coordinator_address is not None
                                 else "env://"),
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    rank, world = dist.get_rank(), dist.get_world_size()
    local = _devices(devices, None)
    peers = [None] * world
    dist.all_gather_object(peers, (socket.gethostname(),
                                   [str(d) for d in local]))
    sizes = {len(devs) for _, devs in peers}
    if len(sizes) != 1:
        raise ValueError(f"ranks hold unequal device counts "
                         f"{[len(d) for _, d in peers]}")
    backend, why = _pick_backend(peers)
    group = dist.group.WORLD
    if backend == "nccl":
        torch.cuda.set_device(local[0])
        group = dist.new_group(backend="nccl")
    print(f"parallel: rank {rank}/{world}, backend {backend} ({why})",
          file=sys.stderr, flush=True)
    devs = [d for r, (_, names) in enumerate(peers)
            for d in (local if r == rank else map(torch.device, names))]
    t, c = _time_ch(len(devs), time_shards)
    owners = np.repeat(np.arange(world), len(local)).reshape(t, c)
    return Mesh(_object_array(devs, (t, c)), (TIME_AXIS, CH_AXIS),
                owners=owners, rank=rank, group=group, backend=backend)
