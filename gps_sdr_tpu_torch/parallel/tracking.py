"""Sharded tracking: channels over ``ch``, stream time over ``time``.

Port of gps_sdr_tpu/parallel/tracking.py.  Channels are a sharded batch
axis of the K=1 tracking step: each ``ch`` shard tracks its own
channels and nothing crosses between them.  A long stream is split into
contiguous ``time`` shards; each shard scans its blocks locally, then
the shard-final states pass to the right neighbour (Mesh.ppermute) and
the scan re-runs from them.  Shard 0 always starts from the initial
states.  On pass 1 every other shard starts from the initial states
too, at its own stream number, so the stream-skip eraser (channel_step)
fires there as it does in the JAX package.

Two stitch strategies, as in the JAX package:

  * exact re-scan: n_stitch passes; after pass k shards 0..k-1 hold the
    sequential carry, and n_stitch = the time-axis size reproduces the
    sequential scan;
  * state handoff (warmup_blocks = W): one ppermute of the pass-1 final
    states and a re-scan of each shard's first min(W, t_local) blocks,
    spliced in front of pass 1's later blocks.

The host-side epoch pipeline consumes the stacked per-block outputs in
stream order, so decode and PVT do not see how tracking was sharded.
"""

from __future__ import annotations

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.ops.tracking import (ChannelOut, ChannelState,
                                            track_chunk_impl)
from gps_sdr_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh


def _like(x, pad):
    """`pad` zero rows after x's channel axis, in x's type (numpy array
    or tensor, on x's device)."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


def pad_channels(states: ChannelState, codes, code_ffts, mult: int):
    """Pad the channel axis up to a multiple of the ch mesh-axis size.

    Padded slots are zeros: inactive (prn=0), like the reference's empty
    worker slots.  codes and code_ffts keep their type (numpy or
    tensor)."""
    c = int(states.prn.shape[0])
    rem = (-c) % mult
    if rem == 0:
        return states, codes, code_ffts
    return (ChannelState(*(_like(x, rem) for x in states)),
            _like(codes, rem), _like(code_ffts, rem))


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def _splice(head: ChannelOut, tail: ChannelOut, w: int) -> ChannelOut:
    return ChannelOut(*(torch.cat([a, b[w:]]) for a, b in zip(head, tail)))


def track_sharded(cfg: ReceiverConfig, mesh: Mesh, states: ChannelState,
                  blocks, stream_no0, codes, code_ffts,
                  n_stitch: int | None = None,
                  warmup_blocks: int | None = None
                  ) -> tuple[ChannelState, ChannelOut]:
    """Track T blocks over the (time, ch) mesh.

    blocks: [T, ngps] complex64, [T, ngps, 2] f32 or grouped planar
    [T, 2, n_cyc, cs] f32 (numpy or a tensor), T divisible by the
    time-axis size; states/codes/code_ffts with channel axes divisible
    by the ch-axis size (use pad_channels).  Each shard's inputs are
    copied to its device.  Returns (final_states, outs) on the mesh's
    home device: final_states is the last time shard's state [C, ...]
    and outs are stacked in stream order [T, C, ...].  Across processes
    every rank returns the whole result.

    Stitch strategy: warmup_blocks=W runs one state handoff and a
    W-block re-scan a shard; otherwise n_stitch full passes, by default
    the time-axis size (sequential-exact)."""
    n_time = mesh.shape[TIME_AXIS]
    c_size = mesh.shape[CH_AXIS]
    if warmup_blocks is None:
        warmup_blocks = 0
        if n_stitch is None:
            n_stitch = n_time
    else:
        n_stitch = 1
    t = blocks.shape[0]
    if t % n_time:
        raise ValueError(f"T={t} not divisible by time shards {n_time}")
    c = int(states.prn.shape[0])
    if c % c_size:
        raise ValueError(f"{c} channels not divisible by ch axis {c_size}"
                         " (use pad_channels)")
    t_loc, c_loc = t // n_time, c // c_size
    stream_no0 = int(stream_no0)
    local = mesh.local_positions()

    # each shard's inputs on its device (a time shard's blocks are copied
    # once a device, whatever the ch shards on it)
    blk, init0, args = {}, {}, {}
    for ti, ci in local:
        dev = mesh.devices[ti, ci]
        if (ti, dev) not in blk:
            blk[ti, dev] = _on(blocks[ti * t_loc:(ti + 1) * t_loc], dev)
        ch = slice(ci * c_loc, (ci + 1) * c_loc)
        init0[ti, ci] = ChannelState(*(_on(x[ch], dev) for x in states))
        args[ti, ci] = (_on(codes[ch], dev), _on(code_ffts[ch], dev))

    def scan(pos, init, n_blocks=t_loc):
        ti = pos[0]
        return track_chunk_impl(cfg, init,
                                blk[ti, mesh.devices[pos]][:n_blocks],
                                stream_no0 + ti * t_loc, *args[pos])

    def handoff(finals):
        # shard 0's true initial state IS states0; every other shard
        # starts from its left neighbour's final state
        recv = mesh.ppermute({p: tuple(f) for p, f in finals.items()},
                             TIME_AXIS)
        return {p: init0[p] if p[0] == 0 else ChannelState(*recv[p])
                for p in local}

    finals, outs = {}, {}
    for pos in local:
        finals[pos], outs[pos] = scan(pos, init0[pos])
    if warmup_blocks > 0 and n_time > 1:
        w = min(warmup_blocks, t_loc)
        inits = handoff(finals)
        for pos in local:
            final2, outs2 = scan(pos, inits[pos], w)
            outs[pos] = _splice(outs2, outs[pos], w)
            if w == t_loc:
                finals[pos] = final2
    else:
        for _ in range(max(n_stitch - 1, 0)):
            inits = handoff(finals)
            for pos in local:
                finals[pos], outs[pos] = scan(pos, inits[pos])

    home = mesh.home
    outs = mesh.all_gather({p: tuple(o) for p, o in outs.items()}, home)
    finals = mesh.all_gather({p: tuple(f) for p, f in finals.items()},
                             home)
    final = ChannelState(*(torch.cat(f) for f in zip(*(
        finals[n_time - 1, ci] for ci in range(c_size)))))
    rows = [ChannelOut(*(torch.cat(f, dim=1) for f in zip(*(
        outs[ti, ci] for ci in range(c_size))))) for ti in range(n_time)]
    return final, ChannelOut(*(torch.cat(f) for f in zip(*rows)))
