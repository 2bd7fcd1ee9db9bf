"""The fused K-step loop, eager or replayed as CUDA graphs.

On the card one K-step of ops/tracking.py _fused_steps is the two
hand-written kernels (hopper_wipeoff, hopper_cheap) and ~140 small
PyTorch kernels around them.  Enqueuing those from Python costs ~3 ms of
host time a K-step at the product configuration, against ~0.15 ms of
device work.  So on a CUDA device each K-step of a chunk is captured
once as a torch.cuda.CUDAGraph and replayed after: one graph launch
instead of ~140 enqueues.

A family of graphs serves every chunk of one key (graph_key: the
configuration, the channel and stream counts, and the chunk's shape,
dtype and device).  Graph j runs K-step j of the chunk.  It reads the
family's static inputs (chunk, first stream number, codes, spectrum)
and, past the first step, graph j-1's output state.  The graphs of a
family share one memory pool and are replayed in the order of their
capture.  The cache is module-level, so the graphs captured for one
Session serve the next one of the same shapes; it keeps the
MAX_FAMILIES most recently used.  Like the receiver loops that call it,
it is driven from one thread: a family's static buffers take one
chunk at a time.

A key's first chunk runs its steps eagerly on the family's side stream,
which builds the kernels, cuFFT plans and kernel attributes the capture
needs, and returns that result; the capture follows and runs nothing.
Every later chunk stages its inputs into the static buffers (a copy
each; the codes only when the caller's tables changed), replays the
graphs, and returns the final state as fresh tensors: nothing that a
later replay overwrites reaches the caller.  The steps' outputs reach it
through _fused_steps' concatenation, which makes fresh tensors too.

A replay runs the eager step's kernels in the same order on the same
inputs, so it gives the eager step's bits.  The hand-written kernels'
launch counters count what runs: a capture takes back its increments,
and a replay adds the launches that its capture recorded.  run counts
track.partial_tile_steps: the K-steps it runs, eagerly on a CUDA device
or replayed, whose wipeoff kernel runs a partial last column tile (a
code period off its 128-column grid, hopper_wipeoff.partial_tile).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from gps_sdr_tpu_torch.ops import corr, hopper_cheap, hopper_wipeoff
from gps_sdr_tpu_torch.utils.profiling import count, span

MAX_FAMILIES = 8

# the hand-written kernels' wrappers, whose .launches count real launches
_COUNTED = (hopper_wipeoff.mix_wipeoff, hopper_wipeoff.mix_wipeoff_vpu,
            hopper_cheap.cheap_scan)


class CudaGraphs:
    """Side stream, memory pool and captures of one family on a CUDA
    device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, fn):
        """fn() run eagerly on the side stream, ordered after and before
        the current stream's work."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn):
        """(replay, fn's outputs): fn captured into a graph, not run."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), \
                torch.cuda.graph(g, pool=self.pool, stream=self.stream):
            out = fn()
        return g.replay, out


# device type -> graph maker; a device type without one runs eagerly
BACKENDS = {"cuda": CudaGraphs}
_CACHE: OrderedDict = OrderedDict()


def graph_key(cfg, n_streams: int, states, chunk: torch.Tensor) -> tuple:
    """The key of the graph family that runs the K-steps of `chunk`:
    the whole (frozen) configuration, which holds K and every field the
    step reads, the channel count (over all streams), the stream count,
    and the chunk's layout (its shape: a shared or a per-stream chunk,
    complex or grouped planar, its block count), dtype and device."""
    return (cfg, int(states.prn.shape[0]), n_streams, chunk.dtype,
            tuple(chunk.shape), chunk.device)


def partial_tile_steps(cfg, chunk: torch.Tensor) -> bool:
    """Whether the K-steps of `chunk` run a wipeoff kernel on a partial
    last column tile: on a CUDA device, at a code period off the
    kernels' tile grid."""
    return chunk.device.type == "cuda" and \
        hopper_wipeoff.partial_tile(cfg.code_samples)


def run_eager(step, states, chunk, n_steps: int, stream_no0, codes, spec):
    """The chunk's K-steps enqueued one by one: (final state, [each
    step's ChannelOut])."""
    outs = []
    for j in range(n_steps):
        with span("track.kstep"):
            states, out = step(states, chunk, j, stream_no0, codes, spec)
        outs.append(out)
    return states, outs


def run(cfg, n_streams: int, step, states, chunk, n_steps: int,
        stream_no0: int, codes, code_ffts):
    """The chunk's K-steps: (final state, [each step's ChannelOut]).
    On a device with graphs they are replayed from their family, or run
    eagerly while the family is captured; elsewhere they run eagerly.

    step(states, chunk, j, stream_no0, codes, spec) -> (states, out) is
    K-step j of the chunk; stream_no0 reaches it as an int32 scalar
    tensor on the chunk's device when captured."""
    if partial_tile_steps(cfg, chunk):
        count("track.partial_tile_steps", n_steps)
    if chunk.device.type not in BACKENDS:
        return run_eager(step, states, chunk, n_steps, stream_no0, codes,
                         corr.prep_spec(code_ffts))
    key = graph_key(cfg, n_streams, states, chunk)
    fam = _CACHE.get(key)
    if fam is None:
        backend = BACKENDS[chunk.device.type](chunk.device)
        spec = corr.prep_spec(code_ffts)
        result = backend.warm_up(lambda: run_eager(
            step, states, chunk, n_steps, stream_no0, codes, spec))
        with span("track.graph_stage"):
            fam = _Family(backend, step, states, chunk, n_steps,
                          stream_no0, codes, code_ffts)
        count("track.graph_captures", n_steps)
        _CACHE[key] = fam
        while len(_CACHE) > MAX_FAMILIES:
            _CACHE.popitem(last=False)
        return result
    _CACHE.move_to_end(key)
    return fam.replay(states, chunk, stream_no0, codes, code_ffts)


class _Family:
    """The static inputs and the captured steps of one key."""

    def __init__(self, backend, step, states, chunk, n_steps: int,
                 stream_no0: int, codes, code_ffts):
        self.chunk = chunk.clone()
        self.states = type(states)(*(x.clone() for x in states))
        self.sno = torch.tensor(stream_no0, dtype=torch.int32,
                                device=chunk.device)
        self.codes = codes.clone()
        self.spec = corr.prep_spec(code_ffts).clone()
        self._tables = (codes, codes._version, code_ffts,
                        code_ffts._version)
        self.steps = []           # (replay, launches it adds, out)
        st = self.states
        for j in range(n_steps):
            before = [f.launches for f in _COUNTED]
            replay, (st, out) = backend.capture(
                lambda st=st, j=j: step(st, self.chunk, j, self.sno,
                                        self.codes, self.spec))
            launches = []
            for f, b in zip(_COUNTED, before):
                launches.append(f.launches - b)
                f.launches = b
            self.steps.append((replay, launches, out))
        self.final = st

    def _same_tables(self, codes, code_ffts) -> bool:
        """Whether codes and code_ffts are the tables last staged, not
        written since.  The family holds those, so their memory cannot
        pass to another tensor: the same address, shape and strides
        mean the same tensor or a view of it, and the version counter,
        which views share, says whether it was written."""
        def same(x, old, ver):
            return (x.data_ptr() == old.data_ptr() and x.shape == old.shape
                    and x.stride() == old.stride() and x._version == ver)
        c0, cv, f0, fv = self._tables
        return same(codes, c0, cv) and same(code_ffts, f0, fv)

    def replay(self, states, chunk, stream_no0: int, codes, code_ffts):
        with span("track.graph_stage"):
            self.chunk.copy_(chunk)
            for dst, src in zip(self.states, states):
                dst.copy_(src)
            self.sno.fill_(stream_no0)
            if not self._same_tables(codes, code_ffts):
                self.codes.copy_(codes)
                self.spec.copy_(corr.prep_spec(code_ffts))
                self._tables = (codes, codes._version, code_ffts,
                                code_ffts._version)
        outs = []
        for replay, launches, out in self.steps:
            with span("track.kstep"):
                replay()
                for f, n in zip(_COUNTED, launches):
                    f.launches += n
                count("track.graph_replays")
            outs.append(out)
        with span("track.graph_stage"):
            final = type(self.final)(*(x.clone() for x in self.final))
        return final, outs
