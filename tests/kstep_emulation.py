"""A CPU stand-in for ops/kstep_graphs.py CudaGraphs, for the tests: a
capture runs the step once for its output tensors, and a replay runs it
again on the static inputs as they are then and writes its results into
those same tensors, as a CUDA graph writes its static outputs.  With
`emulated(monkeypatch)` the K-steps of CPU chunks go through the graph
cache, its staging and its chained steps on the plain path."""

from gps_sdr_tpu_torch.ops import kstep_graphs


def leaves(out) -> list:
    """The tensors of a step's (ChannelState, ChannelOut)."""
    return [*out[0], *out[1]]


class Emulated:
    def __init__(self, device):
        self.device = device

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        out = fn()

        def replay():
            for dst, src in zip(leaves(out), leaves(fn())):
                dst.copy_(src)
        return replay, out


def emulated(monkeypatch) -> None:
    """Run CPU K-steps through an empty graph cache with Emulated."""
    monkeypatch.setattr(kstep_graphs, "BACKENDS", {"cpu": Emulated})
    monkeypatch.setattr(kstep_graphs, "_CACHE", type(kstep_graphs._CACHE)())
