"""Share of the fused K-steps that ran as a CUDA-graph replay, in %:
gps_sdr_tpu_torch.utils.profiling's track.graph_replays counter over
the count of its track.kstep span (ops/kstep_graphs.py), from set-up's
warm-up session and the untraced window: spans and counters add nothing
while the profiler runs.  The K-steps that ran eagerly while their
graphs were captured (a shape's first chunk, in the warm-up session)
count against it.  None where the program keeps no such totals,
captured no graph (a program without the mechanism, or one on the CPU)
or recorded no K-step."""


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    snap = profiling.snapshot()
    counts = snap["counts"]
    sp = snap["spans"].get("track.kstep")
    if "track.graph_captures" not in counts or sp is None \
            or not sp["count"]:
        return None
    return 100.0 * counts.get("track.graph_replays", 0) / sp["count"]
