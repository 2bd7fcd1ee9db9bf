"""The check's control: the reference, one precision down, in the
receiver's place.

The receiver states float64 for its geometry (orbits, light time,
pseudoranges, fixes).  The control answers every question the check
asks of a receiver with the reference computed in float32: the
acquisition's Doppler and delay, every block's code phase, each epoch's
carrier frequency, the ephemerides, and a fix at each epoch.  Judged
against the float64 reference at the cell's own size it has to come
out not correct:

    python3 -m gsbench.control --workload rtl12.replay --seeds 1 2 3

prints each seed's numbers beside the limits.  It needs no card: it
makes the cell's scenarios (not their IQ) from each seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gsbench import generator, judge, manifest
from gsbench import reference as ref
from gsbench import scenario as sc
from gsbench import synth


def scenarios(traffic: dict, config: dict, seed: int) -> list:
    """The cell's captures without their IQ (scenario and length)."""
    shape = generator.shape_of(config)
    bs = shape["n_cyc"] * shape["code_samples"] / shape["fs"]
    return [generator.Capture(
        i, sc.make_scenario(synth.capture_seed(seed, i),
                            traffic["satellites"],
                            traffic["blocks"] * bs + 6.0),
        traffic["blocks"])
        for i in range(generator.n_captures(traffic, config))]


def records(captures: list, shape: dict, dtype=np.float32,
            chunk: int = 32) -> list:
    """The answers of the reference in `dtype`, shaped as a receiver's:
    an epoch a chunk, a fix at each epoch's end."""
    out = []
    for cap in captures:
        scn = cap.scn
        rec = judge.StreamRecord(cap.index, first_sno=1)
        rec.found = ref.acquisition(scn, shape, dtype)
        blocks = np.arange(cap.n_blocks)
        cp = {s.prn: ref.code_phase(scn, s, shape, blocks, dtype)
              for s in scn.sats}
        dop = {s.prn: ref.doppler(scn, s, shape, blocks, dtype)
               for s in scn.sats}
        pos = []
        for b0 in range(0, cap.n_blocks, chunk):
            b = blocks[b0:b0 + chunk]
            rec.epochs.append(judge.Answers(
                {p: judge.Series(b + 1, v[b].astype(np.float64))
                 for p, v in cp.items()},
                [{"SAT": p, "FRQ": float(v[b[-1]])} for p, v in
                 dop.items()]))
            t = float(ref.block_centres(scn, shape, [b[-1]])[0])
            pos.append([t, *ref.fix(scn, t, dtype)])
        rec.ephemerides = ref.ephemerides(scn, dtype)
        rec.positions = np.asarray(pos)
        rec.due_end = cap.n_blocks
        rec.complete = True
        out.append(rec)
    return out


def run(workload: str, seed: int, dtype=np.float32,
        resize: dict | None = None) -> dict:
    """judge.judge of the control's answers for one seed of a cell."""
    _, config, traffic = manifest.cell(manifest.load(), workload)
    if resize:
        traffic = dict(traffic, **resize.get("traffic", {}))
        config = dict(config, **resize.get("config", {}))
    shape = generator.shape_of(config)
    caps = scenarios(traffic, config, seed)
    return judge.judge(records(caps, shape, dtype),
                       judge.Reference(caps, shape), config, traffic["due"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    failed = 0
    for seed in args.seeds:
        v = run(args.workload, seed)
        failed += not v["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": v["correct"], "checks": v["checks"]}))
    print(f"control not correct on {failed} of {len(args.seeds)} seeds",
          file=sys.stderr)
    return 0 if failed == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
