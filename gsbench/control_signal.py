"""The check's second control: the program's signal processing one
precision down.

The configuration states float32 for the signal processing.  The
wipeoff's contraction, the one stage whose arithmetic a faster kernel
would be tempted to cut, runs on the tensor cores in the 3xTF32 split,
which carries float32's precision.  This control switches the program
to TF32, as the port's own mirror of that kernel computes it with a
single TF32 pass (hopper_wipeoff._mix_wipeoff_mxu_math, rounding
"tf32"), with TF32 allowed in every PyTorch matmul besides; or, with
--precision bf16, to bfloat16 inputs of that contraction.  It then
runs the cell as a run of the benchmark does, on the card, and prints
each seed's numbers beside the limits:

    python3 -m gsbench.control_signal --workload rtl12.replay6sat \
        --seeds 1 2 3 --seconds 20 [--precision tf32|bf16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

PRECISIONS = ("tf32", "bf16")


def _bf16(x, truncate: bool = False):
    """f32 rounded to bfloat16 (8 mantissa bits) and back."""
    import torch
    return x.to(torch.bfloat16).to(torch.float32)


def plant(precision: str):
    """Switch the program's wipeoff contraction (and PyTorch's matmuls)
    to `precision`; returns (the lowered wipeoff, a function that undoes
    the switch).  The lowered wipeoff counts its calls in .launches."""
    import torch

    from gps_sdr_tpu_torch.ops import hopper_wipeoff as hw
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    saved = (hw.mix_wipeoff, hw._tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)

    def one(cfg, k, s, snp, phase, wipe, chunk, step, codes):
        blocks = chunk[step * k:(step + 1) * k].reshape(
            k, cfg.n_cyc, cfg.code_samples)
        return hw._mix_wipeoff_mxu_math(cfg, k, s, snp, phase, wipe,
                                        blocks.real, blocks.imag, codes,
                                        rounding="tf32")

    def lowered(cfg, k, s, snp, phase, wipe, chunk, step, codes,
                n_streams=1):
        lowered.launches += 1
        return hw._over_streams(one, 2, "wipeoff", cfg, k, s, snp, phase,
                                wipe, chunk, step, codes, n_streams)

    lowered.launches = 0
    hw.mix_wipeoff = lowered
    if precision == "bf16":
        hw._tf32 = _bf16
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    def undo():
        (hw.mix_wipeoff, hw._tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return lowered, undo


def run(workload: str, seed: int, seconds: float, precision: str,
        devices: list, root: str | None = None,
        resize: dict | None = None) -> dict:
    """One run of the cell with the signal processing at `precision`:
    the harness's result, with the lowered wipeoff's calls in
    stats["lowered_launches"]."""
    from gsbench import harness, manifest
    lowered, undo = plant(precision)
    try:
        out = harness.run(workload, seed, seconds, False, devices,
                          time.perf_counter(), root=root or manifest.ROOT,
                          resize=resize)
    finally:
        undo()
    out["stats"]["lowered_launches"] = lowered.launches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--precision", choices=PRECISIONS, default="tf32")
    args = ap.parse_args(argv)
    import torch

    from gsbench import manifest
    chips = manifest.cell(manifest.load(), args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: the control of {args.workload} needs {chips} CUDA "
              "device(s)", file=sys.stderr)
        return 3
    n_correct = 0
    for seed in args.seeds:
        out = run(args.workload, seed, args.seconds, args.precision,
                  [f"cuda:{i}" for i in range(chips)])
        n_correct += out["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "launches": out["stats"]["lowered_launches"],
                          "checks": out["checks"]},
                         default=lambda x: x.item()), flush=True)
    print(f"control {args.precision}: correct on {n_correct} of "
          f"{len(args.seeds)} seeds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
