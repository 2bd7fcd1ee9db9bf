#!/usr/bin/env python3
"""Both wipeoff kernels' bits against another version of their sources,
on one NVIDIA GPU.

    python3 wipeoff_bits.py OTHER_ROOT     # from the repository root

OTHER_ROOT is another checkout of the repository (e.g. the parent
commit, unpacked from `git archive` into a directory .gitignore lists).
Its gps_sdr_tpu_torch/csrc/wipeoff.cu and wipeoff_vpu.cu are compiled
with the product flags beside this checkout's libraries (cheap_bits.py
other_library) and launched through this checkout's mix_wipeoff and
mix_wipeoff_vpu (the argument structs are the same).  Both versions take
code periods on the 128-column tile grid: at cs 2048 (n_cyc 32, K=8: 11,
12 and 32 channels, and 12 channels of 3 streams over one shared chunk)
and at cs 16384 (n_cyc 8, corr_avg 4, K=8: 8 and 11 channels), on random
inputs (kernel_profile.py's) with the predicted wipeoff delays and with
chip_smoke.py's crafted ones, the second K-step of the chunk.  Every
output of every call must be bit-identical.  Prints the card's name and
power limit, then one JSON line; exits 1 on a difference.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke
from cheap_bits import other_library

KERNELS = {"wipeoff": ("mix_wipeoff", "cplx"),
           "wipeoff_vpu": ("mix_wipeoff_vpu", "planar")}


def cases():
    """(name, cfg, n_streams) of every case."""
    from gps_sdr_tpu_torch import ReceiverConfig

    product = ReceiverConfig()
    wide = product.replace(code_samples=16384, n_cyc=8, corr_avg=4)
    out = [(f"cs 2048, {n} ch", product.replace(max_sat=n), 1)
           for n in (11, 12, 32)]
    out.append(("cs 2048, 3 streams x 12 ch", product.replace(max_sat=12),
                3))
    out += [(f"cs 16384, {n} ch", wide.replace(max_sat=n), 1)
            for n in (8, 11)]
    return out


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from gps_sdr_tpu_torch.kernel_profile import _kernel_inputs
    from gps_sdr_tpu_torch.ops import _build, hopper_wipeoff

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    root = Path(argv[0]).resolve()
    libs = _build.load()
    others = {name: other_library(root, name) for name in KERNELS}
    n_calls, differ = 0, []
    for label, cfg, n_streams in cases():
        x = _kernel_inputs(cfg, dev, n_blocks=2 * cfg.blocks_per_step)
        crafted = chip_smoke.crafted_wipe(cfg, cfg.max_sat).to(dev)
        for wipe_name, wipe in (("predicted", x["wipe"]),
                                ("crafted", crafted)):
            args = [torch.cat([v] * n_streams) for v in
                    (x["s"], x["snp"], x["phase"], wipe, x["codes"])]
            for name, (fn, layout) in KERNELS.items():
                call = getattr(hopper_wipeoff, fn)
                mine = call(cfg, cfg.blocks_per_step, *args[:4], x[layout],
                            1, args[4], n_streams)
                saved, libs[name] = libs[name], others[name]
                try:
                    theirs = call(cfg, cfg.blocks_per_step, *args[:4],
                                  x[layout], 1, args[4], n_streams)
                finally:
                    libs[name] = saved
                torch.cuda.synchronize()
                n_calls += 1
                if not all(chip_smoke._same_bits(a, b)
                           for a, b in zip(mine, theirs)):
                    differ.append(f"{name}: {label}, {wipe_name} delays")
    print(json.dumps({"card": card, "cases": n_calls,
                      "bit_identical": n_calls - len(differ),
                      "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
