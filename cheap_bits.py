#!/usr/bin/env python3
"""The cheap kernel's bits against another version of its source, on one
NVIDIA GPU.

    python3 cheap_bits.py OTHER_ROOT       # from the repository root

OTHER_ROOT is another checkout of the repository (e.g. the parent
commit, unpacked from `git archive` into a directory .gitignore lists).
Its gps_sdr_tpu_torch/csrc/cheap.cu is compiled with the product flags
beside this checkout's libraries and launched through this checkout's
cheap_scan (the argument struct is the same); both kernels then take
chip_smoke.py phase 3's cases at n_cyc 8, 16 and 32: the 8 chained
K-steps at the product configuration (11 channels, K=8, cs 2048) with
that n_cyc, and the crafted case (cheap_case) there and at the tests'
small configuration.  Every output of every call must be bit-identical.
Prints the card's name and power limit, then one JSON line; exits 1 on
a difference.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke


def other_library(root: Path, name: str = "cheap") -> ctypes.CDLL:
    """OTHER_ROOT's csrc/<name>.cu compiled with the product flags, loaded
    with this checkout's C signature of that kernel."""
    from gps_sdr_tpu_torch.ops import _build

    src = root / "gps_sdr_tpu_torch" / "csrc" / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"libgsdr_{name}_other_{tag}.so"
    _build.compile_libraries(
        {f"{name}_other": ([_build.nvcc(), *_build.NVCC_FLAGS, str(src)],
                           lib)})
    dll = ctypes.CDLL(str(lib))
    entry, args = _build.ENTRIES[name]
    fn = getattr(dll, entry)
    fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dll.gsdr_error_string.argtypes = [ctypes.c_int]
    dll.gsdr_error_string.restype = ctypes.c_char_p
    return dll


def both(args, other) -> tuple:
    """cheap_scan(*args) with this checkout's kernel, then with other's."""
    import torch
    from gps_sdr_tpu_torch.ops import _build, hopper_cheap

    libs = _build.load()
    mine = hopper_cheap.cheap_scan(*args)
    saved, libs["cheap"] = libs["cheap"], other
    try:
        theirs = hopper_cheap.cheap_scan(*args)
    finally:
        libs["cheap"] = saved
    torch.cuda.synchronize()
    return mine, theirs


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from gps_sdr_tpu_torch import ReceiverConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    other = other_library(Path(argv[0]).resolve())
    product = ReceiverConfig()
    small = product.replace(code_samples=256, n_cyc=8, corr_avg=4,
                            sweep_corr_avg=2, blocks_per_step=4,
                            corr_q_window_sec=2)
    cases = []
    for n_cyc in (8, 16, 32):
        cfg = product.replace(n_cyc=n_cyc)
        st, chunk, codes, ffts = chip_smoke.make_case(
            cfg, cfg.max_sat, cfg.no_sec, 7, dev, on_card=True)
        for i, args in enumerate(chip_smoke.cheap_chain_args(
                cfg, st, chunk, codes, ffts)):
            cases.append((f"n_cyc {n_cyc} chain step {i}", args))
        cases.append((f"n_cyc {n_cyc} crafted", chip_smoke.cheap_case(
            cfg, cfg.max_sat, 3, dev)[0]))
    cases.append(("small crafted", chip_smoke.cheap_case(small, 4, 3,
                                                         dev)[0]))
    differ = []
    for name, args in cases:
        mine, theirs = both(args, other)
        if not all(chip_smoke._same_bits(a, b)
                   for a, b in zip(mine, theirs)):
            differ.append(name)
    print(json.dumps({"card": card, "cases": len(cases),
                      "bit_identical": len(cases) - len(differ),
                      "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
