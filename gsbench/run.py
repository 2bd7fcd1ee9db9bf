"""Run one cell of the benchmark once.

    python3 -m gsbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 gsbench/run.py ...        (the same)

From the root of a checkout that holds the receiver package
(gps_sdr_tpu_torch).  The last line of standard output is the result,
one JSON object; the last lines of standard error are the numbers the
check compared, each beside its limit.  Without as many CUDA devices as
the cell asks for the run fails and prints no result; it never falls
back to the CPU.  Kernel and compiler caches stay inside the checkout
(build/), the captures go to a temporary directory under TMPDIR.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the receiver's host work is one Python
# thread, and pools of BLAS or intra-op threads only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FOREIGN = ("jax", "jaxlib", "flax", "gps_sdr_tpu")


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: gps_sdr_tpu_torch is not gps_sdr_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = os.path.join(ROOT, "build", "gsbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")

    from gsbench import harness, manifest

    try:
        cell, _, _ = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    except (OSError, KeyError, StopIteration) as e:
        print(f"gsbench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"gsbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"gsbench: {args.workload} seed {args.seed} on {power_limit()}",
          file=sys.stderr)
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace),
                         [f"cuda:{i}" for i in range(cell["chips"])],
                         T_START, ROOT)
    bad = foreign_modules()
    if bad:
        print(f"gsbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    report(result)
    return 0


def report(result: dict) -> None:
    """Earlier lines on standard error, the checks as its last lines,
    the result as the last line of standard output."""
    stats = result.get("stats", {})
    print("gsbench: window " + json.dumps(stats, default=_plain),
          file=sys.stderr)
    if "per_device_busy_s" in result:
        print("gsbench: busy s by device "
              + json.dumps(result["per_device_busy_s"]), file=sys.stderr)
    for note in result.get("notes", []):
        print("gsbench: failed " + note, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {json.dumps(c['value'], default=_plain)} "
              f"limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, default=_plain), flush=True)


def _plain(x):
    """NumPy scalars as Python numbers in the result line."""
    if hasattr(x, "item"):
        return x.item()
    raise TypeError(f"{type(x).__name__} in the result")


if __name__ == "__main__":
    sys.exit(main())
