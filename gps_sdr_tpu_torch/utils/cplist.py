"""Array-backed (stream_no, value) series for the code-phase plumbing.

The reference hands code phases around as Python lists of
(streamNo, codePhase) tuples (gpsrecv.py:509-519 pickles them per
second; gpseval.py walks them entry by entry).  That shape leaks into
every hot host function here — the receiver built the lists with
zip/tolist, the unwrap re-read them with fromiter, the pseudorange
walk re-read them again with a comprehension.  At serving scale
(hundreds of thousands of entries per second across streams) the
tuple<->array round trips were ~30% of the whole host evaluator.

CodePhaseList keeps the series as two numpy arrays and duck-types just
enough of the list-of-pairs protocol (len/iter/index/slice/eq/pickle)
that every existing surface — UDP transport pickles, JSON export,
tests that build plain lists — keeps working; the hot consumers call
`cp_arrays` and skip the tuple detour entirely.  Plain lists remain
accepted everywhere: `cp_arrays` is the single conversion point.
"""

from __future__ import annotations

import pickle

import numpy as np

__all__ = ["CodePhaseList", "CodePhaseUnpickler", "FOREIGN_PACKAGES",
           "cp_arrays", "cp_concat", "plain_series"]

# top-level packages of the JAX package and of JAX, whose classes the
# port never unpickles
FOREIGN_PACKAGES = frozenset({"gps_sdr_tpu", "jax", "jaxlib"})


class CodePhaseList:
    """Immutable-ish array-backed sequence of (stream_no, value) pairs."""

    __slots__ = ("snos", "vals")

    def __init__(self, snos, vals):
        self.snos = np.asarray(snos, np.int64)
        self.vals = np.asarray(vals, np.float64)

    @classmethod
    def from_pairs(cls, pairs) -> "CodePhaseList":
        if isinstance(pairs, CodePhaseList):
            return pairs
        n = len(pairs)
        snos = np.fromiter((e[0] for e in pairs), np.int64, n)
        vals = np.fromiter((e[1] for e in pairs), np.float64, n)
        return cls(snos, vals)

    def __len__(self) -> int:
        return self.snos.shape[0]

    def __bool__(self) -> bool:
        return self.snos.shape[0] > 0

    def __iter__(self):
        return zip(self.snos.tolist(), self.vals.tolist())

    def __getitem__(self, i):
        if isinstance(i, slice):
            return CodePhaseList(self.snos[i], self.vals[i])
        return (int(self.snos[i]), float(self.vals[i]))

    def __eq__(self, other):
        if isinstance(other, CodePhaseList):
            return (np.array_equal(self.snos, other.snos)
                    and np.array_equal(self.vals, other.vals))
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"CodePhaseList(n={len(self)})"

    # pickle via the arrays (UDP transport / session recording)
    def __reduce__(self):
        return (CodePhaseList, (self.snos, self.vals))


class CodePhaseUnpickler(pickle.Unpickler):
    """Unpickles epochs written by either package: the JAX package's
    CodePhaseList (gps_sdr_tpu.utils.cplist) is read as the port's, and
    any other class whose top package is the JAX package's or JAX's
    raises a ValueError naming it (`what` says what was being read),
    before its module is imported."""

    def __init__(self, file, what: str):
        super().__init__(file)
        self.what = what

    def find_class(self, module, name):
        if (module, name) == ("gps_sdr_tpu.utils.cplist", "CodePhaseList"):
            return CodePhaseList
        # the top package, not a prefix: gps_sdr_tpu_torch is the port's
        if module.split(".")[0] in FOREIGN_PACKAGES:
            raise ValueError(f"{self.what} refers to {module}.{name}")
        return super().find_class(module, name)


def plain_series(series: dict) -> dict:
    """{sat: [(stream_no, value), ...]} as plain lists of tuples, which
    either package unpickles without the other."""
    return {sat: list(lst) for sat, lst in series.items()}


def cp_arrays(lst) -> tuple[np.ndarray, np.ndarray]:
    """(snos int64[N], values float64[N]) view of a code-phase series,
    whatever its container (CodePhaseList: zero-copy)."""
    if isinstance(lst, CodePhaseList):
        return lst.snos, lst.vals
    n = len(lst)
    snos = np.fromiter((e[0] for e in lst), np.int64, n)
    vals = np.fromiter((e[1] for e in lst), np.float64, n)
    return snos, vals


def cp_concat(parts) -> "CodePhaseList | list":
    """Concatenate code-phase series (merge_epochs throughput mode).

    A single part passes through unchanged; a poison-pill list (value
    None — evaluator._prep_code_phases) can't be array-backed and
    falls back to plain list concatenation."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return []
    if len(parts) == 1:
        return parts[0]
    if any(not isinstance(p, CodePhaseList)
           and any(e[1] is None for e in p) for p in parts):
        out: list = []
        for p in parts:
            out.extend(p)
        return out
    arrs = [cp_arrays(p) for p in parts]
    return CodePhaseList(np.concatenate([a[0] for a in arrs]),
                         np.concatenate([a[1] for a in arrs]))
