"""Navigation-message codec and bit assembly (host side).

Replaces the reference's Subframe class (src/gpslib.py:96-419), the
edge->bit framing logicalBits (src/gpslib.py:1465-1492) and the preamble
search / subframe extraction evalGpsBits (src/gpslib.py:1504-1580).

Unlike the reference this module is symmetric: one declarative field
table drives BOTH decoding and the encoder that the signal simulator
uses to synthesize bit streams — the closed loop the reference never
had.  Runs on the host: nav bits arrive at 50 bps/channel, six orders of
magnitude below the IQ stream, so this layer is bookkeeping (SURVEY.md
section 7.4).

Conventions (matching IS-GPS-200 and the reference decoder):
  * A subframe is 300 bits = 10 words x 30 bits; bits here are 0/1 in
    the *source* domain (after undoing the D30 complement).
  * Parity: D25..D30 computed from the previous word's transmitted bits
    29/30 (DS29/DS30) and the current word's 24 source bits
    (gpslib.py:379-405).  Word 1 (TLM) parity is not checkable without
    the preceding word and is skipped, as in the reference.
  * The preamble is 10001011; reception may be globally inverted
    (gpslib.py:287-292).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gps_sdr_tpu_torch.config import GPS_PI, SUBFRAME_BITS

PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int8)
PREAMBLE_PM = (2 * PREAMBLE - 1).astype(np.int8)

# Parity tap tables: source-bit indices (0..23) feeding each parity bit,
# plus which of (DS29, DS30) seeds it.
_PAR_TAPS = {
    24: ("DS29", [0, 1, 2, 4, 5, 9, 10, 11, 12, 13, 16, 17, 19, 22]),
    25: ("DS30", [1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23]),
    26: ("DS29", [0, 2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21]),
    27: ("DS30", [1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22]),
    28: ("DS30", [0, 2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23]),
    29: ("DS29", [2, 4, 5, 7, 8, 9, 10, 12, 14, 18, 21, 22, 23]),
}


# tap matrix [6, 24] and seed-source row selector for the vectorized form
_TAPS_MAT = np.zeros((6, 24), dtype=np.int8)
_SEED29 = np.zeros(6, dtype=np.int8)
for _k in range(24, 30):
    _s, _taps = _PAR_TAPS[_k]
    _TAPS_MAT[_k - 24, _taps] = 1
    _SEED29[_k - 24] = 1 if _s == "DS29" else 0


def word_parity(d: np.ndarray, ds29: int, ds30: int) -> np.ndarray:
    """Six parity bits for 24 source bits `d` given the previous word's
    transmitted bits 29/30."""
    seed = np.where(_SEED29 == 1, ds29, ds30)
    return ((seed + _TAPS_MAT @ d.astype(np.int32)) % 2).astype(np.int8)


def words_parity(d: np.ndarray, ds29: np.ndarray,
                 ds30: np.ndarray) -> np.ndarray:
    """word_parity for a batch: d[N, 24], ds29/ds30[N] -> [N, 6].

    One matmul replaces the reference's per-word tap loop
    (gpslib.py:379-405) across all N words at once."""
    seed = np.where(_SEED29[None, :] == 1, ds29[:, None], ds30[:, None])
    return ((seed + d.astype(np.int32) @ _TAPS_MAT.T) % 2).astype(np.int8)


# -- declarative field layout -------------------------------------------------
# (name, [(word, lo, hi), ...], signed, scale); bit spans concatenate MSB
# first across words; scale multiplies the (two's-complement) integer.

_COMMON = [
    ("tow", [(1, 0, 17)], False, 1),
    ("ID", [(1, 19, 22)], False, 1),
]

_SF_FIELDS = {
    1: [
        ("weekNum", [(2, 0, 10)], False, 1),
        ("satAcc", [(2, 12, 16)], False, 1),
        ("satHealth", [(2, 16, 22)], False, 1),
        ("IODC", [(2, 22, 24), (7, 0, 8)], False, 1),
        ("Tgd", [(6, 16, 24)], True, 2.0 ** -31),
        ("Toc", [(7, 8, 24)], False, 16),
        ("af2", [(8, 0, 8)], True, 2.0 ** -55),
        ("af1", [(8, 8, 24)], True, 2.0 ** -43),
        ("af0", [(9, 0, 22)], True, 2.0 ** -31),
    ],
    2: [
        ("IODE2", [(2, 0, 8)], False, 1),
        ("Crs", [(2, 8, 24)], True, 2.0 ** -5),
        ("deltaN", [(3, 0, 16)], True, 2.0 ** -43 * GPS_PI),
        ("M0", [(3, 16, 24), (4, 0, 24)], True, 2.0 ** -31 * GPS_PI),
        ("Cuc", [(5, 0, 16)], True, 2.0 ** -29),
        ("e", [(5, 16, 24), (6, 0, 24)], False, 2.0 ** -33),
        ("Cus", [(7, 0, 16)], True, 2.0 ** -29),
        ("sqrtA", [(7, 16, 24), (8, 0, 24)], False, 2.0 ** -19),
        ("Toe", [(9, 0, 16)], False, 16),
    ],
    3: [
        ("Cic", [(2, 0, 16)], True, 2.0 ** -29),
        ("omegaBig", [(2, 16, 24), (3, 0, 24)], True, 2.0 ** -31 * GPS_PI),
        ("Cis", [(4, 0, 16)], True, 2.0 ** -29),
        ("i0", [(4, 16, 24), (5, 0, 24)], True, 2.0 ** -31 * GPS_PI),
        ("Crc", [(6, 0, 16)], True, 2.0 ** -5),
        ("omegaSmall", [(6, 16, 24), (7, 0, 24)], True, 2.0 ** -31 * GPS_PI),
        ("omegaDot", [(8, 0, 24)], True, 2.0 ** -43 * GPS_PI),
        ("IDOT", [(9, 8, 22)], True, 2.0 ** -43 * GPS_PI),
        ("IODE3", [(9, 0, 8)], False, 1),
    ],
    # Subframes 4/5 are paged: every page carries data ID + SV(page) ID
    # in word 3; the remaining fields depend on the page (IS-GPS-200
    # 20.3.3.5).  The reference decodes nothing here (ID/tow only,
    # gpslib.py:1565-1568, stubs commented out at gpslib.py:373-377) —
    # full page decode is what enables the Klobuchar ionosphere model
    # and the almanac warm start this framework adds.
    4: [
        ("dataID", [(2, 0, 2)], False, 1),
        ("svID", [(2, 2, 8)], False, 1),
    ],
    5: [
        ("dataID", [(2, 0, 2)], False, 1),
        ("svID", [(2, 2, 8)], False, 1),
    ],
}

# Subframe 4 page 18 (svID 56): ionospheric + UTC parameters
# (IS-GPS-200 Figure 20-1 sheet 8; 20.3.3.5.1.6-7).
_SF4_PAGE18 = [
    ("alpha0", [(2, 8, 16)], True, 2.0 ** -30),
    ("alpha1", [(2, 16, 24)], True, 2.0 ** -27),
    ("alpha2", [(3, 0, 8)], True, 2.0 ** -24),
    ("alpha3", [(3, 8, 16)], True, 2.0 ** -24),
    ("beta0", [(3, 16, 24)], True, 2.0 ** 11),
    ("beta1", [(4, 0, 8)], True, 2.0 ** 14),
    ("beta2", [(4, 8, 16)], True, 2.0 ** 16),
    ("beta3", [(4, 16, 24)], True, 2.0 ** 16),
    ("utcA1", [(5, 0, 24)], True, 2.0 ** -50),
    ("utcA0", [(6, 0, 24), (7, 0, 8)], True, 2.0 ** -30),
    ("utcTot", [(7, 8, 16)], False, 2 ** 12),
    ("utcWNt", [(7, 16, 24)], False, 1),
    ("dtLS", [(8, 0, 8)], True, 1),
    ("WNlsf", [(8, 8, 16)], False, 1),
    ("DN", [(8, 16, 24)], False, 1),
    ("dtLSF", [(9, 0, 8)], True, 1),
]

# Almanac pages (SF5 pages 1-24 = svID 1-24; SF4 pages 2-5, 7-10 =
# svID 25-32): reduced-precision ephemeris for one SV (IS-GPS-200
# Figure 20-1 sheet 4; 20.3.3.5.1.2).  Angles in the same
# GPS_PI-multiplied radian convention as the precise ephemeris fields.
_ALMANAC = [
    ("almE", [(2, 8, 24)], False, 2.0 ** -21),
    ("almToa", [(3, 0, 8)], False, 2 ** 12),
    ("almDeltaI", [(3, 8, 24)], True, 2.0 ** -19 * GPS_PI),
    ("almOmegaDot", [(4, 0, 16)], True, 2.0 ** -38 * GPS_PI),
    ("almHealth", [(4, 16, 24)], False, 1),
    ("almSqrtA", [(5, 0, 24)], False, 2.0 ** -11),
    ("almOmega0", [(6, 0, 24)], True, 2.0 ** -23 * GPS_PI),
    ("almOmegaSmall", [(7, 0, 24)], True, 2.0 ** -23 * GPS_PI),
    ("almM0", [(8, 0, 24)], True, 2.0 ** -23 * GPS_PI),
    ("almAf0", [(9, 0, 8), (9, 19, 22)], True, 2.0 ** -20),
    ("almAf1", [(9, 8, 19)], True, 2.0 ** -38),
]

IONO_PAGE_SVID = 56      # SF4 page 18


def _page_fields(sf_id: int, data_id: int, sv_id: int) -> list:
    """Page-specific field table of a subframe-4/5 page (empty for
    reserved pages / dummy-SV fill).  dataID must be 1 ('01', the only
    value defined for the LNAV upload)."""
    if sf_id not in (4, 5) or data_id != 1:
        return []
    if sf_id == 4 and sv_id == IONO_PAGE_SVID:
        return _SF4_PAGE18
    if 1 <= sv_id <= 32:
        return _ALMANAC
    return []


def field_scale(sf_id: int, name: str) -> float:
    """LSB scale factor of a subframe field (for quantization-aware tests)."""
    pages = _SF4_PAGE18 if sf_id == 4 else (_ALMANAC if sf_id == 5 else [])
    for n, _, _, scale in _COMMON + _SF_FIELDS[sf_id] + pages:
        if n == name:
            return scale
    raise KeyError(name)


def _bits_to_int(bits: np.ndarray, signed: bool) -> int:
    # one int64 dot against MSB-first powers of two (fields are <= 32
    # bits); the per-bit Python loop was ~40% of decode_subframe at the
    # serving path's subframe rate
    b = np.asarray(bits, np.int64)
    n = b.shape[0]
    v = int(b @ (np.int64(1) << np.arange(n - 1, -1, -1, dtype=np.int64)))
    if signed and b[0] == 1:
        v -= 1 << n
    return v


def _int_to_bits(value: int, n: int) -> np.ndarray:
    v = int(value) & ((1 << n) - 1)
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.int8)


# -- decoding -----------------------------------------------------------------

class SubframeError(Exception):
    pass


# the subframe-ID source span, handed to the native scanner so its
# walk can apply decode_subframe's 1 <= ID <= 5 gate (one source of
# truth: this table)
_ID_SPAN = next((sp[0][0], sp[0][1], sp[0][2])
                for n, sp, *_ in _COMMON if n == "ID")


def _native_scan():
    """The native subframe scanner (csrc/navscan.cpp), or False when
    GSDR_NAVSCAN=0 (the numpy walk).  A scanner that cannot be built or
    loaded raises."""
    import os
    if os.environ.get("GSDR_NAVSCAN", "1") == "0":
        return False
    from gps_sdr_tpu_torch.models._navscan import navscan
    return navscan


def check_and_unscramble(sub300: np.ndarray) -> np.ndarray | None:
    """Parity-check a 300-bit subframe; return 10x30 source-domain words.

    Handles global inversion via the preamble; undoes the D30 data
    complement per word; verifies parity of words 2..10 (the reference's
    CheckParity loop, gpslib.py:379-405).  Returns None on any failure.
    """
    if sub300.shape[0] != SUBFRAME_BITS:
        return None
    w = np.array(sub300, dtype=np.int8).reshape(10, 30)
    if not np.array_equal(w[0, :8], PREAMBLE):
        w = 1 - w
        if not np.array_equal(w[0, :8], PREAMBLE):
            return None
    # the D30 complement decision and both parity seeds use only the
    # TRANSMITTED bits of the previous word — known upfront for every
    # word — so the whole 9-word check collapses to one [9, 24] matmul
    ds29, ds30 = w[:-1, 28], w[:-1, 29]
    d = np.where(ds30[:, None] == 1, 1 - w[1:, :24], w[1:, :24])
    if not np.array_equal(words_parity(d, ds29, ds30), w[1:, 24:]):
        return None
    w[1:, :24] = d
    return w


def _field_matrix(fields) -> tuple[np.ndarray, list]:
    """Weight matrix W int64[n_fields, 300] with W @ flat_source_bits
    giving every field's raw integer at once (signed fields carry a
    negative MSB weight — two's complement as a dot product).  Returns
    (W, [(name, scale)]).  Cached per fields tuple: decode_subframe ran
    one _bits_to_int per field, and at the serving path's aggregate
    subframe rate the per-field Python loop was most of the host
    consume stage.  Keyed on the field structure itself (hashable
    tuple), not id(): an id can be reused after a temporary table is
    collected, silently decoding with the wrong weights."""
    key = tuple((name, tuple(spans), signed, scale)
                for name, spans, signed, scale in fields)
    hit = _FIELD_MATRICES.get(key)
    if hit is not None:
        return hit
    W = np.zeros((len(fields), SUBFRAME_BITS), np.int64)
    meta = []
    for fi, (name, spans, signed, scale) in enumerate(fields):
        n = sum(hi - lo for _, lo, hi in spans)
        k = 0
        for wi, lo, hi in spans:
            for b in range(lo, hi):
                wgt = np.int64(1) << (n - 1 - k)
                if signed and k == 0:
                    wgt = -wgt
                W[fi, wi * 30 + b] = wgt
                k += 1
        meta.append((name, scale))
    _FIELD_MATRICES[key] = (W, meta)
    return W, meta


_FIELD_MATRICES: dict = {}


def decode_subframe(sub300: np.ndarray) -> dict | None:
    """300 transmitted bits -> field dict, or None if invalid.

    Field positions and scale factors per IS-GPS-200 (the positions the
    reference reads in getDataSub1..3, gpslib.py:316-371; subframes 4/5
    yield only ID/tow as in gpslib.py:1565-1568).
    """
    w = check_and_unscramble(np.asarray(sub300))
    if w is None:
        return None
    return fields_from_source(w.reshape(-1))


def fields_from_source(flat300: np.ndarray) -> dict | None:
    """Field dict from 300 SOURCE-domain bits (already parity-checked
    and data-complement-corrected — check_and_unscramble's output, or
    the native scanner's)."""
    flat = np.asarray(flat300).astype(np.int64)
    Wc, mc = _field_matrix(_COMMON)
    vals = Wc @ flat
    out = {name: int(v) for (name, _), v in zip(mc, vals)}
    sf_id = out["ID"]
    if not 1 <= sf_id <= 5:
        return None
    def apply(fields):
        if fields:
            Wf, mf = _field_matrix(fields)
            for (name, scale), v in zip(mf, Wf @ flat):
                out[name] = int(v) if scale == 1 else v * scale

    apply(_SF_FIELDS[sf_id])
    # page tables key off dataID/svID, themselves subframe fields
    apply(_page_fields(sf_id, out.get("dataID", 0),
                       out.get("svID", 0)))
    return out


# -- encoding (simulator side) ------------------------------------------------

def _solve_tail(d: np.ndarray, ds29: int, ds30: int) -> np.ndarray:
    """Choose source bits d[22], d[23] so transmitted D29 = D30 = 0.

    Mirrors the IS-GPS-200 requirement that HOW and word 10 end with
    zeros in bits 29/30 so every subframe starts from a known parity
    state (and the TLM preamble is transmitted non-inverted)."""
    d = d.copy()
    d[22] = d[23] = 0
    p = word_parity(d, ds29, ds30)
    # D29 taps include d23 (not d22); D30 taps include both.
    d[23] = p[4]
    d[22] = (p[5] + d[23]) % 2
    assert word_parity(d, ds29, ds30)[4:].tolist() == [0, 0]
    return d


def encode_subframe(sf_id: int, fields: dict, tow: int,
                    fill: str = "random") -> np.ndarray:
    """Build the 300 transmitted bits of one subframe.

    `fields` uses the same names/units as decode_subframe's output.
    HOW and word 10 tails are solved for zero D29/D30; each word's data
    bits are complemented with the running DS30 before transmission.

    Reserved / unspecified payload bits are filled with deterministic
    pseudo-random data keyed by (sf_id, tow) — real broadcast subframes
    carry TLM/reserved/almanac entropy, and the receiver's 20 ms bit
    framing relies on transitions arriving every few bits: an all-zero
    fill creates >100-bit constant runs that no GPS receiver (including
    the reference, whose r>17 gap rounding assumes real signals,
    gpslib.py:1475-1478) is designed to frame.  Pass fill="zeros" for
    bit-layout unit tests.
    """
    if fill == "random":
        rng = np.random.default_rng((0x675053, sf_id, tow))
        src = rng.integers(0, 2, size=(10, 24)).astype(np.int8)
    else:
        src = np.zeros((10, 24), dtype=np.int8)
    src[0, :8] = PREAMBLE
    values = dict(fields)
    values["tow"] = tow
    values["ID"] = sf_id
    if sf_id in (4, 5):
        # page layout follows the caller's dataID/svID; default fill is
        # a dummy-SV page (dataID 1, svID 0) so random reserved bits
        # can't masquerade as an almanac or iono page downstream
        values.setdefault("dataID", 1)
        values.setdefault("svID", 0)
    layout = (_COMMON + _SF_FIELDS[sf_id]
              + _page_fields(sf_id, values.get("dataID", 0),
                             values.get("svID", 0)))
    # fields not specified by the caller decode as pseudo-random values;
    # zero them for the defined tables so partial dicts stay faithful
    for name, spans, _, _ in layout:
        for wi, lo, hi in spans:
            src[wi, lo:hi] = 0
    for name, spans, signed, scale in layout:
        if name not in values:
            continue
        v = values[name]
        iv = int(round(v / scale)) if scale != 1 else int(v)
        n = sum(hi - lo for _, lo, hi in spans)
        bits = _int_to_bits(iv, n)
        k = 0
        for wi, lo, hi in spans:
            src[wi, lo:hi] = bits[k:k + hi - lo]
            k += hi - lo

    tx = np.zeros((10, 30), dtype=np.int8)
    ds29 = ds30 = 0
    for i in range(10):
        d = src[i]
        if i in (1, 9):                      # HOW and word 10: force 00 tail
            d = _solve_tail(d, ds29, ds30)
        par = word_parity(d, ds29, ds30)
        tx[i, :24] = (d + ds30) % 2
        tx[i, 24:] = par
        ds29, ds30 = int(tx[i, 28]), int(tx[i, 29])
    return tx.reshape(300)


# -- edge -> bit -> subframe assembly (host, per channel) ---------------------

@dataclass
class NavDecoder:
    """Accumulates bit-edge events from the tracking kernel and yields
    decoded subframes; the host-side mirror of the reference's EDGES /
    GPSBITS bookkeeping (gpslib.py:1451-1580).
    """

    ngps: int
    last_sign: int = 0
    # edge events as array parts [(ms int64[k], st int64[k]), ...] —
    # appended per chunk, concatenated once per poll (the per-edge
    # tuple churn was a measurable slice of the serving consume stage);
    # the `edges` property keeps the list-of-(ms, st) view
    edge_parts: list = field(default_factory=list)
    bits: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int8))
    bits_st: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    ms_from_st: int = 0
    # > 0 (the code_samples length): frame bits from the edge's
    # ABSOLUTE sample time (st // code_samples) instead of the
    # channel's ms_time counter.  The two advance in lockstep within a
    # contiguous scan (1 ms of satellite clock = one code period of
    # samples; code Doppler moves the boundary < 0.2 samples/block and
    # the r>17 rounding absorbs +-1), but ms_time is a RELATIVE counter
    # that restarts wherever tracking state was respliced — in
    # time-SHARDED tracking (parallel/tracking.py) the warmup seam
    # makes it jump backward and the 20 ms framing dies at every shard
    # boundary.  Sample time is absolute and shard-invariant, so this
    # mode makes decode agnostic to how tracking was sharded.

    @property
    def edges(self) -> list:
        """List-of-(ms, st) view of the pending edge events (tests,
        introspection; the hot paths use edge_parts directly)."""
        if not self.edge_parts:
            return []
        ms = np.concatenate([p[0] for p in self.edge_parts])
        st = np.concatenate([p[1] for p in self.edge_parts])
        return list(zip(ms.tolist(), st.tolist()))

    @edges.setter
    def edges(self, pairs) -> None:
        if len(pairs):
            ms = np.fromiter((e[0] for e in pairs), np.int64, len(pairs))
            st = np.fromiter((e[1] for e in pairs), np.int64, len(pairs))
            self.edge_parts = [(ms, st)]
        else:
            self.edge_parts = []

    @property
    def n_edges(self) -> int:
        return sum(p[0].shape[0] for p in self.edge_parts)

    def erase(self):
        """Stream skip: drop edge/bit continuity (erasePrevData,
        gpslib.py:1095-1099)."""
        self.last_sign = 0
        self.edge_parts = []
        self.bits = np.zeros(0, np.int8)
        self.bits_st = np.zeros(0, np.int64)

    def push_block(self, sign0: int, edge_ms: np.ndarray,
                   edge_local: np.ndarray, edge_valid: np.ndarray,
                   stream_no: int, erased: bool):
        """Feed one block's edge events (ChannelOut fields)."""
        if erased:
            self.erase()
        if self.last_sign == 0 and sign0 != 0:
            self.last_sign = int(sign0)
        base = np.int64(stream_no) * self.ngps
        for ms, loc, ok in zip(edge_ms, edge_local, edge_valid):
            if ok:
                st = base + int(loc)
                m = (st // self.ms_from_st if self.ms_from_st
                     else int(ms))
                self.edge_parts.append(
                    (np.array([m], np.int64), np.array([st], np.int64)))

    def push_chunk(self, sign0: np.ndarray, edge_ms: np.ndarray,
                   edge_local: np.ndarray, edge_valid: np.ndarray,
                   stream_no0: int, erased: np.ndarray):
        """Feed a whole chunk of blocks at once (vectorized ingest).

        Arguments are one channel's slices of ChannelOut over T blocks:
        sign0[T], edge_ms/edge_local/edge_valid[T, E], erased[T].  The
        device produces ~50 edges/s/channel, but the per-block Python
        loop cost (T x E iterations) dominated fast replays on slow
        hosts; this keeps the host O(edges).  Falls back to the
        per-block path around stream gaps (rare by construction).
        """
        if erased.any():
            for b in range(sign0.shape[0]):
                self.push_block(sign0[b], edge_ms[b], edge_local[b],
                                edge_valid[b], stream_no0 + b,
                                bool(erased[b]))
            return
        if self.last_sign == 0:
            nz = np.nonzero(sign0)[0]
            if nz.size:
                self.last_sign = int(sign0[nz[0]])
        t = np.int64(stream_no0) + np.arange(sign0.shape[0],
                                             dtype=np.int64)
        st = t[:, None] * self.ngps + edge_local.astype(np.int64)
        sel = edge_valid.astype(bool)
        stv = st[sel]
        ms = (stv // self.ms_from_st if self.ms_from_st
              else edge_ms[sel].astype(np.int64))
        if stv.size:
            self.edge_parts.append((ms, stv))

    def _frame_bits(self) -> tuple[np.ndarray, np.ndarray]:
        """Edges -> logical bits with 20 ms framing and r>17 rounding
        (logicalBits, gpslib.py:1465-1492).  Consumes all but the last
        edge; flips the running sign once per edge."""
        if self.n_edges < 2:
            return np.zeros(0, np.int8), np.zeros(0, np.int64)
        # vectorized over intervals: interval j (between edges j, j+1)
        # carries sign last_sign * (-1)^j and rounds to m_j bits
        t = np.concatenate([p[0] for p in self.edge_parts])
        st = np.concatenate([p[1] for p in self.edge_parts])
        back = np.nonzero(np.diff(t) < 0)[0]
        if back.size:
            # ms_time restarted: the slot was re-acquired while a window
            # tracked with its old state was in flight (run_device,
            # serving), so that window's edges reached the new decoder
            # in the old time base.  Keep the edges from the restart on
            # (the reference decoder raises here on np.repeat).
            j = int(back[-1]) + 1
            t, st = t[j:], st[j:]
            self.last_sign = int(self.last_sign * (-1) ** j)
            if t.shape[0] < 2:
                self.edge_parts = [(t, st)]
                return np.zeros(0, np.int8), np.zeros(0, np.int64)
        m, r = np.divmod(np.diff(t), 20)
        m += r > 17
        k = m.shape[0]
        signs = np.where(np.arange(k) % 2 == 0, self.last_sign,
                         -self.last_sign).astype(np.int8)
        bits = np.repeat(signs, m)
        sts = np.zeros(int(m.sum()), np.int64)
        startpos = np.concatenate([[0], np.cumsum(m)[:-1]])
        has = m > 0
        sts[startpos[has]] = st[:-1][has]
        self.edge_parts = [(t[-1:], st[-1:])]
        self.last_sign = int(self.last_sign * (-1) ** k)
        return bits, sts

    def poll_subframes(self) -> list[dict]:
        """Assemble pending edges into bits, scan for subframes.

        Mirrors evalEdges + evalGpsBits (gpslib.py:1451-1580): locate
        preambles by +-8 correlation, attempt extraction, advance by 300
        bits on success or to the next preamble on failure; keep the
        unconsumed tail.  Each subframe dict gains 'ST', the sample time
        of its preamble's first bit edge.
        """
        nb, ns = self._frame_bits()
        out = []
        if nb.size == 0:
            # no new bits: the previous scan already consumed every
            # decodable subframe from the (unchanged) buffer, so the
            # correlation scan would deterministically find nothing new
            return out
        self.bits = np.concatenate([self.bits, nb])
        self.bits_st = np.concatenate([self.bits_st, ns])
        bits = self.bits
        if len(bits) < SUBFRAME_BITS:
            return out
        return self._scan_buffer()

    def _scan_buffer(self) -> list[dict]:
        """Scan self.bits for subframes and trim the consumed prefix
        (the walk after new bits arrived; split out so the native /
        Python equivalence is testable on arbitrary buffers)."""
        bits = self.bits
        out: list[dict] = []
        scan = _native_scan()
        if scan:
            starts, words, final = scan(bits, _TAPS_MAT, _SEED29,
                                        _ID_SPAN)
            for si, wrow in zip(starts.tolist(), words):
                sf = fields_from_source(wrow)
                sf["ST"] = int(self.bits_st[si])
                out.append(sf)
            self.bits = bits[final:]
            self.bits_st = self.bits_st[final:]
            return out
        corr = np.correlate(bits, PREAMBLE_PM, mode="valid")
        locs = [i for i in np.nonzero(np.abs(corr) == 8)[0]]
        start = 0
        li = 0
        if locs:
            b01 = ((bits + 1) // 2).astype(np.int8)
            start = locs[0]
            while start + SUBFRAME_BITS <= len(b01):
                sf = decode_subframe(b01[start:start + SUBFRAME_BITS])
                if sf is not None:
                    sf["ST"] = int(self.bits_st[start])
                    out.append(sf)
                    start += SUBFRAME_BITS
                else:
                    nxt = None
                    while li < len(locs):
                        if locs[li] > start:
                            nxt = locs[li]
                            break
                        li += 1
                    if nxt is None:
                        break
                    start = nxt
        self.bits = bits[start:]
        self.bits_st = self.bits_st[start:]
        return out
