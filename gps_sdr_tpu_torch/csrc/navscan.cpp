// Native subframe scanner: preamble correlation + walk + parity
// check/unscramble over a logical-bit buffer.
//
// The port's copy of the JAX package's csrc/navscan.cpp, code unchanged.
//
// Mirrors gps_sdr_tpu_torch/models/navmsg.py poll_subframes' scan loop and
// check_and_unscramble (behavior surface: the reference's evalGpsBits +
// CheckParity, src/gpslib.py:379-405, 1510-1580) — but
// as straight-line C++: on the 1-core deployment host the per-call
// overhead of many tiny numpy ops dominated the nav-decode stage of
// the serving path.
//
// The parity tap matrix and the ID field location are passed IN from
// Python (derived from the same declarative tables the encoder uses),
// so there is exactly one source of truth for the IS-GPS-200 layout.
//
// Interface (ctypes, see gps_sdr_tpu_torch/models/_navscan.py):
//   n_out = gsdr_navscan(bits, n, taps, seed29,
//                        id_word, id_lo, id_hi, max_out,
//                        out_starts, out_words, final_start)
//   bits       : int8[n], logical bits as +1/-1
//   taps       : int8[6*24], parity tap matrix (row k = parity bit k)
//   seed29     : int8[6], 1 if parity bit k seeds from D29*, else D30*
//   out_starts : int64[max_out], bit index of each decoded subframe
//   out_words  : int8[max_out*300], source-domain bits (0/1; word 0 as
//                transmitted after global inversion, words 1..9
//                data-complement-corrected) — field extraction stays
//                in Python (one cached matmul)
//   final_start: int64[1], walk position the caller trims the buffer to
// Returns the number of parity-valid subframes with 1 <= ID <= 5.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kSubframeBits = 300;
constexpr int kWordBits = 30;
constexpr int kDataBits = 24;
// IS-GPS-200 TLM preamble, MSB first (navmsg.py PREAMBLE)
constexpr int8_t kPreamble[8] = {1, 0, 0, 0, 1, 0, 1, 1};

// Try to decode 300 logical bits (0/1) at `w` into source-domain bits.
// Returns true and fills out[300] + id_val on success.
bool try_decode(const uint8_t* w, const int8_t* taps,
                const int8_t* seed29, int id_word, int id_lo, int id_hi,
                uint8_t* out, int* id_val) {
  uint8_t buf[kSubframeBits];
  // preamble match, else global inversion, else fail
  bool direct = true, inverted = true;
  for (int i = 0; i < 8; ++i) {
    direct &= (w[i] == (uint8_t)kPreamble[i]);
    inverted &= ((1 - w[i]) == (uint8_t)kPreamble[i]);
  }
  if (direct) {
    std::memcpy(buf, w, kSubframeBits);
  } else if (inverted) {
    for (int i = 0; i < kSubframeBits; ++i) buf[i] = 1 - w[i];
  } else {
    return false;
  }
  std::memcpy(out, buf, kSubframeBits);
  for (int wi = 1; wi < 10; ++wi) {
    const uint8_t* prev = buf + (wi - 1) * kWordBits;
    const uint8_t* cur = buf + wi * kWordBits;
    uint8_t ds29 = prev[28], ds30 = prev[29];
    uint8_t d[kDataBits];
    for (int j = 0; j < kDataBits; ++j)
      d[j] = ds30 ? (uint8_t)(1 - cur[j]) : cur[j];
    for (int k = 0; k < 6; ++k) {
      int acc = seed29[k] ? ds29 : ds30;
      const int8_t* row = taps + k * kDataBits;
      for (int j = 0; j < kDataBits; ++j) acc += row[j] & d[j];
      if ((uint8_t)(acc & 1) != cur[kDataBits + k]) return false;
    }
    std::memcpy(out + wi * kWordBits, d, kDataBits);
  }
  // subframe ID from the source domain (span passed in from the table)
  int id = 0;
  for (int b = id_lo; b < id_hi; ++b)
    id = (id << 1) | out[id_word * kWordBits + b];
  *id_val = id;
  return id >= 1 && id <= 5;
}

}  // namespace

extern "C" int64_t gsdr_navscan(
    const int8_t* bits, int64_t n, const int8_t* taps,
    const int8_t* seed29, int32_t id_word, int32_t id_lo, int32_t id_hi,
    int64_t max_out, int64_t* out_starts, int8_t* out_words,
    int64_t* final_start) {
  *final_start = 0;
  if (n < kSubframeBits) return 0;
  // preamble correlation over ±1 bits; |corr| == 8 marks candidates
  // (navmsg.py: np.correlate(bits, PREAMBLE_PM))
  const int64_t n_corr = n - 8 + 1;
  // 0/1 view for decoding
  uint8_t* b01 = new uint8_t[n];
  for (int64_t i = 0; i < n; ++i) b01[i] = (uint8_t)((bits[i] + 1) >> 1);

  int64_t n_found = 0;
  int64_t start = -1, li = 0;
  // candidate list materialized lazily: walk positions are sparse
  int64_t* locs = new int64_t[n_corr > 0 ? n_corr : 1];
  int64_t n_locs = 0;
  for (int64_t i = 0; i < n_corr; ++i) {
    int corr = 0;
    for (int j = 0; j < 8; ++j)
      corr += (2 * kPreamble[j] - 1) * bits[i + j];
    if (corr == 8 || corr == -8) locs[n_locs++] = i;
  }
  if (n_locs > 0) {
    start = locs[0];
    while (start + kSubframeBits <= n) {
      uint8_t sub[kSubframeBits];
      int id = 0;
      if (n_found < max_out
          && try_decode(b01 + start, taps, seed29, id_word, id_lo,
                        id_hi, sub, &id)) {
        out_starts[n_found] = start;
        int8_t* dst = out_words + n_found * kSubframeBits;
        for (int i = 0; i < kSubframeBits; ++i) dst[i] = (int8_t)sub[i];
        ++n_found;
        start += kSubframeBits;
      } else {
        int64_t nxt = -1;
        while (li < n_locs) {
          if (locs[li] > start) { nxt = locs[li]; break; }
          ++li;
        }
        if (nxt < 0) break;
        start = nxt;
      }
    }
  }
  *final_start = start < 0 ? 0 : start;
  delete[] locs;
  delete[] b01;
  return n_found;
}
