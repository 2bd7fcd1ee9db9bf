// K-block cheap feedback stage of the fused tracking step (sm_90a).
//
// Replaces gps_sdr_tpu/ops/pallas_cheap.py::_cheap_kernel (via
// cheap_stage_call / cheap_stage_pallas).  The plain PyTorch twin and the
// contract are in gps_sdr_tpu_torch/ops/hopper_cheap.py; the semantics
// are the scan body of gps_sdr_tpu/ops/tracking.py channel_step_k
// (_means_from_sums, the virtual-NCO-retune rotation, _corr_quality,
// _edge_scan, amplitude/sigma, _pll), block after block.
//
// One 96-thread CTA per channel, three warps with separate work.  Lanes
// own H means slots, j + 32 h for h < H, so one warp covers n_cyc + 1 <=
// 32 H slots: the kernel is built for H = 2 (n_cyc + 1 <= 64; the
// product's 33 slots put the last block edge in lane 0's second slot) and
// H = 4 (n_cyc 64's 65 slots, up to 128), and the launcher takes the
// smaller that fits.  The H = 2 build is the two-slot kernel unchanged:
// its sums run in the same order, so its bits do not depend on H = 4.
//   The H = 4 build also rounds the PLL's inputs as the plain version's
// PyTorch ops round them on the card (div_by_scalar and the H == 4
// branches): the means, the slot times, the retune angle and its sin and
// cos, the rotation and the phase and frequency updates, one rounding an
// op, a division by a scalar as a multiply by its reciprocal, and the
// complex multiply's one contraction; and it sums the phases and the df
// ring in double, rounded once, as the plain version does
// (plain_phase_sums).  A 64 ms block doubles the unlocked PLL's gain a
// block (g pi t_blk = 2), so one rounding of difference in the rotated
// means of a noise-led channel, pulled by hundreds of Hz, grew block
// after block past the df ring's tolerance (cheap_trace.py).
//   * Warps 0 and 2 first copy the step's inputs (head, seg, wipe, ~2 KB
//     a channel) into shared memory and form every block's slot means
//     before the retune rotation, one (block, slot) a thread: carry
//     completion, compaction and slot start times depend on the inputs
//     alone, so no global load and no division of them sits on the
//     block-to-block chain.
//   * Warp 0 then runs the chain: per block the retune rotation and
//     arctan of its slots, and the PLL: the previous slot's phase comes
//     by __shfl_up_sync; the pi-step unwrap enters the phase sums as
//     integer sums of the -sign(d) steps, each weighted by the number of
//     summed slots after it (so no prefix scan: __reduce_add_sync), and
//     phase_dev, the tail offset and the df-ring mean are warp sums; the
//     df ring lives in shared memory.  It publishes each block's rotated
//     means and lock state (a flag in shared memory) and goes on without
//     waiting: nothing of the PLL depends on the edges or the amplitude.
//   * Warp 2 follows block by block: the edge scan's running reference
//     sign is an exclusive max-scan of the position-encoded candidate
//     keys, n_do before each slot a __ballot_sync + __popc prefix count;
//     amplitude and sigma are warp sums (sigma gates the next block's
//     edges, on this warp).
//   * Warp 1 runs the correlation-quality ring, which depends on the
//     delays and the ring alone: it copies the int8 ring into shared
//     memory (16-byte loads, the exact running sum by dp4a) and per
//     block updates it and takes the corr_l window as a strided warp sum.
// Warps synchronize with __syncwarp, one named barrier between warps 0
// and 2 around the means, and the per-block flags; never __syncthreads.
// The carried state is read from the input tensors and never written:
// the new state, rings included, goes to separate outputs.
//
// Bound: latency.  A step moves ~40 KB and a few thousand operations per
// channel, but block b + 1 needs block b's phase and frequency
// corrections, so a step is a dependent chain of K blocks of sincosf,
// atanf, a shuffle and three interleaved warp sums (5 shuffle rounds),
// plus the prologue's loads and one launch.
//
// Exactness: ms_time, counters and ring sums are int32 (ms_time past
// 2^24 stays exact; the +-1 ring sums are exact integers, kept as a
// running sum); the PLL phase is atanf(Q/I) with the I == 0 guard, never
// atan2 (the pi-step unwrap relies on the (-pi/2, pi/2) range).  Float
// sums run in another order than the plain version's (tolerances in
// chip_smoke.py _compare_cheap).  The reference quirks are kept: corr_cnt,
// df_cnt and df_idx start at 1, and the correlation ring's write index is
// updated from the incremented count.

#include <cuda_runtime.h>
#include <stdint.h>

struct CheapState {     // the carried ChannelState fields, [C, ...] each
  float2* carry_sum;    // complex64 [C]
  int* carry_cnt;       // i32 [C]
  int8_t* sign0;        // i8 [C]
  int8_t* prev_sign;    // i8 [C]
  float* prev_signal;   // f32 [C]
  int* ms_time;         // i32 [C]
  float* std_dev;       // f32 [C]
  uint8_t* locked;      // bool [C]
  float* df_buf;        // f32 [C, no_sec]
  int* df_cnt;          // i32 [C]
  int* df_idx;          // i32 [C]
  int8_t* corr_buf;     // i8 [C, hist]
  int* corr_cnt;        // i32 [C]
  int* corr_idx;        // i32 [C]
};

struct CheapArgs {
  // inputs
  const float2* head;   // complex64 [C, K] wipeoff head sums
  const float2* seg;    // complex64 [C, K, n_cyc] segment sums
  const int* delay;     // i32 [C, K] correlator delay, found = (>= 0)
  const int* wipe;      // i32 [C, K] wipeoff boundary delays
  CheapState in;        // the step's starting state (read only)
  CheapState out;       // the state after the step (written)
  // outputs
  float* dphi;          // f32 [C] accumulated phase correction
  float* df_sum;        // f32 [C] accumulated frequency correction
  float* amplitude;     // f32 [C, K]
  float* corr_q;        // f32 [C, K]
  float* corr_l;        // f32 [C, K]
  uint8_t* locked_seq;  // bool [C, K]
  int8_t* sign0_seq;    // i8 [C, K]
  int* edge_ms;         // i32 [C, K, n_cyc+1]
  int* edge_local;      // i32 [C, K, n_cyc+1]
  uint8_t* edge_valid;  // bool [C, K, n_cyc+1]
  int n_ch, k, n_cyc, cs, no_sec, hist, offset_avg;
  float sample_rate, edge_sigma, gain_locked, gain_unlocked, lock_threshold,
      max_df, phase_jump, t_blk;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 128;  // four slots per lane
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// The plain version's rounding (the H = 4 build): a / b for a scalar b as
// a * (1 / b), as PyTorch divides a tensor by a scalar on the card.
__device__ __forceinline__ float div_by_scalar(float a, float b) {
  return __fmul_rn(a, __fdiv_rn(1.f, b));
}

// v / d for a slot mean: the H = 4 build as the plain version rounds it
// on the card (div_by_scalar), the H = 2 build as it always has
template <int H>
__device__ __forceinline__ float2 scale(float2 v, float d) {
  if constexpr (H == 4)
    return make_float2(div_by_scalar(v.x, d), div_by_scalar(v.y, d));
  else
    return make_float2(v.x / d, v.y / d);
}

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float fsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// inclusive max-scan over the 32 lanes
__device__ __forceinline__ int scan_max(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

// The value of slot r - 1 for lane's slots r = lane + 32 h; slot -1 is
// `before`.
template <int H>
__device__ __forceinline__ void prev_slot(const float (&v)[H], float before,
                                          int lane, float (&p)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float u = __shfl_up_sync(kFull, v[h], 1);
    const float last = h == 0 ? before : __shfl_sync(kFull, v[h - 1], 31);
    p[h] = lane == 0 ? last : u;
  }
}

// dst[i] = src[i] for i < n, by the warp, four loads in flight a lane
template <typename T>
__device__ __forceinline__ void warp_copy(T* dst, const T* src, int n,
                                          int lane) {
  int i = lane;
  for (; i + 96 < n; i += 128) {
    const T x0 = src[i], x1 = src[i + 32], x2 = src[i + 64],
            x3 = src[i + 96];
    dst[i] = x0;
    dst[i + 32] = x1;
    dst[i + 64] = x2;
    dst[i + 96] = x3;
  }
  for (; i < n; i += 32) dst[i] = src[i];
}

__device__ __forceinline__ int byte_sum(int4 x) {   // 16 signed int8
  int s = __dp4a(x.x, 0x01010101, 0);
  s = __dp4a(x.y, 0x01010101, s);
  s = __dp4a(x.z, 0x01010101, s);
  return __dp4a(x.w, 0x01010101, s);
}

// Copy the n-byte ring by the warp; returns the sum of its bytes as signed
// int8 (exact), in every lane.
__device__ int copy_ring(int8_t* dst, const int8_t* src, int n, int lane) {
  int part = 0;
  if (n % 16 == 0 && ((reinterpret_cast<uintptr_t>(dst) |
                       reinterpret_cast<uintptr_t>(src)) % 16 == 0)) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    int v = lane;
    for (; v + 96 < n / 16; v += 128) {
      const int4 x0 = s[v], x1 = s[v + 32], x2 = s[v + 64], x3 = s[v + 96];
      d[v] = x0;
      d[v + 32] = x1;
      d[v + 64] = x2;
      d[v + 96] = x3;
      part += byte_sum(x0) + byte_sum(x1) + byte_sum(x2) + byte_sum(x3);
    }
    for (; v < n / 16; v += 32) {
      const int4 x = s[v];
      d[v] = x;
      part += byte_sum(x);
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      const int8_t x = src[i];
      dst[i] = x;
      part += x;
    }
  }
  return __reduce_add_sync(kFull, part);
}

struct Smem {          // the CTA's dynamic shared memory
  float2* seg;         // [K][n_cyc] segment sums
  float2* head;        // [K] head sums
  float2* mean;        // [K][32 H] slot means before the retune rotation
  float* t_m;          // [K][32 H] slot mid-times, s
  float2* rot;         // [K][32 H] slot means after it (warp 0 -> warp 2)
  int* wipe;           // [K]
  int* n_valid;        // [K] valid slots
  int* locked;         // [K] lock state at the block's start (0 -> 2)
  int* ready;          // [K] block published by warp 0
  int* delay;          // [K]                                 (warp 1)
  float* df;           // [no_sec] df ring                    (warp 0)
  int8_t* ring;        // [hist] correlation ring             (warp 1)
};

// Lay out the dynamic shared memory from `base` for `slots` = 32 H slots a
// block (every array on a 16-byte boundary); returns its size.  m may be
// null (size only).
__host__ __device__ size_t carve(const CheapArgs& a, int slots,
                                 unsigned char* base, Smem* m) {
  const size_t k = a.k, ns = slots;
  const size_t bytes[] = {
      sizeof(float2) * k * a.n_cyc, sizeof(float2) * k,
      sizeof(float2) * k * ns, sizeof(float) * k * ns,
      sizeof(float2) * k * ns, sizeof(int) * k, sizeof(int) * k,
      sizeof(int) * k, sizeof(int) * k, sizeof(int) * k,
      sizeof(float) * a.no_sec, (size_t)a.hist};
  size_t off[12], n = 0;
  for (int i = 0; i < 12; ++i) {
    off[i] = n;
    n += (bytes[i] + 15) / 16 * 16;
  }
  if (m) {
    m->seg = reinterpret_cast<float2*>(base + off[0]);
    m->head = reinterpret_cast<float2*>(base + off[1]);
    m->mean = reinterpret_cast<float2*>(base + off[2]);
    m->t_m = reinterpret_cast<float*>(base + off[3]);
    m->rot = reinterpret_cast<float2*>(base + off[4]);
    m->wipe = reinterpret_cast<int*>(base + off[5]);
    m->n_valid = reinterpret_cast<int*>(base + off[6]);
    m->locked = reinterpret_cast<int*>(base + off[7]);
    m->ready = reinterpret_cast<int*>(base + off[8]);
    m->delay = reinterpret_cast<int*>(base + off[9]);
    m->df = reinterpret_cast<float*>(base + off[10]);
    m->ring = reinterpret_cast<int8_t*>(base + off[11]);
  }
  return n;
}

// warps 0 and 2 (64 threads) meet here
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
}

// Warp 1: the correlation-quality ring (_corr_quality) over the K blocks.
// It depends on the delays and the ring alone, so it runs beside the
// other warps.
__device__ void corr_ring_warp(const CheapArgs& a, const Smem& m, int c,
                               int lane) {
  const int K = a.k, hist = a.hist, no_sec = a.no_sec;
  warp_copy(m.delay, a.delay + (size_t)c * K, K, lane);
  int corr_sum =
      copy_ring(m.ring, a.in.corr_buf + (size_t)c * hist, hist, lane);
  int cnt = a.in.corr_cnt[c], idx = a.in.corr_idx[c];
  __syncwarp();
  for (int b = 0; b < K; ++b) {
    const size_t cb = (size_t)c * K + b;
    const int cpq = m.delay[b] >= 0 ? 1 : -1;
    const int pos = cnt < hist ? cnt : pmod(idx, hist);
    corr_sum += cpq - m.ring[pos];
    __syncwarp();
    if (lane == 0) m.ring[pos] = (int8_t)cpq;
    __syncwarp();
    cnt = cnt + 1 < hist ? cnt + 1 : hist;
    idx = cnt < hist ? idx : pmod(idx + 1, hist);
    const int win = cnt < no_sec ? cnt : no_sec;
    int lsum = 0;
    for (int o = lane; o < win; o += 32) {
      int lp = cnt < hist ? cnt - 1 - o : pmod(idx - 1 - o, hist);
      lp = lp < 0 ? 0 : (lp > hist - 1 ? hist - 1 : lp);
      lsum += m.ring[lp];
    }
    lsum = __reduce_add_sync(kFull, lsum);
    if (lane == 0) {
      a.corr_q[cb] = (float)corr_sum / (float)cnt;
      a.corr_l[cb] = (float)lsum / (float)(win > 1 ? win : 1);
    }
  }
  __syncwarp();
  copy_ring(a.out.corr_buf + (size_t)c * hist, m.ring, hist, lane);
  if (lane == 0) {
    a.out.corr_cnt[c] = cnt;
    a.out.corr_idx[c] = idx;
  }
}

// Warps 0 and 2 (warp index h2 = 0, 1): the step's inputs into shared
// memory, then every block's slot means before the retune rotation
// (_means_from_sums), blocks h2, h2 + 2, ...: they depend on the inputs
// and the carry only, and the carry of block b is the state's (b = 0) or
// block b - 1's tail.
template <int H>
__device__ void means_before_rotation(const CheapArgs& a, const Smem& m,
                                      int c, int h2, int lane) {
  constexpr int S = 32 * H;
  const int K = a.k, n_cyc = a.n_cyc, sl = n_cyc + 1, cs = a.cs;
  const int t = 32 * h2 + lane;
  const float2* sg = a.seg + (size_t)c * K * n_cyc;
  int i = t;
  for (; i + 192 < K * n_cyc; i += 256) {
    const float2 x0 = sg[i], x1 = sg[i + 64], x2 = sg[i + 128],
                 x3 = sg[i + 192];
    m.seg[i] = x0;
    m.seg[i + 64] = x1;
    m.seg[i + 128] = x2;
    m.seg[i + 192] = x3;
  }
  for (; i < K * n_cyc; i += 64) m.seg[i] = sg[i];
  for (int j = t; j < K; j += 64) {
    m.head[j] = a.head[(size_t)c * K + j];
    m.wipe[j] = a.wipe[(size_t)c * K + j];
    m.ready[j] = 0;
  }
  const float2 cw = a.in.carry_sum[c];
  const int cnt_in = a.in.carry_cnt[c], corr_in = a.in.corr_cnt[c];
  pair_sync();
  // the channel continues a block of its stream (_continues): not
  // erased (carry_cnt -1) and not fresh from a reset (corr_cnt 1)
  const bool cont_in = cnt_in >= 0 && corr_in > 1;
  for (int b = h2; b < K; b += 2) {
    const int w = m.wipe[b], wp = b > 0 ? m.wipe[b - 1] : 0;
    const int carry_cnt =
        b == 0 ? (cnt_in > 0 ? cnt_in : 0) : (wp > 0 ? cs - wp : 0);
    float2 carry = cw;
    if (b > 0)
      carry = wp > 0 ? m.seg[(b - 1) * n_cyc + n_cyc - 1]
                     : make_float2(0.f, 0.f);
    const int cnt0 = carry_cnt + w;
    // the boundary delay crossed the period boundary since the last
    // block (_means_from_sums): slot 0 under half a period runs on
    // through segment 0 after a carry, and is the tail of the period
    // the last block closed (dropped) after none; over one and a half
    // it splits into the carry's period and the head's
    const bool tail = (b > 0 || cont_in) && carry_cnt == 0 && 2 * w < cs;
    const bool shrt = carry_cnt > 0 && 2 * cnt0 < cs;
    const bool lng = 2 * cnt0 > 3 * cs;
    const bool v0 = cnt0 > 0 && !tail;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int r = lane + 32 * h;
      if (r < sl) {
        float2 mv;
        int st;
        if (lng && r < 2) {
          mv = r == 0 ? scale<H>(carry, (float)(carry_cnt > 1 ? carry_cnt
                                                              : 1))
                      : scale<H>(m.head[b], (float)(w > 1 ? w : 1));
          st = r == 0 ? -carry_cnt : w - cs;
        } else if (shrt && r == 0) {
          const float2 hd = m.head[b], s0 = m.seg[b * n_cyc];
          mv = scale<H>(make_float2(carry.x + hd.x + s0.x,
                                    carry.y + hd.y + s0.y),
                        (float)(cnt0 + cs));
          st = -carry_cnt;
        } else {
          // compaction when slot 0 is empty or merged, room for the
          // split
          const int src = lng ? r - 1
                              : (v0 && !shrt ? r : (r + 1 == sl ? 0 : r + 1));
          if (src == 0) {
            const float2 hd = m.head[b];
            mv = scale<H>(make_float2(carry.x + hd.x, carry.y + hd.y),
                          (float)(cnt0 > 1 ? cnt0 : 1));
            st = -carry_cnt;
          } else {
            mv = scale<H>(m.seg[b * n_cyc + (src - 1)], (float)cs);
            st = w + cs * (src - 1);
          }
        }
        m.mean[b * S + r] = mv;
        m.t_m[b * S + r] =
            H == 4 ? div_by_scalar((float)st + 0.5f * (float)cs,
                                   a.sample_rate)
                   : ((float)st + 0.5f * (float)cs) / a.sample_rate;
        a.edge_local[((size_t)c * K + b) * sl + r] = st;
      }
    }
    if (lane == 0)
      m.n_valid[b] = n_cyc - (w > 0 ? 1 : 0) + (v0 ? 1 : 0) - (shrt ? 1 : 0)
                     + (lng ? 1 : 0);
  }
  pair_sync();
}

// The H = 4 build's phase and df sums as the plain version forms them:
// per slot the unwrapped phase ph + pi * csum (csum the running sum of the
// -sign(d) steps, over the row and the rows before) rounded as its ops
// round it, then the sums over the valid slots, the tail [t0, n_valid)
// and the df ring in double, each rounded once to float, as the plain
// version sums them, so that the order of the sums does not show.
template <int H>
__device__ void plain_phase_sums(const CheapArgs& a, const Smem& m,
                                 const float (&ph)[H], const float (&pp)[H],
                                 int n_valid, int t0, int df_cnt, int lane,
                                 float& phase_dev, float& phase_offset,
                                 float& dsum_f, float& mean_df) {
  int carry = 0;
  double dev = 0.0, tail = 0.0;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int r = lane + 32 * h;
    const float d = ph[h] - pp[h];
    int csum = (r > 0 && r < n_valid && fabsf(d) > a.phase_jump)
                   ? (d > 0.f ? -1 : 1) : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, csum, o);
      if (lane >= o) csum += u;
    }
    csum += carry;
    carry = __shfl_sync(kFull, csum, 31);
    if (r < n_valid) {
      const double u = __fadd_rn(ph[h], __fmul_rn((float)csum, kPi));
      dev += u;
      if (r >= t0) tail += u;
    }
  }
  double dsum = 0.0;
  for (int i = lane; i < a.no_sec; i += 32) dsum += m.df[i];
  dev = warp_sum_d(dev);
  tail = warp_sum_d(tail);
  dsum_f = (float)warp_sum_d(dsum);
  const int n_tail = n_valid - t0;
  phase_dev = __fdiv_rn((float)dev, (float)(n_valid > 1 ? n_valid : 1));
  phase_offset = __fdiv_rn((float)tail, (float)(n_tail > 1 ? n_tail : 1));
  mean_df = __fdiv_rn(dsum_f, (float)(df_cnt > 1 ? df_cnt : 1));
}

// Warp 0: retune rotation, arctan and the PLL (_pll), block after block;
// it publishes each block's rotated means and lock state to warp 2.
template <int H>
__device__ void pll_warp(const CheapArgs& a, const Smem& m, int c,
                         int lane) {
  constexpr int S = 32 * H;
  const int K = a.k, n_cyc = a.n_cyc, sl = n_cyc + 1, cs = a.cs;
  const int no_sec = a.no_sec;
  warp_copy(m.df, a.in.df_buf + (size_t)c * no_sec, no_sec, lane);
  bool locked = a.in.locked[c] != 0;
  int df_cnt = a.in.df_cnt[c], df_idx = a.in.df_idx[c];
  means_before_rotation<H>(a, m, c, 0, lane);

  float dphi = 0.f, df_sum = 0.f;
  for (int b = 0; b < K; ++b) {
    const size_t cb = (size_t)c * K + b;
    const int n_valid = m.n_valid[b];
    float mr[H], mi[H], ph[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int r = lane + 32 * h;
      mr[h] = mi[h] = ph[h] = 0.f;
      if (r < sl) {
        const float2 mv = m.mean[b * S + r];
        float sn, cn;
        if constexpr (H == 4) {
          // dphi + (2 pi df_sum) t, sin and cos, and mean * (cos - i sin)
          // as the plain version's ops round them
          const float ang = __fadd_rn(
              dphi, __fmul_rn(__fmul_rn(kTwoPi, df_sum), m.t_m[b * S + r]));
          sn = sinf(ang);
          cn = cosf(ang);
          mr[h] = __fmaf_rn(mv.x, cn, __fmul_rn(mv.y, sn));
          mi[h] = __fmaf_rn(mv.x, -sn, __fmul_rn(mv.y, cn));
        } else {
          const float ang = dphi + kTwoPi * df_sum * m.t_m[b * S + r];
          sincosf(ang, &sn, &cn);
          mr[h] = mv.x * cn + mv.y * sn;        // mean * exp(-i ang)
          mi[h] = mv.y * cn - mv.x * sn;
        }
        m.rot[b * S + r] = make_float2(mr[h], mi[h]);
        ph[h] = (mr[h] != 0.f) ? atanf(mi[h] / mr[h])
                               : fsign(mi[h]) * (kPi / 2.f);
      }
    }
    if (lane == 0) m.locked[b] = locked;
    __threadfence_block();           // publish block b to warp 2
    __syncwarp();
    if (lane == 0) *(volatile int*)(m.ready + b) = 1;

    // unwrap: the slot-r phase is ph[r] + pi * csum[r], csum the prefix
    // sum of the -sign(d) steps, so its sums over the valid slots and the
    // tail [t0, n_valid) are the phase sums plus pi times integer sums
    // weighted by how many summed slots each step precedes
    float pp[H];
    prev_slot<H>(ph, 0.f, lane, pp);
    const int t0 = max(n_valid - a.offset_avg, 0);
    float phase_dev, phase_offset, dsum, mean_df;
    if constexpr (H == 4) {
      plain_phase_sums<H>(a, m, ph, pp, n_valid, t0, df_cnt, lane,
                          phase_dev, phase_offset, dsum, mean_df);
    } else {
      float dev = 0.f, tail = 0.f;
      int dev_k = 0, tail_k = 0;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int r = lane + 32 * h;
        if (r < n_valid) {
          const float d = ph[h] - pp[h];
          const int step = (r > 0 && fabsf(d) > a.phase_jump)
                               ? (d > 0.f ? -1 : 1) : 0;
          dev += ph[h];
          dev_k += step * (n_valid - r);
          tail_k += step * (n_valid - max(r, t0));
          if (r >= t0) tail += ph[h];
        }
      }
      dsum = 0.f;
      for (int i = lane; i < no_sec; i += 32) dsum += m.df[i];
      dev_k = __reduce_add_sync(kFull, dev_k);
      tail_k = __reduce_add_sync(kFull, tail_k);
      dev = warp_sum(dev);
      tail = warp_sum(tail);
      dsum = warp_sum(dsum);

      const float nv = (float)(n_valid > 1 ? n_valid : 1);
      const int n_tail = n_valid - t0;
      phase_dev = (dev + (float)dev_k * kPi) / nv;
      phase_offset =
          (tail + (float)tail_k * kPi) / (float)(n_tail > 1 ? n_tail : 1);
      mean_df = dsum / (float)(df_cnt > 1 ? df_cnt : 1);
    }
    float df;
    __syncwarp();                         // df ring read before written
    if (locked) {
      const float pulled = H == 4
          ? __fadd_rn(__fmul_rn(a.gain_locked, phase_dev), mean_df)
          : a.gain_locked * phase_dev + mean_df;
      df = fminf(fmaxf(pulled, -a.max_df), a.max_df);
      const int pos = df_cnt < no_sec ? df_cnt : pmod(df_idx, no_sec);
      if (lane == 0) m.df[pos] = df;
      df_idx = df_cnt < no_sec ? df_idx : pmod(df_idx + 1, no_sec);
      df_cnt = df_cnt + 1 < no_sec ? df_cnt + 1 : no_sec;
    } else {
      df = a.gain_unlocked * phase_dev;
      for (int i = lane; i < no_sec; i += 32) m.df[i] = i == 0 ? df : 0.f;
      df_cnt = 1;
      df_idx = 1;
    }
    __syncwarp();
    locked = locked || fabsf(phase_dev) < a.lock_threshold;
    if (lane == 0) a.locked_seq[cb] = locked ? 1 : 0;
    // virtual phase advance of the intra-step retune over this block
    if constexpr (H == 4)
      dphi = __fadd_rn(__fadd_rn(dphi, phase_offset),
                       __fmul_rn(__fmul_rn(kTwoPi, df_sum), a.t_blk));
    else
      dphi = dphi + phase_offset + kTwoPi * df_sum * a.t_blk;
    df_sum = df_sum + df;
  }

  warp_copy(a.out.df_buf + (size_t)c * no_sec, m.df, no_sec, lane);
  if (lane == 0) {
    const int wl = m.wipe[K - 1];        // the last block's tail
    const float2 last = m.seg[(K - 1) * n_cyc + n_cyc - 1];
    a.out.carry_sum[c] = wl > 0 ? last : make_float2(0.f, 0.f);
    a.out.carry_cnt[c] = wl > 0 ? cs - wl : 0;
    a.out.locked[c] = locked ? 1 : 0;
    a.out.df_cnt[c] = df_cnt;
    a.out.df_idx[c] = df_idx;
    a.dphi[c] = dphi;
    a.df_sum[c] = df_sum;
  }
}

// Warp 2: the bit-edge scan (_edge_scan, prefix form) and amplitude /
// sigma of each block as warp 0 publishes it.
template <int H>
__device__ void edge_warp(const CheapArgs& a, const Smem& m, int c,
                          int lane) {
  constexpr int S = 32 * H;
  const int K = a.k, sl = a.n_cyc + 1;
  int sign0 = a.in.sign0[c], prev_sign = a.in.prev_sign[c];
  float prev_signal = a.in.prev_signal[c];
  int ms_time = a.in.ms_time[c];
  float std_dev = a.in.std_dev[c];
  means_before_rotation<H>(a, m, c, 1, lane);

  const unsigned lt_mask = (1u << lane) - 1u;
  for (int b = 0; b < K; ++b) {
    const size_t cb = (size_t)c * K + b;
    while (*(volatile int*)(m.ready + b) == 0) {
    }
    __threadfence_block();
    const int n_valid = m.n_valid[b];
    const bool locked = m.locked[b] != 0;
    float mr[H], mi[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int r = lane + 32 * h;
      const float2 v = r < sl ? m.rot[b * S + r] : make_float2(0.f, 0.f);
      mr[h] = v.x;
      mi[h] = v.y;
    }

    // edges; the amplitude gate uses the previous block's sigma
    const float mea = a.edge_sigma * std_dev;
    const bool chain = sign0 != 0;
    const int msign0 = __shfl_sync(kFull, mr[0], 0) >= 0.f ? 1 : -1;
    const int base = chain ? prev_sign : msign0;
    float ps[H];
    prev_slot<H>(mr, prev_signal, lane, ps);
    bool dor[H], cand[H];
    int key[H], spm[H];
    float sm = 0.f, sm2 = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int r = lane + 32 * h;
      dor[h] = (r < n_valid) && locked;
      const int ms = mr[h] >= 0.f ? 1 : -1;
      spm[h] = ps[h] >= 0.f ? 1 : -1;
      const bool gate = fabsf(mr[h] - ps[h]) > mea;
      const bool first_slot = !chain && r == 0;
      cand[h] = dor[h] && ms != spm[h] && ps[h] != 0.f && gate &&
                !first_slot;
      key[h] = cand[h] ? 2 * (r + 1) + (ms > 0 ? 1 : 0) : 0;
      const float mag = sqrtf(mr[h] * mr[h] + mi[h] * mi[h]);
      sm += r < n_valid ? mag : 0.f;
      sm2 += r < n_valid ? mag * mag : 0.f;
    }
    // exclusive max-scan of the keys over the 32 H slots (keys are >= 0):
    // each row's lane scan, after the maximum of the rows before it
    int excl[H], cum = 0;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int inc = scan_max(key[h], lane);
      const int up = __shfl_up_sync(kFull, inc, 1);
      excl[h] = max(cum, lane == 0 ? 0 : up);
      cum = max(cum, __shfl_sync(kFull, inc, 31));
    }
    // n_do before each slot: ballot + popc prefix count
    int before[H], n_do = 0;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const unsigned bal = __ballot_sync(kFull, dor[h]);
      before[h] = n_do + __popc(bal & lt_mask);
      n_do += __popc(bal);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int r = lane + 32 * h;
      if (r < sl) {
        const int pre = excl[h] > 0 ? ((excl[h] & 1) ? 1 : -1) : base;
        const size_t e = cb * sl + r;
        a.edge_ms[e] = ms_time + before[h];
        a.edge_valid[e] = (cand[h] && pre == spm[h]) ? 1 : 0;
      }
    }
    const bool has = n_do > 0;
    const int last = has ? n_do - 1 : 0;
    float lv = 0.f;                      // the real part at slot `last`
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float l = __shfl_sync(kFull, mr[h], last & 31);
      if (last >> 5 == h) lv = l;
    }
    sign0 = (has && !chain) ? msign0 : sign0;
    prev_sign = has ? (cum > 0 ? ((cum & 1) ? 1 : -1) : base) : prev_sign;
    prev_signal = has ? lv : prev_signal;
    ms_time += n_do;

    // amplitude / sigma
    sm = warp_sum(sm);
    sm2 = warp_sum(sm2);
    const float nv = (float)(n_valid > 1 ? n_valid : 1);
    const float amp_mean = sm / nv;
    std_dev = sqrtf(fmaxf(sm2 / nv - amp_mean * amp_mean, 1e-12f));
    if (lane == 0) {
      a.sign0_seq[cb] = (int8_t)sign0;
      a.amplitude[cb] = amp_mean / std_dev;
    }
  }
  if (lane == 0) {
    a.out.sign0[c] = (int8_t)sign0;
    a.out.prev_sign[c] = (int8_t)prev_sign;
    a.out.prev_signal[c] = prev_signal;
    a.out.ms_time[c] = ms_time;
    a.out.std_dev[c] = std_dev;
  }
}

template <int H>
__global__ void __launch_bounds__(96) cheap_kernel(CheapArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem m;
  carve(a, 32 * H, smem, &m);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0)
    pll_warp<H>(a, m, blockIdx.x, lane);
  else if (warp == 1)
    corr_ring_warp(a, m, blockIdx.x, lane);
  else
    edge_warp<H>(a, m, blockIdx.x, lane);
}

template <int H>
int launch(const CheapArgs& a, cudaStream_t stream) {
  const size_t smem = carve(a, 32 * H, nullptr, nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cheap_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cheap_kernel<H><<<a.n_ch, 96, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gsdr_cheap_launch(const CheapArgs* a, void* stream) {
  if (a->n_cyc + 1 > kMaxSlots || a->k <= 0 || a->hist <= 0 ||
      a->no_sec <= 0)
    return (int)cudaErrorInvalidValue;
  return a->n_cyc + 1 <= 64 ? launch<2>(*a, (cudaStream_t)stream)
                            : launch<4>(*a, (cudaStream_t)stream);
}

extern "C" const char* gsdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
