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
// own means slots j and j + 32, so one warp covers every n_cyc + 1 <= 64
// (the product's 33 slots put the last block edge in lane 0's second
// slot).
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
constexpr int kMaxSlots = 64;  // two slots per lane
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

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

// inclusive max-scan over the 32 lanes
__device__ __forceinline__ int scan_max(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

// The value of slot r - 1 for lane's slots r = lane (h = 0) and
// lane + 32 (h = 1); slot -1 is `before`.
__device__ __forceinline__ void prev_slot(float v0, float v1, float before,
                                          int lane, float& p0, float& p1) {
  const float u0 = __shfl_up_sync(kFull, v0, 1);
  const float u1 = __shfl_up_sync(kFull, v1, 1);
  const float last0 = __shfl_sync(kFull, v0, 31);
  p0 = lane == 0 ? before : u0;
  p1 = lane == 0 ? last0 : u1;
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
  float2* mean;        // [K][64] slot means before the retune rotation
  float* t_m;          // [K][64] slot mid-times, s
  float2* rot;         // [K][64] slot means after it (warp 0 -> warp 2)
  int* wipe;           // [K]
  int* n_valid;        // [K] valid slots
  int* locked;         // [K] lock state at the block's start (0 -> 2)
  int* ready;          // [K] block published by warp 0
  int* delay;          // [K]                                 (warp 1)
  float* df;           // [no_sec] df ring                    (warp 0)
  int8_t* ring;        // [hist] correlation ring             (warp 1)
};

// Lay out the dynamic shared memory from `base` (every array on a 16-byte
// boundary); returns its size.  m may be null (size only).
__host__ __device__ size_t carve(const CheapArgs& a, unsigned char* base,
                                 Smem* m) {
  const size_t k = a.k;
  const size_t bytes[] = {
      sizeof(float2) * k * a.n_cyc, sizeof(float2) * k,
      sizeof(float2) * k * kMaxSlots, sizeof(float) * k * kMaxSlots,
      sizeof(float2) * k * kMaxSlots, sizeof(int) * k, sizeof(int) * k,
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
__device__ void means_before_rotation(const CheapArgs& a, const Smem& m,
                                      int c, int h2, int lane) {
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
  const int cnt_in = a.in.carry_cnt[c];
  pair_sync();
  for (int b = h2; b < K; b += 2) {
    const int w = m.wipe[b], wp = b > 0 ? m.wipe[b - 1] : 0;
    const int carry_cnt = b == 0 ? cnt_in : (wp > 0 ? cs - wp : 0);
    float2 carry = cw;
    if (b > 0)
      carry = wp > 0 ? m.seg[(b - 1) * n_cyc + n_cyc - 1]
                     : make_float2(0.f, 0.f);
    const int cnt0 = carry_cnt + w;
    const bool v0 = cnt0 > 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r < sl) {
        // compaction when slot 0 is empty
        const int src = v0 ? r : (r + 1 == sl ? 0 : r + 1);
        float re, im;
        int st;
        if (src == 0) {
          const float2 hd = m.head[b];
          const float d = (float)(cnt0 > 1 ? cnt0 : 1);
          re = (carry.x + hd.x) / d;
          im = (carry.y + hd.y) / d;
          st = -carry_cnt;
        } else {
          const float2 sgv = m.seg[b * n_cyc + (src - 1)];
          re = sgv.x / (float)cs;
          im = sgv.y / (float)cs;
          st = w + cs * (src - 1);
        }
        m.mean[b * kMaxSlots + r] = make_float2(re, im);
        m.t_m[b * kMaxSlots + r] =
            ((float)st + 0.5f * (float)cs) / a.sample_rate;
        a.edge_local[((size_t)c * K + b) * sl + r] = st;
      }
    }
    if (lane == 0) m.n_valid[b] = n_cyc - (w > 0 ? 1 : 0) + (v0 ? 1 : 0);
  }
  pair_sync();
}

// Warp 0: retune rotation, arctan and the PLL (_pll), block after block;
// it publishes each block's rotated means and lock state to warp 2.
__device__ void pll_warp(const CheapArgs& a, const Smem& m, int c,
                         int lane) {
  const int K = a.k, n_cyc = a.n_cyc, sl = n_cyc + 1, cs = a.cs;
  const int no_sec = a.no_sec;
  warp_copy(m.df, a.in.df_buf + (size_t)c * no_sec, no_sec, lane);
  bool locked = a.in.locked[c] != 0;
  int df_cnt = a.in.df_cnt[c], df_idx = a.in.df_idx[c];
  means_before_rotation(a, m, c, 0, lane);

  float dphi = 0.f, df_sum = 0.f;
  for (int b = 0; b < K; ++b) {
    const size_t cb = (size_t)c * K + b;
    const int n_valid = m.n_valid[b];
    float mr[2], mi[2], ph[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      mr[h] = mi[h] = ph[h] = 0.f;
      if (r < sl) {
        const float2 mv = m.mean[b * kMaxSlots + r];
        const float ang = dphi + kTwoPi * df_sum * m.t_m[b * kMaxSlots + r];
        float sn, cn;
        sincosf(ang, &sn, &cn);
        mr[h] = mv.x * cn + mv.y * sn;          // mean * exp(-i ang)
        mi[h] = mv.y * cn - mv.x * sn;
        m.rot[b * kMaxSlots + r] = make_float2(mr[h], mi[h]);
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
    float pp[2];
    prev_slot(ph[0], ph[1], 0.f, lane, pp[0], pp[1]);
    const int t0 = max(n_valid - a.offset_avg, 0);
    float dev = 0.f, tail = 0.f;
    int dev_k = 0, tail_k = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
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
    float dsum = 0.f;
    for (int i = lane; i < no_sec; i += 32) dsum += m.df[i];
    dev_k = __reduce_add_sync(kFull, dev_k);
    tail_k = __reduce_add_sync(kFull, tail_k);
    dev = warp_sum(dev);
    tail = warp_sum(tail);
    dsum = warp_sum(dsum);

    const float nv = (float)(n_valid > 1 ? n_valid : 1);
    const int n_tail = n_valid - t0;
    const float phase_dev = (dev + (float)dev_k * kPi) / nv;
    const float phase_offset =
        (tail + (float)tail_k * kPi) / (float)(n_tail > 1 ? n_tail : 1);
    const float mean_df = dsum / (float)(df_cnt > 1 ? df_cnt : 1);
    float df;
    __syncwarp();                         // df ring read before written
    if (locked) {
      df = fminf(fmaxf(a.gain_locked * phase_dev + mean_df, -a.max_df),
                 a.max_df);
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
__device__ void edge_warp(const CheapArgs& a, const Smem& m, int c,
                          int lane) {
  const int K = a.k, sl = a.n_cyc + 1;
  int sign0 = a.in.sign0[c], prev_sign = a.in.prev_sign[c];
  float prev_signal = a.in.prev_signal[c];
  int ms_time = a.in.ms_time[c];
  float std_dev = a.in.std_dev[c];
  means_before_rotation(a, m, c, 1, lane);

  const unsigned lt_mask = (1u << lane) - 1u;
  for (int b = 0; b < K; ++b) {
    const size_t cb = (size_t)c * K + b;
    while (*(volatile int*)(m.ready + b) == 0) {
    }
    __threadfence_block();
    const int n_valid = m.n_valid[b];
    const bool locked = m.locked[b] != 0;
    float mr[2], mi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      const float2 v = r < sl ? m.rot[b * kMaxSlots + r]
                              : make_float2(0.f, 0.f);
      mr[h] = v.x;
      mi[h] = v.y;
    }

    // edges; the amplitude gate uses the previous block's sigma
    const float mea = a.edge_sigma * std_dev;
    const bool chain = sign0 != 0;
    const int msign0 = __shfl_sync(kFull, mr[0], 0) >= 0.f ? 1 : -1;
    const int base = chain ? prev_sign : msign0;
    float ps[2];
    prev_slot(mr[0], mr[1], prev_signal, lane, ps[0], ps[1]);
    bool dor[2], cand[2];
    int key[2], spm[2];
    float sm = 0.f, sm2 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
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
    // exclusive max-scan of the keys over the 64 slots
    const int inc0 = scan_max(key[0], lane);
    const int inc1 = scan_max(key[1], lane);
    const int tot0 = __shfl_sync(kFull, inc0, 31);
    const int up0 = __shfl_up_sync(kFull, inc0, 1);
    const int up1 = __shfl_up_sync(kFull, inc1, 1);
    const int excl[2] = {lane == 0 ? 0 : up0, max(tot0, lane == 0 ? 0 : up1)};
    const int cum = max(tot0, __shfl_sync(kFull, inc1, 31));
    // n_do before each slot: ballot + popc prefix count
    const unsigned bal0 = __ballot_sync(kFull, dor[0]);
    const unsigned bal1 = __ballot_sync(kFull, dor[1]);
    const int n0 = __popc(bal0);
    const int n_do = n0 + __popc(bal1);
    const int before[2] = {__popc(bal0 & lt_mask),
                           n0 + __popc(bal1 & lt_mask)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
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
    const float l0 = __shfl_sync(kFull, mr[0], last & 31);
    const float l1 = __shfl_sync(kFull, mr[1], last & 31);
    sign0 = (has && !chain) ? msign0 : sign0;
    prev_sign = has ? (cum > 0 ? ((cum & 1) ? 1 : -1) : base) : prev_sign;
    prev_signal = has ? (last < 32 ? l0 : l1) : prev_signal;
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

__global__ void __launch_bounds__(96) cheap_kernel(CheapArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem m;
  carve(a, smem, &m);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0)
    pll_warp(a, m, blockIdx.x, lane);
  else if (warp == 1)
    corr_ring_warp(a, m, blockIdx.x, lane);
  else
    edge_warp(a, m, blockIdx.x, lane);
}

}  // namespace

extern "C" int gsdr_cheap_launch(const CheapArgs* a, void* stream) {
  if (a->n_cyc + 1 > kMaxSlots || a->k <= 0 || a->hist <= 0 ||
      a->no_sec <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = carve(*a, nullptr, nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cheap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cheap_kernel<<<a->n_ch, 96, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" const char* gsdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
