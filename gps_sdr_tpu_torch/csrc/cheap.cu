// K-block cheap feedback stage of the fused tracking step (sm_90a).
//
// Replaces gps_sdr_tpu/ops/pallas_cheap.py::_cheap_kernel (via
// cheap_stage_call / cheap_stage_pallas).  The plain PyTorch twin and the
// contract are in gps_sdr_tpu_torch/ops/hopper_cheap.py; the semantics
// are the scan body of gps_sdr_tpu/ops/tracking.py channel_step_k
// (_means_from_sums, the virtual-NCO-retune rotation, _corr_quality,
// _edge_scan, amplitude/sigma, _pll), block after block.
//
// One CTA of 64 threads per channel; the loop over the K blocks runs
// inside the kernel with the channel's state in shared memory.  Per
// block: thread j builds slot j of the n_cyc+1 per-ms means (carry
// completion, compaction, retune rotation, arctan), then thread 0 runs
// the order-dependent parts over the <= 33 slots (correlation ring,
// edge prefix scan, sums, PLL) and writes the block's outputs.
//
// Bound: latency.  A step moves ~40 KB and a few thousand operations per
// channel, but each block depends on the previous one; the gain over the
// plain version is one launch per step instead of hundreds of small ops.
//
// Exactness: ms_time, counters and ring sums are int32 (ms_time past
// 2^24 stays exact; the +-1 ring sums are exact integers, kept as a
// running sum); the PLL phase is atanf(Q/I) with the I == 0 guard, never
// atan2 (the pi-step unwrap relies on the (-pi/2, pi/2) range).  The
// reference quirks are kept: corr_cnt, df_cnt and df_idx start at 1, and
// the correlation ring's write index is updated from the incremented
// count.

#include <cuda_runtime.h>
#include <stdint.h>

struct CheapArgs {
  // inputs
  const float2* head;   // complex64 [C, K] wipeoff head sums
  const float2* seg;    // complex64 [C, K, n_cyc] segment sums
  const int* delay;     // i32 [C, K] correlator delay, found = (>= 0)
  const int* wipe;      // i32 [C, K] wipeoff boundary delays
  // carried state, updated in place
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

constexpr int kSlots = 64;  // threads per CTA; n_cyc + 1 <= 64
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float fsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__global__ void __launch_bounds__(kSlots) cheap_kernel(CheapArgs a) {
  const int c = blockIdx.x, j = threadIdx.x;
  const int K = a.k, n_cyc = a.n_cyc, sl = n_cyc + 1, cs = a.cs;
  const int hist = a.hist, no_sec = a.no_sec;

  __shared__ float m_re[kSlots], m_im[kSlots], ph[kSlots];
  __shared__ int start[kSlots];
  // carried state (written by thread 0 only)
  __shared__ float s_carry_re, s_carry_im, s_prev_signal, s_std_dev;
  __shared__ float s_dphi, s_df_sum;
  __shared__ int s_carry_cnt, s_sign0, s_prev_sign, s_ms_time, s_locked;
  __shared__ int s_df_cnt, s_df_idx, s_corr_cnt, s_corr_idx, s_corr_sum;
  __shared__ int s_n_valid;

  float* df_buf = a.df_buf + (size_t)c * no_sec;
  int8_t* ring = a.corr_buf + (size_t)c * hist;

  if (j == 0) {
    const float2 cw = a.carry_sum[c];
    s_carry_re = cw.x;
    s_carry_im = cw.y;
    s_carry_cnt = a.carry_cnt[c];
    s_sign0 = a.sign0[c];
    s_prev_sign = a.prev_sign[c];
    s_prev_signal = a.prev_signal[c];
    s_ms_time = a.ms_time[c];
    s_std_dev = a.std_dev[c];
    s_locked = a.locked[c] != 0;
    s_df_cnt = a.df_cnt[c];
    s_df_idx = a.df_idx[c];
    s_corr_cnt = a.corr_cnt[c];
    s_corr_idx = a.corr_idx[c];
    s_corr_sum = 0;
    s_dphi = 0.f;
    s_df_sum = 0.f;
  }
  __syncthreads();
  {  // the ring's running sum (exact integer)
    int part = 0;
    for (int i = j; i < hist; i += kSlots) part += ring[i];
    atomicAdd(&s_corr_sum, part);
  }
  __syncthreads();

  for (int b = 0; b < K; ++b) {
    const size_t cb = (size_t)c * K + b;
    // ---- per-slot means (_means_from_sums) + retune rotation + arctan
    if (j < sl) {
      const int w = a.wipe[cb];
      const int carry_cnt = s_carry_cnt;
      const int cnt0 = carry_cnt + w;
      const bool v0 = cnt0 > 0;
      const int k_full = n_cyc - (w > 0 ? 1 : 0);
      const int src = v0 ? j : (j + 1) % sl;   // compaction when slot 0 empty
      float re, im;
      int st;
      if (src == 0) {
        const float2 h = a.head[cb];
        const float d = (float)(cnt0 > 1 ? cnt0 : 1);
        re = (s_carry_re + h.x) / d;
        im = (s_carry_im + h.y) / d;
        st = -carry_cnt;
      } else {
        const float2 sg = a.seg[cb * n_cyc + (src - 1)];
        re = sg.x / (float)cs;
        im = sg.y / (float)cs;
        st = w + cs * (src - 1);
      }
      const float t_m = ((float)st + 0.5f * (float)cs) / a.sample_rate;
      const float ang = s_dphi + kTwoPi * s_df_sum * t_m;
      float sn, cn;
      sincosf(ang, &sn, &cn);
      const float mr = re * cn + im * sn;      // mean * exp(-i ang)
      const float mi = im * cn - re * sn;
      m_re[j] = mr;
      m_im[j] = mi;
      start[j] = st;
      ph[j] = (mr != 0.f) ? atanf(mi / mr) : fsign(mi) * (kPi / 2.f);
      if (j == 0) s_n_valid = k_full + (v0 ? 1 : 0);
    }
    __syncthreads();

    if (j == 0) {
      const int w = a.wipe[cb];
      const int n_valid = s_n_valid;
      // carry for the next block
      if (w > 0) {
        const float2 last = a.seg[cb * n_cyc + (n_cyc - 1)];
        s_carry_re = last.x;
        s_carry_im = last.y;
        s_carry_cnt = cs - w;
      } else {
        s_carry_re = 0.f;
        s_carry_im = 0.f;
        s_carry_cnt = 0;
      }

      // ---- correlation-quality ring (_corr_quality)
      {
        const int cpq = a.delay[cb] >= 0 ? 1 : -1;
        int cnt = s_corr_cnt, idx = s_corr_idx;
        const int pos = cnt < hist ? cnt : pmod(idx, hist);
        s_corr_sum += cpq - ring[pos];
        ring[pos] = (int8_t)cpq;
        cnt = cnt + 1 < hist ? cnt + 1 : hist;
        idx = cnt < hist ? idx : pmod(idx + 1, hist);
        s_corr_cnt = cnt;
        s_corr_idx = idx;
        a.corr_q[cb] = (float)s_corr_sum / (float)cnt;
        const int win = cnt < no_sec ? cnt : no_sec;
        int lsum = 0;
        for (int o = 0; o < win; ++o) {
          int lp = cnt < hist ? cnt - 1 - o : pmod(idx - 1 - o, hist);
          lp = lp < 0 ? 0 : (lp > hist - 1 ? hist - 1 : lp);
          lsum += ring[lp];
        }
        a.corr_l[cb] = (float)lsum / (float)(win > 1 ? win : 1);
      }

      // ---- bit-edge scan (_edge_scan, prefix form), uses last block's
      //      sigma for the amplitude gate
      {
        const float mea = a.edge_sigma * s_std_dev;
        const bool locked = s_locked != 0;
        const bool chain = s_sign0 != 0;
        const int msign0 = m_re[0] >= 0.f ? 1 : -1;
        const int base = chain ? s_prev_sign : msign0;
        int cum = 0, n_do = 0;
        int* ems = a.edge_ms + cb * sl;
        int* est = a.edge_local + cb * sl;
        uint8_t* eok = a.edge_valid + cb * sl;
        for (int r = 0; r < sl; ++r) {
          const bool dor = (r < n_valid) && locked;
          const float re = m_re[r];
          const int ms = re >= 0.f ? 1 : -1;
          const float ps = r == 0 ? s_prev_signal : m_re[r - 1];
          const int spm = ps >= 0.f ? 1 : -1;
          const bool gate = fabsf(re - ps) > mea;
          const bool first_slot = !chain && r == 0;
          const bool cand = dor && ms != spm && ps != 0.f && gate &&
                            !first_slot;
          const int pre = cum > 0 ? ((cum & 1) ? 1 : -1) : base;
          ems[r] = s_ms_time + n_do;
          est[r] = start[r];
          eok[r] = (cand && pre == spm) ? 1 : 0;
          if (cand) {
            const int key = 2 * (r + 1) + (ms > 0 ? 1 : 0);
            cum = key > cum ? key : cum;
          }
          n_do += dor ? 1 : 0;
        }
        if (n_do > 0) {
          if (!chain) s_sign0 = msign0;
          s_prev_sign = cum > 0 ? ((cum & 1) ? 1 : -1) : base;
          s_prev_signal = m_re[n_do - 1];
        }
        s_ms_time += n_do;
        a.sign0_seq[cb] = (int8_t)s_sign0;
      }

      // ---- amplitude / sigma
      const float nv = (float)(n_valid > 1 ? n_valid : 1);
      {
        float sm = 0.f, sm2 = 0.f;
        for (int r = 0; r < n_valid; ++r) {
          const float mag = sqrtf(m_re[r] * m_re[r] + m_im[r] * m_im[r]);
          sm += mag;
          sm2 += mag * mag;
        }
        const float amp_mean = sm / nv;
        const float sd = sqrtf(fmaxf(sm2 / nv - amp_mean * amp_mean, 1e-12f));
        s_std_dev = sd;
        a.amplitude[cb] = amp_mean / sd;
      }

      // ---- PLL (_pll)
      {
        float csum = 0.f, dev_sum = 0.f, tail_sum = 0.f;
        int n_tail = 0;
        for (int r = 0; r < sl; ++r) {
          if (r > 0 && r < n_valid) {
            const float d = ph[r] - ph[r - 1];
            if (fabsf(d) > a.phase_jump) csum -= fsign(d);
          }
          const float rp = ph[r] + csum * kPi;
          if (r < n_valid) {
            dev_sum += rp;
            if (r >= n_valid - a.offset_avg) {
              tail_sum += rp;
              ++n_tail;
            }
          }
        }
        const float phase_dev = dev_sum / nv;
        const float phase_offset = tail_sum / fmaxf((float)n_tail, 1.f);
        float dsum = 0.f;
        for (int i = 0; i < no_sec; ++i) dsum += df_buf[i];
        const float mean_df =
            dsum / (float)(s_df_cnt > 1 ? s_df_cnt : 1);
        const bool locked = s_locked != 0;
        float df;
        if (locked) {
          df = fminf(fmaxf(a.gain_locked * phase_dev + mean_df, -a.max_df),
                     a.max_df);
          const int cnt = s_df_cnt, idx = s_df_idx;
          const int pos = cnt < no_sec ? cnt : pmod(idx, no_sec);
          df_buf[pos] = df;
          s_df_idx = cnt < no_sec ? idx : pmod(idx + 1, no_sec);
          s_df_cnt = cnt + 1 < no_sec ? cnt + 1 : no_sec;
        } else {
          df = a.gain_unlocked * phase_dev;
          for (int i = 0; i < no_sec; ++i) df_buf[i] = 0.f;
          df_buf[0] = df;
          s_df_cnt = 1;
          s_df_idx = 1;
        }
        s_locked = (locked || fabsf(phase_dev) < a.lock_threshold) ? 1 : 0;
        a.locked_seq[cb] = (uint8_t)s_locked;
        // virtual phase advance of the intra-step retune over this block
        s_dphi = s_dphi + phase_offset + kTwoPi * s_df_sum * a.t_blk;
        s_df_sum = s_df_sum + df;
      }
    }
    __syncthreads();
  }

  if (j == 0) {
    a.carry_sum[c] = make_float2(s_carry_re, s_carry_im);
    a.carry_cnt[c] = s_carry_cnt;
    a.sign0[c] = (int8_t)s_sign0;
    a.prev_sign[c] = (int8_t)s_prev_sign;
    a.prev_signal[c] = s_prev_signal;
    a.ms_time[c] = s_ms_time;
    a.std_dev[c] = s_std_dev;
    a.locked[c] = (uint8_t)s_locked;
    a.df_cnt[c] = s_df_cnt;
    a.df_idx[c] = s_df_idx;
    a.corr_cnt[c] = s_corr_cnt;
    a.corr_idx[c] = s_corr_idx;
    a.dphi[c] = s_dphi;
    a.df_sum[c] = s_df_sum;
  }
}

}  // namespace

extern "C" int gsdr_cheap_launch(const CheapArgs* a, void* stream) {
  if (a->n_cyc + 1 > kSlots) return (int)cudaErrorInvalidValue;
  cheap_kernel<<<a->n_ch, kSlots, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
