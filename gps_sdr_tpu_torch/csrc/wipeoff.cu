// Mix + code-wipeoff kernel of the K-block tracking heavy stage (sm_90a).
//
// Replaces gps_sdr_tpu/ops/pallas_kernels.py::_mxu_wipeoff_kernel (via
// mix_wipeoff_mxu / heavy_stage_pallas).  The plain PyTorch twin and the
// contract are in gps_sdr_tpu_torch/ops/hopper_wipeoff.py.
//
// One CTA per (channel c, block b) of the step: grid (C, K).  Each CTA
//   1. tabulates, per column i of a code period, the oscillator factor
//      sincos(base_b + s*(i+1)) and the code rolled by the block's wipeoff
//      delay w (rolled[i] = code[(i - w) mod cs]), and per code period q
//      sincos(s*cs*q), in shared memory (the factorized NCO of the plain
//      version: small angles per factor, sincosf and not __sincosf since
//      the angles reach hundreds of radians);
//   2. streams its block once, period by period: each thread mixes its
//      columns, accumulates the full-period and head (i < w) wipeoff sums
//      and, for the corr_avg center periods, the mean center period
//      (thread-owned columns of the output, so no races);
//   3. reduces the per-period sums over warps and writes head = lo[0] and
//      seg[q] = hi[q] + lo[q+1] (the last segment has no following head).
//
// Bound: bytes.  Every CTA reads one 512 KB block (product shapes); the C
// channels of a block re-read it from L2.  Reading each block once for
// all channels is the first thing a faster version changes.

#include <cuda_runtime.h>

struct WipeoffArgs {
  const float2* chunk;  // complex64 [T, n_cyc*cs], the whole chunk
  const float* codes;   // f32 [C, cs], unrolled codes
  const float* s;       // f32 [C], 2*pi*freq/fs (rad/sample)
  const float* snp;     // f32 [C], (s*ngps) mod 2*pi, per-block advance
  const float* phase;   // f32 [C], NCO phase at the step's first sample
  const int* wipe;      // i32 [C, K], wipeoff delays in [0, cs)
  float2* center;       // complex64 [K, C, cs], mean center period
  float2* head;         // complex64 [C, K]
  float2* seg;          // complex64 [C, K, n_cyc]
  int n_ch, k, step, n_cyc, cs, corr_avg;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

size_t smem_bytes(const WipeoffArgs& a) {
  // cr, sr, rolled code [cs] + cq, sq [n_cyc] + warp partials
  return sizeof(float) * (3 * (size_t)a.cs + 2 * (size_t)a.n_cyc +
                          (size_t)kWarps * a.n_cyc * 4);
}

__global__ void __launch_bounds__(kThreads) wipeoff_kernel(WipeoffArgs a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, b = blockIdx.y;
  const int cs = a.cs, n_cyc = a.n_cyc, k = a.k;
  float* cr = smem;              // [cs]  cos(base_b + s*(i+1))
  float* sr = cr + cs;           // [cs]  sin(...)
  float* code = sr + cs;         // [cs]  rolled code
  float* cq = code + cs;         // [n_cyc] cos(s*cs*q)
  float* sq = cq + n_cyc;        // [n_cyc]
  float* red = sq + n_cyc;       // [kWarps][n_cyc][4] warp partials

  const float s = a.s[c];
  const float base = a.phase[c] + a.snp[c] * (float)b;
  const int wipe = a.wipe[c * k + b];
  const float* code_c = a.codes + (size_t)c * cs;
  for (int i = threadIdx.x; i < cs; i += kThreads) {
    float sn, cn;
    sincosf(base + s * (float)(i + 1), &sn, &cn);
    cr[i] = cn;
    sr[i] = sn;
    int src = i - wipe;
    if (src < 0) src += cs;
    code[i] = code_c[src];
  }
  for (int q = threadIdx.x; q < n_cyc; q += kThreads) {
    float sn, cn;
    sincosf(s * (float)cs * (float)q, &sn, &cn);
    cq[q] = cn;
    sq[q] = sn;
  }
  __syncthreads();

  const float2* blk = a.chunk + (size_t)(a.step * k + b) * n_cyc * cs;
  const int first = (n_cyc - a.corr_avg) / 2;
  const float inv_ca = 1.0f / (float)a.corr_avg;
  float2* cen = a.center + ((size_t)b * a.n_ch + c) * cs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int q = 0; q < n_cyc; ++q) {
    const float cqq = cq[q], sqq = sq[q];
    const bool in_center = q >= first && q < first + a.corr_avg;
    float lo_re = 0.f, lo_im = 0.f, fu_re = 0.f, fu_im = 0.f;
    for (int i = threadIdx.x; i < cs; i += kThreads) {
      const float2 x = blk[(size_t)q * cs + i];
      const float ore = cqq * cr[i] - sqq * sr[i];   // cos(ang)
      const float oim = sqq * cr[i] + cqq * sr[i];   // sin(ang)
      const float mre = x.x * ore + x.y * oim;       // x * exp(-i ang)
      const float mim = x.y * ore - x.x * oim;
      if (in_center) {
        float2 acc = (q == first) ? make_float2(0.f, 0.f) : cen[i];
        acc.x += mre * inv_ca;
        acc.y += mim * inv_ca;
        cen[i] = acc;
      }
      const float pre = mre * code[i], pim = mim * code[i];
      fu_re += pre;
      fu_im += pim;
      if (i < wipe) {
        lo_re += pre;
        lo_im += pim;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      lo_re += __shfl_down_sync(0xffffffffu, lo_re, off);
      lo_im += __shfl_down_sync(0xffffffffu, lo_im, off);
      fu_re += __shfl_down_sync(0xffffffffu, fu_re, off);
      fu_im += __shfl_down_sync(0xffffffffu, fu_im, off);
    }
    if (lane == 0) {
      float* r = red + ((size_t)warp * n_cyc + q) * 4;
      r[0] = lo_re;
      r[1] = lo_im;
      r[2] = fu_re;
      r[3] = fu_im;
    }
  }
  __syncthreads();

  float* tot = cr;  // [n_cyc][4] totals; the tables are no longer read
  for (int j = threadIdx.x; j < n_cyc * 4; j += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += red[(size_t)w * n_cyc * 4 + j];
    tot[j] = acc;
  }
  __syncthreads();

  for (int q = threadIdx.x; q < n_cyc; q += kThreads) {
    const float* t = tot + q * 4;  // lo_re, lo_im, full_re, full_im
    float2 sg = make_float2(t[2] - t[0], t[3] - t[1]);
    if (q + 1 < n_cyc) {
      sg.x += tot[(q + 1) * 4];
      sg.y += tot[(q + 1) * 4 + 1];
    }
    a.seg[((size_t)c * k + b) * n_cyc + q] = sg;
    if (q == 0) a.head[(size_t)c * k + b] = make_float2(t[0], t[1]);
  }
}

}  // namespace

extern "C" int gsdr_wipeoff_launch(const WipeoffArgs* a, void* stream) {
  const size_t smem = smem_bytes(*a);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wipeoff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wipeoff_kernel<<<dim3(a->n_ch, a->k), kThreads, smem,
                   (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" const char* gsdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
