// Mix + code-wipeoff kernel of the K-block tracking heavy stage (sm_90a).
//
// Replaces gps_sdr_tpu/ops/pallas_kernels.py::_mxu_wipeoff_kernel (via
// mix_wipeoff_mxu / heavy_stage_pallas).  The plain PyTorch twin and the
// contract are in gps_sdr_tpu_torch/ops/hopper_wipeoff.py; the mirror of
// this kernel's contraction form (input rounding included) is
// _mix_wipeoff_mxu_math there.
//
// The TPU kernel's factorization: with ang(q, i) = base_b + s*cs*q +
// s*(i+1), every per-period wipeoff sum is a contraction of the RAW block
// planes [n_cyc, cs] against weight rows code*cos(s(i+1)) and
// code*sin(s(i+1)) (and their head-masked, i < w, variants), combined per
// period with cos/sin(s*cs*q) and per block with cos/sin(base_b).
//
// Block-stationary: grid (K, n_ranks, S), one thread-block cluster of
// n_ranks = min(cs / kTile, kMaxTiles) CTAs per block and stream (16 from
// cs = 2048 up, a non-portable cluster size).  Rank r takes the column
// tiles [r * n_tiles / n_ranks, (r + 1) * n_tiles / n_ranks) of the
// n_tiles = cs / kTile, one after the other in tile order: one tile a CTA
// up to cs = 2048, 8 at cs = 16384 (16.384 MS/s).  The z axis is the
// stream axis of the serving path (the batch axis Pallas's vmap rule gives
// the TPU kernel): the CTAs of stream z serve its C channels, which sit at
// z*C on the flattened S*C channel axis of every parameter and result, and
// read its chunk, chunk_stride samples after stream z-1's (0: every stream
// reads one shared chunk, whose blocks then come from L2 after the first
// stream's read).  Nothing else depends on z, so a launch over S streams
// gives the bits of S single-stream launches.  Each CTA
//   1. loads the per-channel parameters and tabulates the per-period
//      factors (cos, sin)(s*cs*q) of every channel (they do not depend on
//      the tile), then for each of its tiles
//   2. stages its [n_cyc, kTile] complex64 slab of block step*K + b in
//      shared memory with cp.async (rows padded to kRow = kTile + 4
//      complex, so fragment loads hit distinct banks), and for each group
//      of at most kGroup channels (their weight columns are what fills the
//      shared memory: at 32 channels and n_cyc 64 two groups fit where one
//      would not)
//   3. gathers the group's codes rolled by the block's wipeoff delays,
//      code[(i - w) mod cs], the same way; meanwhile it tabulates the
//      column factors (precise sincosf: the angles reach hundreds of
//      radians);
//   4. builds the group's weight columns in shared memory, split into TF32
//      high and low parts: (w1, w2) of every channel, and head-masked (w1,
//      w2) only for the channels whose head boundary falls inside THIS tile
//      (for the others the masked sum is the full one or zero), so the
//      columns are ~2G, not 4G;
//   5. takes the wipeoff sums as one tensor-core contraction [2*n_cyc rows
//      (re, im) x kTile] x [kTile x columns, padded to a multiple of 8]:
//      mma.sync m16n8k8 TF32 in the 3xTF32 split (lo*hi + hi*lo + hi*hi:
//      f32-level error; single-pass TF32 misses the 1e-4 bound on noise-
//      dominated channels); a 16-row tile holds the re and im rows of 8
//      periods, so one float2 load gives two A values, and a warp's tiles
//      share their rows, so it splits each A fragment once.  Every sum
//      depends on its own row and column only, so the grouping changes no
//      bit;
//   6. rotates the sums per period and block into the tile's share of
//      head = lo[0] and seg[q] = (full[q] - lo[q]) + lo[q+1] and adds it,
//      in tile order, to the CTA's share in shared memory (the first tile's
//      share is stored as it is);
//   7. takes the group's mean center period of the tile in f32 on CUDA
//      cores: a thread holds its column's center samples in registers and
//      serves every channel of the group, writing center [K, C, cs] once.
//   After its last tile, a cluster barrier; then each CTA adds, for a slice
//   of the results, the n_ranks shares in rank order through distributed
//   shared memory and writes head and seg.  No float atomics, no second
//   kernel, no global scratch: every result is the same from run to run.
//
// Bound: bytes (product shapes: 4.2 MB of blocks in, 1.4 MB of center out
// per K-step; ~0.1 GFLOP; at cs 16384, n_cyc 8: 8.4 MB in, 11.5 MB out).
// Each block leaves device memory once.  What sets the time is a chain of
// dependent phases per tile (loads, tables, weights, mma, shares), each
// latency-bound, run m tiles in a row; only 7 clusters of 16 fit on the
// card at one CTA per SM, so the eighth shares SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

struct WipeoffArgs {
  const float2* chunk;  // complex64 [T, n_cyc*cs] per stream, whole chunks
  const float* codes;   // f32 [S*C, cs], unrolled codes
  const float* s;       // f32 [S*C], 2*pi*freq/fs (rad/sample)
  const float* snp;     // f32 [S*C], (s*ngps) mod 2*pi, per-block advance
  const float* phase;   // f32 [S*C], NCO phase at the step's first sample
  const int* wipe;      // i32 [S*C, K], wipeoff delays in [0, cs)
  float2* center;       // complex64 [K, S*C, cs], mean center period
  float2* head;         // complex64 [S*C, K]
  float2* seg;          // complex64 [S*C, K, n_cyc]
  long long chunk_stride;  // samples from one stream's chunk to the next's
                           // (0: one chunk shared by every stream)
  int n_ch, k, step, n_cyc, cs, corr_avg;  // n_ch: channels a stream (C)
  int n_streams;                           // S, the grid's z extent
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;         // columns of a code period per tile
constexpr int kRow = kTile + 4;    // padded shared row (float2 or float)
constexpr int kPairs = 2;          // mma tiles a warp runs together
constexpr int kMaxTiles = 16;      // CTAs of a cluster (non-portable > 8)
constexpr int kMaxCa = 16;         // center periods held in registers
constexpr int kGroup = 16;         // channels whose weights are built at once
constexpr int kMaxCh = 32;         // channels a stream
constexpr int kMaxCs = 16384;      // code period, samples (128 tiles)

__host__ __device__ int n_pad(int n_cols) { return (n_cols + 7) / 8 * 8; }
__host__ __device__ int group_size(const WipeoffArgs& a) {
  return a.n_ch < kGroup ? a.n_ch : kGroup;
}

struct Smem {        // the CTA's dynamic shared memory
  float2* x;         // [n_cyc][kRow] the slab
  float* w_hi;       // [np][kRow] the group's weight columns, TF32 high part
  float* w_lo;       // [np][kRow] low part
  float* cph;        // [G][kTile] cos(s*(i+1))
  float* sph;        // [G][kTile] sin(s*(i+1))
  float* code;       // [G][kTile] rolled codes
  float2* lo;        // [G][n_cyc] head-masked sums of the tile, rotated
  float2* full;      // [G][n_cyc] full sums of the tile, rotated
  float* cq;         // [C][n_cyc] cos(s*cs*q)
  float* sq;         // [C][n_cyc] sin(s*cs*q)
  float2* cen;       // [C][kMaxCa] (cq, sq) of the center periods, zeros
                     // past corr_avg
  float* cb;         // [C] cos(base_b)
  float* sb;         // [C] sin(base_b)
  float* s;          // [C] rad/sample
  int* w;            // [C] the block's wipeoff delay
  int* split;        // [G + 1] count, then the group's channels split by
                     // the tile
  float2* share;     // [C][n_cyc + 1] the CTA's share of head and seg
};

// Lay out the dynamic shared memory from `base` (every array on a 16-byte
// boundary); returns its size in bytes.  m may be null (size only).
__host__ __device__ size_t carve(const WipeoffArgs& a, float* base,
                                 Smem* m) {
  const size_t c = a.n_ch, nq = a.n_cyc, g = group_size(a);
  const size_t np = n_pad(4 * (int)g);
  const size_t floats[] = {2 * nq * kRow, np * kRow, np * kRow, g * kTile,
                           g * kTile,     g * kTile, 2 * g * nq, 2 * g * nq,
                           c * nq,        c * nq,    2 * c * kMaxCa,
                           c,             c,         c,
                           c,             g + 1,     2 * c * (nq + 1)};
  constexpr int kArrays = sizeof(floats) / sizeof(floats[0]);
  size_t off[kArrays], n = 0;
  for (int i = 0; i < kArrays; ++i) {
    off[i] = n;
    n += (floats[i] + 3) / 4 * 4;
  }
  if (m) {
    m->x = reinterpret_cast<float2*>(base + off[0]);
    m->w_hi = base + off[1];
    m->w_lo = base + off[2];
    m->cph = base + off[3];
    m->sph = base + off[4];
    m->code = base + off[5];
    m->lo = reinterpret_cast<float2*>(base + off[6]);
    m->full = reinterpret_cast<float2*>(base + off[7]);
    m->cq = base + off[8];
    m->sq = base + off[9];
    m->cen = reinterpret_cast<float2*>(base + off[10]);
    m->cb = base + off[11];
    m->sb = base + off[12];
    m->s = base + off[13];
    m->w = reinterpret_cast<int*>(base + off[14]);
    m->split = reinterpret_cast<int*>(base + off[15]);
    m->share = reinterpret_cast<float2*>(base + off[16]);
  }
  return n * sizeof(float);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(kBytes));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32, but in integer ALU operations); lo = x - hi is
// exact in f32 and goes to the tensor core as it is (it reads the TF32
// bits of lo).
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

__device__ __forceinline__ void mma_tf32(float* d, const float* a,
                                         const float* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

__global__ void __launch_bounds__(kThreads) wipeoff_kernel(WipeoffArgs a) {
  extern __shared__ __align__(16) float smem[];
  Smem m;
  carve(a, smem, &m);
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x, rank = blockIdx.y, n_ranks = gridDim.y;
  const int cs = a.cs, n_cyc = a.n_cyc, n_ch = a.n_ch, k = a.k;
  const int n_tiles = cs / kTile, sl = n_cyc + 1, gs = group_size(a);
  // this stream's first channel on the flattened S*C axis, and that axis
  const int ch0 = blockIdx.z * n_ch, n_all = gridDim.z * n_ch;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int first = (n_cyc - a.corr_avg) / 2;
  const float inv_ca = 1.0f / (float)a.corr_avg;
  const float2* blk0 = a.chunk + (size_t)blockIdx.z * a.chunk_stride +
                       (size_t)(a.step * k + b) * n_cyc * cs;

  // 1. the per-channel parameters, the block's rotation and the period
  //    tables (precise sincosf: the angles reach hundreds of radians)
  for (int c = tid; c < n_ch; c += kThreads) {
    m.s[c] = a.s[ch0 + c];
    m.w[c] = a.wipe[(ch0 + c) * k + b];
    sincosf(a.phase[ch0 + c] + a.snp[ch0 + c] * (float)b, &m.sb[c],
            &m.cb[c]);
  }
  __syncthreads();
  for (int v = tid; v < n_ch * n_cyc; v += kThreads) {
    const int c = v / n_cyc, q = v % n_cyc;
    sincosf(m.s[c] * (float)cs * (float)q, &m.sq[v], &m.cq[v]);
    if (q >= first && q < first + a.corr_avg)
      m.cen[c * kMaxCa + q - first] = make_float2(m.cq[v], m.sq[v]);
  }
  for (int v = tid; v < n_ch * (kMaxCa - a.corr_avg); v += kThreads) {
    const int u = a.corr_avg + v % (kMaxCa - a.corr_avg);
    m.cen[(v / (kMaxCa - a.corr_avg)) * kMaxCa + u] = make_float2(0.f, 0.f);
  }

  const int tile0 = rank * n_tiles / n_ranks;
  const int tile1 = (rank + 1) * n_tiles / n_ranks;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int col0 = tile * kTile;
    // 2. the slab, asynchronously (16 B = two samples a copy); the
    //    previous tile's readers are done
    __syncthreads();
    for (int v = tid; v < n_cyc * (kTile / 2); v += kThreads) {
      const int q = v / (kTile / 2), j = 2 * (v % (kTile / 2));
      cp_async<16>(m.x + q * kRow + j, blk0 + (size_t)q * cs + col0 + j);
    }
    for (int g0 = 0; g0 < n_ch; g0 += gs) {
      const int gn = min(gs, n_ch - g0);
      if (g0 > 0) __syncthreads();   // the previous group's readers are done

      // 3. the group's rolled codes, code[(i - w) mod cs], gathered
      //    asynchronously too, and its channels whose head boundary
      //    (col < w) splits the tile; meanwhile the column tables
      for (int v = tid; v < gn * kTile; v += kThreads) {
        const int c = v / kTile, j = v % kTile;
        int src = col0 + j - m.w[g0 + c];
        if (src < 0) src += cs;
        cp_async<4>(m.code + v,
                    a.codes + (size_t)(ch0 + g0 + c) * cs + src);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      if (tid == 0) {
        int n = 0;
        for (int c = 0; c < gn; ++c)
          if (col0 < m.w[g0 + c] && m.w[g0 + c] < col0 + kTile)
            m.split[1 + n++] = c;
        m.split[0] = n;
      }
      for (int v = tid; v < gn * kTile; v += kThreads) {
        const int c = v / kTile, j = v % kTile;
        sincosf(m.s[g0 + c] * (float)(col0 + j + 1), &m.sph[v], &m.cph[v]);
      }
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();

      // 4. the weight columns, split into TF32 high and low parts: rows
      //    2c, 2c + 1 = code*cos, code*sin of group channel c; rows
      //    2G + 2i, 2G + 2i + 1 the same, head-masked, of split channel
      //    i; zero rows up to np
      const int n_split = m.split[0];
      const int n_cols = 2 * gn + 2 * n_split, np = n_pad(n_cols);
      for (int v = tid; v < (gn + n_split) * kTile; v += kThreads) {
        const int r = v / kTile, j = v % kTile;
        const int c = r < gn ? r : m.split[1 + r - gn];
        const int i = c * kTile + j;
        const float code =
            (r < gn || col0 + j < m.w[g0 + c]) ? m.code[i] : 0.f;
        const int row = 2 * r * kRow + j;
        split(code * m.cph[i], m.w_hi[row], m.w_lo[row]);
        split(code * m.sph[i], m.w_hi[row + kRow], m.w_lo[row + kRow]);
      }
      for (int v = tid; v < (np - n_cols) * kTile; v += kThreads) {
        const int row = (n_cols + v / kTile) * kRow + v % kTile;
        m.w_hi[row] = m.w_lo[row] = 0.f;
      }
      __syncthreads();

      // 5. wipeoff sums on the tensor cores: mma tile (mt, nt) covers
      //    periods 8mt..8mt+7 (rows: their re, then their im) against
      //    weight columns 8nt..8nt+7, over the kTile columns, in three
      //    passes (lo*hi + hi*lo into one accumulator, hi*hi into
      //    another).  A warp's tiles share mt, so it splits each A
      //    fragment once.
      {
        const int g = lane / 4, t4 = lane % 4;
        const int n_mt = n_cyc / 8, n_pairs = n_mt * (np / 8);
        for (int p0 = warp; p0 < n_pairs; p0 += kPairs * kWarps) {
          const int aoff = (8 * (p0 % n_mt) + g) * kRow + t4;
          int boff[kPairs];
          float big[kPairs][4], small[kPairs][4];
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            const int p = min(p0 + i * kWarps, n_pairs - 1);
            boff[i] = (8 * (p / n_mt) + g) * kRow + t4;
#pragma unroll
            for (int r = 0; r < 4; ++r) big[i][r] = small[i][r] = 0.f;
          }
#pragma unroll 4
          for (int k0 = 0; k0 < kTile; k0 += 8) {
            const float2 x0 = m.x[aoff + k0], x1 = m.x[aoff + k0 + 4];
            float ah[4], al[4];
            split(x0.x, ah[0], al[0]);
            split(x0.y, ah[1], al[1]);
            split(x1.x, ah[2], al[2]);
            split(x1.y, ah[3], al[3]);
            float bh[kPairs][2], bl[kPairs][2];
#pragma unroll
            for (int i = 0; i < kPairs; ++i) {
              bh[i][0] = m.w_hi[boff[i] + k0];
              bh[i][1] = m.w_hi[boff[i] + k0 + 4];
              bl[i][0] = m.w_lo[boff[i] + k0];
              bl[i][1] = m.w_lo[boff[i] + k0 + 4];
            }
#pragma unroll
            for (int i = 0; i < kPairs; ++i) mma_tf32(small[i], al, bh[i]);
#pragma unroll
            for (int i = 0; i < kPairs; ++i) mma_tf32(big[i], ah, bh[i]);
#pragma unroll
            for (int i = 0; i < kPairs; ++i) mma_tf32(small[i], ah, bl[i]);
          }
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            // d = (re.w1, re.w2, im.w1, im.w2) of period q and weight
            // column pair n / 2 (a channel's full or head-masked pair)
            const int p = p0 + i * kWarps;
            const int n = 8 * (p / n_mt) + 2 * t4, q = 8 * (p % n_mt) + g;
            if (p >= n_pairs || n >= n_cols) continue;
            const bool masked = n >= 2 * gn;
            const int c = masked ? m.split[1 + n / 2 - gn] : n / 2;
            const int cc = g0 + c;
            float d[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) d[r] = big[i][r] + small[i][r];
            const float e = d[0] + d[3], f = d[2] - d[1];  // sum x*w
            const float cqq = m.cq[cc * n_cyc + q], sqq = m.sq[cc * n_cyc + q];
            const float x = cqq * e + sqq * f, y = cqq * f - sqq * e;
            const float2 r = make_float2(m.cb[cc] * x + m.sb[cc] * y,
                                         m.cb[cc] * y - m.sb[cc] * x);
            if (masked) {
              m.lo[c * n_cyc + q] = r;
            } else {
              m.full[c * n_cyc + q] = r;
              const int w = m.w[cc];
              if (!(col0 < w && w < col0 + kTile))   // the tile is all
                m.lo[c * n_cyc + q] =                // tail or all head
                    w >= col0 + kTile ? r : make_float2(0.f, 0.f);
            }
          }
        }
      }
      __syncthreads();

      // 6. the tile's share of head = lo[0] and seg[q] = (full[q] - lo[q])
      //    + lo[q+1], added to the CTA's share in tile order (a thread
      //    owns the same entries at every tile)
      for (int v = tid; v < gn * sl; v += kThreads) {
        const int c = v / sl, r = v % sl;
        const float2* l = m.lo + c * n_cyc;
        float2 o;
        if (r == 0) {
          o = l[0];
        } else {
          const float2 fu = m.full[c * n_cyc + r - 1];
          o = make_float2(fu.x - l[r - 1].x, fu.y - l[r - 1].y);
          if (r < n_cyc) {
            o.x += l[r].x;
            o.y += l[r].y;
          }
        }
        float2* dst = m.share + g0 * sl + v;
        if (tile == tile0) {
          *dst = o;
        } else {
          dst->x += o.x;
          dst->y += o.y;
        }
      }

      // 7. the group's mean center period of the tile, f32 on CUDA
      //    cores, written once: a thread holds its column's center samples
      //    and serves every other channel from registers
      {
        const int j = tid % kTile;
        float2 xc[kMaxCa];
#pragma unroll
        for (int u = 0; u < kMaxCa; ++u)
          xc[u] = u < a.corr_avg ? m.x[(first + u) * kRow + j]
                                 : make_float2(0.f, 0.f);
        for (int c = tid / kTile; c < gn; c += kThreads / kTile) {
          const int cc = g0 + c;
          const float2* cw = m.cen + cc * kMaxCa;    // zeros past corr_avg
          float pr = 0.f, pi = 0.f;
#pragma unroll
          for (int u = 0; u < kMaxCa; ++u) {
            const float2 w = cw[u];
            pr += xc[u].x * w.x + xc[u].y * w.y;     // x * exp(-i s cs q)
            pi += xc[u].y * w.x - xc[u].x * w.y;
          }
          const int i = c * kTile + j;
          const float cp = m.cph[i], sp = m.sph[i];  // * exp(-i s (i+1))
          const float ur = pr * cp + pi * sp, ui = pi * cp - pr * sp;
          a.center[((size_t)b * n_all + ch0 + cc) * cs + col0 + j] =
              make_float2((m.cb[cc] * ur + m.sb[cc] * ui) * inv_ca,
                          (m.cb[cc] * ui - m.sb[cc] * ur) * inv_ca);
        }
      }
    }
  }

  // 8. the cluster (the block's n_ranks CTAs) adds the ranks' shares in
  //    rank order through distributed shared memory, each CTA a slice of
  //    the results
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int v = rank + n_ranks * tid; v < n_ch * sl;
       v += n_ranks * kThreads) {
    // every load issued at once: ranks past n_ranks repeat the last one
    // and count zero (its shares are finite)
    float2 x[kMaxTiles];
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t)
      x[t] = cluster.map_shared_rank(m.share, min(t, n_ranks - 1))[v];
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {   // rank order
      const float keep = t < n_ranks ? 1.f : 0.f;
      acc.x += keep * x[t].x;
      acc.y += keep * x[t].y;
    }
    const int c = v / sl, r = v % sl;
    if (r == 0)
      a.head[(size_t)(ch0 + c) * k + b] = acc;
    else
      a.seg[((size_t)(ch0 + c) * k + b) * n_cyc + r - 1] = acc;
  }
  // done reading the other CTAs' shares; none may leave before all are
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

}  // namespace

extern "C" int gsdr_wipeoff_launch(const WipeoffArgs* a, void* stream) {
  const int n_tiles = a->cs / kTile;
  const int n_ranks = n_tiles < kMaxTiles ? n_tiles : kMaxTiles;
  // n_cyc / 8 must divide kWarps: a warp's mma tiles share their rows
  if (a->cs <= 0 || a->cs % kTile != 0 || a->cs > kMaxCs ||
      a->n_ch <= 0 || a->n_ch > kMaxCh || a->k <= 0 || a->n_cyc <= 0 ||
      a->n_cyc % 8 != 0 || kWarps % (a->n_cyc / 8) != 0 ||
      a->corr_avg <= 0 || a->corr_avg > a->n_cyc ||
      a->corr_avg > kMaxCa || a->n_streams <= 0 || a->n_streams > 65535 ||
      a->chunk_stride < 0 || a->chunk_stride % 2 != 0 ||
      reinterpret_cast<uintptr_t>(a->chunk) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = carve(*a, nullptr, nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      wipeoff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (n_ranks > 8) {
    e = cudaFuncSetAttribute(wipeoff_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->k, n_ranks, a->n_streams);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = n_ranks;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wipeoff_kernel, *a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* gsdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
