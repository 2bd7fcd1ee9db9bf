// Block-stationary mix + code-wipeoff kernel of the K-block tracking heavy
// stage (sm_90a), reading the grouped planar chunk, in f32 on CUDA cores.
//
// Replaces gps_sdr_tpu/ops/pallas_kernels.py::_mix_wipeoff_kernel (the
// per-channel VPU formulation, called through mix_wipeoff by
// heavy_stage_pallas when use_mxu_wipeoff is False).  The plain PyTorch
// version and the contract are in gps_sdr_tpu_torch/ops/hopper_wipeoff.py
// (mix_wipeoff_vpu); the mirror of this kernel's order of arithmetic is
// _mix_wipeoff_vpu_math there.
//
// With ang(q, i) = (base_b + s*(i+1)) + s*cs*q, the wipeoff sum of period q
// is the column sum of the raw samples against the weights
// code[(i - w) mod cs] * exp(-i*(base_b + s*(i+1))), rotated once by
// exp(-i*s*cs*q); the mean center period is the sum of the center periods
// against exp(-i*s*cs*q), rotated once per column.  Every factor is f32
// and every product runs on CUDA cores (csrc/wipeoff.cu is the
// tensor-core formulation).
//
// One launch: grid (K, n_ranks, S), the n_ranks = min(n_tiles,
// kMaxTiles) CTAs of a block and stream form a thread-block cluster (16
// from cs = 2048 up, a non-portable size).  Rank r takes the column tiles
// [r * n_tiles / n_ranks, (r + 1) * n_tiles / n_ranks) of the n_tiles =
// ceil(cs / kTile), one after the other in tile order: one tile a CTA up
// to cs = 2048, 8 at cs = 16384 (16.384 MS/s), one or two at cs = 2400
// (2.4 MS/s: 19 tiles, ranks 5, 10 and 15 take two).  A code period off
// the tile grid (cs a multiple of 4, not of kTile) ends in a partial tile
// of cs mod kTile columns: only its granules inside the period are staged,
// the rest of its slab and its rolled codes there are zero, so the
// columns past cs add nothing to any sum, and no center sample is written
// there.  Those masks sit on that tile alone (a second instance of the
// staging and gather loops); every full tile runs the loops of a period
// on the grid.  The z axis is the stream axis of the serving path (the
// batch axis Pallas's vmap rule gives the TPU kernel): the CTAs of stream
// z serve its C channels, at z*C on the flattened S*C channel axis of
// every parameter and result, and read its chunk, chunk_stride floats
// after stream z-1's (0: one chunk shared by every stream, re-read from
// L2 by all but the first).  Nothing else depends on z, so a launch over
// S streams gives the bits of S single-stream launches; the channel limit
// (kMaxCh) is per stream.  A CTA has 4 main warps and 4 helper warps.  For
// each of its tiles, and in it for each group of at most kGroup channels
// (a thread's table entries of 16 channels fill its registers; 32
// channels are two groups):
//   1. every thread loads the parameters of its (channel, column) table
//      entries; these few loads go ahead of the slab's traffic;
//   2. (first group of a tile) the helpers start the copy of the tile's
//      [2, n_cyc, kTile] slab of block step*K + b into shared memory
//      (cp.async, 16 bytes a copy; the granules of a row are swizzled so
//      that the lanes of a main warp, one period slot each, read different
//      banks without padding);
//   3. while the slab lands, the group's tables at once: every thread
//      gathers the rolled code of all its entries together (one latency,
//      not one per channel) and tabulates (cos, sin)(base_b + s*(i+1)) for
//      the G x kTile entries (precise sincosf: the angles reach tens of
//      radians), with and without the code; the main warps also tabulate
//      (cos, sin)(s*cs*q).  One barrier ends the prologue;
//   4. the main loop has no barrier and no global load: worker (slot,
//      group) reads up to 4 periods x 8 columns of the slab once into
//      registers and serves its channels from them, one 16-byte shared
//      load giving two columns' weights for all its periods; the groups of
//      a warp add their sums by shuffles, the warps' sums go to shared
//      memory.  The head sum (i < w) is the full sum, zero, or, only in the
//      tile the boundary crosses, a second pass with masked weights.  The
//      main warps take the first channels (about 8 of 11); the helpers
//      first take the mean center period (a thread per column holds the
//      corr_avg center samples in registers and serves every channel,
//      writing center [K, C, cs] once) and then the other channels;
//   5. all threads add the warps' sums in warp order, rotate per period,
//      form the tile's share of head = lo[0] and seg[q] = (full[q] -
//      lo[q]) + lo[q+1] and add it, in tile order, to the CTA's share in
//      its own shared memory (the first tile's share is stored as it is).
//   After its last tile each CTA stores each entry of its share into the
//   shared memory of the CTA of the cluster that combines it (distributed
//   shared memory); after the cluster barrier each CTA adds, for its slice
//   of the results, the n_ranks shares in rank order and writes head and
//   seg.  No float atomics, no second kernel, no global scratch: every
//   result is the same from run to run.
//
// Bound: bytes (product shapes: 4.2 MB of blocks in, 1.4 MB of center out
// per K-step, against ~0.11 GFLOP of f32 arithmetic; at cs 16384, n_cyc 8,
// 11 channels: 8.4 MB in, 11.5 MB out).  Each block leaves device memory
// once.  What sets the time is the chain of phases per tile (parameters,
// code gather, tables, main loop, shares), each bound by latency and by the
// shared-memory pipe, run m tiles in a row; only 7 clusters of 16 fit at
// one CTA per SM, so the kernel keeps to 128 registers a thread and ~88 KB
// of shared memory at the product for two CTAs to share an SM, and the
// cluster that shares SMs, with twice the slab traffic and table arithmetic
// on each, sets the kernel's end.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

struct WipeoffVpuArgs {
  const float* chunk;   // f32 [T, 2, n_cyc, cs] grouped planar per stream,
                        // whole chunks
  const float* codes;   // f32 [S*C, cs], unrolled codes
  const float* s;       // f32 [S*C], 2*pi*freq/fs (rad/sample)
  const float* snp;     // f32 [S*C], (s*ngps) mod 2*pi, per-block advance
  const float* phase;   // f32 [S*C], NCO phase at the step's first sample
  const int* wipe;      // i32 [S*C, K], wipeoff delays in [0, cs)
  float2* center;       // complex64 [K, S*C, cs], mean center period
  float2* head;         // complex64 [S*C, K]
  float2* seg;          // complex64 [S*C, K, n_cyc]
  long long chunk_stride;  // floats from one stream's chunk to the next's
                           // (0: one chunk shared by every stream)
  int n_ch, k, step, n_cyc, cs, corr_avg;  // n_ch: channels a stream (C)
  int n_streams;                           // S, the grid's z extent
};

namespace {

constexpr int kMainThreads = 128;   // warps 0-3: tables, main loop
constexpr int kHelpThreads = 128;   // warps 4-7: slab copy, tables, center,
                                    // then their part of the main loop
constexpr int kThreads = kMainThreads + kHelpThreads;
constexpr int kMainWarps = kMainThreads / 32;
constexpr int kTile = 128;          // columns of a code period per tile
constexpr int kGran = kTile / 4;    // 16-byte granules of a slab row
constexpr int kMaxTiles = 16;       // CTAs of a cluster (non-portable > 8)
constexpr int kMaxCa = 16;          // center periods held in registers
constexpr int kGroup = 16;          // channels whose tables are built at once
constexpr int kMaxCh = 32;          // channels a stream
constexpr int kMinCs = kTile;       // code period, samples: a multiple of
constexpr int kMaxCs = 16384;       // 4 (16-byte rows) in [kMinCs, kMaxCs]
// (channel, column) table entries of a group a thread fills at most
constexpr int kEnt = kGroup * kTile / kThreads;
constexpr int kQ = 8;               // period slots of the main loop
static_assert(kHelpThreads == kTile, "a helper thread per column");

struct Smem {       // the CTA's dynamic shared memory
  float4* x;        // [2 * n_cyc][kGran] the slab, granules swizzled
  float2* wt;       // [G][kTile] code * (cos, sin)(base_b + s*(i+1))
  float2* osc;      // [G][kTile] (cos, sin)(base_b + s*(i+1))
  float2* cq;       // [G][n_cyc] (cos, sin)(s*cs*q)
  float2* cen;      // [G][kMaxCa] cq of the center periods, zeros past
                    // corr_avg
  float2* red;      // [G][2][kMainWarps][n_cyc] a warp's column sums of a
                    // period: full, and head where the tile is split
  float2* share;    // [C][n_cyc + 1] the CTA's share of head and seg
  float2* recv;     // [n_ranks][slice] the ranks' shares of this CTA's
                    // slice of head/seg, written by the cluster's CTAs
  int* w;           // [C] the block's wipeoff delay
};

__host__ __device__ int n_tiles_of(const WipeoffVpuArgs& a) {
  return (a.cs + kTile - 1) / kTile;
}

__host__ __device__ int n_ranks_of(const WipeoffVpuArgs& a) {
  const int n_tiles = n_tiles_of(a);
  return n_tiles < kMaxTiles ? n_tiles : kMaxTiles;
}

__host__ __device__ int group_size(const WipeoffVpuArgs& a) {
  return a.n_ch < kGroup ? a.n_ch : kGroup;
}

// results (head, then the n_cyc segments, per channel) a CTA of the cluster
// combines: result v belongs to rank v % n_ranks, at slot v / n_ranks
__host__ __device__ int slice_len(const WipeoffVpuArgs& a) {
  const int n_ranks = n_ranks_of(a);
  return (a.n_ch * (a.n_cyc + 1) + n_ranks - 1) / n_ranks;
}

// Lay out the dynamic shared memory from `base` (every array on a 16-byte
// boundary); returns its size in bytes.  m may be null (size only).
__host__ __device__ size_t carve(const WipeoffVpuArgs& a, float* base,
                                 Smem* m) {
  const size_t c = a.n_ch, nq = a.n_cyc, g = group_size(a);
  const size_t floats[] = {2 * nq * kTile,
                           2 * g * kTile,
                           2 * g * kTile,
                           2 * g * nq,
                           2 * g * kMaxCa,
                           2 * g * 2 * kMainWarps * nq,
                           2 * c * (nq + 1),
                           2 * (size_t)n_ranks_of(a) * slice_len(a),
                           c};
  constexpr int kArrays = sizeof(floats) / sizeof(floats[0]);
  size_t off[kArrays], n = 0;
  for (int i = 0; i < kArrays; ++i) {
    off[i] = n;
    n += (floats[i] + 3) / 4 * 4;
  }
  if (m) {
    m->x = reinterpret_cast<float4*>(base + off[0]);
    m->wt = reinterpret_cast<float2*>(base + off[1]);
    m->osc = reinterpret_cast<float2*>(base + off[2]);
    m->cq = reinterpret_cast<float2*>(base + off[3]);
    m->cen = reinterpret_cast<float2*>(base + off[4]);
    m->red = reinterpret_cast<float2*>(base + off[5]);
    m->share = reinterpret_cast<float2*>(base + off[6]);
    m->recv = reinterpret_cast<float2*>(base + off[7]);
    m->w = reinterpret_cast<int*>(base + off[8]);
  }
  return n * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// z * exp(-i ang) for f = (cos ang, sin ang)
__device__ __forceinline__ float2 rotate(float zr, float zi, float2 f) {
  return make_float2(f.x * zr + f.y * zi, f.x * zi - f.y * zr);
}

// acc += x * (w.x - i w.y)
__device__ __forceinline__ void cmac(float& ar, float& ai, float xr, float xi,
                                     float wr, float wi) {
  ar = fmaf(xr, wr, ar);
  ai = fmaf(xi, wr, ai);
  ar = fmaf(xi, wi, ar);
  ai = fmaf(-xr, wi, ai);
}

// Sums of x * (wr - i wi) over a thread's kCols columns for its kP periods,
// each in two chains; with kMasked over the first n_head columns only.
template <int kP, int kCols, bool kMasked>
__device__ __forceinline__ void column_sums(const float (&xr)[kP][kCols],
                                            const float (&xi)[kP][kCols],
                                            const float4* wp, int n_head,
                                            float (&sr)[kP], float (&si)[kP]) {
  float ar[kP][2], ai[kP][2];
#pragma unroll
  for (int pp = 0; pp < kP; ++pp)
    ar[pp][0] = ar[pp][1] = ai[pp][0] = ai[pp][1] = 0.f;
#pragma unroll
  for (int t = 0; t < kCols / 2; ++t) {
    float4 w = wp[t];       // the weights of columns 2t, 2t + 1
    if (kMasked) {
      if (2 * t >= n_head) w.x = w.y = 0.f;
      if (2 * t + 1 >= n_head) w.z = w.w = 0.f;
    }
#pragma unroll
    for (int pp = 0; pp < kP; ++pp) {
      cmac(ar[pp][0], ai[pp][0], xr[pp][2 * t], xi[pp][2 * t], w.x, w.y);
      cmac(ar[pp][1], ai[pp][1], xr[pp][2 * t + 1], xi[pp][2 * t + 1], w.z,
           w.w);
    }
  }
#pragma unroll
  for (int pp = 0; pp < kP; ++pp) {
    sr[pp] = ar[pp][0] + ar[pp][1];
    si[pp] = ai[pp][0] + ai[pp][1];
  }
}

// kCa: corr_avg rounded up to the unrolled center loop's length
template <int kNCyc, int kCa>
__global__ void __launch_bounds__(kThreads, 2)
    wipeoff_vpu_kernel(WipeoffVpuArgs a) {
  // worker (qs, g) holds kP periods of column group g (kCols columns) at
  // a time, in kPass passes; a warp holds 32 / kQ groups
  constexpr int kP = kNCyc / kQ < 4 ? kNCyc / kQ : 4;
  constexpr int kPass = kNCyc / (kQ * kP);
  constexpr int kGroups = kMainThreads / kQ;
  constexpr int kCols = kTile / kGroups;
  static_assert(kP * kPass * kQ == kNCyc && kCols % 4 == 0, "mapping");
  extern __shared__ __align__(16) float smem[];
  Smem m;
  carve(a, smem, &m);
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x, rank = blockIdx.y, n_ranks = gridDim.y;
  const int cs = a.cs, n_ch = a.n_ch, k = a.k, ca = a.corr_avg;
  const int n_tiles = n_tiles_of(a), sl = kNCyc + 1, gs = group_size(a);
  // this stream's first channel on the flattened S*C axis, and that axis
  const int ch0 = blockIdx.z * n_ch, n_all = gridDim.z * n_ch;
  const int tid = threadIdx.x;
  const bool helper = tid >= kMainThreads;
  const int first = (kNCyc - ca) / 2;
  const float* blk0 = a.chunk + (size_t)blockIdx.z * a.chunk_stride +
                      (size_t)(a.step * k + b) * 2 * kNCyc * cs;

  // every CTA of the cluster has started once this barrier completes; it
  // is waited for just before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int tile0 = rank * n_tiles / n_ranks;
  const int tile1 = (rank + 1) * n_tiles / n_ranks;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int col0 = tile * kTile;
    const int nv = min(kTile, cs - col0);   // the tile's columns in the period
    for (int g0 = 0; g0 < n_ch; g0 += gs) {
      const int gn = min(gs, n_ch - g0);
      // the previous group's or tile's readers of the slab, the tables
      // and the warps' sums are done.  Not before the first: nothing
      // waits ahead of its parameter loads and slab copy (m.w is read
      // only past the prologue's barrier)
      if (tile != tile0 || g0 != 0) __syncthreads();

      // 1. the parameters of this thread's table entries.  Entry v =
      //    (group channel v / kTile, column v % kTile); a thread's entries
      //    are tid, tid + kThreads, ...  These few loads go first: behind
      //    the slab's traffic they would wait for all of it.
      const int n_ent = gn * kTile;
      int src[kEnt];
      float ps[kEnt], pbase[kEnt], code[kEnt];
#pragma unroll
      for (int i = 0; i < kEnt; ++i) {
        const int v = tid + i * kThreads;
        const int c = ch0 + g0 + min(v, n_ent - 1) / kTile;
        src[i] = col0 + v % kTile - __ldg(a.wipe + c * k + b);
        ps[i] = __ldg(a.s + c);
        pbase[i] = __fadd_rn(__ldg(a.phase + c),
                             __fmul_rn(__ldg(a.snp + c), (float)b));
      }
      // the delays of all channels, once; their shared stores wait for
      // the loads, so they come after the entries' loads are in flight
      if (tile == tile0 && g0 == 0 && tid < n_ch)
        m.w[tid] = __ldg(a.wipe + (ch0 + tid) * k + b);

      // 2. the helpers start the tile's slab copy: row = plane * n_cyc +
      //    q, rows cs floats apart in the chunk.  Granule gr of row `row`
      //    sits at gr ^ ((row / kP) % 8): the lanes of a main warp, kP
      //    rows apart, then read different banks.  A partial tile's
      //    granules past its nv columns are zero.
      auto stage = [&](auto partial) {
        const float* blk = blk0 + col0;
        for (int v = tid - kMainThreads; v < 2 * kNCyc * kGran;
             v += kHelpThreads) {
          const int row = v / kGran, gr = v % kGran;
          float4* dst = m.x + row * kGran + (gr ^ ((row / kP) % 8));
          if (!decltype(partial)::value || 4 * gr < nv)
            cp_async16(dst, blk + (size_t)row * cs + 4 * gr);
          else
            *dst = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        asm volatile("cp.async.commit_group;\n" ::);
      };
      if (helper && g0 == 0) {
        if (nv == kTile)
          stage(std::false_type{});
        else
          stage(std::true_type{});
      }

      // 3. the group's tables, while the slab lands: every rolled-code
      //    gather, code[(i - w) mod cs], so that they are in flight
      //    together (one latency, not one per channel; zero past a partial
      //    tile's nv columns); the period table (main warps); the column
      //    table
      auto gather = [&](auto partial) {
#pragma unroll
        for (int i = 0; i < kEnt; ++i) {
          const int v = tid + i * kThreads;
          code[i] = 0.f;
          if (v < n_ent && (!decltype(partial)::value || v % kTile < nv))
            code[i] = __ldg(a.codes + (size_t)(ch0 + g0 + v / kTile) * cs +
                            (src[i] < 0 ? src[i] + cs : src[i]));
        }
      };
      if (nv == kTile)
        gather(std::false_type{});
      else
        gather(std::true_type{});
      if (!helper) {
        for (int v = tid; v < gn * kNCyc; v += kMainThreads) {
          const int c = v / kNCyc, q = v % kNCyc;
          float sn, cn;
          sincosf(__fmul_rn(__fmul_rn(__ldg(a.s + ch0 + g0 + c), (float)cs),
                            (float)q),
                  &sn, &cn);
          m.cq[v] = make_float2(cn, sn);
          if (q >= first && q < first + ca)
            m.cen[c * kMaxCa + q - first] = make_float2(cn, sn);
        }
        for (int v = tid; v < gn * (kMaxCa - ca); v += kMainThreads)
          m.cen[(v / (kMaxCa - ca)) * kMaxCa + ca + v % (kMaxCa - ca)] =
              make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kEnt; ++i) {
        const int v = tid + i * kThreads;
        if (v < n_ent) {
          float sn, cn;
          sincosf(__fadd_rn(pbase[i],
                            __fmul_rn(ps[i], (float)(col0 + v % kTile + 1))),
                  &sn, &cn);
          m.osc[v] = make_float2(cn, sn);
          m.wt[v] = make_float2(code[i] * cn, code[i] * sn);
        }
      }
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();

      // 4. The main loop has no barrier and no global load: worker (slot,
      //    group), one per main thread and again one per helper thread,
      //    reads kP periods' kCols columns into registers and serves the
      //    group channels [c_begin, c_end), one 16-byte shared load giving
      //    two columns' weights for its kP periods; the groups of a warp
      //    add their sums by shuffles, the warps' sums go to shared
      //    memory.  The head columns (col < w) are the whole tile, none of
      //    it, or, in the one tile the boundary crosses, a second pass
      //    with masked weights.
      auto main_loop = [&](int c_begin, int c_end) {
        const int wid = tid % kMainThreads;
        const int warp = wid / 32, lane = wid % 32;
        const int qs = wid % kQ, j0 = (wid / kQ) * kCols;
        const float4* wt4 = reinterpret_cast<const float4*>(m.wt);
#pragma unroll 1
        for (int pass = 0; pass < kPass; ++pass) {
          const int q0 = (pass * kQ + qs) * kP;   // the worker's first period
          float xr[kP][kCols], xi[kP][kCols];
#pragma unroll
          for (int pp = 0; pp < kP; ++pp)
#pragma unroll
            for (int t = 0; t < kCols / 4; ++t) {
              const int at = (q0 + pp) * kGran + ((j0 / 4 + t) ^ (qs % 8));
              const float4 re = m.x[at], im = m.x[kNCyc * kGran + at];
              xr[pp][4 * t] = re.x, xr[pp][4 * t + 1] = re.y;
              xr[pp][4 * t + 2] = re.z, xr[pp][4 * t + 3] = re.w;
              xi[pp][4 * t] = im.x, xi[pp][4 * t + 1] = im.y;
              xi[pp][4 * t + 2] = im.z, xi[pp][4 * t + 3] = im.w;
            }
          // sums of group channel c into red[c][part]: part 0 full, part 1
          // head
          auto sums = [&](int c, int part, auto masked, int n_head) {
            float sr[kP], si[kP];
            column_sums<kP, kCols, decltype(masked)::value>(
                xr, xi, wt4 + (c * kTile + j0) / 2, n_head, sr, si);
#pragma unroll
            for (int off = 16; off >= kQ; off /= 2)
#pragma unroll
              for (int pp = 0; pp < kP; ++pp) {
                sr[pp] += __shfl_xor_sync(0xffffffffu, sr[pp], off);
                si[pp] += __shfl_xor_sync(0xffffffffu, si[pp], off);
              }
            if (lane < kQ) {
              float2* dst =
                  m.red + ((c * 2 + part) * kMainWarps + warp) * kNCyc + q0;
#pragma unroll
              for (int pp = 0; pp < kP; ++pp)
                dst[pp] = make_float2(sr[pp], si[pp]);
            }
          };
#pragma unroll 1
          for (int c = c_begin; c < c_end; ++c)
            sums(c, 0, std::false_type{}, 0);
#pragma unroll 1
          for (int c = c_begin; c < c_end; ++c) {
            const int wl = m.w[g0 + c] - col0;
            if (wl > 0 && wl < kTile) sums(c, 1, std::true_type{}, wl - j0);
          }
        }
      };
      // the main warps take the first channels; the helpers first the
      // mean center period and then the other channels (about 8 of 11
      // against 3)
      const int c_split = (8 * gn + 10) / 11;
      if (helper) {
        // the mean center period: a thread per column holds its center
        // samples in registers and serves every channel of the group:
        // their sum against exp(-i s cs q), then the column factor once
        // (a partial tile's columns past nv write nothing)
        auto center = [&](auto partial) {
          const int j = tid - kMainThreads;
          if (decltype(partial)::value && j >= nv) return;
          const float inv_ca = 1.0f / (float)ca;
          const float* xs = reinterpret_cast<const float*>(m.x);
          float xcr[kCa], xci[kCa];
#pragma unroll
          for (int u = 0; u < kCa; ++u) {
            const int row = first + u;
            const int at =
                row * kTile + 4 * ((j / 4) ^ ((row / kP) % 8)) + j % 4;
            xcr[u] = u < ca ? xs[at] : 0.f;
            xci[u] = u < ca ? xs[kNCyc * kTile + at] : 0.f;
          }
#pragma unroll 2
          for (int c = 0; c < gn; ++c) {
            // (cos, sin) of two center periods a load; zeros past corr_avg
            const float4* cw =
                reinterpret_cast<const float4*>(m.cen + c * kMaxCa);
            float pr = 0.f, pi = 0.f;
#pragma unroll
            for (int u = 0; u < kCa; u += 2) {
              const float4 f = cw[u / 2];
              pr += xcr[u] * f.x + xci[u] * f.y;
              pi += xci[u] * f.x - xcr[u] * f.y;
              pr += xcr[u + 1] * f.z + xci[u + 1] * f.w;
              pi += xci[u + 1] * f.z - xcr[u + 1] * f.w;
            }
            const float2 o = rotate(pr, pi, m.osc[c * kTile + j]);
            a.center[((size_t)b * n_all + ch0 + g0 + c) * cs + col0 + j] =
                make_float2(o.x * inv_ca, o.y * inv_ca);
          }
        };
        if (nv == kTile)
          center(std::false_type{});
        else
          center(std::true_type{});
        main_loop(c_split, gn);
      } else {
        main_loop(0, c_split);
      }
      __syncthreads();

      // 5. the tile's share of head = lo[0] and seg[q] = (full[q] - lo[q])
      //    + lo[q+1]: the warps' sums added in warp order, then rotated by
      //    the period's factor, and added to the CTA's share in tile order
      //    (a thread owns the same entries at every tile)
      for (int v = tid; v < gn * sl; v += kThreads) {
        const int c = v / sl, r = v % sl;
        const int wl = m.w[g0 + c] - col0;
        // (lo, full - lo) of period q, rotated
        auto period = [&](int q, float2& lo, float2& hi) {
          const float2* rc = m.red + c * 2 * kMainWarps * kNCyc + q;
          float fr = 0.f, fi = 0.f, lr = 0.f, li = 0.f;
#pragma unroll
          for (int w = 0; w < kMainWarps; ++w) {
            const float2 e = rc[w * kNCyc];
            fr += e.x, fi += e.y;
          }
          if (wl >= kTile) {
            lr = fr, li = fi;
          } else if (wl > 0) {
#pragma unroll
            for (int w = 0; w < kMainWarps; ++w) {
              const float2 e = rc[(kMainWarps + w) * kNCyc];
              lr += e.x, li += e.y;
            }
          }
          const float2 f = m.cq[c * kNCyc + q];
          lo = rotate(lr, li, f);
          hi = rotate(fr - lr, fi - li, f);
        };
        float2 o = make_float2(0.f, 0.f), lo, hi;
        if (r > 0) {
          period(r - 1, lo, hi);
          o = hi;
        }
        if (r < kNCyc) {
          period(r, lo, hi);
          o.x += lo.x, o.y += lo.y;
        }
        float2* dst = m.share + g0 * sl + v;
        if (tile == tile0) {
          *dst = o;
        } else {
          dst->x += o.x;
          dst->y += o.y;
        }
      }
    }
  }

  // 6. result v of the CTA's share goes to the CTA of the cluster (the
  //    block's n_ranks CTAs) that combines it, through distributed shared
  //    memory; after the barrier each CTA adds the ranks' shares of its
  //    slice of head and seg in rank order.  After that barrier no CTA
  //    touches another's shared memory.
  const int slice = slice_len(a);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int v = tid; v < n_ch * sl; v += kThreads)
    cluster.map_shared_rank(m.recv, v % n_ranks)[rank * slice + v / n_ranks] =
        m.share[v];
  // the center's stores are long done by now, so the release waits for the
  // remote shares mostly
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int slot = tid; rank + n_ranks * slot < n_ch * sl; slot += kThreads) {
    // ranks past n_ranks repeat the last one and count zero (its shares
    // are finite)
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {   // rank order
      const float2 x = m.recv[min(t, n_ranks - 1) * slice + slot];
      const float keep = t < n_ranks ? 1.f : 0.f;
      acc.x += keep * x.x;
      acc.y += keep * x.y;
    }
    const int v = rank + n_ranks * slot, c = v / sl, r = v % sl;
    if (r == 0)
      a.head[(size_t)(ch0 + c) * k + b] = acc;
    else
      a.seg[((size_t)(ch0 + c) * k + b) * kNCyc + r - 1] = acc;
  }
}

template <int kNCyc, int kCa>
cudaError_t launch(const WipeoffVpuArgs& a, cudaStream_t stream) {
  auto kernel = wipeoff_vpu_kernel<kNCyc, kCa>;
  const int n_ranks = n_ranks_of(a);
  const size_t smem = carve(a, nullptr, nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (n_ranks > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.k, n_ranks, a.n_streams);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = n_ranks;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int kNCyc>
cudaError_t launch(const WipeoffVpuArgs& a, cudaStream_t stream) {
  return a.corr_avg <= 8 ? launch<kNCyc, 8>(a, stream)
                         : launch<kNCyc, kMaxCa>(a, stream);
}

}  // namespace

extern "C" int gsdr_wipeoff_vpu_launch(const WipeoffVpuArgs* a,
                                       void* stream) {
  if (a->cs < kMinCs || a->cs % 4 != 0 || a->cs > kMaxCs ||
      a->n_ch <= 0 || a->n_ch > kMaxCh || a->k <= 0 || a->corr_avg <= 0 ||
      a->corr_avg > a->n_cyc || a->corr_avg > kMaxCa ||
      a->n_streams <= 0 || a->n_streams > 65535 || a->chunk_stride < 0 ||
      a->chunk_stride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a->chunk) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a->n_cyc) {
    case 8: return (int)launch<8>(*a, st);
    case 16: return (int)launch<16>(*a, st);
    case 32: return (int)launch<32>(*a, st);
    case 64: return (int)launch<64>(*a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gsdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
