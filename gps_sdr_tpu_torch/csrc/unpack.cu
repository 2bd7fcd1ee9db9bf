// Packed 8-bit IQ -> complex64 on the card (sm_90a).
//
// The capture format (gps_sdr_tpu_torch/runtime/sources.py) packs a sample
// as one little-endian uint16 word, 256*Q + I, and normalizes each byte v
// to v/127.5 - 1 evaluated in double and rounded once to float32 (the
// values of unpack_iq_numpy and csrc/ingest.cpp's table).  The host-fed
// receiver uploads the words as they are, 2 bytes a sample instead of
// complex64's 8, and this kernel unpacks them where tracking reads them.
// The plain PyTorch twin and the contract are in
// gps_sdr_tpu_torch/ops/hopper_unpack.py.
//
// Each CTA of 256 threads first builds the 256-entry table in shared
// memory (one double division a thread, so every entry has the host's
// bits), then each thread takes a pair of words a pass of a grid-stride
// loop: one 4-byte load, four table reads, one 16-byte store of two
// complex64 samples, so a warp's loads and stores are coalesced.  An odd
// word count leaves one word, which thread 0 of CTA 0 writes.
//
// Bound: bytes.  A product chunk (32 blocks of 65,536 samples) reads 4 MB
// and writes 16.8 MB: ~6 us at the card's 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

struct UnpackArgs {
  const uint16_t* words;  // n packed words; 4-byte aligned
  float2* out;            // n complex64 samples; 16-byte aligned
  long long n;
};

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxCtas = 1 << 16;

__global__ void __launch_bounds__(kThreads)
    unpack_iq8_kernel(UnpackArgs a) {
  __shared__ float lut[256];
  lut[threadIdx.x] = (float)((double)threadIdx.x / 127.5 - 1.0);
  __syncthreads();
  const uint32_t* pairs = reinterpret_cast<const uint32_t*>(a.words);
  float4* out = reinterpret_cast<float4*>(a.out);
  const long long n_pairs = a.n >> 1;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < n_pairs; p += (long long)gridDim.x * kThreads) {
    // the lower address's word sits in the low half (little-endian)
    const uint32_t w = __ldg(pairs + p);
    out[p] = make_float4(lut[w & 0xff], lut[(w >> 8) & 0xff],
                         lut[(w >> 16) & 0xff], lut[w >> 24]);
  }
  if ((a.n & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    const uint16_t w = a.words[a.n - 1];
    a.out[a.n - 1] = make_float2(lut[w & 0xff], lut[w >> 8]);
  }
}

}  // namespace

extern "C" int gsdr_unpack_launch(const UnpackArgs* a, void* stream) {
  if (a->n <= 0 || reinterpret_cast<uintptr_t>(a->words) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a->out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  long long ctas = ((a->n >> 1) + kThreads - 1) / kThreads;
  if (ctas < 1) ctas = 1;
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  unpack_iq8_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}

extern "C" const char* gsdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
