// Host-side IQ ingest: the byte-crunching edge of the data path.
//
// The port's copy of the JAX package's csrc/ingest.cpp, code unchanged.
// The equivalent of the reference's native front-end surface
// (librtlsdr delivers packed 8-bit IQ; numpy unpacks it,
// reference src/gpsrecv.py:168-172).  Everything device-side is
// PyTorch/CUDA; this shim keeps the host edge off the Python interpreter:
//
//   * unpack_iq:  uint16 words (256*Q + I) -> interleaved f32 re/im
//                 pairs normalized v/127.5 - 1  (bit-identical to the
//                 reference normalization)
//   * pack_iq:    float32 re/im pairs -> packed uint16 words
//   * unpack_iq_file: fread + unpack in one pass (replay hot path)
//   * ring buffer: lock-free SPSC block queue with drop-oldest +
//                 skip accounting, the semantics of the reference's
//                 bounded deque (src/gpsrecv.py:76-104)
//
// Built as a plain shared library (no pybind11 in the image); Python
// binds via ctypes (gps_sdr_tpu_torch/runtime/_native.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---- packed IQ <-> float32 pairs -------------------------------------------

void gst_unpack_iq(const uint16_t* words, float* out, int64_t n) {
    // out[2k] = re, out[2k+1] = im ; v/127.5 - 1
    static float lut[256];
    static std::atomic<int> lut_ready{0};
    if (!lut_ready.load(std::memory_order_acquire)) {
        for (int i = 0; i < 256; ++i)  // double math, single rounding
            lut[i] = static_cast<float>(i / 127.5 - 1.0);
        lut_ready.store(1, std::memory_order_release);
    }
    for (int64_t k = 0; k < n; ++k) {
        const uint16_t w = words[k];
        out[2 * k] = lut[w & 0xff];         // I in the low byte
        out[2 * k + 1] = lut[w >> 8];       // Q in the high byte
    }
}

void gst_pack_iq(const float* pairs, uint16_t* out, int64_t n) {
    for (int64_t k = 0; k < n; ++k) {
        float re = (pairs[2 * k] + 1.0f) * 127.5f;
        float im = (pairs[2 * k + 1] + 1.0f) * 127.5f;
        re = re < 0.f ? 0.f : (re > 255.f ? 255.f : re);
        im = im < 0.f ? 0.f : (im > 255.f ? 255.f : im);
        const auto ri = static_cast<uint16_t>(re + 0.5f);
        const auto qi = static_cast<uint16_t>(im + 0.5f);
        out[k] = static_cast<uint16_t>(qi * 256 + ri);
    }
}

// fread + unpack one block; returns samples read (0 on EOF/short read).
int64_t gst_unpack_iq_file(const char* path, int64_t offset_samples,
                           int64_t n_samples, float* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, 2 * offset_samples, SEEK_SET) != 0) {
        std::fclose(f);
        return -1;
    }
    auto* buf = static_cast<uint16_t*>(std::malloc(2 * n_samples));
    if (!buf) {
        std::fclose(f);
        return -1;
    }
    const auto got = static_cast<int64_t>(
        std::fread(buf, 2, static_cast<size_t>(n_samples), f));
    std::fclose(f);
    if (got == n_samples) gst_unpack_iq(buf, out, got);
    std::free(buf);
    return got == n_samples ? got : 0;
}

// ---- SPSC block ring with drop-oldest + skip accounting --------------------
//
// Mirrors pushToBuffer/pullFromBuffer (gpsrecv.py:76-104): a bounded
// queue of fixed-size float32-pair blocks; on overflow the whole buffer
// is cleared and the number of dropped blocks is added to a skip
// counter that the consumer collects with the next block.

struct GstRing {
    float* data;              // [capacity][block_floats]
    int64_t block_floats;     // 2 * ngps
    int64_t capacity;
    std::atomic<int64_t> head{0};   // next write slot (producer)
    std::atomic<int64_t> tail{0};   // next read slot (consumer)
    std::atomic<int64_t> skipped{0};
};

void* gst_ring_create(int64_t capacity, int64_t block_floats) {
    auto* r = new GstRing();
    r->block_floats = block_floats;
    r->capacity = capacity;
    r->data = static_cast<float*>(
        std::malloc(sizeof(float) * capacity * block_floats));
    if (!r->data) {
        delete r;
        return nullptr;
    }
    return r;
}

void gst_ring_destroy(void* ring) {
    auto* r = static_cast<GstRing*>(ring);
    if (!r) return;
    std::free(r->data);
    delete r;
}

// Push one block; on a full ring, clears it and counts the dropped
// blocks as skipped (drop-oldest semantics, gpsrecv.py:81-87).
void gst_ring_push(void* ring, const float* block) {
    auto* r = static_cast<GstRing*>(ring);
    const int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    while (head - tail >= r->capacity) {
        // Drop-oldest must not race the consumer's tail advance: claim the
        // whole backlog with a CAS.  A pop that loses the race re-validates
        // its copy against tail and retries, so a block the producer is
        // about to overwrite is never delivered torn.
        if (r->tail.compare_exchange_weak(tail, head,
                                          std::memory_order_acq_rel,
                                          std::memory_order_acquire)) {
            r->skipped.fetch_add(head - tail, std::memory_order_relaxed);
            break;
        }
        // CAS failure reloaded tail (the consumer advanced it); if that
        // freed a slot we fall out of the loop and write normally.
    }
    std::memcpy(r->data + (head % r->capacity) * r->block_floats, block,
                sizeof(float) * r->block_floats);
    r->head.store(head + 1, std::memory_order_release);
}

// Pop one block into out; returns the skip count collected with it,
// or -1 if the ring is empty.
int64_t gst_ring_pop(void* ring, float* out) {
    auto* r = static_cast<GstRing*>(ring);
    for (;;) {
        int64_t tail = r->tail.load(std::memory_order_acquire);
        const int64_t head = r->head.load(std::memory_order_acquire);
        if (tail >= head) return -1;
        std::memcpy(out, r->data + (tail % r->capacity) * r->block_floats,
                    sizeof(float) * r->block_floats);
        // Publish the read only if the producer's drop-oldest didn't
        // reclaim this slot mid-copy; otherwise the copy may be torn —
        // discard it and retry on the post-drop backlog.
        if (r->tail.compare_exchange_strong(tail, tail + 1,
                                            std::memory_order_acq_rel,
                                            std::memory_order_acquire))
            return r->skipped.exchange(0, std::memory_order_relaxed);
    }
}

int64_t gst_ring_size(void* ring) {
    auto* r = static_cast<GstRing*>(ring);
    return r->head.load(std::memory_order_acquire)
         - r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
