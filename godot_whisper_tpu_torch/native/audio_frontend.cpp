// Native audio frontend of godot_whisper_tpu_torch: the capture ring of the
// JAX package's native/audio_frontend.cpp.
//
// The handoff from the audio thread to the streaming scheduler
// (AudioEffectCapture -> accumulated frames,
// bin/addons/godot_whisper/capture_stream_to_text.gd:73-75), in native code
// so that neither side loops over samples in Python.  Resampling, the VAD
// and the energy envelope run in numpy (audio/resample.py, audio/vad.py,
// decode/timestamps.py).  A plain C ABI for ctypes; native/bindings.py
// builds it with g++ at first use.

#include <atomic>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- ring buffer
// Single-producer single-consumer float ring (audio thread -> scheduler).
struct gwt_ring {
    std::vector<float> buf;
    std::atomic<uint64_t> head{0};  // write position (samples)
    std::atomic<uint64_t> tail{0};  // read position
};

gwt_ring* gwt_ring_new(uint64_t capacity) {
    auto* r = new gwt_ring();
    r->buf.resize(capacity);
    return r;
}

void gwt_ring_free(gwt_ring* r) { delete r; }

// Returns samples actually written (drops on overflow, like
// AudioEffectCapture when unread).
uint64_t gwt_ring_push(gwt_ring* r, const float* data, uint64_t n) {
    const uint64_t cap = r->buf.size();
    uint64_t head = r->head.load(std::memory_order_relaxed);
    const uint64_t tail = r->tail.load(std::memory_order_acquire);
    const uint64_t free_space = cap - (head - tail);
    if (n > free_space) n = free_space;
    for (uint64_t i = 0; i < n; i++) {
        r->buf[(head + i) % cap] = data[i];
    }
    r->head.store(head + n, std::memory_order_release);
    return n;
}

uint64_t gwt_ring_available(const gwt_ring* r) {
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_relaxed);
}

uint64_t gwt_ring_pop(gwt_ring* r, float* out, uint64_t n) {
    const uint64_t cap = r->buf.size();
    const uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t avail = head - tail;
    if (n > avail) n = avail;
    for (uint64_t i = 0; i < n; i++) {
        out[i] = r->buf[(tail + i) % cap];
    }
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

}  // extern "C"
