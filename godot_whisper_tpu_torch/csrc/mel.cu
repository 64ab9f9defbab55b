// K1: log-mel spectrogram, raw log10 (before the clip-global max-8 clamp),
// and gwt_mel_pad, which builds K1's padded float16 input on the card
// (below).
//
// Replaces the TPU kernel `_mel_kernel` (godot_whisper_tpu/ops/mel_kernel.py,
// reached through `_log_mel_pallas`).  Same function: frames of 400 samples
// at hop 160 from f16 audio upcast to f32, a DFT against the periodic-Hann
// windowed cos | -sin basis, power re^2 + im^2 over the 201 bins, the mel
// filterbank product, log10(max(x, 1e-10)).
//
// Bound on an H100: the DFT is 2 x 400 x 402 operations a frame, run twice
// (below), 5.8 GFLOP for the 8998 frames of a 90 s bucket, ~12 us at the
// 495 TFLOP/s TF32 rate; the power and the sparse filterbank (~1.4 kFLOP a
// frame on the CUDA cores) and the bytes (2 B of audio in and 4 n_mels B
// out per 160 samples, the 666 KB basis) are far below that.  mma.sync
// reaches only part of that rate (it is wgmma's), and the split's integer
// operations and the round-to-nearest adds share its issue slots.
//
// Numerics: split TF32 on the tensor cores.  Every f16 sample is exact in
// TF32, so only the basis is split, b = hi + lo with hi = tf32(b) and
// lo = tf32(b - hi) (round to nearest, ties away, in registers): x.hi + x.lo
// carries each product to ~2^-22 (one TF32 pass is ~1e3 times coarser).
// The tensor cores' f32 sums truncate instead of rounding, so a running DFT
// sum kept in the mma accumulator over 50 k-steps drifts (the worst quiet
// bin at 128 mels came out 4x farther from an f64 result than the plain f32
// version): each k-step's two passes go into a zeroed accumulator and the
// running sum takes them with a round-to-nearest add.  The power is f32 mul
// / mul / add as the plain version forms it; the filterbank sums each mel's
// run of nonzero bins (first to last, host-computed) in bin order with f32
// mul then add, which equals a dense sum in bin order.
//
// Design: the DFT is D^T = basis^T (416 x 400) x frames^T (400 x 8n) on
// mma.sync m16n8k8 TF32.  An A tile (m16) is 8 bins: rows 0-7 hann.cos,
// rows 8-15 -hann.sin of the same bins, so a thread's accumulator holds
// (re, im) of one bin for two frames and forms the power in registers.  The
// host stores the basis in fragment order (ops/mel_kernel.py::frag_basis:
// k-step, 8-bin tile, lane, 4 floats), so a warp's A fragments for one
// k-step and bin tile are 512 contiguous bytes.  A B tile (n8) is 8 frames;
// frame f, sample n is row f + n / 160, column n % 160 of the audio span
// stored in rows of 160 samples at a stride of 164 floats (160 would put
// the 8 frames of a fragment in one bank).  No frame matrix is built.
//
// Reuse of the basis: every frame needs all of it (666 KB), so a CTA takes
// one contiguous range of 8-frame tiles of a clip -- the wrapper gives each
// clip sm_count / B CTAs, so the 1125 tiles of a 90 s bucket spread as 8-9
// a CTA over one wave -- and streams the basis through once per chunk of at
// most kNT tiles.  8 warps, two a sub-partition (so up to 255 registers a
// thread), own 4, 4, 3, 3, 3, 3, 3, 3 of the 26 bin tiles (208 bins, 201
// used): each sub-partition holds 6 or 7.  A warp streams its own basis
// (n_bt x 512 bytes a k-step) from L2 into a private 4-stage cp.async ring
// (no CTA barrier in the k loop).  The chunk's DFT is a template on its
// frame tiles and the warp's bin tiles, so no branch splits a k-step's mma:
// at a branch the compiler drains the tensor-core pipeline.  The audio
// arrives by cp.async as f16 and is widened in shared memory; after the
// DFT the power tile (208 bins x the chunk's frames) goes to shared
// memory, and the filterbank reads the runs and their weights staged
// there, four frames a thread, stores coalesced along frames.
#include "common.cuh"

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFFT / 2 + 1;  // 201
constexpr int kKSteps = kNFFT / 8;    // 50 mma k-steps
constexpr int kBinTiles = 26;         // 8-bin A tiles: 208 >= 201 bins
constexpr int kWarps = 8;             // 2 a sub-partition: <= 255 registers
constexpr int kMT = 4;                // bin tiles a warp, at most
constexpr int kThreads = kWarps * 32;  // 256
constexpr int kNT = 9;                // 8-frame tiles a chunk, at most
constexpr int kNG = 5;                // frame tiles a group of mma chains
constexpr int kRows = 8 * kNT + 2;    // audio rows of 160 a chunk
constexpr int kXStride = 164;         // floats; 164 = 4 mod 32 banks
constexpr int kPStride = 88;          // = 24 mod 32: conflict-free float2
constexpr int kStages = 4;            // basis ring depth (k-steps)
constexpr int kRingWarp = kMT * 32 * 4;  // floats of one warp's k-step
static_assert(kPStride >= 8 * kNT, "power rows hold a chunk's frames");
constexpr int kTabWords = 4096;       // mel runs + weights, when they fit

constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kRows * kXStride +
                     (size_t)kStages * kWarps * kRingWarp +
                     (size_t)8 * kBinTiles * kPStride + kTabWords);

// Round to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32 for
// a finite x far from overflow (the basis lies in [-1, 1]) in two integer
// operations; sm_90 runs the cvt itself as five (an inf test and a select).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// c += a b: A 16 x 8 (row), B 8 x 8 (col) TF32 fragments, f32 c.  Volatile,
// so the mma keep the order written (groups of independent chains).
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a b (a zeroed accumulator)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// The ring is thread-private (each thread reads back only the 16-byte
// pieces it copied), so the memory clobbers, which keep the compiler from
// moving shared-memory reads across the copies and waits, are all the
// ordering it needs.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// src_bytes < 16: the rest of the 16 bytes is zero-filled (0: nothing read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One chunk's DFT for one warp: bin tiles [bt0, bt0 + MT) x the chunk's NV
// frame tiles, 50 k-steps of split-TF32 mma, then the power into s_pow.
// The A fragments of k-step ks + 1 are read from the ring before the mma
// of ks; a k-step's B fragments are loaded first; the mma go in groups of
// kNG chains (every hi, then every lo, then the adds).
template <int NV, int MT, class Issue>
__device__ __forceinline__ void dft_chunk(Issue& issue, const float* ring,
                                          const float* s_x, float* s_pow,
                                          int bt0, int g, int t) {
  float acc[MT][NV][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  cp_async_wait<kStages - 2>();
  float4 an[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    an[m] = *reinterpret_cast<const float4*>(ring + 128 * m);
  for (int ks = 0; ks < kKSteps; ++ks) {
    issue(ks + kStages - 1);
    cp_async_wait<kStages - 2>();  // k-step ks + 1 has landed
    const float* nx = ring + ((ks + 1) % kStages) * kWarps * kRingWarp;
    float4 an_next[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      an_next[m] = *reinterpret_cast<const float4*>(nx + 128 * m);
    // B fragment: frame 8 n + g, samples 8 ks + t (+ 4)
    const float* xr = s_x + (ks / 20 + g) * kXStride + (ks % 20) * 8 + t;
    uint32_t bf[NV][2];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      bf[n][0] = __float_as_uint(xr[8 * n * kXStride]);
      bf[n][1] = __float_as_uint(xr[8 * n * kXStride + 4]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float a[4] = {an[m].x, an[m].y, an[m].z, an[m].w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32_rna(a[e]);
        lo[e] = tf32_rna(a[e] - __uint_as_float(hi[e]));
      }
#pragma unroll
      for (int n0 = 0; n0 < NV; n0 += kNG) {
        constexpr int kG = NV < kNG ? NV : kNG;
        float d[kG][4];
#pragma unroll
        for (int j = 0; j < kG; ++j)
          if (n0 + j < NV)
            mma_tf32_zero(d[j], hi, bf[n0 + j][0], bf[n0 + j][1]);
#pragma unroll
        for (int j = 0; j < kG; ++j)
          if (n0 + j < NV) mma_tf32(d[j], lo, bf[n0 + j][0], bf[n0 + j][1]);
#pragma unroll
        for (int j = 0; j < kG; ++j)
          if (n0 + j < NV)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][n0 + j][e] = __fadd_rn(acc[m][n0 + j][e], d[j][e]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) an[m] = an_next[m];
  }
  cp_async_wait<0>();

  // power of bin 8 (bt0 + m) + g at frames 8 n + 2 t + {0, 1}
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float* pw = s_pow + (8 * (bt0 + m) + g) * kPStride + 2 * t;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const float* c = acc[m][n];
      *reinterpret_cast<float2*>(pw + 8 * n) = make_float2(
          __fadd_rn(__fmul_rn(c[0], c[0]), __fmul_rn(c[2], c[2])),
          __fadd_rn(__fmul_rn(c[1], c[1]), __fmul_rn(c[3], c[3])));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mel_tc_kernel(const __half* __restrict__ audio,
                  const float* __restrict__ fbasis,  // (50, 26, 32, 4)
                  const int* __restrict__ runs,      // (n_mels, 3)
                  const float* __restrict__ wts,     // (n_w,)
                  float* __restrict__ out,           // (B, n_mels, F)
                  int L, int F, int n_mels, int n_w) {
  extern __shared__ float4 sm4[];
  float* s_x = reinterpret_cast<float*>(sm4);         // kRows x kXStride
  float* s_ring = s_x + kRows * kXStride;             // kStages x 8 x 512
  float* s_pow = s_ring + kStages * kWarps * kRingWarp;  // 208 x kPStride
  int* s_tab = reinterpret_cast<int*>(s_pow + 8 * kBinTiles * kPStride);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const __half* xb = audio + (size_t)b * L;
  const bool aligned = (reinterpret_cast<size_t>(xb) & 15) == 0;

  // this CTA's 8-frame tiles [t0, t1), in chunks of at most kNT
  const int n_tiles = (F + 7) / 8;
  const int t0 = (int)((long)blockIdx.x * n_tiles / gridDim.x);
  const int t1 = (int)((long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  const int n_chunks = (t1 - t0 + kNT - 1) / kNT;

  // warp w owns bin tiles [bt0, bt0 + n_bt): 4, 4, 3, 3, 3, 3, 3, 3, so
  // each sub-partition (warps w and w + 4) holds 6 or 7 of the 26
  const int n_bt = warp < 2 ? 4 : 3;
  const int bt0 = warp < 2 ? 4 * warp : 8 + 3 * (warp - 2);
  // this thread's 16-byte pieces of the basis, n_bt a k-step
  const float* fb = fbasis + ((size_t)bt0 * 32 + lane) * 4;
  float* ring = s_ring + warp * kRingWarp + lane * 4;
  auto issue = [&](int ks) {
    if (ks < kKSteps) {
      const float* src = fb + (size_t)ks * kBinTiles * 128;
      float* dst = ring + (ks % kStages) * kWarps * kRingWarp;
      for (int m = 0; m < n_bt; ++m)
        cp_async16(dst + 128 * m, src + 128 * m);
    }
    cp_async_commit();
  };

  // the mel runs (first bin, last bin, offset of the first weight) and
  // their weights, staged once when they fit (a Slaney filterbank: 3
  // n_mels + ~400 words); read from global memory otherwise
  const bool staged = 3 * n_mels + n_w <= kTabWords;
  if (staged) {
    for (int i = tid; i < 3 * n_mels; i += kThreads)
      s_tab[i] = __ldg(runs + i);
    for (int i = tid; i < n_w; i += kThreads)
      s_tab[3 * n_mels + i] = __float_as_int(__ldg(wts + i));
  }
  const int* rt = staged ? s_tab : runs;
  const float* wt =
      staged ? reinterpret_cast<const float*>(s_tab + 3 * n_mels) : wts;

  for (int j = 0; j < n_chunks; ++j) {
    const int ca = t0 + (int)((long)j * (t1 - t0) / n_chunks);
    const int nv = t0 + (int)((long)(j + 1) * (t1 - t0) / n_chunks) - ca;
    const int fa = 8 * ca;
    // the chunk's audio: rows r of samples (fa + r) 160 + [0, 160).  From a
    // 16-byte aligned clip, pieces of 8 f16 samples go by cp.async into
    // s_pow (unused until the power is formed) as one group ahead of the
    // basis ring's, all in flight at once, then are widened into s_x.
    const long base = (long)fa * kHop;
    const int n_rows = 8 * nv + 2;
    if (j > 0) __syncthreads();  // the last chunk's filterbank read s_pow
    __half* s_h = reinterpret_cast<__half*>(s_pow);
    if (aligned) {
      for (int i = tid; i < n_rows * (kHop / 8); i += kThreads) {
        const long s = base + 8L * i;
        const int bytes = s >= L ? 0 : (s + 8 <= L ? 16 : (int)(L - s) * 2);
        cp_async16_zfill(s_h + 8 * i, bytes ? xb + s : xb, bytes);
      }
      cp_async_commit();
    }
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    if (aligned) {
      cp_async_wait<kStages - 1>();  // the audio group
      __syncthreads();
      for (int i = tid; i < n_rows * (kHop / 2); i += kThreads) {
        const int r = i / (kHop / 2), c = 2 * (i % (kHop / 2));
        *reinterpret_cast<float2*>(s_x + r * kXStride + c) = __half22float2(
            *reinterpret_cast<const __half2*>(s_h + r * kHop + c));
      }
    } else {
      for (int i = tid; i < n_rows * kHop; i += kThreads) {
        const int r = i / kHop, c = i % kHop;
        const long s = base + (long)r * kHop + c;
        s_x[r * kXStride + c] = s < L ? __half2float(xb[s]) : 0.f;
      }
    }
    __syncthreads();

    // DFT and power: NV (the chunk's frame tiles) and MT (the warp's bin
    // tiles) as template arguments, so no branch splits a k-step's mma
    switch (nv) {
#define GWT_MEL_CASE(NV)                                              \
  case NV:                                                            \
    if (n_bt == 4)                                                    \
      dft_chunk<NV, 4>(issue, ring, s_x, s_pow, bt0, g, t);           \
    else                                                              \
      dft_chunk<NV, 3>(issue, ring, s_x, s_pow, bt0, g, t);           \
    break;
      GWT_MEL_CASE(1) GWT_MEL_CASE(2) GWT_MEL_CASE(3) GWT_MEL_CASE(4)
      GWT_MEL_CASE(5) GWT_MEL_CASE(6) GWT_MEL_CASE(7) GWT_MEL_CASE(8)
      GWT_MEL_CASE(9)
#undef GWT_MEL_CASE
    }
    __syncthreads();

    // filterbank: a thread sums one mel's run for frames fg + {0, 1, 2, 3}
    // G (four sums in flight, one weight load a bin), stores coalesced
    // along frames
    const int nf = min(8 * nv, F - fa);
    const int G = (nf + 3) / 4;
    for (int q = tid; q < n_mels * G; q += kThreads) {
      const int m = q / G, fg = q - m * G;
      const int k0 = rt[3 * m], k1 = rt[3 * m + 1], off = rt[3 * m + 2];
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = k0; k <= k1; ++k) {
        const float w = wt[off + k - k0];
        const float* pk = s_pow + k * kPStride + fg;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sum[i] = __fadd_rn(sum[i], __fmul_rn(pk[i * G], w));
      }
      float* o = out + ((size_t)b * n_mels + m) * F + fa + fg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (fg + i * G < nf) o[i * G] = log10f(fmaxf(sum[i], 1e-10f));
    }
    // the next chunk stages its audio into s_pow after its first barrier
  }
}

// K1's input from a batch's real samples: gwt_mel_pad.  It replaces no TPU
// kernel: the JAX package pads each clip on the host (audio/mel.py's
// pad_audio), buckets the batch and ships the float16 stack.  Here the
// host ships only the clips' float32 samples, back to back, with each
// clip's offset and length, and this kernel writes the (B, bucket) float16
// stack K1 reads: for clip b with n samples x and padded position p,
// x[m - p] for p < m, m = min(n - 1, 200) (the reflection, whose short-clip
// form leaves zeros after the reversed samples), x[p - 200] for
// 200 <= p < 200 + n, else 0; each value rounded by __float2half_rn, to
// nearest even as numpy's astype(np.float16), subnormals included.
//
// Bound on an H100: bytes.  Each real sample is read about once (the head
// reads 200 again) and the stack written once: a batch of 32 clips of 30 s
// reads 61.4 MB and writes 92.2 MB, ~46 us at 3.35 TB/s.  A thread writes
// 8 halves as one 16-byte store (a row is a multiple of 8 halves, so every
// store is aligned); its 8 reads are consecutive floats of one clip at any
// offset, which the warp's neighbours share in L1.  Positions past the
// clip's samples read nothing.
constexpr int kPad = kNFFT / 2;  // 200
constexpr int kPadThreads = 256;

__device__ __forceinline__ uint32_t half_bits(float v) {
  return (uint32_t)__half_as_ushort(__float2half_rn(v));
}

__global__ void __launch_bounds__(kPadThreads)
    mel_pad_kernel(const float* __restrict__ x,
                   const long long* __restrict__ offsets,  // (B,)
                   const long long* __restrict__ lengths,  // (B,)
                   __half* __restrict__ out,               // (B, bucket)
                   int bucket) {
  const int b = blockIdx.y;
  const long long p0 =
      8LL * ((long long)blockIdx.x * kPadThreads + threadIdx.x);
  if (p0 >= bucket) return;
  const long long n = lengths[b];
  const float* xb = x + offsets[b];
  const long long m = n <= kPad ? n - 1 : kPad;  // -1 for an empty clip
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long p = p0 + 2 * j + e;
      float s = 0.f;
      if (p < kPad) {
        if (p < m) s = __ldg(xb + (m - p));
      } else if (p - kPad < n) {
        s = __ldg(xb + (p - kPad));
      }
      v[e] = s;
    }
    w[j] = half_bits(v[0]) | (half_bits(v[1]) << 16);
  }
  *reinterpret_cast<uint4*>(out + (size_t)b * bucket + p0) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

constexpr int kMaxDevices = 64;

extern "C" int gwt_mel_smem() { return (int)kSmemBytes; }

// audio (B, L) f16; fbasis (50, 26, 32, 4) f32 fragment-ordered basis;
// runs (n_mels, 3) int32 first / last nonzero bin (first > last: an empty
// row) and the offset of its first weight in wts (n_w,) f32; out (B,
// n_mels, F) f32.  ctas: CTAs a clip (the grid is (ctas, B)).
extern "C" int gwt_mel(const void* audio, const void* fbasis, const void* runs,
                       const void* wts, void* out, int B, int L, int F,
                       int n_mels, int n_w, int ctas, void* stream) {
  // The shared-memory attribute, once per device (function attributes
  // belong to the device's context).
  static bool attr_set[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    const cudaError_t attr = cudaFuncSetAttribute(
        mel_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const dim3 grid(ctas, B);
  mel_tc_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const __half*)audio, (const float*)fbasis, (const int*)runs,
      (const float*)wts, (float*)out, L, F, n_mels, n_w);
  return (int)cudaGetLastError();
}

// x: the clips' f32 samples back to back; offsets, lengths (B,) int64:
// clip b is x[offsets[b], offsets[b] + lengths[b]); out (B, bucket) f16,
// bucket a multiple of 8.
extern "C" int gwt_mel_pad(const void* x, const void* offsets,
                           const void* lengths, void* out, int B, int bucket,
                           void* stream) {
  const int per_row = bucket / 8;
  const dim3 grid((per_row + kPadThreads - 1) / kPadThreads, B);
  mel_pad_kernel<<<grid, kPadThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const long long*)offsets, (const long long*)lengths,
      (__half*)out, bucket);
  return (int)cudaGetLastError();
}
