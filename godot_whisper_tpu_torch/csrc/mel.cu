// K1: log-mel spectrogram, raw log10 (before the clip-global max-8 clamp).
//
// Replaces the TPU kernel `_mel_kernel` (godot_whisper_tpu/ops/mel_kernel.py,
// reached through `_log_mel_pallas`).  Same function: frames of 400 samples
// at hop 160 from f16 audio upcast to f32, a DFT against the periodic-Hann
// windowed cos | -sin basis, power re^2 + im^2 over the 201 bins, the mel
// filterbank product, log10(max(x, 1e-10)).  Everything is f32 FMA: bf16 or
// TF32 inputs are too coarse for 16-bit PCM.
//
// Bound on an H100: about 354 kFLOP per frame (400 x 201 x 2 FMAs for the
// DFT, 201 x n_mels for the filterbank), 1.06 GFLOP per 30 s window of
// 3000 frames, so ~16 us at the 67 TFLOP/s f32 rate; the bytes (2 B of audio
// in and 4 n_mels B out per 160 samples) are far below that.
//
// Design: one block per tile of TF frames of one clip.  The tile's audio
// span (TF*160 + 240 samples) and the n_mels x 201 filterbank sit in shared
// memory.  Thread k owns DFT bin k for all TF frames of the tile, so each
// basis column is read once per tile (coalesced across bins, from L2) and
// reused TF times from registers; the audio sample is a shared-memory
// broadcast.  The power spectrum goes to shared memory and the filterbank
// product runs one (mel, frame) pair per thread.  Later work can move the
// DFT onto the tensor cores with 3xTF32 splitting; this version is right
// first.
#include "common.cuh"

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFFT / 2 + 1;  // 201
constexpr int kTF = 32;               // frames per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    mel_kernel(const __half* __restrict__ audio,
               const float* __restrict__ basis,  // (400, 2*201): cos | -sin
               const float* __restrict__ filt,   // (n_mels, 201)
               float* __restrict__ out,          // (B, n_mels, F)
               int L, int F, int n_mels) {
  extern __shared__ float sm[];
  float* s_filt = sm;                       // n_mels * 201
  float* s_pow = s_filt + n_mels * kBins;   // kTF * 201
  float* s_x = s_pow + kTF * kBins;         // kTF * 160 + 240
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTF;
  const __half* x = audio + (size_t)b * L;
  const int span = kTF * kHop + (kNFFT - kHop);

  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long idx = (long)f0 * kHop + i;
    s_x[i] = idx < L ? __half2float(x[idx]) : 0.f;
  }
  for (int i = threadIdx.x; i < n_mels * kBins; i += kThreads)
    s_filt[i] = filt[i];
  __syncthreads();

  for (int k = threadIdx.x; k < kBins; k += kThreads) {
    float re[kTF], im[kTF];
#pragma unroll
    for (int f = 0; f < kTF; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < kNFFT; ++n) {
      const float c = basis[n * 2 * kBins + k];
      const float s = basis[n * 2 * kBins + kBins + k];
#pragma unroll
      for (int f = 0; f < kTF; ++f) {
        const float xv = s_x[f * kHop + n];
        re[f] = fmaf(xv, c, re[f]);
        im[f] = fmaf(xv, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTF; ++f)
      s_pow[f * kBins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int p = threadIdx.x; p < kTF * n_mels; p += kThreads) {
    const int m = p / kTF, f = p % kTF;
    if (f0 + f >= F) continue;
    const float* pw = s_pow + f * kBins;
    const float* fl = s_filt + m * kBins;
    float acc = 0.f;
    for (int k = 0; k < kBins; ++k) acc = fmaf(pw[k], fl[k], acc);
    out[((size_t)b * n_mels + m) * F + f0 + f] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" int gwt_mel(const void* audio, const void* basis, const void* filt,
                       void* out, int B, int L, int F, int n_mels,
                       void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)n_mels * kBins + kTF * kBins +
                       kTF * kHop + (kNFFT - kHop));
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + kTF - 1) / kTF, B);
  mel_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __half*)audio, (const float*)basis, (const float*)filt,
      (float*)out, L, F, n_mels);
  return (int)cudaGetLastError();
}
