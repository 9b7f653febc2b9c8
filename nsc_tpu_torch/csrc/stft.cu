// Framed STFT magnitude for the spectral losses, for Hopper (sm_90a).
//
// Replaces nsc_tpu/ops/pallas/stft.py::stft_magnitude_pallas (_stft_kernel).
// For each row b, frame f and bin k of a signal that the wrapper has already
// reflect-padded by n_fft/2 on both sides:
//   re = sum_n (x[b, f*hop + n] * win[n]) * cos[n, k]
//   im = sum_n (x[b, f*hop + n] * win[n]) * sin[n, k]
//   out[b, f, k] = sqrt(re*re + im*im + 1e-8)
// with the periodic Hann window and the float32 DFT basis the wrapper passes
// in (built in float64 and cast, as the JAX package builds them).
//
// What bounds it on the H100: 4*F*n_fft*(n_fft/2+1) float32 FLOP per row
// against a few MB of traffic (the signal, the basis, the magnitudes), so it
// is bound by the FP32 pipe. No TF32 and no tensor cores: the contract is
// float32.
//
// Design. The point of the TPU kernel is that the frame tensor, n_fft/hop
// times the signal, never reaches device memory; this kernel keeps that
// property. One block owns one (row, tile of 32 frames, tile of 128 bins).
// It stages in shared memory the signal segment its frames cover,
// (32-1)*hop + n_fft floats (72 KB at n_fft 2048), and the window; then it
// walks n in chunks of 32, staging each chunk of the cos and sin basis for
// its bins. The 256 threads are 32 bin groups (threadIdx.x, 4 consecutive
// bins each) by 8 frame groups (threadIdx.y, 4 frames each): the 32 threads
// of a warp share their frames, so the segment reads are broadcasts, and
// read 128 consecutive basis values as float4s, so the basis reads are
// conflict free. Each thread keeps 4 frames x 4 bins x (re, im) float32
// sums. Windowing happens in the inner loop, on the staged raw segment (the
// frames overlap, so the segment cannot be windowed once): x*win is rounded
// once, as in the plain version, and only the order of the n-sum differs
// from it. The basis comes padded with zeros to a multiple of 128 bins, so
// the staging loads need no bounds; the epilogue writes only valid frames
// and bins.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBinGroups = 32;    // threadIdx.x
constexpr int kFrameGroups = 8;   // threadIdx.y
constexpr int kBinsPerThread = 4;
constexpr int kFramesPerThread = 4;
constexpr int kTileK = kBinGroups * kBinsPerThread;        // 128 bins
constexpr int kTileF = kFrameGroups * kFramesPerThread;    // 32 frames
constexpr int kChunkN = 32;                                // basis rows per stage
constexpr int kThreads = kBinGroups * kFrameGroups;        // 256
constexpr float kEps = 1e-8f;

__global__ void __launch_bounds__(kThreads) stft_magnitude_kernel(
    const float* __restrict__ xpad, const float* __restrict__ win,
    const float* __restrict__ cosb, const float* __restrict__ sinb,
    float* __restrict__ out, int Tp, int n_fft, int hop, int F, int K, int Kp) {
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;                      // [kChunkN][kTileK]
  float* ss = cs + kChunkN * kTileK;   // [kChunkN][kTileK]
  float* ws = ss + kChunkN * kTileK;   // [n_fft]
  float* seg = ws + n_fft;             // [(kTileF-1)*hop + n_fft]

  const int b = blockIdx.z;
  const int f0 = blockIdx.x * kTileF;
  const int k0 = blockIdx.y * kTileK;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBinGroups + tx;

  const int seg_len = (kTileF - 1) * hop + n_fft;
  const float* row = xpad + static_cast<size_t>(b) * Tp;
  const size_t start = static_cast<size_t>(f0) * hop;
  for (int i = tid; i < seg_len; i += kThreads) {
    const size_t p = start + i;
    seg[i] = p < static_cast<size_t>(Tp) ? row[p] : 0.f;
  }
  for (int i = tid; i < n_fft; i += kThreads) ws[i] = win[i];

  float re[kFramesPerThread][kBinsPerThread] = {};
  float im[kFramesPerThread][kBinsPerThread] = {};
  const float* my_seg = seg + ty * kFramesPerThread * hop;

  for (int n0 = 0; n0 < n_fft; n0 += kChunkN) {
    __syncthreads();  // segment staged / readers of the previous chunk done
    for (int i = tid; i < kChunkN * kTileK / 4; i += kThreads) {
      const int r = i / (kTileK / 4), c4 = i - r * (kTileK / 4);
      const int n = n0 + r;
      float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), sv = cv;
      if (n < n_fft) {
        const size_t off = static_cast<size_t>(n) * Kp + k0 + c4 * 4;
        cv = *reinterpret_cast<const float4*>(cosb + off);
        sv = *reinterpret_cast<const float4*>(sinb + off);
      }
      reinterpret_cast<float4*>(cs)[i] = cv;
      reinterpret_cast<float4*>(ss)[i] = sv;
    }
    __syncthreads();
    const int nc = min(kChunkN, n_fft - n0);
    for (int j = 0; j < nc; ++j) {
      const int n = n0 + j;
      const float w = ws[n];
      float xv[kFramesPerThread];
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) xv[i] = __fmul_rn(my_seg[i * hop + n], w);
      const float4 c = reinterpret_cast<const float4*>(cs + j * kTileK)[tx];
      const float4 s = reinterpret_cast<const float4*>(ss + j * kTileK)[tx];
      const float c4[kBinsPerThread] = {c.x, c.y, c.z, c.w};
      const float s4[kBinsPerThread] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i)
#pragma unroll
        for (int q = 0; q < kBinsPerThread; ++q) {
          re[i][q] = fmaf(xv[i], c4[q], re[i][q]);
          im[i][q] = fmaf(xv[i], s4[q], im[i][q]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    const int f = f0 + ty * kFramesPerThread + i;
    if (f >= F) continue;
    float* orow = out + (static_cast<size_t>(b) * F + f) * K;
#pragma unroll
    for (int q = 0; q < kBinsPerThread; ++q) {
      const int k = k0 + tx * kBinsPerThread + q;
      if (k < K) {
        const float p = __fadd_rn(__fmul_rn(re[i][q], re[i][q]), __fmul_rn(im[i][q], im[i][q]));
        orow[k] = sqrtf(__fadd_rn(p, kEps));
      }
    }
  }
}

}  // namespace

// xpad (B, Tp), win (n_fft), cosb/sinb (n_fft, Kp), out (B, F, K): float32.
// Kp is K rounded up to a multiple of 128, the basis columns past K are 0.
// Returns the launch's cudaError_t.
extern "C" int nsc_stft_magnitude(const void* xpad, const void* win, const void* cosb,
                                  const void* sinb, void* out, int B, int Tp, int n_fft,
                                  int hop, int F, int K, int Kp, void* stream) {
  if (B < 1 || F < 1 || K < 1 || n_fft < 1 || hop < 1 || Kp < K || Kp % kTileK != 0 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (2 * static_cast<size_t>(kChunkN) * kTileK + n_fft + static_cast<size_t>(kTileF - 1) * hop +
       n_fft) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_magnitude_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kTileF - 1) / kTileF, Kp / kTileK, B);
  const dim3 block(kBinGroups, kFrameGroups);
  stft_magnitude_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xpad), static_cast<const float*>(win),
      static_cast<const float*>(cosb), static_cast<const float*>(sinb),
      static_cast<float*>(out), Tp, n_fft, hop, F, K, Kp);
  return static_cast<int>(cudaGetLastError());
}
