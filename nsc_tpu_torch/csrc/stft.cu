// Framed STFT magnitude for the spectral losses, for Hopper (sm_90a).
//
// Replaces nsc_tpu/ops/pallas/stft.py::stft_magnitude_pallas (_stft_kernel).
// For each row b, frame f and bin k of a signal reflect-padded by n_fft/2
// on both sides:
//   X[b, f, k] = sum_n (x[b, f*hop + n] * win[n]) * exp(-2 pi i n k / n_fft)
//   out[b, f, k] = sqrt(re*re + im*im + 1e-8)
// with the periodic Hann window (built in float64 and cast, as the JAX
// package builds it). The point of the TPU kernel is that the frame tensor,
// n_fft/hop times the signal, never reaches device memory; both kernels
// here keep that property. The wrapper (kernels/stft.py::route) picks one by
// n_fft alone.
//
// stft_magnitude_kernel, the real FFT, for powers of two 16-4096 (every
// n_fft of the shipped losses), computed in float64 and rounded once to
// float32: each output is the magnitude of the true float64 spectrum of
// the float32 input, correctly rounded. The spectral losses' gradients need
// that: the log-magnitude term is an L1 whose gradient changes sign where
// reconstruction and target magnitudes nearly tie, so any rounding of
// ~1e-7 of a frame's peak flips the sign at some low bins, and a float32
// forward (a DFT or an FFT) is as far from the float64 gradient as the
// draw of those flips makes it. What bounds it on the H100: ~2.5 n log2 n
// float64 FLOP per frame and 4 bytes per output bin (~8 MB per training
// launch), near each other at the card's float64 and memory rates.
// Design: one block owns one (row, tile of FT frames); it stages the raw
// segment its frames cover once, reading the reflect-padded index in the
// kernel (no padded copy), windows each frame with the float64 periodic
// Hann window and packs it into an n/2-point complex sequence (even
// samples real, odd imaginary). Stockham radix-4 passes (a radix-2 pass
// last where log2(n/2) is odd) run on all FT frames at once, ping-ponging
// between two shared buffers, so there is no bit reversal; twiddles come
// from a float64 table of exp(-2 pi i j / n), the float64 values the DFT
// basis is cast from. The post-twiddle X[k] = Ze[k] + W^k Zo[k] splits the
// complex spectrum into the real one; the magnitudes (and, for the
// backward, re and im) are written coalesced by bin.
//
// stft_magnitude_dft_kernel, for every other n_fft >= 2: the O(n^2) DFT
// against the float32 basis the wrapper passes in, on a signal the wrapper
// has reflect-padded. Its sums are the plain matmul-DFT path's in another
// order. One block owns one (row, tile of 32 frames, tile of 128 bins). It
// stages in shared memory the signal segment its frames cover and the
// window; then it walks n in chunks of 32, staging each chunk of the cos and
// sin basis for its bins. The 256 threads are 32 bin groups (threadIdx.x, 4
// consecutive bins each) by 8 frame groups (threadIdx.y, 4 frames each):
// the 32 threads of a warp share their frames, so the segment reads are
// broadcasts, and read 128 consecutive basis values as float4s, so the
// basis reads are conflict free. Each thread keeps 4 frames x 4 bins x
// (re, im) float32 sums. The basis comes padded with zeros to a multiple of
// 128 bins, so the staging loads need no bounds; the epilogue writes only
// valid frames and bins.

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

__global__ void __launch_bounds__(kThreads) stft_magnitude_dft_kernel(
    const float* __restrict__ xpad, const float* __restrict__ win,
    const float* __restrict__ cosb, const float* __restrict__ sinb, float* __restrict__ out,
    float* __restrict__ re_out, float* __restrict__ im_out, int Tp, int n_fft, int hop, int F,
    int K, int Kp) {
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
        if (re_out != nullptr) {
          const size_t o = (static_cast<size_t>(b) * F + f) * K + k;
          re_out[o] = re[i][q];
          im_out[o] = im[i][q];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The real FFT, in float64.

constexpr int kFftMin = 16, kFftMax = 4096;
constexpr int kFramePoints = 4096;   // real samples of the frames a block holds
constexpr int kSmemTarget = 81920;   // fewer frames per block while above

// Frames per block and shared-memory bytes: two buffers of n/2 complex
// float64 points per frame and the raw float32 segment (exported as
// nsc_stft_fft_plan). At one frame a block holds 20 * n bytes, at most 80 KB.
__host__ __device__ inline int fft_smem(int n, int hop, int ft) {
  return 16 * ft * n + 4 * ((ft - 1) * hop + n);
}
inline int fft_frames(int n, int hop) {
  int ft = kFramePoints / n > 1 ? kFramePoints / n : 1;
  while (ft > 1 && fft_smem(n, hop, ft) > kSmemTarget) ft /= 2;
  return ft;
}

__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return make_double2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// One Stockham pass of radix R over nfr frames of n2 complex points each,
// src -> dst: butterfly i of a frame reads u_m = src[i + m n2/R], twiddles
// u_m by W^(m k n/(R p)) (k = i mod p, W = exp(-2 pi i / n), tw[j] = W^j),
// takes their R-point DFT y_t and writes dst[(i - k) R + k + t p].
template <int R>
__device__ __forceinline__ void fft_pass(const double2* __restrict__ src,
                                         double2* __restrict__ dst,
                                         const double2* __restrict__ tw, int nfr, int n2, int n,
                                         int p) {
  const int q = n2 / R;
  const int step = n / (R * p);
  for (int g = threadIdx.x; g < nfr * q; g += kThreads) {
    const int f = g / q, i = g - f * q, k = i & (p - 1);
    const double2* s = src + f * n2;
    double2* d = dst + f * n2 + (i - k) * R + k;
    double2 u[R];
#pragma unroll
    for (int m = 0; m < R; ++m) u[m] = s[i + m * q];
    if (p > 1) {
#pragma unroll
      for (int m = 1; m < R; ++m) u[m] = cmul(u[m], __ldg(tw + m * k * step));
    }
    if constexpr (R == 4) {
      const double2 a0 = make_double2(u[0].x + u[2].x, u[0].y + u[2].y);
      const double2 a1 = make_double2(u[0].x - u[2].x, u[0].y - u[2].y);
      const double2 a2 = make_double2(u[1].x + u[3].x, u[1].y + u[3].y);
      const double2 a3 = make_double2(u[1].x - u[3].x, u[1].y - u[3].y);
      d[0] = make_double2(a0.x + a2.x, a0.y + a2.y);
      d[p] = make_double2(a1.x + a3.y, a1.y - a3.x);       // a1 - i a3
      d[2 * p] = make_double2(a0.x - a2.x, a0.y - a2.y);
      d[3 * p] = make_double2(a1.x - a3.y, a1.y + a3.x);   // a1 + i a3
    } else {
      d[0] = make_double2(u[0].x + u[1].x, u[0].y + u[1].y);
      d[p] = make_double2(u[0].x - u[1].x, u[0].y - u[1].y);
    }
  }
}

// x (B, T) float32 unpadded; win (n) and tw (n complex) float64; out (B,
// F, n/2 + 1) float32, re and im likewise or null.
__global__ void __launch_bounds__(kThreads) stft_magnitude_kernel(
    const float* __restrict__ x, const double* __restrict__ win,
    const double2* __restrict__ tw, float* __restrict__ out, float* __restrict__ re_out,
    float* __restrict__ im_out, int T, int n, int hop, int F, int ft) {
  extern __shared__ __align__(16) double2 smd[];
  const int n2 = n / 2, K = n2 + 1;
  double2* buf0 = smd;              // [ft][n2]
  double2* buf1 = buf0 + ft * n2;   // [ft][n2]
  float* seg = reinterpret_cast<float*>(buf1 + ft * n2);  // [(ft-1)*hop + n]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * ft;
  const int tid = threadIdx.x;
  const int pad = n2;
  const long long Tp = static_cast<long long>(T) + 2 * pad;
  const float* row = x + static_cast<size_t>(b) * T;

  // the raw segment of padded positions f0*hop .. f0*hop + seg_len, read
  // through the reflection; positions past the padded signal (frames past
  // F in the last tile) read 0
  const int seg_len = (ft - 1) * hop + n;
  const long long start = static_cast<long long>(f0) * hop;
  for (int i = tid; i < seg_len; i += kThreads) {
    const long long P = start + i;
    float v = 0.f;
    if (P < Tp) {
      long long j = P - pad;
      if (j < 0) j = -j;
      if (j >= T) j = 2 * (static_cast<long long>(T) - 1) - j;
      v = row[j];
    }
    seg[i] = v;
  }
  __syncthreads();

  // window and pack: z[m] = (x[2m] w[2m], x[2m+1] w[2m+1])
  for (int g = tid; g < ft * n2; g += kThreads) {
    const int f = g / n2, m = g - f * n2;
    const float* fr = seg + f * hop + 2 * m;
    buf0[g] = make_double2(static_cast<double>(fr[0]) * __ldg(win + 2 * m),
                           static_cast<double>(fr[1]) * __ldg(win + 2 * m + 1));
  }
  __syncthreads();

  double2* src = buf0;
  double2* dst = buf1;
  int p = 1;
  for (; 4 * p <= n2; p *= 4) {
    fft_pass<4>(src, dst, tw, ft, n2, n, p);
    __syncthreads();
    double2* t = src;
    src = dst;
    dst = t;
  }
  if (p < n2) {
    fft_pass<2>(src, dst, tw, ft, n2, n, p);
    __syncthreads();
    src = dst;
  }

  // X[k] = Ze[k] + W^k Zo[k]: Ze = (Z[k] + conj Z[n2-k]) / 2,
  // Zo = (Z[k] - conj Z[n2-k]) / (2i); then the magnitude, rounded once
  for (int g = tid; g < ft * K; g += kThreads) {
    const int f = g / K, k = g - f * K;
    if (f0 + f >= F) continue;
    const double2 a = src[f * n2 + (k == n2 ? 0 : k)];
    const double2 c = src[f * n2 + (k == 0 ? 0 : n2 - k)];  // conj: (c.x, -c.y)
    const double er = 0.5 * (a.x + c.x), ei = 0.5 * (a.y - c.y);
    const double orr = 0.5 * (a.y + c.y), oi = -0.5 * (a.x - c.x);
    const double2 t = cmul(make_double2(orr, oi), __ldg(tw + k));
    const double xr = er + t.x, xi = ei + t.y;
    const size_t o = (static_cast<size_t>(b) * F + f0 + f) * K + k;
    out[o] = static_cast<float>(sqrt(xr * xr + xi * xi + 1e-8));
    if (re_out != nullptr) {
      re_out[o] = static_cast<float>(xr);
      im_out[o] = static_cast<float>(xi);
    }
  }
}

}  // namespace

// The FFT route (n_fft a power of two, 16-4096). x (B, T) float32, win (n)
// and tw (n, 2) float64, out (B, F, n/2 + 1) float32, and re, im of the
// same shape or null (the spectrum the magnitudes came from, for the
// backward). Returns the launch's cudaError_t.
extern "C" int nsc_stft_magnitude_fft(const void* x, const void* win, const void* tw, void* out,
                                      void* re, void* im, int B, int T, int n_fft, int hop, int F,
                                      void* stream) {
  if (B < 1 || B > 65535 || F < 1 || hop < 1 || n_fft < kFftMin || n_fft > kFftMax ||
      (n_fft & (n_fft - 1)) != 0 || T <= n_fft / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ft = fft_frames(n_fft, hop);
  const int smem = fft_smem(n_fft, hop, ft);
  cudaError_t err = cudaFuncSetAttribute(stft_magnitude_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + ft - 1) / ft, B);
  stft_magnitude_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const double*>(win),
      static_cast<const double2*>(tw), static_cast<float*>(out), static_cast<float*>(re),
      static_cast<float*>(im), T, n_fft, hop, F, ft);
  return static_cast<int>(cudaGetLastError());
}

// Frames per block and shared-memory bytes of the FFT kernel's plan.
extern "C" int nsc_stft_fft_plan(int n_fft, int hop, void* plan) {
  long long* o = static_cast<long long*>(plan);
  o[0] = fft_frames(n_fft, hop);
  o[1] = fft_smem(n_fft, hop, static_cast<int>(o[0]));
  return 0;
}

// The DFT route. xpad (B, Tp), win (n_fft), cosb/sinb (n_fft, Kp), out
// (B, F, K), re and im as out or null: float32. Kp is K rounded up to a
// multiple of 128, the basis columns past K are 0. Returns the launch's
// cudaError_t.
extern "C" int nsc_stft_magnitude_dft(const void* xpad, const void* win, const void* cosb,
                                      const void* sinb, void* out, void* re, void* im, int B,
                                      int Tp, int n_fft, int hop, int F, int K, int Kp,
                                      void* stream) {
  if (B < 1 || F < 1 || K < 1 || n_fft < 1 || hop < 1 || Kp < K || Kp % kTileK != 0 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (2 * static_cast<size_t>(kChunkN) * kTileK + n_fft + static_cast<size_t>(kTileF - 1) * hop +
       n_fft) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_magnitude_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kTileF - 1) / kTileF, Kp / kTileK, B);
  const dim3 block(kBinGroups, kFrameGroups);
  stft_magnitude_dft_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xpad), static_cast<const float*>(win),
      static_cast<const float*>(cosb), static_cast<const float*>(sinb),
      static_cast<float*>(out), static_cast<float*>(re), static_cast<float*>(im), Tp, n_fft,
      hop, F, K, Kp);
  return static_cast<int>(cudaGetLastError());
}
