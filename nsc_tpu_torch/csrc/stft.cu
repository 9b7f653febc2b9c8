// Framed STFT magnitude for the spectral losses, for Hopper (sm_90a).
//
// Replaces nsc_tpu/ops/pallas/stft.py::stft_magnitude_pallas (_stft_kernel).
// For each row b, frame f and bin k of a signal reflect-padded by n_fft/2
// on both sides:
//   X[b, f, k] = sum_n (x[b, f*hop + n] * win[n]) * exp(-2 pi i n k / n_fft)
//   out[b, f, k] = sqrt(re*re + im*im + 1e-8)
// with the periodic Hann window. The point of the TPU kernel is that the
// frame tensor, n_fft/hop times the signal, never reaches device memory;
// both kernels here keep that property, and both read the reflect-padded
// index in the kernel (no padded copy). The wrapper (kernels/stft.py::route)
// picks one by n_fft alone.
//
// Both compute in float64 and round each output once to float32: each
// magnitude is that of the true float64 spectrum of the float32 input,
// correctly rounded. The spectral losses' gradients need that: the
// log-magnitude term is an L1 whose gradient changes sign where
// reconstruction and target magnitudes nearly tie, so any rounding of
// ~1e-7 of a frame's peak flips the sign at some low bins, and a float32
// forward is as far from the float64 gradient as the draw of those flips
// makes it. Both read the float64 window and the float64 table tw[j] =
// exp(-2 pi i j / n_fft), the values the DFT basis is cast from.
//
// stft_magnitude_kernel, the real FFT, for the n_fft the wrapper gives it
// a pass list for (kernels/stft.py::fft_passes, the one statement of the
// route's domain): even n_fft whose half has no prime factor above 7,
// from 16 up to the n_fft whose one-frame plan fills a block's shared
// memory (20 n_fft bytes). What bounds it on the H100: ~2.5 n log2 n
// float64 FLOP per frame and 4 bytes per output bin, near each other at
// the card's float64 and memory rates. Design: one block owns one (row,
// tile of FT frames); it stages the raw segment its frames cover once,
// windows each frame in float64 and packs it into an n/2-point complex
// sequence (even samples real, odd imaginary). Stockham passes of radix 4,
// 2, 3, 5 and 7 (the pass list, a kernel argument, 4 bits a radix; the
// launcher checks only that its radices multiply to n/2) run on all FT
// frames at once, ping-ponging between two shared buffers, so there is no
// digit reversal; the twiddles and the odd radices' butterfly constants
// W_R^j = tw[j n / R] come from the float64 table. For a power of two the
// pass list is the radix-4 passes with a radix-2 pass last where
// log2(n/2) is odd. The post-twiddle X[k] = Ze[k] + W^k Zo[k]
// splits the complex spectrum into the real one; the magnitudes (and, for
// the backward, re and im) are written coalesced by bin.
//
// stft_magnitude_dft_kernel, the remainder: every other n_fft >= 2 (odd,
// a half with a prime factor above 7, or above the FFT's one-frame limit).
// The O(n^2) DFT, summed in float64 against the float64 table read at
// (n k) mod n_fft. One block owns one (row, tile of 32 frames, tile of 64
// bins) and walks n in chunks of 32: per chunk it stages the windowed
// samples of its frames (float64) and the basis of its bins, so a block's
// shared memory (40 KB) does not grow with n_fft or hop, and no shape is
// refused. The 256 threads are 32 bin lanes (threadIdx.x: bins x and x + 32,
// conflict-free 16-byte basis reads) by 8 frame groups (threadIdx.y: 4
// frames each, shared by the warp, so the sample reads are broadcasts);
// each thread keeps 4 frames x 2 bins x (re, im) float64 sums, and a warp
// whose frames all lie past F skips the sums. A fallback for unusual sizes:
// its operations grow as n_fft^2 per frame.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr double kEps = 1e-8;

// the padded position P of a frame's sample, read through the reflection;
// positions past the padded signal (frames past F in a block's last tile)
// read 0
__device__ __forceinline__ float reflected(const float* row, long long P, int T, int pad) {
  if (P >= static_cast<long long>(T) + 2 * pad) return 0.f;
  long long j = P - pad;
  if (j < 0) j = -j;
  if (j >= T) j = 2 * (static_cast<long long>(T) - 1) - j;
  return row[j];
}

__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return make_double2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// ---------------------------------------------------------------------------
// The real FFT, in float64.

constexpr int kFramePoints = 4096;   // real samples of the frames a block holds
constexpr int kSmemTarget = 81920;   // fewer frames per block while above

// Frames per block and shared-memory bytes: two buffers of n/2 complex
// float64 points per frame and the raw float32 segment (exported as
// nsc_stft_fft_plan). At one frame a block holds 20 * n bytes.
__host__ __device__ inline int fft_smem(int n, int hop, int ft) {
  return 16 * ft * n + 4 * ((ft - 1) * hop + n);
}
// the largest power of two with ft * n <= kFramePoints (at least 1),
// halved while the block's bytes are above kSmemTarget
inline int fft_frames(int n, int hop) {
  int ft = 1;
  while (2 * ft * n <= kFramePoints) ft *= 2;
  while (ft > 1 && fft_smem(n, hop, ft) > kSmemTarget) ft /= 2;
  return ft;
}

// The number of passes of a pass list (4 bits a radix from the lowest, 0
// ends it), or 0 unless it is a transform of n/2 points: radices 2, 3, 4,
// 5 and 7 whose product is n/2. Each prefix's product p then times the
// next radix R divides n/2, so Stockham's twiddle stride n / (R p) is an
// integer.
inline int fft_passes(int n, unsigned long long radices) {
  long long prod = 1;
  int passes = 0;
  for (; radices != 0; radices >>= 4, ++passes) {
    const int r = static_cast<int>(radices & 15);
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7) return 0;
    prod *= r;
  }
  return passes > 0 && n % 2 == 0 && prod == n / 2 ? passes : 0;
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
    const int f = g / q, i = g - f * q, k = i % p;
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
    } else if constexpr (R == 2) {
      d[0] = make_double2(u[0].x + u[1].x, u[0].y + u[1].y);
      d[p] = make_double2(u[0].x - u[1].x, u[0].y - u[1].y);
    } else {
      // odd R, in pairs (t, R - t): with a_m = u_m + u_(R-m), b_m = u_m -
      // u_(R-m) and W_R^(m t) = (c, s) = tw[(m t mod R) n / R],
      // y_t = u_0 + sum_m (a_m c + i s b_m), y_(R-t) = u_0 + sum_m (a_m c - i s b_m)
      constexpr int H = (R - 1) / 2;
      const int stride = n / R;
      double2 a[H], b[H];
      double2 y0 = u[0];
#pragma unroll
      for (int m = 1; m <= H; ++m) {
        a[m - 1] = make_double2(u[m].x + u[R - m].x, u[m].y + u[R - m].y);
        b[m - 1] = make_double2(u[m].x - u[R - m].x, u[m].y - u[R - m].y);
        y0 = make_double2(y0.x + a[m - 1].x, y0.y + a[m - 1].y);
      }
      d[0] = y0;
#pragma unroll
      for (int t = 1; t <= H; ++t) {
        double2 re = u[0], im = make_double2(0.0, 0.0);
#pragma unroll
        for (int m = 1; m <= H; ++m) {
          const double2 w = __ldg(tw + ((m * t) % R) * stride);
          re = make_double2(re.x + a[m - 1].x * w.x, re.y + a[m - 1].y * w.x);
          im = make_double2(im.x + b[m - 1].x * w.y, im.y + b[m - 1].y * w.y);
        }
        d[t * p] = make_double2(re.x - im.y, re.y + im.x);        // re + i im
        d[(R - t) * p] = make_double2(re.x + im.y, re.y - im.x);  // re - i im
      }
    }
  }
}

// x (B, T) float32 unpadded; win (n) and tw (n complex) float64; out (B,
// F, n/2 + 1) float32, re and im likewise or null; radices: the pass list.
__global__ void __launch_bounds__(kThreads) stft_magnitude_kernel(
    const float* __restrict__ x, const double* __restrict__ win,
    const double2* __restrict__ tw, float* __restrict__ out, float* __restrict__ re_out,
    float* __restrict__ im_out, int T, int n, int hop, int F, int ft,
    unsigned long long radices) {
  extern __shared__ __align__(16) double2 smd[];
  const int n2 = n / 2, K = n2 + 1;
  double2* buf0 = smd;              // [ft][n2]
  double2* buf1 = buf0 + ft * n2;   // [ft][n2]
  float* seg = reinterpret_cast<float*>(buf1 + ft * n2);  // [(ft-1)*hop + n]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * ft;
  const int tid = threadIdx.x;
  const float* row = x + static_cast<size_t>(b) * T;

  // the raw segment of padded positions f0*hop .. f0*hop + seg_len
  const int seg_len = (ft - 1) * hop + n;
  const long long start = static_cast<long long>(f0) * hop;
  for (int i = tid; i < seg_len; i += kThreads) seg[i] = reflected(row, start + i, T, n2);
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
  for (; radices != 0; radices >>= 4) {
    const int r = static_cast<int>(radices & 15);
    switch (r) {
      case 4: fft_pass<4>(src, dst, tw, ft, n2, n, p); break;
      case 2: fft_pass<2>(src, dst, tw, ft, n2, n, p); break;
      case 3: fft_pass<3>(src, dst, tw, ft, n2, n, p); break;
      case 5: fft_pass<5>(src, dst, tw, ft, n2, n, p); break;
      default: fft_pass<7>(src, dst, tw, ft, n2, n, p); break;
    }
    __syncthreads();
    double2* t = src;
    src = dst;
    dst = t;
    p *= r;
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
    out[o] = static_cast<float>(sqrt(xr * xr + xi * xi + kEps));
    if (re_out != nullptr) {
      re_out[o] = static_cast<float>(xr);
      im_out[o] = static_cast<float>(xi);
    }
  }
}

// ---------------------------------------------------------------------------
// The DFT remainder, in float64.

constexpr int kBinLanes = 32;                               // threadIdx.x
constexpr int kFrameGroups = kThreads / kBinLanes;          // threadIdx.y: 8
constexpr int kBinsPerThread = 2;                           // x and x + 32
constexpr int kFramesPerThread = 4;
constexpr int kTileK = kBinLanes * kBinsPerThread;          // 64 bins
constexpr int kTileF = kFrameGroups * kFramesPerThread;     // 32 frames
constexpr int kChunkN = 32;                                 // points n per stage

__global__ void __launch_bounds__(kThreads) stft_magnitude_dft_kernel(
    const float* __restrict__ x, const double* __restrict__ win,
    const double2* __restrict__ tw, float* __restrict__ out, float* __restrict__ re_out,
    float* __restrict__ im_out, int T, int n_fft, int hop, int F) {
  __shared__ double2 bs[kChunkN][kTileK];   // W^((n k) mod n_fft) of the chunk's n, the tile's k
  __shared__ double xs[kTileF][kChunkN];    // windowed samples of the tile's frames

  const int K = n_fft / 2 + 1;
  const int b = blockIdx.z;
  const int f0 = blockIdx.x * kTileF;
  const int k0 = blockIdx.y * kTileK;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBinLanes + tx;
  const float* row = x + static_cast<size_t>(b) * T;
  const int pad = n_fft / 2;

  // the basis entries a thread stages: bin k0 + (tid mod 64), points n0 + j
  // for j = tid / 64 + 4 r; its table index advances by 4 k mod n_fft per r
  constexpr int kRowsPerPass = kThreads / kTileK;  // 4
  const int sk = tid % kTileK, sj = tid / kTileK;
  const unsigned long long kk = static_cast<unsigned long long>(k0 + sk);
  const unsigned long long nn = static_cast<unsigned long long>(n_fft);
  const unsigned long long advance = (kRowsPerPass * kk) % nn;
  const bool active = f0 + ty * kFramesPerThread < F;  // warp-uniform

  double re[kFramesPerThread][kBinsPerThread] = {};
  double im[kFramesPerThread][kBinsPerThread] = {};

  for (int n0 = 0; n0 < n_fft; n0 += kChunkN) {
    __syncthreads();  // readers of the previous chunk done
    unsigned long long j_idx = (static_cast<unsigned long long>(n0 + sj) * kk) % nn;
    for (int j = sj; j < kChunkN; j += kRowsPerPass) {
      bs[j][sk] = __ldg(tw + j_idx);
      j_idx += advance;
      if (j_idx >= nn) j_idx -= nn;
    }
    for (int i = tid; i < kTileF * kChunkN; i += kThreads) {
      const int f = i / kChunkN, j = i - f * kChunkN, n = n0 + j;
      double v = 0.0;
      if (n < n_fft) {
        const long long P = static_cast<long long>(f0 + f) * hop + n;
        v = static_cast<double>(reflected(row, P, T, pad)) * __ldg(win + n);
      }
      xs[f][j] = v;
    }
    __syncthreads();
    if (!active) continue;
    const int nc = min(kChunkN, n_fft - n0);
    for (int j = 0; j < nc; ++j) {
      double2 w[kBinsPerThread];
#pragma unroll
      for (int q = 0; q < kBinsPerThread; ++q) w[q] = bs[j][q * kBinLanes + tx];
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
        const double v = xs[ty * kFramesPerThread + i][j];
#pragma unroll
        for (int q = 0; q < kBinsPerThread; ++q) {
          re[i][q] = fma(v, w[q].x, re[i][q]);
          im[i][q] = fma(v, w[q].y, im[i][q]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    const int f = f0 + ty * kFramesPerThread + i;
    if (f >= F) continue;
#pragma unroll
    for (int q = 0; q < kBinsPerThread; ++q) {
      const int k = k0 + q * kBinLanes + tx;
      if (k >= K) continue;
      const size_t o = (static_cast<size_t>(b) * F + f) * K + k;
      out[o] = static_cast<float>(sqrt(re[i][q] * re[i][q] + im[i][q] * im[i][q] + kEps));
      if (re_out != nullptr) {
        re_out[o] = static_cast<float>(re[i][q]);
        im_out[o] = static_cast<float>(im[i][q]);
      }
    }
  }
}

}  // namespace

// The FFT route. x (B, T) float32, win (n) and tw (n, 2) float64, out
// (B, F, n/2 + 1) float32, and re, im of the same shape or null (the
// spectrum the magnitudes came from, for the backward); radices: the pass
// list (kernels/stft.py::fft_passes). Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a pass list that is not a transform of n/2
// points; an error of the attribute where the plan is over a block's
// shared memory).
extern "C" int nsc_stft_magnitude_fft(const void* x, const void* win, const void* tw, void* out,
                                      void* re, void* im, int B, int T, int n_fft, int hop, int F,
                                      unsigned long long radices, void* stream) {
  if (B < 1 || B > 65535 || F < 1 || hop < 1 || T <= n_fft / 2 || fft_passes(n_fft, radices) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ft = fft_frames(n_fft, hop);
  const int smem = fft_smem(n_fft, hop, ft);
  cudaError_t err = cudaFuncSetAttribute(stft_magnitude_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return static_cast<int>(err);
  }
  const dim3 grid((F + ft - 1) / ft, B);
  stft_magnitude_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const double*>(win),
      static_cast<const double2*>(tw), static_cast<float*>(out), static_cast<float*>(re),
      static_cast<float*>(im), T, n_fft, hop, F, ft, radices);
  return static_cast<int>(cudaGetLastError());
}

// The FFT kernel's plan at (n_fft, hop): plan[0] frames per block, plan[1]
// shared-memory bytes (2 long longs). Returns 0, or cudaErrorInvalidValue
// (plan 0) for an odd n_fft or one below 2.
extern "C" int nsc_stft_fft_plan(int n_fft, int hop, void* plan) {
  long long* o = static_cast<long long*>(plan);
  o[0] = o[1] = 0;
  if (n_fft < 2 || n_fft % 2 != 0 || hop < 1) return static_cast<int>(cudaErrorInvalidValue);
  o[0] = fft_frames(n_fft, hop);
  o[1] = fft_smem(n_fft, hop, static_cast<int>(o[0]));
  return 0;
}

// The DFT remainder, any n_fft >= 2. Arguments as nsc_stft_magnitude_fft's
// but the pass list.
// Returns the launch's cudaError_t.
extern "C" int nsc_stft_magnitude_dft(const void* x, const void* win, const void* tw, void* out,
                                      void* re, void* im, int B, int T, int n_fft, int hop, int F,
                                      void* stream) {
  if (B < 1 || B > 65535 || F < 1 || n_fft < 2 || hop < 1 || T <= n_fft / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = n_fft / 2 + 1;
  const dim3 grid((F + kTileF - 1) / kTileF, (K + kTileK - 1) / kTileK, B);
  const dim3 block(kBinLanes, kFrameGroups);
  stft_magnitude_dft_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const double*>(win),
      static_cast<const double2*>(tw), static_cast<float*>(out), static_cast<float*>(re),
      static_cast<float*>(im), T, n_fft, hop, F);
  return static_cast<int>(cudaGetLastError());
}
