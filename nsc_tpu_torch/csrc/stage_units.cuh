// Device building blocks of the SEANet stage kernels K1
// (residual_stack.cu), K5 (fused_stage.cu) and K6 (residual_stack_cl.cu),
// for Hopper (sm_90a): the in-kernel activations, a register-tiled SIMT
// GEMM whose weight rows are staged through shared memory, and the
// residual-unit chain on (C x L) buffers in shared memory. The GEMM is
// general over the weight rows' order, the activation operand's column
// stride and the number of output rows, so the strided head and the
// transposed tail of K5 use it too.
//
// Unit chain, for each unit u with dilation d, over the stream S:
//
//   S += T(W2[u] . act(T(W1[u] *_d act(S) + b1[u])) + b2[u])
//
// *_d is a causal dilated k=3 conv whose activated input is zero at t < 0.
// Each unit's valid region shrinks by 2d from the left; conv1's output
// overwrites its own input buffer in place, in column chunks from right to
// left (a causal conv reads only columns at or left of the one it writes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace nsc_stage {

constexpr int kMaxUnits = 8;
constexpr int kThreads = 256;  // every launch uses this block size
constexpr int kRM = 4;         // output rows per thread
constexpr int kRN = 8;         // columns per thread
constexpr int kKC = 16;        // weight rows staged per step

struct Dilations {
  int d[kMaxUnits];
};

// float32 constants are the double values rounded once to float, as the
// JAX package and the plain versions use them.
constexpr float kInvPi = static_cast<float>(0.31830988618379067154);
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kC3 = static_cast<float>(-0.00254553);
constexpr float kC2 = static_cast<float>(0.04350543);
constexpr float kC1 = static_cast<float>(-0.33287596);
constexpr float kC0 = static_cast<float>(0.99996482);
constexpr float kEps = static_cast<float>(1e-9);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to T and back (identity for T = float).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// Storage of activations: T for snake_fast (its result is rounded to T),
// float32 for snake (its result stays float32).
template <typename T, bool kFast>
using act_t = typename std::conditional<kFast, T, float>::type;

// sin^2(f): round-half-even range reduction, then u*Q3(u), each operation
// rounded on its own (no contraction into FMAs), as in the plain versions.
__device__ __forceinline__ float sin_sq_poly(float f) {
  const float k = rintf(__fmul_rn(f, kInvPi));
  const float r = __fsub_rn(f, __fmul_rn(k, kPi));
  const float u = __fmul_rn(r, r);
  float q = __fadd_rn(kC2, __fmul_rn(u, kC3));
  q = __fadd_rn(kC1, __fmul_rn(u, q));
  q = __fadd_rn(kC0, __fmul_rn(u, q));
  return __fmul_rn(u, q);
}

// The in-kernel activation of a value x that is exact in T.
// snake_fast: x + T(term), the add rounded to T, where term is
//   (u*q) / (alpha + eps)      with kDiv (K6, `_snake_fast`),
//   (u*q) * (1/(alpha + eps))  without (K5, `_snake_fast_ct`).
// snake: x + sin(alpha x)^2 / (alpha + eps) in float32, not rounded.
template <typename T, bool kFast, bool kDiv>
__device__ __forceinline__ float act(float x, float alpha) {
  if constexpr (kFast) {
    const float sq = sin_sq_poly(__fmul_rn(alpha, x));
    const float den = __fadd_rn(alpha, kEps);
    const float term = kDiv ? __fdiv_rn(sq, den) : __fmul_rn(sq, __fdiv_rn(1.0f, den));
    return round_to<T>(__fadd_rn(x, round_to<T>(term)));
  } else {
    const float s = sinf(__fmul_rn(alpha, x));
    return __fadd_rn(x, __fdiv_rn(__fmul_rn(s, s), __fadd_rn(alpha, kEps)));
  }
}

// How a block's kThreads threads cover a GEMM with `rows` output rows:
// TY threads over rows (kRM each, rows ty + i*TY), TX over columns (kRN
// each, columns tx + j*TX of a chunk of nc). Threads past TY*TX idle.
struct Tiling {
  int TY, TX, ty, tx, nc;
  bool active;
  __device__ __forceinline__ explicit Tiling(int rows) {
    TY = rows / kRM;
    TX = kThreads / TY;
    ty = threadIdx.x / TX;
    tx = threadIdx.x % TX;
    nc = TX * kRN;
    active = static_cast<int>(threadIdx.x) < TY * TX;
  }
};

__device__ __forceinline__ void zero(float (&acc)[kRM][kRN]) {
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum over rows r < nk of W[r][row_i] * A_r[col_j * stride],
// where W row r starts at wg + wrow(r) * rows (each row `rows` wide, staged
// kKC rows at a time into Wsm) and A_r = arow(r) points at this chunk's
// column 0; columns at or past ncols read 0. Every thread of the block must
// call it (it synchronises); idle threads only help stage.
template <typename W, typename WRow, typename ARow>
__device__ __forceinline__ void gemm_tile(float (&acc)[kRM][kRN], const W* __restrict__ wg,
                                          int nk, int rows, float* Wsm, const Tiling& tl,
                                          int ncols, int stride, WRow wrow, ARow arow) {
  for (int k0 = 0; k0 < nk; k0 += kKC) {
    const int kn = min(kKC, nk - k0);
    __syncthreads();  // earlier readers of Wsm (and writers of A) are done
    for (int i = threadIdx.x; i < kn * rows; i += kThreads) {
      const int kk = i / rows, co = i - kk * rows;
      Wsm[i] = to_f(wg[static_cast<size_t>(wrow(k0 + kk)) * rows + co]);
    }
    __syncthreads();
    if (!tl.active) continue;
    for (int kk = 0; kk < kn; ++kk) {
      float wv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) wv[i] = Wsm[kk * rows + tl.ty + i * tl.TY];
      const auto* a = arow(k0 + kk);
      float av[kRN];
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int c = tl.tx + j * tl.TX;
        av[j] = c < ncols ? to_f(a[c * stride]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] = fmaf(wv[i], av[j], acc[i][j]);
    }
  }
}

// The residual units on the stream S (C x L, T), column p at absolute time
// base + p, valid from column 0. Abuf (C x L) holds activations; Wsm holds
// kKC x C floats. Weights w1 (U, 3, Cin, Cout) and w2 (U, Cin, Cout) are
// in W (T for K1, float32 for K5 and K6); the (U, C) biases and alphas are
// float32. kDiv picks the activation's divide (see `act`). Returns the
// first valid column.
template <typename T, bool kFast, bool kDiv, typename W>
__device__ int run_units(T* S, act_t<T, kFast>* Abuf, float* Wsm, int C, int L, int U,
                         const Dilations& dil, const W* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ a1,
                         const W* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ a2, int base) {
  using A = act_t<T, kFast>;
  const Tiling tl(C);
  const int tid = threadIdx.x;
  int start = 0;
  for (int u = 0; u < U; ++u) {
    const int d = dil.d[u];
    const int ostart = start + 2 * d;
    __syncthreads();
    // act1 of the stream, zero at t < 0 (the conv's zero padding)
    for (int i = tid; i < C * L; i += kThreads) {
      const int c = i / L, p = i - c * L;
      if (p < start) continue;
      const float v = base + p < 0 ? 0.f : act<T, kFast, kDiv>(to_f(S[i]), a1[u * C + c]);
      Abuf[i] = from_f<A>(v);
    }
    // conv1 + b1 -> T -> act2, in place, chunks right to left
    const int nchunk = (L - ostart + tl.nc - 1) / tl.nc;
    const W* w1u = w1 + static_cast<size_t>(u) * 3 * C * C;
    float acc[kRM][kRN];
    for (int ch = nchunk - 1; ch >= 0; --ch) {
      const int p0 = ostart + ch * tl.nc;
      zero(acc);
      gemm_tile(acc, w1u, 3 * C, C, Wsm, tl, L - p0, 1, [](int r) { return r; },
                [&](int r) {
                  const int tap = r / C, ci = r - tap * C;
                  return Abuf + static_cast<size_t>(ci) * L + p0 - (2 - tap) * d;
                });
      __syncthreads();  // every read of this chunk's inputs is done
      if (!tl.active) continue;
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int co = tl.ty + i * tl.TY;
        const float bias = b1[u * C + co], alpha = a2[u * C + co];
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const int p = p0 + tl.tx + j * tl.TX;
          if (p < L) {
            const float y = round_to<T>(acc[i][j] + bias);
            Abuf[static_cast<size_t>(co) * L + p] = from_f<A>(act<T, kFast, kDiv>(y, alpha));
          }
        }
      }
    }
    // conv2 + b2 -> T, added to the stream in T
    const W* w2u = w2 + static_cast<size_t>(u) * C * C;
    for (int ch = 0; ch < nchunk; ++ch) {
      const int p0 = ostart + ch * tl.nc;
      zero(acc);
      gemm_tile(acc, w2u, C, C, Wsm, tl, L - p0, 1, [](int r) { return r; },
                [&](int r) { return Abuf + static_cast<size_t>(r) * L + p0; });
      if (!tl.active) continue;
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int co = tl.ty + i * tl.TY;
        const float bias = b2[u * C + co];
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const int p = p0 + tl.tx + j * tl.TX;
          if (p < L) {
            T& s = S[static_cast<size_t>(co) * L + p];
            s = from_f<T>(__fadd_rn(to_f(s), round_to<T>(acc[i][j] + bias)));
          }
        }
      }
    }
    start = ostart;
  }
  return start;
}

// Columns a block of C x elem_bytes each can hold beside `extra` bytes:
// the largest time tile (a multiple of 32, at most 1024, where possible)
// first within a budget that leaves room for two blocks per SM, then
// within the whole 227 KB. 0 if not even one column fits.
inline int pick_tile(int C, int halo, size_t elem_bytes, size_t extra) {
  const size_t budgets[2] = {112 * 1024, 232448};
  long last = 0;
  for (size_t budget : budgets) {
    if (budget <= extra) continue;
    const long cols = static_cast<long>((budget - extra) / (static_cast<size_t>(C) * elem_bytes));
    last = cols - halo;
    if (last >= 32) return static_cast<int>(last > 1024 ? 1024 : last / 32 * 32);
  }
  return last >= 1 ? static_cast<int>(last) : 0;
}

// Dynamic shared memory of a stack kernel (K1, K6): the stream and the
// activations, C x L elements of elem_bytes together, and the staged
// weight rows.
inline size_t stack_smem_bytes(int C, int L, size_t elem_bytes) {
  return static_cast<size_t>(C) * L * elem_bytes + static_cast<size_t>(kKC) * C * sizeof(float);
}

inline bool valid_width(int c) { return c >= kRM && c % kRM == 0 && c / kRM <= kThreads; }

// Copies the host dilation array; the halo is their sum(2d). False on a
// bad count or dilation.
inline bool read_dilations(const void* dilations, int U, Dilations* dil, int* halo) {
  if (U < 1 || U > kMaxUnits) return false;
  const int* dp = static_cast<const int*>(dilations);
  *halo = 0;
  for (int u = 0; u < U; ++u) {
    if (dp[u] < 1) return false;
    dil->d[u] = dp[u];
    *halo += 2 * dp[u];
  }
  return true;
}

}  // namespace nsc_stage
