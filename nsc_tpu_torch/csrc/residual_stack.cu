// Residual-unit stack of one SEANet stage, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
// nsc_tpu/ops/pallas/residual_stack.py::residual_stack_ct_pallas
// (body _stack_ct_kernel). For each unit u with dilation d, over x (B, C, T):
//
//   x += W2[u] . act(W1[u] *_d act(x) + b1[u]) + b2[u]
//
// with *_d a causal dilated k=3 C->C conv (zero input for t < 0), W2 1x1,
// and act the in-kernel snake or snake_fast (numerics: see
// nsc_tpu_torch/kernels/residual_stack.py, whose plain version this kernel
// is held against).
//
// What bounds it on the H100: per launch it moves 2*B*C*T elements (x in,
// out) and does 24*B*T*C^2 FLOP (3 units x (3 + 1) C x C products per
// sample). At the serving path's widths (C = 32..256) that is 48..384 FLOP
// per byte in bf16, so the narrow stages sit near the memory bound and the
// wide ones are bound by arithmetic. This first version computes the
// products as SIMT float32 FMAs (no tensor cores), so on this card it is
// bound by SIMT instruction issue (the FMAs and the shared-memory loads
// that feed them), far above the tensor-core bound.
//
// Design against that bound: one block owns one (batch row, time tile). It
// loads the tile plus a left halo of sum(2d) samples (zeros for t < 0) into
// shared memory once, runs all units there, and writes only its own tile,
// so x crosses device memory exactly twice per stage, and the intermediate
// activations never do. Each unit's valid region shrinks by 2d from the
// left. Every product is a register-tiled GEMM (4 output channels x 8 time
// columns per thread) with weight rows staged through shared memory. The
// conv1 output overwrites its own input buffer in place, processed in
// column chunks from right to left: a causal conv only reads columns at or
// left of the one it writes. The activated input is re-zeroed at t < 0
// before every unit: the residual stream there holds W2.act(b1)+b2 after the
// first unit, and the reference conv pads its activated input with zeros.
// Blocks are independent (no carry between time tiles), unlike the TPU
// kernel's sequential grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kMaxUnits = 8;
constexpr int kThreads = 256;
constexpr int kRM = 4;   // output channels per thread
constexpr int kRN = 8;   // time columns per thread
constexpr int kKC = 16;  // weight rows staged per step

struct Dilations {
  int d[kMaxUnits];
};

// float32 constants are the double values rounded once to float, as the
// JAX package and the plain version use them.
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

// sin^2(f): round-half-even range reduction, then u*Q3(u), each operation
// rounded on its own (no contraction into FMAs), as in the plain version.
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
// snake_fast: x + T((u*q) * inv), the add rounded to T.
// snake: x + sin(alpha x)^2 / (alpha + eps) in float32, not rounded.
template <typename T, bool kFast>
__device__ __forceinline__ float act(float x, float alpha) {
  if constexpr (kFast) {
    const float inv = __fdiv_rn(1.0f, __fadd_rn(alpha, kEps));
    const float term = round_to<T>(__fmul_rn(sin_sq_poly(__fmul_rn(alpha, x)), inv));
    return round_to<T>(__fadd_rn(x, term));
  } else {
    const float s = sinf(__fmul_rn(alpha, x));
    return __fadd_rn(x, __fdiv_rn(__fmul_rn(s, s), __fadd_rn(alpha, kEps)));
  }
}

// One register tile: acc[i][j] = sum_k W[k][co_i] * src(k, p_j) over the nk
// weight rows at wg (each C wide), staged kKC rows at a time into Wsm. For
// conv1 row k = tap*C + ci reads column p - (2 - tap)*d of channel ci; for
// conv2 row k = ci reads column p.
template <typename T, typename A>
__device__ __forceinline__ void gemm_tile(
    float (&acc)[kRM][kRN], const T* __restrict__ wg, int nk, int C, int L,
    const A* Abuf, float* Wsm, int p0, int ty, int tx, int TY, int TX, int d,
    bool conv1) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kKC) {
    const int kn = min(kKC, nk - k0);
    __syncthreads();  // earlier readers of Wsm are done
    for (int i = tid; i < kn * C; i += nthreads)
      Wsm[i] = to_f(wg[static_cast<size_t>(k0) * C + i]);
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      const int k = k0 + kk;
      int ci = k, shift = 0;
      if (conv1) {
        const int tap = k / C;
        ci = k - tap * C;
        shift = (2 - tap) * d;
      }
      float wv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) wv[i] = Wsm[kk * C + ty + i * TY];
      const A* arow = Abuf + static_cast<size_t>(ci) * L - shift;
      float av[kRN];
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int p = p0 + tx + j * TX;
        av[j] = p < L ? to_f(arow[p]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] = fmaf(wv[i], av[j], acc[i][j]);
    }
  }
}

template <typename T, bool kFast>
__global__ void __launch_bounds__(kThreads) residual_stack_kernel(
    const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ a1,
    const T* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ a2, int C, int Tlen, int U, Dilations dil,
    int halo, int tile) {
  // activation storage: T for snake_fast (its result is rounded to T),
  // float32 for snake (its result stays float32)
  using A = typename std::conditional<kFast, T, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = tile + halo;
  T* S = reinterpret_cast<T*>(smem);                        // [C][L] stream
  A* Abuf = reinterpret_cast<A*>(S + static_cast<size_t>(C) * L);  // [C][L]
  float* Wsm = reinterpret_cast<float*>(Abuf + static_cast<size_t>(C) * L);

  const int TY = C / kRM;
  const int TX = blockDim.x / TY;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int NC = TX * kRN;  // columns per chunk
  const int nthreads = blockDim.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int base = t0 - halo;  // absolute time of column 0
  const T* xb = x + static_cast<size_t>(b) * C * Tlen;

  for (int i = tid; i < C * L; i += nthreads) {
    const int c = i / L, p = i - c * L, t = base + p;
    S[i] = (t >= 0 && t < Tlen) ? xb[static_cast<size_t>(c) * Tlen + t] : from_f<T>(0.f);
  }

  int start = 0;  // first column whose stream value is valid
  for (int u = 0; u < U; ++u) {
    const int d = dil.d[u];
    const int ostart = start + 2 * d;
    __syncthreads();
    // act1 of the stream, zero at t < 0 (the conv's zero padding)
    for (int i = tid; i < C * L; i += nthreads) {
      const int c = i / L, p = i - c * L;
      if (p < start) continue;
      const float v = base + p < 0 ? 0.f : act<T, kFast>(to_f(S[i]), a1[u * C + c]);
      Abuf[i] = from_f<A>(v);
    }
    // conv1 + b1 -> T -> act2, in place, chunks right to left
    const int nchunk = (L - ostart + NC - 1) / NC;
    float acc[kRM][kRN];
    for (int ch = nchunk - 1; ch >= 0; --ch) {
      const int p0 = ostart + ch * NC;
      gemm_tile<T, A>(acc, w1 + static_cast<size_t>(u) * 3 * C * C, 3 * C, C,
                      L, Abuf, Wsm, p0, ty, tx, TY, TX, d, true);
      __syncthreads();  // every read of this chunk's inputs is done
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int co = ty + i * TY;
        const float bias = b1[u * C + co], alpha = a2[u * C + co];
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const int p = p0 + tx + j * TX;
          if (p < L) {
            const float y = round_to<T>(acc[i][j] + bias);
            Abuf[static_cast<size_t>(co) * L + p] = from_f<A>(act<T, kFast>(y, alpha));
          }
        }
      }
    }
    // conv2 + b2 -> T, added to the stream in T
    const int nchunk2 = (L - ostart + NC - 1) / NC;
    for (int ch = 0; ch < nchunk2; ++ch) {
      const int p0 = ostart + ch * NC;
      gemm_tile<T, A>(acc, w2 + static_cast<size_t>(u) * C * C, C, C, L, Abuf,
                      Wsm, p0, ty, tx, TY, TX, d, false);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int co = ty + i * TY;
        const float bias = b2[u * C + co];
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const int p = p0 + tx + j * TX;
          if (p < L) {
            T& s = S[static_cast<size_t>(co) * L + p];
            const float z = round_to<T>(acc[i][j] + bias);
            s = from_f<T>(__fadd_rn(to_f(s), z));
          }
        }
      }
    }
    start = ostart;
  }
  __syncthreads();
  T* ob = out + static_cast<size_t>(b) * C * Tlen;
  for (int i = tid; i < C * tile; i += nthreads) {
    const int c = i / tile, q = i - c * tile, t = t0 + q;
    if (t < Tlen) ob[static_cast<size_t>(c) * Tlen + t] = S[static_cast<size_t>(c) * L + halo + q];
  }
}

size_t smem_bytes(int C, int L, size_t elem_bytes) {
  return static_cast<size_t>(C) * L * elem_bytes + static_cast<size_t>(kKC) * C * 4;
}

// Largest time tile (a multiple of 32 up to 1024 where possible) whose
// shared memory fits a budget: first one that leaves room for two blocks
// per SM, then the whole 227 KB. 0 if even one column does not fit.
int pick_tile(int C, int halo, size_t elem_bytes) {
  const size_t budgets[2] = {112 * 1024, 232448};
  for (size_t budget : budgets) {
    const size_t w = static_cast<size_t>(kKC) * C * 4;
    if (budget <= w) continue;
    const long cols = static_cast<long>((budget - w) / (static_cast<size_t>(C) * elem_bytes));
    long tile = cols - halo;
    if (tile >= 32) return static_cast<int>(tile > 1024 ? 1024 : tile / 32 * 32);
  }
  const size_t w = static_cast<size_t>(kKC) * C * 4;
  const long cols = static_cast<long>((budgets[1] - w) / (static_cast<size_t>(C) * elem_bytes));
  return cols - halo >= 1 ? static_cast<int>(cols - halo) : 0;
}

template <typename T, bool kFast>
cudaError_t launch(const void* x, void* out, const void* w1, const void* b1,
                   const void* a1, const void* w2, const void* b2,
                   const void* a2, int B, int C, int Tlen, int U,
                   const Dilations& dil, int halo, cudaStream_t stream) {
  using A = typename std::conditional<kFast, T, float>::type;
  const size_t elem = sizeof(T) + sizeof(A);
  const int tile = pick_tile(C, halo, elem);
  if (tile < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, tile + halo, elem);
  auto kernel = residual_stack_kernel<T, kFast>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int TY = C / kRM;
  const int threads = TY * (kThreads / TY);
  dim3 grid((Tlen + tile - 1) / tile, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(a1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(a2), C, Tlen, U, dil, halo, tile);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, C, T) in bf16 (is_bf16) or f32; w1 (U, 3, Cin, Cout) and
// w2 (U, Cin, Cout) in x's type; b1, a1, b2, a2 (U, C) f32; dilations: a
// host array of U ints. Returns the launch's cudaError_t.
extern "C" int nsc_residual_stack(const void* x, void* out, const void* w1,
                                  const void* b1, const void* a1,
                                  const void* w2, const void* b2,
                                  const void* a2, const void* dilations,
                                  int B, int C, int Tlen, int U, int is_bf16,
                                  int fast, void* stream) {
  if (U < 1 || U > kMaxUnits || C < kRM || C % kRM != 0 || C / kRM > kThreads ||
      B < 1 || Tlen < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Dilations dil{};
  int halo = 0;
  const int* dp = static_cast<const int*>(dilations);
  for (int u = 0; u < U; ++u) {
    if (dp[u] < 1) return static_cast<int>(cudaErrorInvalidValue);
    dil.d[u] = dp[u];
    halo += 2 * dp[u];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = fast ? launch<__nv_bfloat16, true>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s)
               : launch<__nv_bfloat16, false>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s);
  } else {
    err = fast ? launch<float, true>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s)
               : launch<float, false>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s);
  }
  return static_cast<int>(err);
}
