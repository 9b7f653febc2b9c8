// Residual-unit stack of one SEANet stage on the channels-last layout (K6),
// for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
// nsc_tpu/ops/pallas/residual_stack.py::residual_stack_pallas (body
// _stack_kernel). x and out are (B, T, C); for each unit u with dilation d
//
//   x += W2[u] . act(W1[u] *_d act(x) + b1[u]) + b2[u]
//
// with float32 weights (bf16 activations times float32 weights in bf16
// serving) and the snake_fast that divides by (alpha + eps). Numerics: see
// nsc_tpu_torch/kernels/residual_stack.py, whose plain version
// `residual_stack_cl_plain` this kernel is held against.
//
// What bounds it on the H100: per launch it moves 2*B*T*C elements and does
// 24*B*T*C^2 FLOP of float32-weight products. In bf16 serving each such
// product is float32-exact as three bf16 MMAs (the weight split into bf16
// planes hi + mid + lo on the host), so the bound is 3 x 24*B*T*C^2 at the
// bf16 tensor-core rate: operations at C = 32..256. The tensor-core chain of
// stage_units.cuh runs it (bf16 x, snake_fast, C % 16 == 0); the float32
// and snake instantiations run the SIMT chain at the float32 rate.
//
// Design: one block per (batch row, time tile) with a recomputed left halo
// of sum(2d) samples, zeros at t < 0 and the activated input re-zeroed there
// before every unit, so blocks are independent (the TPU kernel's grid ran in
// order; here nothing carries between blocks). With channels last a time
// step is C contiguous values: the tile and its halo load with neighbouring
// threads on neighbouring channels. On the tensor cores a time step is a
// row of the chain's time-major buffers, so the tile moves 16 bytes a
// thread with no transpose; the SIMT chain's (C x L) buffers take a
// transpose on the way in and out.

#include "stage_units.cuh"

namespace {

using namespace nsc_stage;

template <typename T, bool kFast>
__global__ void __launch_bounds__(kThreads) residual_stack_cl_kernel(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ a1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ a2, int C, int Tlen, int U, Dilations dil, int halo,
    int tile) {
  using A = act_t<T, kFast>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = tile + halo;
  T* S = reinterpret_cast<T*>(smem);                               // [C][L] stream
  A* Abuf = reinterpret_cast<A*>(S + static_cast<size_t>(C) * L);  // [C][L]
  float* Wsm = reinterpret_cast<float*>(Abuf + static_cast<size_t>(C) * L);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int base = t0 - halo;  // absolute time of column 0
  const T* xb = x + static_cast<size_t>(b) * Tlen * C;
  for (int i = tid; i < L * C; i += kThreads) {
    const int p = i / C, c = i - p * C, t = base + p;
    S[static_cast<size_t>(c) * L + p] =
        (t >= 0 && t < Tlen) ? xb[static_cast<size_t>(t) * C + c] : from_f<T>(0.f);
  }
  run_units<T, kFast, true>(S, Abuf, Wsm, C, L, U, dil, w1, b1, a1, w2, b2, a2, base);
  __syncthreads();
  T* ob = out + static_cast<size_t>(b) * Tlen * C;
  for (int i = tid; i < tile * C; i += kThreads) {
    const int q = i / C, c = i - q * C, t = t0 + q;
    if (t < Tlen) ob[static_cast<size_t>(t) * C + c] = S[static_cast<size_t>(c) * L + halo + q];
  }
}

// The tensor-core instantiation (bf16 x, snake_fast): the float32 unit
// weights come as three bf16 planes, w1p (3, U, 3, C, C) and w2p (3, U, C,
// C); a time step is C contiguous values in device memory and a row of the
// time-major stream, so the tile loads and stores 16 bytes at a time.
__global__ void __launch_bounds__(kThreads, 1) residual_stack_cl_tc_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ out, const bf16* __restrict__ w1p,
    const float* __restrict__ b1, const float* __restrict__ a1, const bf16* __restrict__ w2p,
    const float* __restrict__ b2, const float* __restrict__ a2, int C, int Tlen, int U,
    Dilations dil, int halo, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = tile + halo;
  float* prm = reinterpret_cast<float*>(smem);                      // unit constants
  bf16* S = reinterpret_cast<bf16*>(smem + tc_consts_bytes(C));     // [L][C] stream
  bf16* Abuf = S + static_cast<size_t>(L) * C;    // [L][C]
  bf16* Wsm = Abuf + static_cast<size_t>(L) * C;  // weight stages
  const TmBuf sb(S, C);
  const int n16 = C / 8;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int base = t0 - halo;  // absolute time of row 0
  const bf16* xb = x + static_cast<size_t>(b) * Tlen * C;
  constexpr int kLoads = 4;  // 16-byte loads in flight per thread
  for (int i0 = threadIdx.x; i0 < L * n16; i0 += kLoads * kThreads) {
    uint4 v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = i0 + j * kThreads, p = i / n16, t = base + p;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < L * n16 && t >= 0 && t < Tlen)
        v[j] = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(t) * C + (i - p * n16) * 8);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = i0 + j * kThreads, p = i / n16;
      if (i < L * n16) *reinterpret_cast<uint4*>(S + sb.off(p, i - p * n16)) = v[j];
    }
  }
  const size_t ps1 = static_cast<size_t>(U) * 3 * C * C, ps2 = static_cast<size_t>(U) * C * C;
  run_units_tc<3, true>(S, Abuf, Wsm, prm, C, L, U, dil, w1p, ps1, b1, a1, w2p, ps2, b2, a2, base);
  __syncthreads();
  bf16* ob = out + static_cast<size_t>(b) * Tlen * C;
  for (int i = threadIdx.x; i < tile * n16; i += kThreads) {
    const int q = i / n16, c16 = i - q * n16, t = t0 + q;
    if (t < Tlen)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(t) * C + c16 * 8) =
          *reinterpret_cast<const uint4*>(S + sb.off(halo + q, c16));
  }
}

cudaError_t launch_tc(const void* x, void* out, const void* w1p, const void* b1, const void* a1,
                      const void* w2p, const void* b2, const void* a2, int B, int C, int Tlen,
                      int U, const Dilations& dil, int halo, cudaStream_t stream) {
  if (w1p == nullptr || w2p == nullptr ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorInvalidValue;
  const Plan pl = stack_plan<3>(C, halo, true, true);
  if (pl.tile < 1) return cudaErrorInvalidValue;
  const int tile = pl.tile;
  const size_t smem = pl.smem;
  cudaError_t err = cudaFuncSetAttribute(
      residual_stack_cl_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tlen + tile - 1) / tile, B);
  residual_stack_cl_tc_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const bf16*>(w1p),
      static_cast<const float*>(b1), static_cast<const float*>(a1),
      static_cast<const bf16*>(w2p), static_cast<const float*>(b2),
      static_cast<const float*>(a2), C, Tlen, U, dil, halo, tile);
  return cudaGetLastError();
}

template <typename T, bool kFast>
cudaError_t launch(const void* x, void* out, const void* w1, const void* b1,
                   const void* a1, const void* w2, const void* b2, const void* a2,
                   int B, int C, int Tlen, int U, const Dilations& dil, int halo,
                   cudaStream_t stream) {
  const Plan pl = stack_plan<3>(C, halo, sizeof(T) == sizeof(bf16), kFast);
  if (pl.tile < 1) return cudaErrorInvalidValue;
  const int tile = pl.tile;
  const size_t smem = pl.smem;
  auto kernel = residual_stack_cl_kernel<T, kFast>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tlen + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(a1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(a2), C, Tlen, U, dil, halo, tile);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, T, C) in bf16 (is_bf16) or f32; w1 (U, 3, Cin, Cout) and
// w2 (U, Cin, Cout) f32; b1, a1, b2, a2 (U, C) f32; w1p (3, U, 3, Cin,
// Cout) and w2p (3, U, Cin, Cout): the bf16 planes of w1 and w2, read (and
// required) only by the tensor-core instantiation (bf16 x, snake_fast,
// tc_width(C)), null otherwise; dilations: a host array of U ints. Returns
// the launch's cudaError_t.
extern "C" int nsc_residual_stack_cl(const void* x, void* out, const void* w1,
                                     const void* b1, const void* a1, const void* w2,
                                     const void* b2, const void* a2, const void* w1p,
                                     const void* w2p, const void* dilations, int B, int C,
                                     int Tlen, int U, int is_bf16, int fast, void* stream) {
  Dilations dil{};
  int halo = 0;
  if (!read_dilations(dilations, U, &dil, &halo) || !valid_width(C) || B < 1 || Tlen < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && fast && tc_width(C)) {
    err = launch_tc(x, out, w1p, b1, a1, w2p, b2, a2, B, C, Tlen, U, dil, halo, s);
  } else if (is_bf16) {
    err = fast ? launch<__nv_bfloat16, true>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s)
               : launch<__nv_bfloat16, false>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s);
  } else {
    err = fast ? launch<float, true>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s)
               : launch<float, false>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s);
  }
  return static_cast<int>(err);
}
