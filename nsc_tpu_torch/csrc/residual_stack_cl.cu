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
// 24*B*T*C^2 FLOP. The products are float32 weights times activations, so
// their rate is the float32 rate (67 TFLOP/s), not the bf16 tensor cores':
// at C = 32..256 that bound is operations. This first version computes them
// as SIMT float32 FMAs (stage_units.cuh), K1's scheme.
//
// Design: one block per (batch row, time tile) with a recomputed left halo
// of sum(2d) samples, zeros at t < 0 and the activated input re-zeroed there
// before every unit, so blocks are independent (the TPU kernel's grid ran in
// order; here nothing carries between blocks). With channels last a time
// step is C contiguous values: the tile and its halo load with neighbouring
// threads on neighbouring channels, are transposed into the (C x L) shared
// buffers of the unit chain, and are written back the same way.

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

template <typename T, bool kFast>
cudaError_t launch(const void* x, void* out, const void* w1, const void* b1,
                   const void* a1, const void* w2, const void* b2, const void* a2,
                   int B, int C, int Tlen, int U, const Dilations& dil, int halo,
                   cudaStream_t stream) {
  const size_t elem = sizeof(T) + sizeof(act_t<T, kFast>);
  const int tile = pick_tile(C, halo, elem, stack_smem_bytes(C, 0, elem));
  if (tile < 1) return cudaErrorInvalidValue;
  const size_t smem = stack_smem_bytes(C, tile + halo, elem);
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
// w2 (U, Cin, Cout) f32; b1, a1, b2, a2 (U, C) f32; dilations: a host array
// of U ints. Returns the launch's cudaError_t.
extern "C" int nsc_residual_stack_cl(const void* x, void* out, const void* w1,
                                     const void* b1, const void* a1, const void* w2,
                                     const void* b2, const void* a2,
                                     const void* dilations, int B, int C, int Tlen,
                                     int U, int is_bf16, int fast, void* stream) {
  Dilations dil{};
  int halo = 0;
  if (!read_dilations(dilations, U, &dil, &halo) || !valid_width(C) || B < 1 || Tlen < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
