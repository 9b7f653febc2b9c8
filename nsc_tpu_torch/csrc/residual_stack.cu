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
// wide ones are bound by arithmetic at the bf16 tensor-core rate.
//
// Design against that bound: one block owns one (batch row, time tile). It
// loads the tile plus a left halo of sum(2d) samples (zeros for t < 0) into
// shared memory once, runs all units there (the unit chain of
// stage_units.cuh, conv1 in place from right to left), and writes
// only its own tile, so x crosses device memory exactly twice per stage,
// and the intermediate activations never do. In bf16 serving (snake_fast,
// C % 16 == 0) the chain runs on the tensor cores: the tile is transposed
// into a time-major buffer at the load and back at the store, through
// shared memory, and each product is one bf16 mma.sync. Every other
// instantiation runs the SIMT chain on (C x L) buffers (see
// stage_units.cuh). Either way the activated input is re-zeroed at t < 0
// before every unit: the residual stream there holds W2.act(b1)+b2 after
// the first unit, and the reference conv pads its activated input with
// zeros. Blocks are independent (no carry between time
// tiles), unlike the TPU kernel's sequential grid.

#include "stage_units.cuh"

namespace {

using namespace nsc_stage;

template <typename T, bool kFast>
__global__ void __launch_bounds__(kThreads) residual_stack_kernel(
    const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ a1,
    const T* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ a2, int C, int Tlen, int U, Dilations dil,
    int halo, int tile) {
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
  const T* xb = x + static_cast<size_t>(b) * C * Tlen;
  for (int i = tid; i < C * L; i += kThreads) {
    const int c = i / L, p = i - c * L, t = base + p;
    S[i] = (t >= 0 && t < Tlen) ? xb[static_cast<size_t>(c) * Tlen + t] : from_f<T>(0.f);
  }
  run_units<T, kFast, false>(S, Abuf, Wsm, C, L, U, dil, w1, b1, a1, w2, b2, a2, base);
  __syncthreads();
  T* ob = out + static_cast<size_t>(b) * C * Tlen;
  for (int i = tid; i < C * tile; i += kThreads) {
    const int c = i / tile, q = i - c * tile, t = t0 + q;
    if (t < Tlen) ob[static_cast<size_t>(c) * Tlen + t] = S[static_cast<size_t>(c) * L + halo + q];
  }
}

// The tensor-core instantiation (bf16 x and weights, snake_fast): the tile
// is transposed into the time-major stream on the way in and out, through
// shared memory, with neighbouring threads on neighbouring times in device
// memory.
__global__ void __launch_bounds__(kThreads, 1) residual_stack_tc_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ out, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ a1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ a2, int C, int Tlen, int U,
    Dilations dil, int halo, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = tile + halo;
  float* prm = reinterpret_cast<float*>(smem);                      // unit constants
  bf16* S = reinterpret_cast<bf16*>(smem + tc_consts_bytes(C));     // [L][C] stream
  bf16* Abuf = S + static_cast<size_t>(L) * C;    // [L][C]
  bf16* Wsm = Abuf + static_cast<size_t>(L) * C;  // weight stages
  const TmBuf sb(S, C);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int base = t0 - halo;  // absolute time of row 0
  const bf16* xb = x + static_cast<size_t>(b) * C * Tlen;
  load_ct_tile(sb, xb, C, L, Tlen, base);
  run_units_tc<1, false>(S, Abuf, Wsm, prm, C, L, U, dil, w1, 0, b1, a1, w2, 0, b2, a2, base);
  __syncthreads();
  bf16* ob = out + static_cast<size_t>(b) * C * Tlen;
  for (int i = threadIdx.x; i < C * tile; i += kThreads) {
    const int c = i / tile, q = i - c * tile, t = t0 + q;
    if (t < Tlen) ob[static_cast<size_t>(c) * Tlen + t] = *sb.at(halo + q, c);
  }
}

cudaError_t launch_tc(const void* x, void* out, const void* w1, const void* b1, const void* a1,
                      const void* w2, const void* b2, const void* a2, int B, int C, int Tlen,
                      int U, const Dilations& dil, int halo, cudaStream_t stream) {
  const Plan pl = stack_plan<1>(C, halo, true, true);
  if (pl.tile < 1) return cudaErrorInvalidValue;
  const int tile = pl.tile;
  const size_t smem = pl.smem;
  cudaError_t err = cudaFuncSetAttribute(
      residual_stack_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tlen + tile - 1) / tile, B);
  residual_stack_tc_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(a1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(a2), C, Tlen, U, dil, halo, tile);
  return cudaGetLastError();
}

template <typename T, bool kFast>
cudaError_t launch(const void* x, void* out, const void* w1, const void* b1,
                   const void* a1, const void* w2, const void* b2,
                   const void* a2, int B, int C, int Tlen, int U,
                   const Dilations& dil, int halo, cudaStream_t stream) {
  const Plan pl = stack_plan<1>(C, halo, sizeof(T) == sizeof(bf16), kFast);
  if (pl.tile < 1) return cudaErrorInvalidValue;
  const int tile = pl.tile;
  const size_t smem = pl.smem;
  auto kernel = residual_stack_kernel<T, kFast>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tlen + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
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
  Dilations dil{};
  int halo = 0;
  if (!read_dilations(dilations, U, &dil, &halo) || !valid_width(C) || B < 1 || Tlen < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && fast && tc_width(C)) {
    err = launch_tc(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s);
  } else if (is_bf16) {
    err = fast ? launch<__nv_bfloat16, true>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s)
               : launch<__nv_bfloat16, false>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s);
  } else {
    err = fast ? launch<float, true>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s)
               : launch<float, false>(x, out, w1, b1, a1, w2, b2, a2, B, C, Tlen, U, dil, halo, s);
  }
  return static_cast<int>(err);
}

// The plan of a K1 (planes 1) or K6 (planes 3) launch at width C and halo
// sum(2d): plan[0] the time tile (0: the stage does not fit one block),
// plan[1] the block's shared-memory bytes. Host only; for the tests that
// hold the wrappers' planner to the kernels'.
extern "C" int nsc_stack_plan(int C, int halo, int is_bf16, int fast, int planes,
                              long long* plan) {
  if (!valid_width(C) || halo < 0 || (planes != 1 && planes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = planes == 3 ? stack_plan<3>(C, halo, is_bf16, fast)
                             : stack_plan<1>(C, halo, is_bf16, fast);
  plan[0] = p.tile;
  plan[1] = static_cast<long long>(p.smem);
  return 0;
}
