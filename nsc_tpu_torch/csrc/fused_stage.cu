// One SEANet stage with its boundary convs fused in (K5), for Hopper
// (sm_90a).
//
// Replaces the JAX package's TPU kernel
// nsc_tpu/ops/pallas/residual_stack.py::fused_stage_ct_pallas (body
// _fused_stage_kernel). x is (B, C_in, T_in); the stage runs
//
//   head (optional): h[t'] = T(hb + sum_k hw[k]^T act(x)[S t' + k - (2S-1)]),
//                    k < 2S, t' < T_u = ceil(T_in / S)   (C_in -> C_mid)
//   units:           K1's chain on h (in-kernel snake with the reciprocal),
//                    float32 unit weights
//   tail (optional): out[S u + p] = T(tb + tw[p]^T a[u] + tw[S+p]^T a[u-1]),
//                    a = act(h), a[-1] = 0                (C_mid -> C_out)
//
// and writes (B, C_out, T_u * S_tail) (or (B, C_mid, T_u) without a tail).
// Head and tail weights are in x's type; biases and alphas float32.
// Numerics: see nsc_tpu_torch/kernels/fused_stage.py, whose plain version
// this kernel is held against.
//
// What fusing buys on this card: the stage's input is read once and its
// output written once; the activation and strided-conv intermediates of the
// boundary never reach device memory. What bounds it: the units' products
// (float32 weights: the float32 rate, 67 TFLOP/s) dominate the operations;
// head and tail add 2 C_in C_mid S and 2 C_mid C_out S operations per frame.
// This first version computes every product as SIMT float32 FMAs
// (stage_units.cuh), so it is bound by instruction issue, far above either.
//
// Design: one block per (batch row, tile of T_u frames), with a recomputed
// left halo of sum(2d) frames (+1 with a tail, for a[u-1]), as K1 and K6.
// - The head reads x[c, S t' + k - (2S-1)] straight from device memory: for
//   each chunk of output columns and each group of input channels, the
//   activated samples those columns need are staged in shared memory (a
//   slab of S*nc + S samples per channel), and the GEMM reads them at
//   stride S. No host-side phase decomposition, no frame tensor.
// - Only the two (C_mid x (tile + halo)) unit buffers stay resident; head
//   and tail weights stream through shared memory kKC rows at a time, like
//   the units' weights. Above 48 KB the entry point raises the block's
//   dynamic shared-memory limit.
// - The tail activates the final stream into the activation buffer once,
//   then for each output phase p runs one GEMM over 2 C_mid rows (taps j = 0,
//   1 of phase p, reading columns u and u - 1) and writes out[co, S u + p]
//   straight to its place: no host-side de-interleave.

#include "stage_units.cuh"

namespace {

using namespace nsc_stage;

constexpr size_t kSlabBudget = 16384;  // bytes of the head's sample slab
constexpr int kMaxSlabChannels = 8;

struct StageArgs {
  const void* x;
  void* out;
  const void* hw;  // (2S, C_in, C_mid), x's type; null without a head
  const float* hb;
  const float* ha;
  const float* w1;
  const float* b1;
  const float* a1;
  const float* w2;
  const float* b2;
  const float* a2;
  const float* ta;
  const void* tw;  // (S, 2, C_mid, C_out), x's type; null without a tail
  const float* tb;
  Dilations dil;
  int Cin, Cmid, Cout, Tin, Tu, U, s_head, s_tail, halo, tile;
  int slab_w, slab_c;  // head: samples per staged channel, channels per slab
};

// S[co][p] = T(hb[co] + sum_{k, ci} hw[k][ci][co] act(x[ci, S(base+p) + k - (2S-1)]))
// for every column p < L of the block.
template <typename T, bool kFast>
__device__ void head(const StageArgs& a, const T* __restrict__ xb, T* S, float* Wsm,
                     float* slab, int L, int base) {
  const int C = a.Cmid, st = a.s_head, K = 2 * st;
  const Tiling tl(C);
  const T* hw = static_cast<const T*>(a.hw);
  float acc[kRM][kRN];
  for (int p0 = 0; p0 < L; p0 += tl.nc) {
    const long s0 = static_cast<long>(st) * (base + p0) - (K - 1);  // sample of slab column 0
    zero(acc);
    for (int ci0 = 0; ci0 < a.Cin; ci0 += a.slab_c) {
      const int cn = min(a.slab_c, a.Cin - ci0);
      __syncthreads();  // earlier readers of the slab are done
      for (int i = threadIdx.x; i < cn * a.slab_w; i += kThreads) {
        const int cc = i / a.slab_w, q = i - cc * a.slab_w;
        const long s = s0 + q;
        slab[i] = (s >= 0 && s < a.Tin)
                      ? act<T, kFast, false>(to_f(xb[static_cast<size_t>(ci0 + cc) * a.Tin + s]),
                                             a.ha[ci0 + cc])
                      : 0.f;
      }
      // row r = k * cn + cc: weight row k * C_in + ci0 + cc, samples S p + k
      gemm_tile(acc, hw, K * cn, C, Wsm, tl, L - p0, st,
                [&](int r) { return (r / cn) * a.Cin + ci0 + r % cn; },
                [&](int r) { return slab + (r % cn) * a.slab_w + r / cn; });
    }
    if (!tl.active) continue;
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int co = tl.ty + i * tl.TY;
      const float bias = a.hb[co];
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int p = p0 + tl.tx + j * tl.TX;
        if (p < L) S[static_cast<size_t>(co) * L + p] = from_f<T>(acc[i][j] + bias);
      }
    }
  }
}

// out[co, S (t0+q) + ph] = T(tb[co] + sum_{j, ci} tw[ph][j][ci][co] a[ci, t0+q-j]).
template <typename T, bool kFast>
__device__ void tail(const StageArgs& a, T* S, act_t<T, kFast>* Abuf, float* Wsm, int L,
                     int t0, int base, T* __restrict__ ob) {
  using A = act_t<T, kFast>;
  const int C = a.Cmid, Co = a.Cout, st = a.s_tail;
  __syncthreads();  // the units' last writes to S are done
  for (int i = threadIdx.x; i < C * L; i += kThreads) {
    const int c = i / L, p = i - c * L;
    if (p < a.halo - 1) continue;
    const float v = base + p < 0 ? 0.f : act<T, kFast, false>(to_f(S[i]), a.ta[c]);
    Abuf[i] = from_f<A>(v);
  }
  const Tiling tl(Co);
  const T* tw = static_cast<const T*>(a.tw);
  const size_t row_len = static_cast<size_t>(a.Tu) * st;
  float acc[kRM][kRN];
  for (int ph = 0; ph < st; ++ph) {
    const T* w = tw + static_cast<size_t>(ph) * 2 * C * Co;
    for (int p0 = a.halo; p0 < L; p0 += tl.nc) {
      zero(acc);
      gemm_tile(acc, w, 2 * C, Co, Wsm, tl, L - p0, 1, [](int r) { return r; },
                [&](int r) {
                  const int j = r / C, ci = r - j * C;
                  return Abuf + static_cast<size_t>(ci) * L + p0 - j;
                });
      if (!tl.active) continue;
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int co = tl.ty + i * tl.TY;
        const float bias = a.tb[co];
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const int p = p0 + tl.tx + j * tl.TX;
          const int t = t0 + p - a.halo;
          if (p < L && t < a.Tu)
            ob[co * row_len + static_cast<size_t>(t) * st + ph] = from_f<T>(acc[i][j] + bias);
        }
      }
    }
  }
}

template <typename T, bool kFast>
__global__ void __launch_bounds__(kThreads) fused_stage_kernel(const StageArgs a) {
  using A = act_t<T, kFast>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.Cmid, L = a.tile + a.halo;
  T* S = reinterpret_cast<T*>(smem);                               // [C][L] stream
  A* Abuf = reinterpret_cast<A*>(S + static_cast<size_t>(C) * L);  // [C][L]
  float* Wsm = reinterpret_cast<float*>(Abuf + static_cast<size_t>(C) * L);
  float* slab = Wsm + kKC * max(C, a.Cout);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * a.tile;
  const int base = t0 - a.halo;  // frame of column 0
  const T* xb = static_cast<const T*>(a.x) + static_cast<size_t>(b) * a.Cin * a.Tin;
  if (a.s_head > 0) {
    head<T, kFast>(a, xb, S, Wsm, slab, L, base);
  } else {
    for (int i = threadIdx.x; i < C * L; i += kThreads) {
      const int c = i / L, p = i - c * L, t = base + p;
      S[i] = (t >= 0 && t < a.Tin) ? xb[static_cast<size_t>(c) * a.Tin + t] : from_f<T>(0.f);
    }
  }
  run_units<T, kFast, false>(S, Abuf, Wsm, C, L, a.U, a.dil, a.w1, a.b1, a.a1, a.w2, a.b2,
                             a.a2, base);
  const int Co = a.s_tail > 0 ? a.Cout : C;
  T* ob = static_cast<T*>(a.out) +
          static_cast<size_t>(b) * Co * a.Tu * (a.s_tail > 0 ? a.s_tail : 1);
  if (a.s_tail > 0) {
    tail<T, kFast>(a, S, Abuf, Wsm, L, t0, base, ob);
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < C * a.tile; i += kThreads) {
      const int c = i / a.tile, q = i - c * a.tile, t = t0 + q;
      if (t < a.Tu) ob[static_cast<size_t>(c) * a.Tu + t] = S[static_cast<size_t>(c) * L + a.halo + q];
    }
  }
}

template <typename T, bool kFast>
cudaError_t launch(StageArgs a, int B, cudaStream_t stream) {
  const size_t elem = sizeof(T) + sizeof(act_t<T, kFast>);
  size_t extra = static_cast<size_t>(kKC) * (a.Cmid > a.Cout ? a.Cmid : a.Cout) * sizeof(float);
  if (a.s_head > 0) {
    const int nc = kThreads / (a.Cmid / kRM) * kRN;  // Tiling(C_mid).nc
    a.slab_w = a.s_head * nc + a.s_head;
    const size_t per_channel = static_cast<size_t>(a.slab_w) * sizeof(float);
    a.slab_c = static_cast<int>(kSlabBudget / per_channel);
    a.slab_c = a.slab_c < 1 ? 1 : (a.slab_c > kMaxSlabChannels ? kMaxSlabChannels : a.slab_c);
    extra += a.slab_c * per_channel;
  }
  a.tile = pick_tile(a.Cmid, a.halo, elem, extra);
  if (a.tile < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(a.Cmid) * (a.tile + a.halo) * elem + extra;
  auto kernel = fused_stage_kernel<T, kFast>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tu + a.tile - 1) / a.tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (B, C_in, T_in); out: (B, C_out, ceil(T_in/s_head) * s_tail), both bf16
// (is_bf16) or f32. Head (s_head > 0; else null pointers and C_in == C_mid):
// hw (2 s_head, C_in, C_mid) in x's type, hb (C_mid,), ha (C_in,) f32.
// Units: w1 (U, 3, C_mid, C_mid), w2 (U, C_mid, C_mid), b1, a1, b2, a2
// (U, C_mid) f32. Tail (s_tail > 0; else null pointers and C_out == C_mid):
// ta (C_mid,) f32, tw (s_tail, 2, C_mid, C_out) in x's type, tb (C_out,) f32.
// dilations: a host array of U ints. Returns the launch's cudaError_t.
extern "C" int nsc_fused_stage(const void* x, void* out, const void* hw, const void* hb,
                               const void* ha, const void* w1, const void* b1,
                               const void* a1, const void* w2, const void* b2,
                               const void* a2, const void* ta, const void* tw,
                               const void* tb, const void* dilations, int B, int Cin,
                               int Cmid, int Cout, int Tin, int U, int s_head,
                               int s_tail, int is_bf16, int fast, void* stream) {
  StageArgs a{};
  int units_halo = 0;
  if (!read_dilations(dilations, U, &a.dil, &units_halo) || !valid_width(Cmid) ||
      !valid_width(Cout) || B < 1 || Cin < 1 || Tin < 1 || s_head < 0 || s_tail < 0 ||
      (s_head > 0) != (hw != nullptr && hb != nullptr && ha != nullptr) ||
      (s_tail > 0) != (ta != nullptr && tw != nullptr && tb != nullptr) ||
      (s_head == 0 && Cin != Cmid) || (s_tail == 0 && Cout != Cmid))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.out = out;
  a.hw = hw;
  a.hb = static_cast<const float*>(hb);
  a.ha = static_cast<const float*>(ha);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.a1 = static_cast<const float*>(a1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.a2 = static_cast<const float*>(a2);
  a.ta = static_cast<const float*>(ta);
  a.tw = tw;
  a.tb = static_cast<const float*>(tb);
  a.Cin = Cin;
  a.Cmid = Cmid;
  a.Cout = Cout;
  a.Tin = Tin;
  a.Tu = s_head > 0 ? (Tin + s_head - 1) / s_head : Tin;
  a.U = U;
  a.s_head = s_head;
  a.s_tail = s_tail;
  a.halo = units_halo + (s_tail > 0 ? 1 : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = fast ? launch<__nv_bfloat16, true>(a, B, s) : launch<__nv_bfloat16, false>(a, B, s);
  } else {
    err = fast ? launch<float, true>(a, B, s) : launch<float, false>(a, B, s);
  }
  return static_cast<int>(err);
}
