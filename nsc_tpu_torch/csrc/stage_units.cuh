// Device building blocks of the SEANet stage kernels K1
// (residual_stack.cu), K5 (fused_stage.cu) and K6 (residual_stack_cl.cu),
// for Hopper (sm_90a): the in-kernel activations and two residual-unit
// chains, one on the tensor cores and one on the SIMT pipe.
//
// Unit chain, for each unit u with dilation d, over the stream S:
//
//   S += T(W2[u] . act(T(W1[u] *_d act(S) + b1[u])) + b2[u])
//
// *_d is a causal dilated k=3 conv whose activated input is zero at t < 0.
// Each unit's valid region shrinks by 2d from the left; conv1's output
// overwrites its own input buffer in place, in chunks from right to left
// (a causal conv reads only times at or left of the one it writes).
//
// Which instantiation takes which chain (a static rule, decided at launch
// from the dtype, the activation and the widths, never by a failed launch):
//
//  * Tensor cores (`run_units_tc`): bf16 x with snake_fast, whose
//    activations are bf16, at widths C % 16 == 0 and 16 <= C <= 256 (every
//    base_fast stage). Products are mma.sync m16n8k16 bf16 x bf16 -> f32,
//    fragments loaded with ldmatrix, weight chunks double-buffered into
//    shared memory with cp.async. The stream and the activations are
//    time-major (L x C) buffers, 16-byte chunks XOR-swizzled by row, so a
//    tap shift by d is a row offset and ldmatrix is conflict-free. bf16
//    weights (K1) take one MMA per product; float32 weights (K5, K6) are
//    split on the host into three bf16 planes hi + mid + lo == w, and three
//    MMAs into one float32 accumulator give the float32 product exactly
//    (a bf16 x bf16 product is exact in float32), so only the summation
//    order differs from the SIMT chain. The chain is templated on the
//    number of planes.
//  * SIMT (`run_units`): every other instantiation: float32 x (the float32
//    contract: no tensor cores, no TF32), snake with float32 activations,
//    and widths the tensor-core rule does not take. A register-tiled float32
//    GEMM on (C x L) buffers whose weight rows are staged through shared
//    memory; it is general over the weight rows' order, the activation
//    operand's column stride and the number of output rows, so K5's strided
//    head and transposed tail use it too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
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
// snake_fast with its per-channel constant r precomputed: r = alpha + eps
// with kDiv, else its reciprocal (`act_const`).
template <typename T, bool kDiv>
__device__ __forceinline__ float act_fast(float x, float alpha, float r) {
  const float sq = sin_sq_poly(__fmul_rn(alpha, x));
  const float term = kDiv ? __fdiv_rn(sq, r) : __fmul_rn(sq, r);
  return round_to<T>(__fadd_rn(x, round_to<T>(term)));
}

// __frcp_rn is 1/den correctly rounded, as __fdiv_rn(1.0f, den)
template <bool kDiv>
__device__ __forceinline__ float act_const(float alpha) {
  const float den = __fadd_rn(alpha, kEps);
  return kDiv ? den : __frcp_rn(den);
}

template <typename T, bool kFast, bool kDiv>
__device__ __forceinline__ float act(float x, float alpha) {
  if constexpr (kFast) {
    return act_fast<T, kDiv>(x, alpha, act_const<kDiv>(alpha));
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

// ---------------------------------------------------------------------------
// The tensor-core chain.

using bf16 = __nv_bfloat16;
struct alignas(4) Bf16x2 {
  bf16 x, y;
};

constexpr int kWarps = kThreads / 32;
constexpr int kNJ = 4;    // n8 tiles per warp, at most (32 output channels)
constexpr int kMIu = 4;   // m16 tiles per warp in the unit products
constexpr int kMIh = 2;   // ... in K5's head
constexpr int kMIt = 1;   // ... in K5's tail (its phases are staged whole)
constexpr int kKCe = 64;  // weight rows per pipeline stage of K5's head and tail

// Weight rows per pipeline stage of the units: 32, except 16 with three
// planes above C = 128 (a stage's buffer then holds 48 rows of C + 8).
__host__ __device__ inline int units_kc(int planes, int C) {
  return planes == 3 && C > 128 ? 16 : 32;
}

// PTX: begin
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Four 8x8 bf16 matrices; lanes 8j..8j+7 give matrix j's row addresses.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// PTX: end

// A time-major bf16 buffer: row r holds the C channels of one time step.
// Its 16-byte chunks are XOR-swizzled within aligned groups of g chunks
// (g the largest power of two <= 8 dividing C/8), keyed on the row, so the
// 8 rows of an ldmatrix or of an epilogue store fall in 8 bank groups.
struct TmBuf {
  bf16* p;
  int C, sh, gm;
  __device__ __forceinline__ TmBuf(bf16* p_, int C_) : p(p_), C(C_) {
    const int n16 = C_ / 8;
    const int g = min(8, n16 & -n16);
    gm = g - 1;
    sh = g == 8 ? 0 : (g == 4 ? 1 : 2);
  }
  // element offset of chunk c16 (channels 8 c16 .. 8 c16 + 7) of row r
  __device__ __forceinline__ int off(int r, int c16) const {
    return r * C + ((c16 ^ ((r >> sh) & gm)) << 3);
  }
  __device__ __forceinline__ bf16* at(int r, int col) const {
    return p + off(r, col >> 3) + (col & 7);
  }
};

// How 8 warps cover an (mt x N) output chunk: WN warps over N (kNJ n8 tiles
// each, the last one fewer), WM = 8 / WN over rows (MI m16 tiles each).
// Warps past WM * WN only help stage weights.
template <int MI>
struct TcTiling {
  int wm, n0, nj, mt;
  bool active;
  __device__ __forceinline__ explicit TcTiling(int N) {
    const int n8 = N / 8, WN = (n8 + kNJ - 1) / kNJ, WM = kWarps / WN;
    const int warp = threadIdx.x / 32, wn = warp % WN;
    wm = warp / WN;
    active = wm < WM;
    n0 = wn * kNJ * 8;
    nj = min(kNJ, n8 - wn * kNJ);
    mt = WM * 16 * MI;
  }
};

struct WStage {
  const bf16* src;  // row 0 of plane 0 of this stage's weight rows
  size_t pstride;   // elements from one plane to the next
  int kn;           // rows (a multiple of 16)
};

// cp.async of PL planes x kn rows x N bf16 weights into a stage buffer of
// PL x kc rows, each row padded to N + 8 (conflict-free ldmatrix.trans).
template <int PL>
__device__ __forceinline__ void stage_weights(bf16* dst, const WStage& w, int N, int kc) {
  const int cpr = N / 8, per_plane = w.kn * cpr;
  for (int i = threadIdx.x; i < PL * per_plane; i += kThreads) {
    const int pl = i / per_plane, rem = i - pl * per_plane, r = rem / cpr, c = rem - r * cpr;
    cp_async16(dst + (pl * kc + r) * (N + 8) + c * 8,
               w.src + pl * w.pstride + static_cast<size_t>(r) * N + c * 8);
  }
  cp_async_commit();
}

// The products of one staged chunk of kn weight rows: for each k16 step,
// the warp's MI A fragments (aaddr(ks, m, h): row m of the chunk, channels
// 8h..8h+7 of the step) times each plane's B fragments, into acc.
template <int PL, int MI, typename AAddr>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][kNJ][4], const bf16* wbuf, int kn,
                                          int kc, int N, const TcTiling<MI>& tl, AAddr aaddr) {
  const int lane = threadIdx.x % 32;
  for (int ks = 0; ks < kn / 16; ++ks) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4(a[mi], aaddr(ks, tl.wm * 16 * MI + mi * 16 + (lane & 15), lane >> 4));
#pragma unroll
    for (int pl = 0; pl < PL; ++pl) {
      uint32_t b[kNJ][2];
      const int j4 = lane >> 3;
      const bf16* wrow = wbuf + (pl * kc + ks * 16 + (j4 & 1) * 8 + (lane & 7)) * (N + 8) + tl.n0 +
                         (j4 >> 1) * 8;
#pragma unroll
      for (int jp = 0; jp < kNJ / 2; ++jp) {
        if (2 * jp < tl.nj) {
          uint32_t r[4];
          ldsm_x4_t(r, wrow + jp * 16);
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          if (j < tl.nj) mma_bf16(acc[mi][j], a[mi], b[j][0], b[j][1]);
    }
  }
}

// Where the weight-stage pipeline stands between tc_gemm calls: `buf` is
// the buffer the next call's stage 0 is (or will be) staged in; `primed`
// says it was already issued by the previous call.
struct Pipe {
  int buf = 0;
  bool primed = false;
};

// acc += the product of one output chunk over nst weight stages, through a
// double-buffered cp.async pipeline in Wsm (2 x PL x kc x (N + 8)). wsrc(s)
// gives stage s's weights; fill(s), run by every thread once every warp is
// done with stage s-1, may write shared memory that stage s reads and
// returns whether it did; aaddr(s, ks, m, h) as in mma_stage. With `next`
// (stage 0 of the following call, which must have the same PL, kc and N),
// the last stage prefetches it, so that call starts without waiting. Every
// thread of the block must call it (it synchronises). The caller
// synchronises before overwriting what the last stage read.
template <int PL, int MI, typename WSrc, typename Fill, typename AAddr>
__device__ __forceinline__ void tc_gemm(float (&acc)[MI][kNJ][4], bf16* Wsm, int N, int kc,
                                        int nst, const TcTiling<MI>& tl, WSrc wsrc, Fill fill,
                                        AAddr aaddr, Pipe& pipe, const WStage* next) {
  const int buf = PL * kc * (N + 8);
  if (!pipe.primed) {
    __syncthreads();  // earlier readers of Wsm are done
    stage_weights<PL>(Wsm + pipe.buf * buf, wsrc(0), N, kc);
  }
  for (int s = 0; s < nst; ++s) {
    const int b = (pipe.buf + s) & 1;
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with stage s-1
    if (fill(s)) __syncthreads();
    if (s + 1 < nst)
      stage_weights<PL>(Wsm + (b ^ 1) * buf, wsrc(s + 1), N, kc);
    else if (next != nullptr)
      stage_weights<PL>(Wsm + (b ^ 1) * buf, *next, N, kc);
    if (tl.active)
      mma_stage<PL, MI>(acc, Wsm + b * buf, wsrc(s).kn, kc, N, tl,
                            [&](int ks, int m, int h) { return aaddr(s, ks, m, h); });
  }
  pipe.buf = (pipe.buf + nst) & 1;
  pipe.primed = next != nullptr;
}

template <int MI>
__device__ __forceinline__ void zero(float (&acc)[MI][kNJ][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
}

// f(m, n, v0, v1) for each pair of accumulators of this thread (by
// reference): chunk row m, output channels n and n + 1 (n even).
template <int MI, typename F>
__device__ __forceinline__ void for_acc(float (&acc)[MI][kNJ][4], const TcTiling<MI>& tl,
                                        F f) {
  if (!tl.active) return;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      if (j >= tl.nj) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(tl.wm * 16 * MI + mi * 16 + (lane >> 2) + 8 * h, tl.n0 + j * 8 + 2 * (lane & 3),
          acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
    }
}

// Floats of the per-unit constants table of run_units_tc: per channel the
// two alphas, their act_const, and the two biases.
constexpr int kUnitConsts = 6;

// The residual units on the time-major stream S (L x C, bf16), row p at
// absolute time base + p, valid from row 0; Abuf (L x C) holds the
// activations; Wsm the weight stages; prm kUnitConsts x C floats for the
// current unit's constants. Weights w1 (U, 3, Cin, Cout) and w2 (U, Cin,
// Cout) in PL bf16 planes `ps1` / `ps2` elements apart; the (U, C) biases
// and alphas float32. snake_fast only (bf16 activations); kDiv as in `act`.
// Epilogues compute every accumulator's activation before their predicated
// stores, so the independent chains can overlap. Returns the first valid
// row.
template <int PL, bool kDiv>
__device__ int run_units_tc(bf16* Sp, bf16* Ap, bf16* Wsm, float* prm, int C, int L, int U,
                            const Dilations& dil, const bf16* __restrict__ w1, size_t ps1,
                            const float* __restrict__ b1, const float* __restrict__ a1,
                            const bf16* __restrict__ w2, size_t ps2,
                            const float* __restrict__ b2, const float* __restrict__ a2,
                            int base) {
  const int KC = units_kc(PL, C);
  const TmBuf S(Sp, C), A(Ap, C);
  const TcTiling<kMIu> tl(C);
  const int n16 = C / 8;
  float acc[kMIu][kNJ][4];
  Pipe pipe;
  int start = 0;
  for (int u = 0; u < U; ++u) {
    const int d = dil.d[u];
    const int ostart = start + 2 * d;
    float* alpha1 = prm;
    float* r1 = prm + C;
    float* alpha2 = prm + 2 * C;
    float* r2 = prm + 3 * C;
    float* bias1 = prm + 4 * C;
    float* bias2 = prm + 5 * C;
    __syncthreads();  // every reader of the last unit's constants and buffers is done
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float v1 = a1[u * C + c], v2 = a2[u * C + c];
      alpha1[c] = v1;
      r1[c] = act_const<kDiv>(v1);
      alpha2[c] = v2;
      r2[c] = act_const<kDiv>(v2);
      bias1[c] = b1[u * C + c];
      bias2[c] = b2[u * C + c];
    }
    __syncthreads();
    // act1 of the stream, zero at t < 0 (the conv's zero padding)
    for (int i = threadIdx.x; i < L * n16; i += kThreads) {
      const int r = i / n16, c16 = i - r * n16;
      if (r < start) continue;
      const int o = S.off(r, c16);
      uint4 raw = *reinterpret_cast<const uint4*>(Sp + o);
      const bf16* in = reinterpret_cast<const bf16*>(&raw);
      uint4 res;
      bf16* outv = reinterpret_cast<bf16*>(&res);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c16 * 8 + e;
        const float v = act_fast<bf16, kDiv>(to_f(in[e]), alpha1[c], r1[c]);
        outv[e] = from_f<bf16>(base + r < 0 ? 0.f : v);
      }
      *reinterpret_cast<uint4*>(Ap + o) = res;
    }
    // conv1 + b1 -> bf16 -> act2, in place, chunks right to left
    const int nchunk = (L - ostart + tl.mt - 1) / tl.mt;
    const bf16* w1u = w1 + static_cast<size_t>(u) * 3 * C * C;
    const bf16* w2u = w2 + static_cast<size_t>(u) * C * C;
    const int k1 = 3 * C;
    // the first stage of conv1 and of conv2, prefetched by the call before
    const WStage first1{w1u, ps1, min(KC, k1)}, first2{w2u, ps2, min(KC, C)};
    const WStage next_unit{w1u + 3 * static_cast<size_t>(C) * C, ps1, min(KC, k1)};
    for (int ch = nchunk - 1; ch >= 0; --ch) {
      const int p0 = ostart + ch * tl.mt;
      zero(acc);
      tc_gemm<PL, kMIu>(
          acc, Wsm, C, KC, (k1 + KC - 1) / KC, tl,
          [&](int s) { return WStage{w1u + static_cast<size_t>(s) * KC * C, ps1, min(KC, k1 - s * KC)}; },
          [](int) { return false; },
          [&](int s, int ks, int m, int h) {
            const int k = s * KC + ks * 16, tap = k / C, ci = k - tap * C;
            const int r = min(p0 + m - (2 - tap) * d, L - 1);
            return Ap + A.off(r, (ci >> 3) + h);
          },
          pipe, ch > 0 ? &first1 : &first2);
      // act2 of every accumulator first (rows past L are computed, not stored)
      for_acc(acc, tl, [&](int m, int n, float& v0, float& v1) {
        v0 = act_fast<bf16, kDiv>(round_to<bf16>(v0 + bias1[n]), alpha2[n], r2[n]);
        v1 = act_fast<bf16, kDiv>(round_to<bf16>(v1 + bias1[n + 1]), alpha2[n + 1], r2[n + 1]);
      });
      __syncthreads();  // every read of this chunk's inputs is done
      for_acc(acc, tl, [&](int m, int n, float& v0, float& v1) {
        if (p0 + m < L)
          *reinterpret_cast<Bf16x2*>(A.at(p0 + m, n)) = Bf16x2{from_f<bf16>(v0), from_f<bf16>(v1)};
      });
    }
    // conv2 + b2 -> bf16, added to the stream in bf16
    for (int ch = 0; ch < nchunk; ++ch) {
      const int p0 = ostart + ch * tl.mt;
      zero(acc);
      tc_gemm<PL, kMIu>(
          acc, Wsm, C, KC, (C + KC - 1) / KC, tl,
          [&](int s) { return WStage{w2u + static_cast<size_t>(s) * KC * C, ps2, min(KC, C - s * KC)}; },
          [](int) { return false; },
          [&](int s, int ks, int m, int h) {
            const int r = min(p0 + m, L - 1);
            return Ap + A.off(r, ((s * KC + ks * 16) >> 3) + h);
          },
          pipe, ch + 1 < nchunk ? &first2 : (u + 1 < U ? &next_unit : nullptr));
      for_acc(acc, tl, [&](int m, int n, float& v0, float& v1) {
        const int p = p0 + m;
        if (p >= L) return;
        Bf16x2& sv = *reinterpret_cast<Bf16x2*>(S.at(p, n));
        sv = Bf16x2{from_f<bf16>(__fadd_rn(to_f(sv.x), round_to<bf16>(v0 + bias2[n]))),
                    from_f<bf16>(__fadd_rn(to_f(sv.y), round_to<bf16>(v1 + bias2[n + 1])))};
      });
    }
    start = ostart;
  }
  return start;
}

// Loads a (C x L) tile of a (C, T) bf16 row into the time-major buffer `sb`:
// element (c, p) is xb[c * Tlen + base + p], zero outside [0, Tlen). Each
// thread keeps kLoads global loads in flight before it stores.
__device__ __forceinline__ void load_ct_tile(const TmBuf& sb, const bf16* __restrict__ xb, int C,
                                             int L, int Tlen, int base) {
  constexpr int kLoads = 8;
  const int n = C * L;
  for (int i0 = threadIdx.x; i0 < n; i0 += kLoads * kThreads) {
    bf16 v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = i0 + j * kThreads, c = i / L, t = base + i - c * L;
      v[j] = (i < n && t >= 0 && t < Tlen) ? xb[static_cast<size_t>(c) * Tlen + t]
                                           : from_f<bf16>(0.f);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = i0 + j * kThreads, c = i / L;
      if (i < n) *sb.at(i - c * L, c) = v[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Host-side planning (mirrored by the wrappers' Python planner).

// Whether a width takes the tensor-core chain (with bf16 x and snake_fast).
inline bool tc_width(int n) { return n >= 16 && n <= 256 && n % 16 == 0; }

// Rows of one output chunk of TcTiling<MI>(n).
inline int tc_rows(int n, int mi) {
  const int wn = (n / 8 + kNJ - 1) / kNJ;
  return kWarps / wn * 16 * mi;
}

// Time tile of a tensor-core kernel beside `extra` bytes: its registers
// allow one block per SM, so rows L = tile + halo take the whole 227 KB (at
// most 1024 + halo). Of that L and the largest 2 + k * (units' chunk rows)
// below it, the one whose first unit computes the fewest rows per output is
// taken. 0 if not even one output fits.
inline int tc_pick_tile(int C, int halo, size_t extra) {
  if (extra >= 232448) return 0;
  long rows = static_cast<long>((232448 - extra) / (2 * sizeof(bf16) * C));
  if (rows > 1024 + halo) rows = 1024 + halo;
  if (rows - halo < 1) return 0;
  const int mt = tc_rows(C, kMIu);
  const long aligned = (rows - 2) / mt * mt + 2;
  const long cost_rows = (rows - 2 + mt - 1) / mt * mt;  // chunk rows computed
  const long cost_aligned = aligned - 2;
  if (aligned - halo >= 1 && (aligned - halo) * cost_rows > (rows - halo) * cost_aligned)
    rows = aligned;
  return static_cast<int>(rows - halo);
}

// Bytes of run_units_tc's constants table.
__host__ __device__ inline size_t tc_consts_bytes(int C) { return kUnitConsts * static_cast<size_t>(C) * sizeof(float); }

// Bytes of a double-buffered weight stage of `planes` x kc rows of n.
inline size_t tc_wbuf_bytes(int planes, int kc, int n) {
  return 2 * static_cast<size_t>(planes) * kc * (n + 8) * sizeof(bf16);
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

// Dynamic shared memory of a tensor-core stack kernel (K1, K6): the stream
// and the activations, L x C bf16 each, and the weight stages of PL planes.
template <int PL>
inline size_t tc_stack_smem_bytes(int C, int L) {
  return 2 * static_cast<size_t>(C) * L * sizeof(bf16) + tc_wbuf_bytes(PL, units_kc(PL, C), C) +
         tc_consts_bytes(C);
}

// A launch's plan: the time tile (0 where not even one output fits) and
// the block's dynamic shared memory.
struct Plan {
  int tile;
  size_t smem;
};

// The plan of a stack kernel, K1 (PL = 1: bf16 weights) or K6 (PL = 3:
// float32 weights as bf16 planes): the tensor-core chain for bf16 x with
// snake_fast at tc_width(C), the SIMT chain with elem_bytes = x's type plus
// the activations' (x's type with snake_fast, float32 with snake) for every
// other case. The wrappers' Python planner (`kernels/residual_stack.py::
// stack_plan`) restates it; `nsc_stack_plan` lets a test hold the two equal.
template <int PL>
inline Plan stack_plan(int C, int halo, bool is_bf16, bool fast) {
  Plan p{};
  if (is_bf16 && fast && tc_width(C)) {
    p.tile = tc_pick_tile(C, halo, tc_stack_smem_bytes<PL>(C, 0));
    p.smem = tc_stack_smem_bytes<PL>(C, p.tile + halo);
  } else {
    const size_t elem = (is_bf16 ? sizeof(bf16) : sizeof(float)) +
                        (is_bf16 && fast ? sizeof(bf16) : sizeof(float));
    p.tile = pick_tile(C, halo, elem, stack_smem_bytes(C, 0, elem));
    p.smem = stack_smem_bytes(C, p.tile + halo, elem);
  }
  return p;
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
