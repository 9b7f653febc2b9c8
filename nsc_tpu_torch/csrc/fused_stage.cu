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
// boundary never reach device memory. What bounds it: operations. The
// units' products have float32 weights; in bf16 serving each is three bf16
// MMAs (the weight split into planes hi + mid + lo, exact in float32), so
// 3 x 24 C_mid^2 per frame at the bf16 tensor-core rate; head and tail add
// 2 C_in C_mid 2S and 2 C_mid C_out 2S operations per frame in bf16, one MMA
// each.
//
// Design: one block per (batch row, tile of T_u frames), with a recomputed
// left halo of sum(2d) frames (+1 with a tail, for a[u-1]), as K1 and K6.
// In bf16 serving (snake_fast, widths multiples of 16) every product runs on
// the tensor cores (stage_units.cuh), on time-major buffers:
// - The head reads x[c, S t' + k - (2S-1)] straight from device memory: per
//   chunk of output frames and group of 32 input channels, the activated
//   samples those frames read are staged time-major in a slab; the A
//   operand of tap k is the slab's rows S t' + k, one ldmatrix row address
//   each. No im2col copy, no host-side phase decomposition.
// - The tail activates the final stream once; per chunk of frames each
//   output phase p is one GEMM over 2 C_mid rows (taps p and S+p, rows u
//   and u-1, a one-row shift), staged in shared memory; then every output
//   channel's S * frames samples are written as one contiguous run.
// - Only the two (tile + halo) x C_mid unit buffers stay resident; head,
//   unit and tail weights stream through double-buffered cp.async stages.
// Every other instantiation (float32, snake, other widths) runs the SIMT
// chain on (C x L) buffers: the head's slab is channel-major and read at
// stride S, the tail writes each phase to out[co, S u + p] in place.

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
  const bf16* w1p;  // (3, U, 3, C_mid, C_mid) bf16 planes of w1; tensor cores only
  const bf16* w2p;  // (3, U, C_mid, C_mid)
  const float* ta;
  const void* tw;  // (S, 2, C_mid, C_out), x's type; null without a tail
  const float* tb;
  Dilations dil;
  int Cin, Cmid, Cout, Tin, Tu, U, s_head, s_tail, halo, tile;
  int slab_w, slab_c;  // head: samples per staged channel, channels per slab
  int wbuf_elems;      // tensor cores: elements of the weight stages
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

// ---------------------------------------------------------------------------
// The tensor-core instantiation (bf16 x, snake_fast; C_in, C_mid, C_out
// multiples of 16, C_mid and C_out at most 256): time-major buffers, the
// units' float32 weights as three bf16 planes, head and tail weights (bf16)
// one MMA per product. `edge` is the head's sample slab, then the tail's
// output staging.

// Channels per slab group of the head (a weight stage's rows): 64, 32 or
// 16, the largest that divides C_in.
__host__ __device__ inline int head_group(int cin) {
  return cin % 64 == 0 ? 64 : (cin % 32 == 0 ? 32 : 16);
}

// S[p][co] = bf16(hb[co] + sum_{k, ci} hw[k][ci][co] act(x[ci, S(base+p) + k - (2S-1)]))
// for every row p < L. Per chunk of output rows and group of input
// channels, the activated samples the chunk reads are staged time-major in
// the slab (rows: samples, zero outside [0, T_in)); the A operand of tap k
// is the slab's rows S m + k, an ldmatrix row address each.
__device__ void head_tc(const StageArgs& a, const bf16* __restrict__ xb, bf16* Sp, bf16* Wsm,
                        bf16* slab, int L, int base) {
  const int C = a.Cmid, st = a.s_head, K = 2 * st;
  const TcTiling<kMIh> tl(C);
  const TmBuf S(Sp, C);
  const int kci = head_group(a.Cin), ngroups = a.Cin / kci;
  const TmBuf sb(slab, kci);
  const int slab_rows = st * tl.mt + st;
  const bf16* hw = static_cast<const bf16*>(a.hw);
  float acc[kMIh][kNJ][4];
  Pipe pipe;
  for (int p0 = 0; p0 < L; p0 += tl.mt) {
    const long s0 = static_cast<long>(st) * (base + p0) - (K - 1);  // sample of slab row 0
    zero(acc);
    // stage s: group s / K, tap s % K
    tc_gemm<1, kMIh>(
        acc, Wsm, C, kKCe, ngroups * K, tl,
        [&](int s) {
          const int g = s / K, k = s - g * K;
          return WStage{hw + (static_cast<size_t>(k) * a.Cin + g * kci) * C, 0, kci};
        },
        [&](int s) {
          if (s % K) return false;
          const int c0 = s / K * kci, n = kci * slab_rows;
          constexpr int kLoads = 4;  // global loads in flight per thread
          for (int i0 = threadIdx.x; i0 < n; i0 += kLoads * kThreads) {
            bf16 v[kLoads];
#pragma unroll
            for (int j = 0; j < kLoads; ++j) {
              const int i = i0 + j * kThreads, cc = i / slab_rows;
              const long smp = s0 + i - cc * slab_rows;
              v[j] = (i < n && smp >= 0 && smp < a.Tin)
                         ? xb[static_cast<size_t>(c0 + cc) * a.Tin + smp]
                         : from_f<bf16>(0.f);
            }
#pragma unroll
            for (int j = 0; j < kLoads; ++j) {
              const int i = i0 + j * kThreads, cc = i / slab_rows, q = i - cc * slab_rows;
              const long smp = s0 + q;
              if (i < n)
                *sb.at(q, cc) = from_f<bf16>(
                    smp >= 0 && smp < a.Tin ? act<bf16, true, false>(to_f(v[j]), a.ha[c0 + cc]) : 0.f);
            }
          }
          return true;
        },
        [&](int s, int ks, int m, int h) {
          return slab + sb.off(st * m + s % K, 2 * ks + h);
        },
        pipe, nullptr);
    for_acc(acc, tl, [&](int m, int n, float v0, float v1) {
      const int p = p0 + m;
      if (p < L)
        *reinterpret_cast<Bf16x2*>(S.at(p, n)) =
            Bf16x2{from_f<bf16>(v0 + a.hb[n]), from_f<bf16>(v1 + a.hb[n + 1])};
    });
  }
}

// out[co, S (t0+q) + ph] = bf16(tb[co] + sum_{j, ci} tw[ph][j][ci][co] a[t0+q-j, ci]).
// Per chunk of frames, the S phases' results are staged in `stage`
// ([ph][m][co], rows padded to C_out + 8), then written as runs of S *
// frames contiguous samples per output channel.
__device__ void tail_tc(const StageArgs& a, bf16* Sp, bf16* Ap, bf16* Wsm, bf16* stage, int L,
                        int t0, int base, bf16* __restrict__ ob) {
  const int C = a.Cmid, Co = a.Cout, st = a.s_tail, n16 = C / 8;
  const TmBuf S(Sp, C), A(Ap, C);
  __syncthreads();  // the units' last writes to S are done
  for (int i = threadIdx.x; i < L * n16; i += kThreads) {
    const int r = i / n16, c16 = i - r * n16;
    if (r < a.halo - 1) continue;
    const int o = S.off(r, c16);
    uint4 raw = *reinterpret_cast<const uint4*>(Sp + o);
    const bf16* in = reinterpret_cast<const bf16*>(&raw);
    uint4 res;
    bf16* outv = reinterpret_cast<bf16*>(&res);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      outv[e] = from_f<bf16>(base + r < 0 ? 0.f
                                          : act<bf16, true, false>(to_f(in[e]), a.ta[c16 * 8 + e]));
    *reinterpret_cast<uint4*>(Ap + o) = res;
  }
  const TcTiling<kMIt> tl(Co);
  const bf16* tw = static_cast<const bf16*>(a.tw);
  const size_t row_len = static_cast<size_t>(a.Tu) * st;
  const int k2 = 2 * C, ldo = Co + 8;
  float acc[kMIt][kNJ][4];
  Pipe pipe;
  for (int p0 = a.halo; p0 < L; p0 += tl.mt) {
    for (int ph = 0; ph < st; ++ph) {
      const bf16* w = tw + static_cast<size_t>(ph) * k2 * Co;
      zero(acc);
      tc_gemm<1, kMIt>(
          acc, Wsm, Co, kKCe, (k2 + kKCe - 1) / kKCe, tl,
          [&](int s) { return WStage{w + static_cast<size_t>(s) * kKCe * Co, 0, min(kKCe, k2 - s * kKCe)}; },
          [](int) { return false; },
          [&](int s, int ks, int m, int h) {
            const int k = s * kKCe + ks * 16, j = k / C, ci = k - j * C;
            return Ap + A.off(min(p0 + m - j, L - 1), (ci >> 3) + h);
          },
          pipe, nullptr);
      for_acc(acc, tl, [&](int m, int n, float v0, float v1) {
        *reinterpret_cast<Bf16x2*>(stage + (ph * tl.mt + m) * ldo + n) =
            Bf16x2{from_f<bf16>(v0 + a.tb[n]), from_f<bf16>(v1 + a.tb[n + 1])};
      });
    }
    __syncthreads();  // every phase of the chunk is staged
    const int tstart = t0 + p0 - a.halo;
    const int rows = min(min(tl.mt, L - p0), a.Tu - tstart);
    const int run = st * rows;
    for (int i = threadIdx.x; i < Co * run; i += kThreads) {
      const int co = i / run, q = i - co * run, m = q / st, ph = q - m * st;
      ob[co * row_len + static_cast<size_t>(tstart) * st + q] = stage[(ph * tl.mt + m) * ldo + co];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) fused_stage_tc_kernel(const StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.Cmid, L = a.tile + a.halo;
  float* prm = reinterpret_cast<float*>(smem);                   // unit constants
  bf16* S = reinterpret_cast<bf16*>(smem + tc_consts_bytes(C));  // [L][C] stream
  bf16* Abuf = S + static_cast<size_t>(L) * C;                   // [L][C]
  bf16* Wsm = Abuf + static_cast<size_t>(L) * C;                 // weight stages
  bf16* edge = Wsm + a.wbuf_elems;                               // head slab / tail staging
  const TmBuf sb(S, C);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * a.tile;
  const int base = t0 - a.halo;  // frame of row 0
  const bf16* xb = static_cast<const bf16*>(a.x) + static_cast<size_t>(b) * a.Cin * a.Tin;
  if (a.s_head > 0) {
    head_tc(a, xb, S, Wsm, edge, L, base);
  } else {
    load_ct_tile(sb, xb, C, L, a.Tin, base);
  }
  const size_t ps1 = static_cast<size_t>(a.U) * 3 * C * C, ps2 = static_cast<size_t>(a.U) * C * C;
  run_units_tc<3, false>(S, Abuf, Wsm, prm, C, L, a.U, a.dil, a.w1p, ps1, a.b1, a.a1, a.w2p, ps2,
                         a.b2, a.a2, base);
  const int Co = a.s_tail > 0 ? a.Cout : C;
  bf16* ob = static_cast<bf16*>(a.out) +
             static_cast<size_t>(b) * Co * a.Tu * (a.s_tail > 0 ? a.s_tail : 1);
  if (a.s_tail > 0) {
    tail_tc(a, S, Abuf, Wsm, edge, L, t0, base, ob);
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < C * a.tile; i += kThreads) {
      const int c = i / a.tile, q = i - c * a.tile, t = t0 + q;
      if (t < a.Tu) ob[static_cast<size_t>(c) * a.Tu + t] = *sb.at(a.halo + q, c);
    }
  }
}

// Bytes of the weight stages: the largest of the units' (three planes), the
// head's and the tail's (one plane each).
inline size_t tc_stage_wbuf_bytes(int cmid, int cout, int s_head, int s_tail) {
  size_t b = tc_wbuf_bytes(3, units_kc(3, cmid), cmid);
  if (s_head > 0) b = b > tc_wbuf_bytes(1, kKCe, cmid) ? b : tc_wbuf_bytes(1, kKCe, cmid);
  if (s_tail > 0) b = b > tc_wbuf_bytes(1, kKCe, cout) ? b : tc_wbuf_bytes(1, kKCe, cout);
  return b;
}

// Bytes of the edge region: the head's slab (S rows per output row of a
// chunk, plus S) or the tail's staged phases, whichever is larger.
inline size_t tc_stage_edge_bytes(int cin, int cmid, int cout, int s_head, int s_tail) {
  size_t slab = 0, stage = 0;
  if (s_head > 0)
    slab = static_cast<size_t>(s_head) * (tc_rows(cmid, kMIh) + 1) * head_group(cin) * sizeof(bf16);
  if (s_tail > 0)
    stage = static_cast<size_t>(s_tail) * tc_rows(cout, kMIt) * (cout + 8) * sizeof(bf16);
  return slab > stage ? slab : stage;
}

// Whether a stage takes the tensor-core instantiation (with bf16 x and
// snake_fast).
inline bool tc_stage(const StageArgs& a) {
  return tc_width(a.Cmid) && (a.s_head == 0 || a.Cin % 16 == 0) &&
         (a.s_tail == 0 || tc_width(a.Cout));
}

// The plan of a launch: fills a's tile and, per chain, the weight stages'
// size (tensor cores) or the head's slab shape (SIMT). The tensor-core
// chain takes bf16 x with snake_fast where tc_stage(a), the SIMT chain
// every other case, with elem_bytes = x's type plus the activations'. The
// wrapper's Python planner (`kernels/fused_stage.py::stage_plan`) restates
// it; `nsc_fused_stage_plan` lets a test hold the two equal.
Plan stage_plan(StageArgs& a, bool is_bf16, bool fast) {
  Plan p{};
  if (is_bf16 && fast && tc_stage(a)) {
    const size_t wbuf = tc_stage_wbuf_bytes(a.Cmid, a.Cout, a.s_head, a.s_tail);
    a.wbuf_elems = static_cast<int>(wbuf / sizeof(bf16));
    const size_t extra = wbuf + tc_stage_edge_bytes(a.Cin, a.Cmid, a.Cout, a.s_head, a.s_tail) +
                         tc_consts_bytes(a.Cmid);
    p.tile = tc_pick_tile(a.Cmid, a.halo, extra);
    p.smem = 2 * static_cast<size_t>(a.Cmid) * (p.tile + a.halo) * sizeof(bf16) + extra;
  } else {
    const size_t elem = (is_bf16 ? sizeof(bf16) : sizeof(float)) +
                        (is_bf16 && fast ? sizeof(bf16) : sizeof(float));
    size_t extra = static_cast<size_t>(kKC) * (a.Cmid > a.Cout ? a.Cmid : a.Cout) * sizeof(float);
    if (a.s_head > 0) {
      const int nc = kThreads / (a.Cmid / kRM) * kRN;  // Tiling(C_mid).nc
      a.slab_w = a.s_head * nc + a.s_head;
      const size_t per_channel = static_cast<size_t>(a.slab_w) * sizeof(float);
      a.slab_c = static_cast<int>(kSlabBudget / per_channel);
      a.slab_c = a.slab_c < 1 ? 1 : (a.slab_c > kMaxSlabChannels ? kMaxSlabChannels : a.slab_c);
      extra += a.slab_c * per_channel;
    }
    p.tile = pick_tile(a.Cmid, a.halo, elem, extra);
    p.smem = static_cast<size_t>(a.Cmid) * (p.tile + a.halo) * elem + extra;
  }
  a.tile = p.tile;
  return p;
}

cudaError_t launch_tc(StageArgs a, int B, cudaStream_t stream) {
  if (a.w1p == nullptr || a.w2p == nullptr) return cudaErrorInvalidValue;
  const Plan pl = stage_plan(a, true, true);
  if (pl.tile < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_stage_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tu + a.tile - 1) / a.tile, B);
  fused_stage_tc_kernel<<<grid, kThreads, pl.smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kFast>
cudaError_t launch(StageArgs a, int B, cudaStream_t stream) {
  const Plan pl = stage_plan(a, sizeof(T) == sizeof(bf16), kFast);
  if (pl.tile < 1) return cudaErrorInvalidValue;
  auto kernel = fused_stage_kernel<T, kFast>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tu + a.tile - 1) / a.tile, B);
  kernel<<<grid, kThreads, pl.smem, stream>>>(a);
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
                               const void* a2, const void* w1p, const void* w2p,
                               const void* ta, const void* tw,
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
  a.w1p = static_cast<const bf16*>(w1p);
  a.w2p = static_cast<const bf16*>(w2p);
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
  if (is_bf16 && fast && tc_stage(a)) {
    err = launch_tc(a, B, s);
  } else if (is_bf16) {
    err = fast ? launch<__nv_bfloat16, true>(a, B, s) : launch<__nv_bfloat16, false>(a, B, s);
  } else {
    err = fast ? launch<float, true>(a, B, s) : launch<float, false>(a, B, s);
  }
  return static_cast<int>(err);
}

// The plan of a K5 launch for a stage of the given widths and strides
// (0: no head / no tail) and the units' halo sum(2d): plan[0] the time tile
// (0: the stage does not fit one block), plan[1] the block's shared-memory
// bytes. Host only; for the tests that hold the wrapper's planner to the
// kernel's.
extern "C" int nsc_fused_stage_plan(int Cin, int Cmid, int Cout, int s_head, int s_tail,
                                    int units_halo, int is_bf16, int fast, long long* plan) {
  if (!valid_width(Cmid) || !valid_width(Cout) || Cin < 1 || s_head < 0 || s_tail < 0 ||
      units_halo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StageArgs a{};
  a.Cin = Cin;
  a.Cmid = Cmid;
  a.Cout = Cout;
  a.s_head = s_head;
  a.s_tail = s_tail;
  a.halo = units_halo + (s_tail > 0 ? 1 : 0);
  const Plan p = stage_plan(a, is_bf16, fast);
  plan[0] = p.tile;
  plan[1] = static_cast<long long>(p.smem);
  return 0;
}
