// Residual vector quantizer search (quantize) and codeword sum (dequantize),
// for Hopper (sm_90a).
//
// quantize replaces nsc_tpu/ops/pallas/rvq_argmin.py::quantize_pallas
// (_quantize_kernel): for each frame, over the books in order,
//   idx = argmin_k ||c_k||^2 - 2 r.c_k   (float32, lowest index on ties)
//   r  -= c[idx]                          (float32; skipped after the last book)
// The TPU kernel takes r.c at precision=HIGHEST, a multi-pass bf16 product
// on the MXU; this one runs it on the tensor cores via exact bf16 planes.
// Each float32 value is split by truncation into bf16 planes hi + mid + lo
// that sum to it exactly (|v| >= 2^-110, and 0): the codebooks once per
// call (rvq_split_planes_kernel, launched by the wrapper before the search;
// kernels/residual_stack.py::split_planes is its plain version), the
// residuals by the block. A bf16 x bf16 product is exact in
// float32, so r.c is the sum of nine plane products; the six largest,
// (residual plane . code plane) lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
// hi.hi, smallest first, go through mma.sync m16n8k16 bf16 -> f32 into one
// float32 accumulator per (frame, code); the three dropped (mid.lo, lo.mid,
// lo.lo) are below ~3 x 2^-24 of |r||c|. ||c||^2 comes precomputed in
// float32, and the score is one exact doubling and one rounded subtraction,
// as in the plain version; what differs from it is the dot's summation
// order and the tensor cores' accumulation, which need not round each
// addition to nearest. Those differ from the float32 dot by up to a few
// ulps of the score, biased toward zero on raw trained latents, so the
// argmin of these scores alone can miss the float32 one by more than a
// near-tie (refit searches of the trained flagship). So the tensor cores
// only shortlist: each thread keeps, per frame, its best (score, index)
// among its even codes and among its odd codes, so the book's codes fall
// in 16 subsets of 64, each with its best; the frame's two best of those
// 16 are scored again from the tile's exact float32 residual: the dot in float64 (each product exact, one rounding per
// addition), ||c||^2 - 2 dot in float64, rounded once to float32. The
// frame takes the lowest of those scores, lowest index on ties, and
// best_out returns it.
//
// What bounds it on the H100: 2*M*K*D*n_q FLOP per plane product, six of
// them at the bf16 tensor-core rate, against a few MB of device memory
// (the codebook planes, 12 MB for the serving quantizer, stay in L2).
// Design: a tile of 128 frames per block, persistent blocks over the tiles
// so the grid is one whole wave. The tile's residuals are kept only as
// their three bf16 planes, which hold them exactly: the update rebuilds
// each float32 residual as (hi + mid) + lo, subtracts the codeword in
// float32 and splits the result again (a component below 2^-110 in
// magnitude, other than 0, would lose its bits below 2^-133).
// Per book, 128-code chunks of the codebook planes stream through shared
// memory 64 dims at a time (48 KB stages: the block-wide barrier between
// stages, more than the products, bounded a design with 32-dim stages),
// double-buffered with cp.async so the copy of the next stage overlaps the
// MMAs of this one (across book boundaries too). Two launch plans of the
// same kernel, chosen by the padded width Dp alone, run the same products
// in the same order:
//   resident (Dp <= 128): the residual planes stay in shared memory for all
//     books (96 KB at Dp = 128) beside the two stages;
//   streamed (Dp > 128): the residual planes live in a scratch of device
//     memory, one slot of 3 x 128 x Dp bf16 per block (the wrapper
//     allocates it; it stays in L2), and each stage carries the tile's
//     residual planes of its 64 dims beside the code planes (48 + 48 KB).
//     The stage that opens a book is issued without its residual part,
//     which is copied once the update has written it. So shared memory is
//     213,504 bytes at every width, and no width is refused; the residual
//     planes are read from L2 once per 128-code chunk. (ptxas, sm_90a,
//     before the rescoring: 241 registers for the resident plan; 255 and a
//     232-byte spill for the streamed one. chip_smoke.py's build line prints
//     today's.)
// The 8 warps are 4 (32 frames each) x 2 (64 codes of the chunk each);
// fragments come by ldmatrix from XOR-swizzled rows (stage_units.cuh's
// TmBuf), and those of the next 16-dim step are loaded between the plane
// products of this one. After each chunk a warp turns its accumulators
// into scores (with ||c||^2 loaded at the chunk's start) and keeps the
// best (score, lowest index) of its even and of its odd codes per frame in
// registers (the two indices packed in one word, so K <= 65,536: a score
// costs the thread one compare and two selects, as a single running best
// did); after the book every thread writes them to shared memory, and two
// threads per frame take the frame's two best of its 16 and rescore one
// each (the codeword from L2, the residual from its planes), then agree by
// one shuffle. The shortlist always holds the
// tensor-core argmin; it misses the tensor-core runner-up only where that
// shares the argmin's subset (63 of the other 1,023 codes). A true top-2
// per thread (two compares and up to six selects a score) cost 0.34 ms a
// call at the serving shape on the H100. What the rescoring costs: two
// codeword gathers of D floats and 2 D float64 FMAs per frame and book. A
// shortlist of two sufficed on the refits of the trained flagship
// (scripts/torch_refit_flips.py, seeds 7-10, as four did). The residual update gathers the chosen
// codewords (float32, from L2, 16 bytes a load) with every thread of the
// block. Codes past K in the last chunk are zero planes and score +inf, so
// they never win; dims past D are zero planes.
//
// dequantize replaces nsc_tpu/ops/pallas/rvq_argmin.py::dequantize_pallas
// (_dequantize_kernel): out[m] = 0 + c_0[idx[m,0]] + c_1[idx[m,1]] + ...,
// summed in book order in float32 with __fadd_rn, which is bit-exact with
// the plain version and the JAX package. An index outside [0, K) adds
// nothing (as the TPU kernel's one-hot product), rather than reading out
// of bounds. What bounds it: the codewords it gathers, n_q*D*4 bytes per
// frame (262 MB at the serving shape), come from L2 (the books, 8.4 MB,
// stay there); device memory sees only the indices and the output. No
// gather reaches the device-memory bound, so the design keeps L2 busy:
// each lane takes 16 bytes of a row (float4; 4 bytes where D % 4 != 0 or
// the books are not 16-byte aligned), so a warp reads one 128-dim row per
// instruction; the L lanes of a frame (the smallest power of two that
// covers its row, at most 32; 32 / L frames per warp) read up to L of the
// frame's indices in one coalesced load and pass them round by
// __shfl_sync; then the books go in batches of 8: a lane issues the
// batch's 8 codeword loads before its first add, an out-of-range index a
// predicated zero (adding +0 to a sum that starts at +0 changes no bit). A
// persistent grid of as many 256-thread blocks as fit the card walks over
// the frames. At the serving shape (M 32,000, D 128, n_q 16: one frame a
// warp, two batches) a warp holds 8 x 512 bytes in flight; at 64 registers
// (ptxas, sm_90a) 4 blocks fit an SM, 32 warps, 4,224 on the card, each
// walking 7-8 frames.
// rvq_dequantize_rowwarp_kernel is the earlier design (one warp per frame,
// a lane walks the books for each of its dims, one 4-byte load at a time);
// no path runs it: chip_smoke.py times the kernel against it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "stage_units.cuh"

namespace {

using nsc_stage::bf16;
using nsc_stage::cp_async16;
using nsc_stage::cp_async_commit;
using nsc_stage::cp_async_wait_all;
using nsc_stage::ldsm_x4;
using nsc_stage::mma_bf16;
using nsc_stage::TmBuf;

constexpr int kWM = 4, kWN = 2;  // warps over frames x codes
constexpr int kQThreads = 32 * kWM * kWN;
constexpr int kTM = 128;        // frames per tile
constexpr int kNC = 128;        // codes per chunk
constexpr int kKC = 64;         // dims per pipeline stage
constexpr int kMI = 2;          // m16 tiles per warp: 32 frames
constexpr int kNJ = 8;          // n8 tiles per warp: 64 codes
constexpr int kPlanes = 3;      // hi, mid, lo
constexpr int kResidentDim = 128;  // widest padded D of the resident plan
constexpr int kLists = 4 * kWN;    // threads holding a frame's candidates: 4 lanes x kWN warps
constexpr int kStageElems = kPlanes * kNC * kKC;  // one stage's code (or residual) planes
constexpr float kInf = __builtin_huge_valf();
static_assert(kTM == kNC, "a stage's residual planes have the shape of its code planes");

// the launch plan of a padded width: the residual planes in shared memory
// (resident) or streamed beside the code planes from device memory
__host__ __device__ inline bool streamed(int Dp) { return Dp > kResidentDim; }

// shared memory of one block: the residuals' planes (resident plan), two
// stages (code planes, and in the streamed plan the residual planes of the
// same dims), the frames' candidate lists (kLists pairs of score and index
// each) and the chosen indices
__host__ __device__ inline int quantize_smem(int Dp) {
  const int resident = streamed(Dp) ? 0 : kTM * Dp * 2 * kPlanes;
  const int stage = (streamed(Dp) ? 2 : 1) * kStageElems * 2;
  return resident + 2 * stage + kTM * (2 * 2 * kLists + 1) * 4;
}

__device__ __forceinline__ bool better(float s, int k, float bs, int bk) {
  return s < bs || (s == bs && k < bk);
}

// 8 floats of a codeword row from d0 on (16-byte loads where D % 8 == 0),
// 0 past D (no load at all from d0 >= D)
__device__ __forceinline__ void load_code8(const float* src, int d0, int D, float (&c)[8]) {
  if (D % 8 == 0 && d0 < D) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(src + 4));
    c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
    c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = d0 + e < D ? __ldg(src + e) : 0.f;
  }
}

// v -> bf16 bits of hi, mid, lo with hi + mid + lo == v (truncation)
__device__ __forceinline__ void split3(float v, uint32_t& h, uint32_t& m, uint32_t& l) {
  const uint32_t hb = __float_as_uint(v) & 0xffff0000u;
  const float rest = __fsub_rn(v, __uint_as_float(hb));
  const uint32_t mb = __float_as_uint(rest) & 0xffff0000u;
  h = hb >> 16;
  m = mb >> 16;
  l = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(rest, __uint_as_float(mb))));
}

// The residuals of the tile live only as their planes [3][kTM][Dp]:
// thread-owned groups of 8 dims of a row (16 bytes of each plane), at
// element offset `off` of each plane. A group's float32 values are
// (hi + mid) + lo, exact for planes split from a float32.
__device__ __forceinline__ void store_group(bf16* R, int Dp, int off, const float (&v)[8]) {
  uint32_t w[kPlanes][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(v[2 * e], h0, m0, l0);
    split3(v[2 * e + 1], h1, m1, l1);
    w[0][e] = h0 | (h1 << 16);
    w[1][e] = m0 | (m1 << 16);
    w[2][e] = l0 | (l1 << 16);
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    *reinterpret_cast<uint4*>(R + p * kTM * Dp + off) = make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
}

__device__ __forceinline__ void load_group(const bf16* R, int Dp, int off, float (&v)[8]) {
  uint4 w[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) w[p] = *reinterpret_cast<const uint4*>(R + p * kTM * Dp + off);
  const uint32_t* h = &w[0].x;
  const uint32_t* m = &w[1].x;
  const uint32_t* l = &w[2].x;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int sh = e & 1 ? 0 : 16;
    const float hv = __uint_as_float((h[e / 2] << sh) & 0xffff0000u);
    const float mv = __uint_as_float((m[e / 2] << sh) & 0xffff0000u);
    const float lv = __uint_as_float((l[e / 2] << sh) & 0xffff0000u);
    v[e] = __fadd_rn(__fadd_rn(hv, mv), lv);
  }
}

// Stage s of a tile: book q, chunk c of 128 codes, dims kd*64 .. + kn.
// Stages run in order, so the next one is one step on.
struct Stage {
  int q = 0, c = 0, kd = 0, kn = 0;
  __device__ __forceinline__ Stage next(int nch, int nkd, int Dp) const {
    Stage n = *this;
    if (++n.kd == nkd) {
      n.kd = 0;
      if (++n.c == nch) {
        n.c = 0;
        ++n.q;
      }
    }
    n.kn = min(kKC, Dp - n.kd * kKC);
    return n;
  }
};

// cp.async of three planes x 128 rows x 8*kCpr dims into buf (rows of
// kKC, swizzled); plane p's rows at src + (p * rows + r) * Dp
template <int kCpr>
__device__ __forceinline__ void copy_stage(bf16* buf, const bf16* src, int rows, int Dp) {
  const TmBuf cbuf(buf, kKC);
  for (int i = threadIdx.x; i < kPlanes * kNC * kCpr; i += kQThreads) {
    const int p = i / (kNC * kCpr), rem = i - p * kNC * kCpr, r = rem / kCpr, cc = rem - r * kCpr;
    cp_async16(buf + p * kNC * kKC + cbuf.off(r, cc),
               src + (static_cast<size_t>(p) * rows + r) * Dp + cc * 8);
  }
}

__device__ __forceinline__ void copy_slice(bf16* buf, const bf16* src, int rows, int Dp, int kn) {
  switch (kn) {
    case 64: copy_stage<8>(buf, src, rows, Dp); break;
    case 48: copy_stage<6>(buf, src, rows, Dp); break;
    case 32: copy_stage<4>(buf, src, rows, Dp); break;
    default: copy_stage<2>(buf, src, rows, Dp); break;
  }
}

// Stage st into buf: its code planes, and in the streamed plan (with
// `residual`) the tile's residual planes of the same dims from Rg.
template <bool kStream>
__device__ __forceinline__ void issue_stage(bf16* buf, const bf16* __restrict__ planes,
                                            const bf16* Rg, const Stage& st, int Kp, int Dp,
                                            bool residual) {
  const bf16* src = planes + (static_cast<size_t>(st.q) * kPlanes * Kp + st.c * kNC) * Dp +
                    st.kd * kKC;
  copy_slice(buf, src, Kp, Dp, st.kn);
  if (kStream && residual) copy_slice(buf + kStageElems, Rg + st.kd * kKC, kTM, Dp, st.kn);
  cp_async_commit();
}

// The A fragments (residual plane p, 16-dim step ks of the stage) of this
// warp's frames, and the B fragments (code plane p, step ks) of its codes.
// The residual planes are at Ra + p * rstride in rows of rb, the stage's
// dims from 16-byte chunk rc0 on.
struct Frags {
  const bf16* Ra;
  const bf16* cs;
  TmBuf rb, cb;
  int rstride, rc0, wm, wn, lane;
  __device__ __forceinline__ void a(uint32_t (&f)[kMI][4], int p, int ks) const {
    const int chunk = rc0 + 2 * ks + (lane >> 4);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
      ldsm_x4(f[mi], Ra + p * rstride + rb.off(wm * 32 + mi * 16 + (lane & 15), chunk));
  }
  __device__ __forceinline__ void b(uint32_t (&f)[kNJ][2], int p, int ks) const {
    const int chunk = 2 * ks + ((lane >> 3) & 1);
#pragma unroll
    for (int jp = 0; jp < kNJ / 2; ++jp) {
      uint32_t r[4];
      const int code = wn * (kNJ * 8) + jp * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
      ldsm_x4(r, cs + p * kNC * kKC + cb.off(code, chunk));
      f[2 * jp][0] = r[0];
      f[2 * jp][1] = r[1];
      f[2 * jp + 1][0] = r[2];
      f[2 * jp + 1][1] = r[3];
    }
  }
};

// acc += (residual plane kR) . (code plane kC) over one 16-dim step
template <int kR, int kC>
__device__ __forceinline__ void plane_product(float (&acc)[kMI][kNJ][4],
                                              const uint32_t (&a)[kPlanes][kMI][4],
                                              const uint32_t (&b)[kPlanes][kNJ][2]) {
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) mma_bf16(acc[mi][j], a[kR][mi], b[kC][j][0], b[kC][j][1]);
}

// where group (row, c8) of a residual plane sits: swizzled rows in shared
// memory (resident plan), plain rows in the device-memory slot (streamed)
template <bool kStream>
__device__ __forceinline__ int group_off(const TmBuf& rb, int Dp, int row, int c8) {
  return kStream ? row * Dp + c8 * 8 : rb.off(row, c8);
}

// The float64 dot of row `row` of the tile's residuals (its planes, as
// store_group left them) with a codeword of D floats: each product exact,
// one rounding per addition. 32 dims a round, the round's codeword loads
// (from L2) issued before its products.
template <bool kStream>
__device__ __forceinline__ double exact_dot(const bf16* R, const TmBuf& rb, int Dp, int row,
                                            const float* code, int D) {
  double dot = 0.0;
  for (int c0 = 0; c0 * 8 < D; c0 += 4) {
    float c[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_code8(code + (c0 + u) * 8, (c0 + u) * 8, D, c[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if ((c0 + u) * 8 >= D) break;
      float r[8];
      load_group(R, Dp, group_off<kStream>(rb, Dp, row, c0 + u), r);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dot = fma(static_cast<double>(r[e]), static_cast<double>(c[u][e]), dot);
    }
  }
  return dot;
}

// kStream: the streamed plan (Dp > kResidentDim), with rscratch one
// [3][kTM][Dp] bf16 slot per block; the resident plan ignores rscratch.
template <bool kStream>
__global__ void __launch_bounds__(kQThreads, 1) rvq_quantize_kernel(
    const float* __restrict__ z, const bf16* __restrict__ planes, const float* __restrict__ cb,
    const float* __restrict__ csq, bf16* rscratch, int* __restrict__ idx,
    float* __restrict__ best_out, int M, int n_q, int K, int D, int Kp, int Dp, int tiles) {
  constexpr int kStage = (kStream ? 2 : 1) * kStageElems;
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Rp = reinterpret_cast<bf16*>(smraw);  // resident: [3][kTM][Dp], swizzled
  bf16* Cs = kStream ? Rp : Rp + kPlanes * kTM * Dp;  // [2][kStage], swizzled
  float* cand_s = reinterpret_cast<float*>(Cs + 2 * kStage);  // [kTM][kLists][2]
  int* cand_k = reinterpret_cast<int*>(cand_s + kTM * kLists * 2);  // [kTM][kLists][2]
  int* chosen = cand_k + kTM * kLists * 2;                            // [kTM]
  // where the residual groups live: this block's device-memory slot, or Rp
  bf16* Rg = kStream ? rscratch + static_cast<size_t>(blockIdx.x) * kPlanes * kTM * Dp : nullptr;
  bf16* R = kStream ? Rg : Rp;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWN, wn = warp % kWN;
  const TmBuf rb(Rp, Dp);
  const int nch = Kp / kNC, nkd = (Dp + kKC - 1) / kKC, c8n = Dp / 8;
  const int per_book = nch * nkd, total = n_q * per_book;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * kTM;
    __syncthreads();  // the previous tile's readers are done
    for (int g = tid; g < kTM * c8n; g += kQThreads) {
      const int row = g / c8n, c8 = g - row * c8n;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = c8 * 8 + e;
        v[e] = m0 + row < M && d < D ? z[static_cast<size_t>(m0 + row) * D + d] : 0.f;
      }
      store_group(R, Dp, group_off<kStream>(rb, Dp, row, c8), v);
    }
    if (kStream) __syncthreads();  // the slot is written before the copies read it
    Stage st;
    st.kn = min(kKC, Dp);
    issue_stage<kStream>(Cs, planes, Rg, st, Kp, Dp, true);

    float acc[kMI][kNJ][4];
    float bs[kMI][2][2];  // per frame, the best score of this thread's even and odd codes
    uint32_t bk[kMI][2];  // and their indices, the even's | the odd's << 16
    float c2[kNJ][2];  // ||c||^2 of this thread's codes of the chunk, +inf past K
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bs[mi][h][0] = bs[mi][h][1] = kInf;
        bk[mi][h] = 0;
      }
    }

    for (int s = 0; s < total; ++s, st = st.next(nch, nkd, Dp)) {
      cp_async_wait_all();
      __syncthreads();  // stage s landed; every warp is done with stage s-1
      if (s + 1 < total) {
        // a stage that opens the next book goes without its residual
        // planes: the update below writes them first
        const Stage nx = st.next(nch, nkd, Dp);
        issue_stage<kStream>(Cs + ((s + 1) & 1) * kStage, planes, Rg, nx, Kp, Dp, nx.q == st.q);
      }
      if (st.kd == 0) {
        // the chunk's ||c||^2, loaded while its products run
        const float* csq_q = csq + static_cast<size_t>(st.q) * K;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int code = st.c * kNC + wn * (kNJ * 8) + j * 8 + 2 * (lane & 3) + e;
            c2[j][e] = code < K ? __ldg(csq_q + code) : kInf;
          }
      }

      // the six plane products of each 16-dim step, smallest first; the
      // fragments of the next step are loaded as soon as the current step
      // is done with the registers they replace (the code hi plane, read
      // first and last, has its own buffer)
      const bf16* cs = Cs + (s & 1) * kStage;
      const bf16* rs = cs + kStageElems;  // the stage's residual planes (streamed)
      const TmBuf cbuf(const_cast<bf16*>(cs), kKC);
      const Frags fr = kStream
          ? Frags{rs, cs, TmBuf(const_cast<bf16*>(rs), kKC), cbuf, kTM * kKC, 0, wm, wn, lane}
          : Frags{Rp, cs, rb, cbuf, kTM * Dp, st.kd * (kKC / 8), wm, wn, lane};
      const int nks = st.kn / 16;
      uint32_t a[kPlanes][kMI][4], b[kPlanes][kNJ][2], bhi[kNJ][2];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        fr.a(a[p], p, 0);
        fr.b(b[p], p, 0);
      }
      for (int ks = 0; ks < nks; ++ks) {
        const bool more = ks + 1 < nks;
        plane_product<2, 0>(acc, a, b);  // lo.hi
        if (more) fr.a(a[2], 2, ks + 1);
        plane_product<0, 2>(acc, a, b);  // hi.lo
        if (more) {
          fr.b(b[2], 2, ks + 1);
          fr.b(bhi, 0, ks + 1);
        }
        plane_product<1, 1>(acc, a, b);  // mid.mid
        plane_product<1, 0>(acc, a, b);  // mid.hi
        if (more) fr.a(a[1], 1, ks + 1);
        plane_product<0, 1>(acc, a, b);  // hi.mid
        if (more) fr.b(b[1], 1, ks + 1);
        plane_product<0, 0>(acc, a, b);  // hi.hi
        if (more) {
          fr.a(a[0], 0, ks + 1);
#pragma unroll
          for (int j = 0; j < kNJ; ++j) {
            b[0][j][0] = bhi[j][0];
            b[0][j][1] = bhi[j][1];
          }
        }
      }

      if (st.kd == nkd - 1) {
        // scores of this chunk, c2 - 2 acc rounded once (the doubling is
        // exact); each thread meets its codes in increasing order, so a
        // strict < keeps the lowest index of equal scores
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int code = st.c * kNC + wn * (kNJ * 8) + j * 8 + 2 * (lane & 3) + e;
#pragma unroll
            for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float sc = fmaf(-2.0f, acc[mi][j][2 * h + e], c2[j][e]);
                if (sc < bs[mi][h][e]) {
                  bs[mi][h][e] = sc;
                  bk[mi][h] = e ? (bk[mi][h] & 0xffffu) | (static_cast<uint32_t>(code) << 16)
                                : (bk[mi][h] & 0xffff0000u) | static_cast<uint32_t>(code);
                }
              }
          }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
      }

      if (st.c == nch - 1 && st.kd == nkd - 1) {
        // every thread's best even and odd code of each of its frames into
        // the frame's lists (one that never took a code scores +inf)
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm * 32 + mi * 16 + (lane >> 2) + 8 * h;
            const int at = (row * kLists + wn * 4 + (lane & 3)) * 2;
            cand_s[at] = bs[mi][h][0];
            cand_s[at + 1] = bs[mi][h][1];
            cand_k[at] = static_cast<int>(bk[mi][h] & 0xffffu);
            cand_k[at + 1] = static_cast<int>(bk[mi][h] >> 16);
            bs[mi][h][0] = bs[mi][h][1] = kInf;
            bk[mi][h] = 0;
          }
        __syncthreads();
        {
          // two threads per frame: both take the frame's two best of its
          // 2 x kLists by tensor-core score, and each rescores one of them
          const int row = tid >> 1, part = tid & 1;
          float ts[2] = {kInf, kInf};
          int tk[2] = {0x7fffffff, 0x7fffffff};
          for (int i = 0; i < 2 * kLists; ++i) {
            const float cs_i = cand_s[row * 2 * kLists + i];
            const int ck_i = cand_k[row * 2 * kLists + i];
            if (!(cs_i < kInf)) continue;
            if (better(cs_i, ck_i, ts[0], tk[0])) {
              ts[1] = ts[0];
              tk[1] = tk[0];
              ts[0] = cs_i;
              tk[0] = ck_i;
            } else if (better(cs_i, ck_i, ts[1], tk[1])) {
              ts[1] = cs_i;
              tk[1] = ck_i;
            }
          }
          float v = kInf;
          int k = part ? tk[1] : tk[0];
          if ((part ? ts[1] : ts[0]) < kInf) {
            const double dot = exact_dot<kStream>(
                R, rb, Dp, row, cb + (static_cast<size_t>(st.q) * K + k) * D, D);
            v = __double2float_rn(static_cast<double>(__ldg(csq + static_cast<size_t>(st.q) * K + k)) -
                                  2.0 * dot);
          }
          const float ov = __shfl_xor_sync(0xffffffffu, v, 1);
          const int ok = __shfl_xor_sync(0xffffffffu, k, 1);
          if (better(ov, ok, v, k)) {
            v = ov;
            k = ok;
          }
          if (k == 0x7fffffff) k = 0;  // no code scored below +inf
          if (part == 0) {
            chosen[row] = k;
            if (m0 + row < M) {
              idx[static_cast<size_t>(m0 + row) * n_q + st.q] = k;
              if (best_out != nullptr) best_out[static_cast<size_t>(m0 + row) * n_q + st.q] = v;
            }
          }
        }
        __syncthreads();
        if (st.q + 1 < n_q) {
          // r -= c[idx] in float32, each thread on its groups: the chosen
          // codewords are gathered first (from L2), then each group is
          // rebuilt from its planes, updated and split again in place (in
          // shared memory, or in the block's slot)
          const float* book = cb + static_cast<size_t>(st.q) * K * D;
          constexpr int kG = 4;  // groups per thread per round
          for (int g0 = tid; g0 < kTM * c8n; g0 += kG * kQThreads) {
            float c[kG][8];
#pragma unroll
            for (int u = 0; u < kG; ++u) {
              const int g = g0 + u * kQThreads;
              const int row = g / c8n, d0 = (g - row * c8n) * 8;
              const float* src = book + static_cast<size_t>(chosen[row < kTM ? row : 0]) * D + d0;
              load_code8(src, g < kTM * c8n ? d0 : D, D, c[u]);
            }
#pragma unroll
            for (int u = 0; u < kG; ++u) {
              const int g = g0 + u * kQThreads;
              if (g >= kTM * c8n) continue;
              const int row = g / c8n, c8 = g - row * c8n;
              const int off = group_off<kStream>(rb, Dp, row, c8);
              float v[8];
              load_group(R, Dp, off, v);
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = __fsub_rn(v[e], c[u][e]);
              store_group(R, Dp, off, v);
            }
          }
          if (kStream) {
            // the next book's first stage, its residual part now
            __syncthreads();  // the slot is updated before the copy reads it
            copy_slice(Cs + ((s + 1) & 1) * kStage + kStageElems, Rg, kTM, Dp, min(kKC, Dp));
            cp_async_commit();
          }
        }
      }
    }
  }
}

// The codebooks' planes: cb (n_q, K, D) float32 -> planes (n_q, 3, Kp, Dp)
// bf16, hi, mid, lo of each value (as kernels/residual_stack.py::
// split_planes), zero past K and D. One thread per (book, code, dim).
__global__ void rvq_split_planes_kernel(const float* __restrict__ cb, bf16* __restrict__ planes,
                                        int n_q, int K, int D, int Kp, int Dp) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n_q) * Kp * Dp) return;
  const int d = static_cast<int>(i % Dp);
  const int k = static_cast<int>((i / Dp) % Kp);
  const int q = static_cast<int>(i / (static_cast<size_t>(Dp) * Kp));
  const float v = k < K && d < D ? cb[(static_cast<size_t>(q) * K + k) * D + d] : 0.f;
  uint32_t h, m, l;
  split3(v, h, m, l);
  const size_t plane = static_cast<size_t>(Kp) * Dp;
  unsigned short* out = reinterpret_cast<unsigned short*>(planes) + q * kPlanes * plane +
                        static_cast<size_t>(k) * Dp + d;
  out[0] = static_cast<unsigned short>(h);
  out[plane] = static_cast<unsigned short>(m);
  out[2 * plane] = static_cast<unsigned short>(l);
}

// The dequantize kernel's row vectors: kW floats, 16 bytes or 4.
template <int kW>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ __forceinline__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ static T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                       __fadd_rn(a.w, b.w));
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ __forceinline__ static T zero() { return 0.f; }
  __device__ __forceinline__ static T add(T a, T b) { return __fadd_rn(a, b); }
};

constexpr int kDqThreads = 256;
constexpr int kDqBooks = 8;  // codeword loads a lane issues before the batch's first add

// L lanes per frame (a power of two), 32 / L frames per warp; the warps
// walk over groups of frames. Every loop is uniform across the warp, so
// all its lanes reach each shuffle.
template <int kW>
__global__ void __launch_bounds__(kDqThreads) rvq_dequantize_kernel(
    const int* __restrict__ idx, const float* __restrict__ cb, float* __restrict__ out, int M,
    int n_q, int K, int D, int L) {
  using V = typename Vec<kW>::T;
  const int lane = threadIdx.x & 31, f = lane / L, j = lane % L, F = 32 / L;
  const int nv = D / kW;              // vectors of a row
  const int nb = min(L, kDqBooks);    // books per batch (their indices sit in the frame's lanes)
  const int warps = gridDim.x * (kDqThreads / 32);
  for (int m0 = (blockIdx.x * (kDqThreads / 32) + threadIdx.x / 32) * F; m0 < M; m0 += warps * F) {
    const int m = m0 + f;
    const bool live = m < M;
    const int* row = idx + static_cast<size_t>(m) * n_q;
    for (int v0 = 0; v0 < nv; v0 += L) {
      const int v = v0 + j;
      const bool on = live && v < nv;
      V acc = Vec<kW>::zero();
      for (int q0 = 0; q0 < n_q; q0 += nb) {
        // lane j of the frame loads book q0 + j's index; every lane then
        // takes the batch's indices from its frame's lanes
        const int mine = live && j < nb && q0 + j < n_q ? row[q0 + j] : 0;
        V c[kDqBooks];
#pragma unroll
        for (int u = 0; u < kDqBooks; ++u) {
          const int k = __shfl_sync(0xffffffffu, mine, u, L);
          const bool ok = on && u < nb && q0 + u < n_q && k >= 0 && k < K;
          c[u] = ok ? __ldg(reinterpret_cast<const V*>(cb + (static_cast<size_t>(q0 + u) * K + k) * D) + v)
                    : Vec<kW>::zero();
        }
#pragma unroll
        for (int u = 0; u < kDqBooks; ++u) acc = Vec<kW>::add(acc, c[u]);
      }
      if (on) reinterpret_cast<V*>(out + static_cast<size_t>(m) * D)[v] = acc;
    }
  }
}

// The earlier dequantize (one warp per frame; each lane walks the books for its
// dims lane, lane + 32, ..., one 4-byte load behind a branch at a time),
// kept as the design chip_smoke.py times rvq_dequantize_kernel against.
__global__ void rvq_dequantize_rowwarp_kernel(const int* __restrict__ idx,
                                              const float* __restrict__ cb,
                                              float* __restrict__ out, int M, int n_q,
                                              int K, int D) {
  const int m = blockIdx.x * blockDim.y + threadIdx.y;
  if (m >= M) return;
  const int* row = idx + static_cast<size_t>(m) * n_q;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < n_q; ++q) {
      const int k = row[q];
      if (k >= 0 && k < K) acc = __fadd_rn(acc, cb[(static_cast<size_t>(q) * K + k) * D + d]);
    }
    out[static_cast<size_t>(m) * D + d] = acc;
  }
}

// A persistent grid of whole blocks: at most as many as fit on the card.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem, int needed, int* grid,
                            int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  const int slots = *per_sm * *sms;
  *grid = needed < slots ? needed : slots;
  return cudaSuccess;
}

int quantize_tiles(int M) { return (M + kTM - 1) / kTM; }

template <bool kStream>
cudaError_t quantize_grid_of(int M, int Dp, int* grid, int* per_sm, int* sms) {
  const int smem = quantize_smem(Dp);
  const cudaError_t err = cudaFuncSetAttribute(rvq_quantize_kernel<kStream>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return persistent_grid(rvq_quantize_kernel<kStream>, kQThreads, smem, quantize_tiles(M), grid,
                         per_sm, sms);
}

cudaError_t quantize_grid(int M, int Dp, int* grid, int* per_sm, int* sms) {
  return streamed(Dp) ? quantize_grid_of<true>(M, Dp, grid, per_sm, sms)
                      : quantize_grid_of<false>(M, Dp, grid, per_sm, sms);
}

// lanes per frame: the smallest power of two >= the row's vectors, at most 32
int dequantize_lanes(int nv) {
  int L = 1;
  while (L < nv && L < 32) L <<= 1;
  return L;
}

template <int kW>
cudaError_t dequantize_launch(const int* idx, const float* cb, float* out, int M, int n_q, int K,
                              int D, cudaStream_t stream) {
  const int L = dequantize_lanes(D / kW), F = 32 / L;
  const int warps = (M + F - 1) / F, needed = (warps + kDqThreads / 32 - 1) / (kDqThreads / 32);
  int grid = 0, per_sm = 0, sms = 0;
  const cudaError_t err =
      persistent_grid(rvq_dequantize_kernel<kW>, kDqThreads, 0, needed, &grid, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  rvq_dequantize_kernel<kW><<<grid, kDqThreads, 0, stream>>>(idx, cb, out, M, n_q, K, D, L);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// z (M, D) float32; planes (n_q, 3, Kp, Dp) bf16 (hi, mid, lo of the
// codebooks, zero past K and D); cb (n_q, K, D) and csq (n_q, K) float32;
// scratch: for Dp > 128 (the streamed plan) scratch_blocks slots of
// 3 x 128 x Dp bf16, and the grid takes at most scratch_blocks blocks;
// ignored otherwise (may be null); idx (M, n_q) int32; best (M, n_q)
// float32, the winning (rescored) scores, or null. Kp a multiple of 128
// and at most 65,536, Dp a multiple of 16, Dp >= D.
// Returns the launch's cudaError_t.
extern "C" int nsc_rvq_quantize(const void* z, const void* planes, const void* cb,
                                const void* csq, void* scratch, void* idx, void* best, int M,
                                int n_q, int K, int D, int Kp, int Dp, int scratch_blocks,
                                void* stream) {
  if (M < 1 || n_q < 1 || K < 1 || D < 1 || Dp < D || Dp % 16 != 0 || Kp < K || Kp % kNC != 0 ||
      Kp > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  if (streamed(Dp) && (scratch == nullptr || scratch_blocks < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0, per_sm = 0, sms = 0;
  cudaError_t err = quantize_grid(M, Dp, &grid, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto zf = static_cast<const float*>(z);
  const auto pl = static_cast<const bf16*>(planes);
  const auto cf = static_cast<const float*>(cb);
  const auto qf = static_cast<const float*>(csq);
  const auto rs = static_cast<bf16*>(scratch);
  const auto ip = static_cast<int*>(idx);
  const auto bp = static_cast<float*>(best);
  if (streamed(Dp)) {
    const int blocks = grid < scratch_blocks ? grid : scratch_blocks;  // a slot each
    rvq_quantize_kernel<true><<<blocks, kQThreads, quantize_smem(Dp), s>>>(
        zf, pl, cf, qf, rs, ip, bp, M, n_q, K, D, Kp, Dp, quantize_tiles(M));
  } else {
    rvq_quantize_kernel<false><<<grid, kQThreads, quantize_smem(Dp), s>>>(
        zf, pl, cf, qf, rs, ip, bp, M, n_q, K, D, Kp, Dp, quantize_tiles(M));
  }
  return static_cast<int>(cudaGetLastError());
}

// cb (n_q, K, D) float32 -> planes (n_q, 3, Kp, Dp) bf16, the quantize
// kernel's codebook operand. Returns the launch's cudaError_t.
extern "C" int nsc_rvq_split_planes(const void* cb, void* planes, int n_q, int K, int D, int Kp,
                                    int Dp, void* stream) {
  if (n_q < 1 || K < 1 || D < 1 || Kp < K || Dp < D) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(n_q) * Kp * Dp;
  rvq_split_planes_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cb), static_cast<bf16*>(planes), n_q, K, D, Kp, Dp);
  return static_cast<int>(cudaGetLastError());
}

// The quantize launch's plan for M frames of padded width Dp: 6 long longs,
// tiles, blocks (the grid), blocks per SM, SMs, shared-memory bytes, and
// the plan (0 resident, 1 streamed).
extern "C" int nsc_rvq_quantize_plan(int M, int Dp, void* plan) {
  int grid = 0, per_sm = 0, sms = 0;
  const cudaError_t err = quantize_grid(M, Dp, &grid, &per_sm, &sms);
  long long* o = static_cast<long long*>(plan);
  o[0] = quantize_tiles(M);
  o[1] = grid;
  o[2] = per_sm;
  o[3] = sms;
  o[4] = quantize_smem(Dp);
  o[5] = streamed(Dp);
  return static_cast<int>(err);
}

// idx (M, n_q) int32, cb (n_q, K, D) float32 -> out (M, D) float32. Rows
// go 16 bytes a lane where D % 4 == 0 and cb and out are 16-byte aligned,
// 4 bytes a lane otherwise.
extern "C" int nsc_rvq_dequantize(const void* idx, const void* cb, void* out,
                                  int M, int n_q, int K, int D, void* stream) {
  if (M < 1 || n_q < 1 || K < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto i = static_cast<const int*>(idx);
  const auto c = static_cast<const float*>(cb);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D % 4 == 0 && aligned16(cb) && aligned16(out)
                              ? dequantize_launch<4>(i, c, o, M, n_q, K, D, s)
                              : dequantize_launch<1>(i, c, o, M, n_q, K, D, s);
  return static_cast<int>(err);
}

// The same function by the earlier design (rvq_dequantize_rowwarp_kernel).
extern "C" int nsc_rvq_dequantize_rowwarp(const void* idx, const void* cb, void* out, int M,
                                          int n_q, int K, int D, void* stream) {
  if (M < 1 || n_q < 1 || K < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  rvq_dequantize_rowwarp_kernel<<<(M + block.y - 1) / block.y, block, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(cb), static_cast<float*>(out), M,
      n_q, K, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
