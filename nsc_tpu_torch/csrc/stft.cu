// Framed STFT magnitude for the spectral losses, for Hopper (sm_90a).
//
// Replaces nsc_tpu/ops/pallas/stft.py::stft_magnitude_pallas (_stft_kernel).
// For each row b, frame f and bin k of a signal reflect-padded by n_fft/2
// on both sides:
//   X[b, f, k] = sum_n (x[b, f*hop + n] * win[n]) * exp(-2 pi i n k / n_fft)
//   out[b, f, k] = sqrt(re*re + im*im + 1e-8)
// with the periodic Hann window. The point of the TPU kernel is that the
// frame tensor, n_fft/hop times the signal, never reaches device memory;
// the four routes here keep that property, and each reads the frame's
// samples from the unpadded signal through the reflect index (no padded
// copy, nothing staged; the two-level route keeps its transforms' points,
// not frames, in a scratch buffer). The wrapper (kernels/stft.py::route)
// picks one by n_fft alone.
//
// All four compute in float64 and round each output once to float32: each
// magnitude is that of the true float64 spectrum of the float32 input,
// correctly rounded. The spectral losses' gradients need that: the
// log-magnitude term is an L1 whose gradient changes sign where
// reconstruction and target magnitudes nearly tie, so any rounding of
// ~1e-7 of a frame's peak flips the sign at some low bins, and a float32
// forward is as far from the float64 gradient as the draw of those flips
// makes it. They read the float64 window and float64 tables tw[j] =
// exp(-2 pi i j / t) of the length t each names.
//
// The transforms: an N-point complex transform as a pass list (4 bits a
// radix from the lowest; radices 4, 2, 3, 5 and 7 whose product is N; the
// host writes it, the launchers check only the product). Each pass is done
// in place in ONE shared buffer of N complex float64 points a frame: a
// butterfly of radix R at (p, k) reads its R points at base + m p into
// registers, twiddles them by W_(R p)^(m k) from the table, takes their
// R-point DFT (4 and 2 in closed form, odd R in pairs (t, R - t) with the
// constants W_R^j from the table) and writes them back to the same R
// positions, so the butterflies of a pass touch disjoint points and one
// barrier a pass is all they need. That is the decimation-in-time order:
// the input is loaded digit-reversed and the output comes out in natural
// order, through the very butterflies and twiddles of a two-buffer
// Stockham plan (the same float64 arithmetic, in half its shared memory).
// Its transpose, the same passes last to first with the
// twiddles after the butterfly (decimation in frequency), takes natural
// order to digit-reversed. Two refinements, both measured on an H100: a
// point's slot is its position XOR-swizzled within its aligned group of 8
// (`slot`), which takes the bank conflicts out of the digit-reversed load
// and the first passes' strided butterflies; and where a block's frames
// hold enough points, two consecutive passes run in one round trip through
// shared memory (`pass_pair`: the same arithmetic, half the traffic and
// barriers).
//
// stft_magnitude_kernel, the real FFT, for the n_fft the wrapper gives it
// a pass list for (kernels/stft.py::fft_passes, the one statement of the
// route's domain): even n_fft whose half has no prime factor above 7, from
// 16 up to the n_fft whose one-frame plan fills a block's shared memory
// (8 n_fft bytes: 29,056). One block owns one (row, tile of FT frames, FT n
// <= 4096, so the short windows of the loss bank share a block); it windows
// each frame in float64 straight from the L2-resident signal and packs it
// into an n/2-point complex sequence (even samples real, odd imaginary),
// each point stored where the host's load order puts it (`order`, the
// digit reversal of the pass list: one coalesced int read a point, cheaper
// than the reversal's divisions), runs the DIT passes on all FT frames at
// once, and the post-twiddle X[k] = Ze[k] + W^k Zo[k] splits the complex
// spectrum into the real one; the magnitudes (and, for the backward, re and
// im) are written coalesced by bin. What bounds it on the H100: ~2.5 n
// log2 n float64 FLOP per frame and 4 bytes per output bin, near each other
// at the card's float64 and memory rates; in practice the shared-memory
// traffic of the passes, 16 bytes a point each way.
//
// stft_magnitude_bluestein_kernel, the chirp-z transform, for every other
// n_fft >= 2 whose plan fits a block (kernels/stft.py::bluestein_plan).
// With L = n (odd n: two real frames as one complex sequence, a + i a',
// whose spectra the end splits apart, X = (Z[k] + conj Z[n-k]) / 2 and X' =
// (Z[k] - conj Z[n-k]) / (2i), so a transform serves two frames) or L =
// n/2 (even n: the packed sequence of the real FFT) and the chirp c_j =
// exp(-pi i j^2 / L) = tw2L[j^2 mod 2L] (the index reduced in integers,
// never through a float j^2; 32-bit suffices, j < L < 65536): Z[k] = c_k
// sum_j (z_j c_j) conj(c_(k-j)), a cyclic convolution of length M, the
// smallest 7-smooth number >= 2L - 1, so that both M-point transforms run
// on the passes above. Per frame: the chirped frame, zero-padded to M, in
// natural order; the DIF passes (digit-reversed out); times the host's
// float64 transform of the conjugate chirp (stored in that digit-reversed
// order with the 1/M of the inverse folded in, read from L2), conjugated;
// the DIT passes (natural order out: the conjugate of the convolution);
// times c_k after conjugating back; for an even n the real FFT's
// post-twiddle, whose W^k is tw2L[k] (2L = n). 16 M bytes a transform, so M up
// to 14,528: odd n to 7,203, even n to 14,404. Its operations are those of
// two M-point transforms, ~4-9x the real FFT's at the same n (half that a frame
// for an odd n).
//
// stft_magnitude_bluestein_cluster_kernel, the same chirp-z transform where
// its M points outgrow a block (kernels/stft.py::bluestein_cluster_plan):
// odd n from 7,205 to 57,599 and even n from 14,408 to 115,200 that the FFT
// route does not take. A thread-block cluster of C = 2, 4 or 8 blocks on
// neighbouring SMs owns one transform; block r holds the contiguous points
// [r S, (r + 1) S), S = M / C, in its shared memory (16 S bytes, up to 225 KB,
// so one block an SM). M is the smallest 7-smooth number >= 2L - 1 that 8 C
// divides, and the pass list that of S followed by that of C: every pass but
// the last one or two (whose radices multiply to C) has butterflies within
// a share, and runs on it alone through the one-block kernel's device
// functions; the passes across the shares (`cross_passes`: the first DIF
// passes, at the largest strides, and the last DIT ones) gather the C
// points k + j S of each local offset k from the C blocks' shared memory
// (distributed shared memory, `map_shared_rank`), run in registers and
// write back, a cluster barrier before and after. The end steps read Z[n -
// k] (odd n) or Z[L - k] (even n) from the block that holds it. The same
// float64 butterflies and twiddles per point as the one-block kernel at the
// same M and pass list, so the two agree bit for bit there. What bounds it:
// as the one-block kernel, the shared-memory traffic of the passes (16
// bytes a point each way), far above the byte bound (the samples read once,
// the bins written once); a cross pass moves its points through the SM-to-
// SM network instead, once per transform each way. What the cluster buys:
// 8x a block's shared memory for one transform, so an n whose chirp-z plan
// outgrows a block still runs on two M-point FFTs without leaving the
// chip's SRAM. Clusters stop at 8, the portable size.
//
// stft_magnitude_bluestein_global_*_kernel, the same chirp-z transform in
// two levels through global memory, for every n_fft no 8-block cluster
// holds (kernels/stft.py::bluestein_global_plan): odd n from 57,601 and even
// n from 115,202. M is the smallest 7-smooth multiple of 8 >= 2L - 1, split
// into C shares of S points, S the largest divisor of M that 8 divides and
// that is at most kBluesteinPoints (the points one chirp-z block holds), C =
// M / S; the pass list is that of S followed by that of C, as the cluster
// kernel's. The points of each transform live in a scratch buffer the
// wrapper allocates (16 M bytes a transform, share-major: point g at g), and
// four kernels run in turn on the caller's stream, each as wide as the
// card: _cross_dif, one block per (transform, tile of kt local offsets k),
// makes the chirped points k + j S (j < C) straight from the signal, runs
// the passes across the shares (radices multiplying to C) in shared memory
// on the tile and writes the points; _share, one block per (transform,
// share), is the cluster kernel's middle (the passes within the share, the
// product with the conjugate chirp's transform, the DIT passes); _cross_dit
// runs the DIT passes across the shares on the tiles and writes Z[g] = c_g
// conj(G[g]) for g < L; _end splits Z into the bins. The same float64
// butterflies and twiddles per point as the one-block and cluster kernels
// at the same M and pass list, so the three agree bit for bit there; the
// chirp index j^2 mod 2L is taken in 64 bits (j^2 passes 2^32 from j =
// 65,536). What bounds it: four round trips of 16 bytes a point through L2
// and HBM, above K4's byte bound (the samples read once, the bins written
// once), and the passes' shared-memory traffic as in the other chirp-z
// kernels. Its reach: M up to 2^20 (odd n to 524,287, even n to
// 1,048,576), where C stays at most 1,771 (S >= 592) and a tile of 8
// offsets of C points fits a block; the wrapper raises beyond. It replaces
// the O(n^2) DFT that earlier served these n_fft.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes of shared memory one block may use on Hopper
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

__device__ __forceinline__ double2 conjugate(double2 a) { return make_double2(a.x, -a.y); }

// ---------------------------------------------------------------------------
// The passes, in float64.

// The number of passes of a pass list (4 bits a radix from the lowest, 0
// ends it) if it is a transform of n points: radices 2, 3, 4, 5 and 7 whose
// product is n (the empty list for n = 1); else -1. Each prefix's product p
// then times the next radix R divides n, so the twiddle stride t / (R p) of
// a table of t = a multiple of n entries is an integer.
inline int transform_passes(long long n, unsigned long long radices) {
  long long prod = 1;
  int passes = 0;
  for (; radices != 0; radices >>= 4, ++passes) {
    const int r = static_cast<int>(radices & 15);
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7) return -1;
    prod *= r;
  }
  return prod == n ? passes : -1;
}

__device__ __forceinline__ int pass_count(unsigned long long radices) {
  int s = 0;
  for (; radices != 0; radices >>= 4) ++s;
  return s;
}

// The slot of point pos in its frame's buffer of n points: for n a
// multiple of 8, pos with its low 3 bits XORed by bits 3-5, 6-8 and 9-11 (a
// permutation within each aligned group of 8, so the slot stays below n).
// A 16-byte point's bank group is its slot mod 8: the swizzle spreads the
// digit-reversed load's stores (points n/4 apart) and the first passes'
// strided butterflies over the banks, and leaves 8 consecutive points of an
// aligned group on 8 banks. The identity for other n.
__device__ __forceinline__ int slot(int pos, int n) {
  return (n & 7) != 0 ? pos : pos ^ (((pos >> 3) ^ (pos >> 6) ^ (pos >> 9)) & 7);
}

// y = the R-point DFT of u, W_R^j = tw[j tn / R] (tn: the table's length)
template <int R>
__device__ __forceinline__ void butterfly(const double2 (&u)[R], double2 (&y)[R],
                                          const double2* __restrict__ tw, int tn) {
  if constexpr (R == 4) {
    const double2 a0 = make_double2(u[0].x + u[2].x, u[0].y + u[2].y);
    const double2 a1 = make_double2(u[0].x - u[2].x, u[0].y - u[2].y);
    const double2 a2 = make_double2(u[1].x + u[3].x, u[1].y + u[3].y);
    const double2 a3 = make_double2(u[1].x - u[3].x, u[1].y - u[3].y);
    y[0] = make_double2(a0.x + a2.x, a0.y + a2.y);
    y[1] = make_double2(a1.x + a3.y, a1.y - a3.x);   // a1 - i a3
    y[2] = make_double2(a0.x - a2.x, a0.y - a2.y);
    y[3] = make_double2(a1.x - a3.y, a1.y + a3.x);   // a1 + i a3
  } else if constexpr (R == 2) {
    y[0] = make_double2(u[0].x + u[1].x, u[0].y + u[1].y);
    y[1] = make_double2(u[0].x - u[1].x, u[0].y - u[1].y);
  } else {
    // odd R, in pairs (t, R - t): with a_m = u_m + u_(R-m), b_m = u_m -
    // u_(R-m) and W_R^(m t) = (c, s) = tw[(m t mod R) tn / R],
    // y_t = u_0 + sum_m (a_m c + i s b_m), y_(R-t) = u_0 + sum_m (a_m c - i s b_m)
    constexpr int H = (R - 1) / 2;
    const int stride = tn / R;
    double2 a[H], b[H];
    double2 y0 = u[0];
#pragma unroll
    for (int m = 1; m <= H; ++m) {
      a[m - 1] = make_double2(u[m].x + u[R - m].x, u[m].y + u[R - m].y);
      b[m - 1] = make_double2(u[m].x - u[R - m].x, u[m].y - u[R - m].y);
      y0 = make_double2(y0.x + a[m - 1].x, y0.y + a[m - 1].y);
    }
    y[0] = y0;
#pragma unroll
    for (int t = 1; t <= H; ++t) {
      double2 re = u[0], im = make_double2(0.0, 0.0);
#pragma unroll
      for (int m = 1; m <= H; ++m) {
        const double2 w = __ldg(tw + ((m * t) % R) * stride);
        re = make_double2(re.x + a[m - 1].x * w.x, re.y + a[m - 1].y * w.x);
        im = make_double2(im.x + b[m - 1].x * w.y, im.y + b[m - 1].y * w.y);
      }
      y[t] = make_double2(re.x - im.y, re.y + im.x);        // re + i im
      y[R - t] = make_double2(re.x + im.y, re.y - im.x);    // re - i im
    }
  }
}

// One pass of radix R over nfr frames of n points each (frame stride n),
// in place: butterfly i of a frame (k = i mod p) owns the points (i - k) R
// + k + m p, m < R. DIT (kDif false) twiddles the inputs by W^(m k tn/(R
// p)) (tw[j] = W^j = exp(-2 pi i j / tn)) before the R-point DFT; DIF, its
// transpose, twiddles the outputs after it.
template <int R, bool kDif, int kT>
__device__ __forceinline__ void pass(double2* __restrict__ buf, const double2* __restrict__ tw,
                                     int nfr, int n, int tn, int p) {
  const int q = n / R;
  const int step = tn / (R * p);
  for (int g = threadIdx.x; g < nfr * q; g += kT) {
    const int f = g / q, i = g - f * q, k = i % p;
    double2* d = buf + f * n;
    const int base = (i - k) * R + k;
    double2 u[R], y[R];
#pragma unroll
    for (int m = 0; m < R; ++m) u[m] = d[slot(base + m * p, n)];
    if (!kDif && p > 1) {
#pragma unroll
      for (int m = 1; m < R; ++m) u[m] = cmul(u[m], __ldg(tw + m * k * step));
    }
    butterfly<R>(u, y, tw, tn);
    if (kDif && p > 1) {
#pragma unroll
      for (int t = 1; t < R; ++t) y[t] = cmul(y[t], __ldg(tw + t * k * step));
    }
#pragma unroll
    for (int t = 0; t < R; ++t) d[slot(base + t * p, n)] = y[t];
  }
}

// Two DIT passes in one round trip through shared memory: radix RA at p,
// then radix RB at RA p. The RA RB points at (i - k) RA RB + k + a p + b RA
// p (k = i mod p; a < RA, b < RB) are closed under both passes, so a thread
// takes them into registers once, runs the RB butterflies of radix RA and
// the RA of radix RB there (the very butterflies and twiddles of the two
// passes, in the same order per point) and writes them back: half the
// shared traffic and barriers of two passes.
template <int RA, int RB, int kT>
__device__ __forceinline__ void pass_pair(double2* __restrict__ buf,
                                          const double2* __restrict__ tw, int nfr, int n, int tn,
                                          int p) {
  constexpr int RR = RA * RB;
  const int q = n / RR;
  const int step_a = tn / (RA * p), step_b = tn / (RR * p);
  for (int g = threadIdx.x; g < nfr * q; g += kT) {
    const int f = g / q, i = g - f * q, k = i % p;
    double2* d = buf + f * n;
    const int base = (i - k) * RR + k;
    double2 u[RR];
#pragma unroll
    for (int m = 0; m < RR; ++m) u[m] = d[slot(base + m * p, n)];  // u[a + RA b] at a p + b RA p
    // the radix-RA butterflies at p, one per b
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      double2 v[RA], y[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) v[a] = u[a + RA * b];
      if (p > 1) {
#pragma unroll
        for (int a = 1; a < RA; ++a) v[a] = cmul(v[a], __ldg(tw + a * k * step_a));
      }
      butterfly<RA>(v, y, tw, tn);
#pragma unroll
      for (int a = 0; a < RA; ++a) u[a + RA * b] = y[a];
    }
    // the radix-RB butterflies at RA p, one per t (k' = k + t p)
#pragma unroll
    for (int t = 0; t < RA; ++t) {
      const int kk = k + t * p;
      double2 v[RB], y[RB];
#pragma unroll
      for (int b = 0; b < RB; ++b) v[b] = u[t + RA * b];
#pragma unroll
      for (int b = 1; b < RB; ++b) v[b] = cmul(v[b], __ldg(tw + b * kk * step_b));
      butterfly<RB>(v, y, tw, tn);
#pragma unroll
      for (int b = 0; b < RB; ++b) u[t + RA * b] = y[b];
    }
#pragma unroll
    for (int m = 0; m < RR; ++m) d[slot(base + m * p, n)] = u[m];
  }
}

template <bool kDif, int kT>
__device__ __forceinline__ void run_pass(int r, double2* buf, const double2* tw, int nfr, int n,
                                         int tn, int p) {
  switch (r) {
    case 4: pass<4, kDif, kT>(buf, tw, nfr, n, tn, p); break;
    case 2: pass<2, kDif, kT>(buf, tw, nfr, n, tn, p); break;
    case 3: pass<3, kDif, kT>(buf, tw, nfr, n, tn, p); break;
    case 5: pass<5, kDif, kT>(buf, tw, nfr, n, tn, p); break;
    default: pass<7, kDif, kT>(buf, tw, nfr, n, tn, p); break;
  }
}

// Two consecutive DIT passes (radix ra at p, rb at ra p) as one pass_pair
// where the pair has one (the pairs of the pass lists' order 4, 2, 3, 5, 7
// whose RA RB points fit in registers: at most 16): true if it ran them.
template <int kT>
__device__ __forceinline__ bool run_pair(int ra, int rb, double2* buf, const double2* tw, int nfr,
                                         int n, int tn, int p) {
  switch (ra * 16 + rb) {
    case 4 * 16 + 4: pass_pair<4, 4, kT>(buf, tw, nfr, n, tn, p); return true;
    case 4 * 16 + 2: pass_pair<4, 2, kT>(buf, tw, nfr, n, tn, p); return true;
    case 4 * 16 + 3: pass_pair<4, 3, kT>(buf, tw, nfr, n, tn, p); return true;
    case 2 * 16 + 3: pass_pair<2, 3, kT>(buf, tw, nfr, n, tn, p); return true;
    case 2 * 16 + 5: pass_pair<2, 5, kT>(buf, tw, nfr, n, tn, p); return true;
    case 2 * 16 + 7: pass_pair<2, 7, kT>(buf, tw, nfr, n, tn, p); return true;
    case 3 * 16 + 3: pass_pair<3, 3, kT>(buf, tw, nfr, n, tn, p); return true;
    case 3 * 16 + 5: pass_pair<3, 5, kT>(buf, tw, nfr, n, tn, p); return true;
    default: return false;
  }
}

// The DIT passes, first to last (with kPairs, two at a time where run_pair
// takes them): digit-reversed in, natural order out.
template <bool kPairs, int kT>
__device__ __forceinline__ void dit_passes(double2* buf, const double2* tw, int nfr, int n,
                                           int tn, unsigned long long radices) {
  int p = 1;
  while (radices != 0) {
    const int ra = static_cast<int>(radices & 15), rb = static_cast<int>((radices >> 4) & 15);
    if (kPairs && rb != 0 && run_pair<kT>(ra, rb, buf, tw, nfr, n, tn, p)) {
      radices >>= 8;
      p *= ra * rb;
    } else {
      run_pass<false, kT>(ra, buf, tw, nfr, n, tn, p);
      radices >>= 4;
      p *= ra;
    }
    __syncthreads();
  }
}

// The DIF passes, last to first: natural order in, digit-reversed out.
template <int kT>
__device__ __forceinline__ void dif_passes(double2* buf, const double2* tw, int nfr, int n,
                                           int tn, unsigned long long radices, int passes) {
  int p = n;
  for (int j = passes - 1; j >= 0; --j) {
    const int r = static_cast<int>((radices >> (4 * j)) & 15);
    p /= r;
    run_pass<true, kT>(r, buf, tw, nfr, n, tn, p);
    __syncthreads();
  }
}

// Bin k of the real spectrum from the n2-point transform Z of a packed
// sequence: X[k] = Ze[k] + W^k Zo[k], Ze = (Z[k] + conj Z[n2-k]) / 2, Zo =
// (Z[k] - conj Z[n2-k]) / (2i), from a = Z[k mod n2], c = Z[(n2 - k) mod
// n2] and w = W^k.
__device__ __forceinline__ double2 real_bin(double2 a, double2 c, double2 w) {
  const double er = 0.5 * (a.x + c.x), ei = 0.5 * (a.y - c.y);
  const double orr = 0.5 * (a.y + c.y), oi = -0.5 * (a.x - c.x);
  const double2 t = cmul(make_double2(orr, oi), w);
  return make_double2(er + t.x, ei + t.y);
}

// Bin k of one of two real frames carried as Z = X + i X': X[k] = (Z[k] +
// conj Z[n-k]) / 2 (the first), X'[k] = (Z[k] - conj Z[n-k]) / (2i) (the
// second), from a = Z[k] and c = Z[(n - k) mod n].
__device__ __forceinline__ double2 split_bin(double2 a, double2 c, bool second) {
  return second ? make_double2(0.5 * (a.y + c.y), -0.5 * (a.x - c.x))
                : make_double2(0.5 * (a.x + c.x), 0.5 * (a.y - c.y));
}

// The magnitude of v at o, and re, im where asked, each rounded once.
__device__ __forceinline__ void store_bin(double2 v, size_t o, float* __restrict__ out,
                                          float* __restrict__ re_out,
                                          float* __restrict__ im_out) {
  out[o] = static_cast<float>(sqrt(v.x * v.x + v.y * v.y + kEps));
  if (re_out != nullptr) {
    re_out[o] = static_cast<float>(v.x);
    im_out[o] = static_cast<float>(v.y);
  }
}

// The real spectrum of ft frames from the n2-point transforms Z of their
// packed sequences (natural order in frames of `stride` slots; `real_bin`,
// W^k = tw[k] of a table of 2 n2 entries).
template <int kT>
__device__ __forceinline__ void write_real_spectrum(const double2* z, int stride, int n2,
                                                    const double2* __restrict__ tw,
                                                    float* __restrict__ out,
                                                    float* __restrict__ re_out,
                                                    float* __restrict__ im_out, int b, int f0,
                                                    int ft, int F) {
  const int K = n2 + 1;
  for (int g = threadIdx.x; g < ft * K; g += kT) {
    // bins k < n2 frame by frame (8 lanes on 8 consecutive points), then k = n2
    const int f = g < ft * n2 ? g / n2 : g - ft * n2;
    const int k = g < ft * n2 ? g - f * n2 : n2;
    if (f0 + f >= F) continue;
    const double2 a = z[f * stride + slot(k == n2 ? 0 : k, stride)];
    const double2 c = z[f * stride + slot(k == 0 ? 0 : n2 - k, stride)];
    store_bin(real_bin(a, c, __ldg(tw + k)), (static_cast<size_t>(b) * F + f0 + f) * K + k, out,
              re_out, im_out);
  }
}

// ---------------------------------------------------------------------------
// The real FFT.

constexpr int kFramePoints = 4096;   // real samples of the frames a block holds
// A block whose frames hold at least kPairPoints complex points, each at
// least kPairFramePoints, runs the passes two at a time (pass_pair: ft n/2 /
// 16 >= 128 butterfly pairs, half the threads busy); elsewhere the one-pass
// kernel, whose lower register count (68 against 104) keeps more blocks on
// an SM, is the faster (NVIDIA H100, 64 x 1 s: at n_fft 128, 400 and 2400
// it is, at 256 to 12000 the pairs are).
constexpr int kPairPoints = 2048;
constexpr int kPairFramePoints = 128;

// Shared-memory bytes of a block of ft frames: one buffer of n/2 complex
// float64 points a frame, 8 n bytes (exported with the frames as
// nsc_stft_fft_plan).
__host__ __device__ inline int fft_smem(int n, int ft) { return 8 * ft * n; }
// the largest power of two with ft * n <= kFramePoints (at least 1)
inline int fft_frames(int n) {
  int ft = 1;
  while (2 * ft * n <= kFramePoints) ft *= 2;
  return ft;
}

// x (B, T) float32 unpadded; win (n) and tw (n complex) float64; out (B,
// F, n/2 + 1) float32, re and im likewise or null; radices: the pass list.
template <bool kPairs>
__global__ void __launch_bounds__(kThreads) stft_magnitude_kernel(
    const float* __restrict__ x, const double* __restrict__ win,
    const double2* __restrict__ tw, const int* __restrict__ order, float* __restrict__ out,
    float* __restrict__ re_out, float* __restrict__ im_out, int T, int n, int hop, int F, int ft,
    unsigned long long radices) {
  extern __shared__ __align__(16) double2 smd[];  // [ft][n2]
  const int n2 = n / 2;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * ft;
  const float* row = x + static_cast<size_t>(b) * T;

  // window and pack, digit-reversed: z[m] = (x[2m] w[2m], x[2m+1] w[2m+1])
  for (int g = threadIdx.x; g < ft * n2; g += kThreads) {
    const int f = g / n2, m = g - f * n2;
    const long long P = static_cast<long long>(f0 + f) * hop + 2 * m;
    smd[f * n2 + slot(__ldg(order + m), n2)] =
        make_double2(static_cast<double>(reflected(row, P, T, n2)) * __ldg(win + 2 * m),
                     static_cast<double>(reflected(row, P + 1, T, n2)) * __ldg(win + 2 * m + 1));
  }
  __syncthreads();
  dit_passes<kPairs, kThreads>(smd, tw, ft, n2, n, radices);
  write_real_spectrum<kThreads>(smd, n2, n2, tw, out, re_out, im_out, b, f0, ft, F);
}

// ---------------------------------------------------------------------------
// The chirp-z (Bluestein) transform.

constexpr int kBluesteinPoints = 4096;  // complex points of the transforms a block holds

// Shared-memory bytes of a block of ft transforms: one buffer of M complex
// float64 points each, 16 M bytes (exported with the transforms as
// nsc_stft_bluestein_plan).
inline int bluestein_smem(int m, int ft) { return 16 * ft * m; }
// the largest power of two with ft * M <= kBluesteinPoints (at least 1)
inline int bluestein_frames(int m) {
  int ft = 1;
  while (2 * ft * m <= kBluesteinPoints) ft *= 2;
  return ft;
}

// x (B, T) float32 unpadded; win (n) float64; chirp (2L complex) float64,
// tw2L[j] = exp(-2 pi i j / 2L); twm (M complex) the M-point table; fb (M
// complex) the transform of the conjugate chirp over M, in the DIF output
// order, times 1/M; out (B, F, n/2 + 1) float32, re and im likewise or
// null; radices: the pass list of M.
__global__ void __launch_bounds__(kThreads) stft_magnitude_bluestein_kernel(
    const float* __restrict__ x, const double* __restrict__ win,
    const double2* __restrict__ chirp, const double2* __restrict__ twm,
    const double2* __restrict__ fb, float* __restrict__ out, float* __restrict__ re_out,
    float* __restrict__ im_out, int T, int n, int hop, int F, int ft, int M,
    unsigned long long radices) {
  extern __shared__ __align__(16) double2 smd[];  // [ft][M]
  const bool odd = (n & 1) != 0;
  const int L = odd ? n : n / 2;
  const unsigned two_l = 2 * static_cast<unsigned>(L);  // j^2 < 2^32: L < 65536
  const int pad = n / 2;
  const int b = blockIdx.y;
  const int fpt = odd ? 2 : 1;  // frames a transform carries
  const int f0 = blockIdx.x * ft * fpt;
  const float* row = x + static_cast<size_t>(b) * T;
  const int passes = pass_count(radices);

  // the chirped sequence z_j c_j, zero from L to M, natural order: for an
  // even n the packed frame, for an odd n two frames, z_j = a_j + i a'_j
  for (int g = threadIdx.x; g < ft * M; g += kThreads) {
    const int t = g / M, j = g - t * M;
    double2 v = make_double2(0.0, 0.0);
    if (j < L) {
      const long long P = static_cast<long long>(f0 + fpt * t) * hop + (odd ? j : 2 * j);
      const int w = odd ? j : 2 * j;
      const long long Q = odd ? P + hop : P + 1;  // the other frame's sample, or the odd one
      const double2 z =
          make_double2(static_cast<double>(reflected(row, P, T, pad)) * __ldg(win + w),
                       static_cast<double>(reflected(row, Q, T, pad)) * __ldg(win + w + 1 - odd));
      const unsigned jj = static_cast<unsigned>(j);
      v = cmul(z, __ldg(chirp + (jj * jj) % two_l));
    }
    smd[t * M + slot(j, M)] = v;
  }
  __syncthreads();
  dif_passes<kThreads>(smd, twm, ft, M, M, radices, passes);
  // times the conjugate chirp's transform (both digit-reversed), conjugated:
  // the DIT passes then give the conjugate of the convolution, times M
  for (int g = threadIdx.x; g < ft * M; g += kThreads) {
    const int t = g / M, pos = g - t * M;
    double2* v = smd + t * M + slot(pos, M);
    *v = conjugate(cmul(*v, __ldg(fb + pos)));
  }
  __syncthreads();
  dit_passes<false, kThreads>(smd, twm, ft, M, M, radices);
  // Z[k] = c_k conj(G[k]), k < L, in place
  for (int g = threadIdx.x; g < ft * L; g += kThreads) {
    const int t = g / L, k = g - t * L;
    const unsigned kk = static_cast<unsigned>(k);
    double2* v = smd + t * M + slot(k, M);
    *v = cmul(conjugate(*v), __ldg(chirp + (kk * kk) % two_l));
  }
  __syncthreads();
  if (!odd) {
    // the real FFT's post-twiddle (W^k = tw2L[k]: 2L = n)
    write_real_spectrum<kThreads>(smd, M, L, chirp, out, re_out, im_out, b, f0, ft, F);
    return;
  }
  // two real frames from Z = X + i X': X[k] = (Z[k] + conj Z[n-k]) / 2,
  // X'[k] = (Z[k] - conj Z[n-k]) / (2i), for the n/2 + 1 bins
  const int K = n / 2 + 1;
  for (int g = threadIdx.x; g < 2 * ft * K; g += kThreads) {
    const int h = g / K, k = g - h * K, t = h >> 1, second = h & 1;
    const int f = f0 + h;
    if (f >= F) continue;
    const double2 a = smd[t * M + slot(k, M)];
    const double2 c = smd[t * M + slot(k == 0 ? 0 : n - k, M)];
    store_bin(split_bin(a, c, second), (static_cast<size_t>(b) * F + f) * K + k, out, re_out,
              im_out);
  }
}

// ---------------------------------------------------------------------------
// The chirp-z transform over a thread-block cluster.

// Threads of a cluster block: a share of 117-227 KB leaves one block on an
// SM, so the block alone has to hide the float64 and shared-memory latency
// (kThreads would be 8 warps on the SM). 512 keeps 128 registers a thread;
// 1024 (64 registers) spills.
constexpr int kClusterThreads = 512;

// The passes across a cluster's blocks, the last of the pass list: radix C
// for C 2 and 4, radix 4 then radix 2 for C 8, at p = S (the share) and, for
// the radix 2 of C 8, 4 S. Their butterflies touch, for each local offset k
// < S, the C points k + j S (j < C), point j in block j: a thread gathers
// them through distributed shared memory (pts[j], block j's slot of k), runs
// the passes in registers and writes them back. DIT (kDif false): the very
// butterflies and twiddles of `pass<C, false>` at p = S, or of `pass_pair<4,
// 2>` (the radix-4 pass at S and the radix-2 pass at 4 S in one round trip);
// DIF, the transpose: the radix-2 pass at 4 S then the radix-4 pass at S,
// each as `pass<R, true>` does it. tw: the M-point table.
template <int C, bool kDif>
__device__ __forceinline__ void cross_passes(double2 (&u)[C], const double2* __restrict__ tw, int M,
                                             int k) {
  if constexpr (C == 8 && !kDif) {
    // radix 4 at p = S (twiddle step M / (4 S) = 2), radix 2 at 4 S (step 1)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      double2 v[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) v[a] = u[a + 4 * b];
#pragma unroll
      for (int a = 1; a < 4; ++a) v[a] = cmul(v[a], __ldg(tw + a * k * 2));
      butterfly<4>(v, y, tw, M);
#pragma unroll
      for (int a = 0; a < 4; ++a) u[a + 4 * b] = y[a];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int kk = k + t * (M / 8);
      double2 v[2] = {u[t], u[t + 4]}, y[2];
      v[1] = cmul(v[1], __ldg(tw + kk));
      butterfly<2>(v, y, tw, M);
      u[t] = y[0];
      u[t + 4] = y[1];
    }
  } else if constexpr (C == 8) {
    const int S = M / 8;
#pragma unroll
    for (int a = 0; a < 4; ++a) {  // radix 2 at p = 4 S: points k + a S and k + (a + 4) S
      const double2 v[2] = {u[a], u[a + 4]};
      double2 y[2];
      butterfly<2>(v, y, tw, M);
      u[a] = y[0];
      u[a + 4] = cmul(y[1], __ldg(tw + (k + a * S)));  // step M / (2 * 4 S) = 1
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {  // radix 4 at p = S: points k + (4 b + m) S
      double2 v[4], y[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) v[m] = u[4 * b + m];
      butterfly<4>(v, y, tw, M);
#pragma unroll
      for (int t = 1; t < 4; ++t) y[t] = cmul(y[t], __ldg(tw + t * k * 2));  // step M / (4 S)
#pragma unroll
      for (int m = 0; m < 4; ++m) u[4 * b + m] = y[m];
    }
  } else {
    double2 y[C];
    if (!kDif) {
#pragma unroll
      for (int m = 1; m < C; ++m) u[m] = cmul(u[m], __ldg(tw + m * k));  // step M / (C S) = 1
    }
    butterfly<C>(u, y, tw, M);
    if (kDif) {
#pragma unroll
      for (int t = 1; t < C; ++t) y[t] = cmul(y[t], __ldg(tw + t * k));
    }
#pragma unroll
    for (int t = 0; t < C; ++t) u[t] = y[t];
  }
}

// x (B, T) float32 unpadded; win (n) float64; chirp (2L complex), twm (M
// complex) and fb (M complex) as stft_magnitude_bluestein_kernel's; out (B,
// F, n/2 + 1) float32, re and im likewise or null; S = M / C, the points a
// block holds; radices: the pass list of S (the passes within a share). A
// cluster of C blocks (blockIdx.x / C) owns one transform, two frames of an
// odd n or one of an even n, of row blockIdx.y; block rank r holds the
// points [r S, (r + 1) S) in its dynamic shared memory.
template <int C>
__global__ void __launch_bounds__(kClusterThreads, 1) stft_magnitude_bluestein_cluster_kernel(
    const float* __restrict__ x, const double* __restrict__ win,
    const double2* __restrict__ chirp, const double2* __restrict__ twm,
    const double2* __restrict__ fb, float* __restrict__ out, float* __restrict__ re_out,
    float* __restrict__ im_out, int T, int n, int hop, int F, int M, int S,
    unsigned long long radices) {
  extern __shared__ __align__(16) double2 smd[];  // [S]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool odd = (n & 1) != 0;
  const int L = odd ? n : n / 2;
  const unsigned two_l = 2 * static_cast<unsigned>(L);  // j^2 < 2^32: L < 65536
  const int pad = n / 2;
  const int b = blockIdx.y;
  const int f0 = (blockIdx.x / C) * (odd ? 2 : 1);
  const float* row = x + static_cast<size_t>(b) * T;
  const int base = rank * S;  // the global position of the share's first point
  // point g of the transform, in the block that holds it
  auto point = [&](int g) -> double2* {
    return cluster.map_shared_rank(smd, g / S) + slot(g % S, S);
  };

  // the chirped sequence z_j c_j of the share's points, zero from L to M
  for (int j = threadIdx.x; j < S; j += kClusterThreads) {
    const int g = base + j;
    double2 v = make_double2(0.0, 0.0);
    if (g < L) {
      const long long P = static_cast<long long>(f0) * hop + (odd ? g : 2 * g);
      const int w = odd ? g : 2 * g;
      const long long Q = odd ? P + hop : P + 1;  // the other frame's sample, or the odd one
      const double2 z =
          make_double2(static_cast<double>(reflected(row, P, T, pad)) * __ldg(win + w),
                       static_cast<double>(reflected(row, Q, T, pad)) * __ldg(win + w + 1 - odd));
      const unsigned gg = static_cast<unsigned>(g);
      v = cmul(z, __ldg(chirp + (gg * gg) % two_l));
    }
    smd[slot(j, S)] = v;
  }
  cluster.sync();
  // the DIF passes across the blocks first (the largest strides), the
  // butterflies of each local offset k dealt out to the blocks in turn
  for (int k = rank * kClusterThreads + threadIdx.x; k < S; k += C * kClusterThreads) {
    double2* pts[C];
    double2 u[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      pts[j] = cluster.map_shared_rank(smd, j) + slot(k, S);
      u[j] = *pts[j];
    }
    cross_passes<C, true>(u, twm, M, k);
#pragma unroll
    for (int j = 0; j < C; ++j) *pts[j] = u[j];
  }
  cluster.sync();
  const int local = pass_count(radices);
  dif_passes<kClusterThreads>(smd, twm, 1, S, M, radices, local);
  // times the conjugate chirp's transform (digit-reversed, as the points),
  // conjugated; the DIT passes then give the conjugate of the convolution
  for (int j = threadIdx.x; j < S; j += kClusterThreads) {
    double2* v = smd + slot(j, S);
    *v = conjugate(cmul(*v, __ldg(fb + base + j)));
  }
  __syncthreads();
  dit_passes<false, kClusterThreads>(smd, twm, 1, S, M, radices);
  cluster.sync();
  // the DIT passes across the blocks, and Z[g] = c_g conj(G[g]) for g < L
  for (int k = rank * kClusterThreads + threadIdx.x; k < S; k += C * kClusterThreads) {
    double2* pts[C];
    double2 u[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      pts[j] = cluster.map_shared_rank(smd, j) + slot(k, S);
      u[j] = *pts[j];
    }
    cross_passes<C, false>(u, twm, M, k);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const unsigned g = static_cast<unsigned>(k + j * S);
      *pts[j] = g < static_cast<unsigned>(L) ? cmul(conjugate(u[j]), __ldg(chirp + (g * g) % two_l))
                                             : u[j];
    }
  }
  cluster.sync();
  // the end, the bins dealt out to the blocks in turn, Z[n - k] or Z[L - k]
  // read from the block that holds it: for an even n the real FFT's
  // post-twiddle (W^k = tw2L[k]: 2L = n), for an odd n the two frames
  const int K = n / 2 + 1;
  for (int g = rank * kClusterThreads + threadIdx.x; g < (odd ? 2 * K : K);
       g += C * kClusterThreads) {
    const int h = g / K, k = g - h * K, f = f0 + h;
    if (f >= F) continue;
    const size_t o = (static_cast<size_t>(b) * F + f) * K + k;
    if (odd) {
      store_bin(split_bin(*point(k), *point(k == 0 ? 0 : n - k), h != 0), o, out, re_out, im_out);
    } else {
      store_bin(real_bin(*point(k == L ? 0 : k), *point(k == 0 ? 0 : L - k), __ldg(chirp + k)), o,
                out, re_out, im_out);
    }
  }
  cluster.sync();  // no block leaves while another still reads its points
}

// ---------------------------------------------------------------------------
// The chirp-z transform in two levels through global memory.

// A tile of the kernels across the shares: kt consecutive local offsets,
// the largest power of two from kTileMaxOffsets down whose C points each
// stay within kBluesteinPoints, and never fewer than kTileMinOffsets (8
// offsets: each gather and scatter row is 128 contiguous bytes). With C at
// most kGlobalMaxC a tile of 8 fits a block (16 x 8 x 1,816 bytes).
constexpr int kTileMaxOffsets = 64, kTileMinOffsets = 8;
constexpr int kGlobalMaxC = kMaxSmem / (16 * kTileMinOffsets);

inline int global_tile(int C) {
  int kt = kTileMaxOffsets;
  while (kt > kTileMinOffsets && kt * C > kBluesteinPoints) kt /= 2;
  return kt;
}

// One pass across the shares, of radix R at p = S q (q: the product of the
// cross radices before it), on a tile of kt local offsets [k0, k0 + kt):
// buf[j kt + o] holds point k0 + o + j S of the transform (j < C). On the j
// axis a pass at q whose butterfly i (j0 = i mod q) owns the points (i - j0)
// R + j0 + m q and takes the twiddles of global offset k0 + o + j0 S at
// step C / (R q) of the M-point table: the very butterflies and twiddles
// of `pass<R, kDif>` at p = S q over the whole transform, in the same
// order per point (p > 1, so the twiddles always apply).
template <int R, bool kDif>
__device__ __forceinline__ void tile_pass(double2* __restrict__ buf,
                                          const double2* __restrict__ tw, int kt, int C, int M,
                                          int S, int k0, int q) {
  const int step = C / (R * q);
  for (int g = threadIdx.x; g < (C / R) * kt; g += kThreads) {
    const int i = g / kt, o = g - i * kt, j0 = i % q;
    const int base = (i - j0) * R + j0;
    const int kg = k0 + o + j0 * S;
    double2 u[R], y[R];
#pragma unroll
    for (int m = 0; m < R; ++m) u[m] = buf[(base + m * q) * kt + o];
    if (!kDif) {
#pragma unroll
      for (int m = 1; m < R; ++m) u[m] = cmul(u[m], __ldg(tw + m * kg * step));
    }
    butterfly<R>(u, y, tw, M);
    if (kDif) {
#pragma unroll
      for (int t = 1; t < R; ++t) y[t] = cmul(y[t], __ldg(tw + t * kg * step));
    }
#pragma unroll
    for (int t = 0; t < R; ++t) buf[(base + t * q) * kt + o] = y[t];
  }
}

template <bool kDif>
__device__ __forceinline__ void run_tile_pass(int r, double2* buf, const double2* tw, int kt,
                                              int C, int M, int S, int k0, int q) {
  switch (r) {
    case 4: tile_pass<4, kDif>(buf, tw, kt, C, M, S, k0, q); break;
    case 2: tile_pass<2, kDif>(buf, tw, kt, C, M, S, k0, q); break;
    case 3: tile_pass<3, kDif>(buf, tw, kt, C, M, S, k0, q); break;
    case 5: tile_pass<5, kDif>(buf, tw, kt, C, M, S, k0, q); break;
    default: tile_pass<7, kDif>(buf, tw, kt, C, M, S, k0, q); break;
  }
}

// The passes across the shares on a tile, `cross` their radices (4 bits
// each, their product C): DIF last to first, DIT first to last.
template <bool kDif>
__device__ __forceinline__ void tile_passes(double2* buf, const double2* tw, int kt, int C, int M,
                                            int S, int k0, unsigned long long cross) {
  const int count = pass_count(cross);
  int q = kDif ? C : 1;
  for (int j = 0; j < count; ++j) {
    const int r = static_cast<int>((cross >> (4 * (kDif ? count - 1 - j : j))) & 15);
    if (kDif) q /= r;
    run_tile_pass<kDif>(r, buf, tw, kt, C, M, S, k0, q);
    if (!kDif) q *= r;
    __syncthreads();
  }
}

// The row and first frame of transform tg (per_row transforms a row, each
// two frames of an odd n or one of an even n).
__device__ __forceinline__ void transform_frames(long long tg, int per_row, bool odd, int* b,
                                                 int* f0) {
  *b = static_cast<int>(tg / per_row);
  *f0 = static_cast<int>(tg - static_cast<long long>(*b) * per_row) * (odd ? 2 : 1);
}

// x (B, T) float32 unpadded; win (n) float64; chirp (2L complex) as the
// one-block kernel's; twm (M complex); scratch (transforms of the chunk, M
// complex); t0: the chunk's first transform (blockIdx.y adds to it); cross:
// the radices across the shares. Block (tile, transform): the chirped
// points k + j S of the tile's offsets, zero from L to M, the DIF passes
// across the shares, written to the scratch.
__global__ void __launch_bounds__(kThreads) stft_magnitude_bluestein_global_cross_dif_kernel(
    const float* __restrict__ x, const double* __restrict__ win,
    const double2* __restrict__ chirp, const double2* __restrict__ twm,
    double2* __restrict__ scratch, int T, int n, int hop, int M, int C, int kt, long long t0,
    int per_row, unsigned long long cross) {
  extern __shared__ __align__(16) double2 smd[];  // [C][kt]
  const bool odd = (n & 1) != 0;
  const int L = odd ? n : n / 2;
  const unsigned long long two_l = 2ull * static_cast<unsigned long long>(L);
  const int pad = n / 2;
  const int S = M / C;
  const int k0 = blockIdx.x * kt;
  int b, f0;
  transform_frames(t0 + blockIdx.y, per_row, odd, &b, &f0);
  const float* row = x + static_cast<size_t>(b) * T;
  double2* pts = scratch + static_cast<size_t>(blockIdx.y) * M;

  for (int g = threadIdx.x; g < C * kt; g += kThreads) {
    const int j = g / kt, k = k0 + g - j * kt;
    const int pt = j * S + k;
    double2 v = make_double2(0.0, 0.0);
    if (k < S && pt < L) {
      const long long P = static_cast<long long>(f0) * hop + (odd ? pt : 2 * pt);
      const int w = odd ? pt : 2 * pt;
      const long long Q = odd ? P + hop : P + 1;  // the other frame's sample, or the odd one
      const double2 z =
          make_double2(static_cast<double>(reflected(row, P, T, pad)) * __ldg(win + w),
                       static_cast<double>(reflected(row, Q, T, pad)) * __ldg(win + w + 1 - odd));
      const unsigned long long gg = static_cast<unsigned long long>(pt);
      v = cmul(z, __ldg(chirp + (gg * gg) % two_l));
    }
    smd[g] = v;
  }
  __syncthreads();
  tile_passes<true>(smd, twm, kt, C, M, S, k0, cross);
  for (int g = threadIdx.x; g < C * kt; g += kThreads) {
    const int j = g / kt, k = k0 + g - j * kt;
    if (k < S) pts[j * S + k] = smd[g];
  }
}

// fb (M complex) as the one-block kernel's; local: the pass list of S.
// Block (share r, transform): the share's S points, the DIF passes within
// it, times the conjugate chirp's transform, conjugated, the DIT passes,
// written back (the cluster kernel's middle).
__global__ void __launch_bounds__(kThreads) stft_magnitude_bluestein_global_share_kernel(
    const double2* __restrict__ twm, const double2* __restrict__ fb,
    double2* __restrict__ scratch, int M, int S, unsigned long long local) {
  extern __shared__ __align__(16) double2 smd[];  // [S]
  const int base = blockIdx.x * S;
  double2* pts = scratch + static_cast<size_t>(blockIdx.y) * M + base;
  for (int j = threadIdx.x; j < S; j += kThreads) smd[slot(j, S)] = pts[j];
  __syncthreads();
  dif_passes<kThreads>(smd, twm, 1, S, M, local, pass_count(local));
  for (int j = threadIdx.x; j < S; j += kThreads) {
    double2* v = smd + slot(j, S);
    *v = conjugate(cmul(*v, __ldg(fb + base + j)));
  }
  __syncthreads();
  dit_passes<false, kThreads>(smd, twm, 1, S, M, local);
  for (int j = threadIdx.x; j < S; j += kThreads) pts[j] = smd[slot(j, S)];
}

// Block (tile, transform): the DIT passes across the shares on the tile's
// points, then Z[g] = c_g conj(G[g]) written back for g < L (the end reads
// no other).
__global__ void __launch_bounds__(kThreads) stft_magnitude_bluestein_global_cross_dit_kernel(
    const double2* __restrict__ chirp, const double2* __restrict__ twm,
    double2* __restrict__ scratch, int n, int M, int C, int kt, unsigned long long cross) {
  extern __shared__ __align__(16) double2 smd[];  // [C][kt]
  const int L = (n & 1) != 0 ? n : n / 2;
  const unsigned long long two_l = 2ull * static_cast<unsigned long long>(L);
  const int S = M / C;
  const int k0 = blockIdx.x * kt;
  double2* pts = scratch + static_cast<size_t>(blockIdx.y) * M;
  for (int g = threadIdx.x; g < C * kt; g += kThreads) {
    const int j = g / kt, k = k0 + g - j * kt;
    smd[g] = k < S ? pts[j * S + k] : make_double2(0.0, 0.0);
  }
  __syncthreads();
  tile_passes<false>(smd, twm, kt, C, M, S, k0, cross);
  for (int g = threadIdx.x; g < C * kt; g += kThreads) {
    const int j = g / kt, k = k0 + g - j * kt;
    const int pt = j * S + k;
    if (k < S && pt < L) {
      const unsigned long long gg = static_cast<unsigned long long>(pt);
      pts[pt] = cmul(conjugate(smd[g]), __ldg(chirp + (gg * gg) % two_l));
    }
  }
}

// out (B, F, n/2 + 1) float32, re and im likewise or null. Block (tile of
// kThreads bins, transform): for an odd n the two frames' bins from Z[k]
// and Z[n - k], for an even n the real FFT's post-twiddle from Z[k] and
// Z[L - k] (W^k = tw2L[k]: 2L = n).
__global__ void __launch_bounds__(kThreads) stft_magnitude_bluestein_global_end_kernel(
    const double2* __restrict__ chirp, const double2* __restrict__ scratch,
    float* __restrict__ out, float* __restrict__ re_out, float* __restrict__ im_out, int n,
    int F, int M, long long t0, int per_row) {
  const bool odd = (n & 1) != 0;
  const int L = odd ? n : n / 2;
  const int K = n / 2 + 1;
  int b, f0;
  transform_frames(t0 + blockIdx.y, per_row, odd, &b, &f0);
  const double2* z = scratch + static_cast<size_t>(blockIdx.y) * M;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= (odd ? 2 * K : K)) return;
  const int h = g / K, k = g - h * K, f = f0 + h;
  if (f >= F) return;
  const size_t o = (static_cast<size_t>(b) * F + f) * K + k;
  if (odd) {
    store_bin(split_bin(z[k], z[k == 0 ? 0 : n - k], h != 0), o, out, re_out, im_out);
  } else {
    store_bin(real_bin(z[k == L ? 0 : k], z[k == 0 ? 0 : L - k], __ldg(chirp + k)), o, out,
              re_out, im_out);
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
extern "C" int nsc_stft_magnitude_fft(const void* x, const void* win, const void* tw,
                                      const void* order, void* out, void* re, void* im, int B,
                                      int T, int n_fft, int hop, int F, unsigned long long radices,
                                      void* stream) {
  if (B < 1 || B > 65535 || F < 1 || hop < 1 || T <= n_fft / 2 || n_fft < 2 || n_fft % 2 != 0 ||
      transform_passes(n_fft / 2, radices) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ft = fft_frames(n_fft);
  const int smem = fft_smem(n_fft, ft);
  const bool pairs = n_fft / 2 >= kPairFramePoints && ft * (n_fft / 2) >= kPairPoints;
  const auto kernel = pairs ? stft_magnitude_kernel<true> : stft_magnitude_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return static_cast<int>(err);
  }
  const dim3 grid((F + ft - 1) / ft, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const double*>(win),
      static_cast<const double2*>(tw), static_cast<const int*>(order), static_cast<float*>(out),
      static_cast<float*>(re), static_cast<float*>(im), T, n_fft, hop, F, ft, radices);
  return static_cast<int>(cudaGetLastError());
}

// The FFT kernel's plan at (n_fft, hop): plan[0] frames per block, plan[1]
// shared-memory bytes (2 long longs; hop does not enter). Returns 0, or
// cudaErrorInvalidValue (plan 0) for an odd n_fft or one below 2.
extern "C" int nsc_stft_fft_plan(int n_fft, int hop, void* plan) {
  long long* o = static_cast<long long*>(plan);
  o[0] = o[1] = 0;
  if (n_fft < 2 || n_fft % 2 != 0 || hop < 1) return static_cast<int>(cudaErrorInvalidValue);
  o[0] = fft_frames(n_fft);
  o[1] = fft_smem(n_fft, static_cast<int>(o[0]));
  return 0;
}

// The chirp-z route. x, win, out, re, im, B, T, n_fft, hop, F as
// nsc_stft_magnitude_fft's; chirp (2L, 2), twm (M, 2) and fb (M, 2)
// float64 (kernels/stft.py::bluestein_tables), M the transform's length and
// radices its pass list (kernels/stft.py::bluestein_plan). Returns the
// launch's cudaError_t (cudaErrorInvalidValue for an M below 2L - 1 or a
// pass list that is not a transform of M points; an error of the attribute
// where the plan is over a block's shared memory).
extern "C" int nsc_stft_magnitude_bluestein(const void* x, const void* win, const void* chirp,
                                            const void* twm, const void* fb, void* out, void* re,
                                            void* im, int B, int T, int n_fft, int hop, int F,
                                            int M, unsigned long long radices, void* stream) {
  const int L = n_fft % 2 != 0 ? n_fft : n_fft / 2;
  if (B < 1 || B > 65535 || F < 1 || hop < 1 || n_fft < 2 || T <= n_fft / 2 || L >= 65536 ||
      M < 2 * L - 1 || transform_passes(M, radices) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ft = bluestein_frames(M);
  const int smem = bluestein_smem(M, ft);
  const int frames = n_fft % 2 != 0 ? 2 * ft : ft;  // an odd n's transform carries two
  cudaError_t err = cudaFuncSetAttribute(stft_magnitude_bluestein_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid((F + frames - 1) / frames, B);
  stft_magnitude_bluestein_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const double*>(win),
      static_cast<const double2*>(chirp), static_cast<const double2*>(twm),
      static_cast<const double2*>(fb), static_cast<float*>(out), static_cast<float*>(re),
      static_cast<float*>(im), T, n_fft, hop, F, ft, M, radices);
  return static_cast<int>(cudaGetLastError());
}

// The chirp-z kernel's plan at M: plan[0] transforms per block (each one
// frame of an even n_fft, two of an odd one), plan[1] shared-memory bytes
// (2 long longs). Returns 0, or cudaErrorInvalidValue (plan 0) for an M
// below 1.
extern "C" int nsc_stft_bluestein_plan(int M, void* plan) {
  long long* o = static_cast<long long*>(plan);
  o[0] = o[1] = 0;
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  o[0] = bluestein_frames(M);
  o[1] = bluestein_smem(M, static_cast<int>(o[0]));
  return 0;
}

// The host queries of a cluster launch, made once per (device, C, share
// bytes) and cached: each n_fft has one M, so a training step repeats the
// same few keys. The kernel's shared-memory attribute is raised to the
// largest share queried on the device (a larger cap admits every smaller
// share), and the occupancy answer is kept, 0 included.
struct ClusterFit {
  int device, C, smem, active;
};
constexpr int kClusterFits = 64, kClusterDevices = 64;
std::mutex cluster_fits_mutex;
ClusterFit cluster_fits[kClusterFits];
int cluster_fit_count = 0;
int cluster_attr_smem[3][kClusterDevices];  // per C (2, 4, 8) and device

// The cluster's launch configuration at (B, transforms a row, M, C) and
// the clusters the card can hold at once (`active`, 0 where it can hold
// none); S = M / C points a block, 16 S bytes.
template <int C>
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B, int nt,
                           int M, void* stream, int* active) {
  const int smem = 16 * (M / C);
  const auto kernel = stft_magnitude_bluestein_cluster_kernel<C>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(nt * C, B);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  std::lock_guard<std::mutex> lock(cluster_fits_mutex);
  for (int i = 0; i < cluster_fit_count; ++i) {
    const ClusterFit& fit = cluster_fits[i];
    if (fit.device == device && fit.C == C && fit.smem == smem) {
      *active = fit.active;
      return cudaSuccess;
    }
  }
  const bool cached = device < kClusterDevices;
  int* attr_smem = cached ? &cluster_attr_smem[C == 2 ? 0 : C == 4 ? 1 : 2][device] : nullptr;
  if (!cached || smem > *attr_smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (cached) *attr_smem = smem;
  }
  err = cudaOccupancyMaxActiveClusters(active, reinterpret_cast<const void*>(kernel), &cfg);
  if (err == cudaSuccess && cached && cluster_fit_count < kClusterFits)
    cluster_fits[cluster_fit_count++] = ClusterFit{device, C, smem, *active};
  return err;
}

template <int C>
cudaError_t launch_cluster(int B, int nt, int M, void* stream, const void* x, const void* win,
                           const void* chirp, const void* twm, const void* fb, void* out,
                           void* re, void* im, int T, int n_fft, int hop, int F,
                           unsigned long long radices) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t err = cluster_config<C>(cfg, attr, B, nt, M, stream, &active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;  // the card holds no such cluster
  err = cudaLaunchKernelEx(&cfg, stft_magnitude_bluestein_cluster_kernel<C>,
                           static_cast<const float*>(x), static_cast<const double*>(win),
                           static_cast<const double2*>(chirp), static_cast<const double2*>(twm),
                           static_cast<const double2*>(fb), static_cast<float*>(out),
                           static_cast<float*>(re), static_cast<float*>(im), T, n_fft, hop, F, M,
                           M / C, radices);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The pass list of M with its last passes, those across a cluster of C
// blocks (2: radix 2; 4: radix 4; 8: radix 4 then 2), cut off: the passes
// within a share. Returns false where the list does not end with them.
inline bool share_passes(unsigned long long radices, int C, unsigned long long* local) {
  int count = 0;
  for (unsigned long long r = radices; r != 0; r >>= 4) ++count;
  const int cross = C == 8 ? 2 : 1;
  if (count <= cross) return false;
  const int last = static_cast<int>((radices >> (4 * (count - 1))) & 15);
  const int before = static_cast<int>((radices >> (4 * (count - 2))) & 15);
  if (C == 8 ? (before != 4 || last != 2) : last != C) return false;
  *local = radices & ((1ull << (4 * (count - cross))) - 1);
  return true;
}

// The chirp-z route over a cluster. Arguments as
// nsc_stft_magnitude_bluestein's, and C the blocks of a cluster (2, 4 or 8),
// M a multiple of C; radices the pass list of M, ending with the passes
// across the blocks (kernels/stft.py::bluestein_cluster_plan). Returns the
// launch's cudaError_t: cudaErrorInvalidValue for an M below 2L - 1, a C
// not 2, 4 or 8, an M that C does not divide or a pass list that is not a
// transform of M points ending with C's passes; cudaErrorInvalidConfiguration
// where the card can hold no such cluster (cudaOccupancyMaxActiveClusters
// 0); else the error of the attribute, of the occupancy query or of the
// launch.
extern "C" int nsc_stft_magnitude_bluestein_cluster(const void* x, const void* win,
                                                    const void* chirp, const void* twm,
                                                    const void* fb, void* out, void* re, void* im,
                                                    int B, int T, int n_fft, int hop, int F, int M,
                                                    int C, unsigned long long radices,
                                                    void* stream) {
  const int L = n_fft % 2 != 0 ? n_fft : n_fft / 2;
  unsigned long long local = 0;
  if (B < 1 || B > 65535 || F < 1 || hop < 1 || n_fft < 2 || T <= n_fft / 2 || L >= 65536 ||
      M < 2 * L - 1 || (C != 2 && C != 4 && C != 8) || M % C != 0 ||
      transform_passes(M, radices) < 0 || !share_passes(radices, C, &local))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = n_fft % 2 != 0 ? (F + 1) / 2 : F;  // an odd n's transform carries two frames
  cudaError_t err;
  switch (C) {
    case 2: err = launch_cluster<2>(B, nt, M, stream, x, win, chirp, twm, fb, out, re, im, T,
                                    n_fft, hop, F, local); break;
    case 4: err = launch_cluster<4>(B, nt, M, stream, x, win, chirp, twm, fb, out, re, im, T,
                                    n_fft, hop, F, local); break;
    default: err = launch_cluster<8>(B, nt, M, stream, x, win, chirp, twm, fb, out, re, im, T,
                                     n_fft, hop, F, local); break;
  }
  if (err != cudaSuccess) cudaGetLastError();  // not left for the next launch's check
  return static_cast<int>(err);
}

// The cluster kernel's plan at (M, C): plan[0] threads a block, plan[1]
// shared-memory bytes a block (16 M / C), plan[2] the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters, at one row of one
// transform; 3 long longs). Returns 0, or cudaErrorInvalidValue (plan 0)
// for a C not 2, 4 or 8 or an M it does not divide, or the error of the
// attribute or of the query.
extern "C" int nsc_stft_bluestein_cluster_plan(int M, int C, void* plan) {
  long long* o = static_cast<long long*>(plan);
  o[0] = o[1] = o[2] = 0;
  if ((C != 2 && C != 4 && C != 8) || M < C || M % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  const cudaError_t err =
      C == 2 ? cluster_config<2>(cfg, attr, 1, 1, M, nullptr, &active)
      : C == 4 ? cluster_config<4>(cfg, attr, 1, 1, M, nullptr, &active)
               : cluster_config<8>(cfg, attr, 1, 1, M, nullptr, &active);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  o[0] = kClusterThreads;
  o[1] = 16LL * (M / C);
  o[2] = active;
  return 0;
}

// The dynamic shared memory of the two-level route's kernels, raised once
// per (kernel, device) to the largest a launch has asked for (a larger cap
// admits every smaller block).
std::mutex global_attr_mutex;
int global_attr_smem[3][kClusterDevices];  // per kernel (cross DIF, share, cross DIT) and device

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int which, int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(global_attr_mutex);
  int* cached = device < kClusterDevices ? &global_attr_smem[which][device] : nullptr;
  if (cached != nullptr && smem <= *cached) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cached != nullptr) *cached = smem;
  return err;
}

// The pass list of M cut where its prefix multiplies to S: the passes
// within a share (local) and those across the shares (cross). Returns
// false where no prefix multiplies to S.
inline bool split_passes(unsigned long long radices, int S, unsigned long long* local,
                         unsigned long long* cross) {
  long long prod = 1;
  int count = 0;
  for (unsigned long long r = radices; prod < S && r != 0; r >>= 4, ++count) prod *= r & 15;
  if (prod != S) return false;
  *local = count == 0 ? 0 : radices & ((1ull << (4 * count)) - 1);
  *cross = count == 16 ? 0 : radices >> (4 * count);
  return true;
}

// The two-level chirp-z route. x, win, chirp, twm, fb, out, re, im, B, T,
// n_fft, hop, F and M as nsc_stft_magnitude_bluestein's; scratch (chunk, M,
// 2) float64, the points of `chunk` transforms (the launcher runs the
// B x per-row transforms chunk by chunk, the four kernels each time); C the
// shares, dividing M; radices the pass list of M, the passes of S = M / C
// first (kernels/stft.py::bluestein_global_plan). Returns the launches'
// cudaError_t: cudaErrorInvalidValue for an M below 2L - 1, a C below 2 or
// above kGlobalMaxC or not dividing M, a pass list that is not a transform
// of M or has no prefix of S, or a chunk below 1 or above 65,535; else the
// first error of an attribute or a launch.
extern "C" int nsc_stft_magnitude_bluestein_global(const void* x, const void* win,
                                                   const void* chirp, const void* twm,
                                                   const void* fb, void* scratch, void* out,
                                                   void* re, void* im, int B, int T, int n_fft,
                                                   int hop, int F, int M, int C, int chunk,
                                                   unsigned long long radices, void* stream) {
  const bool odd = n_fft % 2 != 0;
  const long long L = odd ? n_fft : n_fft / 2;
  unsigned long long local = 0, cross = 0;
  if (B < 1 || B > 65535 || F < 1 || hop < 1 || n_fft < 2 || T <= n_fft / 2 || M < 2 * L - 1 ||
      C < 2 || C > kGlobalMaxC || M % C != 0 || chunk < 1 || chunk > 65535 ||
      transform_passes(M, radices) < 0 || !split_passes(radices, M / C, &local, &cross))
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = M / C;
  const int kt = global_tile(C);
  const int tile_smem = 16 * kt * C, share_smem = 16 * S;
  cudaError_t err = allow_smem(stft_magnitude_bluestein_global_cross_dif_kernel, 0, tile_smem);
  if (err == cudaSuccess)
    err = allow_smem(stft_magnitude_bluestein_global_share_kernel, 1, share_smem);
  if (err == cudaSuccess)
    err = allow_smem(stft_magnitude_bluestein_global_cross_dit_kernel, 2, tile_smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_row = odd ? (F + 1) / 2 : F;  // an odd n's transform carries two frames
  const long long total = static_cast<long long>(B) * per_row;
  const int tiles = (S + kt - 1) / kt;
  const int bins = odd ? 2 * (n_fft / 2 + 1) : n_fft / 2 + 1;
  double2* pts = static_cast<double2*>(scratch);
  const double2* ch = static_cast<const double2*>(chirp);
  const double2* tw = static_cast<const double2*>(twm);
  for (long long t0 = 0; t0 < total; t0 += chunk) {
    const int nt = static_cast<int>(total - t0 < chunk ? total - t0 : chunk);
    stft_magnitude_bluestein_global_cross_dif_kernel<<<dim3(tiles, nt), kThreads, tile_smem, st>>>(
        static_cast<const float*>(x), static_cast<const double*>(win), ch, tw, pts, T, n_fft, hop,
        M, C, kt, t0, per_row, cross);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    stft_magnitude_bluestein_global_share_kernel<<<dim3(C, nt), kThreads, share_smem, st>>>(
        tw, static_cast<const double2*>(fb), pts, M, S, local);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    stft_magnitude_bluestein_global_cross_dit_kernel<<<dim3(tiles, nt), kThreads, tile_smem, st>>>(
        ch, tw, pts, n_fft, M, C, kt, cross);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    stft_magnitude_bluestein_global_end_kernel<<<dim3((bins + kThreads - 1) / kThreads, nt),
                                                 kThreads, 0, st>>>(
        ch, pts, static_cast<float*>(out), static_cast<float*>(re), static_cast<float*>(im),
        n_fft, F, M, t0, per_row);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
  }
  return static_cast<int>(err);
}

// The two-level route's plan at (M, C): plan[0] threads a block, plan[1]
// the local offsets of a tile (kt), plan[2] shared-memory bytes of a share
// block (16 M / C), plan[3] of a tile block (16 kt C) (4 long longs).
// Returns 0, or cudaErrorInvalidValue (plan 0) for a C below 2 or above
// kGlobalMaxC or an M it does not divide.
extern "C" int nsc_stft_bluestein_global_plan(int M, int C, void* plan) {
  long long* o = static_cast<long long*>(plan);
  o[0] = o[1] = o[2] = o[3] = 0;
  if (C < 2 || C > kGlobalMaxC || M < C || M % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  o[0] = kThreads;
  o[1] = global_tile(C);
  o[2] = 16LL * (M / C);
  o[3] = 16LL * o[1] * C;
  return 0;
}
