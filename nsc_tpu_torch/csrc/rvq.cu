// Residual vector quantizer search (quantize) and codeword sum (dequantize),
// for Hopper (sm_90a).
//
// quantize replaces nsc_tpu/ops/pallas/rvq_argmin.py::quantize_pallas
// (_quantize_kernel): for each frame, over the books in order,
//   idx = argmin_k ||c_k||^2 - 2 r.c_k   (true float32, lowest index on ties)
//   r  -= c[idx]                          (skipped after the last book)
// What bounds it on the H100: 2*M*K*D*n_q FLOP that must stay true float32
// (no TF32, no tensor cores: the index contract is float32), against a few
// MB of traffic, so it is bound by the FP32 pipe. Design: one block owns 64
// frames; their residuals stay in shared memory for all books. Each book's
// codewords stream through shared memory 64 at a time from the transposed
// copy (n_q, D, K) (8 MB for the serving quantizer: L2-resident), and every
// thread computes a 4 frame x 4 code register tile of dot products with
// float32 FMAs, keeping a running (score, lowest index) per frame. ||c||^2
// comes in precomputed once per call, and the score is one exact doubling
// and one rounded subtraction, so only the dot's summation order differs
// from the plain version.
//
// dequantize replaces nsc_tpu/ops/pallas/rvq_argmin.py::dequantize_pallas
// (_dequantize_kernel): out[m] = 0 + c_0[idx[m,0]] + c_1[idx[m,1]] + ...,
// summed in book order in float32, which is bit-exact with the plain version
// and the JAX package. It is bound by memory: it reads the indices and
// n_q*D floats per frame (gathered from L2) and writes D floats per frame.
// One warp per frame reads each codeword row coalesced. An index outside
// [0, K) adds nothing (as the TPU kernel's one-hot product), rather than
// reading out of bounds.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kTM = 64;       // frames per block
constexpr int kTK = 64;       // codewords per shared-memory chunk
constexpr int kQThreads = 256;  // 16 (frame groups) x 16 (code groups)

__device__ __forceinline__ bool better(float s, int k, float bs, int bk) {
  return bk < 0 || s < bs || (s == bs && k < bk);
}

__global__ void __launch_bounds__(kQThreads) rvq_quantize_kernel(
    const float* __restrict__ z, const float* __restrict__ cbt,
    const float* __restrict__ cb, const float* __restrict__ csq,
    int* __restrict__ idx, int M, int n_q, int K, int D) {
  extern __shared__ __align__(16) float sm[];
  float* R = sm;              // [D][kTM] residuals, frames contiguous
  float* Cc = R + D * kTM;    // [D][kTK] codeword chunk, codes contiguous
  __shared__ float red_s[kTM][16];
  __shared__ int red_k[kTM][16];
  __shared__ int chosen[kTM];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // frames ty*4.., codes tx*4..
  const int m0 = blockIdx.x * kTM;

  for (int i = tid; i < kTM * D; i += kQThreads) {
    const int m = i / D, d = i - m * D;
    R[d * kTM + m] = m0 + m < M ? z[static_cast<size_t>(m0 + m) * D + d] : 0.f;
  }

  for (int q = 0; q < n_q; ++q) {
    float best[4];
    int bk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = FLT_MAX;
      bk[i] = -1;
    }
    const float* bookt = cbt + static_cast<size_t>(q) * D * K;
    for (int k0 = 0; k0 < K; k0 += kTK) {
      __syncthreads();  // R updated / earlier chunk readers done
      for (int i = tid; i < D * kTK; i += kQThreads) {
        const int d = i / kTK, kk = i - d * kTK;
        Cc[i] = k0 + kk < K ? bookt[static_cast<size_t>(d) * K + k0 + kk] : 0.f;
      }
      __syncthreads();
      float acc[4][4] = {};
      for (int d = 0; d < D; ++d) {
        const float4 rv = *reinterpret_cast<const float4*>(R + d * kTM + ty * 4);
        const float4 cv = *reinterpret_cast<const float4*>(Cc + d * kTK + tx * 4);
        const float r4[4] = {rv.x, rv.y, rv.z, rv.w};
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(r4[i], c4[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx * 4 + j;
        if (k < K) {
          const float c2 = csq[static_cast<size_t>(q) * K + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s = __fsub_rn(c2, 2.0f * acc[i][j]);
            if (better(s, k, best[i], bk[i])) {
              best[i] = s;
              bk[i] = k;
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red_s[ty * 4 + i][tx] = best[i];
      red_k[ty * 4 + i][tx] = bk[i];
    }
    __syncthreads();
    if (tid < kTM) {
      float bs = red_s[tid][0];
      int b = red_k[tid][0];
      for (int t = 1; t < 16; ++t)
        if (red_k[tid][t] >= 0 && better(red_s[tid][t], red_k[tid][t], bs, b)) {
          bs = red_s[tid][t];
          b = red_k[tid][t];
        }
      chosen[tid] = b;
      if (m0 + tid < M) idx[static_cast<size_t>(m0 + tid) * n_q + q] = b;
    }
    __syncthreads();
    if (q + 1 < n_q) {
      const float* book = cb + static_cast<size_t>(q) * K * D;
      for (int i = tid; i < kTM * D; i += kQThreads) {
        const int d = i / kTM, m = i - d * kTM;
        R[i] = __fsub_rn(R[i], book[static_cast<size_t>(chosen[m]) * D + d]);
      }
    }
  }
}

__global__ void rvq_dequantize_kernel(const int* __restrict__ idx,
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

}  // namespace

// z (M, D), cbt (n_q, D, K), cb (n_q, K, D), csq (n_q, K): float32;
// idx (M, n_q) int32. Returns the launch's cudaError_t.
extern "C" int nsc_rvq_quantize(const void* z, const void* cbt, const void* cb,
                                const void* csq, void* idx, int M, int n_q,
                                int K, int D, void* stream) {
  if (M < 1 || n_q < 1 || K < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(D) * (kTM + kTK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rvq_quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rvq_quantize_kernel<<<(M + kTM - 1) / kTM, kQThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(cbt),
      static_cast<const float*>(cb), static_cast<const float*>(csq),
      static_cast<int*>(idx), M, n_q, K, D);
  return static_cast<int>(cudaGetLastError());
}

// idx (M, n_q) int32, cb (n_q, K, D) float32 -> out (M, D) float32.
extern "C" int nsc_rvq_dequantize(const void* idx, const void* cb, void* out,
                                  int M, int n_q, int K, int D, void* stream) {
  if (M < 1 || n_q < 1 || K < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  rvq_dequantize_kernel<<<(M + block.y - 1) / block.y, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(cb),
      static_cast<float*>(out), M, n_q, K, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nsc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
