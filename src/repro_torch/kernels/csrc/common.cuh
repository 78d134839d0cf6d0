// Device helpers shared by the corpus-scoring and item-scoring kernels.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace repro {

// Dead-slot sentinel; the one value of kernels/dplr_corpus_score.py NEG_INF.
constexpr float kNegInf = -1e30f;

// The largest rho * k any kernel here takes (the wrappers check it first).
constexpr int kMaxRK = 128;

// Row stride in shared memory for rows of `width` floats: odd, so that
// thread t reading word j of row t hits bank (t * stride + j) % 32, which
// differs across the 32 lanes of a warp (no bank conflicts).
__host__ __device__ inline int padded_stride(int width) { return width | 1; }

// Copy rows [row0, row0 + rows) of a row-major (n, width) float array into
// shared memory with row stride `stride`, the whole block cooperating so
// that neighbouring threads read neighbouring addresses.  Rows at or past n
// are zero-filled.  Each thread issues kStageBatch independent loads before
// it stores any of them, so that many loads are in flight per thread: a
// load-then-store loop would wait out the device memory latency once per
// element.
constexpr int kStageBatch = 8;

__device__ inline void stage_rows(const float* __restrict__ src, long long row0,
                                  int rows, long long n, int width, int stride,
                                  float* __restrict__ dst) {
  const int total = rows * width;
  const long long left = n - row0;
  const int avail = (int)(left <= 0 ? 0 : (left < rows ? left : rows)) * width;
  const float* base = src + row0 * width;
  const int extra = stride - width;   // row r of dst starts r * extra later
  for (int idx0 = threadIdx.x; idx0 < total; idx0 += kStageBatch * blockDim.x) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int idx = idx0 + u * blockDim.x;
      v[u] = idx < avail ? __ldg(base + idx) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int idx = idx0 + u * blockDim.x;
      if (idx < total) dst[idx + extra * (idx / width)] = v[u];
    }
  }
}

// sum_r e_r ||pc_r + q_r||^2 over a (rho, k) pair of rows.
__device__ inline float eigen_square_sum(const float* q, const float* pc,
                                         const float* e, int rho, int k) {
  float acc = 0.f;
  for (int r = 0; r < rho; ++r) {
    float s = 0.f;
    for (int c = 0; c < k; ++c) {
      const float p = pc[r * k + c] + q[r * k + c];
      s = fmaf(p, p, s);
    }
    acc = fmaf(e[r], s, acc);
  }
  return acc;
}

// The top-K order: a higher value first, and among equal values the lower
// slot id first (the tie rule of lax.top_k and of a stable descending sort).
__device__ inline bool ranks_before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Sort N (a power of two) (value, id) pairs in shared memory so that entry 0
// ranks first.  Bitonic network: data-independent, so the result depends
// only on the keys, never on thread timing.
__device__ inline void bitonic_sort(float* v, int* id, int N) {
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < N / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool first_block = (lo & size) == 0;
        const float va = v[lo], vb = v[hi];
        const int ia = id[lo], ib = id[hi];
        const bool swap = first_block ? ranks_before(vb, ib, va, ia)
                                      : ranks_before(va, ia, vb, ib);
        if (swap) {
          v[lo] = vb;
          v[hi] = va;
          id[lo] = ib;
          id[hi] = ia;
        }
      }
    }
  }
  __syncthreads();
}

// Opt the kernel into `bytes` of dynamic shared memory (above 48 KB a kernel
// must ask first).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
