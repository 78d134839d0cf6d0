// Algorithm 1's per-item DPLR-FwFM score over raw item embeddings, for a
// batch of queries at once:
//
//   P[q, i]   = P_C[q] + U_I V_I[q, i]                        (rho, k)
//   out[q, i] = 0.5 * ((s_C[q] + sum_m d_m ||v_m||^2) + sum_r e_r ||P_r||^2)
//
// Replaces the Pallas TPU kernel src/repro/kernels/dplr_score.py,
// dplr_score_items() (_kernel), which scores one query; the grid here has a
// query axis, so fwfm.rank_items scores its whole (Bq, n) batch in one
// launch where the JAX package vmaps the per-query kernel.
//
// What bounds it on an H100: memory.  Each (query, item) reads m_I * k * 4
// bytes of V_I (2432 B at m_I = 38, k = 16) for about (2 + 2 rho) * m_I * k
// flops, well under the card's f32 rate per byte.
//
// What the design does about it: one thread per (query, item) streams its
// item's m_I * k floats once, 8 loads in flight at a time, squaring each
// for the d-term and adding it into the rho * k projection P as it goes.
// The threads of a warp read rows 2.4 KB apart (not coalesced); each
// 32-byte sector a thread touches is used whole, through L1.  P lives in the thread's own
// row of shared memory (odd row stride: no bank conflicts), so rho * k may
// be up to repro::kMaxRK = 128 without spilling registers.  U_I, e, d_I
// and P_C[q] sit in shared memory, read by every thread of the block.
#include "common.cuh"

namespace {

using repro::kMaxRK;

constexpr int kTile = 128;  // items per block, one per thread
constexpr size_t kMaxSmem = 232448;

__global__ void dplr_score_items_kernel(const float* __restrict__ V,
                                        const float* __restrict__ U,
                                        const float* __restrict__ e,
                                        const float* __restrict__ d,
                                        const float* __restrict__ PC,
                                        const float* __restrict__ sC, long long n,
                                        int mI, int rho, int k,
                                        float* __restrict__ out) {
  extern __shared__ float smem[];
  const int RK = rho * k;
  const int RKP = repro::padded_stride(RK);
  float* us = smem;            // rho * mI
  float* es = us + rho * mI;   // rho
  float* ds = es + rho;        // mI
  float* pcs = ds + mI;        // RK
  float* acc = pcs + RK;       // kTile * RKP

  const int q = blockIdx.y;
  for (int t = threadIdx.x; t < rho * mI; t += blockDim.x) us[t] = U[t];
  for (int t = threadIdx.x; t < rho; t += blockDim.x) es[t] = e[t];
  for (int t = threadIdx.x; t < mI; t += blockDim.x) ds[t] = d[t];
  for (int t = threadIdx.x; t < RK; t += blockDim.x) pcs[t] = PC[(long long)q * RK + t];
  __syncthreads();

  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  if (i >= n) return;
  float* P = acc + threadIdx.x * RKP;
  for (int j = 0; j < RK; ++j) P[j] = pcs[j];
  // The item's m_I * k floats are contiguous; they are read kStageBatch at
  // a time, all loads issued before any is used, with (m, c) stepped along.
  const float* v = V + ((long long)q * n + i) * mI * k;
  const int total = mI * k;
  float term_d = 0.f;
  int m = 0, c = 0;
  for (int j0 = 0; j0 < total; j0 += repro::kStageBatch) {
    float x[repro::kStageBatch];
#pragma unroll
    for (int u = 0; u < repro::kStageBatch; ++u)
      x[u] = j0 + u < total ? __ldg(v + j0 + u) : 0.f;
#pragma unroll
    for (int u = 0; u < repro::kStageBatch; ++u) {
      if (j0 + u < total) {
        term_d = fmaf(ds[m] * x[u], x[u], term_d);
        for (int r = 0; r < rho; ++r)
          P[r * k + c] = fmaf(us[r * mI + m], x[u], P[r * k + c]);
        if (++c == k) {
          c = 0;
          ++m;
        }
      }
    }
  }
  float term_e = 0.f;
  for (int r = 0; r < rho; ++r) {
    float s = 0.f;
    for (int c = 0; c < k; ++c) s = fmaf(P[r * k + c], P[r * k + c], s);
    term_e = fmaf(es[r], s, term_e);
  }
  out[(long long)q * n + i] = 0.5f * ((sC[q] + term_d) + term_e);
}

}  // namespace

extern "C" {

int dplr_score_items(const float* V, const float* U, const float* e, const float* d,
                     const float* PC, const float* sC, long long n, int Bq, int mI, int rho,
                     int k, float* out, void* stream, int device) {
  if (n <= 0 || Bq <= 0 || Bq > 65535 || rho * k > kMaxRK) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(rho * mI + rho + mI + rho * k +
                               kTile * repro::padded_stride(rho * k)) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  err = repro::allow_smem(dplr_score_items_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)Bq);
  dplr_score_items_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(V, U, e, d, PC, sC, n,
                                                                      mI, rho, k, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
