// The full FwFM pairwise term, per example:
//
//   out[b] = 0.5 * sum_{i,j} <v_i, v_j> R_ij        V (B, m, k), R (m, m), f32
//
// Replaces the Pallas TPU kernel src/repro/kernels/fwfm_interaction.py,
// fwfm_pairwise() (_kernel), which forms a tile's (bb, m, m) Gram on the
// MXU and contracts it with a VMEM-resident R.
//
// What bounds it on an H100: f32 operations.  The Gram is symmetric, so the
// function needs only its m (m + 1) / 2 distinct dot products, contracted
// with R_ij + R_ji: about m (m + 1) (k + 1) flops an example (1.16e5 at
// m = 82, k = 16) against m k 4 bytes read (5.2 KB), some 22 flops a byte,
// just above the card's f32 rate per byte of device memory (20).  This
// kernel does 2 m^2 (k + 1), the full Gram: twice what the function needs.
//
// What the design does about it: a block keeps R in shared memory for its
// whole life (odd row stride: the threads of a warp read R_ij for
// different i from different banks) and walks over tiles of
// floor(256 / m) examples, a grid of at most as many blocks as fit on the
// card at once, so R is read from device memory once per block.  A tile's V
// is staged into shared memory with 16-byte loads (4-byte loads when k % 4
// != 0 or V is not 16-byte aligned), each row zero-padded to a multiple of
// 4 floats, which adds exact zeros to every dot product.  Thread (e, i) of the
// tile holds v_i in registers and computes row i of the Gram against every
// v_j, which the threads of its example read as one shared-memory
// broadcast, folding G_ij into sum_j R_ij G_ij as it goes; the tile's
// example sums are then taken in a fixed order (i ascending).  All in f32
// on the CUDA cores, by hand: no cuBLAS, no tensor cores.  The full m x m
// sum is formed, so R's symmetry is not used (half the flops, left for
// later work) and any R gives the plain version's result.
// Limits: m <= kMaxM and k <= kMaxK (shared memory and registers).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 128;
constexpr int kMaxK = 32;

__global__ void fwfm_pairwise_kernel(const float* __restrict__ V, const float* __restrict__ R,
                                     long long B, int m, int k, int tb, int vec4,
                                     float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int kq = (k + 3) / 4;
  const int RS = repro::padded_stride(m);
  float4* vs = smem4;                                       // tb * m * kq
  float* rs = reinterpret_cast<float*>(vs + tb * m * kq);  // m * RS
  float* part = rs + m * RS;                                // tb * m
  for (int t = threadIdx.x; t < m * m; t += blockDim.x) rs[(t / m) * RS + t % m] = R[t];

  const int e = threadIdx.x / m;
  const int i = threadIdx.x - e * m;
  const long long n_tiles = (B + tb - 1) / tb;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b0 = tile * tb;
    const int nb = (int)(B - b0 < tb ? B - b0 : tb);
    __syncthreads();  // the last tile's reads of vs and part are done
    if (vec4) {
      const float4* src = reinterpret_cast<const float4*>(V + b0 * m * k);
      for (int t = threadIdx.x; t < nb * m * kq; t += blockDim.x) vs[t] = __ldg(src + t);
    } else {
      const float* src = V + b0 * m * k;
      float* dst = reinterpret_cast<float*>(vs);
      const int kp = 4 * kq;
      for (int t = threadIdx.x; t < nb * m * kp; t += blockDim.x) {
        const int r = t / kp, c = t - r * kp;
        dst[t] = c < k ? __ldg(src + (long long)r * k + c) : 0.f;
      }
    }
    __syncthreads();

    float acc = 0.f;
    if (e < nb) {
      float4 vi[kMaxK / 4];
      const float4* row = vs + (e * m + i) * kq;
#pragma unroll
      for (int q = 0; q < kMaxK / 4; ++q)
        if (q < kq) vi[q] = row[q];
      const float4* vj = vs + e * m * kq;
      const float* ri = rs + i * RS;
      for (int j = 0; j < m; ++j, vj += kq) {
        float g = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxK / 4; ++q) {
          if (q < kq) {
            const float4 x = vj[q];
            g = fmaf(vi[q].x, x.x, g);
            g = fmaf(vi[q].y, x.y, g);
            g = fmaf(vi[q].z, x.z, g);
            g = fmaf(vi[q].w, x.w, g);
          }
        }
        acc = fmaf(ri[j], g, acc);
      }
    }
    if (e < tb) part[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < nb) {
      const float* p = part + threadIdx.x * m;
      float s = 0.f;
      for (int r = 0; r < m; ++r) s += p[r];
      out[b0 + threadIdx.x] = 0.5f * s;
    }
  }
}

}  // namespace

extern "C" {

// V (B, m, k) and R (m, m) row-major f32; out (B,).  B = 0 launches nothing.
int fwfm_pairwise(const float* V, const float* R, long long B, int m, int k, float* out,
                  void* stream, int device) {
  if (B < 0 || m <= 0 || m > kMaxM || k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vec4 = k % 4 == 0 && (uintptr_t)V % 16 == 0;
  const int tb = kThreads / m;
  const int kp = (k + 3) / 4 * 4;
  const size_t smem =
      ((size_t)tb * m * kp + (size_t)m * repro::padded_stride(m) + (size_t)tb * m) * sizeof(float);
  err = repro::allow_smem(fwfm_pairwise_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwfm_pairwise_kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (B + tb - 1) / tb;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  fwfm_pairwise_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(V, R, B, m, k, tb, vec4,
                                                                      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
