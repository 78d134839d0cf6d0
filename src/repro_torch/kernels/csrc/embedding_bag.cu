// Weighted embedding bag over one arena table:
//
//   out[b, bag, :] = sum_{s : seg[s] = bag} (w[b, s] * table[ids[b, s], :])
//
// for arena-global ids (B, n_slots), weights (B, n_slots) and a static
// slot -> bag map, out (B, n_bags, k), all f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py,
// embedding_bag() (_make_kernel), which DMAs one table row per slot of an
// example and adds it into the example's bag in VMEM.
//
// What bounds it on an H100: memory.  Per slot it reads one k-float row
// (64 B at k = 16) at a data-dependent address, 8 B of id and weight, and
// writes its bag's row once; two flops per element.
//
// What the design does about it: one thread owns one (example, bag, lane)
// where a lane is 4 floats (one 16-byte load) when k % 4 == 0, else one
// float, so the 4 threads of a k = 16 bag read their row as one 64-byte
// piece and neighbouring threads write neighbouring output words.  The
// map arrives as CSR (bag -> its slots in ascending slot order, built once
// on the host), so a thread walks only its own bag's slots and writes its
// output once: no atomics, no zero-fill pass, no scratch.  Each bag is
// summed from 0 in ascending slot order with the product and the add
// rounded separately (no fused multiply-add), which is the Pallas kernel's
// order (out.at[seg[s]].add(row * w) for s ascending): the result does not
// depend on the batch size or the launch shape.  An id outside [0, rows) is
// never read: its whole bag is written as NaN.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ inline long long slot_id(const void* ids, int ids64, long long at) {
  return ids64 ? __ldg(static_cast<const long long*>(ids) + at)
               : (long long)__ldg(static_cast<const int*>(ids) + at);
}

__device__ inline float bag_add(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}

__global__ void embedding_bag_kernel(const float* __restrict__ table, long long rows, int k,
                                     const void* __restrict__ ids, int ids64,
                                     const float* __restrict__ w,
                                     const int* __restrict__ bag_ptr,
                                     const int* __restrict__ bag_slots, long long B,
                                     int n_slots, int n_bags, int vec,
                                     float* __restrict__ out) {
  const int lanes = k / vec;
  const long long per_example = (long long)n_bags * lanes;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * per_example) return;
  const long long b = t / per_example;
  const int r = (int)(t - b * per_example);
  const int bag = r / lanes;
  const int col = (r - bag * lanes) * vec;
  const long long base = b * n_slots;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  bool bad = false;
  const int end = __ldg(bag_ptr + bag + 1);
  for (int p = __ldg(bag_ptr + bag); p < end; ++p) {
    const int s = __ldg(bag_slots + p);
    const long long id = slot_id(ids, ids64, base + s);
    if (id < 0 || id >= rows) {
      bad = true;
      break;
    }
    const float ws = __ldg(w + base + s);
    const float* row = table + id * k + col;
    if (vec == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(row));
      acc[0] = bag_add(acc[0], x.x, ws);
      acc[1] = bag_add(acc[1], x.y, ws);
      acc[2] = bag_add(acc[2], x.z, ws);
      acc[3] = bag_add(acc[3], x.w, ws);
    } else {
      acc[0] = bag_add(acc[0], __ldg(row), ws);
    }
  }
  if (bad) acc[0] = acc[1] = acc[2] = acc[3] = CUDART_NAN_F;
  float* dst = out + (b * n_bags + bag) * k + col;
  if (vec == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    dst[0] = acc[0];
  }
}

}  // namespace

extern "C" {

// ids: int32 (ids64 = 0) or int64 (ids64 = 1), (B, n_slots) row-major.
// bag_ptr (n_bags + 1) and bag_slots (n_slots): the CSR of the slot -> bag
// map.  B = 0 launches nothing.
int embedding_bag(const float* table, long long rows, int k, const void* ids, int ids64,
                  const float* w, const int* bag_ptr, const int* bag_slots, long long B,
                  int n_slots, int n_bags, float* out, void* stream, int device) {
  if (B < 0 || rows <= 0 || k <= 0 || n_slots <= 0 || n_bags <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((uintptr_t)table % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int vec = (k % 4 == 0 && aligned) ? 4 : 1;
  const long long threads = B * n_bags * (long long)(k / vec);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  embedding_bag_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, rows, k, ids, ids64, w, bag_ptr, bag_slots, B, n_slots, n_bags, vec, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
