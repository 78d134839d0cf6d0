// Weighted embedding bag over one arena table:
//
//   out[b, bag, :] = sum_{s : seg[s] = bag} (w[b, s] * table[ids[b, s], :])
//
// for arena-global ids (B, n_slots), weights (B, n_slots) and a static
// slot -> bag map, out (B, n_bags, k): all f32, or table, weights and out
// all bf16 (the serving checkpoint's type).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py,
// embedding_bag() (_make_kernel), which DMAs one table row per slot of an
// example and adds it into the example's bag in VMEM.
//
// What bounds it on an H100: memory.  Per slot it reads one k-float row
// (64 B at k = 16; 32 B in bf16) at a data-dependent address, 8 B of id
// and weight (6 in bf16), and writes its bag's row once; two flops per
// element.
//
// What the design does about it: one thread owns one (example, bag, lane)
// where a lane is 16 bytes of the row (4 floats or 8 bf16, one load) when
// the row is a whole number of 16-byte pieces from an aligned table, else
// one element, so the 4 threads of a k = 16 f32 bag (2 in bf16) read their
// row as one piece and neighbouring threads write neighbouring output
// words.  The
// map arrives as CSR (bag -> its slots in ascending slot order, built once
// on the host), so a thread walks only its own bag's slots and writes its
// output once: no atomics, no zero-fill pass, no scratch.  Each bag is
// summed from 0 in ascending slot order with the product and the add
// rounded separately (no fused multiply-add), which is the Pallas kernel's
// order (out.at[seg[s]].add(row * w) for s ascending): the result does not
// depend on the batch size or the launch shape.  In bf16 each product and
// each add is rounded to bf16 (computed in f32, then rounded, as PyTorch's
// and XLA's bf16 arithmetic does), the weight arriving in bf16.  An id
// outside [0, rows) is never read: its whole bag is written as NaN.
//
// The backward, embedding_bag_backward_kernel, writes the table's gradient
//
//   d_table[r, :] = sum_{(b, s) : ids[b, s] = r} grad[b, seg[s], :] * w[b, s]
//
// (the rows no slot names stay as the caller zeroed them).  On the card
// an atomic scatter would add each row's terms in whatever order its
// threads arrive, so two runs of one step could differ in the last bits
// and a resumed training run would not repeat the uninterrupted one.
// Here the caller sorts the slots' flat indices by row once, stably (a
// library sort, as set-up), and one warp sums each run of equal rows in
// ascending slot order, the product and the add rounded separately, and
// writes the row once: no atomics, the same order as the plain version's
// index_add_ on the CPU, and the same bits on every call.  A pass takes 32
// entries of the run: lane i loads entry i's gradient row times its
// weight (all 32 rows in flight at once) into the warp's tile in shared
// memory, then lane c adds column c's 32 products in entry order.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ inline long long slot_id(const void* ids, int ids64, long long at) {
  return ids64 ? __ldg(static_cast<const long long*>(ids) + at)
               : (long long)__ldg(static_cast<const int*>(ids) + at);
}

// acc + x * w with the product and the add each rounded to T.
__device__ inline float bag_add(float acc, float x, float w, float) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}
__device__ inline float bag_add(float acc, float x, float w, __nv_bfloat16) {
  return repro::round_bf16(__fadd_rn(acc, repro::round_bf16(__fmul_rn(x, w))));
}

// A lane's 16 bytes of a row as f32, and its output written back as T.
__device__ inline void load_lane(const float* src, float* x) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ inline void load_lane(const __nv_bfloat16* src, float* x) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ inline void store_lane(float* dst, const float* acc) {
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}
__device__ inline void store_lane(__nv_bfloat16* dst, const float* acc) {
  unsigned words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    words[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
}
__device__ inline void store_one(float* dst, float x) { dst[0] = x; }
__device__ inline void store_one(__nv_bfloat16* dst, float x) { dst[0] = __float2bfloat16_rn(x); }

template <class T>
__global__ void embedding_bag_kernel(const T* __restrict__ table, long long rows, int k,
                                     const void* __restrict__ ids, int ids64,
                                     const T* __restrict__ w,
                                     const int* __restrict__ bag_ptr,
                                     const int* __restrict__ bag_slots, long long B,
                                     int n_slots, int n_bags, int vec,
                                     T* __restrict__ out) {
  constexpr int kLane = 16 / sizeof(T);   // elements of a 16-byte lane
  const int lanes = k / vec;
  const long long per_example = (long long)n_bags * lanes;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * per_example) return;
  const long long b = t / per_example;
  const int r = (int)(t - b * per_example);
  const int bag = r / lanes;
  const int col = (r - bag * lanes) * vec;
  const long long base = b * n_slots;

  float acc[kLane];
#pragma unroll
  for (int j = 0; j < kLane; ++j) acc[j] = 0.f;
  bool bad = false;
  const int end = __ldg(bag_ptr + bag + 1);
  for (int p = __ldg(bag_ptr + bag); p < end; ++p) {
    const int s = __ldg(bag_slots + p);
    const long long id = slot_id(ids, ids64, base + s);
    if (id < 0 || id >= rows) {
      bad = true;
      break;
    }
    const float ws = repro::to_f32(__ldg(w + base + s));
    const T* row = table + id * k + col;
    if (vec == kLane) {
      float x[kLane];
      load_lane(row, x);
#pragma unroll
      for (int j = 0; j < kLane; ++j) acc[j] = bag_add(acc[j], x[j], ws, T());
    } else {
      acc[0] = bag_add(acc[0], repro::to_f32(__ldg(row)), ws, T());
    }
  }
  if (bad) {
#pragma unroll
    for (int j = 0; j < kLane; ++j) acc[j] = CUDART_NAN_F;
  }
  T* dst = out + (b * n_bags + bag) * k + col;
  if (vec == kLane) {
    store_lane(dst, acc);
  } else {
    store_one(dst, acc[0]);
  }
}

// The backward's tile: kBwdTile entries a pass, kBwdTile columns.
constexpr int kBwdTile = 32;

__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_kernel(const float* __restrict__ grad, int n_bags, int k, int vec,
                                  const void* __restrict__ sorted, int keys64,
                                  const long long* __restrict__ perm,
                                  const float* __restrict__ w,
                                  const long long* __restrict__ seg, int n_slots,
                                  long long N, long long rows, float* __restrict__ d_table) {
  __shared__ float tiles[kThreads / 32][kBwdTile][kBwdTile + 1];
  float(*T)[kBwdTile + 1] = tiles[threadIdx.x >> 5];  // this warp's [entry][column]
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long p = warp * 32 + lane;
  long long row = -1;
  bool start = false;
  if (p < N) {
    row = slot_id(sorted, keys64, p);
    start = (p == 0 || slot_id(sorted, keys64, p - 1) != row) && row >= 0 && row < rows;
  }
  unsigned starts = __ballot_sync(full, start);
  while (starts) {
    const int src = __ffs(starts) - 1;
    starts &= starts - 1;
    const long long q0 = warp * 32 + src;
    const long long r = __shfl_sync(full, row, src);
    // the run's end: the first entry past q0 of another row
    long long q_end = N;
    for (long long base = q0 + 1; base < N; base += 32) {
      const long long q = base + lane;
      const unsigned other = __ballot_sync(full, q >= N || slot_id(sorted, keys64, q) != r);
      if (other) {
        q_end = base + __ffs(other) - 1;
        break;
      }
    }
    for (int c0 = 0; c0 < k; c0 += kBwdTile) {
      const int cw = k - c0 < kBwdTile ? k - c0 : kBwdTile;
      float acc = 0.f;
      for (long long t0 = q0; t0 < q_end; t0 += kBwdTile) {
        const int cnt = q_end - t0 < kBwdTile ? (int)(q_end - t0) : kBwdTile;
        if (lane < cnt) {  // lane i loads entry t0 + i's products, all lanes at once
          const long long j = __ldg(perm + t0 + lane);
          const long long b = j / n_slots;
          const float* g = grad + (b * n_bags + __ldg(seg + (j - b * n_slots))) * k + c0;
          const float wq = __ldg(w + j);
          if (vec) {
            for (int c = 0; c < cw; c += 4) {
              const float4 x = __ldg(reinterpret_cast<const float4*>(g + c));
              T[lane][c] = __fmul_rn(x.x, wq);
              T[lane][c + 1] = __fmul_rn(x.y, wq);
              T[lane][c + 2] = __fmul_rn(x.z, wq);
              T[lane][c + 3] = __fmul_rn(x.w, wq);
            }
          } else {
            for (int c = 0; c < cw; ++c) T[lane][c] = __fmul_rn(__ldg(g + c), wq);
          }
        }
        __syncwarp();
        if (lane < cw)  // column `lane` adds the entries in order
          for (int i = 0; i < cnt; ++i) acc = __fadd_rn(acc, T[i][lane]);
        __syncwarp();
      }
      if (lane < cw) d_table[r * k + c0 + lane] = acc;
    }
  }
}

}  // namespace

extern "C" {

// ids: int32 (ids64 = 0) or int64 (ids64 = 1), (B, n_slots) row-major.
// table, w and out: float (dtype = 0) or bf16 (dtype = 1), one type.
// bag_ptr (n_bags + 1) and bag_slots (n_slots): the CSR of the slot -> bag
// map.  B = 0 launches nothing.
int embedding_bag(const void* table, int dtype, long long rows, int k, const void* ids,
                  int ids64, const void* w, const int* bag_ptr, const int* bag_slots,
                  long long B, int n_slots, int n_bags, void* out, void* stream, int device) {
  if (B < 0 || rows <= 0 || k <= 0 || n_slots <= 0 || n_bags <= 0 ||
      (dtype != repro::kF32 && dtype != repro::kBF16))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((uintptr_t)table % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int lane = dtype == repro::kBF16 ? 8 : 4;
  const int vec = (k % lane == 0 && aligned) ? lane : 1;
  const long long threads = B * n_bags * (long long)(k / vec);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == repro::kBF16)
    embedding_bag_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(table), rows, k, ids, ids64,
        static_cast<const __nv_bfloat16*>(w), bag_ptr, bag_slots, B, n_slots, n_bags, vec,
        static_cast<__nv_bfloat16*>(out));
  else
    embedding_bag_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(table), rows, k, ids, ids64, static_cast<const float*>(w),
        bag_ptr, bag_slots, B, n_slots, n_bags, vec, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The table's gradient, d_table (rows, k), for grad (B, n_bags, k), the
// weights w (B, n_slots) and the slot -> bag map seg (n_slots): sorted (N,
// int32 with keys64 = 0, else int64) holds the N = B * n_slots flat slot
// ids' rows in ascending order and perm (N) their flat indices
// b * n_slots + s, in ascending order within a row (a stable sort).
// d_table must arrive zeroed; only rows some slot names, within
// [0, rows), are written.  N = 0 launches nothing.
int embedding_bag_backward(const float* grad, int n_bags, int k, const void* sorted,
                           int keys64, const long long* perm, const float* w,
                           const long long* seg, int n_slots, long long N, long long rows,
                           float* d_table, void* stream, int device) {
  if (N < 0 || rows <= 0 || k <= 0 || n_slots <= 0 || n_bags <= 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = k % 4 == 0 && (uintptr_t)grad % 16 == 0;
  embedding_bag_backward_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      grad, n_bags, k, vec, sorted, keys64, perm, w, seg, n_slots, N, rows, d_table);
  return (int)cudaGetLastError();
}

}  // extern "C"
