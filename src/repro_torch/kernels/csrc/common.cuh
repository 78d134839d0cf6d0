// Device helpers shared by the corpus-scoring and item-scoring kernels.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

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
// element.  Rows of a multiple of 4 floats from a 16-byte aligned base are
// read 16 bytes a load, others 4.
constexpr int kStageBatch = 8;

__device__ inline void put_words(float* d, float v) { d[0] = v; }
__device__ inline void put_words(float* d, float4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

template <class V>
__device__ inline void stage_rows_as(const float* __restrict__ src, long long row0, int rows,
                                     long long n, int width, int stride,
                                     float* __restrict__ dst) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int wv = width / kW;
  const int total = rows * wv;
  const long long left = n - row0;
  const int avail = (int)(left <= 0 ? 0 : (left < rows ? left : rows)) * wv;
  const V* base = reinterpret_cast<const V*>(src + row0 * width);
  for (int idx0 = threadIdx.x; idx0 < total; idx0 += kStageBatch * blockDim.x) {
    V v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int idx = idx0 + u * blockDim.x;
      v[u] = idx < avail ? __ldg(base + idx) : V{};
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int idx = idx0 + u * blockDim.x;
      if (idx < total) put_words(dst + (idx / wv) * stride + (idx % wv) * kW, v[u]);
    }
  }
}

__device__ inline void stage_rows(const float* __restrict__ src, long long row0, int rows,
                                  long long n, int width, int stride,
                                  float* __restrict__ dst) {
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0)
    stage_rows_as<float4>(src, row0, rows, n, width, stride, dst);
  else
    stage_rows_as<float>(src, row0, rows, n, width, stride, dst);
}

// Loads a row of G floats from shared memory, 16 bytes at a time where G
// allows (the row 16-byte aligned for G >= 4, 8-byte for G = 2).
template <int G>
__device__ inline void load_row(const float* src, float* dst) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int j = 0; j < G; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + j);
      dst[j] = v.x;
      dst[j + 1] = v.y;
      dst[j + 2] = v.z;
      dst[j + 3] = v.w;
    }
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) dst[j] = src[j];
  }
}

// One slot's masked-before scores against G queries,
//   s[j] = (a_C[j] + a_I) + 0.5 * sum_r e_r ||P_C[j, r] + Q_I[r]||^2,
// the one scorer of every kernel that scores a slot (the full scores and
// both top-K modes), so that all of them round a score the same way: per
// query, the squares of row r summed in order by fused multiply-adds, the
// rows weighted in order, and the final multiply-add written out.  `q`: the
// slot's rho * k row; `pcT`: the queries' P_C transposed, pcT[c * G + j] =
// P_C[j].flat[c], so that one load reads entry c of several queries and the
// slot's row is read once for all G.
template <int G>
__device__ inline void slot_score(float ai, const float* q, const float* pcT, const float* ac,
                                  const float* e, int rho, int k, float* s) {
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.f;
  for (int r = 0; r < rho; ++r) {
    float part[G];
#pragma unroll
    for (int j = 0; j < G; ++j) part[j] = 0.f;
    for (int c = r * k; c < (r + 1) * k; ++c) {
      const float qv = q[c];
      float pc[G];
      load_row<G>(pcT + c * G, pc);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float p = pc[j] + qv;
        part[j] = fmaf(p, p, part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = fmaf(e[r], part[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) s[j] = fmaf(0.5f, acc[j], ac[j] + ai);
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

// The top-K order of a float as an unsigned integer: order_key(a) >
// order_key(b) iff a > b for floats that are not NaN, and -0.0 and +0.0,
// which compare equal, share a key.  A selection by key is a selection by
// value.
__device__ inline unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Exclusive prefix sum of `v` over the block (every thread calls it; it
// meets at __syncthreads).  `warp_sums`: blockDim.x / 32 words of shared
// memory.  *total gets the block's sum.
__device__ inline unsigned block_scan(unsigned v, unsigned* warp_sums, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  unsigned before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const unsigned sum = warp_sums[w];
    if (w < warp) before += sum;
    all += sum;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// The largest `v` over the block, called as block_scan is.
__device__ inline unsigned block_max(unsigned v, unsigned* warp_sums) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, d));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v = max(v, warp_sums[w]);
  __syncthreads();
  return v;
}

// Radix-select digits: kSelectBits at a time, kSelectBins bins.
constexpr int kSelectBits = 11;
constexpr int kSelectBins = 1 << kSelectBits;
// Entries one thread loads before it uses any of them in a select's scan:
// 4, because the merge runs 1024 threads a block at 64 registers a thread,
// and its last block spilled at 8.
constexpr int kSelectBatch = 4;

// A key picked by block_select: the key, and how many admitted keys lie
// above it and on it.
struct Selected {
  unsigned key, above, equal;
};

// Calls f(key) for every admitted key {key : i in [0, count), key_of(i, key)
// true}, thread t taking i = t, t + blockDim.x, ...; each thread makes
// kSelectBatch loads before it uses one.
template <class KeyOf, class F>
__device__ inline void for_keys(KeyOf key_of, long long count, F f) {
  const long long step = (long long)blockDim.x * kSelectBatch;
  for (long long i0 = threadIdx.x; i0 < count; i0 += step) {
    unsigned key[kSelectBatch];
    bool ok[kSelectBatch];
#pragma unroll
    for (int u = 0; u < kSelectBatch; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      ok[u] = i < count && key_of(i, key[u]);
    }
#pragma unroll
    for (int u = 0; u < kSelectBatch; ++u)
      if (ok[u]) f(key[u]);
  }
}

// The need-th largest (1 <= need <= the admitted count) of the admitted
// keys {key : i in [0, count), key_of(i, key) true}, found by the whole
// block.  A radix select: each pass counts the keys that match the bits
// found so far into kSelectBins bins `hist` in shared memory with integer
// atomics, then finds the bin where the count from the top reaches `need`.
// The first pass bins a key by the number of leading bits it shares with
// the largest key M (a key sharing more is larger), so that keys close to
// each other, as the best of a list are, spread over many bins instead of
// piling onto the one bin of their top bits; the passes after it take
// kSelectBits at a time below the first bit where the key differs from M:
// at most four passes.  The work and the result depend on the keys alone,
// not on their order nor on thread timing.  Every thread of the block calls
// it (it meets at __syncthreads); `cross`: 3 words, `warp_sums`:
// blockDim.x / 32 words.
template <class KeyOf>
__device__ Selected block_select(KeyOf key_of, long long count, unsigned need,
                                 unsigned* hist, unsigned* cross, unsigned* warp_sums) {
  unsigned top = 0;
  for_keys(key_of, count, [&](unsigned key) { top = max(top, key); });
  top = block_max(top, warp_sums);
  const int per = kSelectBins / blockDim.x;   // bins a thread owns in the crossing
  unsigned prefix = 0, mask = 0, above = 0, equal = 0;
  int hi = 32;                                // pass 0; then the highest bit not known
  for (int pass = 0; hi >= 0; ++pass) {
    const int bits = pass == 0 ? 0 : (hi + 1 < kSelectBits ? hi + 1 : kSelectBits);
    const int shift = pass == 0 ? 0 : hi + 1 - bits;
    for (int b = threadIdx.x; b < kSelectBins; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for_keys(key_of, count, [&](unsigned key) {
      if ((key & mask) != prefix) return;
      const unsigned bin =
          pass == 0 ? (unsigned)__clz(key ^ top) : (key >> shift) & ((1u << bits) - 1u);
      atomicAdd(&hist[bin], 1u);
    });
    __syncthreads();
    // thread t owns bins last, last - 1, ..., last - per + 1, thread 0 the top
    const int last = kSelectBins - 1 - (int)threadIdx.x * per;
    unsigned sum = 0;
    for (int b = 0; b < per; ++b) sum += hist[last - b];
    unsigned total;
    unsigned run = block_scan(sum, warp_sums, &total);
    if (run < need && need <= run + sum) {
      for (int b = 0; b < per; ++b) {
        const unsigned c = hist[last - b];
        if (run + c >= need) {
          cross[0] = last - b;
          cross[1] = run;
          cross[2] = c;
          break;
        }
        run += c;
      }
    }
    __syncthreads();
    const unsigned bin = cross[0];
    above += cross[1];
    need -= cross[1];
    equal = cross[2];
    __syncthreads();                          // cross is read before it is written again
    if (pass > 0) {
      prefix |= bin << shift;
      mask |= ((1u << bits) - 1u) << shift;
      hi = shift - 1;
    } else if (bin == 32) {                   // the top key itself
      prefix = top;
      hi = -1;
    } else {                                  // top's first `bin` bits, then a 0 where top has a 1
      mask = 0xFFFFFFFFu << (31 - bin);
      prefix = top & mask & ~(0x80000000u >> bin);
      hi = 30 - (int)bin;
    }
  }
  return {prefix, above, equal};
}

// Opt the kernel into `bytes` of dynamic shared memory (above 48 KB a kernel
// must ask first).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
