// Helpers shared by the kernels: the corpus and item scorers' device code,
// and the launchers' shared-memory and grid set-up.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace repro {

// Dead-slot sentinel; the one value of kernels/dplr_corpus_score.py NEG_INF.
constexpr float kNegInf = -1e30f;

// The largest rho * k any kernel here takes (the wrappers check it first).
constexpr int kMaxRK = 128;

// Row stride in shared memory for rows of `width` floats: odd, so that
// thread t reading word j of row t hits bank (t * stride + j) % 32, which
// differs across the 32 lanes of a warp (no bank conflicts).
__host__ __device__ inline int padded_stride(int width) { return width | 1; }

// The element types of a slab (and of the item kernel's V_I and the bag's
// table): float, or __nv_bfloat16, read as stored and upcast to f32 (exact)
// where a thread reads a value.  Codes of the C entry points' `dtype`.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the nearest bf16 (ties to even), as f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Words of shared memory a staged row of `width` elements of T takes (odd,
// as padded_stride), and that stride in elements.  For float, padded_stride.
template <class T>
__host__ __device__ inline int row_words(int width) {
  return padded_stride((width * (int)sizeof(T) + 3) / 4);
}
template <class T>
__host__ __device__ inline int row_stride(int width) {
  return row_words<T>(width) * 4 / (int)sizeof(T);
}

// Words a staged row of `width` elements of T takes when a thread reads its
// row 16 bytes at a time (width * sizeof(T) a multiple of 16): an odd
// number of 16-byte pieces.  A 16-byte load is served 8 lanes at a time,
// and rows an odd number of pieces apart start those 8 lanes on 8
// different groups of 4 banks (no bank conflicts); every row starts
// 16-byte aligned, as a bulk copy's destination must.
template <class T>
__host__ __device__ inline int wide_row_words(int width) {
  return 4 * ((width * (int)sizeof(T) / 16) | 1);
}

// Copy rows [row0, row0 + rows) of a row-major (n, width) array of T into
// shared memory with row stride `stride` elements, the whole block
// cooperating so that neighbouring threads read neighbouring addresses.
// Rows at or past n are zero-filled.  Each thread issues kStageBatch
// independent loads before it stores any of them, so that many loads are
// in flight per thread: a load-then-store loop would wait out the device
// memory latency once per element.  Rows of a whole number of 16-byte
// pieces from a 16-byte aligned base are read 16 bytes a load (4 floats or
// 8 bf16), others one element a load.
constexpr int kStageBatch = 8;

__device__ inline void put_words(float* d, float v) { d[0] = v; }
__device__ inline void put_words(float* d, float4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ inline void put_words(__nv_bfloat16* d, __nv_bfloat16 v) { d[0] = v; }
// 8 bf16 to a 4-byte aligned place (an odd word stride leaves rows only that)
__device__ inline void put_words(__nv_bfloat16* d, uint4 v) {
  unsigned* w = reinterpret_cast<unsigned*>(d);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

template <class V, class T>
__device__ inline void stage_rows_as(const T* __restrict__ src, long long row0, int rows,
                                     long long n, int width, int stride,
                                     T* __restrict__ dst) {
  constexpr int kW = sizeof(V) / sizeof(T);
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

__device__ inline void stage_rows(const __nv_bfloat16* __restrict__ src, long long row0,
                                  int rows, long long n, int width, int stride,
                                  __nv_bfloat16* __restrict__ dst) {
  if (width % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0)
    stage_rows_as<uint4>(src, row0, rows, n, width, stride, dst);
  else
    stage_rows_as<__nv_bfloat16>(src, row0, rows, n, width, stride, dst);
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

// Accumulation modes of the rank-space reduction (the reference's
// acc_dtype): kAccF32 sums each query's squares in f32; kAccBF16 rounds
// each square p^2 and each e_r to bf16, sums their products (exact in f32)
// in f32 in the same fixed order, and rounds the sum once to bf16.
constexpr int kAccF32 = 0;
constexpr int kAccBF16 = 1;

// One slot's masked-before scores against G queries,
//   s[j] = (a_C[j] + a_I) + 0.5 * sum_r e_r ||P_C[j, r] + Q_I[r]||^2,
// the one scorer of every kernel that scores a slot (the full scores and
// both top-K modes), so that all of them round a score the same way.  In
// kAccF32 mode, per query, the squares of row r summed in order by fused
// multiply-adds, the rows weighted in order, and the final multiply-add
// written out; the slot's row (T: float or bf16) is upcast as it is read,
// so a bf16 slab scores bitwise as its upcast f32 copy.  In kAccBF16 mode,
// as the enum says, then the same final multiply-add.  `q`: the slot's
// rho * k row; `pcT`: the queries' P_C transposed, pcT[c * G + j] =
// P_C[j].flat[c], so that one load reads entry c of several queries and
// the slot's row is read once for all G.
template <int G, class T, int Acc>
__device__ inline void slot_score(float ai, const T* q, const float* pcT, const float* ac,
                                  const float* e, int rho, int k, float* s) {
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.f;
  for (int r = 0; r < rho; ++r) {
    if constexpr (Acc == kAccF32) {
      float part[G];
#pragma unroll
      for (int j = 0; j < G; ++j) part[j] = 0.f;
      for (int c = r * k; c < (r + 1) * k; ++c) {
        const float qv = to_f32(q[c]);
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
    } else {
      const float er = round_bf16(e[r]);
      for (int c = r * k; c < (r + 1) * k; ++c) {
        const float qv = to_f32(q[c]);
        float pc[G];
        load_row<G>(pcT + c * G, pc);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float p = pc[j] + qv;
          acc[j] = fmaf(round_bf16(__fmul_rn(p, p)), er, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
    s[j] = fmaf(0.5f, Acc == kAccF32 ? acc[j] : round_bf16(acc[j]), ac[j] + ai);
}

// 16 bytes of a staged row as f32 values in order: 4 floats, or 8 bf16
// upcast (exact, as to_f32).
__device__ __forceinline__ void load_piece(const float* src, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_piece(const __nv_bfloat16* src, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// slot_score for NS slots at once, each slot's row q[s] read 16 bytes at a
// time (rows 16-byte aligned, k a multiple of 16 / sizeof(T)), each load of
// the queries' P_C serving all NS slots.  Per slot and query the
// operations are slot_score's, in its order, so a slot scores the same bits
// either way: s[t][j] is slot_score(ai[t], q[t], ...)'s s[j].
template <int G, class T, int Acc, int NS>
__device__ __forceinline__ void slot_scores_wide(const float* ai, const T* const* q,
                                                 const float* pcT, const float* ac,
                                                 const float* e, int rho, int k,
                                                 float (*s)[G]) {
  constexpr int E = 16 / (int)sizeof(T);
  float acc[NS][G];
#pragma unroll
  for (int t = 0; t < NS; ++t)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[t][j] = 0.f;
  for (int r = 0; r < rho; ++r) {
    float part[NS][G];
#pragma unroll
    for (int t = 0; t < NS; ++t)
#pragma unroll
      for (int j = 0; j < G; ++j) part[t][j] = 0.f;
    const float er = Acc == kAccF32 ? 0.f : round_bf16(e[r]);
    for (int c0 = r * k; c0 < (r + 1) * k; c0 += E) {
      float x[NS][E];
#pragma unroll
      for (int t = 0; t < NS; ++t) load_piece(q[t] + c0, x[t]);
#pragma unroll
      for (int u = 0; u < E; ++u) {
        float pc[G];
        load_row<G>(pcT + (c0 + u) * G, pc);
#pragma unroll
        for (int t = 0; t < NS; ++t)
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float p = pc[j] + x[t][u];
            if constexpr (Acc == kAccF32)
              part[t][j] = fmaf(p, p, part[t][j]);
            else
              acc[t][j] = fmaf(round_bf16(__fmul_rn(p, p)), er, acc[t][j]);
          }
      }
    }
    if constexpr (Acc == kAccF32) {
#pragma unroll
      for (int t = 0; t < NS; ++t)
#pragma unroll
        for (int j = 0; j < G; ++j) acc[t][j] = fmaf(e[r], part[t][j], acc[t][j]);
    }
  }
#pragma unroll
  for (int t = 0; t < NS; ++t)
#pragma unroll
    for (int j = 0; j < G; ++j)
      s[t][j] = fmaf(0.5f, Acc == kAccF32 ? acc[t][j] : round_bf16(acc[t][j]), ac[j] + ai[t]);
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

// Blocks of `kernel` the card holds at once (resident blocks an SM at
// `threads` threads and `smem` bytes of dynamic shared memory, times the
// SMs): the grid of a persistent kernel.  Asked of the runtime once per
// (kernel, threads, smem, device) and kept, so that a launch adds no query.
template <typename Kernel>
inline cudaError_t one_wave(Kernel kernel, int threads, size_t smem, int device,
                            long long* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t, int>, long long> known;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), threads, smem, device);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = known[key] = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return cudaSuccess;
}

}  // namespace repro
