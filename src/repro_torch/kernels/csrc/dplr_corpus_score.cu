// Corpus-cached DPLR-FwFM scoring against a capacity-padded item slab, in
// three modes: the full (Bq, n) score matrix, a masked top-K per query, and
// the masked top-K of S tenants' slabs in one launch.
//
//   s[q, i] = (a_C[q] + a_I[i]) + 0.5 * sum_r e_r ||P_C[q, r] + Q_I[i, r]||^2
//   s[q, i] = -1e30 where valid[i] == 0
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dplr_corpus_score.py:
// dplr_corpus_score() (_kernel_full for topk=None, _kernel_topk for topk=K)
// and dplr_corpus_score_multi() (_kernel_multi_topk).
//
// What bounds it on an H100: memory.  Each item costs rho*k*4 bytes of Q_I
// (192 B at rho = 3, k = 16) plus 5 bytes of a_I and valid, against
// 3 * rho * k flops per query, so below Bq of about 60 the pass over Q_I
// is the floor; the full mode adds Bq * n * 4 bytes of output.  What keeps a
// kernel off that floor is the work per byte it adds on the way: shared-
// memory loads in the scorer, and in the top-K modes the selection.
//
// What the design does about it:
//  * One scorer (common.cuh slot_score<G>) for every mode: a thread scores
//    its slot against G <= 16 queries at once, reading the slot's row once
//    and the queries' P_C transposed, 4 queries to a 16-byte broadcast
//    load; per query the operations are those of the plain direct form, in
//    one order, so the top-K modes return kernel 1's scores bitwise.  All
//    arithmetic is f32 in the direct form, not the GEMM expansion
//    ||P_C||^2 + 2<P_C, Q_I> + ||Q_I||^2, whose rounding differs.
//  * Q_I is copied tile by tile into shared memory (common.cuh stage_rows,
//    16 bytes a load where the rows allow), with an odd row stride so that
//    each thread then reads its own slot's row without bank conflicts.
//  * Full mode: a block of 128 threads holds up to 16 queries' P_C and one
//    slot per thread, and writes out[q, i] with consecutive threads on
//    consecutive i.
//  * Top-K modes: a CUDA grid has no order, so the TPU kernel's running
//    top-K, carried across a sequential grid, does not carry over; a full
//    sort of every chunk (the previous design) cost ~59x the bound; a
//    running threshold costs more when later slots score higher; and an
//    exact select of each (row, chunk) in shared memory, tried first, cost
//    as much as the scoring at Bq = 16.  Instead, an exact radix select
//    over the whole row, in two launches (K <= 4096; sorts follow past it):
//    - Stage 1, block (chunk of 512 slots, group of up to 16 query rows):
//      Q_I, a_I and valid are read once per group of 16 rows, so once a
//      call for Bq <= 16.  The block writes its rows' scores (a slot's at
//      its own position) and adds their first digits (the top 11 bits of
//      the order-preserving key) to a per-row histogram in device memory
//      (integer atomics, after counting in shared memory).
//    - Merge, blocks (row, part of 16384 scores): each finds from the
//      histogram the bin b1 of the row's K-th largest score, keeps the
//      scores at or above it, and counts the next 12 key bits of those on
//      b1 into a second per-row histogram.  The last block of the row (an
//      atomic ticket after a __threadfence) finds the second digit's bin
//      b2 of the K-th; the two histograms count the kept scores at or
//      above (b1, b2).  If those fit in shared memory (2 next_pow2(K)
//      entries, K <= 4096) it reads them there, sorts them whole by (value
//      desc, slot asc) and writes the first K.  Else it copies them into
//      the row's scores, dead after the ticket, where they fit (else reads
//      them from the kept set through the (b1, b2) test each time),
//      radix-selects the exact K-th key among them (common.cuh
//      block_select), breaks ties on it by a second select on the slot
//      (the lowest slots win, as in lax.top_k), and sorts the K winners:
//      in shared memory for K <= 4096; past that topk_sort_tiles (bitonic
//      sorts of 16384 in shared memory) and topk_sort_merge (merge-path
//      rounds in device memory) order them.
//    No step's work depends on the order of the scores, only on their
//    values, and every step's result is a function of the keys alone (the
//    atomics only count, or place entries that the final sort orders), so
//    the result is the same from run to run.  What bounds the merge is the
//    second read of every score, and the last block, which works alone.
//    The scratch is 3 words a (row, slot): the scores and the kept set.
//  * Multi-tenant mode: the TPU kernel concatenates the S slabs on the item
//    axis (a copy of every slab on every call) and scores each tile against
//    all S * Bq query rows, masking the foreign ones.  Here the S slabs stay
//    where they are: a table of S (Q_I, a_I, valid, n) entries travels as a
//    kernel parameter, and a stage-1 block scores a chunk of segment s
//    against that segment's rows alone, with the same device code as the
//    single-slab mode; a row's merge reads its own segment's scores.  The
//    top-K order is a total order, so row [s] is bitwise the single-slab
//    top-K of segment s.
#include "common.cuh"

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

using repro::kMaxRK;
using repro::kNegInf;

constexpr int kFullTile = 128;       // slots per full-mode block, one per thread
constexpr int kTopkThreads = 256;    // stage-1 threads: one slot each per tile
constexpr int kChunk = 512;          // slots a stage-1 block scores and selects from
constexpr int kMaxGroup = 16;        // query rows a stage-1 block scores at once
constexpr int kHistBits = 11;        // key bits of the merge's first digit
constexpr int kHistBins = 1 << kHistBits;
constexpr int kHist2Bits = 12;       // and of its second, the bits below the first
constexpr int kHist2Bins = 1 << kHist2Bits;
constexpr int kScoreStride = kChunk + 1;        // a row of chunk scores in shared memory
constexpr int kPackedStride = kHistBins / 2 + 1;  // a row's first-digit bins, two a word
constexpr int kMergeThreads = 1024;
constexpr int kPart = 16384;         // candidates one merge block filters
constexpr int kMaxBlockK = 4096;     // largest K the merge's last block sorts
constexpr int kSortTile = 16384;     // entries one topk_sort_tiles block sorts
constexpr int kSortThreads = 1024;
constexpr int kRoundThreads = 256;   // topk_sort_merge threads: one entry each
constexpr int kMaxSegments = 64;     // segments of one multi-tenant launch
constexpr int kMaxGrid = 65535;      // grid.y and grid.z limit

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline long long n_chunks_of(long long n) { return (n + kChunk - 1) / kChunk; }

// Shared-memory layout (in words) of the full mode for G queries: P_C
// transposed first (16-byte aligned), then e, a_C and the Q_I tile.
struct FullSmem {
  int pcT, es, ac, qs, words;
  __host__ __device__ FullSmem(int G, int rho, int k) {
    const int RK = rho * k;
    pcT = 0;
    es = pcT + RK * G;
    ac = es + round4(rho);
    qs = ac + round4(G);
    words = qs + kFullTile * repro::padded_stride(RK);
  }
};

template <int G>
__global__ void __launch_bounds__(kFullTile)
corpus_score_full(const float* __restrict__ Q, const float* __restrict__ aI,
                  const unsigned char* __restrict__ valid, const float* __restrict__ e,
                  const float* __restrict__ PC, const float* __restrict__ aC, long long n,
                  int Bq, int rho, int k, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int RK = rho * k;
  const int RKP = repro::padded_stride(RK);
  const FullSmem lay(G, rho, k);
  float* pcT = smem + lay.pcT;
  float* es = smem + lay.es;
  float* ac = smem + lay.ac;
  float* qs = smem + lay.qs;

  const long long row0 = (long long)blockIdx.x * kFullTile;
  const int q0 = blockIdx.y * G;
  const int nq = min(G, Bq - q0);
  for (int t = threadIdx.x; t < RK * G; t += blockDim.x) {
    const int c = t / G, j = t % G;
    pcT[t] = j < nq ? PC[(long long)(q0 + j) * RK + c] : 0.f;
  }
  for (int t = threadIdx.x; t < rho; t += blockDim.x) es[t] = e[t];
  for (int t = threadIdx.x; t < G; t += blockDim.x) ac[t] = t < nq ? aC[q0 + t] : 0.f;
  repro::stage_rows(Q, row0, kFullTile, n, RK, RKP, qs);
  __syncthreads();

  const long long i = row0 + threadIdx.x;
  if (i >= n) return;
  float s[G];
  if (valid == nullptr || valid[i] != 0) {
    repro::slot_score<G>(aI[i], qs + threadIdx.x * RKP, pcT, ac, es, rho, k, s);
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) s[j] = kNegInf;
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < nq) out[(long long)(q0 + j) * n + i] = s[j];
}

// Shared-memory layout (in words) of a stage-1 block for G query rows:
// P_C transposed (16-byte aligned), e, a_C, the G rows' chunk scores (odd
// row stride), and a work area: the Q_I tile while scoring, then the rows'
// first-digit bins, two 16-bit counts a word (odd row stride).
struct ChunkSmem {
  int pcT, es, ac, sc, work, words;
  __host__ __device__ ChunkSmem(int G, int rho, int k) {
    const int RK = rho * k;
    pcT = 0;
    es = pcT + RK * G;
    ac = es + round4(rho);
    sc = ac + round4(G);
    work = sc + G * kScoreStride;
    words = work + imax(kTopkThreads * repro::padded_stride(RK), G * kPackedStride);
  }
};

// Stage 1 of the top-K modes, one block: score slots [chunk * kChunk,
// (chunk + 1) * kChunk) of one slab against nq <= G query rows (P_C rows
// `PC`, a_C `aC`), write the scores to cand_v[j * stride + chunk * kChunk
// ...] (a slot's candidate is at its own position) and add their first
// digits (top kHistBits bits of the order key) to the rows' bins
// hist1[j * kHistBins ...].  Slots past the slab's end score -inf, below
// every slot.  Shared by the single-slab and the multi-tenant kernels, so
// that both score identically.
template <int G>
__device__ void chunk_scores(const float* __restrict__ Q, const float* __restrict__ aI,
                             const unsigned char* __restrict__ valid, long long n,
                             const float* __restrict__ e, const float* __restrict__ PC,
                             const float* __restrict__ aC, int nq, int rho, int k,
                             long long chunk, float* __restrict__ cand_v, long long stride,
                             unsigned* __restrict__ hist1) {
  extern __shared__ __align__(16) float smem[];
  const int RK = rho * k;
  const int RKP = repro::padded_stride(RK);
  const ChunkSmem lay(G, rho, k);
  float* pcT = smem + lay.pcT;
  float* es = smem + lay.es;
  float* ac = smem + lay.ac;
  float* sc = smem + lay.sc;
  float* work = smem + lay.work;
  const int tid = threadIdx.x;

  const long long base = chunk * kChunk;
  for (int t = tid; t < RK * G; t += kTopkThreads) {
    const int c = t / G, j = t % G;
    pcT[t] = j < nq ? PC[(long long)j * RK + c] : 0.f;
  }
  for (int t = tid; t < rho; t += kTopkThreads) es[t] = e[t];
  for (int t = tid; t < G; t += kTopkThreads) ac[t] = t < nq ? aC[t] : 0.f;
  for (int off = 0; off < kChunk; off += kTopkThreads) {
    __syncthreads();                // the previous tile is consumed
    repro::stage_rows(Q, base + off, kTopkThreads, n, RK, RKP, work);
    __syncthreads();
    const long long i = base + off + tid;
    float s[G];
    if (i < n && (valid == nullptr || valid[i] != 0)) {
      repro::slot_score<G>(aI[i], work + tid * RKP, pcT, ac, es, rho, k, s);
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j) s[j] = i < n ? kNegInf : -CUDART_INF_F;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      sc[j * kScoreStride + off + tid] = s[j];
      if (j < nq) cand_v[(long long)j * stride + base + off + tid] = s[j];
    }
  }

  // the rows' first digits, neighbouring threads on different rows (so on
  // different bins of a dense region)
  unsigned* bins = reinterpret_cast<unsigned*>(work);
  __syncthreads();                  // the tile is consumed
  for (int t = tid; t < nq * kPackedStride; t += kTopkThreads) bins[t] = 0;
  __syncthreads();
  for (int t = tid; t < nq * kChunk; t += kTopkThreads) {
    const int j = t % nq, i = t / nq;
    const unsigned b = repro::order_key(sc[j * kScoreStride + i]) >> (32 - kHistBits);
    atomicAdd(&bins[j * kPackedStride + (b >> 1)], b & 1u ? 0x10000u : 1u);
  }
  __syncthreads();
  for (int t = tid; t < nq * (kHistBins / 2); t += kTopkThreads) {
    const int j = t / (kHistBins / 2), w = t % (kHistBins / 2);
    const unsigned c = bins[j * kPackedStride + w];
    unsigned* h = hist1 + (long long)j * kHistBins + 2 * w;
    if (c & 0xFFFFu) atomicAdd(h, c & 0xFFFFu);
    if (c >> 16) atomicAdd(h + 1, c >> 16);
  }
}

// Stage 1 of the single-slab top-K: block (chunk, group of G rows).
template <int G>
__global__ void __launch_bounds__(kTopkThreads, 2)
corpus_topk_chunks(const float* __restrict__ Q, const float* __restrict__ aI,
                   const unsigned char* __restrict__ valid, const float* __restrict__ e,
                   const float* __restrict__ PC, const float* __restrict__ aC, long long n,
                   int Bq, int rho, int k, float* cand_v, long long stride, unsigned* hist1) {
  const int q0 = blockIdx.y * G;
  const long long RK = (long long)rho * k;
  chunk_scores<G>(Q, aI, valid, n, e, PC + q0 * RK, aC + q0, min(G, Bq - q0), rho, k,
                  blockIdx.x, cand_v + q0 * stride, stride, hist1 + (long long)q0 * kHistBins);
}

// The S slabs of a multi-tenant launch, by value in the kernel's parameters
// (S <= kMaxSegments; 2 KB of the 4 KB a launch may pass).
struct Segments {
  const float* Q[kMaxSegments];
  const float* aI[kMaxSegments];
  const unsigned char* valid[kMaxSegments];   // nullptr: every slot live
  long long n[kMaxSegments];
};

// Stage 1 of the multi-tenant top-K: block (chunk, segment s and group of
// G of its Bq rows), rows s * Bq + q.  A chunk past the end of a shorter
// segment has nothing to do (the merge reads that segment's chunks alone).
template <int G>
__global__ void __launch_bounds__(kTopkThreads, 2)
corpus_multi_topk_chunks(const __grid_constant__ Segments segs, const float* __restrict__ e,
                         const float* __restrict__ PC, const float* __restrict__ aC, int Bq,
                         int rho, int k, float* cand_v, long long stride, unsigned* hist1) {
  const int groups = (Bq + G - 1) / G;
  const int s = blockIdx.y / groups;
  const int q0 = (blockIdx.y % groups) * G;
  const long long chunk = blockIdx.x;
  const long long n = segs.n[s];
  if (chunk * kChunk >= n) return;
  const long long row0 = (long long)s * Bq + q0;
  const long long RK = (long long)rho * k;
  chunk_scores<G>(segs.Q[s], segs.aI[s], segs.valid[s], n, e + (long long)s * rho,
                  PC + row0 * RK, aC + row0, min(G, Bq - q0), rho, k, chunk,
                  cand_v + row0 * stride, stride, hist1 + row0 * kHistBins);
}

// The merge's device memory for one row: its candidates, its digit bins
// and counters, the kept candidates, and where its K winners go.
struct MergeRow {
  float* cand_v;              // the row's scores, m of them, slot i at i; dead once
                              // the last block holds the ticket
  long long m;
  const unsigned* hist1;      // kHistBins: first digits of all m scores
  unsigned* hist2;            // kHist2Bins: second digits of those in the bin of the K-th
  unsigned* sel_count;
  unsigned* ticket;
  float* sel_v;               // room for m: the kept scores
  int* sel_i;
  float* out_v;               // K: the final row (sorted) or, past kMaxBlockK, the winners
  int* out_i;
};

// Shared memory of a merge block, in words: the select's bins, a part's
// second-digit bins and scratch, then (for K <= kMaxBlockK) room to sort
// 2 next_pow2(K) values and slots.
constexpr int kMergeHead =
    repro::kSelectBins + kHist2Bins + 4 + 2 * (kMergeThreads / 32) + 4;

__device__ inline unsigned digit1(unsigned key) { return key >> (32 - kHistBits); }
__device__ inline unsigned digit2(unsigned key) {
  return (key >> (32 - kHistBits - kHist2Bits)) & (kHist2Bins - 1u);
}

// The bin of `hist` (nbins, in device memory) where the count from the top
// reaches `need`, and the count above it; every thread of the block calls
// it.  Thread t owns nbins / kMergeThreads bins, thread 0 the top ones.
template <int NB>
__device__ uint2 crossing(const unsigned* hist, unsigned need, unsigned* cross,
                          unsigned* warp_sums) {
  constexpr int kPer = NB / kMergeThreads;
  const int top = NB - 1 - (int)threadIdx.x * kPer;
  unsigned c[kPer], sum = 0;
#pragma unroll
  for (int b = 0; b < kPer; ++b) sum += c[b] = __ldcg(hist + top - b);
  unsigned total;
  unsigned run = repro::block_scan(sum, warp_sums, &total);
  if (run < need && need <= run + sum) {
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      if (run + c[b] >= need) {
        cross[0] = top - b;
        cross[1] = run;
        break;
      }
      run += c[b];
    }
  }
  __syncthreads();
  const uint2 out = make_uint2(cross[0], cross[1]);
  __syncthreads();
  return out;
}

// Appends the entries (v, slot) for which `take` holds to (to_v, to_i),
// each warp reserving its places with one atomic on *count (shared memory);
// thread t reads entries t, t + blockDim.x, ..., kSelectBatch of them
// before it uses one.  The order of the appended entries depends on timing;
// the callers' selections and sort do not.
template <class Get, class Take>
__device__ void append(long long n, Get get, Take take, float* to_v, int* to_i,
                       unsigned* count) {
  const int lane = threadIdx.x & 31;
  constexpr int kB = repro::kSelectBatch;
  for (long long i0 = 0; i0 < n; i0 += (long long)kB * blockDim.x) {
    float v[kB];
    int slot[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const long long i = i0 + (long long)u * blockDim.x + threadIdx.x;
      v[u] = 0.f;
      slot[u] = 0;
      if (i < n) get(i, v[u], slot[u]);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const long long i = i0 + (long long)u * blockDim.x + threadIdx.x;
      const bool ok = i < n && take(v[u], slot[u]);
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      unsigned at = 0;
      if (lane == 0 && ballot) at = atomicAdd(count, (unsigned)__popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(ballot & ((1u << lane) - 1u));
      if (ok) {
        to_v[at] = v[u];
        to_i[at] = slot[u];
      }
    }
  }
}

// The last block's pick: the K winners among the n entries (value, slot)
// at (src_v, src_i), of those whose key is at least `least` if Filtered:
// the exact K-th key by a radix select, the ties on it to the lowest slots
// by a select on ~slot.  Appends them to (to_v, to_i) in no order.
template <bool Filtered>
__device__ __forceinline__ void pick_winners(const float* src_v, const int* src_i, long long n,
                                             unsigned least, int K, float* to_v, int* to_i,
                                             unsigned* hist, unsigned* cross,
                                             unsigned* warp_sums, unsigned* count) {
  const repro::Selected cut = repro::block_select(
      [src_v, least](long long i, unsigned& key) {
        key = repro::order_key(__ldcg(src_v + i));
        return !Filtered || key >= least;
      },
      n, (unsigned)K, hist, cross, warp_sums);
  const unsigned T = cut.key;
  const unsigned need_eq = K - cut.above;
  unsigned slot_cut = 0;            // ~slot at or above it: every entry on the key
  if (cut.equal > need_eq) {        // ties on the K-th key: the lowest slots
    slot_cut = repro::block_select(
                   [src_v, src_i, T](long long i, unsigned& key) {
                     if (repro::order_key(__ldcg(src_v + i)) != T) return false;
                     key = ~(unsigned)__ldcg(src_i + i);
                     return true;
                   },
                   n, need_eq, hist, cross, warp_sums)
                   .key;
  }
  // the keys above the K-th (all at or above `least`), and on it the
  // slots from the lowest
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  append(
      n,
      [src_v, src_i](long long i, float& v, int& slot) {
        v = __ldcg(src_v + i);
        slot = __ldcg(src_i + i);
      },
      [T, slot_cut](float v, int slot) {
        const unsigned key = repro::order_key(v);
        return key > T || (key == T && ~(unsigned)slot >= slot_cut);
      },
      to_v, to_i, count);
}

// Merge block (row, part): keep the part's scores whose first digit is at
// or above b1, the bin of the row's K-th largest score, and count the second
// digits of those on b1.  The row's last block then finds b2, the second
// digit's bin of the K-th, keeps the kept scores at or above (b1, b2), picks
// the K winners among those exactly, and, for K <= kMaxBlockK, sorts them
// and writes the row relabeled (else writes them for the sort kernels).
__device__ void merge_row(const MergeRow& r, int part, int K, long long index_offset,
                          long long index_stride) {
  extern __shared__ __align__(16) float smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);    // kSelectBins
  unsigned* h2 = hist + repro::kSelectBins;               // kHist2Bins
  unsigned* cross = h2 + kHist2Bins;                      // 4
  unsigned* warp_sums = cross + 4;                        // kMergeThreads / 32
  unsigned* warp_base = warp_sums + kMergeThreads / 32;   // kMergeThreads / 32
  unsigned* misc = warp_base + kMergeThreads / 32;        // 4
  float* sv = smem + kMergeHead;                          // 2 next_pow2(K) when sorting
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int parts = (int)((r.m + kPart - 1) / kPart);
  if (part >= parts) return;

  const uint2 c1 = crossing<kHistBins>(r.hist1, (unsigned)K, cross, warp_sums);
  const unsigned b1 = c1.x;

  // this part: count the kept scores and the second digits of those on b1,
  // then write the kept ones, each warp's in one range at offsets reserved
  // with one atomic per block, so that a warp's stores are contiguous (a
  // part with none skips the second read)
  for (int b = tid; b < kHist2Bins; b += kMergeThreads) h2[b] = 0;
  __syncthreads();
  const long long lo = (long long)part * kPart;
  const long long hi = lo + kPart < r.m ? lo + kPart : r.m;
  unsigned mine = 0;
  for (long long i = lo + tid; i < hi; i += kMergeThreads) {
    const unsigned key = repro::order_key(r.cand_v[i]);
    mine += digit1(key) >= b1;
    if (digit1(key) == b1) atomicAdd(&h2[digit2(key)], 1u);
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) warp_sums[warp] = mine;
  __syncthreads();
  if (tid == 0) {
    unsigned total = 0;
    for (int w = 0; w < kMergeThreads / 32; ++w) {
      warp_base[w] = total;
      total += warp_sums[w];
    }
    misc[0] = total ? atomicAdd(r.sel_count, total) : 0u;
    misc[3] = total;
  }
  for (int b = tid; b < kHist2Bins; b += kMergeThreads)
    if (h2[b]) atomicAdd(&r.hist2[b], h2[b]);
  __syncthreads();
  if (misc[3]) {
    unsigned at = misc[0] + warp_base[warp];
    for (long long i0 = lo; i0 < hi; i0 += kMergeThreads) {
      const long long i = i0 + tid;
      const float v = i < hi ? r.cand_v[i] : -CUDART_INF_F;
      const bool keep = i < hi && digit1(repro::order_key(v)) >= b1;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const unsigned to = at + __popc(ballot & ((1u << lane) - 1u));
        r.sel_v[to] = v;
        r.sel_i[to] = (int)i;
      }
      at += __popc(ballot);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) misc[1] = atomicAdd(r.ticket, 1u) == (unsigned)parts - 1;
  __syncthreads();
  if (!misc[1]) return;

  // the row's last block: every part's kept scores are in sel and its
  // second digits in hist2.  The K winners are among the kept scores at or
  // above (b1, b2), and the two histograms count those.
  __threadfence();
  const long long count = *reinterpret_cast<volatile unsigned*>(r.sel_count);
  const uint2 c2 = crossing<kHist2Bins>(r.hist2, K - c1.y, cross, warp_sums);
  const unsigned b2 = c2.x;
  const long long n_fin = (long long)c1.y + c2.y + __ldcg(r.hist2 + b2);
  // a key is at or above (b1, b2) iff it is at or above the least key there
  const unsigned narrow_lo = b1 << (32 - kHistBits) | b2 << (32 - kHistBits - kHist2Bits);
  const auto narrowed = [narrow_lo](float v, int) { return repro::order_key(v) >= narrow_lo; };
  const float* sel_v = r.sel_v;
  const int* sel_i = r.sel_i;
  const auto get = [sel_v, sel_i](long long i, float& v, int& slot) {
    v = __ldcg(sel_v + i);
    slot = __ldcg(sel_i + i);
  };

  const bool sort_here = K <= kMaxBlockK;
  int N = 1;
  while (N < K) N <<= 1;
  int* si = reinterpret_cast<int*>(sv + 2 * N);
  if (sort_here && n_fin <= 2 * N) {
    // the narrowed set fits: sort it whole and keep its first K
    int M = 1;
    while (M < n_fin) M <<= 1;
    if (tid == 0) misc[2] = 0;
    __syncthreads();
    append(count, get, narrowed, sv, si, misc + 2);
    __syncthreads();
    for (int t = (int)n_fin + tid; t < M; t += kMergeThreads) {
      sv[t] = -CUDART_INF_F;
      si[t] = INT_MAX;
    }
    repro::bitonic_sort(sv, si, M);
    for (int t = tid; t < K; t += kMergeThreads) {
      r.out_v[t] = sv[t];
      r.out_i[t] = (int)(index_offset + index_stride * (long long)si[t]);
    }
    return;
  }

  // Else select among them, read several times: from a copy of them in the
  // row's scores, dead since the ticket, where it fits (2 words an entry),
  // else from sel through the (b1, b2) test (most of the row shares the
  // K-th's bins, as when all scores are equal).
  float* to_v = sort_here ? sv : r.out_v;
  int* to_i = sort_here ? si : r.out_i;
  if (2 * n_fin <= r.m) {
    float* fin_v = r.cand_v;
    int* fin_i = reinterpret_cast<int*>(r.cand_v + n_fin);
    if (tid == 0) misc[2] = 0;
    __syncthreads();
    append(count, get, narrowed, fin_v, fin_i, misc + 2);
    __syncthreads();
    pick_winners<false>(fin_v, fin_i, n_fin, 0u, K, to_v, to_i, hist, cross, warp_sums,
                        misc + 3);
  } else {
    pick_winners<true>(sel_v, sel_i, count, narrow_lo, K, to_v, to_i, hist, cross, warp_sums,
                       misc + 3);
  }
  if (!sort_here) return;
  for (int t = K + tid; t < N; t += kMergeThreads) {
    sv[t] = -CUDART_INF_F;
    si[t] = INT_MAX;
  }
  repro::bitonic_sort(sv, si, N);
  for (int t = tid; t < K; t += kMergeThreads) {
    r.out_v[t] = sv[t];
    r.out_i[t] = (int)(index_offset + index_stride * (long long)si[t]);
  }
}

// Shared-memory bytes of a merge block for K.
size_t merge_smem(int K) {
  int N = 1;
  while (N < K) N <<= 1;
  return (kMergeHead + (K <= kMaxBlockK ? 4 * N : 0)) * sizeof(float);
}

// The per-call scratch of a top-K launch, in 4-byte words, for rows of m
// candidates: per row, the two digits' bins and two counters (zeroed before
// stage 1), the scores (after the merge's ticket, room for the last block's
// narrowed copy), the kept scores and their slots (room for all m: every
// score may share the K-th's first digit), and for K > kMaxBlockK two
// buffers of K winners for the sort.  So 3 words a (row, slot): at Bq = 16
// and n = 2^20, 201 MB, three times kernel 1's (Bq, n) output.
struct Scratch {
  long long counters, cand_v, sel, win, words;
  Scratch(long long rows, long long m, int K) {
    counters = 0;
    cand_v = counters + rows * (kHistBins + kHist2Bins + 2);
    sel = cand_v + rows * m;
    win = sel + 2 * rows * m;
    words = win + (K > kMaxBlockK ? 4 * rows * (long long)K : 0);
  }
};

// Row `row`'s part of the scratch (rows of `stride` candidates, m of them
// this row's) and outputs.
__device__ MergeRow merge_args(unsigned* w, const Scratch& sc, long long row, long long rows,
                               long long stride, long long m, int K, float* out_v,
                               int* out_i) {
  MergeRow r;
  unsigned* counters = w + sc.counters;
  r.cand_v = reinterpret_cast<float*>(w + sc.cand_v) + row * stride;
  r.m = m;
  r.hist1 = counters + row * kHistBins;
  r.hist2 = counters + rows * kHistBins + row * kHist2Bins;
  r.sel_count = counters + rows * (kHistBins + kHist2Bins) + row;
  r.ticket = counters + rows * (kHistBins + kHist2Bins + 1) + row;
  r.sel_v = reinterpret_cast<float*>(w + sc.sel) + row * stride;
  r.sel_i = reinterpret_cast<int*>(w + sc.sel) + (rows + row) * stride;
  if (K <= kMaxBlockK) {
    r.out_v = out_v + row * K;
    r.out_i = out_i + row * K;
  } else {
    r.out_v = reinterpret_cast<float*>(w + sc.win) + row * K;
    r.out_i = reinterpret_cast<int*>(w + sc.win) + (rows + row) * K;
  }
  return r;
}

// The merge of the single-slab top-K: block (row, part); every row has m
// candidates.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge(unsigned* scratch, Scratch sc, long long rows, long long m, int K, float* out_v,
           int* out_i, long long index_offset, long long index_stride) {
  merge_row(merge_args(scratch, sc, blockIdx.x, rows, m, m, K, out_v, out_i), blockIdx.y, K,
            index_offset, index_stride);
}

// The merge of the multi-tenant top-K: row s * Bq + q has segment s's
// scores, in rows of `stride` (the longest segment's chunks).
__global__ void __launch_bounds__(kMergeThreads)
multi_topk_merge(unsigned* scratch, Scratch sc, const __grid_constant__ Segments segs,
                 long long rows, int Bq, long long stride, int K, float* out_v, int* out_i,
                 long long index_offset, long long index_stride) {
  const long long n = segs.n[blockIdx.x / Bq];
  merge_row(merge_args(scratch, sc, blockIdx.x, rows, stride, n_chunks_of(n) * kChunk, K,
                       out_v, out_i),
            blockIdx.y, K, index_offset, index_stride);
}

// Writes an ordered entry: the final row relabeled, or a sort buffer.
__device__ inline void put(float* out_v, int* out_i, long long at, float v, int slot,
                           int final_out, long long index_offset, long long index_stride) {
  out_v[at] = v;
  out_i[at] = final_out ? (int)(index_offset + index_stride * (long long)slot) : slot;
}

// K > kMaxBlockK: block (row, tile) sorts entries [tile * kSortTile, ...)
// of the row's K winners by (value desc, slot asc) in shared memory.
__global__ void __launch_bounds__(kSortThreads)
topk_sort_tiles(const float* __restrict__ in_v, const int* __restrict__ in_i, int K,
                float* out_v, int* out_i, int final_out, long long index_offset,
                long long index_stride) {
  extern __shared__ __align__(16) float smem[];
  const long long start = (long long)blockIdx.y * kSortTile;
  const int len = (int)(K - start < kSortTile ? K - start : kSortTile);
  int N = 1;
  while (N < len) N <<= 1;
  float* sv = smem;
  int* si = reinterpret_cast<int*>(sv + N);
  const long long row = (long long)blockIdx.x * K + start;
  for (int t = threadIdx.x; t < N; t += kSortThreads) {
    sv[t] = t < len ? in_v[row + t] : -CUDART_INF_F;
    si[t] = t < len ? in_i[row + t] : INT_MAX;
  }
  repro::bitonic_sort(sv, si, N);
  for (int t = threadIdx.x; t < len; t += kSortThreads)
    put(out_v, out_i, row + t, sv[t], si[t], final_out, index_offset, index_stride);
}

// How many of the sorted entries (v[0], i[0]), ..., (v[len-1], i[len-1])
// rank before (v, slot).
__device__ inline long long ranked_before(const float* v, const int* ids, long long len,
                                          float value, int slot) {
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (repro::ranks_before(v[mid], ids[mid], value, slot))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One merge-path round: each pair of sorted runs of `run` entries becomes
// one run.  An entry's place is its rank in its own run plus the number of
// the other run's entries that rank before it (the order is total: slots
// are unique), so every entry is placed independently.
__global__ void __launch_bounds__(kRoundThreads)
topk_sort_merge(const float* __restrict__ in_v, const int* __restrict__ in_i, int K,
                long long run, float* out_v, int* out_i, int final_out,
                long long index_offset, long long index_stride) {
  const long long idx = (long long)blockIdx.y * kRoundThreads + threadIdx.x;
  if (idx >= K) return;
  const long long row = (long long)blockIdx.x * K;
  const long long a0 = idx / (2 * run) * (2 * run);
  const long long b0 = a0 + run;
  const long long a_len = b0 < K ? run : K - a0;
  const long long b_len = b0 >= K ? 0 : (b0 + run < K ? run : K - b0);
  const float v = in_v[row + idx];
  const int slot = in_i[row + idx];
  long long at;
  if (idx < b0)
    at = idx + ranked_before(in_v + row + b0, in_i + row + b0, b_len, v, slot);
  else
    at = a0 + (idx - b0) + ranked_before(in_v + row + a0, in_i + row + a0, a_len, v, slot);
  put(out_v, out_i, row + at, v, slot, final_out, index_offset, index_stride);
}

int next_pow2(long long x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Query rows a stage-1 or full-mode block scores at once.
int group_size(int Bq) { return Bq >= kMaxGroup ? kMaxGroup : next_pow2(Bq); }


// repro::allow_smem for `Kernel` on `device`, once per size: the attribute
// is a driver call that every top-K call would otherwise pay.  The lock
// makes the check, the call and the record one step, so that the size
// recorded is the size set even when threads launch at once.
template <auto Kernel>
cudaError_t allow_smem_once(size_t bytes, int device) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static size_t allowed[kDevices];
  if (device < 0 || device >= kDevices) return repro::allow_smem(Kernel, bytes);
  std::lock_guard<std::mutex> lock(mu);
  if (bytes <= allowed[device]) return cudaSuccess;
  const cudaError_t err = repro::allow_smem(Kernel, bytes);
  if (err == cudaSuccess) allowed[device] = bytes;
  return err;
}

// Calls f(std::integral_constant<int, G>()) for G in {1, 2, 4, 8, 16}: the
// kernels are instantiated for those query-group sizes.
template <class F>
cudaError_t with_group(int G, F f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return f(std::integral_constant<int, 16>());
  }
}

// For K > kMaxBlockK, after the merge wrote each row's K winners to the
// first sort buffer: sort tiles, then merge runs, the last step writing
// the relabeled rows.  Counts the launches in launched[0] (tiles) and
// launched[1] (rounds).
cudaError_t sort_rows(unsigned* scratch, const Scratch& sc, long long rows, int K,
                      float* out_v, int* out_i, long long index_offset,
                      long long index_stride, cudaStream_t s, int device, int* launched) {
  float* buf_v[2] = {reinterpret_cast<float*>(scratch + sc.win),
                     reinterpret_cast<float*>(scratch + sc.win) + 2 * rows * K};
  int* buf_i[2] = {reinterpret_cast<int*>(scratch + sc.win) + rows * K,
                   reinterpret_cast<int*>(scratch + sc.win) + 3 * rows * K};
  const long long tiles = (K + kSortTile - 1) / kSortTile;
  const size_t smem = (size_t)2 * next_pow2(tiles == 1 ? K : kSortTile) * sizeof(float);
  cudaError_t err = allow_smem_once<topk_sort_tiles>(smem, device);
  if (err != cudaSuccess) return err;
  bool last = tiles == 1;
  topk_sort_tiles<<<dim3((unsigned)rows, (unsigned)tiles), kSortThreads, smem, s>>>(
      buf_v[0], buf_i[0], K, last ? out_v : buf_v[1], last ? out_i : buf_i[1], last,
      index_offset, index_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launched[0] = 1;
  int cur = 1;
  for (long long run = kSortTile; run < K; run *= 2) {
    last = 2 * run >= K;
    topk_sort_merge<<<dim3((unsigned)rows, (unsigned)((K + kRoundThreads - 1) / kRoundThreads)),
                      kRoundThreads, 0, s>>>(
        buf_v[cur], buf_i[cur], K, run, last ? out_v : buf_v[1 - cur],
        last ? out_i : buf_i[1 - cur], last, index_offset, index_stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++launched[1];
    cur = 1 - cur;
  }
  return cudaSuccess;
}

// Shared checks of both top-K entry points: grid limits of the launches.
bool topk_fits(long long rows, long long groups_y, long long m, int K) {
  const long long parts = (m + kPart - 1) / kPart;
  return groups_y <= kMaxGrid && parts <= kMaxGrid && rows <= INT_MAX &&
         m < INT_MAX && (K <= kMaxBlockK || (K + kRoundThreads - 1) / kRoundThreads <= kMaxGrid);
}

}  // namespace

extern "C" {

int dplr_corpus_score_full(const float* Q, const float* aI, const unsigned char* valid,
                           const float* e, const float* PC, const float* aC, long long n,
                           int Bq, int rho, int k, float* out, void* stream, int device) {
  if (n <= 0 || Bq <= 0 || rho * k > kMaxRK) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = group_size(Bq);
  const long long groups = (Bq + G - 1) / G;
  if (groups > kMaxGrid) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)FullSmem(G, rho, k).words * sizeof(float);
  const dim3 grid((unsigned)((n + kFullTile - 1) / kFullTile), (unsigned)groups);
  err = with_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t e2 = allow_smem_once<corpus_score_full<kG>>(smem, device);
    if (e2 != cudaSuccess) return e2;
    corpus_score_full<kG><<<grid, kFullTile, smem, (cudaStream_t)stream>>>(
        Q, aI, valid, e, PC, aC, n, Bq, rho, k, out);
    return cudaGetLastError();
  });
  return (int)err;
}

// Scratch words (4 bytes each) dplr_corpus_topk needs for Bq rows, or
// dplr_corpus_multi_topk for S * Bq rows with n the longest segment.
long long dplr_corpus_topk_scratch(long long n, long long rows, int K) {
  return Scratch(rows, n_chunks_of(n) * kChunk, K).words;
}

// Writes the launches it made to launched[0] (corpus_topk_chunks: 1),
// launched[1] (topk_merge: 1), launched[2] (topk_sort_tiles: 1 for K >
// 4096, else 0) and launched[3] (topk_sort_merge: one per round of runs).
int dplr_corpus_topk(const float* Q, const float* aI, const unsigned char* valid,
                     const float* e, const float* PC, const float* aC, long long n, int Bq,
                     int rho, int k, int K, long long index_offset, long long index_stride,
                     unsigned* scratch, float* out_v, int* out_i, int* launched, void* stream,
                     int device) {
  launched[0] = launched[1] = launched[2] = launched[3] = 0;
  if (n <= 0 || Bq <= 0 || K <= 0 || K > n || n > INT_MAX || rho * k > kMaxRK)
    return (int)cudaErrorInvalidValue;
  const int G = group_size(Bq);
  const long long n_chunks = n_chunks_of(n), m = n_chunks * kChunk, groups = (Bq + G - 1) / G;
  if (!topk_fits(Bq, groups, m, K)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const Scratch sc(Bq, m, K);
  err = cudaMemsetAsync(scratch + sc.counters, 0,
                        (size_t)Bq * (kHistBins + kHist2Bins + 2) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;

  const size_t smem1 = (size_t)ChunkSmem(G, rho, k).words * sizeof(float);
  err = with_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t e2 = allow_smem_once<corpus_topk_chunks<kG>>(smem1, device);
    if (e2 != cudaSuccess) return e2;
    corpus_topk_chunks<kG><<<dim3((unsigned)n_chunks, (unsigned)groups), kTopkThreads, smem1,
                             s>>>(
        Q, aI, valid, e, PC, aC, n, Bq, rho, k, reinterpret_cast<float*>(scratch + sc.cand_v),
        m, scratch + sc.counters);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;

  const size_t smem2 = merge_smem(K);
  err = allow_smem_once<topk_merge>(smem2, device);
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<dim3((unsigned)Bq, (unsigned)((m + kPart - 1) / kPart)), kMergeThreads, smem2,
               s>>>(scratch, sc, Bq, m, K, out_v, out_i, index_offset,
                    index_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[1] = 1;
  if (K <= kMaxBlockK) return (int)cudaSuccess;
  return (int)sort_rows(scratch, sc, Bq, K, out_v, out_i, index_offset, index_stride, s, device,
                        launched + 2);
}

// The masked top-K of S segments in one launch: row s * Bq + q of the
// (S * Bq, K) outputs is query q of segment s against segment s's slab
// (Q[s] (n[s], rho, k), aI[s], valid[s] or nullptr) with eigenvalues
// e[s * rho ...], ids segment-local and relabeled.  Scratch: as many words
// as dplr_corpus_topk_scratch(max n, S * Bq, K) gives.  Writes the launches
// it made to launched[0] (corpus_multi_topk_chunks), launched[1]
// (multi_topk_merge), and launched[2] and [3] as dplr_corpus_topk does.
int dplr_corpus_multi_topk(int S, const float* const* Q, const float* const* aI,
                           const unsigned char* const* valid, const long long* n,
                           const float* e, const float* PC, const float* aC, int Bq,
                           int rho, int k, int K, long long index_offset,
                           long long index_stride, unsigned* scratch, float* out_v,
                           int* out_i, int* launched, void* stream, int device) {
  launched[0] = launched[1] = launched[2] = launched[3] = 0;
  if (S <= 0 || S > kMaxSegments || Bq <= 0 || K <= 0 || rho * k > kMaxRK)
    return (int)cudaErrorInvalidValue;
  Segments segs;
  long long n_max = 0;
  for (int j = 0; j < kMaxSegments; ++j) {
    const bool in = j < S;
    segs.Q[j] = in ? Q[j] : nullptr;
    segs.aI[j] = in ? aI[j] : nullptr;
    segs.valid[j] = in && valid != nullptr ? valid[j] : nullptr;
    segs.n[j] = in ? n[j] : 0;
    if (in && (n[j] < K || n[j] > INT_MAX)) return (int)cudaErrorInvalidValue;
    if (in && n[j] > n_max) n_max = n[j];
  }
  const int G = group_size(Bq);
  const long long rows = (long long)S * Bq, groups = (Bq + G - 1) / G;
  const long long n_chunks = n_chunks_of(n_max), m = n_chunks * kChunk;
  if (!topk_fits(rows, S * groups, m, K)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const Scratch sc(rows, m, K);
  err = cudaMemsetAsync(scratch + sc.counters, 0,
                        (size_t)rows * (kHistBins + kHist2Bins + 2) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;

  const size_t smem1 = (size_t)ChunkSmem(G, rho, k).words * sizeof(float);
  err = with_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaError_t e2 = allow_smem_once<corpus_multi_topk_chunks<kG>>(smem1, device);
    if (e2 != cudaSuccess) return e2;
    corpus_multi_topk_chunks<kG><<<dim3((unsigned)n_chunks, (unsigned)(S * groups)),
                                   kTopkThreads, smem1, s>>>(
        segs, e, PC, aC, Bq, rho, k, reinterpret_cast<float*>(scratch + sc.cand_v), m,
        scratch + sc.counters);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;

  const size_t smem2 = merge_smem(K);
  err = allow_smem_once<multi_topk_merge>(smem2, device);
  if (err != cudaSuccess) return (int)err;
  multi_topk_merge<<<dim3((unsigned)rows, (unsigned)((m + kPart - 1) / kPart)), kMergeThreads,
                     smem2, s>>>(scratch, sc, segs, rows, Bq, m, K, out_v, out_i,
                                 index_offset, index_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[1] = 1;
  if (K <= kMaxBlockK) return (int)cudaSuccess;
  return (int)sort_rows(scratch, sc, rows, K, out_v, out_i, index_offset, index_stride, s, device,
                        launched + 2);
}

}  // extern "C"
