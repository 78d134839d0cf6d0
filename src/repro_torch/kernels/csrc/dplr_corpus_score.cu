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
// is the floor; the full mode adds Bq * n * 4 bytes of output.  A bf16 slab
// (Q_I and a_I in bf16, the serving checkpoint's type) halves it: 96 + 2 + 1
// bytes an item.  What keeps a kernel off that floor is the work per byte
// it adds on the way: shared-memory loads in the scorer, and in the top-K
// modes the selection.
//
// Types: every kernel that reads the slab is instantiated for a float and a
// bf16 slab (Q_I and a_I one type, read as stored; e, P_C and a_C are f32,
// upcast by the caller, as they do not grow with n) and for the two
// accumulation modes of the reference's acc_dtype (common.cuh slot_score).
// A bf16 slab with f32 accumulation scores bitwise as its upcast f32 copy:
// the upcast is exact and the arithmetic after it is the same.  Scores are
// f32 in every instantiation, so the merge and sort kernels are shared.
//
// What the design does about it:
//  * One scorer (common.cuh slot_score<G>) for every mode: a thread scores
//    its slot against G <= 16 queries at once, reading the slot's row once
//    and the queries' P_C transposed, 4 queries to a 16-byte broadcast
//    load; per query the operations are those of the plain direct form, in
//    one order, so the top-K modes return kernel 1's scores bitwise (kernel
//    1 scores two slots at once through slot_scores_wide, the same
//    operations a slot).  All arithmetic is f32 in the direct form, not the
//    GEMM expansion ||P_C||^2 + 2<P_C, Q_I> + ||Q_I||^2, whose rounding
//    differs.
//  * Top-K modes: Q_I is copied tile by tile into shared memory as stored (common.cuh
//    stage_rows, 16 bytes a load where the rows allow), with an odd row
//    stride in words so that each thread then reads its own slot's row
//    without bank conflicts, upcasting a bf16 entry as it reads it.
//  * Full mode (kernel 1): the bytes (the slab once, the (Bq, n) output)
//    and the scorer's instructions (at Bq = 16 an add and an FMA per query
//    and element) take about as long each, so the copies have to stream
//    while the CUDA cores score.  One wave of persistent blocks, each 4
//    scoring warps and one producer warp, two blocks an SM (f32: 110 KB of
//    shared memory each).  A block claims runs of block_n slots (256 by
//    default) of one query group in turn, and loads that group's P_C, e and
//    a_C once, not once a tile.  The producer reads a tile's valid bytes a
//    tile ahead and, for each 32 rows with a live slot, issues one TMA box
//    load of a rank-2 tensor map over Q_I (a tile with no live slot copies
//    nothing: the dead tail costs its mask bytes) into a ring of 2 stages
//    of 256 rows, completing on the stage's mbarrier.  The box is wider than
//    rho k: its columns past the row load as zeros, so the rows land an odd
//    number of 16-byte pieces apart (common.cuh wide_row_words: 208 bytes in
//    f32, 112 in bf16 at rho k = 48), where 16-byte loads meet no bank
//    conflict.  Rows that are no whole number of 16-byte pieces a k-row
//    (k % 4 in f32, k % 8 in bf16), or a slab not 16-byte aligned, take the
//    same kernel's element copies of the live rows (4-byte cp.async in f32,
//    loads and stores in bf16); the former into row_words rows read an
//    element at a time (slot_score).  A scoring thread scores rows t and t
//    + 128 of a stage at once (slot_scores_wide: each P_C load serves both
//    slots, a slot's row read 16 bytes at a time; per slot slot_score's
//    operations, so the same bits), reading a_I and valid a tile ahead; its
//    warp frees the stage, then writes out[q, i] with streaming stores
//    (st.global.cs), consecutive lanes on consecutive i.  No block-wide
//    barrier after the set-up.  What chose this, on an NVIDIA H100 80GB
//    HBM3 at 700 W (scripts/sweep_full_kernel.py, scripts/ab_corpus.py):
//    one bulk copy a row (192 bytes) was bound by the copies' rate, ~1.6
//    TB/s at Bq = 1; one thread a slot, 8 scoring warps a block, 4 stages,
//    3 or 4 slots a thread (212-255 registers) or 3 blocks an SM were each
//    as fast or slower; the scoring alone (no copies) takes 0.086 ms at Bq =
//    16 at 1980 MHz, about 2.5 instructions a cycle, the loads and stores
//    alone 0.096 ms in f32 (the card's read rate, as torch.sum's, ~2.8
//    TB/s), 0.067 in bf16 (PERF.md).
//  * Top-K modes: a CUDA grid has no order, so the TPU kernel's running
//    top-K, carried across a sequential grid, does not carry over; a full
//    sort of every chunk (the previous design) cost ~59x the bound; a
//    running threshold costs more when later slots score higher; and an
//    exact select of each (row, chunk) in shared memory, tried first, cost
//    as much as the scoring at Bq = 16.  Instead, an exact radix select
//    over the whole row, in two launches (K <= 4096; sorts follow past it):
//    - Stage 1, block (chunk of 512 slots, group of up to 16 query rows;
//      256 threads, one slot each a tile):
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
//
// Geometry.  The numbers above are defaults, not constants: the full
// mode's run, the query group G (both modes), and in the top-K
// modes the chunk, stage 1's threads and the merge's part are launch
// parameters of the C entry points (the port's kernels/blocks.py names the
// defaults and resolves a call's geometry; kernels/autotune.py sweeps it).
// Only G sizes a register array, so only G is a template parameter (60
// instantiations: G in {1, 2, 4, 8, 16} x slab type x accumulation mode x
// three kernels); the chunk and the threads set loop bounds and the
// dynamic shared memory.  Stage 1's body is compiled twice: once with the
// default chunk and threads as constants, which a launch at the default
// takes (the general body, at the default's geometry, took 7-14% longer
// at Bq = 16 on an H100), and once with them read at run time.  Per query
// a slot's score is the same operations in the same order whatever the
// geometry, and the selection is a function of the keys alone, so every
// geometry returns the same bits.
#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

using repro::kMaxRK;
using repro::kNegInf;

constexpr int kFullThreads = 128;    // full-mode scoring threads (4 warps), and one
constexpr int kFullWarps = kFullThreads / 32;  // producer warp besides
constexpr int kFullBlock = kFullThreads + 32;
constexpr int kFullSlots = 2;        // slots a scoring thread scores at once
constexpr int kFullTile = kFullThreads * kFullSlots;  // most rows a stage holds
constexpr int kFullBox = 32;         // rows a copy moves (a stage: whole boxes)
constexpr int kFullBlockN = kFullTile;  // default run: slots a block claims at a time
constexpr int kFullStages = 2;       // stages of the ring
constexpr int kFullBlocks = 2;       // blocks an SM: the launch bound, and so
constexpr int kFullSmem = 233472 / kFullBlocks - 1024;  // the shared memory a block
constexpr int kTopkThreads = 256;    // default and most stage-1 threads (its launch
                                     // bound): one slot each a tile
constexpr int kChunk = 512;          // default slots a stage-1 block scores and selects from
// Stage-1 blocks of kTopkThreads an SM the launch bounds ask for at a query
// group of G: three up to 4 rows (80 registers a thread, as the bodies had
// before the geometry was a launch parameter; ptxas gave the multi-tenant
// kernel 105 without it, two blocks an SM, 11% slower at 16 x 65,536),
// two past that.
template <int G>
constexpr int kStage1Blocks = G <= 4 ? 3 : 2;
constexpr int kMaxChunk = 32768;     // the most: a chunk's bin counts are 16-bit
constexpr int kMaxGroup = 16;        // query rows a block scores at once, at most
constexpr int kHistBits = 11;        // key bits of the merge's first digit
constexpr int kHistBins = 1 << kHistBits;
constexpr int kHist2Bits = 12;       // and of its second, the bits below the first
constexpr int kHist2Bins = 1 << kHist2Bits;
constexpr int kPackedStride = kHistBins / 2 + 1;  // a row's first-digit bins, two a word
constexpr int kMergeThreads = 1024;
constexpr int kPart = 16384;         // default candidates one merge block filters
constexpr int kMaxBlockK = 4096;     // largest K the merge's last block sorts
constexpr int kSortTile = 16384;     // entries one topk_sort_tiles block sorts
constexpr int kSortThreads = 1024;
constexpr int kRoundThreads = 256;   // topk_sort_merge threads: one entry each
constexpr int kMaxSegments = 64;     // segments of one multi-tenant launch
constexpr int kMaxGrid = 65535;      // grid.y and grid.z limit

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline long long n_chunks_of(long long n, int chunk) {
  return (n + chunk - 1) / chunk;
}

// Shared-memory layout (in words) of a full-mode block for G queries: the
// ring's mbarriers (full[s], then empty[s]: 2 kFullStages, 8 bytes each), P_C
// transposed (16-byte aligned), e, a_C, then kFullStages stages of `tile`
// rows of `rw` words each (rw is repro::wide_row_words of the slab's type
// where rows are read 16 bytes at a time, else row_words), from the first
// 128-byte boundary at or past word `stages` (a TMA box's destination; 32
// words of slack hold the padding).
struct FullSmem {
  int pcT, es, ac, stages, words;
  __host__ __device__ FullSmem(int G, int rho, int k, int rw, int tile) {
    pcT = 4 * kFullStages;
    es = pcT + rho * k * G;
    ac = es + round4(rho);
    stages = round4(ac + round4(G));
    words = stages + 32 + kFullStages * tile * rw;
  }
};

// Whether a slab of T at k is staged wide: each k-row (so each rho k row)
// a whole number of 16-byte pieces, which the scorer reads 16 bytes at a
// time.  Else its rows take row_words, read an element at a time.
template <class T>
__host__ __device__ inline bool full_wide(int k) {
  return k * (int)sizeof(T) % 16 == 0;
}

template <class T>
__host__ __device__ inline int full_row_words(int rho, int k) {
  return full_wide<T>(k) ? repro::wide_row_words<T>(rho * k) : repro::row_words<T>(rho * k);
}

// Rows a stage holds for a run of `run` slots, whole boxes of kFullBox:
// kFullTile, fewer where the run is shorter or two stages of rows of `rw`
// words would pass kFullSmem.
inline int full_tile(int G, int rho, int k, int rw, long long run) {
  const long long fit = ((long long)kFullSmem / 4 - FullSmem(G, rho, k, rw, 0).words) /
                        ((long long)kFullStages * rw) / kFullBox * kFullBox;
  long long t = kFullTile;
  const long long need = (run + kFullBox - 1) / kFullBox * kFullBox;
  if (need < t) t = need;
  if (fit < t) t = fit;
  return t < kFullBox ? kFullBox : (int)t;
}

// The tiles a full-mode block walks.  Work item w is run w % runs (slots
// [run * (w % runs), ...), at most `run` of them) of query group w / runs;
// block b takes items b, b + gridDim.x, ..., each in tiles of `tile` rows.
struct FullWalk {
  long long n, run, runs, items;
  int tile;
};

struct FullCursor {
  long long w, row0, end;     // the item, the tile's first slot, the run's end
  int group;
  bool live;                  // false past the block's last item
  __device__ void begin(long long item, const FullWalk& p) {
    w = item;
    live = w < p.items;
    if (!live) return;
    group = (int)(w / p.runs);
    row0 = (w % p.runs) * p.run;
    end = row0 + p.run < p.n ? row0 + p.run : p.n;
  }
  __device__ void next(const FullWalk& p) {
    row0 += p.tile;
    if (row0 >= end) begin(w + gridDim.x, p);
  }
  __device__ int rows(const FullWalk& p) const {
    return (int)(end - row0 < p.tile ? end - row0 : p.tile);
  }
};

// Kernel 1, persistent: one wave of blocks of kFullThreads scoring threads
// and one producer warp.  The producer streams each tile's Q_I rows into a
// ring of kFullStages stages (where `bulk`, one TMA box of `map` for each
// kFullBox rows with a live slot, its rows padded to the stage's stride by
// the box's zeros past rho k; else the live rows element by element: 4-byte
// cp.async copies for f32, loads and stores for bf16), completing on the
// stage's "full" mbarrier; a tile with no live slot copies nothing.
// Scoring thread t scores the tile's rows t and t + kFullThreads against
// the block's query group (P_C transposed in shared memory, loaded again
// only when the group changes), through slot_scores_wide where rows are
// wide, else slot_score; its warp then arrives on the stage's "empty"
// mbarrier, which the producer waits for before it refills the stage, and
// writes out[q, i] with streaming stores (-1e30 for a dead slot).  a_I and
// valid of a thread's slots are loaded a tile ahead.
template <int G, class T, int Acc>
__global__ void __launch_bounds__(kFullBlock, kFullBlocks)
corpus_score_full(const T* __restrict__ Q, const T* __restrict__ aI,
                  const unsigned char* __restrict__ valid, const float* __restrict__ e,
                  const float* __restrict__ PC, const float* __restrict__ aC, long long n,
                  int Bq, int rho, int k, long long run, int tile, int bulk,
                  const __grid_constant__ CUtensorMap map, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // kFullStages: the rows landed
  uint64_t* empty = full + kFullStages;                 // kFullStages: the slots scored
  const int RK = rho * k;
  const bool wide = full_wide<T>(k);
  const int rw = full_row_words<T>(rho, k);
  const int re = rw * 4 / (int)sizeof(T);               // a staged row's stride in elements
  const FullSmem lay(G, rho, k, rw, tile);
  float* pcT = smem + lay.pcT;
  float* es = smem + lay.es;
  float* ac = smem + lay.ac;
  const uint32_t at = hopper::smem_addr(smem + lay.stages);
  T* stages = reinterpret_cast<T*>(reinterpret_cast<char*>(smem + lay.stages) +
                                   ((128 - at % 128) % 128));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long runs = (n + run - 1) / run;
  const FullWalk p{n, run, runs, runs * ((Bq + G - 1) / G), tile};

  const auto load_queries = [&](int group) {
    const int q0 = group * G, nq = min(G, Bq - q0);
    for (int t = threadIdx.x; t < RK * G; t += kFullThreads) {
      const int c = t / G, j = t % G;
      pcT[t] = j < nq ? PC[(long long)(q0 + j) * RK + c] : 0.f;
    }
    for (int t = threadIdx.x; t < rho; t += kFullThreads) es[t] = e[t];
    for (int t = threadIdx.x; t < G; t += kFullThreads) ac[t] = t < nq ? aC[q0 + t] : 0.f;
  };
  FullCursor cur;
  cur.begin(blockIdx.x, p);
  if (warp == kFullWarps) {
    if (lane == 0) {
      for (int s = 0; s < kFullStages; ++s) {
        hopper::mbar_init(hopper::smem_addr(&full[s]), bulk ? 1 : 32);
        hopper::mbar_init(hopper::smem_addr(&empty[s]), kFullWarps);
      }
      hopper::mbar_init_fence();
    }
  } else {
    load_queries(cur.group);
  }
  __syncthreads();  // the barriers and the first group's queries are ready

  if (warp == kFullWarps) {
    // The producer.  Lane l reads the liveness of rows l, l + 32, ... of a
    // tile (a tile ahead), then copies the live ones.
    constexpr int kPer = kFullTile / 32;
    static_assert(kFullBox == 32, "a box is the 32 rows one ballot covers");
    const uint32_t box_bytes = (uint32_t)(kFullBox * rw * 4);
    if (bulk) hopper::prefetch_tensor_map(&map);
    const auto load_valid = [&](const FullCursor& c, unsigned char* v) {
      const int rows = c.rows(p);
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        const int r = 32 * b + lane;
        v[b] = r >= rows ? 0 : valid == nullptr ? 1 : __ldg(valid + c.row0 + r);
      }
    };
    unsigned char v[kPer];
    load_valid(cur, v);
    for (long long u = 0; cur.live; ++u) {
      const int s = (int)(u % kFullStages);
      if (u >= kFullStages)
        hopper::mbar_wait(hopper::smem_addr(&empty[s]), (uint32_t)(u / kFullStages - 1) & 1);
      FullCursor nxt = cur;
      nxt.next(p);
      unsigned char vn[kPer] = {};
      if (nxt.live) load_valid(nxt, vn);
      const uint32_t bar = hopper::smem_addr(&full[s]);
      T* dst = stages + (long long)s * tile * re;
      const T* src = Q + cur.row0 * RK;
      unsigned live[kPer];
      uint32_t boxes = 0;
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        live[b] = __ballot_sync(0xffffffffu, v[b] != 0);
        boxes += live[b] != 0;
      }
      if (bulk) {
        if (lane == 0) {
          hopper::mbar_expect_tx(bar, boxes * box_bytes);
#pragma unroll
          for (int b = 0; b < kPer; ++b)
            if (live[b])
              hopper::tma_load_2d(hopper::smem_addr(dst + kFullBox * b * re), &map, bar, 0,
                                  (int)(cur.row0 + kFullBox * b));
        }
      } else {
        // each live row's elements by the whole warp; the lane arrives once
        // its copies have landed (cp.async) or its stores are done
#pragma unroll
        for (int b = 0; b < kPer; ++b) {
          for (unsigned m = live[b]; m; m &= m - 1) {
            const int r = 32 * b + __ffs(m) - 1;
            for (int c = lane; c < RK; c += 32) {
              if constexpr (sizeof(T) == 4)
                hopper::cp_async_4(hopper::smem_addr(dst + r * re + c),
                                   src + (long long)r * RK + c, 4u);
              else
                dst[r * re + c] = src[(long long)r * RK + c];
            }
          }
        }
        if constexpr (sizeof(T) == 4)
          hopper::cp_async_arrive(bar);
        else
          hopper::mbar_arrive(bar);
      }
      cur = nxt;
#pragma unroll
      for (int b = 0; b < kPer; ++b) v[b] = vn[b];
    }
    return;
  }

  // The scoring threads: rows t and t + kFullThreads of each tile.  A slot's
  // a_I and valid byte are loaded a tile ahead and read a tile later.
  const int t = threadIdx.x;
  const auto load_slots = [&](const FullCursor& c, T* a, unsigned char* v) {
    const int rows = c.rows(p);
#pragma unroll
    for (int h = 0; h < kFullSlots; ++h) {
      const int r = t + h * kFullThreads;
      const long long i = c.row0 + r;
      a[h] = r < rows ? __ldg(aI + i) : T{};
      v[h] = r >= rows ? 0 : valid == nullptr ? 1 : __ldg(valid + i);
    }
  };
  T a[kFullSlots];
  unsigned char v[kFullSlots];
  load_slots(cur, a, v);
  int group = cur.group;
  for (long long u = 0; cur.live; ++u) {
    FullCursor nxt = cur;
    nxt.next(p);
    T an[kFullSlots] = {};
    unsigned char vn[kFullSlots] = {};
    if (nxt.live) load_slots(nxt, an, vn);
    if (cur.group != group) {      // the scoring warps reload the queries
      asm volatile("bar.sync 1, %0;\n" ::"n"(kFullThreads) : "memory");
      group = cur.group;
      load_queries(group);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kFullThreads) : "memory");
    }
    const int s = (int)(u % kFullStages);
    hopper::mbar_wait(hopper::smem_addr(&full[s]), (uint32_t)(u / kFullStages) & 1);
    const int rows = cur.rows(p);
    const int q0 = group * G, nq = min(G, Bq - q0);
    bool in[kFullSlots], live[kFullSlots];
    float ai[kFullSlots];
    const T* q[kFullSlots];
    const T* stage = stages + (long long)s * tile * re;
#pragma unroll
    for (int h = 0; h < kFullSlots; ++h) {
      const int r = t + h * kFullThreads;
      in[h] = r < rows;
      live[h] = v[h] != 0;
      ai[h] = repro::to_f32(a[h]);
      q[h] = stage + (in[h] ? r : 0) * re;   // a row of the stage, read or not
    }
    float sc[kFullSlots][G];
    bool any = false;
#pragma unroll
    for (int h = 0; h < kFullSlots; ++h) any = any || live[h];
    if (__any_sync(0xffffffffu, any)) {
      if (wide) {
        repro::slot_scores_wide<G, T, Acc, kFullSlots>(ai, q, pcT, ac, es, rho, k, sc);
      } else {
#pragma unroll
        for (int h = 0; h < kFullSlots; ++h)
          repro::slot_score<G, T, Acc>(ai[h], q[h], pcT, ac, es, rho, k, sc[h]);
      }
    }
    __syncwarp();     // the warp has read the stage: free it before the stores
    if (lane == 0) hopper::mbar_arrive(hopper::smem_addr(&empty[s]));
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= nq) break;
      float* o = out + (long long)(q0 + j) * n + cur.row0 + t;
#pragma unroll
      for (int h = 0; h < kFullSlots; ++h)
        if (in[h]) __stcs(o + h * kFullThreads, live[h] ? sc[h][j] : kNegInf);
    }
    cur = nxt;
#pragma unroll
    for (int h = 0; h < kFullSlots; ++h) {
      a[h] = an[h];
      v[h] = vn[h];
    }
  }
}

// Shared-memory layout (in words) of a stage-1 block of `threads` threads
// for G query rows and a chunk of `chunk` slots: P_C transposed (16-byte
// aligned), e, a_C, the G rows' chunk scores (odd row stride chunk + 1),
// and a work area: the Q_I tile while scoring (`threads` rows of `rkw`
// words), then the rows' first-digit bins, two 16-bit counts a word (odd
// row stride).
struct ChunkSmem {
  int pcT, es, ac, sc, work, words;
  __host__ __device__ ChunkSmem(int G, int rho, int k, int rkw, int chunk, int threads) {
    const int RK = rho * k;
    pcT = 0;
    es = pcT + RK * G;
    ac = es + round4(rho);
    sc = ac + round4(G);
    work = sc + G * (chunk + 1);
    words = work + imax(threads * rkw, G * kPackedStride);
  }
};

// Stage 1 of the top-K modes, one block of blockDim.x threads: score slots
// [chunk * len, (chunk + 1) * len) of one slab against nq <= G query rows
// (P_C rows `PC`, a_C `aC`), write the scores to cand_v[j * stride + chunk
// * len ...] (a slot's candidate is at its own position) and add their
// first digits (top kHistBits bits of the order key) to the rows' bins
// hist1[j * kHistBins ...].  Slots past the slab's end score -inf, below
// every slot.  Shared by the single-slab and the multi-tenant kernels, so
// that both score identically.
//
// chunk_scores_as: the body, with the chunk `len` and the block's threads
// compile-time constants kLen and kThreads where those are not 0.  Each
// thread reads its slot's a_I and liveness before the tile's barrier, so
// that their latency overlaps the staging of Q_I.
template <int G, class T, int Acc, int kLen, int kThreads>
__device__ __forceinline__ void chunk_scores_as(
    const T* __restrict__ Q, const T* __restrict__ aI, const unsigned char* __restrict__ valid,
    long long n, const float* __restrict__ e, const float* __restrict__ PC,
    const float* __restrict__ aC, int nq, int rho, int k, long long chunk, int len_arg,
    float* __restrict__ cand_v, long long stride, unsigned* __restrict__ hist1) {
  extern __shared__ __align__(16) float smem[];
  const int RK = rho * k;
  const int RKP = repro::row_stride<T>(RK);
  const int len = kLen ? kLen : len_arg;
  const int threads = kThreads ? kThreads : blockDim.x;
  const int sstride = len + 1;      // a row of chunk scores in shared memory
  const ChunkSmem lay(G, rho, k, repro::row_words<T>(RK), len, threads);
  float* pcT = smem + lay.pcT;
  float* es = smem + lay.es;
  float* ac = smem + lay.ac;
  float* sc = smem + lay.sc;
  float* work = smem + lay.work;
  T* tile = reinterpret_cast<T*>(work);
  const int tid = threadIdx.x;

  const long long base = chunk * len;
  for (int t = tid; t < RK * G; t += threads) {
    const int c = t / G, j = t % G;
    pcT[t] = j < nq ? PC[(long long)j * RK + c] : 0.f;
  }
  for (int t = tid; t < rho; t += threads) es[t] = e[t];
  for (int t = tid; t < G; t += threads) ac[t] = t < nq ? aC[t] : 0.f;
  for (int off = 0; off < len; off += threads) {
    const long long i = base + off + tid;
    const bool mine = off + tid < len;
    const bool live = mine && i < n && (valid == nullptr || valid[i] != 0);
    const float ai = live ? repro::to_f32(aI[i]) : 0.f;
    __syncthreads();                // the previous tile is consumed
    repro::stage_rows(Q, base + off, len - off < threads ? len - off : threads, n, RK, RKP,
                      tile);
    __syncthreads();
    if (!mine) continue;
    float s[G];
    if (live) {
      repro::slot_score<G, T, Acc>(ai, tile + tid * RKP, pcT, ac, es, rho, k, s);
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j) s[j] = i < n ? kNegInf : -CUDART_INF_F;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      sc[j * sstride + off + tid] = s[j];
      if (j < nq) cand_v[(long long)j * stride + base + off + tid] = s[j];
    }
  }

  // the rows' first digits, neighbouring threads on different rows (so on
  // different bins of a dense region)
  unsigned* bins = reinterpret_cast<unsigned*>(work);
  __syncthreads();                  // the tile is consumed
  for (int t = tid; t < nq * kPackedStride; t += threads) bins[t] = 0;
  __syncthreads();
  for (int t = tid; t < nq * len; t += threads) {
    const int j = t % nq, i = t / nq;
    const unsigned b = repro::order_key(sc[j * sstride + i]) >> (32 - kHistBits);
    atomicAdd(&bins[j * kPackedStride + (b >> 1)], b & 1u ? 0x10000u : 1u);
  }
  __syncthreads();
  for (int t = tid; t < nq * (kHistBins / 2); t += threads) {
    const int j = t / (kHistBins / 2), w = t % (kHistBins / 2);
    const unsigned c = bins[j * kPackedStride + w];
    unsigned* h = hist1 + (long long)j * kHistBins + 2 * w;
    if (c & 0xFFFFu) atomicAdd(h, c & 0xFFFFu);
    if (c >> 16) atomicAdd(h + 1, c >> 16);
  }
}

// The default geometry takes the body compiled for it (file header).
template <int G, class T, int Acc>
__device__ void chunk_scores(const T* __restrict__ Q, const T* __restrict__ aI,
                             const unsigned char* __restrict__ valid, long long n,
                             const float* __restrict__ e, const float* __restrict__ PC,
                             const float* __restrict__ aC, int nq, int rho, int k,
                             long long chunk, int len, float* __restrict__ cand_v,
                             long long stride, unsigned* __restrict__ hist1) {
  if (len == kChunk && blockDim.x == kTopkThreads)
    chunk_scores_as<G, T, Acc, kChunk, kTopkThreads>(Q, aI, valid, n, e, PC, aC, nq, rho, k,
                                                     chunk, len, cand_v, stride, hist1);
  else
    chunk_scores_as<G, T, Acc, 0, 0>(Q, aI, valid, n, e, PC, aC, nq, rho, k, chunk, len, cand_v,
                                     stride, hist1);
}

// Stage 1 of the single-slab top-K: block (chunk of `len` slots, group of G
// rows) of up to kTopkThreads threads.  (A bound of 512 threads let ptxas
// cap some instantiations at 64 registers, and they spilled.)
template <int G, class T, int Acc>
__global__ void __launch_bounds__(kTopkThreads, kStage1Blocks<G>)
corpus_topk_chunks(const T* __restrict__ Q, const T* __restrict__ aI,
                   const unsigned char* __restrict__ valid, const float* __restrict__ e,
                   const float* __restrict__ PC, const float* __restrict__ aC, long long n,
                   int Bq, int rho, int k, int len, float* cand_v, long long stride,
                   unsigned* hist1) {
  const int q0 = blockIdx.y * G;
  const long long RK = (long long)rho * k;
  chunk_scores<G, T, Acc>(Q, aI, valid, n, e, PC + q0 * RK, aC + q0, min(G, Bq - q0), rho, k,
                          blockIdx.x, len, cand_v + q0 * stride, stride,
                          hist1 + (long long)q0 * kHistBins);
}

// The S slabs of a multi-tenant launch, by value in the kernel's parameters
// (S <= kMaxSegments; 2 KB of the 4 KB a launch may pass).  Q and aI are of
// the launch's one slab type, which the kernel's T names.
struct Segments {
  const void* Q[kMaxSegments];
  const void* aI[kMaxSegments];
  const unsigned char* valid[kMaxSegments];   // nullptr: every slot live
  long long n[kMaxSegments];
};

// Stage 1 of the multi-tenant top-K: block (chunk, segment s and group of
// G of its Bq rows), rows s * Bq + q.  A chunk past the end of a shorter
// segment has nothing to do (the merge reads that segment's chunks alone).
template <int G, class T, int Acc>
__global__ void __launch_bounds__(kTopkThreads, kStage1Blocks<G>)
corpus_multi_topk_chunks(const __grid_constant__ Segments segs, const float* __restrict__ e,
                         const float* __restrict__ PC, const float* __restrict__ aC, int Bq,
                         int rho, int k, int len, float* cand_v, long long stride,
                         unsigned* hist1) {
  const int groups = (Bq + G - 1) / G;
  const int s = blockIdx.y / groups;
  const int q0 = (blockIdx.y % groups) * G;
  const long long chunk = blockIdx.x;
  const long long n = segs.n[s];
  if (chunk * len >= n) return;
  const long long row0 = (long long)s * Bq + q0;
  const long long RK = (long long)rho * k;
  chunk_scores<G, T, Acc>(static_cast<const T*>(segs.Q[s]), static_cast<const T*>(segs.aI[s]),
                          segs.valid[s], n, e + (long long)s * rho, PC + row0 * RK, aC + row0,
                          min(G, Bq - q0), rho, k, chunk, len, cand_v + row0 * stride, stride,
                          hist1 + row0 * kHistBins);
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

// Merge block (row, part of `part_len` scores): keep the part's scores whose first digit is at
// or above b1, the bin of the row's K-th largest score, and count the second
// digits of those on b1.  The row's last block then finds b2, the second
// digit's bin of the K-th, keeps the kept scores at or above (b1, b2), picks
// the K winners among those exactly, and, for K <= kMaxBlockK, sorts them
// and writes the row relabeled (else writes them for the sort kernels).
__device__ void merge_row(const MergeRow& r, int part, int part_len, int K,
                          long long index_offset, long long index_stride) {
  extern __shared__ __align__(16) float smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);    // kSelectBins
  unsigned* h2 = hist + repro::kSelectBins;               // kHist2Bins
  unsigned* cross = h2 + kHist2Bins;                      // 4
  unsigned* warp_sums = cross + 4;                        // kMergeThreads / 32
  unsigned* warp_base = warp_sums + kMergeThreads / 32;   // kMergeThreads / 32
  unsigned* misc = warp_base + kMergeThreads / 32;        // 4
  float* sv = smem + kMergeHead;                          // 2 next_pow2(K) when sorting
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int parts = (int)((r.m + part_len - 1) / part_len);
  if (part >= parts) return;

  const uint2 c1 = crossing<kHistBins>(r.hist1, (unsigned)K, cross, warp_sums);
  const unsigned b1 = c1.x;

  // this part: count the kept scores and the second digits of those on b1,
  // then write the kept ones, each warp's in one range at offsets reserved
  // with one atomic per block, so that a warp's stores are contiguous (a
  // part with none skips the second read)
  for (int b = tid; b < kHist2Bins; b += kMergeThreads) h2[b] = 0;
  __syncthreads();
  const long long lo = (long long)part * part_len;
  const long long hi = lo + part_len < r.m ? lo + part_len : r.m;
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
topk_merge(unsigned* scratch, Scratch sc, long long rows, long long m, int part_len, int K,
           float* out_v, int* out_i, long long index_offset, long long index_stride) {
  merge_row(merge_args(scratch, sc, blockIdx.x, rows, m, m, K, out_v, out_i), blockIdx.y,
            part_len, K, index_offset, index_stride);
}

// The merge of the multi-tenant top-K: row s * Bq + q has segment s's
// scores, in rows of `stride` (the longest segment's chunks of `len`).
__global__ void __launch_bounds__(kMergeThreads)
multi_topk_merge(unsigned* scratch, Scratch sc, const __grid_constant__ Segments segs,
                 long long rows, int Bq, long long stride, int len, int part_len, int K,
                 float* out_v, int* out_i, long long index_offset, long long index_stride) {
  const long long n = segs.n[blockIdx.x / Bq];
  merge_row(merge_args(scratch, sc, blockIdx.x, rows, stride, n_chunks_of(n, len) * len, K,
                       out_v, out_i),
            blockIdx.y, part_len, K, index_offset, index_stride);
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

// The default query group: the rows a stage-1 or full-mode block scores at
// once (kernels/blocks.py group_size).
int group_size(int Bq) { return Bq >= kMaxGroup ? kMaxGroup : next_pow2(Bq); }

// A launch's geometry: the query group G, and in the top-K modes stage 1's
// threads, its chunk of slots and the merge's part (kernels/blocks.py Tile).
struct Geometry {
  int group, threads, chunk, part;
};

bool group_ok(int G) { return G == 1 || G == 2 || G == 4 || G == 8 || G == 16; }

bool topk_geometry_ok(const Geometry& g) {
  return group_ok(g.group) && g.threads >= 32 && g.threads <= kTopkThreads &&
         g.threads % 32 == 0 && g.chunk >= 1 && g.chunk <= kMaxChunk && g.part >= 1;
}

// Dynamic shared memory of stage 1 (for the slab type `dtype`), or of the
// full mode (topk = false; g.chunk: its run).
size_t stage_smem(bool topk, const Geometry& g, int rho, int k, int dtype) {
  const bool bf16 = dtype == repro::kBF16;
  if (!topk) {
    const int rw = bf16 ? full_row_words<__nv_bfloat16>(rho, k) : full_row_words<float>(rho, k);
    const int tile = full_tile(g.group, rho, k, rw, g.chunk);
    return (size_t)FullSmem(g.group, rho, k, rw, tile).words * sizeof(float);
  }
  const int rkw = bf16 ? repro::row_words<__nv_bfloat16>(rho * k)
                       : repro::row_words<float>(rho * k);
  return (size_t)ChunkSmem(g.group, rho, k, rkw, g.chunk, g.threads).words * sizeof(float);
}

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

// The tensor map of kernel 1's copies over a slab of T at `base` (n rows of
// rho k), with boxes of box0 x kFullBox: encoded once per (base, n, rho k,
// box0) and kept, since the encode, a driver call, would otherwise cost
// every call host time (a served slab keeps its address).  The map holds
// nothing but those values, so a slab freed and made again at the same
// address and shape has the same map.
template <class T>
cudaError_t slab_map(const void* base, long long n, int rk, int box0, CUtensorMap* map) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, long long, int, int>, CUtensorMap> known;
  const auto key = std::make_tuple(base, n, rk, box0);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const cudaError_t err = hopper::encode_2d(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      base, (uint64_t)rk, (uint64_t)n, (uint64_t)rk * sizeof(T), (uint32_t)box0,
      (uint32_t)kFullBox);
  if (err != cudaSuccess) return err;
  if (known.size() >= 256) known.clear();
  known.emplace(key, *map);
  return cudaSuccess;
}

template <class T>
struct TypeTag {
  using type = T;
};

// Calls f(std::integral_constant<int, G>(), TypeTag<T>(),
// std::integral_constant<int, Acc>()) for G in {1, 2, 4, 8, 16}, the slab
// type T of `dtype` (repro::kF32: float, repro::kBF16: __nv_bfloat16) and
// the accumulation mode `acc`: the kernels are instantiated for each.
template <class F>
cudaError_t with_variant(int G, int dtype, int acc, F f) {
  const auto by_acc = [&](auto g, auto t) -> cudaError_t {
    if (acc == repro::kAccBF16) return f(g, t, std::integral_constant<int, repro::kAccBF16>());
    return f(g, t, std::integral_constant<int, repro::kAccF32>());
  };
  const auto by_type = [&](auto g) -> cudaError_t {
    if (dtype == repro::kBF16) return by_acc(g, TypeTag<__nv_bfloat16>());
    return by_acc(g, TypeTag<float>());
  };
  switch (G) {
    case 1: return by_type(std::integral_constant<int, 1>());
    case 2: return by_type(std::integral_constant<int, 2>());
    case 4: return by_type(std::integral_constant<int, 4>());
    case 8: return by_type(std::integral_constant<int, 8>());
    case 16: return by_type(std::integral_constant<int, 16>());
    default: return cudaErrorInvalidValue;
  }
}

bool variant_ok(int dtype, int acc) {
  return (dtype == repro::kF32 || dtype == repro::kBF16) &&
         (acc == repro::kAccF32 || acc == repro::kAccBF16);
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
bool topk_fits(long long rows, long long groups_y, long long m, int K, int part) {
  const long long parts = (m + part - 1) / part;
  return groups_y <= kMaxGrid && parts <= kMaxGrid && rows <= INT_MAX &&
         m < INT_MAX && (K <= kMaxBlockK || (K + kRoundThreads - 1) / kRoundThreads <= kMaxGrid);
}

}  // namespace

extern "C" {

// The default geometry and the limits of the launch parameters, for the
// port's kernels/blocks.py to check its named defaults against: out[0] the
// full mode's run (slots a block claims at a time), [1] its scoring threads
// (beside one producer warp), [2] the chunk, [3]
// stage 1's threads, [4] the largest query group, [5] the merge's part,
// [6] the largest chunk, [7] the most stage-1 threads (the default).
void dplr_corpus_geometry_defaults(long long* out) {
  out[0] = kFullBlockN;
  out[1] = kFullThreads;
  out[2] = kChunk;
  out[3] = kTopkThreads;
  out[4] = kMaxGroup;
  out[5] = kPart;
  out[6] = kMaxChunk;
  out[7] = kTopkThreads;
}

// Whether a geometry fits `device`'s opt-in shared memory a block: the
// full mode's (topk = 0; chunk its run; threads and part unused) or stage 1's and
// the merge's for K (topk = 1), at rho, k and the slab type `dtype`.
// Returns 1 if it fits, 0 if it does not, and the negated cudaError_t of a
// failed query or an invalid geometry.
int dplr_corpus_geometry_fits(int topk, int group, int threads, int chunk, int part, int rho,
                              int k, int dtype, int K, int device) {
  const Geometry g{group, threads, chunk, part};
  if (rho * k > kMaxRK || rho <= 0 || k <= 0 ||
      !(topk ? topk_geometry_ok(g) : group_ok(group) && chunk >= 1) ||
      (dtype != repro::kF32 && dtype != repro::kBF16))
    return -(int)cudaErrorInvalidValue;
  int optin = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  size_t need = stage_smem(topk != 0, g, rho, k, dtype);
  if (topk && merge_smem(K) > need) need = merge_smem(K);
  return need <= (size_t)optin ? 1 : 0;
}

// Q (n, rho, k) and aI (n): the slab, float (dtype = 0) or bf16 (dtype = 1);
// acc: 0 sums in f32, 1 as the reference's acc_dtype='bfloat16'.  group:
// the query rows a block scores at once (1, 2, 4, 8 or 16); block_n: the
// run, the slots a block claims at a time (in tiles of at most kFullTile
// rows).  One wave of persistent blocks.
int dplr_corpus_score_full(const void* Q, const void* aI, const unsigned char* valid,
                           const float* e, const float* PC, const float* aC, long long n,
                           int Bq, int rho, int k, int dtype, int acc, int group,
                           long long block_n, float* out, void* stream, int device) {
  if (n <= 0 || Bq <= 0 || rho <= 0 || k <= 0 || rho * k > kMaxRK || !variant_ok(dtype, acc) ||
      !group_ok(group) || block_n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = group;
  const long long items = (n + block_n - 1) / block_n * ((Bq + G - 1) / G);
  err = with_variant(G, dtype, acc, [&](auto g, auto t, auto a) {
    constexpr int kG = decltype(g)::value, kA = decltype(a)::value;
    using T = typename decltype(t)::type;
    // a tensor map takes a 16-byte aligned base, rows a whole number of
    // 16-byte pieces apart and row coordinates below 2^31
    const int bulk =
        full_wide<T>(k) && reinterpret_cast<uintptr_t>(Q) % 16 == 0 && n <= INT_MAX;
    const int rw = full_row_words<T>(rho, k);
    const int tile = full_tile(kG, rho, k, rw, block_n);
    const size_t smem = (size_t)FullSmem(kG, rho, k, rw, tile).words * sizeof(float);
    CUtensorMap map{};
    if (bulk) {
      const cudaError_t e1 = slab_map<T>(Q, n, rho * k, rw * 4 / (int)sizeof(T), &map);
      if (e1 != cudaSuccess) return e1;
    }
    cudaError_t e2 = allow_smem_once<corpus_score_full<kG, T, kA>>(smem, device);
    if (e2 != cudaSuccess) return e2;
    long long most = 0;
    e2 = repro::one_wave(corpus_score_full<kG, T, kA>, kFullBlock, smem, device, &most);
    if (e2 != cudaSuccess) return e2;
    corpus_score_full<kG, T, kA><<<(unsigned)(items < most ? items : most), kFullBlock, smem,
                                   (cudaStream_t)stream>>>(
        static_cast<const T*>(Q), static_cast<const T*>(aI), valid, e, PC, aC, n, Bq, rho, k,
        block_n, tile, bulk, map, out);
    return cudaGetLastError();
  });
  return (int)err;
}

// Scratch words (4 bytes each) dplr_corpus_topk needs for Bq rows, or
// dplr_corpus_multi_topk for S * Bq rows with n the longest segment, at a
// chunk of `chunk` slots (the rows' length is n rounded up to chunks).
long long dplr_corpus_topk_scratch(long long n, long long rows, int K, int chunk) {
  if (chunk < 1 || chunk > kMaxChunk) return -1;
  return Scratch(rows, n_chunks_of(n, chunk) * chunk, K).words;
}

// Writes the launches it made to launched[0] (corpus_topk_chunks: 1),
// launched[1] (topk_merge: 1), launched[2] (topk_sort_tiles: 1 for K >
// 4096, else 0) and launched[3] (topk_sort_merge: one per round of runs).
// group, threads, chunk, part: the geometry (Geometry).
int dplr_corpus_topk(const void* Q, const void* aI, const unsigned char* valid,
                     const float* e, const float* PC, const float* aC, long long n, int Bq,
                     int rho, int k, int dtype, int acc, int group, int threads, int chunk,
                     int part, int K, long long index_offset, long long index_stride,
                     unsigned* scratch, float* out_v, int* out_i, int* launched, void* stream,
                     int device) {
  launched[0] = launched[1] = launched[2] = launched[3] = 0;
  const Geometry geo{group, threads, chunk, part};
  if (n <= 0 || Bq <= 0 || K <= 0 || K > n || n > INT_MAX || rho * k > kMaxRK ||
      !variant_ok(dtype, acc) || !topk_geometry_ok(geo))
    return (int)cudaErrorInvalidValue;
  const int G = group;
  const long long n_chunks = n_chunks_of(n, chunk), m = n_chunks * chunk,
                  groups = (Bq + G - 1) / G;
  if (!topk_fits(Bq, groups, m, K, part)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const Scratch sc(Bq, m, K);
  err = cudaMemsetAsync(scratch + sc.counters, 0,
                        (size_t)Bq * (kHistBins + kHist2Bins + 2) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;

  err = with_variant(G, dtype, acc, [&](auto g, auto t, auto a) {
    constexpr int kG = decltype(g)::value, kA = decltype(a)::value;
    using T = typename decltype(t)::type;
    const size_t smem1 =
        (size_t)ChunkSmem(kG, rho, k, repro::row_words<T>(rho * k), chunk, threads).words *
        sizeof(float);
    cudaError_t e2 = allow_smem_once<corpus_topk_chunks<kG, T, kA>>(smem1, device);
    if (e2 != cudaSuccess) return e2;
    corpus_topk_chunks<kG, T, kA><<<dim3((unsigned)n_chunks, (unsigned)groups), threads, smem1,
                                    s>>>(
        static_cast<const T*>(Q), static_cast<const T*>(aI), valid, e, PC, aC, n, Bq, rho, k,
        chunk, reinterpret_cast<float*>(scratch + sc.cand_v), m, scratch + sc.counters);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;

  const size_t smem2 = merge_smem(K);
  err = allow_smem_once<topk_merge>(smem2, device);
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<dim3((unsigned)Bq, (unsigned)((m + part - 1) / part)), kMergeThreads, smem2,
               s>>>(scratch, sc, Bq, m, part, K, out_v, out_i, index_offset, index_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[1] = 1;
  if (K <= kMaxBlockK) return (int)cudaSuccess;
  return (int)sort_rows(scratch, sc, Bq, K, out_v, out_i, index_offset, index_stride, s, device,
                        launched + 2);
}

// The masked top-K of S segments in one launch: row s * Bq + q of the
// (S * Bq, K) outputs is query q of segment s against segment s's slab
// (Q[s] (n[s], rho, k), aI[s], valid[s] or nullptr; every segment's Q and
// aI of the one type `dtype`) with eigenvalues e[s * rho ...], ids
// segment-local and relabeled.  Scratch: as many words as
// dplr_corpus_topk_scratch(max n, S * Bq, K, chunk) gives.  Writes the
// launches it made to launched[0] (corpus_multi_topk_chunks), launched[1]
// (multi_topk_merge), and launched[2] and [3] as dplr_corpus_topk does;
// the geometry as there.
int dplr_corpus_multi_topk(int S, const void* const* Q, const void* const* aI,
                           const unsigned char* const* valid, const long long* n,
                           const float* e, const float* PC, const float* aC, int Bq,
                           int rho, int k, int dtype, int acc, int group, int threads,
                           int chunk, int part, int K, long long index_offset,
                           long long index_stride, unsigned* scratch, float* out_v,
                           int* out_i, int* launched, void* stream, int device) {
  launched[0] = launched[1] = launched[2] = launched[3] = 0;
  const Geometry geo{group, threads, chunk, part};
  if (S <= 0 || S > kMaxSegments || Bq <= 0 || K <= 0 || rho * k > kMaxRK ||
      !variant_ok(dtype, acc) || !topk_geometry_ok(geo))
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
  const int G = group;
  const long long rows = (long long)S * Bq, groups = (Bq + G - 1) / G;
  const long long n_chunks = n_chunks_of(n_max, chunk), m = n_chunks * chunk;
  if (!topk_fits(rows, S * groups, m, K, part)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const Scratch sc(rows, m, K);
  err = cudaMemsetAsync(scratch + sc.counters, 0,
                        (size_t)rows * (kHistBins + kHist2Bins + 2) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;

  err = with_variant(G, dtype, acc, [&](auto g, auto t, auto a) {
    constexpr int kG = decltype(g)::value, kA = decltype(a)::value;
    using T = typename decltype(t)::type;
    const size_t smem1 =
        (size_t)ChunkSmem(kG, rho, k, repro::row_words<T>(rho * k), chunk, threads).words *
        sizeof(float);
    cudaError_t e2 = allow_smem_once<corpus_multi_topk_chunks<kG, T, kA>>(smem1, device);
    if (e2 != cudaSuccess) return e2;
    corpus_multi_topk_chunks<kG, T, kA><<<dim3((unsigned)n_chunks, (unsigned)(S * groups)),
                                          threads, smem1, s>>>(
        segs, e, PC, aC, Bq, rho, k, chunk, reinterpret_cast<float*>(scratch + sc.cand_v), m,
        scratch + sc.counters);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;

  const size_t smem2 = merge_smem(K);
  err = allow_smem_once<multi_topk_merge>(smem2, device);
  if (err != cudaSuccess) return (int)err;
  multi_topk_merge<<<dim3((unsigned)rows, (unsigned)((m + part - 1) / part)), kMergeThreads,
                     smem2, s>>>(scratch, sc, segs, rows, Bq, m, chunk, part, K, out_v, out_i,
                                 index_offset, index_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[1] = 1;
  if (K <= kMaxBlockK) return (int)cudaSuccess;
  return (int)sort_rows(scratch, sc, rows, K, out_v, out_i, index_offset, index_stride, s, device,
                        launched + 2);
}

}  // extern "C"
