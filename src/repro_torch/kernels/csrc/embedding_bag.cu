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
// The backward writes the table's gradient, f32,
//
//   d_table[r, :] = sum_{(b, s) : ids[b, s] = r} grad[b, seg[s], :] * w[b, s]
//
// zero where no slot names r; an id outside [0, rows) adds to no row.  It
// replaces no Pallas kernel of its own (the JAX trainer differentiates the
// jnp lookup; the TPU kernel has no vjp).  Two parts, three launches:
//
// 1. A stable LSD radix sort of the N = B * n_slots flat slots by row:
//    bag_rows_radix_histogram, then bag_rows_radix_sort.  A slot's key is
//    its id, or `rows` for an id outside [0, rows) (cutting such an id to
//    the key's bits would alias it onto a real row), over bit_length(rows)
//    bits (25 on the 33,040,384-row arena) in digits of at most 9 bits (9,
//    8 and 8 there).  The keys go in tiles of 4,096 and the tiles in items
//    (one each at this N).  The histogram kernel counts pass 0's digits
//    item by item and zeroes the counters and the named-row bitmap.  The
//    sort kernel is persistent: its blocks claim (pass, item) tickets in
//    order from one counter.  Each item of a pass after the first counts its
//    digits, publishes them and waits until every item of the pass has (the
//    items of a pass are at most the resident blocks, so all of them are
//    claimed before any waits for long); then it adds up each digit's start
//    from all the items' counts (coalesced rows, no look-back chain), ranks
//    its keys stably (warp by warp in rounds of 32, one ballot a digit bit:
//    __match_any_sync was the slower), orders the tile by digit in shared
//    memory and writes each digit's keys to their consecutive places.  A
//    pass waits for the one before through a done counter.  The last pass
//    writes the outputs and marks in the bitmap the rows the tile holds
//    (equal keys sit next to each other in the tile's order).  What bounds
//    it: at N = 335,872 its bytes (16 N read and written a pass) take a few
//    microseconds; its time is latency (the loads of each phase, a barrier
//    and a fence a pass), hence one launch for all its passes.  Its result
//    is bitwise torch.sort(keys, stable=True): the keys, in the ids' type,
//    and the flat slot indices, ascending within a row.
// 2. One writer, embedding_bag_backward_kernel, writes every element of
//    d_table exactly once (the caller allocates it empty).  Persistent
//    blocks claim tickets in order, each claiming its next while it works:
//    first the sum items (2,048 sorted entries each: the runs of equal rows
//    that start there, however far they go), then the zero tiles (16 KB of
//    rows).  A zero tile writes zeros over the rows the sort's bitmap does
//    not mark, a warp 32 rows at a time with 16-byte streaming stores.  A
//    sum item walks its entries in stages of 256 (128 past k = 16): seven
//    warps copy the next stage's gradient rows into shared memory
//    (cp.async; their slot indices, rows and weights loaded a stage ahead)
//    and add the runs that start in this stage (16 lanes a run at k <= 16,
//    two runs a warp, else 32; run boundaries from a bit mask of the
//    stage's starts), while warp 0 adds the run carried in from the stage
//    before, so a hot row's thousands of entries cost one serial add each
//    and not one load latency each.  What bounds it: writing the table once
//    (2.11 GB at full width, 0.63 ms at 3.35 TB/s); the sums read g, the
//    sorted slots and the weights, ~22 MB, but their latency-bound blocks
//    do not stream zeros meanwhile.
//
// Why the order of adds is fixed: on the card an atomic scatter would add
// each row's terms in whatever order its threads arrive, so two runs of
// one step could differ in the last bits, and a resumed training run would
// not repeat the uninterrupted one.  Here each row is summed from 0.f in
// ascending flat-slot order (the sort is stable), each product and each add
// rounded separately (__fmul_rn, __fadd_rn): the plain version's order
// (index_add_ on the CPU) and the same bits on every call, whichever block
// or lane does the work (a run that crosses a stage hands its partial sum
// on through shared memory as it is).
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

// ---- the backward: the sort ------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;

constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortKeys = 8;                          // keys a thread ranks in a tile
constexpr int kSortTile = kSortThreads * kSortKeys;   // keys a tile holds
constexpr int kDigitBits = 9;                         // the widest digit
constexpr int kBins = 1 << kDigitBits;                // = kSortThreads: a thread a digit
constexpr int kMaxPasses = 4;                         // keys below 2^31
// Counter words at the start of the scratch, zeroed by the histogram
// kernel: the sort's ticket; per pass, the items that published their
// digit counts and the items that scattered; the writer's: its sum items'
// ticket and its count of blocks done.  The writer's last block out zeroes
// its words again, so the writer can run again on the same sort.
constexpr int kTicket = 0, kCounted = 1, kDone = 5, kWriterTicket = 16, kCounters = 32;

static_assert(kBins == kSortThreads, "one thread a digit");
static_assert(kSortTile * 2 <= kSortWarps * kBins, "a tile's keys and values fit the counts");

// A sort of n keys in [0, rows]: its passes' digits, its items (runs of
// whole tiles), and the scratch's layout (byte offsets): each pass's digit
// counts of each item, [pass][item][digit], the bitmap of the rows some key
// names, and two ping-pong buffers of keys and of flat indices.
struct SortPlan {
  long long n, rows;
  int passes, tiles, items, per_item;
  int bits[kMaxPasses], shift[kMaxPasses];
  long long counts, named, named_words, keys[2], vals[2], bytes;
};

// False past the limits: rows < 2^31 - 1 (a key and the sentinel fit in 31
// bits), n < 2^31.  `blocks`: the sort kernel's resident blocks (the items
// of a pass, at most that many, all wait for the last to publish).
inline bool plan_sort(long long n, long long rows, long long blocks, SortPlan* p) {
  if (n < 0 || n > 0x7fffffffLL || rows <= 0 || rows > 0x7ffffffeLL || blocks <= 0) return false;
  *p = SortPlan{};
  p->n = n;
  p->rows = rows;
  int bits = 0;
  while ((1LL << bits) <= rows) ++bits;
  p->passes = (bits + kDigitBits - 1) / kDigitBits;
  for (int i = 0, at = 0; i < p->passes; ++i) {
    p->bits[i] = bits / p->passes + (i < bits % p->passes ? 1 : 0);
    p->shift[i] = at;
    at += p->bits[i];
  }
  p->tiles = (int)((n + kSortTile - 1) / kSortTile);
  const long long items = p->tiles < blocks ? p->tiles : blocks;
  p->per_item = items > 0 ? (int)((p->tiles + items - 1) / items) : 1;
  p->items = (p->tiles + p->per_item - 1) / p->per_item;
  p->named_words = (rows + 127) / 128 * 4;
  long long at = 0;
  const auto take = [&at](long long bytes) {
    const long long offset = at;
    at += (bytes + 255) / 256 * 256;
    return offset;
  };
  take(kCounters * 4);
  p->counts = take((long long)p->passes * p->tiles * kBins * 4);
  p->named = take(p->named_words * 4);
  for (int i = 0; i < 2; ++i) {
    p->keys[i] = take(n * 4);
    p->vals[i] = take(n * 4);
  }
  p->bytes = at;
  return true;
}

__device__ inline unsigned row_key(const void* ids, int ids64, long long q, long long rows) {
  const long long id = slot_id(ids, ids64, q);
  return (unsigned)(id >= 0 && id < rows ? id : rows);
}

__device__ inline unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Block thread 0 until *counter reaches `target`; then the block may read
// what the blocks that counted wrote before they counted.
__device__ inline void wait_for(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    while (load_acquire(counter) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// Count the block's writes above into *counter, after every thread's.
__device__ inline void count_in(unsigned* counter) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(counter, 1u);
}

// The lanes whose digit equals this lane's (valid lanes only; 0 for an
// invalid lane): one ballot a bit, every lane of the warp calling.
__device__ inline unsigned digit_peers(unsigned d, int bits, bool valid) {
  unsigned peers = __ballot_sync(kFull, valid);
  for (int b = 0; b < bits; ++b) {
    const bool one = (d >> b) & 1u;
    const unsigned m = __ballot_sync(kFull, one);
    peers &= one ? m : ~m;
  }
  return valid ? peers : 0u;
}

// This thread's first key of a tile; its keys are base + 32 r, r < kSortKeys
// (a warp owns 256 consecutive keys).
__device__ inline long long tile_base(long long tile) {
  return tile * kSortTile + (threadIdx.x >> 5) * (32 * kSortKeys) + (threadIdx.x & 31);
}

// The block's digit counts of a tile's keys, added into `hist`: one atomic
// a digit a warp round.
__device__ inline void count_digits(const unsigned* key, long long base, long long n, int shift,
                                    int bits, unsigned* hist) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kSortKeys; ++r) {
    const unsigned d = (key[r] >> shift) & ((1u << bits) - 1u);
    const unsigned peers = digit_peers(d, bits, base + r * 32 < n);
    if (peers && lane == 31 - __clz(peers)) atomicAdd(hist + d, (unsigned)__popc(peers));
  }
}

// Digit tid's start for `item` in a pass's output, from every item's
// counts of the pass ([item][digit]): the counts of all items, scanned over
// digits, plus those of the items before this one.  The whole block calls
// it; each load of a row is one coalesced line a warp.
__device__ inline unsigned digit_start(const unsigned* counts, int items, int item, int nbins,
                                       unsigned* warp_sums) {
  const int d = threadIdx.x;
  unsigned all = 0, before = 0;
  if (d < nbins) {
#pragma unroll 16
    for (int j = 0; j < items; ++j) {
      const unsigned c = __ldcg(counts + (long long)j * kBins + d);
      all += c;
      before += j < item ? c : 0u;
    }
  }
  unsigned sum;
  return repro::block_scan(all, warp_sums, &sum) + before;
}

// Pass 0's digit counts of each item (block b counts item b), and the
// zeroed counters and named-row bitmap for the kernels after it.
__global__ void __launch_bounds__(kSortThreads)
    bag_rows_radix_histogram(const void* __restrict__ ids, int ids64, SortPlan plan,
                             unsigned char* __restrict__ scratch) {
  __shared__ unsigned hist[kBins];
  unsigned* const counters = reinterpret_cast<unsigned*>(scratch);
  uint4* const named = reinterpret_cast<uint4*>(scratch + plan.named);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < plan.named_words / 4;
       i += (long long)gridDim.x * blockDim.x)
    named[i] = make_uint4(0u, 0u, 0u, 0u);
  if (blockIdx.x == 0 && threadIdx.x < kCounters) counters[threadIdx.x] = 0u;
  hist[threadIdx.x] = 0u;
  __syncthreads();
  const int end = min(plan.tiles, (int)(blockIdx.x + 1) * plan.per_item);
  for (int tile = blockIdx.x * plan.per_item; tile < end; ++tile) {
    const long long base = tile_base(tile);
    unsigned key[kSortKeys];
#pragma unroll
    for (int r = 0; r < kSortKeys; ++r)
      key[r] = base + r * 32 < plan.n ? row_key(ids, ids64, base + r * 32, plan.rows) : 0u;
    count_digits(key, base, plan.n, plan.shift[0], plan.bits[0], hist);
  }
  __syncthreads();
  reinterpret_cast<unsigned*>(scratch + plan.counts)[(long long)blockIdx.x * kBins + threadIdx.x] =
      hist[threadIdx.x];
}

// The passes, persistent: ticket t is item t % items of pass t / items.  A
// pass after the first counts each item's digits and publishes them, and
// waits until every item of the pass has (pass 0's counts are the
// histogram kernel's).  Then each item adds up each digit's start from all
// the counts, ranks
// each tile's keys stably (warp by warp in rounds of 32, one ballot a
// digit bit), orders the tile by digit in shared memory, and writes each
// digit's keys to their consecutive places.  The last pass writes the
// outputs and marks each row it writes in the named-row bitmap (once a
// tile: a tile's equal keys end up next to each other).
__global__ void __launch_bounds__(kSortThreads)
    bag_rows_radix_sort(const void* __restrict__ ids, int ids64, SortPlan plan,
                        unsigned char* scratch, void* __restrict__ keys_out,
                        long long* __restrict__ perm_out) {
  // a warp's counts of a tile, then where its keys go; then the tile's
  // keys and values in digit order
  __shared__ unsigned hist[kSortWarps][kBins];
  __shared__ unsigned total[kBins];             // the block's counts of a pass
  __shared__ int delta[kBins];                  // a digit's global minus tile place
  __shared__ unsigned warp_sums[kSortWarps];
  __shared__ unsigned shared_word;
  unsigned* const counters = reinterpret_cast<unsigned*>(scratch);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int items = plan.items, P = plan.passes;
  unsigned* const sorted_keys = &hist[0][0];
  unsigned* const sorted_vals = &hist[0][0] + kSortTile;
  for (;;) {
    if (tid == 0) shared_word = atomicAdd(counters + kTicket, 1u);
    __syncthreads();
    const int ticket = (int)shared_word;
    __syncthreads();
    if (ticket >= P * items) break;
    const int p = ticket / items, item = ticket - p * items;
    const int first = item * plan.per_item;
    const int end = min(plan.tiles, first + plan.per_item);
    const int shift = plan.shift[p], bits = plan.bits[p];
    const unsigned nbins = 1u << bits, mask = nbins - 1u;
    unsigned* const counts = reinterpret_cast<unsigned*>(scratch + plan.counts) +
                             (long long)p * plan.tiles * kBins;
    // pass p reads the buffers pass p - 1 wrote (pass 0 the ids) and writes
    // the others (the last pass the outputs)
    const int in = (p + 1) & 1, out = p & 1;
    const unsigned* const keys_in = reinterpret_cast<const unsigned*>(scratch + plan.keys[in]);
    const unsigned* const vals_in = reinterpret_cast<const unsigned*>(scratch + plan.vals[in]);
    unsigned* const keys_mid = reinterpret_cast<unsigned*>(scratch + plan.keys[out]);
    unsigned* const vals_mid = reinterpret_cast<unsigned*>(scratch + plan.vals[out]);
    const bool last = p == P - 1, single = end - first == 1;
    unsigned key[kSortKeys], val[kSortKeys], rank[kSortKeys];
    const auto load = [&](int tile) {
      const long long base = tile_base(tile);
#pragma unroll
      for (int r = 0; r < kSortKeys; ++r) {
        const long long q = base + r * 32;
        key[r] = q >= plan.n ? 0u : p == 0 ? row_key(ids, ids64, q, plan.rows)
                                           : __ldcg(keys_in + q);
        val[r] = q >= plan.n ? 0u : p == 0 ? (unsigned)q : __ldcg(vals_in + q);
      }
    };
    // a key's place among its warp's keys of its digit (hist: each warp's counts)
    const auto rank_tile = [&](int tile) {
      const long long base = tile_base(tile);
      unsigned* const mine = hist[warp];
      for (int d = lane; d < kBins; d += 32) mine[d] = 0u;
      __syncwarp();
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int r = 0; r < kSortKeys; ++r) {
        const unsigned d = (key[r] >> shift) & mask;
        const unsigned peers = digit_peers(d, bits, base + r * 32 < plan.n);
        const unsigned at = peers ? mine[d] : 0u;
        __syncwarp();
        if (peers && lane == 31 - __clz(peers)) mine[d] = at + __popc(peers);
        __syncwarp();
        rank[r] = at + __popc(peers & below);
      }
      __syncthreads();
    };
    if (p > 0) wait_for(counters + kDone + p - 1, (unsigned)items);
    if (single) {
      load(first);
      rank_tile(first);
    }
    if (p > 0) {  // publish this item's digit counts; wait for every item's
      unsigned c = 0;
      if (single) {
        for (int w = 0; w < kSortWarps; ++w) c += hist[w][tid];
      } else {
        total[tid] = 0u;
        __syncthreads();
        for (int tile = first; tile < end; ++tile) {
          load(tile);
          count_digits(key, tile_base(tile), plan.n, shift, bits, total);
        }
        __syncthreads();
        c = total[tid];
      }
      counts[(long long)item * kBins + tid] = c;
      count_in(counters + kCounted + p);
      wait_for(counters + kCounted + p, (unsigned)items);
    }
    unsigned run = digit_start(counts, items, item, nbins, warp_sums);
    for (int tile = first; tile < end; ++tile) {
      if (!single) {
        load(tile);
        rank_tile(tile);
      }
      // digit tid: each warp's place in the tile's digit order and in the output
      unsigned in_tile = 0;
      for (int w = 0; w < kSortWarps; ++w) in_tile += hist[w][tid];
      unsigned sum;
      unsigned at = repro::block_scan(in_tile, warp_sums, &sum);  // the digit's tile place
      delta[tid] = (int)(run - at);
      run += in_tile;
      for (int w = 0; w < kSortWarps; ++w) {
        const unsigned c = hist[w][tid];
        hist[w][tid] = at;
        at += c;
      }
      __syncthreads();
      const long long base = tile_base(tile);
      unsigned place[kSortKeys];
#pragma unroll
      for (int r = 0; r < kSortKeys; ++r)
        place[r] = hist[warp][(key[r] >> shift) & mask] + rank[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kSortKeys; ++r) {
        if (base + r * 32 >= plan.n) continue;
        sorted_keys[place[r]] = key[r];
        sorted_vals[place[r]] = val[r];
      }
      __syncthreads();
      const int count = (int)min((long long)kSortTile, plan.n - (long long)tile * kSortTile);
      for (int i = tid; i < count; i += kSortThreads) {
        const unsigned k = sorted_keys[i];
        const unsigned dst = (unsigned)(delta[(k >> shift) & mask] + i);
        if (!last) {
          __stcg(keys_mid + dst, k);
          __stcg(vals_mid + dst, sorted_vals[i]);
          continue;
        }
        if (ids64)
          static_cast<long long*>(keys_out)[dst] = (long long)k;
        else
          static_cast<int*>(keys_out)[dst] = (int)k;
        perm_out[dst] = (long long)sorted_vals[i];
        if (k < plan.rows && (i == 0 || sorted_keys[i - 1] != k))
          atomicOr(reinterpret_cast<unsigned*>(scratch + plan.named) + (k >> 5),
                   1u << (k & 31));
      }
      __syncthreads();
    }
    count_in(counters + kDone + p);
  }
}

// ---- the backward: the writer ----------------------------------------------

// Asynchronous copies from global into shared memory (cp.async): 16 bytes
// (both 16-byte aligned) or 4; wait_copies waits for this thread's.
__device__ inline void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ inline void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ inline void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }


constexpr int kWriterThreads = 256;
constexpr int kProducers = kWriterThreads - 32;  // warps 1..7 gather; warp 0 carries
constexpr int kStageFloats = 4096;               // gradient elements a stage holds
constexpr int kMaxStage = kStageFloats / 16;     // entries of a stage at 16 columns
constexpr int kChunk = 2048;                     // sorted entries of a sum item
constexpr int kSegSlots = 1024;                  // a slot -> bag map this long sits in shared memory
constexpr int kTileFloats = 4096;                // a zero tile's elements (past 32 rows)

struct BagGrad {
  const float* grad;
  const void* keys;
  const long long* perm;
  const float* w;
  const long long* seg;
  float* d_table;
  const unsigned* named;  // the sort's bitmap of the rows some slot names
  unsigned* counter;
  long long N, rows, sum_items, items;
  int tile_rows;  // rows of a zero tile (a multiple of 32)
  int n_bags, k, n_slots, keys64, vec, vec_grad;
};

struct __align__(16) WriterShared {
  float g[2][kStageFloats];        // a stage's gradient rows, [entry][column]
  long long src[kMaxStage];        // an entry's gradient row (and column block)
  float wt[2][kMaxStage];          // its weight
  int row[2][kMaxStage];           // its row
  unsigned char start[2][kMaxStage];  // whether a run starts at it
  unsigned starts[2][kMaxStage / 32];  // the same as bits, one word a 32 entries
  float carry[2][32];              // the partial sum of the run that crosses a stage
  int carry_row[2];
  int seg[kSegSlots];              // the slot -> bag map (n_slots <= kSegSlots)
  long long z;
  unsigned item;
  int first, sentinel;
};

__device__ inline long long key_at(const BagGrad& A, long long q) {
  return slot_id(A.keys, A.keys64, q);
}

// The first q in [lo, hi) with key q >= v, else hi (keys ascending); the
// whole warp calls it and probes 32 places a round.
__device__ long long warp_lower_bound(const BagGrad& A, long long lo, long long hi, long long v) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const unsigned m = __ballot_sync(kFull, q >= hi || key_at(A, q) >= v);
    if (m == 0) {
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(m) - 1;
    if (f == 0) return lo;
    const long long end = lo + f * step;
    lo += (f - 1) * step + 1;
    hi = end < hi ? end : hi;
  }
  const long long q = lo + lane;
  const unsigned m = __ballot_sync(kFull, q >= hi || key_at(A, q) >= v);
  return m ? lo + __ffs(m) - 1 : hi;
}

// The first run start in [from, to) of a stage, else to, from the stage's
// start bits (every lane of a group computes it).
__device__ inline int next_start(const unsigned* starts, int from, int to) {
  for (int w = from >> 5; (w << 5) < to; ++w) {
    const unsigned m = starts[w] & (w == from >> 5 ? ~0u << (from & 31) : ~0u);
    if (m) {
      const int f = (w << 5) + __ffs(m) - 1;
      return f < to ? f : to;
    }
  }
  return to;
}

// A producer thread's entries of the stages ahead (entry pt and pt +
// kProducers of a stage): the next stage's flat slot indices, keys, the key
// before each, and weights, and the flat indices of the stage after it.
struct Ahead {
  unsigned flat[2], next[2];
  long long key[2], prev[2];
  float w[2];
};

// Shift `h` on to stage j: its flat indices (loaded a stage ago), then the
// loads of its keys and weights and of stage j + 1's flat indices, all in
// flight when it returns.
__device__ inline void look_ahead(const BagGrad& A, long long a, long long z, long long j,
                                  int stage, Ahead& h) {
  const int pt = threadIdx.x - 32;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int e = pt + m * kProducers;
    const long long q = a + j * stage + e, q1 = q + stage;
    h.flat[m] = h.next[m];
    if (e < stage && q < z) {
      h.key[m] = key_at(A, q);
      h.prev[m] = q == 0 ? -1 : key_at(A, q - 1);
      h.w[m] = __ldg(A.w + h.flat[m]);
    }
    h.next[m] = e < stage && q1 < z ? (unsigned)__ldg(A.perm + q1) : 0u;
  }
}

// Stage j of the entries [a, z) into buffer j & 1 from `h`: each entry's
// weight, row and whether a run starts at it, then copies of its gradient
// row's columns [c0, c0 + cw) (in flight when it returns: the caller waits
// for them); `h` moves on to stage j + 1.  Warps 1..7 call it.
__device__ void gather(const BagGrad& A, WriterShared& S, long long a, long long z, int c0,
                       long long j, int cw, Ahead& h) {
  const int pt = threadIdx.x - 32, buf = (int)(j & 1), stage = kStageFloats / cw;
  const long long x = a + j * stage;
  const int len = (int)(z - x < stage ? z - x : stage);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int e = pt + m * kProducers;
    if (e >= len) continue;
    const unsigned b = h.flat[m] / (unsigned)A.n_slots, slot = h.flat[m] - b * A.n_slots;
    const int bag = A.n_slots <= kSegSlots ? S.seg[slot] : (int)__ldg(A.seg + slot);
    S.src[e] = ((long long)b * A.n_bags + bag) * A.k + c0;
    S.wt[buf][e] = h.w[m];
    S.row[buf][e] = (int)h.key[m];
    S.start[buf][e] = h.prev[m] != h.key[m];
  }
  look_ahead(A, a, z, j + 1, stage, h);
  asm volatile("bar.sync 1, %0;" ::"n"(kProducers) : "memory");
  if (pt < 32) {  // warp 1: the start flags as bits
    for (int w = 0; w < kMaxStage / 32; ++w) {
      const int e = w * 32 + pt;
      const unsigned bits = __ballot_sync(kFull, e < len && S.start[buf][e]);
      if (pt == 0) S.starts[buf][w] = bits;
    }
  }
  const int width = A.k - c0 < cw ? A.k - c0 : cw;  // the columns of this block
  float* const dst = S.g[buf];
  if (A.vec_grad) {  // 16-byte pieces
    const int pieces = cw / 4, shift = cw == 16 ? 2 : 3;
    for (int i = pt; i < len * pieces; i += kProducers) {
      const int e = i >> shift, c = (i & (pieces - 1)) * 4;
      if (c < width) copy16(dst + e * cw + c, A.grad + S.src[e] + c);
    }
  } else {
    const int shift = cw == 16 ? 4 : 5;
    for (int i = pt; i < len * cw; i += kProducers) {
      const int e = i >> shift, c = i & (cw - 1);
      if (c < width) copy4(dst + i, A.grad + S.src[e] + c);
    }
  }
}

// A run's sum for columns [c0, c0 + cw) into its row.
__device__ inline void put_row(const BagGrad& A, int row, float acc, int c0, int glane) {
  if (c0 + glane < A.k) A.d_table[(long long)row * A.k + c0 + glane] = acc;
}

// The sums of the runs in [a, z) (a is a run start, z a run end), columns
// [c0, c0 + cw), stage by stage.  While warps 1..7 copy the next stage in
// and add the runs that start in this one, warp 0 adds the run carried in
// from the stage before.  A stage's last run always hands its partial sum
// on; the next stage's warp 0 continues it, or, when a run starts there,
// writes it.  Each product g * w is rounded, then added.
__device__ void sum_runs(const BagGrad& A, WriterShared& S, long long a, long long z, int c0) {
  const int cw = A.k <= 16 ? 16 : 32, stage = kStageFloats / cw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int glane = lane & (cw - 1);
  const long long stages = (z - a + stage - 1) / stage;
  Ahead h;
  if (warp > 0) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int e = tid - 32 + m * kProducers;
      h.next[m] = e < stage && a + e < z ? (unsigned)__ldg(A.perm + a + e) : 0u;
    }
    look_ahead(A, a, z, 0, stage, h);
    gather(A, S, a, z, c0, 0, cw, h);
    wait_copies();
  }
  __syncthreads();
  for (long long i = 0; i < stages; ++i) {
    const int cur = (int)(i & 1);
    const long long x = a + i * stage;
    const int len = (int)(z - x < stage ? z - x : stage);
    const float* const g = S.g[cur];
    const float* const wt = S.wt[cur];
    const unsigned* const starts = S.starts[cur];
    if (warp > 0) {
      if (i + 1 < stages) gather(A, S, a, z, c0, i + 1, cw, h);
      // the runs that start in this stage: group grp looks for starts in its
      // share of the entries, and follows each run to its end
      const int groups = kProducers / cw, grp = (tid - 32) / cw;
      const int hi = (grp + 1) * len / groups;
      for (int e = next_start(starts, grp * len / groups, hi); e < hi;
           e = next_start(starts, e + 1, hi)) {
        const int f = next_start(starts, e + 1, len);
        float acc = 0.f;
#pragma unroll 8
        for (int t = e; t < f; ++t) acc = __fadd_rn(acc, __fmul_rn(g[t * cw + glane], wt[t]));
        if (f < len) {
          put_row(A, S.row[cur][e], acc, c0, glane);
        } else {
          S.carry[cur][glane] = acc;
          if (glane == 0) S.carry_row[cur] = S.row[cur][e];
        }
      }
      wait_copies();
    } else if (i > 0 && lane < cw) {
      const float carried = S.carry[cur ^ 1][glane];
      const int row = S.carry_row[cur ^ 1];
      if (starts[0] & 1u) {
        put_row(A, row, carried, c0, glane);
      } else {
        const int f = next_start(starts, 0, len);
        float acc = carried;
#pragma unroll 8
        for (int t = 0; t < f; ++t) acc = __fadd_rn(acc, __fmul_rn(g[t * cw + glane], wt[t]));
        if (f < len) {
          put_row(A, row, acc, c0, glane);
        } else {
          S.carry[cur][glane] = acc;
          if (glane == 0) S.carry_row[cur] = row;
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0 && lane < cw)  // the last run, which ends at z
    put_row(A, S.carry_row[(stages - 1) & 1], S.carry[(stages - 1) & 1][glane], c0, glane);
}

// Sum item `chunk`: every run of named rows that starts among the sorted
// entries [chunk * kChunk, + kChunk), to its end.
__device__ void sum_item(const BagGrad& A, WriterShared& S, long long chunk) {
  const int tid = threadIdx.x;
  const long long e0 = chunk * kChunk, e1 = e0 + kChunk < A.N ? e0 + kChunk : A.N;
  if (tid == 0) {
    S.first = kChunk;
    S.sentinel = kChunk;
  }
  __syncthreads();
  for (long long q = e0 + tid; q < e1; q += kWriterThreads) {
    const long long key = key_at(A, q);
    if (key >= A.rows)
      atomicMin(&S.sentinel, (int)(q - e0));
    else if (q == 0 || key_at(A, q - 1) != key)
      atomicMin(&S.first, (int)(q - e0));
  }
  __syncthreads();
  if (S.first == kChunk) return;
  const long long a = e0 + S.first;
  if (tid < 32) {  // the end of the last run that starts here
    long long z;
    if (S.sentinel < kChunk) {
      z = e0 + S.sentinel;
    } else {
      const long long v = key_at(A, e1 - 1), q = e1 + tid;
      const unsigned m = __ballot_sync(kFull, q >= A.N || key_at(A, q) != v);
      z = m ? e1 + __ffs(m) - 1 : warp_lower_bound(A, e1 + 32, A.N, v + 1);
    }
    if (tid == 0) S.z = z;
  }
  __syncthreads();
  const long long z = S.z;
  for (int c0 = 0; c0 < A.k; c0 += A.k <= 16 ? 16 : 32) sum_runs(A, S, a, z, c0);
}

// Zero tile t: zeros over the rows of [t * tile_rows, + tile_rows) that no
// slot names.  A warp takes 32 rows at a time: one word of the sort's
// bitmap (the next group's loaded before this group's stores), then the
// group's free rows, consecutive lanes on consecutive 16 bytes.
__device__ void zero_tile(const BagGrad& A, long long t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = kWriterThreads / 32;
  const long long r0 = t * A.tile_rows;
  const int n_rows = (int)(A.rows - r0 < A.tile_rows ? A.rows - r0 : A.tile_rows);
  const int groups = (n_rows + 31) / 32;
  const unsigned* const named = A.named + r0 / 32;  // tile_rows is a multiple of 32
  unsigned word = warp < groups ? __ldg(named + warp) : 0u;
  for (int grp = warp; grp < groups; grp += warps) {
    const unsigned next = grp + warps < groups ? __ldg(named + grp + warps) : 0u;
    const int rows = n_rows - grp * 32 < 32 ? n_rows - grp * 32 : 32;
    float* const base = A.d_table + (r0 + grp * 32LL) * A.k;
    if (A.vec) {
      const int per_row = A.k >> 2;
      float4* const dst = reinterpret_cast<float4*>(base);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      if (word == 0u) {  // most groups: no row named
#pragma unroll 4
        for (int u = lane; u < rows * per_row; u += 32) __stcs(dst + u, zero);
      } else {
        for (int u = lane; u < rows * per_row; u += 32)
          if (!((word >> (u / per_row)) & 1u)) __stcs(dst + u, zero);
      }
    } else {
      for (int u = lane; u < rows * A.k; u += 32)
        if (!((word >> (u / A.k)) & 1u)) __stcs(base + u, 0.f);
    }
    word = next;
  }
}

// Items in ticket order, the sum items first: each block claims its next
// ticket while it works on the one it has.
__global__ void __launch_bounds__(kWriterThreads, 4) embedding_bag_backward_kernel(BagGrad A) {
  __shared__ WriterShared S;
  unsigned* const ticket = A.counter;
  unsigned* const exited = A.counter + 1;
  if (A.n_slots <= kSegSlots)
    for (int i = threadIdx.x; i < A.n_slots; i += kWriterThreads) S.seg[i] = (int)A.seg[i];
  if (threadIdx.x == 0) S.item = atomicAdd(ticket, 1u);
  __syncthreads();
  for (;;) {
    const unsigned item = S.item;
    __syncthreads();
    if (item >= A.items) break;
    unsigned next = 0;
    if (threadIdx.x == 0) next = atomicAdd(ticket, 1u);
    if (item < A.sum_items)
      sum_item(A, S, item);
    else
      zero_tile(A, item - A.sum_items);
    if (threadIdx.x == 0) S.item = next;
    __syncthreads();
  }
  if (threadIdx.x == 0 && atomicAdd(exited, 1u) == gridDim.x - 1) {
    *ticket = 0u;  // every block is past its last ticket
    *exited = 0u;
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

// The scratch bytes of a bag_rows_sort of n keys over `rows` rows (0, and
// *bytes set), or cudaErrorInvalidValue past its limits: rows < 2^31 - 1,
// n < 2^31.
int bag_rows_sort_scratch(long long n, long long rows, long long* bytes) {
  SortPlan plan;
  if (!plan_sort(n, rows, 1, &plan)) return (int)cudaErrorInvalidValue;
  *bytes = plan.bytes;
  return 0;
}

// The stable sort of the n flat slot ids (int32 with ids64 = 0, else int64)
// by row: keys (n, the ids' type) = ids with those outside [0, rows) set to
// rows, ascending; perm (n) their flat indices, ascending within a key:
// bitwise torch.sort(keys, stable=True).  scratch: bag_rows_sort_scratch
// bytes, any contents; it keeps the bitmap of the rows some id names for
// the writer.  n = 0 launches nothing.
int bag_rows_sort(const void* ids, int ids64, long long n, long long rows, void* keys,
                  long long* perm, void* scratch, void* stream, int device) {
  SortPlan plan;
  if (!plan_sort(n, rows, 1, &plan)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  err = repro::one_wave(bag_rows_radix_sort, kSortThreads, 0, device, &blocks);
  if (err != cudaSuccess) return (int)err;
  plan_sort(n, rows, blocks, &plan);
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned char* const bytes = static_cast<unsigned char*>(scratch);
  bag_rows_radix_histogram<<<plan.items, kSortThreads, 0, s>>>(ids, ids64, plan, bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long tickets = (long long)plan.passes * plan.items;
  bag_rows_radix_sort<<<(unsigned)(blocks < tickets ? blocks : tickets), kSortThreads, 0, s>>>(
      ids, ids64, plan, bytes, keys, perm);
  return (int)cudaGetLastError();
}

// The table's gradient, d_table (rows, k), every element written once, for
// grad (B, n_bags, k), the weights w (B, n_slots) and the slot -> bag map
// seg (n_slots), from bag_rows_sort's result over the N = B * n_slots
// slots: sorted (N, int32 with keys64 = 0, else int64) and perm (N).
// scratch: that sort's, on the same stream (its histogram kernel zeroed the
// writer's counters there, and the writer leaves them zeroed, so it may run
// again on the same sort).  N >= 1.
int embedding_bag_backward(const float* grad, int n_bags, int k, const void* sorted,
                           int keys64, const long long* perm, const float* w,
                           const long long* seg, int n_slots, long long N, long long rows,
                           void* scratch, float* d_table, void* stream, int device) {
  SortPlan plan;
  if (N <= 0 || !plan_sort(N, rows, 1, &plan) || k <= 0 || n_slots <= 0 || n_bags <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BagGrad A{};
  A.grad = grad;
  A.keys = sorted;
  A.perm = perm;
  A.w = w;
  A.seg = seg;
  A.d_table = d_table;
  A.named = reinterpret_cast<const unsigned*>(static_cast<unsigned char*>(scratch) + plan.named);
  A.counter = static_cast<unsigned*>(scratch) + kWriterTicket;
  A.N = N;
  A.rows = rows;
  A.n_bags = n_bags;
  A.k = k;
  A.n_slots = n_slots;
  A.keys64 = keys64;
  A.vec = k % 4 == 0 && (uintptr_t)d_table % 16 == 0;
  A.vec_grad = k % 4 == 0 && (uintptr_t)grad % 16 == 0;
  A.tile_rows = (kTileFloats / k + 31) / 32 * 32;  // about 16 KB of f32 rows, whole groups
  A.sum_items = (N + kChunk - 1) / kChunk;
  A.items = A.sum_items + (rows + A.tile_rows - 1) / A.tile_rows;
  if (A.items > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  long long blocks = 0;
  err = repro::one_wave(embedding_bag_backward_kernel, kWriterThreads, 0, device, &blocks);
  if (err != cudaSuccess) return (int)err;
  embedding_bag_backward_kernel<<<(unsigned)(blocks < A.items ? blocks : A.items),
                                   kWriterThreads, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // extern "C"
