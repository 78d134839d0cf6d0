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
// is the floor; the full mode adds Bq * n * 4 bytes of output.
//
// What the design does about it:
//  * Q_I is read once per block, as whole tiles copied cooperatively into
//    shared memory (coalesced, 8 loads in flight per thread), with an odd
//    row stride so that each thread then reads its own item's row without
//    bank conflicts.
//  * Full mode: a block of 128 threads holds up to 16 queries' P_C in
//    shared memory and one item per thread, and writes out[q, i] with
//    consecutive threads on consecutive i.
//  * Top-K mode: a CUDA grid has no order, so the TPU kernel's running
//    top-K, carried across a sequential grid, does not carry over.  It runs
//    in two stages instead.  Stage 1: one block per (query, chunk of up to
//    16384 slots) scores its chunk into shared memory and sorts it with a
//    bitonic network; its best L = next_pow2(K) entries go to a scratch
//    list.  Stage 2: blocks load up to 16384 / L lists, sort them again and
//    keep the best L, launched again until one list remains.  Every sort
//    orders by (value descending, slot ascending), so ties go to the lowest
//    slot as in lax.top_k, and the result is the same from run to run (no
//    atomics).  The query index is blockIdx.x, so the blocks that read one
//    chunk of Q_I for different queries run together and share it in L2.
//  * Multi-tenant mode: the TPU kernel concatenates the S slabs on the item
//    axis (a copy of every slab on every call) and scores each tile against
//    all S * Bq query rows, masking the foreign ones.  Here the S slabs stay
//    where they are: a table of S (Q_I, a_I, valid, n) entries travels as a
//    kernel parameter, and stage 1 runs one block per (stacked query row,
//    chunk of that row's own segment), so no slab is copied and no foreign
//    row is scored.  Rows of a shorter segment pad their list count up to
//    the longest segment's with sentinel lists (-inf, INT_MAX), so that one
//    merge schedule serves all S * Bq rows.  A block scores and sorts with
//    the same device code as the single-slab mode; the top-K order is a
//    total order, so row [s] is bitwise the single-slab top-K of segment s
//    whatever the chunking.
//  * All arithmetic is f32 in the direct form, not the GEMM expansion
//    ||P_C||^2 + 2<P_C, Q_I> + ||Q_I||^2, whose rounding differs.
#include "common.cuh"

namespace {

using repro::kMaxRK;
using repro::kNegInf;

constexpr int kFullTile = 128;     // items per block, one per thread
constexpr int kFullQueries = 16;   // queries per block in the full mode
constexpr int kTopkThreads = 256;
constexpr int kMergeThreads = 512;
constexpr int kMaxSort = 16384;    // entries one block sorts in shared memory
constexpr int kMaxTopK = 4096;
constexpr int kMaxSegments = 64;   // segments of one multi-tenant launch
constexpr size_t kMaxSmem = 232448;

__global__ void corpus_score_full(const float* __restrict__ Q,
                                  const float* __restrict__ aI,
                                  const unsigned char* __restrict__ valid,
                                  const float* __restrict__ e,
                                  const float* __restrict__ PC,
                                  const float* __restrict__ aC, long long n,
                                  int Bq, int rho, int k,
                                  float* __restrict__ out) {
  extern __shared__ float smem[];
  const int RK = rho * k;
  const int RKP = repro::padded_stride(RK);
  float* qs = smem;                          // kFullTile * RKP
  float* pc = qs + kFullTile * RKP;          // kFullQueries * RK
  float* es = pc + kFullQueries * RK;        // rho
  float* ac = es + rho;                      // kFullQueries

  const long long row0 = (long long)blockIdx.x * kFullTile;
  const int q0 = blockIdx.y * kFullQueries;
  const int nq = min(kFullQueries, Bq - q0);
  for (int t = threadIdx.x; t < nq * RK; t += blockDim.x)
    pc[t] = PC[(long long)q0 * RK + t];
  for (int t = threadIdx.x; t < rho; t += blockDim.x) es[t] = e[t];
  for (int t = threadIdx.x; t < nq; t += blockDim.x) ac[t] = aC[q0 + t];
  repro::stage_rows(Q, row0, kFullTile, n, RK, RKP, qs);
  __syncthreads();

  const long long i = row0 + threadIdx.x;
  if (i >= n) return;
  const bool live = valid == nullptr || valid[i] != 0;
  const float ai = aI[i];
  const float* q = qs + threadIdx.x * RKP;
  for (int j = 0; j < nq; ++j) {
    float s = kNegInf;
    if (live) s = repro::slot_score(ac[j], ai, q, pc + j * RK, es, rho, k);
    out[(long long)(q0 + j) * n + i] = s;
  }
}

// Writes the block's sorted list: the first K entries, relabeled, to the
// final outputs (row q of K), or all L entries to the scratch list `list`.
__device__ void write_list(const float* sv, const int* si, long long q, long long list,
                           int L, float* out_v, int* out_i, int is_final, int K,
                           long long index_offset, long long index_stride) {
  if (is_final) {
    for (int t = threadIdx.x; t < K; t += blockDim.x) {
      out_v[q * K + t] = sv[t];
      out_i[q * K + t] = (int)(index_offset + index_stride * (long long)si[t]);
    }
  } else {
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      out_v[list * L + t] = sv[t];
      out_i[list * L + t] = si[t];
    }
  }
}

// The stage-1 work of one block: score slots [chunk * CH, (chunk + 1) * CH)
// of one slab for one query (P_C row `pc_row`, scalar `ac`, eigenvalues
// `e`), sort them and write the best L to list `list` (or, final, the best
// K to row `row`).  Shared by the single-slab and the multi-tenant kernels,
// so that both score and order a slot identically.
__device__ void chunk_topk(const float* __restrict__ Q, const float* __restrict__ aI,
                           const unsigned char* __restrict__ valid, long long n,
                           const float* __restrict__ e, const float* __restrict__ pc_row,
                           float ac, int rho, int k, long long chunk, int CH, int tile,
                           int L, long long row, long long list, float* out_v, int* out_i,
                           int is_final, int K, long long index_offset,
                           long long index_stride) {
  extern __shared__ float smem[];
  const int RK = rho * k;
  const int RKP = repro::padded_stride(RK);
  float* pc = smem;                 // RK
  float* es = pc + RK;              // rho
  float* qs = es + rho;             // tile * RKP
  float* sv = qs + tile * RKP;      // CH
  int* si = (int*)(sv + CH);        // CH

  const long long base = chunk * CH;
  for (int t = threadIdx.x; t < RK; t += blockDim.x) pc[t] = pc_row[t];
  for (int t = threadIdx.x; t < rho; t += blockDim.x) es[t] = e[t];

  for (int off = 0; off < CH; off += tile) {
    const int rows = min(tile, CH - off);
    __syncthreads();                // the previous tile is consumed
    repro::stage_rows(Q, base + off, rows, n, RK, RKP, qs);
    __syncthreads();
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      const long long i = base + off + t;
      float v = -CUDART_INF_F;      // past the end: below every real slot
      int id = INT_MAX;
      if (i < n) {
        v = kNegInf;
        if (valid == nullptr || valid[i] != 0)
          v = repro::slot_score(ac, aI[i], qs + t * RKP, pc, es, rho, k);
        id = (int)i;
      }
      sv[off + t] = v;
      si[off + t] = id;
    }
  }
  repro::bitonic_sort(sv, si, CH);
  write_list(sv, si, row, list, L, out_v, out_i, is_final, K, index_offset, index_stride);
}

// Stage 1: block (q, chunk) scores slots [chunk * CH, (chunk + 1) * CH) for
// query q, sorts them and keeps its best L.
__global__ void corpus_topk_chunks(const float* __restrict__ Q,
                                   const float* __restrict__ aI,
                                   const unsigned char* __restrict__ valid,
                                   const float* __restrict__ e,
                                   const float* __restrict__ PC,
                                   const float* __restrict__ aC, long long n,
                                   int rho, int k, int CH, int tile, int L,
                                   float* out_v, int* out_i, int is_final, int K,
                                   long long index_offset, long long index_stride) {
  const int q = blockIdx.x;
  const long long chunk = blockIdx.y;
  chunk_topk(Q, aI, valid, n, e, PC + (long long)q * rho * k, aC[q], rho, k, chunk, CH,
             tile, L, q, (long long)q * gridDim.y + chunk, out_v, out_i, is_final, K,
             index_offset, index_stride);
}

// The S slabs of a multi-tenant launch, by value in the kernel's parameters
// (S <= kMaxSegments; 2 KB of the 4 KB a launch may pass).
struct Segments {
  const float* Q[kMaxSegments];
  const float* aI[kMaxSegments];
  const unsigned char* valid[kMaxSegments];   // nullptr: every slot live
  long long n[kMaxSegments];
};

// Multi-tenant stage 1: block (row, chunk), row = s * Bq + q, does the
// single-slab block's work on chunk `chunk` of segment s alone.  A chunk
// past the end of a shorter segment writes a sentinel list instead.
__global__ void corpus_multi_topk_chunks(const __grid_constant__ Segments segs,
                                         const float* __restrict__ e,
                                         const float* __restrict__ PC,
                                         const float* __restrict__ aC, int Bq, int rho,
                                         int k, int CH, int tile, int L, float* out_v,
                                         int* out_i, int is_final, int K,
                                         long long index_offset,
                                         long long index_stride) {
  const int row = blockIdx.x;
  const int s = row / Bq;
  const long long chunk = blockIdx.y;
  const long long list = (long long)row * gridDim.y + chunk;
  const long long n = segs.n[s];
  if (chunk * CH >= n) {
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      out_v[list * L + t] = -CUDART_INF_F;
      out_i[list * L + t] = INT_MAX;
    }
    return;
  }
  chunk_topk(segs.Q[s], segs.aI[s], segs.valid[s], n, e + (long long)s * rho,
             PC + (long long)row * rho * k, aC[row], rho, k, chunk, CH, tile, L, row,
             list, out_v, out_i, is_final, K, index_offset, index_stride);
}

// Stage 2: block (q, group) merges lists [group * G, (group + 1) * G) of
// query row q into one list of the best L.
__device__ void merge_lists(const float* __restrict__ in_v, const int* __restrict__ in_i,
                            long long n_lists, int L, int G, float* out_v, int* out_i,
                            int is_final, int K, long long index_offset,
                            long long index_stride) {
  extern __shared__ float smem[];
  const int N = G * L;
  float* sv = smem;
  int* si = (int*)(sv + N);
  const long long q = blockIdx.x;
  const long long group = blockIdx.y;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    const long long list = group * G + t / L;
    if (list < n_lists) {
      const long long src = (q * n_lists + list) * L + (t % L);
      sv[t] = in_v[src];
      si[t] = in_i[src];
    } else {
      sv[t] = -CUDART_INF_F;
      si[t] = INT_MAX;
    }
  }
  repro::bitonic_sort(sv, si, N);
  write_list(sv, si, q, q * gridDim.y + group, L, out_v, out_i, is_final, K, index_offset,
             index_stride);
}

// The merge as two __global__ functions of one body, one per C entry, so
// that a launch count or a profile tells the single-slab top-K's merges
// from the multi-tenant top-K's.
__global__ void topk_merge(const float* __restrict__ in_v, const int* __restrict__ in_i,
                           long long n_lists, int L, int G, float* out_v, int* out_i,
                           int is_final, int K, long long index_offset,
                           long long index_stride) {
  merge_lists(in_v, in_i, n_lists, L, G, out_v, out_i, is_final, K, index_offset,
              index_stride);
}

__global__ void multi_topk_merge(const float* __restrict__ in_v,
                                 const int* __restrict__ in_i, long long n_lists, int L,
                                 int G, float* out_v, int* out_i, int is_final, int K,
                                 long long index_offset, long long index_stride) {
  merge_lists(in_v, in_i, n_lists, L, G, out_v, out_i, is_final, K, index_offset,
              index_stride);
}

using MergeKernel = void (*)(const float*, const int*, long long, int, int, float*, int*,
                             int, int, long long, long long);

int next_pow2(long long x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

struct TopkPlan {
  int L;               // list length: next_pow2(K)
  int CH;              // slots per stage-1 block (a power of two >= L)
  long long n_chunks;  // stage-1 lists per query
};

TopkPlan plan_topk(long long n, int K) {
  TopkPlan p;
  p.L = next_pow2(K);
  int ch = 16 * p.L;
  ch = ch < 4096 ? 4096 : (ch > kMaxSort ? kMaxSort : ch);
  const long long np2 = n < ch ? next_pow2(n) : ch;   // no longer than the slab needs
  p.CH = (int)(np2 < p.L ? p.L : np2);
  p.n_chunks = (n + p.CH - 1) / p.CH;
  return p;
}

int merge_group(long long n_lists, int L) {
  const int g = kMaxSort / L;
  const int np2 = next_pow2(n_lists);
  return g < np2 ? g : np2;
}

size_t chunk_smem(int rho, int k, int CH, int tile) {
  const int RK = rho * k;
  return (size_t)(RK + rho + tile * repro::padded_stride(RK) + 2 * CH) * sizeof(float);
}

// The stage-1 tile (rows of Q_I staged at a time): the largest that fits
// beside a CH-entry sort in shared memory; 0 when none does.
int chunk_tile(int rho, int k, int CH) {
  int tile = kTopkThreads;
  while (tile > 32 && chunk_smem(rho, k, CH, tile) > kMaxSmem) tile >>= 1;
  return chunk_smem(rho, k, CH, tile) > kMaxSmem ? 0 : tile;
}

// Stage 2: merge `rows` rows of n_lists lists each, from scratch region A,
// launched again until one list per row remains; the last round writes the
// final (rows, K) outputs.  Two scratch regions are used in turn: A holds
// the stage-1 lists, B the first merge's, A again the second's, and so on
// (each merge at least halves the list count).  Counts the launches in
// *launched.
cudaError_t merge_rounds(MergeKernel kernel, long long rows, long long n_lists, int L,
                         float* scratch_v, int* scratch_i, float* out_v, int* out_i, int K,
                         long long index_offset, long long index_stride,
                         cudaStream_t s, int* launched) {
  const long long region_a = rows * n_lists * L;
  float* bufs_v[2] = {scratch_v, scratch_v + region_a};
  int* bufs_i[2] = {scratch_i, scratch_i + region_a};
  int cur = 0;
  while (n_lists > 1) {
    const int G = merge_group(n_lists, L);
    const long long groups = (n_lists + G - 1) / G;
    const bool last = groups == 1;
    const size_t smem2 = (size_t)G * L * (sizeof(float) + sizeof(int));
    cudaError_t err = repro::allow_smem(kernel, smem2);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((unsigned)rows, (unsigned)groups), kMergeThreads, smem2, s>>>(
        bufs_v[cur], bufs_i[cur], n_lists, L, G, last ? out_v : bufs_v[1 - cur],
        last ? out_i : bufs_i[1 - cur], last ? 1 : 0, K, index_offset, index_stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    n_lists = groups;
    cur = 1 - cur;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int dplr_corpus_score_full(const float* Q, const float* aI, const unsigned char* valid,
                           const float* e, const float* PC, const float* aC, long long n,
                           int Bq, int rho, int k, float* out, void* stream, int device) {
  if (n <= 0 || Bq <= 0 || rho * k > kMaxRK) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int RK = rho * k;
  const size_t smem = (size_t)(kFullTile * repro::padded_stride(RK) + kFullQueries * RK +
                               rho + kFullQueries) * sizeof(float);
  err = repro::allow_smem(corpus_score_full, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + kFullTile - 1) / kFullTile),
                  (unsigned)((Bq + kFullQueries - 1) / kFullQueries));
  corpus_score_full<<<grid, kFullTile, smem, (cudaStream_t)stream>>>(Q, aI, valid, e, PC,
                                                                     aC, n, Bq, rho, k, out);
  return (int)cudaGetLastError();
}

// Scratch floats (and as many ints) dplr_corpus_topk needs; 0 when one
// stage-1 block covers the whole slab.
long long dplr_corpus_topk_scratch(long long n, int Bq, int K) {
  const TopkPlan p = plan_topk(n, K);
  if (p.n_chunks <= 1) return 0;
  return (long long)Bq * p.L * (p.n_chunks + (p.n_chunks + 1) / 2);
}

int dplr_corpus_topk_max_k() { return kMaxTopK; }

// Writes the launches it made to launched[0] (corpus_topk_chunks: 0 or 1)
// and launched[1] (topk_merge: 0 or more, by the number of stage-1 lists).

int dplr_corpus_topk(const float* Q, const float* aI, const unsigned char* valid,
                     const float* e, const float* PC, const float* aC, long long n, int Bq,
                     int rho, int k, int K, long long index_offset, long long index_stride,
                     float* scratch_v, int* scratch_i, float* out_v, int* out_i,
                     int* launched, void* stream, int device) {
  launched[0] = launched[1] = 0;
  if (n <= 0 || Bq <= 0 || K <= 0 || K > kMaxTopK || K > n || rho * k > kMaxRK)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const TopkPlan p = plan_topk(n, K);
  if (p.n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const int tile = chunk_tile(rho, k, p.CH);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t smem1 = chunk_smem(rho, k, p.CH, tile);
  err = repro::allow_smem(corpus_topk_chunks, smem1);
  if (err != cudaSuccess) return (int)err;

  const bool one_chunk = p.n_chunks == 1;
  corpus_topk_chunks<<<dim3((unsigned)Bq, (unsigned)p.n_chunks), kTopkThreads, smem1, s>>>(
      Q, aI, valid, e, PC, aC, n, rho, k, p.CH, tile, p.L,
      one_chunk ? out_v : scratch_v, one_chunk ? out_i : scratch_i, one_chunk ? 1 : 0, K,
      index_offset, index_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  return (int)merge_rounds(topk_merge, Bq, p.n_chunks, p.L, scratch_v, scratch_i, out_v,
                           out_i, K, index_offset, index_stride, s, launched + 1);
}

// The masked top-K of S segments in one launch: row s * Bq + q of the
// (S * Bq, K) outputs is query q of segment s against segment s's slab
// (Q[s] (n[s], rho, k), aI[s], valid[s] or nullptr) with eigenvalues
// e[s * rho ...], ids segment-local and relabeled.  Scratch: as many as
// dplr_corpus_topk_scratch(max n, S * Bq, K) gives.  Writes the launches
// it made to launched[0] (corpus_multi_topk_chunks) and launched[1]
// (multi_topk_merge).
int dplr_corpus_multi_topk(int S, const float* const* Q, const float* const* aI,
                           const unsigned char* const* valid, const long long* n,
                           const float* e, const float* PC, const float* aC, int Bq,
                           int rho, int k, int K, long long index_offset,
                           long long index_stride, float* scratch_v, int* scratch_i,
                           float* out_v, int* out_i, int* launched, void* stream,
                           int device) {
  launched[0] = launched[1] = 0;
  if (S <= 0 || S > kMaxSegments || Bq <= 0 || K <= 0 || K > kMaxTopK ||
      rho * k > kMaxRK || (long long)S * Bq > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Segments segs;
  long long n_max = 0;
  for (int j = 0; j < kMaxSegments; ++j) {
    const bool in = j < S;
    segs.Q[j] = in ? Q[j] : nullptr;
    segs.aI[j] = in ? aI[j] : nullptr;
    segs.valid[j] = in && valid != nullptr ? valid[j] : nullptr;
    segs.n[j] = in ? n[j] : 0;
    if (in && n[j] < K) return (int)cudaErrorInvalidValue;
    if (in && n[j] > n_max) n_max = n[j];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const TopkPlan p = plan_topk(n_max, K);
  if (p.n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const int tile = chunk_tile(rho, k, p.CH);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t smem1 = chunk_smem(rho, k, p.CH, tile);
  err = repro::allow_smem(corpus_multi_topk_chunks, smem1);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)S * Bq;
  const bool one_chunk = p.n_chunks == 1;
  corpus_multi_topk_chunks<<<dim3((unsigned)rows, (unsigned)p.n_chunks), kTopkThreads,
                             smem1, s>>>(
      segs, e, PC, aC, Bq, rho, k, p.CH, tile, p.L, one_chunk ? out_v : scratch_v,
      one_chunk ? out_i : scratch_i, one_chunk ? 1 : 0, K, index_offset, index_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  return (int)merge_rounds(multi_topk_merge, rows, p.n_chunks, p.L, scratch_v, scratch_i,
                           out_v, out_i, K, index_offset, index_stride, s, launched + 1);
}

}  // extern "C"
