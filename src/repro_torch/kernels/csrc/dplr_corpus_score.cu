// Corpus-cached DPLR-FwFM scoring against a capacity-padded item slab, in
// two modes: the full (Bq, n) score matrix, and a masked top-K per query.
//
//   s[q, i] = (a_C[q] + a_I[i]) + 0.5 * sum_r e_r ||P_C[q, r] + Q_I[i, r]||^2
//   s[q, i] = -1e30 where valid[i] == 0
//
// Replaces the Pallas TPU kernel src/repro/kernels/dplr_corpus_score.py,
// dplr_corpus_score(): _kernel_full (topk=None) and _kernel_topk (topk=K).
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
    if (live)
      s = (ac[j] + ai) + 0.5f * repro::eigen_square_sum(q, pc + j * RK, es, rho, k);
    out[(long long)(q0 + j) * n + i] = s;
  }
}

// Writes the block's sorted list: the first K entries, relabeled, to the
// final (Bq, K) outputs, or all L entries to the scratch list `list`.
__device__ void write_list(const float* sv, const int* si, int q, long long list,
                           int L, float* out_v, int* out_i, int is_final, int K,
                           long long index_offset, long long index_stride) {
  if (is_final) {
    for (int t = threadIdx.x; t < K; t += blockDim.x) {
      out_v[(long long)q * K + t] = sv[t];
      out_i[(long long)q * K + t] = (int)(index_offset + index_stride * (long long)si[t]);
    }
  } else {
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      out_v[list * L + t] = sv[t];
      out_i[list * L + t] = si[t];
    }
  }
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
  extern __shared__ float smem[];
  const int RK = rho * k;
  const int RKP = repro::padded_stride(RK);
  float* pc = smem;                 // RK
  float* es = pc + RK;              // rho
  float* qs = es + rho;             // tile * RKP
  float* sv = qs + tile * RKP;      // CH
  int* si = (int*)(sv + CH);        // CH

  const int q = blockIdx.x;
  const long long chunk = blockIdx.y;
  const long long base = chunk * CH;
  for (int t = threadIdx.x; t < RK; t += blockDim.x) pc[t] = PC[(long long)q * RK + t];
  for (int t = threadIdx.x; t < rho; t += blockDim.x) es[t] = e[t];
  const float ac = aC[q];

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
          v = (ac + aI[i]) + 0.5f * repro::eigen_square_sum(qs + t * RKP, pc, es, rho, k);
        id = (int)i;
      }
      sv[off + t] = v;
      si[off + t] = id;
    }
  }
  repro::bitonic_sort(sv, si, CH);
  write_list(sv, si, q, (long long)q * gridDim.y + chunk, L, out_v, out_i, is_final,
             K, index_offset, index_stride);
}

// Stage 2: block (q, group) merges lists [group * G, (group + 1) * G) of
// query q into one list of the best L.
__global__ void topk_merge(const float* __restrict__ in_v, const int* __restrict__ in_i,
                           long long n_lists, int L, int G, float* out_v, int* out_i,
                           int is_final, int K, long long index_offset,
                           long long index_stride) {
  extern __shared__ float smem[];
  const int N = G * L;
  float* sv = smem;
  int* si = (int*)(sv + N);
  const int q = blockIdx.x;
  const long long group = blockIdx.y;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    const long long list = group * G + t / L;
    if (list < n_lists) {
      const long long src = ((long long)q * n_lists + list) * L + (t % L);
      sv[t] = in_v[src];
      si[t] = in_i[src];
    } else {
      sv[t] = -CUDART_INF_F;
      si[t] = INT_MAX;
    }
  }
  repro::bitonic_sort(sv, si, N);
  write_list(sv, si, q, (long long)q * gridDim.y + group, L, out_v, out_i, is_final, K,
             index_offset, index_stride);
}

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

  int tile = kTopkThreads;
  while (tile > 32 && chunk_smem(rho, k, p.CH, tile) > kMaxSmem) tile >>= 1;
  const size_t smem1 = chunk_smem(rho, k, p.CH, tile);
  if (smem1 > kMaxSmem) return (int)cudaErrorInvalidValue;
  err = repro::allow_smem(corpus_topk_chunks, smem1);
  if (err != cudaSuccess) return (int)err;

  // Two scratch regions used in turn: A holds the stage-1 lists, B the
  // first merge's, A again the second's, and so on (each merge at least
  // halves the list count).
  const long long region_a = (long long)Bq * p.n_chunks * p.L;
  float* bufs_v[2] = {scratch_v, scratch_v + region_a};
  int* bufs_i[2] = {scratch_i, scratch_i + region_a};

  const bool one_chunk = p.n_chunks == 1;
  corpus_topk_chunks<<<dim3((unsigned)Bq, (unsigned)p.n_chunks), kTopkThreads, smem1, s>>>(
      Q, aI, valid, e, PC, aC, n, rho, k, p.CH, tile, p.L,
      one_chunk ? out_v : bufs_v[0], one_chunk ? out_i : bufs_i[0], one_chunk ? 1 : 0, K,
      index_offset, index_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  if (one_chunk) return (int)cudaSuccess;

  long long n_lists = p.n_chunks;
  int cur = 0;
  while (n_lists > 1) {
    const int G = merge_group(n_lists, p.L);
    const long long groups = (n_lists + G - 1) / G;
    const bool last = groups == 1;
    const size_t smem2 = (size_t)G * p.L * (sizeof(float) + sizeof(int));
    err = repro::allow_smem(topk_merge, smem2);
    if (err != cudaSuccess) return (int)err;
    topk_merge<<<dim3((unsigned)Bq, (unsigned)groups), kMergeThreads, smem2, s>>>(
        bufs_v[cur], bufs_i[cur], n_lists, p.L, G, last ? out_v : bufs_v[1 - cur],
        last ? out_i : bufs_i[1 - cur], last ? 1 : 0, K, index_offset, index_stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++launched[1];
    n_lists = groups;
    cur = 1 - cur;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
