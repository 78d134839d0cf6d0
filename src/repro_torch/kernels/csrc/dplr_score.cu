// Algorithm 1's per-item DPLR-FwFM score over raw item embeddings, for a
// batch of queries at once:
//
//   P[q, i]   = P_C[q] + U_I V_I[q, i]                        (rho, k)
//   out[q, i] = 0.5 * ((s_C[q] + sum_m d_m ||v_m||^2) + sum_r e_r ||P_r||^2)
//
// Replaces the Pallas TPU kernel src/repro/kernels/dplr_score.py,
// dplr_score_items() (_kernel), which scores one query; here one launch
// scores a whole (Bq, n) batch, any Bq >= 1, where the JAX package vmaps
// the per-query kernel.
//
// What bounds it on an H100: memory.  Each (query, item) reads m_I * k * 4
// bytes of V_I (2432 B at m_I = 38, k = 16; half that in bf16) for about
// (2 + 2 rho) * m_I * k flops, well under the card's f32 rate per byte.
//
// Types: V_I is float or bf16 (the serving checkpoint's type), read as
// stored into shared memory and upcast in registers; the small operands
// (U_I, e, d_I, P_C, s_C) arrive in f32, upcast by the caller.  After the
// upcast, which is exact, the arithmetic is the float kernel's, so a bf16
// V_I scores bitwise as its upcast f32 copy (the Pallas kernel squares a
// bf16 V in bf16; here every product is f32).
//
// What the design does about it.  A block, one warp, walks tiles of T items
// of one query ((query, tile) pairs flattened, a grid of at most one wave
// of blocks, 5 blocks an SM at the serving shape), each tile's V_I
// (T m_I k 4 contiguous bytes) copied into shared memory by bulk copies
// (cp.async.bulk, one an item, issued by the warp's lanes together)
// completed on an mbarrier, through a ring of 2 stages: one is scored
// while the other loads.  Items sit in padded slots, stride congruent to kp mod 32 floats
// (kp = k rounded up to 4): an item row is 608 floats at m_I = 38, k = 16,
// a multiple of 32, so unpadded rows would put every item's field on the
// same banks (in bf16, a slot stride congruent to kp mod 64 elements does
// the same for the 8-byte reads of 4 columns).  Where V_I is not 16-byte
// aligned or a field row is not a whole number of 16-byte pieces (k % 4 != 0
// in f32, k % 8 != 0 in bf16), the threads stage each tile with plain loads
// of one element into the same layout (k padded with zeros), in the same
// kernel: a bf16 view 2 bytes off any 4-byte boundary takes that path.  Items whose m_I k floats exceed a stage go
// through in chunks of fields, P carried across them in registers.
//
// g threads share an item, each owning a 4-row by 4-column block of P in
// registers (rows 4 rg.., columns 4 cq..; g = ceil(rho / 4) * kp / 4,
// rounded up to a power of two, at most 32 since rho * k <= kMaxRK).  Per
// field it reads its 4 columns as one 16-byte load and U_I's 4 rows as a
// 16-byte broadcast, and adds d_m v^2 (row block 0 only); then the g
// partial d- and e-terms are summed by shuffles in a fixed tree.
//
// Sums over fields are blocked: the products of each run of G.FB fields
// (field indices b * G.FB.. of the item, whatever chunk they arrive in)
// go into partial sums that start from 0, and each block's
// partials are added into P and the d-term when the block ends, with the
// rounding error of that addition carried to the next block (Kahan's
// compensated sum; P's 16 carries a thread sit in shared memory, touched
// once a block, so that the registers do not spill).  One running sum over all m_I fields would grow its
// rounding error with m_I (at m_I = 200 it sat 2.6x the plain version's
// distance from an f64 version); the blocks keep every sum short, and the
// compensation keeps the sum of blocks close to exact.  Up to
// kOneBlockFields item fields (the served shapes: 38) the whole item is
// one block, whose running sum is as close as the plain version's and
// costs no block ends; past it, blocks of kFieldBlock.  Each score's operations
// and their order depend only on (m_I, k, rho), never on Bq, n or the
// tile, so every row of a batched call is bitwise the per-query call.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::kMaxRK;

constexpr int kThreads = 32;   // one warp a block
constexpr int kStages = 2;
constexpr int kStageBytes = 98304;   // 96 KB a stage at most
constexpr int kUFloats = 8192;       // U_I's chunk, 32 KB at most
constexpr int kFieldBlock = 8;       // fields a partial sum spans past kOneBlockFields
constexpr int kOneBlockFields = 48;  // up to this m_I, one block of all fields

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// sum += x, with the addition's rounding error kept in carry (as its
// negative) and taken off the next term: Kahan's compensated sum.
__device__ inline void kahan_add(float& sum, float& carry, float x) {
  const float y = __fsub_rn(x, carry);
  const float t = __fadd_rn(sum, y);
  carry = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// Elements from one item's slot to the next: at least `width`, congruent
// to kp mod `banks` (the elements of T in 32 banks of 4 bytes).
__host__ __device__ inline int slot_stride(int width, int kp, int banks) {
  return width + ((kp - width) % banks + banks) % banks;
}

// How (m_I, rho, k) maps onto the block for V_I of `elem` bytes an entry:
// lanes an item (g used of gp), items a tile (T), fields a chunk (FC) and
// the slot stride in elements (S).  All but FC and S are the same for both
// types, and the arithmetic depends on none of them.
struct Geometry {
  int kp, kq, rhop, g, gp, T, FC, S, FB;
};

__host__ __device__ inline Geometry geometry(int mI, int rho, int k, int elem) {
  Geometry G;
  G.kp = round4(k);
  G.kq = G.kp / 4;
  G.rhop = round4(rho);
  G.g = G.rhop / 4 * G.kq;
  G.gp = 1;
  while (G.gp < G.g) G.gp *= 2;
  G.T = kThreads / G.gp;
  const int banks = 128 / elem;
  int fc = (kStageBytes / elem / G.T - banks) / G.kp;
  const int fu = kUFloats / (G.rhop + 1);
  fc = fc < fu ? fc : fu;
  fc = fc < mI ? fc : mI;
  G.FC = fc > 1 ? fc : 1;
  G.S = slot_stride(G.FC * G.kp, G.kp, banks);
  G.FB = mI <= kOneBlockFields ? (mI > 1 ? mI : 1) : kFieldBlock;
  return G;
}

// Bytes of the stages, rounded up to 16 (the floats after them are read 16
// bytes at a time).
__host__ __device__ inline size_t stage_bytes(const Geometry& G, int elem) {
  return ((size_t)kStages * G.T * G.S * elem + 15) & ~(size_t)15;
}

__host__ __device__ inline size_t smem_bytes(const Geometry& G, int elem) {
  return 16 + stage_bytes(G, elem) +
         ((size_t)G.FC * (G.rhop + 1) + G.rhop + 16 * kThreads) * sizeof(float);
}

// 4 consecutive entries of a staged row as f32 (16 bytes of floats, or 8 of
// bf16, the row 8-byte aligned).
__device__ inline float4 load4(const float* x) { return *reinterpret_cast<const float4*>(x); }
__device__ inline float4 load4(const __nv_bfloat16* x) {
  const uint2 w = *reinterpret_cast<const uint2*>(x);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    dplr_score_items_kernel(const T* __restrict__ V, const float* __restrict__ U,
                            const float* __restrict__ e, const float* __restrict__ d,
                            const float* __restrict__ PC, const float* __restrict__ sC,
                            long long n, int Bq, int mI, int rho, int k, int bulk,
                            float* __restrict__ out) {
  const Geometry G = geometry(mI, rho, k, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  T* stages = reinterpret_cast<T*>(smem_raw + 16);           // kStages * T * S
  float* us = reinterpret_cast<float*>(smem_raw + 16 + stage_bytes(G, sizeof(T)));
                                                             // FC * rhop: us[f * rhop + r]
  float* ds = us + G.FC * G.rhop;                            // FC
  float* es = ds + G.FC;                                     // rhop
  float* pc = es + G.rhop + threadIdx.x;  // this thread's carries of P, stride kThreads

  const int n_fc = (mI + G.FC - 1) / G.FC > 1 ? (mI + G.FC - 1) / G.FC : 1;
  const long long tiles_q = (n + G.T - 1) / G.T;
  const long long n_tiles = tiles_q * Bq;
  // Unit v of this block: chunk v % n_fc of tile blockIdx.x + (v / n_fc) * gridDim.x.
  const long long n_units =
      blockIdx.x < n_tiles ? ((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) * n_fc : 0;
  auto unit_tile = [&](long long v) { return blockIdx.x + v / n_fc * gridDim.x; };
  auto unit_items = [&](long long tile, long long* first) {
    const long long q = tile / tiles_q, i0 = tile % tiles_q * G.T;
    *first = q * n + i0;
    return (int)(n - i0 < G.T ? n - i0 : G.T);
  };
  auto unit_fields = [&](long long v, int* f0) {
    *f0 = (int)(v % n_fc) * G.FC;
    return mI - *f0 < G.FC ? mI - *f0 : G.FC;
  };
  // The warp issues a unit's copies, one an item a lane, all on the stage's
  // barrier (lane 0 announces their bytes first).
  auto issue = [&](long long v, int s) {
    long long first;
    const int nv = unit_items(unit_tile(v), &first);
    int f0;
    const uint32_t bytes = (uint32_t)(unit_fields(v, &f0) * k) * (uint32_t)sizeof(T);
    const uint32_t bar = hopper::smem_addr(&full[s]);
    if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, bytes * nv);
    __syncwarp();
    T* dst = stages + s * G.T * G.S;
    for (int it = threadIdx.x; it < nv; it += kThreads)
      hopper::bulk_load(hopper::smem_addr(dst + it * G.S), V + ((first + it) * mI + f0) * k,
                        bytes, bar);
  };
  auto load_u = [&](int f0, int fc) {
    for (int t = threadIdx.x; t < fc * G.rhop; t += kThreads) {
      const int f = t / G.rhop, r = t - f * G.rhop;
      us[t] = r < rho ? U[r * mI + f0 + f] : 0.f;
    }
    for (int t = threadIdx.x; t < fc; t += kThreads) ds[t] = d[f0 + t];
  };
  if (bulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) hopper::mbar_init(hopper::smem_addr(&full[s]), 1);
      hopper::mbar_init_fence();
    }
    __syncwarp();
    for (int s = 0; s < kStages && s < n_units; ++s) issue(s, s);
  }
  for (int t = threadIdx.x; t < G.rhop; t += kThreads) es[t] = t < rho ? e[t] : 0.f;
  if (n_fc == 1) load_u(0, mI);
  __syncthreads();

  // This thread's item slot and block of P (lanes li >= g hold zeros).
  const int it = threadIdx.x / G.gp, li = threadIdx.x % G.gp;
  const bool active = li < G.g;
  const int rg = active ? li / G.kq : 0, cq = active ? li % G.kq : 0;
  float P[4][4], Pb[4][4];  // P: the sum of blocks, Pb: a block
  float td = 0.f, tdb = 0.f, tdc = 0.f;
  long long q = 0, item = 0;
  int nv = 0;
  for (long long v = 0; v < n_units; ++v) {
    const int s = (int)(v % kStages);
    const long long tile = unit_tile(v);
    int f0;
    const int fc = unit_fields(v, &f0);
    if (f0 == 0) {  // a new tile: P starts from P_C[q]
      long long first;
      nv = unit_items(tile, &first);
      q = tile / tiles_q;
      item = first + it;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = 4 * rg + rr, col = 4 * cq + c;
          P[rr][c] = active && r < rho && col < k ? PC[(q * rho + r) * k + col] : 0.f;
          Pb[rr][c] = 0.f;
          pc[(4 * rr + c) * kThreads] = 0.f;
        }
      td = tdb = tdc = 0.f;
    }
    if (n_fc > 1) {
      load_u(f0, fc);
      __syncthreads();
    }
    T* X = stages + s * G.T * G.S;
    if (bulk) {
      hopper::mbar_wait(hopper::smem_addr(&full[s]), (uint32_t)(v / kStages) & 1);
    } else {
      long long first;
      const int items = unit_items(tile, &first);
      const int per = fc * G.kp;
      for (int t = threadIdx.x; t < items * per; t += kThreads) {
        const int b = t / per, r = t - b * per, f = r / G.kp, c = r - f * G.kp;
        X[b * G.S + r] = c < k ? __ldg(V + ((first + b) * mI + f0 + f) * k + c) : T{};
      }
      __syncthreads();
    }

    if (active) {
      const T* x = X + it * G.S + 4 * cq;
      const float* u = us + 4 * rg;
      // the chunk's fields, cut where a block of G.FB item fields ends
      for (int fb = 0; fb < fc;) {
        const int gend = ((f0 + fb) / G.FB + 1) * G.FB;
        const int fe = gend - f0 < fc ? gend - f0 : fc;
#pragma unroll 4
        for (int f = fb; f < fe; ++f) {
          const float4 xv = load4(x + f * G.kp);
          const float4 uv = *reinterpret_cast<const float4*>(u + f * G.rhop);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
          const float ur[4] = {uv.x, uv.y, uv.z, uv.w};
          if (rg == 0) {
            const float dm = ds[f];
#pragma unroll
            for (int c = 0; c < 4; ++c) tdb = fmaf(dm * xs[c], xs[c], tdb);
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int c = 0; c < 4; ++c) Pb[rr][c] = fmaf(ur[rr], xs[c], Pb[rr][c]);
        }
        if (f0 + fe == gend || f0 + fe == mI) {  // a block ends: add its partials
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float carry = pc[(4 * rr + c) * kThreads];
              kahan_add(P[rr][c], carry, Pb[rr][c]);
              pc[(4 * rr + c) * kThreads] = carry;
              Pb[rr][c] = 0.f;
            }
          kahan_add(td, tdc, tdb);
          tdb = 0.f;
        }
        fb = fe;
      }
    }
    __syncthreads();  // the stage (and U_I's chunk) are read
    if (bulk && v + kStages < n_units) issue(v + kStages, s);

    if (f0 + fc == mI) {  // the tile's last chunk: finish its scores
      float te = 0.f;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float sq = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float pv = __fsub_rn(P[rr][c], pc[(4 * rr + c) * kThreads]);  // carry off
          sq = fmaf(pv, pv, sq);
        }
        te = fmaf(es[4 * rg + rr], sq, te);
      }
      td = __fsub_rn(td, tdc);
      for (int o = 1; o < G.gp; o *= 2) {
        td += __shfl_xor_sync(0xffffffffu, td, o);
        te += __shfl_xor_sync(0xffffffffu, te, o);
      }
      if (li == 0 && it < nv) out[item] = 0.5f * ((sC[q] + td) + te);
    }
  }
}

template <class T>
cudaError_t launch_items(const T* V, const float* U, const float* e, const float* d,
                         const float* PC, const float* sC, long long n, int Bq, int mI,
                         int rho, int k, float* out, cudaStream_t stream, int device) {
  const Geometry G = geometry(mI, rho, k, sizeof(T));
  const size_t smem = smem_bytes(G, sizeof(T));
  cudaError_t err = repro::allow_smem(dplr_score_items_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  long long most = 0;
  err = repro::one_wave(dplr_score_items_kernel<T>, kThreads, smem, device, &most);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + G.T - 1) / G.T * Bq;
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  // bulk copies move whole 16-byte pieces between 16-byte aligned places
  const int bulk = k % (16 / (int)sizeof(T)) == 0 && (uintptr_t)V % 16 == 0;
  dplr_score_items_kernel<T><<<grid, kThreads, smem, stream>>>(V, U, e, d, PC, sC, n, Bq, mI,
                                                                rho, k, bulk, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// V: (Bq, n, m_I, k) float (dtype = 0) or bf16 (dtype = 1); the rest f32.
int dplr_score_items(const void* V, int dtype, const float* U, const float* e, const float* d,
                     const float* PC, const float* sC, long long n, int Bq, int mI, int rho,
                     int k, float* out, void* stream, int device) {
  if (n <= 0 || Bq <= 0 || mI < 0 || rho <= 0 || k <= 0 || rho * k > kMaxRK ||
      (dtype != repro::kF32 && dtype != repro::kBF16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kBF16)
    return (int)launch_items(static_cast<const __nv_bfloat16*>(V), U, e, d, PC, sC, n, Bq, mI,
                             rho, k, out, s, device);
  return (int)launch_items(static_cast<const float*>(V), U, e, d, PC, sC, n, Bq, mI, rho, k,
                           out, s, device);
}

// Items a tile holds at (m_I, rho, k), as the launch above cuts them (the
// same for both types); 0 where the launch refuses the shape.
int dplr_score_items_tile(int mI, int rho, int k) {
  if (mI < 0 || rho <= 0 || k <= 0 || rho * k > kMaxRK) return 0;
  return geometry(mI, rho, k, sizeof(float)).T;
}

}  // extern "C"
