// Causal grouped-query attention with an optional sliding window, forward,
// as a streaming softmax:
//
//   out[b, i, h] = sum_{j in span(i)} softmax_j(<q[b, i, h], k[b, j, h / G]> / sqrt(hd))
//                  * v[b, j, h / G]
//   span(i) = {j : j <= i and (window == 0 or j > i - window)}
//
// q, out (B, Sq, H, hd); k, v (B, S, KV, hd); G = H / KV.  Query row r sits
// at position i = q_off + r (q_off + Sq <= S): 0 for a whole sequence, the
// first row's position for a block of rows (the LM plan's query rows split
// over a mesh's model axis).  bf16 (the model's compute type) or f32 (for
// parity checks), scores, running max and sum in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention() (_kernel): grid (B, KV, q blocks, kv blocks), the kv
// blocks in order on one core with (max, sum, accumulator) carried in VMEM
// scratch, kv blocks outside the causal or window span skipped.  It rounds
// where that kernel rounds: scores in f32 times 1/sqrt(hd), masked scores
// set to -1e30, p = exp(s - m) cast to v's type before the PV product with
// f32 sums, the accumulator divided by max(l, 1e-30) and cast to q's type.
// (The Hopper path masks with -inf: a key masked for a row then weighs 0
// at once, where -1e30 gives it weight 1 until the row's first visible key
// scales it by exactly 0, so the outputs are the same.)
//
// What bounds it on an H100 in bf16: tensor-core operations.  A global
// layer of gemma3-1b at S = 32,752 needs 4 hd S (S + 1) / 2 flops a head,
// 2.2 TFLOP a sequence, against 0.17 GB of q, k, v and out; a windowed
// layer (W = 1024) ~0.14 TFLOP.  Two more limits sit close under it: k and
// v come from L2 once per block at 128 flops a byte (128 rows a block),
// ~34 GB a global layer at B = 2; and at hd = 256 shared memory carries,
// per 64 x 64 consumer tile, 64 KB of wgmma reads for S = Q K^T (both
// operands from shared memory), 32 KB for P V and 32 KB of TMA writes:
// 128 KB per 4.2 MFLOP, as many 128-byte shared-memory clocks as the
// tensor cores take for the flops.
//
// What the design does about it:
//  * bf16 at hd in {64, 128, 256} (flash_attention_wgmma): a block owns
//    128 rows, 128 / G query positions times the G query heads of one kv
//    head (the GQA fold of the Pallas wrapper), so each k and v byte staged
//    serves 128 rows.  The sequential kv grid axis of the TPU kernel
//    becomes a loop inside the block, from the first tile the window
//    reaches to the diagonal: the work is ~S W on windowed layers and
//    ~S^2 / 2 on global ones.  Blocks are issued heaviest (last query
//    tile) first.  Three warpgroups: a producer, whose thread 0 loads Q
//    once and K, V tiles (64 keys at hd = 256, 128 below) through a
//    two-stage ring by TMA (rank-4 tensor maps, so a tile never reads past
//    its sequence: rows past S load as zeros), each stage guarded by
//    full and empty mbarriers for K and for V; and two consumers of 64
//    rows.  A consumer runs S = Q K^T as wgmma m64nNk16 with both operands
//    in 128-byte-swizzled shared memory, the streaming softmax in
//    registers (masked only on tiles that cross the diagonal, the window's
//    edge or S), then O += P V as wgmma with P in registers (the S
//    accumulator layout is the A-fragment layout) and V read MN-major
//    through the transpose bit; the 64 x hd f32 O accumulator stays in
//    registers.  setmaxnreg moves registers from the producer (24) to the
//    consumers (240).  K is released as soon as S is done, so the producer
//    refills it while the consumer still works on V; the two consumers
//    overlap each other's softmax with their products.  The softmax runs
//    in base 2, with log2 e folded into the scale (__expf is ex2.approx
//    already).
//  * bf16 at hd in {16, 32} (flash_attention_kernel): 64 rows a block, 4
//    warps of 16 rows on mma.sync.m16n8k16 with ldmatrix from padded
//    shared memory, loads staged by all threads.
//  * f32 (parity checks only): the same tiling on the CUDA cores, 256
//    threads, 32-key tiles; no tensor cores, so no TF32.
//  * Any S: the ragged last tiles are masked in the kernel; rows past Sq are
//    never written.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;         // rows (position, head) of a block
constexpr int kKeysBf16 = 64;     // keys a tile, bf16
constexpr int kKeysF32 = 32;      // keys a tile, f32
constexpr int kThreadsBf16 = 128;
constexpr int kThreadsF32 = 256;
constexpr int kMaxHdF32 = 256;

struct Shape {
  int S, H, KV, G, pos_per_block, window;   // S: keys
  float scale;
  int Sq, q_off;                            // query rows, the position of row 0
};

// A block's first query row and the positions [q_lo, q_hi] of its rows.
struct BlockRows {
  int r_lo, q_lo, q_hi;
};

__device__ inline BlockRows block_rows(const Shape& sh) {
  const int r_lo = (gridDim.x - 1 - blockIdx.x) * sh.pos_per_block;
  return {r_lo, sh.q_off + r_lo, sh.q_off + min(r_lo + sh.pos_per_block, sh.Sq) - 1};
}

// The keys [k_first, k_last] a block of query positions [q_lo, q_hi] needs.
__device__ inline void key_span(const Shape& sh, int q_lo, int q_hi, int keys_per_tile,
                                int* t_first, int* t_last) {
  const int k_first = sh.window > 0 ? max(0, q_lo - sh.window + 1) : 0;
  *t_first = k_first / keys_per_tile;
  *t_last = q_hi / keys_per_tile;
}

__device__ inline bool visible(const Shape& sh, int qpos, int kpos) {
  return kpos < sh.S && kpos <= qpos && (sh.window <= 0 || kpos > qpos - sh.window);
}

// ---------------------------------------------------------------- bf16 ----

__device__ inline void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Stage `rows` rows of hd elements (T: 16 bytes = `per16` elements) into
// shared memory with row stride `stride` elements; row r comes from `src(r)`
// or is zero when src(r) is null.
template <typename T, int kThreads, typename Src>
__device__ inline void stage(T* dst, int rows, int hd, int stride, Src src) {
  constexpr int per16 = 16 / sizeof(T);
  const int chunks = hd / per16;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    const T* row = src(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row != nullptr) val = __ldg(reinterpret_cast<const uint4*>(row) + c);
    *reinterpret_cast<uint4*>(dst + r * stride + c * per16) = val;
  }
}

template <int HD>
__device__ void attend_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            const Shape& sh) {
  constexpr int kStride = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * kStride;
  __nv_bfloat16* vs = ks + kKeysBf16 * kStride;

  const int b = blockIdx.z, kvh = blockIdx.y;
  const BlockRows br = block_rows(sh);
  const int q_lo = br.q_lo, q_hi = br.q_hi;
  const int rows_used = sh.pos_per_block * sh.G;
  const long long seq = (long long)b * sh.S, qseq = (long long)b * sh.Sq;

  stage<__nv_bfloat16, kThreadsBf16>(qs, kRows, HD, kStride, [&](int r) {
    const int row = br.r_lo + r / sh.G;
    return (r < rows_used && row < sh.Sq)
               ? q + ((qseq + row) * sh.H + kvh * sh.G + r % sh.G) * HD
               : nullptr;
  });

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this lane's two rows: warp * 16 + g and + 8
  int qpos[2];
  bool row_ok[2];
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    qpos[i] = q_lo + r / sh.G;
    row_ok[i] = r < rows_used && br.r_lo + r / sh.G < sh.Sq;
  }
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {repro::kNegInf, repro::kNegInf}, l[2] = {0.f, 0.f};

  // ldmatrix lane addressing: matrix mi = lane / 8, row lane % 8 within it
  const int mi = lane >> 3, mr = lane & 7;
  int t_first, t_last;
  key_span(sh, q_lo, q_hi, kKeysBf16, &t_first, &t_last);
  for (int tile = t_first; tile <= t_last; ++tile) {
    const int k0 = tile * kKeysBf16;
    __syncthreads();  // the last tile's reads of ks and vs are done
    auto kv_row = [&](const __nv_bfloat16* base) {
      return [=](int r) {
        const int pos = k0 + r;
        return pos < sh.S ? base + ((seq + pos) * sh.KV + kvh) * HD : nullptr;
      };
    };
    stage<__nv_bfloat16, kThreadsBf16>(ks, kKeysBf16, HD, kStride, kv_row(k));
    stage<__nv_bfloat16, kThreadsBf16>(vs, kKeysBf16, HD, kStride, kv_row(v));
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (warp * 16 + (mi & 1) * 8 + mr) * kStride + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + ((n + (mi >> 1)) * 8 + mr) * kStride + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[n], a, bk[0], bk[1]);
        mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, running max and sum (rows g: entries 0-1, g + 8: 2-3)
    float tmax[2] = {repro::kNegInf, repro::kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const float x = s[n][e] * sh.scale;
        s[n][e] = (row_ok[i] && visible(sh, qpos[i], kpos)) ? x : repro::kNegInf;
        tmax[i] = fmaxf(tmax[i], s[n][e]);
      }
    }
    float alpha[2], tsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m[e >> 1]);
        tsum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tsum[i] += __shfl_xor_sync(0xffffffffu, tsum[i], 1);
      tsum[i] += __shfl_xor_sync(0xffffffffu, tsum[i], 2);
      l[i] = l[i] * alpha[i] + tsum[i];
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P (16 x 64) from the score fragments, rounded to bf16
#pragma unroll
    for (int kc = 0; kc < kKeysBf16 / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kc * 16 + (mi & 1) * 8 + mr) * kStride + (j + (mi >> 1)) * 8);
        mma_bf16(o[j], a, bv[0], bv[1]);
        mma_bf16(o[j + 1], a, bv[2], bv[3]);
      }
    }
  }

  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int r = warp * 16 + g + 8 * i;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* dst =
        out + ((qseq + qpos[i] - sh.q_off) * sh.H + kvh * sh.G + r % sh.G) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2 * i] * inv_l, o[j][2 * i + 1] * inv_l);
    }
  }
}

// ----------------------------------------------------------------- f32 ----

__device__ void attend_f32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int hd,
                           const Shape& sh) {
  const int stride = hd + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kRows * stride;
  float* vs = ks + kKeysF32 * stride;
  float* ps = vs + kKeysF32 * stride;          // kRows x (kKeysF32 + 1)
  float* alpha_s = ps + kRows * (kKeysF32 + 1);
  float* l_s = alpha_s + kRows;

  const int b = blockIdx.z, kvh = blockIdx.y;
  const BlockRows br = block_rows(sh);
  const int q_lo = br.q_lo, q_hi = br.q_hi;
  const int rows_used = sh.pos_per_block * sh.G;
  const long long seq = (long long)b * sh.S, qseq = (long long)b * sh.Sq;
  const int hd4 = hd / 4;

  stage<float, kThreadsF32>(qs, kRows, hd, stride, [&](int r) {
    const int row = br.r_lo + r / sh.G;
    return (r < rows_used && row < sh.Sq)
               ? q + ((qseq + row) * sh.H + kvh * sh.G + r % sh.G) * hd
               : nullptr;
  });

  // scores: thread (rg, cg) takes rows 2 rg, 2 rg + 1 and keys cg + 8 j
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  int qpos[2];
  bool row_ok[2];
  float m[2] = {repro::kNegInf, repro::kNegInf}, l[2] = {0.f, 0.f};
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * rg + i;
    qpos[i] = q_lo + r / sh.G;
    row_ok[i] = r < rows_used && br.r_lo + r / sh.G < sh.Sq;
  }
  // PV: thread (pr, dq) takes row pr and float4 columns dq + 4 j
  const int pr = threadIdx.x >> 2, dq = threadIdx.x & 3;
  float4 o[kMaxHdF32 / 16];
#pragma unroll
  for (int j = 0; j < kMaxHdF32 / 16; ++j) o[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  int t_first, t_last;
  key_span(sh, q_lo, q_hi, kKeysF32, &t_first, &t_last);
  for (int tile = t_first; tile <= t_last; ++tile) {
    const int k0 = tile * kKeysF32;
    __syncthreads();
    auto kv_row = [&](const float* base) {
      return [=](int r) {
        const int pos = k0 + r;
        return pos < sh.S ? base + ((seq + pos) * sh.KV + kvh) * hd : nullptr;
      };
    };
    stage<float, kThreadsF32>(ks, kKeysF32, hd, stride, kv_row(k));
    stage<float, kThreadsF32>(vs, kKeysF32, hd, stride, kv_row(v));
    __syncthreads();

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const float4* qa = reinterpret_cast<const float4*>(qs + 2 * rg * stride);
    const float4* qb = reinterpret_cast<const float4*>(qs + (2 * rg + 1) * stride);
    for (int d = 0; d < hd4; ++d) {
      const float4 x0 = qa[d], x1 = qb[d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 y = reinterpret_cast<const float4*>(ks + (cg + 8 * j) * stride)[d];
        s[0][j] = fmaf(x0.x, y.x, s[0][j]);
        s[0][j] = fmaf(x0.y, y.y, s[0][j]);
        s[0][j] = fmaf(x0.z, y.z, s[0][j]);
        s[0][j] = fmaf(x0.w, y.w, s[0][j]);
        s[1][j] = fmaf(x1.x, y.x, s[1][j]);
        s[1][j] = fmaf(x1.y, y.y, s[1][j]);
        s[1][j] = fmaf(x1.z, y.z, s[1][j]);
        s[1][j] = fmaf(x1.w, y.w, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = repro::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[i][j] * sh.scale;
        s[i][j] = (row_ok[i] && visible(sh, qpos[i], k0 + cg + 8 * j)) ? x : repro::kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      for (int off = 1; off < 8; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        tsum += p;
        ps[(2 * rg + i) * (kKeysF32 + 1) + cg + 8 * j] = p;
      }
      for (int off = 1; off < 8; off <<= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      l[i] = l[i] * alpha + tsum;
      if (cg == 0) alpha_s[2 * rg + i] = alpha;
    }
    __syncthreads();

    const float alpha = alpha_s[pr];
    const float* prow = ps + pr * (kKeysF32 + 1);
#pragma unroll
    for (int j = 0; j < kMaxHdF32 / 16; ++j) {
      if (dq + 4 * j < hd4) {
        o[j].x *= alpha;
        o[j].y *= alpha;
        o[j].z *= alpha;
        o[j].w *= alpha;
      }
    }
    for (int c = 0; c < kKeysF32; ++c) {
      const float p = prow[c];
      const float4* vrow = reinterpret_cast<const float4*>(vs + c * stride);
#pragma unroll
      for (int j = 0; j < kMaxHdF32 / 16; ++j) {
        if (dq + 4 * j < hd4) {
          const float4 y = vrow[dq + 4 * j];
          o[j].x = fmaf(p, y.x, o[j].x);
          o[j].y = fmaf(p, y.y, o[j].y);
          o[j].z = fmaf(p, y.z, o[j].z);
          o[j].w = fmaf(p, y.w, o[j].w);
        }
      }
    }
  }
  if (cg == 0) {
    l_s[2 * rg] = l[0];
    l_s[2 * rg + 1] = l[1];
  }
  __syncthreads();
  const int row = br.r_lo + pr / sh.G;
  if (pr < rows_used && row < sh.Sq) {
    const float inv_l = 1.f / fmaxf(l_s[pr], 1e-30f);
    float4* dst = reinterpret_cast<float4*>(
        out + ((qseq + row) * sh.H + kvh * sh.G + pr % sh.G) * hd);
#pragma unroll
    for (int j = 0; j < kMaxHdF32 / 16; ++j) {
      if (dq + 4 * j < hd4)
        dst[dq + 4 * j] =
            make_float4(o[j].x * inv_l, o[j].y * inv_l, o[j].z * inv_l, o[j].w * inv_l);
    }
  }
}

// ------------------------------------------------- bf16 on Hopper ----
//
// hd in {64, 128, 256}: a producer warpgroup and two consumer warpgroups.
// Thread 0 of the producer loads the block's Q once and streams K and V
// tiles through a ring of kStages stages with TMA.  Each stage has "full"
// barriers for K and for V (completed by the TMA's bytes) and "empty" ones
// for K and for V (one arrival per consumer warp once its products have
// read the tile).  Consumer warpgroup c owns rows 64 c .. 64 c + 63: S =
// Q K^T by wgmma from shared memory, the streaming softmax in registers,
// O += P V by wgmma with P from registers and V read MN-major (the
// transpose bit).

constexpr int kWgThreads = 128;
constexpr int kHopperRows = 128;               // rows of a block, 64 a consumer
constexpr int kHopperThreads = 3 * kWgThreads;
constexpr int kStages = 2;
constexpr int kSwizzleRow = 128;               // bytes: 64 bf16, one swizzle row
constexpr int kConsumerWarps = 2 * kWgThreads / 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;             // 2 x 128 x 240 + 128 x 24 <= 65,536

template <int HD>
struct HopperTile {
  static constexpr int kKeys = HD == 256 ? 64 : 128;       // keys a K or V tile
  static constexpr int kPanels = HD / 64;                  // 64-column panels
  static constexpr int kQPanel = kHopperRows * kSwizzleRow;
  static constexpr int kKVPanel = kKeys * kSwizzleRow;
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKVPanel;      // one K or V tile
  static constexpr int kBarriers = 1 + 4 * kStages;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
};

// The block's shared memory, by address: Q, the K and V stages, and the
// barriers (Q full; K full, V full, K empty, V empty per stage).
template <int HD>
struct Ring {
  using T = HopperTile<HD>;
  uint32_t q, k, v, bar;
  __device__ __forceinline__ explicit Ring(unsigned char* smem_raw) {
    q = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
    k = q + T::kQBytes;
    v = k + kStages * T::kKVBytes;
    bar = v + kStages * T::kKVBytes;
  }
  __device__ __forceinline__ uint32_t k_tile(int st) const { return k + st * T::kKVBytes; }
  __device__ __forceinline__ uint32_t v_tile(int st) const { return v + st * T::kKVBytes; }
  __device__ __forceinline__ uint32_t q_full() const { return bar; }
  __device__ __forceinline__ uint32_t k_full(int st) const { return bar + 8 * (1 + st); }
  __device__ __forceinline__ uint32_t v_full(int st) const {
    return bar + 8 * (1 + kStages + st);
  }
  __device__ __forceinline__ uint32_t k_empty(int st) const {
    return bar + 8 * (1 + 2 * kStages + st);
  }
  __device__ __forceinline__ uint32_t v_empty(int st) const {
    return bar + 8 * (1 + 3 * kStages + st);
  }
};

// One consumer warpgroup's view of its 64 rows.
struct ConsumerRows {
  int qpos[2];           // this thread's rows: 16 warp + g and + 8
  bool ok[2];
  bool all_ok;           // every row of the block is a real (position, head)
  int q_lo, q_hi, t4;
};

// S = Q K^T for this warpgroup's 64 rows and the N keys of a tile, issued
// (not waited for).
template <int HD, int N>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_addr, uint32_t k_addr) {
  using T = HopperTile<HD>;
  const uint64_t qd = hopper::sw128_desc(q_addr, 16, 1024);
  const uint64_t kd = hopper::sw128_desc(k_addr, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    // 16 columns: 32 bytes within a 128-byte row, then the next panel;
    // the descriptor holds the address in 16-byte units
    const uint32_t step = (kk & 3) * 2;
    hopper::wgmma_ss<N>(s, qd + (kk >> 2) * (T::kQPanel >> 4) + step,
                        kd + (kk >> 2) * (T::kKVPanel >> 4) + step, kk > 0);
  }
}

// O += P V: V (N keys x HD) MN-major, 64-column panels kKVPanel apart and
// 8-key groups 1024 bytes apart; issued, not waited for.
template <int HD, int N>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*p)[4], uint32_t v_addr) {
  using T = HopperTile<HD>;
  const uint64_t vd = hopper::sw128_desc(v_addr, T::kKVPanel, 1024);
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)
    hopper::wgmma_rs_tb<HD>(o, p[kc], vd + kc * (16 * kSwizzleRow >> 4));
}

// The streaming softmax of one tile of scores (keys k0 .. k0 + N - 1), in
// place: the mask where kMask (the tile crosses the diagonal, the window's
// edge or S, or the block has rows past S or past G x positions), the
// running max m (of scores times scale log2 e) and this thread's part of
// the running sum l; s becomes P = 2^(s scale log2 e - m).  Returns in
// alpha the factor by which O's rows shrink.
template <int N, bool kMask>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l, float* alpha,
                                             const ConsumerRows& rows, const Shape& sh, int k0,
                                             float scale_log2) {
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const int r = (j >> 1) & 1;
      const int kpos = k0 + 8 * (j >> 2) + 2 * rows.t4 + (j & 1);
      if (!(rows.ok[r] && visible(sh, rows.qpos[r], kpos))) s[j] = -CUDART_INF_F;
    }
  }
  float tmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < N / 2; ++j) tmax[(j >> 1) & 1] = fmaxf(tmax[(j >> 1) & 1], s[j]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r] * scale_log2);
    alpha[r] = hopper::ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float tsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int r = (j >> 1) & 1;
    s[j] = hopper::ex2(fmaf(s[j], scale_log2, -m[r]));
    tsum[r] += s[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + tsum[r];
}

template <int N>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l, float* alpha,
                                             const ConsumerRows& rows, const Shape& sh, int k0,
                                             float scale_log2) {
  const bool edge = !rows.all_ok || k0 + N - 1 > rows.q_lo ||
                    (sh.window > 0 && k0 <= rows.q_hi - sh.window);
  if (edge) {
    softmax_tile<N, true>(s, m, l, alpha, rows, sh, k0, scale_log2);
  } else {
    softmax_tile<N, false>(s, m, l, alpha, rows, sh, k0, scale_log2);
  }
}

// P (the softmax's f32 tile) as the bf16 A fragments of O += P V: the
// accumulator layout of S is the A-fragment layout, two keys a register.
template <int N>
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*p)[4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kc][e] = pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float* o, const float* alpha) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int N>
__device__ __forceinline__ void fence_p(uint32_t (*p)[4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[kc][e])::"memory");
}

template <int HD>
__device__ __forceinline__ void hopper_consumer(const Ring<HD>& ring,
                                                __nv_bfloat16* __restrict__ out,
                                                const Shape& sh, int q_lo, int q_hi, int t_first,
                                                int t_last) {
  using T = HopperTile<HD>;
  constexpr int N = T::kKeys;
  const int c = threadIdx.x / kWgThreads - 1;          // consumer 0 or 1
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int rows_used = sh.pos_per_block * sh.G;
  const float scale_log2 = sh.scale * 1.4426950408889634f;
  const int r_lo = q_lo - sh.q_off;
  ConsumerRows rows;
  rows.all_ok = rows_used == kHopperRows && r_lo + sh.pos_per_block <= sh.Sq;
  rows.q_lo = q_lo;
  rows.q_hi = q_hi;
  rows.t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * c + 16 * warp + g + 8 * i;
    rows.qpos[i] = q_lo + r / sh.G;
    rows.ok[i] = r < rows_used && r_lo + r / sh.G < sh.Sq;
  }
  float o[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  float m[2] = {repro::kNegInf, repro::kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float s[N / 2];
  uint32_t p[N / 16][4];
  const uint32_t q_addr = ring.q + c * 64 * kSwizzleRow;
  auto release = [&](uint32_t bar) {
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  hopper::mbar_wait(ring.q_full(), 0);

  for (int i = 0, tile = t_first; tile <= t_last; ++i, ++tile) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    hopper::mbar_wait(ring.k_full(st), parity);
    hopper::fence_regs<N / 2>(s);
    hopper::wgmma_fence();
    issue_qk<HD, N>(s, q_addr, ring.k_tile(st));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs<N / 2>(s);
    release(ring.k_empty(st));
    softmax_tile<N>(s, m, l, alpha, rows, sh, tile * N, scale_log2);
    pack_p<N>(s, p);
    rescale<HD>(o, alpha);
    hopper::mbar_wait(ring.v_full(st), parity);
    hopper::fence_regs<HD / 2>(o);
    hopper::wgmma_fence();
    issue_pv<HD, N>(o, p, ring.v_tile(st));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs<HD / 2>(o);
    fence_p<N>(p);
    release(ring.v_empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long long qseq = (long long)blockIdx.z * sh.Sq;
  const int kvh = blockIdx.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows.ok[r]) continue;
    const int row = 64 * c + 16 * warp + g + 8 * r;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        out + ((qseq + rows.qpos[r] - sh.q_off) * sh.H + kvh * sh.G + row % sh.G) * HD +
        2 * rows.t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv_l, o[4 * j + 2 * r + 1] * inv_l);
    }
  }
}

template <int HD>
__device__ __forceinline__ void hopper_producer(const Ring<HD>& ring, const CUtensorMap* tq,
                                                const CUtensorMap* tk, const CUtensorMap* tv,
                                                const Shape& sh, int r_lo, int t_first,
                                                int t_last) {
  using T = HopperTile<HD>;
  hopper::prefetch_tensor_map(tq);
  hopper::prefetch_tensor_map(tk);
  hopper::prefetch_tensor_map(tv);
  const int b = blockIdx.z, kvh = blockIdx.y;
  hopper::mbar_expect_tx(ring.q_full(), T::kPanels * kSwizzleRow * sh.G * sh.pos_per_block);
#pragma unroll
  for (int pn = 0; pn < T::kPanels; ++pn)
    hopper::tma_load_4d(ring.q + pn * T::kQPanel, tq, ring.q_full(), 64 * pn, kvh * sh.G, r_lo,
                        b);
  for (int i = 0, tile = t_first; tile <= t_last; ++i, ++tile) {
    const int st = i % kStages;
    const uint32_t parity = ((i / kStages) - 1) & 1;   // the stage's last release
    if (i >= kStages) hopper::mbar_wait(ring.k_empty(st), parity);
    hopper::mbar_expect_tx(ring.k_full(st), T::kKVBytes);
#pragma unroll
    for (int pn = 0; pn < T::kPanels; ++pn)
      hopper::tma_load_4d(ring.k_tile(st) + pn * T::kKVPanel, tk, ring.k_full(st), 64 * pn, kvh,
                          tile * T::kKeys, b);
    if (i >= kStages) hopper::mbar_wait(ring.v_empty(st), parity);
    hopper::mbar_expect_tx(ring.v_full(st), T::kKVBytes);
#pragma unroll
    for (int pn = 0; pn < T::kPanels; ++pn)
      hopper::tma_load_4d(ring.v_tile(st) + pn * T::kKVPanel, tv, ring.v_full(st), 64 * pn, kvh,
                          tile * T::kKeys, b);
  }
}

template <int HD>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, Shape sh) {
  using T = HopperTile<HD>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<HD> ring(smem_raw);
  const BlockRows br = block_rows(sh);
  int t_first, t_last;
  key_span(sh, br.q_lo, br.q_hi, T::kKeys, &t_first, &t_last);
  constexpr int kEmptyArrivals = kConsumerWarps;

  if (threadIdx.x == 0) {
    hopper::mbar_init(ring.q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(ring.k_full(st), 1);
      hopper::mbar_init(ring.v_full(st), 1);
      hopper::mbar_init(ring.k_empty(st), kEmptyArrivals);
      hopper::mbar_init(ring.v_empty(st), kEmptyArrivals);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // the producer warpgroup: one thread issues every load
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      hopper_producer<HD>(ring, &tq, &tk, &tv, sh, br.r_lo, t_first, t_last);
  } else {
    hopper::regs_inc<kConsumerRegs>();
    hopper_consumer<HD>(ring, out, sh, br.q_lo, br.q_hi, t_first, t_last);
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B,
                         const Shape& sh, cudaStream_t stream) {
  using T = HopperTile<HD>;
  CUtensorMap tq, tk, tv;
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t q_dims[4] = {HD, (uint64_t)sh.H, (uint64_t)sh.Sq, (uint64_t)B};
  const uint64_t q_strides[3] = {HD * e, sh.H * HD * e, (uint64_t)sh.Sq * sh.H * HD * e};
  const uint64_t kv_dims[4] = {HD, (uint64_t)sh.KV, (uint64_t)sh.S, (uint64_t)B};
  const uint64_t kv_strides[3] = {HD * e, sh.KV * HD * e, (uint64_t)sh.S * sh.KV * HD * e};
  cudaError_t err = hopper::encode_bf16_4d(&tq, q, q_dims, q_strides, sh.G, sh.pos_per_block);
  const uint32_t kv_box = T::kKeys;
  if (err == cudaSuccess) err = hopper::encode_bf16_4d(&tk, k, kv_dims, kv_strides, 1, kv_box);
  if (err == cudaSuccess) err = hopper::encode_bf16_4d(&tv, v, kv_dims, kv_strides, 1, kv_box);
  if (err != cudaSuccess) return err;
  auto kernel = flash_attention_wgmma<HD>;
  err = repro::allow_smem(kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.Sq + sh.pos_per_block - 1) / sh.pos_per_block, sh.KV, B);
  kernel<<<grid, kHopperThreads, T::kSmem, stream>>>(tq, tk, tv,
                                                     static_cast<__nv_bfloat16*>(out), sh);
  return cudaGetLastError();
}

// One kernel name for both input types, so a launch counts the same way.
template <typename T, int HD>
__global__ void __launch_bounds__(sizeof(T) == 2 ? kThreadsBf16 : kThreadsF32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int hd, Shape sh) {
  if constexpr (sizeof(T) == 2) {
    attend_bf16<HD>(q, k, v, out, sh);
  } else {
    attend_f32(q, k, v, out, hd, sh);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int hd,
                   const Shape& sh, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  size_t smem;
  int threads;
  if constexpr (sizeof(T) == 2) {
    smem = (size_t)(kRows + 2 * kKeysBf16) * (HD + 8) * sizeof(T);
    threads = kThreadsBf16;
  } else {
    smem = ((size_t)(kRows + 2 * kKeysF32) * (hd + 4) + kRows * (kKeysF32 + 1) + 2 * kRows) *
           sizeof(float);
    threads = kThreadsF32;
  }
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.Sq + sh.pos_per_block - 1) / sh.pos_per_block, sh.KV, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), hd,
                                          sh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out (B, Sq, H, hd); k, v (B, S, KV, hd); contiguous, 16-byte aligned;
// query row r at position q_off + r, q_off + Sq <= S.  dtype 0: f32 (hd % 4
// == 0, hd <= 256); 1: bf16 (hd in 16, 32, 64, 128, 256).  window <= 0:
// global causal.  Sq = 0 or B = 0 launches nothing.
int flash_attention(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                    int S, int q_off, int H, int KV, int hd, int window, float scale, int dtype,
                    void* stream, int device) {
  if (B < 0 || Sq < 0 || q_off < 0 || (long long)q_off + Sq > S || KV <= 0 || H % KV != 0 ||
      H / KV > kRows || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  const Shape sh{S, H, KV, G, kRows / G, window, scale, Sq, q_off};
  const Shape wide{S, H, KV, G, kHopperRows / G, window, scale, Sq, q_off};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (hd <= 0 || hd % 4 != 0 || hd > kMaxHdF32) return (int)cudaErrorInvalidValue;
    return (int)launch<float, 0>(q, k, v, out, B, hd, sh, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return (int)launch<__nv_bfloat16, 16>(q, k, v, out, B, hd, sh, st);
    case 32: return (int)launch<__nv_bfloat16, 32>(q, k, v, out, B, hd, sh, st);
    case 64: return (int)launch_wgmma<64>(q, k, v, out, B, wide, st);
    case 128: return (int)launch_wgmma<128>(q, k, v, out, B, wide, st);
    case 256: return (int)launch_wgmma<256>(q, k, v, out, B, wide, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
