// Causal grouped-query attention with an optional sliding window, forward,
// as a streaming softmax:
//
//   out[b, i, h] = sum_{j in span(i)} softmax_j(<q[b, i, h], k[b, j, h / G]> / sqrt(hd))
//                  * v[b, j, h / G]
//   span(i) = {j : j <= i and (window == 0 or j > i - window)}
//
// q, out (B, S, H, hd); k, v (B, S, KV, hd); G = H / KV.  bf16 (the model's
// compute type) or f32 (for parity checks), scores, running max and sum in
// f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention() (_kernel): grid (B, KV, q blocks, kv blocks), the kv
// blocks in order on one core with (max, sum, accumulator) carried in VMEM
// scratch, kv blocks outside the causal or window span skipped.  It rounds
// where that kernel rounds: scores in f32 times 1/sqrt(hd), masked scores
// set to -1e30, p = exp(s - m) cast to v's type before the PV product with
// f32 sums, the accumulator divided by max(l, 1e-30) and cast to q's type.
//
// What bounds it on an H100: bf16 tensor-core operations.  A global layer
// of gemma3-1b at S = 32,752 needs 4 hd S (S + 1) / 2 flops a head, 2.2
// TFLOP a sequence, against 0.17 GB of q, k, v and out; a windowed layer
// (W = 1024) ~0.14 TFLOP.
//
// What the design does about it:
//  * A block owns 64 rows: 64 / G query positions times the G query heads
//    of one kv head (the GQA fold of the Pallas wrapper), so each k and v
//    tile staged into shared memory serves all G heads.  The sequential
//    kv grid axis of the TPU kernel becomes a loop inside the block, from
//    the first 64-key tile the window reaches to the diagonal, so the work
//    is ~S W on windowed layers and ~S^2 / 2 on global ones.  Blocks are
//    issued heaviest (last query tile) first.
//  * bf16: 4 warps, 16 rows each.  S = Q K^T and O += P V are
//    mma.sync.m16n8k16 (bf16 in, f32 sums) with fragments read by ldmatrix
//    from shared-memory rows padded by 16 bytes (no bank conflicts).  The
//    score fragment becomes the A operand of the PV product in registers
//    (rounded to bf16 there); the 16 x hd f32 accumulator stays in
//    registers.  q, k and v tiles take 3 x 64 x (hd + 8) x 2 bytes of
//    dynamic shared memory (101 KB at hd = 256, two blocks an SM).
//  * f32 (parity checks only): the same tiling on the CUDA cores, 256
//    threads, 32-key tiles; no tensor cores, so no TF32.
//  * Any S: the ragged last tiles are masked in the kernel and k, v rows
//    past S are staged as zeros.
// Speed is later work: no TMA, no wgmma, no overlap of loads with compute.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 64;         // rows (position, head) of a block
constexpr int kKeysBf16 = 64;     // keys a tile, bf16
constexpr int kKeysF32 = 32;      // keys a tile, f32
constexpr int kThreadsBf16 = 128;
constexpr int kThreadsF32 = 256;
constexpr int kMaxHdF32 = 256;

struct Shape {
  int S, H, KV, G, pos_per_block, window;
  float scale;
};

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
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * sh.pos_per_block;
  const int q_hi = min(q_lo + sh.pos_per_block, sh.S) - 1;
  const int rows_used = sh.pos_per_block * sh.G;
  const long long seq = (long long)b * sh.S;

  stage<__nv_bfloat16, kThreadsBf16>(qs, kRows, HD, kStride, [&](int r) {
    const int pos = q_lo + r / sh.G;
    return (r < rows_used && pos < sh.S)
               ? q + ((seq + pos) * sh.H + kvh * sh.G + r % sh.G) * HD
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
    row_ok[i] = r < rows_used && qpos[i] < sh.S;
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
    __nv_bfloat16* dst = out + ((seq + qpos[i]) * sh.H + kvh * sh.G + r % sh.G) * HD + 2 * t;
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
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * sh.pos_per_block;
  const int q_hi = min(q_lo + sh.pos_per_block, sh.S) - 1;
  const int rows_used = sh.pos_per_block * sh.G;
  const long long seq = (long long)b * sh.S;
  const int hd4 = hd / 4;

  stage<float, kThreadsF32>(qs, kRows, hd, stride, [&](int r) {
    const int pos = q_lo + r / sh.G;
    return (r < rows_used && pos < sh.S)
               ? q + ((seq + pos) * sh.H + kvh * sh.G + r % sh.G) * hd
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
    row_ok[i] = r < rows_used && qpos[i] < sh.S;
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
  const int pos = q_lo + pr / sh.G;
  if (pr < rows_used && pos < sh.S) {
    const float inv_l = 1.f / fmaxf(l_s[pr], 1e-30f);
    float4* dst = reinterpret_cast<float4*>(
        out + ((seq + pos) * sh.H + kvh * sh.G + pr % sh.G) * hd);
#pragma unroll
    for (int j = 0; j < kMaxHdF32 / 16; ++j) {
      if (dq + 4 * j < hd4)
        dst[dq + 4 * j] =
            make_float4(o[j].x * inv_l, o[j].y * inv_l, o[j].z * inv_l, o[j].w * inv_l);
    }
  }
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
  const dim3 grid((sh.S + sh.pos_per_block - 1) / sh.pos_per_block, sh.KV, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), hd,
                                          sh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out (B, S, H, hd); k, v (B, S, KV, hd); contiguous, 16-byte aligned.
// dtype 0: f32 (hd % 4 == 0, hd <= 256); 1: bf16 (hd in 16, 32, 64, 128,
// 256).  window <= 0: global causal.  S = 0 or B = 0 launches nothing.
int flash_attention(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                    int KV, int hd, int window, float scale, int dtype, void* stream,
                    int device) {
  if (B < 0 || S < 0 || KV <= 0 || H % KV != 0 || H / KV > kRows || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  const Shape sh{S, H, KV, G, kRows / G, window, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (hd <= 0 || hd % 4 != 0 || hd > kMaxHdF32) return (int)cudaErrorInvalidValue;
    return (int)launch<float, 0>(q, k, v, out, B, hd, sh, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return (int)launch<__nv_bfloat16, 16>(q, k, v, out, B, hd, sh, st);
    case 32: return (int)launch<__nv_bfloat16, 32>(q, k, v, out, B, hd, sh, st);
    case 64: return (int)launch<__nv_bfloat16, 64>(q, k, v, out, B, hd, sh, st);
    case 128: return (int)launch<__nv_bfloat16, 128>(q, k, v, out, B, hd, sh, st);
    case 256: return (int)launch<__nv_bfloat16, 256>(q, k, v, out, B, hd, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
