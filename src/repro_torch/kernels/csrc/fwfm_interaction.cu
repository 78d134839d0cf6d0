// The full FwFM pairwise term, per example:
//
//   out[b] = 0.5 * sum_{i,j} <v_i, v_j> R_ij        V (B, m, k), R (m, m)
//
// V is float or __nv_bfloat16 (the kernel is a template on its type), R and
// out f32.  A bf16 V is staged as stored and upcast to f32 where a compute
// warp loads it into registers (exact), so every operation after that is the
// f32 kernel's: a bf16 launch is bitwise the f32 launch on the upcast V, as
// the Pallas kernel takes V of any float type and accumulates in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fwfm_interaction.py,
// fwfm_pairwise() (_kernel), which forms a tile's (bb, m, m) Gram on the
// MXU and contracts it with a VMEM-resident R.
//
// What bounds it on an H100: f32 operations.  The Gram is symmetric, so the
// function needs only its m (m + 1) / 2 distinct dot products, contracted
// with W_ij = R_ij + R_ji (i < j) and W_ii = R_ii: m (m + 1) (k + 1) flops
// an example (1.16e5 at m = 82, k = 16) against m k 4 bytes read (5.2 KB),
// some 22 flops a byte, just above the card's f32 rate per byte of device
// memory (20).  So V has to stream in while the CUDA cores compute.
//
// What the design does about it.  With x = V[b, :, c] (one column of an
// example), sum_ij <v_i, v_j> R_ij = sum_c sum_j x_j Z_j, where
// Z_j = sum_{i <= j} W_ij x_i: per column a product with the triangle of W,
// which holds each distinct dot product's weight once.  Over a tile of tb
// examples that is one matrix product, W^T (m x m, triangular) times the
// tile's (m x tb k) columns, done as an SGEMM on the CUDA cores:
//
// - W, built in shared memory from R once per block, as W[i][J] with
//   J = j + shift (rows padded to mp, a multiple of 8, zeros where j < 0 or
//   i > j).  Any R gives the plain version's result: non-symmetric, with a
//   diagonal, or pruned.
// - Each thread holds an 8 x 8 register tile of Z: 8 rows j (a "j-tile",
//   the same for the whole warp, so W is read as 16-byte broadcasts) by two
//   column quads (4 columns of one example each, quads lane and lane + 32
//   of the tile's 64).  One step of i is 2 broadcast and 2 plain 16-byte
//   shared loads for 64 FMAs.
// - The triangle, j-tile t running i over [0, 8t + 8 - shift), is cut into
//   12 equal runs of i-steps, one a compute warp (a run may cross j-tiles:
//   each piece ends in its own contraction with x_j, which is linear, so
//   the pieces add).  The warps finish together whatever m is.
// - Examples live in padded slots (stride = m kp rounded up to kp mod 32
//   floats, kp = k rounded up to 4; in bf16 to kp mod 64 elements), so the
//   8 examples a warp reads at once fall on different banks.  A block walks
//   tiles of tb examples (a grid of at most one wave of blocks) through a
//   ring of 2 stages.
// - Warp-specialised: 12 compute warps, and one producer warp that fills a
//   stage with one bulk copy an example (cp.async.bulk, tb m k sizeof(V)
//   contiguous bytes a tile, a lane a copy) completed on the stage's "full"
//   mbarrier, and, once the compute warps have arrived on its "done"
//   mbarrier, sums the tile and refills the stage.  So the compute warps
//   never wait for one another or for a tile's sum and copies, only for
//   data.  Where V is not 16-byte aligned or a row is not a whole number of
//   16-byte pieces (k % 4 != 0 in f32, k % 8 != 0 in bf16), the producer
//   fills the same layout element by element (f32: 4-byte cp.async copies;
//   bf16: loads and stores, each lane arriving after its stores), zeros for
//   k's padding, completed on the same mbarrier, in the same kernel.
// - Each piece's contraction with x_j is branch-free, its 16 loads issued
//   together (a branch and a load a row cost more than the piece's FMAs).
// - Each example is reduced in a fixed order: a lane's quad partials in
//   registers (its pieces in order), then the producer sums each example's
//   quads' 12 warp partials in shared memory (16-byte loads).  No atomics.
//   An example's operations and their order depend on (m, k) alone, so its
//   value does not depend on B or on where it sits in the batch.
//
// All arithmetic in f32 on the CUDA cores, by hand: no cuBLAS, no tensor
// cores.
// Limits: m <= kMaxM and k <= kMaxK (shared memory and the 64 column quads
// of a tile).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxM = 128;
constexpr int kMaxK = 32;
constexpr int kWarps = 12;                 // compute warps; one more fills and sums
constexpr int kThreads = 32 * (kWarps + 1);
constexpr int kStages = 2;
constexpr int kQuads = 64;   // column quads of a tile: two a lane
constexpr int kRows = 8;     // rows j of a register tile (a j-tile)
constexpr size_t kMaxSmem = 232448;
static_assert(kWarps % 4 == 0, "a tile's sums read the warps' partials 4 at a time");

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// Elements from one example's slot to the next: at least m kp, and congruent
// to kp mod the elements of 128 bytes (32 floats, 64 bf16), so that
// consecutive examples' rows start kp elements' banks apart.
__host__ __device__ inline int slot_stride(int m, int kp, int elem) {
  const int base = m * kp, period = 128 / elem;
  return base + ((kp - base) % period + period) % period;
}

// Shared memory: a header (each stage's "full" and "done" mbarriers), W
// (m x mp floats), the stages (tb slots each of elements of `elem` bytes,
// the whole rounded up to 16 bytes) and each stage's per-warp quad partials.
constexpr int kHeader = 32;
__host__ __device__ inline size_t stages_bytes(int m, int k, int tb, int elem) {
  return ((size_t)kStages * tb * slot_stride(m, round4(k), elem) * elem + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t smem_bytes(int m, int k, int tb, int elem) {
  return kHeader + (size_t)m * round8(m) * sizeof(float) + stages_bytes(m, k, tb, elem) +
         (size_t)kStages * kQuads * kWarps * sizeof(float);
}

// Examples a tile: as many as fill the 64 quads, within shared memory.
inline int tile_examples(int m, int k, int elem) {
  int tb = kQuads / (round4(k) / 4);
  while (tb > 1 && smem_bytes(m, k, tb, elem) > kMaxSmem) --tb;
  return tb;
}

// 4 consecutive entries of a staged row as f32: 16 bytes of floats, or 8 of
// bf16 upcast (exact).
__device__ inline float4 load4(const float* x) { return *reinterpret_cast<const float4*>(x); }
__device__ inline float4 load4(const __nv_bfloat16* x) {
  const uint2 w = *reinterpret_cast<const uint2*>(x);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
    fwfm_pairwise_kernel(const T* __restrict__ V, const float* __restrict__ R,
                         long long B, int m, int k, int tb, int bulk,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // kStages: the data landed
  uint64_t* done = full + kStages;                         // kStages: the tile computed
  const int kp = round4(k), kq = kp / 4;
  const int mp = round8(m), shift = mp - m;
  const int S = slot_stride(m, kp, (int)sizeof(T));
  float* W = reinterpret_cast<float*>(smem_raw + kHeader);  // m * mp
  T* stages = reinterpret_cast<T*>(W + m * mp);             // kStages * tb * S
  float* parts = reinterpret_cast<float*>(                  // kStages * kQuads * kWarps
      reinterpret_cast<unsigned char*>(stages) + stages_bytes(m, k, tb, (int)sizeof(T)));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n_tiles = (B + tb - 1) / tb;

  // The producer warp fills a stage with a tile and signals full[s] (one
  // bulk copy a slot a lane, lane 0 announcing their bytes first; or else
  // element by element by every lane, zeros for k's padding, each lane
  // arriving once its copies have landed), then, once the compute warps are
  // done with it, sums the tile and refills the stage.  Its first fills go
  // out before W is built.
  const uint32_t slot_bytes = (uint32_t)(m * k) * (uint32_t)sizeof(T);
  auto fill = [&](long long tile, int s) {
    const long long b0 = tile * tb;
    const int nb = (int)(B - b0 < tb ? B - b0 : tb);
    const uint32_t bar = hopper::smem_addr(&full[s]);
    T* dst = stages + s * tb * S;
    if (bulk) {
      if (lane == 0) hopper::mbar_expect_tx(bar, slot_bytes * nb);
      __syncwarp();
      for (int b = lane; b < nb; b += 32)
        hopper::bulk_load(hopper::smem_addr(dst + b * S), V + (b0 + b) * m * k, slot_bytes,
                          bar);
    } else {
      const int per = m * kp;  // elements a slot takes; lane walks r = lane, lane + 32, ...
      for (int b = 0; b < nb; ++b) {
        const T* src = V + (b0 + b) * m * k;
        T* slot = dst + b * S;
        int i = lane / kp, c = lane % kp;
        for (int r = lane; r < per; r += 32) {
          if constexpr (sizeof(T) == 4)
            hopper::cp_async_4(hopper::smem_addr(slot + r), src + i * k + (c < k ? c : 0),
                               c < k ? 4u : 0u);
          else
            slot[r] = c < k ? src[i * k + c] : T{};
          c += 32 % kp;
          i += 32 / kp + (c >= kp);
          c -= c >= kp ? kp : 0;
        }
      }
      // arrive once this lane's copies have landed (cp.async) or its stores
      // are done (the arrival releases them to the waiting warps)
      if constexpr (sizeof(T) == 4)
        hopper::cp_async_arrive(bar);
      else
        hopper::mbar_arrive(bar);
    }
  };
  if (warp == kWarps) {
    if (lane == 0) {
      for (int s = 0; s < kStages; ++s) {
        hopper::mbar_init(hopper::smem_addr(&full[s]), bulk ? 1 : 32);
        hopper::mbar_init(hopper::smem_addr(&done[s]), kWarps);
      }
      hopper::mbar_init_fence();
    }
    __syncwarp();
    for (int s = 0; s < kStages; ++s)
      if (blockIdx.x + (long long)s * gridDim.x < n_tiles)
        fill(blockIdx.x + (long long)s * gridDim.x, s);
  }
  for (int t = threadIdx.x; t < m * mp; t += kThreads) {
    const int i = t / mp, j = t - i * mp - shift;
    float w = 0.f;
    if (j >= 0 && i <= j) w = i < j ? R[i * m + j] + R[j * m + i] : R[i * m + i];
    W[t] = w;
  }
  __syncthreads();  // W and the barriers are ready; no block-wide barrier after this

  if (warp == kWarps) {
    long long u = 0;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++u) {
      const int s = (int)(u % kStages);
      hopper::mbar_wait(hopper::smem_addr(&done[s]), (uint32_t)(u / kStages) & 1);
      const float* part = parts + s * kQuads * kWarps;  // part[quad * kWarps + warp]
      const long long b0 = tile * tb;
      const int nb = (int)(B - b0 < tb ? B - b0 : tb);
      for (int e = lane; e < nb; e += 32) {  // its quads in order, each over the warps in order
        const float4* q4 = reinterpret_cast<const float4*>(part + e * kq * kWarps);
        float sum = 0.f;
        for (int c = 0; c < kq; ++c) {
#pragma unroll
          for (int h = 0; h < kWarps / 4; ++h) {
            const float4 v = q4[c * (kWarps / 4) + h];
            sum += v.x;
            sum += v.y;
            sum += v.z;
            sum += v.w;
          }
        }
        out[b0 + e] = 0.5f * sum;
      }
      __syncwarp();  // the partials are read before the stage (and they) refill
      if (tile + (long long)kStages * gridDim.x < n_tiles)
        fill(tile + (long long)kStages * gridDim.x, s);
    }
    return;
  }

  // A compute warp's run of the triangle's i-steps, [run0, run1): j-tile t
  // (rows j = 8t - shift ...) takes 8t + 8 - shift of them.
  const int n_jt = mp / kRows;
  const int steps = 4 * n_jt * (n_jt + 1) - n_jt * shift;
  const int run0 = steps * warp / kWarps, run1 = steps * (warp + 1) / kWarps;
  // The lane's two quads: offsets into a stage (quads past the tile read
  // quad 0, and their partials are never summed).
  const int q0 = lane < tb * kq ? lane : 0, q1 = lane + 32 < tb * kq ? lane + 32 : 0;
  const int off0 = q0 / kq * S + q0 % kq * 4, off1 = q1 / kq * S + q1 % kq * 4;

  long long u = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++u) {
    const int s = (int)(u % kStages);
    const T* X = stages + s * tb * S;
    hopper::mbar_wait(hopper::smem_addr(&full[s]), (uint32_t)(u / kStages) & 1);

    float p0 = 0.f, p1 = 0.f;
    int jt = 0, begin = 0;  // j-tile jt covers steps [begin, begin + its count)
    for (int pos = run0; pos < run1;) {
      const int count = kRows * jt + kRows - shift;
      if (pos >= begin + count) {
        begin += count;
        ++jt;
        continue;
      }
      const int i0 = pos - begin;
      const int i1 = run1 - begin < count ? run1 - begin : count;
      const int J0 = kRows * jt;
      float acc[kRows][8];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        const float4 wa = *reinterpret_cast<const float4*>(W + i * mp + J0);
        const float4 wb = *reinterpret_cast<const float4*>(W + i * mp + J0 + 4);
        const float4 xa = load4(X + off0 + i * kp);
        const float4 xb = load4(X + off1 + i * kp);
        const float w[kRows] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(w[r], x[c], acc[r][c]);
      }
      // This piece's share of sum_j x_j Z_j over the j-tile's rows, all 16
      // loads issued first.  Rows j < 0 read row 0 against Z = 0 exactly
      // (W is zero there), which leaves the sums as they are.
      float4 xj[2 * kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = J0 + r - shift > 0 ? J0 + r - shift : 0;
        xj[2 * r] = load4(X + off0 + j * kp);
        xj[2 * r + 1] = load4(X + off1 + j * kp);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p0 = fmaf(xj[2 * r].x, acc[r][0], p0);
        p0 = fmaf(xj[2 * r].y, acc[r][1], p0);
        p0 = fmaf(xj[2 * r].z, acc[r][2], p0);
        p0 = fmaf(xj[2 * r].w, acc[r][3], p0);
        p1 = fmaf(xj[2 * r + 1].x, acc[r][4], p1);
        p1 = fmaf(xj[2 * r + 1].y, acc[r][5], p1);
        p1 = fmaf(xj[2 * r + 1].z, acc[r][6], p1);
        p1 = fmaf(xj[2 * r + 1].w, acc[r][7], p1);
      }
      pos = begin + i1;
    }
    float* part = parts + s * kQuads * kWarps;
    part[lane * kWarps + warp] = p0;
    part[(lane + 32) * kWarps + warp] = p1;
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(hopper::smem_addr(&done[s]));
  }
}

template <class T>
cudaError_t launch_pairwise(const T* V, const float* R, long long B, int m, int k, float* out,
                            cudaStream_t stream, int device) {
  // bulk copies move whole 16-byte pieces between 16-byte aligned places
  const int bulk = k % (16 / (int)sizeof(T)) == 0 && (uintptr_t)V % 16 == 0;
  const int tb = tile_examples(m, k, (int)sizeof(T));
  const size_t smem = smem_bytes(m, k, tb, (int)sizeof(T));
  cudaError_t err = repro::allow_smem(fwfm_pairwise_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  long long most = 0;
  err = repro::one_wave(fwfm_pairwise_kernel<T>, kThreads, smem, device, &most);
  if (err != cudaSuccess) return err;
  const long long tiles = (B + tb - 1) / tb;
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  fwfm_pairwise_kernel<T><<<grid, kThreads, smem, stream>>>(V, R, B, m, k, tb, bulk, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// V (B, m, k) row-major, float (dtype = 0) or bf16 (dtype = 1); R (m, m)
// row-major f32; out (B,) f32.  B = 0 launches nothing.
int fwfm_pairwise(const void* V, int dtype, const float* R, long long B, int m, int k,
                  float* out, void* stream, int device) {
  if (B < 0 || m <= 0 || m > kMaxM || k <= 0 || k > kMaxK ||
      (dtype != repro::kF32 && dtype != repro::kBF16))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == repro::kBF16)
    return (int)launch_pairwise(static_cast<const __nv_bfloat16*>(V), R, B, m, k, out, s,
                                device);
  return (int)launch_pairwise(static_cast<const float*>(V), R, B, m, k, out, s, device);
}

// Examples a tile holds at (m, k) for a V of `dtype`, as the launch above
// cuts them; 0 where the launch refuses the shape.
int fwfm_pairwise_tile(int m, int k, int dtype) {
  if (m <= 0 || m > kMaxM || k <= 0 || k > kMaxK ||
      (dtype != repro::kF32 && dtype != repro::kBF16))
    return 0;
  return tile_examples(m, k, dtype == repro::kBF16 ? 2 : 4);
}

}  // extern "C"
