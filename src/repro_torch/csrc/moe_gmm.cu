// moe_gmm: y[e] = x[e] @ w[e] for x (E, C, d), w (E, d, f), y (E, C, f), all
// contiguous, in float32 or bfloat16, with float32 accumulation; rows at or
// past counts[e] (int32, clamped into [0, C]) are zero.  y has x's dtype.
//
// Replaces repro/kernels/moe_gmm.py:_gmm_kernel, whose grid (E, C tiles,
// f tiles, d tiles) keeps an f32 accumulator in VMEM along the sequential
// d axis and masks the dead rows when the last d tile is done.  Hopper
// blocks run in no order, so the d axis becomes a loop inside the block:
// one block per (row tile, column tile, expert) walks d and keeps its
// accumulator in registers.  The block reads counts[e] itself (never the
// host): a row tile wholly past the expert's live rows loads nothing and
// writes zeros (y comes from torch.empty, and the reference zeroes those
// rows); a partial tile writes zeros on its dead rows.
//
// Bound: at the MoE layers' shapes (DeepSeek-MoE 16B: 64 experts, C 240,
// d 2048, f 2816 / 1408; Jamba: 16 experts, C 320, d 8192, f 49152 / 24576)
// the expert weights dominate the bytes (738 MB for DeepSeek's up
// projection, 12.9 GB for Jamba's); the operations (2 d f per live row) are
// a little below the bytes at the bf16 tensor-core rate.
//
// bfloat16 (gmm_bf16_k): blocks of 256 x 128 outputs where one row tile
// spans the capacity (C <= 256, DeepSeek's 240), so each weight panel
// (d x 128) is read from HBM once; 128 x 256 where 256-row tiles would pad C
// further (Jamba's 320: 3 row tiles of 128, not 2 of 256), the row tiles
// that share a panel running side by side (blockIdx.x is the row tile) so
// that its later reads hit the L2.  Both move 48 KB a stage for the same
// products.  384 threads: a producer warpgroup whose one thread keeps a
// 4-stage ring of (x, w) tiles in flight with TMA (3-D maps, the expert
// outermost, so a box past C or d reads zeros inside its expert), completed
// on mbarriers; two consumer warpgroups running m64nNk16 wgmma on the
// stages that have arrived, one stage's products in flight behind the next
// one's issue, x K-major and w MN-major (the transpose bit set) in shared
// memory under the 128-byte swizzle.  A 64-row sub-tile wholly past the
// count skips its products.  d % 8 == 0, f % 8 == 0 and 16-byte aligned
// bases are the TMA's terms: the wrapper pads and copies to meet them.
//
// float32 (gmm_f32_k): the CUDA cores, 4 x 4 outputs a thread, so that the
// float32 forward checks hold (no TF32); shared-memory tiles of x and w,
// single-buffered.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

// Copy kV elements from src[r][c .. c + kV) of a row-major matrix with
// `ld` elements a row, `rows` x `cols` valid, into dst; zero outside.
// `vec`: ld % kV == 0 and src 16-byte aligned, so a whole in-bounds group
// is one 16-byte load.
template <typename T, int kV>
__device__ __forceinline__ void load_group(T* __restrict__ dst, const T* __restrict__ src,
                                           int64_t ld, int r, int c, int rows, int cols,
                                           bool vec) {
  static_assert(sizeof(T) * kV == 16, "one 16-byte group");
  if (r < rows && vec && c + kV <= cols) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + r * ld + c);
    return;
  }
#pragma unroll
  for (int j = 0; j < kV; ++j)
    dst[j] = (r < rows && c + j < cols) ? src[r * ld + c + j] : T(0.f);
}

// ---- bfloat16: wgmma fed by TMA ----------------------------------------------

constexpr int kBK = 64;            // d per stage: 128 bytes, one swizzle row
constexpr int kStages = 4;
constexpr int kBf16Threads = 384;  // consumers 0-255, producer 256-383

// A block of kBM rows (two consumer warpgroups of kBM / 2 rows, each
// kSubs = kBM / 128 m64 sub-tiles) by kBN columns (kBN / 64 w boxes).
template <int kBM, int kBN>
struct GmmTiles {
  static constexpr int kSubs = kBM / 128;
  static constexpr int kXBytes = kBM * kBK * 2;  // x tile [kBM][64]
  static constexpr int kWBytes = kBK * kBN * 2;  // w tile: kBN / 64 boxes of [64 d][64 f]
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
};

// One thread's part of a 64 x kBN accumulator: acc[4 j + 2 hr + c] is row
// r + 8 hr, column c0 + 8 j + c.  Rows at or past the count are written as
// zeros; f % 8 == 0 keeps a column pair in or out together.
template <int kBN>
__device__ __forceinline__ void store_tile(const float (&acc)[kBN / 2],
                                           __nv_bfloat16* __restrict__ y, int e, int r, int c0,
                                           int C, int f, int live) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r + 8 * hr;
    if (row >= C) continue;
    __nv_bfloat16* yr = y + ((int64_t)e * C + row) * f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c < f)
        *reinterpret_cast<uint32_t*>(yr + c) =
            row < live ? hopper::pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]) : 0u;
    }
  }
}

// A consumer warpgroup's walk over d: wait for each stage, issue the
// products of its first kLive 64-row sub-tiles (x rows at xoff + 64 i rows
// of the stage's x tile), and release a stage once its products are done,
// keeping one stage's products in flight behind the next one's issue.
template <int kBM, int kBN, int kLive>
__device__ __forceinline__ void mainloop(float (&acc)[kBM / 128][kBN / 2], const uint8_t* smem,
                                         int xoff, uint64_t* full, uint64_t* empty, int nk) {
  using Tiles = GmmTiles<kBM, kBN>;
  const int lane = threadIdx.x & 31;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    if constexpr (kLive > 0) {
      const uint8_t* xs = smem + s * Tiles::kStageBytes + xoff;
      const uint8_t* ws = smem + s * Tiles::kStageBytes + Tiles::kXBytes;
#pragma unroll
      for (int i = 0; i < kLive; ++i) hopper::fence_operands(acc[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // w: MN-major (f contiguous), 16 rows of d a step, boxes 8 KB apart
        const uint64_t db = hopper::desc_sw128(ws + kk * 16 * 128, kBK * 128, 1024);
#pragma unroll
        for (int i = 0; i < kLive; ++i)
          hopper::wgmma_ss<kBN, 1>(acc[i], hopper::desc_sw128(xs + i * 64 * 128 + kk * 32, 16, 1024),
                                   db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the last stage's products are done
#pragma unroll
      for (int i = 0; i < kLive; ++i) hopper::fence_operands(acc[i]);
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
    } else if (lane == 0) {
      hopper::mbar_arrive(&empty[s]);
    }
  }
  if constexpr (kLive > 0) {
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kLive; ++i) hopper::fence_operands(acc[i]);
  }
}

template <int kBM, int kBN>
__global__ void __launch_bounds__(kBf16Threads, 1)
    gmm_bf16_k(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const int* __restrict__ counts, __nv_bfloat16* __restrict__ y, int C, int d,
               int f) {
  using Tiles = GmmTiles<kBM, kBN>;
  constexpr int kSubs = Tiles::kSubs;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ uint64_t full[kStages], empty[kStages];

  const int e = blockIdx.z, row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int live = min(max(counts[e], 0), C);
  const int nk = row0 < live ? (d + kBK - 1) / kBK : 0;  // a dead tile loads nothing

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        hopper::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], Tiles::kStageBytes);
        uint8_t* xs = smem + s * Tiles::kStageBytes;
        uint8_t* ws = xs + Tiles::kXBytes;
        // rows past C read as zeros inside the expert (3-D map)
        hopper::tma_load_3d(xs, &xmap, &full[s], kt * kBK, row0, e);
        for (int bx = 0; bx < kBN / 64; ++bx)
          hopper::tma_load_3d(ws + bx * kBK * 128, &wmap, &full[s], col0 + 64 * bx, kt * kBK, e);
      }
    }
  } else {  // consumer warpgroup wg: rows row0 + wg kBM / 2 + 64 i
    hopper::setmaxnreg_inc<240>();
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int sub0 = row0 + wg * 64 * kSubs;
    // 64-row sub-tiles of this warpgroup below the count (uniform in it)
    const int on = min(kSubs, max(0, (live - sub0 + 63) / 64));
    float acc[kSubs][kBN / 2];
#pragma unroll
    for (int i = 0; i < kSubs; ++i)
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) acc[i][j] = 0.f;
    // a sub-tile wholly past the count skips its products; one loop per
    // count of live sub-tiles, so that no wgmma sits in a branch of its own
    const int xoff = wg * 64 * kSubs * 128;  // this warpgroup's rows of the x tile
    if (kSubs == 2 && on == 2)
      mainloop<kBM, kBN, kSubs>(acc, smem, xoff, full, empty, nk);
    else if (on >= 1)
      mainloop<kBM, kBN, 1>(acc, smem, xoff, full, empty, nk);
    else
      mainloop<kBM, kBN, 0>(acc, smem, xoff, full, empty, nk);
#pragma unroll
    for (int i = 0; i < kSubs; ++i)
      store_tile<kBN>(acc[i], y, e, sub0 + 64 * i + 16 * wq + g, col0 + 2 * t, C, f, live);
  }
}

template <int kBM, int kBN>
cudaError_t launch_tiles(const void* x, const void* w, const void* counts, void* y, int E, int C,
                         int d, int f, cudaStream_t s) {
  using Tiles = GmmTiles<kBM, kBN>;
  CUtensorMap xm, wm;
  if (!hopper::bf16_map_3d(&xm, x, d, C, E, kBM) || !hopper::bf16_map_3d(&wm, w, f, d, E, kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + kBM - 1) / kBM), (unsigned)((f + kBN - 1) / kBN), (unsigned)E);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  auto kern = gmm_bf16_k<kBM, kBN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kBf16Threads, Tiles::kSmem, s>>>(xm, wm, static_cast<const int*>(counts),
                                                static_cast<__nv_bfloat16*>(y), C, d, f);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* w, const void* counts, void* y, int E, int C,
                        int d, int f, cudaStream_t s) {
  // the TMA's terms: rows of a multiple of 16 bytes, 16-byte aligned bases
  if (d % 8 || f % 8 || d == 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  // 256 x 128 blocks read each weight panel once where one row tile spans C
  // (C <= 256, DeepSeek's 240); where 256-row tiles would pad C more than
  // 128-row ones (Jamba's 320: 512 rows against 384), 128 x 256 blocks,
  // whose row tiles run side by side and share the panel in the L2.  Both
  // move 48 KB a stage for the same products.
  if ((C + 255) / 256 * 256 <= (C + 127) / 128 * 128)
    return launch_tiles<256, 128>(x, w, counts, y, E, C, d, f, s);
  return launch_tiles<128, 256>(x, w, counts, y, E, C, d, f, s);
}

// ---- float32: CUDA cores -----------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFA = kFM + 4;  // As (transposed, [k][m]) row stride
constexpr int kFB = kFN + 4;  // Bs ([k][n]) row stride

__global__ void __launch_bounds__(kThreads)
    gmm_f32_k(const float* __restrict__ x, const float* __restrict__ w,
              const int* __restrict__ counts, float* __restrict__ y, int C, int d, int f,
              int vec) {
  __shared__ __align__(16) float As[kFK * kFA];
  __shared__ __align__(16) float Bs[kFK * kFB];

  const int e = blockIdx.z, row0 = blockIdx.x * kFM, col0 = blockIdx.y * kFN;
  const int live = min(max(counts[e], 0), C);
  const float* xe = x + (int64_t)e * C * d;
  const float* we = w + (int64_t)e * d * f;
  float* ye = y + (int64_t)e * C * f;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (row0 < live) {
    const int rows = min(live - row0, kFM);
    for (int k0 = 0; k0 < d; k0 += kFK) {
      __syncthreads();
      {  // x: 64 rows x 16 = 256 groups of 4, stored transposed
        const int r = tid >> 2, c = (tid & 3) * 4;
        __align__(16) float v[4];
        load_group<float, 4>(v, xe + (int64_t)row0 * d + k0, d, r, c, rows, d - k0, vec);
#pragma unroll
        for (int j = 0; j < 4; ++j) As[(c + j) * kFA + r] = v[j];
      }
      {  // w: 16 rows x 64 = 256 groups of 4
        const int r = tid >> 4, c = (tid & 15) * 4;
        load_group<float, 4>(Bs + r * kFB + c, we + (int64_t)k0 * f + col0, f, r, c, d - k0,
                             f - col0, vec);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(As + k * kFA + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Bs + k * kFB + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= C) continue;
    const bool on = r < live;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < f) ye[(int64_t)r * f + c] = on ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

extern "C" int repro_moe_gmm(const void* x, const void* w, const void* counts, void* y,
                             int E, int C, int d, int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 0 || C < 0 || d < 0 || f < 0 || E > 65535) return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || f == 0) return cudaSuccess;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  switch (dtype) {
    case repro::kBFloat16:
      return launch_bf16(x, w, counts, y, E, C, d, f, s);
    case repro::kFloat32: {
      const dim3 grid((unsigned)((C + kFM - 1) / kFM), (unsigned)((f + kFN - 1) / kFN),
                      (unsigned)E);
      if (grid.y > 65535) return cudaErrorInvalidValue;
      const int vec = aligned && d % 4 == 0 && f % 4 == 0;
      gmm_f32_k<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(w),
                                          static_cast<const int*>(counts),
                                          static_cast<float*>(y), C, d, f, vec);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
