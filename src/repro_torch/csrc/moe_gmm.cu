// moe_gmm: y[e] = x[e] @ w[e] for x (E, C, d), w (E, d, f), y (E, C, f), all
// contiguous, in float32 or bfloat16, with float32 accumulation; rows at or
// past counts[e] (int32, clamped into [0, C]) are zero.  y has x's dtype.
//
// Replaces repro/kernels/moe_gmm.py:_gmm_kernel, whose grid (E, C tiles,
// f tiles, d tiles) keeps an f32 accumulator in VMEM along the sequential
// d axis and masks the dead rows when the last d tile is done.  Hopper
// blocks run in no order, so the d axis becomes a loop inside the block:
// one block per (row tile, column tile, expert) walks d in shared-memory
// tiles of x and w and keeps its accumulator in registers.  The block reads
// counts[e] itself: a row tile wholly past the expert's live rows skips the
// loop and writes zeros (y comes from torch.empty, and the reference zeroes
// those rows); a partial tile stages its dead rows as zeros, and writes
// zeros there.
//
// Bound: at the MoE layers' shapes (DeepSeek-MoE 16B: 64 experts, C 240,
// d 2048, f 2816 / 1408; Jamba: 16 experts, C 320, d 8192, f 49152 / 24576)
// the expert weights dominate the bytes (738 MB for DeepSeek's up
// projection, 12.9 GB for Jamba's), read once per row tile: each block of
// one column tile reads a weight panel of d x 128, and the C / 64 row tiles
// that share it run side by side (blockIdx.x is the row tile), so the panel
// comes from the L2 after the first of them.  The operations (2 d f per
// live row) are a little below the bytes at bf16 tensor-core rate.  What the
// design does about it: bfloat16 runs on the tensor cores with mma.sync
// (m16n8k16, f32 accumulate), each warp a 32 x 32 output tile, operands
// read from shared memory padded so that the fragment loads of a warp hit
// distinct banks; float32 runs on the CUDA cores, 4 x 4 outputs a thread.
// Single-buffered, no TMA or wgmma: that is later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }

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

// ---- bfloat16: tensor cores ------------------------------------------------

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kAS = kBK + 8;  // As row stride (bf16): 80 bytes
constexpr int kBS = kBN + 8;  // Bs row stride (bf16): 272 bytes

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
    gmm_bf16_k(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const int* __restrict__ counts, __nv_bfloat16* __restrict__ y, int C, int d,
               int f, int vec) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kAS];  // x tile, [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK * kBS];  // w tile, [k][n]

  const int e = blockIdx.z, row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int live = min(max(counts[e], 0), C);
  const __nv_bfloat16* xe = x + (int64_t)e * C * d;
  const __nv_bfloat16* we = w + (int64_t)e * d * f;
  __nv_bfloat16* ye = y + (int64_t)e * C * f;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;  // this warp's 32 x 32
  const int g = lane >> 2, t4 = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const unsigned short* Bh = reinterpret_cast<const unsigned short*>(Bs);
  if (row0 < live) {
    const int rows = min(live - row0, kBM);
    for (int k0 = 0; k0 < d; k0 += kBK) {
      __syncthreads();  // the last tile's fragment loads are done
      // x: 64 x 32 = 256 groups of 8, one a thread; w: 32 x 128 = 512 groups
      {
        const int r = tid >> 2, c = (tid & 3) * 8;
        load_group<__nv_bfloat16, 8>(As + r * kAS + c, xe + (int64_t)row0 * d + k0, d, r, c,
                                     rows, d - k0, vec);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads, r = idx >> 4, c = (idx & 15) * 8;
        load_group<__nv_bfloat16, 8>(Bs + r * kBS + c, we + (int64_t)k0 * f + col0, f, r, c,
                                     d - k0, f - col0, vec);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* a0 = As + (wm + i * 16 + g) * kAS + kk + t4 * 2;
          af[i][0] = *reinterpret_cast<const uint32_t*>(a0);
          af[i][1] = *reinterpret_cast<const uint32_t*>(a0 + 8 * kAS);
          af[i][2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
          af[i][3] = *reinterpret_cast<const uint32_t*>(a0 + 8 * kAS + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // B fragment: (k = 2 t4, 2 t4 + 1) and (+8) of column n, the lower
          // k in the lower half
          const unsigned short* b0 = Bh + (kk + t4 * 2) * kBS + wn + j * 8 + g;
          bfr[j][0] = (uint32_t)b0[0] | ((uint32_t)b0[kBS] << 16);
          bfr[j][1] = (uint32_t)b0[8 * kBS] | ((uint32_t)b0[9 * kBS] << 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
      }
    }
  }

  // c0, c1: row g, columns 2 t4, 2 t4 + 1; c2, c3: row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm + i * 16 + g + half * 8;
      if (r >= C) continue;
      const bool on = r < live;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + wn + j * 8 + t4 * 2;
#pragma unroll
        for (int v = 0; v < 2; ++v)
          if (c + v < f) store(ye + (int64_t)r * f + c + v, on ? acc[i][j][half * 2 + v] : 0.f);
      }
    }
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
    case repro::kBFloat16: {
      const dim3 grid((unsigned)((C + kBM - 1) / kBM), (unsigned)((f + kBN - 1) / kBN),
                      (unsigned)E);
      if (grid.y > 65535) return cudaErrorInvalidValue;
      const int vec = aligned && d % 8 == 0 && f % 8 == 0;
      gmm_bf16_k<<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
          static_cast<const int*>(counts), static_cast<__nv_bfloat16*>(y), C, d, f, vec);
      break;
    }
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
