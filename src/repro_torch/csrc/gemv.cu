// gemv: y = A @ x for A (rows, n) in float32 or bfloat16, x (n,) float32,
// float32 accumulation, y in A's dtype; n a multiple of 8, A 16-byte aligned.
//
// Replaces repro/kernels/gemv.py:_gemv_kernel, which tiles A into
// (128, 512) MXU blocks with an f32 VMEM accumulator carried across the
// sequential n axis.  A matrix-vector product does 2 flops per element of A,
// far below what the tensor cores need to matter, so it is bound by the
// bytes of A, read once.  Reaching the HBM rate takes some 20 KB of loads in
// flight on each SM (Little's law at 3.35 TB/s and ~0.7 us), all the time.
// The design keeps them in flight, on a grid that holds all the work (one
// launch, no grid stride: the block scheduler hands the blocks out in order):
//   - short rows (n <= 1024 float32, 2048 bfloat16, the suite's 256 among
//     them): no shared memory and no barrier.  A lane always meets the same
//     columns, so it keeps their x in registers, loaded once per warp.  A
//     warp owns a group of R rows and issues all R x VPL 16-byte loads of
//     them (VPL = the row's vectors per lane, a template number; R x VPL =
//     kLoads = 16) before its first FMA; R lanes then write the R sums in
//     one store.  At the suite's shape on an H100, persistent blocks walking
//     the groups with a grid stride measured 1.4% slower, and a ring of 1-D
//     bulk copies into shared memory 0.6-1.0% slower (PERF.md);
//   - longer rows: a warp a row, x staged into shared memory tile by tile
//     (kXTile values, one tile up to 8,192), kUnroll 16-byte loads a lane
//     before it adds;
//   - A is read once, so it is loaded with evict-first hints (__ldcs).
// No atomics: a row's sum order depends only on n, so y is the same on
// every call.  A bank-batched GEMV is one (banks * rows, n) product with the
// shared x.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 16;    // short rows: 16-byte loads a lane has in flight
constexpr int kUnroll = 8;    // long rows: 16-byte loads a lane issues at once
constexpr int kXTile = 8192;  // long rows: x values a block stages at once (32 KB)
constexpr int kMaxVpl = 8;    // short rows: at most 8 x 32 vectors a row

// A's 16-byte vector: 4 float32 or 8 bfloat16 values
template <typename TA>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int kPer = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int kPer = 8;
};

// acc + <one vector of A, its x values>, in column order
__device__ __forceinline__ float dot(const float4& a, const float* x, float acc) {
  acc = fmaf(a.x, x[0], acc);
  acc = fmaf(a.y, x[1], acc);
  acc = fmaf(a.z, x[2], acc);
  return fmaf(a.w, x[3], acc);
}
__device__ __forceinline__ float dot(const uint4& a, const float* x, float acc) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    acc = fmaf(f.x, x[2 * i], acc);
    acc = fmaf(f.y, x[2 * i + 1], acc);
  }
  return acc;
}

// Sum over the warp that leaves the same value in every lane: at each step
// lanes i and i ^ o add the same two values, and addition commutes exactly.
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }

// Short rows: a row has vpr <= 32 * VPL vectors; vector c of a row is lane
// c % 32's, its (c / 32)-th.  Warp g of the grid owns rows [g R, g R + R).
template <typename TA, int VPL>
__global__ void __launch_bounds__(kThreads)
    gemv_rows_k(const TA* __restrict__ a, const float* __restrict__ x, TA* __restrict__ y,
                int64_t rows, int vpr) {
  using V = typename Vec<TA>::type;
  constexpr int kPer = Vec<TA>::kPer, R = kLoads / VPL;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  if (r0 >= rows) return;
  float xr[VPL][kPer];  // this lane's x (x need not be 16-byte aligned)
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < kPer; ++e) xr[j][e] = c < vpr ? __ldg(x + c * kPer + e) : 0.f;
  }
  const V* av = reinterpret_cast<const V*>(a);
  V v[R][VPL];
  if (r0 + R <= rows && vpr == 32 * VPL) {
    // a whole group of whole rows: loads without a guard, which the
    // compiler issues all before the first FMA (guarded, it issued 9 of the
    // 24 loads of x and A before it, and the kernel measured 0.8% slower
    // on an H100)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < VPL; ++j) v[r][j] = __ldcs(av + (r0 + r) * vpr + lane + 32 * j);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int c = lane + 32 * j;
        v[r][j] = (r0 + r < rows && c < vpr) ? __ldcs(av + (r0 + r) * vpr + c) : V{};
      }
  }
  float mine = 0.f;  // lane r keeps row r0 + r's sum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc = dot(v[r][j], xr[j], acc);
    acc = warp_allsum(acc);
    if (lane == r) mine = acc;
  }
  if (lane < R && r0 + lane < rows) store(y + r0 + lane, mine);
}

// Long rows: warp w of the grid owns row w; x in shared memory tile by tile
// (every warp of the block walks the same tiles).
template <typename TA>
__global__ void __launch_bounds__(kThreads)
    gemv_long_k(const TA* __restrict__ a, const float* __restrict__ x, TA* __restrict__ y,
                int64_t rows, int n) {
  using V = typename Vec<TA>::type;
  constexpr int kPer = Vec<TA>::kPer;
  __shared__ __align__(16) float xs[kXTile];
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  float acc = 0.f;
  for (int t0 = 0; t0 < n; t0 += kXTile) {
    const int tv = min(kXTile, n - t0) / kPer;
    __syncthreads();  // every warp is done with the last tile
    for (int i = threadIdx.x; i < tv * kPer; i += kThreads) xs[i] = __ldg(x + t0 + i);
    __syncthreads();
    if (row >= rows) continue;
    const V* av = reinterpret_cast<const V*>(a + row * n + t0);
    for (int c = lane; c < tv; c += 32 * kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = c + 32 * u < tv ? __ldcs(av + c + 32 * u) : V{};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c + 32 * u < tv) acc = dot(v[u], xs + (c + 32 * u) * kPer, acc);
    }
  }
  acc = warp_allsum(acc);
  if (row < rows && lane == 0) store(y + row, acc);
}

// One launch, a block for every kWarps groups of rows (VPL > 0, R rows a
// group) or every kWarps rows (VPL = 0).
template <typename TA, int VPL>
int launch(const TA* a, const float* x, TA* y, int64_t rows, int n, cudaStream_t s) {
  constexpr int64_t R = VPL > 0 ? kLoads / VPL : 1;
  const unsigned blocks = static_cast<unsigned>(((rows + R - 1) / R + kWarps - 1) / kWarps);
  if constexpr (VPL > 0)
    gemv_rows_k<TA, VPL><<<blocks, kThreads, 0, s>>>(a, x, y, rows, n / Vec<TA>::kPer);
  else
    gemv_long_k<TA><<<blocks, kThreads, 0, s>>>(a, x, y, rows, n);
  return cudaGetLastError();
}

template <typename TA>
int dispatch(const void* av, const float* x, void* yv, int64_t rows, int n, cudaStream_t s) {
  const TA* a = static_cast<const TA*>(av);
  TA* y = static_cast<TA*>(yv);
  const int vpr = n / Vec<TA>::kPer;  // 16-byte vectors a row
  if (vpr <= 32) return launch<TA, 1>(a, x, y, rows, n, s);
  if (vpr <= 64) return launch<TA, 2>(a, x, y, rows, n, s);
  if (vpr <= 128) return launch<TA, 4>(a, x, y, rows, n, s);
  if (vpr <= 32 * kMaxVpl) return launch<TA, kMaxVpl>(a, x, y, rows, n, s);
  return launch<TA, 0>(a, x, y, rows, n, s);
}

}  // namespace

extern "C" int repro_gemv(const void* a, const void* x, void* y, int64_t rows, int n,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 0 || n < 0 || n % 8) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const float* xp = static_cast<const float*>(x);
  switch (dtype) {
    case repro::kFloat32:
      return dispatch<float>(a, xp, y, rows, n, s);
    case repro::kBFloat16:
      return dispatch<__nv_bfloat16>(a, xp, y, rows, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}
