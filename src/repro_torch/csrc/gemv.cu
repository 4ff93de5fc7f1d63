// gemv: y = A @ x for A (rows, n) in float32 or bfloat16, x (n,) float32,
// float32 accumulation, y in A's dtype; n a multiple of 8.
//
// Replaces repro/kernels/gemv.py:_gemv_kernel, which tiles A into
// (128, 512) MXU blocks with an f32 VMEM accumulator.  A matrix-vector
// product does 2 flops per element of A, far below what the tensor cores
// need to matter, so it is bound by the bytes of A.  The design streams A
// once at full width: one warp per row, 16-byte loads (4 floats or 8
// bfloat16 per lane), x staged in shared memory in 4096-element tiles and
// read back as 16-byte vectors, a warp-shuffle sum per row.  A bank-batched
// GEMV is one (banks * rows, n) product with the shared x.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {
constexpr int kXTile = 4096;
}

__device__ __forceinline__ float dot_tile(const float* __restrict__ a,
                                          const float* xs, int tn, int lane) {
  float acc = 0.f;
  for (int c = lane * 4; c < tn; c += 128) {
    const float4 av = *reinterpret_cast<const float4*>(a + c);
    const float4 xv = *reinterpret_cast<const float4*>(xs + c);
    acc = fmaf(av.x, xv.x, acc);
    acc = fmaf(av.y, xv.y, acc);
    acc = fmaf(av.z, xv.z, acc);
    acc = fmaf(av.w, xv.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot_tile(const __nv_bfloat16* __restrict__ a,
                                          const float* xs, int tn, int lane) {
  float acc = 0.f;
  for (int c = lane * 8; c < tn; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(a + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 x0 = *reinterpret_cast<const float4*>(xs + c);
    const float4 x1 = *reinterpret_cast<const float4*>(xs + c + 4);
    float2 f = __bfloat1622float2(p[0]);
    acc = fmaf(f.x, x0.x, acc);
    acc = fmaf(f.y, x0.y, acc);
    f = __bfloat1622float2(p[1]);
    acc = fmaf(f.x, x0.z, acc);
    acc = fmaf(f.y, x0.w, acc);
    f = __bfloat1622float2(p[2]);
    acc = fmaf(f.x, x1.x, acc);
    acc = fmaf(f.y, x1.y, acc);
    f = __bfloat1622float2(p[3]);
    acc = fmaf(f.x, x1.z, acc);
    acc = fmaf(f.y, x1.w, acc);
  }
  return acc;
}

__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16(v);
}

template <typename TA>
__global__ void gemv_k(const TA* __restrict__ a, const float* __restrict__ x,
                       TA* __restrict__ y, int64_t rows, int n) {
  __shared__ __align__(16) float xs[kXTile];
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool live = row < rows;
  float acc = 0.f;
  for (int t0 = 0; t0 < n; t0 += kXTile) {
    const int tn = min(kXTile, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < tn; i += blockDim.x) xs[i] = x[t0 + i];
    __syncthreads();
    if (live) acc += dot_tile(a + row * n + t0, xs, tn, lane);
  }
  acc = repro::warp_sum(acc);
  if (live && lane == 0) store(y + row, acc);
}

extern "C" int repro_gemv(const void* a, const void* x, void* y, int64_t rows, int n,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;  // 8 warps: 8 rows per block
  const unsigned blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  const float* xp = static_cast<const float*>(x);
  switch (dtype) {
    case repro::kFloat32:
      gemv_k<float><<<blocks, kThreads, 0, s>>>(static_cast<const float*>(a), xp,
                                                static_cast<float*>(y), rows, n);
      break;
    case repro::kBFloat16:
      gemv_k<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), xp, static_cast<__nv_bfloat16*>(y),
          rows, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
