// spmv_ell: y[r] = sum_k (cols[r,k] >= 0 ? f32(vals[r,k]) * x[min(cols[r,k], n-1)] : 0)
// for ELL vals (rows, k) in float32 or bfloat16, cols (rows, k) int32 with
// -1 padding, x (n,) float32; float32 accumulation, y in vals' dtype.
//
// Replaces repro/kernels/spmv.py:_spmv_kernel, which takes (128, k) row
// blocks and gathers from a VMEM-resident x.  The product does 2 flops
// per stored entry, so it is bound by the bytes of vals and cols, each read
// once.  The design:
//   - x in shared memory: each block stages x once when it is at most
//     kSharedX values (32 KB of dynamic shared memory) and gathers from
//     there, as the TPU kernel gathers from VMEM; a longer x is gathered
//     through the read-only path (__ldg);
//   - a row read by several lanes: when k % 4 == 0 and vals and cols are
//     aligned, a row belongs to kLanes = min(k / 4, 8) consecutive lanes
//     (the power of two at or below), each loading 16 bytes of cols and 16
//     bytes of float32 (8 of bfloat16) vals at a time, so one warp load
//     covers one contiguous span; the lanes' float32 sums are combined with
//     __shfl_xor_sync in a fixed order, the same on every run.  Any other k,
//     or unaligned storage, takes one thread per row;
//   - vals are read only where a slot is stored: a 16-byte load of four
//     padded slots (all four cols < 0) is skipped, as is a padded slot of
//     the one-thread-a-row path, so rows with nothing stored cost their
//     cols alone;
//   - as many blocks as the card holds at once, each walking row groups
//     with a grid stride, so x is staged once per block and the 132 SMs
//     are full at every shape (a bank axis is folded into the rows, since x
//     is shared).
// Two edges follow the Pallas kernel: a column at or past n reads x[n-1]
// (the TPU gather clamps), and a padded slot is skipped, so a NaN or inf
// stored there contributes nothing.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedX = 8192;   // float32 values of x staged in shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }

template <bool kShared>
__device__ __forceinline__ void term(float& acc, float v, int c, const float* __restrict__ x,
                                     int n) {
  if (c >= 0) {
    const int i = min(c, n - 1);
    acc = fmaf(v, kShared ? x[i] : __ldg(x + i), acc);
  }
}

// Four consecutive vals of a row as float32.
__device__ __forceinline__ float4 load4(const float* v) {
  return *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(v);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename TV, int kLanes, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_k(const TV* __restrict__ vals, const int* __restrict__ cols,
               const float* __restrict__ x, TV* __restrict__ y, int64_t rows, int k, int n) {
  extern __shared__ float xs[];
  const float* xv = x;
  if (kShared) {
    for (int i = threadIdx.x; i < n; i += kThreads) xs[i] = x[i];
    __syncthreads();
    xv = xs;
  }
  constexpr int kRows = kThreads / kLanes;   // rows of one block step
  const int lane = threadIdx.x % kLanes;
  for (int64_t r0 = (int64_t)blockIdx.x * kRows; r0 < rows; r0 += (int64_t)gridDim.x * kRows) {
    const int64_t r = r0 + threadIdx.x / kLanes;
    float acc = 0.f;
    if (r < rows) {
      const TV* v = vals + r * k;
      const int* c = cols + r * k;
      if (kVec) {
        for (int j = 4 * lane; j < k; j += 4 * kLanes) {
          const int4 cc = *reinterpret_cast<const int4*>(c + j);
          if ((cc.x & cc.y & cc.z & cc.w) < 0) continue;   // four padded slots
          const float4 vv = load4(v + j);
          term<kShared>(acc, vv.x, cc.x, xv, n);
          term<kShared>(acc, vv.y, cc.y, xv, n);
          term<kShared>(acc, vv.z, cc.z, xv, n);
          term<kShared>(acc, vv.w, cc.w, xv, n);
        }
      } else {
        for (int j = lane; j < k; j += kLanes) {
          const int cj = c[j];
          if (cj >= 0) term<kShared>(acc, to_f32(v[j]), cj, xv, n);
        }
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (r < rows && lane == 0) store(y + r, acc);
  }
}

template <typename TV, int kLanes, bool kVec, bool kShared>
cudaError_t run(const TV* v, const int* c, const float* x, TV* y, int64_t rows, int k, int n,
                cudaStream_t s) {
  auto kernel = spmv_ell_k<TV, kLanes, kVec, kShared>;
  const size_t smem = kShared ? n * sizeof(float) : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  constexpr int kRows = kThreads / kLanes;
  const int64_t steps = (rows + kRows - 1) / kRows;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(steps < resident ? steps : resident);
  kernel<<<blocks, kThreads, smem, s>>>(v, c, x, y, rows, k, n);
  return cudaGetLastError();
}

template <typename TV, bool kShared>
cudaError_t pick_lanes(const TV* v, const int* c, const float* x, TV* y, int64_t rows, int k,
                       int n, cudaStream_t s) {
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(v) % (4 * sizeof(TV)) == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (!vec) return run<TV, 1, false, kShared>(v, c, x, y, rows, k, n, s);
  const int lanes = k / 4;
  if (lanes >= 8) return run<TV, 8, true, kShared>(v, c, x, y, rows, k, n, s);
  if (lanes >= 4) return run<TV, 4, true, kShared>(v, c, x, y, rows, k, n, s);
  if (lanes >= 2) return run<TV, 2, true, kShared>(v, c, x, y, rows, k, n, s);
  return run<TV, 1, true, kShared>(v, c, x, y, rows, k, n, s);
}

template <typename TV>
cudaError_t launch(const void* vals, const void* cols, const void* x, void* y, int64_t rows,
                   int k, int n, cudaStream_t s) {
  if (rows == 0) return cudaSuccess;
  const TV* v = static_cast<const TV*>(vals);
  const int* c = static_cast<const int*>(cols);
  const float* xp = static_cast<const float*>(x);
  TV* yp = static_cast<TV*>(y);
  if (n <= kSharedX) return pick_lanes<TV, true>(v, c, xp, yp, rows, k, n, s);
  return pick_lanes<TV, false>(v, c, xp, yp, rows, k, n, s);
}

}  // namespace

extern "C" int repro_spmv_ell(const void* vals, const void* cols, const void* x, void* y,
                              int64_t rows, int k, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(vals, cols, x, y, rows, k, n, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(vals, cols, x, y, rows, k, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}
