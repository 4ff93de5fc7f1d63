// spmv_ell: y[r] = sum_k (cols[r,k] >= 0 ? f32(vals[r,k]) * x[min(cols[r,k], n-1)] : 0)
// for ELL vals (rows, k) in float32 or bfloat16, cols (rows, k) int32 with
// -1 padding, x (n,) float32; float32 accumulation, y in vals' dtype.
//
// Replaces repro/kernels/spmv.py:_spmv_kernel, which takes (128, k) row
// blocks and gathers from a VMEM-resident x.  The product does 2 flops
// per stored entry, so it is bound by the bytes of vals and cols.  The
// design streams both once: one thread per row (a bank axis is folded
// into the rows, since x is shared), 16-byte loads of vals and cols when
// k % 4 == 0 and both are 16-byte aligned (8-byte loads of 4 bfloat16),
// and x gathered through the read-only path, where a bank-sized x stays
// in L1.  Two edges follow the Pallas kernel: a column at or past n reads
// x[n-1] (the TPU gather clamps), and a padded slot is skipped, so a NaN
// or inf stored there contributes nothing.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }

__device__ __forceinline__ void term(float& acc, float v, int c, const float* __restrict__ x,
                                     int n) {
  if (c >= 0) acc = fmaf(v, __ldg(x + min(c, n - 1)), acc);
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

template <typename TV, bool kVec>
__global__ void spmv_ell_k(const TV* __restrict__ vals, const int* __restrict__ cols,
                           const float* __restrict__ x, TV* __restrict__ y, int64_t rows,
                           int k, int n) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const TV* v = vals + r * k;
  const int* c = cols + r * k;
  float acc = 0.f;
  if (kVec) {
    for (int j = 0; j < k; j += 4) {
      const int4 cc = *reinterpret_cast<const int4*>(c + j);
      const float4 vv = load4(v + j);
      term(acc, vv.x, cc.x, x, n);
      term(acc, vv.y, cc.y, x, n);
      term(acc, vv.z, cc.z, x, n);
      term(acc, vv.w, cc.w, x, n);
    }
  } else {
    for (int j = 0; j < k; ++j) term(acc, to_f32(v[j]), c[j], x, n);
  }
  store(y + r, acc);
}

template <typename TV>
cudaError_t launch(const void* vals, const void* cols, const void* x, void* y, int64_t rows,
                   int k, int n, cudaStream_t s) {
  constexpr int kThreads = 256;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  const TV* v = static_cast<const TV*>(vals);
  const int* c = static_cast<const int*>(cols);
  const float* xp = static_cast<const float*>(x);
  TV* yp = static_cast<TV*>(y);
  if (vec)
    spmv_ell_k<TV, true><<<blocks, kThreads, 0, s>>>(v, c, xp, yp, rows, k, n);
  else
    spmv_ell_k<TV, false><<<blocks, kThreads, 0, s>>>(v, c, xp, yp, rows, k, n);
  return cudaGetLastError();
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
