// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// Each source is built into a shared library of its own, so each carries
// its own repro_error_string (defined once here, per library).
//
// Integer sums run in uint32_t: two's-complement addition in unsigned
// arithmetic wraps exactly as the int32 reference does, while signed
// overflow is undefined in C++.  The int32 buffers are passed through as
// uint32_t pointers to the same bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/cuda_lib.py)
enum Dtype : int { kInt32 = 0, kFloat32 = 1, kBFloat16 = 2 };

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the thread block; the result is valid in thread 0 only.
// blockDim.x must be a multiple of 32.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // part[] may still be read by an earlier call
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = (threadIdx.x < nw) ? part[threadIdx.x] : T(0);
  if (warp == 0) v = warp_sum(v);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    T u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive scan of one value per thread, in thread order; every thread
// also gets the block total.  blockDim.x must be a multiple of 32.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  __shared__ T woff[32];
  __shared__ T tot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // woff / tot may still be read by an earlier call
  const T inc = warp_inclusive_scan(v);
  if (lane == 31) woff[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = (lane < nw) ? woff[lane] : T(0);
    const T wi = warp_inclusive_scan(w);
    T we = __shfl_up_sync(0xffffffffu, wi, 1);
    if (lane == 0) we = T(0);
    if (lane < nw) woff[lane] = we;
    if (lane == 31) tot = wi;
  }
  __syncthreads();
  T ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = T(0);
  *total = tot;
  return woff[warp] + ex;
}

// Sum of one tile of `block` elements, accumulated in T (float or
// uint32_t) in a fixed order; valid in thread 0.
template <typename T>
__device__ __forceinline__ T tile_sum(const T* __restrict__ x, int block) {
  T acc = T(0);
  for (int i = threadIdx.x; i < block; i += blockDim.x) acc += x[i];
  return block_sum(acc);
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
