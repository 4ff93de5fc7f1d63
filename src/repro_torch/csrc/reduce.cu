// reduce_sum: per-bank sum of a (banks, n) array, n a multiple of `block`.
//
// Replaces repro/kernels/reduce.py:_reduce_kernel, whose TPU grid runs in
// order and carries one VMEM accumulator from block to block.  Hopper
// blocks run in no order, so the sum takes two passes: grid
// (n / block, banks) writes one partial per tile, then one block per bank
// sums its partials in a fixed order.  No float atomics, so a float sum is
// the same from run to run.  Bound by bytes: the input is read once
// (~4 bytes per add).  Floats accumulate in float32; int32 accumulates in
// uint32_t and wraps as the reference does.
#include "common.cuh"

template <typename T>
__global__ void reduce_tiles_k(const T* __restrict__ x, T* __restrict__ partials,
                               int64_t n, int block) {
  const int64_t bank = blockIdx.y;
  const int nb = gridDim.x;
  const T s = repro::tile_sum(x + bank * n + (int64_t)blockIdx.x * block, block);
  if (threadIdx.x == 0) partials[bank * nb + blockIdx.x] = s;
}

template <typename T>
__global__ void reduce_rows_k(const T* __restrict__ partials, T* __restrict__ out,
                              int nb) {
  const int64_t bank = blockIdx.x;
  T acc = T(0);
  for (int i = threadIdx.x; i < nb; i += blockDim.x) acc += partials[bank * nb + i];
  acc = repro::block_sum(acc);
  if (threadIdx.x == 0) out[bank] = acc;
}

template <typename T>
static int launch_reduce(const void* x, void* partials, void* out, int64_t banks,
                         int64_t n, int block, cudaStream_t s) {
  const int nb = static_cast<int>(n / block);
  const int threads = block < 256 ? block : 256;
  reduce_tiles_k<T><<<dim3(nb, banks), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(partials), n, block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_rows_k<T><<<banks, 256, 0, s>>>(static_cast<const T*>(partials),
                                          static_cast<T*>(out), nb);
  return cudaGetLastError();
}

extern "C" int repro_reduce_sum(const void* x, void* partials, void* out,
                                int64_t banks, int64_t n, int block, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kInt32:
      return launch_reduce<uint32_t>(x, partials, out, banks, n, block, s);
    case repro::kFloat32:
      return launch_reduce<float>(x, partials, out, banks, n, block, s);
    default:
      return cudaErrorInvalidValue;
  }
}
