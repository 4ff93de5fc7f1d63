// scan_inclusive: per-bank inclusive prefix sum of a (banks, n) array, n a
// multiple of `block`.
//
// Replaces repro/kernels/scan.py:_scan_kernel, whose TPU grid runs in
// order and carries the running block total in VMEM.  Hopper blocks run in
// no order, so the carry becomes three launches (reduce-then-scan):
//   1. grid (n / block, banks): one total per tile;
//   2. one block per bank: exclusive scan of its tile totals -> offsets;
//   3. grid (n / block, banks): each tile is staged in shared memory, each
//      thread scans a run of block / threads consecutive elements, a block
//      scan of the run totals gives each run its start, plus the offset.
// Bound by bytes: the input is read twice (passes 1 and 3) and the output
// written once; the tile totals are 1/block of that.  Floats accumulate in
// float32; int32 runs in uint32_t and wraps as the reference does.
#include "common.cuh"

template <typename T>
__global__ void scan_tile_totals_k(const T* __restrict__ x, T* __restrict__ totals,
                                   int64_t n, int block) {
  const int64_t bank = blockIdx.y;
  const int nb = gridDim.x;
  const T s = repro::tile_sum(x + bank * n + (int64_t)blockIdx.x * block, block);
  if (threadIdx.x == 0) totals[bank * nb + blockIdx.x] = s;
}

template <typename T>
__global__ void scan_offsets_k(const T* __restrict__ totals, T* __restrict__ offsets,
                               int nb) {
  const int64_t row = (int64_t)blockIdx.x * nb;
  T carry = T(0);
  for (int base = 0; base < nb; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const T v = (i < nb) ? totals[row + i] : T(0);
    T tot;
    const T ex = repro::block_exclusive_scan(v, &tot);
    if (i < nb) offsets[row + i] = carry + ex;
    carry += tot;
  }
}

template <typename T>
__global__ void scan_tiles_k(const T* __restrict__ x, const T* __restrict__ offsets,
                             T* __restrict__ y, int64_t n, int block) {
  __shared__ T tile[repro::kMaxBlock];
  const int64_t bank = blockIdx.y;
  const int nb = gridDim.x;
  const int64_t base = bank * n + (int64_t)blockIdx.x * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x) tile[i] = x[base + i];
  __syncthreads();
  const int per = block / blockDim.x;
  const int first = threadIdx.x * per;
  T run = T(0);
  for (int k = 0; k < per; ++k) {
    run += tile[first + k];
    tile[first + k] = run;
  }
  T tot;
  const T off = offsets[bank * nb + blockIdx.x] + repro::block_exclusive_scan(run, &tot);
  for (int k = 0; k < per; ++k) tile[first + k] += off;
  __syncthreads();
  for (int i = threadIdx.x; i < block; i += blockDim.x) y[base + i] = tile[i];
}

template <typename T>
static int launch_scan(const void* x, void* totals, void* offsets, void* y,
                       int64_t banks, int64_t n, int block, cudaStream_t s) {
  const int nb = static_cast<int>(n / block);
  const int threads = block < 256 ? block : 256;
  const dim3 grid(nb, banks);
  scan_tile_totals_k<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(totals), n, block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  scan_offsets_k<T><<<banks, 256, 0, s>>>(static_cast<const T*>(totals),
                                           static_cast<T*>(offsets), nb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  scan_tiles_k<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(offsets), static_cast<T*>(y),
      n, block);
  return cudaGetLastError();
}

extern "C" int repro_scan_inclusive(const void* x, void* totals, void* offsets,
                                    void* y, int64_t banks, int64_t n, int block,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kInt32:
      return launch_scan<uint32_t>(x, totals, offsets, y, banks, n, block, s);
    case repro::kFloat32:
      return launch_scan<float>(x, totals, offsets, y, banks, n, block, s);
    default:
      return cudaErrorInvalidValue;
  }
}
