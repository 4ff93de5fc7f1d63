// histogram: per-bank int32 bin counts of a (banks, n) int32 array, n a
// multiple of `block`; values are clipped into [0, nbins).
//
// Replaces repro/kernels/histogram.py:_hist_kernel, which builds each
// block's counts with a one-hot matmul on the MXU and adds them into one
// output block that every (sequential) grid step revisits.  Hopper has
// fast shared-memory atomics instead, so this is the paper's HST-S: grid
// (n / block, banks), each block counts its tile into a private histogram
// in shared memory, then merges it into its bank's output row with global
// integer atomics (exact in any order).  Where nbins does not fit in 48 KB
// of shared memory, the blocks add into the output row directly.  Bound
// by bytes: 4 bytes read per value; the merge adds nbins atomics per tile.
// The caller zeroes `out`.
#include "common.cuh"

__global__ void hist_shared_k(const int32_t* __restrict__ v, int32_t* __restrict__ out,
                              int64_t n, int block, int nbins) {
  extern __shared__ int32_t h[];
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int64_t bank = blockIdx.y;
  const int32_t* vb = v + bank * n + (int64_t)blockIdx.x * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const int c = min(max(vb[i], 0), nbins - 1);
    atomicAdd(&h[c], 1);
  }
  __syncthreads();
  int32_t* ob = out + bank * nbins;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const int c = h[i];
    if (c) atomicAdd(&ob[i], c);
  }
}

__global__ void hist_global_k(const int32_t* __restrict__ v, int32_t* __restrict__ out,
                              int64_t n, int block, int nbins) {
  const int64_t bank = blockIdx.y;
  const int32_t* vb = v + bank * n + (int64_t)blockIdx.x * block;
  int32_t* ob = out + bank * nbins;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    atomicAdd(&ob[min(max(vb[i], 0), nbins - 1)], 1);
  }
}

extern "C" int repro_histogram(const void* v, void* out, int64_t banks, int64_t n,
                               int block, int nbins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<int>(n / block), banks);
  const int threads = block < 256 ? block : 256;
  const size_t smem = static_cast<size_t>(nbins) * sizeof(int32_t);
  const int32_t* vp = static_cast<const int32_t*>(v);
  int32_t* op = static_cast<int32_t*>(out);
  if (smem <= 48 * 1024) {
    hist_shared_k<<<grid, threads, smem, s>>>(vp, op, n, block, nbins);
  } else {
    hist_global_k<<<grid, threads, 0, s>>>(vp, op, n, block, nbins);
  }
  return cudaGetLastError();
}
