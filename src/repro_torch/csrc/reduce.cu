// reduce_sum: per-bank sum of a (banks, n) array, any n.
//
// Replaces repro/kernels/reduce.py:_reduce_kernel, whose TPU grid runs in
// order and carries one VMEM accumulator from block to block.  Bound by
// bytes: the input is read once (~4 bytes per add).  The design, one
// launch a call:
//   - a bank is cut into `parts` spans of at least kMinSpan values (32 KB),
//     as many as fill the resident blocks (the occupancy API), and the grid
//     is the resident blocks, walking the (bank, span) items with a stride;
//   - each thread issues kUnroll independent 16-byte streaming loads
//     (uint4 / float4, evict-first: the input is read once) before it
//     adds; a row's values before its first 16-byte boundary and
//     after its last whole vector are added once, by the bank's first span,
//     so any n and any 4-byte aligned base take the vector path;
//   - a bank of one span (the suite's 2,048 banks fill the card alone) is
//     written by its block directly;
//   - deterministic combine across blocks, no float atomics: each block
//     writes its span's sum, then __threadfence and an atomicAdd on the
//     bank's int counter tell it whether it arrived last; the last block
//     sums the bank's partials in index order.  The number of spans depends
//     only on the shape and the card, so a float sum is the same on every
//     call.  The wrapper clears the counters on the stream (a torch.zeros
//     of `banks` counters followed by the partials), so calls in a row and
//     calls on two streams never share them.
// Floats accumulate in float32; int32 accumulates in uint32_t and wraps as
// the reference does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // independent 16-byte loads a thread issues
constexpr int64_t kMinSpan = 8192;  // values a block sums at least (32 KB);
                                    // kernels/reduce.py:SPAN is the same

__host__ __device__ constexpr int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ constexpr int64_t lmax(int64_t a, int64_t b) { return a < b ? b : a; }

template <typename T>
struct Vec;
template <>
struct Vec<uint32_t> {
  using type = uint4;
};
template <>
struct Vec<float> {
  using type = float4;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_k(const T* __restrict__ x, T* __restrict__ out, uint32_t* __restrict__ scratch,
             int64_t banks, int64_t n, int parts) {
  using V = typename Vec<T>::type;
  uint32_t* arrived = scratch;                          // (banks,), zero
  T* partials = reinterpret_cast<T*>(scratch + banks);  // (banks, parts)
  __shared__ bool last;
  const int64_t items = banks * parts;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t bank = item / parts;
    const int part = static_cast<int>(item - bank * parts);
    const T* row = x + bank * n;
    const int64_t head =
        lmin(n, ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(T));
    const int64_t nv = (n - head) / 4;
    const V* vec = reinterpret_cast<const V*>(row + head);
    const int64_t lo = nv * part / parts, hi = nv * (part + 1) / parts;
    T acc = T(0);
    for (int64_t i = lo + threadIdx.x; i < hi; i += kUnroll * kThreads) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = i + u * kThreads;
        v[u] = j < hi ? __ldcs(vec + j) : V{};  // read once: evict first
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += (v[u].x + v[u].y) + (v[u].z + v[u].w);
    }
    if (part == 0) {  // the unaligned head and the tail, once a bank
      const int64_t tail = head + 4 * nv;
      if (threadIdx.x < head) acc += row[threadIdx.x];
      if (tail + threadIdx.x < n) acc += row[tail + threadIdx.x];
    }
    acc = repro::block_sum(acc);
    if (parts == 1) {  // the bank is this one span
      if (threadIdx.x == 0) out[bank] = acc;
      continue;
    }
    if (threadIdx.x == 0) {
      partials[item] = acc;
      __threadfence();  // the partial is visible before the count says so
      last = atomicAdd(arrived + bank, 1u) == static_cast<uint32_t>(parts - 1);
    }
    __syncthreads();
    if (last) {  // every partial of the bank is written: sum them in order
      __threadfence();
      T s = T(0);
      for (int i = threadIdx.x; i < parts; i += kThreads) s += __ldcg(partials + bank * parts + i);
      s = repro::block_sum(s);
      if (threadIdx.x == 0) out[bank] = s;
    }
    // the next item's block_sum synchronises before `last` is written again
  }
}

template <typename T>
int launch(const void* x, void* out, void* scratch, int64_t banks, int64_t n, int64_t cap,
           cudaStream_t s) {
  auto kernel = reduce_k<T>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  int64_t parts = (resident + banks - 1) / banks;            // fill the card...
  parts = lmin(parts, lmax(1, (n + kMinSpan - 1) / kMinSpan));  // ...in 32 KB spans
  parts = lmin(parts, cap);
  const int64_t items = banks * parts;
  const unsigned blocks = static_cast<unsigned>(items < resident ? items : resident);
  kernel<<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                     static_cast<uint32_t*>(scratch), banks, n,
                                     static_cast<int>(parts));
  return cudaGetLastError();
}

}  // namespace

// x (banks, n) contiguous; out (banks,); scratch: banks + banks * cap
// 32-bit words, zero, where cap >= 1 bounds the spans of a bank.
extern "C" int repro_reduce_sum(const void* x, void* out, void* scratch, int64_t banks,
                                int64_t n, int64_t cap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (banks < 0 || n < 0 || cap < 1 || cap > (1 << 30)) return cudaErrorInvalidValue;
  if (banks == 0) return cudaSuccess;
  switch (dtype) {
    case repro::kInt32:
      return launch<uint32_t>(x, out, scratch, banks, n, cap, s);
    case repro::kFloat32:
      return launch<float>(x, out, scratch, banks, n, cap, s);
    default:
      return cudaErrorInvalidValue;
  }
}
