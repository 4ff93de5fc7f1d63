// scan_inclusive: per-bank inclusive (or exclusive) prefix sum of a
// (banks, n) array, n a multiple of 4, the row starts 16-byte aligned.
//
// Replaces repro/kernels/scan.py:_scan_kernel, whose TPU grid runs in
// order and carries the running block total in VMEM.  Bound by bytes: the
// least the card can move is the input read once and the output written
// once, 2 * banks * n * 4 bytes.  Hopper blocks run in no order, so the
// carry becomes a single-pass scan with decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), one launch that reads each input byte once and writes each
// output byte once:
//   - a block of 512 threads takes its tile (kTile = 8192 values, 16 a
//     thread) from a counter, in bank-major order, so every tile before it
//     has already started;
//   - 16-byte coalesced loads, moved through swizzled shared memory into
//     16 consecutive values a thread (no bank conflicts either way); each
//     thread scans its values, then a block scan of the thread totals;
//   - the tile publishes its aggregate, warp 0 walks back over the
//     status words of the tiles before it, 32 at a time, adding aggregates
//     until it meets an inclusive prefix, then publishes its own; the
//     bank's first tile publishes its prefix at once, so a look-back never
//     leaves its bank;
//   - the output goes back through shared memory to coalesced stores;
//     `exclusive` writes inclusive - x from registers, the operation that
//     ops.scan_exclusive's formula applies to the inclusive result.
// A status word is 64 bits: the flag (0 not ready, 1 aggregate, 2
// inclusive prefix) above the 32-bit value, stored with st.release.gpu and
// read with ld.acquire.gpu.  The words and the tile counter are cleared on
// the stream by the wrapper before each call (a zeroed buffer from the
// caching allocator), so calls in a row and calls on two streams never
// share them.
//
// Numbers: int32 runs in uint32_t and wraps, exact on every run.  float32
// accumulates in float32; which predecessors had published a prefix when a
// tile looked back decides the order of its adds, so float32 results may
// differ from run to run in their last bits (within 1e-6 * sum |x| over the
// prefix).
#include "common.cuh"

namespace {

constexpr int kThreads = 512, kItems = 16, kTile = kThreads * kItems;
constexpr int kSlots = kTile / 4;           // 16-byte slots of one tile
constexpr uint64_t kAggregate = 1ull << 32, kPrefix = 2ull << 32;

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t bits(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

template <typename T>
__device__ __forceinline__ T value(uint32_t b);
template <>
__device__ __forceinline__ uint32_t value<uint32_t>(uint32_t b) { return b; }
template <>
__device__ __forceinline__ float value<float>(uint32_t b) { return __uint_as_float(b); }

// Slot s of a tile lives at s ^ ((s / 8) & 3).  A quarter-warp's 16-byte
// accesses fall on distinct 16-byte bank groups both when 8 threads touch 8
// consecutive slots (the striped load and store) and when they touch slots
// 4t + m of threads t (each thread's own 16 values).
__device__ __forceinline__ int swz(int s) { return s ^ ((s >> 3) & 3); }

template <typename T>
__device__ __forceinline__ T warp_total(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exclusive prefix of `tile` within its bank, whose first tile is
// `tile - in_bank` (in_bank > 0); called by all of warp 0.  Lane l reads the
// status of tile `last - l`; once no word in the window is "not ready", the
// window's values up to the nearest inclusive prefix are summed.  Tiles
// before the bank's first count as a prefix of 0.
template <typename T>
__device__ T look_back(const uint64_t* status, int64_t tile, int in_bank) {
  const int lane = threadIdx.x & 31;
  const int64_t first = tile - in_bank;
  T prefix = T(0);
  for (int64_t last = tile - 1;; last -= 32) {
    const int64_t p = last - lane;
    uint64_t w = kPrefix;
    if (p >= first) w = load_acquire(status + p);
    while (__any_sync(0xffffffffu, (w >> 32) == 0)) {
      if ((w >> 32) == 0) w = load_acquire(status + p);
    }
    const unsigned done = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    prefix += warp_total(lane <= stop ? value<T>(static_cast<uint32_t>(w)) : T(0));
    if (done) return prefix;
  }
}

template <typename T, bool kExclusive>
__global__ void __launch_bounds__(kThreads)
    scan_k(const T* __restrict__ x, T* __restrict__ y, uint64_t* status,
           unsigned* counter, int64_t n, int tiles_per_bank) {
  __shared__ uint4 stage[kSlots];
  __shared__ unsigned tile_id;
  __shared__ T tile_prefix;
  if (threadIdx.x == 0) tile_id = atomicAdd(counter, 1u);
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t bank = tile / tiles_per_bank;
  const int in_bank = static_cast<int>(tile - bank * tiles_per_bank);
  const int64_t start = bank * n + static_cast<int64_t>(in_bank) * kTile;
  const int64_t left = n - static_cast<int64_t>(in_bank) * kTile;
  const int slots = static_cast<int>(left < kTile ? left : kTile) / 4;

  const uint4* src = reinterpret_cast<const uint4*>(x + start);
#pragma unroll
  for (int i = 0; i < kItems / 4; ++i) {
    const int s = i * kThreads + threadIdx.x;
    stage[swz(s)] = s < slots ? src[s] : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  T item[kItems], run[kItems];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint4 v = stage[swz(threadIdx.x * 4 + m)];
    item[4 * m] = value<T>(v.x);
    item[4 * m + 1] = value<T>(v.y);
    item[4 * m + 2] = value<T>(v.z);
    item[4 * m + 3] = value<T>(v.w);
  }
  run[0] = item[0];
#pragma unroll
  for (int k = 1; k < kItems; ++k) run[k] = run[k - 1] + item[k];

  T aggregate;
  const T offset = repro::block_exclusive_scan(run[kItems - 1], &aggregate);
  if (threadIdx.x < 32) {
    T prefix = T(0);
    if (in_bank == 0) {
      if (threadIdx.x == 0) store_release(status + tile, kPrefix | bits(aggregate));
    } else {
      if (threadIdx.x == 0) store_release(status + tile, kAggregate | bits(aggregate));
      prefix = look_back<T>(status, tile, in_bank);
      if (threadIdx.x == 0) store_release(status + tile, kPrefix | bits(prefix + aggregate));
    }
    if (threadIdx.x == 0) tile_prefix = prefix;
  }
  __syncthreads();
  const T base = tile_prefix + offset;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    T out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T inc = base + run[4 * m + j];
      out[j] = kExclusive ? inc - item[4 * m + j] : inc;
    }
    stage[swz(threadIdx.x * 4 + m)] = make_uint4(bits(out[0]), bits(out[1]), bits(out[2]),
                                                 bits(out[3]));
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(y + start);
#pragma unroll
  for (int i = 0; i < kItems / 4; ++i) {
    const int s = i * kThreads + threadIdx.x;
    if (s < slots) dst[s] = stage[swz(s)];
  }
}

template <typename T>
int launch_scan(const void* x, void* y, void* scratch, int64_t scratch_words, int64_t banks,
                int64_t n, bool exclusive, cudaStream_t s) {
  const int64_t per = (n + kTile - 1) / kTile;
  const int64_t tiles = banks * per;
  if (tiles == 0) return cudaSuccess;
  if (n % 4 || tiles > 0x7fffffff || scratch_words < tiles + 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  uint64_t* status = static_cast<uint64_t*>(scratch);
  unsigned* counter = reinterpret_cast<unsigned*>(status + tiles);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int p = static_cast<int>(per);
  if (exclusive)
    scan_k<T, true><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(xp, yp, status, counter, n, p);
  else
    scan_k<T, false><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(xp, yp, status, counter, n, p);
  return cudaGetLastError();
}

}  // namespace

// `scratch`: `scratch_words` zeroed 64-bit words, at least one status word
// for each of the banks * ceil(n / kTile) tiles and one more for the tile
// counter.
extern "C" int repro_scan_inclusive(const void* x, void* y, void* scratch,
                                    int64_t scratch_words, int64_t banks, int64_t n,
                                    int exclusive, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kInt32:
      return launch_scan<uint32_t>(x, y, scratch, scratch_words, banks, n, exclusive != 0, s);
    case repro::kFloat32:
      return launch_scan<float>(x, y, scratch, scratch_words, banks, n, exclusive != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}
