// flash_attention: o[b,h] = softmax(mask(q[b,h] k[b,kvh]^T * scale)) v[b,kvh]
// with kvh = h / (H / KVH) (GQA), for q (B, H, S, D) and k, v (B, KVH, T, D),
// all contiguous, in float32 or bfloat16; float32 scores, softmax and
// accumulation; o (B, H, S, D) in q's dtype.  Query row i sits at position
// i + (T - S).  A key is live when kpos < T, kpos <= qpos (causal) and
// kpos > qpos - window (window); a row with no live key gives 0, not NaN.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel, whose grid
// (B, H, q blocks, kv blocks) carries the online-softmax state (m, l, acc)
// in VMEM scratch across the sequential kv axis.  Hopper blocks run in no
// order, so the kv axis becomes a loop inside the block: one block per
// (query tile, head, batch) keeps m, l and the accumulator in registers and
// walks the key tiles that the causal / window band can reach, skipping the
// rest, as the Pallas kernel's pl.when does; only tiles that cross the
// diagonal, the window edge or T are masked.
//
// Bound: at the main path's shapes the work is 4*D flops per live (q, k)
// pair against about 4*S*D bytes of q, k, v and o per head, far above the
// card's ridge point, so the bound is operations.
//
// bfloat16 (flash_bf16_k): the tensor cores.  A block is 384 threads: two
// consumer warpgroups of 64 query rows each and a producer warpgroup whose
// one thread issues the TMA loads: Q once, then K and V tiles through a
// 2-stage ring of shared-memory buffers completed on mbarriers, so the
// next tile's loads overlap this tile's products.  S = Q K^T is a wgmma
// with both operands K-major in shared memory (128-byte swizzle; D in boxes
// of 64, zero-filled past D); the scaled scores go through the online
// softmax in registers (ex2.approx, scale * log2 e folded in); P is fed
// from registers as the A of O += P V, rounded once to bfloat16, except in
// the masked tiles, where it runs as three bfloat16 terms (float32's 24
// bits): they hold every key of a row that sees few keys, whose output, a
// mean of a few values, would carry P's rounding whole.  V is read
// from shared memory as an MN-major B (the transpose bit set).  The head
// dim is padded up to 64, 128, 192 or 256 in shared memory only; D % 8 == 0
// and 16-byte aligned bases are the TMA's terms (the wrapper pads and
// copies to meet them).  Blocks run heaviest query tile first, with the
// query heads of one KV head adjacent so that their K / V tiles meet in L2.
//
// float32 (flash_k): the CUDA cores in float32, so that the float32
// forward checks hold (no TF32).  Q, K, V and P tiles staged once in shared
// memory, padded so that the 16-byte loads of one quarter-warp hit distinct
// banks; each thread owns a 4 x 4 block of the score tile and a 4-row x
// 4-column block of the output per 64 columns, so every shared-memory load
// feeds four multiply-adds.  Any D up to 256 runs, with the columns past D
// held at zero in shared memory.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTile = 64;       // query rows per block, keys per kv tile
constexpr int kThreads = 256;   // 16 row groups x 16 key / column groups
constexpr int kPS = kTile + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Stage kTile rows of `d` elements (row stride d in src) into dst as
// float32 with row stride dp; rows at or past `valid` and columns in
// [d, d4) are zero.  `vec`: d % 4 == 0 and src 4-element aligned.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ src,
                                      int valid, int d, int d4, int dp, bool vec) {
  const int groups = d4 >> 2;
  for (int i = threadIdx.x; i < kTile * groups; i += kThreads) {
    const int r = i / groups, c = (i - r * groups) << 2;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      const T* s = src + (int64_t)r * d + c;
      if (vec) {
        val = load4(s);
      } else {
        val.x = to_f32(s[0]);
        val.y = c + 1 < d ? to_f32(s[1]) : 0.f;
        val.z = c + 2 < d ? to_f32(s[2]) : 0.f;
        val.w = c + 3 < d ? to_f32(s[3]) : 0.f;
      }
    }
    *reinterpret_cast<float4*>(dst + r * dp + c) = val;
  }
}

// kCols: 64-column groups of the output each thread covers (D <= 64 * kCols).
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
    flash_k(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int H, int KVH, int S, int Tn, int d, int d4, int dp,
            float scale, int causal, int use_window, int window, int vec) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kTile x dp
  float* Ks = Qs + kTile * dp;                   // kTile x dp
  float* Vs = Ks + kTile * dp;                   // kTile x dp
  float* Ps = Vs + kTile * dp;                   // kTile x kPS

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int off = Tn - S;  // query i sits at position i + off
  const T* qb = q + (((int64_t)b * H + h) * S + q0) * d;
  const T* kb = k + ((int64_t)b * KVH + kvh) * Tn * d;
  const T* vb = v + ((int64_t)b * KVH + kvh) * Tn * d;

  const int rg = threadIdx.x >> 4;  // rows rg*4 .. rg*4+3 of the tile
  const int cg = threadIdx.x & 15;  // keys cg + 16j; output columns cg*4 + 64n

  stage(Qs, qb, min(kTile, S - q0), d, d4, dp, vec);

  float m[4], l[4], acc[4][kCols][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  // the keys this tile's rows can see: [kbeg, kend), kbeg tile-aligned
  const int qlo = q0 + off, qhi = min(q0 + kTile, S) - 1 + off;
  const int kend = causal ? min(Tn, qhi + 1) : Tn;
  const int kbeg = use_window ? max(0, qlo - window + 1) / kTile * kTile : 0;

  for (int k0 = kbeg; k0 < kend; k0 += kTile) {
    __syncthreads();  // the last tile's reads of Ks / Vs / Ps are done
    const int kvalid = min(kTile, Tn - k0);
    stage(Ks, kb + (int64_t)k0 * d, kvalid, d, d4, dp, vec);
    stage(Vs, vb + (int64_t)k0 * d, kvalid, d, d4, dp, vec);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d4; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * dp + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (cg + 16 * j) * dp + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, then the online-softmax update of each row; the 16 threads
    // that share a row group are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i + off;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        live[j] = kpos < Tn && (!causal || kpos <= qpos) &&
                  (!use_window || kpos > qpos - window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float mnew = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - mnew) : 0.f;
        Ps[(rg * 4 + i) * kPS + cg + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      l[i] = l[i] * alpha + sum;
      m[i] = mnew;
#pragma unroll
      for (int n = 0; n < kCols; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha;
    }
    __syncthreads();  // Ps complete

    // acc += P V over this tile's keys
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (rg * 4 + i) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int n = 0; n < kCols; ++n) {
          const int c = cg * 4 + 64 * n;
          if (c < d4) {
            const float4 vv = *reinterpret_cast<const float4*>(Vs + (kk + u) * dp + c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = lane(p4[i], u);
              acc[i][n][0] = fmaf(p, vv.x, acc[i][n][0]);
              acc[i][n][1] = fmaf(p, vv.y, acc[i][n][1]);
              acc[i][n][2] = fmaf(p, vv.z, acc[i][n][2]);
              acc[i][n][3] = fmaf(p, vv.w, acc[i][n][3]);
            }
          }
        }
      }
    }
  }

  // o = acc / l, with l == 0 (no live key) divided by 1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((int64_t)b * H + h) * S + row) * d;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      const int c = cg * 4 + 64 * n;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) store(orow + c + e, acc[i][n][e] / lsafe);
    }
  }
}

template <typename T, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int H,
                   int KVH, int S, int Tn, int d, int causal, int use_window, int window,
                   float scale, cudaStream_t s) {
  const int d4 = (d + 3) & ~3;
  // a row stride of an odd number of 16-byte groups keeps the 16-byte loads
  // of 8 consecutive rows on distinct banks
  const int dp = d4 + ((d4 >> 2) % 2 == 0 ? 4 : 8);
  const size_t smem = sizeof(float) * ((size_t)3 * kTile * dp + (size_t)kTile * kPS);
  auto kern = flash_k<T, kCols>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), (unsigned)H, (unsigned)B);
  kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(o), H, KVH, S,
                                    Tn, d, d4, dp, scale, causal, use_window, window, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int64_t B, int H,
                     int KVH, int S, int Tn, int d, int causal, int use_window, int window,
                     float scale, cudaStream_t s) {
  if (d <= 64)
    return launch<T, 1>(q, k, v, o, B, H, KVH, S, Tn, d, causal, use_window, window, scale, s);
  if (d <= 128)
    return launch<T, 2>(q, k, v, o, B, H, KVH, S, Tn, d, causal, use_window, window, scale, s);
  return launch<T, 4>(q, k, v, o, B, H, KVH, S, Tn, d, causal, use_window, window, scale, s);
}

// ---- bfloat16: wgmma fed by TMA ------------------------------------------------

constexpr int kBM = 128;               // query rows per block: two warpgroups of 64
constexpr int kStages = 2;             // K / V ring
constexpr int kBf16Threads = 384;      // consumers 0-255, producer 256-383
constexpr int kBox = 64 * 2;           // bytes of one 64-wide swizzled row
constexpr float kLog2e = 1.4426950408889634f;

template <int kDp, int kBN>
struct FlashTiles {
  static constexpr int kBoxes = kDp / 64;
  static constexpr int kQBytes = kBoxes * kBM * kBox;   // Q: kBoxes x [kBM][64]
  static constexpr int kKVBytes = kBoxes * kBN * kBox;  // K or V: kBoxes x [kBN][64]
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;  // + alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile for a thread's rows qpos0 and
// qpos0 + 8: s[4 j + 2 hr + c] is the score of row qpos0 + 8 hr and key
// kpos0 + 8 j + c.  Scores are scaled into the log2 domain (scale * log2 e);
// m and l are the rows' running max and sum, and the output accumulator is
// rescaled by exp2(m_old - m_new).  On return s holds P in float32.
// kMasked: keys dead by T, causal or window score the finite kNegInf and
// give p = 0 (so a row with no live key yet keeps l = 0 and a zero output).
template <int kBN, bool kMasked, int kO>
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float (&m)[2], float (&l)[2],
                                             float sl2, int qpos0, int kpos0, int Tn,
                                             int causal, int use_window, int window,
                                             float (&oacc)[kO]) {
  float alpha[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qpos = qpos0 + 8 * hr;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * hr + c];
        x *= sl2;
        if constexpr (kMasked) {
          const int kpos = kpos0 + 8 * j + c;
          const bool live = kpos < Tn && (!causal || kpos <= qpos) &&
                            (!use_window || kpos > qpos - window);
          x = live ? x : kNegInf;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mnew = fmaxf(m[hr], mx);
    alpha[hr] = ex2(m[hr] - mnew);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * hr + c];
        const float p = ex2(x - mnew);
        x = kMasked && x == kNegInf ? 0.f : p;  // a dead key is exactly kNegInf
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[hr] = l[hr] * alpha[hr] + sum;
    m[hr] = mnew;
  }
#pragma unroll
  for (int i = 0; i < kO / 4; ++i) {
    oacc[4 * i + 0] *= alpha[0];
    oacc[4 * i + 1] *= alpha[0];
    oacc[4 * i + 2] *= alpha[1];
    oacc[4 * i + 3] *= alpha[1];
  }
}

// O += P V over one tile of kBN keys (V at Vs, MN-major): the P fragment
// packed to bf16x2 as the register A of each 16-key step.  kTerms = 1 rounds
// P once to bfloat16; kTerms = 3 runs p = p1 + p2 + p3 (three bfloat16
// terms, float32's 24 bits), one product each.
template <int kDp, int kBN, int kTerms>
__device__ __forceinline__ void pv_product(float (&oacc)[kDp / 2], float (&p)[kBN / 2],
                                           const uint8_t* Vs) {
#pragma unroll
  for (int term = 0; term < kTerms; ++term) {
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float& lo = p[8 * kk + 2 * r];
        float& hi = p[8 * kk + 2 * r + 1];
        pa[kk][r] = hopper::pack_bf16(lo, hi);
        if (term + 1 < kTerms) {  // what this term left over
          lo -= __uint_as_float(pa[kk][r] << 16);
          hi -= __uint_as_float(pa[kk][r] & 0xffff0000u);
        }
      }
    hopper::fence_operands(oacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      hopper::wgmma_rs<kDp, 1>(oacc, pa[kk],
                               hopper::desc_sw128(Vs + kk * 16 * kBox, kBN * kBox, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(oacc);
  }
}

// kDp: head dim padded to a multiple of 64 (N of P V); kBN: keys per tile.
template <int kDp, int kBN>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bf16_k(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                 int B, int H, int KVH, int S, int Tn, int d, int nq, float scale_log2,
                 int causal, int use_window, int window) {
  using Tiles = FlashTiles<kDp, kBN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + Tiles::kQBytes;  // stage s: K at s * 2 * kKVBytes, V after it
  __shared__ uint64_t q_full, full[kStages], empty[kStages];

  // heaviest query tiles first; the heads of one batch row adjacent, so the
  // query heads of one KV head read its tiles side by side
  int id = blockIdx.x;
  const int h = id % H;
  id /= H;
  const int b = id % B;
  const int q0 = (nq - 1 - id / B) * kBM;
  const int kvh = h / (H / KVH);
  const int off = Tn - S;  // query i sits at position i + off
  const int qlo = q0 + off, qhi = min(q0 + kBM, S) - 1 + off;
  const int kend = causal ? min(Tn, qhi + 1) : Tn;
  const int kbeg = use_window ? max(0, qlo - window + 1) / kBN * kBN : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && ntiles > 0) {
      hopper::mbar_arrive_expect_tx(&q_full, Tiles::kQBytes);
      for (int bx = 0; bx < Tiles::kBoxes; ++bx)
        hopper::tma_load_3d(Qs + bx * kBM * kBox, &qmap, &q_full, bx * 64, q0, b * H + h);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        hopper::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * Tiles::kKVBytes);
        uint8_t* Ks = KVs + s * 2 * Tiles::kKVBytes;
        uint8_t* Vs = Ks + Tiles::kKVBytes;
        const int k0 = kbeg + j * kBN, row = b * KVH + kvh;
        for (int bx = 0; bx < Tiles::kBoxes; ++bx) {
          hopper::tma_load_3d(Ks + bx * kBN * kBox, &kmap, &full[s], bx * 64, k0, row);
          hopper::tma_load_3d(Vs + bx * kBN * kBox, &vmap, &full[s], bx * 64, k0, row);
        }
      }
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64 wg ...
    hopper::setmaxnreg_inc<240>();
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64 + wq * 16 + g;  // this thread's rows r0, r0 + 8
    float oacc[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) oacc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    if (ntiles > 0) hopper::mbar_wait(&q_full, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      const int k0 = kbeg + j * kBN;
      hopper::mbar_wait(&full[s], (j / kStages) & 1);
      const uint8_t* Ks = KVs + s * 2 * Tiles::kKVBytes;
      const uint8_t* Vs = Ks + Tiles::kKVBytes;

      // S = Q K^T over D in steps of 16
      float sacc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sacc[i] = 0.f;
      hopper::fence_operands(sacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(
            Qs + (kk / 4) * kBM * kBox + wg * 64 * kBox + (kk % 4) * 32, 16, 1024);
        const uint64_t db =
            hopper::desc_sw128(Ks + (kk / 4) * kBN * kBox + (kk % 4) * 32, 16, 1024);
        hopper::wgmma_ss<kBN, 0>(sacc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sacc);

      // only a tile that crosses the diagonal, the window edge or T is masked
      const bool masked = k0 + kBN > Tn || (causal && k0 + kBN - 1 > qlo) ||
                          (use_window && k0 <= qhi - window);
      if (masked) {
        softmax_tile<kBN, true>(sacc, m, l, scale_log2, r0 + off, k0 + 2 * t, Tn, causal,
                                use_window, window, oacc);
        pv_product<kDp, kBN, 3>(oacc, sacc, Vs);
      } else {
        softmax_tile<kBN, false>(sacc, m, l, scale_log2, r0 + off, k0 + 2 * t, Tn, causal,
                                 use_window, window, oacc);
        pv_product<kDp, kBN, 1>(oacc, sacc, Vs);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // o = acc / l, with l == 0 (no live key) divided by 1; d % 8 == 0, so a
    // column pair is in or out together
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row >= S) continue;
      const float inv = 1.f / (l[hr] == 0.f ? 1.f : l[hr]);
      __nv_bfloat16* orow = o + (((int64_t)b * H + h) * S + row) * d;
#pragma unroll
      for (int j8 = 0; j8 < kDp / 8; ++j8) {
        const int col = 8 * j8 + 2 * t;
        if (col < d)
          *reinterpret_cast<uint32_t*>(orow + col) = hopper::pack_bf16(
              oacc[4 * j8 + 2 * hr] * inv, oacc[4 * j8 + 2 * hr + 1] * inv);
      }
    }
  }
}

template <int kDp, int kBN>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int64_t B, int H,
                        int KVH, int S, int Tn, int d, int causal, int use_window, int window,
                        float scale, cudaStream_t s) {
  using Tiles = FlashTiles<kDp, kBN>;
  CUtensorMap qm, km, vm;
  if (!hopper::bf16_map_3d(&qm, q, d, S, B * H, kBM) ||
      !hopper::bf16_map_3d(&km, k, d, Tn, B * KVH, kBN) ||
      !hopper::bf16_map_3d(&vm, v, d, Tn, B * KVH, kBN))
    return cudaErrorInvalidValue;
  auto kern = flash_bf16_k<kDp, kBN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tiles::kSmem);
  if (err != cudaSuccess) return err;
  const int nq = (S + kBM - 1) / kBM;
  const int64_t blocks = (int64_t)nq * B * H;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kBf16Threads, Tiles::kSmem, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), (int)B, H, KVH, S, Tn, d, nq,
      scale * kLog2e, causal, use_window, window);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int64_t B,
                          int H, int KVH, int S, int Tn, int d, int causal, int use_window,
                          int window, float scale, cudaStream_t s) {
  // the TMA's terms: rows of a multiple of 16 bytes, 16-byte aligned bases
  if (d % 8 || reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || reinterpret_cast<uintptr_t>(o) % 16)
    return cudaErrorInvalidValue;
  if (d <= 64)
    return launch_bf16<64, 128>(q, k, v, o, B, H, KVH, S, Tn, d, causal, use_window, window,
                                scale, s);
  if (d <= 128)
    return launch_bf16<128, 128>(q, k, v, o, B, H, KVH, S, Tn, d, causal, use_window, window,
                                 scale, s);
  if (d <= 192)
    return launch_bf16<192, 64>(q, k, v, o, B, H, KVH, S, Tn, d, causal, use_window, window,
                                scale, s);
  return launch_bf16<256, 64>(q, k, v, o, B, H, KVH, S, Tn, d, causal, use_window, window,
                              scale, s);
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int64_t B, int H, int KVH, int S, int T, int D,
                                     int causal, int use_window, int window, float scale,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 0 || H < 1 || KVH < 1 || H % KVH || S < 0 || T < 0 || D < 1 || D > kMaxD ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  switch (dtype) {
    case repro::kFloat32:
      return dispatch<float>(q, k, v, o, B, H, KVH, S, T, D, causal, use_window, window,
                             scale, s);
    case repro::kBFloat16:
      return dispatch_bf16(q, k, v, o, B, H, KVH, S, T, D, causal, use_window, window, scale,
                           s);
    default:
      return cudaErrorInvalidValue;
  }
}
