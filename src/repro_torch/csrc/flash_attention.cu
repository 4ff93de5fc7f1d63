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
// (64-row query tile, head, batch) keeps m, l and the accumulator in
// registers and walks the 64-key tiles that the causal / window band can
// reach, skipping the rest, as the Pallas kernel's pl.when does.
//
// Bound: at the main path's shapes the work is 4*D flops per live (q, k)
// pair against about 4*S*D bytes of q, k, v and o per head, far above the
// card's ridge point, so the bound is operations.  This first kernel does
// them on the CUDA cores in float32 (no tensor cores; wgmma and TMA are for
// a later version).  What it does about the bound: Q, K, V and P tiles
// staged once in shared memory as float32, padded so that the 16-byte
// loads of one quarter-warp hit distinct banks; each thread owns a 4 x 4
// block of the score tile and a 4-row x 4-column block of the output per
// 64 columns, so every shared-memory load feeds four multiply-adds.  The
// head dim is not padded to a power of two: any D up to 256 runs, with the
// columns past D held at zero in shared memory.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;       // query rows per block, keys per kv tile
constexpr int kThreads = 256;   // 16 row groups x 16 key / column groups
constexpr int kPS = kTile + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
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
      return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KVH, S, T, D, causal, use_window,
                                     window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
