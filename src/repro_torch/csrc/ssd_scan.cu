// ssd_scan: the SSD (Mamba-2) selective scan in its chunked form, for
// x (B, S, H, P) and b, c (B, S, N) in float32 or bfloat16, a (B, S, H)
// float32 in (0, 1]:
//
//   h_t = a_t h_{t-1} + b_t (x) x_t ;  y_t = c_t . h_t ,  h_0 = 0
//
// y (B, S, H, P) in x's dtype and the final h (B, H, N, P) in float32.
// Within a chunk of L steps, with cum the inclusive cumsum of log a:
//
//   s   = (B o exp(cum_L - cum))^T X                      the chunk's own state
//   h   = exp(cum_L) h0 + s                               the carry
//   y   = ((C B^T) o D) X + exp(cum) (C h0),  D[t, s] = exp(cum_t - cum_s), t >= s
//
// Replaces repro/kernels/mamba_scan.py:_ssd_kernel, whose grid (B, H, chunks)
// carries the (N, P) f32 state in VMEM scratch along the sequential chunk
// axis.  Hopper blocks run in no order, so the chunks run in parallel, in
// three launches a call:
//   1. ssd_states_*_k, grid (chunk, group of kHeads heads, batch): each head's
//      cum, its state s (N, P) and exp(cum_L), into a float32 scratch
//      (B, chunks, H, N, P) and (B, chunks, H) that the wrapper allocates;
//   2. ssd_carry_k, a thread per (b, h, n, p): h_in[c] = exp(cum_L[c-1])
//      h_in[c-1] + s[c-1] over the chunks in order, written over s in the
//      scratch, and the final h;
//   3. ssd_out_*_k, grid as in 1: G = C B^T once per block, for every head the
//      block holds, then y = (G o D_h) X_h + exp(cum_h) (C h_in).
// x is read twice (steps 1 and 3), y written once.  The TPU wrapper pads S
// to a whole chunk with a = 1 (log a = 0); here the ragged tail is masked
// instead: past S, x, b and c stage as 0 and log a as 0, which is what the
// padding gives, and no y is written there.  D is used for t >= s only: its
// exponent is clamped at 0 and the entry masked for s > t, where
// exp(cum_t - cum_s) could overflow.
//
// bfloat16 inputs run their products on the tensor cores (mma.sync
// m16n8k16, bf16 -> f32, B fragments of X by ldmatrix.trans).  C B^T is
// exact in its products.  The float32 operands (B o w, G o D, h_in) enter a
// bf16 product as a hi + lo pair of bf16 terms, two mma for one, which keeps
// ~16 bits of each: the state h is held at 1e-3 against the chunked form.
// G is stored once per block as the A fragments of its lower-triangle
// 16 x 16 tiles; a warp owns the row tiles i and T - 1 - i, so every warp
// walks the same number of tiles of the triangle.  float32 inputs stay on
// the CUDA cores (no TF32): register tiles of 4 rows x 4 columns a quad,
// four quads a thread (tr, 15 - tr, 16 + tr, 31 - tr: equal work under the
// triangle), fed by float4 loads of X and of the masked matrix from
// shared memory.
//
// Bound: at the Jamba cut's shape (B 1, S 2048, H 256, P 64, N 16, L 128)
// the bytes (x and y, 67 MB each in bf16) are above the operations (12.9
// GFLOP at tensor-core rate), so the bound is the bytes; in float32 the
// operations at the CUDA cores' rate.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 128;             // 4 warps
constexpr int kMaxChunk = 2 * kThreads;   // the cumsum gives each thread two steps
constexpr int kHeads = 4;                 // heads a block of steps 1 and 3 holds
constexpr int kCarryThreads = 256;
constexpr int kSmemMax = 232448;          // a block's shared memory on Hopper

__host__ __device__ constexpr int up(int v, int m) { return (v + m - 1) / m * m; }

// ---- shared memory of each kernel, in bytes from the start (every region
// starts on 16 bytes); kernels/mamba_scan.py:smem_bytes mirrors the totals.

struct StatesBf16 {  // f32: as (L16 x kHeads), cum, w (L16); bf16: xs (L16 x XS), bt (N16 x BT)
  int L16, P16, N16, XS, BT, as, cum, w, xs, bt, bytes;
  __host__ __device__ StatesBf16(int L, int P, int N)
      : L16(up(L, 16)), P16(up(P, 16)), N16(up(N, 16)), XS(P16 + 8), BT(L16 + 8) {
    as = 0;
    cum = as + 4 * L16 * kHeads;
    w = cum + 4 * L16;
    xs = w + 4 * L16;
    bt = xs + 2 * L16 * XS;
    bytes = bt + 2 * N16 * BT;
  }
};

struct OutBf16 {  // f32: gf (tiles x 256), as, cum; bf16: cs, bs (L16 x NS), hh, hl (P16 x NS), xs
  int L16, P16, N16, T16, NS, XS, gf, as, cum, cs, bs, hh, hl, xs, bytes;
  __host__ __device__ OutBf16(int L, int P, int N)
      : L16(up(L, 16)), P16(up(P, 16)), N16(up(N, 16)), T16(L16 / 16), NS(N16 + 8),
        XS(P16 + 8) {
    gf = 0;
    as = gf + 4 * 256 * (T16 * (T16 + 1) / 2);
    cum = as + 4 * L16 * kHeads;
    cs = cum + 4 * L16;
    bs = cs + 2 * L16 * NS;
    hh = bs + 2 * L16 * NS;
    hl = hh + 2 * P16 * NS;
    xs = hl + 2 * P16 * NS;
    bytes = xs + 2 * L16 * XS;
  }
};

struct StatesF32 {  // as (L4 x kHeads), cum, w (L4), xs (L4 x P4), bs (L4 x N16)
  int L4, P4, N16, as, cum, w, xs, bs, bytes;
  __host__ __device__ StatesF32(int L, int P, int N) : L4(up(L, 4)), P4(up(P, 4)), N16(up(N, 16)) {
    as = 0;
    cum = as + 4 * L4 * kHeads;
    w = cum + 4 * L4;
    xs = w + 4 * L4;
    bs = xs + 4 * L4 * P4;
    bytes = bs + 4 * L4 * N16;
  }
};

// gq, mq: G and the masked matrix of one head, row quads packed under the
// triangle: quad r (rows 4r..4r+3) holds, for s = 0..4r+3, the float4 of its
// four rows at s, from float4 2 r (r + 1).  bs (L4 x N) aliases mq.
struct OutF32 {  // gq, mq, xs (L4 x P4), ct (N x L4), as (L4 x kHeads), cum (L4)
  int L4, P4, RQ, tri, gq, mq, xs, ct, as, cum, bytes;
  __host__ __device__ OutF32(int L, int P, int N)
      : L4(up(L, 4)), P4(up(P, 4)), RQ(L4 / 4), tri(8 * RQ * (RQ + 1)) {
    gq = 0;
    mq = gq + 4 * tri;
    xs = mq + 4 * (tri > L4 * N ? tri : L4 * N);
    ct = xs + 4 * L4 * P4;
    as = ct + 4 * N * L4;
    cum = as + 4 * L4 * kHeads;
    bytes = cum + 4 * L4;
  }
};

template <typename T>
__device__ __forceinline__ T* at(void* base, int off) {
  return reinterpret_cast<T*>(static_cast<char*>(base) + off);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// v0, v1 as bf16 pairs hi and lo with hi + lo = v to ~16 bits.
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = hopper::pack_bf16(v0, v1);
  lo = hopper::pack_bf16(v0 - __uint_as_float(hi << 16), v1 - __uint_as_float(hi & 0xffff0000u));
}

// A fragment of the 16 x 16 tile at (r0, k0) of a row-major bf16 array.
__device__ __forceinline__ void load_a(const bf16* m, int stride, int r0, int k0, int lane,
                                       uint32_t (&a)[4]) {
  const bf16* p = m + (r0 + (lane >> 2)) * stride + k0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// store(i, load(i)) for i < total over the block, kBatch loads in flight a
// thread before their stores: the staging loops read global memory, and
// one load at a time would wait out its latency at every step.
template <typename Load, typename Store>
__device__ __forceinline__ void batched(int total, Load load, Store store) {
  constexpr int kBatch = 8;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    decltype(load(0)) v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (base + k * kThreads < total) v[k] = load(base + k * kThreads);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (base + k * kThreads < total) store(base + k * kThreads, v[k]);
  }
}

// a of the block's heads, as[t * kHeads + j] for head h0 + j and step t < len
// (0 for a head past H).
__device__ __forceinline__ void stage_a(const float* __restrict__ a, int64_t row0, int H, int h0,
                                        int nh, int len, float* as) {
  batched(
      len * kHeads,
      [&](int i) {
        const int t = i / kHeads, j = i - t * kHeads;
        return j < nh ? a[(row0 + t) * H + h0 + j] : 0.f;
      },
      [&](int i, float v) { as[i] = v; });
}

// Inclusive cumsum of log a of head j over the chunk into cum[0, n), log a
// = 0 past the chunk's len steps; n <= 2 * kThreads.  Every thread calls it.
__device__ __forceinline__ void chunk_cum(const float* as, int j, int len, int n, float* cum) {
  const int t = 2 * threadIdx.x;
  const float l0 = t < len ? logf(as[t * kHeads + j]) : 0.f;
  const float l1 = t + 1 < len ? logf(as[(t + 1) * kHeads + j]) : 0.f;
  float total;
  const float ex = repro::block_exclusive_scan(l0 + l1, &total);
  if (t < n) cum[t] = ex + l0;
  if (t + 1 < n) cum[t + 1] = ex + l0 + l1;
}

// x of head h over the chunk into xs (rows x cols, row stride `stride`),
// zero past len and past P; 16-byte loads when `vec`, eight in flight
// (written out: through `batched`, ptxas spilled in ssd_out_bf16_k).
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, int64_t row0, int H, int h, int P,
                                        int len, int rows, int cols, int stride, T* xs, bool vec) {
  constexpr int kPer = 16 / sizeof(T);  // values a 16-byte load
  constexpr int kBatch = 8;
  const T* src = x + (row0 * H + h) * P;
  const int64_t step = static_cast<int64_t>(H) * P;
  if (vec) {  // P % kPer == 0 and x 16-byte aligned
    const int per = cols / kPer, total = rows * per;
    for (int base = 0; base < total; base += kBatch * kThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        const int t = i / per, p = (i - t * per) * kPer;
        v[k] = make_uint4(0, 0, 0, 0);
        if (i < total && t < len && p < P)
          v[k] = *reinterpret_cast<const uint4*>(src + t * step + p);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        const int t = i / per, p = (i - t * per) * kPer;
        if (i < total) *reinterpret_cast<uint4*>(xs + t * stride + p) = v[k];
      }
    }
  } else {
    batched(
        rows * cols,
        [&](int i) {
          const int t = i / cols, p = i - t * cols;
          return (t < len && p < P) ? src[t * step + p] : T(0.f);
        },
        [&](int i, T v) { xs[(i / cols) * stride + i % cols] = v; });
  }
}

// ---- step 1: the chunk states, bf16 on the tensor cores --------------------------

__global__ void __launch_bounds__(kThreads)
    ssd_states_bf16_k(const bf16* __restrict__ x, const float* __restrict__ a,
                      const bf16* __restrict__ b, float* __restrict__ st, float* __restrict__ dec,
                      int S, int H, int P, int N, int L, int nc) {
  const StatesBf16 lay(L, P, N);
  extern __shared__ float4 smem4[];
  float* as = at<float>(smem4, lay.as);
  float* cum = at<float>(smem4, lay.cum);
  float* w = at<float>(smem4, lay.w);
  bf16* xs = at<bf16>(smem4, lay.xs);
  bf16* bt = at<bf16>(smem4, lay.bt);
  const int ci = blockIdx.x, h0 = blockIdx.y * kHeads, bi = blockIdx.z;
  const int nh = min(kHeads, H - h0), len = min(L, S - ci * L);
  const int64_t row0 = static_cast<int64_t>(bi) * S + static_cast<int64_t>(ci) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  batched(  // b^T, zero padded
      lay.L16 * lay.N16,
      [&](int i) {
        const int t = i / lay.N16, n = i - t * lay.N16;
        return (t < len && n < N) ? b[(row0 + t) * N + n] : __float2bfloat16(0.f);
      },
      [&](int i, bf16 v) { bt[(i % lay.N16) * lay.BT + i / lay.N16] = v; });
  stage_a(a, row0, H, h0, nh, len, as);
  const bool vec = P % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int mtiles = lay.N16 / 16, groups = lay.P16 / 16, ksteps = lay.L16 / 16;
  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    __syncthreads();  // a staged; the last head's reads of cum, w and xs done
    chunk_cum(as, j, len, lay.L16, cum);
    stage_x(x, row0, H, h, P, len, lay.L16, lay.P16, lay.XS, xs, vec);
    __syncthreads();
    const float last = cum[L - 1];
    for (int t = threadIdx.x; t < lay.L16; t += kThreads) w[t] = expf(last - cum[t]);
    const int64_t chunk = (static_cast<int64_t>(bi) * nc + ci) * H + h;
    if (threadIdx.x == 0) dec[chunk] = expf(last);
    __syncthreads();
    // s (N16 x P16) = (B o w)^T (N16 x L16) . X (L16 x P16): a warp takes 16
    // rows and 16 columns at a time
    float* out = st + chunk * N * P;
    for (int item = warp; item < mtiles * groups; item += kThreads / 32) {
      const int mi = item / groups, gi = item - mi * groups;
      float acc[2][4] = {};
      for (int k = 0; k < ksteps; ++k) {
        const int s = 16 * k + 2 * q;
        const float2 w0 = *reinterpret_cast<const float2*>(w + s);
        const float2 w8 = *reinterpret_cast<const float2*>(w + s + 8);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 16 * mi + g + 8 * (r & 1);
          const bf162 bv = *reinterpret_cast<const bf162*>(bt + n * lay.BT + s + 8 * (r >> 1));
          const float2 wv = (r >> 1) ? w8 : w0;
          split(__low2float(bv) * wv.x, __high2float(bv) * wv.y, hi[r], lo[r]);
        }
        uint32_t bx[4];
        hopper::ldsm_x4_trans(xs + (16 * k + (lane & 15)) * lay.XS + 16 * gi + 8 * (lane >> 4), bx);
        hopper::mma_bf16(acc[0], hi, bx[0], bx[1]);
        hopper::mma_bf16(acc[0], lo, bx[0], bx[1]);
        hopper::mma_bf16(acc[1], hi, bx[2], bx[3]);
        hopper::mma_bf16(acc[1], lo, bx[2], bx[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 16 * mi + g + 8 * (r >> 1), p = 16 * gi + 8 * nt + 2 * q + (r & 1);
          if (n < N && p < P) out[n * P + p] = acc[nt][r];
        }
    }
  }
}

// ---- step 1, float32 on the CUDA cores ---------------------------------------------

__global__ void __launch_bounds__(kThreads)
    ssd_states_f32_k(const float* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ b, float* __restrict__ st, float* __restrict__ dec,
                     int S, int H, int P, int N, int L, int nc) {
  const StatesF32 lay(L, P, N);
  extern __shared__ float4 smem4[];
  float* as = at<float>(smem4, lay.as);
  float* cum = at<float>(smem4, lay.cum);
  float* w = at<float>(smem4, lay.w);
  float* xs = at<float>(smem4, lay.xs);
  float* bs = at<float>(smem4, lay.bs);
  const int ci = blockIdx.x, h0 = blockIdx.y * kHeads, bi = blockIdx.z;
  const int nh = min(kHeads, H - h0), len = min(L, S - ci * L);
  const int64_t row0 = static_cast<int64_t>(bi) * S + static_cast<int64_t>(ci) * L;
  batched(  // b, zero padded
      lay.L4 * lay.N16,
      [&](int i) {
        const int t = i / lay.N16, n = i - t * lay.N16;
        return (t < len && n < N) ? b[(row0 + t) * N + n] : 0.f;
      },
      [&](int i, float v) { bs[i] = v; });
  stage_a(a, row0, H, h0, nh, len, as);
  const bool vec = P % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int tn = threadIdx.x >> 4, tc = threadIdx.x & 15;
  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    __syncthreads();
    chunk_cum(as, j, len, lay.L4, cum);
    stage_x(x, row0, H, h, P, len, lay.L4, lay.P4, lay.P4, xs, vec);
    __syncthreads();
    const float last = cum[L - 1];
    for (int t = threadIdx.x; t < lay.L4; t += kThreads) w[t] = expf(last - cum[t]);
    const int64_t chunk = (static_cast<int64_t>(bi) * nc + ci) * H + h;
    if (threadIdx.x == 0) dec[chunk] = expf(last);
    __syncthreads();
    // s[n][p] = sum_s b[s][n] w[s] x[s][p]: rows n0, n0 + 8 and 4 columns a thread
    float* out = st + chunk * N * P;
    for (int n0 = tn; n0 < lay.N16; n0 += 16)
      for (int p0 = 4 * tc; p0 < lay.P4; p0 += 64) {
        float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
        for (int s = 0; s < len; ++s) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + s * lay.P4 + p0);
          const float u = bs[s * lay.N16 + n0] * w[s], v = bs[s * lay.N16 + n0 + 8] * w[s];
          s0.x = fmaf(u, xv.x, s0.x), s0.y = fmaf(u, xv.y, s0.y);
          s0.z = fmaf(u, xv.z, s0.z), s0.w = fmaf(u, xv.w, s0.w);
          s1.x = fmaf(v, xv.x, s1.x), s1.y = fmaf(v, xv.y, s1.y);
          s1.z = fmaf(v, xv.z, s1.z), s1.w = fmaf(v, xv.w, s1.w);
        }
        const float r0[4] = {s0.x, s0.y, s0.z, s0.w}, r1[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (p0 + e >= P) break;
          if (n0 < N) out[n0 * P + p0 + e] = r0[e];
          if (n0 + 8 < N) out[(n0 + 8) * P + p0 + e] = r1[e];
        }
      }
  }
}

// ---- step 2: the carry over the chunks -------------------------------------------

__global__ void __launch_bounds__(kCarryThreads)
    ssd_carry_k(float* __restrict__ st, const float* __restrict__ dec, float* __restrict__ hout,
                int64_t BH, int H, int NP, int nc) {
  constexpr int kBatch = 8;  // chunks whose loads are in flight at once
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (e >= BH * NP) return;
  const int64_t bh = e / NP, bi = bh / H;
  const int i = static_cast<int>(e - bh * NP), h = static_cast<int>(bh - bi * H);
  float carry = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float sv[kBatch], dv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t chunk = (bi * nc + c0 + k) * H + h;
      sv[k] = c0 + k < nc ? st[chunk * NP + i] : 0.f;
      dv[k] = c0 + k < nc ? dec[chunk] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < nc) {
        st[((bi * nc + c0 + k) * H + h) * NP + i] = carry;  // h_in of this chunk
        carry = dv[k] * carry + sv[k];
      }
    }
  }
  hout[bh * NP + i] = carry;
}

// ---- step 3: the outputs, bf16 on the tensor cores -------------------------------

// The masked matrix M = G o D at row tile i, column tile j, as hi and lo A
// fragments, from G's stored fragments and cum.
__device__ __forceinline__ void m_frag(const float* gf, const float* cum, int i, int j, int lane,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float4* tile = reinterpret_cast<const float4*>(gf + (i * (i + 1) / 2 + j) * 256);
  const float4 u = tile[lane], v = tile[32 + lane];
  const int t0 = 16 * i + (lane >> 2), t1 = t0 + 8, s = 16 * j + 2 * (lane & 3);
  const float c0 = cum[t0], c1 = cum[t1];
  const float2 e0 = *reinterpret_cast<const float2*>(cum + s);
  const float2 e8 = *reinterpret_cast<const float2*>(cum + s + 8);
  auto m = [](float gv, int t, float ct, int sv, float cs) {
    return sv <= t ? gv * __expf(fminf(ct - cs, 0.f)) : 0.f;
  };
  split(m(u.x, t0, c0, s, e0.x), m(u.y, t0, c0, s + 1, e0.y), hi[0], lo[0]);
  split(m(u.z, t1, c1, s, e0.x), m(u.w, t1, c1, s + 1, e0.y), hi[1], lo[1]);
  split(m(v.x, t0, c0, s + 8, e8.x), m(v.y, t0, c0, s + 9, e8.y), hi[2], lo[2]);
  split(m(v.z, t1, c1, s + 8, e8.x), m(v.w, t1, c1, s + 9, e8.y), hi[3], lo[3]);
}

__device__ __forceinline__ void store_y(bf16* __restrict__ y, const float (&acc)[8][4], int t0,
                                        int len, int64_t row0, int H, int h, int P, int p0,
                                        int ntiles, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= ntiles) break;
    const int p = p0 + 8 * nt + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + (lane >> 2) + 8 * half;
      if (t >= len) continue;
      bf16* dst = y + ((row0 + t) * H + h) * P + p;
      const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
      if (P % 2 == 0 && p + 1 < P) {
        *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (p < P) dst[0] = __float2bfloat16(v0);
        if (p + 1 < P) dst[1] = __float2bfloat16(v1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    ssd_out_bf16_k(const bf16* __restrict__ x, const float* __restrict__ a,
                   const bf16* __restrict__ b, const bf16* __restrict__ c,
                   const float* __restrict__ hin, bf16* __restrict__ y, int S, int H, int P, int N,
                   int L, int nc) {
  const OutBf16 lay(L, P, N);
  extern __shared__ float4 smem4[];
  float* gf = at<float>(smem4, lay.gf);
  float* as = at<float>(smem4, lay.as);
  float* cum = at<float>(smem4, lay.cum);
  bf16* cs = at<bf16>(smem4, lay.cs);
  bf16* bs = at<bf16>(smem4, lay.bs);
  bf16* hh = at<bf16>(smem4, lay.hh);
  bf16* hl = at<bf16>(smem4, lay.hl);
  bf16* xs = at<bf16>(smem4, lay.xs);
  const int ci = blockIdx.x, h0 = blockIdx.y * kHeads, bi = blockIdx.z;
  const int nh = min(kHeads, H - h0), len = min(L, S - ci * L);
  const int64_t row0 = static_cast<int64_t>(bi) * S + static_cast<int64_t>(ci) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NS = lay.NS, T16 = lay.T16, ksteps = lay.N16 / 16;
  batched(  // C and B, zero padded
      lay.L16 * lay.N16,
      [&](int i) {
        const int t = i / lay.N16, n = i - t * lay.N16;
        const bf16 zero = __float2bfloat16(0.f);
        const bool on = t < len && n < N;
        return __halves2bfloat162(on ? c[(row0 + t) * N + n] : zero,
                                  on ? b[(row0 + t) * N + n] : zero);
      },
      [&](int i, bf162 v) {
        const int t = i / lay.N16, n = i - t * lay.N16;
        cs[t * NS + n] = v.x;
        bs[t * NS + n] = v.y;
      });
  stage_a(a, row0, H, h0, nh, len, as);
  __syncthreads();
  // G = C B^T, once for every head of the block: tile (ti, tj), tj <= ti, is
  // two 16 x 8 products whose D fragments are the tile's A fragment
  for (int ti = 0, idx = 0; ti < T16; ++ti)
    for (int tj = 0; tj <= ti; ++tj, ++idx) {
      if ((idx & 3) != warp) continue;
      float d0[4] = {}, d1[4] = {};
      for (int k = 0; k < ksteps; ++k) {
        uint32_t af[4];
        load_a(cs, NS, 16 * ti, 16 * k, lane, af);
        const bf16* p = bs + (16 * tj + (lane >> 2)) * NS + 16 * k + 2 * (lane & 3);
        hopper::mma_bf16(d0, af, ld32(p), ld32(p + 8));
        hopper::mma_bf16(d1, af, ld32(p + 8 * NS), ld32(p + 8 * NS + 8));
      }
      float4* dst = reinterpret_cast<float4*>(gf + idx * 256);
      dst[lane] = make_float4(d0[0], d0[1], d0[2], d0[3]);
      dst[32 + lane] = make_float4(d1[0], d1[1], d1[2], d1[3]);
    }
  const bool vec = P % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int pairs = (T16 + 1) / 2;
  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    __syncthreads();  // G stored; the last head's reads done
    chunk_cum(as, j, len, lay.L16, cum);
    stage_x(x, row0, H, h, P, len, lay.L16, lay.P16, lay.XS, xs, vec);
    const float* hp = hin + ((static_cast<int64_t>(bi) * nc + ci) * H + h) * N * P;
    batched(  // h_in^T as hi + lo
        lay.N16 * lay.P16,
        [&](int i) {
          const int n = i / lay.P16, p = i - n * lay.P16;
          return (n < N && p < P) ? hp[n * P + p] : 0.f;
        },
        [&](int i, float v) {
          const int n = i / lay.P16, p = i - n * lay.P16;
          const bf16 vh = __float2bfloat16(v);
          hh[p * NS + n] = vh;
          hl[p * NS + n] = __float2bfloat16(v - __bfloat162float(vh));
        });
    __syncthreads();
    // a warp owns the row tiles i1 and i2 = T16 - 1 - i1, 64 columns at a time
    for (int pr = warp; pr < pairs; pr += kThreads / 32) {
      const int i1 = pr, i2 = T16 - 1 - pr;
      const bool two = i1 != i2;
      for (int p0 = 0; p0 < lay.P16; p0 += 64) {
        const int groups = min(4, (lay.P16 - p0) / 16);
        float acc[2][8][4] = {};  // [i1, i2][column tile][fragment]
        // exp(cum_t) (C h_in)
        for (int k = 0; k < ksteps; ++k) {
          uint32_t a1[4], a2[4];
          load_a(cs, NS, 16 * i2, 16 * k, lane, a2);
          if (two) load_a(cs, NS, 16 * i1, 16 * k, lane, a1);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt >= 2 * groups) break;
            const int off = (p0 + 8 * nt + (lane >> 2)) * NS + 16 * k + 2 * (lane & 3);
            const uint32_t bh0 = ld32(hh + off), bh1 = ld32(hh + off + 8);
            const uint32_t bl0 = ld32(hl + off), bl1 = ld32(hl + off + 8);
            hopper::mma_bf16(acc[1][nt], a2, bh0, bh1);
            if (two) hopper::mma_bf16(acc[0][nt], a1, bh0, bh1);
            hopper::mma_bf16(acc[1][nt], a2, bl0, bl1);
            if (two) hopper::mma_bf16(acc[0][nt], a1, bl0, bl1);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t = 16 * (m ? i2 : i1) + (lane >> 2);
          const float e0 = __expf(cum[t]), e8 = __expf(cum[t + 8]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            acc[m][nt][0] *= e0, acc[m][nt][1] *= e0;
            acc[m][nt][2] *= e8, acc[m][nt][3] *= e8;
          }
        }
        // + (G o D) X over the column tiles s <= t
        for (int jj = 0; jj <= i2; ++jj) {
          uint32_t m2h[4], m2l[4], m1h[4], m1l[4];
          m_frag(gf, cum, i2, jj, lane, m2h, m2l);
          const bool one = two && jj <= i1;
          if (one) m_frag(gf, cum, i1, jj, lane, m1h, m1l);
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
            if (gi >= groups) break;
            uint32_t bx[4];
            hopper::ldsm_x4_trans(
                xs + (16 * jj + (lane & 15)) * lay.XS + p0 + 16 * gi + 8 * (lane >> 4), bx);
            hopper::mma_bf16(acc[1][2 * gi], m2h, bx[0], bx[1]);
            hopper::mma_bf16(acc[1][2 * gi + 1], m2h, bx[2], bx[3]);
            if (one) {
              hopper::mma_bf16(acc[0][2 * gi], m1h, bx[0], bx[1]);
              hopper::mma_bf16(acc[0][2 * gi + 1], m1h, bx[2], bx[3]);
            }
            hopper::mma_bf16(acc[1][2 * gi], m2l, bx[0], bx[1]);
            hopper::mma_bf16(acc[1][2 * gi + 1], m2l, bx[2], bx[3]);
            if (one) {
              hopper::mma_bf16(acc[0][2 * gi], m1l, bx[0], bx[1]);
              hopper::mma_bf16(acc[0][2 * gi + 1], m1l, bx[2], bx[3]);
            }
          }
        }
        store_y(y, acc[1], 16 * i2, len, row0, H, h, P, p0, 2 * groups, lane);
        if (two) store_y(y, acc[0], 16 * i1, len, row0, H, h, P, p0, 2 * groups, lane);
      }
    }
  }
}

// ---- step 3, float32 on the CUDA cores ---------------------------------------------

// Quad and column offset of entry e of the packed triangle: e = 2 r (r + 1) + s.
__device__ __forceinline__ int quad_of(int e) {
  int r = static_cast<int>((sqrtf(2.f * e + 1.f) - 1.f) * 0.5f);
  while (2 * (r + 1) * (r + 2) <= e) ++r;
  while (2 * r * (r + 1) > e) --r;
  return r;
}

__device__ __forceinline__ void fma4(float4 (&acc)[4], const float4 m, const float4 v) {
  const float mr[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[r].x = fmaf(mr[r], v.x, acc[r].x), acc[r].y = fmaf(mr[r], v.y, acc[r].y);
    acc[r].z = fmaf(mr[r], v.z, acc[r].z), acc[r].w = fmaf(mr[r], v.w, acc[r].w);
  }
}

// acc[k] += M[quad k] X over s in [lo, hi), for the quads K0..3 of the thread
template <int K0>
__device__ __forceinline__ void segment(float4 (&acc)[4][4], const float* xs, const float* mq,
                                        const int (&qb)[4], int P4, int p0, int lo, int hi) {
  for (int s = lo; s < hi; ++s) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + s * P4 + p0);
#pragma unroll
    for (int k = K0; k < 4; ++k)
      fma4(acc[k], *reinterpret_cast<const float4*>(mq + qb[k] + 4 * s), xv);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    ssd_out_f32_k(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ hin, float* __restrict__ y, int S, int H, int P, int N,
                  int L, int nc) {
  const OutF32 lay(L, P, N);
  extern __shared__ float4 smem4[];
  float* gq = at<float>(smem4, lay.gq);
  float* mq = at<float>(smem4, lay.mq);
  float* bs = mq;  // b (L4 x N), until G is stored
  float* xs = at<float>(smem4, lay.xs);
  float* ct = at<float>(smem4, lay.ct);
  float* as = at<float>(smem4, lay.as);
  float* cum = at<float>(smem4, lay.cum);
  const int ci = blockIdx.x, h0 = blockIdx.y * kHeads, bi = blockIdx.z;
  const int nh = min(kHeads, H - h0), len = min(L, S - ci * L);
  const int64_t row0 = static_cast<int64_t>(bi) * S + static_cast<int64_t>(ci) * L;
  const int L4 = lay.L4, P4 = lay.P4, RQ = lay.RQ, entries = lay.tri / 4;
  batched(  // C^T and b, zero past S
      L4 * N,
      [&](int i) {
        const int t = i / N;
        return t < len ? make_float2(c[(row0 + t) * N + i - t * N], b[(row0 + t) * N + i - t * N])
                       : make_float2(0.f, 0.f);
      },
      [&](int i, float2 v) {
        ct[(i % N) * L4 + i / N] = v.x;
        bs[i] = v.y;
      });
  stage_a(a, row0, H, h0, nh, len, as);
  __syncthreads();
  float4* gq4 = reinterpret_cast<float4*>(gq);
  for (int e = threadIdx.x; e < entries; e += kThreads) {  // G = C B^T, once
    const int r = quad_of(e), s = e - 2 * r * (r + 1);
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(ct + n * L4 + 4 * r);
      const float bv = bs[s * N + n];
      g.x = fmaf(cv.x, bv, g.x), g.y = fmaf(cv.y, bv, g.y);
      g.z = fmaf(cv.z, bv, g.z), g.w = fmaf(cv.w, bv, g.w);
    }
    gq4[e] = g;
  }
  const bool vec = P % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vech = P % 4 == 0;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    __syncthreads();  // G stored (b no longer read); the last head's reads done
    chunk_cum(as, j, len, L4, cum);
    stage_x(x, row0, H, h, P, len, L4, P4, P4, xs, vec);
    __syncthreads();
    float4* mq4 = reinterpret_cast<float4*>(mq);
    for (int e = threadIdx.x; e < entries; e += kThreads) {  // M = G o D
      const int r = quad_of(e), s = e - 2 * r * (r + 1), t = 4 * r;
      const float4 g = gq4[e];
      const float cs = cum[s];
      auto m = [&](float gv, int tt) {
        return s <= tt ? gv * __expf(fminf(cum[tt] - cs, 0.f)) : 0.f;
      };
      mq4[e] = make_float4(m(g.x, t), m(g.y, t + 1), m(g.z, t + 2), m(g.w, t + 3));
    }
    __syncthreads();
    const float* hp = hin + ((static_cast<int64_t>(bi) * nc + ci) * H + h) * N * P;
    for (int r0 = 0; r0 < RQ; r0 += 32) {
      const int quad[4] = {r0 + tr, r0 + 15 - tr, r0 + 16 + tr, r0 + 31 - tr};
      int qb[4], end[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool on = quad[k] < RQ;
        qb[k] = on ? 8 * quad[k] * (quad[k] + 1) : 0;  // an invalid quad reads quad 0's
        end[k] = on ? 4 * quad[k] + 4 : (k ? end[k - 1] : 0);
      }
      for (int p0 = 4 * tc; p0 < P4; p0 += 64) {
        float4 acc[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[k][r] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int n0 = 0; n0 < N; n0 += 4) {  // exp(cum_t) (C h_in), 4 rows of h_in in flight
          float4 hv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* row = hp + (n0 + u) * P + p0;
            if (n0 + u >= N) {
              hv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            } else if (vech) {
              hv[u] = *reinterpret_cast<const float4*>(row);
            } else {
              hv[u] = make_float4(row[0], p0 + 1 < P ? row[1] : 0.f, p0 + 2 < P ? row[2] : 0.f,
                                  p0 + 3 < P ? row[3] : 0.f);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (n0 + u < N && quad[k] < RQ)
                fma4(acc[k], *reinterpret_cast<const float4*>(ct + (n0 + u) * L4 + 4 * quad[k]),
                     hv[u]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = 4 * quad[k] + r;
            const float e = t < L4 ? __expf(cum[t]) : 0.f;
            acc[k][r].x *= e, acc[k][r].y *= e, acc[k][r].z *= e, acc[k][r].w *= e;
          }
        segment<0>(acc, xs, mq, qb, P4, p0, 0, end[0]);
        segment<1>(acc, xs, mq, qb, P4, p0, end[0], end[1]);
        segment<2>(acc, xs, mq, qb, P4, p0, end[1], end[2]);
        segment<3>(acc, xs, mq, qb, P4, p0, end[2], end[3]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = 4 * quad[k] + r;
            if (quad[k] >= RQ || t >= len) continue;
            float* dst = y + ((row0 + t) * H + h) * P + p0;
            if (vech) {
              *reinterpret_cast<float4*>(dst) = acc[k][r];
            } else {
              const float v4[4] = {acc[k][r].x, acc[k][r].y, acc[k][r].z, acc[k][r].w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (p0 + e < P) dst[e] = v4[e];
            }
          }
      }
    }
  }
}

// ---- launch ------------------------------------------------------------------------

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, void* y, void* h,
                   void* scratch, int B, int S, int H, int P, int N, int L, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int nc = (S + L - 1) / L;
  float* st = static_cast<float*>(scratch);
  float* dec = st + static_cast<int64_t>(B) * nc * H * N * P;
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  const T* cp = static_cast<const T*>(c);
  const float* ap = static_cast<const float*>(a);
  const dim3 grid(nc, (H + kHeads - 1) / kHeads, B);
  cudaError_t e = cudaSuccess;
  if (nc > 0) {
    if constexpr (kBf16) {
      const int smem = StatesBf16(L, P, N).bytes;
      e = allow_smem(ssd_states_bf16_k, smem);
      if (e != cudaSuccess) return e;
      ssd_states_bf16_k<<<grid, kThreads, smem, s>>>(reinterpret_cast<const bf16*>(xp), ap,
                                                  reinterpret_cast<const bf16*>(bp), st, dec, S,
                                                  H, P, N, L, nc);
    } else {
      const int smem = StatesF32(L, P, N).bytes;
      e = allow_smem(ssd_states_f32_k, smem);
      if (e != cudaSuccess) return e;
      ssd_states_f32_k<<<grid, kThreads, smem, s>>>(reinterpret_cast<const float*>(xp), ap,
                                                 reinterpret_cast<const float*>(bp), st, dec, S,
                                                 H, P, N, L, nc);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int64_t bh = static_cast<int64_t>(B) * H, threads = bh * N * P;
  ssd_carry_k<<<static_cast<unsigned>((threads + kCarryThreads - 1) / kCarryThreads), kCarryThreads,
            0, s>>>(st, dec, static_cast<float*>(h), bh, H, N * P, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess || nc == 0) return e;
  if constexpr (kBf16) {
    const int smem = OutBf16(L, P, N).bytes;
    e = allow_smem(ssd_out_bf16_k, smem);
    if (e != cudaSuccess) return e;
    ssd_out_bf16_k<<<grid, kThreads, smem, s>>>(
        reinterpret_cast<const bf16*>(xp), ap, reinterpret_cast<const bf16*>(bp),
        reinterpret_cast<const bf16*>(cp), st, static_cast<bf16*>(y), S, H, P, N, L, nc);
  } else {
    const int smem = OutF32(L, P, N).bytes;
    e = allow_smem(ssd_out_f32_k, smem);
    if (e != cudaSuccess) return e;
    ssd_out_f32_k<<<grid, kThreads, smem, s>>>(
        reinterpret_cast<const float*>(xp), ap, reinterpret_cast<const float*>(bp),
        reinterpret_cast<const float*>(cp), st, static_cast<float*>(y), S, H, P, N, L, nc);
  }
  return cudaGetLastError();
}

}  // namespace

// scratch: B * ceil(S / L) * H * (N * P + 1) float32, any contents.
extern "C" int repro_ssd_scan(const void* x, const void* a, const void* b, const void* c,
                              void* y, void* h, void* scratch, int B, int S, int H, int P, int N,
                              int L, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 0 || S < 0 || H < 0 || P < 1 || N < 1 || L < 1 || L > kMaxChunk || B > 65535 ||
      (H + kHeads - 1) / kHeads > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, a, b, c, y, h, scratch, B, S, H, P, N, L, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, a, b, c, y, h, scratch, B, S, H, P, N, L, s);
    default:
      return cudaErrorInvalidValue;
  }
}
