// ssd_scan: the SSD (Mamba-2) selective scan in its chunked form, for
// x (B, S, H, P) and b, c (B, S, N) in float32 or bfloat16, a (B, S, H)
// float32 in (0, 1]:
//
//   h_t = a_t h_{t-1} + b_t (x) x_t ;  y_t = c_t . h_t ,  h_0 = 0
//
// y (B, S, H, P) in x's dtype and the final h (B, H, N, P) in float32.
// Within a chunk of L steps, with cum the inclusive cumsum of log a:
//
//   y = ((C B^T) o D) X + exp(cum) (C h0),  D[t, s] = exp(cum_t - cum_s), t >= s
//   h = exp(cum_L) h0 + (B o exp(cum_L - cum))^T X
//
// Replaces repro/kernels/mamba_scan.py:_ssd_kernel, whose grid (B, H, chunks)
// carries the (N, P) f32 state in VMEM scratch along the sequential chunk
// axis.  Hopper blocks run in no order, so one block per (head, batch) walks
// the chunks itself with the state in shared memory.  The TPU wrapper pads
// S to a whole chunk with a = 1 (log a = 0); here the ragged tail is masked
// instead: past S, x, b and c stage as 0 and log a as 0, which is what the
// padding gives, and no y is written there.  D is evaluated for t >= s
// only, where its exponent is <= 0: exp(cum_t - cum_s) for t < s can
// overflow, and nothing reads it.
//
// Bound: at the Jamba cut's shape (B 1, S 2048, H 256, P 64, N 16, L 128)
// the bytes (x and y, 67 MB each in bf16) are above the operations (12.9
// GFLOP at tensor-core rate), so the bound is the bytes.  What the design
// does about it: x, b, c and a are read once and y written once, the
// state never leaves the SM; each chunk's (L, P) inputs, C, B^T, the
// masked L x L matrix (C B^T) o D and the state sit in shared memory as
// float32 and the three products run on the CUDA cores.  Only B * H blocks
// exist (256 at the Jamba cut: two waves on 132 SMs, one block an SM for
// its ~120 KB of shared memory); more parallelism and tensor cores are
// later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = kThreads;  // the cumsum gives each step a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }

// shared floats for one block: x (L, P), b^T (N, L), c (L, N), the masked
// matrix (L, L + 1), the state (N, P), cum, exp(cum), exp(cum_L - cum) (L);
// kernels/mamba_scan.py:smem_bytes is the same count
inline size_t smem_floats(int L, int P, int N) {
  return (size_t)L * P + 2 * (size_t)L * N + (size_t)L * (L + 1) + (size_t)N * P + 3 * (size_t)L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_k(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ b,
          const T* __restrict__ c, T* __restrict__ y, float* __restrict__ hout, int S, int H,
          int P, int N, int L) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [t][p]
  float* bt = xs + L * P;                        // [n][t]
  float* cs = bt + N * L;                        // [t][n]
  float* M = cs + L * N;                         // [t][s], row stride L + 1
  float* hs = M + L * (L + 1);                   // [n][p]
  float* cum = hs + N * P;
  float* ecum = cum + L;                         // exp(cum_t)
  float* wdec = ecum + L;                        // exp(cum_{L-1} - cum_s)

  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int LM = L + 1;
  for (int i = tid; i < N * P; i += kThreads) hs[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += L) {
    const int len = min(L, S - s0);
    const int64_t row = (int64_t)bi * S + s0;  // (b, s0) in the (B, S) rows
    __syncthreads();  // the last chunk's reads of xs, bt, M and hs are done
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      xs[i] = t < len ? to_f32(x[((row + t) * H + h) * P + p]) : 0.f;
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const bool on = t < len;
      bt[n * L + t] = on ? to_f32(b[(row + t) * N + n]) : 0.f;
      cs[i] = on ? to_f32(c[(row + t) * N + n]) : 0.f;
    }
    // inclusive cumsum of log a over the chunk; log a = 0 past S
    const float la = tid < len ? logf(a[(row + tid) * H + h]) : 0.f;
    float total;
    const float inc = repro::block_exclusive_scan(la, &total) + la;
    if (tid < L) {
      cum[tid] = inc;
      ecum[tid] = expf(inc);
    }
    __syncthreads();
    if (tid < L) wdec[tid] = expf(cum[L - 1] - cum[tid]);
    // M[t][s] = (c_t . b_s) exp(cum_t - cum_s) for s <= t
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, s = i - t * L;
      if (s > t) continue;
      float g = 0.f;
      for (int n = 0; n < N; ++n) g = fmaf(cs[t * N + n], bt[n * L + s], g);
      M[t * LM + s] = g * expf(cum[t] - cum[s]);
    }
    __syncthreads();
    // y[t][p] = sum_{s <= t} M[t][s] x[s][p] + exp(cum_t) sum_n c[t][n] h[n][p]
    for (int i = tid; i < len * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc = fmaf(M[t * LM + s], xs[s * P + p], acc);
      float carry = 0.f;
      for (int n = 0; n < N; ++n) carry = fmaf(cs[t * N + n], hs[n * P + p], carry);
      store(y + ((row + t) * H + h) * P + p, acc + ecum[t] * carry);
    }
    __syncthreads();  // every read of the old state is done
    // h[n][p] = exp(cum_{L-1}) h[n][p] + sum_s b[s][n] exp(cum_{L-1} - cum_s) x[s][p]
    const float keep = ecum[L - 1];
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P, p = i - n * P;
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc = fmaf(bt[n * L + s] * wdec[s], xs[s * P + p], acc);
      hs[i] = keep * hs[i] + acc;
    }
  }
  __syncthreads();
  float* ho = hout + ((int64_t)bi * H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) ho[i] = hs[i];
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, void* y,
                   void* h, int B, int S, int H, int P, int N, int L, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(L, P, N);
  auto kern = ssd_k<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)H, (unsigned)B), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), static_cast<float*>(h), S, H, P, N, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_ssd_scan(const void* x, const void* a, const void* b, const void* c,
                              void* y, void* h, int B, int S, int H, int P, int N, int L,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 0 || S < 0 || H < 0 || P < 1 || N < 1 || L < 1 || L > kMaxChunk || B > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, a, b, c, y, h, B, S, H, P, N, L, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, a, b, c, y, h, B, S, H, P, N, L, s);
    default:
      return cudaErrorInvalidValue;
  }
}
