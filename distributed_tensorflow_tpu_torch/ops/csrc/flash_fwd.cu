// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel distributed_tensorflow_tpu/ops/pallas_attention.py
// _fwd_kernel (launched by _fwd_call): exact softmax attention computed
// tile by tile with an online softmax, so the [L, L] score matrix never
// reaches device memory. Features: causal mask, per-batch right-padding
// kv_lens, grouped-query attention (query head h reads KV head
// h / (Hq / Hkv)), head dim D in {64, 128}, any sequence length (the
// ragged last tile is masked).
//
// Design. The TPU walks k-blocks as the innermost *sequential* grid axis and
// carries m / l / acc in VMEM scratch between grid steps. CUDA blocks run
// concurrently in no order, so here one CTA owns a (batch, query head,
// 64-query tile) and loops over the 64-key tiles itself; the running max,
// sum and accumulator stay in registers for the whole loop. Four adjacent
// lanes share one query row: each scores a quarter of the tile's keys and
// owns a quarter of the output dims (dims t, t+4, ...). Q, K and V tiles
// sit in shared memory as f32 (rows padded by one to spread banks); the
// probabilities go through shared memory between the QK^T and PV halves.
// Math is f32 with plain FMAs (scale 1/sqrt(D), masked entries at -1e30,
// the TPU kernel's empty-row guard), inputs f32 or bf16.
//
// Bound. Causal prefill at S=8, L=512, 8 heads of 64 dims does ~2.1 GFLOP
// and moves ~17 MB: both tiny against 989 TFLOP/s and 3.35 TB/s, so the
// bound is a few microseconds. This first version runs on the CUDA cores
// (no wgmma / TMA) and is limited by shared-memory bandwidth (about one
// shared load per FMA); tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int TPR = 4;        // threads per query row
constexpr int NTHREADS = BQ * TPR;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_lens,
                 T* __restrict__ out, float* __restrict__ lse,
                 int L, int Hq, int Hkv, int causal) {
  constexpr int DP = D + 1;   // padded row stride of the Q and K tiles
  constexpr int DT = D / TPR; // output dims owned by one thread
  constexpr int KT = BK / TPR; // keys scored by one thread per tile
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][DP]
  float* Ks = Qs + BQ * DP;         // [BK][DP]
  float* Vs = Ks + BK * DP;         // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int r = tid / TPR;          // query row within the tile
  const int t = tid % TPR;          // lane within the row's group
  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const float scale = rsqrtf((float)D);
  const int qpos = q0 + r;

  // Keys past kend cannot be attended by any row of this tile.
  int kend = L;
  if (causal) kend = min(kend, q0 + BQ);
  const int kvlen = kv_lens ? kv_lens[b] : L;
  kend = min(kend, kvlen);

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    int rr = i / D, dd = i % D;
    int p = q0 + rr;
    Qs[rr * DP + dd] =
        p < L ? to_f(q[((size_t)(b * L + p) * Hq + hq) * D + dd]) : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Q tile written)
    for (int i = tid; i < BK * D; i += NTHREADS) {
      int jj = i / D, dd = i % D;
      int p = k0 + jj;
      size_t g = ((size_t)(b * L + p) * Hkv + hk) * D + dd;
      bool in = p < L;
      Ks[jj * DP + dd] = in ? to_f(k[g]) : 0.f;
      Vs[jj * D + dd] = in ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

    float s[KT];
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) s[jj] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qv = Qs[r * DP + dd];
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) s[jj] += qv * Ks[(t + TPR * jj) * DP + dd];
    }
    float mt = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      int kp = k0 + t + TPR * jj;
      bool ok = kp < L && kp < kvlen && (!causal || kp <= qpos);
      s[jj] = ok ? s[jj] * scale : NEG_INF;
      mt = fmaxf(mt, s[jj]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    float m_new = fmaxf(m, mt);
    // An all-masked-so-far row has m_new == -1e30; exp(s - m_new) would
    // then be exp(0) for masked entries. The TPU kernel's guard, verbatim.
    float m_safe = m_new == NEG_INF ? 0.f : m_new;
    float corr = expf(m - m_safe);
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      float p = expf(s[jj] - m_safe);
      ps += p;
      Ps[r * (BK + 1) + t + TPR * jj] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * corr + ps;
    m = m_new;
    __syncwarp();  // the row's four lanes see each other's probabilities
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i] *= corr;
    for (int jj = 0; jj < BK; ++jj) {
      float p = Ps[r * (BK + 1) + jj];
#pragma unroll
      for (int i = 0; i < DT; ++i) acc[i] += p * Vs[jj * D + t + TPR * i];
    }
  }

  if (qpos < L) {
    float ls = fmaxf(l, 1e-30f);
    size_t row = (size_t)(b * L + qpos) * Hq + hq;
#pragma unroll
    for (int i = 0; i < DT; ++i) from_f(&out[row * D + t + TPR * i], acc[i] / ls);
    if (t == 0) lse[row] = m + logf(ls);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lens, void* out, float* lse, int B, int L,
                   int Hq, int Hkv, int causal, cudaStream_t stream) {
  size_t smem = sizeof(float) *
                (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_lens, (T*)out, lse, L, Hq,
      Hkv, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, L, Hq, D], k/v [B, L, Hkv, D] (contiguous, f32 or bf16), kv_lens
// [B] int32 or NULL → out [B, L, Hq, D] (input dtype), lse [B, L, Hq] f32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* kv_lens, void* out, float* lse, int B,
                         int L, int Hq, int Hkv, int D, int causal,
                         int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, kv_lens, out, lse, B, L, Hq, Hkv, causal, st)
                         : launch<float, 64>(q, k, v, kv_lens, out, lse, B, L, Hq, Hkv, causal, st));
  if (D == 128)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, kv_lens, out, lse, B, L, Hq, Hkv, causal, st)
                         : launch<float, 128>(q, k, v, kv_lens, out, lse, B, L, Hq, Hkv, causal, st));
  return (int)cudaErrorInvalidValue;
}
