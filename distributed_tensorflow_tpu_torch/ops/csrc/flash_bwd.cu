// Flash-attention backward for Hopper (sm_90a), CUDA C++: three kernels.
//
// Replaces the TPU kernels of distributed_tensorflow_tpu/ops/pallas_attention.py:
//   kv_kernel<FUSED=true> + dq_reduce_kernel  <- _fused_bwd_kernel (:440, pallas_call :588)
//   q_kernel                                  <- _dq_kernel        (:327, pallas_call :626)
//   kv_kernel<FUSED=false>                    <- _dkv_kernel       (:381, pallas_call :640)
//
// What they compute, per (query row i, key j) pair that the mask keeps
// (causal j <= i, j < kv_lens[b], both < L), from the forward's saved
// log-sum-exp and delta_i = rowsum(dO_i * O_i) - dlse_i:
//     s  = q_i . k_j * scale            p  = exp(s - lse_i)   (0 where masked)
//     dp = dO_i . v_j                   ds = p * (dp - delta_i) * scale
//     dv_j += p * dO_i     dk_j += ds * q_i     dq_i += ds * k_j
// p is masked explicitly (not through -inf underflow), as the TPU kernels
// do: a row whose lse is ~-1e30 would otherwise turn masked entries into 1.
// p and ds are rounded to the operand dtype before their products (the
// TPU kernels' astype), products and sums are f32. Under GQA a KV head's dk
// and dv sum over the query heads of its group. Layout [B, L, H, D] with
// lse and delta [B, L, Hq] f32; head dim D in {64, 128}; any L (the ragged
// last tile is masked); outputs in the input dtype (f32 or bf16).
//
// Design. The TPU kernels walk a sequential grid and carry dk/dv (or dq) in
// VMEM scratch across the innermost axis. Here:
// - kv_kernel: one CTA per (batch, KV head, 64-key tile) keeps its K and V
//   tiles in shared memory and loops itself over the q-tiles of every query
//   head of the group (from the tile's diagonal under causal), recomputing
//   s and p from lse; dk and dv accumulate in registers.
// - q_kernel: one CTA per (batch, query head, 64-query tile) loops over the
//   k-tiles up to the diagonal; dq accumulates in registers.
// - Fused: CUDA blocks run in no order, so dq cannot accumulate across the
//   kv CTAs. Each CTA writes the dq partial of each (head, q-tile) it visits
//   to its own slice of an f32 buffer [nk, B, L, Hq, D] (the TPU kernel's
//   layout); dq_reduce_kernel then sums the k-tiles of each element in
//   ascending order. The reduction reads exactly the slices the kv CTAs
//   wrote (the same skip predicate), so nothing is zeroed and the result
//   is deterministic, as on the TPU; no atomics.
// The 256 threads of a CTA each own a 4 x (D/16) tile of every [64 x D]
// product (rows t/16 + 16i, columns t%16 + 16j) and a 4 x 4 tile of the
// [64 x 64] score products; tiles sit in shared memory as f32 with rows
// padded by one to spread the banks.
//
// Bound. At the training path's shapes (B*H = 128, L = 1024, D = 64,
// causal, f32) 67.2 M (q, k) pairs are unmasked: 43.0 GFLOP for the fused
// pass (five products), 25.8 for dq (three), 34.4 for dk/dv (four); at
// 67 TFLOP/s of f32 CUDA-core FMA that is 0.642 / 0.385 / 0.513 ms, while
// the ~236 MB of inputs and outputs take 0.07 ms at 3.35 TB/s: operations
// bind. This first version runs plain FMAs on the CUDA cores and is
// limited by shared-memory bandwidth (one 4-byte shared load per two
// FMAs); wgmma on bf16 operands, TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per CTA
constexpr int PP = BK + 1;  // padded row stride of the p / ds tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// x rounded to the operand dtype T (the TPU kernels' astype before a product).
__device__ __forceinline__ float rnd(float x, float*) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows r0.. r0+63 of head h of a [B, L, H, D] tensor into a [64][D+1] f32
// tile; rows past L read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b,
                                          int r0, int h, int L, int H) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    int rr = i / D, dd = i % D;
    int p = r0 + rr;
    dst[rr * (D + 1) + dd] = p < L ? to_f(src[((size_t)(b * L + p) * H + h) * D + dd]) : 0.f;
  }
}

// acc[i][j] = sum_d A[tr+16i][d] * B[tc+16j][d] over two [64][D+1] tiles.
template <int D>
__device__ __forceinline__ void tile_dot_t(float (&acc)[4][4], const float* A, const float* B,
                                           int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(tr + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bb[j];
  }
}

// s = Q K^T and dp = dO V^T on the thread's 4x4 tile, then p and ds into
// the shared Ps / dSs tiles (rounded to the operand dtype). q0 / k0 are the
// tiles' first positions.
template <typename T, int D>
__device__ __forceinline__ void p_ds_tiles(const float* Qs, const float* Ks, const float* dOs,
                                           const float* Vs, const float* Ls, const float* Dl,
                                           float* Ps, float* dSs, int q0, int k0, int L,
                                           int kvlen, int causal, float scale, int tr, int tc) {
  float s[4][4], dp[4][4];
  tile_dot_t<D>(s, Qs, Ks, tr, tc);
  tile_dot_t<D>(dp, dOs, Vs, tr, tc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = tr + 16 * i, qp = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = tc + 16 * j, kp = k0 + c;
      bool ok = qp < L && kp < L && kp < kvlen && (!causal || kp <= qp);
      float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
      float ds = p * (dp[i][j] - Dl[r]) * scale;
      Ps[r * PP + c] = rnd(p, (T*)nullptr);
      dSs[r * PP + c] = rnd(ds, (T*)nullptr);
    }
  }
}

template <int D>
constexpr size_t kv_smem_floats() {
  return 4 * 64 * (D + 1) + 2 * BQ * PP + 2 * BQ;
}

template <int D>
constexpr size_t q_smem_floats() {
  return 4 * 64 * (D + 1) + BQ * PP + 2 * BQ;
}

// dk / dv (and with FUSED the dq partials) of one (batch, KV head, k-tile).
template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(NT)
kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, const int* __restrict__ kv_lens,
          T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dqp, int L, int Hq,
          int Hkv, int causal, float scale) {
  constexpr int DP = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * DP;
  float* Qs = Vs + 64 * DP;
  float* dOs = Qs + 64 * DP;
  float* Ps = dOs + 64 * DP;
  float* dSs = Ps + BQ * PP;
  float* Ls = dSs + BQ * PP;
  float* Dl = Ls + BQ;

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int k0 = ik * BK;
  const int G = Hq / Hkv;
  const int kvlen = kv_lens ? kv_lens[b] : L;
  const int nq = (L + BQ - 1) / BQ;

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // A tile wholly past kv_lens gets zero gradients and writes no dq partial
  // (dq_reduce_kernel skips it by the same predicate).
  if (k0 < kvlen) {
    load_tile<T, D>(Ks, k, b, k0, hk, L, Hkv);
    load_tile<T, D>(Vs, v, b, k0, hk, L, Hkv);
    const int iq0 = causal ? k0 / BQ : 0;
    for (int gi = 0; gi < G; ++gi) {
      const int h = hk * G + gi;
      for (int iq = iq0; iq < nq; ++iq) {
        const int q0 = iq * BQ;
        __syncthreads();  // the previous q-tile is consumed (and K/V written)
        load_tile<T, D>(Qs, q, b, q0, h, L, Hq);
        load_tile<T, D>(dOs, dout, b, q0, h, L, Hq);
        if (tid < BQ) {
          int p = q0 + tid;
          size_t row = (size_t)(b * L + p) * Hq + h;
          Ls[tid] = p < L ? lse[row] : 0.f;
          Dl[tid] = p < L ? delta[row] : 0.f;
        }
        __syncthreads();
        p_ds_tiles<T, D>(Qs, Ks, dOs, Vs, Ls, Dl, Ps, dSs, q0, k0, L, kvlen, causal, scale, tr,
                         tc);
        __syncthreads();
        for (int r = 0; r < BQ; ++r) {
          float pr[4], dsr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pr[i] = Ps[r * PP + tr + 16 * i];
            dsr[i] = dSs[r * PP + tr + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            float o = dOs[r * DP + tc + 16 * j], qq = Qs[r * DP + tc + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              adv[i][j] += pr[i] * o;
              adk[i][j] += dsr[i] * qq;
            }
          }
        }
        if (FUSED) {
          float acc[4][DJ];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
          for (int c = 0; c < BK; ++c) {
            float dsr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) dsr[i] = dSs[(tr + 16 * i) * PP + c];
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
              float kk = Ks[c * DP + tc + 16 * j];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][j] += dsr[i] * kk;
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            int qp = q0 + tr + 16 * i;
            if (qp < L) {
              float* dst = dqp + (((size_t)(ik * B + b) * L + qp) * Hq + h) * D;
#pragma unroll
              for (int j = 0; j < DJ; ++j) dst[tc + 16 * j] = acc[i][j];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int kp = k0 + tr + 16 * i;
    if (kp < L) {
      size_t row = ((size_t)(b * L + kp) * Hkv + hk) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        from_f(&dk[row + tc + 16 * j], adk[i][j]);
        from_f(&dv[row + tc + 16 * j], adv[i][j]);
      }
    }
  }
}

// dq of one (batch, query head, q-tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, const int* __restrict__ kv_lens, T* __restrict__ dq,
         int L, int Hq, int Hkv, int causal, float scale) {
  constexpr int DP = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * DP;
  float* Ks = dOs + 64 * DP;
  float* Vs = Ks + 64 * DP;
  float* dSs = Vs + 64 * DP;
  float* Ls = dSs + BQ * PP;
  float* Dl = Ls + BQ;

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * BQ;
  const int hk = h / (Hq / Hkv);
  const int kvlen = kv_lens ? kv_lens[b] : L;

  load_tile<T, D>(Qs, q, b, q0, h, L, Hq);
  load_tile<T, D>(dOs, dout, b, q0, h, L, Hq);
  if (tid < BQ) {
    int p = q0 + tid;
    size_t row = (size_t)(b * L + p) * Hq + h;
    Ls[tid] = p < L ? lse[row] : 0.f;
    Dl[tid] = p < L ? delta[row] : 0.f;
  }
  // Keys at or past kend are masked for every row of the tile.
  int kend = min(L, kvlen);
  if (causal) kend = min(kend, q0 + BQ);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous k-tile is consumed (and Q/dO written)
    load_tile<T, D>(Ks, k, b, k0, hk, L, Hkv);
    load_tile<T, D>(Vs, v, b, k0, hk, L, Hkv);
    __syncthreads();
    // p lands in dSs and is overwritten by ds in the same thread's slots.
    p_ds_tiles<T, D>(Qs, Ks, dOs, Vs, Ls, Dl, dSs, dSs, q0, k0, L, kvlen, causal, scale, tr, tc);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = dSs[(tr + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        float kk = Ks[c * DP + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += dsr[i] * kk;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int qp = q0 + tr + 16 * i;
    if (qp < L) {
      size_t row = ((size_t)(b * L + qp) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) from_f(&dq[row + tc + 16 * j], acc[i][j]);
    }
  }
}

// dq[e] = sum over the k-tiles ik (ascending) that kv_kernel<FUSED> visited
// for e's (batch, q-tile): k0 = ik * BK < kv_lens[b] and, under causal,
// q-tile >= k0 / BQ. Exactly the slices written, so no zeroing is needed.
template <typename T>
__global__ void dq_reduce_kernel(const float* __restrict__ dqp, T* __restrict__ dq,
                                 const int* __restrict__ kv_lens, int B, int L, int Hq, int D,
                                 int causal) {
  const size_t n = (size_t)B * L * Hq * D;
  const int nk = (L + BK - 1) / BK;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    int b = (int)(e / ((size_t)L * Hq * D));
    int l = (int)((e / ((size_t)Hq * D)) % L);
    int kvlen = kv_lens ? kv_lens[b] : L;
    int iq = l / BQ;
    float s = 0.f;
    for (int ik = 0; ik < nk; ++ik) {
      int k0 = ik * BK;
      if (k0 >= kvlen || (causal && iq < k0 / BQ)) break;
      s += dqp[(size_t)ik * n + e];
    }
    from_f(&dq[e], s);
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch(int mode, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* kv_lens, void* dq,
                   void* dk, void* dv, float* dqp, int B, int L, int Hq, int Hkv, int causal,
                   float scale, cudaStream_t st) {
  cudaError_t err;
  const int nq = (L + BQ - 1) / BQ, nk = (L + BK - 1) / BK;
  if (mode == 0 || mode == 2) {  // fused, or dk/dv alone
    size_t smem = sizeof(float) * kv_smem_floats<D>();
    dim3 grid(nk, Hkv, B);
    if (mode == 0) {
      if ((err = set_smem(kv_kernel<T, D, true>, smem)) != cudaSuccess) return err;
      kv_kernel<T, D, true><<<grid, NT, smem, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, kv_lens, (T*)dk,
          (T*)dv, dqp, L, Hq, Hkv, causal, scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      size_t n = (size_t)B * L * Hq * D;
      int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
      dq_reduce_kernel<T><<<blocks, 256, 0, st>>>(dqp, (T*)dq, kv_lens, B, L, Hq, D, causal);
    } else {
      if ((err = set_smem(kv_kernel<T, D, false>, smem)) != cudaSuccess) return err;
      kv_kernel<T, D, false><<<grid, NT, smem, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, kv_lens, (T*)dk,
          (T*)dv, nullptr, L, Hq, Hkv, causal, scale);
    }
    return cudaGetLastError();
  }
  if (mode == 1) {  // dq alone
    size_t smem = sizeof(float) * q_smem_floats<D>();
    if ((err = set_smem(q_kernel<T, D>, smem)) != cudaSuccess) return err;
    dim3 grid(nq, Hq, B);
    q_kernel<T, D><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                           (const T*)dout, lse, delta, kv_lens, (T*)dq, L, Hq,
                                           Hkv, causal, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout [B, L, Hq, D]; k, v [B, L, Hkv, D] (contiguous, f32 or bf16, one
// dtype); lse, delta [B, L, Hq] f32; kv_lens [B] int32 or NULL.
// mode 0 (fused): dq, dk, dv, with dqp an f32 scratch of
//   ceil(L/64) * B * L * Hq * D floats;
// mode 1: dq alone; mode 2: dk and dv alone (dqp unused).
// Outputs in the input dtype; dk, dv [B, L, Hkv, D].
extern "C" int flash_bwd(int mode, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta,
                         const int* kv_lens, void* dq, void* dk, void* dv, float* dqp, int B,
                         int L, int Hq, int Hkv, int D, int causal, int is_bf16, float scale,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv < 1 || Hq % Hkv || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 64>(mode, q, k, v, dout, lse, delta, kv_lens, dq, dk, dv, dqp, B, L, Hq, Hkv, causal, scale, st)
                         : launch<float, 64>(mode, q, k, v, dout, lse, delta, kv_lens, dq, dk, dv, dqp, B, L, Hq, Hkv, causal, scale, st));
  if (D == 128)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 128>(mode, q, k, v, dout, lse, delta, kv_lens, dq, dk, dv, dqp, B, L, Hq, Hkv, causal, scale, st)
                         : launch<float, 128>(mode, q, k, v, dout, lse, delta, kv_lens, dq, dk, dv, dqp, B, L, Hq, Hkv, causal, scale, st));
  return (int)cudaErrorInvalidValue;
}
