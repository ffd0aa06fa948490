// Flash-attention forward for Hopper (sm_90a), CUDA C++, on the tensor cores.
//
// Replaces the TPU kernel distributed_tensorflow_tpu/ops/pallas_attention.py
// _fwd_kernel (:208, launched by _fwd_call's pallas_call :297): exact
// softmax attention computed tile by tile with an online softmax, so the
// [L, L] score matrix never reaches device memory. Features: causal mask,
// the sliding window (window = W > 0: row i keeps key j iff i - W < j <= i),
// the ring offset (offset = F >= 0, with causal: row i sits at position
// i + F, so it keeps key j iff j <= i + F, and i + F - W < j with a window;
// the TPU kernel's `offset`, _causal_mask :113),
// per-batch right-padding kv_lens, grouped-query attention (query head h
// reads KV head h / (Hq / Hkv)), head dim D in {8, 16, 32, 64, 128} (any
// other multiple of 8 up to 128 runs zero-padded to the next one:
// ops/flash_attention.py), the softmax scale a launch argument (the TPU
// kernel's `scale`; 1 / sqrt of the caller's D), any sequence length (the
// ragged last tile is masked), f32 or bf16 inputs.
//
// Bound. At the training path's shapes (B=16, L=1024, 8 heads of 64,
// causal, f32) the two products take 17.2 GFLOP of f32-accurate
// multiply-adds; done as split-TF32 (three TF32 MMAs each, see
// flash_mma.cuh) at 495/3 = 165 TFLOP/s that is 0.104 ms, while the
// ~34 MB of inputs and outputs take 0.01 ms at 3.35 TB/s: operations bind.
// (On the CUDA cores at 67 TFLOP/s of f32 the same work takes 0.257 ms,
// the bound of the first, CUDA-core version of this kernel.)
//
// Design. The TPU walks k-blocks as the innermost sequential grid axis
// and carries m / l / acc in VMEM scratch. Here one CTA of 8 warps owns a
// (batch, query head, 128-query tile) and loops over the 64-key tiles
// itself; each warp owns 16 query rows, and its running max, sum and
// output accumulator stay in registers. Instruction: mma.sync m16n8k8 on
// TF32 operands (split-TF32 for f32 inputs, one exact pass for bf16
// ones), not wgmma: wgmma takes 32-bit operands K-major only, and P V
// needs V's rows as K. The accumulator registers of S = Q K^T are P's A
// fragment as they stand (flash_mma.cuh), so P never leaves registers;
// the row max and sum are quad shuffles. K/V tiles are double-buffered in
// padded shared memory by 16-byte cp.async copies: tile i+1 loads while
// tile i's MMAs run. Under causal masking a warp skips key tiles wholly
// above its rows, and the grid launches the heaviest q-tiles (the last)
// first. With a window the CTA's key range starts at the band's first tile,
// floor((q0 - W + 1) / BK), not at 0 (the TPU kernel's _banded_k_index),
// and a warp skips the tiles wholly older than its rows' band, so the work
// is O(L W); a row that sees no key (window with kv_lens, or an offset
// past the window: rows i >= L - 1 + W - F) keeps l = 0 and writes 0 and
// lse -1e30, as the TPU kernel's empty-row guard gives. Under an offset
// every bound above moves with the rows' positions: the key range ends at
// q0 + BQ + F, starts at floor((q0 + F - W + 1) / BK), and the warp's
// skips and the mask compare keys with row + F. Each tile's share
// of P V is summed in fresh accumulators and folded into O in f32 (O = O * corr + P V): the tensor cores truncate as
// they accumulate, and O would otherwise take that error at every MMA.
// Masked entries are -1e30 with the TPU kernel's empty-row guard; for
// bf16 inputs p is rounded to bf16 before P V, as the TPU kernel's astype.
// exp is the full-precision expf (not the __expf intrinsic, whose error
// grows with |x|).
// Head dim 32 (gpt-s, the decode-* models of tools/lm_bench.py): the same
// tiles, a row of 36 floats or 40 bf16 (4 banks on, or 20 words: the row-
// and column-gathers stay free of bank conflicts), 4 k-steps of QK^T and one
// pass of P V over O's 4 dim tiles; half of D=64's shared memory (55 KB in
// f32), so more CTAs a SM carry the softmax's CUDA-core work, which weighs
// twice as much a key as at D=64.
// Head dim 16 (the transformer classifier: 4 heads of 16 over 28 rows): a
// row of 20 floats or 24 bf16 (again 4 banks on), 2 k-steps of QK^T and one
// pass of P V over O's 2 dim tiles. Its rows are shorter than one tile
// (L=28 < BQ and BK): the zero-filled rows past L are masked as keys and
// never stored as queries, as any ragged last tile is.
// Head dim 8 (the JAX engine's test models: 4 heads of 8): a row of 12
// floats or 24 bf16 (a bf16 row is one 16-byte copy, padded by 32 bytes to
// stay 4 banks on), one k-step of QK^T and one pass of P V over O's one dim
// tile.

#include <type_traits>

#include "flash_mma.cuh"

namespace {

using namespace flash;

constexpr int BQ = 128;  // query rows per CTA
constexpr int BK = 64;   // keys per tile
constexpr int NW = BQ / 16;
constexpr int NT = NW * 32;

// One CTA's tile: the kernels below are this body under their launch bounds.
// WIN: built with the window's tests (window > 0); the other build has none.
// OFF: built with the ring offset (offset > 0, always with a window: the
// launcher runs an offset without one as the window L + F, which masks
// nothing); the other builds fold every offset term away.
template <typename T, int D, bool WIN, bool OFF>
__device__ __forceinline__ void fwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const int* __restrict__ kv_lens,
                                         T* __restrict__ out, float* __restrict__ lse, int L,
                                         int Hq, int Hkv, int causal, int window, int offset,
                                         float scale) {
  if (!WIN) window = 0;  // every window test below folds away
  if (!OFF) offset = 0;  // every offset term below folds away
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NJ = BK / 8;  // key column tiles of S
  constexpr int NN = D / 8;   // dim column tiles of O
  // Dim tiles of O summed per pass of P V: 4, or all of D=16's 2 and D=8's 1.
  constexpr int NC = NN < 4 ? NN : 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int SD = stride<T, D>();
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][SD]
  T* Ks = Qs + BQ * SD;                    // [2][BK][SD]
  T* Vs = Ks + 2 * BK * SD;                // [2][BK][SD]

  const int warp = threadIdx.x >> 5;
  const Lane ln(threadIdx.x & 31);
  const int iq = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = iq * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int klim = min(L, kv_lens ? kv_lens[b] : L);  // keys at or past klim are masked
  const int kend = causal ? min(klim, q0 + BQ + offset) : klim;
  // In the loop keys are counted from -offset (kq = key - offset), so the
  // causal and window tests compare them with the rows as they stand.
  const int klimq = klim - offset;
  const int ntile = (kend + BK - 1) / BK;
  const int it0 = window ? max(0, q0 + offset - window + 1) / BK : 0;  // the band's first tile

  load_rows_async<T, D, BQ, NT>(Qs, q, b, q0, hq, L, Hq);
  load_rows_async<T, D, BK, NT>(Ks, k, b, it0 * BK, hk, L, Hkv);
  load_rows_async<T, D, BK, NT>(Vs, v, b, it0 * BK, hk, L, Hkv);
  cp_async_commit();

  const int wr = 16 * warp;           // the warp's first row in the tile
  const int r0 = q0 + wr + ln.g;      // this lane's rows r0 and r0 + 8
  const bool live = q0 + wr < L;      // warp-uniform
  float o[NN][4];
  zero(o);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = it0; it < ntile; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it-1
    const int cur = (it - it0) & 1;
    if (it + 1 < ntile) {
      const int nb = cur ^ 1;
      load_rows_async<T, D, BK, NT>(Ks + nb * BK * SD, k, b, (it + 1) * BK, hk, L, Hkv);
      load_rows_async<T, D, BK, NT>(Vs + nb * BK * SD, v, b, (it + 1) * BK, hk, L, Hkv);
    }
    cp_async_commit();
    const int kq0 = it * BK - offset;
    if (!live || (causal && kq0 > q0 + wr + 15) || (window && kq0 + BK - 1 <= q0 + wr - window))
      continue;  // every score masked: above the rows, or older than their band
    const T* Kt = Ks + cur * BK * SD;
    const T* Vt = Vs + cur * BK * SD;

    // S = Q K^T; s[j] holds keys it BK + 8j + 2t and + 2t + 1 of rows r0, r0 + 8.
    float s[NJ][4], sx[NJ][4];
    zero(s);
    zero(sx);
#pragma unroll 4  // a full unroll spills
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA<SPLIT> a;
      load_a<SD, SPLIT>(a, Qs, wr, 8 * kk, ln);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float b0, b1;
        load_b_rows<SD>(b0, b1, Kt, 8 * j, 8 * kk, ln);
        mma_b<SPLIT>(s[j], sx[j], a, b0, b1);
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kq0 + 8 * j + 2 * ln.t + (e & 1);
        const int row = r0 + ((e >> 1) << 3);
        const bool ok =
            key < klimq && (!causal || key <= row) && (!window || key > row - window);
        s[j][e] = ok ? (s[j][e] + sx[j][e]) * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], msafe[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mnew = fmaxf(m[h], mx[h]);
      // An all-masked-so-far row has mnew == -1e30; exp(s - mnew) would
      // then be exp(0) for masked entries. The TPU kernel's guard.
      msafe[h] = mnew == NEG_INF ? 0.f : mnew;
      corr[h] = expf(m[h] - msafe[h]);
      m[h] = mnew;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - msafe[e >> 1]);
        ps[e >> 1] += p;
        s[j][e] = rnd(p, (const T*)nullptr);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l[h] = l[h] * corr[h] + ps[h];
    }

    // O = O * corr + P V. P's A fragment for keys it BK + 8kk .. + 7 is s[kk]
    // reordered. The tile's share is summed in fresh accumulators, NC dim
    // tiles at a time, and folded into O in f32: O takes one rounding a
    // tile instead of the tensor cores' truncation at every MMA.
#pragma unroll
    for (int c0 = 0; c0 < NN; c0 += NC) {
      float t[NC][4];
      zero(t);
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        FragA<SPLIT> a;
        a.set(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          float b0, b1;
          load_b_cols<SD>(b0, b1, Vt, 8 * kk, 8 * (c0 + n), ln);
          mma_b<SPLIT>(t[n], t[n], a, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[c0 + n][e] = o[c0 + n][e] * corr[e >> 1] + t[n][e];
    }
  }
  cp_async_wait_all();  // no copy may outlive the CTA (an empty loop leaves one)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (!live || row >= L) continue;
    const float ls = fmaxf(l[h], 1e-30f);
    const size_t base = (size_t)(b * L + row) * Hq + hq;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      store2(out + base * D + 8 * n + 2 * ln.t, o[n][2 * h] / ls, o[n][2 * h + 1] / ls);
    if (ln.t == 0) lse[base] = m[h] + logf(ls);
  }
}

template <typename T, int D, bool WIN, bool OFF>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kv_lens, T* __restrict__ out, float* __restrict__ lse,
                 int L, int Hq, int Hkv, int causal, int window, int offset, float scale) {
  fwd_tile<T, D, WIN, OFF>(q, k, v, kv_lens, out, lse, L, Hq, Hkv, causal, window, offset, scale);
}

// Head dims 16 and 8 declare one CTA a SM as their minimum. Without it
// ptxas aims at a register count for several CTAs of 256 threads (80 in
// bf16) and the bf16 D=16 tile spills a register there; with it, 114-159
// registers and no spill (CUDA 12.8's ptxas). The other head dims keep
// their bounds, and their register counts.
template <typename T, int D, bool WIN, bool OFF>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel_narrow(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_lens,
                        T* __restrict__ out, float* __restrict__ lse, int L, int Hq, int Hkv,
                        int causal, int window, int offset, float scale) {
  fwd_tile<T, D, WIN, OFF>(q, k, v, kv_lens, out, lse, L, Hq, Hkv, causal, window, offset, scale);
}

template <typename T, int D, bool WIN, bool OFF>
constexpr auto fwd_kernel() {
  if constexpr (D <= 16) {
    return flash_fwd_kernel_narrow<T, D, WIN, OFF>;
  } else {
    return flash_fwd_kernel<T, D, WIN, OFF>;
  }
}

template <typename T, int D, bool WIN, bool OFF>
cudaError_t launch_w(const void* q, const void* k, const void* v, const int* kv_lens, void* out,
                     float* lse, int B, int L, int Hq, int Hkv, int causal, int window,
                     int offset, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)(BQ + 4 * BK) * stride<T, D>();
  constexpr auto kern = fwd_kernel<T, D, WIN, OFF>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, kv_lens, (T*)out,
                                   lse, L, Hq, Hkv, causal, window, offset, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_lens, void* out,
                   float* lse, int B, int L, int Hq, int Hkv, int causal, int window,
                   int offset, float scale, cudaStream_t stream) {
  // An offset runs on the offset build, which has a window: without one,
  // the window L + F, which masks nothing (row i keeps key j > i + F - W).
  if (offset)
    return launch_w<T, D, true, true>(q, k, v, kv_lens, out, lse, B, L, Hq, Hkv, causal,
                                      window ? window : L + offset, offset, scale, stream);
  return window ? launch_w<T, D, true, false>(q, k, v, kv_lens, out, lse, B, L, Hq, Hkv,
                                              causal, window, 0, scale, stream)
                : launch_w<T, D, false, false>(q, k, v, kv_lens, out, lse, B, L, Hq, Hkv,
                                               causal, 0, 0, scale, stream);
}

}  // namespace

// q [B, L, Hq, D], k/v [B, L, Hkv, D] (contiguous, 16-byte aligned, f32 or
// bf16), kv_lens [B] int32 or NULL → out [B, L, Hq, D] (input dtype), lse
// [B, L, Hq] f32. window: 0 for none, else W >= 1 (needs causal). scale:
// the scores' factor (1 / sqrt of the caller's head dim). offset: 0, or
// F >= 1 (needs causal), the rows' position ahead of the keys'.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* kv_lens,
                         void* out, float* lse, int B, int L, int Hq, int Hkv, int D,
                         int causal, int window, int offset, int is_bf16, float scale,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv < 1 || Hq % Hkv || B < 1 || L < 1 || window < 0 || (window && !causal) ||
      offset < 0 || (offset && !causal))
    return (int)cudaErrorInvalidValue;
#define FWD_ARGS q, k, v, kv_lens, out, lse, B, L, Hq, Hkv, causal, window, offset, scale, st
  if (D == 8)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 8>(FWD_ARGS) : launch<float, 8>(FWD_ARGS));
  if (D == 16)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 16>(FWD_ARGS) : launch<float, 16>(FWD_ARGS));
  if (D == 32)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 32>(FWD_ARGS) : launch<float, 32>(FWD_ARGS));
  if (D == 64)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 64>(FWD_ARGS) : launch<float, 64>(FWD_ARGS));
  if (D == 128)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 128>(FWD_ARGS) : launch<float, 128>(FWD_ARGS));
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
