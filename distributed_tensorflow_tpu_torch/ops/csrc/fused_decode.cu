// Fused GPT decode for Hopper (sm_90a), CUDA C++: three kernels, the first
// two instantiated for the slab cache and for the paged block pool.
//
//   decode_block_kernel  replaces distributed_tensorflow_tpu/ops/pallas_decode.py
//                        _fused_decode_kernel (per layer; launched by _fused_call,
//                        public decode_block_slab / decode_block_paged). One
//                        layer's step per slot; the fresh K/V rows go back to
//                        the caller, which commits.
//   decode_token_kernel  replaces pallas_decode.py _mega_decode_kernel (the
//                        megakernel; launched by _mega_call, public
//                        decode_token_slab / decode_token_paged). Every layer
//                        in one launch, with the fresh-row commit done in the
//                        kernel.
//   verify_kernel        replaces pallas_decode.py _verify_kernel (public
//                        verify_tokens_paged): the speculation verify, L draft
//                        rows per slot through every layer in one launch over
//                        the paged pool, with the commit done in the kernel.
//
// One slot's step for one layer: LN1 -> q/k/v projections -> fresh K/V row
// rounded through the bf16 cache dtype -> attention of the slot's query over
// its cache positions [0, length) read PRE-write plus the fresh row at
// position `length` -> output projection + residual -> LN2 -> FFN (tanh
// GELU) + residual. The rounding points follow models/gpt.py's XLA engine:
// the layernormed rows, the attention output and gelu(up) are cast to bf16
// before each product, products accumulate in f32, and the normalized
// softmax weights are cast to bf16 before they weight the bf16 values.
//
// Design. The TPU kernels run a sequential grid (layer, slot, kv block) and
// carry the residual rows in VMEM scratch (h_scr) from step to step. CUDA
// blocks run concurrently, so nothing may be carried between them: here one
// CTA owns one slot for the whole launch (the megakernel loops over the
// layers inside the CTA, the residual row stays in shared memory), and slots
// are independent, so no state crosses CTAs. The megakernel commits the fresh
// row of layer l at [l, s, length] after that layer's attention, only when
// active[s]; the attention never re-reads it from memory (it comes from
// shared memory), so the write cannot race the read.
//
// Paged addressing. Position p of slot s lives at
// pool[table[s, p / bs], p % bs]. The TPU kernels take the tables as scalar
// prefetch; here each CTA copies its slot's table row into shared memory
// once and does one lookup per key row. The arithmetic is the slab
// kernels' own: only the row offset (SlabRows / PagedRows) differs, so a
// paged launch over a pool holding the same logical cache gives the slab
// launch's results bit for bit. Live slots never share a writable block
// (the server's allocator shares only full prompt blocks, and writes land
// past the prompt), so in-kernel commits stay disjoint from every read.
//
// Verify. The TPU kernel folds the suffix's own causal block into an online
// softmax over pool blocks. Here one CTA per slot loops over the layers as
// the megakernel does, holds the L residual rows in shared memory, and its
// products take L rows per weight read; attention runs one query head at a
// time with an exact softmax over [pool positions < prefix_len, fresh rows
// lj <= li, lj < suffix_len]. As in the TPU kernel the softmax weights stay
// f32 and a row with no valid key gives 0. Each layer commits position
// prefix_len + li where active and li < suffix_len.
//
// Bound. At gpt-m (d=512, 8 layers, F=2048, MHA 8x64) with S=8 slots and a
// mean cache length of 512, one token moves ~50 MB of bf16 weights and ~67
// MB of KV: ~35 us at 3.35 TB/s. This design reads every weight once PER
// SLOT (S CTAs each stream all weights, mostly from L2) and uses only S of
// the 132 SMs, so it is bound by one SM's load throughput, far above the
// device bound; splitting columns across CTAs with grid-wide syncs is the
// later, faster design. The verify kernel has the same shape with L rows
// per weight read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int LMAX = 8;  // most verify rows per slot
constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-5f;
constexpr size_t SMEM_MAX = 232448;

typedef __nv_bfloat16 bf16;

// C: a slot's logical extent (the slab length, or MB * bs). bs, MB: the
// pool's block size and the tables' width (0, 0 for the slab).
struct Dims {
  int S, d, Hq, Hkv, Dh, F, C, bs, MB;
};

// Element offset of logical row j (all KV heads) of slot s in one layer's
// cache; `tab` is the slot's table row (paged only).
struct SlabRows {
  __device__ __forceinline__ size_t operator()(const Dims& D, const int*, int s,
                                               int j) const {
    return ((size_t)s * D.C + j) * (D.Hkv * D.Dh);
  }
};
struct PagedRows {
  __device__ __forceinline__ size_t operator()(const Dims& D, const int* tab, int,
                                               int j) const {
    return ((size_t)tab[j / D.bs] * D.bs + j % D.bs) * (D.Hkv * D.Dh);
  }
};

// One layer's weights (projections bf16 [in, out] row-major, rest f32).
struct LayerW {
  const bf16 *wq, *wk, *wv, *wo, *w_up, *w_down;
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b, *b_up, *b_down;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; buf holds >= 33 floats. Every thread gets the total.
__device__ float block_sum(float v, float* buf) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) buf[w] = v;
  __syncthreads();
  if (w == 0) {
    float t = lane < NWARPS ? buf[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) buf[32] = t;
  }
  __syncthreads();
  float r = buf[32];
  __syncthreads();
  return r;
}

// out[i] = bf16r(layernorm(x)[i]) over n entries (the JAX models/base
// arithmetic: mean, biased variance, rsqrt(var + eps), scale, bias).
__device__ void layernorm_bf16(const float* x, const float* sc, const float* bi,
                               float* out, int n, float* buf) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += NTHREADS) s += x[i];
  const float mu = block_sum(s, buf) / n;
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    float c = x[i] - mu;
    v += c * c;
  }
  const float rstd = rsqrtf(block_sum(v, buf) / n + LN_EPS);
  for (int i = threadIdx.x; i < n; i += NTHREADS)
    out[i] = bf16r((x[i] - mu) * rstd * sc[i] + bi[i]);
  __syncthreads();
}

// Rows of the split-K scratch a matvec of width n uses (host and device).
__host__ __device__ inline int matvec_ks(int n) {
  int groups = n / 8;
  int g = groups < NTHREADS ? groups : NTHREADS;
  return NTHREADS / g;
}

// y[n] = sum_k x[k] * W[k, n] (+ bias[n]) for n < N: x is a shared-memory
// f32 row (already rounded to bf16 values), W bf16 [K, N] in device memory.
// Each thread owns 8 adjacent columns (one 16-byte load per row k) and a
// 1/KS slice of the rows; partial sums meet in `red` ([KS, N] floats).
__device__ void matvec(const float* x, const bf16* __restrict__ W, int K, int N,
                       const float* __restrict__ bias, float* y, float* red) {
  const int groups = N / 8;
  const int G = groups < NTHREADS ? groups : NTHREADS;
  const int KS = NTHREADS / G;
  const int tid = threadIdx.x;
  const int ks = tid / G;
  if (ks < KS) {
    for (int cg = tid % G; cg < groups; cg += G) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      const uint4* wp = reinterpret_cast<const uint4*>(W) + cg;
#pragma unroll 4
      for (int k = ks; k < K; k += KS) {
        uint4 raw = __ldg(wp + (size_t)k * groups);
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float xk = x[k];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 f = __bfloat1622float2(w2[e]);
          acc[2 * e] += xk * f.x;
          acc[2 * e + 1] += xk * f.y;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) red[ks * N + cg * 8 + e] = acc[e];
    }
  }
  __syncthreads();
  for (int n = tid; n < N; n += NTHREADS) {
    float s = bias ? bias[n] : 0.f;
    for (int j = 0; j < KS; ++j) s += red[j * N + n];
    y[n] = s;
  }
  __syncthreads();
}

// matvec over L <= LMAX rows at once: y[r, n] = sum_k x[r, k] * W[k, n]
// (+ bias[n]), x [L, K] and y [L, N] row-major in shared memory. Each weight
// load serves all L rows; partial sums meet in `red` ([KS, L, N] floats).
__device__ void matmul_rows(const float* x, int L, const bf16* __restrict__ W, int K,
                            int N, const float* __restrict__ bias, float* y, float* red) {
  const int groups = N / 8;
  const int G = groups < NTHREADS ? groups : NTHREADS;
  const int KS = NTHREADS / G;
  const int tid = threadIdx.x;
  const int ks = tid / G;
  if (ks < KS) {
    for (int cg = tid % G; cg < groups; cg += G) {
      float acc[LMAX][8];
#pragma unroll
      for (int r = 0; r < LMAX; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
      const uint4* wp = reinterpret_cast<const uint4*>(W) + cg;
#pragma unroll 2
      for (int k = ks; k < K; k += KS) {
        uint4 raw = __ldg(wp + (size_t)k * groups);
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float wf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 f = __bfloat1622float2(w2[e]);
          wf[2 * e] = f.x;
          wf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int r = 0; r < LMAX; ++r) {
          if (r < L) {
            const float xk = x[r * K + k];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][e] += xk * wf[e];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < LMAX; ++r) {
        if (r < L) {
#pragma unroll
          for (int e = 0; e < 8; ++e) red[((size_t)ks * L + r) * N + cg * 8 + e] = acc[r][e];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < L * N; i += NTHREADS) {
    const int r = i / N, n = i % N;
    float s = bias ? bias[n] : 0.f;
    for (int j = 0; j < KS; ++j) s += red[((size_t)j * L + r) * N + n];
    y[i] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Eight bf16 values at p (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const bf16* __restrict__ p, float* out) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = __bfloat1622float2(k2[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// DPL (2 or 4) bf16 values at p as floats; the rest of out[4] zeroed.
__device__ __forceinline__ void load_dpl(const bf16* p, int DPL, float* vv) {
  if (DPL == 2) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    vv[0] = f.x; vv[1] = f.y; vv[2] = 0.f; vv[3] = 0.f;
  } else {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 a = __bfloat1622float2(v2[0]), b = __bfloat1622float2(v2[1]);
    vv[0] = a.x; vv[1] = a.y; vv[2] = b.x; vv[3] = b.y;
  }
}

struct Smem {
  float *h, *hn, *q, *kf, *vf, *att, *up, *tmp, *sc, *red, *buf;
  int* tab;
};

__device__ Smem carve(float* base, const Dims& D, int red_floats) {
  Smem s;
  s.h = base;
  s.hn = s.h + D.d;
  s.q = s.hn + D.d;
  s.kf = s.q + D.Hq * D.Dh;
  s.vf = s.kf + D.Hkv * D.Dh;
  s.att = s.vf + D.Hkv * D.Dh;
  s.up = s.att + D.Hq * D.Dh;
  s.tmp = s.up + D.F;
  s.sc = s.tmp + D.d;
  s.red = s.sc + D.Hq * (D.C + 1);
  s.buf = s.red + red_floats;
  s.tab = reinterpret_cast<int*>(s.buf + 33);
  return s;
}

// One layer's step for slot s. ck/cv point at this layer's cache (slab
// [S, C, Hkv, Dh] or pool [NB, bs, Hkv, Dh], addressed by Rows). Leaves the
// new residual row in sm.h and the fresh bf16-rounded K/V rows in sm.kf /
// sm.vf.
template <class Rows>
__device__ void layer_step(const LayerW& w, const Dims& D, const bf16* __restrict__ ck,
                           const bf16* __restrict__ cv, int s, int len,
                           const Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = D.d, Dh = D.Dh, Hq = D.Hq, Hkv = D.Hkv, C = D.C;
  const int g = Hq / Hkv;
  const int kvw = Hkv * Dh;
  const float scale = rsqrtf((float)Dh);
  const Rows rows_of{};

  layernorm_bf16(sm.h, w.ln1_s, w.ln1_b, sm.hn, d, sm.buf);
  matvec(sm.hn, w.wq, d, Hq * Dh, nullptr, sm.q, sm.red);
  matvec(sm.hn, w.wk, d, kvw, nullptr, sm.kf, sm.red);
  matvec(sm.hn, w.wv, d, kvw, nullptr, sm.vf, sm.red);
  for (int i = tid; i < kvw; i += NTHREADS) {
    sm.kf[i] = bf16r(sm.kf[i]);  // the cache's storage-dtype round trip
    sm.vf[i] = bf16r(sm.vf[i]);
  }
  __syncthreads();

  // Scores over the pre-write cache: LPR lanes (8 dims each) per key row.
  const int LPR = Dh / 8, RPW = 32 / LPR;
  const int sub = lane % LPR;
  const int rows = Hkv * len;
  for (int base = warp * RPW; base < rows; base += NWARPS * RPW) {
    const int r = base + lane / LPR;
    const bool ok = r < rows;
    const int hk = ok ? r / len : 0, j = ok ? r % len : 0;
    float kv8[8];
    if (ok) {
      load8(ck + rows_of(D, sm.tab, s, j) + (size_t)hk * Dh + sub * 8, kv8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kv8[e] = 0.f;
    }
    for (int gi = 0; gi < g; ++gi) {
      const float* qh = sm.q + (hk * g + gi) * Dh + sub * 8;
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) p += qh[e] * kv8[e];
      for (int o = LPR / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (ok && sub == 0) sm.sc[(hk * g + gi) * (C + 1) + j] = p * scale;
    }
  }
  // The fresh row's score, at position len.
  for (int h = warp; h < Hq; h += NWARPS) {
    const int hk = h / g;
    float p = 0.f;
    for (int e = lane; e < Dh; e += 32) p += sm.q[h * Dh + e] * sm.kf[hk * Dh + e];
    p = warp_sum(p);
    if (lane == 0) sm.sc[h * (C + 1) + len] = p * scale;
  }
  __syncthreads();

  // Exact softmax over [0, len] per head; weights rounded to bf16.
  for (int h = warp; h < Hq; h += NWARPS) {
    float* row = sm.sc + h * (C + 1);
    float m = NEG_INF;
    for (int j = lane; j <= len; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float z = 0.f;
    for (int j = lane; j <= len; j += 32) {
      float e = expf(row[j] - m);
      row[j] = e;
      z += e;
    }
    z = warp_sum(z);
    __syncwarp();
    for (int j = lane; j <= len; j += 32) row[j] = bf16r(row[j] / z);
  }
  __syncthreads();

  // P·V: warp task (kv head, slice of positions); lanes own DPL dims.
  const int DPL = Dh / 32;
  const int JS = NWARPS / Hkv > 0 ? NWARPS / Hkv : 1;
  for (int task = warp; task < Hkv * JS; task += NWARPS) {
    const int hk = task % Hkv, js = task / Hkv;
    // g <= 8 (checked at launch); static trip counts keep acc in registers.
    float acc[8][4];
#pragma unroll
    for (int gi = 0; gi < 8; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][e] = 0.f;
    for (int j = js; j < len; j += JS) {
      float vv[4];
      load_dpl(cv + rows_of(D, sm.tab, s, j) + (size_t)hk * Dh + lane * DPL, DPL, vv);
#pragma unroll
      for (int gi = 0; gi < 8; ++gi) {
        if (gi < g) {
          const float p = sm.sc[(hk * g + gi) * (C + 1) + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][e] += p * vv[e];
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < 8; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gi < g && e < DPL)
          sm.red[(js * Hq + hk * g + gi) * Dh + lane * DPL + e] = acc[gi][e];
  }
  __syncthreads();
  for (int i = tid; i < Hq * Dh; i += NTHREADS) {
    const int h = i / Dh, e = i % Dh, hk = h / g;
    float a = sm.sc[h * (C + 1) + len] * sm.vf[hk * Dh + e];
    for (int js = 0; js < JS; ++js) a += sm.red[(js * Hq + h) * Dh + e];
    sm.att[i] = bf16r(a);
  }
  __syncthreads();

  // Output projection + residual, then LN2 and the FFN + residual.
  matvec(sm.att, w.wo, Hq * Dh, d, nullptr, sm.tmp, sm.red);
  for (int i = tid; i < d; i += NTHREADS) sm.h[i] += sm.tmp[i];
  __syncthreads();
  layernorm_bf16(sm.h, w.ln2_s, w.ln2_b, sm.hn, d, sm.buf);
  matvec(sm.hn, w.w_up, d, D.F, w.b_up, sm.up, sm.red);
  for (int i = tid; i < D.F; i += NTHREADS) sm.up[i] = bf16r(gelu_tanh(sm.up[i]));
  __syncthreads();
  matvec(sm.up, w.w_down, D.F, d, w.b_down, sm.tmp, sm.red);
  for (int i = tid; i < d; i += NTHREADS) sm.h[i] += sm.tmp[i];
  __syncthreads();
}

__device__ LayerW layer(const LayerW& w0, const Dims& D, int l) {
  const size_t d = D.d, qw = (size_t)D.Hq * D.Dh, kvw = (size_t)D.Hkv * D.Dh;
  const size_t F = D.F;
  LayerW w;
  w.wq = w0.wq + l * d * qw;
  w.wk = w0.wk + l * d * kvw;
  w.wv = w0.wv + l * d * kvw;
  w.wo = w0.wo + l * qw * d;
  w.w_up = w0.w_up + l * d * F;
  w.w_down = w0.w_down + l * F * d;
  w.ln1_s = w0.ln1_s + l * d;
  w.ln1_b = w0.ln1_b + l * d;
  w.ln2_s = w0.ln2_s + l * d;
  w.ln2_b = w0.ln2_b + l * d;
  w.b_up = w0.b_up + l * F;
  w.b_down = w0.b_down + l * d;
  return w;
}

// The slot's table row into shared memory (paged; MB is 0 for the slab).
__device__ __forceinline__ void load_table(const Dims& D, const int* tables, int s, int* tab) {
  for (int i = threadIdx.x; i < D.MB; i += NTHREADS) tab[i] = tables[(size_t)s * D.MB + i];
}

template <class Rows>
__global__ void __launch_bounds__(NTHREADS)
decode_block_kernel(LayerW w, Dims D, int red_floats, const float* __restrict__ h_in,
                    float* __restrict__ h_out, const bf16* __restrict__ ck,
                    const bf16* __restrict__ cv, const int* __restrict__ lengths,
                    const int* __restrict__ tables, bf16* __restrict__ k_fresh,
                    bf16* __restrict__ v_fresh) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem, D, red_floats);
  const int s = blockIdx.x;
  const int len = min(lengths[s], D.C);
  for (int i = threadIdx.x; i < D.d; i += NTHREADS) sm.h[i] = h_in[(size_t)s * D.d + i];
  load_table(D, tables, s, sm.tab);
  __syncthreads();
  layer_step<Rows>(w, D, ck, cv, s, len, sm);
  const int kvw = D.Hkv * D.Dh;
  for (int i = threadIdx.x; i < kvw; i += NTHREADS) {
    k_fresh[(size_t)s * kvw + i] = __float2bfloat16(sm.kf[i]);
    v_fresh[(size_t)s * kvw + i] = __float2bfloat16(sm.vf[i]);
  }
  for (int i = threadIdx.x; i < D.d; i += NTHREADS) h_out[(size_t)s * D.d + i] = sm.h[i];
}

template <class Rows>
__global__ void __launch_bounds__(NTHREADS)
decode_token_kernel(LayerW w0, Dims D, int n_layers, int red_floats, size_t layer_elems,
                    const float* __restrict__ h_in, float* __restrict__ h_out,
                    bf16* ck, bf16* cv, const int* __restrict__ lengths,
                    const int* __restrict__ active, const int* __restrict__ tables) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem, D, red_floats);
  const int s = blockIdx.x;
  const int len = min(lengths[s], D.C);
  const bool commit = active[s] != 0 && len < D.C;
  const int kvw = D.Hkv * D.Dh;
  for (int i = threadIdx.x; i < D.d; i += NTHREADS) sm.h[i] = h_in[(size_t)s * D.d + i];
  load_table(D, tables, s, sm.tab);
  __syncthreads();
  for (int l = 0; l < n_layers; ++l) {
    bf16* ckl = ck + l * layer_elems;
    bf16* cvl = cv + l * layer_elems;
    layer_step<Rows>(layer(w0, D, l), D, ckl, cvl, s, len, sm);
    if (commit) {
      const size_t off = Rows()(D, sm.tab, s, len);
      for (int i = threadIdx.x; i < kvw; i += NTHREADS) {
        ckl[off + i] = __float2bfloat16(sm.kf[i]);
        cvl[off + i] = __float2bfloat16(sm.vf[i]);
      }
    }
  }
  for (int i = threadIdx.x; i < D.d; i += NTHREADS) h_out[(size_t)s * D.d + i] = sm.h[i];
}

// -- the verify kernel --------------------------------------------------------

struct VSmem {
  float *h, *hn, *q, *kf, *vf, *att, *tmp, *up, *sc, *red, *buf;
  int* tab;
};

__host__ __device__ inline int verify_sc_floats(const Dims& D, int L) {
  const int a = L * D.F, b = L * (D.C + L);
  return a > b ? a : b;
}

__device__ VSmem vcarve(float* base, const Dims& D, int L, int red_floats) {
  const int qw = D.Hq * D.Dh, kvw = D.Hkv * D.Dh;
  VSmem s;
  s.h = base;
  s.hn = s.h + L * D.d;
  s.q = s.hn + L * D.d;
  s.kf = s.q + L * qw;
  s.vf = s.kf + L * kvw;
  s.att = s.vf + L * kvw;
  s.tmp = s.att + L * qw;
  s.up = s.tmp + L * D.d;
  s.sc = s.up;  // scores live only in attention, gelu(up) only in the FFN
  s.red = s.up + verify_sc_floats(D, L);
  s.buf = s.red + red_floats;
  s.tab = reinterpret_cast<int*>(s.buf + 33);
  return s;
}

// Attention of the L rows for query head h: scores over pool positions
// j < plen and the fresh rows, exact f32 softmax, P·V; writes
// bf16r(attention) into sm.att[r, h*Dh:(h+1)*Dh].
__device__ void verify_head(const Dims& D, const bf16* __restrict__ pk,
                            const bf16* __restrict__ pv, const VSmem& sm, int h, int L,
                            int plen, int slen, float scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dh = D.Dh, g = D.Hq / D.Hkv, hk = h / g;
  const int qw = D.Hq * Dh, kvw = D.Hkv * Dh, CS = D.C + L;
  const PagedRows rows_of{};

  // Scores over the pre-write pool: LPR lanes (8 dims each) per key row,
  // each key row dotted with all L query rows.
  const int LPR = Dh / 8, RPW = 32 / LPR;
  const int sub = lane % LPR;
  for (int base = warp * RPW; base < plen; base += NWARPS * RPW) {
    const int j = base + lane / LPR;
    const bool ok = j < plen;
    float kv8[8];
    if (ok) {
      load8(pk + rows_of(D, sm.tab, 0, j) + (size_t)hk * Dh + sub * 8, kv8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kv8[e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < LMAX; ++r) {
      if (r < L) {
        const float* qh = sm.q + r * qw + h * Dh + sub * 8;
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) p += qh[e] * kv8[e];
        for (int o = LPR / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (ok && sub == 0) sm.sc[r * CS + j] = p * scale;
      }
    }
  }
  // Fresh keys at plen + lj: causal within the suffix, real rows only.
  for (int pair = warp; pair < L * L; pair += NWARPS) {
    const int r = pair / L, lj = pair % L;
    float p = 0.f;
    for (int e = lane; e < Dh; e += 32) p += sm.q[r * qw + h * Dh + e] * sm.kf[lj * kvw + hk * Dh + e];
    p = warp_sum(p);
    if (lane == 0) sm.sc[r * CS + plen + lj] = (lj <= r && lj < slen) ? p * scale : NEG_INF;
  }
  __syncthreads();

  // Exact f32 softmax per row; masked keys weigh 0, a row with no valid
  // key gets all-zero weights (output 0).
  for (int r = warp; r < L; r += NWARPS) {
    float* row = sm.sc + r * CS;
    const int n = plen + L;
    float m = NEG_INF;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    const bool dead = !(m > 0.5f * NEG_INF);
    float z = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = row[j] > 0.5f * NEG_INF ? expf(row[j] - m) : 0.f;
      row[j] = e;
      z += e;
    }
    z = warp_sum(z);
    __syncwarp();
    for (int j = lane; j < n; j += 32) row[j] = dead ? 0.f : row[j] / z;
  }
  __syncthreads();

  // P·V over the pool: warp w takes positions j = w (mod NWARPS); lanes
  // own DPL dims; partial sums per warp meet in red [NWARPS, L, Dh].
  const int DPL = Dh / 32;
  float acc[LMAX][4];
#pragma unroll
  for (int r = 0; r < LMAX; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  for (int j = warp; j < plen; j += NWARPS) {
    float vv[4];
    load_dpl(pv + rows_of(D, sm.tab, 0, j) + (size_t)hk * Dh + lane * DPL, DPL, vv);
#pragma unroll
    for (int r = 0; r < LMAX; ++r) {
      if (r < L) {
        const float p = sm.sc[r * CS + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] += p * vv[e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < LMAX; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r < L && e < DPL) sm.red[(warp * L + r) * Dh + lane * DPL + e] = acc[r][e];
  __syncthreads();
  for (int i = tid; i < L * Dh; i += NTHREADS) {
    const int r = i / Dh, e = i % Dh;
    float a = 0.f;
    for (int lj = 0; lj < L; ++lj) a += sm.sc[r * CS + plen + lj] * sm.vf[lj * kvw + hk * Dh + e];
    for (int js = 0; js < NWARPS; ++js) a += sm.red[(js * L + r) * Dh + e];
    sm.att[r * qw + h * Dh + e] = bf16r(a);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS)
verify_kernel(LayerW w0, Dims D, int n_layers, int L, int red_floats, size_t layer_elems,
              const float* __restrict__ h_in, float* __restrict__ h_out, bf16* pk, bf16* pv,
              const int* __restrict__ tables, const int* __restrict__ prefix_lens,
              const int* __restrict__ suffix_lens, const int* __restrict__ active) {
  extern __shared__ float smem[];
  const VSmem sm = vcarve(smem, D, L, red_floats);
  const int s = blockIdx.x, tid = threadIdx.x;
  const int d = D.d, qw = D.Hq * D.Dh, kvw = D.Hkv * D.Dh;
  const int plen = max(0, min(prefix_lens[s], D.C));
  const int slen = max(0, min(suffix_lens[s], L));
  const bool act = active[s] != 0;
  const float scale = rsqrtf((float)D.Dh);
  for (int i = tid; i < L * d; i += NTHREADS) sm.h[i] = h_in[(size_t)s * L * d + i];
  load_table(D, tables, s, sm.tab);
  __syncthreads();
  for (int l = 0; l < n_layers; ++l) {
    const LayerW w = layer(w0, D, l);
    bf16* pkl = pk + l * layer_elems;
    bf16* pvl = pv + l * layer_elems;
    for (int r = 0; r < L; ++r)
      layernorm_bf16(sm.h + r * d, w.ln1_s, w.ln1_b, sm.hn + r * d, d, sm.buf);
    matmul_rows(sm.hn, L, w.wq, d, qw, nullptr, sm.q, sm.red);
    matmul_rows(sm.hn, L, w.wk, d, kvw, nullptr, sm.kf, sm.red);
    matmul_rows(sm.hn, L, w.wv, d, kvw, nullptr, sm.vf, sm.red);
    for (int i = tid; i < L * kvw; i += NTHREADS) {
      sm.kf[i] = bf16r(sm.kf[i]);  // the cache's storage-dtype round trip
      sm.vf[i] = bf16r(sm.vf[i]);
    }
    __syncthreads();
    for (int h = 0; h < D.Hq; ++h) verify_head(D, pkl, pvl, sm, h, L, plen, slen, scale);
    // Commit position plen + r of every real row of an active slot.
    if (act) {
      for (int i = tid; i < slen * kvw; i += NTHREADS) {
        const int r = i / kvw, e = i % kvw, pos = plen + r;
        if (pos < D.C) {
          const size_t off = PagedRows()(D, sm.tab, s, pos) + e;
          pkl[off] = __float2bfloat16(sm.kf[i]);
          pvl[off] = __float2bfloat16(sm.vf[i]);
        }
      }
    }
    matmul_rows(sm.att, L, w.wo, qw, d, nullptr, sm.tmp, sm.red);
    for (int i = tid; i < L * d; i += NTHREADS) sm.h[i] += sm.tmp[i];
    __syncthreads();
    for (int r = 0; r < L; ++r)
      layernorm_bf16(sm.h + r * d, w.ln2_s, w.ln2_b, sm.hn + r * d, d, sm.buf);
    matmul_rows(sm.hn, L, w.w_up, d, D.F, w.b_up, sm.up, sm.red);
    for (int i = tid; i < L * D.F; i += NTHREADS) sm.up[i] = bf16r(gelu_tanh(sm.up[i]));
    __syncthreads();
    matmul_rows(sm.up, L, w.w_down, D.F, d, w.b_down, sm.tmp, sm.red);
    for (int i = tid; i < L * d; i += NTHREADS) sm.h[i] += sm.tmp[i];
    __syncthreads();
  }
  for (int i = tid; i < L * d; i += NTHREADS) h_out[(size_t)s * L * d + i] = sm.h[i];
}

// -- host side ----------------------------------------------------------------

int red_floats_for(const Dims& D) {
  int r = 33;
  const int ns[] = {D.Hq * D.Dh, D.Hkv * D.Dh, D.d, D.F};
  for (int n : ns) r = r > matvec_ks(n) * n ? r : matvec_ks(n) * n;
  const int js = NWARPS / D.Hkv > 0 ? NWARPS / D.Hkv : 1;
  const int pv = js * D.Hq * D.Dh;
  return r > pv ? r : pv;
}

int verify_red_floats(const Dims& D, int L) {
  int r = NWARPS * L * D.Dh;
  const int ns[] = {D.Hq * D.Dh, D.Hkv * D.Dh, D.d, D.F};
  for (int n : ns) r = r > matvec_ks(n) * L * n ? r : matvec_ks(n) * L * n;
  return r;
}

size_t smem_bytes(const Dims& D, int red_floats) {
  size_t f = 3 * (size_t)D.d + 2 * (size_t)D.Hq * D.Dh + 2 * (size_t)D.Hkv * D.Dh +
             D.F + (size_t)D.Hq * (D.C + 1) + red_floats + 33;
  return f * sizeof(float) + (size_t)D.MB * sizeof(int);
}

size_t verify_smem(const Dims& D, int L, int red_floats) {
  size_t f = (size_t)L * (3 * D.d + 2 * D.Hq * D.Dh + 2 * D.Hkv * D.Dh) +
             verify_sc_floats(D, L) + red_floats + 33;
  return f * sizeof(float) + (size_t)D.MB * sizeof(int);
}

// The envelope this design takes; the Python wrapper checks it first and
// raises with a reason, this is the last line of defence.
cudaError_t check_dims(const Dims& D) {
  if (D.Hkv < 1 || D.Hq % D.Hkv || D.Hq / D.Hkv > 8) return cudaErrorInvalidValue;
  if (D.Dh != 64 && D.Dh != 128) return cudaErrorInvalidValue;
  if (D.d % 8 || D.F % 8 || (D.Hkv * D.Dh) % 8 || D.d != D.Hq * D.Dh) return cudaErrorInvalidValue;
  if (D.MB && (D.bs < 1 || D.C != D.MB * D.bs)) return cudaErrorInvalidValue;
  if (smem_bytes(D, red_floats_for(D)) > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t check_verify(const Dims& D, int L) {
  if (L < 1 || L > LMAX || D.MB < 1) return cudaErrorInvalidValue;
  cudaError_t err = check_dims(D);
  if (err != cudaSuccess) return err;
  if (verify_smem(D, L, verify_red_floats(D, L)) > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaSuccess;
}

LayerW pack(const void* wq, const void* wk, const void* wv, const void* wo,
            const void* ln1_s, const void* ln1_b, const void* ln2_s,
            const void* ln2_b, const void* w_up, const void* b_up,
            const void* w_down, const void* b_down) {
  LayerW w;
  w.wq = (const bf16*)wq; w.wk = (const bf16*)wk; w.wv = (const bf16*)wv;
  w.wo = (const bf16*)wo; w.w_up = (const bf16*)w_up; w.w_down = (const bf16*)w_down;
  w.ln1_s = (const float*)ln1_s; w.ln1_b = (const float*)ln1_b;
  w.ln2_s = (const float*)ln2_s; w.ln2_b = (const float*)ln2_b;
  w.b_up = (const float*)b_up; w.b_down = (const float*)b_down;
  return w;
}

template <class Rows>
int launch_block(const LayerW& w, const Dims& D, const void* h_in, void* h_out,
                 const void* ck, const void* cv, const void* lengths, const void* tables,
                 void* k_fresh, void* v_fresh, void* stream) {
  cudaError_t err = check_dims(D);
  if (err != cudaSuccess) return (int)err;
  const int red = red_floats_for(D);
  const size_t smem = smem_bytes(D, red);
  err = cudaFuncSetAttribute(decode_block_kernel<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_block_kernel<Rows><<<D.S, NTHREADS, smem, (cudaStream_t)stream>>>(
      w, D, red, (const float*)h_in, (float*)h_out, (const bf16*)ck, (const bf16*)cv,
      (const int*)lengths, (const int*)tables, (bf16*)k_fresh, (bf16*)v_fresh);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_token(const LayerW& w, const Dims& D, int n_layers, size_t layer_elems,
                 const void* h_in, void* h_out, void* ck, void* cv, const void* lengths,
                 const void* active, const void* tables, void* stream) {
  cudaError_t err = check_dims(D);
  if (err != cudaSuccess) return (int)err;
  const int red = red_floats_for(D);
  const size_t smem = smem_bytes(D, red);
  err = cudaFuncSetAttribute(decode_token_kernel<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_token_kernel<Rows><<<D.S, NTHREADS, smem, (cudaStream_t)stream>>>(
      w, D, n_layers, red, layer_elems, (const float*)h_in, (float*)h_out, (bf16*)ck,
      (bf16*)cv, (const int*)lengths, (const int*)active, (const int*)tables);
  return (int)cudaGetLastError();
}

}  // namespace

// Per-layer kernel, slab. h_in/h_out [S, d] f32; one layer's weights;
// ck/cv [S, C, Hkv, Dh] bf16 (read only); lengths [S] int32 → k_fresh/v_fresh
// [S, Hkv, Dh] bf16 (the caller commits them).
extern "C" int decode_block_slab(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, const void* ck, const void* cv,
    const void* lengths, void* k_fresh, void* v_fresh, int S, int d, int Hq,
    int Hkv, int Dh, int F, int C, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, C, 0, 0};
  return launch_block<SlabRows>(
      pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down), D,
      h_in, h_out, ck, cv, lengths, nullptr, k_fresh, v_fresh, stream);
}

// Per-layer kernel, paged. As decode_block_slab with one layer's pool
// pk/pv [NB, bs, Hkv, Dh] bf16 (read only) and tables [S, MB] int32.
extern "C" int decode_block_paged(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, const void* pk, const void* pv,
    const void* lengths, const void* tables, void* k_fresh, void* v_fresh, int S,
    int d, int Hq, int Hkv, int Dh, int F, int bs, int MB, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, MB * bs, bs, MB};
  return launch_block<PagedRows>(
      pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down), D,
      h_in, h_out, pk, pv, lengths, tables, k_fresh, v_fresh, stream);
}

// Megakernel, slab. Layer-stacked weights (leading [n_layers] axis) and
// caches [n_layers, S, C, Hkv, Dh] bf16, committed in place at
// [l, s, lengths[s]] where active[s] != 0. h_in/h_out [S, d] f32.
extern "C" int decode_token_slab(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, void* ck, void* cv,
    const void* lengths, const void* active, int n_layers, int S, int d,
    int Hq, int Hkv, int Dh, int F, int C, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, C, 0, 0};
  return launch_token<SlabRows>(
      pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down), D,
      n_layers, (size_t)S * C * Hkv * Dh, h_in, h_out, ck, cv, lengths, active, nullptr,
      stream);
}

// Megakernel, paged. Pools [n_layers, NB, bs, Hkv, Dh] bf16, tables
// [S, MB] int32; the fresh row of layer l is committed in place at
// pool[l, tables[s, len / bs], len % bs] where active[s] != 0.
extern "C" int decode_token_paged(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, void* pk, void* pv,
    const void* lengths, const void* active, const void* tables, int n_layers, int S,
    int d, int Hq, int Hkv, int Dh, int F, int NB, int bs, int MB, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, MB * bs, bs, MB};
  return launch_token<PagedRows>(
      pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down), D,
      n_layers, (size_t)NB * bs * Hkv * Dh, h_in, h_out, pk, pv, lengths, active, tables,
      stream);
}

// Verify. h_in/h_out [S, L, d] f32, layer-stacked weights, pools
// [n_layers, NB, bs, Hkv, Dh] bf16 (committed in place), tables [S, MB],
// prefix_lens / suffix_lens / active [S] int32.
extern "C" int verify_tokens_paged(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, void* pk, void* pv, const void* tables,
    const void* prefix_lens, const void* suffix_lens, const void* active, int n_layers,
    int S, int L, int d, int Hq, int Hkv, int Dh, int F, int NB, int bs, int MB,
    void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, MB * bs, bs, MB};
  cudaError_t err = check_verify(D, L);
  if (err != cudaSuccess) return (int)err;
  const int red = verify_red_floats(D, L);
  const size_t smem = verify_smem(D, L, red);
  err = cudaFuncSetAttribute(verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  verify_kernel<<<S, NTHREADS, smem, (cudaStream_t)stream>>>(
      pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down), D,
      n_layers, L, red, (size_t)NB * bs * Hkv * Dh, (const float*)h_in, (float*)h_out,
      (bf16*)pk, (bf16*)pv, (const int*)tables, (const int*)prefix_lens,
      (const int*)suffix_lens, (const int*)active);
  return (int)cudaGetLastError();
}

// Shared-memory bytes the decode kernels need at these dims (MB = 0: the
// slab; else C = MB * bs), or 0 when the dims are outside the kernels'
// envelope (for the wrappers' checks).
extern "C" long long decode_smem_bytes(int S, int d, int Hq, int Hkv, int Dh,
                                       int F, int C, int MB) {
  Dims D{S, d, Hq, Hkv, Dh, F, C, MB ? C / MB : 0, MB};
  if (check_dims(D) != cudaSuccess) return 0;
  return (long long)smem_bytes(D, red_floats_for(D));
}

// The same for the verify kernel at L rows per slot.
extern "C" long long verify_smem_bytes(int L, int d, int Hq, int Hkv, int Dh, int F,
                                       int bs, int MB) {
  Dims D{1, d, Hq, Hkv, Dh, F, MB * bs, bs, MB};
  if (check_verify(D, L) != cudaSuccess) return 0;
  return (long long)verify_smem(D, L, verify_red_floats(D, L));
}
