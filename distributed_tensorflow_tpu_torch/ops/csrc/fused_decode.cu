// Fused single-token GPT decode for Hopper (sm_90a), CUDA C++: two kernels.
//
//   decode_block_kernel  replaces distributed_tensorflow_tpu/ops/pallas_decode.py
//                        _fused_decode_kernel (per layer; launched by _fused_call,
//                        public decode_block_slab). One layer's step per slot;
//                        the fresh K/V rows go back to the caller, which commits.
//   decode_token_kernel  replaces pallas_decode.py _mega_decode_kernel (the
//                        megakernel; launched by _mega_call, public
//                        decode_token_slab). Every layer in one launch, with
//                        the fresh-row commit done in the kernel.
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
// Bound. At gpt-m (d=512, 8 layers, F=2048, MHA 8x64) with S=8 slots and a
// mean cache length of 512, one token moves ~50 MB of bf16 weights and ~67
// MB of KV: ~35 us at 3.35 TB/s. This design reads every weight once PER
// SLOT (S CTAs each stream all weights, mostly from L2) and uses only S of
// the 132 SMs, so it is bound by one SM's load throughput, far above the
// device bound; splitting columns across CTAs with grid-wide syncs is the
// later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-5f;

typedef __nv_bfloat16 bf16;

struct Dims {
  int S, d, Hq, Hkv, Dh, F, C;
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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

struct Smem {
  float *h, *hn, *q, *kf, *vf, *att, *up, *tmp, *sc, *red, *buf;
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
  return s;
}

// One layer's step for slot s. ck/cv point at this layer's [S, C, Hkv, Dh]
// cache. Leaves the new residual row in sm.h and the fresh bf16-rounded
// K/V rows in sm.kf / sm.vf.
__device__ void layer_step(const LayerW& w, const Dims& D, const bf16* __restrict__ ck,
                           const bf16* __restrict__ cv, int s, int len,
                           const Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = D.d, Dh = D.Dh, Hq = D.Hq, Hkv = D.Hkv, C = D.C;
  const int g = Hq / Hkv;
  const int kvw = Hkv * Dh;
  const float scale = rsqrtf((float)Dh);

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
  const size_t slot_off = (size_t)s * C * kvw;
  const int LPR = Dh / 8, RPW = 32 / LPR;
  const int sub = lane % LPR;
  const int rows = Hkv * len;
  for (int base = warp * RPW; base < rows; base += NWARPS * RPW) {
    const int r = base + lane / LPR;
    const bool ok = r < rows;
    const int hk = ok ? r / len : 0, j = ok ? r % len : 0;
    float kv8[8];
    if (ok) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          ck + slot_off + ((size_t)j * Hkv + hk) * Dh + sub * 8));
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(k2[e]);
        kv8[2 * e] = f.x;
        kv8[2 * e + 1] = f.y;
      }
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
      const bf16* vp = cv + slot_off + ((size_t)j * Hkv + hk) * Dh + lane * DPL;
      float vv[4];
      if (DPL == 2) {
        float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp));
        vv[0] = f.x; vv[1] = f.y; vv[2] = 0.f; vv[3] = 0.f;
      } else {
        uint2 raw = *reinterpret_cast<const uint2*>(vp);
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float2 a = __bfloat1622float2(v2[0]), b = __bfloat1622float2(v2[1]);
        vv[0] = a.x; vv[1] = a.y; vv[2] = b.x; vv[3] = b.y;
      }
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

__global__ void __launch_bounds__(NTHREADS)
decode_block_kernel(LayerW w, Dims D, int red_floats, const float* __restrict__ h_in,
                    float* __restrict__ h_out, const bf16* __restrict__ ck,
                    const bf16* __restrict__ cv, const int* __restrict__ lengths,
                    bf16* __restrict__ k_fresh, bf16* __restrict__ v_fresh) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem, D, red_floats);
  const int s = blockIdx.x;
  const int len = min(lengths[s], D.C);
  for (int i = threadIdx.x; i < D.d; i += NTHREADS) sm.h[i] = h_in[(size_t)s * D.d + i];
  __syncthreads();
  layer_step(w, D, ck, cv, s, len, sm);
  const int kvw = D.Hkv * D.Dh;
  for (int i = threadIdx.x; i < kvw; i += NTHREADS) {
    k_fresh[(size_t)s * kvw + i] = __float2bfloat16(sm.kf[i]);
    v_fresh[(size_t)s * kvw + i] = __float2bfloat16(sm.vf[i]);
  }
  for (int i = threadIdx.x; i < D.d; i += NTHREADS) h_out[(size_t)s * D.d + i] = sm.h[i];
}

__global__ void __launch_bounds__(NTHREADS)
decode_token_kernel(LayerW w0, Dims D, int n_layers, int red_floats,
                    const float* __restrict__ h_in, float* __restrict__ h_out,
                    bf16* ck, bf16* cv, const int* __restrict__ lengths,
                    const int* __restrict__ active) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem, D, red_floats);
  const int s = blockIdx.x;
  const int len = min(lengths[s], D.C);
  const bool commit = active[s] != 0 && len < D.C;
  const int kvw = D.Hkv * D.Dh;
  const size_t layer_elems = (size_t)D.S * D.C * kvw;
  for (int i = threadIdx.x; i < D.d; i += NTHREADS) sm.h[i] = h_in[(size_t)s * D.d + i];
  __syncthreads();
  for (int l = 0; l < n_layers; ++l) {
    bf16* ckl = ck + l * layer_elems;
    bf16* cvl = cv + l * layer_elems;
    layer_step(layer(w0, D, l), D, ckl, cvl, s, len, sm);
    if (commit) {
      const size_t off = ((size_t)s * D.C + len) * kvw;
      for (int i = threadIdx.x; i < kvw; i += NTHREADS) {
        ckl[off + i] = __float2bfloat16(sm.kf[i]);
        cvl[off + i] = __float2bfloat16(sm.vf[i]);
      }
    }
  }
  for (int i = threadIdx.x; i < D.d; i += NTHREADS) h_out[(size_t)s * D.d + i] = sm.h[i];
}

int red_floats_for(const Dims& D) {
  int r = 33;
  const int ns[] = {D.Hq * D.Dh, D.Hkv * D.Dh, D.d, D.F};
  for (int n : ns) r = r > matvec_ks(n) * n ? r : matvec_ks(n) * n;
  const int js = NWARPS / D.Hkv > 0 ? NWARPS / D.Hkv : 1;
  const int pv = js * D.Hq * D.Dh;
  return r > pv ? r : pv;
}

size_t smem_bytes(const Dims& D, int red_floats) {
  size_t f = 3 * (size_t)D.d + 2 * (size_t)D.Hq * D.Dh + 2 * (size_t)D.Hkv * D.Dh +
             D.F + (size_t)D.Hq * (D.C + 1) + red_floats + 33;
  return f * sizeof(float);
}

// The envelope this design takes; the Python wrapper checks it first and
// raises with a reason, this is the last line of defence.
cudaError_t check_dims(const Dims& D) {
  if (D.Hkv < 1 || D.Hq % D.Hkv || D.Hq / D.Hkv > 8) return cudaErrorInvalidValue;
  if (D.Dh != 64 && D.Dh != 128) return cudaErrorInvalidValue;
  if (D.d % 8 || D.F % 8 || (D.Hkv * D.Dh) % 8 || D.d != D.Hq * D.Dh) return cudaErrorInvalidValue;
  if (smem_bytes(D, red_floats_for(D)) > 232448) return cudaErrorInvalidValue;
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

}  // namespace

// Per-layer kernel. h_in/h_out [S, d] f32; one layer's weights; ck/cv
// [S, C, Hkv, Dh] bf16 (read only); lengths [S] int32 → k_fresh/v_fresh
// [S, Hkv, Dh] bf16 (the caller commits them).
extern "C" int decode_block_slab(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, const void* ck, const void* cv,
    const void* lengths, void* k_fresh, void* v_fresh, int S, int d, int Hq,
    int Hkv, int Dh, int F, int C, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, C};
  cudaError_t err = check_dims(D);
  if (err != cudaSuccess) return (int)err;
  const int red = red_floats_for(D);
  const size_t smem = smem_bytes(D, red);
  err = cudaFuncSetAttribute(decode_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_block_kernel<<<S, NTHREADS, smem, (cudaStream_t)stream>>>(
      pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down),
      D, red, (const float*)h_in, (float*)h_out, (const bf16*)ck, (const bf16*)cv,
      (const int*)lengths, (bf16*)k_fresh, (bf16*)v_fresh);
  return (int)cudaGetLastError();
}

// Megakernel. Layer-stacked weights (leading [n_layers] axis) and caches
// [n_layers, S, C, Hkv, Dh] bf16, committed in place at [l, s, lengths[s]]
// where active[s] != 0. h_in/h_out [S, d] f32.
extern "C" int decode_token_slab(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, void* ck, void* cv,
    const void* lengths, const void* active, int n_layers, int S, int d,
    int Hq, int Hkv, int Dh, int F, int C, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, C};
  cudaError_t err = check_dims(D);
  if (err != cudaSuccess) return (int)err;
  const int red = red_floats_for(D);
  const size_t smem = smem_bytes(D, red);
  err = cudaFuncSetAttribute(decode_token_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_token_kernel<<<S, NTHREADS, smem, (cudaStream_t)stream>>>(
      pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down),
      D, n_layers, red, (const float*)h_in, (float*)h_out, (bf16*)ck, (bf16*)cv,
      (const int*)lengths, (const int*)active);
  return (int)cudaGetLastError();
}

// Shared-memory bytes the decode kernels need at these dims, or 0 when the
// dims are outside the kernels' envelope (for the wrappers' checks).
extern "C" long long decode_smem_bytes(int S, int d, int Hq, int Hkv, int Dh,
                                       int F, int C) {
  Dims D{S, d, Hq, Hkv, Dh, F, C};
  if (check_dims(D) != cudaSuccess) return 0;
  return (long long)smem_bytes(D, red_floats_for(D));
}
