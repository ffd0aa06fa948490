// Flash-attention backward for Hopper (sm_90a), CUDA C++: three kernels.
//
// Replaces the TPU kernels of distributed_tensorflow_tpu/ops/pallas_attention.py:
//   kv_kernel<FUSED=true> + dq_reduce_kernel  <- _fused_bwd_kernel (:440, pallas_call :588)
//   q_kernel                                  <- _dq_kernel        (:327, pallas_call :626)
//   kv_kernel<FUSED=false>                    <- _dkv_kernel       (:381, pallas_call :640)
//
// What they compute, per (query row i, key j) pair that the mask keeps
// (causal j <= i + F, with a window W also j > i + F - W, j < kv_lens[b],
// both < L; F the ring offset, 0 but on a ring-flash hop: the TPU kernels'
// `offset`, _causal_mask :113), from the forward's saved
// log-sum-exp and delta_i = rowsum(dO_i * O_i) - dlse_i:
//     s  = q_i . k_j * scale            p  = exp(s - lse_i)   (0 where masked)
//     dp = dO_i . v_j                   ds = p * (dp - delta_i) * scale
//     dv_j += p * dO_i     dk_j += ds * q_i     dq_i += ds * k_j
// p is masked explicitly (not through -inf underflow), as the TPU kernels
// do: a row whose lse is ~-1e30 would otherwise turn masked entries into 1.
// p and ds are rounded to the operand dtype before their products (the
// TPU kernels' astype), products and sums are f32, exp is the
// full-precision expf. Under GQA a KV head's dk and dv sum over the query
// heads of its group. Layout [B, L, H, D] with
// lse and delta [B, L, Hq] f32; head dim D in {8, 16, 32, 64, 128} (any other
// multiple of 8 up to 128 runs zero-padded to the next one, with the scale
// of its own D: ops/flash_attention.py); any L (the ragged last tile is
// masked); outputs in the input dtype (f32 or bf16).
//
// The sliding window (window = W > 0) visits only the band's tiles, as the
// TPU kernels' banded index maps do: a kv CTA's q-tiles end at the band's
// last query, (k0 + BK - 2 + W) / BQ (_banded_q_index), a q_kernel CTA's
// k-tiles start at the band's first key, (q0 - W + 1) / BK
// (_banded_k_index), and a warp skips a tile wholly outside its band, so
// the work is O(L W). dq_reduce_kernel sums exactly the dq partials that
// the fused kv CTAs wrote, by the same ranges.
//
// The ring offset F shifts every query's position by F, and every range
// above with it: a kv CTA's q-tiles start at floor((k0 - F) / BQ) and end at
// (k0 + BK - 2 + W - F) / BQ (none when that is negative), a q_kernel CTA's
// k-tiles end at q0 + BQ + F and start at floor((q0 + F - W + 1) / BK), and
// dq_reduce_kernel's ranges move the same way. The band arithmetic is
// shifted rather than turned off (the TPU kernels turn banding off under an
// offset, :550), so an offset hop visits only the band's tiles too. A row
// that sees no key (F >= W: rows i >= L - 1 + W - F) gets p = 0 at every
// key, hence exactly zero dq, and adds nothing to dk or dv.
//
// Bound. At the training path's shapes (B*H = 128, L = 1024, D = 64,
// causal, f32) 67.2 M (q, k) pairs are unmasked: 43.0 GFLOP for the fused
// pass (five products), 25.8 for dq (three), 34.4 for dk/dv (four). The
// kv kernels run them as split-TF32 on the tensor cores (three TF32 MMAs
// per f32 product, flash_mma.cuh): at 495/3 = 165 TFLOP/s that is 0.261 ms
// fused and 0.208 ms dk/dv, while the ~236 MB of inputs and outputs take
// 0.07 ms at 3.35 TB/s: operations bind; dq's 25.8 GFLOP take 0.156 ms. (At
// the CUDA cores' 67 TFLOP/s of f32 the bounds are 0.642 / 0.385 / 0.513 ms.)
//
// Design of the kv kernels (B4a, B4c). The TPU kernels walk a sequential
// grid and carry dk/dv (or dq) in VMEM scratch across the innermost axis.
// Here one CTA of 4 warps per (batch, KV head, 64-key tile) keeps its K
// and V tiles in shared memory and loops itself over the 32-query tiles of
// every query head of the group (from the tile's diagonal under causal);
// each warp owns 16 keys, and their dk and dv accumulate in registers.
// Instruction: mma.sync m16n8k8 on TF32 operands (split-TF32 for f32
// inputs, one exact pass for bf16 ones), not wgmma: wgmma takes 32-bit
// operands K-major only, and P^T dO, dS^T Q and dS K need dO, Q and K's
// rows as K. p and ds, computed in the accumulator registers of
// S^T = K Q^T and dP^T = V dO^T, are the A fragments of dV += P^T dO and
// dK += dS^T Q as they stand (flash_mma.cuh). Q, dO, lse and delta tiles
// are double-buffered in padded shared memory by cp.async copies: the next
// q-tile loads while this one's MMAs run. A warp whose keys all lie past
// the q-tile (the diagonal) or past kv_lens skips the products. Each
// q-tile's share of dV and dK is summed in fresh accumulators and added to
// dv / dk in f32, so the tensor cores' truncating accumulation does not
// build up over L. The CTA takes 70 KB of shared memory at D=64 in f32 and
// at most 168 registers a thread: three CTAs (12 warps) a SM.
// - Fused: CUDA blocks run in no order, so dq cannot accumulate across the
//   kv CTAs. Once every warp is done with the q-tile's dO, ds takes its
//   buffer (dK runs meanwhile), and the CTA computes the q-tile's dq
//   partial dS K on the tensor cores into its own slice of an f32 buffer
//   [nk, B, L, Hq, D] (the TPU kernel's layout); dq_reduce_kernel then sums
//   the k-tiles of each element in ascending order. The reduction reads
//   exactly the slices the kv CTAs wrote (the same skip predicate), so
//   nothing is zeroed and the result is deterministic, as on the TPU; no
//   atomics.
//
// Design of q_kernel (B4b), flash_fwd.cu's structure: one CTA per (batch,
// query head, q-tile of 64 rows at D=64, 128 at D=128), 16 query rows a
// warp, the heaviest q-tiles launched first (the q-tile is the grid's
// slowest axis). Q and dO are copied once into padded shared memory by
// cp.async; K and V tiles of 32 keys are double-buffered, tile i+1 loading
// while tile i multiplies. S = Q K^T and dP = dO V^T run as mma.sync
// m16n8k8 on TF32 operands (split-TF32 for f32, one exact pass for bf16);
// p and ds are formed in the accumulator registers and are the A fragment
// of dQ += dS K as they stand (K's rows as k, load_b_cols), so they never
// reach shared memory. dq stays in registers; each k-tile's share is summed
// in fresh accumulators and added to dq in f32. A warp skips k-tiles wholly
// above its rows; k-tiles past kv_lens are not visited. No atomics: two
// launches agree bit for bit.

#include <type_traits>

#include "flash_mma.cuh"

namespace {

__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int BK = 64;  // keys per tile (every kernel); the dq partials come one per k-tile

// ---------------------------------------------------------------------------
// kv_kernel: dk / dv (and with FUSED the dq partials), on the tensor cores.
// ---------------------------------------------------------------------------

using namespace flash;

constexpr int KV_NW = BK / 16;  // warps: 16 keys each
constexpr int KV_NT = KV_NW * 32;
constexpr int KV_BQ = 32;       // query rows per q-tile
constexpr int NC = 4;           // dim tiles summed per pass of a [16 x D] product

// Dim tiles a pass over NN of them: NC, or all of D=16's 2 and D=8's 1.
template <int NN>
__host__ __device__ constexpr int pass_tiles() {
  return NN < NC ? NN : NC;
}

// acc[16 keys x D] += A^T B for one q-tile: A^T the warp's p or ds
// (registers, keys x queries), B the q-tile's dO or Q ([BQ][SD] shared).
// Summed NC dim tiles at a time in fresh accumulators, then added to acc.
template <typename T, int SD, bool SPLIT, int NJ, int NN>
__device__ __forceinline__ void dkv_product(float (&acc)[NN][4], const float (&pt)[NJ][4],
                                            const T* Bt, const Lane& ln) {
  constexpr int NC = pass_tiles<NN>();
#pragma unroll
  for (int c0 = 0; c0 < NN; c0 += NC) {
    float t[NC][4];
    zero(t);
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      FragA<SPLIT> a;  // pt[kk] as the A fragment: slots t / t+4 = queries 2t / 2t+1
      a.set(pt[kk][0], pt[kk][2], pt[kk][1], pt[kk][3]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        float b0, b1;
        load_b_cols<SD>(b0, b1, Bt, 8 * kk, 8 * (c0 + n), ln);
        mma_b<SPLIT>(t[n], t[n], a, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + n][e] += t[n][e];
  }
}

// A dO buffer's row stride: D's, or at D=16 and D=32 the ds tile's (BK keys a row),
// which takes the current dO buffer once dV is done.
template <typename T, int D>
__host__ __device__ constexpr int do_stride() {
  return stride<T, D>() > stride<T, BK>() ? stride<T, D>() : stride<T, BK>();
}

// Shared memory of kv_kernel: K, V and two buffers each of Q and dO (the
// current dO buffer takes the dq product's ds once dV is done), then two
// each of the q-tile's lse and delta. 70 KB at D=64 in f32: three CTAs a SM;
// 45 KB at D=32 and 33 KB at D=16 (their dO buffers sized for ds: 64 keys
// a row).
template <typename T, int D>
constexpr size_t kv_smem_bytes() {
  return sizeof(T) * (size_t)(2 * BK * stride<T, D>() + 2 * KV_BQ * stride<T, D>() +
                              2 * KV_BQ * do_stride<T, D>()) +
         sizeof(float) * 4 * KV_BQ;
}

// CTAs a SM that kv_kernel is built for (its register budget): D=8, D=16,
// D=32 and D=64 three (at most 168 registers a thread; D=32, D=16 and D=8
// hold a half, a quarter and an eighth of D=64's accumulators, so they keep
// D=64's budget and cannot spill where D=64 does not), D=128 one.
template <int D>
__host__ __device__ constexpr int kv_ctas() {
  return D == 128 ? 1 : 3;
}

// WIN: built with the window's tests (window > 0); the other build has none.
// OFF: built with the ring offset (offset > 0, always with a window: the
// launcher runs an offset without one as the window L + F, which masks
// nothing); the other builds fold every offset term away and are the
// offset-free kernels as they were, register for register.
template <typename T, int D, bool FUSED, bool WIN, bool OFF>
__global__ void __launch_bounds__(KV_NT, kv_ctas<D>())
kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, const int* __restrict__ kv_lens,
          T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dqp, int L, int Hq,
          int Hkv, int causal, int window, int offset, float scale) {
  if (!WIN) window = 0;  // every window test below folds away
  if (!OFF) offset = 0;  // every offset term below folds away
  constexpr int BQ = KV_BQ;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NJ = BQ / 8;  // query column tiles of S^T and dP^T
  constexpr int NN = D / 8;   // dim column tiles of dK, dV, dQ
  constexpr int SD = stride<T, D>(), SK = stride<T, BK>(), SO = do_stride<T, D>();
  static_assert(SK <= SO && SD <= SO, "ds and dO must fit in a dO buffer");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [BK][SD]
  T* Vs = Ks + BK * SD;                    // [BK][SD]
  T* Qs = Vs + BK * SD;                    // [2][BQ][SD]
  T* dOs = Qs + 2 * BQ * SD;               // [2] buffers of BQ x SO: dO [BQ][SD], ds [BQ][SK]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * SO);  // [2][BQ]
  float* Dl = Ls + 2 * BQ;                                  // [2][BQ]

  const int warp = threadIdx.x >> 5;
  const Lane ln(threadIdx.x & 31);
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int k0 = ik * BK;
  const int G = Hq / Hkv;
  const int kvlen = kv_lens ? kv_lens[b] : L;
  const int klim = min(L, kvlen);
  const int nq = (L + BQ - 1) / BQ;
  const int wk = 16 * warp;       // the warp's first key in the tile
  const int kr = k0 + wk + ln.g;  // this lane's keys kr and kr + 8

  float adk[NN][4], adv[NN][4];
  zero(adk);
  zero(adv);

  // A tile wholly past kv_lens, or (under an offset) that no query reaches,
  // gets zero gradients and writes no dq partial (dq_reduce_kernel skips it
  // by the same predicate).
  if (k0 < kvlen && (!OFF || k0 + BK - 2 + window - offset >= 0)) {
    // The q-tiles the keys reach: from the first query at or past k0 - F
    // (causal) to the band's last, k0 + BK - 2 + W - F (the tile's last
    // key, W - 1 on).
    const int iq0 = causal ? (OFF ? max(0, k0 - offset) : k0) / BQ : 0;
    const int iq1 = window ? min(nq, (k0 + BK - 2 + window - offset) / BQ + 1) : nq;
    const int nqt = iq1 - iq0, ntile = G * nqt;
    auto load_q_tile = [&](int it) {
      const int h = hk * G + it / nqt, q0 = (iq0 + it % nqt) * BQ, buf = it & 1;
      load_rows_async<T, D, BQ, KV_NT>(Qs + buf * BQ * SD, q, b, q0, h, L, Hq);
      load_rows_async<T, D, BQ, KV_NT>(dOs + buf * BQ * SO, dout, b, q0, h, L, Hq);
      load_vec_async<BQ, KV_NT>(Ls + buf * BQ, lse, b, q0, h, L, Hq);
      load_vec_async<BQ, KV_NT>(Dl + buf * BQ, delta, b, q0, h, L, Hq);
    };
    load_rows_async<T, D, BK, KV_NT>(Ks, k, b, k0, hk, L, Hkv);
    load_rows_async<T, D, BK, KV_NT>(Vs, v, b, k0, hk, L, Hkv);
    load_q_tile(0);
    cp_async_commit();
    // All of the warp's keys lie past kv_lens when k0 + wk >= klim; under
    // causal they lie past rows q0 .. q0+BQ-1 when q0 + BQ - 1 + F < k0 + wk.
    const bool keys_live = k0 + wk < klim;

    for (int it = 0; it < ntile; ++it) {
      cp_async_wait_all();
      __syncthreads();  // tile it has landed; every warp is done with tile it-1
      if (it + 1 < ntile) load_q_tile(it + 1);
      cp_async_commit();
      const int h = hk * G + it / nqt, q0 = (iq0 + it % nqt) * BQ, buf = it & 1;
      const T* Qt = Qs + buf * BQ * SD;
      T* dOt = dOs + buf * BQ * SO;
      const float* Lt = Ls + buf * BQ;
      const float* Dt = Dl + buf * BQ;
      const bool live = keys_live && !(causal && q0 + BQ - 1 + offset < k0 + wk) &&
                        !(window && q0 + offset - (k0 + wk + 15) >= window);

      // p[j] / ds[j]: keys kr, kr + 8 against queries q0 + 8j + 2t and + 2t + 1.
      // dV takes P before dP^T is formed, so p, ds and dV's accumulators
      // are never live at once.
      float p[NJ][4], ds[NJ][4];
      zero(ds);
      if (live) {
        zero(p);
        {
          float x[NJ][4];  // S^T = K Q^T
          zero(x);
#pragma unroll 2  // a full unroll spills at three CTAs a SM
          for (int kk = 0; kk < D / 8; ++kk) {
            FragA<SPLIT> a;
            load_a<SD, SPLIT>(a, Ks, wk, 8 * kk, ln);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              float b0, b1;
              load_b_rows<SD>(b0, b1, Qt, 8 * j, 8 * kk, ln);
              mma_b<SPLIT>(p[j], x[j], a, b0, b1);
            }
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = 8 * j + 2 * ln.t + (e & 1), qp = q0 + qi;
              const int key = kr + ((e >> 1) << 3);
              const bool ok = qp < L && key < klim && (!causal || key <= qp + offset) &&
                              (!window || key > qp + offset - window);
              p[j][e] = ok ? expf((p[j][e] + x[j][e]) * scale - Lt[qi]) : 0.f;
            }
        }
        if (SPLIT) {
          dkv_product<T, SD, SPLIT, NJ, NN>(adv, p, dOt, ln);  // dV += P^T dO
        } else {  // the product takes p rounded to the operand dtype; ds takes it unrounded
          float pr[NJ][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) pr[j][e] = rnd(p[j][e], (const T*)nullptr);
          dkv_product<T, SD, SPLIT, NJ, NN>(adv, pr, dOt, ln);
        }
        {
          float x[NJ][4];  // dP^T = V dO^T
          zero(x);
#pragma unroll 2
          for (int kk = 0; kk < D / 8; ++kk) {
            FragA<SPLIT> a;
            load_a<SD, SPLIT>(a, Vs, wk, 8 * kk, ln);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              float b0, b1;
              load_b_rows<SD>(b0, b1, dOt, 8 * j, 8 * kk, ln);
              mma_b<SPLIT>(ds[j], x[j], a, b0, b1);
            }
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = 8 * j + 2 * ln.t + (e & 1);
              ds[j][e] = rnd(p[j][e] * (ds[j][e] + x[j][e] - Dt[qi]) * scale, (const T*)nullptr);
            }
        }
      }
      if (FUSED) {
        __syncthreads();  // every warp is done with dO: ds takes its buffer
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            from_f(&dOt[(8 * j + 2 * ln.t + (e & 1)) * SK + wk + ln.g + ((e >> 1) << 3)], ds[j][e]);
      }
      if (live) dkv_product<T, SD, SPLIT, NJ, NN>(adk, ds, Qt, ln);
      if (FUSED) {
        // dQ partial of the q-tile = dS K: BQ/16 row blocks of 16 queries,
        // each over NW / (BQ/16) warps that split the dim tiles, NCQ of them
        // a pass (D=32: a warp's 2 tiles in one pass; D=16: its one tile;
        // D=8: one tile, which a row block's first warp takes alone).
        constexpr int RB = BQ / 16, WPR = KV_NW / RB, NPW = NN / WPR > 0 ? NN / WPR : 1;
        constexpr int NCQ = NPW < NC ? NPW : NC;
        const int qr = 16 * (warp % RB), n0 = (warp / RB) * NPW;
        __syncthreads();  // ds is complete
        if (q0 + qr < L && (NN >= WPR || n0 < NN)) {  // the test folds away but at D=8
          const T* pa = dOt + (qr + ln.g) * SK + 2 * ln.t;
#pragma unroll
          for (int c0 = 0; c0 < NPW; c0 += NCQ) {
            float t[NCQ][4];
            zero(t);
#pragma unroll 2
            for (int kk = 0; kk < BK / 8; ++kk) {
              // k-slots t / t+4 are keys 8kk + 2t / + 2t + 1, as K's rows.
              FragA<SPLIT> a;
              a.set(to_f(pa[8 * kk]), to_f(pa[8 * SK + 8 * kk]), to_f(pa[8 * kk + 1]),
                    to_f(pa[8 * SK + 8 * kk + 1]));
#pragma unroll
              for (int n = 0; n < NCQ; ++n) {
                float b0, b1;
                load_b_cols<SD>(b0, b1, Ks, 8 * kk, 8 * (n0 + c0 + n), ln);
                mma_b<SPLIT>(t[n], t[n], a, b0, b1);
              }
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int qp = q0 + qr + ln.g + 8 * hh;
              if (qp >= L) continue;
              float* dst = dqp + (((size_t)(ik * B + b) * L + qp) * Hq + h) * D;
#pragma unroll
              for (int n = 0; n < NCQ; ++n)
                store2(dst + 8 * (n0 + c0 + n) + 2 * ln.t, t[n][2 * hh], t[n][2 * hh + 1]);
            }
          }
        }
      }
    }
    cp_async_wait_all();
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kr + 8 * hh;
    if (key >= L) continue;
    const size_t row = ((size_t)(b * L + key) * Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      store2(dk + row + 8 * n + 2 * ln.t, adk[n][2 * hh], adk[n][2 * hh + 1]);
      store2(dv + row + 8 * n + 2 * ln.t, adv[n][2 * hh], adv[n][2 * hh + 1]);
    }
  }
}

// dq[e] = sum over the k-tiles ik (ascending) that kv_kernel<FUSED> visited
// for e's (batch, query row l): k0 = ik * BK < kv_lens[b], under causal
// l's q-tile is at or past floor((k0 - F) / KV_BQ), and with a window l's
// q-tile is at or before the band's last, (k0 + BK - 2 + W - F) / KV_BQ.
// Exactly the slices written, so no zeroing is needed.
template <typename T>
__global__ void dq_reduce_kernel(const float* __restrict__ dqp, T* __restrict__ dq,
                                 const int* __restrict__ kv_lens, int B, int L, int Hq, int D,
                                 int causal, int window, int offset) {
  const size_t n = (size_t)B * L * Hq * D;
  const int nk = (L + BK - 1) / BK;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(e / ((size_t)L * Hq * D));
    const int l = (int)((e / ((size_t)Hq * D)) % L);
    const int kvlen = kv_lens ? kv_lens[b] : L;
    // The slices written for row l: k-tiles ik0 .. ns-1.
    int ns = min(nk, (kvlen + BK - 1) / BK);
    // The last ik with floor((ik BK - F) / KV_BQ) <= l / KV_BQ.
    if (causal) ns = min(ns, ((l / KV_BQ + 1) * KV_BQ + offset - 1) / BK + 1);
    int ik0 = 0;
    if (window) {  // the first ik with (ik BK + BK - 2 + W - F) / KV_BQ >= l / KV_BQ
      const int need = (l / KV_BQ) * KV_BQ - (BK - 2 + window) + offset;
      ik0 = need <= 0 ? 0 : (need + BK - 1) / BK;
    }
    float s = 0.f;
    int ik = ik0;
    for (; ik + 4 <= ns; ik += 4) {  // four loads in flight, summed in order
      const float a0 = dqp[(size_t)ik * n + e], a1 = dqp[(size_t)(ik + 1) * n + e];
      const float a2 = dqp[(size_t)(ik + 2) * n + e], a3 = dqp[(size_t)(ik + 3) * n + e];
      s = (((s + a0) + a1) + a2) + a3;
    }
    for (; ik < ns; ++ik) s += dqp[(size_t)ik * n + e];
    from_f(&dq[e], s);
  }
}

// ---------------------------------------------------------------------------
// q_kernel: dq alone, on the tensor cores.
// ---------------------------------------------------------------------------

// Tiles of q_kernel: query rows a CTA (16 a warp) and keys a K/V tile. D=16
// and D=32 take D=64's 64 rows (4 warps; 37 KB of shared memory at D=32 in
// f32).
template <int D>
struct QTiles {
  static constexpr int BQ = D <= 64 ? 64 : 128;
  static constexpr int BK = 32;
  static constexpr int NW = BQ / 16;
  static constexpr int NT = NW * 32;
};

// Shared memory of q_kernel: the Q and dO tiles, two buffers each of K and
// V, then lse and delta.
template <typename T, int D>
constexpr size_t q_smem_bytes() {
  using Q = QTiles<D>;
  return sizeof(T) * (size_t)(2 * Q::BQ + 4 * Q::BK) * stride<T, D>() +
         sizeof(float) * 2 * Q::BQ;
}

// c (+ x) += A B^T over the head dim for the warp's 16 rows of A (a [BQ][SD]
// tile) against the NJ x 8 rows of B (the [BK][SD] tile Bt).
template <typename T, int D, int NJ, bool SPLIT>
__device__ __forceinline__ void row_product(float (&c)[NJ][4], float (&x)[NJ][4], const T* A,
                                            int wr, const T* Bt, const Lane& ln) {
  constexpr int SD = stride<T, D>();
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    FragA<SPLIT> a;
    load_a<SD, SPLIT>(a, A, wr, 8 * kk, ln);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float b0, b1;
      load_b_rows<SD>(b0, b1, Bt, 8 * j, 8 * kk, ln);
      mma_b<SPLIT>(c[j], x[j], a, b0, b1);
    }
  }
}

// dq of one (batch, query head, q-tile). Each warp owns 16 query rows; S =
// Q K^T and dP = dO V^T of a k-tile are computed in registers, p and ds
// formed there, and ds is the A fragment of dQ += dS K as it stands. Each
// k-tile's share of dQ is summed in fresh accumulators and added to dq in
// f32. The kernels below are this body under their launch bounds.
template <typename T, int D, bool WIN, bool OFF>
__device__ __forceinline__ void q_tile(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, const T* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       const int* __restrict__ kv_lens, T* __restrict__ dq,
                                       int L, int Hq, int Hkv, int causal, int window,
                                       int offset, float scale) {
  if (!WIN) window = 0;  // every window test below folds away
  if (!OFF) offset = 0;  // every offset term below folds away
  using Q = QTiles<D>;
  constexpr int BQ = Q::BQ, BKQ = Q::BK, NT = Q::NT;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NJ = BKQ / 8;  // key column tiles of S and dP
  constexpr int NN = D / 8;    // dim column tiles of dQ
  constexpr int NC = pass_tiles<NN>();
  constexpr int SD = stride<T, D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][SD]
  T* dOs = Qs + BQ * SD;                   // [BQ][SD]
  T* Ks = dOs + BQ * SD;                   // [2][BKQ][SD]
  T* Vs = Ks + 2 * BKQ * SD;               // [2][BKQ][SD]
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BKQ * SD);  // [BQ]
  float* Dl = Ls + BQ;                                      // [BQ]

  const int warp = threadIdx.x >> 5;
  const Lane ln(threadIdx.x & 31);
  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
  const int q0 = iq * BQ, hk = h / (Hq / Hkv);
  const int klim = min(L, kv_lens ? kv_lens[b] : L);  // keys at or past klim are masked
  const int kend = causal ? min(klim, q0 + BQ + offset) : klim;
  const int ntile = (kend + BKQ - 1) / BKQ;
  // In the loop keys are counted from -offset (kq = key - offset), so the
  // causal and window tests compare them with the rows as they stand.
  const int klimq = klim - offset;
  const int it0 = window ? max(0, q0 + offset - window + 1) / BKQ : 0;  // the band's first tile

  load_rows_async<T, D, BQ, NT>(Qs, q, b, q0, h, L, Hq);
  load_rows_async<T, D, BQ, NT>(dOs, dout, b, q0, h, L, Hq);
  load_vec_async<BQ, NT>(Ls, lse, b, q0, h, L, Hq);
  load_vec_async<BQ, NT>(Dl, delta, b, q0, h, L, Hq);
  load_rows_async<T, D, BKQ, NT>(Ks, k, b, it0 * BKQ, hk, L, Hkv);
  load_rows_async<T, D, BKQ, NT>(Vs, v, b, it0 * BKQ, hk, L, Hkv);
  cp_async_commit();

  const int wr = 16 * warp;       // the warp's first row in the tile
  const int r0 = q0 + wr + ln.g;  // this lane's rows r0 and r0 + 8
  const bool live = q0 + wr < L;  // warp-uniform
  float acc[NN][4];
  zero(acc);

  for (int it = it0; it < ntile; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it-1
    const int cur = (it - it0) & 1;
    const T* Kt = Ks + cur * BKQ * SD;
    const T* Vt = Vs + cur * BKQ * SD;
    if (it + 1 < ntile) {
      const int nb = cur ^ 1;
      load_rows_async<T, D, BKQ, NT>(Ks + nb * BKQ * SD, k, b, (it + 1) * BKQ, hk, L, Hkv);
      load_rows_async<T, D, BKQ, NT>(Vs + nb * BKQ * SD, v, b, (it + 1) * BKQ, hk, L, Hkv);
    }
    cp_async_commit();
    const int kq0 = it * BKQ - offset;
    if (!live || (causal && kq0 > q0 + wr + 15) || (window && kq0 + BKQ - 1 <= q0 + wr - window))
      continue;  // every p of the warp is 0: above its rows, or older than their band

    // s[j] / dp[j]: keys k0 + 8j + 2t and + 2t + 1 of rows r0 and r0 + 8.
    float p[NJ][4];
    {
      float x[NJ][4];  // S = Q K^T
      zero(p);
      zero(x);
      row_product<T, D, NJ, SPLIT>(p, x, Qs, wr, Kt, ln);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kq0 + 8 * j + 2 * ln.t + (e & 1);
          const int qi = wr + ln.g + ((e >> 1) << 3), row = q0 + qi;
          const bool ok = row < L && key < klimq && (!causal || key <= row) &&
                          (!window || key > row - window);
          p[j][e] = ok ? expf((p[j][e] + x[j][e]) * scale - Ls[qi]) : 0.f;
        }
    }
    float ds[NJ][4];
    {
      float x[NJ][4];  // dP = dO V^T
      zero(ds);
      zero(x);
      row_product<T, D, NJ, SPLIT>(ds, x, dOs, wr, Vt, ln);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = wr + ln.g + ((e >> 1) << 3);
          ds[j][e] = rnd(p[j][e] * (ds[j][e] + x[j][e] - Dl[qi]) * scale, (const T*)nullptr);
        }
    }

    // dQ += dS K: ds[kk] reordered is the A fragment of keys k0 + 8kk ..
    // + 7 (k-slots t / t+4 = keys 2t / 2t + 1, K's rows by load_b_cols).
#pragma unroll
    for (int c0 = 0; c0 < NN; c0 += NC) {
      float t[NC][4];
      zero(t);
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        FragA<SPLIT> a;
        a.set(ds[kk][0], ds[kk][2], ds[kk][1], ds[kk][3]);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          float b0, b1;
          load_b_cols<SD>(b0, b1, Kt, 8 * kk, 8 * (c0 + n), ln);
          mma_b<SPLIT>(t[n], t[n], a, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c0 + n][e] += t[n][e];
    }
  }
  cp_async_wait_all();  // no copy may outlive the CTA

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (!live || row >= L) continue;
    const size_t base = ((size_t)(b * L + row) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < NN; ++n) store2(dq + base + 8 * n + 2 * ln.t, acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
}

template <typename T, int D, bool WIN, bool OFF>
__global__ void __launch_bounds__(QTiles<D>::NT)
q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, const int* __restrict__ kv_lens, T* __restrict__ dq,
         int L, int Hq, int Hkv, int causal, int window, int offset, float scale) {
  q_tile<T, D, WIN, OFF>(q, k, v, dout, lse, delta, kv_lens, dq, L, Hq, Hkv, causal, window, offset,
                    scale);
}

// Head dims 16 and 8 declare one CTA a SM as their minimum: at ptxas's
// default register target for its 128 threads the f32 D=16 tile spills two
// registers (96 used), as flash_fwd.cu's D=16 tile does; with it, 86-112
// registers and no spill.
template <typename T, int D, bool WIN, bool OFF>
__global__ void __launch_bounds__(QTiles<D>::NT, 1)
q_kernel_narrow(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ kv_lens,
                T* __restrict__ dq, int L, int Hq, int Hkv, int causal, int window,
                int offset, float scale) {
  q_tile<T, D, WIN, OFF>(q, k, v, dout, lse, delta, kv_lens, dq, L, Hq, Hkv, causal, window, offset,
                    scale);
}

template <typename T, int D, bool WIN, bool OFF>
constexpr auto dq_kernel() {
  if constexpr (D <= 16) {
    return q_kernel_narrow<T, D, WIN, OFF>;
  } else {
    return q_kernel<T, D, WIN, OFF>;
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D, bool WIN, bool OFF>
cudaError_t launch_w(int mode, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const int* kv_lens, void* dq,
                     void* dk, void* dv, float* dqp, int B, int L, int Hq, int Hkv, int causal,
                     int window, int offset, float scale, cudaStream_t st) {
  cudaError_t err;
  const int nk = (L + BK - 1) / BK;
  if (mode == 0 || mode == 2) {  // fused, or dk/dv alone
    dim3 grid(nk, Hkv, B);
    if (mode == 0) {
      const size_t smem = kv_smem_bytes<T, D>();
      if ((err = set_smem(kv_kernel<T, D, true, WIN, OFF>, smem)) != cudaSuccess) return err;
      kv_kernel<T, D, true, WIN, OFF><<<grid, KV_NT, smem, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, kv_lens, (T*)dk,
          (T*)dv, dqp, L, Hq, Hkv, causal, window, offset, scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      size_t n = (size_t)B * L * Hq * D;
      int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
      dq_reduce_kernel<T><<<blocks, 256, 0, st>>>(dqp, (T*)dq, kv_lens, B, L, Hq, D, causal,
                                                  window, offset);
    } else {
      const size_t smem = kv_smem_bytes<T, D>();
      if ((err = set_smem(kv_kernel<T, D, false, WIN, OFF>, smem)) != cudaSuccess) return err;
      kv_kernel<T, D, false, WIN, OFF><<<grid, KV_NT, smem, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, kv_lens, (T*)dk,
          (T*)dv, nullptr, L, Hq, Hkv, causal, window, offset, scale);
    }
    return cudaGetLastError();
  }
  if (mode == 1) {  // dq alone
    using Q = QTiles<D>;
    const size_t smem = q_smem_bytes<T, D>();
    constexpr auto kern = dq_kernel<T, D, WIN, OFF>();
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    dim3 grid(Hq, B, (L + Q::BQ - 1) / Q::BQ);
    kern<<<grid, Q::NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
                                    delta, kv_lens, (T*)dq, L, Hq, Hkv, causal, window, offset,
                                    scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch(int mode, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* kv_lens, void* dq,
                   void* dk, void* dv, float* dqp, int B, int L, int Hq, int Hkv, int causal,
                   int window, int offset, float scale, cudaStream_t st) {
  // An offset runs on the offset build, which has a window: without one,
  // the window L + F, which masks nothing (row i keeps key j > i + F - W).
  if (offset)
    return launch_w<T, D, true, true>(mode, q, k, v, dout, lse, delta, kv_lens, dq, dk, dv,
                                      dqp, B, L, Hq, Hkv, causal, window ? window : L + offset,
                                      offset, scale, st);
  return window ? launch_w<T, D, true, false>(mode, q, k, v, dout, lse, delta, kv_lens, dq, dk,
                                              dv, dqp, B, L, Hq, Hkv, causal, window, 0, scale,
                                              st)
                : launch_w<T, D, false, false>(mode, q, k, v, dout, lse, delta, kv_lens, dq, dk,
                                               dv, dqp, B, L, Hq, Hkv, causal, 0, 0, scale, st);
}

}  // namespace

// q, dout [B, L, Hq, D]; k, v [B, L, Hkv, D] (contiguous, 16-byte aligned,
// f32 or bf16, one dtype); lse, delta [B, L, Hq] f32; kv_lens [B] int32 or
// NULL; window 0 for none, else W >= 1 (needs causal); offset 0, or F >= 1
// (needs causal) the rows' position ahead of the keys'; scale the scores'
// factor (1 / sqrt of the caller's head dim).
// mode 0 (fused): dq, dk, dv, with dqp an f32 scratch of
//   ceil(L/64) * B * L * Hq * D floats;
// mode 1: dq alone; mode 2: dk and dv alone (dqp unused).
// Outputs in the input dtype; dk, dv [B, L, Hkv, D].
extern "C" int flash_bwd(int mode, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta,
                         const int* kv_lens, void* dq, void* dk, void* dv, float* dqp, int B,
                         int L, int Hq, int Hkv, int D, int causal, int window, int offset,
                         int is_bf16, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv < 1 || Hq % Hkv || B < 1 || L < 1 || window < 0 || (window && !causal) ||
      offset < 0 || (offset && !causal))
    return (int)cudaErrorInvalidValue;
#define BWD_ARGS                                                                              \
  mode, q, k, v, dout, lse, delta, kv_lens, dq, dk, dv, dqp, B, L, Hq, Hkv, causal, window, offset, \
      scale, st
  if (D == 8)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 8>(BWD_ARGS) : launch<float, 8>(BWD_ARGS));
  if (D == 16)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 16>(BWD_ARGS) : launch<float, 16>(BWD_ARGS));
  if (D == 32)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 32>(BWD_ARGS) : launch<float, 32>(BWD_ARGS));
  if (D == 64)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 64>(BWD_ARGS) : launch<float, 64>(BWD_ARGS));
  if (D == 128)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 128>(BWD_ARGS) : launch<float, 128>(BWD_ARGS));
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
