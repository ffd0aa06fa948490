// Fused GPT decode for Hopper (sm_90a), CUDA C++: one cooperative kernel
// for the per-layer step, the whole-model step and the speculation verify,
// each instantiated for the slab cache and for the paged block pool.
//
//   coop_step_kernel<Rows, false, true, KV>  replaces distributed_tensorflow_tpu/
//                        ops/pallas_decode.py _fused_decode_kernel (B5; per
//                        layer; launched by _fused_call, public
//                        decode_block_slab / decode_block_paged): one layer's
//                        step; the fresh K/V rows go back to the caller
//                        (k_fresh / v_fresh), which commits them.
//   coop_step_kernel<Rows, false, false, KV>  replaces pallas_decode.py
//                        _mega_decode_kernel (B6, the megakernel; launched by
//                        _mega_call, public decode_token_slab /
//                        decode_token_paged). Every layer in one launch, with
//                        the fresh-row commit done in the kernel.
//   coop_step_kernel<PagedRows, true, false, KV>  replaces pallas_decode.py
//                        _verify_kernel (B7, public verify_tokens_paged): the
//                        speculation verify, L draft rows per slot through
//                        every layer in one launch over the paged pool,
//                        committed in the kernel.
//
// Each is built for one compute dtype (Act: the weights, the activations
// staged for the products, the attended values) and instantiated for three
// KV storage types (the KV template parameter): a cache of the compute
// dtype, and int8 or e4m3 codes with one f32 scale a row (one position of
// one KV head; pallas_decode.py _quant_row). The default build computes in
// bf16 (library fused_decode: bf16, int8, e4m3 caches), the build with
// -DDECODE_F32 in f32 (library fused_decode_f32: f32, int8, e4m3 caches):
// the JAX kernels' compute_dtype= (pallas_decode.py :524/:536), whose
// "bf16" cache stores the compute dtype (ops/quantized.py
// kv_storage_dtype). One body serves both; the two builds compile side by
// side. RoPE is a flag of the launch.
//
// One slot's step for one layer: LN1 -> q/k/v projections -> RoPE of the q
// and fresh k rows at their own positions (pallas_decode.py _rope_rows: f32,
// pairs (x_i, x_{i+Dh/2}), frequency 10000^(-i/(Dh/2))) -> fresh K/V rows
// rounded through the cache (its dtype; or quantized with the row's amax
// scale, then attended as their dequantized value in the compute dtype) ->
// attention of the slot's queries over its cache positions [0, length) read
// PRE-write (1-byte codes are dequantized to the compute dtype as they
// arrive) plus the fresh rows from `length` on -> output projection +
// residual -> LN2 -> FFN (tanh GELU) + residual. The rounding points follow
// models/gpt.py's XLA engine (_dot_full, dequantize_kv): in bf16 the
// layernormed rows, the attention output and gelu(up) are cast to bf16
// before each product, products accumulate in f32, and (decode only) the
// normalized softmax weights are cast to bf16 before they weight the bf16
// values; in f32 none of these casts happens. The verify keeps the weights
// f32, masks the suffix causally and gives 0 for a row with no valid key,
// as the TPU verify kernel does.
//
// Sliding window (W > 0, a launch argument). A windowed slab is a rolling
// buffer of C slots, position p at slot p mod C (pallas_decode.py's
// rolling=window is not None, :559 and :1039); the pool addresses
// absolutely. A step at length n reads only the band's positions, from
// lo = max(0, n - W + 1) (on the slab also n - C + 1: the write slot,
// n mod C, still holds position n - C) to n - 1, in the same chunks and
// order whatever the layout, so a paged read is O(W) and a rolling slab's
// step equals the paged one bit for bit. The verify reads from its row
// 0's band start and masks row li's cache positions <= prefix + li - W and
// its fresh rows lj <= li - W (pallas_decode.py :1189-1190, :1222-1223).
//
// Paged addressing. Position p of slot s lives at
// pool[table[s, p / bs], p % bs]. The arithmetic is the slab kernels' own:
// only the row offset (SlabRows / PagedRows) differs, and no partition or
// summation order depends on the block layout, so a paged launch over a pool
// holding the same logical cache gives the slab launch's results bit for bit.
// Live slots never share a writable block (the server's allocator shares only
// full prompt blocks, and writes land past the prompt), so in-kernel commits
// stay disjoint from every read.
//
// Bound: at gpt-m (d=512, 8 layers, F=2048, MHA 8x64) one B6 launch must
// move ~50 MB of bf16 weights and, at S=8 slots and a mean cache length of
// 512, ~67 MB of K/V: ~35 us at 3.35 TB/s (bytes; the products, 2 x S*R rows
// x 25M MACs, are far below the tensor cores' rate); an int8/e4m3 cache
// moves a byte an element and a 4-byte scale a row of Dh (~36 MB of K/V:
// ~26 us in all). B5 moves one layer of
// that (~14 MB, ~4.2 us); at gpt-xl width (d=2048, 16x128, F=8192) a layer
// holds ~100 MB of weights (~40 us with its K/V). In f32 at decode-full
// (d=256, 4 layers, 8x32, F=1024) one B6 launch moves ~12.6 MB of f32
// weights and, at S=8 and lengths 256-512, ~25 MB of f32 K/V: ~11 us (the
// split-TF32 products, three MMAs each, still far below the rate).
// Design: one cooperative launch over the whole card, CT threads a CTA (the
// grid is the SM count times the occupancy, read at launch;
// ops/fused_decode.py coop_plan lays it out). Each layer runs five phases
// with a grid-wide barrier after each (5 n - 1 a launch); the state between
// phases lives in global scratch (the f32 residual rows in h_out, q/k/v f32,
// the attention output and gelu(up) in the compute dtype):
//   (a) every CTA with a q/k/v column tile layernorms all S*R rows into its
//       shared memory (from L2), then computes its tiles;
//   (b) one task per (slot, KV head): the head group's g x R query rows over
//       the cache row with the exact softmax, through a score tile of the
//       plan's kb keys (the whole row where it fits, else the row in blocks,
//       read twice: attend()); it rounds and commits the fresh K/V rows of
//       its head (attention reads only positions < length, the commits land
//       at >= length, so no commit races a read), or, for B5, writes them to
//       k_fresh / v_fresh;
//   (c) output projection, the owner of a column tile adding the residual;
//   (d) LN2 of all rows, up projection, bias, GELU (in the compute dtype);
//   (e) down projection, bias and residual.
// Products: column tiles of tw = 8 to 64 output columns over the full K
// (the plan takes for each product the width that gives the busiest CTA
// the fewest columns, then the widest); tile t goes to CTA t mod grid, so
// each weight element is read once a launch. A CTA's weights stream
// through a ring of nw slots in shared memory, in chunks of its tiles x kw
// rows (the weight stream: every layer's products in order), each chunk a
// TMA box a tile (rows of tw columns), issued by one warp (a chunk a lane,
// all at once) and counted by the slot's mbarrier, so no thread stalls on
// a weight copy. The grid barriers issue them, by a warp that would
// otherwise wait, one product ahead (issuing them further ahead measured
// slower); a product whose chunks outnumber the ring's free slots tops it up
// itself as it frees them. The first phase's chunks are in flight before
// LN1. One chunk a product where it fits (gpt-m), so a width's weights need
// not fit in shared memory (gpt-xl: ~760 KB a CTA a layer). Activations
// that come from another CTA (the attention output, gelu(up)) are staged by
// the TMA, one bulk copy a row, in chunks of d columns, up to MAXS in
// flight.
// The products run on the tensor cores. bf16: mma.sync m16n8k16, bf16
// operands, f32 sums (the operands are bf16 values, so each product is
// exact and only the order of the sums changes), k-steps of 16. f32:
// split-TF32 mma.sync m16n8k8 (flash_mma.cuh: each operand split into a
// TF32 hi and lo, the product lo*hi + hi*lo + hi*hi; one TF32 pass would
// miss f32 by ~4e-4), k-steps of 8. The activations are staged in f32 and
// split as the A fragment is loaded: staged split, a slot would hold two
// TF32 words an element, twice the shared memory and the TMA bytes, to save
// four conversions a k-step that each A fragment serves to every subtile.
// Each k-step's three MMAs sum into fresh registers, added to the tile's
// sums in f32 (the tensor cores truncate as they accumulate, so a long sum
// taken by the MMAs alone would lose up to an ulp a step, all one way); a
// second set of accumulators for the small terms would cost 32 registers
// and spill. Each f32 weight tile's row is at most 128 bytes (32 columns),
// the TMA's widest swizzled box. Warp w takes m-tile w mod cs and the
// k-steps of k-group w / cs (counted from each x chunk's start), and the
// k-groups' partial sums meet in shared memory and are added in k-group
// order, so the order of every sum depends only on the row count and K,
// never on the grid, the weight chunks or the launch's layer count: a step
// through B5 layer by layer, with the commits, equals one B6 launch bit for
// bit. The k-step loop is built for each count of a CTA's 8-column
// subtiles (chunk_mma), so it carries no per-subtile test or swizzle
// arithmetic: with 40 rows (the verify) each warp runs three times the
// k-steps, and that overhead had cost B7 9%.
// A step over more slots than one launch takes (ops/fused_decode.py
// slot_group: rows, and the busiest CTA's tiles x m-tiles) runs as launches
// over groups of slots, one after another; every group's k-groups are the
// first group's (the plan's cs), so each row's sums keep their order.
// Attention: each thread streams its own VD dims of every K (then V) row
// through a ring of RING 16-byte cp.async slots in shared memory (RING - 1
// chunks in flight and no registers spent on them): 8 dims of bf16 (16
// bytes), 4 dims of f32 (16 bytes), or 8 bytes of codes under bf16 compute
// and 4 under f32 (and, by the row's first lane, the row's 4-byte scale),
// so a 1-byte cache moves a fraction of the bytes with the same per-thread
// geometry as its compute dtype's cache: a row takes Dh / 8 lanes in bf16,
// Dh / 4 in f32 (LPR: 1 to 32 lanes a key row, Dh = 8 to 128); the
// softmax's maxima and sums meet across the warps in warp order. Dh = 4 is
// one lane a row in both builds: the f32 build streams its whole 16-byte
// row (or 4 codes) as at any Dh; the bf16 build, whose lanes take 8 dims,
// copies a half slot (8 bytes of bf16, or 4 codes, through the 8- and
// 4-byte copies) and zeroes dims 4-7 where it unpacks them, so the scores'
// and P·V's extra terms are exact zeros and the other head dims run the
// same instructions (one body: a second instantiation of the attention for
// Dh = 4 spilled a register in the bf16 build).
// The grid barrier is a flag a CTA (grid_sync), polled by one warp a CTA:
// a single counter would take every CTA's atomic (PERF.md section 6 has the
// two timed). Its epochs are kept on the device, so a launch needs no state
// from the host and may be replayed from a CUDA graph.
// There are no float atomics: two launches on the same inputs agree bit for
// bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-5f;
constexpr float KV_EPS = 1e-12f;  // ops/quantized.py _EPS

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 e4m3;

// The build's compute dtype (see the top of the file): Act, and the cache
// type that stores it (the "bf16" cache layout of ops/quantized.py).
#ifdef DECODE_F32
typedef float Act;
#else
typedef bf16 Act;
#endif
constexpr bool F32 = std::is_same<Act, float>::value;

// The KV storage types: the compute dtype (bf16 or f32), or 1-byte codes
// (int8, e4m3) with a scale a row that maps the row's amax onto QMAX
// (ops/quantized.py _QMAX). VD: the dims of a row one thread streams (16
// bytes of bf16 or f32; 8 codes under bf16 compute, 4 under f32, whose
// P·V sums of 8 dims a thread, in f32, spilled registers).
template <class KV>
struct KvCodes {
  static constexpr bool QUANT = false;
  static constexpr int VD = 16 / (int)sizeof(KV);
};
template <>
struct KvCodes<int8_t> {
  static constexpr bool QUANT = true;
  static constexpr int VD = F32 ? 4 : 8;
  static constexpr float QMAX = 127.f;
  // Round half to even, clip (ops/quantized.py _quantize).
  static __device__ __forceinline__ int8_t code(float xs) {
    return (int8_t)fminf(fmaxf(rintf(xs), -QMAX), QMAX);
  }
  static __device__ __forceinline__ float value(int8_t c) { return (float)c; }
};
template <>
struct KvCodes<e4m3> {
  static constexpr bool QUANT = true;
  static constexpr int VD = F32 ? 4 : 8;
  static constexpr float QMAX = 448.f;
  // Round to nearest even; |xs| <= 448 by construction.
  static __device__ __forceinline__ e4m3 code(float xs) {
    e4m3 c;
    c.__x = __nv_cvt_float_to_fp8(xs, __NV_SATFINITE, __NV_E4M3);
    return c;
  }
  static __device__ __forceinline__ float value(e4m3 c) { return (float)c; }
};

// C: a slot's logical extent (the slab length, or MB * bs). bs, MB: the
// pool's block size and the tables' width (0, 0 for the slab). W: the
// sliding window (0: none); rolling: the slab keeps position p at slot
// p mod C (a windowed slab).
struct Dims {
  int S, d, Hq, Hkv, Dh, F, C, bs, MB, W, rolling;
};

// Row of logical position j of slot s in one layer's cache (Hkv x Dh
// elements, and Hkv scales, a row); `tab` is the slot's table row (paged
// only).
struct SlabRows {
  __device__ __forceinline__ size_t operator()(const Dims& D, const int*, int s,
                                               int j) const {
    return (size_t)s * D.C + (D.rolling ? j % D.C : j);
  }
};
struct PagedRows {
  __device__ __forceinline__ size_t operator()(const Dims& D, const int* tab, int,
                                               int j) const {
    return (size_t)tab[j / D.bs] * D.bs + j % D.bs;
  }
};

// One layer's weights (projections [in, out] row-major in the compute
// dtype, the rest f32).
struct LayerW {
  const void *wq, *wk, *wv, *wo, *w_up, *w_down;
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b, *b_up, *b_down;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// x rounded to T (bf16 or f32), as a float; and stored as T.
template <class T>
__device__ __forceinline__ float rnd(float x) {
  return std::is_same<T, bf16>::value ? bf16r(x) : x;
}
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// One 16-byte load of a row (eight bf16 or four f32 values) as floats.
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, const bf16*) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = __bfloat1622float2(k2[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

// N 1-byte codes (N / 4 words of one load) dequantized with the row's
// scale to the compute dtype, as floats (ops/quantized.py dequantize_kv).
// Both forms give the codes' values exactly, without a quarter-rate
// integer-to-float conversion an element.
// int8: code b's byte, offset to b + 128, set in the mantissa of 2^23; the
// float 2^23 + b + 128 less 2^23 + 128 is b.
template <int N>
__device__ __forceinline__ void unpack_codes(const uint32_t (&raw)[N / 4], float scale,
                                             float* out, const int8_t*) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float v = __uint_as_float(__byte_perm(raw[e >> 2] ^ 0x80808080u, 0x4B000000u,
                                                0x7440u | (e & 3))) -
                    8388736.f;
    out[e] = rnd<Act>(v * scale);
  }
}

// e4m3: two codes a conversion to half2 (e4m3 values are exact in half).
template <int N>
__device__ __forceinline__ void unpack_codes(const uint32_t (&raw)[N / 4], float scale,
                                             float* out, const e4m3*) {
#pragma unroll
  for (int p = 0; p < N / 2; ++p) {
    const __half2 h = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(raw[p >> 1] >> (16 * (p & 1))), __NV_E4M3);
    const float2 f = __half22float2(h);
    out[2 * p] = rnd<Act>(f.x * scale);
    out[2 * p + 1] = rnd<Act>(f.y * scale);
  }
}

// cos and sin of RoPE's angle for dim pair e of `half` at position pos, in
// the plain version's order: 10000^(-e / half), times pos.
__device__ __forceinline__ void rope_cs(int pos, int e, int half, float& c, float& s) {
  const float freq = powf(10000.f, -(float)e / (float)half);
  sincosf((float)pos * freq, &s, &c);
}

// -- the cooperative kernel ---------------------------------------------------

constexpr int CT = 384;  // threads of a CTA
constexpr int CW = CT / 32;
constexpr int TILE = 8;  // columns of an MMA subtile of a weight tile
// The products' k-step: bf16 m16n8k16, f32 (split-TF32) m16n8k8.
constexpr int KSTEP = F32 ? 8 : 16;
// Elements of padding at the end of an x slot's row (16 bytes): bf16 rows
// 4 banks apart for ldmatrix, f32 rows 4 banks apart for the A fragment's
// row-gathers (rows g, columns t and t + 4).
constexpr int XPAD = 16 / (int)sizeof(Act);
constexpr int MAXT = 8;  // most tiles of one product a CTA takes
constexpr int MAXTM = 8;  // most tiles x m-tiles of one product a CTA takes
constexpr int NWMAX = 16;  // most slots of the weight ring
constexpr int GMAX = 5;  // query rows one P·V pass accumulates
constexpr int MAXS = 4;  // most x slots
constexpr int RING = 8;  // 16-byte cp.async slots a thread streams K / V through
constexpr int MAX_GRID = 1024;  // most CTAs (the grid barrier's flags)

// The launch plan (ops/fused_decode.py coop_plan): CTAs, the width in columns
// of a staged chunk of x (= d), the weight ring (nw slots of wslot bytes from
// offset 0; chunks of kw[product] rows, kw dividing kc, of column tiles of
// tw[product] = 8, 16, 32 or 64 columns, at most 128 bytes a row), and the rest of the
// shared-memory layout in bytes: the next layernorm's scale and bias ([2][d]
// f32 at ln); nslot x slots from x0, xs bytes apart (the attention's
// scratch overlays them); the product partial sums at red, the region's
// end (over the slots' tail where they do not fit beside them); the
// mbarriers: one an x slot, a full and an empty one a weight slot, one for
// the layernorm's parameters. kb: the attention's score tiles, in keys (the
// cache extent C where one block holds every key, else narrower: the cache
// streams in blocks of kb keys). cs: the m-tile lanes of the warps (1, 2 or
// 4; CW / cs k-groups), from the rows of the whole step, so a launch over a
// group of its slots sums in the same order.
struct Plan {
  int grid, kc, wslot, nw, kw[4], tw[4], ln, x0, xs, nslot, red, bar, smem, kb, cs;
};

struct Coop {
  // TMA maps of the projections as 2-D [n_layers * K, N] Act (wq, wk, wv,
  // wo, w_up, w_down), boxes of tw columns x min(kw, 256) rows of the
  // product's weight chunks; encoded per launch (launch_coop).
  CUtensorMap maps[6];
  LayerW w0;  // layer-stacked
  Dims D;
  Plan p;
  int n_layers, R;  // R: rows a slot (1, or the verify's L)
  int rope;         // rotate q and the fresh k rows (RoPE)
  size_t layer_elems;
  const float* h_in;
  float* h_out;  // [S * R, d]: the residual rows between phases
  void *ck, *cv;     // the KV cache: the compute dtype, or 1-byte codes
  float *ks, *vs;    // its scales [.., Hkv] a row (1-byte codes), else null
  // lengths: the decode's write positions, or the verify's prefix lengths.
  const int *lengths, *suffix, *active, *tables;
  float* qkv;  // [S * R, Hq Dh + 2 Hkv Dh]
  Act* att;   // [S * R, Hq Dh]
  Act* gelu;  // [S * R, F]
  // B5's fresh rows [S, Hkv, Dh] in the cache's type and, for 1-byte codes,
  // their scales [S, Hkv] (else null).
  void *k_fresh, *v_fresh;
  float *ks_fresh, *vs_fresh;
  // The grid barrier's flags: [MAX_GRID] words, one a CTA, then the epoch
  // the last launch on them ended at (see grid_sync()).
  unsigned* flags;
#ifdef DECODE_PROBE
  // Phase stamps, or null (see stamp()).
  unsigned long long* stamps;
#endif
};

// The cooperative kernels' dynamic shared memory, laid out by the Plan.
extern __shared__ __align__(1024) unsigned char coop_smem[];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 8- and 4-byte copies (cached at all levels: .cg takes 16 bytes only).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, P1;\n\t"
      "}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete. A copy that never lands
// traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long n = 0; !mbar_try(bar, parity); ++n)
    if (n == (1ll << 26)) __trap();
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One TMA bulk copy of `bytes` contiguous bytes into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One TMA copy of the box of `map` at (column col, row row) into dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses (of shared memory, of
// global memory) before its later TMA copies.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n\tfence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Grid-wide barrier of the cooperative grid: CTA b posts `epoch` in
// flags[b] (a release at gpu scope after the CTA's barrier, so it covers
// every thread's earlier writes), then warp 0 polls all the flags until each
// has reached the epoch, and acquires. No word takes every CTA's atomic, as
// a counter's does, so the cost does not grow with the grid. Epochs wrap.
//
// The epochs live on the device: a launch's warp 0 reads the base from
// flags[MAX_GRID] on entry (epoch_in), its i-th sync posts base + i, and CTA
// 0 stores the last epoch back on exit (epoch_out). Every CTA has read the
// base before it posts its first sync, so CTA 0 stores only after all have
// read it; the next launch in stream order reads the new base. So launches
// may be replayed from a CUDA graph; launches that run at once on one flags
// buffer would race (the wrapper keeps one buffer a stream).
__device__ __forceinline__ unsigned epoch_in(const unsigned* flags) {
  unsigned v = 0;
  if (threadIdx.x < 32)
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flags + MAX_GRID)
                 : "memory");
  return v;
}

__device__ __forceinline__ void epoch_out(unsigned* flags, unsigned epoch) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(flags + MAX_GRID), "r"(epoch)
                 : "memory");
}

// `between` runs on every thread after the CTA has posted its epoch and
// before warp 0 polls: work that need not delay the grid (the weight
// stream's refills).
template <class Between>
__device__ void grid_sync(unsigned* flags, unsigned epoch, int grid, Between between) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flags + blockIdx.x), "r"(epoch)
                 : "memory");
  between();
  if (threadIdx.x < 32) {
    for (long long n = 0;; ++n) {
      bool ok = true;
      for (int i = threadIdx.x; i < grid; i += 32) {
        unsigned v;
        asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flags + i) : "memory");
        ok = ok && (int)(v - epoch) >= 0;
      }
      if (__all_sync(0xffffffffu, ok)) break;
      if (n == (1ll << 26)) __trap();
    }
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
}

__device__ void grid_sync(unsigned* flags, unsigned epoch, int grid) {
  grid_sync(flags, epoch, grid, [] {});
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr)
               : "memory");
}

// c += a b: A 16 x 16 (row), B 16 x 8 (col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The four products of a layer: q/k/v, output, up, down.
enum { QKV = 0, OUT = 1, UP = 2, DOWN = 3 };
struct Prod {
  int K, N;
};

__device__ __forceinline__ Prod prod_dims(const Dims& D, int which) {
  const int qw = D.Hq * D.Dh;
  switch (which) {
    case QKV: return {D.d, qw + 2 * D.Hkv * D.Dh};
    case OUT: return {qw, D.d};
    case UP: return {D.d, D.F};
    default: return {D.F, D.d};
  }
}

// Tiles of a product with T tiles this CTA owns (blockIdx.x + i * grid).
__device__ __forceinline__ int my_tiles(int T, int grid) {
  return (int)blockIdx.x < T ? (T - 1 - (int)blockIdx.x) / grid + 1 : 0;
}

// The TMA map of weight column tile t (of tw columns) of product `which` at
// layer l, and the tile's first column and row in that map.
__device__ __forceinline__ void tile_map(const Coop& a, int l, int which, int t, int tw, int& m,
                                         int& col, int& row) {
  const Dims& D = a.D;
  const int qw = D.Hq * D.Dh, kvw = D.Hkv * D.Dh;
  col = t * tw;
  switch (which) {
    case QKV:
      row = l * D.d;
      m = col < qw ? 0 : col < qw + kvw ? 1 : 2;
      col -= m == 0 ? 0 : m == 1 ? qw : qw + kvw;
      return;
    case OUT: m = 3; row = l * qw; return;
    case UP: m = 4; row = l * D.d; return;
    default: m = 5; row = l * D.F; return;
  }
}

// Phase stamps for chip_smoke.py's split of a launch, in the probe build
// (-DDECODE_PROBE, module fused_decode_probe) when a.stamps is set:
// thread 0 of each CTA writes clock64 at NST points of each layer l (at
// NST l + k; STAMP_POINTS below), then %globaltimer and clock64 at the
// kernel's start and end (NST n .. NST n + 3), the clock's rate.
constexpr int NST = 19;
// (a) start, LN1 done, product ready, end; (b) start, q/k/v and the table
// loaded, scores done, softmax done, end; (c) start, x staging issued, end;
// (d) start, LN2 done, product ready, end; (e) start, x staging issued, end.
enum {
  S_A0, S_A_LN, S_A_W, S_A1, S_B0, S_B_IN, S_B_SC, S_B_SM, S_B1,
  S_C0, S_C_W, S_C1, S_D0, S_D_LN, S_D_W, S_D1, S_E0, S_E_W, S_E1
};
__device__ __forceinline__ void stamp(const Coop& a, int k, bool timer = false) {
#ifdef DECODE_PROBE
  if (a.stamps && threadIdx.x == 0) {
    unsigned long long t;
    if (timer)
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    else
      t = clock64();
    a.stamps[(size_t)blockIdx.x * (NST * a.n_layers + 4) + k] = t;
  }
#endif
}

// The x slots ([rows][kc + XPAD] Act each) and their mbarriers; bit i of
// `loads` is the parity of the count of loads into slot i (every thread of
// the CTA keeps the same bits), so the last load into it completes the
// mbarrier's phase of parity 1 - that bit.
struct Ring {
  uint32_t loads;
};

__device__ __forceinline__ Act* slot_ptr(const Plan& p, int i) {
  return reinterpret_cast<Act*>(coop_smem + p.x0 + (size_t)i * p.xs);
}

__device__ __forceinline__ uint64_t* bar_ptr(const Plan& p, int i) {
  return reinterpret_cast<uint64_t*>(coop_smem + p.bar) + i;
}

// The TMA copies columns [k0, k0 + kc) of rows [0, rows) of src (row stride
// ld) into slot i; warp 0 issues them, one bulk copy a row. Called by every
// thread, after a barrier that ends all reads of the slot.
__device__ void stage(const Plan& p, Ring& x, int i, const Act* src, int ld, int rows, int k0,
                      int kc) {
  if (threadIdx.x < 32) {
    uint64_t* bar = bar_ptr(p, i);
    Act* dst = slot_ptr(p, i);
    if (threadIdx.x == 0) mbar_expect_tx(bar, (uint32_t)(rows * kc * sizeof(Act)));
    __syncwarp();
    for (int r = threadIdx.x; r < rows; r += 32)
      bulk_load(dst + (size_t)r * (p.kc + XPAD), src + (size_t)r * ld + k0,
                kc * (int)sizeof(Act), bar);
  }
  x.loads ^= 1u << i;
}

// The first chunks of a product's x from src, one a slot, after a fence
// that orders the phase's earlier generic writes (the attention scratch over
// the slots; src, by other CTAs before the grid sync) before the copies.
__device__ void stage_first(const Plan& p, Ring& x, const Act* src, int ld, int rows, int K) {
  if (threadIdx.x < 32) fence_async();
  for (int i = 0; i < p.nslot && i * p.kc < K; ++i)
    stage(p, x, i, src, ld, rows, i * p.kc, min(p.kc, K - i * p.kc));
}

// The weight stream: every chunk of every product this CTA multiplies, in
// the order the kernel consumes them (layer, then q/k/v, output, up, down),
// chunk j of a product being rows [j kw, (j + 1) kw) of the CTA's tiles;
// chunk k of the stream is chunk k - l per of layer l = k / per. Chunk k
// goes to weight slot k % nw as [tile][kw][tw] Act: one TMA box a tile's
// tw columns (two or more where kw > 256; rows of 32 to 128 bytes swizzled
// by the TMA, so that the MMA's B loads stay free of bank conflicts in bf16),
// counted by the slot's full mbarrier, phase k / nw. Every warp arrives on
// the slot's empty mbarrier once it is done with the chunk, and the chunk
// that refills the slot waits for that. Every thread keeps the same counts;
// the CTA's tiles and chunks of each product are counted once.
struct WStream {
  int issued, used;   // chunks issued, chunks consumed
  int per;            // chunks a layer
  int nt[4], nck[4];  // this CTA's tiles and chunks of each product
};

__device__ __forceinline__ Act* wslot_ptr(const Plan& p, int i) {
  return reinterpret_cast<Act*>(coop_smem + (size_t)i * p.wslot);
}

// The full (count 1, with the copies' bytes) and empty (count CW) mbarriers
// of weight slot i.
__device__ __forceinline__ uint64_t* wfull_ptr(const Plan& p, int i) {
  return bar_ptr(p, p.nslot + i);
}
__device__ __forceinline__ uint64_t* wempty_ptr(const Plan& p, int i) {
  return bar_ptr(p, p.nslot + p.nw + i);
}

// Element `which` of a per-product array (selected, not indexed, so that
// the array stays in registers or the kernel's parameters).
__device__ __forceinline__ int pick(const int (&v)[4], int which) {
  return which == QKV ? v[0] : which == OUT ? v[1] : which == UP ? v[2] : v[3];
}

__device__ WStream ws_start(const Coop& a) {
  WStream ws{0, 0, 0, {}, {}};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const Prod pd = prod_dims(a.D, w);
    const int kw = pick(a.p.kw, w);
    ws.nt[w] = my_tiles(pd.N / pick(a.p.tw, w), a.p.grid);
    ws.nck[w] = ws.nt[w] ? (pd.K + kw - 1) / kw : 0;
  }
  ws.per = ws.nck[0] + ws.nck[1] + ws.nck[2] + ws.nck[3];
  return ws;
}

// Issues the stream's chunks into the free slots, those of products up to
// product `lp` of layer `ll`, until the ring is full or the stream ends.
// Called by every thread; lane i of warp `issuer` issues the i-th chunk (and
// the 32nd after it ...), all at once: it waits until every warp is done
// with the slot's last chunk, arms the full mbarrier and issues the boxes.
__device__ void ws_fill(const Coop& a, WStream& ws, int issuer, int ll, int lp) {
  int end = ll * ws.per + ws.nck[0];
  if (lp >= OUT) end += ws.nck[1];
  if (lp >= UP) end += ws.nck[2];
  if (lp >= DOWN) end += ws.nck[3];
  end = min(min(end, a.n_layers * ws.per), ws.used + a.p.nw);
  if (ws.issued >= end) return;
  if ((int)(threadIdx.x >> 5) == issuer) {
    for (int k = ws.issued + (threadIdx.x & 31); k < end; k += 32) {
      const int l = k / ws.per;
      int j = k - l * ws.per, which = QKV;  // chunk j of product `which`
      if (j >= ws.nck[0]) {
        j -= ws.nck[0];
        which = OUT;
        if (j >= ws.nck[1]) {
          j -= ws.nck[1];
          which = UP;
          if (j >= ws.nck[2]) {
            j -= ws.nck[2];
            which = DOWN;
          }
        }
      }
      const int kw = pick(a.p.kw, which), tw = pick(a.p.tw, which), nt = pick(ws.nt, which);
      const int slot = k % a.p.nw, box = kw < 256 ? kw : 256;
      uint64_t* bar = wfull_ptr(a.p, slot);
      if (k >= a.p.nw) mbar_wait(wempty_ptr(a.p, slot), (k / a.p.nw - 1) & 1);
      mbar_expect_tx(bar, (uint32_t)(nt * kw * tw * sizeof(Act)));
      Act* dst = wslot_ptr(a.p, slot);
      for (int t = 0; t < nt; ++t) {
        int m, col, row;
        tile_map(a, l, which, (int)blockIdx.x + t * a.p.grid, tw, m, col, row);
        for (int r = 0; r < kw; r += box)
          tma_load_2d(dst + ((size_t)t * kw + r) * tw, &a.maps[m], col, row + j * kw + r, bar);
      }
    }
  }
  ws.issued = end;
}

// acc[t] += x W over the k-steps ks, ks + kg, ... < s1 of one weight chunk
// (at shared address wb, its first row the x chunk's row c0), for NS
// subtiles. bf16: the A fragment by ldmatrix at xs (k-step 0), the B
// fragments at wb + the k-step's rows + boff[t]. f32: the A fragment's
// rows g and g + 8 at xs and xs8 (column t of k-step 0), split once a
// k-step; each subtile's B rows t and t + 4 at boff[t] and 4 rows on (in
// the swizzle, 4 rowb bytes on with the XOR key's bit for row 4 flipped:
// rowb / 2), split, its three MMAs (flash_mma.cuh mma_b) summed from zero
// and added to acc[t]. NS is a constant,
// so the loop over the subtiles carries no test and no address arithmetic
// beyond one add.
template <int NS>
__device__ __forceinline__ void chunk_mma(float (&acc)[MAXT][4], const Act* xs, const Act* xs8,
                                          uint32_t wb, const uint32_t (&boff)[MAXT], int ks,
                                          int s1, int kg, int c0, int rowb) {
  for (; ks < s1; ks += kg) {
    const uint32_t rb = wb + (uint32_t)((ks * KSTEP - c0) * rowb);
    if constexpr (F32) {
      const float* p0 = reinterpret_cast<const float*>(xs) + ks * 8;
      const float* p1 = reinterpret_cast<const float*>(xs8) + ks * 8;
      flash::FragA<true> af;
      af.set(p0[0], p1[0], p0[4], p1[4]);
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t b1 = (boff[t] + 4 * rowb) ^ (rowb >> 1);
        flash::mma_b<true>(p, p, af, lds_f32(rb + boff[t]), lds_f32(rb + b1));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] += p[e];
      }
    } else {
      uint32_t af[4];
      ldsm_x4(af, xs + ks * 16);
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, rb + boff[t]);
        mma_bf16(acc[t], af, b0, b1);
      }
    }
  }
}

// y[r, c] = sum_k x[r, k] W[k, c] over this CTA's tiles of product `which`,
// handed to epi(c, r, y, pre(c, r)) for r < rows; pre's loads are issued
// before x and the sums are waited on. x sits in slot 0 (src null), or comes
// from src (row stride ld) in chunks of kc columns through the slots, the
// first ones already staged; W comes chunk by chunk from the weight stream.
// Warp w takes m-tile w % cs (cs = the plan's, at least the m-tiles: warps
// past them idle) and the k-steps of k-group w / cs, counted from the x
// chunk's start; the partial sums meet in `red` and are added in k-group
// order.
template <class Pre, class Epi>
__device__ void product(const Coop& a, WStream& ws, int l, int which, int rows, Ring& x,
                        const Act* src, int ld, Pre pre, Epi epi) {
  const Prod pd = prod_dims(a.D, which);
  // Tiles of tw columns, each tw / 8 MMA subtiles; subtile s is column
  // block j = s % per of tile t = s / per, at column col_of(s).
  const int tw = pick(a.p.tw, which), per = tw / TILE, lp = __ffs(per) - 1, sub = per - 1;
  const int nt = pick(ws.nt, which), ns = nt * per;
  const auto col_of = [&](int s) {
    return ((int)blockIdx.x + (s >> lp) * a.p.grid) * tw + (s & sub) * TILE;
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = (rows + 15) / 16, cs = a.p.cs, kg = CW / cs;
  const int ms = warp % cs, kgr = warp / cs;
  // The A fragment's rows (past the last they repeat it; their sums are
  // dropped) and first column: bf16, this lane's ldmatrix row and column
  // block; f32, rows g and g + 8, column t.
  const int arow = min(ms * 16 + (F32 ? lane >> 2 : lane & 15), rows - 1);
  const int arow8 = min(ms * 16 + (lane >> 2) + 8, rows - 1);
  const int acol = F32 ? lane & 3 : (lane >> 4) * 8;
  const int kc = a.p.kc, kw = pick(a.p.kw, which), nch = src ? (pd.K + kc - 1) / kc : 1;
  // This thread's outputs: i = threadIdx.x + k CT, k < MAXO.
  constexpr int MAXO = (MAXTM * 128 + CT - 1) / CT;
  const int nout = ns * mt * 128;
  float2 early[MAXO];
#pragma unroll
  for (int k = 0; k < MAXO; ++k) {
    const int i = threadIdx.x + k * CT, t = i / (mt * 128), e = i % 128;
    const int row = (i / 128) % mt * 16 + e / 8;
    if (i < nout && row < rows) early[k] = pre(col_of(t) + e % 8, row);
  }
  float acc[MAXT][4];
#pragma unroll
  for (int t = 0; t < MAXT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  // The B fragment of subtile s at chunk row 0: its offset in a weight slot
  // in the TMA's swizzled [kw][tw] tile (rows of rowb bytes), whose 16-byte
  // column blocks are XORed with address bits 7.. (the row's 16-byte blocks
  // less one: swz). bf16: this lane's row lane % 16 and the subtile's
  // 16-byte block, for ldmatrix; f32: row t, column g of the subtile's 32
  // bytes (row t + 4 is 4 rowb bytes on, which sets one bit of the key that
  // rows 0-3 leave clear: chunk_mma). Slots lie 1024-byte multiples from the
  // region's start, and a k-step (16 or 8 rows: 16 rowb bytes in bf16, 8
  // rowb in f32, at least the swizzle's span) leaves those bits as they
  // are, so every slot and k-step adds its offset to the same ones.
  const int rowb = tw * (int)sizeof(Act), swz = rowb / 16 - 1;
  const uint32_t base = smem_u32(coop_smem);
  uint32_t boff[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const uint32_t tile = base + (t >> lp) * kw * rowb;
    const uint32_t o = F32 ? tile + (lane & 3) * rowb + (t & sub) * 32 + (lane >> 2) * 4
                           : tile + (lane & 15) * rowb + (t & sub) * 16;
    boff[t] = (o ^ (((o >> 7) & swz) << 4)) - base;
  }
  ws_fill(a, ws, 0, l, which);  // this product's chunks the ring has room for
  for (int ch = 0; ch < nch; ++ch) {
    const int k0 = ch * kc, w = min(kc, pd.K - k0), slot = src ? ch % a.p.nslot : 0;
    if (src) mbar_wait(bar_ptr(a.p, slot), ((x.loads >> slot) & 1u) ^ 1u);  // chunk ch
    const Act* xs = slot_ptr(a.p, slot) + (size_t)arow * (kc + XPAD) + acol;
    const Act* xs8 = slot_ptr(a.p, slot) + (size_t)arow8 * (kc + XPAD) + acol;
    for (int c0 = 0; c0 < w; c0 += kw) {  // the weight chunks of this x chunk
      const int ws_slot = ws.used % a.p.nw;
      mbar_wait(wfull_ptr(a.p, ws_slot), (ws.used / a.p.nw) & 1);
      const uint32_t wb = smem_u32(wslot_ptr(a.p, ws_slot));
      if (ms < mt) {
        const int s0 = c0 / KSTEP, s1 = min(c0 + kw, w) / KSTEP;
        const int ks = s0 + ((kgr - s0) % kg + kg) % kg;
#define CHUNK(n) chunk_mma<n>(acc, xs, xs8, wb, boff, ks, s1, kg, c0, rowb)
        switch (ns) {
          case 1: CHUNK(1); break;
          case 2: CHUNK(2); break;
          case 3: CHUNK(3); break;
          case 4: CHUNK(4); break;
          case 5: CHUNK(5); break;
          case 6: CHUNK(6); break;
          case 7: CHUNK(7); break;
          default: CHUNK(MAXT); break;
        }
#undef CHUNK
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(wempty_ptr(a.p, ws_slot));
      ++ws.used;
      // Refill only with this product's own later chunks here (a slot's
      // refill waits for the slowest warp); the next product's wait for the
      // grid barrier, where the CTA idles.
      ws_fill(a, ws, 0, l, which);
    }
    const int next = ch + a.p.nslot;
    if (src && next < nch) {
      __syncthreads();  // every warp is done with the x slot
      stage(a.p, x, slot, src, ld, rows, next * kc, min(kc, pd.K - next * kc));
    }
  }
  // C fragment: c0, c1 at (g, 2q), (g, 2q+1); c2, c3 at (g+8, ...). The
  // partial sums may overlay the x slots' tail: then every warp is done
  // with x first.
  if (a.p.red < a.p.x0 + a.p.nslot * a.p.xs) __syncthreads();
  float* red = reinterpret_cast<float*>(coop_smem + a.p.red);
  if (ms < mt) {
    const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (t < ns) {
        float* o = red + ((size_t)(t * kg + kgr) * mt + ms) * 128;
        o[g * 8 + q2] = acc[t][0];
        o[g * 8 + q2 + 1] = acc[t][1];
        o[(g + 8) * 8 + q2] = acc[t][2];
        o[(g + 8) * 8 + q2 + 1] = acc[t][3];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MAXO; ++k) {
    const int i = threadIdx.x + k * CT, t = i / (mt * 128), m = (i / 128) % mt;
    const int e = i % 128, row = m * 16 + e / 8;
    if (i < nout && row < rows) {
      float s = 0.f;
      for (int j = 0; j < kg; ++j) s += red[((size_t)(t * kg + j) * mt + m) * 128 + e];
      epi(col_of(t) + e % 8, row, s, early[k]);
    }
  }
}

// Four values of row x at column c in the compute dtype: layernorm(v) with
// the row's mean and reciprocal deviation, scale and bias sc / bi.
__device__ __forceinline__ void ln_store(Act* x, int c, const float4& v, float mu, float rstd,
                                         const float* sc, const float* bi) {
  const float4 g = *reinterpret_cast<const float4*>(sc + c);
  const float4 b = *reinterpret_cast<const float4*>(bi + c);
  const float4 y = make_float4((v.x - mu) * rstd * g.x + b.x, (v.y - mu) * rstd * g.y + b.y,
                               (v.z - mu) * rstd * g.z + b.z, (v.w - mu) * rstd * g.w + b.w);
  if constexpr (F32) {
    *reinterpret_cast<float4*>(x + c) = y;
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(x + c) = packed;
  }
}

// x[r, :] = layernorm(h[r, :]) in the compute dtype for r < rows (the JAX models/base
// arithmetic), scale sc and bias bi [d] f32 in shared memory; h read from
// L2, one warp a row. Up to d = 1024 a warp loads a batch of its rows (the
// LNV float4 a lane holds: LNV / ceil(d / 128) rows) before it reduces any;
// a wider row is read three times (mean, variance, output), LNV float4 a
// lane at a time.
constexpr int LNV = 8;  // float4 a lane holds in a layernorm batch

__device__ void layernorm_rows(const float* h, const float* sc, const float* bi, int rows, int d,
                               Act* x, int ldx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = (d + 127) / 128;  // float4 a lane a row
  if (nv > LNV) {
    for (int r = warp; r < rows; r += CW) {
      const float4* hr = reinterpret_cast<const float4*>(h + (size_t)r * d);
      const auto row = [&](int k) { return __ldcg(hr + k); };
      float s = 0.f;
      for (int k0 = lane; k0 < d / 4; k0 += 32 * LNV) {
        float4 v[LNV];
#pragma unroll
        for (int u = 0; u < LNV; ++u)
          v[u] = k0 + 32 * u < d / 4 ? row(k0 + 32 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < LNV; ++u) s += (v[u].x + v[u].y) + (v[u].z + v[u].w);
      }
      const float mu = warp_sum(s) / d;
      float q = 0.f;
      for (int k0 = lane; k0 < d / 4; k0 += 32 * LNV) {
        float4 v[LNV];
#pragma unroll
        for (int u = 0; u < LNV; ++u)
          v[u] = k0 + 32 * u < d / 4 ? row(k0 + 32 * u) : make_float4(mu, mu, mu, mu);
#pragma unroll
        for (int u = 0; u < LNV; ++u) {
          const float a = v[u].x - mu, b = v[u].y - mu, c = v[u].z - mu, e = v[u].w - mu;
          q += (a * a + b * b) + (c * c + e * e);
        }
      }
      const float rstd = rsqrtf(warp_sum(q) / d + LN_EPS);
      for (int k = lane; k < d / 4; k += 32)
        ln_store(x + (size_t)r * ldx, 4 * k, row(k), mu, rstd, sc, bi);
    }
    return;
  }
  const int rb = LNV / nv;  // rows a batch
  for (int r0 = warp; r0 < rows; r0 += CW * rb) {
    float4 v[LNV];
#pragma unroll
    for (int k = 0; k < LNV; ++k) {
      const int r = r0 + k / nv * CW, c = (k % nv) * 128 + lane * 4;
      v[k] = k < rb * nv && r < rows && c < d
                 ? __ldcg(reinterpret_cast<const float4*>(h + (size_t)r * d + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int j = 0; j < rb; ++j) {
      const int r = r0 + j * CW;
      if (r >= rows) break;  // warp-uniform
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < LNV; ++k)
        if (k / nv == j) s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
      const float mu = warp_sum(s) / d;
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < LNV; ++k) {
        if (k / nv == j && (k % nv) * 128 + lane * 4 < d) {
          const float a = v[k].x - mu, b = v[k].y - mu, c = v[k].z - mu, e = v[k].w - mu;
          q += (a * a + b * b) + (c * c + e * e);
        }
      }
      const float rstd = rsqrtf(warp_sum(q) / d + LN_EPS);
#pragma unroll
      for (int k = 0; k < LNV; ++k) {
        const int c = (k % nv) * 128 + lane * 4;
        if (k / nv == j && c < d) ln_store(x + (size_t)r * ldx, c, v[k], mu, rstd, sc, bi);
      }
    }
  }
}

// Floats of one attention task's scratch before its table row (host and
// device): q [gR][Dh], fresh k and v [R][Dh], a score tile [gR][KB + R],
// the softmax's per-warp partial maxima and sums [2][CW][gR], the P·V
// partial sums [CW][GMAX][Dh]; with KB < C (the cache in blocks) the
// running maxima and sums [2][gR] and the P·V sums [gR][Dh] of the blocks.
__host__ __device__ inline size_t attend_floats(const Dims& D, int R, int KB) {
  const size_t gR = (size_t)(D.Hq / D.Hkv) * R;
  return gR * D.Dh + 2 * (size_t)R * D.Dh + gR * (KB + R) + 2 * (size_t)CW * gR +
         (size_t)CW * GMAX * D.Dh + (KB < D.C ? 2 * gR + gR * D.Dh : 0);
}

// Bytes of an attention task's scratch: the floats, the table row, then the
// K/V ring (RING slots of CT x 16 bytes, 16-byte aligned).
__host__ __device__ inline size_t attend_ring_offset(const Dims& D, int R, int KB) {
  return (attend_floats(D, R, KB) * 4 + (size_t)D.MB * 4 + 15) / 16 * 16;
}
__host__ __device__ inline size_t attend_bytes(const Dims& D, int R, int KB) {
  return attend_ring_offset(D, R, KB) + (size_t)RING * CT * 16;
}

// cp.async.wait_group n: all but this thread's n most recent groups landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The scores of G query rows (q, Dh floats apart, at this lane's VD dims)
// on one key row kv (its VD dims: 8, or 4 of an f32 cache), summed over the
// LPR lanes of the row; the G sums' shuffles interleave. Stored at out, CS
// floats apart, where `store`.
template <int G, int VD>
__device__ __forceinline__ void score_rows(const float* q, int Dh, int LPR, const float* kv,
                                           float* out, int CS, bool store, float scale) {
  float p[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const float4 qa = *reinterpret_cast<const float4*>(q + u * Dh);
    p[u] = (qa.x * kv[0] + qa.y * kv[1]) + (qa.z * kv[2] + qa.w * kv[3]);
    if constexpr (VD == 8) {
      const float4 qb = *reinterpret_cast<const float4*>(q + u * Dh + 4);
      p[u] = p[u] + ((qb.x * kv[4] + qb.y * kv[5]) + (qb.z * kv[6] + qb.w * kv[7]));
    }
  }
  for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < G; ++u) p[u] += __shfl_xor_sync(0xffffffffu, p[u], o);
  if (store)
#pragma unroll
    for (int u = 0; u < G; ++u) out[(size_t)u * CS] = p[u] * scale;
}

// Attention task (slot s, KV head hk) of layer l: the head group's g query
// heads x R rows over cache positions [lo, kvlen) (read pre-write; lo > 0
// only with a window) and the slot's R fresh rows at kvlen + lj, with the
// exact softmax; rounds (KV bf16) or quantizes (1-byte codes) and commits
// the fresh rows of head hk (FRESH: writes them to k_fresh / v_fresh
// instead). The scores go through a tile of KB keys (the plan's kb) in nb
// blocks: column j of block b is position lo + b KB + j, and the fresh rows
// follow the last block's cache keys. One block (wherever the plan fits
// the whole extent, KB = C): the scores, their maxima and sums, the weights
// and P·V in one pass over K and one over V. Several blocks (the
// pallas_decode.py kernels stream the cache in blocks too, _pick_cache_block
// :121): a first pass over K folds each block's maxima and sums into
// running ones, a second recomputes each block's scores, forms its weights
// from the final maximum and sum exactly as one block does, and adds its
// P·V; K is read twice, and shared memory does not grow with the extent.
// `base`: the task's shared scratch.
template <class Rows, bool VERIFY, bool FRESH, class KV>
__device__ void attend(const Coop& a, float* base, int l, int s, int hk, bool first) {
  constexpr bool QUANT = KvCodes<KV>::QUANT;
  constexpr int VD = KvCodes<KV>::VD;
  const Dims& D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, Dh = D.Dh, g = D.Hq / D.Hkv, gR = g * R, KB = a.p.kb, CS = KB + R;
  const int qw = D.Hq * Dh, kvw = D.Hkv * Dh, nqkv = qw + 2 * kvw;
  float* q = base;
  float* kf = q + gR * Dh;
  float* vf = kf + R * Dh;
  float* sc = vf + R * Dh;
  float* pm = sc + (size_t)gR * CS;  // [CW][gR] partial maxima, then sums
  float* pz = pm + CW * gR;
  float* pv = pz + CW * gR;
  float* mz = pv + CW * GMAX * Dh;  // several blocks: running maxima and sums [2][gR]
  float* oacc = mz + 2 * gR;        // several blocks: P·V sums [gR][Dh]
  int* tab = reinterpret_cast<int*>(base + attend_floats(D, R, KB));
  const Rows rows_of{};

  // [lo, kvlen): positions read from the cache; the fresh rows go at
  // kvlen + r. With a window lo is the band's start (the verify's row 0's,
  // the widest); a rolling slab reads logical positions below the length.
  int lo = 0, kvlen, slen = 1;
  bool commit;
  if (VERIFY) {
    kvlen = max(0, min(a.lengths[s], D.C));
    slen = max(0, min(a.suffix[s], R));
    commit = a.active[s] != 0;
    if (D.W) lo = max(0, a.lengths[s] - D.W + 1);
  } else if (D.rolling) {
    kvlen = max(0, a.lengths[s]);
    commit = !FRESH && a.active[s] != 0;
    lo = max(0, kvlen - min(D.W, D.C) + 1);
  } else {
    kvlen = min(a.lengths[s], D.C);
    commit = !FRESH && a.active[s] != 0 && kvlen < D.C;
    if (D.W) lo = max(0, a.lengths[s] - D.W + 1);
  }
  lo = min(lo, kvlen);
  const int nkv = kvlen - lo;  // cache keys a row
  const int nb = nkv > KB ? (nkv + KB - 1) / KB : 1;  // blocks of the score tile
  const float* qkv = a.qkv + (size_t)s * R * nqkv;
  for (int i = tid; i < D.MB; i += CT) tab[i] = a.tables[(size_t)s * D.MB + i];
  KV* ck = static_cast<KV*>(a.ck) + l * a.layer_elems;
  KV* cv = static_cast<KV*>(a.cv) + l * a.layer_elems;
  // The scales of this layer (1-byte codes): one a row and KV head.
  float* ks = QUANT ? a.ks + l * (a.layer_elems / Dh) : nullptr;
  float* vs = QUANT ? a.vs + l * (a.layer_elems / Dh) : nullptr;
  // The cache row of head hk streams through the ring in chunks of CP
  // positions: in chunk c, thread t copies VD dims (sub) of position b0 +
  // c CP + cr (cr = t / LPR; LPR = Dh / VD, 1 to 32 lanes a row) into its
  // own 16-byte slot (bf16: 8 dims, f32: 4 dims; 1-byte codes: VD bytes,
  // and the row's scale at byte 8), and reads the same bytes back, so a
  // chunk needs no barrier; RING - 1 chunks are in flight. The current
  // block: its first position b0, its bn cache keys in nc chunks.
  const float scale = rsqrtf((float)Dh);
  // A half row a lane (bf16 build, Dh = 4): see the top of the file.
  const bool half = VD == 8 && Dh < VD;
  const int LPR = half ? 1 : Dh / VD, sub = lane % LPR, cr = tid / LPR, CP = CT / LPR;
  int b0 = lo, bn = min(nkv, KB), nc = (bn + CP - 1) / CP;
  const auto block = [&](int b) {
    b0 = lo + b * KB;
    bn = min(KB, nkv - b * KB);
    nc = (bn + CP - 1) / CP;
  };
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(base) + attend_ring_offset(D, R, KB) + (size_t)tid * 16;
  // Chunk c of `cache` (and its `scales`) into this thread's slot c % RING
  // (and, for the K pass, the V rows into L2 for the P·V pass).
  const auto fetch = [&](const KV* cache, const float* scales, int c, bool to_l2) {
    const int j = b0 + c * CP + cr;
    if (j < b0 + bn) {
      const size_t row = rows_of(D, tab, s, j), off = row * kvw + (size_t)hk * Dh + sub * VD;
      unsigned char* slot = ring + (size_t)(c % RING) * CT * 16;
      if constexpr (QUANT) {
        if (VD == 8 && !half)
          cp_async8(slot, cache + off);
        else
          cp_async4(slot, cache + off);
        if (sub == 0) cp_async4(slot + 8, scales + row * D.Hkv + hk);  // the row's lanes share it
      } else if (half) {
        cp_async8(slot, cache + off);
      } else {
        cp_async16(slot, cache + off);
      }
      if (to_l2 && (sub & 7) == 0) prefetch_l2(cv + off);
    }
  };
  // The VD values of chunk c this thread copied (zeros past bn), once
  // they have landed, with chunk c + RING - 1 asked for. 1-byte codes: the
  // row's scale, which its first lane copied, is read after the warp's
  // barrier (which makes that lane's landed copy visible) and before any
  // lane asks for the chunk that will overwrite it.
  const auto take = [&](const KV* cache, const float* scales, int c, bool to_l2, float* xv) {
    cp_async_wait<RING - 2>();
    const unsigned char* slot = ring + (size_t)(c % RING) * CT * 16;
    uint32_t codes[VD / 4];
    float row_scale;
    if constexpr (QUANT) {
      __syncwarp();
#pragma unroll
      for (int i = 0; i < VD / 4; ++i) codes[i] = reinterpret_cast<const uint32_t*>(slot)[i];
      row_scale = *reinterpret_cast<const float*>(slot - sub * 16 + 8);
    }
    if (c + RING - 1 < nc) fetch(cache, scales, c + RING - 1, to_l2);
    cp_async_commit();
    if constexpr (QUANT) {
      if (c * CP + cr < bn) {
        unpack_codes<VD>(codes, row_scale, xv, (const KV*)nullptr);
      } else {
#pragma unroll
        for (int e = 0; e < VD; ++e) xv[e] = 0.f;
      }
    } else {
      unpack16(c * CP + cr < bn ? *reinterpret_cast<const uint4*>(slot)
                                 : make_uint4(0u, 0u, 0u, 0u),
               xv, (const KV*)nullptr);
    }
    if constexpr (VD == 8) {
      if (half)  // the slot's second half holds no dims of this row
#pragma unroll
        for (int e = 4; e < 8; ++e) xv[e] = 0.f;
    }
  };
  const auto prime = [&](const KV* cache, const float* scales, bool to_l2) {
    for (int c = 0; c < RING - 1; ++c) {
      if (c < nc) fetch(cache, scales, c, to_l2);
      cp_async_commit();
    }
  };
  // The table row lands before the first copies read it (paged);
  // the first K chunks are in flight while q, k and v load.
  if (D.MB) __syncthreads();
  prime(ck, ks, true);
  if (a.rope) {
    // Row r of the slot sits at position lengths[s] + r (the decode's
    // write position, the verify's prefix plus r). One item a thread: a q
    // pair, a fresh k pair (rotated), or a fresh v value.
    const int half = Dh / 2, pos0 = a.lengths[s], nq = gR * half, nk = R * half;
    for (int i = tid; i < nq + nk + R * Dh; i += CT) {
      if (i < nq + nk) {
        const bool isq = i < nq;
        const int p = isq ? i : i - nq, row = p / half, e = p % half, r = isq ? row % R : row;
        const float* src =
            qkv + (size_t)r * nqkv + (isq ? (hk * g + row / R) * Dh : qw + hk * Dh) + e;
        float c, sn;
        rope_cs(pos0 + r, e, half, c, sn);
        const float x1 = __ldcg(src), x2 = __ldcg(src + half);
        const float y1 = x1 * c - x2 * sn, y2 = x1 * sn + x2 * c;
        float* dst = (isq ? q : kf) + row * Dh + e;
        dst[0] = isq || QUANT ? y1 : rnd<KV>(y1);
        dst[half] = isq || QUANT ? y2 : rnd<KV>(y2);
      } else {
        const int v = i - nq - nk;
        const float x = __ldcg(qkv + (size_t)(v / Dh) * nqkv + qw + kvw + hk * Dh + v % Dh);
        vf[v] = QUANT ? x : rnd<KV>(x);
      }
    }
  } else {
    for (int i = tid; i < gR * Dh; i += CT) {
      const int row = i / Dh, e = i % Dh;
      q[i] = __ldcg(qkv + (size_t)(row % R) * nqkv + (hk * g + row / R) * Dh + e);
    }
    for (int i = tid; i < R * Dh; i += CT) {
      const float* fr = qkv + (size_t)(i / Dh) * nqkv + qw + hk * Dh + i % Dh;
      // The cache's storage-dtype round trip; codes: quantized below.
      kf[i] = QUANT ? __ldcg(fr) : rnd<KV>(__ldcg(fr));
      vf[i] = QUANT ? __ldcg(fr + kvw) : rnd<KV>(__ldcg(fr + kvw));
    }
  }
  __syncthreads();
  if (first) stamp(a, NST * l + S_B_IN);

  if constexpr (QUANT) {
    // One warp a fresh row (K or V, row r): its amax over Dh, the scale,
    // the codes; the row is then attended as the codes dequantized to the
    // compute dtype (ops/quantized.py quantize_kv / dequantize_kv).
    for (int t = warp; t < 2 * R; t += CW) {
      const int r = t >> 1, pos = kvlen + r;
      const bool isv = t & 1, keep = commit && r < slen && (D.rolling || pos < D.C);
      float* x = (isv ? vf : kf) + r * Dh;
      float amax = 0.f;
      for (int e = lane; e < Dh; e += 32) amax = fmaxf(amax, fabsf(x[e]));
      const float rs = fmaxf(warp_max(amax), KV_EPS) / KvCodes<KV>::QMAX;
      const size_t row = keep ? rows_of(D, tab, s, pos) : 0;
      KV* dst = (isv ? cv : ck) + row * kvw + (size_t)hk * Dh;
      KV* fresh = static_cast<KV*>(isv ? a.v_fresh : a.k_fresh) + ((size_t)s * D.Hkv + hk) * Dh;
      for (int e = lane; e < Dh; e += 32) {
        const KV c = KvCodes<KV>::code(x[e] / rs);
        x[e] = rnd<Act>(KvCodes<KV>::value(c) * rs);
        if (keep) dst[e] = c;
        if (FRESH) fresh[e] = c;
      }
      if (lane == 0) {
        if (keep) (isv ? vs : ks)[row * D.Hkv + hk] = rs;
        if (FRESH) (isv ? a.vs_fresh : a.ks_fresh)[(size_t)s * D.Hkv + hk] = rs;
      }
    }
    __syncthreads();
  } else {
    for (int i = tid; i < R * Dh; i += CT) {
      const int r = i / Dh, pos = kvlen + r;
      if (commit && r < slen && (D.rolling || pos < D.C)) {
        const size_t off = rows_of(D, tab, s, pos) * kvw + (size_t)hk * Dh + i % Dh;
        put(ck + off, kf[i]);
        put(cv + off, vf[i]);
      }
    }
    if (FRESH)
      for (int i = tid; i < Dh; i += CT) {
        put(static_cast<KV*>(a.k_fresh) + ((size_t)s * D.Hkv + hk) * Dh + i, kf[i]);
        put(static_cast<KV*>(a.v_fresh) + ((size_t)s * D.Hkv + hk) * Dh + i, vf[i]);
      }
  }

  // The current block's scores into the tile: its cache keys (K streamed;
  // to_l2: V's rows into L2 on the way), then, in the last block, the
  // fresh keys: causal within the suffix, in the band, and real rows only
  // (verify). With a window the verify's row r masks the columns before its
  // band, which starts r positions after row 0's (where lo began).
  const auto scores = [&](int b, bool to_l2) {
    for (int c = 0; c < nc; ++c) {
      float kv[VD];
      take(ck, ks, c, to_l2, kv);
      const int j = c * CP + cr;
      const bool store = sub == 0 && j < bn;
      int i = 0;
      for (; i + 4 <= gR; i += 4)
        score_rows<4, VD>(q + i * Dh + sub * VD, Dh, LPR, kv, sc + (size_t)i * CS + j, CS,
                          store, scale);
      for (; i < gR; ++i)
        score_rows<1, VD>(q + i * Dh + sub * VD, Dh, LPR, kv, sc + (size_t)i * CS + j, CS,
                          store, scale);
    }
    if (b == nb - 1)
      for (int pair = warp; pair < gR * R; pair += CW) {
        const int i = pair / R, lj = pair % R, r = i % R;
        float p = 0.f;
        for (int e = lane; e < Dh; e += 32) p += q[i * Dh + e] * kf[lj * Dh + e];
        p = warp_sum(p);
        if (lane == 0)
          sc[(size_t)i * CS + bn + lj] =
              !VERIFY || (lj <= r && lj < slen && (!D.W || lj > r - D.W)) ? p * scale : NEG_INF;
      }
    __syncthreads();
    if (VERIFY && D.W) {
      for (int t = tid; t < gR * R; t += CT) {
        const int i = t / R, j = t % R;
        if (j < bn && b0 + j <= a.lengths[s] + i % R - D.W) sc[(size_t)i * CS + j] = NEG_INF;
      }
      __syncthreads();
    }
  };
  // The softmax's maximum and sum of each query row over block b's columns,
  // masked keys weighing 0. Warp w takes columns [w n / CW, (w + 1) n / CW)
  // of every row; the warps' maxima, then their sums of exp(x - max), meet
  // in pm / pz in warp order, and thread i adds up row i's. One block: the
  // row's maximum and sum go to pm[i] / pz[i]. Several: they fold into the
  // running ones in mz (the sum rescaled to the new maximum).
  const auto stats = [&](int b) {
    const int n = bn + (b == nb - 1 ? R : 0);
    const int c0 = warp * n / CW, c1 = (warp + 1) * n / CW;
    for (int i = 0; i < gR; ++i) {
      const float* row = sc + (size_t)i * CS;
      float m = NEG_INF;
      for (int j = c0 + lane; j < c1; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      if (lane == 0) pm[warp * gR + i] = m;
    }
    __syncthreads();
    for (int i = 0; i < gR; ++i) {
      const float* row = sc + (size_t)i * CS;
      float m = NEG_INF;
      for (int w = 0; w < CW; ++w) m = fmaxf(m, pm[w * gR + i]);
      float z = 0.f;
      for (int j = c0 + lane; j < c1; j += 32)
        z += row[j] > 0.5f * NEG_INF ? expf(row[j] - m) : 0.f;
      z = warp_sum(z);
      if (lane == 0) pz[warp * gR + i] = z;
    }
    __syncthreads();
    for (int i = tid; i < gR; i += CT) {
      float m = NEG_INF, z = 0.f;
      for (int w = 0; w < CW; ++w) {
        m = fmaxf(m, pm[w * gR + i]);
        z += pz[w * gR + i];  // each taken against the row's maximum
      }
      if (nb == 1) {
        pm[i] = m;
        pz[i] = z;
      } else {
        const float m0 = b ? mz[i] : NEG_INF, z0 = b ? mz[gR + i] : 0.f, mn = fmaxf(m0, m);
        mz[i] = mn;
        mz[gR + i] = z0 * expf(m0 - mn) + z * expf(m - mn);
      }
    }
    __syncthreads();
  };
  // Block b's weights in the tile from the row's maximum and sum. Decode:
  // rounded to the compute dtype. Verify: f32, and 0 for a row with no
  // valid key.
  const auto weights = [&](int b) {
    const int n = bn + (b == nb - 1 ? R : 0);
    for (int i = 0; i < gR; ++i) {
      float* row = sc + (size_t)i * CS;
      const float m = nb == 1 ? pm[i] : mz[i], z = nb == 1 ? pz[i] : mz[gR + i];
      const bool dead = !(m > 0.5f * NEG_INF);
      for (int j = tid; j < n; j += CT) {
        const float e = row[j] > 0.5f * NEG_INF ? expf(row[j] - m) : 0.f;
        row[j] = VERIFY ? (dead ? 0.f : e / z) : rnd<Act>(e / z);
      }
    }
    __syncthreads();
  };
  // P·V of block b, GMAX query rows a pass, V streamed as K was; the
  // position lanes of a warp meet by shuffles, the warps in pv (warp order),
  // then the fresh rows (last block) and, with several blocks, the earlier
  // blocks' sums in oacc.
  const int pr = lane / LPR;
  const auto weigh_values = [&](int b) {
    const bool last = b == nb - 1;
    for (int i0 = 0; i0 < gR; i0 += GMAX) {
      const int ng = min(GMAX, gR - i0);
      float acc[GMAX][VD];
#pragma unroll
      for (int ii = 0; ii < GMAX; ++ii)
#pragma unroll
        for (int e = 0; e < VD; ++e) acc[ii][e] = 0.f;
      prime(cv, vs, false);
      for (int c = 0; c < nc; ++c) {
        float vv[VD];
        take(cv, vs, c, false, vv);
        const int j = c * CP + cr;
        if (j < bn) {
#pragma unroll
          for (int ii = 0; ii < GMAX; ++ii) {
            if (ii < ng) {
              const float p = sc[(size_t)(i0 + ii) * CS + j];
#pragma unroll
              for (int e = 0; e < VD; ++e) acc[ii][e] += p * vv[e];
            }
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < GMAX; ++ii) {
        if (ii < ng) {
#pragma unroll
          for (int e = 0; e < VD; ++e) {
            float v = acc[ii][e];
            for (int o = LPR; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            if (pr == 0 && (e < 4 || !half)) pv[((size_t)warp * GMAX + ii) * Dh + sub * VD + e] = v;
          }
        }
      }
      __syncthreads();
      for (int o = tid; o < ng * Dh; o += CT) {
        const int ii = o / Dh, e = o % Dh, i = i0 + ii;
        float t = 0.f;
        if (last)
          for (int lj = 0; lj < R; ++lj) t += sc[(size_t)i * CS + bn + lj] * vf[lj * Dh + e];
        for (int w = 0; w < CW; ++w) t += pv[((size_t)w * GMAX + ii) * Dh + e];
        if (nb > 1) {
          float* sum = oacc + (size_t)i * Dh + e;
          if (b) t = *sum + t;
          if (!last) {
            *sum = t;
            continue;
          }
        }
        put(a.att + (size_t)(s * R + i % R) * qw + (hk * g + i / R) * Dh + e, t);
      }
      __syncthreads();
    }
  };

  // Pass 1 over the blocks (one block: the only pass over K; block 0's
  // first chunks are in flight since before the q/k/v loads).
  for (int b = 0; b < nb; ++b) {
    if (b) {
      block(b);
      prime(ck, ks, false);
    }
    scores(b, nb == 1);
    if (first && b == 0) stamp(a, NST * l + S_B_SC);
    stats(b);
  }
  if (nb == 1) {
    weights(0);
    if (first) stamp(a, NST * l + S_B_SM);
    weigh_values(0);
    return;
  }
  if (first) stamp(a, NST * l + S_B_SM);
  for (int b = 0; b < nb; ++b) {  // pass 2
    block(b);
    prime(ck, ks, true);
    scores(b, true);
    weights(b);
    weigh_values(b);
  }
}

// The layernorms' scale and bias in shared memory ([2][d] f32 at p.ln),
// one layernorm's at a time, copied by the TMA a phase ahead by CTAs that
// run that layernorm; `loads` counts the copies (load j completes phase j
// of the mbarrier). Every thread keeps the same count.
struct LnStage {
  uint32_t loads;
};

__device__ __forceinline__ float* ln_ptr(const Plan& p) {
  return reinterpret_cast<float*>(coop_smem + p.ln);
}

__device__ __forceinline__ uint64_t* lnbar_ptr(const Plan& p) {
  return bar_ptr(p, p.nslot + 2 * p.nw);
}

// Layernorm `which` (1 or 2) of layer l into the region, if this CTA runs
// it (owns q/k/v tiles, or up tiles), by `issuer`, after a barrier that
// ends every read of the region.
__device__ void ln_fetch(const Coop& a, LnStage& st, int l, int which, bool issuer) {
  const int T = which == 1 ? (a.D.Hq + 2 * a.D.Hkv) * a.D.Dh / a.p.tw[0] : a.D.F / a.p.tw[2];
  if (l >= a.n_layers || !my_tiles(T, a.p.grid)) return;
  if (issuer) {
    const int d = a.D.d;
    uint64_t* bar = lnbar_ptr(a.p);
    float* dst = ln_ptr(a.p);
    mbar_expect_tx(bar, (uint32_t)(8 * d));
    bulk_load(dst, (which == 1 ? a.w0.ln1_s : a.w0.ln2_s) + (size_t)l * d, 4 * d, bar);
    bulk_load(dst + d, (which == 1 ? a.w0.ln1_b : a.w0.ln2_b) + (size_t)l * d, 4 * d, bar);
  }
  ++st.loads;
}

// Waits for the last layernorm parameters fetched.
__device__ __forceinline__ const float* ln_wait(const Plan& p, const LnStage& st) {
  mbar_wait(lnbar_ptr(p), (st.loads - 1) & 1);
  return ln_ptr(p);
}

template <class Rows, bool VERIFY, bool FRESH, class KV>
__global__ void __launch_bounds__(CT, 1) coop_step_kernel(const __grid_constant__ Coop a) {
  const Dims& D = a.D;
  const Plan& p = a.p;
  const int rows = D.S * a.R, b = blockIdx.x;
  const int qw = D.Hq * D.Dh, nqkv = qw + 2 * D.Hkv * D.Dh;
  // Owners of a product's tiles (of p.tw columns): CTAs below its tile count.
  const int T_qkv = nqkv / p.tw[0], T_out = D.d / p.tw[1], T_up = D.F / p.tw[2];
  const int T_down = D.d / p.tw[3];
  Ring x{0u};
  WStream ws = ws_start(a);
  unsigned epoch = epoch_in(a.flags);
  const int ns = NST * a.n_layers;  // phase stamps; 4 more for the rate
  stamp(a, ns, true);
  stamp(a, ns + 2);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.nslot; ++i) mbar_init(bar_ptr(p, i), 1);
    for (int i = 0; i < p.nw; ++i) {
      mbar_init(wfull_ptr(p, i), 1);
      mbar_init(wempty_ptr(p, i), CW);
    }
    mbar_init(lnbar_ptr(p), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // The first layer's q/k/v chunks (and the output projection's) go out
  // before LN1 reads h. From here on a product tops up the ring with its
  // own chunks as it frees slots, and the grid barriers issue the next
  // product's, one product ahead (warp 1 issues while warp 0 polls, so no
  // phase's work waits on the issue): the up projection's after the
  // attention, the down projection's after the output projection, the next
  // layer's q/k/v and output projection's after the down projection.
  if (threadIdx.x < 6)
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&a.maps[threadIdx.x]))
                 : "memory");
  LnStage lns{0u};
  ln_fetch(a, lns, 0, 1, threadIdx.x == 0);
  ws_fill(a, ws, 0, 0, OUT);
  const bool refiller = threadIdx.x == 32;
  const auto refill = [&](int ll, int lp) { ws_fill(a, ws, 1, ll, lp); };
  for (int l = 0; l < a.n_layers; ++l) {
    const float* hsrc = l ? a.h_out : a.h_in;
    const size_t ld = (size_t)l * D.d, lf = (size_t)l * D.F;
    const int st = NST * l;

    // (a) LN1, q/k/v.
    stamp(a, st + S_A0);
    if (b < T_qkv)
      layernorm_rows(hsrc, ln_wait(p, lns), ln_ptr(p) + D.d, rows, D.d, slot_ptr(p, 0),
                     p.kc + XPAD);
    stamp(a, st + S_A_LN);
    __syncthreads();
    stamp(a, st + S_A_W);
    if (b < T_qkv) {
      float* qkv = a.qkv;
      product(
          a, ws, l, QKV, rows, x, nullptr, 0, [](int, int) { return make_float2(0.f, 0.f); },
          [&](int c, int r, float v, float2) { __stcg(qkv + (size_t)r * nqkv + c, v); });
    }
    stamp(a, st + S_A1);
    grid_sync(a.flags, ++epoch, p.grid, [&] { ln_fetch(a, lns, l, 2, refiller); });

    // (b) Attention, one task a (slot, KV head); commits the fresh rows.
    stamp(a, st + S_B0);
    for (int t = b; t < D.S * D.Hkv; t += p.grid)
      attend<Rows, VERIFY, FRESH, KV>(a, reinterpret_cast<float*>(coop_smem + p.x0), l,
                                  t / D.Hkv, t % D.Hkv, t == b);
    fence_async();  // the attention rows are read by TMA next
    stamp(a, st + S_B1);
    grid_sync(a.flags, ++epoch, p.grid, [&] { refill(l, UP); });

    // (c) Output projection; the residual added by the column's owner.
    stamp(a, st + S_C0);
    if (b < T_out) stage_first(p, x, a.att, qw, rows, qw);
    stamp(a, st + S_C_W);
    if (b < T_out) {
      float* h = a.h_out;
      product(
          a, ws, l, OUT, rows, x, a.att, qw,
          [&](int c, int r) { return make_float2(__ldcg(hsrc + (size_t)r * D.d + c), 0.f); },
          [&](int c, int r, float v, float2 e) { h[(size_t)r * D.d + c] = e.x + v; });
    }
    stamp(a, st + S_C1);
    grid_sync(a.flags, ++epoch, p.grid, [&] { refill(l, DOWN); });

    // (d) LN2, up projection, bias, GELU (in the compute dtype).
    stamp(a, st + S_D0);
    if (b < T_up)
      layernorm_rows(a.h_out, ln_wait(p, lns), ln_ptr(p) + D.d, rows, D.d, slot_ptr(p, 0),
                     p.kc + XPAD);
    stamp(a, st + S_D_LN);
    __syncthreads();
    stamp(a, st + S_D_W);
    if (b < T_up) {
      Act* up = a.gelu;
      const float* b_up = a.w0.b_up + lf;
      product(
          a, ws, l, UP, rows, x, nullptr, 0,
          [&](int c, int) { return make_float2(__ldg(b_up + c), 0.f); },
          [&](int c, int r, float v, float2 e) {
            put(up + (size_t)r * D.F + c, gelu_tanh(v + e.x));
          });
    }
    fence_async();
    stamp(a, st + S_D1);
    grid_sync(a.flags, ++epoch, p.grid, [&] { ln_fetch(a, lns, l + 1, 1, refiller); });

    // (e) Down projection, bias, residual.
    stamp(a, st + S_E0);
    if (b < T_down) stage_first(p, x, a.gelu, D.F, rows, D.F);
    stamp(a, st + S_E_W);
    if (b < T_down) {
      float* h = a.h_out;
      const float* b_down = a.w0.b_down + ld;
      product(
          a, ws, l, DOWN, rows, x, a.gelu, D.F,
          [&](int c, int r) {
            return make_float2(__ldcg(h + (size_t)r * D.d + c), __ldg(b_down + c));
          },
          [&](int c, int r, float v, float2 e) { h[(size_t)r * D.d + c] = (e.x + v) + e.y; });
    }
    stamp(a, st + S_E1);
    if (l + 1 < a.n_layers) grid_sync(a.flags, ++epoch, p.grid, [&] { refill(l + 1, OUT); });
  }
  epoch_out(a.flags, epoch);
  stamp(a, ns + 1, true);
  stamp(a, ns + 3);
}

#ifdef DECODE_PROBE
// A probe of the grid barrier alone: `steps` syncs of grid_sync over the
// launch's grid (each CTA CT threads and `smem` bytes of shared
// memory, as the cooperative kernels), for chip_smoke.py's timing.
__global__ void __launch_bounds__(CT, 1) barrier_probe_kernel(unsigned* flags, int steps) {
  unsigned epoch = epoch_in(flags);
  for (int i = 0; i < steps; ++i) grid_sync(flags, ++epoch, gridDim.x);
  epoch_out(flags, epoch);
}
#endif

// -- host side ----------------------------------------------------------------

LayerW pack(const void* wq, const void* wk, const void* wv, const void* wo,
            const void* ln1_s, const void* ln1_b, const void* ln2_s,
            const void* ln2_b, const void* w_up, const void* b_up,
            const void* w_down, const void* b_down) {
  LayerW w;
  w.wq = wq; w.wk = wk; w.wv = wv;
  w.wo = wo; w.w_up = w_up; w.w_down = w_down;
  w.ln1_s = (const float*)ln1_s; w.ln1_b = (const float*)ln1_b;
  w.ln2_s = (const float*)ln2_s; w.ln2_b = (const float*)ln2_b;
  w.b_up = (const float*)b_up; w.b_down = (const float*)b_down;
  return w;
}

#ifdef DECODE_PROBE
// Phase stamps for the next launches (coop_set_stamps), or null.
unsigned long long* g_stamps = nullptr;
#endif

// The cooperative kernels by number: kernel k of KV type t (0 the compute
// dtype, bf16 or f32; 1 int8, 2 e4m3) is N_COOP t + k, k being 0: slab
// decode, 1: paged decode, 2: verify, 3: slab per-layer step, 4: paged
// per-layer step; with the shared memory last set on each and the
// occupancy it gave.
struct CoopKernel {
  const void* fn;
  int smem, per_sm, dev;
};
constexpr int N_COOP = 5;
constexpr int N_KV = 3;
template <class KV>
CoopKernel coop_kernel(int k) {
  return {k == 0   ? (const void*)coop_step_kernel<SlabRows, false, false, KV>
          : k == 1 ? (const void*)coop_step_kernel<PagedRows, false, false, KV>
          : k == 2 ? (const void*)coop_step_kernel<PagedRows, true, false, KV>
          : k == 3 ? (const void*)coop_step_kernel<SlabRows, false, true, KV>
                   : (const void*)coop_step_kernel<PagedRows, false, true, KV>,
          -1, 0, -1};
}
CoopKernel g_coop[N_KV * N_COOP] = {
    coop_kernel<Act>(0),    coop_kernel<Act>(1),    coop_kernel<Act>(2),
    coop_kernel<Act>(3),    coop_kernel<Act>(4),    coop_kernel<int8_t>(0),
    coop_kernel<int8_t>(1), coop_kernel<int8_t>(2), coop_kernel<int8_t>(3),
    coop_kernel<int8_t>(4), coop_kernel<e4m3>(0),   coop_kernel<e4m3>(1),
    coop_kernel<e4m3>(2),   coop_kernel<e4m3>(3),   coop_kernel<e4m3>(4),
};

// CTAs of kernel k a SM holds at `smem` bytes of shared memory (sets the
// kernel's shared-memory limit first).
cudaError_t coop_per_sm(int k, int smem, int& per_sm) {
  CoopKernel& ck = g_coop[k];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem != ck.smem || dev != ck.dev) {
    if ((err = cudaFuncSetAttribute(ck.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ck.per_sm, ck.fn, CT, smem)) !=
            cudaSuccess)
      return err;
    ck.smem = smem;
    ck.dev = dev;
  }
  per_sm = ck.per_sm;
  return cudaSuccess;
}

// The plan's offsets in order, aligned and inside `smem`: the weight ring,
// the layernorm's parameters, the x slots, the partial sums, the mbarriers. The sizes are
// ops/fused_decode.py coop_plan's; the kernel's own bounds are checked
// here: its tiles a CTA (register arrays of MAXT and MAXTM / m-tiles), the
// weight chunks (whole k-steps, within an x chunk, inside a slot, whole TMA
// boxes of at most 256 rows of at most 128 bytes), the m-tile lanes, the
// score tile (1 to C keys)
// and the attention task's scratch, which it lays out itself over the
// slots.
bool plan_in_bounds(const Dims& D, int R, const Plan& p) {
  const int rows = D.S * R, mt = (rows + 15) / 16;
  if ((p.cs != 1 && p.cs != 2 && p.cs != 4) || p.cs < (mt < 4 ? mt : 4) || p.kb < 1 || p.kb > D.C)
    return false;
  const int kg = CW / p.cs;
  const long nqkv = (long)D.Hq * D.Dh + 2L * D.Hkv * D.Dh;
  const long n[4] = {nqkv, D.d, D.F, D.d};
  long wneed = 0, red = 0;
  for (int i = 0; i < 4; ++i) {
    const long tw = p.tw[i], kw = p.kw[i];
    if ((tw != 8 && tw != 16 && tw != 32 && tw != 64) || tw * (long)sizeof(Act) > 128 ||
        n[i] % tw || (i == 0 && (D.Hkv * D.Dh) % tw))
      return false;
    const long nt = (n[i] / tw + p.grid - 1) / p.grid, ns = nt * tw / TILE;
    if (ns > MAXT || ns * mt > MAXTM || kw < 16 || kw % 16 || p.kc % kw ||
        (kw > 256 && kw % 256))
      return false;
    const long bytes = nt * kw * tw * (long)sizeof(Act);
    wneed = wneed > bytes ? wneed : bytes;
    red = red > ns * kg * mt * 512 ? red : ns * kg * mt * 512;
  }
  return p.wslot % 1024 == 0 && p.nw >= 1 && p.nw <= NWMAX && wneed <= p.wslot &&
         (long)p.nw * p.wslot <= p.ln && p.ln % 16 == 0 && p.ln + 8L * D.d <= p.x0 &&
         p.x0 % 128 == 0 && p.xs % 16 == 0 &&
         p.red % 16 == 0 && p.bar % 8 == 0 && p.nslot >= 1 && p.nslot <= MAXS &&
         p.xs >= (long)rows * (p.kc + XPAD) * (long)sizeof(Act) &&
         p.x0 + (long)p.nslot * p.xs <= p.bar &&
         p.x0 + (long)attend_bytes(D, R, p.kb) <= p.bar && p.red >= p.x0 && p.red + red <= p.bar &&
         p.bar + 8L * (p.nslot + 2 * p.nw + 1) <= p.smem;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA maps of the six projections (Coop::maps): 2-D [n_layers * K, N]
// in the compute dtype, boxes of one tile's tw columns x the product's chunk
// rows (at most 256), swizzled across the tile's row of 32 to 128 bytes
// (product()'s boff undoes it).
cudaError_t weight_maps(Coop& a) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    if (err != cudaSuccess) return err;
    if (!fn) return cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const Dims& D = a.D;
  const cuuint64_t n = a.n_layers, d = D.d, qw = (cuuint64_t)D.Hq * D.Dh;
  const cuuint64_t kvw = (cuuint64_t)D.Hkv * D.Dh, F = D.F;
  const void* ptr[6] = {a.w0.wq, a.w0.wk, a.w0.wv, a.w0.wo, a.w0.w_up, a.w0.w_down};
  const cuuint64_t cols[6] = {qw, kvw, kvw, d, F, d}, rows[6] = {n * d, n * d, n * d,
                                                                 n * qw, n * d, n * F};
  const int prod[6] = {0, 0, 0, 1, 2, 3};
  const cuuint32_t ones[2] = {1, 1};
  for (int i = 0; i < 6; ++i) {
    const int kw = a.p.kw[prod[i]], tw = a.p.tw[prod[i]];
    const cuuint64_t dims[2] = {cols[i], rows[i]}, strides[1] = {cols[i] * sizeof(Act)};
    const cuuint32_t box[2] = {(cuuint32_t)tw, (cuuint32_t)(kw < 256 ? kw : 256)};
    const int rowb = tw * (int)sizeof(Act);
    const CUtensorMapSwizzle swizzle = rowb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : rowb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : rowb == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                    : CU_TENSOR_MAP_SWIZZLE_NONE;
    const CUtensorMapDataType dtype =
        F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (encode(&a.maps[i], dtype, 2, const_cast<void*>(ptr[i]), dims,
               strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The last line of defence behind ops/fused_decode.py coop_plan, which
// checks the envelope and raises with a reason: dims, the plan's layout, and
// a grid that fits on the card at once (else the grid sync would never
// complete). Nothing falls back: a refusal is an error code.
int launch_coop(Coop& a, const int* plan, int k, int kv, void* stream) {
  const Dims& D = a.D;
  Plan& p = a.p;
  p = Plan{plan[0], plan[1], plan[2], plan[3], {plan[4], plan[5], plan[6], plan[7]},
           {plan[8], plan[9], plan[10], plan[11]}, plan[12], plan[13], plan[14], plan[15],
           plan[16], plan[17], plan[18], plan[19], plan[20]};
  const int rows = D.S * a.R;
  const bool fresh = k >= 3;  // the per-layer steps write their fresh rows out
  if (D.Hkv < 1 || D.Hq % D.Hkv ||
      (D.Dh != 4 && D.Dh != 8 && D.Dh != 16 && D.Dh != 32 && D.Dh != 64 && D.Dh != 128) ||
      D.d != D.Hq * D.Dh ||
      D.d % 16 || D.F % 16 || rows < 1 || rows > 64 || a.n_layers < 1 || !a.flags ||
      D.W < 0 || (D.rolling && (D.MB || D.W < 1)) ||
      p.kc != D.d || p.grid < 1 || p.grid > MAX_GRID ||
      (D.MB && (D.bs < 1 || D.C != D.MB * D.bs)) || !plan_in_bounds(D, a.R, p) || kv < 0 ||
      kv >= N_KV || (kv && (!a.ks || !a.vs)) || (fresh && (!a.k_fresh || !a.v_fresh)) ||
      (fresh && kv && (!a.ks_fresh || !a.vs_fresh)))
    return (int)cudaErrorInvalidValue;
  k += kv * N_COOP;
  int dev = 0, nsm = 0, coop = 0, per_sm = 0;
  cudaError_t err;
  if ((err = weight_maps(a)) != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
      (err = coop_per_sm(k, p.smem, per_sm)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm * nsm < p.grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(g_coop[k].fn, dim3(p.grid), dim3(CT), args, p.smem,
                                    (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The cache of a launch: its K/V (bf16, or 1-byte codes with their f32
// scales [.., Hkv] a row), RoPE, and (per-layer step) where its fresh rows
// and their scales go.
struct CacheArgs {
  void *k, *v;
  const void *ks, *vs;
  int rope;
  void *k_fresh = nullptr, *v_fresh = nullptr, *ks_fresh = nullptr, *vs_fresh = nullptr;
};

Coop coop_args(const LayerW& w, const Dims& D, int n_layers, int R, size_t layer_elems,
               const void* h_in, void* h_out, const CacheArgs& c, const void* lengths,
               const void* suffix, const void* active, const void* tables, void* qkv,
               void* att, void* gelu, void* flags) {
  Coop a;
  a.w0 = w;
  a.D = D;
  a.n_layers = n_layers;
  a.R = R;
  a.rope = c.rope;
  a.layer_elems = layer_elems;
  a.h_in = (const float*)h_in;
  a.h_out = (float*)h_out;
  a.ck = c.k;
  a.cv = c.v;
  a.ks = (float*)c.ks;
  a.vs = (float*)c.vs;
  a.lengths = (const int*)lengths;
  a.suffix = (const int*)suffix;
  a.active = (const int*)active;
  a.tables = (const int*)tables;
  a.qkv = (float*)qkv;
  a.att = (Act*)att;
  a.gelu = (Act*)gelu;
  a.k_fresh = c.k_fresh;
  a.v_fresh = c.v_fresh;
  a.ks_fresh = (float*)c.ks_fresh;
  a.vs_fresh = (float*)c.vs_fresh;
  a.flags = (unsigned*)flags;
#ifdef DECODE_PROBE
  a.stamps = g_stamps;
#endif
  return a;
}

}  // namespace

// Every launcher takes the projections in the build's compute dtype (bf16;
// f32 with -DDECODE_F32), the KV cache's type `kv` (0 the compute dtype, 1
// int8, 2 e4m3), `rope` (rotate q and the fresh k rows at their positions)
// and `window` (0: none; W >= 1: the band of the last W positions; a
// windowed slab is a rolling buffer, position p at slot p mod C, committed
// there). With 1-byte codes, k_scale / v_scale hold one f32 scale a cache
// row and KV head ([.., Hkv], the cache's shape without Dh), updated with
// the codes; for a cache of the compute dtype they are null.

// Per-layer step, slab (B5): one layer's weights, its cache ck/cv
// [S, C, Hkv, Dh] (read only, pre-write), lengths [S] int32; h_in /
// h_out [S, d] f32 -> k_fresh / v_fresh [S, Hkv, Dh] in the cache's type
// (and, for codes, ks_fresh / vs_fresh [S, Hkv] f32), the fresh rows the
// caller commits. Scratch, flags and plan as decode_token_slab (a plan of
// one layer).
extern "C" int decode_block_slab(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, const void* ck, const void* cv,
    const void* k_scale, const void* v_scale, const void* lengths, void* k_fresh,
    void* v_fresh, void* ks_fresh, void* vs_fresh, void* qkv, void* att, void* gelu,
    void* flags, const int* plan, int kv, int rope, int window, int S, int d, int Hq, int Hkv,
    int Dh, int F, int C, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, C, 0, 0, window, window > 0};
  const CacheArgs c{(void*)ck, (void*)cv, k_scale, v_scale, rope,
                    k_fresh, v_fresh, ks_fresh, vs_fresh};
  Coop a = coop_args(pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down),
                     D, 1, 1, 0, h_in, h_out, c, lengths, nullptr, nullptr, nullptr, qkv, att,
                     gelu, flags);
  return launch_coop(a, plan, 3, kv, stream);
}

// Per-layer step, paged (B5): as decode_block_slab with one layer's pool
// pk/pv [NB, bs, Hkv, Dh] (read only) and tables [S, MB] int32.
extern "C" int decode_block_paged(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, const void* pk, const void* pv,
    const void* k_scale, const void* v_scale, const void* lengths, const void* tables,
    void* k_fresh, void* v_fresh, void* ks_fresh, void* vs_fresh, void* qkv, void* att,
    void* gelu, void* flags, const int* plan, int kv, int rope, int window, int S, int d, int Hq,
    int Hkv, int Dh, int F, int NB, int bs, int MB, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, MB * bs, bs, MB, window, 0};
  const CacheArgs c{(void*)pk, (void*)pv, k_scale, v_scale, rope,
                    k_fresh, v_fresh, ks_fresh, vs_fresh};
  Coop a = coop_args(pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down),
                     D, 1, 1, 0, h_in, h_out, c, lengths, nullptr, nullptr, tables, qkv, att,
                     gelu, flags);
  if (MB < 1 || NB < 1) return (int)cudaErrorInvalidValue;
  return launch_coop(a, plan, 4, kv, stream);
}

// Whole-model step, slab. Layer-stacked weights (leading [n_layers] axis) and
// caches [n_layers, S_cache, C, Hkv, Dh] (scales [n_layers, S_cache, C,
// Hkv]), ck / cv / k_scale / v_scale pointing at the launch's first slot
// (a group of S of the cache's S_cache slots), committed in place at [l, s,
// lengths[s]] where active[s] != 0. h_in/h_out [S, d] f32; scratch qkv
// [S, Hq Dh + 2 Hkv Dh] f32, att [S, d] and gelu [S, F] in the compute
// dtype; the grid
// barrier's flags (MAX_GRID + 1 uint32, zeroed once, then left to the
// kernels; see grid_sync()); `plan` the twenty-one ints of
// ops/fused_decode.py coop_plan. One launch at a time may use the flags.
extern "C" int decode_token_slab(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, void* ck, void* cv, void* k_scale,
    void* v_scale, const void* lengths, const void* active, void* qkv, void* att, void* gelu,
    void* flags, const int* plan, int kv, int rope, int window, int n_layers, int S, int d, int Hq,
    int Hkv, int Dh, int F, int C, int S_cache, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, C, 0, 0, window, window > 0};
  if (S_cache < S) return (int)cudaErrorInvalidValue;
  const CacheArgs c{ck, cv, k_scale, v_scale, rope};
  Coop a = coop_args(pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down),
                     D, n_layers, 1, (size_t)S_cache * C * Hkv * Dh, h_in, h_out, c, lengths,
                     nullptr, active, nullptr, qkv, att, gelu, flags);
  return launch_coop(a, plan, 0, kv, stream);
}

// Whole-model step, paged. Pools [n_layers, NB, bs, Hkv, Dh] (scales
// [n_layers, NB, bs, Hkv]), tables [S, MB] int32; the fresh row of layer l
// is committed in place at pool[l, tables[s, len / bs], len % bs] where
// active[s] != 0.
extern "C" int decode_token_paged(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, void* pk, void* pv, void* k_scale,
    void* v_scale, const void* lengths, const void* active, const void* tables, void* qkv,
    void* att, void* gelu, void* flags, const int* plan, int kv, int rope, int window, int n_layers,
    int S, int d, int Hq, int Hkv, int Dh, int F, int NB, int bs, int MB, void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, MB * bs, bs, MB, window, 0};
  const CacheArgs c{pk, pv, k_scale, v_scale, rope};
  Coop a = coop_args(pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down),
                     D, n_layers, 1, (size_t)NB * bs * Hkv * Dh, h_in, h_out, c, lengths,
                     nullptr, active, tables, qkv, att, gelu, flags);
  return launch_coop(a, plan, 1, kv, stream);
}

// Verify. h_in/h_out [S, L, d] f32, layer-stacked weights, pools
// [n_layers, NB, bs, Hkv, Dh] (and scales; committed in place), tables
// [S, MB], prefix_lens / suffix_lens / active [S] int32; scratch as
// decode_token_slab with S * L rows.
extern "C" int verify_tokens_paged(
    const void* h_in, void* h_out, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, const void* w_up, const void* b_up,
    const void* w_down, const void* b_down, void* pk, void* pv, void* k_scale, void* v_scale,
    const void* tables, const void* prefix_lens, const void* suffix_lens, const void* active,
    void* qkv, void* att, void* gelu, void* flags, const int* plan, int kv, int rope, int window,
    int n_layers, int S, int L, int d, int Hq, int Hkv, int Dh, int F, int NB, int bs, int MB,
    void* stream) {
  Dims D{S, d, Hq, Hkv, Dh, F, MB * bs, bs, MB, window, 0};
  if (L < 1 || MB < 1) return (int)cudaErrorInvalidValue;
  const CacheArgs c{pk, pv, k_scale, v_scale, rope};
  Coop a = coop_args(pack(wq, wk, wv, wo, ln1_s, ln1_b, ln2_s, ln2_b, w_up, b_up, w_down, b_down),
                     D, n_layers, L, (size_t)NB * bs * Hkv * Dh, h_in, h_out, c, prefix_lens,
                     suffix_lens, active, tables, qkv, att, gelu, flags);
  return launch_coop(a, plan, 2, kv, stream);
}

// CTAs a SM holds of cooperative kernel k (0 slab decode, 1 paged decode, 2
// verify, 3 slab per-layer step, 4 paged per-layer step) on KV type kv at
// `smem` bytes of dynamic shared memory, or -(cudaError_t).
extern "C" int coop_occupancy(int k, int kv, int smem) {
  if (k < 0 || k >= N_COOP || kv < 0 || kv >= N_KV || smem < 0)
    return -(int)cudaErrorInvalidValue;
  k += kv * N_COOP;
  int per_sm = 0;
  cudaError_t err = coop_per_sm(k, smem, per_sm);
  return err != cudaSuccess ? -(int)err : per_sm;
}

// The constants the launch plan (ops/fused_decode.py) mirrors, and the
// current device's opt-in shared memory a block: out[0..10] = CT, TILE,
// MAXT, GMAX, MAXS, RING, MAX_GRID, MAXTM, NWMAX, the compute dtype's
// bytes, the limit. Returns a cudaError_t.
extern "C" int coop_constants(int* out) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int v[11] = {CT, TILE, MAXT, GMAX, MAXS, RING, MAX_GRID, MAXTM, NWMAX,
                     (int)sizeof(Act), limit};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return (int)err;
}

#ifdef DECODE_PROBE
// Phase stamps of the cooperative launches that follow: [grid][NST n + 4]
// u64 (see stamp()), or null to stop.
extern "C" void coop_set_stamps(void* stamps) { g_stamps = (unsigned long long*)stamps; }

// `steps` grid barriers of the cooperative kernels over `grid` CTAs of
// `smem` bytes of shared memory, on the flags of the decode kernels.
extern "C" int coop_barrier_probe(int grid, int smem, int steps, void* flags, void* stream) {
  const void* k = (const void*)barrier_probe_kernel;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  unsigned* f = (unsigned*)flags;
  void* args[] = {&f, &steps};
  err = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(CT), args, smem,
                                    (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
#endif
