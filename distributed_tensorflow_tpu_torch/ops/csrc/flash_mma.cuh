// Building blocks of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// on Hopper's tensor cores: 16-byte cp.async tile copies into padded
// shared memory, the split-TF32 operand split, and m16n8k8 TF32 MMAs.
//
// Arithmetic. For f32 inputs every product is split-TF32: each operand x
// becomes hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and the
// product is lo*hi + hi*lo + hi*hi, three MMAs accumulating in f32 (the
// arithmetic of CUTLASS's OpMultiplyAddFastF32). Emulated on the CPU
// (tests/test_torch_tf32_split.py) attention lands within ~1e-6 of f32,
// where one TF32 pass misses by ~4e-4 and more. bf16 values
// (and p / ds rounded to bf16) are exact in TF32, so for bf16 inputs one
// TF32 MMA per product is exact products with f32 accumulation: the TPU
// kernels' one-pass bf16 arithmetic.
//
// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8):   b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A product sums over k in any order, as long as A and B agree on it. So
// where the A operand is the C tile of an earlier product (P V, P^T dO,
// dS^T Q), k-slot t stands for row 2t of the 8-row group and slot t+4 for
// row 2t+1: the C registers are then the A fragment as they stand (c0, c2,
// c1, c3), and the B operand reads rows 2t and 2t+1 (load_b_cols).
//
// Shared tiles are [rows][D + pad] in the input dtype, each row padded by
// 16 bytes (32 for bf16 at D=8, whose 16-byte rows would otherwise sit 4
// banks on from the last twice over: 8 banks), so a row is 4 (mod 8) banks
// on from the last. Row-gathers
// (rows g, columns t and t+4) and column-gathers (rows 2t and 2t+1, column
// g) are then free of bank conflicts, and every fragment address is a
// per-lane base plus a constant.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row stride, in elements, of a shared [rows][D] tile of T: D plus 16
// bytes, or 32 where that leaves the row 0 (mod 8) banks long.
template <typename T, int D>
__host__ __device__ constexpr int stride() {
  return ((D + 16 / (int)sizeof(T)) * (int)sizeof(T) / 4) % 8 == 4 ? D + 16 / (int)sizeof(T)
                                                                   : D + 32 / (int)sizeof(T);
}

// Rows r0 .. r0+ROWS-1 of head h of a [B, L, H, D] tensor into a padded
// tile, asynchronously; rows past L read as zeros.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows_async(T* dst, const T* __restrict__ src, int b, int r0,
                                                int h, int L, int H) {
  constexpr int CH = 16 / sizeof(T), NCH = D / CH;
  for (int i = threadIdx.x; i < ROWS * NCH; i += NT) {
    const int r = i / NCH, c = i % NCH, p = r0 + r;
    const bool in = p < L;
    const T* g = src + ((size_t)(b * L + (in ? p : 0)) * H + h) * D + c * CH;
    cp_async16(dst + r * stride<T, D>() + c * CH, g, in ? 16 : 0);
  }
}

// ROWS entries of a [B, L, H] f32 array (head h, rows r0..), asynchronously.
template <int ROWS, int NT>
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src, int b,
                                               int r0, int h, int L, int H) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const int p = r0 + i;
    const bool in = p < L;
    cp_async4(dst + i, src + (size_t)(b * L + (in ? p : 0)) * H + h, in ? 4 : 0);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the operand dtype T (the TPU kernels' astype before a product).
__device__ __forceinline__ float rnd(float x, const float*) { return x; }
__device__ __forceinline__ float rnd(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The operand split: SPLIT (f32 operands) gives hi = cvt.rna.tf32(x) and
// lo = x - hi rounded the same way. The MMA reads a TF32 operand's top 19
// bits and ignores the low 13, so adding half a TF32 ulp (0x1000) to lo's
// bits is that rounding without cvt's inf/NaN test, two instructions
// fewer (lo is finite wherever x is; where x is not, hi carries it).
// Without SPLIT, x is exact in TF32 (a bf16 value) and passes as it is.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment: its four values split; the B side is split by mma_b.
template <bool SPLIT>
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split<SPLIT>(x0, hi[0], lo[0]);
    split<SPLIT>(x1, hi[1], lo[1]);
    split<SPLIT>(x2, hi[2], lo[2]);
    split<SPLIT>(x3, hi[3], lo[3]);
  }
};

// c += A * B with B = (b0, b1). With SPLIT the small terms lo*hi + hi*lo go
// to x, which may be c itself. The tensor cores truncate as they
// accumulate, so each MMA into a large sum costs up to an ulp of it: a long
// sum (over the head dim) keeps the small terms in their own accumulator,
// added to c once the product is done, and takes one MMA per step.
template <bool SPLIT>
__device__ __forceinline__ void mma_b(float (&c)[4], float (&x)[4], const FragA<SPLIT>& a,
                                      float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split<SPLIT>(b0, h0, l0);
  split<SPLIT>(b1, h1, l1);
  if (SPLIT) {
    mma_tf32(x, a.lo, h0, h1);
    mma_tf32(x, a.hi, l0, l1);
  }
  mma_tf32(c, a.hi, h0, h1);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

struct Lane {
  int g, t;  // group, thread in group
  __device__ __forceinline__ Lane(int lane) : g(lane >> 2), t(lane & 3) {}
};

// A fragment from rows r0+g, r0+g+8, columns c0+t, c0+t+4 of a tile with
// row stride S.
template <int S, bool SPLIT, typename T>
__device__ __forceinline__ void load_a(FragA<SPLIT>& a, const T* s, int r0, int c0,
                                       const Lane& ln) {
  const T* p = s + (r0 + ln.g) * S + c0 + ln.t;
  a.set(to_f(p[0]), to_f(p[8 * S]), to_f(p[4]), to_f(p[8 * S + 4]));
}

// B operand B[k][n] = tile[r0 + n][c0 + k] (a row-gather).
template <int S, typename T>
__device__ __forceinline__ void load_b_rows(float& b0, float& b1, const T* s, int r0, int c0,
                                            const Lane& ln) {
  const T* p = s + (r0 + ln.g) * S + c0 + ln.t;
  b0 = to_f(p[0]);
  b1 = to_f(p[4]);
}

// B operand B[k][n] = tile[r0 + k][c0 + n] (a column-gather), with k-slots
// t / t+4 on rows r0+2t / r0+2t+1.
template <int S, typename T>
__device__ __forceinline__ void load_b_cols(float& b0, float& b1, const T* s, int r0, int c0,
                                            const Lane& ln) {
  const T* p = s + (r0 + 2 * ln.t) * S + c0 + ln.g;
  b0 = to_f(p[0]);
  b1 = to_f(p[S]);
}

}  // namespace flash
