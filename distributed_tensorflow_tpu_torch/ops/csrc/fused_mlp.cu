// Fused SGD for the reference MLP on Hopper (sm_90a), CUDA C++: two kernels.
//
//   mlp_step_kernel   replaces distributed_tensorflow_tpu/ops/pallas_mlp.py
//                     _fused_train_kernel (pallas_call at :124; public
//                     make_fused_train_step). One SGD step; the parameters
//                     are updated IN PLACE (the TPU kernel aliases them,
//                     input_output_aliases={2:0,3:1,4:2,5:3}).
//   mlp_epoch_kernel  replaces pallas_mlp.py _epoch_kernel (pallas_call at
//                     :235, built by _epoch_call; public make_fused_epoch_fn).
//                     `steps` SGD steps in one launch with the parameters
//                     resident in shared memory, written back once at the
//                     end (in place), one f32 cost per step.
//
// Both run pallas_mlp.py _mlp_sgd_math in f32 through ONE device function,
// sgd_step, as the TPU pair shares _mlp_sgd_math:
//
//   z1 = x W1 + b1;  h = sigmoid(z1);  p = softmax(h W2 + b2)   (max-subtracted)
//   cost = sum_b(-sum_k y log(max(p, 1e-30))) / B;  dl = (p - y) / B
//   dW2 = h^T dl;  db2 = sum_b dl;  dz1 = (dl W2^T) h (1 - h)
//   dW1 = x^T dz1;  db1 = sum_b dz1;  W <- W - lr dW  (every grad from the old W)
//
// Split over CTAs. W1 alone (784*100*4 = 313,600 bytes) exceeds the 227 KB
// one CTA may hold, so the HIDDEN units are split: CTA c owns J = [4c, 4c+4)
// and keeps W1[:, J] (transposed), b1[J], W2[J, :] and its own copy of b2 in
// shared memory; 25 CTAs at H=100, launched cooperatively (a grid that
// cannot be co-resident is refused). The one dependency between CTAs is
// logits = sum_J h[:, J] W2[J, :]: each CTA writes its [B, OUT] share to
// global memory, the grid synchronises, and every CTA sums the shares in CTA
// order (no float atomics; all CTAs hold the same logits bit for bit and
// compute the softmax redundantly, so their b2 copies stay identical). The
// shares are double-buffered by step parity: a CTA cannot reach step i+2's
// write before every CTA has passed step i+1's barrier, i.e. finished
// reading step i's shares. The sum is spread over all threads, two logits
// each, with up to 32 shares' loads in flight.
//
// The batch in shared memory. x is cut along IN into chunks of 512 bytes a
// row (C = 256 bf16 or 128 f32 columns; the last chunk ragged) and each
// chunk of a batch is one TMA copy of a [B, w] box (cp.async.bulk.tensor,
// tensor maps from the host) into a slot with an mbarrier that counts its
// bytes; thread 0 issues it ahead of its use. Load u of a launch (per step:
// the forward's chunks, then dW1's when streaming) fills slot u % nbuf for
// the (u / nbuf)-th time, so waiters use parity (u / nbuf) & 1; the ring
// follows u with a slot and fill counter instead of dividing. Each CTA also
// asks L2 for its 1/25 of the next batch (cp.async.bulk.prefetch.L2) a step
// ahead, so the copies hit L2.
//   - resident (a bf16 batch: 156,800 bytes at B=100): every chunk has its
//     own slot; the forward and dW1 read the same copy, and after dW1 the
//     next batch's chunks are copied in, chunk 0 first, for the next
//     forward;
//   - streaming (f32: 313,600 bytes do not fit): a ring of 2-4 slots; the
//     forward and then dW1 each stream the chunks, the next ones in flight
//     while the current one is used.
// Rows of a slot are the chunk's width apart (rows of x must be 16-byte
// multiples: IN a multiple of 8 in bf16, of 4 in f32). Copies were first
// 512-byte row segments, by TMA (100 a chunk, one thread issuing) and then
// by cp.async (16 bytes a thread): both kept the SMs waiting on issue
// longer than one box a chunk does (PERF.md).
//
// The products on x, from shared memory, in f32 FMAs on the CUDA cores:
//   - forward: warp w owns ceil(B/16) <= 8 examples, each lane one 16-byte
//     vector of x per chunk and row; its [8 x 4] sums are kept in registers
//     across the chunks (W1 read once per chunk for all 8 examples; rows
//     past the batch and lanes past the chunk compute on clamped or zeroed
//     inputs instead of branching), then reduce-scattered across the warp
//     in 31 shuffles;
//   - dW1, resident: thread t owns columns 2t, 2t+1 for every unit and sums
//     the whole batch itself (8 products per two shared loads);
//   - dW1, streaming: per chunk, thread (slice, quad) sums four columns for
//     every unit over one of 8 batch slices; the slices' sums meet in
//     shared memory and each thread adds one (column, unit)'s in order.
// The reductions over the batch (db2, the cost, db1, dW2) run at once,
// eight lanes each, lanes over examples then a shuffle tree; the softmax,
// dlogits and dz1 take four threads an example. Every sum has a fixed
// order, so two runs are bitwise equal. Each round of dependent latency
// costs more than the arithmetic at these sizes, so the phases are laid
// out for few rounds (PERF.md has the split of a step).
//
// The barrier is the cooperative grid's. chip_smoke.py's barrier probes
// time a thread-block cluster instead (the shares exchanged through
// distributed shared memory): a cluster of 8 CTAs meets ~0.9 us a step
// sooner, one of 15 no sooner at the reference's 1000 floats a CTA. A
// cluster of 8 needs 13 hidden units a CTA, a step that was not built or
// timed; whether it pays is open (PERF.md).
//
// Bound. One step at B=100, 784->100->10 does 2*100*(784*100*2 + 100*10*3)
// = 31.96 MFLOP: 0.477 us at the H100's 67 TFLOP/s f32 (CUDA cores; the
// update math is f32 as on the TPU). So both kernels are bound by
// operations, but at batch 100 the steps are small and serial, and latency
// rules: the grid barrier with the share sum, and the chains of phases a
// step must run in order (PERF.md has the split of a step).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_probe.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int HC = 4;          // hidden units owned by one CTA
constexpr int RBMAX = 8;       // examples of one warp in the forward: B <= 128
constexpr int MAX_B = NWARPS * RBMAX;
constexpr int MAX_OUT = 32;    // classes: the first kernels' domain, kept
constexpr int MAX_NBUF = 4;    // slots of the streaming ring
constexpr int SUM_BATCH = 32;  // share loads in flight per pair of logits
constexpr float LOG_EPS = 1e-30f;
static_assert(RBMAX * HC == 32, "the forward reduce-scatters 32 sums per warp");

typedef __nv_bfloat16 bf16;

struct Dims {
  int B, IN, H, OUT;
};

// A stream type's chunk: V elements a lane loads at once (16 bytes), C
// columns a chunk (512 bytes a row).
template <typename T>
struct Chunk {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int C = 32 * V;
};

__host__ __device__ constexpr int chunk_cols(int elem) { return 512 / elem; }

// Streaming dW1: four-column groups of a chunk, and batch slices.
template <typename T>
constexpr int STREAM_QD = Chunk<T>::C / 4;
constexpr int STREAM_SL = 8;

// Byte offsets of one CTA's shared memory; the same on host and device.
struct Plan {
  int nc, nbuf, resident;  // chunks, slots, every chunk its own slot
  unsigned bar, w1, w2, b1, b2, h, dz1, dl, y, crow, one, part, x, total;
};

__host__ __device__ inline unsigned align16(size_t n) { return (unsigned)((n + 15) & ~(size_t)15); }

// The layout for `nbuf` ring slots, or (resident) one slot per chunk.
__host__ __device__ inline Plan make_plan(const Dims& d, int elem, int nbuf, int resident) {
  const int C = chunk_cols(elem);
  Plan p;
  p.nc = (d.IN + C - 1) / C;
  p.resident = resident;
  p.nbuf = resident ? p.nc : nbuf;
  unsigned o = 0;
  p.bar = o;  o += align16(8 * (size_t)p.nbuf);
  p.w1 = o;   o += align16(4 * (size_t)HC * d.IN);
  p.w2 = o;   o += align16(4 * (size_t)HC * d.OUT);
  p.b1 = o;   o += align16(4 * HC);
  p.b2 = o;   o += align16(4 * (size_t)d.OUT);
  p.h = o;    o += align16(4 * (size_t)d.B * HC);
  p.dz1 = o;  o += align16(4 * (size_t)d.B * HC);
  p.dl = o;   o += align16(4 * (size_t)d.B * d.OUT);
  p.y = o;    o += align16(4 * (size_t)d.B * d.OUT);
  p.crow = o; o += align16(4 * (size_t)d.B);
  p.one = o;  o += 16;
  p.part = o; o += resident ? 0 : 4 * 4 * HC * STREAM_SL * (C / 4);
  o = (o + 127) & ~127u;  // TMA destinations: 128-byte aligned
  p.x = o;
  o += resident ? align16((size_t)d.B * d.IN * elem) : align16((size_t)nbuf * d.B * C * elem);
  p.total = o;
  return p;
}

// Floats between two CTAs' shares: B*OUT rounded up to even, so that
// pairs load as float2.
__host__ __device__ inline int share_stride(const Dims& d) { return (d.B * d.OUT + 1) & ~1; }

struct Smem {
  uint64_t* bar;  // [nbuf]      one mbarrier per slot
  float* w1;      // [HC][IN]    W1[:, j0 + j], transposed
  float* w2;      // [HC][OUT]   W2[j0 + j, :]
  float* b1;      // [HC]
  float* b2;      // [OUT]       this CTA's copy
  float* h;       // [B][HC]
  float* dz1;     // [B][HC]
  float* dl;      // [B][OUT]    logits, then dlogits
  float* y;       // [B][OUT]    the step's labels
  float* crow;    // [B]         per-example cost
  float* one;     // [1]         1.0, the second factor of a plain sum
  float* part;    // [SL][4*HC][QD] streaming dW1's slice sums of a chunk
  char* x;        // the slots
};

__device__ Smem carve(char* base, const Plan& p) {
  Smem s;
  s.bar = (uint64_t*)(base + p.bar);
  s.w1 = (float*)(base + p.w1);
  s.w2 = (float*)(base + p.w2);
  s.b1 = (float*)(base + p.b1);
  s.b2 = (float*)(base + p.b2);
  s.h = (float*)(base + p.h);
  s.dz1 = (float*)(base + p.dz1);
  s.dl = (float*)(base + p.dl);
  s.y = (float*)(base + p.y);
  s.crow = (float*)(base + p.crow);
  s.one = (float*)(base + p.one);
  s.part = (float*)(base + p.part);
  s.x = base + p.x;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

// W - lr*dW rounded as the reference rounds it: the product, then the
// difference (no fused multiply-add).
__device__ __forceinline__ float sgd(float w, float lr, float g) {
  return __fsub_rn(w, __fmul_rn(lr, g));
}

// Four neighbouring elements of x as floats (bf16 -> f32 is exact).
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 w = *(const uint2*)p;
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4(const float* p) { return *(const float4*)p; }

// A column pair of x as floats.
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  const uint32_t w = *(const uint32_t*)p;
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 ld_pair(const float* p) { return *(const float2*)p; }

// One halving of a reduce-scatter across lanes: lanes with bit OFF set
// keep the upper half of v[0, 2*OFF) and send the lower, their partners
// the reverse; after halvings OFF, OFF/2, .., 1 lane l holds the sum of
// v[l mod 2*OFF].
template <int OFF, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  static_assert(2 * OFF <= N, "halve takes v[0, 2*OFF)");
  const bool up = lane & OFF;
#pragma unroll
  for (int k = 0; k < OFF; ++k) {
    const float send = up ? v[k] : v[k + OFF];
    const float keep = up ? v[k + OFF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Sums 32 values across the warp: lane l returns the total of v[l], in
// five halvings (31 shuffles).
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// Elements t, t+1 (t even) of the CTAs' shares ([gridDim.x][stride])
// summed in CTA order, read through L2 (other SMs wrote them) with up to
// SUM_BATCH loads in flight.
__device__ __forceinline__ float2 sum_shares(const float* shares, int stride, int t) {
  const int nblk = (int)gridDim.x;
  float2 acc = make_float2(0.f, 0.f);
  for (int c0 = 0; c0 < nblk; c0 += SUM_BATCH) {
    float2 v[SUM_BATCH];
#pragma unroll
    for (int i = 0; i < SUM_BATCH; ++i)
      v[i] = c0 + i < nblk ? __ldcg((const float2*)(shares + (size_t)(c0 + i) * stride + t))
                           : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < SUM_BATCH; ++i)
      if (c0 + i < nblk) {
        acc.x += v[i].x;
        acc.y += v[i].y;
      }
  }
  return acc;
}

// -- the staging of x (TMA copies, one mbarrier per slot) --------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// One TMA copy of the box of `map` at (column col, row row) into dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// The slots of x and where the next load goes. Load u (of the launch's
// sequence: per step, the forward's chunks, then dW1's when streaming)
// fills slot u % nbuf for the (u / nbuf)-th time; `k` and `f` follow u
// without dividing.
template <typename T>
struct Ring {
  T* x;
  uint64_t* bar;
  const CUtensorMap* map;   // x as [steps*B, IN] in global memory, boxes [B, C]
  const CUtensorMap* tail;  // the same with boxes [B, IN % C]
  int steps, nbuf, nc, B, IN;
  bool resident;
  int k = 0, f = 0;  // streaming: the slot and fill of the next load used

  __device__ int width(int c) const { return min(Chunk<T>::C, IN - c * Chunk<T>::C); }
  // Rows of a slot are its chunk's width apart; resident chunk c starts
  // after c full-width chunks.
  __device__ T* slot(int slot_k) const { return x + (size_t)slot_k * B * Chunk<T>::C; }
  __device__ void wait(int slot_k, int fill) const { mbar_wait(bar + slot_k, fill & 1); }
  __device__ void advance() {
    if (++k == nbuf) {
      k = 0;
      ++f;
    }
  }
  // Chunk c of batch `step` into slot slot_k: one TMA copy of a [B, w]
  // box (`tail`'s box for a ragged last chunk), issued by thread 0, which
  // also arrives on the slot's mbarrier with the bytes to expect.
  __device__ void issue(int slot_k, int step, int c) const {
    if (step >= steps || threadIdx.x != 0) return;
    const int w = width(c);
#ifdef MLP_PROBE
    if ((g_mlp_probe_flags & MLP_SKIP_COPIES) && step > 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar + slot_k))
                   : "memory");
      return;
    }
#endif
    mbar_expect_tx(bar + slot_k, (uint32_t)(B * w * sizeof(T)));
    tma_load_2d(slot(slot_k), w == Chunk<T>::C ? map : tail, c * Chunk<T>::C, step * B,
                bar + slot_k);
  }
  // Streaming: after the use of chunk c of pass `pass` (0 forward, 1 dW1)
  // of batch `step` in slot k, the load nbuf ahead goes into the same slot.
  __device__ void refill(int step, int pass, int c) {
    int idx = pass * nc + c + nbuf;
    if (idx >= 2 * nc) {
      idx -= 2 * nc;
      ++step;
    }
    issue(k, step, idx >= nc ? idx - nc : idx);
    advance();
  }
};

// Each CTA asks L2 for its 1/gridDim.x share of a batch's bytes (one
// bulk prefetch), so that the slots' copies of it later hit L2.
__device__ __forceinline__ void prefetch_l2(const void* batch, size_t bytes) {
  const size_t share = (bytes / gridDim.x + 15) & ~(size_t)15, off = share * blockIdx.x;
  if (threadIdx.x == 0 && off < bytes)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"((const char*)batch + off),
                 "r"((uint32_t)(bytes - off < share ? bytes - off : share))
                 : "memory");
}

// This CTA's slice of the parameters into shared memory. Hidden units past
// H (the last CTA's ragged slice) are zero: they add nothing to the logits
// and get zero gradients.
__device__ void load_params(const Smem& s, const Dims& d, int j0, const float* w1,
                            const float* b1, const float* w2, const float* b2) {
  for (int t = threadIdx.x; t < HC * d.IN; t += NTHREADS) {
    const int i = t / HC, j = t % HC;
    s.w1[j * d.IN + i] = (j0 + j < d.H) ? w1[(size_t)i * d.H + j0 + j] : 0.f;
  }
  for (int t = threadIdx.x; t < HC * d.OUT; t += NTHREADS) {
    const int j = t / d.OUT, k = t % d.OUT;
    s.w2[t] = (j0 + j < d.H) ? w2[(size_t)(j0 + j) * d.OUT + k] : 0.f;
  }
  if (threadIdx.x < HC) s.b1[threadIdx.x] = (j0 + threadIdx.x < d.H) ? b1[j0 + threadIdx.x] : 0.f;
  if (threadIdx.x < d.OUT) s.b2[threadIdx.x] = b2[threadIdx.x];
  if (threadIdx.x == 0) s.one[0] = 1.f;
  __syncthreads();
}

// Write back the slice this CTA owns; CTA 0 writes b2.
__device__ void store_params(const Smem& s, const Dims& d, int j0, float* w1, float* b1,
                             float* w2, float* b2) {
  for (int t = threadIdx.x; t < HC * d.IN; t += NTHREADS) {
    const int i = t / HC, j = t % HC;
    if (j0 + j < d.H) w1[(size_t)i * d.H + j0 + j] = s.w1[j * d.IN + i];
  }
  for (int t = threadIdx.x; t < HC * d.OUT; t += NTHREADS) {
    const int j = t / d.OUT, k = t % d.OUT;
    if (j0 + j < d.H) w2[(size_t)(j0 + j) * d.OUT + k] = s.w2[t];
  }
  if (threadIdx.x < HC && j0 + threadIdx.x < d.H) b1[j0 + threadIdx.x] = s.b1[threadIdx.x];
  if (blockIdx.x == 0 && threadIdx.x < d.OUT) b2[threadIdx.x] = s.b2[threadIdx.x];
}

// One SGD step on batch `step` of the ring (labels y [B, OUT]) with this
// CTA's parameters in shared memory. `shares` is the step's share buffer
// ([gridDim.x][B*OUT]); CTA 0 writes the cost to *cost.
template <typename T>
__device__ void sgd_step(const Smem& s, const Dims& d, Ring<T>& ring, int step, int j0,
                         const T* __restrict__ y, float* shares, float* cost, float lr,
                         cg::grid_group& grid) {
  using Ch = Chunk<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = d.B, IN = d.IN, OUT = d.OUT, BO = d.B * d.OUT, stride = share_stride(d);
  const float inv_b = 1.0f / (float)B;
  const bool resident = ring.resident;

  // Forward, z1[:, J] and h[:, J]: warp w owns examples [w*rb, w*rb + nb);
  // lane l takes the 16-byte vector at column l*V of each chunk.
  {
    const int rb = (B + NWARPS - 1) / NWARPS;
    const int e0 = warp * rb, nb = max(0, min(rb, B - e0));
    float acc[RBMAX * HC];
#pragma unroll
    for (int k = 0; k < RBMAX * HC; ++k) acc[k] = 0.f;
    // Without branches: rows past the batch read its last row and lanes
    // past the chunk's width read zeros; their sums are never stored.
    for (int c = 0; c < ring.nc; ++c) {
      const int w = ring.width(c), k = resident ? c : ring.k;
      const bool live = lane * Ch::V < w;
      const int col = live ? lane * Ch::V : 0;
      ring.wait(k, resident ? step : ring.f);
      const T* xr = ring.slot(k) + col;
      // Four columns at a time: W1[those, J] once, then every example.
#pragma unroll 1
      for (int g = 0; g < Ch::V; g += 4) {
        float4 wv[HC];
#pragma unroll
        for (int j = 0; j < HC; ++j) wv[j] = *(const float4*)(s.w1 + j * IN + c * Ch::C + col + g);
#pragma unroll
        for (int r = 0; r < RBMAX; ++r) {
          float4 xv = ld4(xr + (size_t)min(e0 + r, B - 1) * w + g);
          if (!live) xv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < HC; ++j) {
            float a = acc[r * HC + j];
            a = fmaf(xv.x, wv[j].x, a);
            a = fmaf(xv.y, wv[j].y, a);
            a = fmaf(xv.z, wv[j].z, a);
            acc[r * HC + j] = fmaf(xv.w, wv[j].w, a);
          }
        }
      }
      if (!resident) {  // the slot goes to the load nbuf ahead
        __syncthreads();
        ring.refill(step, 0, c);
      }
    }
    MLP_STAMP(0);
    const float z = reduce_scatter32(acc, lane);  // (r, j) = (lane / HC, lane % HC)
    const int r = lane / HC, j = lane % HC;
    if (r < nb)
      s.h[(e0 + r) * HC + j] = j0 + j < d.H ? 1.f / (1.f + expf(-(z + s.b1[j]))) : 0.f;
  }
  __syncthreads();
  MLP_STAMP(1);

  // This CTA's share of the logits, h[:, J] W2[J, :]; the labels into
  // shared memory while the grid meets.
  for (int t = tid; t < BO; t += NTHREADS) {
    const int b = t / OUT, k = t % OUT;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < HC; ++j) acc = fmaf(s.h[b * HC + j], s.w2[j * OUT + k], acc);
    __stcg(shares + (size_t)blockIdx.x * stride + t, acc);
    s.y[t] = ld(y + t);
  }
  MLP_STAMP(2);
  grid.sync();

  // logits = the shares summed in CTA order, + b2, two a thread.
  for (int t = 2 * tid; t < BO; t += 2 * NTHREADS) {
    const float2 v = sum_shares(shares, stride, t);
    s.dl[t] = v.x + s.b2[t % OUT];
    if (t + 1 < BO) s.dl[t + 1] = v.y + s.b2[(t + 1) % OUT];
  }
  __syncthreads();
  MLP_STAMP(3);

  // Four neighbouring threads per example (g = lane & 3 takes classes g,
  // g+4, ..): the softmax, the naive cross entropy, dlogits, and dz1 =
  // (dl W2[J, :]^T) h (1 - h) from the old W2, each thread's sums over its
  // classes joined by shuffles within the four; thread g ends with unit g.
  if (warp * 32 < 4 * B) {
    static_assert(HC == 4, "the softmax's four threads end with one unit each");
    const int b = tid >> 2, g = tid & 3;
    const bool on = b < B;
    float* row = s.dl + b * OUT;  // logits, then exp, then dlogits
    const float* yr = s.y + b * OUT;
    float m = __int_as_float((int)0xff800000u);  // -inf
    if (on)
      for (int k = g; k < OUT; k += 4) m = fmaxf(m, row[k]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.f;
    if (on)
#pragma unroll 1
      for (int k = g; k < OUT; k += 4) {
        const float e = expf(row[k] - m);
        row[k] = e;
        sum += e;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    float c = 0.f, dz[HC] = {0.f, 0.f, 0.f, 0.f};
    if (on)
#pragma unroll 1
      for (int k = g; k < OUT; k += 4) {
        const float p = row[k] / sum, yv = yr[k];
        // max(p, eps) that keeps a NaN (fmaxf drops it), as jnp.maximum and
        // torch.clamp do: a NaN batch gives a NaN cost, which the anomaly
        // guard reads. The same value for every other p.
        c += yv * logf(p < LOG_EPS ? LOG_EPS : p);
        const float gl = (p - yv) * inv_b;
        row[k] = gl;
#pragma unroll
        for (int j = 0; j < HC; ++j) dz[j] = fmaf(gl, s.w2[j * OUT + k], dz[j]);
      }
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    halve<2>(dz, lane);
    halve<1>(dz, lane);
    if (on) {
      if (g == 0) s.crow[b] = -c;
      const float hv = s.h[b * HC + g];
      s.dz1[b * HC + g] = dz[0] * hv * (1.f - hv);
    }
  }
  __syncthreads();
  MLP_STAMP(4);

  // The sums over the batch and their updates: db2 and b2 (every CTA its
  // own copy), the cost, db1 and b1, dW2 and W2[J, :]. They read dl, crow,
  // dz1 and h, which nothing writes until the next step; dW1's first
  // barrier waits for them before anything reads the new b1 or W2.
  // Eight lanes a sum (four sums a warp, all at once): lane q of a sum
  // takes examples q, q+8, ..; three shuffles join the eight.
  const int ntask = OUT + 1 + HC + HC * OUT;
  for (int task = tid >> 3; task - (lane >> 3) < ntask; task += NTHREADS / 8) {
    const bool on = task < ntask;
    const float *a = s.crow, *f = s.one;  // a plain sum multiplies by s.one[0]
    int sa = 1, sf = 0;
    if (!on) {
      sa = 0;  // a lane past the last sum adds crow[0] * 1, never stored
    } else if (task < OUT) {  // db2[k]
      a = s.dl + task;
      sa = OUT;
    } else if (task > OUT && task <= OUT + HC) {  // db1[j]
      a = s.dz1 + (task - OUT - 1);
      sa = HC;
    } else if (task > OUT + HC) {  // dW2[j, k] = sum_b h[b, j] dl[b, k]
      const int t = task - OUT - 1 - HC;
      a = s.h + t / OUT;
      sa = HC;
      f = s.dl + t % OUT;
      sf = OUT;
    }
    float part = 0.f;
    for (int b = lane & 7; b < B; b += 8) part = fmaf(a[b * sa], f[b * sf], part);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (on && (lane & 7) == 0) {
      if (task < OUT) {
        s.b2[task] = sgd(s.b2[task], lr, part);
      } else if (task == OUT) {
        if (blockIdx.x == 0) *cost = part * inv_b;
      } else if (task <= OUT + HC) {
        const int jj = task - OUT - 1;
        s.b1[jj] = sgd(s.b1[jj], lr, part);
      } else {
        const int t = task - OUT - 1 - HC;
        s.w2[t] = sgd(s.w2[t], lr, part);
      }
    }
  }
  MLP_STAMP(5);

  // dW1[:, J] = x^T dz1 and W1[:, J]; every sum over the batch in a fixed
  // order.
  if (resident) {
    // Thread t owns columns 2t, 2t+1 (and t + 512, ..) for every unit and
    // sums the whole batch itself; then one barrier, and the next batch's
    // copies into every slot.
    for (int pr = tid; 2 * pr < IN; pr += NTHREADS) {
      const int col = 2 * pr, c = col / Ch::C, w = ring.width(c);
      const T* xc = ring.slot(c) + (col - c * Ch::C);
      float a[2][HC] = {};
      for (int b = 0; b < B; ++b) {
        const float2 xv = ld_pair(xc + (size_t)b * w);
        const float4 dz = *(const float4*)(s.dz1 + b * HC);
        const float dzv[HC] = {dz.x, dz.y, dz.z, dz.w};
#pragma unroll
        for (int j = 0; j < HC; ++j) {
          a[0][j] = fmaf(xv.x, dzv[j], a[0][j]);
          a[1][j] = fmaf(xv.y, dzv[j], a[1][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        float* wp = s.w1 + j * IN + col;
        wp[0] = sgd(wp[0], lr, a[0][j]);
        wp[1] = sgd(wp[1], lr, a[1][j]);
      }
    }
    MLP_STAMP(6);
    __syncthreads();  // every read of every slot is done
    for (int c = 0; c < ring.nc; ++c) ring.issue(c, step + 1, c);
    MLP_STAMP(7);
  } else {
    // Chunk by chunk as they stream in: thread (sl, qd) sums columns
    // 4qd..4qd+3 for every unit over batch slice sl (16 products per two
    // shared loads); the SL slices' sums meet in shared memory, where each
    // thread adds one (column, unit)'s in slice order. The slot goes to
    // the next load as soon as its columns are read.
    const int qd = tid % STREAM_QD<T>, sl = tid / STREAM_QD<T>;
    const int bs = (B + STREAM_SL - 1) / STREAM_SL, b0 = sl * bs;
    const int b1 = sl < STREAM_SL ? min(B, b0 + bs) : b0;
    for (int c = 0; c < ring.nc; ++c) {
      const int w = ring.width(c);
      ring.wait(ring.k, ring.f);
      float a[4][HC] = {};
      if (4 * qd < w) {
        const T* xc = ring.slot(ring.k) + 4 * qd;
        for (int b = b0; b < b1; ++b) {
          const float4 xv = ld4(xc + (size_t)b * w);
          const float4 dz = *(const float4*)(s.dz1 + b * HC);
          const float xs4[4] = {xv.x, xv.y, xv.z, xv.w}, dzv[HC] = {dz.x, dz.y, dz.z, dz.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int j = 0; j < HC; ++j) a[e][j] = fmaf(xs4[e], dzv[j], a[e][j]);
        }
      }
      if (sl < STREAM_SL)
#pragma unroll
        for (int v = 0; v < 4 * HC; ++v)
          s.part[(sl * 4 * HC + v) * STREAM_QD<T> + qd] = a[v / HC][v % HC];
      MLP_STAMP(6);
      __syncthreads();  // every read of the slot and every partial is done
      ring.refill(step, 1, c);
      for (int o = tid; o < 4 * HC * STREAM_QD<T>; o += NTHREADS) {
        const int v = o / STREAM_QD<T>, q2 = o % STREAM_QD<T>, col = 4 * q2 + v / HC;
        if (col < w) {
          float g = 0.f;
#pragma unroll
          for (int ss = 0; ss < STREAM_SL; ++ss) g += s.part[(ss * 4 * HC + v) * STREAM_QD<T> + q2];
          float* wp = s.w1 + (v % HC) * IN + c * Ch::C + col;
          *wp = sgd(*wp, lr, g);
        }
      }
      __syncthreads();  // the partials' space is free again
      MLP_STAMP(7);
    }
  }
}

// The ring, its mbarriers and the first loads, then the parameters, then
// `steps` steps. The step kernel is this body at steps = 1 on an f32 batch.
template <typename T>
__device__ void run(const T* xs, const CUtensorMap* map, const CUtensorMap* tail, const T* ys,
                    float* w1, float* b1, float* w2, float* b2, float* costs, float* shares,
                    int steps, const Dims& d, const Plan& p, float lr) {
  extern __shared__ __align__(16) char smem[];
  cg::grid_group grid = cg::this_grid();
  mlp_split_begin();
  const Smem s = carve(smem, p);
  Ring<T> ring{(T*)s.x, s.bar, map, tail, steps, p.nbuf, p.nc, d.B, d.IN, p.resident != 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < p.nbuf; ++k) mbar_init(s.bar + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const size_t batch = (size_t)d.B * d.IN;
  prefetch_l2(xs, batch * sizeof(T));
  for (int u = 0; u < p.nbuf; ++u) ring.issue(u, 0, u);  // nbuf <= nc
  const int j0 = blockIdx.x * HC;
  const size_t bo = (size_t)d.B * d.OUT, stride = share_stride(d);
  load_params(s, d, j0, w1, b1, w2, b2);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) prefetch_l2(xs + (step + 1) * batch, batch * sizeof(T));
    sgd_step<T>(s, d, ring, step, j0, ys + (size_t)step * bo,
                shares + (size_t)(step & 1) * gridDim.x * stride, costs + step, lr, grid);
  }
  store_params(s, d, j0, w1, b1, w2, b2);
  mlp_split_end();
}

__global__ void __launch_bounds__(NTHREADS, 1)
    mlp_step_kernel(const float* __restrict__ x, const __grid_constant__ CUtensorMap map,
                    const __grid_constant__ CUtensorMap tail, const float* __restrict__ y,
                    float* w1, float* b1, float* w2, float* b2, float* cost, float* shares,
                    Dims d, Plan p, float lr) {
  run<float>(x, &map, &tail, y, w1, b1, w2, b2, cost, shares, 1, d, p, lr);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    mlp_epoch_kernel(const T* __restrict__ xs, const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap tail, const T* __restrict__ ys,
                     float* w1, float* b1, float* w2, float* b2, float* costs, float* shares,
                     int steps, Dims d, Plan p, float lr) {
  run<T>(xs, &map, &tail, ys, w1, b1, w2, b2, costs, shares, steps, d, p, lr);
}

int num_blocks(int H) { return (H + HC - 1) / HC; }

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor maps of x ([rows, IN], 16-byte aligned rows) with boxes of
// [B, C] columns and of [B, IN % C] (the ragged last chunk; the first map
// again when there is none).
cudaError_t x_maps(const void* x, int rows, const Dims& d, int elem, CUtensorMap& map,
                   CUtensorMap& tail) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    if (err != cudaSuccess) return err;
    if (!fn) return cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const int C = chunk_cols(elem), rem = d.IN % C;
  const cuuint64_t dims[2] = {(cuuint64_t)d.IN, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d.IN * elem};
  const cuuint32_t ones[2] = {1, 1};
  const CUtensorMapDataType type =
      elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  for (int m = 0; m < 2; ++m) {
    const cuuint32_t box[2] = {(cuuint32_t)(m == 1 && rem ? rem : (d.IN < C ? d.IN : C)),
                               (cuuint32_t)d.B};
    if (encode(m ? &tail : &map, type, 2, const_cast<void*>(x), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The current card's numbers, read when the device changes.
struct Device {
  int id = -1, nsm = 0, coop = 0, smem_optin = 0;
};
Device g_dev;

cudaError_t device(Device& dv = g_dev) {
  int id = 0;
  cudaError_t err = cudaGetDevice(&id);
  if (err != cudaSuccess || id == dv.id) return err;
  Device n;
  n.id = id;
  if ((err = cudaDeviceGetAttribute(&n.nsm, cudaDevAttrMultiProcessorCount, id)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n.coop, cudaDevAttrCooperativeLaunch, id)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, id)) !=
          cudaSuccess)
    return err;
  dv = n;
  return cudaSuccess;
}

// The plan for these dims: resident if the whole batch fits, else a ring
// of 2..MAX_NBUF slots; false outside the kernels' domain.
bool plan_for(const Dims& d, int elem, int limit, Plan& p) {
  if (d.B < 1 || d.B > MAX_B || d.IN < 1 || d.H < 1 || d.OUT < 1 || d.OUT > MAX_OUT ||
      (d.IN * elem) % 16 != 0)
    return false;
  p = make_plan(d, elem, 0, 1);
  if ((long)p.total <= limit) return true;
  const long room = limit - (long)make_plan(d, elem, 0, 0).total - 8 * MAX_NBUF - 128;
  const long slot = (long)d.B * chunk_cols(elem) * elem;
  const int nbuf = room < 0 ? 0 : (int)(room / slot < MAX_NBUF ? room / slot : MAX_NBUF);
  if (nbuf < 2) return false;
  p = make_plan(d, elem, nbuf, 0);
  return (long)p.total <= limit;
}

// Cooperative launch of `kernel` over num_blocks(H) CTAs; refuses dims
// outside the domain and a grid that cannot be co-resident (the grid
// barrier would never complete). The shared-memory attribute and the
// occupancy are asked only when the kernel's shared memory changes.
struct KernelState {
  int smem = -1, per_sm = 0, dev = -1;
};

cudaError_t coop_launch(const void* kernel, KernelState& ks, const Dims& d, const Plan& p,
                        void** args, cudaStream_t stream) {
  const Device& dv = g_dev;
  cudaError_t err = device();
  if (err != cudaSuccess) return err;
  if (!dv.coop) return cudaErrorNotSupported;
  if ((int)p.total != ks.smem || dv.id != ks.dev) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)p.total)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ks.per_sm, kernel, NTHREADS,
                                                             p.total)) != cudaSuccess)
      return err;
    ks.smem = (int)p.total;
    ks.dev = dv.id;
  }
  const int nblk = num_blocks(d.H);
  if (ks.per_sm * dv.nsm < nblk) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblk), dim3(NTHREADS), args, p.total, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The plan within this card's opt-in shared memory (less the probe
// builds' static stamps), or cudaErrorInvalidValue outside the domain.
cudaError_t plan_or_refuse(const Dims& d, int elem, Plan& p) {
  cudaError_t err = device();
  if (err != cudaSuccess) return err;
  return plan_for(d, elem, g_dev.smem_optin - MLP_PROBE_SMEM, p) ? cudaSuccess
                                                                 : cudaErrorInvalidValue;
}

}  // namespace

// Floats of the share buffer of a launch (both parities).
extern "C" int mlp_workspace(int B, int IN, int H, int OUT, int bf16) {
  return 2 * num_blocks(H) * share_stride(Dims{B, IN, H, OUT});
}

// Bytes of shared memory a CTA of a launch on the current card takes, and
// its ring (nbuf slots; resident 1 when every chunk has its own); 0 outside
// the domain, minus a cudaError_t when the card cannot be asked.
extern "C" int mlp_plan(int B, int IN, int H, int OUT, int bf16, int* nbuf, int* resident) {
  Plan p;
  const cudaError_t err = plan_or_refuse(Dims{B, IN, H, OUT}, bf16 ? 2 : 4, p);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -(int)err;
  *nbuf = p.nbuf;
  *resident = p.resident;
  return (int)p.total;
}

extern "C" int mlp_step(const void* x, const void* y, void* w1, void* b1, void* w2, void* b2,
                        void* cost, void* shares, int B, int IN, int H, int OUT, float lr,
                        void* stream) {
  static KernelState ks;
  const float* xp = (const float*)x;
  const float* yp = (const float*)y;
  float *w1p = (float*)w1, *b1p = (float*)b1, *w2p = (float*)w2, *b2p = (float*)b2;
  float *cp = (float*)cost, *sp = (float*)shares;
  Dims d{B, IN, H, OUT};
  Plan p;
  CUtensorMap map, tail;
  cudaError_t err = plan_or_refuse(d, 4, p);
  if (err == cudaSuccess) err = x_maps(x, B, d, 4, map, tail);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&xp, &map, &tail, &yp, &w1p, &b1p, &w2p, &b2p, &cp, &sp, &d, &p, &lr};
  return (int)coop_launch((const void*)mlp_step_kernel, ks, d, p, args, (cudaStream_t)stream);
}

// `bf16` selects the stream type of xs/ys: 1 = bfloat16, 0 = float32.
extern "C" int mlp_epoch(const void* xs, const void* ys, int bf16, void* w1, void* b1, void* w2,
                         void* b2, void* costs, void* shares, int steps, int B, int IN, int H,
                         int OUT, float lr, void* stream) {
  static KernelState ks16, ks32;
  float *w1p = (float*)w1, *b1p = (float*)b1, *w2p = (float*)w2, *b2p = (float*)b2;
  float *cp = (float*)costs, *sp = (float*)shares;
  Dims d{B, IN, H, OUT};
  Plan p;
  CUtensorMap map, tail;
  cudaError_t err = plan_or_refuse(d, bf16 ? 2 : 4, p);
  if (err == cudaSuccess) err = x_maps(xs, steps * B, d, bf16 ? 2 : 4, map, tail);
  if (err != cudaSuccess) return (int)err;
  if (bf16) {
    const __nv_bfloat16* xp = (const __nv_bfloat16*)xs;
    const __nv_bfloat16* yp = (const __nv_bfloat16*)ys;
    void* args[] = {&xp, &map, &tail, &yp, &w1p, &b1p, &w2p, &b2p, &cp, &sp, &steps, &d, &p, &lr};
    return (int)coop_launch((const void*)mlp_epoch_kernel<__nv_bfloat16>, ks16, d, p, args,
                            (cudaStream_t)stream);
  }
  const float* xp = (const float*)xs;
  const float* yp = (const float*)ys;
  void* args[] = {&xp, &map, &tail, &yp, &w1p, &b1p, &w2p, &b2p, &cp, &sp, &steps, &d, &p, &lr};
  return (int)coop_launch((const void*)mlp_epoch_kernel<float>, ks32, d, p, args,
                          (cudaStream_t)stream);
}

#ifdef MLP_PROBE
// The barrier probes: a step's exchange of logits shares alone, n floats a
// CTA, `steps` times, between CTAs that each hold PROBE_SMEM bytes of shared
// memory (one a SM, as the kernels above):
//   (a) probe_grid_kernel: through global memory, the cooperative grid
//       barrier and sum_shares, as sgd_step;
//   (b) probe_cluster_kernel: one thread-block cluster of every CTA, the
//       shares in each CTA's shared memory (double-buffered by step parity),
//       a cluster barrier, and the sum over the cluster's ranks in rank
//       order through distributed shared memory.
// out[t] (CTA 0) keeps the sums alive.
namespace {

constexpr int PROBE_SMEM = 150 * 1024;

__global__ void __launch_bounds__(NTHREADS, 1)
    probe_grid_kernel(float* shares, float* out, int steps, int n) {
  cg::grid_group grid = cg::this_grid();
  float total = 0.f;
  for (int step = 0; step < steps; ++step) {
    float* buf = shares + (size_t)(step & 1) * gridDim.x * n;
    for (int t = threadIdx.x; t < n; t += NTHREADS)
      __stcg(buf + (size_t)blockIdx.x * n + t, (float)(t + step + blockIdx.x));
    grid.sync();
    for (int t = 2 * threadIdx.x; t < n; t += 2 * NTHREADS) {
      const float2 v = sum_shares(buf, n, t);
      total += v.x + v.y;
    }
  }
  if (blockIdx.x == 0) out[threadIdx.x] = total;
}

__global__ void __launch_bounds__(NTHREADS, 1) probe_cluster_kernel(float* out, int steps, int n) {
  extern __shared__ __align__(16) char smem[];
  float* sh = (float*)smem;  // [2][n]
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  float total = 0.f;
  for (int step = 0; step < steps; ++step) {
    float* buf = sh + (step & 1) * n;
    for (int t = threadIdx.x; t < n; t += NTHREADS) buf[t] = (float)(t + step + rank);
    cluster.sync();
    for (int t = threadIdx.x; t < n; t += NTHREADS) {
      float v[16];
      float acc = 0.f;
      for (int c0 = 0; c0 < nblk; c0 += 16) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          v[i] = c0 + i < nblk ? *cluster.map_shared_rank(buf + t, c0 + i) : 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (c0 + i < nblk) acc += v[i];
      }
      total += acc;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
  if (rank == 0 && blockIdx.x == 0) out[threadIdx.x] = total;
}

}  // namespace

// One launch of probe (a) (cluster = 0, a cooperative grid of nblk CTAs;
// `shares` holds 2 * nblk * n floats, n even) or (b) (cluster = 1, one cluster of
// nblk <= 16 CTAs); out holds NTHREADS floats.
extern "C" int probe_exchange(int cluster, int nblk, int n, int steps, void* shares, void* out,
                              void* stream) {
  float *sp = (float*)shares, *op = (float*)out;
  if (2 * n * 4 > PROBE_SMEM) return (int)cudaErrorInvalidValue;
  if (!cluster) {
    const void* k = (const void*)probe_grid_kernel;
    cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, PROBE_SMEM);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&sp, &op, &steps, &n};
    err = cudaLaunchCooperativeKernel(k, dim3(nblk), dim3(NTHREADS), args, PROBE_SMEM,
                                      (cudaStream_t)stream);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(probe_cluster_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PROBE_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = PROBE_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, probe_cluster_kernel, &cfg)) != cudaSuccess)
    return (int)err;
  if (clusters < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchKernelEx(&cfg, probe_cluster_kernel, op, steps, n);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
#endif
