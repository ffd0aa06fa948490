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
// Design. The Pallas kernels keep x, W1 and W2 in VMEM at once; W1 alone is
// 784*100*4 = 313,600 bytes, more than the 227 KB one CTA may hold. So the
// HIDDEN units are split across CTAs: CTA c owns hidden units
// J = [4c, 4c+4) and holds W1[:,J] (transposed, so lanes read neighbouring
// inputs), b1[J], W2[J,:] and its own copy of b2 in shared memory. With
// those it computes z1[:,J], h[:,J], dz1[:,J], dW1[:,J] and dW2[J,:]
// locally. The one dependency between CTAs is
// logits = sum_J h[:,J] W2[J,:] ([B, OUT]): each CTA writes its share to
// global memory, the grid synchronises (cooperative launch, so every CTA is
// co-resident), and every CTA sums the shares in CTA order (no float
// atomics), so all CTAs hold the same logits bit for bit and compute the
// softmax, the cost and db2 redundantly; their b2 copies stay identical.
// The shares are double-buffered by step parity: a CTA that runs ahead into
// step i+1 writes the other buffer, and it cannot reach step i+2's write
// before every CTA has passed step i+1's barrier, i.e. finished reading
// step i's shares. x is read from global memory (L2) twice per step, by the
// forward and by dW1, and upcast to f32 in registers (exact for bf16).
//
// b2 in the in-place step kernel: every CTA reads b2 when it loads its
// parameters, before the grid barrier; only CTA 0 writes the new b2, after
// that barrier, so no CTA can read a b2 that was already updated.
//
// Bound. One step at B=100, 784->100->10 does 2*100*(784*100*2 + 100*10*3)
// = 31.96 MFLOP: 0.477 us at the H100's 67 TFLOP/s f32 (CUDA cores; the
// update math is f32 as on the TPU). It moves ~1 MB (x in f32, parameters
// read and written): 0.28 us at 3.35 TB/s. So both kernels are bound by
// operations. At batch 100 every step is small and the steps are serial,
// so latency rules: on an H100 a step of the epoch kernel takes ~53 us, of
// which ~5.5 us is the grid barrier with the share reduction and most of
// the rest the two chains of dependent loads over x (PERF.md). This design
// does nothing about that yet; a later one stages x in shared memory and
// issues its loads ahead.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int HC = 4;         // hidden units owned by one CTA
constexpr int MAX_OUT = 32;   // the softmax gives one lane to each class
constexpr float LOG_EPS = 1e-30f;

typedef __nv_bfloat16 bf16;

struct Dims {
  int B, IN, H, OUT;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

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

// W - lr*dW rounded as the reference rounds it: the product, then the
// difference (no fused multiply-add).
__device__ __forceinline__ float sgd(float w, float lr, float g) {
  return __fsub_rn(w, __fmul_rn(lr, g));
}

// One CTA's shared memory, in floats.
struct Smem {
  float* w1;    // [HC][IN]  W1[:, j0 + j], transposed
  float* b1;    // [HC]
  float* w2;    // [HC][OUT] W2[j0 + j, :]
  float* b2;    // [OUT]     this CTA's copy
  float* h;     // [B][HC]
  float* dz1;   // [B][HC]
  float* dl;    // [B][OUT]  logits, then dlogits
  float* db2;   // [OUT]
  float* crow;  // [B]       per-example cost
};

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return (size_t)HC * d.IN + HC + (size_t)HC * d.OUT + d.OUT + 2 * (size_t)d.B * HC +
         (size_t)d.B * d.OUT + d.OUT + d.B;
}

__device__ Smem carve(float* p, const Dims& d) {
  Smem s;
  s.w1 = p; p += (size_t)HC * d.IN;
  s.b1 = p; p += HC;
  s.w2 = p; p += (size_t)HC * d.OUT;
  s.b2 = p; p += d.OUT;
  s.h = p; p += (size_t)d.B * HC;
  s.dz1 = p; p += (size_t)d.B * HC;
  s.dl = p; p += (size_t)d.B * d.OUT;
  s.db2 = p; p += d.OUT;
  s.crow = p;
  return s;
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

// One SGD step on the batch (x [B, IN], y [B, OUT]) with this CTA's
// parameters in shared memory. `share` is this CTA's [B*OUT] slot of the
// step's share buffer `shares` ([gridDim.x][B*OUT]). Returns the cost on
// thread 0 (other threads return 0).
template <typename T>
__device__ float sgd_step(const Smem& s, const Dims& d, int j0, const T* __restrict__ x,
                          const T* __restrict__ y, float* share, const float* shares, float lr,
                          cg::grid_group& grid) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = d.B, IN = d.IN, OUT = d.OUT, BO = d.B * d.OUT;
  const int nvalid = min(HC, d.H - j0);
  const float inv_b = 1.0f / (float)B;

  // z1[:, J] and h[:, J]: one warp per example, lanes over the inputs.
  for (int b = warp; b < B; b += NWARPS) {
    const T* xr = x + (size_t)b * IN;
    float acc[HC];
#pragma unroll
    for (int j = 0; j < HC; ++j) acc[j] = 0.f;
    for (int i = lane; i < IN; i += 32) {
      const float xv = ld(xr + i);
#pragma unroll
      for (int j = 0; j < HC; ++j) acc[j] = fmaf(xv, s.w1[j * IN + i], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < HC; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < HC; ++j)
        s.h[b * HC + j] = j < nvalid ? 1.f / (1.f + expf(-(acc[j] + s.b1[j]))) : 0.f;
    }
  }
  __syncthreads();

  // This CTA's share of the logits, h[:, J] W2[J, :].
  for (int t = tid; t < BO; t += NTHREADS) {
    const int b = t / OUT, k = t % OUT;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < HC; ++j) acc = fmaf(s.h[b * HC + j], s.w2[j * OUT + k], acc);
    __stcg(share + t, acc);
  }
  grid.sync();

  // logits = the shares summed in CTA order, + b2 (read through L2: other
  // SMs wrote them).
  for (int t = tid; t < BO; t += NTHREADS) {
    float acc = 0.f;
    for (int c = 0; c < (int)gridDim.x; ++c) acc += __ldcg(shares + (size_t)c * BO + t);
    s.dl[t] = acc + s.b2[t % OUT];
  }
  __syncthreads();

  // softmax, the naive cross entropy and dlogits: one warp per example,
  // one lane per class.
  for (int b = warp; b < B; b += NWARPS) {
    const bool on = lane < OUT;
    const float l = on ? s.dl[b * OUT + lane] : __int_as_float((int)0xff800000u);  // -inf
    const float m = warp_max(l);
    const float e = on ? expf(l - m) : 0.f;
    const float p = e / warp_sum(e);
    const float yv = on ? ld(y + (size_t)b * OUT + lane) : 0.f;
    const float c = warp_sum(on ? yv * logf(fmaxf(p, LOG_EPS)) : 0.f);
    if (on) s.dl[b * OUT + lane] = (p - yv) * inv_b;
    if (lane == 0) s.crow[b] = -c;
  }
  __syncthreads();

  // The gradients that read W2 before it changes: dz1 and db2; the cost.
  for (int t = tid; t < B * HC; t += NTHREADS) {
    const int b = t / HC, j = t % HC;
    float acc = 0.f;
    for (int k = 0; k < OUT; ++k) acc = fmaf(s.dl[b * OUT + k], s.w2[j * OUT + k], acc);
    const float hv = s.h[t];
    s.dz1[t] = acc * hv * (1.f - hv);
  }
  if (tid < OUT) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += s.dl[b * OUT + tid];
    s.db2[tid] = acc;
  }
  float cost = 0.f;
  if (tid == 0) {
    for (int b = 0; b < B; ++b) cost += s.crow[b];
    cost *= inv_b;
  }
  __syncthreads();

  // The update: W2[J, :], b1[J], b2 (every CTA its own copy), W1[:, J].
  for (int t = tid; t < HC * OUT; t += NTHREADS) {
    const int j = t / OUT, k = t % OUT;
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc = fmaf(s.h[b * HC + j], s.dl[b * OUT + k], acc);
    s.w2[t] = sgd(s.w2[t], lr, acc);
  }
  if (tid < HC) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += s.dz1[b * HC + tid];
    s.b1[tid] = sgd(s.b1[tid], lr, acc);
  }
  if (tid < OUT) s.b2[tid] = sgd(s.b2[tid], lr, s.db2[tid]);
  for (int i = tid; i < IN; i += NTHREADS) {
    float acc[HC];
#pragma unroll
    for (int j = 0; j < HC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      const float xv = ld(x + (size_t)b * IN + i);
#pragma unroll
      for (int j = 0; j < HC; ++j) acc[j] = fmaf(xv, s.dz1[b * HC + j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < HC; ++j) s.w1[j * IN + i] = sgd(s.w1[j * IN + i], lr, acc[j]);
  }
  __syncthreads();
  return cost;
}

__global__ void __launch_bounds__(NTHREADS)
    mlp_step_kernel(const float* __restrict__ x, const float* __restrict__ y, float* w1,
                    float* b1, float* w2, float* b2, float* cost, float* shares, Dims d,
                    float lr) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const Smem s = carve(smem, d);
  const int j0 = blockIdx.x * HC;
  load_params(s, d, j0, w1, b1, w2, b2);
  const float c = sgd_step<float>(s, d, j0, x, y, shares + (size_t)blockIdx.x * d.B * d.OUT,
                                  shares, lr, grid);
  if (blockIdx.x == 0 && threadIdx.x == 0) cost[0] = c;
  store_params(s, d, j0, w1, b1, w2, b2);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    mlp_epoch_kernel(const T* __restrict__ xs, const T* __restrict__ ys, float* w1, float* b1,
                     float* w2, float* b2, float* costs, float* shares, int steps, Dims d,
                     float lr) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const Smem s = carve(smem, d);
  const int j0 = blockIdx.x * HC;
  const size_t bo = (size_t)d.B * d.OUT, bi = (size_t)d.B * d.IN;
  load_params(s, d, j0, w1, b1, w2, b2);
  for (int step = 0; step < steps; ++step) {
    float* buf = shares + (size_t)(step & 1) * gridDim.x * bo;
    const float c = sgd_step<T>(s, d, j0, xs + (size_t)step * bi, ys + (size_t)step * bo,
                                buf + (size_t)blockIdx.x * bo, buf, lr, grid);
    if (blockIdx.x == 0 && threadIdx.x == 0) costs[step] = c;
  }
  store_params(s, d, j0, w1, b1, w2, b2);
}

int num_blocks(int H) { return (H + HC - 1) / HC; }

// Cooperative launch of `kernel` over num_blocks(H) CTAs; refuses a grid
// that cannot be co-resident (the grid barrier would never complete).
cudaError_t coop_launch(const void* kernel, const Dims& d, void** args, cudaStream_t stream) {
  if (d.B < 1 || d.IN < 1 || d.H < 1 || d.OUT < 1 || d.OUT > MAX_OUT) return cudaErrorInvalidValue;
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  const int nblk = num_blocks(d.H);
  if (per_sm * nsm < nblk) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblk), dim3(NTHREADS), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// CTAs of a launch for H hidden units; the share buffer holds
// mlp_blocks(H) * B * OUT floats for a step, twice that for an epoch.
extern "C" int mlp_blocks(int H) { return num_blocks(H); }

extern "C" int mlp_step(const void* x, const void* y, void* w1, void* b1, void* w2, void* b2,
                        void* cost, void* shares, int B, int IN, int H, int OUT, float lr,
                        void* stream) {
  const float* xp = (const float*)x;
  const float* yp = (const float*)y;
  float *w1p = (float*)w1, *b1p = (float*)b1, *w2p = (float*)w2, *b2p = (float*)b2;
  float *cp = (float*)cost, *sp = (float*)shares;
  Dims d{B, IN, H, OUT};
  void* args[] = {&xp, &yp, &w1p, &b1p, &w2p, &b2p, &cp, &sp, &d, &lr};
  return (int)coop_launch((const void*)mlp_step_kernel, d, args, (cudaStream_t)stream);
}

// `bf16` selects the stream type of xs/ys: 1 = bfloat16, 0 = float32.
extern "C" int mlp_epoch(const void* xs, const void* ys, int bf16, void* w1, void* b1, void* w2,
                         void* b2, void* costs, void* shares, int steps, int B, int IN, int H,
                         int OUT, float lr, void* stream) {
  float *w1p = (float*)w1, *b1p = (float*)b1, *w2p = (float*)w2, *b2p = (float*)b2;
  float *cp = (float*)costs, *sp = (float*)shares;
  Dims d{B, IN, H, OUT};
  if (bf16) {
    const __nv_bfloat16* xp = (const __nv_bfloat16*)xs;
    const __nv_bfloat16* yp = (const __nv_bfloat16*)ys;
    void* args[] = {&xp, &yp, &w1p, &b1p, &w2p, &b2p, &cp, &sp, &steps, &d, &lr};
    return (int)coop_launch((const void*)mlp_epoch_kernel<__nv_bfloat16>, d, args,
                            (cudaStream_t)stream);
  }
  const float* xp = (const float*)xs;
  const float* yp = (const float*)ys;
  void* args[] = {&xp, &yp, &w1p, &b1p, &w2p, &b2p, &cp, &sp, &steps, &d, &lr};
  return (int)coop_launch((const void*)mlp_epoch_kernel<float>, d, args, (cudaStream_t)stream);
}
