// The PR-2 design of the MLP epoch kernel (25 CTAs of 4 hidden units, x
// read from global memory by the forward and again by dW1, logits shares
// summed after a grid sync), kept with phase stamps (mlp_probe.cuh) so that
// chip_smoke.py phase 7 can print its split of a step beside the current
// kernel's (fused_mlp.cu). Built only as the probe module
// "fused_mlp_v1_probe" (ops/_build.py PROBES, -DMLP_PROBE); nothing in the
// package calls it.
//
// Phases (MLP_STAMP slots): 0 forward, 1 logits share, 2 grid barrier and
// share sum, 3 softmax, 4 dz1/db2/cost, 5 update W2/b1/b2, 6 dW1 and W1.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mlp_probe.cuh"

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
  MLP_STAMP(0);

  // This CTA's share of the logits, h[:, J] W2[J, :].
  for (int t = tid; t < BO; t += NTHREADS) {
    const int b = t / OUT, k = t % OUT;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < HC; ++j) acc = fmaf(s.h[b * HC + j], s.w2[j * OUT + k], acc);
    __stcg(share + t, acc);
  }
  MLP_STAMP(1);
  grid.sync();

  // logits = the shares summed in CTA order, + b2 (read through L2: other
  // SMs wrote them).
  for (int t = tid; t < BO; t += NTHREADS) {
    float acc = 0.f;
    for (int c = 0; c < (int)gridDim.x; ++c) acc += __ldcg(shares + (size_t)c * BO + t);
    s.dl[t] = acc + s.b2[t % OUT];
  }
  MLP_STAMP(2);

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
  MLP_STAMP(3);

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
  MLP_STAMP(4);

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
  MLP_STAMP(5);
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
  MLP_STAMP(6);
  return cost;
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
  mlp_split_begin();
  load_params(s, d, j0, w1, b1, w2, b2);
  for (int step = 0; step < steps; ++step) {
    float* buf = shares + (size_t)(step & 1) * gridDim.x * bo;
    const float c = sgd_step<T>(s, d, j0, xs + (size_t)step * bi, ys + (size_t)step * bo,
                                buf + (size_t)blockIdx.x * bo, buf, lr, grid);
    if (blockIdx.x == 0 && threadIdx.x == 0) costs[step] = c;
  }
  store_params(s, d, j0, w1, b1, w2, b2);
  mlp_split_end();
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

// Floats of the share buffer of an epoch launch: B * OUT for each CTA,
// twice (the step parities).
extern "C" int mlp_workspace(int B, int IN, int H, int OUT, int bf16) {
  return 2 * num_blocks(H) * B * OUT;
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
