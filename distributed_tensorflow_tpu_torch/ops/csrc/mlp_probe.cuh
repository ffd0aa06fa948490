// Phase stamps of the MLP kernels, compiled only into their probe builds
// (-DMLP_PROBE, ops/_build.py PROBES; chip_smoke.py phase 7 reads them).
//
// MLP_STAMP(k) ends phase k of a step: every thread of the CTA meets at a
// __syncthreads, then thread 0 of CTA 0 adds the SM cycles since the last
// stamp to slot k. The kernels place their own barriers; a stamp's is
// extra, so that a phase without one ends when its last thread does.
// mlp_split_begin/end bracket the kernel; end copies the slots, the
// kernel's cycles and its globaltimer nanoseconds (which give the cycle
// rate) to g_mlp_split, which the host reads with mlp_split(). Without
// MLP_PROBE the three are empty. MLP_PROBE_SMEM is the room a launcher
// leaves in a CTA's shared memory for the stamps' static array (0 outside
// the probe builds).
#pragma once

#ifdef MLP_PROBE
constexpr int MLP_SPLIT_SLOTS = 12;
constexpr int MLP_PROBE_SMEM = 1024;

__device__ unsigned long long g_mlp_split[MLP_SPLIT_SLOTS + 2];

// [0, SLOTS): cycles per phase; [SLOTS]: the last stamp's clock;
// [SLOTS + 1]: the kernel's first clock; [SLOTS + 2]: its first globaltimer.
__device__ __forceinline__ unsigned long long* mlp_split_smem() {
  __shared__ unsigned long long s[MLP_SPLIT_SLOTS + 3];
  return s;
}

__device__ __forceinline__ unsigned long long mlp_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mlp_split_begin() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long* s = mlp_split_smem();
    for (int k = 0; k < MLP_SPLIT_SLOTS; ++k) s[k] = 0;
    s[MLP_SPLIT_SLOTS + 2] = mlp_globaltimer();
    s[MLP_SPLIT_SLOTS] = s[MLP_SPLIT_SLOTS + 1] = clock64();
  }
}

#define MLP_STAMP(k)                                                   \
  do {                                                                 \
    __syncthreads();                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                         \
      unsigned long long* s_ = mlp_split_smem();                       \
      const unsigned long long t_ = clock64();                         \
      s_[k] += t_ - s_[MLP_SPLIT_SLOTS];                               \
      s_[MLP_SPLIT_SLOTS] = t_;                                        \
    }                                                                  \
  } while (0)

__device__ __forceinline__ void mlp_split_end() {
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long* s = mlp_split_smem();
    for (int k = 0; k < MLP_SPLIT_SLOTS; ++k) g_mlp_split[k] = s[k];
    g_mlp_split[MLP_SPLIT_SLOTS] = clock64() - s[MLP_SPLIT_SLOTS + 1];
    g_mlp_split[MLP_SPLIT_SLOTS + 1] = mlp_globaltimer() - s[MLP_SPLIT_SLOTS + 2];
  }
}

// Probe switches, set by mlp_probe_flags() before a launch: MLP_SKIP_COPIES
// issues only the first fill of each slot, so later steps compute on stale
// x and the split shows the step without its copies.
constexpr int MLP_SKIP_COPIES = 1;
__device__ int g_mlp_probe_flags;

extern "C" int mlp_probe_flags(int flags) {
  return (int)cudaMemcpyToSymbol(g_mlp_probe_flags, &flags, sizeof(int));
}

// The last probe launch's split: SLOTS phase cycle counts, then the
// kernel's cycles and nanoseconds (CTA 0). Synchronises the device.
extern "C" int mlp_split(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, g_mlp_split, sizeof(g_mlp_split));
}
#else
constexpr int MLP_PROBE_SMEM = 0;
#define MLP_STAMP(k) \
  do {               \
  } while (0)
__device__ __forceinline__ void mlp_split_begin() {}
__device__ __forceinline__ void mlp_split_end() {}
#endif
