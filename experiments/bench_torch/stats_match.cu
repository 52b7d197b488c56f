// A variant of the single-block path of
// src/repro_torch/csrc/source_expert_count.cu with warp-aggregated counting,
// kept for experiments/bench_torch/stats_paths.py, which times it beside the
// two paths the port runs. Not built or called by the port.
//
// Same semantics: B[e] and A[s, e] over expert_idx (T, K) and source_ids
// (T,); ids outside [0, E) and sources outside [0, S) count nowhere. One
// block of 1024 threads keeps the (S + 1) x E bins in shared memory; for
// each of its slots a warp groups the lanes that hold one bin with
// __match_any_sync and the group's first lane adds the group's size with
// one atomicAdd. Then every bin is stored with a plain store.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int PER_LANE = 4;

__global__ void __launch_bounds__(THREADS)
stats_match_block(const int* __restrict__ ids, const int* __restrict__ src,
                  int* __restrict__ b_out, int* __restrict__ a_out,
                  int n_slots, int K, int E, int S) {
  extern __shared__ int bins[];          // [S + 1][E]
  const int n_bins = (S + 1) * E;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int base = (threadIdx.x - lane) * PER_LANE; base < n_slots;
       base += blockDim.x * PER_LANE) {
    int e[PER_LANE], s[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int i = base + 32 * j + lane;
      e[j] = i < n_slots ? ids[i] : -1;
      s[j] = i < n_slots ? src[i / K] : -1;
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const bool ok = e[j] >= 0 && e[j] < E;
      const int eb = ok ? S * E + e[j] : -1;
      const int sb = ok && s[j] >= 0 && s[j] < S ? s[j] * E + e[j] : -1;
      unsigned peers = __match_any_sync(0xffffffffu, eb);
      if (eb >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&bins[eb], __popc(peers));
      peers = __match_any_sync(0xffffffffu, sb);
      if (sb >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&bins[sb], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    if (i < S * E)
      a_out[i] = bins[i];
    else
      b_out[i - S * E] = bins[i];
  }
}

}  // namespace

extern "C" int stats_match_launch(const void* expert_idx,
                                  const void* source_ids, void* b_out,
                                  void* a_out, int T, int K, int E, int S,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 0 || K <= 0 || E <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)(S + 1) * E;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stats_match_block,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  stats_match_block<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(expert_idx), static_cast<const int*>(source_ids),
      static_cast<int*>(b_out), static_cast<int*>(a_out), T * K, K, E, S);
  return (int)cudaGetLastError();
}
