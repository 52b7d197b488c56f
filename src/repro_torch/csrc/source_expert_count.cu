// Source-aware expert statistics: B[e] and A[s, e] in one pass.
//
// Replaces: src/repro/kernels/source_expert_count.py::_kernel
// (source_expert_count), which builds one-hot tiles and accumulates them on
// the TPU's matrix unit because a TPU has no atomics.
//
// Computes, over expert_idx (T, K) and source_ids (T,):
//   B[e]    = #{(t, k) : expert_idx[t, k] == e}
//   A[s, e] = #{(t, k) : expert_idx[t, k] == e and source_ids[t] == s}
// Ids outside [0, E) and sources outside [0, S) count nowhere; B counts a
// valid expert id whatever its source.
//
// Bound on an H100: the bytes of the ids, 4 B per slot plus 4 B per token;
// one compare and one add per slot.
//
// Design: the paper's atomics formulation. Each block keeps an (S + 1) x E
// int32 histogram in shared memory (row S holds B), walks its share of the
// slots with a grid-stride loop and counts with shared-memory atomicAdd,
// then flushes its non-zero bins into the outputs with global atomicAdd.
// Integer atomics are exact, so the result does not depend on their order.
// The launcher zeroes B and A on the stream before the kernel runs.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 264;   // two per SM on an H100

__global__ void __launch_bounds__(THREADS)
source_expert_count_kernel(const int* __restrict__ expert_idx,
                           const int* __restrict__ source_ids,
                           int* __restrict__ b_out, int* __restrict__ a_out,
                           int n_slots, int K, int E, int S) {
  extern __shared__ int bins[];          // [S + 1][E]
  const int n_bins = (S + 1) * E;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_slots;
       i += gridDim.x * blockDim.x) {
    const int e = expert_idx[i];
    if (e < 0 || e >= E) continue;
    atomicAdd(&bins[S * E + e], 1);
    const int s = source_ids[i / K];
    if (s >= 0 && s < S) atomicAdd(&bins[s * E + e], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int c = bins[i];
    if (c) atomicAdd(i < S * E ? &a_out[i] : &b_out[i - S * E], c);
  }
}

}  // namespace

// Returns the cudaError_t of the memsets and the launch.
extern "C" int source_expert_count_launch(const void* expert_idx,
                                          const void* source_ids,
                                          void* b_out, void* a_out, int T,
                                          int K, int E, int S, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(b_out, 0, sizeof(int) * (size_t)E, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(a_out, 0, sizeof(int) * (size_t)S * E, s);
  if (err != cudaSuccess) return (int)err;
  const int n_slots = T * K;
  if (n_slots == 0 || E == 0) return 0;
  const size_t smem = sizeof(int) * (size_t)(S + 1) * E;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(source_expert_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (n_slots + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  source_expert_count_kernel<<<blocks, THREADS, smem, s>>>(
      static_cast<const int*>(expert_idx),
      static_cast<const int*>(source_ids), static_cast<int*>(b_out),
      static_cast<int*>(a_out), n_slots, K, E, S);
  return (int)cudaGetLastError();
}

extern "C" const char* source_expert_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
