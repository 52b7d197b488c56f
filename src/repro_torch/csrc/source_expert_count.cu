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
// valid expert id whatever its source. The counts do not depend on the
// order of the slots, so the caller passes the router's ids unsorted.
//
// Bound on an H100: the bytes of the ids, 4 B per slot plus 4 B per token,
// are nanoseconds at serving sizes (2048 slots: 16 KB). What a call costs
// there is its launches: the launch, and any memset before it.
//
// Design. Both paths keep an (S + 1) x E int32 histogram in shared memory
// (row S holds B) and count with shared-memory atomicAdd; integer atomics
// are exact, so the result does not depend on their order. A lane loads
// PER_LANE slots before it counts any, so their latencies overlap.
// - One block (T * K at most the caller's single-block limit,
//   SINGLE_BLOCK_SLOTS in kernels/source_expert_count.py, set by
//   measurement on an H100): 1024 threads zero the bins,
//   count, and store every bin of B and A with plain stores. One launch,
//   no memset, no global atomics.
// - A grid (larger T * K): the launcher zeroes B and A on the stream; each
//   block walks its share of the slots with a grid-stride loop, counts the
//   same way, and flushes its non-zero bins with global atomicAdd.
// Warp-aggregated counting (__match_any_sync on the bin, one atomicAdd per
// distinct bin of a warp) was measured on an H100 and left out: the match
// costs more than the contended atomics it saves, for skewed ids too (one
// block, 2048 slots, device time: 6.2 against 2.3 us with random ids, 3.4
// against 2.2 with 3 of 4 slots on one expert, 2.9 against 2.3 with every
// slot on one; experiments/bench_torch/stats_paths.py, PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 264;   // two per SM on an H100
constexpr int ONE_BLOCK_THREADS = 1024;

constexpr int PER_LANE = 4;       // slots a lane loads before counting

// Counts the warp's next 32 * PER_LANE slots from base: lane l takes slots
// base + 32 * j + l. It loads all of its ids and sources first, so their
// latencies overlap, then adds each valid slot to its expert bin (row S of
// bins) and, with a valid source, to its source bin.
__device__ __forceinline__ void count_slots(int* bins, int base, int n_slots,
                                            const int* __restrict__ ids,
                                            const int* __restrict__ src,
                                            int K, int E, int S, int lane) {
  int e[PER_LANE], s[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int i = base + 32 * j + lane;
    e[j] = i < n_slots ? ids[i] : -1;
    s[j] = i < n_slots ? src[i / K] : -1;
  }
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    if (e[j] < 0 || e[j] >= E) continue;
    atomicAdd(&bins[S * E + e[j]], 1);
    if (s[j] >= 0 && s[j] < S) atomicAdd(&bins[s[j] * E + e[j]], 1);
  }
}

__global__ void __launch_bounds__(ONE_BLOCK_THREADS)
source_expert_count_block(const int* __restrict__ expert_idx,
                          const int* __restrict__ source_ids,
                          int* __restrict__ b_out, int* __restrict__ a_out,
                          int n_slots, int K, int E, int S) {
  extern __shared__ int bins[];          // [S + 1][E]
  const int n_bins = (S + 1) * E;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int base = (threadIdx.x - lane) * PER_LANE; base < n_slots;
       base += blockDim.x * PER_LANE)
    count_slots(bins, base, n_slots, expert_idx, source_ids, K, E, S, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    if (i < S * E)
      a_out[i] = bins[i];
    else
      b_out[i - S * E] = bins[i];
  }
}

__global__ void __launch_bounds__(THREADS)
source_expert_count_grid(const int* __restrict__ expert_idx,
                         const int* __restrict__ source_ids,
                         int* __restrict__ b_out, int* __restrict__ a_out,
                         int n_slots, int K, int E, int S) {
  extern __shared__ int bins[];          // [S + 1][E]
  const int n_bins = (S + 1) * E;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int base = (blockIdx.x * blockDim.x + threadIdx.x - lane) * PER_LANE;
       base < n_slots; base += gridDim.x * blockDim.x * PER_LANE)
    count_slots(bins, base, n_slots, expert_idx, source_ids, K, E, S, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int c = bins[i];
    if (c) atomicAdd(i < S * E ? &a_out[i] : &b_out[i - S * E], c);
  }
}

}  // namespace

// T * K slots at most single_block_slots: one block, one launch; more: the
// memsets and the grid. Returns the cudaError_t of the memsets and the
// launch.
extern "C" int source_expert_count_launch(const void* expert_idx,
                                          const void* source_ids,
                                          void* b_out, void* a_out, int T,
                                          int K, int E, int S,
                                          int single_block_slots, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 0 || K <= 0 || E <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_slots = T * K;
  const size_t smem = sizeof(int) * (size_t)(S + 1) * E;
  const bool one_block = n_slots <= single_block_slots;
  auto kernel = one_block ? source_expert_count_block
                          : source_expert_count_grid;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int* ids = static_cast<const int*>(expert_idx);
  const int* src = static_cast<const int*>(source_ids);
  int* b = static_cast<int*>(b_out);
  int* a = static_cast<int*>(a_out);
  if (one_block) {                       // stores every bin, even at T = 0
    source_expert_count_block<<<1, ONE_BLOCK_THREADS, smem, s>>>(
        ids, src, b, a, n_slots, K, E, S);
    return (int)cudaGetLastError();
  }
  err = cudaMemsetAsync(b_out, 0, sizeof(int) * (size_t)E, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(a_out, 0, sizeof(int) * (size_t)S * E, s);
  if (err != cudaSuccess) return (int)err;
  if (n_slots == 0) return 0;
  const int per_block = THREADS * PER_LANE;
  int blocks = (n_slots + per_block - 1) / per_block;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  source_expert_count_grid<<<blocks, THREADS, smem, s>>>(ids, src, b, a,
                                                         n_slots, K, E, S);
  return (int)cudaGetLastError();
}

extern "C" const char* source_expert_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
