// Grouped expert GEMMs of the MoE FFN, two entry points sharing one
// device-side inner loop (gmm_rows below).
//
// 1. moe_gmm_launch: the group-sized ragged GEMM over tokens sorted by
//    expert. Replaces src/repro/kernels/moe_gmm.py::_ragged_kernel
//    (moe_gmm_ragged).
//
//    x (Np, D) holds the dispatched token rows grouped by physical expert,
//    each group starting on a multiple of the row tile nb
//    (kernels/moe_dispatch.py). Row tile n belongs to expert tile_expert[n];
//    out (Np, F) f32 is
//      out[r] = x[r] . w[e]  for rows r of a live tile with r - poff[e] < size[e]
//      out[r] = 0            otherwise
//    where a tile is live iff its first row is below poff[E] and below
//    poff[e] + size[e] (the same skip rule as the Pallas kernel). The kernel
//    writes every output row itself, zeros included: the wrapper allocates
//    the output with torch.empty, where the TPU kernel relied on zeroed
//    blocks.
//
// 2. moe_gmm_padded_launch: the capacity-padded batched GEMM
//    out[e] = x[e] . w[e], x (E, C, D), w (E, D, F), out (E, C, F) f32.
//    Replaces src/repro/kernels/moe_gmm.py::_kernel (moe_gmm). The Pallas
//    wrapper zero-pads C, D and F up to its block multiples and slices the
//    result; here the kernel masks the edges of C, D and F itself, reads no
//    padded copy and writes every output element.
//
// Bound on an H100: at decode the bytes of the weights read (the ragged
// GEMM reads the experts actually hit, up to 64 distinct experts x 2048 x
// 768 x 2 B = 200 MB per GEMM at 8 lanes x top-8; the padded GEMM reads all
// E experts' weights, 402 MB per GEMM in bf16); at prefill the
// multiply-adds, 2 x rows x D x F.
//
// Design: a block owns R rows of one expert and 128 output columns, one
// column per thread with R f32 accumulators. x rows are staged in shared
// memory 64 deep and broadcast to every thread; each thread streams its own
// weight column from device memory, neighbouring threads on neighbouring
// addresses, so each weight element is read once per R rows. The ragged
// kernel uses R = 8 (nb is a multiple of 8, so the 8 rows share one
// expert); dead ragged blocks write zeros and read nothing. The padded
// kernel picks R = 8, 16 or 32 from C, with the row tiles of one expert's
// column tile adjacent in the grid, so their weight reads meet in L2.
// Below 4096 token-slots pick_row_block gives nb=8 at E=128, so the ragged
// decode and most prefill run 8-row tiles and an expert with many rows
// re-reads its weights once per 8 rows. A later kernel should tile per
// expert group instead of per nb-row tile, and move the product to wgmma
// with TMA-fed shared-memory tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;
constexpr int COLS = 128;      // = threads per block
constexpr int KC = 64;         // depth staged in shared memory per step

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Accumulates acc[r] += x[r] . w[:, f] for the first n_rows rows of the
// tile at x (row stride D; rows past n_rows read as 0) and the expert's
// weights w (D, F). Every thread of the block calls it (it holds barriers).
template <typename T, int R>
__device__ __forceinline__ void gmm_rows(const T* __restrict__ x,
                                         const T* __restrict__ w, int D,
                                         int F, int n_rows, int f,
                                         float (&acc)[R], float (*xs)[KC]) {
  for (int d0 = 0; d0 < D; d0 += KC) {
    const int kc = min(KC, D - d0);
    for (int i = threadIdx.x; i < R * KC; i += blockDim.x) {
      const int r = i / KC, d = i - r * KC;
      xs[r][d] = (d < kc && r < n_rows) ? to_f(x[(size_t)r * D + d0 + d])
                                        : 0.f;
    }
    __syncthreads();
    if (f < F) {
      const T* wc = w + (size_t)d0 * F + f;
#pragma unroll 8
      for (int d = 0; d < kc; ++d) {
        const float wv = to_f(wc[(size_t)d * F]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xs[r][d], wv, acc[r]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(COLS)
gmm_ragged_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ tile_expert,
                  const int* __restrict__ group_sizes,
                  const int* __restrict__ poff, float* __restrict__ out,
                  int D, int F, int E, int nb) {
  __shared__ float xs[ROWS][KC];
  const int r0 = blockIdx.x * ROWS;
  const int f = blockIdx.y * COLS + threadIdx.x;
  const int n = r0 / nb;
  const int e = tile_expert[n];
  const int tile_row0 = n * nb;
  const int gstart = poff[e], gsize = group_sizes[e];
  const bool live = tile_row0 < poff[E] && tile_row0 < gstart + gsize;
  // rows r0 .. r0 + n_rows - 1 lie within the group's real size
  const int n_rows = live ? max(0, min(ROWS, gstart + gsize - r0)) : 0;
  if (n_rows == 0) {           // uniform over the block: no barrier skipped
    if (f < F) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) out[(size_t)(r0 + r) * F + f] = 0.f;
    }
    return;
  }

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  gmm_rows<T, ROWS>(x + (size_t)r0 * D, w + (size_t)e * D * F, D, F, n_rows,
                    f, acc, xs);
  if (f < F) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      out[(size_t)(r0 + r) * F + f] = r < n_rows ? acc[r] : 0.f;
  }
}

// grid (ceil(C / R), ceil(F / COLS), E)
template <typename T, int R>
__global__ void __launch_bounds__(COLS)
gmm_padded_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  float* __restrict__ out, int C, int D, int F) {
  __shared__ float xs[R][KC];
  const int e = blockIdx.z;
  const int r0 = blockIdx.x * R;
  const int f = blockIdx.y * COLS + threadIdx.x;
  const int n_rows = min(R, C - r0);
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  gmm_rows<T, R>(x + ((size_t)e * C + r0) * D, w + (size_t)e * D * F, D, F,
                 n_rows, f, acc, xs);
  if (f < F) {
    float* o = out + ((size_t)e * C + r0) * F + f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < n_rows) o[(size_t)r * F] = acc[r];
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* te, const void* gs,
           const void* po, void* out, int Np, int D, int F, int E, int nb,
           cudaStream_t stream) {
  const dim3 grid(Np / ROWS, (F + COLS - 1) / COLS);
  gmm_ragged_kernel<T><<<grid, COLS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(te), static_cast<const int*>(gs),
      static_cast<const int*>(po), static_cast<float*>(out), D, F, E, nb);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_padded(const void* x, const void* w, void* out, int E, int C,
                  int D, int F, cudaStream_t stream) {
  const dim3 grid((C + R - 1) / R, (F + COLS - 1) / COLS, E);
  gmm_padded_kernel<T, R><<<grid, COLS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<float*>(out), C, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_padded(const void* x, const void* w, void* out, int E, int C,
                  int D, int F, cudaStream_t stream) {
  if (C <= 8) return launch_padded<T, 8>(x, w, out, E, C, D, F, stream);
  if (C <= 16) return launch_padded<T, 16>(x, w, out, E, C, D, F, stream);
  return launch_padded<T, 32>(x, w, out, E, C, D, F, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and w). Returns the launch's
// cudaError_t. Np must be a multiple of nb, and nb a multiple of 8.
extern "C" int moe_gmm_launch(const void* x, const void* w,
                              const void* tile_expert,
                              const void* group_sizes,
                              const void* padded_offsets, void* out, int Np,
                              int D, int F, int E, int nb, int dtype,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Np == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, tile_expert, group_sizes, padded_offsets, out,
                         Np, D, F, E, nb, s);
  return launch<__nv_bfloat16>(x, w, tile_expert, group_sizes,
                               padded_offsets, out, Np, D, F, E, nb, s);
}

// dtype: 0 = float32, 1 = bfloat16 (x and w). x (E, C, D), w (E, D, F),
// out (E, C, F) f32, all contiguous; any C, D and F. Returns the launch's
// cudaError_t.
extern "C" int moe_gmm_padded_launch(const void* x, const void* w, void* out,
                                     int E, int C, int D, int F, int dtype,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0 || C == 0 || F == 0) return 0;
  if (E > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_padded<float>(x, w, out, E, C, D, F, s);
  return launch_padded<__nv_bfloat16>(x, w, out, E, C, D, F, s);
}

extern "C" const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
