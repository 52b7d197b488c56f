// Grouped expert GEMMs of the MoE FFN, two entry points.
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
// Bound on an H100: the bytes of the expert weights, at every serving
// shape. The padded GEMM reads all E experts' weights (402.7 MB in bf16 at
// E=128, D=2048, F=768); the ragged one the experts hit. At a prefill
// capacity of C=71 a weight byte carries 71 operations, where the bf16
// tensor cores become the limit only at about 295; but on the CUDA cores
// (67 TFLOP/s f32) the same products take three times the bytes bound.
//
// Two routes, chosen by the wrapper from the dtype and shape alone
// (kernels/moe_gmm.py::tc_eligible) and passed in as the dtype code:
//
// * bf16 on the tensor cores (code 2; D > 0 and F multiples of 8, pointers
//   16-byte aligned): csrc/gmm_tile.cuh. mma.sync m16n8k16 products fed
//   by ldmatrix from a 4-stage shared-memory ring that TMA fills with the
//   weights (48 KB in flight per block). A block owns BM rows of one expert
//   and a 128-column panel, and streams the panel's weights from device
//   memory once:
//   - padded: one block per (expert, column panel) covering all C rows up
//     to C = 128 (BM = 16 at the decode capacity C = 4, 80 at C = 71);
//     above 128, adjacent row tiles of one panel, so their reads meet in
//     L2;
//   - ragged: tiled per expert group, not per nb-row tile. The grid stays
//     (Np / nb, F / 128) from host-known numbers; the block of a tile at a
//     multiple of BM / nb tiles into its group leads and computes up to BM
//     rows of the group (BM about twice the mean group size, estimated
//     from Np, E and nb), a live non-leader exits, a dead tile writes its
//     zeros. So an expert's panel is read once per BM rows, where the
//     CUDA-core kernel re-read it once per 8 rows.
//   No split-K: a row's sum runs in one fixed order, so its result does
//   not depend on what else was routed to its expert.
// * the CUDA cores (f32 inputs, code 0, whose float32 twins must match the
//   CPU to 1e-4, where TF32 would not; and bf16 shapes the tensor-core
//   route cannot take, code 1): gmm_rows below. A block owns R rows of one
//   expert and 128 output columns, one column per thread with R f32
//   accumulators; x rows are staged in shared memory 64 deep and broadcast,
//   each thread streams its own weight column. The ragged kernel uses
//   R = 8 (nb is a multiple of 8); the padded one R = 8, 16 or 32 from C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "gmm_tile.cuh"

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


// ------------------------------------------------ tensor-core route (bf16)
using bf16 = __nv_bfloat16;
using gmm_tc::Tile;

// Zeros for rows [0, rows) and the block's columns [n0, n0 + BN) of out.
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int F,
                                          int n0, int rows) {
  for (int i = threadIdx.x; i < rows * (gmm_tc::BN / 4); i += blockDim.x) {
    const int r = i / (gmm_tc::BN / 4);
    const int col = n0 + (i % (gmm_tc::BN / 4)) * 4;
    if (col < F)
      *reinterpret_cast<float4*>(out + (size_t)r * F + col) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// grid (Np / nb, ceil(F / BN)). A leader covers `per` consecutive tiles of
// its group (all of them live), in passes of BM rows.
template <int MT, int WM>
__global__ void __launch_bounds__(Tile<MT, WM>::THREADS)
gmm_ragged_tc_kernel(const bf16* __restrict__ x,
                     const __grid_constant__ CUtensorMap wmap,
                     const int* __restrict__ tile_expert,
                     const int* __restrict__ group_sizes,
                     const int* __restrict__ poff, float* __restrict__ out,
                     int D, int F, int E, int nb) {
  using T = Tile<MT, WM>;
  extern __shared__ __align__(128) char smem[];
  const int n = blockIdx.x, r0 = n * nb, n0 = blockIdx.y * gmm_tc::BN;
  const int e = tile_expert[n];
  const int gstart = poff[e], gend = gstart + group_sizes[e];
  if (r0 >= poff[E] || r0 >= gend) {        // dead tile: its zeros
    zero_rows(out + (size_t)r0 * F, F, n0, nb);
    return;
  }
  const int per = max(1, T::BM / nb);
  if ((r0 - gstart) / nb % per) return;     // its leader covers it
  const int cover = min(per, (gend - r0 + nb - 1) / nb) * nb;
#pragma unroll 1
  for (int p = 0; p < cover; p += T::BM) {
    float acc[MT][4][4];
    const int n_rows = min(T::BM, gend - r0 - p);
    gmm_tc::gmm_tile<MT, WM>(x + (size_t)(r0 + p) * D, {&wmap, e}, D, n_rows,
                             n0, acc, smem);
    gmm_tc::store_tile<MT, WM>(out + (size_t)(r0 + p) * F, F, n0, n_rows,
                               min(T::BM, cover - p), acc);
  }
}

// grid (ceil(C / BM), ceil(F / BN), E): the row tiles of one expert's
// column panel are adjacent.
template <int MT, int WM>
__global__ void __launch_bounds__(Tile<MT, WM>::THREADS)
gmm_padded_tc_kernel(const bf16* __restrict__ x,
                     const __grid_constant__ CUtensorMap wmap,
                     float* __restrict__ out, int C, int D, int F) {
  using T = Tile<MT, WM>;
  extern __shared__ __align__(128) char smem[];
  const int e = blockIdx.z, r0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * gmm_tc::BN;
  const int n_rows = min(T::BM, C - r0);
  float acc[MT][4][4];
  gmm_tc::gmm_tile<MT, WM>(x + ((size_t)e * C + r0) * D, {&wmap, e}, D,
                           n_rows, n0, acc, smem);
  gmm_tc::store_tile<MT, WM>(out + ((size_t)e * C + r0) * F, F, n0, n_rows,
                             n_rows, acc);
}

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// address, so the library links against nothing but cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA descriptor of w (E, D, F) bf16: boxes of 64 columns x BK depth
// of one expert, 128-byte swizzled, zeros past D and F.
cudaError_t weights_map(CUtensorMap* map, const void* w, int E, int D,
                        int F) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  const cuuint32_t box[3] = {64, gmm_tc::BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int MT, int WM>
int launch_ragged_tc(const void* x, const void* w, const void* te,
                     const void* gs, const void* po, void* out, int Np, int D,
                     int F, int E, int nb, cudaStream_t stream) {
  using T = Tile<MT, WM>;
  auto kernel = gmm_ragged_tc_kernel<MT, WM>;
  CUtensorMap wmap;
  cudaError_t err = weights_map(&wmap, w, E, D, F);
  if (err == cudaSuccess) err = allow_smem(kernel, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Np / nb, (F + gmm_tc::BN - 1) / gmm_tc::BN);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(x), wmap, static_cast<const int*>(te),
      static_cast<const int*>(gs), static_cast<const int*>(po),
      static_cast<float*>(out), D, F, E, nb);
  return (int)cudaGetLastError();
}

// Rows per leader: about twice the mean group size. The buffer holds the
// T*K real rows plus at most E * (nb - 1) rows of alignment padding, so
// the real rows are known from the shapes to within that.
int ragged_rows_per_block(int Np, int E, int nb) {
  const long long real = (long long)Np - (long long)E * (nb - 1);
  const long long target = real > 0 ? 2 * ((real + E - 1) / E) : 0;
  return target <= 16 ? 16 : target <= 32 ? 32 : target <= 64 ? 64 : 128;
}

int launch_ragged_tc(const void* x, const void* w, const void* te,
                     const void* gs, const void* po, void* out, int Np, int D,
                     int F, int E, int nb, cudaStream_t s) {
  switch (ragged_rows_per_block(Np, E, nb)) {
    case 16: return launch_ragged_tc<1, 1>(x, w, te, gs, po, out, Np, D, F,
                                           E, nb, s);
    case 32: return launch_ragged_tc<2, 1>(x, w, te, gs, po, out, Np, D, F,
                                           E, nb, s);
    case 64: return launch_ragged_tc<4, 1>(x, w, te, gs, po, out, Np, D, F,
                                           E, nb, s);
    default: return launch_ragged_tc<4, 2>(x, w, te, gs, po, out, Np, D, F,
                                           E, nb, s);
  }
}

template <int MT, int WM>
int launch_padded_tc(const void* x, const void* w, void* out, int E, int C,
                     int D, int F, cudaStream_t stream) {
  using T = Tile<MT, WM>;
  auto kernel = gmm_padded_tc_kernel<MT, WM>;
  CUtensorMap wmap;
  cudaError_t err = weights_map(&wmap, w, E, D, F);
  if (err == cudaSuccess) err = allow_smem(kernel, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + T::BM - 1) / T::BM, (F + gmm_tc::BN - 1) / gmm_tc::BN,
                  E);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(x), wmap, static_cast<float*>(out), C, D, F);
  return (int)cudaGetLastError();
}

// BM = C rounded up to 16 while C <= 80 (one warp row of up to five m16
// tiles), else 128 (two warp rows of four).
int launch_padded_tc(const void* x, const void* w, void* out, int E, int C,
                     int D, int F, cudaStream_t s) {
  switch ((C + 15) / 16) {
    case 1: return launch_padded_tc<1, 1>(x, w, out, E, C, D, F, s);
    case 2: return launch_padded_tc<2, 1>(x, w, out, E, C, D, F, s);
    case 3: return launch_padded_tc<3, 1>(x, w, out, E, C, D, F, s);
    case 4: return launch_padded_tc<4, 1>(x, w, out, E, C, D, F, s);
    case 5: return launch_padded_tc<5, 1>(x, w, out, E, C, D, F, s);
    default: return launch_padded_tc<4, 2>(x, w, out, E, C, D, F, s);
  }
}

// The tensor-core route's preconditions, checked again on this side.
bool tc_ok(int D, int F, std::initializer_list<const void*> ptrs) {
  if (D <= 0 || D % 8 || F % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 on the CUDA cores, 2 = bfloat16 on the
// tensor cores (D > 0 and F multiples of 8, x, w and out 16-byte aligned;
// else cudaErrorInvalidValue). Returns the launch's cudaError_t. Np must be a
// multiple of nb, and nb a multiple of 8.
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
  if (dtype == 2) {
    if (!tc_ok(D, F, {x, w, out})) return (int)cudaErrorInvalidValue;
    return launch_ragged_tc(x, w, tile_expert, group_sizes, padded_offsets,
                            out, Np, D, F, E, nb, s);
  }
  return launch<__nv_bfloat16>(x, w, tile_expert, group_sizes,
                               padded_offsets, out, Np, D, F, E, nb, s);
}

// dtype as above. x (E, C, D), w (E, D, F), out (E, C, F) f32, all
// contiguous; any C, D and F on the CUDA cores. Returns the launch's
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
  if (dtype == 2) {
    if (!tc_ok(D, F, {x, w, out})) return (int)cudaErrorInvalidValue;
    return launch_padded_tc(x, w, out, E, C, D, F, s);
  }
  return launch_padded<__nv_bfloat16>(x, w, out, E, C, D, F, s);
}

extern "C" const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
