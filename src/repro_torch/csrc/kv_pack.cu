// Int8 KV rows: per-row symmetric quantization and its inverse.
//
// Replaces: src/repro/kernels/kv_pack.py::_pack_kernel (pack_kv_pallas) and
// ::_unpack_kernel (unpack_kv_pallas).
//
// pack_kv, for each row r of x (rows, hd), bf16 or f32, read as f32:
//   s[r]    = max_d |x[r, d]| / 127          (an IEEE division, as jnp)
//   q[r, d] = round_half_even(x[r, d] / max(s[r], 1e-8))   -> int8
// A zero row gives s = 0 and q = 0. The division is kept as a division
// (no multiply by a reciprocal) and the file is built without fast math,
// so that ties round exactly as the reference's jnp.round does
// (__float2int_rn rounds half to even; roundf would round half away).
//
// unpack_kv: out[r, d] = (float)q[r, d] * s[r], cast to bf16 or f32.
//
// Bound on an H100: bytes, both ways. Pack reads hd * itemsize bytes and
// writes hd + 4 bytes per row with one compare, one division and one
// conversion per value; unpack reads hd + 4 and writes hd * itemsize.
//
// Design: pack gives one warp to a row (a row is a KV head of one token:
// hd = 128 values). Each lane reads its values with stride 32, so the warp
// reads the row in coalesced passes; a shuffle reduction gives the row
// max to all lanes, which then re-read their values (from L1) and write
// the int8 codes. Lane 0 writes the scale. Unpack gives each thread 16
// int8 codes, one 16-byte load, and its row's scale, and writes 16 output
// values as 16-byte stores; it needs hd % 16 == 0 and aligned buffers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pack_kv_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
               float* __restrict__ s, long long rows, int hd) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;
  for (long long r = warp; r < rows; r += n_warps) {
    const T* xr = x + r * hd;
    float amax = 0.f;
    for (int d = lane; d < hd; d += 32)
      amax = fmaxf(amax, fabsf(to_f(xr[d])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax / 127.0f;
    const float denom = fmaxf(scale, 1e-8f);
    int8_t* qr = q + r * hd;
    for (int d = lane; d < hd; d += 32)
      qr[d] = (int8_t)__float2int_rn(to_f(xr[d]) / denom);
    if (lane == 0) s[r] = scale;
  }
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
unpack_kv_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                 T* __restrict__ out, long long n_vec, int vec_per_row) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * blockDim.x) {
    const float scale = s[i / vec_per_row];
    const uint4 raw = reinterpret_cast<const uint4*>(q)[i];
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    alignas(16) T o[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) o[j] = from_f<T>((float)v[j] * scale);
    uint4* dst = reinterpret_cast<uint4*>(out + i * 16);
#pragma unroll
    for (int j = 0; j < (int)(16 * sizeof(T) / 16); ++j)
      dst[j] = reinterpret_cast<const uint4*>(o)[j];
  }
}

int grid_for(long long work, int per_block) {
  long long g = (work + per_block - 1) / per_block;
  const long long cap = 132 * 16;     // SMs x resident blocks, roughly
  return (int)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

// x (rows, hd) in dtype (0 = float32, 1 = bfloat16) -> q (rows, hd) int8,
// s (rows,) float32. Returns the cudaError_t of the launch.
extern "C" int pack_kv_launch(const void* x, void* q, void* s, long long rows,
                              int hd, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(rows, WARPS);
  if (dtype == 0)
    pack_kv_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), rows, hd);
  else
    pack_kv_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), rows, hd);
  return (int)cudaGetLastError();
}

// q (rows, hd) int8, s (rows,) float32 -> out (rows, hd) in dtype
// (0 = float32, 1 = bfloat16). hd must be a multiple of 16 and the buffers
// 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int unpack_kv_launch(const void* q, const void* s, void* out,
                                long long rows, int hd, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd <= 0 || hd % 16 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_vec = rows * (hd / 16);
  const int grid = grid_for(n_vec, THREADS);
  if (dtype == 0)
    unpack_kv_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), n_vec, hd / 16);
  else
    unpack_kv_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(out), n_vec, hd / 16);
  return (int)cudaGetLastError();
}

extern "C" const char* kv_pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
