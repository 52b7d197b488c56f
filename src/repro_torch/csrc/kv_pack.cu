// Int8 KV rows: per-row symmetric quantization, written in place or
// straight into int8 KV pages, and its inverse.
//
// Replaces: src/repro/kernels/kv_pack.py::_pack_kernel (pack_kv_pallas) and
// ::_unpack_kernel (unpack_kv_pallas); pack_kv_paged_launch also does the
// page-slot arithmetic and the scatter of the reference's int8 write path
// (src/repro/models/transformer.py::_paged_attention, the .at[page, off]
// .set of codes and scales).
//
// pack, for each row r of x (rows, hd), bf16 or f32, read as f32:
//   s[r]    = max_d |x[r, d]| / 127          (an IEEE division, as jnp)
//   q[r, d] = round_half_even(x[r, d] / max(s[r], 1e-8))   -> int8
// A zero row gives s = 0 and q = 0. The division is kept as a division
// (no multiply by a reciprocal) and the file is built without fast math,
// so that ties round exactly as the reference's jnp.round does
// (__float2int_rn rounds half to even; roundf would round half away).
//
// pack_kv_launch writes row r to q[r], s[r]. pack_kv_paged_launch takes the
// rows of K and V of a (B, S) chunk (token t = b * S + j, head h) and
// writes each one to its page slot:
//   page = valid[t] ? block_tables[b, clamp(pos[t] // ps, 0, NB - 1)] : 0
//   off  = valid[t] ? pos[t] % ps : 0          (floor division and modulo)
//   pool[page, off, h, :] = codes, scale[page, off, h] = s
// Invalid rows all land on page 0, the garbage page, and race there; a
// page id outside [0, P) writes nothing.
//
// unpack_kv: out[r, d] = (float)q[r, d] * s[r], cast to bf16 or f32.
//
// Bound on an H100: the bytes (hd * itemsize read, hd + 4 written per row)
// and, at serving sizes, the launch: a decode step writes 8 tokens x 4
// heads of K and of V, 16 KB read and 8 KB written, nanoseconds at 3.35
// TB/s. So one launch does the whole write of a layer (K and V, codes and
// scales, the slot arithmetic), where the plain sequence takes 17 device
// operations (PERF.md).
//
// Design: one warp per (row, K or V); K and V of a row are neighbouring
// warps. When hd = 32 * n (n = 1, 2, 4, 8) and the pointers allow it, each
// lane loads its n values with one vector load (8 bytes at hd = 128 in
// bf16), a shuffle reduction gives the row max to every lane, and each lane
// stores its n codes with one store (4 bytes at hd = 128); other widths
// take a strided loop over the row. Lane 0 writes the scale. Unpack gives
// each thread 16 int8 codes, one 16-byte load, and its row's scale, and
// writes 16 output values as 16-byte stores; it needs hd % 16 == 0 and
// aligned buffers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PACK_THREADS = 128;
constexpr int PACK_WARPS = PACK_THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Where row r's codes and scale go: itself, or its slot in the pages.
struct Slots {
  const int* block_tables;       // (B, NB); null: row r goes to row r
  const int* pos;                // (B * S,)
  const uint8_t* valid;          // (B * S,) bool
  int S, Hkv, NB, ps, P;

  // the destination row in units of hd, or -1 to write nothing
  __device__ __forceinline__ long long row(long long r) const {
    if (!block_tables) return r;
    const long long t = r / Hkv;
    const int h = (int)(r - t * Hkv);
    long long page = 0;
    int off = 0;
    if (valid[t]) {
      const int p = pos[t];
      int blk = p / ps;
      off = p - blk * ps;
      if (off < 0) {             // floor division for a negative position
        off += ps;
        --blk;
      }
      blk = blk < 0 ? 0 : (blk >= NB ? NB - 1 : blk);
      page = block_tables[(t / S) * NB + blk];
      if (page < 0 || page >= P) return -1;
    }
    return (page * ps + off) * Hkv + h;
  }
};

// One warp packs one row of hd values into codes q and scale *s.
// N > 0: lane l holds values [l * N, l * N + N), one vector load.
template <typename T, int N>
__device__ __forceinline__ void pack_row(const T* __restrict__ xr,
                                         int8_t* __restrict__ qr,
                                         float* __restrict__ s, int hd,
                                         int lane) {
  float amax = 0.f;
  if constexpr (N > 0) {
    const Vec<T, N> x = reinterpret_cast<const Vec<T, N>*>(xr)[lane];
    float f[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      f[i] = to_f(x.v[i]);
      amax = fmaxf(amax, fabsf(f[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax / 127.0f;
    const float denom = fmaxf(scale, 1e-8f);
    Vec<int8_t, N> c;
#pragma unroll
    for (int i = 0; i < N; ++i) c.v[i] = (int8_t)__float2int_rn(f[i] / denom);
    reinterpret_cast<Vec<int8_t, N>*>(qr)[lane] = c;
    if (lane == 0) *s = scale;
  } else {
    for (int d = lane; d < hd; d += 32)
      amax = fmaxf(amax, fabsf(to_f(xr[d])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax / 127.0f;
    const float denom = fmaxf(scale, 1e-8f);
    for (int d = lane; d < hd; d += 32)
      qr[d] = (int8_t)__float2int_rn(to_f(xr[d]) / denom);
    if (lane == 0) *s = scale;
  }
}

// Units u = 0 .. rows * n_src - 1: source u % n_src (K, then V), row
// u / n_src. Source i reads x[i] and writes q[i], s[i] at dst.row(row).
template <typename T, int N>
__global__ void __launch_bounds__(PACK_THREADS)
pack_kv_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
               int8_t* __restrict__ q0, int8_t* __restrict__ q1,
               float* __restrict__ s0, float* __restrict__ s1,
               long long rows, int n_src, int hd, Slots dst) {
  const int lane = threadIdx.x & 31;
  const long long n_units = rows * n_src;
  for (long long u = (long long)blockIdx.x * PACK_WARPS + (threadIdx.x >> 5);
       u < n_units; u += (long long)gridDim.x * PACK_WARPS) {
    const long long r = u / n_src;
    const bool second = u - r * n_src;
    const long long d = dst.row(r);
    if (d < 0) continue;                       // warp-uniform
    pack_row<T, N>((second ? x1 : x0) + r * hd, (second ? q1 : q0) + d * hd,
                   (second ? s1 : s0) + d, hd, lane);
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

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Values per lane of the vector route, or 0 for the strided loop: hd must
// be 32 * n with n in {1, 2, 4, 8} and every row start aligned to n values
// (the bases are, since each row is hd values from the last).
int values_per_lane(int hd, size_t item, const void* x0, const void* x1,
                    const void* q0, const void* q1) {
  if (hd % 32) return 0;
  const int n = hd / 32;
  if (n != 1 && n != 2 && n != 4 && n != 8) return 0;
  const size_t xb = n * item;
  if (!aligned(x0, xb) || !aligned(x1, xb) || !aligned(q0, n) ||
      !aligned(q1, n))
    return 0;
  return n;
}

template <typename T>
cudaError_t pack(const void* x0, const void* x1, void* q0, void* q1,
                 void* s0, void* s1, long long rows, int hd,
                 const Slots& dst, cudaStream_t st) {
  const int n_src = x1 ? 2 : 1;
  const int grid = grid_for(rows * n_src, PACK_WARPS);
  const T* a = static_cast<const T*>(x0);
  const T* b = static_cast<const T*>(x1);
  int8_t* c = static_cast<int8_t*>(q0);
  int8_t* d = static_cast<int8_t*>(q1);
  float* e = static_cast<float*>(s0);
  float* f = static_cast<float*>(s1);
#define PACK_KV_LAUNCH(N)                                                    \
  pack_kv_kernel<T, N><<<grid, PACK_THREADS, 0, st>>>(a, b, c, d, e, f,      \
                                                      rows, n_src, hd, dst)
  switch (values_per_lane(hd, sizeof(T), x0, x1, q0, q1)) {
    case 1: PACK_KV_LAUNCH(1); break;
    case 2: PACK_KV_LAUNCH(2); break;
    case 4: PACK_KV_LAUNCH(4); break;
    case 8: PACK_KV_LAUNCH(8); break;
    default: PACK_KV_LAUNCH(0); break;
  }
#undef PACK_KV_LAUNCH
  return cudaGetLastError();
}

cudaError_t pack_any(int dtype, const void* x0, const void* x1, void* q0,
                     void* q1, void* s0, void* s1, long long rows, int hd,
                     const Slots& dst, cudaStream_t st) {
  if (dtype == 0)
    return pack<float>(x0, x1, q0, q1, s0, s1, rows, hd, dst, st);
  return pack<__nv_bfloat16>(x0, x1, q0, q1, s0, s1, rows, hd, dst, st);
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
  const Slots itself{nullptr, nullptr, nullptr, 1, 1, 1, 1, 0};
  return (int)pack_any(dtype, x, nullptr, q, nullptr, s, nullptr, rows, hd,
                       itself, static_cast<cudaStream_t>(stream));
}

// k, v (B * S, Hkv, hd) in dtype -> their codes and scales in the int8
// pages pool_k, pool_v (P, ps, Hkv, hd) and k_scale, v_scale (P, ps, Hkv)
// float32, at the slots block_tables (B, NB) int32, pos (B * S,) int32 and
// valid (B * S,) bool give. Returns the cudaError_t of the launch.
extern "C" int pack_kv_paged_launch(const void* k, const void* v,
                                    const void* block_tables, const void* pos,
                                    const void* valid, void* pool_k,
                                    void* pool_v, void* k_scale,
                                    void* v_scale, long long tokens, int S,
                                    int Hkv, int hd, int NB, int ps, int P,
                                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd <= 0 || tokens < 0 || S <= 0 || Hkv <= 0 || NB <= 0 || ps <= 0 ||
      P <= 0)
    return (int)cudaErrorInvalidValue;
  if (tokens == 0) return 0;
  const Slots slots{static_cast<const int*>(block_tables),
                    static_cast<const int*>(pos),
                    static_cast<const uint8_t*>(valid), S, Hkv, NB, ps, P};
  return (int)pack_any(dtype, k, v, pool_k, pool_v, k_scale, v_scale,
                       tokens * Hkv, hd, slots,
                       static_cast<cudaStream_t>(stream));
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
