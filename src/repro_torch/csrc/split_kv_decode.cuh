// Split-KV flash decoding, the parts shared by paged_decode.cu and
// flash_decode.cu (the ports of src/repro/kernels/paged_decode.py and
// flash_decode.py): one block per (request, KV head, slice of the context)
// serves the G = Hq / Hkv query heads of its KV head and writes the slice's
// (max, sum, accumulator) per query head; combine merges the slices.
//
// This header holds the CUDA-core route (f32 inputs, and bf16 shapes the
// tensor-core route of split_kv_tc.cuh cannot take), the partials' layout
// in the call's one f32 scratch buffer, and the combine pass both routes
// share. The CUDA-core kernel stages TILE K/V rows of its slice in shared
// memory as f32 (how it finds them is its own: through a block table, or in
// a dense cache), then attend_tile runs the online-softmax update.
//
// State in shared memory, f32: qs [G][hd], ks [TILE][hd + 1] (padded rows:
// conflict-free score reads), vs [TILE][hd], sc [G][TILE], acc [G][hd],
// ms, ls, cs [G]. A slice with no token writes (NEG_INF, 0, 0), and the
// combine gives every slice with l = 0 the weight 0 without reading its
// accumulator; a row with no token at all divides 0 by max(0, 1e-30) and
// gives exact zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: each including source is its own shared library.
namespace {
namespace split_kv {

constexpr int TILE = 32;       // tokens staged per step
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T -> 16 / sizeof(T) floats at dst[0], dst[1], ...
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* dst) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = to_f(v[i]);
}

// f32 words of shared memory the state above takes
__host__ __device__ inline size_t state_floats(int G, int hd) {
  return (size_t)2 * G * hd + TILE * (hd + 1) + TILE * hd + G * TILE + 3 * G;
}

struct State {
  float *qs, *ks, *vs, *sc, *acc, *ms, *ls, *cs;
  __device__ State(float* smem, int G, int hd) {
    qs = smem;
    ks = qs + G * hd;
    vs = ks + TILE * (hd + 1);
    sc = vs + TILE * hd;
    acc = sc + G * TILE;
    ms = acc + G * hd;
    ls = ms + G;
    cs = ls + G;
  }
  // first word past the state: the kernel's own scratch starts here
  __device__ float* end(int G) const { return cs + G; }
};

// Loads the G query rows at q (f32 in qs) and zeroes the running state.
// The caller synchronises before the first attend_tile.
template <typename T>
__device__ __forceinline__ void init_state(const State& st, const T* q, int G,
                                           int hd) {
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    st.qs[i] = to_f(q[i]);
    st.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    st.ms[g] = NEG_INF;
    st.ls[g] = 0.f;
  }
}

// Stores K and V row t of the tile (VEC floats at column c * VEC).
template <int VEC>
__device__ __forceinline__ void stage(const State& st, int hd, int t, int c,
                                      const float* kf, const float* vf) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    st.ks[t * (hd + 1) + c * VEC + j] = kf[j];
    st.vs[t * hd + c * VEC + j] = vf[j];
  }
}

// One online-softmax step over the n <= TILE rows staged in ks/vs (the
// caller synchronised after staging): scores (capped to cap * tanh(s /
// cap) when cap > 0), per-head max and sum with the rescale of the running
// state, then the accumulator. Ends synchronised.
__device__ __forceinline__ void attend_tile(const State& st, int G, int hd,
                                            int n, float scale,
                                            float cap = 0.f) {
  const int tid = threadIdx.x;
  const int ks_ld = hd + 1;
  for (int i = tid; i < G * TILE; i += blockDim.x) {
    const int g = i / TILE, t = i - g * TILE;
    float s = NEG_INF;
    if (t < n) {
      float dot = 0.f;
      const float* qr = st.qs + g * hd;
      const float* kr = st.ks + t * ks_ld;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
    }
    st.sc[i] = s;
  }
  __syncthreads();

  for (int g = tid; g < G; g += blockDim.x) {
    const float m_prev = st.ms[g];
    float m_new = m_prev;
    for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, st.sc[g * TILE + t]);
    float sum = 0.f;
    for (int t = 0; t < TILE; ++t) {
      const float p = t < n ? expf(st.sc[g * TILE + t] - m_new) : 0.f;
      st.sc[g * TILE + t] = p;
      sum += p;
    }
    const float c = expf(m_prev - m_new);
    st.ls[g] = st.ls[g] * c + sum;
    st.ms[g] = m_new;
    st.cs[g] = c;
  }
  __syncthreads();

  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float a = st.acc[i] * st.cs[g];
    for (int t = 0; t < n; ++t)
      a = fmaf(st.sc[g * TILE + t], st.vs[t * hd + d], a);
    st.acc[i] = a;
  }
  __syncthreads();
}

// Partials of query heads h*G .. h*G+G-1 for slice `split` of request b:
// m_part/l_part (B, Hq, n_split), acc_part (B, Hq, n_split, hd).
__device__ __forceinline__ void write_partials(const State& st, int b, int h,
                                               int split, int G, int Hq,
                                               int hd, int n_split,
                                               float* m_part, float* l_part,
                                               float* acc_part) {
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    const size_t row = ((size_t)b * Hq + h * G + g) * n_split + split;
    acc_part[row * hd + d] = st.acc[i];
    if (d == 0) {
      m_part[row] = st.ms[g];
      l_part[row] = st.ls[g];
    }
  }
}

// The partials in the call's scratch buffer, f32: acc (B, Hq, n_split, hd)
// first (16-byte aligned for the combine's vector loads), then m and l
// (B, Hq, n_split); scratch holds B * Hq * n_split * (hd + 2) floats.
struct Partials {
  float *acc, *m, *l;
  Partials(void* scratch, int B, int Hq, int n_split, int hd) {
    const size_t rows = (size_t)B * Hq * n_split;
    acc = static_cast<float*>(scratch);
    m = acc + rows * hd;
    l = m + rows;
  }
};

constexpr int COMBINE_WARPS = 4;
constexpr int COMBINE_THREADS = 32 * COMBINE_WARPS;
constexpr int MAX_SPLITS = 8192;  // the combine's weights in shared memory

// op over the block's values: a butterfly over the lanes, then the warps'
// results in warp order. red holds COMBINE_WARPS floats.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(~0u, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < COMBINE_WARPS; ++w) v = op(v, red[w]);
  __syncthreads();
  return v;
}

// One block per (request, query head): rescales the slices' partials to
// the global max m and divides by the global sum. Each slice's weight
// exp(m_s - m) is computed once into shared memory, 0 for a slice with no
// token (l_s = 0), whose accumulator is then never read: the tensor-core
// route does not write it. Warp w sums the accumulators of the slices w,
// w + COMBINE_WARPS, ..., four columns a lane (16-byte loads), and the
// warps' sums are added in warp order, so the result does not depend on
// timing. EXP2: the maxima are in log2 units (the tensor-core route), so
// the weight is exp2(m_s - m). hd must be a multiple of 4. With lse
// non-null (split-K decode across shards of a cache, T = float) the block
// also writes its row's natural-log log-sum-exp, m + log(l) (m taken back
// from log2 units on the tensor-core route), or -inf for a row with no
// token, so that shards' outputs can be merged as the partials are here.
template <typename T, bool EXP2>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine(Partials part, T* __restrict__ out, float* __restrict__ lse, int Hq,
        int hd, int n_split) {
  extern __shared__ float sm[];   // wts [n_split, rounded up to 4], sums
  float* wts = sm;
  float* sums = sm + ((n_split + 3) & ~3);          // [COMBINE_WARPS][hd]
  __shared__ float red[COMBINE_WARPS];
  const int b = blockIdx.x, hq = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t row0 = ((size_t)b * Hq + hq) * n_split;
  float m = NEG_INF;
  for (int s = tid; s < n_split; s += COMBINE_THREADS)
    m = fmaxf(m, part.m[row0 + s]);
  m = block_reduce(m, red, [](float x, float y) { return fmaxf(x, y); });
  float l = 0.f;
  for (int s = tid; s < n_split; s += COMBINE_THREADS) {
    const float ls = part.l[row0 + s];
    const float x = part.m[row0 + s] - m;
    const float w = ls > 0.f ? (EXP2 ? exp2f(x) : expf(x)) : 0.f;
    wts[s] = w;
    l += ls * w;
  }
  l = block_reduce(l, red, [](float x, float y) { return x + y; });
  for (int c = lane; c < hd / 4; c += 32) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = warp; s < n_split; s += COMBINE_WARPS) {
      const float w = wts[s];
      if (w == 0.f) continue;
      const float4 v = *reinterpret_cast<const float4*>(
          part.acc + (row0 + s) * hd + 4 * c);
      a.x += v.x * w;
      a.y += v.y * w;
      a.z += v.z * w;
      a.w += v.w * w;
    }
    *reinterpret_cast<float4*>(sums + warp * hd + 4 * c) = a;
  }
  __syncthreads();
  for (int d = tid; d < hd; d += COMBINE_THREADS) {
    float a = sums[d];
#pragma unroll
    for (int w = 1; w < COMBINE_WARPS; ++w) a += sums[w * hd + d];
    out[((size_t)b * Hq + hq) * hd + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
  if (lse != nullptr && tid == 0)
    lse[(size_t)b * Hq + hq] =
        l > 0.f ? (EXP2 ? m * 0.69314718055994531f : m) + logf(l)
                : __int_as_float((int)0xff800000u);  // -inf
}

template <typename T, bool EXP2>
int launch_combine(const Partials& p, void* out, int B, int Hq, int hd,
                   int n_split, cudaStream_t stream, float* lse = nullptr) {
  if (n_split > MAX_SPLITS || hd % 4 || hd > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (((n_split + 3) & ~3) + COMBINE_WARPS * hd);
  combine<T, EXP2><<<dim3(B, Hq), COMBINE_THREADS, smem, stream>>>(
      p, static_cast<T*>(out), lse, Hq, hd, n_split);
  return (int)cudaGetLastError();
}

// Allows KERNEL at least smem bytes of dynamic shared memory on `device`;
// cudaFuncSetAttribute only when a launch needs more than any before.
template <auto KERNEL>
cudaError_t allow_smem(size_t smem, int device) {
  static size_t allowed[64] = {};   // per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= allowed[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

// Makes `device` current, reading the current one first: no cudaSetDevice
// when it already is.
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace split_kv
}  // namespace
