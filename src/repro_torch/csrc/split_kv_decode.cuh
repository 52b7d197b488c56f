// Split-KV flash decoding, the parts shared by paged_decode.cu and
// flash_decode.cu: one block per (request, KV head, slice of the context)
// serves the G = Hq / Hkv query heads of its KV head. The kernel stages TILE
// K/V rows of its slice in shared memory as f32 (how it finds them is its
// own: through a block table, or in a dense cache), then attend_tile runs
// the online-softmax update; write_partials stores the slice's (max, sum,
// accumulator) per query head, and combine merges the slices.
//
// State in shared memory, f32: qs [G][hd], ks [TILE][hd + 1] (padded rows:
// conflict-free score reads), vs [TILE][hd], sc [G][TILE], acc [G][hd],
// ms, ls, cs [G]. A slice with no token writes (NEG_INF, 0, 0), which the
// combine weighs by exp(-huge) = 0; a row with no token at all divides 0 by
// max(0, 1e-30) and gives exact zeros.
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
// caller synchronised after staging): scores, per-head max and sum with
// the rescale of the running state, then the accumulator. Ends synchronised.
__device__ __forceinline__ void attend_tile(const State& st, int G, int hd,
                                            int n, float scale) {
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

// One block per (request, query head): rescales the slices' partials to
// the global max and divides by the global sum.
template <typename T>
__global__ void combine(const float* __restrict__ m_part,
                        const float* __restrict__ l_part,
                        const float* __restrict__ acc_part,
                        T* __restrict__ out, int Hq, int hd, int n_split) {
  const int b = blockIdx.x, hq = blockIdx.y;
  const size_t row0 = ((size_t)b * Hq + hq) * n_split;
  float m = NEG_INF;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_part[row0 + s]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s)
    l += l_part[row0 + s] * expf(m_part[row0 + s] - m);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += acc_part[(row0 + s) * hd + d] * expf(m_part[row0 + s] - m);
    out[((size_t)b * Hq + hq) * hd + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch_combine(const void* m_part, const void* l_part,
                   const void* acc_part, void* out, int B, int Hq, int hd,
                   int n_split, cudaStream_t stream) {
  combine<T><<<dim3(B, Hq), hd < 1024 ? hd : 1024, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), Hq, hd,
      n_split);
  return (int)cudaGetLastError();
}

}  // namespace split_kv
}  // namespace
