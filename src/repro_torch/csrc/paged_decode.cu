// Paged flash decode: one new token per request against a paged KV pool.
//
// Replaces: src/repro/kernels/paged_decode.py::_kernel (paged_decode_pallas),
// both variants: pages in the query's type, and int8 pages with per-row f32
// scales (P, ps, Hkv), dequantized on read (kernels/kv_pack.py layout).
//
// Computes, for request b and query head (h, g) of KV head h:
//   out = softmax(q . K[0:ctx] / sqrt(hd)) . V[0:ctx]
// where token t of the request lives at page block_tables[b, t / ps], slot
// t % ps. Scores, running max, running sum and the accumulator are f32; the
// output is cast to the input type. ctx_lens[b] == 0 gives exact zeros. On
// int8 pages each K/V value is dequantized in f32 as float(v) * scale[page,
// slot, head] before it is staged, as the reference does.
//
// Bound on an H100: the bytes of K and V of the live tokens. At Hkv=4,
// hd=128 in bf16 that is 2 KB per token and layer, against 2 * G = 16 flops
// per K/V element read: far below the ~295 flops per byte at which the
// tensor cores become the limit. Int8 pages halve those bytes (plus 4 bytes
// of scale per row and head).
//
// Design (split-KV flash decoding, two launches on one stream):
//  1. partial pass, one block per (request, KV head, split_tokens slice of
//     the context). The block serves all G = Hq/Hkv query heads of its KV
//     head, so each K/V row is read from device memory once. It copies its
//     slice of the block table to shared memory, then walks only live tokens,
//     TILE at a time: K and V rows come in as 16-byte vector loads and are
//     staged in shared memory as f32, each thread scores (head, token)
//     pairs, one thread per head runs the online-softmax update, and the
//     accumulator (G x hd f32) stays in shared memory. Tokens past ctx are
//     never read. It writes its (max, sum, accumulator) per query head.
//  2. combine pass, one block per (request, query head): rescales the
//     slices' partials to the global max and divides by the global sum.
// Splitting the context in 128-token slices gives B * Hkv * ceil(NB * ps /
// 128) blocks (256 at the serving shape) instead of B * Hkv = 32.
// Tensor-core scoring, a TMA ring of K/V pages and a fused combine are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// 16 bytes of T -> VEC floats at dst[0], dst[1], ...
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* dst) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = to_f(v[i]);
}

// T: query/output type; TP: page type (T, or int8_t with scales ksc/vsc)
template <typename T, typename TP>
__global__ void __launch_bounds__(THREADS)
paged_decode_partial(const T* __restrict__ q, const TP* __restrict__ kp,
                     const TP* __restrict__ vp,
                     const float* __restrict__ ksc,
                     const float* __restrict__ vsc, const int* __restrict__ bt,
                     const int* __restrict__ ctx_lens,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part, int Hq, int Hkv, int hd,
                     int ps, int NB, int n_split, int split_tokens,
                     float scale) {
  constexpr int VEC = 16 / sizeof(TP);
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int ks_ld = hd + 1;    // padded K rows: conflict-free score reads

  extern __shared__ float smem[];
  float* qs = smem;                    // [G][hd]
  float* ks = qs + G * hd;             // [TILE][hd + 1]
  float* vs = ks + TILE * ks_ld;       // [TILE][hd]
  float* sc = vs + TILE * hd;          // [G][TILE] scores, then weights
  float* acc = sc + G * TILE;          // [G][hd]
  float* ms = acc + G * hd;            // [G] running max
  float* ls = ms + G;                  // [G] running sum
  float* cs = ls + G;                  // [G] rescale of this step
  int* pages = reinterpret_cast<int*>(cs + G);   // [split_tokens / ps + 2]

  const int ctx = max(0, min(ctx_lens[b], NB * ps));
  const int lo = split * split_tokens;
  const int hi = min(ctx, lo + split_tokens);
  const int blk0 = lo / ps;
  if (lo < hi) {
    const int n_blk = (hi - 1) / ps - blk0 + 1;
    for (int i = tid; i < n_blk; i += blockDim.x)
      pages[i] = bt[(size_t)b * NB + blk0 + i];
    const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * hd;
    for (int i = tid; i < G * hd; i += blockDim.x) qs[i] = to_f(qb[i]);
  }
  for (int i = tid; i < G * hd; i += blockDim.x) acc[i] = 0.f;
  for (int g = tid; g < G; g += blockDim.x) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  __syncthreads();

  const int row_vecs = hd / VEC;
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
#pragma unroll 2
    for (int i = tid; i < n * row_vecs; i += blockDim.x) {
      const int t = i / row_vecs, c = i - t * row_vecs;
      const int pos = t0 + t;
      const size_t page = (size_t)pages[pos / ps - blk0];
      const size_t row = (page * ps + pos % ps) * Hkv + h;
      const size_t off = row * hd + c * VEC;
      const uint4 kraw = *reinterpret_cast<const uint4*>(kp + off);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vp + off);
      float kf[VEC], vf[VEC];
      unpack16<TP>(kraw, kf);
      unpack16<TP>(vraw, vf);
      if constexpr (QUANT) {
        const float k_scale = ksc[row], v_scale = vsc[row];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          kf[j] *= k_scale;
          vf[j] *= v_scale;
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[t * ks_ld + c * VEC + j] = kf[j];
        vs[t * hd + c * VEC + j] = vf[j];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * TILE; i += blockDim.x) {
      const int g = i / TILE, t = i - g * TILE;
      float s = NEG_INF;
      if (t < n) {
        float dot = 0.f;
        const float* qr = qs + g * hd;
        const float* kr = ks + t * ks_ld;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      sc[i] = s;
    }
    __syncthreads();

    for (int g = tid; g < G; g += blockDim.x) {
      const float m_prev = ms[g];
      float m_new = m_prev;
      for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, sc[g * TILE + t]);
      float sum = 0.f;
      for (int t = 0; t < TILE; ++t) {
        const float p = t < n ? expf(sc[g * TILE + t] - m_new) : 0.f;
        sc[g * TILE + t] = p;
        sum += p;
      }
      const float c = expf(m_prev - m_new);
      ls[g] = ls[g] * c + sum;
      ms[g] = m_new;
      cs[g] = c;
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i - g * hd;
      float a = acc[i] * cs[g];
      for (int t = 0; t < n; ++t)
        a = fmaf(sc[g * TILE + t], vs[t * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  // partials of query heads h*G .. h*G+G-1 for this slice; an empty slice
  // writes (NEG_INF, 0, 0), which the combine weighs by exp(-huge) = 0
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    const size_t row = ((size_t)b * Hq + h * G + g) * n_split + split;
    acc_part[row * hd + d] = acc[i];
    if (d == 0) {
      m_part[row] = ms[g];
      l_part[row] = ls[g];
    }
  }
}

template <typename T>
__global__ void paged_decode_combine(const float* __restrict__ m_part,
                                     const float* __restrict__ l_part,
                                     const float* __restrict__ acc_part,
                                     T* __restrict__ out, int Hq, int hd,
                                     int n_split) {
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

template <typename T, typename TP>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* bt, const void* ctx, void* m_part,
           void* l_part, void* acc_part,
           void* out, int B, int Hq, int Hkv, int hd, int ps, int NB,
           int n_split, int split_tokens, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * hd + TILE * (hd + 1) + TILE * hd +
                       G * TILE + 3 * G) +
      sizeof(int) * (split_tokens / ps + 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_partial<T, TP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_decode_partial<T, TP>
      <<<dim3(B, Hkv, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(bt),
      static_cast<const int*>(ctx), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), Hq, Hkv,
      hd, ps, NB, n_split, split_tokens, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine<T><<<dim3(B, Hq), hd < 1024 ? hd : 1024, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), Hq, hd,
      n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of q and the output): 0 = float32, 1 = bfloat16. The pages are
// of that type when k_scales and v_scales are null, and int8 with f32
// scales (P, ps, Hkv) when they are not. Block z of the partial pass covers
// context tokens [z * split_tokens, (z + 1) * split_tokens), split_tokens a
// positive multiple of TILE; m_part/l_part (B, Hq, n_split) and acc_part
// (B, Hq, n_split, hd) are f32 scratch with n_split * split_tokens >=
// NB * ps. hd * sizeof(page type) must be a multiple of 16 and the pages
// 16-byte aligned. Returns the cudaError_t of the launches.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales,
                                   const void* block_tables,
                                   const void* ctx_lens, void* m_part,
                                   void* l_part, void* acc_part, void* out,
                                   int B, int Hq, int Hkv, int hd, int ps,
                                   int NB, int n_split, int split_tokens,
                                   float scale, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (split_tokens <= 0 || split_tokens % TILE ||
      (long long)n_split * split_tokens < (long long)NB * ps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if ((k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scales != nullptr;
#define PAGED_DECODE_ARGS                                                   \
  q, k_pages, v_pages, k_scales, v_scales, block_tables, ctx_lens, m_part, \
      l_part, acc_part, out, B, Hq, Hkv, hd, ps, NB, n_split, split_tokens, \
      scale, s
  if (dtype == 0)
    return quant ? launch<float, int8_t>(PAGED_DECODE_ARGS)
                 : launch<float, float>(PAGED_DECODE_ARGS);
  return quant ? launch<__nv_bfloat16, int8_t>(PAGED_DECODE_ARGS)
               : launch<__nv_bfloat16, __nv_bfloat16>(PAGED_DECODE_ARGS);
#undef PAGED_DECODE_ARGS
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
