// Paged flash decode: one new token per request against a paged KV pool.
//
// Replaces: src/repro/kernels/paged_decode.py::_kernel (paged_decode_pallas),
// both variants: pages in the query's type, and int8 pages with per-row f32
// scales (P, ps, Hkv) (kernels/kv_pack.py layout).
//
// Computes, for request b and query head (h, g) of KV head h:
//   out = softmax(q . K[0:ctx] / sqrt(hd)) . V[0:ctx]
// where token t of the request lives at page block_tables[b, t / ps], slot
// t % ps. Scores, running max, running sum and the accumulator are f32; the
// output is cast to the input type. ctx_lens[b] == 0 gives exact zeros.
//
// Bound on an H100: the bytes of K and V of the live tokens. At Hkv=4,
// hd=128 in bf16 that is 2 KB per token and layer (8.9 MB at the serving
// shape, 2.7 us at 3.35 TB/s; 0.54 GB at a 32k context), against 2 * G =
// 16 flops per K/V element read: far below the ~295 flops per byte at
// which the tensor cores become the limit. Int8 pages halve those bytes
// (plus 4 bytes of scale per row and head).
//
// Design: split-KV flash decoding in two launches on one stream. The
// partial pass has one block per (request, KV head, split_tokens slice of
// the context), serving all G = Hq/Hkv query heads of its KV head so each
// K/V row is read from device memory once; it copies its slice of the block
// table to shared memory and reads only live tokens. It writes its (max,
// sum, accumulator) per query head into the call's scratch buffer; the
// combine pass (split_kv_decode.cuh), one block per (request, query head),
// rescales the slices to the global max and divides by the global sum.
// 128-token slices give B * Hkv * ceil(NB * ps / 128) blocks, whatever B.
// Two routes, chosen by the wrapper (kernels/decode_route.py::tc_eligible)
// and passed in as the dtype code:
// * bf16 on the tensor cores (code 2): split_kv_tc.cuh. A cp.async ring of
//   bf16 16-token tiles per warp, scores and P.V by mma.sync, the online
//   softmax in registers; P is rounded to bf16 before P.V. On int8 pages the
//   codes are converted to bf16 exactly in shared memory, the K scale
//   multiplies the score and the V scale multiplies p before its cast, so
//   no dequantized value is rounded to bf16 (numerics in that header).
// * the CUDA cores (f32, code 0, whose float32 twins must match the CPU to
//   1e-4; bf16 shapes the tensor cores cannot take, code 1): TILE tokens at
//   a time staged in shared memory as f32 (int8 values dequantized in f32
//   as float(v) * scale, as the reference does), scored and merged by
//   split_kv_decode.cuh's attend_tile.
#include <type_traits>

#include "split_kv_decode.cuh"
#include "split_kv_tc.cuh"

namespace {

using namespace split_kv;

// T: query/output type; TP: page type (T, or int8_t with scales ksc/vsc)
template <typename T, typename TP>
__global__ void __launch_bounds__(THREADS)
paged_decode_partial(const T* __restrict__ q, const TP* __restrict__ kp,
                     const TP* __restrict__ vp,
                     const float* __restrict__ ksc,
                     const float* __restrict__ vsc, const int* __restrict__ bt,
                     const int* __restrict__ ctx_lens, Partials part,
                     int Hq, int Hkv, int hd,
                     int ps, int NB, int n_split, int split_tokens,
                     float scale) {
  constexpr int VEC = 16 / sizeof(TP);
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = Hq / Hkv;

  extern __shared__ float smem[];
  const State st(smem, G, hd);
  int* pages = reinterpret_cast<int*>(st.end(G));   // [split_tokens / ps + 2]

  const int ctx = max(0, min(ctx_lens[b], NB * ps));
  const int lo = split * split_tokens;
  const int hi = min(ctx, lo + split_tokens);
  const int blk0 = lo / ps;
  if (lo < hi) {
    const int n_blk = (hi - 1) / ps - blk0 + 1;
    for (int i = tid; i < n_blk; i += blockDim.x)
      pages[i] = bt[(size_t)b * NB + blk0 + i];
  }
  init_state(st, q + ((size_t)b * Hq + (size_t)h * G) * hd, G, hd);
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
      stage<VEC>(st, hd, t, c, kf, vf);
    }
    __syncthreads();
    attend_tile(st, G, hd, n, scale);
  }
  write_partials(st, b, h, split, G, Hq, hd, n_split, part.m, part.l,
                 part.acc);
}

// The tensor-core route's partial pass: one block per (request, KV head,
// slice), split_kv_tc::attend_slice over the slice's live tokens.
template <int HD, bool QUANT>
__global__ void __launch_bounds__(split_kv_tc::THREADS)
paged_decode_tc(const __nv_bfloat16* __restrict__ q,
                const typename std::conditional<QUANT, int8_t,
                                                __nv_bfloat16>::type* kp,
                const typename std::conditional<QUANT, int8_t,
                                                __nv_bfloat16>::type* vp,
                const float* __restrict__ ksc, const float* __restrict__ vsc,
                const int* __restrict__ bt, const int* __restrict__ ctx_lens,
                Partials part, int Hq, int Hkv, int ps, int NB, int n_split,
                int split_tokens, float scale_log2) {
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int G = Hq / Hkv;
  extern __shared__ __align__(128) char smem_tc[];
  int* pages = reinterpret_cast<int*>(
      smem_tc + split_kv_tc::Layout<HD, QUANT>::BYTES);   // [n_blk]
  const int ctx = max(0, min(ctx_lens[b], NB * ps));
  const int lo = split * split_tokens;
  const int hi = min(ctx, lo + split_tokens);
  const int blk0 = lo / ps;
  if (lo < hi) {
    const int n_blk = (hi - 1) / ps - blk0 + 1;
    for (int i = threadIdx.x; i < n_blk; i += blockDim.x)
      pages[i] = bt[(size_t)b * NB + blk0 + i];
  }
  __syncthreads();
  const auto rows = [&](int i) -> size_t {
    const int t = lo + i;
    return ((size_t)pages[t / ps - blk0] * ps + t % ps) * Hkv + h;
  };
  split_kv_tc::attend_slice<HD, QUANT>(
      q + ((size_t)b * Hq + (size_t)h * G) * HD, G, kp, vp, ksc, vsc,
      max(0, hi - lo), rows, scale_log2, smem_tc, part,
      ((size_t)b * Hq + (size_t)h * G) * n_split + split, n_split);
}

size_t pages_smem(int ps, int split_tokens) {
  return sizeof(int) * (split_tokens / ps + 2);
}

template <bool QUANT>
int launch_tc(const void* q, const void* kp, const void* vp, const void* ksc,
              const void* vsc, const void* bt, const void* ctx,
              const Partials& part, void* out, int B, int Hq, int Hkv, int hd,
              int ps, int NB, int n_split, int split_tokens, float scale,
              int device, cudaStream_t stream) {
  using TP = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  int err = split_kv_tc::with_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    const size_t smem = split_kv_tc::Layout<HD, QUANT>::BYTES +
                        pages_smem(ps, split_tokens);
    cudaError_t e =
        allow_smem<paged_decode_tc<HD, QUANT>>(smem, device);
    if (e != cudaSuccess) return (int)e;
    paged_decode_tc<HD, QUANT>
        <<<dim3(B, Hkv, n_split), split_kv_tc::THREADS, smem, stream>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const TP*>(kp),
            static_cast<const TP*>(vp), static_cast<const float*>(ksc),
            static_cast<const float*>(vsc), static_cast<const int*>(bt),
            static_cast<const int*>(ctx), part, Hq, Hkv, ps, NB, n_split,
            split_tokens, scale * split_kv_tc::LOG2E);
    return (int)cudaGetLastError();
  });
  if (err) return err;
  return launch_combine<__nv_bfloat16, true>(part, out, B, Hq, hd, n_split,
                                             stream);
}

template <typename T, typename TP>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* bt, const void* ctx,
           const Partials& part, void* out, int B, int Hq, int Hkv, int hd,
           int ps, int NB, int n_split, int split_tokens, float scale,
           int device, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * state_floats(G, hd) +
                      pages_smem(ps, split_tokens);
  cudaError_t err = allow_smem<paged_decode_partial<T, TP>>(smem, device);
  if (err != cudaSuccess) return (int)err;
  paged_decode_partial<T, TP>
      <<<dim3(B, Hkv, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(bt),
      static_cast<const int*>(ctx), part, Hq, Hkv, hd, ps, NB, n_split,
      split_tokens, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<T, false>(part, out, B, Hq, hd, n_split, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 on the CUDA cores, 2 = bfloat16 on the
// tensor cores (hd a multiple of 16 up to 128, G = Hq / Hkv <= 16, q and
// the pages 16-byte aligned; else cudaErrorInvalidValue). q and the output
// are of that type. The pages are of that type when k_scales and v_scales
// are null, and int8 with f32 scales (P, ps, Hkv) when they are not. Block z
// of the partial pass covers context tokens [z * split_tokens, (z + 1) *
// split_tokens), split_tokens a positive multiple of TILE; scratch is f32
// of B * Hq * n_split * (hd + 2) floats (split_kv::Partials) with
// n_split * split_tokens >= NB * ps. hd * sizeof(page type) must be a
// multiple of 16 and the pages 16-byte aligned. Returns the cudaError_t of
// the launches.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales,
                                   const void* block_tables,
                                   const void* ctx_lens, void* scratch,
                                   void* out, int B, int Hq, int Hkv, int hd,
                                   int ps, int NB, int n_split,
                                   int split_tokens, float scale, int dtype,
                                   int device, void* stream) {
  cudaError_t err = split_kv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (split_tokens <= 0 || split_tokens % split_kv::TILE ||
      (long long)n_split * split_tokens < (long long)NB * ps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if ((k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scales != nullptr;
  const Partials part(scratch, B, Hq, n_split, hd);
#define PAGED_DECODE_ARGS                                                   \
  q, k_pages, v_pages, k_scales, v_scales, block_tables, ctx_lens, part,   \
      out, B, Hq, Hkv, hd, ps, NB, n_split, split_tokens, scale, device, s
  if (dtype == 0)
    return quant ? launch<float, int8_t>(PAGED_DECODE_ARGS)
                 : launch<float, float>(PAGED_DECODE_ARGS);
  if (dtype == 2) {
    if (Hq % Hkv ||
        !split_kv_tc::tc_ok(hd, Hq / Hkv, {q, k_pages, v_pages}))
      return (int)cudaErrorInvalidValue;
    return quant ? launch_tc<true>(PAGED_DECODE_ARGS)
                 : launch_tc<false>(PAGED_DECODE_ARGS);
  }
  return quant ? launch<__nv_bfloat16, int8_t>(PAGED_DECODE_ARGS)
               : launch<__nv_bfloat16, __nv_bfloat16>(PAGED_DECODE_ARGS);
#undef PAGED_DECODE_ARGS
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
