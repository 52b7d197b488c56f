// Flash decode over a dense (ring) KV cache: one new token per request.
//
// Replaces: src/repro/kernels/flash_decode.py::_kernel (flash_decode), and
// the dense decode of src/repro/models/transformer.py::attention_block
// around it (sliding window, logit softcap, int8 cache: the reference's
// attention.py::_attend_one_kv_block with one query).
//
// Computes, for request b and query head (h, g) of KV head h:
//   s(l)  = q . K[l] / sqrt(hd), then cap * tanh(s / cap) when cap > 0
//   out   = softmax(s[valid]) . V[valid]
// over the slots l of row b of the caches (B, L, Hkv, hd) with
//   valid(l) = 0 <= k_pos[b, l] <= q_pos[b]
//              && (window <= 0 || k_pos[b, l] > q_pos[b] - window).
// In a ring cache (models/attention.py::ring_positions) the valid slots are
// not a prefix. An int8 cache comes with f32 scales (B, L, Hkv); each
// element is dequantized as bf16(code * scale), the reference's rounding,
// whatever q's type. Scores, running max, running sum and the accumulator
// are f32; the output is cast to q's type. A row with no valid slot gives
// exact zeros, as the Pallas kernel does (its p is zeroed by the mask and
// acc / max(l, 1e-30) = 0), not the mean of V.
//
// Bound on an H100: the bytes of K and V of the valid slots (and their
// scales on an int8 cache). At Hkv=4, hd=128 in bf16 that is 2 KB per slot
// and layer (0.54 GB at B=8, L=32768), against 2 * G = 16 flops per K/V
// element read: far below the ~295 flops per byte at which the tensor
// cores become the limit. A window only shrinks the valid set.
//
// Design: split-KV flash decoding, the structure of paged_decode.cu, two
// launches on one stream. The partial pass has one block per (request, KV
// head, split_tokens slice of the cache). It first compacts the slice's
// valid slots (the window is part of the test) into a list in shared
// memory, so masked slots are never read; then it attends over the list
// and writes its (max, sum, accumulator) per query head into the call's
// scratch buffer (a slice with no valid slot writes (NEG_INF, 0, 0)). The
// combine pass (split_kv_decode.cuh) merges the slices. 128-slot slices
// give B * Hkv * ceil(L / 128) blocks, whatever B. Two routes, chosen by
// the wrapper (kernels/decode_route.py::tc_eligible) and passed in as the
// dtype code:
// * bf16 q on the tensor cores (code 2; hd a multiple of 16 up to 128):
//   every warp ballots 32-slot chunks of the slice at once, and a prefix
//   over the chunks' counts places each warp's slots; then split_kv_tc.cuh
//   attends over the list (a cp.async ring of 16-slot tiles per warp,
//   scores and P.V by mma.sync, the softcap and the online softmax in
//   registers; P is rounded to bf16 before P.V, as the reference's own
//   dense decode does, attention.py:58-60). An int8 cache is read as raw
//   codes and scales and converted to bf16(code * scale) tiles in shared
//   memory (split_kv_tc's DEQ mode).
// * the CUDA cores (f32, code 0, whose float32 twins must match the CPU to
//   1e-4; bf16 shapes the tensor cores cannot take, code 1, among them
//   hd = 256 of the gemmas): warp 0 compacts the slots (ballot + popc),
//   then TILE slots at a time are staged in shared memory as f32 (int8
//   dequantized and rounded as above) and merged by split_kv_decode.cuh's
//   attend_tile, which applies the softcap.
#include <type_traits>

#include "split_kv_decode.cuh"
#include "split_kv_tc.cuh"

namespace {

using namespace split_kv;

// Whether slot position kp is attended by the query at position qp.
__device__ __forceinline__ bool slot_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

// T: query/output type; TK: cache type (T, or int8_t with scales ksc/vsc)
template <typename T, typename TK>
__global__ void __launch_bounds__(THREADS)
flash_decode_partial(const T* __restrict__ q, const TK* __restrict__ kc,
                     const TK* __restrict__ vc, const float* __restrict__ ksc,
                     const float* __restrict__ vsc,
                     const int* __restrict__ k_pos,
                     const int* __restrict__ q_pos, Partials part, int Hq,
                     int Hkv, int hd, int L, int n_split, int split_tokens,
                     int window, float scale, float cap) {
  constexpr int VEC = 16 / sizeof(TK);
  constexpr bool QUANT = std::is_same<TK, int8_t>::value;
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = Hq / Hkv;

  extern __shared__ float smem[];
  const State st(smem, G, hd);
  int* n_valid = reinterpret_cast<int*>(st.end(G));   // [1]
  int* slots = n_valid + 1;                            // [split_tokens]

  const int lo = split * split_tokens;
  const int hi = min(L, lo + split_tokens);
  if (tid < 32) {              // warp 0: compact the valid slots of [lo, hi)
    const int qp = q_pos[b];
    int base = 0;
    for (int t0 = lo; t0 < hi; t0 += 32) {
      const int t = t0 + tid;
      const bool ok = t < hi && slot_valid(k_pos[(size_t)b * L + t], qp,
                                           window);
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (ok) slots[base + __popc(mask & ((1u << tid) - 1u))] = t;
      base += __popc(mask);
    }
    if (tid == 0) *n_valid = base;
  }
  init_state(st, q + ((size_t)b * Hq + (size_t)h * G) * hd, G, hd);
  __syncthreads();

  const int n_slots = *n_valid;
  const int row_vecs = hd / VEC;
  for (int t0 = 0; t0 < n_slots; t0 += TILE) {
    const int n = min(TILE, n_slots - t0);
#pragma unroll 2
    for (int i = tid; i < n * row_vecs; i += blockDim.x) {
      const int t = i / row_vecs, c = i - t * row_vecs;
      const size_t row = ((size_t)b * L + slots[t0 + t]) * Hkv + h;
      const size_t off = row * hd + c * VEC;
      const uint4 kraw = *reinterpret_cast<const uint4*>(kc + off);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vc + off);
      float kf[VEC], vf[VEC];
      unpack16<TK>(kraw, kf);
      unpack16<TK>(vraw, vf);
      if constexpr (QUANT) {   // bf16(code * scale), the reference's value
        const float k_scale = ksc[row], v_scale = vsc[row];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          kf[j] = __bfloat162float(__float2bfloat16(kf[j] * k_scale));
          vf[j] = __bfloat162float(__float2bfloat16(vf[j] * v_scale));
        }
      }
      stage<VEC>(st, hd, t, c, kf, vf);
    }
    __syncthreads();
    attend_tile(st, G, hd, n, scale, cap);
  }
  write_partials(st, b, h, split, G, Hq, hd, n_split, part.m, part.l,
                 part.acc);
}

// The tensor-core route's partial pass: one block per (request, KV head,
// slice). Every warp ballots its 32-slot chunks of the slice; a prefix over
// the chunks' counts places each chunk's valid slots in the list, in slot
// order; split_kv_tc::attend_slice then reads only those.
template <int HD, bool QUANT>
__global__ void __launch_bounds__(split_kv_tc::THREADS)
flash_decode_tc(const __nv_bfloat16* __restrict__ q,
                const typename std::conditional<QUANT, int8_t,
                                                __nv_bfloat16>::type* kc,
                const typename std::conditional<QUANT, int8_t,
                                                __nv_bfloat16>::type* vc,
                const float* __restrict__ ksc, const float* __restrict__ vsc,
                const int* __restrict__ k_pos, const int* __restrict__ q_pos,
                Partials part, int Hq, int Hkv, int L, int n_split,
                int split_tokens, int window, float scale, float cap) {
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ __align__(128) char smem_tc[];
  unsigned* masks = reinterpret_cast<unsigned*>(
      smem_tc + split_kv_tc::Layout<HD, QUANT>::BYTES);  // [split_tokens/32]
  int* slots = reinterpret_cast<int*>(masks + split_tokens / 32);

  const int lo = split * split_tokens;
  const int hi = min(L, lo + split_tokens);
  const int n_chunks = max(0, (hi - lo + 31) / 32);
  const int qp = q_pos[b];
  for (int c = warp; c < n_chunks; c += split_kv_tc::WARPS) {
    const int t = lo + c * 32 + lane;
    const bool ok = t < hi && slot_valid(k_pos[(size_t)b * L + t], qp,
                                         window);
    const unsigned mask = __ballot_sync(~0u, ok);
    if (lane == 0) masks[c] = mask;
  }
  __syncthreads();
  int n = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const unsigned mask = masks[c];
    if (c % split_kv_tc::WARPS == warp && (mask >> lane & 1))
      slots[n + __popc(mask & ((1u << lane) - 1u))] = lo + c * 32 + lane;
    n += __popc(mask);
  }
  __syncthreads();
  const auto rows = [&](int i) -> size_t {
    return ((size_t)b * L + slots[i]) * Hkv + h;
  };
  split_kv_tc::attend_slice<HD, QUANT, QUANT>(
      q + ((size_t)b * Hq + (size_t)h * G) * HD, G, kc, vc, ksc, vsc, n,
      rows, scale * split_kv_tc::LOG2E, smem_tc, part,
      ((size_t)b * Hq + (size_t)h * G) * n_split + split, n_split, cap,
      scale);
}

template <bool QUANT>
int launch_tc(const void* q, const void* kc, const void* vc, const void* ksc,
              const void* vsc, const void* k_pos, const void* q_pos,
              const Partials& part, void* out, int B, int Hq, int Hkv, int hd,
              int L, int n_split, int split_tokens, int window, float scale,
              float cap, int device, cudaStream_t stream) {
  using TK = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  int err = split_kv_tc::with_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    const size_t smem = split_kv_tc::Layout<HD, QUANT>::BYTES +
                        sizeof(int) * (split_tokens / 32 + split_tokens);
    cudaError_t e = allow_smem<flash_decode_tc<HD, QUANT>>(smem, device);
    if (e != cudaSuccess) return (int)e;
    flash_decode_tc<HD, QUANT>
        <<<dim3(B, Hkv, n_split), split_kv_tc::THREADS, smem, stream>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const TK*>(kc),
            static_cast<const TK*>(vc), static_cast<const float*>(ksc),
            static_cast<const float*>(vsc), static_cast<const int*>(k_pos),
            static_cast<const int*>(q_pos), part, Hq, Hkv, L, n_split,
            split_tokens, window, scale, cap);
    return (int)cudaGetLastError();
  });
  if (err) return err;
  return launch_combine<__nv_bfloat16, true>(part, out, B, Hq, hd, n_split,
                                             stream);
}

template <typename T, typename TK>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* k_pos, const void* q_pos,
           const Partials& part, void* out, int B, int Hq, int Hkv, int hd,
           int L, int n_split, int split_tokens, int window, float scale,
           float cap, int device, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * state_floats(G, hd) +
                      sizeof(int) * (split_tokens + 1);
  cudaError_t err = allow_smem<flash_decode_partial<T, TK>>(smem, device);
  if (err != cudaSuccess) return (int)err;
  flash_decode_partial<T, TK>
      <<<dim3(B, Hkv, n_split), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const TK*>(kc),
          static_cast<const TK*>(vc), static_cast<const float*>(ksc),
          static_cast<const float*>(vsc), static_cast<const int*>(k_pos),
          static_cast<const int*>(q_pos), part, Hq, Hkv, hd, L, n_split,
          split_tokens, window, scale, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<T, false>(part, out, B, Hq, hd, n_split, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 on the CUDA cores, 2 = bfloat16 on the
// tensor cores (hd a multiple of 16 up to 128, G = Hq / Hkv <= 16, q and
// the caches 16-byte aligned, split_tokens a multiple of 32; else
// cudaErrorInvalidValue), of q and the output. The caches are of that type
// when k_scales and v_scales are null, and int8 with f32 scales (B, L, Hkv)
// when they are not. q (B, Hq, hd); k_cache, v_cache (B, L, Hkv, hd); k_pos
// (B, L) and q_pos (B,) int32, all contiguous. window <= 0: no window;
// softcap <= 0: no cap. Block z of the partial pass covers slots
// [z * split_tokens, (z + 1) * split_tokens); scratch is f32 of B * Hq *
// n_split * (hd + 2) floats (split_kv::Partials) with n_split *
// split_tokens >= L. hd * sizeof(cache type) must be a multiple of 16 and
// the caches 16-byte aligned. Returns the cudaError_t of the launches.
extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_scales,
                                   const void* v_scales, const void* k_pos,
                                   const void* q_pos, void* scratch,
                                   void* out, int B, int Hq, int Hkv, int hd,
                                   int L, int n_split, int split_tokens,
                                   int window, float scale, float softcap,
                                   int dtype, int device, void* stream) {
  cudaError_t err = split_kv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (split_tokens <= 0 || (long long)n_split * split_tokens < L)
    return (int)cudaErrorInvalidValue;
  if ((k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scales != nullptr;
  const Partials part(scratch, B, Hq, n_split, hd);
#define FLASH_DECODE_ARGS                                                    \
  q, k_cache, v_cache, k_scales, v_scales, k_pos, q_pos, part, out, B, Hq,  \
      Hkv, hd, L, n_split, split_tokens, window, scale, softcap, device, s
  if (dtype == 0)
    return quant ? launch<float, int8_t>(FLASH_DECODE_ARGS)
                 : launch<float, float>(FLASH_DECODE_ARGS);
  if (dtype == 2) {
    if (Hq % Hkv || split_tokens % 32 ||
        !split_kv_tc::tc_ok(hd, Hq / Hkv, {q, k_cache, v_cache}))
      return (int)cudaErrorInvalidValue;
    return quant ? launch_tc<true>(FLASH_DECODE_ARGS)
                 : launch_tc<false>(FLASH_DECODE_ARGS);
  }
  return quant ? launch<__nv_bfloat16, int8_t>(FLASH_DECODE_ARGS)
               : launch<__nv_bfloat16, __nv_bfloat16>(FLASH_DECODE_ARGS);
#undef FLASH_DECODE_ARGS
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
