// Flash decode over a dense (ring) KV cache: one new token per request.
//
// Replaces: src/repro/kernels/flash_decode.py::_kernel (flash_decode).
//
// Computes, for request b and query head (h, g) of KV head h:
//   out = softmax(q . K[valid] / sqrt(hd)) . V[valid]
// over the slots l of row b of the caches (B, L, Hkv, hd) with
//   valid(l) = k_pos[b, l] >= 0 && k_pos[b, l] <= q_pos[b].
// In a ring cache (models/attention.py::ring_positions) the valid slots are
// not a prefix. Scores, running max, running sum and the accumulator are
// f32; the output is cast to the input type. A row with no valid slot gives
// exact zeros, as the Pallas kernel does (its p is zeroed by the mask and
// acc / max(l, 1e-30) = 0), not the mean of V.
//
// Bound on an H100: the bytes of K and V of the valid slots. At Hkv=4,
// hd=128 in bf16 that is 2 KB per slot and layer (0.54 GB at B=8, L=32768),
// against 2 * G = 16 flops per K/V element read: far below the ~295 flops
// per byte at which the tensor cores become the limit.
//
// Design: split-KV flash decoding, the structure of paged_decode.cu, two
// launches on one stream. The partial pass has one block per (request, KV
// head, split_tokens slice of the cache). It first compacts the slice's
// valid slots into a list in shared memory, so masked slots are never
// read; then it attends over the list and writes its (max, sum,
// accumulator) per query head into the call's scratch buffer (a slice with
// no valid slot writes (NEG_INF, 0, 0)). The combine pass
// (split_kv_decode.cuh) merges the slices. 128-slot slices give B * Hkv *
// ceil(L / 128) blocks, whatever B. Two routes, chosen by the wrapper
// (kernels/decode_route.py::tc_eligible) and passed in as the dtype code:
// * bf16 on the tensor cores (code 2): every warp ballots 32-slot chunks
//   of the slice at once, and a prefix over the chunks' counts places each
//   warp's slots; then split_kv_tc.cuh attends over the list (a cp.async
//   ring of bf16 16-slot tiles per warp, scores and P.V by mma.sync, the
//   online softmax in registers; P is rounded to bf16 before P.V, as the
//   reference's own dense decode does, attention.py:58-60).
// * the CUDA cores (f32, code 0, whose float32 twins must match the CPU to
//   1e-4; bf16 shapes the tensor cores cannot take, code 1): warp 0
//   compacts the slots (ballot + popc), then TILE slots at a time are
//   staged in shared memory as f32 and merged by split_kv_decode.cuh's
//   attend_tile.
#include "split_kv_decode.cuh"
#include "split_kv_tc.cuh"

namespace {

using namespace split_kv;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ k_pos,
                     const int* __restrict__ q_pos, Partials part, int Hq,
                     int Hkv, int hd,
                     int L, int n_split, int split_tokens, float scale) {
  constexpr int VEC = 16 / sizeof(T);
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
      bool ok = false;
      if (t < hi) {
        const int kp = k_pos[(size_t)b * L + t];
        ok = kp >= 0 && kp <= qp;
      }
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
      unpack16<T>(kraw, kf);
      unpack16<T>(vraw, vf);
      stage<VEC>(st, hd, t, c, kf, vf);
    }
    __syncthreads();
    attend_tile(st, G, hd, n, scale);
  }
  write_partials(st, b, h, split, G, Hq, hd, n_split, part.m, part.l,
                 part.acc);
}

// The tensor-core route's partial pass: one block per (request, KV head,
// slice). Every warp ballots its 32-slot chunks of the slice; a prefix over
// the chunks' counts places each chunk's valid slots in the list, in slot
// order; split_kv_tc::attend_slice then reads only those.
template <int HD>
__global__ void __launch_bounds__(split_kv_tc::THREADS)
flash_decode_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ kc,
                const __nv_bfloat16* __restrict__ vc,
                const int* __restrict__ k_pos, const int* __restrict__ q_pos,
                Partials part, int Hq, int Hkv, int L, int n_split,
                int split_tokens, float scale_log2) {
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ __align__(128) char smem_tc[];
  unsigned* masks = reinterpret_cast<unsigned*>(
      smem_tc + split_kv_tc::Layout<HD, false>::BYTES);  // [split_tokens/32]
  int* slots = reinterpret_cast<int*>(masks + split_tokens / 32);

  const int lo = split * split_tokens;
  const int hi = min(L, lo + split_tokens);
  const int n_chunks = max(0, (hi - lo + 31) / 32);
  const int qp = q_pos[b];
  for (int c = warp; c < n_chunks; c += split_kv_tc::WARPS) {
    const int t = lo + c * 32 + lane;
    bool ok = false;
    if (t < hi) {
      const int kp = k_pos[(size_t)b * L + t];
      ok = kp >= 0 && kp <= qp;
    }
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
  split_kv_tc::attend_slice<HD, false>(
      q + ((size_t)b * Hq + (size_t)h * G) * HD, G, kc, vc, nullptr, nullptr,
      n, rows, scale_log2, smem_tc, part,
      ((size_t)b * Hq + (size_t)h * G) * n_split + split, n_split);
}

int launch_tc(const void* q, const void* kc, const void* vc,
              const void* k_pos, const void* q_pos, const Partials& part,
              void* out, int B, int Hq, int Hkv, int hd, int L, int n_split,
              int split_tokens, float scale, int device,
              cudaStream_t stream) {
  int err = split_kv_tc::with_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    const size_t smem = split_kv_tc::Layout<HD, false>::BYTES +
                        sizeof(int) * (split_tokens / 32 + split_tokens);
    cudaError_t e = allow_smem<flash_decode_tc<HD>>(smem, device);
    if (e != cudaSuccess) return (int)e;
    flash_decode_tc<HD>
        <<<dim3(B, Hkv, n_split), split_kv_tc::THREADS, smem, stream>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(kc),
            static_cast<const __nv_bfloat16*>(vc),
            static_cast<const int*>(k_pos), static_cast<const int*>(q_pos),
            part, Hq, Hkv, L, n_split, split_tokens,
            scale * split_kv_tc::LOG2E);
    return (int)cudaGetLastError();
  });
  if (err) return err;
  return launch_combine<__nv_bfloat16, true>(part, out, B, Hq, hd, n_split,
                                             stream);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* k_pos,
           const void* q_pos, const Partials& part, void* out, int B, int Hq,
           int Hkv, int hd, int L, int n_split, int split_tokens, float scale,
           int device, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * state_floats(G, hd) +
                      sizeof(int) * (split_tokens + 1);
  cudaError_t err = allow_smem<flash_decode_partial<T>>(smem, device);
  if (err != cudaSuccess) return (int)err;
  flash_decode_partial<T><<<dim3(B, Hkv, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(k_pos),
      static_cast<const int*>(q_pos), part, Hq, Hkv, hd, L, n_split,
      split_tokens, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<T, false>(part, out, B, Hq, hd, n_split, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 on the CUDA cores, 2 = bfloat16 on the
// tensor cores (hd a multiple of 16 up to 128, G = Hq / Hkv <= 16, q and
// the caches 16-byte aligned, split_tokens a multiple of 32; else
// cudaErrorInvalidValue), of q, the caches and the output. q (B, Hq, hd);
// k_cache, v_cache (B, L, Hkv, hd); k_pos (B, L) and q_pos (B,) int32, all
// contiguous. Block z of the partial pass covers slots [z * split_tokens,
// (z + 1) * split_tokens); scratch is f32 of B * Hq * n_split * (hd + 2)
// floats (split_kv::Partials) with n_split * split_tokens >= L.
// hd * sizeof(T) must be a multiple of 16 and the caches 16-byte aligned.
// Returns the cudaError_t of the launches.
extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_pos,
                                   const void* q_pos, void* scratch,
                                   void* out, int B, int Hq, int Hkv, int hd,
                                   int L, int n_split, int split_tokens,
                                   float scale, int dtype, int device,
                                   void* stream) {
  cudaError_t err = split_kv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (split_tokens <= 0 || (long long)n_split * split_tokens < L)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Partials part(scratch, B, Hq, n_split, hd);
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, k_pos, q_pos, part, out, B, Hq,
                         Hkv, hd, L, n_split, split_tokens, scale, device, s);
  if (dtype == 2) {
    if (Hq % Hkv || split_tokens % 32 ||
        !split_kv_tc::tc_ok(hd, Hq / Hkv, {q, k_cache, v_cache}))
      return (int)cudaErrorInvalidValue;
    return launch_tc(q, k_cache, v_cache, k_pos, q_pos, part, out, B, Hq,
                     Hkv, hd, L, n_split, split_tokens, scale, device, s);
  }
  return launch<__nv_bfloat16>(q, k_cache, v_cache, k_pos, q_pos, part, out,
                               B, Hq, Hkv, hd, L, n_split, split_tokens,
                               scale, device, s);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
