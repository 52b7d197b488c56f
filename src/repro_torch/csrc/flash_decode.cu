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
// hd=128 in bf16 that is 2 KB per slot and layer, against 2 * G = 16 flops
// per K/V element read: far below the ~295 flops per byte at which the
// tensor cores become the limit.
//
// Design (split-KV flash decoding, the structure of paged_decode.cu, two
// launches on one stream):
//  1. partial pass, one block per (request, KV head, split_tokens slice of
//     the cache). Warp 0 reads the slice's k_pos and compacts the valid
//     slots into a list in shared memory (ballot + popc), so slots that are
//     masked are never read. The block then walks the list TILE slots at a
//     time: K and V rows come in as 16-byte vector loads straight from the
//     cache row and are staged in shared memory as f32, each thread scores
//     (head, slot) pairs, one thread per head runs the online-softmax
//     update, and the accumulator (G x hd f32) stays in shared memory. It
//     writes its (max, sum, accumulator) per query head; a slice with no
//     valid slot writes (NEG_INF, 0, 0).
//  2. combine pass, one block per (request, query head): rescales the
//     slices' partials to the global max and divides by the global sum.
// 128-slot slices give B * Hkv * ceil(L / 128) blocks (256 at B=8, Hkv=4,
// L=1024). The tile step, the partials and the combine pass are
// split_kv_decode.cuh, shared with paged_decode.cu. Tensor-core scoring and
// a fused combine are later work.
#include "split_kv_decode.cuh"

namespace {

using namespace split_kv;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ k_pos,
                     const int* __restrict__ q_pos,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part, int Hq, int Hkv, int hd,
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
  write_partials(st, b, h, split, G, Hq, hd, n_split, m_part, l_part,
                 acc_part);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* k_pos,
           const void* q_pos, void* m_part, void* l_part, void* acc_part,
           void* out, int B, int Hq, int Hkv, int hd, int L, int n_split,
           int split_tokens, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * state_floats(G, hd) +
                      sizeof(int) * (split_tokens + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_decode_partial<T><<<dim3(B, Hkv, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(k_pos),
      static_cast<const int*>(q_pos), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), Hq, Hkv,
      hd, L, n_split, split_tokens, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<T>(m_part, l_part, acc_part, out, B, Hq, hd,
                           n_split, stream);
}

}  // namespace

// dtype (of q, the caches and the output): 0 = float32, 1 = bfloat16.
// q (B, Hq, hd); k_cache, v_cache (B, L, Hkv, hd); k_pos (B, L) and q_pos
// (B,) int32, all contiguous. Block z of the partial pass covers slots
// [z * split_tokens, (z + 1) * split_tokens); m_part/l_part (B, Hq,
// n_split) and acc_part (B, Hq, n_split, hd) are f32 scratch with
// n_split * split_tokens >= L. hd * sizeof(T) must be a multiple of 16 and
// the caches 16-byte aligned. Returns the cudaError_t of the launches.
extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_pos,
                                   const void* q_pos, void* m_part,
                                   void* l_part, void* acc_part, void* out,
                                   int B, int Hq, int Hkv, int hd, int L,
                                   int n_split, int split_tokens, float scale,
                                   int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (split_tokens <= 0 || (long long)n_split * split_tokens < L)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, k_pos, q_pos, m_part, l_part,
                         acc_part, out, B, Hq, Hkv, hd, L, n_split,
                         split_tokens, scale, s);
  return launch<__nv_bfloat16>(q, k_cache, v_cache, k_pos, q_pos, m_part,
                               l_part, acc_part, out, B, Hq, Hkv, hd, L,
                               n_split, split_tokens, scale, s);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
