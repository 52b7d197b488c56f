// The tensor-core route of the two decode kernels: paged_decode.cu, which
// replaces src/repro/kernels/paged_decode.py::_kernel (paged_decode_pallas),
// and flash_decode.cu, which replaces src/repro/kernels/flash_decode.py::
// _kernel (flash_decode). bf16 q, bf16 or int8 K/V, f32 partials, for hd a
// multiple of 16 up to 128 and G = Hq / Hkv <= 16 query heads per KV head
// (kernels/decode_route.py::tc_eligible, checked again by the entry
// points). One block of WARPS warps per (request, KV head, slice of the
// context), as on the CUDA-core route of split_kv_decode.cuh; attend_slice
// below is the block's whole partial pass, the caller only says where the
// slice's K/V rows are.
//
// Bound on an H100: the bytes of K and V (2 KB per token and layer at
// Hkv = 4, hd = 128 in bf16: 0.6 us per 1024 tokens of a batch at 3.35
// TB/s). A K/V element carries 2 * G = 16 flops at G = 8, far below the
// ~295 flops per byte at which the tensor cores become the limit, so the
// design keeps the copies in flight and spends as few instructions per byte
// as it can:
// - Copies: each warp owns the slice's 16-token tiles w, w + WARPS, ... and
//   streams them through its own STAGES-deep ring in shared memory by
//   16-byte cp.async (rows past the slice are zero-filled). With 128-token
//   slices a warp's two tiles are both in flight before it scores the
//   first. K/V stay bf16 in shared memory (rows padded by 16 bytes, so the
//   ldmatrix reads are conflict-free); nothing is staged as f32.
// - Scores on the tensor cores: mma.sync.m16n8k16, bf16 in, f32 out. The
//   G query heads are the A operand's rows, zero-padded to 16 (the padding
//   costs tensor-core time that is nowhere near the limit); q is loaded once
//   per block into registers as hd / 16 A fragments; K rows feed B by
//   ldmatrix (a K row [t][d] is a column of B).
// - The online softmax in registers: a row's 16 scores of a tile sit in the
//   4 lanes of a quad, so its max is two __shfl_xor_sync; exp2f on scores
//   pre-scaled by hd^-1/2 * log2 e. Each warp keeps its own (m, l, acc)
//   over its tiles (l as per-lane partial sums, reduced once), and the
//   warps merge once at the end of the slice through shared memory, in
//   warp order. No block barrier inside the token loop.
// - P.V on the tensor cores: the f32 score fragments of two adjacent n8
//   tiles are re-packed in registers into one bf16 A fragment (the C
//   layout of m16n8 tiles t and t + 1 is the A layout of one m16k16 tile);
//   V feeds B by ldmatrix.trans; acc is 16 x hd f32 in registers.
//
// Numerics. P is rounded to bf16 before the P.V product, where the Pallas
// flash_decode and paged_decode keep it f32; the reference's own dense
// decode (src/repro/models/attention.py:58-60) casts it the same way. The
// running max, the sum l (of the unrounded p) and acc stay f32; against
// the f32 plain version the difference stays within the bf16 bar of 3e-2.
// Int8 K/V: the codes are converted to bf16 in a pass from the raw ring
// into one bf16 K and V tile per warp. Two ways, by the DEQ parameter:
// - DEQ false (paged_decode, whose reference dequantizes in f32): the codes
//   convert exactly (|v| <= 127); the K scale multiplies the score after
//   q . codes (s_t = k_scale[t] * (q . codes_t) * hd^-1/2), the V scale
//   multiplies p before its bf16 cast (p_t * v_scale[t]) while l sums the
//   unscaled p, so no dequantized value is ever rounded to bf16.
// - DEQ true (flash_decode, whose reference dense cache dequantizes as
//   (code * scale) rounded to bf16, src/repro/models/attention.py:35-38):
//   the pass writes bf16(code * scale) with the row's own scale, and the
//   scores and p are those of a bf16 cache.
// A logit softcap (cap > 0, the dense cache of gemma2) replaces the scaled
// score s by cap * tanh(s / cap), in registers after the score mma and
// before the mask. A masked token's p is exactly 0 (set, not computed:
// -1e30 * log2 e stays finite). A slice with no token writes max NEG_INF
// and sum 0 and returns at once, without its accumulator: the combine gives
// such a slice the weight 0 and never reads it.
//
// Batch invariance: a block's work depends only on its own slice (tiles,
// warps and the merge order follow token positions in the slice), and the
// combine adds the slices in order, an empty slice as exact zeros. So a
// request's output row is bitwise the same alone, in any batch, and with a
// wider block table or cache.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "ptx.cuh"
#include "split_kv_decode.cuh"

namespace {
namespace split_kv_tc {

using namespace ptx;
using split_kv::NEG_INF;
using split_kv::Partials;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TOK = 16;       // tokens of a warp tile: n16 of q.k, k16 of P.V
constexpr int STAGES = 2;     // per-warp ring depth
constexpr int MAX_G = 16;     // rows of the A operand
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory of a block, in bytes. Per warp: STAGES stages,
// each the tile's K then V (bf16 rows of LD elements; or int8 rows of HD
// bytes followed by the 16 K and 16 V scales), and on int8 pages one bf16
// K and V tile the codes are converted into. After the token loop the ring
// is reused for the merge: m and l [WARPS][MAX_G], acc [WARPS][MAX_G][HD]
// in rows of HD + 8 floats (the quads' stores of one column pair then fill
// distinct banks).
template <int HD, bool QUANT>
struct Layout {
  static constexpr int LD = HD + 8;
  static constexpr int TILE = TOK * LD * 2;
  static constexpr int RAW = TOK * HD;
  static constexpr int STAGE = QUANT ? 2 * RAW + 2 * TOK * 4 : 2 * TILE;
  static constexpr int WARP = STAGES * STAGE + (QUANT ? 2 * TILE : 0);
  static constexpr int RING = WARPS * WARP;
  static constexpr int ALD = HD + 8;
  static constexpr int MERGE = WARPS * MAX_G * (ALD + 2) * 4;
  static constexpr int BYTES = RING > MERGE ? RING : MERGE;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The partial pass of one block over the n tokens of its slice, for the G
// query heads whose q rows (HD bf16 each) start at q. Token i of the slice
// is row rows(i) of the K/V tensors: its values at kp/vp + rows(i) * HD,
// its scales (int8) at ksc/vsc[rows(i)]. scale_log2 = hd^-1/2 * log2 e;
// cap > 0 caps the scores (cap_scale = hd^-1/2 then). Writes, for g < G,
// row row0 + g * n_split of the partials: max (log2 units), sum, acc.
// Every thread of the block calls it; smem holds Layout<HD, QUANT>::BYTES.
template <int HD, bool QUANT, bool DEQ = false, typename Rows>
__device__ __forceinline__ void attend_slice(
    const __nv_bfloat16* __restrict__ q, int G,
    const typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type*
        __restrict__ kp,
    const typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type*
        __restrict__ vp,
    const float* __restrict__ ksc, const float* __restrict__ vsc, int n,
    const Rows& rows, float scale_log2, char* smem, const Partials& part,
    size_t row0, int n_split, float cap = 0.f, float cap_scale = 0.f) {
  using Lay = Layout<HD, QUANT>;
  constexpr int KT = HD / 16;                  // k16 steps of q . k
  constexpr int NT = HD / 8;                   // n8 tiles of acc
  constexpr int EL = QUANT ? 1 : 2;            // bytes of a K/V element
  constexpr int CH = HD * EL / 16;             // 16-byte chunks of a row
  constexpr int ROW = QUANT ? HD : Lay::LD * 2;  // a row's bytes in a stage
  constexpr int V_OFF = QUANT ? Lay::RAW : Lay::TILE;
  if (n == 0) {                   // (NEG_INF, 0); the combine skips acc
    for (int g = threadIdx.x; g < G; g += THREADS) {
      part.m[row0 + (size_t)g * n_split] = NEG_INF;
      part.l[row0 + (size_t)g * n_split] = 0.f;
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;   // the C fragment's row, pair

  // q as A fragments: a[0] rows gid, a[1] rows gid + 8, columns 2 tig (+1);
  // a[2], a[3] the same 8 columns further. Rows >= G are zero.
  uint32_t qa[KT][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int d = kk * 16 + 2 * tig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = gid + 8 * (j & 1);
        qa[kk][j] = g < G ? q32[(g * HD + d + 8 * (j >> 1)) / 2] : 0u;
      }
    }
  }
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows gid, gid + 8

  const int n_tiles = (n + TOK - 1) / TOK;
  const int mine = warp < n_tiles ? (n_tiles - 1 - warp) / WARPS + 1 : 0;
  char* wsm = smem + warp * Lay::WARP;
  const uint32_t ring = smem_addr(wsm);

  // Copies the warp's it-th tile into stage it % STAGES.
  auto issue = [&](int it) {
    const int t0 = (warp + it * WARPS) * TOK;
    const uint32_t st = ring + (it % STAGES) * Lay::STAGE;
#pragma unroll
    for (int i = lane; i < TOK * CH; i += 32) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = t0 + r < n;
      const size_t off = ok ? rows(t0 + r) * HD + c * (16 / EL) : 0;
      cp_async16(st + r * ROW + c * 16, kp + off, ok);
      cp_async16(st + V_OFF + r * ROW + c * 16, vp + off, ok);
    }
    if constexpr (QUANT) {        // lanes 0-15 the K scales, 16-31 the V
      const int r = lane & 15;
      const bool ok = t0 + r < n;
      const size_t row = ok ? rows(t0 + r) : 0;
      cp_async4(st + 2 * Lay::RAW + lane * 4, (lane < 16 ? ksc : vsc) + row,
                ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine) issue(s);
    cp_async_commit();
  }
  const int mi = lane >> 3, ri = lane & 7;     // ldmatrix: matrix, row
  for (int it = 0; it < mine; ++it) {
    // refill the stage of tile it - 1 first, so STAGES tiles are in flight
    // while the warp waits for tile it
    if (it + STAGES - 1 < mine) issue(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();                 // tile it landed for every lane
    const int t0 = (warp + it * WARPS) * TOK;
    const int stage = (it % STAGES) * Lay::STAGE;
    uint32_t kt = ring + stage, vt = kt + Lay::TILE;
    const float* sc = nullptr;    // int8 pages: K scales, then V scales
    if constexpr (QUANT) {
      const char* raw = wsm + stage;
      char* tiles = wsm + STAGES * Lay::STAGE;
      sc = reinterpret_cast<const float*>(raw + 2 * Lay::RAW);
      constexpr int RCH = HD / 16;
#pragma unroll
      for (int i = lane; i < 2 * TOK * RCH; i += 32) {
        const int kv = i / (TOK * RCH), j = i - kv * TOK * RCH;
        const int r = j / RCH, c = j - r * RCH;
        const uint4 w =
            *reinterpret_cast<const uint4*>(raw + kv * Lay::RAW + r * HD +
                                            c * 16);
        const int8_t* v = reinterpret_cast<const int8_t*>(&w);
        const float f = DEQ ? sc[kv * TOK + r] : 1.f;
        uint4 o[2];
        uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o32[e] = DEQ ? pack_bf16((float)v[2 * e] * f,
                                   (float)v[2 * e + 1] * f)
                       : pack_bf16((float)v[2 * e], (float)v[2 * e + 1]);
        uint4* dst = reinterpret_cast<uint4*>(
            tiles + kv * Lay::TILE + (r * Lay::LD + c * 16) * 2);
        dst[0] = o[0];
        dst[1] = o[1];
      }
      kt = smem_addr(tiles);
      vt = kt + Lay::TILE;
      __syncwarp();
    }

    // s[nt][e]: row gid + 8 (e >> 1), token nt * 8 + 2 tig + (e & 1)
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t kb[4];           // tokens 0-7 | 8-15 x columns lo | hi 8
      ldsm_x4(kt + (((mi >> 1) * 8 + ri) * Lay::LD + kk * 16 + (mi & 1) * 8) *
                       2,
              kb);
      mma_bf16(s[0], qa[kk], kb[0], kb[1]);
      mma_bf16(s[1], qa[kk], kb[2], kb[3]);
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = nt * 8 + 2 * tig + (e & 1);
        // cap > 0 comes only with bf16 or DEQ tiles, whose scores need
        // no K scale
        float v = cap > 0.f ? cap * tanhf(s[nt][e] * cap_scale / cap) * LOG2E
                            : s[nt][e] * scale_log2;
        if constexpr (QUANT && !DEQ) v *= sc[t];
        v = t0 + t < n ? v : NEG_INF;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      c[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= c[r];
    }
    // P as one A fragment: tiles nt = 0, 1 are its columns 0-7, 8-15
    uint32_t pa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = nt * 8 + 2 * tig;
        float p0 = t0 + t < n ? exp2f(s[nt][2 * r] - m[r]) : 0.f;
        float p1 = t0 + t + 1 < n ? exp2f(s[nt][2 * r + 1] - m[r]) : 0.f;
        l[r] += p0 + p1;
        if constexpr (QUANT && !DEQ) {
          p0 *= sc[TOK + t];
          p1 *= sc[TOK + t + 1];
        }
        pa[nt * 2 + r] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][0] *= c[0];
      acc[i][1] *= c[0];
      acc[i][2] *= c[1];
      acc[i][3] *= c[1];
    }
#pragma unroll
    for (int dd = 0; dd < KT; ++dd) {
      uint32_t vb[4];           // tokens 0-7 | 8-15 x columns lo | hi 8
      ldsm_x4_trans(
          vt + (((mi & 1) * 8 + ri) * Lay::LD + dd * 16 + (mi >> 1) * 8) * 2,
          vb);
      mma_bf16(acc[2 * dd], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * dd + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();                 // every lane is done with tile it's stage
  }
  cp_async_wait<0>();

  // Merge the warps: each rescales to the slice's max, summed in warp order.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
  }
  __syncthreads();                // every warp is done with its ring
  float* mw = reinterpret_cast<float*>(smem);
  float* lw = mw + WARPS * MAX_G;
  float* aw = lw + WARPS * MAX_G;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = gid + 8 * r;
    if (tig == 0) {
      mw[warp * MAX_G + g] = m[r];
      lw[warp * MAX_G + g] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
      *reinterpret_cast<float2*>(aw + (warp * MAX_G + g) * Lay::ALD +
                                 i * 8 + 2 * tig) =
          make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i - g * HD;
    float mg = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mg = fmaxf(mg, mw[w * MAX_G + g]);
    float a = 0.f, lg = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(mw[w * MAX_G + g] - mg);
      a += aw[(w * MAX_G + g) * Lay::ALD + d] * f;
      lg += lw[w * MAX_G + g] * f;
    }
    const size_t row = row0 + (size_t)g * n_split;
    part.acc[row * HD + d] = a;
    if (d == 0) {
      part.m[row] = mg;
      part.l[row] = lg;
    }
  }
}

// The route's preconditions, checked again on this side of the wrapper.
inline bool tc_ok(int hd, int G, std::initializer_list<const void*> ptrs) {
  if (hd % 16 || hd < 16 || hd > 128 || G < 1 || G > MAX_G) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// f(std::integral_constant<int, HD>{}) for hd = HD in 16, 32, ..., 128.
template <typename F>
int with_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace split_kv_tc
}  // namespace
