// Paged chunked-prefill attention: a chunk of S new query tokens per lane
// against the lane's paged KV context (the earlier chunks and this one),
// causal.
//
// Replaces no Pallas kernel: the reference's chunked-prefill attention (the
// block-table gather in src/repro/models/transformer.py::_paged_attention,
// then src/repro/models/attention.py::flash_attention) is plain JAX. It
// replaces the port's plain route of the same function
// (kernels/paged_prefill.py::paged_prefill_attention_plain), which gathers
// the whole block table (NB * ps slots a lane, whatever its context) and
// runs a Python loop of f32 torch ops over 512 x 512 tiles.
//
// Computes, for lane b, KV head h, query head h * G + g and chunk row i at
// position p = chunk_starts[b] + i, a real row while p < ctx_lens[b]:
//   out = softmax(q . K[0:p+1] / sqrt(hd)) . V[0:p+1]
// where token t of the lane lives at page block_tables[b, t / ps], slot
// t % ps. Rows past the chunk (p >= ctx_lens[b]) and lanes with no chunk
// (ctx_lens[b] == chunk_starts[b]) are written as exact zeros.
//
// Bound on an H100: the tensor cores. A 2048-token chunk from position 0 at
// 32 query heads of 128 is 4 * 32 * 128 * 2048 * 2049 / 2 = 34.4 GFLOP of
// causal products (34.8 us at 989 TFLOP/s) against 4.2 MB of live K/V pages
// (1.3 us at 3.35 TB/s). So the design spends the tensor cores on live
// work only and keeps every intermediate on chip:
// - The block: one per (lane, KV head, query tile of 128 rows). A row is a
//   (token, query head) pair of the KV head's group, rows ordered token by
//   token, so the G = Hq / Hkv heads that read one K/V page sit in the M
//   dimension of the same products (16 tokens x 8 heads at qwen3-moe,
//   25.6 x 5 at llama4; a tile may start inside a token's group).
// - The walk: the block reads its lane's block table up to the causal
//   horizon of its last real row (min(ctx, last position + 1)), 64 slots a
//   tile, double-buffered in shared memory by 16-byte cp.async of each
//   slot's K and V row (rows past the horizon zero-filled). Padding lanes
//   and tiles wholly past the chunk write zeros and read nothing. Tiles go
//   heaviest first (grid x reversed), to shorten the last wave.
// - The arithmetic, eight warps of 16 rows: q . k by mma.sync.m16n8k16 (bf16
//   in, f32 out), q held in registers as A fragments; the scale after the
//   product; the online softmax in f32 registers (exp2f on scores
//   pre-scaled by hd^-1/2 * log2 e, the row max across a quad by two
//   shuffles); p rounded to bf16 and re-packed in registers as the A
//   fragment of P . V (ldmatrix.trans of V); acc 16 x hd f32 in registers.
//   Only a warp's tiles that reach past its first row's position are
//   masked element by element (about one 64-slot tile a warp).
//
// Numerics, as the plain route (models/attention.py::_attend_one_kv_block):
// bf16 operands with exact products and f32 sums, l summing the unrounded
// p, p rounded to q's type (the pages' type, or what int8 pages dequantize
// to) before P . V, out = acc / max(l, 1e-30) rounded to q's type. What
// differs: the order of the sums, and the running max that p is taken
// against (a 64-slot tile's here, a 512-slot block's there).
//
// Two routes, chosen by the wrapper (kernels/paged_prefill.py::tc_eligible)
// and passed in as the dtype code: bf16 on the tensor cores (code 2; hd 32,
// 64 or 128, 16-byte aligned q, pages and output), and the CUDA cores (f32,
// code 0, whose float32 twins must match the CPU to 1e-4; bf16 widths the
// tiles cannot take, code 1): 32 rows and 32 slots a step, K/V staged as
// f32, a lane per slot for the scores and a lane per column for P . V,
// expf, and p rounded to q's type as above.
//
// Int8 pages (quant = 1; kernels/kv_pack.py: int8 codes and one f32 scale a
// (token, KV head) row) take either route. Each value is dequantized as the
// plain route's unpack_kv does, (code * scale) in f32 rounded to q's type,
// so the scores and p are those of a cache in q's type: on the tensor cores
// a tile's codes and scales land by cp.async in a raw stage (16 bytes of
// codes, 4 of a scale a copy) and one pass converts them into a bf16 K and
// V tile that the products read; on the CUDA cores the staging loop
// converts them as it stages K/V as f32.
#include <initializer_list>
#include <type_traits>

#include "ptx.cuh"
#include "split_kv_decode.cuh"

namespace {

using namespace ptx;
using split_kv::allow_smem;
using split_kv::from_f;
using split_kv::NEG_INF;
using split_kv::to_f;

constexpr float LOG2E = 1.4426950408889634f;

// What a block of either route covers: rows [row0, row0 + rows) of its
// lane's S * G (token, head) rows for one KV head. real rows: token < len.
struct Rows {
  int start;      // the chunk's first position
  int len;        // real tokens of the chunk (<= 0: a padding lane)
  int tok_first;  // the block's first token
  int kv_end;     // slots [0, kv_end) the block reads (0: nothing real)

  __device__ Rows(const int* starts, const int* ctx_lens, int b, int row0,
                  int rows, int S, int G, int L) {
    start = starts[b];
    const int ctx = min(ctx_lens[b], L);
    len = min(ctx - start, S);
    tok_first = row0 / G;
    const int tok_last = min((row0 + rows - 1) / G, len - 1);
    kv_end = tok_first < len ? start + tok_last + 1 : 0;
  }
};

// Zeros for every row of the block whose token is below S.
template <typename T>
__device__ void zero_rows(T* ob, int row0, int rows, int S, int G, int hd,
                          size_t tok_stride, int threads) {
  const int n = rows * hd;
  for (int i = threadIdx.x; i < n; i += threads) {
    const int r = i / hd, d = i - r * hd;
    const int gr = row0 + r, tok = gr / G;
    if (tok < S) ob[tok * tok_stride + (size_t)(gr - tok * G) * hd + d] =
        from_f<T>(0.f);
  }
}

// ------------------------------------------------------------ tensor cores
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;   // rows of a block
constexpr int BN = 64;                   // slots of a K/V tile

// Dynamic shared memory: 2 stages, each a K then a V tile of BN bf16 rows
// of LD elements (padded by 16 bytes: the ldmatrix rows of a warp then
// fall in distinct banks). On int8 pages a stage holds the K then the V
// codes (BN rows of HD bytes) and the BN K then BN V scales, and one bf16 K
// and V tile after the two stages takes the converted values.
template <int HD, bool QUANT>
struct TcLayout {
  static constexpr int LD = HD + 8;
  static constexpr int TILE = BN * LD * 2;
  static constexpr int RAW = BN * HD;
  static constexpr int STAGE = QUANT ? 2 * RAW + 2 * BN * 4 : 2 * TILE;
  static constexpr int BYTES = 2 * STAGE + (QUANT ? 2 * TILE : 0);
};

template <bool QUANT, typename T>
using KvT = typename std::conditional<QUANT, int8_t, T>::type;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD, bool QUANT>
__global__ void __launch_bounds__(TC_THREADS, 1)
paged_prefill_tc(const __nv_bfloat16* __restrict__ q,
                 const KvT<QUANT, __nv_bfloat16>* __restrict__ kp,
                 const KvT<QUANT, __nv_bfloat16>* __restrict__ vp,
                 const float* __restrict__ ksc, const float* __restrict__ vsc,
                 const int* __restrict__ bt, const int* __restrict__ starts,
                 const int* __restrict__ ctx_lens,
                 __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv,
                 int ps, int NB, float scale_log2) {
  using Lay = TcLayout<HD, QUANT>;
  constexpr int KT = HD / 16;      // k16 steps of q . k, d16 blocks of P . V
  constexpr int NT = HD / 8;       // n8 tiles of acc
  constexpr int EL = QUANT ? 1 : 2;            // bytes of a K/V element
  constexpr int CH = HD * EL / 16;             // 16-byte chunks of a row
  constexpr int ROW = QUANT ? HD : Lay::LD * 2;  // a row's bytes in a stage
  constexpr int V_OFF = QUANT ? Lay::RAW : Lay::TILE;
  extern __shared__ __align__(128) char smem_tc[];
  const int G = Hq / Hkv;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * TC_ROWS;
  const size_t tok_stride = (size_t)Hq * HD;
  const size_t lane_off = (size_t)b * S * tok_stride + (size_t)h * G * HD;
  __nv_bfloat16* ob = out + lane_off;
  const Rows rw(starts, ctx_lens, b, row0, TC_ROWS, S, G, NB * ps);
  if (rw.kv_end == 0) {
    zero_rows(ob, row0, TC_ROWS, S, G, HD, tok_stride, TC_THREADS);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;   // the C fragment's row, pair

  // this thread's two rows: gid and gid + 8 of the warp's 16
  int lim[2];                // last slot a row attends (-1: not real)
  int tok[2];
  size_t off[2];             // the row's q and output offset in the lane
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + warp * 16 + gid + 8 * r;
    tok[r] = gr / G;
    lim[r] = tok[r] < rw.len ? rw.start + tok[r] : -1;
    off[r] = tok[r] * tok_stride + (size_t)(gr - tok[r] * G) * HD;
  }
  // a warp's tiles past this slot mask element by element
  const int wmin = rw.start + (row0 + warp * 16) / G;

  // q as A fragments: a[0] row gid, a[1] row gid + 8, columns 2 tig (+1);
  // a[2], a[3] the same 8 columns further. Rows past S are zero.
  uint32_t qa[KT][4];
  {
    const __nv_bfloat16* qb = q + lane_off;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j & 1, d = kk * 16 + 2 * tig + 8 * (j >> 1);
        qa[kk][j] = tok[r] < S ? *reinterpret_cast<const uint32_t*>(
                                     qb + off[r] + d)
                               : 0u;
      }
  }
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int* btb = bt + (size_t)b * NB;
  const uint32_t base = smem_addr(smem_tc);
  const int n_tiles = (rw.kv_end + BN - 1) / BN;
  // (page * ps + slot) * Hkv + h: slot t's K/V row and scale index
  auto kv_row = [&](int t) {
    const int pg = t / ps;
    return ((size_t)btb[pg] * ps + (t - pg * ps)) * Hkv + h;
  };
  // Copies tile j's K and V rows (and scales) into stage j % 2.
  auto load_tile = [&](int j) {
    const uint32_t ks = base + (j & 1) * Lay::STAGE;
#pragma unroll
    for (int i = threadIdx.x; i < BN * CH; i += TC_THREADS) {
      const int r = i / CH, c = i - r * CH;
      const int t = j * BN + r;
      const bool ok = t < rw.kv_end;
      const size_t src = ok ? kv_row(t) * HD + c * (16 / EL) : 0;
      const uint32_t dst = r * ROW + c * 16;
      cp_async16(ks + dst, kp + src, ok);
      cp_async16(ks + V_OFF + dst, vp + src, ok);
    }
    if constexpr (QUANT) {        // threads 0-63 the K scales, 64-127 the V
      if (threadIdx.x < 2 * BN) {
        const int t = j * BN + (threadIdx.x & (BN - 1));
        const bool ok = t < rw.kv_end;
        cp_async4(ks + 2 * Lay::RAW + threadIdx.x * 4,
                  (threadIdx.x < BN ? ksc : vsc) + (ok ? kv_row(t) : 0), ok);
      }
    }
  };

  load_tile(0);
  cp_async_commit();
  const int mi = lane >> 3, ri = lane & 7;     // ldmatrix: matrix, row
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();              // tile j landed for every thread
    uint32_t kt = base + (j & 1) * Lay::STAGE, vt = kt + Lay::TILE;
    if constexpr (QUANT) {        // codes * scale, rounded to bf16
      constexpr int RCH = HD / 16;
      const char* raw = smem_tc + (j & 1) * Lay::STAGE;
      char* tiles = smem_tc + 2 * Lay::STAGE;
      const float* sc = reinterpret_cast<const float*>(raw + 2 * Lay::RAW);
#pragma unroll
      for (int i = threadIdx.x; i < 2 * BN * RCH; i += TC_THREADS) {
        const int kv = i / (BN * RCH), jj = i - kv * BN * RCH;
        const int r = jj / RCH, c = jj - r * RCH;
        const uint4 w = *reinterpret_cast<const uint4*>(
            raw + kv * Lay::RAW + r * HD + c * 16);
        const int8_t* v = reinterpret_cast<const int8_t*>(&w);
        const float f = sc[kv * BN + r];
        uint4 o[2];
        uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o32[e] = pack_bf16((float)v[2 * e] * f, (float)v[2 * e + 1] * f);
        uint4* dst = reinterpret_cast<uint4*>(
            tiles + kv * Lay::TILE + (r * Lay::LD + c * 16) * 2);
        dst[0] = o[0];
        dst[1] = o[1];
      }
      __syncthreads();            // the converted tile, for every warp
      kt = smem_addr(tiles);
      vt = kt + Lay::TILE;
    }
    const int t0 = j * BN;

    // s[nt][e]: row gid + 8 (e >> 1), slot t0 + nt * 8 + 2 tig + (e & 1)
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];         // slots 0-7 | 8-15 x columns lo | hi 8
        ldsm_x4(kt + ((np * 16 + (mi >> 1) * 8 + ri) * Lay::LD + kk * 16 +
                      (mi & 1) * 8) *
                         2,
                kb);
        mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    const bool masked = t0 + BN - 1 > wmin;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[nt][e] * scale_log2;
        if (masked && t0 + nt * 8 + 2 * tig + (e & 1) > lim[e >> 1])
          v = NEG_INF;
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
    // P as A fragments, one per k16 step of slots: the C layout of n8
    // tiles 2 kk and 2 kk + 1 is the A layout of one m16k16 tile. A masked
    // slot's p is exactly 0 (set, not computed: a row with no slot yet has
    // m = NEG_INF).
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + nt * 8 + 2 * tig;
        float p0 = exp2f(s[nt][2 * r] - m[r]);
        float p1 = exp2f(s[nt][2 * r + 1] - m[r]);
        if (masked) {
          p0 = t <= lim[r] ? p0 : 0.f;
          p1 = t + 1 <= lim[r] ? p1 : 0.f;
        }
        l[r] += p0 + p1;
        pa[nt >> 1][(nt & 1) * 2 + r] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][0] *= c[0];
      acc[i][1] *= c[0];
      acc[i][2] *= c[1];
      acc[i][3] *= c[1];
    }
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks)
#pragma unroll
      for (int dd = 0; dd < KT; ++dd) {
        uint32_t vb[4];         // slots 0-7 | 8-15 x columns lo | hi 8
        ldsm_x4_trans(vt + ((ks * 16 + (mi & 1) * 8 + ri) * Lay::LD +
                            dd * 16 + (mi >> 1) * 8) *
                               2,
                      vb);
        mma_bf16(acc[2 * dd], pa[ks], vb[0], vb[1]);
        mma_bf16(acc[2 * dd + 1], pa[ks], vb[2], vb[3]);
      }
    __syncthreads();              // stage j % 2 is free for tile j + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
    if (tok[r] >= S) continue;
    const bool real = lim[r] >= 0;
    const float lc = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* o = ob + off[r];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float lo = real ? acc[i][2 * r] / lc : 0.f;
      const float hi = real ? acc[i][2 * r + 1] / lc : 0.f;
      *reinterpret_cast<uint32_t*>(o + i * 8 + 2 * tig) = pack_bf16(lo, hi);
    }
  }
}

// ------------------------------------------------------------- CUDA cores
constexpr int CC_WARPS = 4;
constexpr int CC_THREADS = 32 * CC_WARPS;
constexpr int CC_RPW = 8;                   // rows a warp
constexpr int CC_ROWS = CC_RPW * CC_WARPS;  // rows of a block
constexpr int CC_BN = 32;                   // slots a step: a lane each
constexpr int CC_MAX_HD = 256;              // hd / 32 columns a lane

// f32 words of dynamic shared memory: q [CC_ROWS][hd], K [CC_BN][hd + 1]
// (padded: a lane's row reads fall in distinct banks), V [CC_BN][hd]
inline size_t cc_smem(int hd) {
  return sizeof(float) * ((size_t)CC_ROWS * hd + CC_BN * (hd + 1) +
                          CC_BN * hd);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(CC_THREADS)
paged_prefill_cc(const T* __restrict__ q, const KvT<QUANT, T>* __restrict__ kp,
                 const KvT<QUANT, T>* __restrict__ vp,
                 const float* __restrict__ ksc, const float* __restrict__ vsc,
                 const int* __restrict__ bt, const int* __restrict__ starts,
                 const int* __restrict__ ctx_lens, T* __restrict__ out,
                 int S, int Hq, int Hkv, int hd, int ps, int NB,
                 float scale) {
  extern __shared__ float smem_cc[];
  const int G = Hq / Hkv;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * CC_ROWS;
  const size_t tok_stride = (size_t)Hq * hd;
  const size_t lane_off = (size_t)b * S * tok_stride + (size_t)h * G * hd;
  T* ob = out + lane_off;
  const Rows rw(starts, ctx_lens, b, row0, CC_ROWS, S, G, NB * ps);
  if (rw.kv_end == 0) {
    zero_rows(ob, row0, CC_ROWS, S, G, hd, tok_stride, CC_THREADS);
    return;
  }
  const int kld = hd + 1;
  float* qs = smem_cc;
  float* ks = qs + CC_ROWS * hd;
  float* vs = ks + CC_BN * kld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < CC_ROWS * hd; i += CC_THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int gr = row0 + r, tk = gr / G;
    qs[i] = tk < S ? to_f(q[lane_off + tk * tok_stride +
                            (size_t)(gr - tk * G) * hd + d])
                   : 0.f;
  }
  int lim[CC_RPW];
  float m[CC_RPW], l[CC_RPW], acc[CC_RPW][CC_MAX_HD / 32];
#pragma unroll
  for (int k = 0; k < CC_RPW; ++k) {
    const int tk = (row0 + warp * CC_RPW + k) / G;
    lim[k] = tk < rw.len ? rw.start + tk : -1;
    m[k] = NEG_INF;
    l[k] = 0.f;
#pragma unroll
    for (int j = 0; j < CC_MAX_HD / 32; ++j) acc[k][j] = 0.f;
  }
  const int* btb = bt + (size_t)b * NB;
  for (int t0 = 0; t0 < rw.kv_end; t0 += CC_BN) {
    __syncthreads();              // q staged; the last step's K/V read
    for (int i = threadIdx.x; i < CC_BN * hd; i += CC_THREADS) {
      const int r = i / hd, d = i - r * hd;
      const int t = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < rw.kv_end) {
        const int pg = t / ps;
        const size_t row = ((size_t)btb[pg] * ps + (t - pg * ps)) * Hkv + h;
        const size_t src = row * hd + d;
        if constexpr (QUANT) {    // codes * scale, rounded to q's type
          kv = round_to<T>((float)kp[src] * ksc[row]);
          vv = round_to<T>((float)vp[src] * vsc[row]);
        } else {
          kv = to_f(kp[src]);
          vv = to_f(vp[src]);
        }
      }
      ks[r * kld + d] = kv;
      vs[r * hd + d] = vv;
    }
    __syncthreads();
    const int t = t0 + lane;
#pragma unroll
    for (int k = 0; k < CC_RPW; ++k) {
      const float* qr = qs + (warp * CC_RPW + k) * hd;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qr[d] * ks[lane * kld + d];
      const bool ok = t <= lim[k];          // lim < kv_end
      const float sv = ok ? dot * scale : NEG_INF;
      float mx = sv;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
      const float mn = fmaxf(m[k], mx);
      const float p = ok ? expf(sv - mn) : 0.f;
      const float c = expf(m[k] - mn);
      float psum = p;
#pragma unroll
      for (int o = 16; o; o >>= 1) psum += __shfl_xor_sync(~0u, psum, o);
      l[k] = l[k] * c + psum;
      m[k] = mn;
      const float pr = round_to<T>(p);     // p in q's type for P . V
#pragma unroll
      for (int j = 0; j < CC_MAX_HD / 32; ++j) acc[k][j] *= c;
      for (int tt = 0; tt < CC_BN; ++tt) {
        const float pt = __shfl_sync(~0u, pr, tt);
#pragma unroll
        for (int j = 0; j < CC_MAX_HD / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) acc[k][j] += pt * vs[tt * hd + d];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < CC_RPW; ++k) {
    const int gr = row0 + warp * CC_RPW + k, tk = gr / G;
    if (tk >= S) continue;
    const float lc = fmaxf(l[k], 1e-30f);
    T* o = ob + tk * tok_stride + (size_t)(gr - tk * G) * hd;
#pragma unroll
    for (int j = 0; j < CC_MAX_HD / 32; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) o[d] = from_f<T>(lim[k] >= 0 ? acc[k][j] / lc : 0.f);
    }
  }
}

template <int HD, bool QUANT>
int launch_tc(const void* q, const void* kp, const void* vp, const void* ksc,
              const void* vsc, const void* bt, const void* starts,
              const void* ctx, void* out, int B, int S, int Hq, int Hkv,
              int ps, int NB, float scale, int device, cudaStream_t stream) {
  using KV = KvT<QUANT, __nv_bfloat16>;
  constexpr size_t smem = TcLayout<HD, QUANT>::BYTES;
  cudaError_t err = allow_smem<paged_prefill_tc<HD, QUANT>>(smem, device);
  if (err != cudaSuccess) return (int)err;
  const int G = Hq / Hkv;
  const long long rows = (long long)S * G;
  const dim3 grid((unsigned)((rows + TC_ROWS - 1) / TC_ROWS), Hkv, B);
  paged_prefill_tc<HD, QUANT><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(bt),
      static_cast<const int*>(starts), static_cast<const int*>(ctx),
      static_cast<__nv_bfloat16*>(out), S, Hq, Hkv, ps, NB,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT>
int launch_cc(const void* q, const void* kp, const void* vp, const void* ksc,
              const void* vsc, const void* bt, const void* starts,
              const void* ctx, void* out, int B, int S, int Hq, int Hkv,
              int hd, int ps, int NB, float scale, int device,
              cudaStream_t stream) {
  using KV = KvT<QUANT, T>;
  if (hd > CC_MAX_HD) return (int)cudaErrorInvalidValue;
  const size_t smem = cc_smem(hd);
  cudaError_t err = allow_smem<paged_prefill_cc<T, QUANT>>(smem, device);
  if (err != cudaSuccess) return (int)err;
  const int G = Hq / Hkv;
  const long long rows = (long long)S * G;
  const dim3 grid((unsigned)((rows + CC_ROWS - 1) / CC_ROWS), Hkv, B);
  paged_prefill_cc<T, QUANT><<<grid, CC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(bt),
      static_cast<const int*>(starts), static_cast<const int*>(ctx),
      static_cast<T*>(out), S, Hq, Hkv, hd, ps, NB, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 on the CUDA cores, 1 = bfloat16 on the CUDA cores
// (hd up to 256), 2 = bfloat16 on the tensor cores (hd 32, 64 or 128; q,
// the pages and out 16-byte aligned; else cudaErrorInvalidValue). q and out
// (B, S, Hq, hd) of that type, the pages (P, ps, Hkv, hd) of that type
// (quant 0) or int8 with k_scales and v_scales (P, ps, Hkv) f32 (quant 1),
// all contiguous; block_tables (B, NB), chunk_starts and ctx_lens (B,)
// int32. Returns the cudaError_t of the launch.
extern "C" int paged_prefill_launch(const void* q, const void* k_pages,
                                    const void* v_pages, const void* k_scales,
                                    const void* v_scales,
                                    const void* block_tables,
                                    const void* chunk_starts,
                                    const void* ctx_lens, void* out, int B,
                                    int S, int Hq, int Hkv, int hd, int ps,
                                    int NB, float scale, int dtype, int quant,
                                    int device, void* stream) {
  cudaError_t err = split_kv::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv || ps <= 0 || NB <= 0 ||
      (quant && (!k_scales || !v_scales)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    for (const void* p : {q, k_pages, v_pages, (const void*)out})
      if (reinterpret_cast<uintptr_t>(p) % 16)
        return (int)cudaErrorInvalidValue;
#define PAGED_PREFILL_TC(HD)                                                \
  (quant ? launch_tc<HD, true>(q, k_pages, v_pages, k_scales, v_scales,     \
                               block_tables, chunk_starts, ctx_lens, out, B, \
                               S, Hq, Hkv, ps, NB, scale, device, s)         \
         : launch_tc<HD, false>(q, k_pages, v_pages, k_scales, v_scales,    \
                                block_tables, chunk_starts, ctx_lens, out,  \
                                B, S, Hq, Hkv, ps, NB, scale, device, s))
    switch (hd) {
      case 32: return PAGED_PREFILL_TC(32);
      case 64: return PAGED_PREFILL_TC(64);
      case 128: return PAGED_PREFILL_TC(128);
    }
#undef PAGED_PREFILL_TC
    return (int)cudaErrorInvalidValue;
  }
#define PAGED_PREFILL_CC(T)                                                  \
  (quant ? launch_cc<T, true>(q, k_pages, v_pages, k_scales, v_scales,       \
                              block_tables, chunk_starts, ctx_lens, out, B,  \
                              S, Hq, Hkv, hd, ps, NB, scale, device, s)      \
         : launch_cc<T, false>(q, k_pages, v_pages, k_scales, v_scales,      \
                               block_tables, chunk_starts, ctx_lens, out, B, \
                               S, Hq, Hkv, hd, ps, NB, scale, device, s))
  if (dtype == 0) return PAGED_PREFILL_CC(float);
  if (dtype == 1) return PAGED_PREFILL_CC(__nv_bfloat16);
#undef PAGED_PREFILL_CC
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
