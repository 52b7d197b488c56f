// The tensor-core tile routine of the expert GEMMs (csrc/moe_gmm.cu): BM
// rows of one expert's tokens against a BN-column panel of that expert's
// weights w (D, F), bf16 in, the sum in f32 registers.
//
// Products: bf16 mma.sync.aligned.m16n8k16 with f32 accumulators; x is fed
// from shared memory with ldmatrix, w (K x N row-major) with ldmatrix.trans.
// Copies: a STAGES-deep ring in dynamic shared memory, BK deep per stage.
// The weights come by TMA: thread 0 asks for two 64 x 64 boxes a stage and
// an mbarrier counts their bytes in, so each block keeps (STAGES - 1) x BK
// x BN x 2 = 48 KB of weights in flight without spending its threads on
// the copy. The few x rows come by 16-byte cp.async.cg from every thread.
// Both tiles are stored in rows of 128 bytes with the TMA's 128-byte
// swizzle, so the ldmatrix reads touch eight distinct bank groups.
// Edges: x rows past n_rows and depth past D are staged as zeros (cp.async
// with a source size of 0), and so are weights past D or F (the TMA's
// out-of-bounds fill); the caller masks the stores past its edges.
// No split-K: every output element is one f32 register that takes the
// k16 steps of the depth in ascending order, whatever BM is and whatever
// other rows share the block, so a row's result does not depend on the
// rows beside it (batch invariance).
//
// Preconditions (tc_eligible in kernels/moe_gmm.py): D and F multiples of
// 8 and x, w 16-byte aligned, so every 16-byte chunk of x lies wholly
// inside or wholly outside the matrix and w's rows meet the TMA's 16-byte
// stride rule.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "ptx.cuh"

namespace gmm_tc {

using namespace ptx;

constexpr int BN = 128;       // output columns per block
constexpr int BK = 64;        // depth per pipeline stage
constexpr int STAGES = 4;
constexpr int WARPS_N = BN / 32;  // warps across the columns, 32 columns each

// MT m16 tiles per warp, WM warps down the rows.
template <int MT, int WM>
struct Tile {
  static constexpr int BM = 16 * MT * WM;
  static constexpr int THREADS = 32 * WARPS_N * WM;
  static constexpr int A_BYTES = BM * BK * 2;     // rows of 128 bytes
  static constexpr int B_BYTES = BK * BN * 2;     // two halves of 64 columns
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // B first, then A
  // + slack to align the ring to 1024 bytes, + one mbarrier per stage
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 8 * STAGES;
};
static_assert(BK * 2 == 128, "x rows and w half-rows of 128 bytes");

// One expert's weights w (D, F): slice e of the (E, D, F) tensor behind
// the TMA descriptor map.
struct Weights {
  const CUtensorMap* map;
  int e;
};

// Rows of 128 bytes; the 16-byte chunk c of row r is stored at chunk
// c ^ (r % 8), the TMA's 128-byte swizzle: the 8 rows an ldmatrix reads at
// one logical chunk then sit in 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One 64 x 64 box of the (E, D, F) weights at (column c0, depth c1,
// expert c2) into shared memory, 128-byte swizzled; elements past D or F
// arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Stages depth tile kt of x rows [0, BM) (cp.async, every thread) and of
// w[:, n0 : n0 + BN] (TMA from thread 0) into the stage at shared address
// st, whose barrier is bar.
template <int MT, int WM>
__device__ __forceinline__ void load_stage(const __nv_bfloat16* __restrict__ x,
                                           const Weights& w, int D,
                                           int n_rows, int n0, int kt,
                                           uint32_t st, uint32_t bar) {
  using T = Tile<MT, WM>;
  const int d0 = kt * BK;
  for (int i = threadIdx.x; i < T::BM * 8; i += T::THREADS) {
    const int r = i >> 3, c = i & 7, d = d0 + c * 8;
    const bool ok = r < n_rows && d < D;
    cp_async16(st + T::B_BYTES + swz(r, c), ok ? x + (size_t)r * D + d : x,
               ok);
  }
  if (threadIdx.x == 0) {
    mbar_expect(bar, T::B_BYTES);
    tma_load(st, w.map, n0, d0, w.e, bar);
    tma_load(st + T::B_BYTES / 2, w.map, n0 + 64, d0, w.e, bar);
  }
}

// The products of one staged depth tile: BK / 16 k16 steps, in order.
template <int MT, int WM>
__device__ __forceinline__ void mma_stage(uint32_t st,
                                          float (&acc)[MT][4][4]) {
  using T = Tile<MT, WM>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const uint32_t b_s = st, a_s = st + T::B_BYTES;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[MT][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = (wm * MT + mt) * 16 + (lane & 15);
      const int c = kk * 2 + (lane >> 4);
      ldsm_x4(a_s + swz(r, c), a[mt]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = lane >> 3;
      const int k = kk * 16 + (m & 1) * 8 + (lane & 7);
      const int c = wn * 4 + j * 2 + (m >> 1);       // of the BN / 8
      uint32_t r[4];
      ldsm_x4_trans(b_s + (c >> 3) * (T::B_BYTES / 2) + swz(k, c & 7), r);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0],
                                              b[nt][1]);
  }
}

// acc = x[0 : n_rows] . w[:, n0 : n0 + BN] over the full depth D, for x
// rows of stride D and one expert's weights. Every thread of the block
// calls it (it holds barriers); smem holds Tile<MT, WM>::SMEM bytes.
// Thread (warp, lane) owns, for m16 tile mt and n8 tile nt,
//   acc[mt][nt][0..1] at row (wm * MT + mt) * 16 + lane / 4,
//                        columns n0 + wn * 32 + nt * 8 + 2 * (lane % 4) + {0, 1}
//   acc[mt][nt][2..3] at the same columns, 8 rows further down.
template <int MT, int WM>
__device__ __forceinline__ void gmm_tile(const __nv_bfloat16* __restrict__ x,
                                         const Weights& w, int D, int n_rows,
                                         int n0,
                                         float (&acc)[MT][4][4], char* smem) {
  using T = Tile<MT, WM>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const uint32_t ring = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t bars = ring + STAGES * T::STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int KT = (D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<MT, WM>(x, w, D, n_rows, n0, s, ring + s * T::STAGE_BYTES,
                         bars + 8 * s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    cp_async_wait<STAGES - 2>();   // x's depth tile kt has landed ...
    mbar_wait(bars + 8 * s, (kt / STAGES) & 1);   // ... and w's
    __syncthreads();               // ... for every thread; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < KT)
      load_stage<MT, WM>(x, w, D, n_rows, n0, next,
                         ring + (next % STAGES) * T::STAGE_BYTES,
                         bars + 8 * (next % STAGES));
    cp_async_commit();
    mma_stage<MT, WM>(ring + s * T::STAGE_BYTES, acc);
  }
  cp_async_wait<0>();
  __syncthreads();                 // the caller may reuse smem
  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES; ++s) mbar_inval(bars + 8 * s);
}

// Stores the tile's rows [0, row_hi) of out (row stride F, the tile's row 0
// at out): acc for rows below n_rows, zeros from there on; columns past F
// are skipped.
template <int MT, int WM>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int F,
                                           int n0, int n_rows, int row_hi,
                                           const float (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * (lane & 3);
      if (col >= F) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MT + mt) * 16 + (lane >> 2) + 8 * h;
        if (r >= row_hi) continue;
        const bool live = r < n_rows;
        *reinterpret_cast<float2*>(out + (size_t)r * F + col) =
            make_float2(live ? acc[mt][nt][2 * h] : 0.f,
                        live ? acc[mt][nt][2 * h + 1] : 0.f);
      }
    }
}

}  // namespace gmm_tc
