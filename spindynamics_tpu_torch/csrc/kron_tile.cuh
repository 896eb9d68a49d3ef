// The output-tile machinery shared by K1 (kron_group.cu) and K2
// (cheb_term.cu): the group descriptor, the K-segment register GEMM and the
// hi-local sum of one tile row. See kron_group.cu for the design.
//
// A block owns the output tile [h, m0:m0+BM, l0:l0+BL] of one kron group
// [ch, cmp, clp]. tile_products() gathers the three kinds of matrix product
// of the tile (T@W_lo, W_mid^T@T, lo|mid cross terms) into a register
// accumulator; hi_local_row() adds the seed, the diagonal and the mid|hi
// slice adds for one row of a thread's 4x4 sub-tile; window_row_add() adds
// the mid|hi terms of a sharded launch, which arrive as windows. K2 runs the
// first two once per (re, im) plane and takes no windows. Each thread's result for an element depends only on that
// element's inputs and a fixed operation order, so both kernels are
// deterministic.
//
// The state's element type S is a template parameter: float, or
// __nv_bfloat16 for the half-width amplitude mode. States, seeds and cross
// sources are converted to float as they are staged into shared memory or
// loaded in the epilogue; the tables, the shared tiles and the accumulators
// are float whatever S is, so a bf16 amplitude times a float table entry is
// exact in float and the sum is rounded once, by the kernel's store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#define KG_MAX_CROSS 16
#define KG_MAX_CROSSH 8
#define KG_MAX_CROSSW 8
#define KG_MAX_MIDS 4

// KgDesc.state_type: the element type of every state tensor of a launch
#define KG_STATE_F32 0
#define KG_STATE_BF16 1

struct KgCross {        // lo|mid term
  const void* src;      // source group [ch, cmp_s, clp_s], state type
  const float* A;       // one-hot lo factor [clp_s, clp]
  int cmp_s, clp_s;
  int r0, c0, ln;
  float val;
};

struct KgMid {
  int ra0, ca0, lna;
  float val;
};

struct KgCrossH {       // mid|hi term: one hi run x 1..KG_MAX_MIDS mid runs
  const void* src;      // source group [ch_s, cmp_s, clp], state type
  int ch_s, cmp_s;
  int rb0, cb0, lnb;
  int n_mids;
  KgMid mids[KG_MAX_MIDS];
};

// mid|hi term of a launch on one shard's LOCAL hi block (the crossw
// variant): the source rows live on other shards, so the term arrives as a
// window aligned to the output's hi rows, the hi run's shift and mask already
// applied (rows outside the run are zero). Only the mid runs remain.
struct KgCrossW {
  const void* win;      // window [ch, cmp_s, clp], state type
  int cmp_s;
  int n_mids;
  KgMid mids[KG_MAX_MIDS];
};

struct KgDesc {
  void* out;            // [ch, cmp, clp], state type
  const void* T;        // [ch, cmp, clp], state type
  const void* seed;     // [ch, cmp, clp] or NULL, state type
  const float* D1;      // [cmp, clp] or NULL
  const float* D2;      // [ch, cmp] or NULL
  const float* D3;      // [ch, clp] or NULL
  const float* W_lo;    // [clp, clp] or NULL
  const float* W_mid_T; // [cmp, cmp] or NULL
  int ch, cmp, clp;
  int n_cross, n_crossh;
  int state_type;       // KG_STATE_F32 or KG_STATE_BF16
  int n_crossw;
  KgCross cross[KG_MAX_CROSS];
  KgCrossH crossh[KG_MAX_CROSSH];
  KgCrossW crossw[KG_MAX_CROSSW];
};

namespace kron_tile {

constexpr int BM = 32;    // mid rows per tile
constexpr int BL = 128;   // lo columns per tile
constexpr int BK = 8;     // K depth per shared-memory stage
constexpr int NT = 256;   // threads: 8 warps x 32 lanes, 4x4 outputs each

struct Smem {
  float A[2][BK][BM];     // A tile, k-major
  float B[2][BK][BL];
};

// The launch checks both kernels share: tile pads and cross-term counts.
inline bool desc_ok(const KgDesc& d) {
  return (d.state_type == KG_STATE_F32 || d.state_type == KG_STATE_BF16) &&
         d.ch >= 1 && d.cmp >= 1 && d.clp >= 1 && d.clp % BL == 0 &&
         d.cmp % BK == 0 && d.n_cross >= 0 && d.n_cross <= KG_MAX_CROSS &&
         d.n_crossh >= 0 && d.n_crossh <= KG_MAX_CROSSH &&
         d.n_crossw >= 0 && d.n_crossw <= KG_MAX_CROSSW;
}

inline dim3 grid_of(const KgDesc& d) {
  return dim3(d.clp / BL, (d.cmp + BM - 1) / BM, d.ch);
}

// Element loads and the 4-wide row access of both state types. A bfloat16 is
// the high half of a float, so widening it is a shift; four of them are one
// 8-byte vector.
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
// the one rounding of a bf16 launch: round to nearest even
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// acc += scale * A[rows] @ B[:, l0:l0+BL] for tile rows m in [m0, m0+BM):
// A row of output row m is A + (m + a_shift) * lda, valid for m in
// [mlo, mhi) (zero elsewhere); B is [K, ldb]; K is a multiple of BK. One of
// A and B is a state (float or bfloat16), the other a float table.
template <class TA, class TB>
__device__ __forceinline__ void gemm_segment(
    float (&acc)[4][4], Smem& sm, const TA* __restrict__ A, int lda,
    int a_shift, int mlo, int mhi, float scale,
    const TB* __restrict__ B, int ldb, int K, int m0, int l0) {
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  const int ar = tid / BK, ak = tid % BK;              // A stage coords
  const int bk = tid / (BL / 4), bc = (tid % (BL / 4)) * 4;  // B stage coords
  const int m = m0 + ar;
  const bool a_ok = m >= mlo && m < mhi;
  const TA* a_ptr = a_ok ? A + (size_t)(m + a_shift) * lda + ak : A;
  const TB* b_ptr = B + (size_t)bk * ldb + l0 + bc;
  const int ntiles = K / BK;

  float a_reg = a_ok ? ldf(a_ptr) * scale : 0.f;
  float4 b_reg = ld4(b_ptr);
  sm.A[0][ak][ar] = a_reg;
  *reinterpret_cast<float4*>(&sm.B[0][bk][bc]) = b_reg;
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < ntiles;
    if (more) {
      a_reg = a_ok ? ldf(a_ptr + (t + 1) * BK) * scale : 0.f;
      b_reg = ld4(b_ptr + (size_t)(t + 1) * BK * ldb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.A[cur][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.B[cur][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      sm.A[cur ^ 1][ak][ar] = a_reg;
      *reinterpret_cast<float4*>(&sm.B[cur ^ 1][bk][bc]) = b_reg;
    }
    __syncthreads();
  }
}

// The tile's matrix products for state T (one plane): T[h] @ W_lo,
// W_mid^T @ T[h], and val * S[h, r0+i] @ A for every lo|mid cross term
// whose mid rows meet the tile. src_of(c) is cross term c's source group
// in the same plane as T (an untyped pointer to elements of type S).
template <class S, class SrcOf>
__device__ __forceinline__ void tile_products(
    float (&acc)[4][4], Smem& sm, const KgDesc& d, const S* T,
    SrcOf src_of, int h, int m0, int l0) {
  const int cmp = d.cmp, clp = d.clp;
  const S* Th = T + (size_t)h * cmp * clp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (d.W_lo != nullptr)      // T[h] @ W_lo
    gemm_segment(acc, sm, Th, clp, 0, 0, cmp, 1.f, d.W_lo, clp, clp, m0, l0);
  if (d.W_mid_T != nullptr)   // W_mid^T @ T[h]
    gemm_segment(acc, sm, d.W_mid_T, cmp, 0, 0, cmp, 1.f, Th, clp, cmp, m0, l0);
  for (int c = 0; c < d.n_cross; ++c) {   // lo|mid: val * S[h, r0+i] @ A
    const KgCross& x = d.cross[c];
    if (m0 + BM <= x.c0 || m0 >= x.c0 + x.ln) continue;  // block-uniform
    gemm_segment(acc, sm, static_cast<const S*>(src_of(c)) +
                 (size_t)h * x.cmp_s * x.clp_s, x.clp_s,
                 x.r0 - x.c0, x.c0, x.c0 + x.ln, x.val, x.A, clp, x.clp_s,
                 m0, l0);
  }
}

// The hi-local sum of H at out[h, m, l:l+4] for one plane:
//   seed + T * (D1 + D2[h, m] + D3[h, l]) + acc_row + mid|hi slice adds.
// t returns T[h, m, l:l+4]. srch_of(c) is mid|hi term c's source group in
// T's plane (untyped, elements of type S); seed may be NULL.
template <class S, class SrcOf>
__device__ __forceinline__ float4 hi_local_row(
    const KgDesc& d, const float (&acc_row)[4], const S* T,
    const S* seed, SrcOf srch_of, int h, int m, int l, float4& t) {
  const int cmp = d.cmp, clp = d.clp;
  const size_t idx = (size_t)h * cmp * clp + (size_t)m * clp + l;
  t = ld4(T + idx);
  float4 r = seed != nullptr ? ld4(seed + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dg = d.D1 != nullptr ? ld4(d.D1 + (size_t)m * clp + l)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  if (d.D2 != nullptr) {
    const float s = d.D2[(size_t)h * cmp + m];
    dg.x += s; dg.y += s; dg.z += s; dg.w += s;
  }
  if (d.D3 != nullptr) {
    const float4 e = ld4(d.D3 + (size_t)h * clp + l);
    dg.x += e.x; dg.y += e.y; dg.z += e.z; dg.w += e.w;
  }
  r.x += t.x * dg.x + acc_row[0];
  r.y += t.y * dg.y + acc_row[1];
  r.z += t.z * dg.z + acc_row[2];
  r.w += t.w * dg.w + acc_row[3];
  for (int c = 0; c < d.n_crossh; ++c) {   // mid|hi slice adds
    const KgCrossH& x = d.crossh[c];
    if (h < x.cb0 || h >= x.cb0 + x.lnb) continue;
    const int srow = min(max(h + x.rb0 - x.cb0, 0), x.ch_s - 1);
    const S* Sh = static_cast<const S*>(srch_of(c)) +
                  (size_t)srow * x.cmp_s * clp;
    for (int k = 0; k < x.n_mids; ++k) {
      const KgMid& mr = x.mids[k];
      if (m < mr.ca0 || m >= mr.ca0 + mr.lna) continue;
      const float4 s = ld4(Sh + (size_t)(mr.ra0 + m - mr.ca0) * clp + l);
      r.x += mr.val * s.x; r.y += mr.val * s.y;
      r.z += mr.val * s.z; r.w += mr.val * s.w;
    }
  }
  return r;
}

// The windowed mid|hi terms at out[h, m, l:l+4]: for every window whose mid
// run holds m, r += val * win[h, ra0 + m - ca0, l:l+4]. A gather like the
// rest of the tile: the window shares the output's hi row, so there is no
// row shift and no range test on h.
template <class S>
__device__ __forceinline__ void window_row_add(
    const KgDesc& d, float4& r, int h, int m, int l) {
  const int clp = d.clp;
  for (int c = 0; c < d.n_crossw; ++c) {
    const KgCrossW& x = d.crossw[c];
    const S* Wh = static_cast<const S*>(x.win) + (size_t)h * x.cmp_s * clp;
    for (int k = 0; k < x.n_mids; ++k) {
      const KgMid& mr = x.mids[k];
      if (m < mr.ca0 || m >= mr.ca0 + mr.lna) continue;
      const float4 s = ld4(Wh + (size_t)(mr.ra0 + m - mr.ca0) * clp + l);
      r.x += mr.val * s.x; r.y += mr.val * s.y;
      r.z += mr.val * s.z; r.w += mr.val * s.w;
    }
  }
}

}  // namespace kron_tile
