// The output-tile machinery shared by K1 (kron_group.cu) and K2
// (cheb_term.cu): the group descriptor, the two K-segment routes of the
// tile's matrix products and the hi-local sum of one tile row. See
// kron_group.cu for the design.
//
// A block owns the output tile [h, m0:m0+BM, l0:l0+BL] of one kron group
// [ch, cmp, clp] (BM = 32 or 64, chosen per launch). tile_products() gathers
// the three kinds of matrix product of the tile (T@W_lo, W_mid^T@T, lo|mid
// cross terms) into a register accumulator laid out as the fragments of
// mma.sync.m16n8k16, one K segment at a time, each on the route its table
// allows:
//   tc_segment   the table is exactly bf16 (its descriptor flag; the table
//                pointer then holds the bf16 copy): bf16 tensor-core
//                products with float32 accumulation. A float32 state is
//                split into hi = bf16(s) and lo = bf16(s - hi) and both
//                halves are multiplied (two passes, the TPU kernel's
//                _dot_split2); a bfloat16 state is one pass (under a
//                scale that is not a power of two it takes the FMAs).
//   fma_segment  any other table: float32 FMAs on the CUDA cores.
// stage_acc() writes the accumulator to shared memory, and the epilogue
// reads it back one 4-wide row piece at a time: hi_local_row() adds the
// seed, the diagonal and the mid|hi slice adds; window_row_add() adds the
// mid|hi terms of a sharded launch, which arrive as windows. K2 runs the
// products once per (re, im) plane and takes no windows. Each output
// element is summed by one thread in a fixed order and written once, so
// both kernels are deterministic.
//
// The state's element type S is a template parameter: float, or
// __nv_bfloat16 for the half-width amplitude mode. Every sum is float32;
// a bfloat16 output is rounded once, by the kernel's store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define KG_MAX_CROSS 16
#define KG_MAX_CROSSH 8
#define KG_MAX_CROSSW 8
#define KG_MAX_MIDS 4

// KgDesc.state_type: the element type of every state tensor of a launch
#define KG_STATE_F32 0
#define KG_STATE_BF16 1

struct KgCross {        // lo|mid term
  const void* src;      // source group [ch, cmp_s, clp_s], state type
  const void* A;        // one-hot lo factor [clp_s, clp]: bf16 if exact,
                        // else float
  int cmp_s, clp_s;
  int r0, c0, ln;
  float val;
  int exact;            // A is exactly bf16: the tensor-core route
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
  const void* W_lo;     // [clp, clp] or NULL: bf16 if wlo_exact, else float
  const void* W_mid_T;  // [cmp, cmp] or NULL: bf16 if wmid_exact, else float
  int ch, cmp, clp;
  int n_cross, n_crossh;
  int state_type;       // KG_STATE_F32 or KG_STATE_BF16
  int n_crossw;
  int wlo_exact, wmid_exact;  // the table is exactly bf16: tensor cores
  int tile_rows;        // 32 or 64 rows per output tile; 0: tile_rows()
  KgCross cross[KG_MAX_CROSS];
  KgCrossH crossh[KG_MAX_CROSSH];
  KgCrossW crossw[KG_MAX_CROSSW];
};

namespace kron_tile {

typedef __nv_bfloat16 bf16;

constexpr int BL = 128;   // lo columns per tile
constexpr int NT = 256;   // threads: 8 warps
constexpr int BK = 32;    // K depth of a tensor-core stage
constexpr int NS = 3;     // cp.async stages in the ring
constexpr int BKF = 8;    // K depth of an FMA stage
constexpr int PADH = 8;   // bf16 row pad of the operand tiles (ldmatrix
                          // rows land on distinct 16-byte bank groups)
constexpr int PADE = 4;   // float row pad of the epilogue tile

// The warp grid of a BM x BL tile: 8 warps as (BM/32) x (8/(BM/32)), each
// warp a 32 x WN piece of m16n8 fragments, MI x NI of them.
template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BL / WARPS_N;
  static constexpr int MI = 2;
  static constexpr int NI = WN / 8;
};

template <int BM>
struct Acc {
  float c[2][Tile<BM>::NI][4];
};

// Shared memory: one buffer reused by the segments (the cp.async ring and
// the split tiles, or the FMA tiles) and then by the epilogue.
constexpr size_t RAW_BYTES = (size_t)BK * BL * 4;           // a state tile
constexpr size_t HT_BYTES = (size_t)BK * (BL + PADH) * 2;    // a bf16 tile
constexpr size_t STAGE_BYTES = RAW_BYTES + HT_BYTES;
constexpr size_t TC_BYTES = NS * STAGE_BYTES + 2 * HT_BYTES;
template <int BM>
constexpr size_t epi_bytes(int planes) {
  return (size_t)planes * BM * (BL + PADE) * 4;
}
template <int BM>
constexpr size_t smem_bytes(int planes) {
  return TC_BYTES > epi_bytes<BM>(planes) ? TC_BYTES : epi_bytes<BM>(planes);
}

// The launch checks both kernels share: tile pads and cross-term counts.
inline bool desc_ok(const KgDesc& d) {
  return (d.state_type == KG_STATE_F32 || d.state_type == KG_STATE_BF16) &&
         d.ch >= 1 && d.cmp >= 1 && d.clp >= 1 && d.clp % BL == 0 &&
         d.cmp % BKF == 0 && d.n_cross >= 0 && d.n_cross <= KG_MAX_CROSS &&
         (d.tile_rows == 0 || d.tile_rows == 32 || d.tile_rows == 64) &&
         d.n_crossh >= 0 && d.n_crossh <= KG_MAX_CROSSH &&
         d.n_crossw >= 0 && d.n_crossw <= KG_MAX_CROSSW;
}

// The tile height of a launch: the descriptor's, else 64 rows where the
// group is tall enough and the grid still fills two blocks on each of the
// H100's 132 SMs, else 32 (a small group's launch is then twice as many,
// shorter blocks). Either gives every element the same operation order, so
// the same bits.
inline int tile_rows(const KgDesc& d) {
  if (d.tile_rows != 0) return d.tile_rows;
  const long blocks64 = (long)(d.clp / BL) * ((d.cmp + 63) / 64) * d.ch;
  return (d.cmp > 32 && blocks64 >= 2 * 132) ? 64 : 32;
}

inline dim3 grid_of(const KgDesc& d, int bm) {
  return dim3(d.clp / BL, (d.cmp + bm - 1) / bm, d.ch);
}

// Element loads and the 4-wide row access of both state types. A bfloat16 is
// the high half of a float, so widening it is a shift; four of them are one
// 8-byte vector.
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
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
__device__ __forceinline__ void st4(bf16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---- tensor-core primitives ------------------------------------------------

// 16 bytes global -> shared, asynchronously; src_ok false fills zeros and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool src_ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = src_ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// c += a @ b for one m16n8k16 fragment, bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one bf16x2 word, each rounded to nearest even (x in the
// low half), and the two bf16 values back as floats.
__device__ __forceinline__ unsigned bf16x2_rn(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Four state values (scaled) -> their bf16 hi halves and, when `two`, the
// bf16 lo halves bf16(v - hi): hi + lo carries 16 significand bits, so a
// product of either half with a bf16 table entry is exact in float32.
__device__ __forceinline__ void split4(const float4& v, bool two, bf16* hi,
                                       bf16* lo) {
  const unsigned h0 = bf16x2_rn(v.x, v.y), h1 = bf16x2_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
  if (two)
    *reinterpret_cast<uint2*>(lo) = make_uint2(
        bf16x2_rn(v.x - bf16_lo(h0), v.y - bf16_hi(h0)),
        bf16x2_rn(v.z - bf16_lo(h1), v.w - bf16_hi(h1)));
}

// acc += scale * A[rows] @ B[:, l0:l0+BL] on the tensor cores, for tile rows
// m in [m0, m0+BM), K in steps of BK (the last step zero-filled past K).
// SA: the state is A (A row of output row m is state + (m + shift) * lds,
// valid for m in [mlo, mhi), zero elsewhere) and the bf16 table is B [K,
// ldt]; !SA: the bf16 table is A (rows m < mhi) and the state is B [K, lds].
// The state arrives by cp.async in its own type into a ring of NS stages, is
// scaled and split into the bf16 hi (and lo) tiles, and each half meets the
// table tile in one mma pass; per 16-deep k step the hi pass comes first.
template <int BM, class S, bool SA>
__device__ __forceinline__ void tc_segment(
    Acc<BM>& acc, char* smem, const S* __restrict__ state, int lds, int shift,
    int mlo, int mhi, float scale, const bf16* __restrict__ tab, int ldt,
    int K, int m0, int l0) {
  using TL = Tile<BM>;
  constexpr int ES = (int)(16 / sizeof(S));     // state elements per 16 B
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  // a float32 state takes two passes (hi, lo); a bf16 state, scaled by a
  // power of two (segment() routes any other scale to the FMAs), is its
  // own hi
  constexpr bool two = sizeof(S) == 4;
  // tile geometry: the state tile and the table tile, rows x cols
  constexpr int SR = SA ? BM : BK, SC = SA ? BK : BL;   // state tile
  constexpr int HW = SC + PADH;                         // split-tile row
  constexpr int TR = SA ? BK : BM, TC = SA ? BL : BK;   // table tile
  constexpr int TW = TC + PADH;
  char* ring = smem;
  bf16* hi = reinterpret_cast<bf16*>(smem + NS * STAGE_BYTES);
  bf16* lo = hi + HT_BYTES / 2;
  const int nk = (K + BK - 1) / BK;

  // This thread's 16-byte chunks of the two tiles, fixed for the segment:
  // the element offset of the chunk at k = 0, whether its row is in range,
  // and the k offset its range test needs; from stage to stage only k0
  // moves, by 1 (k runs along the row) or by the row stride.
  constexpr int CS = SR * SC / ES, CT = TR * TC / 8;   // chunks per tile
  constexpr int NCS = (CS + NT - 1) / NT, NCT = (CT + NT - 1) / NT;
  const long s_step = SA ? 1 : lds, t_step = SA ? ldt : 1;
  long s_off[NCS], t_off[NCT];
  int s_k[NCS], t_k[NCT];
  bool s_ok[NCS], t_ok[NCT];
#pragma unroll
  for (int i = 0; i < NCS; ++i) {
    const int c = tid + i * NT;
    const int r = c / (SC / ES), cc = (c % (SC / ES)) * ES;
    if constexpr (SA) {   // row m0 + r of the state, k along the row
      s_ok[i] = c < CS && m0 + r >= mlo && m0 + r < mhi;
      s_off[i] = (long)(m0 + r + shift) * lds + cc;
      s_k[i] = cc;
    } else {              // row k = r of the state, columns l0 + cc
      s_ok[i] = c < CS;
      s_off[i] = (long)r * lds + l0 + cc;
      s_k[i] = r;
    }
  }
#pragma unroll
  for (int i = 0; i < NCT; ++i) {
    const int c = tid + i * NT;
    const int r = c / (TC / 8), cc = (c % (TC / 8)) * 8;
    if constexpr (SA) {   // row k = r of the table, columns l0 + cc
      t_ok[i] = c < CT;
      t_off[i] = (long)r * ldt + l0 + cc;
      t_k[i] = r;
    } else {              // row m0 + r of the table, k along the row
      t_ok[i] = c < CT && m0 + r < mhi;
      t_off[i] = (long)(m0 + r) * ldt + cc;
      t_k[i] = cc;
    }
  }

  auto load = [&](int stage, int kt) {
    S* raw = reinterpret_cast<S*>(ring + stage * STAGE_BYTES);
    bf16* tt = reinterpret_cast<bf16*>(ring + stage * STAGE_BYTES + RAW_BYTES);
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < NCS; ++i) {   // the state tile, SR x SC (unpadded)
      const int c = tid + i * NT;
      if (c >= CS) break;
      const bool ok = s_ok[i] && k0 + s_k[i] < K;
      cp16(raw + c * ES, ok ? state + s_off[i] + k0 * s_step : state, ok);
    }
#pragma unroll
    for (int i = 0; i < NCT; ++i) {   // the bf16 table tile, TR x TC
      const int c = tid + i * NT;
      if (c >= CT) break;
      const int r = c / (TC / 8), cc = (c % (TC / 8)) * 8;
      const bool ok = t_ok[i] && k0 + t_k[i] < K;
      cp16(tt + r * TW + cc, ok ? tab + t_off[i] + k0 * t_step : tab, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_wait<NS - 2>();
    __syncthreads();   // tile t is in; every warp is done with tile t-1
    if (t + NS - 1 < nk) load((t + NS - 1) % NS, t + NS - 1);
    cp_commit();
    const char* st = ring + (t % NS) * STAGE_BYTES;
    const S* raw = reinterpret_cast<const S*>(st);
    const bf16* tt = reinterpret_cast<const bf16*>(st + RAW_BYTES);
    for (int u = tid; u < SR * SC / 4; u += NT) {   // scale and split
      const int r = (4 * u) / SC, cc = (4 * u) % SC;
      float4 v = ld4(raw + r * SC + cc);
      v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
      split4(v, two, hi + r * HW + cc, lo + r * HW + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[2][2][4];              // [mi][hi|lo]
      unsigned b[TL::NI / 2][2][4];     // [n pair][hi|lo]
      const bf16* abuf[2] = {SA ? hi : tt, lo};
      const int aw = SA ? HW : TW;
      const bf16* bbuf[2] = {SA ? tt : hi, lo};
      const int bw = SA ? TW : HW;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm * 32 + mi * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 8;
        ldsm_x4(a[mi][0], abuf[0] + row * aw + col);
        if (SA && two) ldsm_x4(a[mi][1], abuf[1] + row * aw + col);
      }
#pragma unroll
      for (int np = 0; np < TL::NI / 2; ++np) {
        const int q = lane >> 3;
        const int krow = kk + (q & 1) * 8 + (lane & 7);
        const int col = wn * TL::WN + np * 16 + (q >> 1) * 8;
        ldsm_x4_t(b[np][0], bbuf[0] + krow * bw + col);
        if (!SA && two) ldsm_x4_t(b[np][1], bbuf[1] + krow * bw + col);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < TL::NI; ++ni) {
          const unsigned(&bh)[4] = b[ni / 2][0];
          const int o = (ni & 1) * 2;
          mma16816(acc.c[mi][ni], a[mi][0], bh[o], bh[o + 1]);
          if (two) {
            if (SA) {
              mma16816(acc.c[mi][ni], a[mi][1], bh[o], bh[o + 1]);
            } else {
              const unsigned(&bl)[4] = b[ni / 2][1];
              mma16816(acc.c[mi][ni], a[mi][0], bl[o], bl[o + 1]);
            }
          }
        }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the next segment reuses the ring
}

// acc += scale * A[rows] @ B[:, l0:l0+BL] with float32 FMAs, for a table
// that is not exactly bf16: the same operands as tc_segment (A row of
// output row m is A + (m + a_shift) * lda, valid for m in [mlo, mhi); B is
// [K, ldb]; K is a multiple of BKF), staged through registers into double-
// buffered float tiles. Each thread sums the elements it holds in the
// accumulator's fragment layout, k ascending.
template <int BM, class TA, class TB>
__device__ __forceinline__ void fma_segment(
    Acc<BM>& acc, char* smem, const TA* __restrict__ A, int lda, int a_shift,
    int mlo, int mhi, float scale, const TB* __restrict__ B, int ldb, int K,
    int m0, int l0) {
  using TL = Tile<BM>;
  constexpr int AN = BM * BKF / NT;             // A elements per thread
  float (*As)[BKF][BM] = reinterpret_cast<float (*)[BKF][BM]>(smem);
  float (*Bs)[BKF][BL] =
      reinterpret_cast<float (*)[BKF][BL]>(smem + 2 * BKF * BM * 4);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int g = lane >> 2, q = lane & 3;
  const int bk = tid / (BL / 4), bc = (tid % (BL / 4)) * 4;
  const TB* b_ptr = B + (size_t)bk * ldb + l0 + bc;
  const int ntiles = K / BKF;

  float a_reg[AN];
  auto load_a = [&](int t) {
#pragma unroll
    for (int i = 0; i < AN; ++i) {
      const int e = tid + i * NT, ar = e / BKF, ak = e % BKF;
      const int m = m0 + ar;
      a_reg[i] = (m >= mlo && m < mhi)
                     ? ldf(A + (size_t)(m + a_shift) * lda + t * BKF + ak) * scale
                     : 0.f;
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < AN; ++i) {
      const int e = tid + i * NT;
      As[buf][e % BKF][e / BKF] = a_reg[i];
    }
  };
  load_a(0);
  float4 b_reg = ld4(b_ptr);
  store_a(0);
  *reinterpret_cast<float4*>(&Bs[0][bk][bc]) = b_reg;
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < ntiles;
    if (more) {
      load_a(t + 1);
      b_reg = ld4(b_ptr + (size_t)(t + 1) * BKF * ldb);
    }
#pragma unroll
    for (int kk = 0; kk < BKF; ++kk) {
      float av[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          av[mi][hh] = As[cur][kk][wm * 32 + mi * 16 + g + 8 * hh];
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni) {
        const float2 bv = *reinterpret_cast<const float2*>(
            &Bs[cur][kk][wn * TL::WN + ni * 8 + 2 * q]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float* c = acc.c[mi][ni];
          c[0] = fmaf(av[mi][0], bv.x, c[0]);
          c[1] = fmaf(av[mi][0], bv.y, c[1]);
          c[2] = fmaf(av[mi][1], bv.x, c[2]);
          c[3] = fmaf(av[mi][1], bv.y, c[3]);
        }
      }
    }
    if (more) {
      store_a(cur ^ 1);
      *reinterpret_cast<float4*>(&Bs[cur ^ 1][bk][bc]) = b_reg;
    }
    __syncthreads();
  }
}

// One K segment on the route its table takes: `exact` says the table is
// the bf16 copy (tensor cores), else it is float (FMAs). A bf16 state under
// a scale that is not a power of two (a lo|mid term's non-dyadic value)
// multiplies the bf16 table with FMAs: scaled, it is no longer a bf16, and
// the FMAs keep its product float32-exact.
template <int BM, class S, bool SA>
__device__ __forceinline__ void segment(
    Acc<BM>& acc, char* smem, const S* state, int lds, int shift, int mlo,
    int mhi, float scale, const void* tab, int ldt, int K, int m0, int l0,
    bool exact) {
  const bool pow2 = (__float_as_uint(scale) & 0x7fffffu) == 0;
  if (exact && (sizeof(S) == 4 || pow2)) {
    tc_segment<BM, S, SA>(acc, smem, state, lds, shift, mlo, mhi, scale,
                          static_cast<const bf16*>(tab), ldt, K, m0, l0);
  } else if constexpr (SA) {
    if (exact)
      fma_segment<BM>(acc, smem, state, lds, shift, mlo, mhi, scale,
                      static_cast<const bf16*>(tab), ldt, K, m0, l0);
    else
      fma_segment<BM>(acc, smem, state, lds, shift, mlo, mhi, scale,
                      static_cast<const float*>(tab), ldt, K, m0, l0);
  } else {   // W_mid^T @ T: the scale is 1, so the table is not exact here
    fma_segment<BM>(acc, smem, static_cast<const float*>(tab), ldt, 0, 0,
                    mhi, 1.f, state, lds, K, m0, l0);
  }
}

// The tile's matrix products for state T (one plane): T[h] @ W_lo,
// W_mid^T @ T[h], and val * S[h, r0+i] @ A for every lo|mid cross term
// whose mid rows meet the tile. src_of(c) is cross term c's source group
// in the same plane as T (an untyped pointer to elements of type S).
template <int BM, class S, class SrcOf>
__device__ __forceinline__ void tile_products(
    Acc<BM>& acc, char* smem, const KgDesc& d, const S* T, SrcOf src_of,
    int h, int m0, int l0) {
  const int cmp = d.cmp, clp = d.clp;
  const S* Th = T + (size_t)h * cmp * clp;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Tile<BM>::NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.c[mi][ni][r] = 0.f;

  if (d.W_lo != nullptr)      // T[h] @ W_lo
    segment<BM, S, true>(acc, smem, Th, clp, 0, 0, cmp, 1.f, d.W_lo, clp,
                         clp, m0, l0, d.wlo_exact);
  if (d.W_mid_T != nullptr)   // W_mid^T @ T[h]
    segment<BM, S, false>(acc, smem, Th, clp, 0, 0, cmp, 1.f, d.W_mid_T, cmp,
                          cmp, m0, l0, d.wmid_exact);
  for (int c = 0; c < d.n_cross; ++c) {   // lo|mid: val * S[h, r0+i] @ A
    const KgCross& x = d.cross[c];
    if (m0 + BM <= x.c0 || m0 >= x.c0 + x.ln) continue;  // block-uniform
    segment<BM, S, true>(acc, smem, static_cast<const S*>(src_of(c)) +
                         (size_t)h * x.cmp_s * x.clp_s, x.clp_s,
                         x.r0 - x.c0, x.c0, x.c0 + x.ln, x.val, x.A, clp,
                         x.clp_s, m0, l0, x.exact);
  }
}

// The accumulator into the float tile E [BM, BL + PADE] of shared memory,
// so that the epilogue reads 4-wide row pieces. The caller syncs after the
// last segment (each segment ends in one) and before reading E.
template <int BM>
__device__ __forceinline__ void stage_acc(const Acc<BM>& acc, float* E) {
  using TL = Tile<BM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wm * 32 + mi * 16 + g + 8 * hh;
        const int col = wn * TL::WN + ni * 8 + 2 * q;
        *reinterpret_cast<float2*>(&E[row * (BL + PADE) + col]) =
            make_float2(acc.c[mi][ni][2 * hh], acc.c[mi][ni][2 * hh + 1]);
      }
}

// The hi-local sum of H at out[h, m, l:l+4] for one plane:
//   seed + T * (D1 + D2[h, m] + D3[h, l]) + acc_row + mid|hi slice adds.
// t returns T[h, m, l:l+4]. srch_of(c) is mid|hi term c's source group in
// T's plane (untyped, elements of type S); seed may be NULL.
template <class S, class SrcOf>
__device__ __forceinline__ float4 hi_local_row(
    const KgDesc& d, const float4& acc_row, const S* T,
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
  r.x += t.x * dg.x + acc_row.x;
  r.y += t.y * dg.y + acc_row.y;
  r.z += t.z * dg.z + acc_row.z;
  r.w += t.w * dg.w + acc_row.w;
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

// Launch one instance with its dynamic shared memory. `attr_set` is the
// instance's own flag: the attribute that allows more than 48 KB is set on
// its first launch.
template <class Kern, class Desc>
inline int launch(Kern kernel, const Desc& desc, dim3 grid, size_t smem,
                  cudaStream_t st, bool& attr_set) {
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kernel<<<grid, NT, smem, st>>>(desc);
  return (int)cudaGetLastError();
}

}  // namespace kron_tile
