// K1: fused sector_kron group apply for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel spindynamics_tpu/ops/pallas_kron.py:
// _build_group_call. For one kron group with state T [ch, cmp, clp] it
// computes, for every hi row h,
//
//   out[h] = seed[h] + T[h] * (D1 + D2[h,:,None] + D3[h,None,:])
//          + T[h] @ W_lo + W_mid^T @ T[h]
//          + sum_lo|mid  val * (S[h, r0:r0+ln, :] @ A)       into mid rows c0:c0+ln
//          + sum_mid|hi  val * S[h+rb0-cb0, ra0:ra0+lna, :]   into mid rows ca0:ca0+lna,
//                                                             for h in [cb0, cb0+lnb)
//
// Design. The TPU kernel streams one whole [cmp, clp] hi row through VMEM
// per grid step and read-modify-writes the cross slabs into it. A Hopper
// block has at most 227 KB of shared memory (a row is up to 950 KB at L=32),
// so here each block owns one OUTPUT TILE out[h, m0:m0+32, l0:l0+128] on a
// grid (clp/128, ceil(cmp/32), ch) and gathers every term of that tile:
// the three matrix products run as one register accumulator over a
// sequence of K segments (W_lo over clp, W_mid over cmp, one segment per
// lo|mid cross term over clp_s) staged through double-buffered shared
// memory, and the seed, diagonal and mid|hi slice adds are added in the
// epilogue. Each output element is written once by one thread, in a fixed
// order: no atomics and no read-modify-write, so the apply is
// deterministic (the two-pass Lanczos regenerates its basis bit for bit).
//
// Bound. At L=28 one apply moves ~98 GFLOP through the matrix products
// against ~1 GB of state traffic, so it is compute-bound; this version
// runs f32 FMAs on the CUDA cores (67 TFLOP/s on the H100 SXM data sheet).
// Next step: W_lo, W_mid and the one-hot A are exactly representable in
// bf16, so the TPU's hi+lo bf16 state split maps onto bf16 wgmma with f32
// accumulation (two tensor-core passes, f32-grade result).
//
// Interface: plain C, loaded with ctypes. kg_launch takes a host pointer to
// a KgDesc (mirrored by ctypes structures in ops/kron_group.py) and a
// cudaStream_t, launches on that stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#define KG_MAX_CROSS 16
#define KG_MAX_CROSSH 8
#define KG_MAX_MIDS 4

struct KgCross {        // lo|mid term
  const float* src;     // source group [ch, cmp_s, clp_s]
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
  const float* src;     // source group [ch_s, cmp_s, clp]
  int ch_s, cmp_s;
  int rb0, cb0, lnb;
  int n_mids;
  KgMid mids[KG_MAX_MIDS];
};

struct KgDesc {
  float* out;           // [ch, cmp, clp]
  const float* T;       // [ch, cmp, clp]
  const float* seed;    // [ch, cmp, clp] or NULL
  const float* D1;      // [cmp, clp] or NULL
  const float* D2;      // [ch, cmp] or NULL
  const float* D3;      // [ch, clp] or NULL
  const float* W_lo;    // [clp, clp] or NULL
  const float* W_mid_T; // [cmp, cmp] or NULL
  int ch, cmp, clp;
  int n_cross, n_crossh;
  KgCross cross[KG_MAX_CROSS];
  KgCrossH crossh[KG_MAX_CROSSH];
};

namespace {

constexpr int BM = 32;    // mid rows per tile
constexpr int BL = 128;   // lo columns per tile
constexpr int BK = 8;     // K depth per shared-memory stage
constexpr int NT = 256;   // threads: 8 warps x 32 lanes, 4x4 outputs each

struct Smem {
  float A[2][BK][BM];     // A tile, k-major
  float B[2][BK][BL];
};

// acc += scale * A[rows] @ B[:, l0:l0+BL] for tile rows m in [m0, m0+BM):
// A row of output row m is A + (m + a_shift) * lda, valid for m in
// [mlo, mhi) (zero elsewhere); B is [K, ldb]; K is a multiple of BK.
__device__ __forceinline__ void gemm_segment(
    float (&acc)[4][4], Smem& sm, const float* __restrict__ A, int lda,
    int a_shift, int mlo, int mhi, float scale,
    const float* __restrict__ B, int ldb, int K, int m0, int l0) {
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  const int ar = tid / BK, ak = tid % BK;              // A stage coords
  const int bk = tid / (BL / 4), bc = (tid % (BL / 4)) * 4;  // B stage coords
  const int m = m0 + ar;
  const bool a_ok = m >= mlo && m < mhi;
  const float* a_ptr = a_ok ? A + (size_t)(m + a_shift) * lda + ak : A;
  const float* b_ptr = B + (size_t)bk * ldb + l0 + bc;
  const int ntiles = K / BK;

  float a_reg = a_ok ? a_ptr[0] * scale : 0.f;
  float4 b_reg = *reinterpret_cast<const float4*>(b_ptr);
  sm.A[0][ak][ar] = a_reg;
  *reinterpret_cast<float4*>(&sm.B[0][bk][bc]) = b_reg;
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < ntiles;
    if (more) {
      a_reg = a_ok ? a_ptr[(t + 1) * BK] * scale : 0.f;
      b_reg = *reinterpret_cast<const float4*>(
          b_ptr + (size_t)(t + 1) * BK * ldb);
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(NT)
kron_group_kernel(const __grid_constant__ KgDesc d) {
  __shared__ __align__(16) Smem sm;
  const int l0 = blockIdx.x * BL;
  const int m0 = blockIdx.y * BM;
  const int h = blockIdx.z;
  const int cmp = d.cmp, clp = d.clp;
  const size_t plane = (size_t)cmp * clp;
  const float* Th = d.T + (size_t)h * plane;

  float acc[4][4];
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
    gemm_segment(acc, sm, x.src + (size_t)h * x.cmp_s * x.clp_s, x.clp_s,
                 x.r0 - x.c0, x.c0, x.c0 + x.ln, x.val, x.A, clp, x.clp_s,
                 m0, l0);
  }

  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const int l = l0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= cmp) break;
    const size_t idx = (size_t)h * plane + (size_t)m * clp + l;
    const float4 t = ld4(d.T + idx);
    float4 r = d.seed != nullptr ? ld4(d.seed + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
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
    r.x += t.x * dg.x + acc[i][0];
    r.y += t.y * dg.y + acc[i][1];
    r.z += t.z * dg.z + acc[i][2];
    r.w += t.w * dg.w + acc[i][3];
    for (int c = 0; c < d.n_crossh; ++c) {   // mid|hi slice adds
      const KgCrossH& x = d.crossh[c];
      if (h < x.cb0 || h >= x.cb0 + x.lnb) continue;
      const int srow = min(max(h + x.rb0 - x.cb0, 0), x.ch_s - 1);
      const float* S = x.src + (size_t)srow * x.cmp_s * clp;
      for (int k = 0; k < x.n_mids; ++k) {
        const KgMid& mr = x.mids[k];
        if (m < mr.ca0 || m >= mr.ca0 + mr.lna) continue;
        const float4 s = ld4(S + (size_t)(mr.ra0 + m - mr.ca0) * clp + l);
        r.x += mr.val * s.x; r.y += mr.val * s.y;
        r.z += mr.val * s.z; r.w += mr.val * s.w;
      }
    }
    *reinterpret_cast<float4*>(d.out + idx) = r;
  }
}

}  // namespace

extern "C" int kg_desc_size(void) { return (int)sizeof(KgDesc); }

extern "C" int kg_launch(const KgDesc* desc, void* stream) {
  const KgDesc& d = *desc;
  if (d.ch < 1 || d.cmp < 1 || d.clp < 1 || d.clp % BL != 0 ||
      d.cmp % BK != 0 || d.n_cross < 0 || d.n_cross > KG_MAX_CROSS ||
      d.n_crossh < 0 || d.n_crossh > KG_MAX_CROSSH)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(d.clp / BL, (d.cmp + BM - 1) / BM, d.ch);
  kron_group_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(d);
  return (int)cudaGetLastError();
}
