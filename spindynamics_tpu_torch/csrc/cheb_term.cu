// K2: fused Chebyshev evolution term for Hopper (sm_90a), for float32 and
// bfloat16 states.
//
// Replaces the Pallas TPU kernel spindynamics_tpu/ops/pallas_cheb.py:
// _build_term_call. One term k >= 2 of the Chebyshev-Bessel step
// e^{-iH dt} (solvers/kron_evolve._cheb_kron_scan) for one kron group
// [ch, cmp, clp] and both (re, im) planes of the state:
//
//   H_p   = K1's hi-local sum on plane p (seed, diagonal, T@W_lo,
//           W_mid^T@T, lo|mid cross products, mid|hi slice adds)
//   x_p   = (H_p - b * T_p) * (2 / a) - prev_p           -> next_p
//   acc_re = acc_re + c_r * x_re - c_i * x_im            (in place)
//   acc_im = acc_im + c_i * x_re + c_r * x_im            (in place)
//
// in the operation order of the TPU kernel's epilogue (pallas_cheb.py
// :165-178), so the f32 results compare tightly with the plain version.
//
// Design. K1's output-tile gather (kron_tile.cuh; kron_group.cu explains
// it), with both planes in one block: the accumulator update mixes x_re and
// x_im at the same element, so one thread must hold both. Each block keeps
// two register accumulators (re, im) and runs each K segment once per plane
// on the segment's route (bf16 tensor cores with the hi/lo state split where
// the table is exactly bf16, float32 FMAs elsewhere), stages both into
// shared memory, and the epilogue computes x and the complex multiply-add per
// element. acc is read and written by the same thread at the same element
// (the in->out alias of pallas_cheb.py:232), so the update is in place and
// race-free. next may be prev's storage (ops/cheb_term.py reuses it from
// the second fused term of a step on): each element of prev is read by the
// thread that then writes next there, and by no other. T and the cross
// sources are read by many blocks and are never written.
//
// State types. A template on the state's element type, like K1. With
// bfloat16 (the TPU kernel's state_dtype=bfloat16) T, prev, the seeds and
// the cross sources are bfloat16 and next is stored bfloat16, rounded once
// to nearest even; the accumulator pair stays float and is updated from the
// unrounded float x (pallas_cheb.py:171-178), in the same operation order.
//
// Bound. Twice K1's products per group (two planes) against ~12
// state-sized streams (T, prev, acc, seed in; next, acc out, per plane). On
// the tensor-core route that is bound by bytes at L=28 and at L=32 alike:
// at L=28 2.54 GB (0.76 ms at 3.35 TB/s) against 2 x 185 GFLOP of bf16
// products (0.37 ms at 989 TFLOP/s), at L=32 36.2 GB (10.8 ms) against 2 x
// 3522 GFLOP (7.1 ms). The design reads each of those streams once per
// element, in the epilogue, and keeps the products off the FMA units; the
// two planes still stage the shared tables twice (one W_lo tile for both
// planes, and fewer launches, are later work).
//
// Interface: plain C, loaded with ctypes. ct_launch takes a host pointer to
// a CtDesc (mirrored by ctypes structures in ops/cheb_term.py) and a
// cudaStream_t, launches on that stream and returns cudaGetLastError().
// The four per-term scalars ride in the descriptor, passed by value: no
// device read and no host sync per term.

#include "kron_tile.cuh"

struct CtDesc {
  KgDesc re;            // the re plane as K1 sees it: out = next_re, T =
                        // T_re, seed = seed_re, cross/crossh src = re
                        // sources, and the group's tables
                        // (re.state_type is the launch's state type)
  void* next_im;        // [ch, cmp, clp], state type; may be prev_im
  const void* T_im;     // state type, as seed_im and prev_*
  const void* seed_im;  // NULL iff re.seed is NULL
  const void* prev_re;  // may be re.out
  const void* prev_im;
  float* acc_re;        // float whatever the state type; read and written
  float* acc_im;        // in place
  const void* cross_src_im[KG_MAX_CROSS];
  const void* crossh_src_im[KG_MAX_CROSSH];
  float a_inv, b, c_r, c_i;
};

namespace {

using namespace kron_tile;

// One element of the epilogue: x = (h - b t) (2/a) - p for each plane,
// then the complex coefficient update of the accumulator.
__device__ __forceinline__ void term_element(
    const CtDesc& c, float two_ai, float hr, float hi, float tr, float ti,
    float pr, float pi, float& xr, float& xi, float& ar, float& ai) {
  xr = (hr - c.b * tr) * two_ai - pr;
  xi = (hi - c.b * ti) * two_ai - pi;
  ar = ar + c.c_r * xr - c.c_i * xi;
  ai = ai + c.c_i * xr + c.c_r * xi;
}

template <class S, int BM>
__global__ void __launch_bounds__(NT, 2)
cheb_term_kernel(const __grid_constant__ CtDesc c) {
  extern __shared__ __align__(16) char smem[];
  const KgDesc& d = c.re;
  const int l0 = blockIdx.x * BL;
  const int m0 = blockIdx.y * BM;
  const int h = blockIdx.z;

  const S* T_re = static_cast<const S*>(d.T);
  const S* T_im = static_cast<const S*>(c.T_im);
  Acc<BM> acc_re, acc_im;
  tile_products<BM>(acc_re, smem, d, T_re,
                    [&](int k) { return d.cross[k].src; }, h, m0, l0);
  tile_products<BM>(acc_im, smem, d, T_im,
                    [&](int k) { return c.cross_src_im[k]; }, h, m0, l0);
  float* E_re = reinterpret_cast<float*>(smem);
  float* E_im = E_re + BM * (BL + PADE);
  stage_acc(acc_re, E_re);
  stage_acc(acc_im, E_im);
  __syncthreads();

  const float two_ai = 2.f * c.a_inv;
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const int l = l0 + tx * 4;
  constexpr int RPT = BM / 8;   // rows per thread
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int m = m0 + r;
    if (m >= d.cmp) break;
    const int e = r * (BL + PADE) + tx * 4;
    float4 tr, ti;
    const float4 hr = hi_local_row(
        d, *reinterpret_cast<const float4*>(&E_re[e]), T_re,
        static_cast<const S*>(d.seed),
        [&](int k) { return d.crossh[k].src; }, h, m, l, tr);
    const float4 hi = hi_local_row(
        d, *reinterpret_cast<const float4*>(&E_im[e]), T_im,
        static_cast<const S*>(c.seed_im),
        [&](int k) { return c.crossh_src_im[k]; }, h, m, l, ti);
    const size_t idx = (size_t)h * d.cmp * d.clp + (size_t)m * d.clp + l;
    const float4 pr = ld4(static_cast<const S*>(c.prev_re) + idx);
    const float4 pi = ld4(static_cast<const S*>(c.prev_im) + idx);
    float4 ar = ld4(c.acc_re + idx);
    float4 ai = ld4(c.acc_im + idx);
    float4 xr, xi;
    term_element(c, two_ai, hr.x, hi.x, tr.x, ti.x, pr.x, pi.x, xr.x, xi.x,
                 ar.x, ai.x);
    term_element(c, two_ai, hr.y, hi.y, tr.y, ti.y, pr.y, pi.y, xr.y, xi.y,
                 ar.y, ai.y);
    term_element(c, two_ai, hr.z, hi.z, tr.z, ti.z, pr.z, pi.z, xr.z, xi.z,
                 ar.z, ai.z);
    term_element(c, two_ai, hr.w, hi.w, tr.w, ti.w, pr.w, pi.w, xr.w, xi.w,
                 ar.w, ai.w);
    st4(static_cast<S*>(d.out) + idx, xr);
    st4(static_cast<S*>(c.next_im) + idx, xi);
    st4(c.acc_re + idx, ar);
    st4(c.acc_im + idx, ai);
  }
}

template <class S, int BM>
int launch_k2(const CtDesc& c, cudaStream_t st) {
  static bool attr_set = false;
  return launch(cheb_term_kernel<S, BM>, c, grid_of(c.re, BM),
                smem_bytes<BM>(2), st, attr_set);
}

template <class S>
int launch_k2(const CtDesc& c, cudaStream_t st) {
  return tile_rows(c.re) == 64 ? launch_k2<S, 64>(c, st)
                               : launch_k2<S, 32>(c, st);
}

}  // namespace

extern "C" int ct_desc_size(void) { return (int)sizeof(CtDesc); }

extern "C" int ct_launch(const CtDesc* desc, void* stream) {
  const CtDesc& c = *desc;
  const KgDesc& d = c.re;
  // K2 takes no windows: the sharded evolve runs the plain recurrence
  if (!desc_ok(d) || d.n_crossw != 0 || d.out == nullptr || d.T == nullptr ||
      c.next_im == nullptr || c.T_im == nullptr || c.prev_re == nullptr ||
      c.prev_im == nullptr || c.acc_re == nullptr || c.acc_im == nullptr ||
      (d.seed == nullptr) != (c.seed_im == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d.state_type == KG_STATE_F32 ? launch_k2<float>(c, st)
                                      : launch_k2<__nv_bfloat16>(c, st);
}
