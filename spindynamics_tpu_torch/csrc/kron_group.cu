// K1: fused sector_kron group apply for Hopper (sm_90a), for float32 and
// bfloat16 states.
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
//          + sum_window  val * win[h, ra0:ra0+lna, :]            into mid rows ca0:ca0+lna
//
// The last line is the crossw variant (the TPU kernel's crossw_shapes), used
// by the sharded apply: a launch covers one shard's local hi block, the
// mid|hi source rows live on other shards, and each term arrives as a window
// aligned to the output's rows (KgCrossW in kron_tile.cuh). The TPU kernel
// read-modify-writes each window slab into its VMEM row; here the window is
// one more gather in the epilogue of the tile that owns the element.
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
// State types. The kernel is a template on the state's element type. With
// bfloat16 (the TPU kernel's state_dtype=bfloat16) T, the seed and every
// cross source are bfloat16 in memory, widened to float as they are staged
// or loaded; the tables and the register accumulator stay float, so every
// product is exact in float, and the one rounding (to nearest even) is the
// tile's single store. The TPU kernel needs an f32 VMEM scratch and a
// two-pass table split for that; here it is the same gather with 8-byte
// loads and one 8-byte store.
//
// Bound. At L=28 one apply moves ~98 GFLOP through the matrix products
// against ~1 GB of state traffic, so it is compute-bound; this version
// runs f32 FMAs on the CUDA cores (67 TFLOP/s on the H100 SXM data sheet).
// Next step: W_lo, W_mid and the one-hot A are exactly representable in
// bf16, so the TPU's hi+lo bf16 state split maps onto bf16 wgmma with f32
// accumulation (two tensor-core passes, f32-grade result).
//
// Interface: plain C, loaded with ctypes. kg_launch takes a host pointer to
// a KgDesc (kron_tile.cuh; mirrored by ctypes structures in
// ops/kron_group.py) and a cudaStream_t, launches on that stream and returns
// cudaGetLastError(); KgDesc.state_type picks the instance, and any other
// value is refused with cudaErrorInvalidValue. The descriptor, the tile
// GEMM and the epilogue's hi-local sum live in kron_tile.cuh, shared with
// K2 (cheb_term.cu).

#include "kron_tile.cuh"

namespace {

using namespace kron_tile;

template <class S>
__global__ void __launch_bounds__(NT)
kron_group_kernel(const __grid_constant__ KgDesc d) {
  __shared__ __align__(16) Smem sm;
  const int l0 = blockIdx.x * BL;
  const int m0 = blockIdx.y * BM;
  const int h = blockIdx.z;

  const S* T = static_cast<const S*>(d.T);
  float acc[4][4];
  tile_products(acc, sm, d, T, [&](int c) { return d.cross[c].src; },
                h, m0, l0);

  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const int l = l0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= d.cmp) break;
    float4 t;
    float4 r = hi_local_row(
        d, acc[i], T, static_cast<const S*>(d.seed),
        [&](int c) { return d.crossh[c].src; }, h, m, l, t);
    window_row_add<S>(d, r, h, m, l);
    st4(static_cast<S*>(d.out) + (size_t)h * d.cmp * d.clp +
            (size_t)m * d.clp + l, r);
  }
}

}  // namespace

extern "C" int kg_desc_size(void) { return (int)sizeof(KgDesc); }

extern "C" int kg_launch(const KgDesc* desc, void* stream) {
  const KgDesc& d = *desc;
  if (!desc_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d.state_type == KG_STATE_F32)
    kron_group_kernel<float><<<grid_of(d), NT, 0, st>>>(d);
  else
    kron_group_kernel<__nv_bfloat16><<<grid_of(d), NT, 0, st>>>(d);
  return (int)cudaGetLastError();
}
