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
// so here each block owns one OUTPUT TILE out[h, m0:m0+BM, l0:l0+128] (BM =
// 64, or 32 for a launch too small to fill the card; kron_tile.cuh
// tile_rows) on a grid (clp/128, ceil(cmp/BM), ch) and gathers every term of
// that tile: the three matrix products run as one register accumulator over
// a sequence of K segments (W_lo over clp, W_mid over cmp, one segment per
// lo|mid cross term over clp_s), and the seed, diagonal and mid|hi slice
// adds are added in the epilogue, which reads the accumulator back from
// shared memory in 4-wide row pieces. Each output element is written once by
// one thread, in a fixed order: no atomics and no read-modify-write, so the
// apply is deterministic (the two-pass Lanczos regenerates its basis bit for
// bit).
//
// The products compute what the TPU kernel computes (_dot_split2,
// pallas_kron.py:177-214). W_lo, W_mid and the one-hot A are exactly bf16
// for every dyadic coupling; the host checks each table once, when the
// group's tables are built, and hands the kernel its bf16 copy and a flag
// (KgDesc.wlo_exact, wmid_exact, KgCross.exact). Such a segment runs on the
// tensor cores: the state tile arrives by cp.async in a ring of three
// stages (32 deep in K), is split once in shared memory into bf16 hi =
// bf16(s) and lo = bf16(s - hi) (a bfloat16 state is its own hi), and each
// half meets the bf16 table through ldmatrix (.trans for the state as the
// B operand of W_mid^T @ T) and mma.sync.m16n8k16 with float32 accumulation:
// two passes for a float32 state, one for a bfloat16 state. hi + lo carries
// 16 significand bits and every product is exact, so the result is float32
// grade (each product within 2^-16 of exact). A table that is not exactly
// bf16 (e.g. Jxy = 0.3, or long-range couplings) keeps the float32 FMA route
// on the CUDA cores, chosen from the data when the tables are built.
//
// Bound. At L=28 the kernel part of one apply moves 0.67 GB (float32
// states) against 2 x 91.5 GFLOP of bf16 tensor-core work: 0.20 ms of bytes
// at 3.35 TB/s against 0.19 ms at 989 TFLOP/s, so it is bound by bytes; at
// L=32 it moves 9.1 GB against 2 x 1754 GFLOP, 2.7 ms against 3.5 ms, so it
// is bound by the tensor cores. A bfloat16 state halves both. The design
// keeps the state's bytes to one read per tile (the ring streams each
// operand tile once per block) and lets the tensor cores take the products
// at 15x the FMA rate; what it leaves is one launch per group (sub-wave
// launches at L=28 and in the sharded crossw variant) and the per-stage
// split in shared memory.
//
// State types. The kernel is a template on the state's element type. With
// bfloat16 (the TPU kernel's state_dtype=bfloat16) T, the seed and every
// cross source are bfloat16 in memory; the accumulator stays float, and the
// one rounding (to nearest even) is the tile's single store.
//
// Interface: plain C, loaded with ctypes. kg_launch takes a host pointer to
// a KgDesc (kron_tile.cuh; mirrored by ctypes structures in
// ops/kron_group.py) and a cudaStream_t, launches on that stream and returns
// cudaGetLastError(); KgDesc.state_type picks the instance, and any other
// value is refused with cudaErrorInvalidValue. The descriptor, the two
// segment routes and the epilogue's hi-local sum live in kron_tile.cuh,
// shared with K2 (cheb_term.cu).

#include "kron_tile.cuh"

namespace {

using namespace kron_tile;

template <class S, int BM>
__global__ void __launch_bounds__(NT, 2)
kron_group_kernel(const __grid_constant__ KgDesc d) {
  extern __shared__ __align__(16) char smem[];
  const int l0 = blockIdx.x * BL;
  const int m0 = blockIdx.y * BM;
  const int h = blockIdx.z;

  const S* T = static_cast<const S*>(d.T);
  Acc<BM> acc;
  tile_products<BM>(acc, smem, d, T, [&](int c) { return d.cross[c].src; },
                    h, m0, l0);
  float* E = reinterpret_cast<float*>(smem);
  stage_acc(acc, E);
  __syncthreads();

  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const int l = l0 + tx * 4;
  constexpr int RPT = BM / 8;   // rows per thread
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int m = m0 + r;
    if (m >= d.cmp) break;
    const float4 a =
        *reinterpret_cast<const float4*>(&E[r * (BL + PADE) + tx * 4]);
    float4 t;
    float4 o = hi_local_row(
        d, a, T, static_cast<const S*>(d.seed),
        [&](int c) { return d.crossh[c].src; }, h, m, l, t);
    window_row_add<S>(d, o, h, m, l);
    st4(static_cast<S*>(d.out) + (size_t)h * d.cmp * d.clp +
            (size_t)m * d.clp + l, o);
  }
}

template <class S, int BM>
int launch_k1(const KgDesc& d, cudaStream_t st) {
  static bool attr_set = false;
  return launch(kron_group_kernel<S, BM>, d, grid_of(d, BM),
                smem_bytes<BM>(1), st, attr_set);
}

template <class S>
int launch_k1(const KgDesc& d, cudaStream_t st) {
  return tile_rows(d) == 64 ? launch_k1<S, 64>(d, st)
                            : launch_k1<S, 32>(d, st);
}

}  // namespace

extern "C" int kg_desc_size(void) { return (int)sizeof(KgDesc); }

extern "C" int kg_launch(const KgDesc* desc, void* stream) {
  const KgDesc& d = *desc;
  if (!desc_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d.state_type == KG_STATE_F32 ? launch_k1<float>(d, st)
                                      : launch_k1<__nv_bfloat16>(d, st);
}
