// K3: fused matvec H|psi> on a flat 2^L state for Hopper (sm_90a), float32
// or complex64 (read as float2).
//
// Replaces the Pallas TPU kernel spindynamics_tpu/ops/pallas_matvec.py:
// _make_kernel. In one pass over the state it computes, for every index s,
//
//   y[s] = diag(s) x[s] + sum_b J_b [bit_i(s) != bit_j(s)] x[s ^ (2^i | 2^j)]
//   diag(s) = sum_z Jz_z sz_i(s) sz_j(s) + sum_i h_i sz_i(s),  sz = bit - 1/2
//
// over every hopping bond b = (i, j, J_b), long-range bonds included.
//
// Design. The TPU kernel turns every index XOR into a one-hot matrix
// product, because a per-element gather is slow there. Here an XOR of the
// index is an address. A block owns one TILE of 2^k contiguous amplitudes
// (k = tile_bits, 12 by default: 16 KB real, 32 KB complex, several blocks
// per SM) and stages it in shared memory. By where a bond's two bits live:
//   local     both bits <  k: reads tile[e ^ m] from shared memory;
//   straddle  one bit < k, one >= k: reads the partner tile t ^ 2^(j-k) from
//             global memory at e ^ 2^i (an XOR on low bits permutes within a
//             line, so the read stays coalesced); the mask depends on the
//             element: bit_i(e) != bit_j(t);
//   tile      both bits >= k: the mask is one scalar per tile; when it is 0
//             the partner tile is not read at all, else it is read at the
//             same e, coalesced.
// No N-sized diagonal is read: diag(s) = dtab[e] (a 2^k table of every term
// whose bits are local, resident in L1/L2) + one scalar per tile (terms with
// both bits >= k) + sum_i heff_i(t) sz_i(e) (straddle zz terms, folded per
// tile into an effective field on the local bits). There is no matrix
// product and no bf16 split: the arithmetic is float32 FMAs. Each output
// element is written once by one thread, the output never aliases the input,
// and there are no atomics: the apply is deterministic, and an input that is
// zero outside a U(1) sector gives exact zeros outside it (every such output
// is a sum of products with zeros).
//
// Bound. Bytes: the state is read once and written once at the least, 2 x
// 2^L x 4 B (x 2 complex): 0.16 ms at L=26 real against 3.35 TB/s. The FMAs
// (about 2 per element per active bond) are far below the float32 peak. This
// one-sweep version also reads one partner tile per active tile-space bond
// and per straddle bond, about 1 + (L - k)/2 state passes more for a chain;
// the L2 cache takes those whose partner is near. Staging partner tiles with
// cp.async/TMA and a multi-sweep scheme that cuts the partner reads are the
// next steps.
//
// Interface: plain C, loaded with ctypes. k3_launch takes a host pointer to
// a K3Desc (mirrored by a ctypes structure in ops/fused_matvec.py) and a
// cudaStream_t, launches on that stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int K3_MAX_TILE_BITS = 13;
constexpr int K3_MAX_BONDS = 256;   // per class, staged in shared memory
constexpr int K3_MAX_ZZ = 1024;     // straddle + tile-space zz terms
constexpr int K3_NT = 256;          // threads per block

struct K3Desc {
  void* y;              // out, [2^L] float or float2
  const void* x;        // in
  const float* dtab;    // [2^k] local part of the diagonal
  const int* hop_ij;    // [n_local + n_strad + n_tile][2], class-ordered,
                        // i < j; bits >= k are stored minus k
  const float* hop_J;   // [n_local + n_strad + n_tile]
  const int* zz_ij;     // [n_zs + n_zb][2]: straddle (i local, j - k), then
                        // tile-space (i - k, j - k)
  const float* zz_J;    // [n_zs + n_zb]
  const float* fh;      // [L - k] field on the tile bits
  int L, k, is_complex;
  int n_local, n_strad, n_tile, n_zs, n_zb;
  int n_hbits;          // local bits that carry a straddle zz term
  int hbits[16];
};

namespace {

struct Smem {
  float loc_J[K3_MAX_BONDS];
  int loc_ij[K3_MAX_BONDS];     // i | j << 8
  float str_J[K3_MAX_BONDS];
  int str_iw[K3_MAX_BONDS];     // i | (bit_j(t) ^ 1) << 8: active iff
                                // bit_i(e) == that bit
  long long str_off[K3_MAX_BONDS];   // partner tile base, in elements
  float til_J[K3_MAX_BONDS];    // J where the tile's mask is 1, else 0
  long long til_off[K3_MAX_BONDS];
  float heff[16];
  float dscal;
};

__device__ __forceinline__ float szb(long long t, int bit) {
  return (float)((t >> bit) & 1) - 0.5f;
}

__device__ __forceinline__ void fma_to(float& a, float J, float v) {
  a = fmaf(J, v, a);
}
__device__ __forceinline__ void fma_to(float2& a, float J, float2 v) {
  a.x = fmaf(J, v.x, a.x);
  a.y = fmaf(J, v.y, a.y);
}
__device__ __forceinline__ float scaled(float d, float v) { return d * v; }
__device__ __forceinline__ float2 scaled(float d, float2 v) {
  return make_float2(d * v.x, d * v.y);
}

template <typename T>
__global__ void __launch_bounds__(K3_NT)
fused_matvec_kernel(const __grid_constant__ K3Desc d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Smem sm;
  T* tile = reinterpret_cast<T*>(smem_raw);

  const int k = d.k;
  const int n = 1 << k;
  const long long t = blockIdx.x;
  const long long base = t << k;
  const T* __restrict__ x = static_cast<const T*>(d.x);
  T* __restrict__ y = static_cast<T*>(d.y);
  const int tid = threadIdx.x;

  // ---- stage the own tile and the per-tile bond lists ---------------------
  for (int e = tid; e < n; e += K3_NT) tile[e] = x[base + e];
  for (int q = tid; q < d.n_local; q += K3_NT) {
    sm.loc_ij[q] = d.hop_ij[2 * q] | (d.hop_ij[2 * q + 1] << 8);
    sm.loc_J[q] = d.hop_J[q];
  }
  for (int q = tid; q < d.n_strad; q += K3_NT) {
    const int b = d.n_local + q;
    const int i = d.hop_ij[2 * b], jt = d.hop_ij[2 * b + 1];
    const int want = (int)((t >> jt) & 1) ^ 1;
    sm.str_iw[q] = i | (want << 8);
    sm.str_J[q] = d.hop_J[b];
    sm.str_off[q] = ((t ^ (1LL << jt)) << k);
  }
  for (int q = tid; q < d.n_tile; q += K3_NT) {
    const int b = d.n_local + d.n_strad + q;
    const int it = d.hop_ij[2 * b], jt = d.hop_ij[2 * b + 1];
    const bool on = ((t >> it) ^ (t >> jt)) & 1;
    sm.til_J[q] = on ? d.hop_J[b] : 0.0f;
    sm.til_off[q] = ((t ^ (1LL << it) ^ (1LL << jt)) << k);
  }
  // ---- factored diagonal: per-tile parts ----------------------------------
  if (tid < 16) {
    float h = 0.0f;
    for (int z = 0; z < d.n_zs; ++z)
      if (d.zz_ij[2 * z] == tid) h += d.zz_J[z] * szb(t, d.zz_ij[2 * z + 1]);
    sm.heff[tid] = h;
  }
  if (tid == 32) {
    float s = 0.0f;
    for (int z = d.n_zs; z < d.n_zs + d.n_zb; ++z)
      s += d.zz_J[z] * szb(t, d.zz_ij[2 * z]) * szb(t, d.zz_ij[2 * z + 1]);
    for (int b = 0; b < d.L - k; ++b) s += d.fh[b] * szb(t, b);
    sm.dscal = s;
  }
  __syncthreads();

  const int n_local = d.n_local, n_strad = d.n_strad, n_tile = d.n_tile;
  const int n_hbits = d.n_hbits;
  const float dscal = sm.dscal;

  for (int e = tid; e < n; e += K3_NT) {
    float dg = __ldg(d.dtab + e) + dscal;
    for (int q = 0; q < n_hbits; ++q) {
      const int bit = d.hbits[q];
      dg = fmaf(sm.heff[bit], (float)((e >> bit) & 1) - 0.5f, dg);
    }
    T acc = scaled(dg, tile[e]);
    for (int q = 0; q < n_local; ++q) {
      const int ij = sm.loc_ij[q];
      const int i = ij & 255, j = ij >> 8;
      if (((e >> i) ^ (e >> j)) & 1)
        fma_to(acc, sm.loc_J[q], tile[e ^ ((1 << i) | (1 << j))]);
    }
    for (int q = 0; q < n_strad; ++q) {
      const int iw = sm.str_iw[q];
      const int i = iw & 255;
      if (((e >> i) & 1) == (iw >> 8))
        fma_to(acc, sm.str_J[q], x[sm.str_off[q] + (e ^ (1 << i))]);
    }
    for (int q = 0; q < n_tile; ++q) {
      const float J = sm.til_J[q];
      if (J != 0.0f) fma_to(acc, J, x[sm.til_off[q] + e]);
    }
    y[base + e] = acc;
  }
}

bool desc_ok(const K3Desc& d) {
  return d.y && d.x && d.y != d.x && d.dtab && d.fh && d.L >= 1 &&
         d.L <= 31 && d.k >= 0 && d.k <= K3_MAX_TILE_BITS && d.k <= d.L &&
         d.n_local >= 0 && d.n_local <= K3_MAX_BONDS && d.n_strad >= 0 &&
         d.n_strad <= K3_MAX_BONDS && d.n_tile >= 0 &&
         d.n_tile <= K3_MAX_BONDS && d.n_zs >= 0 && d.n_zb >= 0 &&
         d.n_zs + d.n_zb <= K3_MAX_ZZ && d.n_hbits >= 0 && d.n_hbits <= 16 &&
         (d.n_local + d.n_strad + d.n_tile == 0 || (d.hop_ij && d.hop_J)) &&
         (d.n_zs + d.n_zb == 0 || (d.zz_ij && d.zz_J));
}

template <typename T>
int launch(const K3Desc& d, cudaStream_t stream) {
  const size_t bytes = sizeof(T) << d.k;
  cudaError_t err = cudaFuncSetAttribute(
      fused_matvec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(T) << K3_MAX_TILE_BITS));
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = 1u << (d.L - d.k);
  fused_matvec_kernel<T><<<grid, K3_NT, bytes, stream>>>(d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k3_desc_size(void) { return (int)sizeof(K3Desc); }

extern "C" int k3_launch(const K3Desc* desc, void* stream) {
  const K3Desc& d = *desc;
  if (!desc_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d.is_complex ? launch<float2>(d, s) : launch<float>(d, s);
}
