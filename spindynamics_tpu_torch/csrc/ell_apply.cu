// ell_apply: H psi over the ELL neighbour table of a compact (or full, with a
// table) model, one pass and one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this apply with an
// XLA gather over the whole [N, n_bonds] table (spindynamics_tpu/ops/
// apply.py, the 'ell' backend). Its torch transcription (the plain version,
// ops/ell_apply.ell_apply_plain) widened each block of the int32 table to
// int64, materialised a [rows, n_bonds] gathered block and multiplied it by
// the couplings with a gemv: about 30 GB moved per L=28 apply, some 6x what
// the work needs. This kernel computes
//
//   out[n] = diag[n] * psi[n] + sum_b J_b * psi[nbr[n, b]]   (nbr = -1: none)
//
// in one pass over the table.
//
// Bound. Bytes: the int32 table read once, psi and diag read, out written.
// At L=28, Sz=0 (N = 40,116,600, 27 bonds) that is 4.33 + 0.48 GB = 4.81 GB
// for a float32 state: 1.437 ms at 3.35 TB/s. The gathers of psi add what
// misses the L2; the arithmetic (one FMA per bond and plane) is far below
// the card's rates.
//
// Design.
//   - The table is read once, as int32, with no widening and no gathered
//     block in device memory. It is row-major, so a tile of R rows (R = the
//     block's threads) is one contiguous span of R * n_bonds words. Each
//     block copies its tiles into shared memory through two buffers with
//     cp.async (16-byte vectors where the table is 16-byte aligned, words
//     otherwise), one tile ahead of the one it computes, each copy marked
//     evict-first in the L2, so that the stream of the table does not push
//     psi out of it (without the hint the L=28 apply took 2.23 ms, not
//     1.94, on an H100 80GB HBM3 at 700 W). Two buffers of 256 rows of
//     27 bonds (55 KB) let four blocks share an SM: that beat three or
//     four buffers with fewer blocks (2.00-2.25 ms).
//   - Thread t of a tile owns row tile * R + t and reads its n_bonds
//     indices from shared memory at stride n_bonds words (no bank conflict
//     where n_bonds is odd, as the open chains' L - 1 is for even L).
//   - A persistent grid (as many blocks as the SMs hold) walks the tiles in
//     order, block b taking tiles b, b + G, ..., so the grid works on one
//     window of rows at a time. In the ascending compact sector, flipping
//     bond (i, i+1) moves the rank by +-C(i, c), c the set bits below i, and
//     that offset is constant over the runs of rows that share their bits
//     >= i: a warp's gathers for one bond are mostly one contiguous run, and
//     those of the bonds whose offsets lie within the L2's reach of the
//     window hit it. psi's own and gathered reads go through the read-only
//     path; diag is read and out written as streams (evict-first).
//   - Each row is summed in the state's precision, in registers, in a fixed
//     order: diag * psi first, then bonds 0 .. n_bonds - 1 by FMA, the
//     loads of ELL_UNROLL bonds issued before their FMAs (4, 8 and 16 were
//     within 3% of one another). out is written once, coalesced. No
//     atomics: applies are bit-identical run to run.
//     The host emulation of this partition and order is tests/
//     test_torch_ell_apply.py's `_emulate_ell`.
//   - One instance per element type: float, float2 (complex64, the real
//     couplings and diagonal applied to both planes), double and double2
//     (complex128). The rows per tile come from the caller (ops/ell_apply.
//     tile_rows: from n_bonds alone, 256 halved while two tiles of the
//     table pass 56 KB), the grid from the occupancy of that instance,
//     queried on a shape's first launch and kept (`grid_ceiling`).
//
// Interface (plain C, ctypes): ell_launch(out, psi, diag, J, nbr, n, nb,
// kind, rows, stream) launches on `stream` and returns cudaGetLastError();
// kind 0..3 = float32, complex64, float64, complex128.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define ELL_UNROLL 4

namespace {

struct EllArgs {
  void* out;
  const void* psi;
  const void* diag;  // real type of the state
  const void* J;     // real type of the state, [nb]
  const int* nbr;    // [n, nb] int32, row-major
  long long n;
  int nb;
  int pad;
};

// ---- cp.async (PTX) --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
      ::"r"(smem_u32(dst)), "l"(src), "l"(pol) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
      ::"r"(smem_u32(dst)), "l"(src), "l"(pol) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// ---- element types -------------------------------------------------------

template <typename T> struct Elt;
template <> struct Elt<float> {
  typedef float R;
  __device__ __forceinline__ static float zero() { return 0.f; }
  __device__ __forceinline__ static float scale(float d, float p) {
    return d * p;
  }
  __device__ __forceinline__ static float fma(float j, float v, float a) {
    return fmaf(j, v, a);
  }
};
template <> struct Elt<float2> {
  typedef float R;
  __device__ __forceinline__ static float2 zero() {
    return make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ static float2 scale(float d, float2 p) {
    return make_float2(d * p.x, d * p.y);
  }
  __device__ __forceinline__ static float2 fma(float j, float2 v, float2 a) {
    return make_float2(fmaf(j, v.x, a.x), fmaf(j, v.y, a.y));
  }
};
template <> struct Elt<double> {
  typedef double R;
  __device__ __forceinline__ static double zero() { return 0.0; }
  __device__ __forceinline__ static double scale(double d, double p) {
    return d * p;
  }
  __device__ __forceinline__ static double fma(double j, double v,
                                               double a) {
    return ::fma(j, v, a);
  }
};
template <> struct Elt<double2> {
  typedef double R;
  __device__ __forceinline__ static double2 zero() {
    return make_double2(0.0, 0.0);
  }
  __device__ __forceinline__ static double2 scale(double d, double2 p) {
    return make_double2(d * p.x, d * p.y);
  }
  __device__ __forceinline__ static double2 fma(double j, double2 v,
                                                double2 a) {
    return make_double2(::fma(j, v.x, a.x), ::fma(j, v.y, a.y));
  }
};

// Stage the `words` int32 of one tile (from `src`) into `dst`: 16-byte
// copies where the table is 16-byte aligned (every tile start then is:
// rows per tile are a multiple of 4), then single words for the rest.
__device__ __forceinline__ void stage_tile(int* dst, const int* src,
                                           int words, bool vec,
                                           uint64_t pol) {
  int done = 0;
  if (vec) {
    const int n16 = words >> 2;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i, pol);
    done = n16 << 2;
  }
  for (int i = done + threadIdx.x; i < words; i += blockDim.x)
    cp_async4(dst + i, src + i, pol);
}

template <typename T>
__global__ void __launch_bounds__(256) ell_kernel(const EllArgs a) {
  typedef typename Elt<T>::R R;
  extern __shared__ __align__(16) int ring[];
  const int rows = blockDim.x, nb = a.nb;
  const int stage_words = rows * nb;
  const long long n_tiles = (a.n + rows - 1) / rows;
  const bool vec = (reinterpret_cast<uintptr_t>(a.nbr) & 15) == 0;
  const uint64_t pol = evict_first_policy();
  const T* __restrict__ psi = static_cast<const T*>(a.psi);
  const R* __restrict__ diag = static_cast<const R*>(a.diag);
  const R* __restrict__ J = static_cast<const R*>(a.J);
  T* __restrict__ out = static_cast<T*>(a.out);

  auto stage = [&](long long tile, int slot) {
    const long long r0 = tile * rows;
    const long long left = a.n - r0;
    const int words = (int)(left < rows ? left : rows) * nb;
    stage_tile(ring + slot * stage_words, a.nbr + r0 * nb, words, vec, pol);
  };

  // one commit group per tile, empty or not: tile k is group k
  if (blockIdx.x < n_tiles) stage(blockIdx.x, 0);
  cp_async_commit();
  int k = 0;
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, ++k) {
    const long long ahead = tile + gridDim.x;
    if (ahead < n_tiles) stage(ahead, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();  // all but the newest group: this tile has landed
    __syncthreads();
    const long long r = tile * rows + threadIdx.x;
    if (r < a.n) {
      const int* idx_row = ring + (k & 1) * stage_words + threadIdx.x * nb;
      T acc = Elt<T>::scale(__ldcs(diag + r), __ldg(psi + r));
      for (int b0 = 0; b0 < nb; b0 += ELL_UNROLL) {
        int idx[ELL_UNROLL];
        T v[ELL_UNROLL];
#pragma unroll
        for (int u = 0; u < ELL_UNROLL; ++u) {
          idx[u] = b0 + u < nb ? idx_row[b0 + u] : -1;
          v[u] = idx[u] >= 0 ? __ldg(psi + idx[u]) : Elt<T>::zero();
        }
#pragma unroll
        for (int u = 0; u < ELL_UNROLL; ++u)
          if (idx[u] >= 0) acc = Elt<T>::fma(__ldg(J + b0 + u), v[u], acc);
      }
      __stcs(out + r, acc);
    }
    __syncthreads();  // the buffer is overwritten next round
  }
}

// The launch path's runtime queries, made once and kept: the instance's
// shared-memory cap per device (raised when a launch needs more) and the
// grid's ceiling (blocks per SM by the occupancy, times the SMs) per
// device, instance, rows and n_bonds, which is all it depends on. A repeat
// launch of one shape then asks the runtime for the device alone.
constexpr int MAX_DEVICES = 16, MAX_SHAPES = 64;
struct Shape {
  int dev, kind, rows, nb;
  long long most;
};
std::mutex shapes_lock;
size_t smem_cap[MAX_DEVICES][4];
Shape shapes[MAX_SHAPES];
int n_shapes = 0;

template <typename T>
int grid_ceiling(int dev, int kind, int rows, int nb, size_t smem,
                 long long* most) {
  std::lock_guard<std::mutex> hold(shapes_lock);
  for (int i = 0; i < n_shapes; ++i) {
    const Shape& s = shapes[i];
    if (s.dev == dev && s.kind == kind && s.rows == rows && s.nb == nb) {
      *most = s.most;
      return 0;
    }
  }
  cudaError_t err;
  const bool kept = dev < MAX_DEVICES;
  if (!kept || smem > smem_cap[dev][kind]) {
    if ((err = cudaFuncSetAttribute(
             ell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return (int)err;
    if (kept) smem_cap[dev][kind] = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ell_kernel<T>, rows, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *most = (long long)per_sm * sms;
  if (kept && n_shapes < MAX_SHAPES)
    shapes[n_shapes++] = Shape{dev, kind, rows, nb, *most};
  return 0;
}

template <typename T>
int launch(const EllArgs& a, int kind, int rows, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)rows * a.nb * sizeof(int);
  int dev = 0;
  long long most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int got = grid_ceiling<T>(dev, kind, rows, a.nb, smem, &most);
  if (got != 0) return got;
  const long long n_tiles = (a.n + rows - 1) / rows;
  const unsigned grid = (unsigned)(n_tiles < most ? n_tiles : most);
  ell_kernel<T><<<grid, rows, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_launch(void* out, const void* psi, const void* diag,
                          const void* J, const void* nbr, long long n,
                          int nb, int kind, int rows, void* stream) {
  if (n <= 0 || nb < 0 || (rows != 32 && rows != 64 && rows != 128 &&
                           rows != 256))
    return (int)cudaErrorInvalidValue;
  EllArgs a{out, psi, diag, J, static_cast<const int*>(nbr), n, nb, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch<float>(a, 0, rows, s);
    case 1: return launch<float2>(a, 1, rows, s);
    case 2: return launch<double>(a, 2, rows, s);
    case 3: return launch<double2>(a, 3, rows, s);
  }
  return (int)cudaErrorInvalidValue;
}
