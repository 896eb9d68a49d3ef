// dot2: the solvers' compensated inner product over a table of leaf pairs,
// one pass and one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package the compensated dot
// (spindynamics_tpu/utils/compensated.py: dot2, two_prod) is an XLA fusion
// of Dekker's two_prod and two sums, one pass over x and y. Run eagerly in
// torch that became about 20 launches and 51 leaf-sized passes per leaf
// (the plain version, utils/compensated.dot2). This kernel computes
//
//   out = sum_l sum_i x_l[i] * y_l[i]
//
// over up to D2_MAX_LEAVES pairs (x_l, y_l) in one launch: each product of
// two float32 (or bfloat16) values is formed in float64, where it is exact
// (48 significant bits), the sum is kept in float64 and rounded once to
// float32. That is at least as accurate as Dot2's sum(e) + sum(p) in
// float32. A float64 call (every leaf float64) runs the same code with
// float64 elements and a float64 result (products rounded by the FMA).
//
// Bound. Bytes: x and y read once (x alone where x is y, a norm); at 3.35
// TB/s a float32 <v|w> of the L=32 kron state (601,080,390 amplitudes) is
// 1.44 ms. One float64 FMA per element is far below the card's float64
// rate.
//
// Design.
//   - The leaf table travels in the kernel's parameters (Dot2Desc, 4088
//     bytes of the 4 KB): pointers, an element stride per operand (1, or 2
//     for the .real / .imag planes of a complex tensor), int64 lengths and
//     tile offsets, the element type (float32 or bfloat16; float64 for a
//     float64 call) and two flags: x is y (load once), and the 16-byte
//     vector route (both
//     operands of one type, stride 1, 16-byte aligned). More leaves than a
//     table holds are chunked by the caller into one launch per table;
//     the float64 running sum is carried between them in the workspace and
//     rounded after the last.
//   - A fixed grid (D2_BLOCKS_PER_SM x the SM count, chosen by the caller
//     and written in the table) and a fixed element-to-thread map. Each
//     leaf is cut into TILES of D2_UNROLL x D2_BLOCK items: vectors of 16
//     bytes (V elements: 4 float32, 8 bfloat16, 2 float64) on the vector
//     route, then single elements for the rest (the tail past the last
//     whole vector, or the whole leaf off the vector route). The tiles of
//     all leaves are numbered in leaf order (`tile0`, prefix sums written
//     by the caller); block b takes tiles b, b + G, b + 2G, ..., and thread
//     t of a tile takes items u x D2_BLOCK + t, u < D2_UNROLL, issuing all
//     its loads before it adds. So every block has a whole tile of loads in
//     flight however short the leaves are (a map that strode over each leaf
//     with the whole grid left each thread about one load per leaf at L=28:
//     78 leaves, 0.166 ms where a copy of the bytes took 0.143 on an H100
//     80GB HBM3 at 700 W). Each
//     thread adds its products in that order into one float64 sum.
//   - Each block reduces its threads in a fixed tree (warp shuffles, then
//     the warps' sums through shared memory), writes its partial to the
//     workspace, and takes a ticket from an integer counter; the block that
//     takes the last ticket sums the G partials in a fixed order (thread t
//     takes t, t + B, ...; the same tree) and resets the counter. No float
//     atomics: two calls on the same inputs give the same bits, whichever
//     block finishes last. The host emulation of this exact partition is
//     `_emulate_dot2` in tests/_dot2_emulation.py.
//   - int64 lengths and indices throughout (the sharded L=34 state has
//     2.33e9 amplitudes).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define D2_MAX_LEAVES 112
#define D2_BLOCK 256
#define D2_UNROLL 4

// Dot2Desc.flags
#define D2_FIRST 1  // this launch starts the sum
#define D2_LAST 2   // this launch writes out
#define D2_F64 4    // float64 elements, float64 out

// Dot2Desc.meta[l]: bits 0-1 x stride, 2-3 y stride, then the flags
#define D2_M_XBF16 (1u << 4)
#define D2_M_YBF16 (1u << 5)
#define D2_M_SAME (1u << 6)
#define D2_M_VEC (1u << 7)

struct Dot2Desc {
  void* out;              // float (double with D2_F64), 0-d
  double* partials;       // [grid]
  double* acc;            // the sum carried between the launches of a call
  unsigned int* counter;  // blocks done; 0 between launches
  long long n_tiles;      // tiles of all leaves
  int n_leaves;
  int grid;
  int flags;
  int pad;
  uint64_t x[D2_MAX_LEAVES];
  uint64_t y[D2_MAX_LEAVES];
  long long n[D2_MAX_LEAVES];
  long long tile0[D2_MAX_LEAVES];  // first tile of each leaf (prefix sums)
  unsigned int meta[D2_MAX_LEAVES];
};

typedef unsigned short bf16_t;  // a bfloat16's bits

__device__ __forceinline__ double elem(const float* p, long long i) {
  return (double)__ldg(p + i);
}
__device__ __forceinline__ double elem(const double* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ double elem(const bf16_t* p, long long i) {
  return (double)__uint_as_float((unsigned int)__ldg(p + i) << 16);
}

// 16 bytes of T: the raw load and element k of it as a double
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  typedef float4 raw;
  __device__ __forceinline__ static raw load(const float* p, long long v) {
    return __ldg(reinterpret_cast<const float4*>(p) + v);
  }
  __device__ __forceinline__ static double at(const raw& r, int k) {
    return (double)(k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w);
  }
};
template <> struct Vec<bf16_t> {
  static constexpr int V = 8;
  typedef uint4 raw;
  __device__ __forceinline__ static raw load(const bf16_t* p, long long v) {
    return __ldg(reinterpret_cast<const uint4*>(p) + v);
  }
  __device__ __forceinline__ static double at(const raw& r, int k) {
    unsigned int w = (k >> 1) == 0 ? r.x : (k >> 1) == 1 ? r.y
                     : (k >> 1) == 2 ? r.z : r.w;
    return (double)__uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Vec<double> {
  static constexpr int V = 2;
  typedef double2 raw;
  __device__ __forceinline__ static raw load(const double* p, long long v) {
    return __ldg(reinterpret_cast<const double2*>(p) + v);
  }
  __device__ __forceinline__ static double at(const raw& r, int k) {
    return k == 0 ? r.x : r.y;
  }
};

// One tile of leaf (X, Y): D2_UNROLL x D2_BLOCK vectors (j < vt, the
// vector tiles) or elements (the scalar tiles after them, from n_main on).
// Thread t takes item q = u * D2_BLOCK + t for u = 0..D2_UNROLL-1, issues
// every load of the tile before it adds, and adds in the order u, then the
// element k within a vector.
template <typename TX, typename TY>
__device__ __forceinline__ void tile(const void* xp, const void* yp,
                                     long long n, unsigned int m,
                                     long long j, double& acc) {
  const TX* X = static_cast<const TX*>(xp);
  const TY* Y = static_cast<const TY*>(yp);
  const bool same = (m & D2_M_SAME) != 0;
  constexpr long long T = (long long)D2_UNROLL * D2_BLOCK;
  long long n_main = 0, vt = 0;
  if constexpr (std::is_same<TX, TY>::value) {
    typedef Vec<TX> W;
    if (m & D2_M_VEC) {
      const long long nv = n / W::V;
      n_main = nv * W::V;
      vt = (nv + T - 1) / T;
      if (j < vt) {
        const long long v0 = j * T + threadIdx.x;
        typename W::raw a[D2_UNROLL], b[D2_UNROLL];
#pragma unroll
        for (int u = 0; u < D2_UNROLL; ++u) {
          const long long v = v0 + u * D2_BLOCK;
          if (v < nv) {
            a[u] = W::load(X, v);
            if (!same) b[u] = W::load(Y, v);
          }
        }
#pragma unroll
        for (int u = 0; u < D2_UNROLL; ++u) {
          if (v0 + u * D2_BLOCK < nv) {
#pragma unroll
            for (int k = 0; k < W::V; ++k) {
              const double xa = W::at(a[u], k);
              acc = __fma_rn(xa, same ? xa : W::at(b[u], k), acc);
            }
          }
        }
        return;
      }
    }
  }
  const int sx = (int)(m & 3u), sy = (int)((m >> 2) & 3u);
  const long long i0 = n_main + (j - vt) * T + threadIdx.x;
  double px[D2_UNROLL], py[D2_UNROLL];
#pragma unroll
  for (int u = 0; u < D2_UNROLL; ++u) {
    const long long i = i0 + u * D2_BLOCK;
    if (i < n) {
      px[u] = elem(X, i * sx);
      py[u] = same ? px[u] : elem(Y, i * sy);
    }
  }
#pragma unroll
  for (int u = 0; u < D2_UNROLL; ++u)
    if (i0 + u * D2_BLOCK < n) acc = __fma_rn(px[u], py[u], acc);
}

// The block's sum in thread 0: shuffles down 16, 8, 4, 2, 1 in each warp,
// then warp 0 does the same over the warps' sums (zeros past them).
__device__ __forceinline__ double block_sum(double v, double* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < (D2_BLOCK / 32) ? sh[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <bool F64>
__global__ void __launch_bounds__(D2_BLOCK)
    dot2_kernel(const __grid_constant__ Dot2Desc d) {
  __shared__ double sh[D2_BLOCK / 32];
  __shared__ bool last;
  double acc = 0.0;
  int l = 0;
  for (long long g = blockIdx.x; g < d.n_tiles; g += d.grid) {
    while (l + 1 < d.n_leaves && g >= d.tile0[l + 1]) ++l;
    const unsigned int m = d.meta[l];
    const void* xp = reinterpret_cast<const void*>(d.x[l]);
    const void* yp = reinterpret_cast<const void*>(d.y[l]);
    const long long n = d.n[l], j = g - d.tile0[l];
    if constexpr (F64) {
      tile<double, double>(xp, yp, n, m, j, acc);
    } else {
      const bool bx = (m & D2_M_XBF16) != 0, by = (m & D2_M_YBF16) != 0;
      if (!bx && !by)
        tile<float, float>(xp, yp, n, m, j, acc);
      else if (bx && by)
        tile<bf16_t, bf16_t>(xp, yp, n, m, j, acc);
      else if (bx)
        tile<bf16_t, float>(xp, yp, n, m, j, acc);
      else
        tile<float, bf16_t>(xp, yp, n, m, j, acc);
    }
  }
  double s = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    d.partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(d.counter, 1u) == (unsigned int)(d.grid - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double t = 0.0;
  for (int b = threadIdx.x; b < d.grid; b += D2_BLOCK)
    t += __ldcg(d.partials + b);
  __syncthreads();  // sh is reused
  t = block_sum(t, sh);
  if (threadIdx.x == 0) {
    if (!(d.flags & D2_FIRST)) t = *d.acc + t;
    if (d.flags & D2_LAST) {
      if constexpr (F64)
        *static_cast<double*>(d.out) = t;
      else
        *static_cast<float*>(d.out) = __double2float_rn(t);
    } else {
      *d.acc = t;
    }
    *d.counter = 0u;
  }
}

// The tiles of one leaf: its vector tiles, then the scalar tiles of the
// rest (`tile` above).
static long long leaf_tiles(long long n, unsigned int m, bool f64) {
  const long long T = (long long)D2_UNROLL * D2_BLOCK;
  long long n_main = 0, vt = 0;
  if (m & D2_M_VEC) {
    const long long V = f64 ? 2 : ((m & D2_M_XBF16) ? 8 : 4);
    n_main = n / V * V;
    vt = (n / V + T - 1) / T;
  }
  return vt + (n - n_main + T - 1) / T;
}

static bool desc_ok(const Dot2Desc& d) {
  if (d.n_leaves < 0 || d.n_leaves > D2_MAX_LEAVES) return false;
  if (d.grid < 1 || d.grid > 65535) return false;
  if (!d.out || !d.partials || !d.acc || !d.counter) return false;
  const bool f64 = (d.flags & D2_F64) != 0;
  long long t = 0;
  for (int l = 0; l < d.n_leaves; ++l) {
    const unsigned int m = d.meta[l];
    const unsigned int sx = m & 3u, sy = (m >> 2) & 3u;
    const bool bx = (m & D2_M_XBF16) != 0, by = (m & D2_M_YBF16) != 0;
    if (d.n[l] < 0 || sx < 1 || sx > 2 || sy < 1 || sy > 2) return false;
    if (d.n[l] > 0 && (!d.x[l] || !d.y[l])) return false;
    if (f64 && (bx || by)) return false;
    if ((m & D2_M_VEC) && (bx != by || sx != 1 || sy != 1)) return false;
    if (d.tile0[l] != t) return false;
    t += leaf_tiles(d.n[l], m, f64);
  }
  return t == d.n_tiles;
}

extern "C" int dot2_desc_size(void) { return (int)sizeof(Dot2Desc); }

extern "C" int dot2_launch(const Dot2Desc* desc, void* stream) {
  const Dot2Desc& d = *desc;
  if (!desc_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.flags & D2_F64)
    dot2_kernel<true><<<d.grid, D2_BLOCK, 0, s>>>(d);
  else
    dot2_kernel<false><<<d.grid, D2_BLOCK, 0, s>>>(d);
  return (int)cudaGetLastError();
}
