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
// Bound. Bytes: the state is read once and written once at the least, 2 x
// 2^L x 4 B (x 2 complex): 0.16 ms at L=26 real against 3.35 TB/s. The FMAs
// (about 2 per element per active bond) are far below the float32 peak.
// The partner reads of the bonds whose bits do not both lie in one tile add
// state passes (`fused_pass_count`: 8.5 in all for the L=26 chain at the
// default 2^13 float32 tile, 7.5 at 2^15); the 50 MB L2 serves those whose
// partner tile was read shortly before, so device memory sees the partners
// of the state's top few bits.
//
// What held the first version back was latency, not bytes: it loaded each
// partner amplitude with a scalar load inside a data-dependent branch and
// consumed it at once, so each SM kept a few KB in flight, and the real
// apply took as long as 16 passes at the HBM rate. This version keeps a
// ring of partner chunks in flight per SM instead:
//
//   - A block owns a TILE of 2^k contiguous amplitudes (32 KB by default,
//     up to 128 KB: 2^15 float32, 2^14 complex64) and walks the tiles in
//     index order (a persistent grid: block b takes tiles b, b + grid, ...).
//     Own tiles are staged in shared memory by bulk asynchronous copies
//     (cp.async.bulk, completed on an mbarrier), into two slots where
//     shared memory holds them, so that the next tile lands while this one
//     is computed. A tile of 64 KB or less runs two blocks per SM, a larger
//     one a single block with a single slot, which leaves the SM idle at
//     every tile's edge: such tiles are slower (PERF.md).
//   - One producer thread walks, for each output CHUNK c of 2^cb amplitudes
//     (16 KB), the tile's compacted partner list and stages every partner
//     chunk it needs into a ring of 16 KB stages, as many ahead as shared
//     memory holds: a straddle bond (i local, j a tile bit) needs chunk c of
//     the partner tile t ^ 2^(j-k) for i < cb, and chunk c ^ 2^(i-cb) for
//     i >= cb, and then only for the chunks whose bit i-cb selects the
//     active half; a tile-space bond (both bits tile bits) needs chunk c of
//     t ^ 2^(i-k) ^ 2^(j-k) only where the tile's mask is 1 (half of the
//     tiles; the TPU kernel's `_holdable` elision), else it is skipped.
//   - Eight consumer warps own the output chunk in 16-byte vectors (four
//     float32 or two complex64 amplitudes, four vectors per thread) and
//     add, in a fixed order, the diagonal, the local bonds (both bits < k:
//     from the own tile in shared memory), the straddle bonds and the
//     tile-space bonds (from the ring), then store the vector. A partner
//     whose index differs in bits 0-1 (float32) or bit 0 (complex64) lies in
//     the same vector: a lane swizzle in registers, no second load; a bond
//     whose bits both lie above the vector has one mask per vector.
//
// What bounds it now: the partner chunks that miss L2 (the copy-only
// skeleton of this kernel, own tiles in and outputs out, runs at the rate
// of a plain device copy), and for float32 the consumers' instructions for
// the local bonds, which overlap the ring only in part.
//
// No N-sized diagonal is read: diag(s) = dtab[e] (a 2^k table of every term
// whose bits are local, resident in L2) + one scalar per tile (terms with
// both bits >= k) + sum_i heff_i(t) sz_i(e) (straddle zz terms, folded per
// tile into an effective field on the local bits). The arithmetic is
// float32 FMAs. Each output element is written once by one thread in a
// fixed order of terms, the output never aliases the input, and there are
// no atomics: the apply is deterministic, and an input that is zero outside
// a U(1) sector gives exact zeros outside it (every such output is a sum of
// products with zeros).
//
// Interface: plain C, loaded with ctypes. k3_launch takes a host pointer to
// a K3Desc (mirrored by a ctypes structure in ops/fused_matvec.py) and a
// cudaStream_t, launches on that stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int K3_MAX_TILE_BYTES = 1 << 17;  // 2^15 float32, 2^14 complex64
constexpr int K3_MIN_TILE_BYTES = 16;       // one vector
constexpr int K3_CHUNK_BYTES = 1 << 14;     // one ring stage at the most
constexpr int K3_MAX_STAGES = 16;
constexpr int K3_MAX_BONDS = 256;   // per class
constexpr int K3_MAX_ZZ = 1024;     // straddle + tile-space zz terms
constexpr int K3_CWARPS = 8;        // consumer warps
constexpr int K3_NC = 32 * K3_CWARPS;
constexpr int K3_NT = K3_NC + 32;   // + the producer warp
constexpr int K3_VPT = K3_CHUNK_BYTES / 16 / K3_NC;  // vectors per thread

struct K3Desc {
  void* y;              // out, [2^L] float or float2, 16-byte aligned
  const void* x;        // in, 16-byte aligned
  const float* dtab;    // [2^k] local part of the diagonal
  const int* hop_ij;    // [n_local + n_strad + n_tile][2], class-ordered,
                        // i < j; bits >= k are stored minus k
  const float* hop_J;   // [n_local + n_strad + n_tile]
  const int* zz_ij;     // [n_zs + n_zb][2]: straddle (i local, j - k), then
                        // tile-space (i - k, j - k)
  const float* zz_J;    // [n_zs + n_zb]
  const float* fh;      // [L - k] field on the tile bits
  int L, k, chunk_bits, is_complex;
  int n_local, n_strad, n_tile, n_zs, n_zb;
  int n_hbits;          // local bits that carry a straddle zz term
  int hbits[16];
};

namespace {

// ---- shared memory: own tiles | ring | barriers | per-tile | lists -------

// The ring's shape for one launch: partner-chunk stages, and own-tile slots
// (two where shared memory holds them, so that the next tile is staged
// while this one is computed).
struct Ring {
  int stages, own_slots;
};

struct Layout {
  size_t ring, bars, tv, bonds, zz, fh, total;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~15; }

__host__ __device__ inline Layout layout(const K3Desc& d, int eb,
                                         const Ring& g) {
  Layout s;
  s.ring = (size_t)g.own_slots * ((size_t)eb << d.k);
  s.bars = s.ring + (size_t)g.stages * ((size_t)eb << d.chunk_bits);
  s.tv = s.bars + 8 * (2 * (size_t)g.stages + 2 * (size_t)g.own_slots);
  s.bonds = align16(s.tv + 4 * 17);  // heff per hbit [16], dscal
  s.zz = align16(s.bonds + 8 * (size_t)(d.n_local + d.n_strad + d.n_tile));
  s.fh = s.zz + 8 * (size_t)(d.n_zs + d.n_zb);
  s.total = align16(s.fh + 4 * 32);
  return s;
}

// ---- mbarriers and bulk copies (PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}" ::"r"(smem_u32(b)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(K3_NC) : "memory");
}

// ---- 16-byte vectors: 4 float32 lanes or 2 complex64 lanes ----------------

template <bool C> struct Vec;
template <> struct Vec<false> {
  static constexpr int VB = 2;           // log2 amplitudes per vector
  static constexpr unsigned FULL = 0xF;
  // lanes whose in-vector index has bit i set, i < VB
  __device__ __forceinline__ static unsigned low_pat(int i) {
    return i ? 0xCu : 0xAu;
  }
  // lane l takes lane l ^ s
  __device__ __forceinline__ static float4 swz(float4 p, int s) {
    if (s & 1) p = make_float4(p.y, p.x, p.w, p.z);
    if (s & 2) p = make_float4(p.z, p.w, p.x, p.y);
    return p;
  }
  __device__ __forceinline__ static void fma_lanes(float4& a, float J,
                                                  float4 p, unsigned m) {
    if (m & 1) a.x = fmaf(J, p.x, a.x);
    if (m & 2) a.y = fmaf(J, p.y, a.y);
    if (m & 4) a.z = fmaf(J, p.z, a.z);
    if (m & 8) a.w = fmaf(J, p.w, a.w);
  }
  __device__ __forceinline__ static float4 scale(const float* dg, float4 p) {
    return make_float4(dg[0] * p.x, dg[1] * p.y, dg[2] * p.z, dg[3] * p.w);
  }
  __device__ __forceinline__ static void diag(const float* dtab, int e0,
                                             float s, float* dg) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(dtab + e0));
    dg[0] = v.x + s; dg[1] = v.y + s; dg[2] = v.z + s; dg[3] = v.w + s;
  }
};
template <> struct Vec<true> {
  static constexpr int VB = 1;
  static constexpr unsigned FULL = 0x3;
  __device__ __forceinline__ static unsigned low_pat(int) { return 0x2u; }
  __device__ __forceinline__ static float4 swz(float4 p, int s) {
    return (s & 1) ? make_float4(p.z, p.w, p.x, p.y) : p;
  }
  __device__ __forceinline__ static void fma_lanes(float4& a, float J,
                                                  float4 p, unsigned m) {
    if (m & 1) { a.x = fmaf(J, p.x, a.x); a.y = fmaf(J, p.y, a.y); }
    if (m & 2) { a.z = fmaf(J, p.z, a.z); a.w = fmaf(J, p.w, a.w); }
  }
  __device__ __forceinline__ static float4 scale(const float* dg, float4 p) {
    return make_float4(dg[0] * p.x, dg[0] * p.y, dg[1] * p.z, dg[1] * p.w);
  }
  __device__ __forceinline__ static void diag(const float* dtab, int e0,
                                             float s, float* dg) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(dtab + e0));
    dg[0] = v.x + s; dg[1] = v.y + s;
  }
};

// The lanes of the vector at in-tile index e0 whose amplitude has bit i set.
template <bool C>
__device__ __forceinline__ unsigned bit_lanes(int e0, int i) {
  using V = Vec<C>;
  if (i < V::VB) return V::low_pat(i);
  return ((e0 >> i) & 1) ? V::FULL : 0u;
}

__device__ __forceinline__ float szb(long long t, int bit) {
  return (float)((t >> bit) & 1) - 0.5f;
}

// A sum over a warp in a fixed tree: the same bits in every lane and run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Bars {
  uint64_t *full, *empty, *own_full, *own_empty;
  __device__ Bars(unsigned char* sm, const Layout& s, const Ring& g) {
    full = reinterpret_cast<uint64_t*>(sm + s.bars);
    empty = full + g.stages;
    own_full = empty + g.stages;
    own_empty = own_full + g.own_slots;
  }
};

// ---- the producer: own tiles ahead, each chunk's partner chunks -----------

template <bool C>
__device__ void produce(const K3Desc& d, const Ring& g, unsigned char* sm,
                        const Layout& s) {
  constexpr int EB = C ? 8 : 4;
  const int k = d.k, cb = d.chunk_bits;
  const int nchunk = 1 << (k - cb);
  const uint32_t tile_bytes = (uint32_t)EB << k;
  const uint32_t stage_bytes = (uint32_t)EB << cb;
  const long long n_tiles = 1LL << (d.L - k);
  const char* x = static_cast<const char*>(d.x);
  const Bars bar(sm, s, g);
  const int* bij = reinterpret_cast<const int*>(sm + s.bonds);
  const int nb = d.n_local + d.n_strad + d.n_tile;
  int slot = 0;
  uint32_t par = 1;  // the first waits on empty slots pass
  auto stage = [&](long long elem) {
    mbar_wait(bar.empty + slot, par);
    mbar_expect(bar.full + slot, stage_bytes);
    bulk_g2s(sm + s.ring + (size_t)slot * stage_bytes, x + elem * EB,
             stage_bytes, bar.full + slot);
    if (++slot == g.stages) { slot = 0; par ^= 1; }
  };
  // the block's n-th tile t into own slot n % own_slots
  auto own = [&](long long t, int n) {
    const int o = n % g.own_slots;
    mbar_wait(bar.own_empty + o, ((n / g.own_slots) & 1) ^ 1);
    mbar_expect(bar.own_full + o, tile_bytes);
    for (uint32_t off = 0; off < tile_bytes; off += K3_CHUNK_BYTES)
      bulk_g2s(sm + (size_t)o * tile_bytes + off, x + (t << k) * EB + off,
               min(tile_bytes - off, (uint32_t)K3_CHUNK_BYTES),
               bar.own_full + o);
  };
  // With two slots the next tile is staged after this tile's first chunk;
  // with one, only after its last (its slot is free once it is consumed).
  const int own_at = g.own_slots > 1 ? 0 : nchunk - 1;
  if (blockIdx.x < n_tiles) own(blockIdx.x, 0);
  int n = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++n) {
    for (int c = 0; c < nchunk; ++c) {
      for (int q = d.n_local; q < d.n_local + d.n_strad; ++q) {
        const int i = bij[q] & 255, jt = bij[q] >> 8;
        const int want = (int)((t >> jt) & 1) ^ 1;
        int pc = c;
        if (i >= cb) {
          if (((c >> (i - cb)) & 1) != want) continue;
          pc = c ^ (1 << (i - cb));
        }
        stage(((t ^ (1LL << jt)) << k) + ((long long)pc << cb));
      }
      for (int q = d.n_local + d.n_strad; q < nb; ++q) {
        const int it = bij[q] & 255, jt = bij[q] >> 8;
        if (!(((t >> it) ^ (t >> jt)) & 1)) continue;
        stage(((t ^ (1LL << it) ^ (1LL << jt)) << k) + ((long long)c << cb));
      }
      if (c == own_at && t + gridDim.x < n_tiles) own(t + gridDim.x, n + 1);
    }
  }
}

// ---- the consumers: one output chunk at a time, 16-byte vectors ------------

template <bool C>
__device__ void consume(const K3Desc& d, const Ring& g, unsigned char* sm,
                        const Layout& s) {
  using V = Vec<C>;
  constexpr int EB = C ? 8 : 4;
  constexpr int VB = V::VB;
  constexpr int VW = 1 << VB;
  const int k = d.k, cb = d.chunk_bits;
  const int nchunk = 1 << (k - cb);
  const int nvec = 1 << (cb - VB);          // vectors per chunk
  const int stage_vecs = (EB << cb) / 16;
  const long long n_tiles = 1LL << (d.L - k);
  const int ctid = threadIdx.x, lane = threadIdx.x & 31, warp = ctid >> 5;
  const float4* ring = reinterpret_cast<const float4*>(sm + s.ring);
  const Bars bar(sm, s, g);
  float* tv = reinterpret_cast<float*>(sm + s.tv);  // heff per hbit, dscal
  const int nb = d.n_local + d.n_strad + d.n_tile;
  const int* bij = reinterpret_cast<const int*>(sm + s.bonds);
  const float* bJ = reinterpret_cast<const float*>(bij + nb);
  const int nz = d.n_zs + d.n_zb;
  const int* zij = reinterpret_cast<const int*>(sm + s.zz);
  const float* zJ = reinterpret_cast<const float*>(zij + nz);
  const float* fh = reinterpret_cast<const float*>(sm + s.fh);
  float4* y = static_cast<float4*>(d.y);
  int slot = 0;
  uint32_t par = 0;

  int n = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++n) {
    // ---- factored diagonal: the tile's effective field and scalar, one
    // warp per term list, summed in a fixed order ----------------------------
    consumers_sync();  // the previous tile's values are no longer read
    for (int q = warp; q < d.n_hbits; q += K3_CWARPS) {
      float h = 0.0f;
      for (int z = lane; z < d.n_zs; z += 32)
        if ((zij[z] & 255) == d.hbits[q]) h += zJ[z] * szb(t, zij[z] >> 8);
      h = warp_sum(h);
      if (lane == 0) tv[q] = h;
    }
    if (warp == K3_CWARPS - 1) {
      float sc = 0.0f;
      for (int z = d.n_zs + lane; z < nz; z += 32)
        sc += zJ[z] * szb(t, zij[z] & 255) * szb(t, zij[z] >> 8);
      for (int b = lane; b < d.L - k; b += 32) sc += fh[b] * szb(t, b);
      sc = warp_sum(sc);
      if (lane == 0) tv[16] = sc;
    }
    consumers_sync();
    const float dscal = tv[16];
    const int o = n % g.own_slots;
    mbar_wait(bar.own_full + o, (n / g.own_slots) & 1);
    const float4* own =
        reinterpret_cast<const float4*>(sm + ((size_t)o * EB << k));

    for (int c = 0; c < nchunk; ++c) {
      float4 acc[K3_VPT];
      // the diagonal, then the local bonds, from the own tile
#pragma unroll
      for (int r = 0; r < K3_VPT; ++r) {
        const int v = ctid + r * K3_NC;
        if (v >= nvec) continue;
        const int e0 = (c << cb) + (v << VB);  // in-tile index of lane 0
        float dg[VW];
        V::diag(d.dtab, e0, dscal, dg);
        for (int q = 0; q < d.n_hbits; ++q) {
          const int bit = d.hbits[q];
          const float h = tv[q];
#pragma unroll
          for (int l = 0; l < VW; ++l)
            dg[l] = fmaf(h, (float)(((e0 + l) >> bit) & 1) - 0.5f, dg[l]);
        }
        acc[r] = V::scale(dg, own[e0 >> VB]);
      }
      for (int q = 0; q < d.n_local; ++q) {
        const int i = bij[q] & 255, j = bij[q] >> 8;
        const int m = (1 << i) | (1 << j);
        const float J = bJ[q];
        if (i >= VB) {  // both bits above the vector: one mask per vector
#pragma unroll
          for (int r = 0; r < K3_VPT; ++r) {
            const int v = ctid + r * K3_NC;
            const int e0 = (c << cb) + (v << VB);
            if (v < nvec && (((e0 >> i) ^ (e0 >> j)) & 1))
              V::fma_lanes(acc[r], J, own[(e0 ^ m) >> VB], V::FULL);
          }
          continue;
        }
#pragma unroll
        for (int r = 0; r < K3_VPT; ++r) {
          const int v = ctid + r * K3_NC;
          if (v >= nvec) continue;
          const int e0 = (c << cb) + (v << VB);
          const unsigned on = bit_lanes<C>(e0, i) ^ bit_lanes<C>(e0, j);
          if (on)
            V::fma_lanes(acc[r], J,
                         V::swz(own[(e0 ^ m) >> VB], m & (VW - 1)), on);
        }
      }
      // straddle bonds, from the ring
      for (int q = d.n_local; q < d.n_local + d.n_strad; ++q) {
        const int i = bij[q] & 255, jt = bij[q] >> 8;
        const int want = (int)((t >> jt) & 1) ^ 1;
        const bool above = i >= cb;  // partner chunk c ^ 2^(i-cb), all lanes
        if (above && ((c >> (i - cb)) & 1) != want) continue;
        mbar_wait(bar.full + slot, par);
        const float4* st = ring + (size_t)slot * stage_vecs;
        const float J = bJ[q];
#pragma unroll
        for (int r = 0; r < K3_VPT; ++r) {
          const int v = ctid + r * K3_NC;
          if (v >= nvec) continue;
          if (above) {
            V::fma_lanes(acc[r], J, st[v], V::FULL);
          } else if (i >= VB) {  // one mask per vector
            const int e0 = (c << cb) + (v << VB);
            if (((e0 >> i) & 1) == want)
              V::fma_lanes(acc[r], J, st[v ^ (1 << (i - VB))], V::FULL);
          } else {
            const int e0 = (c << cb) + (v << VB);
            const unsigned hi = bit_lanes<C>(e0, i);
            const unsigned on = want ? hi : (V::FULL & ~hi);
            if (on)
              V::fma_lanes(acc[r], J,
                           V::swz(st[v ^ ((1 << i) >> VB)],
                                  (1 << i) & (VW - 1)), on);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar.empty + slot);
        if (++slot == g.stages) { slot = 0; par ^= 1; }
      }
      // tile-space bonds where the tile's mask is 1, from the ring
      for (int q = d.n_local + d.n_strad; q < nb; ++q) {
        const int it = bij[q] & 255, jt = bij[q] >> 8;
        if (!(((t >> it) ^ (t >> jt)) & 1)) continue;
        mbar_wait(bar.full + slot, par);
        const float4* st = ring + (size_t)slot * stage_vecs;
        const float J = bJ[q];
#pragma unroll
        for (int r = 0; r < K3_VPT; ++r) {
          const int v = ctid + r * K3_NC;
          if (v < nvec) V::fma_lanes(acc[r], J, st[v], V::FULL);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar.empty + slot);
        if (++slot == g.stages) { slot = 0; par ^= 1; }
      }
#pragma unroll
      for (int r = 0; r < K3_VPT; ++r) {
        const int v = ctid + r * K3_NC;
        if (v < nvec)
          y[(((t << k) + (c << cb)) >> VB) + v] = acc[r];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.own_empty + o);
  }
}

template <bool C>
__global__ void __launch_bounds__(K3_NT)
fused_matvec_kernel(const __grid_constant__ K3Desc d, const Ring g) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout s = layout(d, C ? 8 : 4, g);
  const int nb = d.n_local + d.n_strad + d.n_tile, nz = d.n_zs + d.n_zb;
  int* bij = reinterpret_cast<int*>(sm + s.bonds);
  float* bJ = reinterpret_cast<float*>(bij + nb);
  int* zij = reinterpret_cast<int*>(sm + s.zz);
  float* zJ = reinterpret_cast<float*>(zij + nz);
  float* fh = reinterpret_cast<float*>(sm + s.fh);
  for (int q = threadIdx.x; q < nb; q += K3_NT) {
    bij[q] = d.hop_ij[2 * q] | (d.hop_ij[2 * q + 1] << 8);
    bJ[q] = d.hop_J[q];
  }
  for (int q = threadIdx.x; q < nz; q += K3_NT) {
    zij[q] = d.zz_ij[2 * q] | (d.zz_ij[2 * q + 1] << 8);
    zJ[q] = d.zz_J[q];
  }
  for (int b = threadIdx.x; b < d.L - d.k; b += K3_NT) fh[b] = d.fh[b];
  if (threadIdx.x == 0) {
    const Bars bar(sm, s, g);
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(bar.full + i, 1);            // the producer's arrival
      mbar_init(bar.empty + i, K3_CWARPS);   // each consumer warp's
    }
    for (int o = 0; o < g.own_slots; ++o) {
      mbar_init(bar.own_full + o, 1);
      mbar_init(bar.own_empty + o, K3_CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= K3_NC) {
    if (threadIdx.x == K3_NC) produce<C>(d, g, sm, s);
    return;
  }
  consume<C>(d, g, sm, s);
}

bool desc_ok(const K3Desc& d) {
  const int eb = d.is_complex ? 8 : 4;
  const bool aligned = !((reinterpret_cast<uintptr_t>(d.x) |
                          reinterpret_cast<uintptr_t>(d.y) |
                          reinterpret_cast<uintptr_t>(d.dtab)) & 15);
  if (!(d.y && d.x && d.y != d.x && d.dtab && d.fh && aligned && d.L >= 1 &&
        d.L <= 31 && d.k >= 0 && d.k <= d.L && d.chunk_bits >= 0 &&
        d.chunk_bits <= d.k))
    return false;
  const long long tile = (long long)eb << d.k;
  const long long chunk = (long long)eb << d.chunk_bits;
  return tile >= K3_MIN_TILE_BYTES && tile <= K3_MAX_TILE_BYTES &&
         chunk >= 16 && chunk <= K3_CHUNK_BYTES &&
         (chunk == K3_CHUNK_BYTES || chunk == tile) &&
         d.n_local >= 0 && d.n_local <= K3_MAX_BONDS && d.n_strad >= 0 &&
         d.n_strad <= K3_MAX_BONDS && d.n_tile >= 0 &&
         d.n_tile <= K3_MAX_BONDS && d.n_zs >= 0 && d.n_zb >= 0 &&
         d.n_zs + d.n_zb <= K3_MAX_ZZ && d.n_hbits >= 0 && d.n_hbits <= 16 &&
         (d.n_local + d.n_strad + d.n_tile == 0 || (d.hop_ij && d.hop_J)) &&
         (d.n_zs + d.n_zb == 0 || (d.zz_ij && d.zz_J));
}

// The ring for one launch: two blocks per SM for a tile of 64 KB or less,
// else one; two own-tile slots where they leave room for four stages; then
// as many stages as the shared memory left holds.
Ring ring_for(const K3Desc& d, int eb) {
  const size_t tile = (size_t)eb << d.k, chunk = (size_t)eb << d.chunk_bits;
  const size_t budget = tile <= (64u << 10) ? (112u << 10) : (226u << 10);
  for (int own_slots = 2;; --own_slots) {
    const size_t fixed = layout(d, eb, Ring{0, own_slots}).total;
    // a stage: its chunk and its two barriers
    const size_t n = budget > fixed ? (budget - fixed) / (chunk + 16) : 0;
    if (n >= 4 || own_slots == 1)
      return Ring{(int)(n < 2 ? 2 : (n > K3_MAX_STAGES ? K3_MAX_STAGES : n)),
                  own_slots};
  }
}

template <bool C>
int launch(const K3Desc& d, cudaStream_t stream) {
  const Ring g = ring_for(d, C ? 8 : 4);
  const size_t smem = layout(d, C ? 8 : 4, g).total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_matvec_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_matvec_kernel<C>, K3_NT, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = 1LL << (d.L - d.k);
  const long long most = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(n_tiles < most ? n_tiles : most);
  fused_matvec_kernel<C><<<grid, K3_NT, smem, stream>>>(d, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k3_desc_size(void) { return (int)sizeof(K3Desc); }

extern "C" int k3_launch(const K3Desc* desc, void* stream) {
  const K3Desc& d = *desc;
  if (!desc_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d.is_complex ? launch<true>(d, s) : launch<false>(d, s);
}
