// The tiled product that K1 (grouped_ff.cu), K8 (fused_update.cu) and K7
// (consensus_bwd.cu) run:
// a block's 64 x 128 output tile of A B, summed over the depth in slabs of
// 32 that stream through a three-stage cp.async ring, on the tensor cores
// (mma.sync m16n8k8, 3xTF32 for f32 operands), each slab's product folded
// into the tile's accumulator with an f32 add; and the pieces around it:
// the slab layouts, the block's share of the tile, the ordered sum of a
// split's partial tiles and the split planner's rule.
//
//  * slabs of A (64 rows x 32 deep) and B (32 deep x 128 columns) stream
//    through the ring with one barrier a slab, two copies in flight; every
//    slab row is copied in 16-byte pieces by unrolled loops and stored
//    unpadded, its pieces XOR-permuted by the row (a swizzle) so that
//    fragment loads hit distinct banks;
//  * each of the 8 warps owns 32 x 32 of the tile (2 x 4 mma tiles).  A is
//    stored along the depth, so the mma's depth is permuted the same way in
//    A and B: mma depth t and t + 4 of k8 step s of a 16-deep piece are
//    depth 4 t + 2 s and + 1, so one 16-byte shared load gives a lane 4
//    depths of one A row; a column j of an n-tile nt is column 4 j + nt, so
//    one 16-byte load gives a lane one depth of B for all four n-tiles.
//    Each split value serves two or four mma;
//  * each slab's product is formed in a zeroed fragment and added to the
//    tile's accumulator with an f32 add, so no long sum stays inside the
//    mma, whose f32 accumulation rounds toward zero (tile_mma.cuh);
//  * shared memory 72 KB for f32 operands, two blocks an SM.
#pragma once

#include "common.cuh"
#include "tile_mma.cuh"

namespace glom {
namespace tile {

constexpr int THREADS = 256;   // 8 warps, 2 x 4 of 32 x 32
constexpr int BM = 64;         // rows of an output tile
constexpr int BN = 128;        // columns of an output tile
constexpr int BK = 32;         // depth of a slab
constexpr int NST = 3;         // stages of the ring
constexpr int REDUCE_THREADS = 256;

// A slab: BM rows of BK depths of T, row-major and unpadded.  The 16-byte
// piece c of row r is stored at c ^ (half the pieces of a row) when r / (the
// rows of 128 bytes) is odd: a lane reads four depths of a row (16 bytes of
// f32, 8 of bf16), and the lanes of one shared-memory wavefront then hit
// distinct banks.
template <typename T>
struct ASlab {
  static constexpr int kRows = BM, kCols = BK;
  static constexpr int kChunk = 16 / sizeof(T);                  // elements a piece
  static constexpr int kFlip = BK / kChunk / 2;                  // 4 (f32), 2 (bf16)
  static constexpr int kRowsPerLine = 128 / (BK * sizeof(T));    // 1 (f32), 2 (bf16)
  static constexpr int kBytes = BM * BK * sizeof(T);
  __device__ static int at(int r, int k) {
    const int c = (k / kChunk) ^ (kFlip * ((r / kRowsPerLine) & 1));
    return r * BK + c * kChunk + k % kChunk;
  }
};

// A B slab: BK depths of BN columns of T, unpadded; the piece c of depth k is
// stored at c ^ 2 ((k / 4) % 4).  A lane reads four columns at depths 4 t +
// j, the four t of one wavefront on distinct banks.
template <typename T>
struct BSlab {
  static constexpr int kRows = BK, kCols = BN;
  static constexpr int kChunk = 16 / sizeof(T);
  static constexpr int kBytes = BK * BN * sizeof(T);
  __device__ static int at(int k, int n) {
    return k * BN + ((((n / kChunk) ^ (((k >> 2) & 3) << 1)) * kChunk) | (n % kChunk));
  }
};

// The shared memory of a product of A (TA) and B (TB) slabs.
template <typename TA, typename TB>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)NST * (ASlab<TA>::kBytes + BSlab<TB>::kBytes);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

// Start the copy of a slab: row r at src + r * stride (elements), its first
// `width` columns (a multiple of 16 bytes); rows at or past `live_rows` are
// zero.
template <class S, typename T>
__device__ __forceinline__ void copy_slab(T* dst, const T* src, long long stride, int live_rows,
                                          int width) {
  constexpr int E = S::kChunk, PR = S::kCols / E;   // elements a piece, pieces a row
  static_assert(S::kRows * PR % THREADS == 0, "a slab must split evenly over the block");
#pragma unroll
  for (int u = 0; u < S::kRows * PR / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS, r = i / PR, q = i % PR;
    if (q * E < width) {
      const bool live = r < live_rows;
      glom::cp_async16_zfill(dst + S::at(r, q * E), src + (live ? r * stride : 0) + q * E, live);
    }
  }
}

// acc = A B for the block's 64 x 128 output tile, summed over `depth` (a
// multiple of BK): A(m, k) = a[m * lda + k] (a at the tile's first row;
// rows at or past live_rows are zero), B(k, n) = b[k * ldb + n] (b at the
// tile's first column; nw of its BN columns exist, a multiple of 32; rows
// at or past live_depth are zero and never read, for a depth that ends off
// a slab, as K7's keys do).  The
// warp's share: rows 32 (warp % 2) + 16 mt + gid (+ 8), columns 32 (warp /
// 2) + 8 tig + [0, 8): acc[mt][nt] holds mma columns 2 tig and 2 tig + 1,
// which are the tile's columns 8 tig + nt and 8 tig + 4 + nt.
// EXACT_A / EXACT_B: that operand came from bf16 and skips its lo pass.
// The ring is idle when it returns, but other warps may still read its last
// slab: a second product in the same block needs a barrier first.
template <typename TA, typename TB, bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void tile_product(float (&acc)[2][4][4], const TA* __restrict__ a,
                                             long long lda, int live_rows,
                                             const TB* __restrict__ b, long long ldb, int nw,
                                             int depth, unsigned char* smem,
                                             int live_depth = 1 << 30) {
  using SA = ASlab<TA>;
  using SB = BSlab<TB>;
  constexpr int STAGE = SA::kBytes + SB::kBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);
  const bool live = wn < nw;   // warp-uniform
  const int steps = depth / BK;
  auto issue = [&](int s) {
    unsigned char* st = smem + (s % NST) * STAGE;
    copy_slab<SA>(reinterpret_cast<TA*>(st), a + s * BK, lda, live_rows, BK);
    copy_slab<SB>(reinterpret_cast<TB*>(st + SA::kBytes), b + (long long)s * BK * ldb, ldb,
                  live_depth - s * BK, nw);
    glom::cp_async_commit();
  };
  // the ring runs NST - 1 slabs ahead; a group is committed for every slab
  // index, empty past the last, so wait_group counts the same everywhere
  for (int s = 0; s < NST - 1; ++s) {
    if (s < steps) issue(s);
    else glom::cp_async_commit();
  }
  glom::zero_tiles(acc);

  for (int s = 0; s < steps; ++s) {
    glom::cp_async_wait_group<NST - 2>();
    __syncthreads();   // slab s has landed; every warp is done with slab s - 1
    if (s + NST - 1 < steps) issue(s + NST - 1);
    else glom::cp_async_commit();
    if (!live) continue;
    const unsigned char* st = smem + (s % NST) * STAGE;
    const TA* as = reinterpret_cast<const TA*>(st);
    const TB* bs = reinterpret_cast<const TB*>(st + SA::kBytes);
    // the slab's product, formed in t and added to acc with an f32 add
    float t[2][4][4];
    glom::zero_tiles(t);
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      // depths k0 + 4 tig + [0, 4) of the lane's four A rows
      float av[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 v = glom::ld4(as + SA::at(wm + 16 * mt + gid + 8 * half, k0 + 4 * tig));
          av[mt][half][0] = v.x, av[mt][half][1] = v.y, av[mt][half][2] = v.z, av[mt][half][3] = v.w;
        }
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        // mma depth tig and tig + 4 of this k8 step: depth k0 + 4 tig + 2 s2 and + 1
        const float4 b0 = glom::ld4(bs + SB::at(k0 + 4 * tig + 2 * s2, wn + 4 * gid));
        const float4 b1 = glom::ld4(bs + SB::at(k0 + 4 * tig + 2 * s2 + 1, wn + 4 * gid));
        const float bv[2][4] = {{b0.x, b0.y, b0.z, b0.w}, {b1.x, b1.y, b1.z, b1.w}};
        uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}
            const float v = av[mt][e & 1][2 * s2 + (e >> 1)];
            if constexpr (EXACT_A) ahi[mt][e] = __float_as_uint(v);
            else glom::split_tf32(v, ahi[mt][e], alo[mt][e]);
          }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (EXACT_B) bhi[nt][e] = __float_as_uint(bv[e][nt]);
            else glom::split_tf32(bv[e][nt], bhi[nt][e], blo[nt][e]);
          }
        // the small passes first, each issued over every tile in turn
        if constexpr (!EXACT_A) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) glom::mma_tf32(t[mt][nt], alo[mt], bhi[nt]);
        }
        if constexpr (!EXACT_B) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) glom::mma_tf32(t[mt][nt], ahi[mt], blo[nt]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) glom::mma_tf32(t[mt][nt], ahi[mt], bhi[nt]);
      }
    }
    glom::add_tiles(acc, t);
  }
  glom::cp_async_wait_all();
}

// The eight values of row q = 2 mt + half of the lane's share of acc:
// columns 8 tig + [0, 8) of the warp's 32.
__device__ __forceinline__ void row_of(const float (&acc)[2][4][4], int q, float (&v)[8]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    v[nt] = acc[q >> 1][nt][2 * (q & 1)];
    v[4 + nt] = acc[q >> 1][nt][2 * (q & 1) + 1];
  }
}

// The tile row of the lane's row q: rows 32 (warp % 2) + 16 (q / 2) + gid +
// 8 (q % 2).
__device__ __forceinline__ int row_in_tile(int q) {
  const int warp = threadIdx.x >> 5, gid = (threadIdx.x & 31) >> 2;
  return 32 * (warp & 1) + 16 * (q >> 1) + gid + 8 * (q & 1);
}

// The tile column of the lane's first value: 32 (warp / 2) + 8 tig.
__device__ __forceinline__ int col_in_tile() {
  return 32 * (threadIdx.x >> 6) + 8 * (threadIdx.x & 3);
}

// sum_z ws[z * stride + i .. + 4], the splits in a fixed order (z = 0, 1,
// ...), so two calls give the same bits.
__device__ __forceinline__ float4 sum_splits(const float* __restrict__ ws, long long stride,
                                             long long i, int splits) {
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(ws + z * stride + i);
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  return s;
}

// How many blocks should share an output tile's depth: the count that runs
// `tiles` tiles of `slabs` slabs on `slots` resident blocks in the fewest
// slab-times, where the split blocks fit one wave (at most slots / tiles
// splits; none when the tiles alone fill it), and at most max_splits.
inline int plan_splits(long long tiles, long long slots, int slabs, long long max_splits) {
  const long long fit = tiles < slots ? slots / tiles : 1;
  return glom::fewest_waves(tiles, slots, slabs, fit < max_splits ? fit : max_splits);
}

}  // namespace tile
}  // namespace glom
