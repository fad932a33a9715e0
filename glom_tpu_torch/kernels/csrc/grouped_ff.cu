// Grouped feed-forward forward (K1), written by hand for Hopper (sm_90a).
//
// Replaces: glom_tpu/kernels/ff_pallas.py::_forward (the TPU kernel body
// `_kernel`).  Per group g and row r of the flattened (b*n) axis:
//     out[r, g] = gelu(x[r, g] @ w1[g] + b1[g]) @ w2[g] + b2[g]
// with the exact-erf GELU, f32 or bf16 inputs and f32 accumulation.
//
// What bounds it: operations.  At the flagship shapes (d=512, h=2048, 2048
// rows and 6 groups a call at batch 8) a call does 4*d*h FLOPs a row and
// group, 51.5 GFLOP.  The products run on the tensor cores, mma.sync
// m16n8k8 with tf32 operands and f32 accumulators: an f32 operand is split
// into tf32 parts, v = hi + lo, and a product takes three passes, lo*hi +
// hi*lo + hi*hi (3xTF32), so an f32 call keeps f32 accuracy (0.31 ms at
// flagship at the tensor cores' peak); an operand that came from bf16 is
// exact in tf32 and skips its pass, so in bf16 x @ w1 takes one pass and
// hidden @ w2 two.  Around each mma the kernel spends fragment loads,
// splits, copies and barriers, which issue from the same schedulers.
//
// The TPU kernel keeps the hidden gelu(x w1 + b1) in VMEM.  Kept on chip
// here, a block would hold a 64 x d f32 x tile and a 64 x d f32 accumulator
// (182 KB of shared memory and 232 registers a thread at d=512): one block an
// SM, a barrier for every few rows of w2, operands split again for every
// hidden chunk, and the sum over h kept in the accumulator.  Measured on the
// H100, that loop took 1.27 ms at flagship f32 b=8 where a tiled product of
// the same mma count takes 0.88 (PERF.md, Findings).  So the forward is two
// tiled products through a hidden in device memory, which has room for it
// (100 MB f32 at flagship b=8, written once and read once: 0.06 ms of
// traffic):
//     K1a  hid = gelu(x w1 + b1), f32 (groups, rows, h), K2's hidden layout:
//          a product over d, with the bias and GELU in its epilogue;
//     K1b  out = hid w2 + b2, rounded once to x's type: a product over h.
// Both run on the tile machinery of K3 (grouped_ff_bwd.cu):
//  * a block owns a 64 x 128 output tile of one group (K1a: 3,072 tiles at
//    flagship b=8, K1b: 768) and walks the depth in slabs of 32;
//  * slabs of A (64 rows x 32 deep) and B (32 deep x 128 columns) stream
//    through a three-stage cp.async ring with one barrier a slab, two
//    copies in flight; every slab row is copied in 16-byte pieces by
//    unrolled loops and stored unpadded, its pieces XOR-permuted by the row
//    (a swizzle) so that fragment loads hit distinct banks;
//  * each of the 8 warps owns 32 x 32 of the tile (2 x 4 mma tiles).  A
//    (x or hid) is stored along the depth, so the mma's depth is permuted
//    the same way in A and B: mma depth t and t + 4 of k8 step s of a
//    16-deep piece are depth 4 t + 2 s and + 1, so one 16-byte shared load
//    gives a lane 4 depths of one A row; a column j of an n-tile nt is
//    column 4 j + nt, so one 16-byte load gives a lane one depth of B for
//    all four n-tiles.  Each split value serves two or four mma;
//  * each slab's product is formed in a zeroed fragment and added to the
//    tile's accumulator with an f32 add, so no long sum stays inside the
//    mma (tile_mma.cuh);
//  * shared memory 72 KB in f32, two blocks an SM;
//  * where K1b's output tiles leave the card part-empty (b=1: 96 tiles),
//    glom_grouped_ff_splits picks how many blocks share a tile's hidden
//    (K3's rule: only where the split blocks fit one wave); each writes its
//    partial sum to an f32 workspace and a second kernel adds them in a
//    fixed order with b2.  No atomics: two calls give the same bits.
//
// Layout: x is read through a row stride and a group stride (elements; the
// last dimension contiguous, every row on a 16-byte boundary), so the
// bottom-up input, a strided view of the (b, n, L+1, d) state, needs no
// copy.  w1 (g, d, h), b1 (g, h), w2 (g, h, d), b2 (g, d), out (rows, g, d)
// and the hidden are contiguous.  d must be a multiple of 128, at most 512;
// h a multiple of 64 (ragged against the 128-wide tile).

#include <type_traits>

#include "common.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps, 2 x 4 of 32 x 32
constexpr int BM = 64;         // rows of an output tile
constexpr int BN = 128;        // columns of an output tile
constexpr int BK = 32;         // depth of a slab
constexpr int NST = 3;         // stages of the ring
constexpr int H_ALIGN = 64;    // h must be a multiple
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
constexpr size_t smem_bytes() {
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
// tile's first column; nw of its BN columns exist, a multiple of 32).  The
// warp's share: rows 32 (warp % 2) + 16 mt + gid (+ 8), columns 32 (warp /
// 2) + 8 tig + [0, 8): acc[mt][nt] holds mma columns 2 tig and 2 tig + 1,
// which are the tile's columns 8 tig + nt and 8 tig + 4 + nt.
// EXACT_A / EXACT_B: that operand came from bf16 and skips its lo pass.
template <typename TA, typename TB, bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void tile_product(float (&acc)[2][4][4], const TA* __restrict__ a,
                                             long long lda, int live_rows,
                                             const TB* __restrict__ b, long long ldb, int nw,
                                             int depth, unsigned char* smem) {
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
    copy_slab<SB>(reinterpret_cast<TB*>(st + SA::kBytes), b + (long long)s * BK * ldb, ldb, BK, nw);
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

// K1a.  Grid (row tiles x hidden tiles, groups): hid[g][row0 :, n0 :] =
// gelu(x[row0 :, g] w1[g][:, n0 :] + b1[g][n0 :]), f32.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ff_hidden_kernel(const T* __restrict__ x, long long row_stride, long long group_stride,
                 const T* __restrict__ w1, const T* __restrict__ b1, float* __restrict__ hid,
                 int rows, int dim, int hidden) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int g = blockIdx.y, per_row = (hidden + BN - 1) / BN;
  const int row0 = blockIdx.x / per_row * BM, n0 = blockIdx.x % per_row * BN;
  const int nw = min(BN, hidden - n0);
  float acc[2][4][4];
  tile_product<T, T, kExact, kExact>(acc, x + g * group_stride + row0 * row_stride, row_stride,
                                     rows - row0, w1 + (long long)g * dim * hidden + n0, hidden,
                                     nw, dim, reinterpret_cast<unsigned char*>(smem4));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int wm = 32 * (warp & 1), col = 32 * (warp >> 1) + 8 * tig;
  if (col >= nw) return;
  float bias[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bias[i] = glom::to_f32(b1[(long long)g * hidden + n0 + col + i]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + wm + 16 * (q >> 1) + gid + 8 * (q & 1);
    if (row >= rows) continue;
    float v[8];
    row_of(acc, q, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu(v[i] + bias[i]);
    glom::store8(hid + ((long long)g * rows + row) * hidden + n0 + col, v);
  }
}

// K1b.  Grid (row tiles x d tiles, groups, splits): split z sums hidden
// slabs [z * per_split, (z + 1) * per_split).  With ws null the block
// writes out[row0 :, g, n0 :] = hid[g][row0 :] w2[g][:, n0 :] + b2[g][n0 :]
// in T; otherwise its partial sum goes to ws[z] (rows, groups, dim), f32.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ff_out_kernel(const float* __restrict__ hid, const T* __restrict__ w2, const T* __restrict__ b2,
              T* __restrict__ out, float* __restrict__ ws, int rows, int groups, int dim,
              int hidden, int per_split) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int g = blockIdx.y, per_row = dim / BN;
  const int row0 = blockIdx.x / per_row * BM, n0 = blockIdx.x % per_row * BN;
  const int k0 = blockIdx.z * per_split * BK, depth = min(per_split * BK, hidden - k0);
  float acc[2][4][4];
  tile_product<float, T, false, kExact>(acc, hid + ((long long)g * rows + row0) * hidden + k0,
                                        hidden, rows - row0,
                                        w2 + ((long long)g * hidden + k0) * dim + n0, dim, BN,
                                        depth, reinterpret_cast<unsigned char*>(smem4));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int wm = 32 * (warp & 1), col = n0 + 32 * (warp >> 1) + 8 * tig;
  float bias[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bias[i] = ws == nullptr ? glom::to_f32(b2[g * dim + col + i]) : 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + wm + 16 * (q >> 1) + gid + 8 * (q & 1);
    if (row >= rows) continue;
    float v[8];
    row_of(acc, q, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += bias[i];
    const long long o = ((long long)row * groups + g) * dim + col;
    if (ws == nullptr) glom::store8(out + o, v);
    else glom::store8(ws + (long long)blockIdx.z * rows * groups * dim + o, v);
  }
}

// out[i] = sum_z ws[z][i] + b2[g(i)], four elements a thread; D % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_splits_kernel(const float* __restrict__ ws, const T* __restrict__ b2, T* __restrict__ out,
                     long long total, int groups, int dim, int splits) {
  const long long i = 4 * ((long long)blockIdx.x * REDUCE_THREADS + threadIdx.x);
  if (i >= total) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(ws + (long long)z * total + i);
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  const int col = static_cast<int>(i % dim);
  const T* bias = b2 + static_cast<int>((i / dim) % groups) * dim + col;
  glom::store2(out + i, s.x + glom::to_f32(bias[0]), s.y + glom::to_f32(bias[1]));
  glom::store2(out + i + 2, s.z + glom::to_f32(bias[2]), s.w + glom::to_f32(bias[3]));
}

template <typename T>
cudaError_t launch(const T* x, long long row_stride, long long group_stride, const T* w1,
                   const T* b1, const T* w2, const T* b2, T* out, float* ws, float* hid, int rows,
                   int groups, int dim, int hidden, int splits, cudaStream_t stream) {
  const size_t smem1 = smem_bytes<T, T>(), smem2 = smem_bytes<float, T>();
  cudaError_t err = glom::allow_smem(ff_hidden_kernel<T>, smem1);
  if (err == cudaSuccess) err = glom::allow_smem(ff_out_kernel<T>, smem2);
  if (err != cudaSuccess) return err;
  const int row_tiles = (rows + BM - 1) / BM;
  const dim3 grid1(row_tiles * ((hidden + BN - 1) / BN), groups);
  ff_hidden_kernel<T><<<grid1, THREADS, smem1, stream>>>(x, row_stride, group_stride, w1, b1, hid,
                                                        rows, dim, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slabs = hidden / BK;
  const int per_split = (slabs + splits - 1) / splits;
  splits = (slabs + per_split - 1) / per_split;   // no empty split
  float* partial = splits > 1 ? ws : nullptr;
  const dim3 grid2(row_tiles * (dim / BN), groups, splits);
  ff_out_kernel<T><<<grid2, THREADS, smem2, stream>>>(hid, w2, b2, out, partial, rows, groups, dim,
                                                     hidden, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const long long total = (long long)rows * groups * dim;
  const long long blocks = (total / 4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  reduce_splits_kernel<T><<<static_cast<unsigned>(blocks), REDUCE_THREADS, 0, stream>>>(
      partial, b2, out, total, groups, dim, splits);
  return cudaGetLastError();
}

// How many blocks of K1b for T an SM runs at once, as built.
template <typename T>
int blocks_per_sm() {
  const size_t smem = smem_bytes<float, T>();
  if (glom::allow_smem(ff_out_kernel<T>, smem) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ff_out_kernel<T>, THREADS, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

bool valid(int rows, int groups, int dim, int hidden) {
  return dim % 128 == 0 && dim >= 128 && dim <= 512 && hidden % H_ALIGN == 0 && hidden >= H_ALIGN &&
         rows >= 1 && groups >= 1 && groups <= 65535;
}

}  // namespace

// How many blocks should share an output tile's hidden in K1b: the count
// that runs the call's (tile, split) blocks on the current device's SMs in
// the fewest slab-times (waves x slabs a block), where the split blocks fit
// one wave (K3's rule); K1b's tiles at the flagship's b=8 are many (768), so
// it splits only at small batches.  With more than one, the caller passes
// an f32 workspace of splits * rows * groups * dim.  -1 on bad arguments or
// a CUDA error.
extern "C" int glom_grouped_ff_splits(int rows, int groups, int dim, int hidden, int dtype) {
  if (!valid(rows, groups, dim, hidden)) return -1;
  const long long slots = glom::block_slots(dtype == glom::kF32 ? blocks_per_sm<float>()
                                            : dtype == glom::kBF16 ? blocks_per_sm<__nv_bfloat16>()
                                                                   : -1);
  if (slots < 1) return -1;
  const long long tiles = (long long)((rows + BM - 1) / BM) * (dim / BN) * groups;
  return glom::fewest_waves(tiles, slots, hidden / BK, tiles < slots ? slots / tiles : 1);
}

// x: (rows, groups, dim) read through row_stride / group_stride (elements),
// every row on a 16-byte boundary; w1 (groups, dim, hidden), b1 (groups,
// hidden), w2 (groups, hidden, dim), b2 (groups, dim), out (rows, groups,
// dim): contiguous, all of one dtype.  hid: the hidden, f32 (groups, rows,
// hidden), which K1a fills and K1b reads.  ws: with splits > 1, an f32
// workspace of splits * rows * groups * dim; unused with one split.  x, w1,
// w2, out, hid and ws 16-byte aligned.  Returns the launches' cudaError_t.
extern "C" int glom_grouped_ff(const void* x, long long row_stride, long long group_stride,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, void* ws, void* hid, int rows,
                               int groups, int dim, int hidden, int splits, int dtype,
                               void* stream) {
  const long long item = dtype == glom::kF32 ? 4 : 2;
  if (!valid(rows, groups, dim, hidden) || splits < 1 || (splits > 1 && ws == nullptr) ||
      (dtype != glom::kF32 && dtype != glom::kBF16) || hid == nullptr || !glom::aligned16(x) ||
      (row_stride * item) % 16 != 0 || (group_stride * item) % 16 != 0 || !glom::aligned16(w1) ||
      !glom::aligned16(w2) || !glom::aligned16(out) || !glom::aligned16(hid) ||
      !glom::aligned16(ws))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return launch<float>(static_cast<const float*>(x), row_stride, group_stride,
                         static_cast<const float*>(w1), static_cast<const float*>(b1),
                         static_cast<const float*>(w2), static_cast<const float*>(b2),
                         static_cast<float*>(out), static_cast<float*>(ws),
                         static_cast<float*>(hid), rows, groups, dim, hidden, splits, s);
  using B = __nv_bfloat16;
  return launch<B>(static_cast<const B*>(x), row_stride, group_stride, static_cast<const B*>(w1),
                   static_cast<const B*>(b1), static_cast<const B*>(w2), static_cast<const B*>(b2),
                   static_cast<B*>(out), static_cast<float*>(ws), static_cast<float*>(hid), rows,
                   groups, dim, hidden, splits, s);
}
