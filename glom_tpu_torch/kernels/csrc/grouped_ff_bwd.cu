// Grouped feed-forward backward, written by hand for Hopper (sm_90a): two
// kernels, dX and dW, the backward of grouped_ff.cu.
//
// Replaces: glom_tpu/kernels/ff_pallas.py::_backward_fused, its two TPU
// kernels _bwd_dx_kernel (K2) and _bwd_dw_kernel (K3), which share
// _recompute_dh.  Per group g, with pre = X W1 + b1 over a tile of rows:
//     H   = gelu(pre),  dH = (dO W2^T) * gelu'(pre)
//     dX  = dH W1^T                           (K2: summed over the hidden)
//     dW1 = X^T dH,  db1 = 1^T dH,  dW2 = H^T dO
//                                             (K3: summed over every row)
// with the exact-erf GELU, gelu(z) = z Phi(z), gelu'(z) = Phi(z) + z phi(z).
// x, dO and the weights are f32 or bf16 (all one type); accumulation is
// f32; dX and dW are written in that type.  db2 = sum of dO is a plain
// reduction in the wrapper, as it is in the TPU version.
//
// The TPU kernels both recompute pre and dO W2^T, to stay inside VMEM.  On
// the H100 K2 forms H and dH anyway, in f32 registers, for every (row,
// hidden) pair, and device memory has room for them: so K2 stores them (the
// "hidden", two f32 (groups, rows, h) arrays, 201 MB at the flagship b=8)
// and K3, launched right after it, reduces them over the rows with x and dO
// and recomputes nothing.  The wrapper frees the hidden when the backward
// call returns.
//
// What bounds them: operations.  At the flagship shapes (d=512, h=2048,
// 2048 rows, 6 groups) dX does 6*d*h FLOPs a row and group (pre, dO W2^T,
// dH W1^T) and dW 4 (X^T dH, H^T dO): 77 and 52 GFLOP.  Both kernels run
// their products on the tensor cores, mma.sync m16n8k8 with tf32 operands
// and f32 accumulators: an f32 operand is split into tf32 parts, v = hi +
// lo, and a product takes three passes, lo*hi + hi*lo + hi*hi (3xTF32), so
// an f32 call keeps f32 accuracy; an operand that came from bf16 is exact in
// tf32 and skips its pass.  A kernel is then bound by the tensor cores' rate
// at three passes (0.47 ms for dX, 0.31 ms for dW at flagship) and by the
// instructions around each mma, fragment loads and splits, which issue from
// the same schedulers.
//
// K2 (dX).  Its previous design walked the hidden in chunks of 16 with four
// barriers and synchronous weight loads a chunk, one 16 x 8 tile a warp for
// the recompute (a split A and B fragment for three mma), and every warp
// split the same dH values again: 2.6 ms at flagship.  Measured on the H100
// by removing parts of the kernel one at a time (PERF.md, Findings), a
// block's time is nearly the SUM of its mma, its weight copies, its splits
// and its shared-memory fragment reads: with one block an SM and a barrier
// a slab they do not overlap, and more warps or a deeper ring did not make
// them.  So the design spends fewer of each per mma:
//  * a block owns 32 rows of one group (x and dO tiles f32 in shared
//    memory, loaded once) and walks the hidden in chunks of 256;
//  * phase 1 of a chunk streams w1[k slab, chunk] and w2[chunk, k slab],
//    16 rows of d a slab, through a two-stage cp.async ring with one
//    barrier a slab.  Each warp owns all 32 rows x 32 hidden columns for
//    pre AND dO W2^T (2 x 4 tiles: a split A fragment serves four n-tiles,
//    a split B fragment two m-tiles: 48 mma for 32 split values and 4 KB
//    of fragment reads).  A slab's three passes go to a zeroed fragment,
//    added to the tile's accumulator with an f32 add: the tensor cores'
//    accumulation rounds toward zero, and kept over d's 192 mma it shrank
//    H and dH by 4e-6 of their size, which K3's sums over 2048 rows turned
//    into errors of 4.4e-4 on small dW2 entries (PERF.md, Findings);
//  * dH = (dO W2^T) * gelu'(pre + b1) forms in the registers of the warp
//    that computed both and goes to shared memory in f32; for K3, H and dH
//    also go to device memory from those registers, every element once;
//  * phase 2 streams w1[:, j slab], 16 hidden units a slab, through the same
//    ring; each warp splits dH's fragments for its k-steps and adds dH w1^T
//    into its 32 rows x d/8 columns of a (32, d) f32 accumulator held in
//    registers (2 x d/64 tiles: a split B fragment serves two m-tiles).
//    Each slab's product is formed in a zeroed fragment and added with an
//    f32 add (tile_mma.cuh: the tensor cores' own accumulation rounds
//    toward zero);
//  * every slab row is 64 or 512 bytes of one weight row, copied by fully
//    unrolled loops of 16-byte cp.async, and stored unpadded with its
//    16-byte chunks XOR-permuted by row (a swizzle) so that fragment loads
//    hit distinct banks; fragments come by ldmatrix wherever the operand
//    is stored along the depth (x, dO, dH, w2, phase 2's w1);
//  * shared memory: x and dO 2 x 32 x (d+4) f32 (132 KB at d=512; 64 rows
//    would need 264 KB, more than a block may have), dH 32 x 260 f32
//    (33 KB) and two 32 KB ring stages: 230,912 bytes at d=512, one block
//    an SM;
//  * one block an SM makes a call's time whole waves of blocks: 320 row
//    tiles (g=5 at b=8) take three waves like 384, and 48 (b=1) leave most
//    SMs idle.  So glom_grouped_ff_bwd_dx_splits picks how many blocks share
//    a tile's chunks (the fewest waves x chunks a block, K1's rule): with
//    more than one, each writes its partial sum to an f32 workspace and a
//    second kernel adds the partials in a fixed order.  Every sum stays in
//    a fixed order, no atomics: two calls give the same bits.
// K3 (dW).  Its previous design owned 32 hidden units of one group a block,
// kept w1[:, 32] and w2[32, :] resident (128 KB in f32), and recomputed pre
// and dO W2^T for every row tile of 16: half its operations, four barriers
// and synchronous loads a tile, and no room left for a ring (2.85 ms at
// flagship).  Now it reads the hidden K2 stored, so it is two grouped
// products reduced over rows, C[m, n] = sum_r A[r, m] B[r, n]:
//     dW1[g] (d x h):  A = x[:, g, :],  B = dH[g]   (and db1 = 1^T dH)
//     dW2[g] (h x d):  A = H[g],        B = dO[:, g, :]
//  * a block owns a 64 x 128 output tile of one of them (both products
//    share one launch and one grid: blockIdx.x picks the product and the
//    tile, y the group) and walks the rows in slabs of 32;
//  * slabs of A (32 x 64) and B (32 x 128) stream through a three-stage
//    cp.async ring with one barrier a slab; every slab row is 256 or 512
//    bytes of one source row, copied in 16-byte pieces by unrolled loops and
//    stored unpadded, its 16-byte chunks XOR-permuted by the row (a
//    swizzle), so fragment loads hit distinct banks;
//  * each of the 8 warps owns 32 x 32 of the tile (2 x 4 mma tiles).  The
//    rows of an mma tile are mapped to output rows m = 4 gid + 2 mt + half,
//    its columns to n = 4 j + nt, so one 16-byte shared load gives a lane
//    its A values of both m-tiles and another its B values of all four
//    n-tiles: 4 loads and 16 splits for 24 mma a k-step in f32, each split
//    value serving two or four tiles;
//  * each slab's product is formed in a zeroed fragment and added with an
//    f32 add (tile_mma.cuh: the tensor cores' own accumulation rounds
//    toward zero over 2048 rows);
//  * db1 = 1^T dH is summed from the B values the warps of the dW1 tiles of
//    the first d-tile already load, then across the four lanes of a column
//    in a fixed order;
//  * shared memory 72 KB in f32, two blocks an SM;
//  * where the output tiles are too few to fill the card (few groups,
//    narrow widths), glom_grouped_ff_bwd_dw_splits picks how many blocks
//    share a tile's rows (K2's rule, the blocks in one wave); each writes
//    its partial sums to an f32 workspace and a second kernel adds them in
//    a fixed order.  Every sum stays in a fixed order, no atomics: two
//    calls give the same bits.
//
// Layout: x is read through a row stride and a group stride (elements; the
// last dimension contiguous), so the bottom-up input, a strided view of the
// (b, n, L+1, d) state, needs no copy.  dO, w1 (g, d, h), b1 (g, h),
// w2 (g, h, d), the hidden (g, rows, h) and the outputs are contiguous; K2
// copies w1 and w2 with cp.async, and K3 x, dO and the hidden, so those
// start (and x's rows lie) on a 16-byte boundary.  d must be a multiple of
// 128, at most 512; h a multiple of 32.

#include <type_traits>

#include "common.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;   // the second, elementwise kernels
constexpr int WARPS2 = 8;
constexpr int THREADS2 = 32 * WARPS2;
constexpr int NST = 2;         // stages of K2's weight ring (two 32 KB slabs)
constexpr int BM2 = 32;        // dX: rows per block
constexpr int HC2 = 256;       // dX: hidden units per chunk
constexpr int KS2 = 16;        // dX, phase 1: rows of d per weight slab
constexpr int JS2 = 16;        // dX, phase 2: hidden units per weight slab
constexpr int THREADS3 = 256;  // dW: 8 warps, 2 x 4 of 32 x 32
constexpr int BM3 = 64;        // dW: output rows per block
constexpr int BN3 = 128;       // dW: output columns per block
constexpr int BK3 = 32;        // dW: data rows per slab
constexpr int NST3 = 3;        // stages of K3's ring
constexpr int H_ALIGN = 32;    // h must be a multiple

// K2's shared memory.  The weight slabs are stored without padding in f32,
// their 16-byte chunks permuted by an XOR of the row (a "swizzle") so that
// every fragment load of a warp still hits distinct banks and two 32 KB
// stages fit beside the x, dO and dH tiles.  bf16 slabs are padded instead
// (their loads are scalar).  Offsets are in elements of T.
template <typename T, int D>
struct DxLayout {
  static constexpr bool kSwizzle = std::is_same<T, float>::value;
  static constexpr int kRow = D + 4;     // x and dO tiles (BM2, D), f32
  static constexpr int kH = HC2 + 4;     // dH (BM2, HC2), f32
  static constexpr int kW1P = kSwizzle ? HC2 : HC2 + 8;   // phase 1: w1[k slab, chunk]  (KS2, HC2)
  static constexpr int kW2P = kSwizzle ? KS2 : KS2 + 8;   // phase 1: w2[chunk, k slab]  (HC2, KS2)
  static constexpr int kW1Q = kSwizzle ? JS2 : JS2 + 8;   // phase 2: w1[:, j slab]      (D, JS2)
  static constexpr int kStage1 = KS2 * kW1P + HC2 * kW2P;
  static constexpr int kStage2 = D * kW1Q;
  static constexpr int kStage = kStage1 > kStage2 ? kStage1 : kStage2;
  static constexpr size_t kBytes =
      sizeof(float) * (2 * BM2 * kRow + BM2 * kH) + sizeof(T) * NST * kStage;

  // element (k, n) of phase 1's w1 part: rows k + 0..3 XOR the column's
  // 8-groups, so the four rows a B fragment reads land in distinct banks
  __device__ static int w1p(int k, int n) { return k * kW1P + (kSwizzle ? n ^ ((k & 3) << 3) : n); }
  // element (n, k) of phase 1's w2 part (rows of 4 chunks of 4): chunk
  // k / 4 of row n XOR (n / 2) % 4
  __device__ static int w2p(int n, int k) {
    return n * kW2P + (kSwizzle ? ((((k >> 2) ^ ((n >> 1) & 3)) << 2) | (k & 3)) : k);
  }
  // element (n, j) of phase 2's w1 slab (rows of 4 chunks of 4): chunk j / 4
  // of row n XOR (n / 2) % 4
  __device__ static int w1q(int n, int j) {
    return n * kW1Q + (kSwizzle ? ((((j >> 2) ^ ((n >> 1) & 3)) << 2) | (j & 3)) : j);
  }
};

// K3's slab of one operand: BK3 rows of W elements of T, unpadded, the
// 16-byte chunk c of row r stored at chunk c ^ 2 (r % 4).  A lane reads four
// consecutive elements (16 bytes of f32, 8 of bf16) from rows r .. r + 3 at
// the same column: with the XOR the 8 (f32) or 16 (bf16) lanes of one
// shared-memory wavefront hit distinct banks.
template <typename T, int W>
struct DwSlab {
  static constexpr int kChunk = 16 / sizeof(T);   // elements a 16-byte chunk
  static constexpr int kBytes = BK3 * W * sizeof(T);
  __device__ static int at(int r, int e) {
    return r * W + ((((e / kChunk) ^ ((r & 3) << 1)) * kChunk) | (e % kChunk));
  }
};

// K3's ring stage: the A slab, then the B slab, for either product.
template <typename T>
struct DwLayout {
  static constexpr int kA1 = DwSlab<T, BM3>::kBytes + DwSlab<float, BN3>::kBytes;   // dW1
  static constexpr int kA2 = DwSlab<float, BM3>::kBytes + DwSlab<T, BN3>::kBytes;   // dW2
  static constexpr int kStage = kA1 > kA2 ? kA1 : kA2;
  static constexpr size_t kBytes = (size_t)NST3 * kStage;
};

__device__ __forceinline__ void gelu_and_grad(float z, float& g, float& dg) {
  const float cdf = 0.5f * (1.0f + erff(z * 0.70710678118654752440f));
  const float pdf = expf(-0.5f * z * z) * 0.39894228040143267794f;   // 1/sqrt(2 pi)
  g = z * cdf;
  dg = cdf + z * pdf;
}

// Fragment loads from shared memory by ldmatrix (common.cuh): on 32-bit
// data each of the four 8 x 8 b16 matrices is 8 rows of 4 floats, and lane
// l receives element (l / 4, l % 4) of each.
//
// The A fragment (rows [r0, r0 + 16), depth [k, k + 8)) of a row-major f32
// tile: {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}.  Rows 16-byte aligned.
__device__ __forceinline__ void ldm_a(uint32_t (&r)[4], const float* tile, int stride, int r0,
                                      int k) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  glom::ldmatrix_x4(r, tile + (r0 + (lane & 7) + (m & 1) * 8) * stride + k + (m >> 1) * 4);
}

// The B fragments of two n8 tiles (columns [n0, n0 + 16), depth [k, k + 8))
// of an operand stored n-major, B(k, n) = tile[addr(n, k)], each 4-element
// chunk of a row contiguous and 16-byte aligned: {b0, b1} of the first tile
// in r[0], r[1], of the second in r[2], r[3].
template <class Addr>
__device__ __forceinline__ void ldm_b2(uint32_t (&r)[4], const float* tile, Addr addr, int n0,
                                       int k) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  glom::ldmatrix_x4(r, tile + addr(n0 + (lane & 7) + (m >> 1) * 8, k + (m & 1) * 4));
}

// K2's weight stream.  For each hidden chunk of HC2 units from the block's
// first chunk cb (the hidden's last chunk may be shorter, a multiple of
// 32): D / KS2 phase-1 slabs, w1[k0 : k0+KS2, chunk] and w2[chunk, k0 :
// k0+KS2], then chunk / JS2 phase-2 slabs, w1[:, j0 : j0+JS2].  Step s of the
// stream: its chunk start c0, width hc and index j within the chunk.
template <int D>
__device__ __forceinline__ void dx_step(int s, int cb, int hidden, int& c0, int& hc, int& j) {
  constexpr int SPC = D / KS2 + HC2 / JS2;
  const int c = min(cb + s / SPC, hidden / HC2);
  c0 = c * HC2;
  j = s - (c - cb) * SPC;
  hc = min(HC2, hidden - c0);
}

// Start the copy of step s's slab into its ring stage.
template <typename T, int D>
__device__ __forceinline__ void dx_issue(int s, int cb, T* ring, const T* w1g, const T* w2g,
                                         int hidden, int tid) {
  using S = DxLayout<T, D>;
  constexpr int N1 = D / KS2;
  constexpr int E = 16 / sizeof(T);   // elements a 16-byte copy moves
  int c0, hc, j;
  dx_step<D>(s, cb, hidden, c0, hc, j);
  T* dst = ring + (s % NST) * S::kStage;
  if (j < N1) {
    const int k0 = j * KS2;
    constexpr int PR1 = HC2 / E, PR2 = KS2 / E;   // 16-byte pieces a row
#pragma unroll
    for (int u = 0; u < (KS2 * PR1 + THREADS2 - 1) / THREADS2; ++u) {
      const int i = tid + u * THREADS2, r = i / PR1, q = i % PR1;
      if (i < KS2 * PR1 && q * E < hc)
        glom::cp_async16(dst + S::w1p(r, q * E), w1g + (long long)(k0 + r) * hidden + c0 + q * E);
    }
    T* dst2 = dst + KS2 * S::kW1P;
#pragma unroll
    for (int u = 0; u < (HC2 * PR2 + THREADS2 - 1) / THREADS2; ++u) {
      const int i = tid + u * THREADS2, r = i / PR2, q = i % PR2;
      if (i < HC2 * PR2 && r < hc)
        glom::cp_async16(dst2 + S::w2p(r, q * E), w2g + (long long)(c0 + r) * D + k0 + q * E);
    }
  } else {
    const int j0 = c0 + (j - N1) * JS2;
    constexpr int PR = JS2 / E;
#pragma unroll
    for (int u = 0; u < (D * PR + THREADS2 - 1) / THREADS2; ++u) {
      const int i = tid + u * THREADS2, r = i / PR, q = i % PR;
      if (i < D * PR)
        glom::cp_async16(dst + S::w1q(r, q * E), w1g + (long long)r * hidden + j0 + q * E);
    }
  }
  glom::cp_async_commit();
}

// The A fragments of MT m-tiles (rows r0 + 16 mt) at depth k: split into hi
// and lo for f32, hi alone (exact) for values that came from bf16.
template <bool F32, int MT>
__device__ __forceinline__ void a_frags(uint32_t (&hi)[MT][4], uint32_t (&lo)[MT][4],
                                        const float* tile, int stride, int r0, int k) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t raw[4];
    ldm_a(raw, tile, stride, r0 + 16 * mt, k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (F32) glom::split_tf32(__uint_as_float(raw[e]), hi[mt][e], lo[mt][e]);
      else hi[mt][e] = raw[e];
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_tiles(float (&t)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[mt][nt][e] = 0.f;
}

// acc += t, tile by tile, with f32 adds (which round to nearest).
template <int MT, int NT>
__device__ __forceinline__ void add_tiles(float (&acc)[MT][NT][4], const float (&t)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[mt][nt][e];
}

// acc_hi[mt][nt] += a_hi b_hi, acc_lo[mt][nt] += a_lo b_hi + a_hi b_lo (the
// lo passes only for f32), each pass issued over every tile in turn.
template <bool F32, int MT, int NT>
__device__ __forceinline__ void mma3(float (&acc_hi)[MT][NT][4], float (&acc_lo)[MT][NT][4],
                                     const uint32_t (&ahi)[MT][4], const uint32_t (&alo)[MT][4],
                                     const uint32_t (&bhi)[NT][2], const uint32_t (&blo)[NT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) glom::mma_tf32(acc_hi[mt][nt], ahi[mt], bhi[nt]);
  if constexpr (F32) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) glom::mma_tf32(acc_lo[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) glom::mma_tf32(acc_lo[mt][nt], ahi[mt], blo[nt]);
  }
}

// Grid (row tiles, groups, splits).  Split z covers hidden chunks
// [z * per_split, min((z + 1) * per_split, chunks)).  With ws null the block
// writes dx; otherwise its partial sum goes to ws[z] (rows, groups, D), f32.
// With hid non-null the block also stores H and dH of its rows and chunks
// into hid and dh (groups, rows, hidden), f32: every element once.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS2, 1)
ff_bwd_dx_kernel(const T* __restrict__ x, long long row_stride, long long group_stride,
                 const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ go, T* __restrict__ dx, float* __restrict__ ws,
                 float* __restrict__ hid, float* __restrict__ dhg, int rows, int groups,
                 int hidden, int per_split) {
  using S = DxLayout<T, D>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int N1 = D / KS2, SPC = N1 + HC2 / JS2;
  // phase 1: each warp owns all 32 rows (MT1 m-tiles) x 32 of the chunk's
  // 256 hidden units (NT1 n-tiles)
  constexpr int MT1 = 2, NT1 = 4;
  // phase 2: each warp owns all 32 rows x D / 8 columns of dX (NT2 n-tiles,
  // an even count)
  constexpr int NT2 = D / 64;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [BM2][kRow]  x tile
  float* gs = xs + BM2 * S::kRow;                // [BM2][kRow]  dO tile
  float* dhs = gs + BM2 * S::kRow;               // [BM2][kH]    dH of the chunk
  T* ring = reinterpret_cast<T*>(dhs + BM2 * S::kH);   // NST stages of weight slabs

  const int g = blockIdx.y, row0 = blockIdx.x * BM2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const T* w1g = w1 + (long long)g * D * hidden;
  const T* w2g = w2 + (long long)g * hidden * D;
  const T* b1g = b1 + (long long)g * hidden;
  const int full = hidden / HC2, chunks = (hidden + HC2 - 1) / HC2;
  const int cb = blockIdx.z * per_split, ce = min(cb + per_split, chunks);
  const int steps = (min(ce, full) - cb) * SPC + (ce > full ? N1 + (hidden - full * HC2) / JS2 : 0);

  // the ring runs NST - 1 slabs ahead: a group is committed for every slab
  // index, empty past the last, so wait_group counts the same everywhere
  for (int s = 0; s < NST - 1; ++s) {
    if (s < steps) dx_issue<T, D>(s, cb, ring, w1g, w2g, hidden, tid);
    else glom::cp_async_commit();
  }
  glom::load_tile<BM2, D, THREADS2>(xs, S::kRow, x + g * group_stride, row_stride, row0, rows);
  glom::load_tile<BM2, D, THREADS2>(gs, S::kRow, go + (long long)g * D, (long long)groups * D,
                                    row0, rows);

  const int n1 = warp * 8 * NT1, n2 = warp * (D / WARPS2);
  float acc[2][NT2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // pre and dO W2^T: the three passes go to one accumulator each
  float pa[MT1][NT1][4], ga[MT1][NT1][4];

  for (int s = 0; s < steps; ++s) {
    glom::cp_async_wait_group<NST - 2>();
    __syncthreads();   // slab s has landed; every warp is done with slab s-1 (and dH is stored)
    if (s + NST - 1 < steps) dx_issue<T, D>(s + NST - 1, cb, ring, w1g, w2g, hidden, tid);
    else glom::cp_async_commit();
    int c0, hc, j;
    dx_step<D>(s, cb, hidden, c0, hc, j);
    const T* wsl = ring + (s % NST) * S::kStage;
    const float* wslf = reinterpret_cast<const float*>(wsl);   // f32 only
    if (j < N1) {
      if (j == 0) {
        zero_tiles(pa);
        zero_tiles(ga);
      }
      if (n1 < hc) {   // warp-uniform: a short last chunk leaves some warps idle here
        const T* w1sl = wsl;                    // B(k, n) = w1sl[w1p(k, n)]
        const T* w2sl = wsl + KS2 * S::kW1P;    // B(k, n) = w2sl[w2p(n, k)]
        // the slab's part of pre and of dO W2^T, each formed in the zeroed
        // fragment t and added with an f32 add: the tensor cores'
        // accumulation rounds toward zero, which over the 192 mma of d = 512
        // would bias H and dH by about 4e-6 of their size (and K3 sums them
        // over every row)
        float t[MT1][NT1][4];
        zero_tiles(t);
#pragma unroll
        for (int kk = 0; kk < KS2; kk += 8) {   // pre += x W1
          const int k = j * KS2 + kk;
          uint32_t ahi[MT1][4], alo[MT1][4], bhi[NT1][2], blo[NT1][2];
          a_frags<kF32, MT1>(ahi, alo, xs, S::kRow, 0, k);
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt) {
            const int n = n1 + nt * 8 + gid;
            const float bv[2] = {glom::to_f32(w1sl[S::w1p(kk + tig, n)]),
                                 glom::to_f32(w1sl[S::w1p(kk + tig + 4, n)])};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if constexpr (kF32) glom::split_tf32(bv[e], bhi[nt][e], blo[nt][e]);
              else bhi[nt][e] = __float_as_uint(bv[e]);
            }
          }
          mma3<kF32>(t, t, ahi, alo, bhi, blo);
        }
        add_tiles(pa, t);
        zero_tiles(t);
#pragma unroll
        for (int kk = 0; kk < KS2; kk += 8) {   // dO W2^T
          const int k = j * KS2 + kk;
          uint32_t ahi[MT1][4], alo[MT1][4], bhi[NT1][2], blo[NT1][2];
          a_frags<kF32, MT1>(ahi, alo, gs, S::kRow, 0, k);
          if constexpr (kF32) {
#pragma unroll
            for (int p = 0; p < NT1 / 2; ++p) {
              uint32_t braw[4];
              ldm_b2(braw, reinterpret_cast<const float*>(w2sl),
                     [](int n, int k) { return S::w2p(n, k); }, n1 + 16 * p, kk);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                glom::split_tf32(__uint_as_float(braw[e]), bhi[2 * p + (e >> 1)][e & 1],
                          blo[2 * p + (e >> 1)][e & 1]);
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < NT1; ++nt) {
              const int n = n1 + nt * 8 + gid;
              bhi[nt][0] = __float_as_uint(glom::to_f32(w2sl[S::w2p(n, kk + tig)]));
              bhi[nt][1] = __float_as_uint(glom::to_f32(w2sl[S::w2p(n, kk + tig + 4)]));
            }
          }
          mma3<kF32>(t, t, ahi, alo, bhi, blo);
        }
        add_tiles(ga, t);
        if (j == N1 - 1) {
          // dH = (dO W2^T) * gelu'(pre + b1) into shared memory for phase 2
          // (the next step's __syncthreads publishes it), and with hid, H
          // and dH of the live rows to device memory for K3: a warp's four
          // n-tiles fill 128 bytes of each of its 32 rows
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt) {
            const int col = n1 + nt * 8 + 2 * tig;
            const float bias[2] = {glom::to_f32(b1g[c0 + col]), glom::to_f32(b1g[c0 + col + 1])};
#pragma unroll
            for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = mt * 16 + gid + 8 * half;
                float hv[2], dh[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int q = 2 * half + e;
                  float dg;
                  gelu_and_grad(pa[mt][nt][q] + bias[e], hv[e], dg);
                  dh[e] = ga[mt][nt][q] * dg;
                }
                glom::store2(dhs + row * S::kH + col, dh[0], dh[1]);
                if (hid != nullptr && row0 + row < rows) {
                  const long long o = ((long long)g * rows + row0 + row) * hidden + c0 + col;
                  glom::store2(hid + o, hv[0], hv[1]);
                  glom::store2(dhg + o, dh[0], dh[1]);
                }
              }
          }
        }
      }
    } else {
      // phase 2: dX += dH[:, j slab] w1[:, j slab]^T, depth JS2 = 16: each
      // tile's product is formed in a zeroed fragment t and added to acc
      // with an f32 add (tile_mma.cuh: the tensor cores' accumulation rounds
      // toward zero, which would bias a sum over the whole hidden)
      constexpr int K8 = JS2 / 8;
      const int kq = (j - N1) * JS2;
      uint32_t ahi[K8][2][4], alo[K8][2][4];
#pragma unroll
      for (int k = 0; k < K8; ++k)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {   // dH, split here
          uint32_t raw[4];
          ldm_a(raw, dhs, S::kH, mt * 16, kq + 8 * k);
#pragma unroll
          for (int e = 0; e < 4; ++e) glom::split_tf32(__uint_as_float(raw[e]), ahi[k][mt][e], alo[k][mt][e]);
        }
#pragma unroll
      for (int nt0 = 0; nt0 < NT2; nt0 += 2) {   // two n-tiles at a time
        uint32_t bhi[K8][2][2], blo[K8][2][2];
#pragma unroll
        for (int k = 0; k < K8; ++k) {
          if constexpr (kF32) {
            uint32_t braw[4];
            ldm_b2(braw, wslf, [](int n, int jj) { return S::w1q(n, jj); }, n2 + nt0 * 8, 8 * k);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              glom::split_tf32(__uint_as_float(braw[e]), bhi[k][e >> 1][e & 1], blo[k][e >> 1][e & 1]);
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int n = n2 + (nt0 + u) * 8 + gid;
              bhi[k][u][0] = __float_as_uint(glom::to_f32(wsl[S::w1q(n, 8 * k + tig)]));
              bhi[k][u][1] = __float_as_uint(glom::to_f32(wsl[S::w1q(n, 8 * k + tig + 4)]));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int k = 0; k < K8; ++k) {
              glom::mma_tf32(t, alo[k][mt], bhi[k][u]);
              if constexpr (kF32) glom::mma_tf32(t, ahi[k][mt], blo[k][u]);
              glom::mma_tf32(t, ahi[k][mt], bhi[k][u]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt0 + u][e] += t[e];
          }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + mt * 16 + gid + 8 * half;
      if (row >= rows) continue;
      const long long o = ((long long)row * groups + g) * D + n2 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (ws == nullptr) glom::store2(dx + o + nt * 8, v0, v1);
        else glom::store2(ws + (long long)blockIdx.z * rows * groups * D + o + nt * 8, v0, v1);
      }
    }
}

// dx[i] = sum_z ws[z][i], four elements a thread, the splits in order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dx_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dx, long long total, int splits) {
  const long long i = 4 * ((long long)blockIdx.x * THREADS + threadIdx.x);
  if (i >= total) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(ws + (long long)z * total + i);
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  glom::store2(dx + i, s.x, s.y);
  glom::store2(dx + i + 2, s.z, s.w);
}

// Four consecutive elements of a K3 slab as f32: 16 bytes of f32, 8 of bf16.
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return glom::to_f32x4(*reinterpret_cast<const uint2*>(p));
}

// Eight values to eight consecutive elements (16-byte aligned for bf16, 32
// for f32).
__device__ __forceinline__ void store8(float* o, const float (&v)[8]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* o, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(o) = u;
}

// Start the copy of rows [r0, r0 + BK3) of one operand into a slab: row r
// at src + r * stride (elements), its first `width` (a multiple of 32) of W
// columns; rows at or past `rend` are zero.
template <typename T, int W>
__device__ __forceinline__ void dw_copy(T* dst, const T* src, long long stride, int r0, int rend,
                                        int width, int tid) {
  using S = DwSlab<T, W>;
  constexpr int E = S::kChunk, PR = W / E;   // elements a piece, pieces a row
  static_assert(BK3 * PR % THREADS3 == 0, "a slab must split evenly over the block");
#pragma unroll
  for (int u = 0; u < BK3 * PR / THREADS3; ++u) {
    const int i = tid + u * THREADS3, r = i / PR, q = i % PR;
    if (q * E < width) {
      const bool live = r0 + r < rend;
      glom::cp_async16_zfill(dst + S::at(r, q * E),
                             src + (long long)(live ? r0 + r : r0) * stride + q * E, live);
    }
  }
}

// One output tile of C = A^T B, summed over rows [rb, re): A(r, m) = a[r *
// sa + m] (TA), B(r, n) = b[r * sb + n] (TB), both pointing at the tile's
// first column; mw and nw of its BM3 x BN3 entries exist (multiples of 32).
// EXACT_A / EXACT_B: that operand came from bf16 and skips its lo pass.
// STAGE: the bytes of a ring stage.
// The tile goes to c (row stride ldc, element type TC: the output's or the
// f32 workspace's); with db, the column sums of B go to db.
template <int STAGE, typename TA, typename TB, bool EXACT_A, bool EXACT_B, typename TC>
__device__ __forceinline__ void dw_tile(const TA* __restrict__ a, long long sa,
                                        const TB* __restrict__ b, long long sb, int mw, int nw,
                                        int rb, int re, unsigned char* smem, TC* __restrict__ c,
                                        long long ldc, TC* __restrict__ db) {
  using SA = DwSlab<TA, BM3>;
  using SB = DwSlab<TB, BN3>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);
  const bool live = wm < mw && wn < nw;                 // warp-uniform
  const bool sums = db != nullptr && (warp & 1) == 0;   // the warps of the tile's first rows
  const int steps = (re - rb + BK3 - 1) / BK3;
  auto issue = [&](int s) {
    unsigned char* st = smem + (s % NST3) * STAGE;
    dw_copy<TA, BM3>(reinterpret_cast<TA*>(st), a, sa, rb + s * BK3, re, mw, tid);
    dw_copy<TB, BN3>(reinterpret_cast<TB*>(st + SA::kBytes), b, sb, rb + s * BK3, re, nw, tid);
    glom::cp_async_commit();
  };
  // the ring runs NST3 - 1 slabs ahead; a group is committed for every slab
  // index, empty past the last, so wait_group counts the same everywhere
  for (int s = 0; s < NST3 - 1; ++s) {
    if (s < steps) issue(s);
    else glom::cp_async_commit();
  }
  float acc[2][4][4];
  zero_tiles(acc);
  float dbs[4] = {0.f, 0.f, 0.f, 0.f};   // column wn + 4 gid + nt, rows tig and tig + 4 of each k-step

  for (int s = 0; s < steps; ++s) {
    glom::cp_async_wait_group<NST3 - 2>();
    __syncthreads();   // slab s has landed; every warp is done with slab s - 1
    if (s + NST3 - 1 < steps) issue(s + NST3 - 1);
    else glom::cp_async_commit();
    if (!live) continue;
    const unsigned char* st = smem + (s % NST3) * STAGE;
    const TA* as = reinterpret_cast<const TA*>(st);
    const TB* bs = reinterpret_cast<const TB*>(st + SA::kBytes);
    // the slab's product, formed in t and added to acc with an f32 add
    float t[2][4][4];
    zero_tiles(t);
#pragma unroll
    for (int kk = 0; kk < BK3; kk += 8) {
      // mma rows g and g + 8 of m-tile mt are the tile's rows wm + 4 gid +
      // 2 mt and + 1; mma column j of n-tile nt is column wn + 4 j + nt
      const float4 a0 = ld4(as + SA::at(kk + tig, wm + 4 * gid));
      const float4 a1 = ld4(as + SA::at(kk + tig + 4, wm + 4 * gid));
      const float4 b0 = ld4(bs + SB::at(kk + tig, wn + 4 * gid));
      const float4 b1 = ld4(bs + SB::at(kk + tig + 4, wn + 4 * gid));
      const float av[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
      const float bv[2][4] = {{b0.x, b0.y, b0.z, b0.w}, {b1.x, b1.y, b1.z, b1.w}};
      if (sums) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) dbs[nt] += bv[0][nt] + bv[1][nt];
      }
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = av[e >> 1][2 * mt + (e & 1)];
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
    add_tiles(acc, t);
  }
  glom::cp_async_wait_all();
  if (!live) return;
  // row wm + 4 gid + q (q = 2 mt + half) of the tile: columns wn + 8 tig +
  // [0, 8), the first four from mma column 2 tig, the next from 2 tig + 1
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      v[nt] = acc[q >> 1][nt][2 * (q & 1)];
      v[4 + nt] = acc[q >> 1][nt][2 * (q & 1) + 1];
    }
    store8(c + (long long)(wm + 4 * gid + q) * ldc + wn + 8 * tig, v);
  }
  if (sums) {
    // the four lanes of a column hold rows tig (mod 4): add them in a fixed order
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      dbs[nt] += __shfl_xor_sync(0xffffffffu, dbs[nt], 1);
      dbs[nt] += __shfl_xor_sync(0xffffffffu, dbs[nt], 2);
    }
    if (tig == 0) {
      glom::store2(db + wn + 4 * gid, dbs[0], dbs[1]);
      glom::store2(db + wn + 4 * gid + 2, dbs[2], dbs[3]);
    }
  }
}

// dW1 tiles of a group, then dW2 tiles: (d / BM3) x ceil(h / BN3) and
// ceil(h / BM3) x (d / BN3).
__host__ __device__ inline int dw1_tiles(int dim, int hidden) {
  return dim / BM3 * ((hidden + BN3 - 1) / BN3);
}
__host__ __device__ inline int dw_tiles(int dim, int hidden) {
  return dw1_tiles(dim, hidden) + (hidden + BM3 - 1) / BM3 * (dim / BN3);
}

// Grid (dw_tiles, groups, splits).  Split z covers row slabs [z * per_split,
// (z + 1) * per_split).  With ws null the block writes its tile of dw1 or
// dw2 (and, for dW1 tiles of the first d-tile, db1) in T; otherwise its
// partial sums go to ws[z], laid out as [dw1 | db1 | dw2] in f32.
template <typename T>
__global__ void __launch_bounds__(THREADS3, 2)
ff_bwd_dw_kernel(const T* __restrict__ x, long long row_stride, long long group_stride,
                 const T* __restrict__ go, const float* __restrict__ hid,
                 const float* __restrict__ dh, T* __restrict__ dw1, T* __restrict__ db1,
                 T* __restrict__ dw2, float* __restrict__ ws, int rows, int groups, int dim,
                 int hidden, int per_split) {
  using S = DwLayout<T>;
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int g = blockIdx.y;
  const int rb = blockIdx.z * per_split * BK3, re = min(rows, rb + per_split * BK3);
  const long long n1 = (long long)groups * dim * hidden, n2 = (long long)groups * hidden;
  float* wz = ws == nullptr ? nullptr : ws + blockIdx.z * (2 * n1 + n2);
  const float* hg = hid + (long long)g * rows * hidden;
  const float* dhg = dh + (long long)g * rows * hidden;
  int tile = blockIdx.x;
  const int t1 = dw1_tiles(dim, hidden);
  if (tile < t1) {   // dW1[g]: A = x[:, g, m0 :], B = dH[g][:, n0 :]
    const int per_row = (hidden + BN3 - 1) / BN3;
    const int m0 = tile / per_row * BM3, n0 = tile % per_row * BN3;
    const long long o = ((long long)g * dim + m0) * hidden + n0, ob = (long long)g * hidden + n0;
    const T* a = x + g * group_stride + m0;
    const int nw = min(BN3, hidden - n0);
    if (wz == nullptr)
      dw_tile<S::kStage, T, float, kExact, false>(a, row_stride, dhg + n0, hidden, BM3, nw, rb,
                                                  re, smem, dw1 + o, hidden,
                                                  m0 == 0 ? db1 + ob : nullptr);
    else
      dw_tile<S::kStage, T, float, kExact, false>(a, row_stride, dhg + n0, hidden, BM3, nw, rb,
                                                  re, smem, wz + o, hidden,
                                                  m0 == 0 ? wz + n1 + ob : nullptr);
  } else {           // dW2[g]: A = H[g][:, m0 :], B = dO[:, g, n0 :]
    tile -= t1;
    const int per_row = dim / BN3;
    const int m0 = tile / per_row * BM3, n0 = tile % per_row * BN3;
    const long long o = ((long long)g * hidden + m0) * dim + n0;
    const T* b = go + (long long)g * dim + n0;
    const int mw = min(BM3, hidden - m0);
    if (wz == nullptr)
      dw_tile<S::kStage, float, T, false, kExact>(hg + m0, hidden, b, (long long)groups * dim, mw,
                                                  BN3, rb, re, smem, dw2 + o, dim,
                                                  static_cast<T*>(nullptr));
    else
      dw_tile<S::kStage, float, T, false, kExact>(hg + m0, hidden, b, (long long)groups * dim, mw,
                                                  BN3, rb, re, smem, wz + n1 + n2 + o, dim,
                                                  static_cast<float*>(nullptr));
  }
}

// dw1, db1 and dw2 = the sums over z of ws[z] = [dw1 | db1 | dw2], four
// elements a thread, the splits in order (n1, n2 and total multiples of 4).
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dw1, T* __restrict__ db1,
                 T* __restrict__ dw2, long long n1, long long n2, long long total, int splits) {
  const long long i = 4 * ((long long)blockIdx.x * THREADS + threadIdx.x);
  if (i >= total) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(ws + (long long)z * total + i);
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  T* o = i < n1 ? dw1 + i : i < n1 + n2 ? db1 + (i - n1) : dw2 + (i - n1 - n2);
  glom::store2(o, s.x, s.y);
  glom::store2(o + 2, s.z, s.w);
}

template <typename T, int D>
cudaError_t launch_dx(const void* x, long long row_stride, long long group_stride, const void* w1,
                      const void* b1, const void* w2, const void* go, void* dx, void* ws,
                      void* hid, void* dh, int rows, int groups, int hidden, int splits,
                      cudaStream_t stream) {
  const size_t smem = DxLayout<T, D>::kBytes;
  cudaError_t err = glom::allow_smem(ff_bwd_dx_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (hidden + HC2 - 1) / HC2;
  const int per_split = (chunks + splits - 1) / splits;
  splits = (chunks + per_split - 1) / per_split;   // no empty split
  float* partial = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const dim3 grid((rows + BM2 - 1) / BM2, groups, splits);
  ff_bwd_dx_kernel<T, D><<<grid, THREADS2, smem, stream>>>(
      static_cast<const T*>(x), row_stride, group_stride, static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(go),
      static_cast<T*>(dx), partial, static_cast<float*>(hid), static_cast<float*>(dh), rows,
      groups, hidden, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const long long total = (long long)rows * groups * D;
  const long long blocks = (total / 4 + THREADS - 1) / THREADS;
  dx_reduce_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      partial, static_cast<T*>(dx), total, splits);
  return cudaGetLastError();
}

// How many blocks of K2 for (T, D) an SM runs at once.
template <typename T, int D>
int dx_blocks_per_sm() {
  const size_t smem = DxLayout<T, D>::kBytes;
  if (glom::allow_smem(ff_bwd_dx_kernel<T, D>, smem) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ff_bwd_dx_kernel<T, D>, THREADS2, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

template <typename T>
int dx_occupancy(int dim) {
  switch (dim) {
    case 128: return dx_blocks_per_sm<T, 128>();
    case 256: return dx_blocks_per_sm<T, 256>();
    case 384: return dx_blocks_per_sm<T, 384>();
    case 512: return dx_blocks_per_sm<T, 512>();
    default: return -1;
  }
}

template <typename T>
cudaError_t launch_dw(const void* x, long long row_stride, long long group_stride, const void* go,
                      const void* hid, const void* dh, void* dw1, void* db1, void* dw2, void* ws,
                      int rows, int groups, int dim, int hidden, int splits, cudaStream_t stream) {
  const size_t smem = DwLayout<T>::kBytes;
  cudaError_t err = glom::allow_smem(ff_bwd_dw_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int slabs = (rows + BK3 - 1) / BK3;
  const int per_split = (slabs + splits - 1) / splits;
  splits = (slabs + per_split - 1) / per_split;   // no empty split
  float* partial = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const dim3 grid(dw_tiles(dim, hidden), groups, splits);
  ff_bwd_dw_kernel<T><<<grid, THREADS3, smem, stream>>>(
      static_cast<const T*>(x), row_stride, group_stride, static_cast<const T*>(go),
      static_cast<const float*>(hid), static_cast<const float*>(dh), static_cast<T*>(dw1),
      static_cast<T*>(db1), static_cast<T*>(dw2), partial, rows, groups, dim, hidden, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const long long n1 = (long long)groups * dim * hidden, n2 = (long long)groups * hidden;
  const long long total = 2 * n1 + n2;
  const long long blocks = (total / 4 + THREADS - 1) / THREADS;
  dw_reduce_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      partial, static_cast<T*>(dw1), static_cast<T*>(db1), static_cast<T*>(dw2), n1, n2, total,
      splits);
  return cudaGetLastError();
}

// How many blocks of K3 for T an SM runs at once.
template <typename T>
int dw_blocks_per_sm() {
  const size_t smem = DwLayout<T>::kBytes;
  if (glom::allow_smem(ff_bwd_dw_kernel<T>, smem) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ff_bwd_dw_kernel<T>, THREADS3, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

template <typename T>
cudaError_t dispatch_dx(int dim, const void* x, long long rs, long long gs, const void* w1,
                        const void* b1, const void* w2, const void* go, void* dx, void* ws,
                        void* hid, void* dh, int rows, int groups, int hidden, int splits,
                        cudaStream_t s) {
  switch (dim) {
    case 128: return launch_dx<T, 128>(x, rs, gs, w1, b1, w2, go, dx, ws, hid, dh, rows, groups, hidden, splits, s);
    case 256: return launch_dx<T, 256>(x, rs, gs, w1, b1, w2, go, dx, ws, hid, dh, rows, groups, hidden, splits, s);
    case 384: return launch_dx<T, 384>(x, rs, gs, w1, b1, w2, go, dx, ws, hid, dh, rows, groups, hidden, splits, s);
    case 512: return launch_dx<T, 512>(x, rs, gs, w1, b1, w2, go, dx, ws, hid, dh, rows, groups, hidden, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int rows, int groups, int dim, int hidden) {
  return dim % 128 == 0 && dim >= 128 && dim <= 512 && hidden % H_ALIGN == 0 && hidden >= H_ALIGN &&
         rows >= 1 && groups >= 1 && groups <= 65535;
}

// The split count, at most max_splits, that runs `tiles` blocks' worth of
// work, `units` steps a tile (hidden chunks in K2, row slabs in K3), on
// `slots` resident blocks in the fewest step-times (waves x steps a block),
// the fewest splits on a tie.
int fewest_waves(long long tiles, long long slots, int units, long long max_splits) {
  int best = 1;
  long long best_cost = -1;
  for (int per_split = units; per_split >= 1; --per_split) {
    const int splits = (units + per_split - 1) / per_split;
    if (splits > max_splits) break;
    const long long cost = (tiles * splits + slots - 1) / slots * per_split;
    if (best_cost < 0 || cost < best_cost) best = splits, best_cost = cost;
  }
  return best;
}

// The current device's SM count times `per_sm`, or -1.
long long block_slots(int per_sm) {
  int device = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return (long long)sms * per_sm;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// How many blocks should share a row tile's hidden dimension in K2: the
// count that runs the call's (row tile, split) blocks on the current
// device's SMs in the fewest chunk-times (waves x chunks a block), the
// fewest splits on a tie.  With more than one, the caller passes an f32
// workspace of splits * rows * groups * dim.  -1 on bad arguments or a CUDA
// error.
extern "C" int glom_grouped_ff_bwd_dx_splits(int rows, int groups, int dim, int hidden, int dtype) {
  if (!valid(rows, groups, dim, hidden)) return -1;
  const long long slots = block_slots(dtype == glom::kF32 ? dx_occupancy<float>(dim)
                                      : dtype == glom::kBF16 ? dx_occupancy<__nv_bfloat16>(dim)
                                                             : -1);
  if (slots < 1) return -1;
  const int chunks = (hidden + HC2 - 1) / HC2;
  return fewest_waves((long long)((rows + BM2 - 1) / BM2) * groups, slots, chunks, chunks);
}

// K2.  x: (rows, groups, dim) read through row_stride / group_stride
// (elements); w1 (groups, dim, hidden), b1 (groups, hidden), w2 (groups,
// hidden, dim), go = dO and dx (rows, groups, dim): contiguous, all of one
// dtype; w1 and w2 16-byte aligned.  ws: with splits > 1, an f32 workspace
// of splits * rows * groups * dim, 16-byte aligned; unused with one split.
// hid, dh: both null, or K3's hidden, f32 (groups, rows, hidden) each,
// which the kernel fills with H and dH.  Returns the launches' cudaError_t.
extern "C" int glom_grouped_ff_bwd_dx(const void* x, long long row_stride, long long group_stride,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* go, void* dx, void* ws, void* hid, void* dh,
                                      int rows, int groups, int dim, int hidden, int splits,
                                      int dtype, void* stream) {
  if (!valid(rows, groups, dim, hidden) || splits < 1 || (splits > 1 && ws == nullptr) ||
      !aligned16(w1) || !aligned16(w2) || !aligned16(ws) || (hid == nullptr) != (dh == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return dispatch_dx<float>(dim, x, row_stride, group_stride, w1, b1, w2, go, dx, ws, hid, dh,
                              rows, groups, hidden, splits, s);
  if (dtype == glom::kBF16)
    return dispatch_dx<__nv_bfloat16>(dim, x, row_stride, group_stride, w1, b1, w2, go, dx, ws,
                                      hid, dh, rows, groups, hidden, splits, s);
  return cudaErrorInvalidValue;
}

// How many blocks should share an output tile's rows in K3: K2's rule over
// row slabs, where the (tile, split) blocks fit in one wave.  K3's tiles are
// many (1,536 at the flagship's 6 groups), so a split pays only where they
// leave SMs idle: K2's rule alone would split a grid of 5.8 waves 64 ways
// to save the last wave's idle fifth, and pay for it with a workspace 64
// times the output and a second pass over it.  With more than one, the
// caller passes an f32 workspace of splits * groups * (2 * dim * hidden +
// hidden).  -1 on bad arguments or a CUDA error.
extern "C" int glom_grouped_ff_bwd_dw_splits(int rows, int groups, int dim, int hidden, int dtype) {
  if (!valid(rows, groups, dim, hidden)) return -1;
  const long long slots = block_slots(dtype == glom::kF32 ? dw_blocks_per_sm<float>()
                                      : dtype == glom::kBF16 ? dw_blocks_per_sm<__nv_bfloat16>()
                                                             : -1);
  if (slots < 1) return -1;
  const long long tiles = (long long)dw_tiles(dim, hidden) * groups;
  return fewest_waves(tiles, slots, (rows + BK3 - 1) / BK3, tiles < slots ? slots / tiles : 1);
}

// K3.  x (rows, groups, dim) read through row_stride / group_stride
// (elements), go = dO (rows, groups, dim) contiguous, both of dtype, with
// every row on a 16-byte boundary; hid and dh, K2's hidden, f32 (groups,
// rows, hidden), contiguous.  dw1 (groups, dim, hidden), db1 (groups,
// hidden), dw2 (groups, hidden, dim): contiguous, dtype.  ws: with splits >
// 1, an f32 workspace of splits * groups * (2 * dim * hidden + hidden);
// unused with one split.  All 16-byte aligned.  Returns the launches'
// cudaError_t.
extern "C" int glom_grouped_ff_bwd_dw(const void* x, long long row_stride, long long group_stride,
                                      const void* go, const void* hid, const void* dh, void* dw1,
                                      void* db1, void* dw2, void* ws, int rows, int groups,
                                      int dim, int hidden, int splits, int dtype, void* stream) {
  const long long item = dtype == glom::kF32 ? 4 : 2;
  if (!valid(rows, groups, dim, hidden) || splits < 1 || (splits > 1 && ws == nullptr) ||
      (dtype != glom::kF32 && dtype != glom::kBF16) || hid == nullptr || dh == nullptr ||
      !aligned16(x) || (row_stride * item) % 16 != 0 || (group_stride * item) % 16 != 0 ||
      !aligned16(go) || !aligned16(hid) || !aligned16(dh) || !aligned16(dw1) ||
      !aligned16(db1) || !aligned16(dw2) || !aligned16(ws))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return launch_dw<float>(x, row_stride, group_stride, go, hid, dh, dw1, db1, dw2, ws, rows,
                            groups, dim, hidden, splits, s);
  return launch_dw<__nv_bfloat16>(x, row_stride, group_stride, go, hid, dh, dw1, db1, dw2, ws,
                                  rows, groups, dim, hidden, splits, s);
}
