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
// Both run tile_gemm.cuh's tiled product, which K8 (fused_update.cu) shares
// and which came from K3's machinery (grouped_ff_bwd.cu):
//  * a block owns a 64 x 128 output tile of one group (K1a: 3,072 tiles at
//    flagship b=8, K1b: 768) and walks the depth in slabs of 32 through a
//    three-stage cp.async ring, unpadded and swizzled;
//  * each of the 8 warps owns 32 x 32 of the tile, and the mma's depth is
//    permuted the same way in A and B, so one 16-byte shared load gives a
//    lane what it needs; each slab's product is folded into the
//    accumulator with an f32 add, so no long sum stays inside the mma;
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
// and the hidden are contiguous.  d must be a multiple of 128 (any: the
// tiles' shared memory does not grow with d); h a multiple of 64 (ragged
// against the 128-wide tile).

#include <type_traits>

#include "common.cuh"
#include "tile_gemm.cuh"
#include "tile_mma.cuh"

namespace {

using namespace glom::tile;

constexpr int H_ALIGN = 64;    // h must be a multiple

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
  const int col = col_in_tile();
  if (col >= nw) return;
  float bias[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bias[i] = glom::to_f32(b1[(long long)g * hidden + n0 + col + i]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + row_in_tile(q);
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
  const int col = n0 + col_in_tile();
  float bias[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bias[i] = ws == nullptr ? glom::to_f32(b2[g * dim + col + i]) : 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + row_in_tile(q);
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
  const float4 s = sum_splits(ws, total, i, splits);
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
  return dim % 128 == 0 && dim >= 128 && hidden % H_ALIGN == 0 && hidden >= H_ALIGN &&
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
  return plan_splits(tiles, slots, hidden / BK, slots);
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
