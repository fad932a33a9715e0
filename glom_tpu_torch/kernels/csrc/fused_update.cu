// One whole GLOM level update (K8), written by hand for Hopper (sm_90a).
//
// Replaces: glom_tpu/kernels/fused_update_pallas.py::_forward (the TPU
// kernel body `_kernel`).  For each batch b, level l and patch i of levels
// (b, n, L, d), with tokens = bottom[b, :, 0] and pos = pos[0, :, 0]:
//     bu   = BU_l(tokens_i if l == 0 else levels[b, i, l-1])
//     td   = TD_l(levels[b, i, l+1] + pos_i) if l < L-1 else 0
//     cons = consensus(levels[b, :, l])_i
//     out[b, i, l] = (((levels[b, i, l] + bu) + td) + cons) / (3 if l == L-1 else 4)
// BU_l and TD_l are group l of the two grouped feed-forward nets (two layers,
// exact-erf GELU, b1 added before it and b2 after the sum over the hidden, as
// grouped_ff.cu); consensus is consensus_fwd.cuh's (keys the L2-normalised
// levels, scale d^-1/2, soft self-mask, locality mask).  The top level adds
// its zero top-down term instead of skipping it, as the unfused composition
// does, so -0.0 comes out as it does there.  f32 or bf16 inputs (all one
// type); as in the TPU kernel every input is widened to f32, everything is
// computed in f32 (the level l+1 + pos sum included), and out is rounded to
// the inputs' type once, at its store.
//
// What bounds it: operations.  At the flagship shapes (b=8, n=256, L=6,
// d=512, h=2048) an update does 4*d*h FLOPs a row for each of the 11 nets'
// groups and 4*n*d a row of each level for consensus: 100.9 GFLOP on about
// 150 MB of inputs and outputs, 670 FLOPs a byte.
//
// The TPU kernel keeps both nets' hiddens and the three terms in VMEM.  The
// first design here did too, with one block an SM holding a 32-row tile and
// its running sum on chip, and lost to the three unfused kernels it
// replaces (2.94 against 2.19 ms at flagship f32 b=8 on the H100): K1
// measured the same trade (a fused loop at one block an SM 1.27 ms, two
// tiled products through device memory 0.96).  So K8 runs on K1's tiled
// products (tile_gemm.cuh) and K4's consensus kernel, all launched here on
// the caller's stream, and keeps of its own the gather and the epilogue: no
// concatenation, pos add, pad, sum or divide runs outside its kernels.
//  * td_input_kernel: tdin = levels[:, :, 1:] + pos in f32, (rows, L-1, d),
//    never rounded to the inputs' type (21 MB at flagship b=8);
//  * K8a, hidden_kernel: hid[g] = gelu(X_g W1_g + b1_g), f32 (2L-1, rows,
//    h), one tiled product over the 2L-1 groups of both nets.  Group g < L
//    is the bottom-up net's group g and reads the tokens (g = 0) or level
//    g-1 through the strides of `bottom` and `levels`; group g >= L is the
//    top-down net's group g-L and reads tdin, an f32 operand that takes its
//    lo pass in bf16 too.  The weights are read from each net's own tensors;
//  * consensus_fwd.cuh's kernel with an f32 output, (rows, L, d), split over
//    the keys as K4's planner says (the wrapper passes its count);
//  * K8b, update_kernel: a block owns a 64 x 128 tile of out[:, :, l] and sums
//    hid[L+l] W2_td[l] (l < L-1) and then hid[l] W2_bu[l] over h, each into
//    its own accumulator (the first parked in shared memory, a thread's own
//    32 values, while the second runs), then forms the update in the order
//    above, rounded once.  Where its tiles leave the card part-empty (b=1:
//    96 tiles), glom_fused_update_splits picks how many blocks share a tile's
//    hidden (K1b's rule: only where the split blocks fit one wave); each
//    writes its two partial sums to an f32 workspace, and update_reduce_kernel
//    adds them in a fixed order and forms the update.  Two calls give the
//    same bits.
// The hidden, tdin and the consensus term live in one f32 workspace that the
// wrapper allocates for the call (230 MB at flagship f32 b=8) and frees.
//
// Layout: levels, bottom and pos are read through strides (elements; the
// last dimension contiguous, every row on a 16-byte boundary, and levels'
// and bottom's (b, n) axes flattening to one row axis); the weights
// (bottom_up: L groups, top_down: L-1) and out (b, n, L, d) are contiguous,
// w1 and w2 on a 16-byte boundary.  d must be a multiple of 128 (above 512
// the consensus stage is consensus_wide.cuh's design); h a multiple of 64.

#include <type_traits>

#include "common.cuh"
#include "consensus_fwd.cuh"
#include "tile_gemm.cuh"
#include "tile_mma.cuh"

namespace {

using namespace glom::tile;

constexpr int H_ALIGN = 64;       // h must be a multiple
constexpr int MAX_SPLITS = 8;     // blocks that may share a K8b tile
constexpr int PARKED = 32;        // floats a thread parks: its share of a 64 x 128 tile

// A call's arguments, as the kernels read them.
template <typename T>
struct Args {
  const T* lv;           // levels (b, n, L, dim) through sb, sn, sl
  long long sb, sn, sl;
  long long rs;          // levels' row stride over the flattened (b, n)
  const T* tok;          // bottom (b, n, 1, dim), row stride trs
  long long trs;
  const T* pos;          // pos (1, n, 1, dim), row stride psn
  long long psn;
  const T *bw1, *bb1, *bw2, *bb2;   // bottom-up net, L groups
  const T *tw1, *tb1, *tw2, *tb2;   // top-down net, L-1 groups
  float* hid;            // (2L-1, rows, hidden)
  float* tdin;           // (rows, L-1, dim)
  float* cons;           // (rows, L, dim)
  float* ws;             // K8b's partial sums: per split (2, rows, L, dim); null with one split
  T* out;                // (rows, L, dim)
  int rows, n, L, dim, hidden;
};

// The f32 workspace of a call, in floats: each part starts on a 16-byte
// boundary.  The keys' split workspace (consensus_fwd.cuh's: per split the
// partial sums and a (max, sum) per row; above d=512 the wide design's
// logits, key scales and transposed keys, consensus_wide.cuh) and K8b's never
// live at once and share `scratch`.
struct Workspace {
  long long hid, tdin, cons, lse, scratch, total;
};


Workspace workspace(int b, int n, int L, int dim, int hidden, int splits, int cons_splits) {
  const long long rows = (long long)b * n;
  Workspace w;
  w.hid = 0;
  w.tdin = w.hid + (2LL * L - 1) * rows * hidden;
  w.cons = w.tdin + rows * (L - 1) * dim;
  w.lse = w.cons + rows * L * dim;
  w.scratch = w.lse + glom::round4((long long)b * L * n);
  // sized for f32 inputs, whatever the call's type
  const long long keys = glom::round4(glom::cons::workspace_floats(b, n, L, dim, cons_splits, 4));
  const long long tiles = splits > 1 ? 2LL * splits * rows * L * dim : 0;
  w.total = w.scratch + (keys > tiles ? keys : tiles);
  return w;
}

// tdin[r, l, c] = levels[r, l + 1, c] + pos[r % n, c], in f32, four elements a thread.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS) td_input_kernel(const Args<T> a) {
  using V = typename glom::Vec4<T>::type;
  const long long i = 4 * ((long long)blockIdx.x * REDUCE_THREADS + threadIdx.x);
  const long long rl = i / a.dim;   // r * (L - 1) + l
  if (rl >= (long long)a.rows * (a.L - 1)) return;
  const int c = static_cast<int>(i - rl * a.dim), l = static_cast<int>(rl % (a.L - 1));
  const long long r = rl / (a.L - 1);
  const float4 x = glom::to_f32x4(*reinterpret_cast<const V*>(a.lv + r * a.rs + (l + 1) * a.sl + c));
  const float4 p = glom::to_f32x4(*reinterpret_cast<const V*>(a.pos + (r % a.n) * a.psn + c));
  *reinterpret_cast<float4*>(a.tdin + i) = make_float4(x.x + p.x, x.y + p.y, x.z + p.z, x.w + p.w);
}

// One K8a tile: hid[row0 :, n0 :] = gelu(x[row0 :] w1[:, n0 :] + b1[n0 :]),
// x's rows rs apart (TA: T, or f32 for tdin), hid the group's (rows, hidden).
template <typename TA, typename T>
__device__ __forceinline__ void hidden_tile(const TA* x, long long rs, const T* w1, const T* b1,
                                            float* hid, int rows, int dim, int hidden,
                                            unsigned char* smem) {
  constexpr bool kExactA = !std::is_same<TA, float>::value;
  constexpr bool kExactB = !std::is_same<T, float>::value;
  const int per_row = (hidden + BN - 1) / BN;
  const int row0 = blockIdx.x / per_row * BM, n0 = blockIdx.x % per_row * BN;
  const int nw = min(BN, hidden - n0);
  float acc[2][4][4];
  tile_product<TA, T, kExactA, kExactB>(acc, x + row0 * rs, rs, rows - row0, w1 + n0,
                                                    hidden, nw, dim, smem);
  const int col = col_in_tile();
  if (col >= nw) return;
  float bias[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bias[i] = glom::to_f32(b1[n0 + col + i]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + row_in_tile(q);
    if (row >= rows) continue;
    float v[8];
    row_of(acc, q, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu(v[i] + bias[i]);
    glom::store8(hid + (long long)row * hidden + n0 + col, v);
  }
}

// K8a.  Grid (row tiles x hidden tiles, 2L - 1 groups).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) hidden_kernel(const Args<T> a) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int g = blockIdx.y, L = a.L, dim = a.dim, hidden = a.hidden;
  const bool bottom_up = g < L;
  const long long wg = bottom_up ? g : g - L;   // the group in its own net
  const T* w1 = (bottom_up ? a.bw1 : a.tw1) + wg * dim * hidden;
  const T* b1 = (bottom_up ? a.bb1 : a.tb1) + wg * hidden;
  float* hid = a.hid + (long long)g * a.rows * hidden;
  const float* tdin = a.tdin + wg * dim;
  const long long tdin_rs = (long long)(L - 1) * dim;
  if constexpr (std::is_same<T, float>::value) {
    const float* x = g == 0 ? a.tok : bottom_up ? a.lv + (g - 1) * a.sl : tdin;
    const long long rs = g == 0 ? a.trs : bottom_up ? a.rs : tdin_rs;
    hidden_tile(x, rs, w1, b1, hid, a.rows, dim, hidden, smem);
  } else if (bottom_up) {
    hidden_tile(g == 0 ? a.tok : a.lv + (g - 1) * a.sl, g == 0 ? a.trs : a.rs, w1, b1, hid,
                a.rows, dim, hidden, smem);
  } else {
    hidden_tile(tdin, tdin_rs, w1, b1, hid, a.rows, dim, hidden, smem);
  }
}

// Index of value (mt, nt, e) of a thread's parked tile share.
__device__ __forceinline__ int parked(int mt, int nt, int e) {
  return ((mt * 4 + nt) * 4 + e) * THREADS + threadIdx.x;
}

// K8b.  Grid (row tiles x dim tiles, L, splits): split z sums hidden slabs
// [z * per_split, (z + 1) * per_split) of both nets.  With one split the
// block writes out[row0 :, l, n0 :]; otherwise its two partial sums go to
// ws[z] (2, rows, L, dim).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) update_kernel(const Args<T> a, int per_split) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* park = reinterpret_cast<float*>(smem + smem_bytes<float, T>());
  const int l = blockIdx.y, L = a.L, dim = a.dim, hidden = a.hidden, rows = a.rows;
  const int per_row = dim / BN;
  const int row0 = blockIdx.x / per_row * BM, n0 = blockIdx.x % per_row * BN;
  const int k0 = blockIdx.z * per_split * BK, depth = min(per_split * BK, hidden - k0);
  const bool has_td = l < L - 1, split = a.ws != nullptr;
  float acc[2][4][4];
  if (has_td) {
    tile_product<float, T, false, kExact>(
        acc, a.hid + ((long long)(L + l) * rows + row0) * hidden + k0, hidden, rows - row0,
        a.tw2 + ((long long)l * hidden + k0) * dim + n0, dim, BN, depth, smem);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) park[parked(mt, nt, e)] = acc[mt][nt][e];
    __syncthreads();   // every warp is done with the ring before the next product refills it
  }
  tile_product<float, T, false, kExact>(
      acc, a.hid + ((long long)l * rows + row0) * hidden + k0, hidden, rows - row0,
      a.bw2 + ((long long)l * hidden + k0) * dim + n0, dim, BN, depth, smem);

  const int col = n0 + col_in_tile();
  const long long total = (long long)rows * L * dim;
  float bu_bias[8], td_bias[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bu_bias[i] = split ? 0.f : glom::to_f32(a.bb2[l * dim + col + i]);
    td_bias[i] = split || !has_td ? 0.f : glom::to_f32(a.tb2[l * dim + col + i]);
  }
  const float div = l == L - 1 ? 3.f : 4.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + row_in_tile(q);
    if (row >= rows) continue;
    float bu[8], td[8];
    row_of(acc, q, bu);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      td[nt] = has_td ? park[parked(q >> 1, nt, 2 * (q & 1))] : 0.f;
      td[4 + nt] = has_td ? park[parked(q >> 1, nt, 2 * (q & 1) + 1)] : 0.f;
    }
    const long long o = ((long long)row * L + l) * dim + col;
    if (split) {
      glom::store8(a.ws + blockIdx.z * 2 * total + o, bu);
      if (has_td) glom::store8(a.ws + blockIdx.z * 2 * total + total + o, td);
      continue;
    }
    float lv[8], cons[8], v[8];
    glom::load8(a.lv + row * a.rs + l * a.sl + col, lv);
    glom::load8(a.cons + o, cons);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // the top level adds a zero, as the unfused composition's pad does
      const float t = has_td ? td[i] + td_bias[i] : 0.f;
      v[i] = (((lv[i] + (bu[i] + bu_bias[i])) + t) + cons[i]) / div;
    }
    glom::store8(a.out + o, v);
  }
}

// K8b's splits combined, four elements of out a thread: bu = sum_z bu_z +
// b2, td = sum_z td_z + b2 (0 at the top level), splits in a fixed order;
// then the update as update_kernel forms it.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS) update_reduce_kernel(const Args<T> a,
                                                                       int splits) {
  using V = typename glom::Vec4<T>::type;
  const long long total = (long long)a.rows * a.L * a.dim;
  const long long i = 4 * ((long long)blockIdx.x * REDUCE_THREADS + threadIdx.x);
  if (i >= total) return;
  const long long rl = i / a.dim;   // row * L + l
  const int col = static_cast<int>(i - rl * a.dim), l = static_cast<int>(rl % a.L);
  const long long row = rl / a.L;
  const bool has_td = l < a.L - 1;
  const float4 bu = sum_splits(a.ws, 2 * total, i, splits);
  const float4 td = has_td ? sum_splits(a.ws + total, 2 * total, i, splits)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 q = glom::to_f32x4(*reinterpret_cast<const V*>(a.lv + row * a.rs + l * a.sl + col));
  const float4 c = *reinterpret_cast<const float4*>(a.cons + i);
  const float bu4[4] = {bu.x, bu.y, bu.z, bu.w}, td4[4] = {td.x, td.y, td.z, td.w};
  const float q4[4] = {q.x, q.y, q.z, q.w}, c4[4] = {c.x, c.y, c.z, c.w};
  const float div = l == a.L - 1 ? 3.f : 4.f;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float b = bu4[k] + glom::to_f32(a.bb2[l * a.dim + col + k]);
    const float t = has_td ? td4[k] + glom::to_f32(a.tb2[l * a.dim + col + k]) : 0.f;
    o[k] = (((q4[k] + b) + t) + c4[k]) / div;
  }
  glom::store2(a.out + i, o[0], o[1]);
  glom::store2(a.out + i + 2, o[2], o[3]);
}

template <typename T>
size_t update_smem() {
  return smem_bytes<float, T>() + sizeof(float) * PARKED * THREADS;
}

template <typename T>
cudaError_t launch(Args<T> a, int b, const int8_t* mask, float* lse, float* scratch,
                   float scale, int attend_self, int splits, int cons_splits,
                   cudaStream_t stream) {
  const size_t smem1 = smem_bytes<float, T>(), smem2 = update_smem<T>();
  cudaError_t err = glom::allow_smem(hidden_kernel<T>, smem1);
  if (err == cudaSuccess) err = glom::allow_smem(update_kernel<T>, smem2);
  if (err != cudaSuccess) return err;
  const int L = a.L, dim = a.dim, hidden = a.hidden;
  const long long quads = (long long)a.rows * (L - 1) * dim / 4;
  const unsigned blocks0 = static_cast<unsigned>((quads + REDUCE_THREADS - 1) / REDUCE_THREADS);
  td_input_kernel<T><<<blocks0, REDUCE_THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int row_tiles = (a.rows + BM - 1) / BM;
  const dim3 grid1(row_tiles * ((hidden + BN - 1) / BN), 2 * L - 1);
  hidden_kernel<T><<<grid1, THREADS, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = glom::cons::dispatch<T, float>(dim, a.lv, a.sb, a.sn, a.sl, mask, a.cons, lse, scratch, b,
                                       a.n, L, scale, attend_self, cons_splits, stream);
  if (err != cudaSuccess) return err;
  const int slabs = hidden / BK;
  const int per_split = (slabs + splits - 1) / splits;
  splits = (slabs + per_split - 1) / per_split;   // no empty split
  a.ws = splits > 1 ? scratch : nullptr;
  const dim3 grid2(row_tiles * (dim / BN), L, splits);
  update_kernel<T><<<grid2, THREADS, smem2, stream>>>(a, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ws == nullptr) return err;
  const long long blocks = ((long long)a.rows * L * dim / 4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  update_reduce_kernel<T><<<static_cast<unsigned>(blocks), REDUCE_THREADS, 0, stream>>>(a, splits);
  return cudaGetLastError();
}

// How many blocks of K8b for T an SM runs at once, as built.
template <typename T>
int blocks_per_sm() {
  const size_t smem = update_smem<T>();
  if (glom::allow_smem(update_kernel<T>, smem) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, update_kernel<T>, THREADS, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

bool valid(int b, int n, int L, int dim, int hidden) {
  return dim % 128 == 0 && dim >= 128 && hidden % H_ALIGN == 0 && hidden >= H_ALIGN && b >= 1 &&
         n >= 1 && L >= 2 && (long long)b * L <= 65535;
}

// A (b, n, ...) tensor's rows: every one on a 16-byte boundary (a stride
// over a dimension of size 1 is never taken), and the (b, n) axes flattening
// to one row axis.  Its row stride, or -1.
long long row_stride(const void* p, long long sb, long long sn, int b, int n, long long item) {
  if (!glom::aligned16(p) || (b > 1 && (sb * item) % 16 != 0) || (n > 1 && (sn * item) % 16 != 0) ||
      (b > 1 && n > 1 && sb != n * sn))
    return -1;
  return n > 1 ? sn : sb;
}

}  // namespace

// How many blocks should share a K8b tile's hidden: K1b's rule
// (tile_gemm.cuh::plan_splits: where the (tile, split) blocks fit one wave
// on the current device's SMs, in the fewest slab-times), at most 8.  -1 on
// bad arguments or a CUDA error.
extern "C" int glom_fused_update_splits(int b, int n, int L, int dim, int hidden, int dtype) {
  if (!valid(b, n, L, dim, hidden)) return -1;
  const long long slots = glom::block_slots(dtype == glom::kF32 ? blocks_per_sm<float>()
                                            : dtype == glom::kBF16 ? blocks_per_sm<__nv_bfloat16>()
                                                                   : -1);
  if (slots < 1) return -1;
  const long long tiles = ((long long)b * n + BM - 1) / BM * (dim / BN) * L;
  return plan_splits(tiles, slots, hidden / BK, MAX_SPLITS);
}

// The f32 workspace glom_fused_update needs, in floats: the hidden of both
// nets, the top-down input, the consensus term and its lse, and the larger
// of the keys' and K8b's split workspaces.  -1 on bad arguments.
extern "C" long long glom_fused_update_workspace(int b, int n, int L, int dim, int hidden,
                                                 int splits, int cons_splits) {
  if (!valid(b, n, L, dim, hidden) || splits < 1 || splits > MAX_SPLITS || cons_splits < 1 ||
      cons_splits > glom::cons::MAX_SPLITS)
    return -1;
  return workspace(b, n, L, dim, hidden, splits, cons_splits).total;
}

// levels (b, n, L, dim) read through strides sb, sn, sl; bottom (b, n, 1,
// dim) through tsb, tsn; pos (1, n, 1, dim) through psn (elements; last
// dimension contiguous, every row on a 16-byte boundary, levels' and
// bottom's (b, n) axes flattening to one).  bw1 (L, dim, hidden), bb1 (L,
// hidden), bw2 (L, hidden, dim), bb2 (L, dim): the bottom-up net; tw1, tb1,
// tw2, tb2: the top-down net, L-1 groups; contiguous, w1 and w2 on a 16-byte
// boundary.  width: the model's width, 1 to dim, whose d^-1/2 scales the
// consensus logits (dim itself, or less where every input is zero-padded to
// dim).  mask (n, n) int8 or bool, contiguous, or null; out (b, n, L,
// dim) contiguous, 16-byte aligned.  All of one dtype.  splits: how many
// blocks share a K8b tile's hidden (glom_fused_update_splits), 1 to 8;
// cons_splits: how many share a consensus tile's keys (glom_consensus_splits),
// 1 to 8.  ws: an f32 workspace of ws_floats elements, at least
// glom_fused_update_workspace's, 16-byte aligned.  Returns the launches'
// cudaError_t.
extern "C" int glom_fused_update(const void* levels, long long sb, long long sn, long long sl,
                                 const void* bottom, long long tsb, long long tsn,
                                 const void* pos, long long psn, const void* bw1,
                                 const void* bb1, const void* bw2, const void* bb2,
                                 const void* tw1, const void* tb1, const void* tw2,
                                 const void* tb2, const void* mask, void* out, void* ws,
                                 long long ws_floats, int b, int n, int L, int dim, int width,
                                 int hidden, int attend_self, int splits, int cons_splits,
                                 int dtype, void* stream) {
  const long long item = dtype == glom::kF32 ? 4 : 2;
  const long long need = glom_fused_update_workspace(b, n, L, dim, hidden, splits, cons_splits);
  const long long rs = row_stride(levels, sb, sn, b, n, item);
  const long long trs = row_stride(bottom, tsb, tsn, b, n, item);
  if (need < 0 || (dtype != glom::kF32 && dtype != glom::kBF16) || width < 1 || width > dim ||
      rs < 0 || trs < 0 ||
      (sl * item) % 16 != 0 || !glom::aligned16(pos) || (n > 1 && (psn * item) % 16 != 0) ||
      !glom::aligned16(bw1) || !glom::aligned16(bw2) || !glom::aligned16(tw1) ||
      !glom::aligned16(tw2) || !glom::aligned16(out) || ws == nullptr || !glom::aligned16(ws) ||
      ws_floats < need)
    return cudaErrorInvalidValue;
  const Workspace w = workspace(b, n, L, dim, hidden, splits, cons_splits);
  float* f = static_cast<float*>(ws);
  const int8_t* m = static_cast<const int8_t*>(mask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* type) {
    using T = std::remove_pointer_t<decltype(type)>;
    Args<T> a;
    a.lv = static_cast<const T*>(levels); a.sb = sb; a.sn = sn; a.sl = sl; a.rs = rs;
    a.tok = static_cast<const T*>(bottom); a.trs = trs;
    a.pos = static_cast<const T*>(pos); a.psn = psn;
    a.bw1 = static_cast<const T*>(bw1); a.bb1 = static_cast<const T*>(bb1);
    a.bw2 = static_cast<const T*>(bw2); a.bb2 = static_cast<const T*>(bb2);
    a.tw1 = static_cast<const T*>(tw1); a.tb1 = static_cast<const T*>(tb1);
    a.tw2 = static_cast<const T*>(tw2); a.tb2 = static_cast<const T*>(tb2);
    a.hid = f + w.hid; a.tdin = f + w.tdin; a.cons = f + w.cons; a.ws = nullptr;
    a.out = static_cast<T*>(out);
    a.rows = b * n; a.n = n; a.L = L; a.dim = dim; a.hidden = hidden;
    return launch<T>(a, b, m, f + w.lse, f + w.scratch, glom::logit_scale(width), attend_self,
                     splits, cons_splits, s);
  };
  if (dtype == glom::kF32) return run(static_cast<float*>(nullptr));
  return run(static_cast<__nv_bfloat16*>(nullptr));
}
