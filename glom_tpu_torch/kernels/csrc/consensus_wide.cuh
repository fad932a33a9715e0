// Consensus attention forward for widths past the narrow kernel's (d a
// multiple of 128 above 512), written by hand for Hopper (sm_90a): the
// wide path of K4 (consensus.cu, which replaces
// glom_tpu/kernels/consensus_pallas.py::_forward and ::_forward_blocked)
// and of K8's consensus stage (fused_update.cu).  It computes what
// consensus_fwd.cuh's kernel computes (out and lse, the same edge rules of
// consensus_row.cuh), for any n, f32 or bf16 inputs, an output in TO.
//
// What bounds it on the H100: operations, as the narrow kernel.  At the
// large preset (b=4, n=576, L=8, d=1024) a call does 4 n^2 d FLOPs over 32
// (b, l) pairs, 43.5 GFLOP, on 151 MB of inputs and outputs: 3xTF32 bound
// 0.26 ms, bf16 0.044 ms.
//
// Why not the narrow design.  consensus_fwd.cuh keeps the query tile and two
// key stages as whole rows in shared memory (3 x 32 x (d + 4) x 4 B: 395 KB
// at d=1024 f32, against the 227 KB a block may have) and a warp's (32, d/8)
// output accumulator in registers (128 floats a lane at d=1024).  Of the
// two designs weighed, splitting the output's d over blocks keeps the
// logits on chip but forms S once per d-slice (1.5x the ideal FLOPs at two
// slices) and needs a new streamed-d kernel of its own; this one runs in
// four launches on machinery the port already holds, and its only cost
// beyond the ideal FLOPs is the (n, n) logits through device memory (42 MB
// at the large preset, written and read twice: 0.05 ms of traffic):
//  * key_prep_kernel: the keys' scales kscale_j = d^-1/2 / max(||v_j||,
//    1e-12) over the whole d (so every logit is scaled by its key's full
//    norm), and V^T per (b, l), (d, np) in the inputs' type, np = n rounded
//    up to 32 and zero past n: the B operand of S = Q V^T in the layout
//    tile_gemm.cuh's product reads.  A 32 x 32 tile through shared memory,
//    loads and stores both 16 bytes a thread along rows;
//  * logits_kernel: S = Q V^T on tile_gemm.cuh's tiled product (64 queries
//    x 128 keys a block, the depth d walked in slabs of 32; 3xTF32 in f32,
//    one tf32 pass on bf16's exact values), the raw products scaled by
//    kscale, the soft self-mask, the locality mask and the keys past n set
//    in its epilogue (consensus_row.cuh's consensus_logit), into an f32
//    workspace (b, L, n, np);
//  * softmax_kernel: a warp a row: the row's max, its sum of exp, then P
//    in place of S (normalised) and lse = max + log(sum), f32 (b, L, n);
//  * pv_kernel: out = P V on the same tiled product (64 queries x 128
//    columns of d a block, the depth the keys), V read through levels'
//    strides, rounded once to TO.  Where its tiles leave the card part-empty,
//    the keys are split over `splits` blocks (plan(): tile_gemm.cuh's rule,
//    at most MAX_SPLITS); each writes its partial sum to the workspace and
//    sum_splits_kernel adds them in a fixed order.  P is normalised, so the
//    partial sums add as they are.
// Deterministic: every sum in a fixed order, no atomics.  The workspace
// (workspace()) is the caller's, 16-byte aligned.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "consensus_row.cuh"
#include "tile_gemm.cuh"
#include "tile_mma.cuh"

// Internal linkage, as consensus_fwd.cuh's: K4's library and K8's each
// hold their own instances and planner caches.
namespace glom {
namespace cons {
namespace {
namespace wide {

namespace tl = glom::tile;

constexpr int NARROW_MAX_DIM = 512;    // consensus_fwd.cuh's instantiations take d up to this
constexpr int KEYS = 32;               // keys a key_prep_kernel block, and np's multiple
constexpr int PREP_THREADS = 256;
constexpr int PREP_SMEM = KEYS * (KEYS + 1) * sizeof(float);
constexpr int ROWS_PER_BLOCK = 8;      // softmax_kernel: a warp a row
static_assert(KEYS == tl::BK, "np is a whole number of the products' slabs");

inline int padded_keys(int n) { return (n + KEYS - 1) / KEYS * KEYS; }

// The parts of a call's f32 workspace, in floats, each on a 16-byte
// boundary: the logits and then P (b, L, n, np), the key scales (b, L, np),
// V^T (b, L, d, np) in the inputs' type (`item` bytes an element), and with
// splits > 1 the split partial sums (splits, b, n, L, d).
struct Workspace {
  long long s, ks, vt, partial, total;
};

inline Workspace workspace(int b, int n, int L, int dim, int splits, int item) {
  const long long pairs = (long long)b * L, np = padded_keys(n);
  Workspace w;
  w.s = 0;
  w.ks = round4(pairs * n * np);
  w.vt = w.ks + round4(pairs * np);
  w.partial = w.vt + round4((pairs * dim * np * item + 3) / 4);
  w.total = w.partial + (splits > 1 ? (long long)splits * pairs * n * dim : 0);
  return w;
}

// Grid (np / KEYS, b * L).  Keys [j0, j0 + KEYS) of pair (b, l): their
// columns of V^T, and their scales.  Thread t loads key t / 8, columns
// 4 (t % 8) + [0, 4) of each 32-column chunk, and stores column t / 8,
// keys 4 (t % 8) + [0, 4).
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
key_prep_kernel(const T* __restrict__ lv, long long sb, long long sn, long long sl, int n, int L,
                int dim, int np, float scale, T* __restrict__ vt, float* __restrict__ ks) {
  using V = typename glom::Vec4<T>::type;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);   // [KEYS][KEYS + 1]
  const int pair = blockIdx.y, b = pair / L, l = pair % L;
  const int j0 = blockIdx.x * KEYS;
  const int r = threadIdx.x >> 3, q = threadIdx.x & 7;
  const bool live = j0 + r < n;
  const T* row = lv + b * sb + l * sl + (long long)(live ? j0 + r : 0) * sn;
  T* dst = vt + (long long)pair * dim * np + j0 + 4 * q;
  float ss = 0.f;
  for (int c0 = 0; c0 < dim; c0 += KEYS) {
    const float4 v = live ? glom::to_f32x4(*reinterpret_cast<const V*>(row + c0 + 4 * q))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    ss = fmaf(v.x, v.x, ss);
    ss = fmaf(v.y, v.y, ss);
    ss = fmaf(v.z, v.z, ss);
    ss = fmaf(v.w, v.w, ss);
    float* t = tile + r * (KEYS + 1) + 4 * q;
    t[0] = v.x, t[1] = v.y, t[2] = v.z, t[3] = v.w;
    __syncthreads();   // the chunk's tile is written
    const float* c = tile + 4 * q * (KEYS + 1) + r;
    const float out[4] = {c[0], c[KEYS + 1], c[2 * (KEYS + 1)], c[3 * (KEYS + 1)]};
    store4(dst + (long long)(c0 + r) * np, out);
    __syncthreads();   // every thread has read the tile before the next chunk
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  ss += __shfl_xor_sync(0xffffffffu, ss, 4);
  if (q == 0) ks[(long long)pair * np + j0 + r] = glom::key_scale_from_sq(ss, scale);
}

// Grid (row tiles x key tiles, b * L).  S[b, l, row0 :, col0 :] = the
// consensus logits of queries row0 + [0, 64) and keys col0 + [0, 128).
template <typename T>
__global__ void __launch_bounds__(tl::THREADS, 2)
logits_kernel(const T* __restrict__ lv, long long sb, long long sn, long long sl,
              const T* __restrict__ vt, const float* __restrict__ ks,
              const int8_t* __restrict__ mask, float* __restrict__ s, int n, int L, int dim,
              int np, int attend_self) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int pair = blockIdx.y, b = pair / L, l = pair % L;
  const int per_row = (np + tl::BN - 1) / tl::BN;
  const int row0 = blockIdx.x / per_row * tl::BM, col0 = blockIdx.x % per_row * tl::BN;
  const int nw = min(tl::BN, np - col0);
  float acc[2][4][4];
  tl::tile_product<T, T, kExact, kExact>(acc, lv + b * sb + l * sl + row0 * sn, sn, n - row0,
                                         vt + (long long)pair * dim * np + col0, np, nw, dim,
                                         reinterpret_cast<unsigned char*>(smem4));
  const int col = tl::col_in_tile();
  if (col >= nw) return;
  const float* kscale = ks + (long long)pair * np + col0 + col;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + tl::row_in_tile(q);
    if (row >= n) continue;
    float v[8];
    tl::row_of(acc, q, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = glom::consensus_logit(v[i], kscale[i], row, col0 + col + i, n, n, mask, attend_self);
    glom::store8(s + ((long long)pair * n + row) * np + col0 + col, v);
  }
}

// A warp a row of S (rows = b * L * n, each np long): P in place of S and
// lse.  Keys past n hold -inf and weigh exactly 0; every row has a key of
// its own below n, so its max is finite.
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
softmax_kernel(float* __restrict__ s, float* __restrict__ lse, long long rows, int np) {
  const long long r = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= rows) return;   // warp-uniform
  const int lane = threadIdx.x & 31;
  float* row = s + r * np;
  float mx = -INFINITY;
  for (int j = lane; j < np; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
  for (int j = lane; j < np; j += 32) sum += __expf(row[j] - mx);
  sum = glom::warp_sum(sum);
  const float rden = 1.f / sum;
  for (int j = lane; j < np; j += 32) row[j] = __expf(row[j] - mx) * rden;
  if (lane == 0) lse[r] = mx + logf(sum);
}

// Grid (row tiles x d tiles, b * L, splits): split z sums keys [z *
// per_split, (z + 1) * per_split) slabs.  With partial null the block
// writes out[b, row0 :, l, n0 :] = P V in TO; otherwise its partial sum
// goes to partial[z] (b, n, L, d), f32.
template <typename T, typename TO>
__global__ void __launch_bounds__(tl::THREADS, 2)
pv_kernel(const float* __restrict__ p, const T* __restrict__ lv, long long sb, long long sn,
          long long sl, TO* __restrict__ out, float* __restrict__ partial, int n, int L, int dim,
          int np, int per_split) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int pair = blockIdx.y, b = pair / L, l = pair % L;
  const int per_row = dim / tl::BN;
  const int row0 = blockIdx.x / per_row * tl::BM, n0 = blockIdx.x % per_row * tl::BN;
  const int k0 = blockIdx.z * per_split * tl::BK, depth = min(per_split * tl::BK, np - k0);
  float acc[2][4][4];
  tl::tile_product<float, T, false, kExact>(
      acc, p + ((long long)pair * n + row0) * np + k0, np, n - row0,
      lv + b * sb + l * sl + (long long)k0 * sn + n0, sn, tl::BN, depth,
      reinterpret_cast<unsigned char*>(smem4), n - k0);
  const int col = n0 + tl::col_in_tile();
  const long long total = (long long)gridDim.y * n * dim;   // b * n * L * d
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + tl::row_in_tile(q);
    if (row >= n) continue;
    float v[8];
    tl::row_of(acc, q, v);
    const long long o = (((long long)b * n + row) * L + l) * dim + col;
    if (partial == nullptr) glom::store8(out + o, v);
    else glom::store8(partial + blockIdx.z * total + o, v);
  }
}

// out[i] = sum_z partial[z][i], splits in a fixed order, four elements a thread.
template <typename TO>
__global__ void __launch_bounds__(tl::REDUCE_THREADS)
sum_splits_kernel(const float* __restrict__ partial, TO* __restrict__ out, long long total,
                  int splits) {
  const long long i = 4 * ((long long)blockIdx.x * tl::REDUCE_THREADS + threadIdx.x);
  if (i >= total) return;
  const float4 v = tl::sum_splits(partial, total, i, splits);
  glom::store2(out + i, v.x, v.y);
  glom::store2(out + i + 2, v.z, v.w);
}

// How many pv_kernel blocks for (T, TO) an SM runs at once, after opting it
// into its shared memory: asked once per device.
template <typename T, typename TO>
int blocks_per_sm() {
  static int known[64];   // per device: 0 not asked yet, else blocks + 1
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return -1;
  if (known[device] == 0) {
    const size_t smem = tl::smem_bytes<float, T>();
    int blocks = 0;
    if (glom::allow_smem(pv_kernel<T, TO>, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pv_kernel<T, TO>, tl::THREADS,
                                                      smem) != cudaSuccess)
      return -1;
    known[device] = blocks + 1;
  }
  return known[device] - 1;
}

// How many blocks should share a P V tile's keys: tile_gemm.cuh's rule (the
// split blocks fit one wave of the current device, in the fewest
// slab-times), at most max_splits.  -1 on a CUDA error.
template <typename T>
int plan(int b, int n, int L, int dim, int max_splits) {
  const long long slots = glom::block_slots(blocks_per_sm<T, T>());
  if (slots < 1) return -1;
  const long long tiles = (long long)((n + tl::BM - 1) / tl::BM) * (dim / tl::BN) * b * L;
  return tl::plan_splits(tiles, slots, padded_keys(n) / tl::BK, max_splits);
}

template <typename T, typename TO>
cudaError_t launch(const void* levels, long long sb, long long sn, long long sl,
                   const int8_t* mask, void* out, float* lse, void* ws, int b, int n, int L,
                   int dim, float scale, int attend_self, int splits, cudaStream_t stream) {
  const T* lv = static_cast<const T*>(levels);
  const int np = padded_keys(n), pairs = b * L;
  const Workspace w = workspace(b, n, L, dim, splits, sizeof(T));
  float* f = static_cast<float*>(ws);
  float* s = f + w.s;
  float* ks = f + w.ks;
  T* vt = reinterpret_cast<T*>(f + w.vt);
  const size_t smem_s = tl::smem_bytes<T, T>(), smem_pv = tl::smem_bytes<float, T>();
  cudaError_t err = glom::allow_smem(logits_kernel<T>, smem_s);
  if (err == cudaSuccess) err = glom::allow_smem(pv_kernel<T, TO>, smem_pv);
  if (err != cudaSuccess) return err;
  const dim3 grid_k(np / KEYS, pairs);
  key_prep_kernel<T><<<grid_k, PREP_THREADS, PREP_SMEM, stream>>>(lv, sb, sn, sl, n, L, dim, np,
                                                                 scale, vt, ks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int row_tiles = (n + tl::BM - 1) / tl::BM;
  const dim3 grid_s(row_tiles * ((np + tl::BN - 1) / tl::BN), pairs);
  logits_kernel<T><<<grid_s, tl::THREADS, smem_s, stream>>>(lv, sb, sn, sl, vt, ks, mask, s, n, L,
                                                            dim, np, attend_self);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)pairs * n;
  const unsigned row_blocks = static_cast<unsigned>((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  softmax_kernel<<<row_blocks, 32 * ROWS_PER_BLOCK, 0, stream>>>(s, lse, rows, np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slabs = np / tl::BK;
  const int per_split = (slabs + splits - 1) / splits;
  splits = (slabs + per_split - 1) / per_split;   // no empty split
  float* partial = splits > 1 ? f + w.partial : nullptr;
  const dim3 grid_pv(row_tiles * (dim / tl::BN), pairs, splits);
  pv_kernel<T, TO><<<grid_pv, tl::THREADS, smem_pv, stream>>>(s, lv, sb, sn, sl, static_cast<TO*>(out),
                                                              partial, n, L, dim, np, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const long long total = (long long)pairs * n * dim;
  const long long blocks = (total / 4 + tl::REDUCE_THREADS - 1) / tl::REDUCE_THREADS;
  sum_splits_kernel<TO><<<static_cast<unsigned>(blocks), tl::REDUCE_THREADS, 0, stream>>>(
      partial, static_cast<TO*>(out), total, splits);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace
}  // namespace cons
}  // namespace glom
