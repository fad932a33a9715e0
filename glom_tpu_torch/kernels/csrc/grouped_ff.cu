// Grouped feed-forward forward, written by hand for Hopper (sm_90a).
//
// Replaces: glom_tpu/kernels/ff_pallas.py::_forward (the TPU kernel body
// `_kernel`).  Per group g and row r of the flattened (b*n) axis:
//     out[r, g] = gelu(x[r, g] @ w1[g] + b1[g]) @ w2[g] + b2[g]
// with the exact-erf GELU, f32 or bf16 inputs and f32 accumulation.
//
// What bounds it: operations.  At the flagship shapes (d=512, h=2048,
// 2048 rows a call at batch 8) a call does 4*d*h FLOPs per row and group,
// about 130 FLOPs for every byte it must move.  The plain PyTorch version
// also writes and reads the (rows, g, h) hidden through device memory,
// four times the size of the output.
//
// What the design does about it:
//  * the products run on the tensor cores (mma.sync m16n8k8, tf32 inputs,
//    f32 accumulators).  An f32 operand is split into two tf32 parts,
//    v = hi + lo, and a product takes three passes, lo*hi + hi*lo + hi*hi
//    (the "3xTF32" scheme): the dropped lo*lo term is below f32 rounding,
//    so an f32 call matches the f32 plain version to ~1e-5 (the tensor
//    cores' own f32 accumulation rounds toward zero) while the tensor cores
//    do the work.  A bf16 value is exact in tf32 (lo = 0), so with bf16
//    inputs x @ w1 takes one pass and hidden @ w2 two.  The split is two
//    integer operations and a subtraction, not conversions, which run at a
//    quarter of the rate.
//  * the hidden never leaves the chip.  A block owns a tile of 64 rows of
//    one group and walks its share of the hidden dimension in chunks of 64:
//    it computes gelu(x_tile @ w1[:, chunk] + b1) into shared memory, then
//    adds that chunk's product with w2[chunk, :] into a (64, d) f32
//    accumulator held in the registers of its 8 warps (each warp 32 rows x
//    d/4 columns).  Only x, the weights and the output cross device memory.
//  * the x tile is converted to f32 once and stays in shared memory for
//    every chunk.  The weights stream through a two-stage ring of slabs
//    (64 rows of w1's chunk, or 8 rows of w2) copied with cp.async, so the
//    next slab's copy overlaps this slab's products.
//  * a block needs about 182 KB of shared memory at d=512, so one block runs
//    on an SM, and a call has few tiles at small batch (24 at b=1).  The
//    hidden dimension is therefore split over `splits` blocks per tile
//    (glom_grouped_ff_splits picks the count that fills the card in the
//    fewest chunk-times); each writes its partial (64, d) sum to an f32
//    workspace, and a second, elementwise kernel adds the partials in a
//    fixed order with b2, so the result does not depend on timing.  With
//    one split the block writes the output itself.
//  * rows of the shared tiles are padded (x and hidden by 4 floats, weight
//    slabs by 8 elements) so every fragment load of a warp hits 32
//    distinct banks.  wgmma, TMA and warp specialisation are later work.
//
// Layout: x is read through a row stride and a group stride (elements; the
// last dimension contiguous), so the bottom-up input, a strided view of the
// (b, n, L+1, d) state, needs no copy.  w1, b1, w2, b2 and out are
// contiguous; w1 and w2 start on a 16-byte boundary (cp.async).
// d must be a multiple of 128, at most 512; h a multiple of 64.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 64;         // rows per block
constexpr int HC = 64;         // hidden chunk
constexpr int KS = 64;         // rows (of d) of a w1 slab
constexpr int VS = 8;          // rows (of the chunk) of a w2 slab: one k8 step
constexpr int THREADS = 256;   // 8 warps
constexpr int XP = 4;          // row pad of the x and hidden tiles (floats)
constexpr int WP = 8;          // row pad of a weight slab (elements)
constexpr int REDUCE_THREADS = 256;

template <typename T, int D>
struct Layout {
  static constexpr int kXStride = D + XP;
  static constexpr int kHStride = HC + XP;
  static constexpr int kW1Stride = HC + WP;
  static constexpr int kW2Stride = D + WP;
  // one stage of the weight ring holds a w1 slab or a w2 slab (elements of T)
  static constexpr int kStage =
      KS * kW1Stride > VS * kW2Stride ? KS * kW1Stride : VS * kW2Stride;
  static constexpr size_t kBytes = sizeof(float) * (BM * kXStride + BM * kHStride) +
                                   sizeof(T) * 2 * kStage;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

// Start the copy of slab s of the block's weight stream into its ring
// stage.  The stream is, for each hidden chunk c0, c0+1, ..., D/KS slabs of
// w1's chunk columns, then HC/VS slabs of w2's chunk rows.
template <typename T, int D>
__device__ __forceinline__ void issue_slab(int s, int c0, T* ring, const T* w1g, const T* w2g,
                                           int hidden, int tid) {
  using S = Layout<T, D>;
  constexpr int N1 = D / KS, N2 = HC / VS;
  constexpr int E = 16 / sizeof(T);   // elements a 16-byte copy moves
  const int c = c0 + s / (N1 + N2), j = s % (N1 + N2);
  T* dst = ring + (s & 1) * S::kStage;
  if (j < N1) {
    const T* src = w1g + (long long)(j * KS) * hidden + c * HC;
    constexpr int PER_ROW = HC / E;
    for (int i = tid; i < KS * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, q = i - r * PER_ROW;
      glom::cp_async16(dst + r * S::kW1Stride + q * E, src + (long long)r * hidden + q * E);
    }
  } else {
    const T* src = w2g + (long long)(c * HC + (j - N1) * VS) * D;
    constexpr int PER_ROW = D / E;
    for (int i = tid; i < VS * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, q = i - r * PER_ROW;
      glom::cp_async16(dst + r * S::kW2Stride + q * E, src + (long long)r * D + q * E);
    }
  }
  glom::cp_async_commit();
}

// Grid (row tiles, groups, splits).  Split z covers hidden chunks
// [z * per_split, min((z + 1) * per_split, hidden / HC)).  With ws null the
// block writes out (+ b2); otherwise its partial sum goes to
// ws[z] (rows, groups, D), f32.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
grouped_ff_kernel(const T* __restrict__ x, long long row_stride, long long group_stride,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ b2,
                  T* __restrict__ out, float* __restrict__ ws, int rows, int groups,
                  int hidden, int per_split) {
  using S = Layout<T, D>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int N1 = D / KS, N2 = HC / VS;
  constexpr int NT = D / 32;   // n8 tiles in a warp's d/4 output columns
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [BM][kXStride]  x tile, f32
  float* hs = xs + BM * S::kXStride;             // [BM][kHStride]  gelu(hidden chunk)
  T* ring = reinterpret_cast<T*>(hs + BM * S::kHStride);   // 2 stages of weight slabs

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int c0 = blockIdx.z * per_split;
  const int chunks = min(per_split, hidden / HC - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const T* w1g = w1 + (long long)g * D * hidden;
  const T* w2g = w2 + (long long)g * hidden * D;
  const T* b1g = b1 + (long long)g * hidden;
  const int steps = chunks * (N1 + N2);

  if (steps > 0) issue_slab<T, D>(0, c0, ring, w1g, w2g, hidden, tid);
  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, k = i - r * D;
    const int row = row0 + r;
    xs[r * S::kXStride + k] =
        row < rows ? glom::to_f32(x[row * row_stride + g * group_stride + k]) : 0.f;
  }

  // x @ w1: the warp's 16 rows x 32 hidden columns of the chunk, the hi*hi
  // products in pre and the lo terms in pre_lo (two chains, more in flight)
  const int m1 = (warp & 3) * 16, n1 = (warp >> 2) * 32;
  // hidden @ w2: the warp's 32 rows x d/4 output columns
  const int m2 = (warp & 1) * 32, n2 = (warp >> 1) * (D / 4);
  float pre[4][4], pre_lo[4][4];
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    glom::cp_async_wait_all();
    __syncthreads();   // slab s has landed, and every warp is done with slab s-1
    if (s + 1 < steps) issue_slab<T, D>(s + 1, c0, ring, w1g, w2g, hidden, tid);
    const int c = c0 + s / (N1 + N2), j = s % (N1 + N2);
    const T* wsl = ring + (s & 1) * S::kStage;
    if (j < N1) {
      if (j == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pre[nt][e] = pre_lo[nt][e] = 0.f;
      }
#pragma unroll 2
      for (int kk = 0; kk < KS; kk += 8) {
        const float* ap = xs + (m1 + gid) * S::kXStride + j * KS + kk + tig;
        const float av[4] = {ap[0], ap[8 * S::kXStride], ap[4], ap[8 * S::kXStride + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kF32) glom::split_tf32(av[e], ahi[e], alo[e]);
          else ahi[e] = __float_as_uint(av[e]);   // a bf16 value is exact in tf32
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const T* bp = wsl + (kk + tig) * S::kW1Stride + n1 + nt * 8 + gid;
          const float bv[2] = {glom::to_f32(bp[0]), glom::to_f32(bp[4 * S::kW1Stride])};
          uint32_t bhi[2], blo[2];
          if constexpr (kF32) {
            glom::split_tf32(bv[0], bhi[0], blo[0]);
            glom::split_tf32(bv[1], bhi[1], blo[1]);
            glom::mma_tf32(pre_lo[nt], alo, bhi);
            glom::mma_tf32(pre_lo[nt], ahi, blo);
          } else {
            bhi[0] = __float_as_uint(bv[0]);
            bhi[1] = __float_as_uint(bv[1]);
          }
          glom::mma_tf32(pre[nt], ahi, bhi);
        }
      }
      if (j == N1 - 1) {
        // the chunk's hidden: bias and GELU, into shared memory for hidden @ w2
        // (the next step's __syncthreads publishes it to the other warps)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n1 + nt * 8 + 2 * tig;
          const float bias0 = glom::to_f32(b1g[c * HC + col]);
          const float bias1 = glom::to_f32(b1g[c * HC + col + 1]);
          float* h0 = hs + (m1 + gid) * S::kHStride + col;
          h0[0] = gelu(pre[nt][0] + pre_lo[nt][0] + bias0);
          h0[1] = gelu(pre[nt][1] + pre_lo[nt][1] + bias1);
          h0[8 * S::kHStride] = gelu(pre[nt][2] + pre_lo[nt][2] + bias0);
          h0[8 * S::kHStride + 1] = gelu(pre[nt][3] + pre_lo[nt][3] + bias1);
        }
      }
    } else {
      // one k8 step of hidden @ w2: chunk rows (j - N1) * VS .. + 8
      const int k = (j - N1) * VS;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = hs + (m2 + mt * 16 + gid) * S::kHStride + k + tig;
        glom::split_tf32(ap[0], ahi[mt][0], alo[mt][0]);
        glom::split_tf32(ap[8 * S::kHStride], ahi[mt][1], alo[mt][1]);
        glom::split_tf32(ap[4], ahi[mt][2], alo[mt][2]);
        glom::split_tf32(ap[8 * S::kHStride + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* bp = wsl + tig * S::kW2Stride + n2 + nt * 8 + gid;
        const float bv[2] = {glom::to_f32(bp[0]), glom::to_f32(bp[4 * S::kW2Stride])};
        uint32_t bhi[2], blo[2];
        if constexpr (kF32) {
          glom::split_tf32(bv[0], bhi[0], blo[0]);
          glom::split_tf32(bv[1], bhi[1], blo[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) glom::mma_tf32(acc[mt][nt], ahi[mt], blo);
        } else {
          bhi[0] = __float_as_uint(bv[0]);
          bhi[1] = __float_as_uint(bv[1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          glom::mma_tf32(acc[mt][nt], alo[mt], bhi);
          glom::mma_tf32(acc[mt][nt], ahi[mt], bhi);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n2 + nt * 8 + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + m2 + mt * 16 + gid + 8 * half;
        if (row >= rows) continue;
        const long long o = ((long long)row * groups + g) * D + col;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (ws == nullptr) {
          glom::store2(out + o, v0 + glom::to_f32(b2[g * D + col]), v1 + glom::to_f32(b2[g * D + col + 1]));
        } else {
          glom::store2(ws + (long long)blockIdx.z * rows * groups * D + o, v0, v1);
        }
      }
    }
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

template <typename T, int D>
cudaError_t launch(const void* x, long long row_stride, long long group_stride,
                   const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, void* ws, int rows, int groups, int hidden, int splits,
                   cudaStream_t stream) {
  const size_t smem = Layout<T, D>::kBytes;
  cudaError_t err = glom::allow_smem(grouped_ff_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = hidden / HC;
  const int per_split = (chunks + splits - 1) / splits;
  splits = (chunks + per_split - 1) / per_split;   // no empty split
  float* partial = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const dim3 grid((rows + BM - 1) / BM, groups, splits);
  grouped_ff_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), row_stride, group_stride, static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(out), partial, rows, groups, hidden, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const long long total = (long long)rows * groups * D;
  const long long blocks = (total / 4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  reduce_splits_kernel<T><<<static_cast<unsigned>(blocks), REDUCE_THREADS, 0, stream>>>(
      partial, static_cast<const T*>(b2), static_cast<T*>(out), total, groups, D, splits);
  return cudaGetLastError();
}

// How many blocks of the kernel for (T, D) an SM runs at once.
template <typename T, int D>
int blocks_per_sm() {
  const size_t smem = Layout<T, D>::kBytes;
  if (glom::allow_smem(grouped_ff_kernel<T, D>, smem) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, grouped_ff_kernel<T, D>, THREADS, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

template <typename T>
cudaError_t dispatch(int dim, const void* x, long long row_stride, long long group_stride,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     void* out, void* ws, int rows, int groups, int hidden, int splits,
                     cudaStream_t stream) {
  switch (dim) {
    case 128: return launch<T, 128>(x, row_stride, group_stride, w1, b1, w2, b2, out, ws, rows, groups, hidden, splits, stream);
    case 256: return launch<T, 256>(x, row_stride, group_stride, w1, b1, w2, b2, out, ws, rows, groups, hidden, splits, stream);
    case 384: return launch<T, 384>(x, row_stride, group_stride, w1, b1, w2, b2, out, ws, rows, groups, hidden, splits, stream);
    case 512: return launch<T, 512>(x, row_stride, group_stride, w1, b1, w2, b2, out, ws, rows, groups, hidden, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy(int dim) {
  switch (dim) {
    case 128: return blocks_per_sm<T, 128>();
    case 256: return blocks_per_sm<T, 256>();
    case 384: return blocks_per_sm<T, 384>();
    case 512: return blocks_per_sm<T, 512>();
    default: return -1;
  }
}

bool valid(int rows, int groups, int dim, int hidden) {
  return dim % 128 == 0 && dim >= 128 && dim <= 512 && hidden % HC == 0 && hidden >= HC &&
         rows >= 1 && groups >= 1 && groups <= 65535;
}

}  // namespace

// The number of hidden splits a call should use: the count that runs the
// call's (row tile, split) blocks on the current device's SMs in the fewest
// chunk-times (waves x chunks a block), the fewest splits on a tie.  A split
// covers at least 4 chunks (256 hidden units), so the workspace's traffic
// stays small beside the products.  It needs no workspace when it returns
// 1; otherwise the caller passes an f32 workspace of
// splits * rows * groups * dim.  Returns -1 on bad arguments or a CUDA error.
extern "C" int glom_grouped_ff_splits(int rows, int groups, int dim, int hidden, int dtype) {
  if (!valid(rows, groups, dim, hidden)) return -1;
  const int per_sm = dtype == glom::kF32 ? occupancy<float>(dim)
                     : dtype == glom::kBF16 ? occupancy<__nv_bfloat16>(dim) : -1;
  int device = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const long long slots = (long long)sms * per_sm;
  const long long tiles = (long long)((rows + BM - 1) / BM) * groups;
  const int chunks = hidden / HC;
  const int min_per_split = chunks < 4 ? chunks : 4;
  int best = 1;
  long long best_cost = -1;
  for (int per_split = chunks; per_split >= min_per_split; --per_split) {
    const int splits = (chunks + per_split - 1) / per_split;
    const long long waves = (tiles * splits + slots - 1) / slots;
    const long long cost = waves * per_split;
    if (best_cost < 0 || cost < best_cost) best = splits, best_cost = cost;
  }
  return best;
}

// x: (rows, groups, dim) read through row_stride / group_stride (elements);
// w1 (groups, dim, hidden), b1 (groups, hidden), w2 (groups, hidden, dim),
// b2 (groups, dim), out (rows, groups, dim): contiguous, all of one dtype;
// w1 and w2 16-byte aligned.  ws: with splits > 1, an f32 workspace of
// splits * rows * groups * dim, 16-byte aligned; unused with one split.
// Returns the launches' cudaError_t.
extern "C" int glom_grouped_ff(const void* x, long long row_stride, long long group_stride,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, void* ws, int rows, int groups,
                               int dim, int hidden, int splits, int dtype, void* stream) {
  if (!valid(rows, groups, dim, hidden) || splits < 1 || (splits > 1 && ws == nullptr) ||
      reinterpret_cast<uintptr_t>(w1) % 16 != 0 || reinterpret_cast<uintptr_t>(w2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return dispatch<float>(dim, x, row_stride, group_stride, w1, b1, w2, b2, out, ws, rows, groups, hidden, splits, s);
  if (dtype == glom::kBF16)
    return dispatch<__nv_bfloat16>(dim, x, row_stride, group_stride, w1, b1, w2, b2, out, ws, rows, groups, hidden, splits, s);
  return cudaErrorInvalidValue;
}
