// Grouped feed-forward backward, written by hand for Hopper (sm_90a): two
// kernels, dX and dW, the backward of grouped_ff.cu.
//
// Replaces: glom_tpu/kernels/ff_pallas.py::_backward_fused, its two TPU
// kernels _bwd_dx_kernel (K2) and _bwd_dw_kernel (K3), which share
// _recompute_dh.  Per group g, with pre = X W1 + b1 over a tile of rows:
//     dH  = (dO W2^T) * gelu'(pre)            (recomputed, never stored)
//     dX  = dH W1^T                           (K2: summed over the hidden)
//     dW1 = X^T dH,  db1 = 1^T dH,  dW2 = gelu(pre)^T dO
//                                             (K3: summed over every row)
// with the exact-erf GELU, gelu(z) = z Phi(z), gelu'(z) = Phi(z) + z phi(z).
// x, dO and the weights are f32 or bf16 (all one type); accumulation is
// f32; dX and dW are written in that type.  db2 = sum of dO is a plain
// reduction in the wrapper, as it is in the TPU version.
//
// What bounds them: operations.  At the flagship shapes (d=512, h=2048,
// 2048 rows, 6 groups) dX does 6*d*h FLOPs a row and group (pre, dO W2^T,
// dH W1^T) and dW 8 (pre, dO W2^T, X^T dH, gelu^T dO): 77 and 103 GFLOP on
// ~25 MB of inputs.  The plain PyTorch version writes and reads the (rows,
// g, h) hidden and its gradient through device memory.
//
// What the design does about it:
//  * the products run on the tensor cores through tile_mma.cuh (mma.sync,
//    3xTF32 for f32 operands, one pass for operands that came from bf16);
//  * the hidden never leaves the chip: each block recomputes pre and
//    dO W2^T for its tile in shared memory, as the TPU kernels do;
//  * K2: a block owns 32 rows of one group and walks the whole hidden in
//    chunks of 16.  Its x and dO tiles (f32) stay in shared memory; each
//    chunk's w1 columns and w2 rows are loaded, pre and dO W2^T computed
//    (one 16 x 8 tile a warp, four mma chains each), dH formed, and
//    dH W1^T added into a (32, d) accumulator in the 8 warps' registers.
//    The sum over the hidden stays in one block: no workspace, no atomics;
//  * K3: a block owns 32 hidden units of one group and walks every row in
//    tiles of 16, with its w1 columns and w2 rows resident in shared memory
//    and dW1 (d, 32) and dW2 (32, d) accumulated in registers.  The sum
//    over the rows stays in one block, in a fixed order, so two runs give
//    the same bits;
//  * a 32-row f32 x + dO pair is 132 KB at d=512, so a block takes about
//    217 KB of shared memory and one block runs on an SM.  wgmma, TMA and
//    overlapping the chunk loads with the products are later work.
//
// Layout: x is read through a row stride and a group stride (elements; the
// last dimension contiguous), so the bottom-up input, a strided view of the
// (b, n, L+1, d) state, needs no copy.  dO, w1 (g, d, h), b1 (g, h),
// w2 (g, h, d) and the outputs are contiguous.  d must be a multiple of 128,
// at most 512; h a multiple of 32.

#include <type_traits>

#include "common.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int BM2 = 32;        // dX: rows per block
constexpr int HC2 = 16;        // dX: hidden units per chunk
constexpr int BM3 = 16;        // dW: rows per step
constexpr int HC3 = 32;        // dW: hidden units per block

// Row strides (floats) of the shared tiles, padded so the fragment loads
// of the long products hit distinct banks.
template <int D>
struct DxLayout {
  static constexpr int kRow = D + 4;     // x and dO tiles (BM2, D)
  static constexpr int kW1 = HC2 + 8;    // w1 chunk (D, HC2)
  static constexpr int kW2 = D + 4;      // w2 chunk (HC2, D)
  static constexpr int kT = HC2 + 4;     // pre, then dH; and dO W2^T (BM2, HC2)
  static constexpr size_t kBytes =
      sizeof(float) * (2 * BM2 * kRow + D * kW1 + HC2 * kW2 + 2 * BM2 * kT + HC2);
};

template <int D>
struct DwLayout {
  static constexpr int kRow = D + 4;     // x and dO tiles (BM3, D)
  static constexpr int kW1 = HC3 + 8;    // w1 columns (D, HC3)
  static constexpr int kW2 = D + 4;      // w2 rows (HC3, D)
  static constexpr int kT = HC3 + 4;     // gelu(pre) and dH (BM3, HC3)
  static constexpr size_t kBytes =
      sizeof(float) * (2 * BM3 * kRow + D * kW1 + HC3 * kW2 + 2 * BM3 * kT + HC3);
};

__device__ __forceinline__ void gelu_and_grad(float z, float& g, float& dg) {
  const float cdf = 0.5f * (1.0f + erff(z * 0.70710678118654752440f));
  const float pdf = expf(-0.5f * z * z) * 0.39894228040143267794f;   // 1/sqrt(2 pi)
  g = z * cdf;
  dg = cdf + z * pdf;
}

// Grid (row tiles, groups).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
ff_bwd_dx_kernel(const T* __restrict__ x, long long row_stride, long long group_stride,
                 const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ go, T* __restrict__ dx, int rows, int groups, int hidden) {
  using S = DxLayout<D>;
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr int NT = D / 64;   // n8 tiles in a warp's D/8 output columns
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [BM2][kRow]  x tile
  float* gs = xs + BM2 * S::kRow;                // [BM2][kRow]  dO tile
  float* w1s = gs + BM2 * S::kRow;               // [D][kW1]     w1[:, chunk]
  float* w2s = w1s + D * S::kW1;                 // [HC2][kW2]   w2[chunk, :]
  float* hs = w2s + HC2 * S::kW2;                // [BM2][kT]    pre, then dH
  float* ps = hs + BM2 * S::kT;                  // [BM2][kT]    dO W2^T
  float* b1s = ps + BM2 * S::kT;                 // [HC2]

  const int g = blockIdx.y, row0 = blockIdx.x * BM2;
  const int tid = threadIdx.x, warp = tid >> 5;
  const T* w1g = w1 + (long long)g * D * hidden;
  const T* w2g = w2 + (long long)g * hidden * D;
  const T* b1g = b1 + (long long)g * hidden;

  glom::load_tile<BM2, D, THREADS>(xs, S::kRow, x + g * group_stride, row_stride, row0, rows);
  glom::load_tile<BM2, D, THREADS>(gs, S::kRow, go + (long long)g * D, (long long)groups * D,
                                   row0, rows);

  // pre (warps 0-3) and dO W2^T (warps 4-7): one 16 x 8 tile a warp
  const bool second = warp >= 4;
  const int tm = (warp >> 1) & 1, tn = warp & 1;
  const float* pa = (second ? gs : xs) + tm * 16 * S::kRow;
  // B(k, j) = w1[k, j] for pre; = w2[j, k] for dO W2^T
  const float* pb = second ? w2s + tn * 8 * S::kW2 : w1s + tn * 8;
  const int pbr = second ? 1 : S::kW1, pbc = second ? S::kW2 : 1;
  float* pdst = (second ? ps : hs) + tm * 16 * S::kT + tn * 8;
  // dX: the warp's 32 rows x D/8 columns
  const int n2 = warp * (D / 8);
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int c0 = 0; c0 < hidden; c0 += HC2) {
    __syncthreads();   // every warp is done with the previous chunk (and the tiles are loaded)
    glom::load_tile<D, HC2, THREADS>(w1s, S::kW1, w1g + c0, hidden, 0, D);
    glom::load_tile<HC2, D, THREADS>(w2s, S::kW2, w2g + (long long)c0 * D, D, 0, HC2);
    if (tid < HC2) b1s[tid] = glom::to_f32(b1g[c0 + tid]);
    __syncthreads();
    {
      float t[1][1][4] = {{{0.f, 0.f, 0.f, 0.f}}};
      glom::warp_mma_long<1, 1, kExact, kExact>(t, pa, S::kRow, 1, pb, pbr, pbc, D);
      glom::store_tile(pdst, S::kT, t[0][0]);
    }
    __syncthreads();
    for (int i = tid; i < BM2 * HC2; i += THREADS) {
      const int r = i / HC2, j = i - r * HC2;
      float h, dg;
      gelu_and_grad(hs[r * S::kT + j] + b1s[j], h, dg);
      hs[r * S::kT + j] = ps[r * S::kT + j] * dg;   // dH
    }
    __syncthreads();
    // dX += dH @ w1[:, chunk]^T: B(j, col) = w1s[col * kW1 + j]
    glom::warp_mma<2, NT, HC2, false, kExact>(acc, hs, S::kT, 1, w1s + n2 * S::kW1, 1, S::kW1);
  }

  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + mt * 16 + gid + 8 * half;
      if (row >= rows) continue;
      T* o = dx + ((long long)row * groups + g) * D + n2 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        glom::store2(o + nt * 8, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
}

// Grid (hidden / HC3, groups).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
ff_bwd_dw_kernel(const T* __restrict__ x, long long row_stride, long long group_stride,
                 const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ go, T* __restrict__ dw1, T* __restrict__ db1,
                 T* __restrict__ dw2, int rows, int groups, int hidden) {
  using S = DwLayout<D>;
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr int MT1 = D / 128;   // dW1: m16 tiles in a warp's D/8 rows
  constexpr int NT2 = D / 64;    // dW2: n8 tiles in a warp's D/8 columns
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [BM3][kRow]  x tile
  float* gs = xs + BM3 * S::kRow;                // [BM3][kRow]  dO tile
  float* w1s = gs + BM3 * S::kRow;               // [D][kW1]     w1[:, h0 : h0 + HC3]
  float* w2s = w1s + D * S::kW1;                 // [HC3][kW2]   w2[h0 : h0 + HC3, :]
  float* hs = w2s + HC3 * S::kW2;                // [BM3][kT]    pre, then gelu(pre)
  float* ds = hs + BM3 * S::kT;                  // [BM3][kT]    dO W2^T, then dH
  float* b1s = ds + BM3 * S::kT;                 // [HC3]

  const int g = blockIdx.y, h0 = blockIdx.x * HC3;
  const int tid = threadIdx.x, warp = tid >> 5;
  const T* w1g = w1 + (long long)g * D * hidden;
  const T* w2g = w2 + (long long)g * hidden * D;

  glom::load_tile<D, HC3, THREADS>(w1s, S::kW1, w1g + h0, hidden, 0, D);
  glom::load_tile<HC3, D, THREADS>(w2s, S::kW2, w2g + (long long)h0 * D, D, 0, HC3);
  if (tid < HC3) b1s[tid] = glom::to_f32(b1[(long long)g * hidden + h0 + tid]);

  // pre (warps 0-3) and dO W2^T (warps 4-7): one 16 x 8 tile a warp
  const bool second = warp >= 4;
  const int tn = warp & 3;
  const float* pa = second ? gs : xs;
  const float* pb = second ? w2s + tn * 8 * S::kW2 : w1s + tn * 8;
  const int pbr = second ? 1 : S::kW1, pbc = second ? S::kW2 : 1;
  float* pdst = (second ? ds : hs) + tn * 8;
  // dW1: the warp's D/8 rows x HC3; dW2: HC3 rows x the warp's D/8 columns
  const int m1 = warp * (D / 8), n2 = warp * (D / 8);
  float a1[MT1][4][4], a2[2][NT2][4];
#pragma unroll
  for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) a1[mt][nt][e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) a2[mt][nt][e] = 0.f;
  float db = 0.f;   // thread tid < HC3: the sum of dH over rows, column tid

  for (int row0 = 0; row0 < rows; row0 += BM3) {
    __syncthreads();   // every warp is done with the previous row tile (and the weights are loaded)
    glom::load_tile<BM3, D, THREADS>(xs, S::kRow, x + g * group_stride, row_stride, row0, rows);
    glom::load_tile<BM3, D, THREADS>(gs, S::kRow, go + (long long)g * D, (long long)groups * D,
                                     row0, rows);
    __syncthreads();
    {
      float t[1][1][4] = {{{0.f, 0.f, 0.f, 0.f}}};
      glom::warp_mma_long<1, 1, kExact, kExact>(t, pa, S::kRow, 1, pb, pbr, pbc, D);
      glom::store_tile(pdst, S::kT, t[0][0]);
    }
    __syncthreads();
    for (int i = tid; i < BM3 * HC3; i += THREADS) {
      const int r = i / HC3, j = i - r * HC3;
      float h, dg;
      gelu_and_grad(hs[r * S::kT + j] + b1s[j], h, dg);
      const bool live = row0 + r < rows;   // a padding row adds nothing
      hs[r * S::kT + j] = live ? h : 0.f;
      ds[r * S::kT + j] = live ? ds[r * S::kT + j] * dg : 0.f;
    }
    __syncthreads();
    if (tid < HC3) {
#pragma unroll
      for (int r = 0; r < BM3; ++r) db += ds[r * S::kT + tid];
    }
    // dW1 += x^T dH: A(k, row) = xs[row * kRow + k]; B(row, j) = ds[row * kT + j]
    glom::warp_mma<MT1, 4, BM3, kExact, false>(a1, xs + m1, 1, S::kRow, ds, S::kT, 1);
    // dW2 += gelu(pre)^T dO: A(j, row) = hs[row * kT + j]; B(row, col) = gs[row * kRow + col]
    glom::warp_mma<2, NT2, BM3, false, kExact>(a2, hs, 1, S::kT, gs + n2, S::kRow, 1);
  }

  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = m1 + mt * 16 + gid + 8 * half;
      T* o = dw1 + ((long long)g * D + k) * hidden + h0 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        glom::store2(o + nt * 8, a1[mt][nt][2 * half], a1[mt][nt][2 * half + 1]);
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = mt * 16 + gid + 8 * half;
      T* o = dw2 + ((long long)g * hidden + h0 + j) * D + n2 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt)
        glom::store2(o + nt * 8, a2[mt][nt][2 * half], a2[mt][nt][2 * half + 1]);
    }
  if (tid < HC3) db1[(long long)g * hidden + h0 + tid] = glom::from_f32<T>(db);
}

template <typename T, int D>
cudaError_t launch_dx(const void* x, long long row_stride, long long group_stride, const void* w1,
                      const void* b1, const void* w2, const void* go, void* dx, int rows,
                      int groups, int hidden, cudaStream_t stream) {
  const size_t smem = DxLayout<D>::kBytes;
  cudaError_t err = glom::allow_smem(ff_bwd_dx_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + BM2 - 1) / BM2, groups);
  ff_bwd_dx_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), row_stride, group_stride, static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(go),
      static_cast<T*>(dx), rows, groups, hidden);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dw(const void* x, long long row_stride, long long group_stride, const void* w1,
                      const void* b1, const void* w2, const void* go, void* dw1, void* db1,
                      void* dw2, int rows, int groups, int hidden, cudaStream_t stream) {
  const size_t smem = DwLayout<D>::kBytes;
  cudaError_t err = glom::allow_smem(ff_bwd_dw_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(hidden / HC3, groups);
  ff_bwd_dw_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), row_stride, group_stride, static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(go),
      static_cast<T*>(dw1), static_cast<T*>(db1), static_cast<T*>(dw2), rows, groups, hidden);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dx(int dim, const void* x, long long rs, long long gs, const void* w1,
                        const void* b1, const void* w2, const void* go, void* dx, int rows,
                        int groups, int hidden, cudaStream_t s) {
  switch (dim) {
    case 128: return launch_dx<T, 128>(x, rs, gs, w1, b1, w2, go, dx, rows, groups, hidden, s);
    case 256: return launch_dx<T, 256>(x, rs, gs, w1, b1, w2, go, dx, rows, groups, hidden, s);
    case 384: return launch_dx<T, 384>(x, rs, gs, w1, b1, w2, go, dx, rows, groups, hidden, s);
    case 512: return launch_dx<T, 512>(x, rs, gs, w1, b1, w2, go, dx, rows, groups, hidden, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dw(int dim, const void* x, long long rs, long long gs, const void* w1,
                        const void* b1, const void* w2, const void* go, void* dw1, void* db1,
                        void* dw2, int rows, int groups, int hidden, cudaStream_t s) {
  switch (dim) {
    case 128: return launch_dw<T, 128>(x, rs, gs, w1, b1, w2, go, dw1, db1, dw2, rows, groups, hidden, s);
    case 256: return launch_dw<T, 256>(x, rs, gs, w1, b1, w2, go, dw1, db1, dw2, rows, groups, hidden, s);
    case 384: return launch_dw<T, 384>(x, rs, gs, w1, b1, w2, go, dw1, db1, dw2, rows, groups, hidden, s);
    case 512: return launch_dw<T, 512>(x, rs, gs, w1, b1, w2, go, dw1, db1, dw2, rows, groups, hidden, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int rows, int groups, int dim, int hidden) {
  return dim % 128 == 0 && dim >= 128 && dim <= 512 && hidden % HC3 == 0 && hidden >= HC3 &&
         rows >= 1 && groups >= 1 && groups <= 65535;
}

}  // namespace

// K2.  x: (rows, groups, dim) read through row_stride / group_stride
// (elements); w1 (groups, dim, hidden), b1 (groups, hidden), w2 (groups,
// hidden, dim), go = dO and dx (rows, groups, dim): contiguous, all of one
// dtype.  Returns the launch's cudaError_t.
extern "C" int glom_grouped_ff_bwd_dx(const void* x, long long row_stride, long long group_stride,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* go, void* dx, int rows, int groups, int dim,
                                      int hidden, int dtype, void* stream) {
  if (!valid(rows, groups, dim, hidden)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return dispatch_dx<float>(dim, x, row_stride, group_stride, w1, b1, w2, go, dx, rows, groups, hidden, s);
  if (dtype == glom::kBF16)
    return dispatch_dx<__nv_bfloat16>(dim, x, row_stride, group_stride, w1, b1, w2, go, dx, rows, groups, hidden, s);
  return cudaErrorInvalidValue;
}

// K3.  As K2's arguments; dw1 (groups, dim, hidden), db1 (groups, hidden),
// dw2 (groups, hidden, dim): contiguous, the inputs' dtype.
extern "C" int glom_grouped_ff_bwd_dw(const void* x, long long row_stride, long long group_stride,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* go, void* dw1, void* db1, void* dw2, int rows,
                                      int groups, int dim, int hidden, int dtype, void* stream) {
  if (!valid(rows, groups, dim, hidden)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return dispatch_dw<float>(dim, x, row_stride, group_stride, w1, b1, w2, go, dw1, db1, dw2, rows, groups, hidden, s);
  if (dtype == glom::kBF16)
    return dispatch_dw<__nv_bfloat16>(dim, x, row_stride, group_stride, w1, b1, w2, go, dw1, db1, dw2, rows, groups, hidden, s);
  return cudaErrorInvalidValue;
}
