// Warp-level products of f32 tiles in shared memory on the tensor cores,
// for the backward kernels (grouped_ff_bwd.cu, consensus_bwd.cu), and the
// pieces of the tiled products of tile_gemm.cuh (K1, K8) and
// grouped_ff_bwd.cu's K3.
//
// Each product is mma.sync m16n8k8 on tf32 operands with f32 accumulators.
// An f32 operand is split into two tf32 parts, v = hi + lo (common.cuh's
// split_tf32), and a product takes three passes, lo*hi + hi*lo + hi*hi
// ("3xTF32"), so f32 calls keep f32 accuracy.  An operand whose values came
// from bf16 is exact in tf32 (lo = 0): marking it EXACT skips its pass.
//
// Operands are addressed through a row and a column stride, so a transposed
// operand (X^T, P^T) is the same tile read the other way:
//     A(r, k) = a[r * ars + k * acs],   B(k, c) = b[k * brs + c * bcs].
// `a` points at the warp's first row, `b` at its first column.  A is f32; B
// is f32 or, for a weight slab copied as it lies in device memory, bf16.
#pragma once

#include "common.cuh"

namespace glom {

// The A fragment of rows [16 mt, 16 mt + 16) at depth k (common.cuh's
// fragment layout), split into tf32 hi and lo parts.
template <bool EXACT>
__device__ __forceinline__ void load_a(const float* a, int ars, int acs, int k, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* ap = a + gid * ars + (k + tig) * acs;
  const float v[4] = {ap[0], ap[8 * ars], ap[4 * acs], ap[8 * ars + 4 * acs]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (EXACT) {
      hi[e] = __float_as_uint(v[e]);
      lo[e] = 0u;
    } else {
      split_tf32(v[e], hi[e], lo[e]);
    }
  }
}

// The B fragment of columns [8 nt, 8 nt + 8) at depth k.
template <bool EXACT, typename TB>
__device__ __forceinline__ void load_b(const TB* b, int brs, int bcs, int k, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const TB* bp = b + (k + tig) * brs + gid * bcs;
  const float v[2] = {to_f32(bp[0]), to_f32(bp[4 * brs])};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (EXACT) {
      hi[e] = __float_as_uint(v[e]);
      lo[e] = 0u;
    } else {
      split_tf32(v[e], hi[e], lo[e]);
    }
  }
}

// c[mt][nt] (16 x 8 tiles; MT x NT of them) += A @ B over depth K, a
// multiple of 8.  For products with many tiles a warp and a short depth
// that a kernel sums into c over many steps (a row tile, a hidden chunk, a
// key or query block each).  The tensor cores' f32 accumulation rounds
// toward zero, so hundreds of steps accumulated inside the mma would bias a
// long sum (7e-4 on a K3 dW1 entry of the flagship shapes); instead each
// tile's product over a depth of 16 is formed in a zeroed fragment and
// added to c with an f32 add, which rounds to nearest.
template <int MT, int NT, int K, bool EXACT_A, bool EXACT_B, typename TB>
__device__ __forceinline__ void warp_mma(float (&c)[MT][NT][4], const float* a, int ars, int acs,
                                         const TB* b, int brs, int bcs) {
  static_assert(K % 16 == 0, "depth must be a multiple of 16");
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
        load_a<EXACT_A>(a + mt * 16 * ars, ars, acs, k0 + 8 * s, ahi[s], alo[s]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t bhi[2], blo[2];
          load_b<EXACT_B>(b + nt * 8 * bcs, brs, bcs, k0 + 8 * s, bhi, blo);
          if (!EXACT_B) mma_tf32(t, ahi[s], blo);
          if (!EXACT_A) mma_tf32(t, alo[s], bhi);
          mma_tf32(t, ahi[s], bhi);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] += t[e];
      }
    }
  }
}

// As warp_mma, for products with few tiles a warp and a long depth K (a
// multiple of 16): the even and odd k8 steps, and the hi*hi pass apart from
// the lo passes, go to four accumulator sets, so four chains of dependent
// mma are in flight instead of one.  They are added into c at the end.
template <int MT, int NT, bool EXACT_A, bool EXACT_B, typename TB>
__device__ __forceinline__ void warp_mma_long(float (&c)[MT][NT][4], const float* a, int ars,
                                              int acs, const TB* b, int brs, int bcs, int K) {
  float hi[2][MT][NT][4], lo[2][MT][NT][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[s][mt][nt][e] = lo[s][mt][nt][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = k0 + 8 * s;
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a<EXACT_A>(a + mt * 16 * ars, ars, acs, k, ahi[mt], alo[mt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bhi[2], blo[2];
        load_b<EXACT_B>(b + nt * 8 * bcs, brs, bcs, k, bhi, blo);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!EXACT_B) mma_tf32(lo[s][mt][nt], ahi[mt], blo);
          if (!EXACT_A) mma_tf32(lo[s][mt][nt], alo[mt], bhi);
          mma_tf32(hi[s][mt][nt], ahi[mt], bhi);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c[mt][nt][e] += (hi[0][mt][nt][e] + hi[1][mt][nt][e]) + (lo[0][mt][nt][e] + lo[1][mt][nt][e]);
}

// Store a warp's 16 x 8 tile t (fragment layout) into a row-major f32 tile
// in shared memory; `dst` points at the tile's first element.
__device__ __forceinline__ void store_tile(float* dst, int stride, const float (&t)[4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float* p = dst + gid * stride + 2 * tig;
  p[0] = t[0];
  p[1] = t[1];
  p[8 * stride] = t[2];
  p[8 * stride + 1] = t[3];
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

// Four consecutive elements as one vector load: 16 bytes of f32, 8 of bf16.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 to_f32x4(float4 v) { return v; }
__device__ __forceinline__ float4 to_f32x4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four consecutive elements of a slab in shared memory as f32: 16 bytes of
// f32, 8 of bf16.
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return to_f32x4(*reinterpret_cast<const uint2*>(p));
}

// Eight values to eight consecutive elements (16-byte aligned).
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

// Eight consecutive elements as f32 (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const float4 a = to_f32x4(make_uint2(u.x, u.y)), b = to_f32x4(make_uint2(u.z, u.w));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The largest divisor of n that is at most 8.
__host__ __device__ constexpr int batch_of(int n) {
  int b = n < 8 ? n : 8;
  while (n % b != 0) --b;
  return b;
}

// Load rows [row0, row0 + ROWS) of a (rows, COLS) matrix, row r at src + r
// * row_stride (elements, each row contiguous), as f32 into a shared tile of
// row stride `stride` (a multiple of 4); rows past `rows` are zero.  Each
// thread issues up to 8 vector loads before it stores any, so a tile costs
// one trip to L2, not one a element.  src and row_stride must keep every
// row on a vector boundary (16 bytes for f32, 8 for bf16; the wrappers
// check it).
template <int ROWS, int COLS, int THREADS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* __restrict__ src,
                                          long long row_stride, int row0, int rows) {
  using V = typename Vec4<T>::type;
  constexpr int PER_ROW = COLS / 4, TOTAL = ROWS * PER_ROW / THREADS;
  constexpr int BATCH = batch_of(TOTAL);
  static_assert(COLS % 4 == 0 && ROWS * PER_ROW % THREADS == 0,
                "a tile must split evenly into the block's vector loads");
#pragma unroll
  for (int b0 = 0; b0 < TOTAL; b0 += BATCH) {
    V v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (b0 + u) * THREADS, r = i / PER_ROW, q = i - r * PER_ROW;
      const int row = row0 + r;
      if (row < rows)
        v[u] = *reinterpret_cast<const V*>(src + (long long)row * row_stride + 4 * q);
      else
        v[u] = V{};
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (b0 + u) * THREADS, r = i / PER_ROW, q = i - r * PER_ROW;
      *reinterpret_cast<float4*>(dst + r * stride + 4 * q) = to_f32x4(v[u]);
    }
  }
}

}  // namespace glom
