// Pieces of the port's tiled products on the tensor cores (mma.sync
// m16n8k8 on tf32 operands, f32 accumulators; an f32 operand split into
// tf32 hi and lo, common.cuh's split_tf32, and a product taking three
// passes, lo*hi + hi*lo + hi*hi, "3xTF32"), shared by tile_gemm.cuh (K1,
// K7, K8), grouped_ff_bwd.cu (K2, K3) and consensus_bwd.cu (K6): zeroing
// and adding fragment tiles (each slab's product is formed in a zeroed
// fragment and added with an f32 add, since the tensor cores' f32
// accumulation rounds toward zero), vector loads and stores of four or
// eight elements of f32 or bf16, and the copy of a row tile into shared
// memory as f32.
#pragma once

#include "common.cuh"

namespace glom {

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

// Four values to four consecutive elements (8-byte aligned in bf16, 16 in
// f32).
__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float (&v)[4]) {
  store2(o, v[0], v[1]);
  store2(o + 2, v[2], v[3]);
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
