// Helpers shared by the port's kernels: element types, warp reductions,
// and the error-string export every kernel library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace glom {

// Element types a kernel takes; the Python wrappers pass the same codes.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// v = hi + lo for 3xTF32 products on the tensor cores.  hi is v rounded to
// tf32 (10 mantissa bits, ties away from zero) with the low 13 bits
// cleared; lo = v - hi is exact in f32, and the tensor cores read only its
// top 19 bits.  Two integer operations and a subtraction: cvt.rna.tf32.f32
// runs at a quarter of their rate.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// The same split in two operations, for operands that go straight to the
// tensor cores: hi is v's own bits, since an mma reads only the top 19 bits
// of a tf32 operand (the low 13 are ignored, as if cleared), and lo = v - hi
// with those bits cleared, exact in f32.  hi is v truncated, not rounded,
// so |lo| < 2^-10 |v| instead of 2^-11 |v|; the three passes lose about
// one bit more than split_tf32's.
__device__ __forceinline__ void split_tf32_trunc(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v);
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u));
}

// c += a @ b for one m16n8k8 tile on the tensor cores: a row-major 16x8,
// b col-major 8x8, tf32 inputs, f32 accumulators.  Fragments (g = lane / 4,
// t = lane % 4): a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 16-byte asynchronous copy from device to shared memory (both 16-byte
// aligned), the group's commit, and the wait for every group committed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// As cp_async16, but with `valid` false the 16 bytes are zero and nothing
// is read (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of the groups committed are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a @ b for one m16n8k16 tile on the tensor cores: bf16 inputs, f32
// accumulators.  Each register holds two bf16, the lower column (of a) or
// row (of b) in its low half: a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}; c as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, one 16-byte
// row per lane address (lanes 8m .. 8m+7 give matrix m's rows): lane l gets
// the 32-bit word l % 4 of row l / 4 of each matrix (with `trans`, the pair
// of rows 2 (l % 4), 2 (l % 4) + 1 at column l / 4).  On 32-bit data a
// matrix is 8 rows of 4 elements, and lane l gets element (l / 4, l % 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.  Called
// before every launch: the attribute is per function, and setting it again
// is cheap and harmless.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Host helpers of the kernels' split planners.

// The split count, at most max_splits, that runs `tiles` blocks' worth of
// work, `units` steps a tile (hidden chunks in K2, row slabs in K3, hidden
// slabs in K1), on `slots` resident blocks in the fewest step-times (waves x
// steps a block), the fewest splits on a tie.
inline int fewest_waves(long long tiles, long long slots, int units, long long max_splits) {
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
inline long long block_slots(int per_sm) {
  int device = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return (long long)sms * per_sm;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace glom

extern "C" const char* glom_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
