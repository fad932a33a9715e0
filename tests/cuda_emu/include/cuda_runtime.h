// A CPU emulator of the CUDA features the port's kernels use, for running a
// kernel's source on the CPU at small shapes (tests/cuda_emu/emulate.py): one
// block at a time, one std::thread per CUDA thread, warp collectives through
// per-warp barriers.  It checks index arithmetic and fragment layouts, not speed.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __restrict__
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return 0; }
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return 0; }
struct float2 { float x, y; }; struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; }; struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline int __float_as_int(float f) { int u; memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
inline float __expf(float x) { return std::exp(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
using std::min; using std::max;
inline size_t __cvta_generic_to_shared(const void* p) { return reinterpret_cast<size_t>(p); }

namespace emu {
struct Block {
  std::barrier<>* block;
  std::vector<std::barrier<>*> warps;
  std::vector<uint64_t> slot;     // one 8-byte slot x 8 per lane: fragments and pointers
};
inline Block* cur = nullptr;
inline std::vector<float4> smem_buf(232448 / 16 + 16);
inline float4* smem() { return smem_buf.data(); }
inline int lane() { return threadIdx.x & 31; }
inline int warp() { return threadIdx.x >> 5; }
inline void wsync() { cur->warps[warp()]->arrive_and_wait(); }
inline uint64_t* slots(int w, int l) { return &cur->slot[((size_t)w * 32 + l) * 16]; }

template <class K, class... A>
void launch(dim3 grid, int threads, size_t, cudaStream_t, K kernel, A... args) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bb(threads);
        Block b{&bb, {}, std::vector<uint64_t>((size_t)threads * 16)};
        std::vector<std::barrier<>*> ws;
        for (int w = 0; w < (threads + 31) / 32; ++w) ws.push_back(new std::barrier<>(32));
        b.warps = ws;
        memset(smem_buf.data(), 0xcd, smem_buf.size() * sizeof(float4));   // garbage, not zeros
        cur = &b;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=] {
            threadIdx = {(unsigned)t, 0, 0}; blockIdx = {x, y, z};
            blockDim = dim3(threads); gridDim = grid;
            kernel(args...);
          });
        for (auto& t : ts) t.join();
        for (auto* w : ws) delete w;
      }
}
inline float tf32(float v) { return __uint_as_float(__float_as_uint(v) & 0xffffe000u); }
inline float bf(uint32_t r, int half) { return __uint_as_float((half ? (r >> 16) : (r & 0xffff)) << 16); }
}  // namespace emu

inline void __syncthreads() { emu::cur->block->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  int w = emu::warp(), l = emu::lane();
  float r;
  emu::wsync(); memcpy(emu::slots(w, l), &v, 4); emu::wsync();
  memcpy(&r, emu::slots(w, l ^ o), 4); emu::wsync();
  return r;
}
