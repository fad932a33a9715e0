// Consensus attention backward for widths past the narrow K6's (d a
// multiple of 128 above 512), written by hand for Hopper (sm_90a): the wide
// path of K6 (consensus_bwd.cu, which replaces
// glom_tpu/kernels/consensus_pallas.py::_backward_flash's _bwd_dkv_kernel).
// It computes what consensus_bwd.cu's K6 computes -- dKV = normalize_vjp(
// dS^T Q scale) + P^T dO, and with ds_out the dS' K7 reads -- for any n, f32
// or bf16 inputs, dKV in the inputs' type.  K7 (consensus_bwd.cu's tiled
// product dS' V) takes any multiple of 128 as it is.
//
// What bounds it on the H100: operations.  At the large preset (b=4, n=576,
// L=8, d=1024) K6 does four (n, n, d) products over 32 (b, l) pairs, 87.0
// GFLOP: 3xTF32 bound 0.53 ms, bf16 0.09 ms.
//
// Why not the narrow design.  consensus_bwd.cu's K6 keeps a block's 32 keys
// as whole rows in shared memory beside two query/dO ring stages and the
// warps' partial logits (230,784 of 232,448 bytes at d=512; twice that at
// d=1024), and a warp's share of dK and dV in registers.  As K4 past 512
// does (consensus_wide.cuh), this design runs in six launches on the tiled
// product the port already holds (tile_gemm.cuh), the (n, n) intermediates
// through an f32 workspace the caller allocates (workspace(); 397 MB at the
// large preset, about 0.25 ms of traffic written and read):
//  * key_prep_kernel (consensus_wide.cuh): the keys' scales kscale_j =
//    d^-1/2 / max(||v_j||, 1e-12) over the whole d, and V^T per (b, l),
//    (d, np) in the inputs' type, np = n rounded up to 32, zero past n;
//  * logits_kernel (consensus_wide.cuh): S = Q V^T with the scale, the soft
//    self-mask, the locality mask and the keys past n in its epilogue, f32
//    (b, L, n, np);
//  * dp_kernel: dP = dO V^T on the same product, raw, f32 (b, L, n, np).
//    A launch of its own beside the logits': one block forming both from one
//    B slab would hold two accumulators and a second epilogue, for a product
//    that is an eighth of K6's work at the large preset;
//  * ds_kernel: a 32 x 32 tile of (query, key) a block: P = exp(S - lse)
//    and dS = P (dP - delta), 0 on the diagonal under the soft self-mask
//    (masked pairs and keys past n have P = 0); dS' = dS kscale_j to ds_out
//    (the layout K7 reads), and P^T and (dS d^-1/2)^T, (b, L, np, np) f32,
//    through a transpose in shared memory, zero past n in both axes;
//  * dvk_kernel: dV = P^T dO and dK = (dS d^-1/2)^T Q on the tiled product
//    (64 keys x 128 columns of d a block, the depth the queries, one grid
//    for both: blockIdx.z picks the product), f32 (b, L, n, d) each;
//  * finish_kernel: a warp a key row: |v_j|^2 and v_j . dK_j over the whole
//    d (a lane's part in column order, then the warp's butterfly), the
//    L2-normalize VJP dK / |v| - v (v . dK) / |v|^3 (dK / eps for |v| <=
//    eps) plus dV, rounded once to the inputs' type.
// Deterministic: every sum in a fixed order, no atomics.  The workspace is
// the caller's, 16-byte aligned.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "consensus_row.cuh"
#include "consensus_wide.cuh"
#include "tile_gemm.cuh"
#include "tile_mma.cuh"

namespace glom {
namespace cons {
namespace {
namespace wide_bwd {

namespace tl = glom::tile;
using wide::KEYS;
using wide::key_prep_kernel;
using wide::logits_kernel;
using wide::padded_keys;

constexpr int TILE_THREADS = 256;   // ds_kernel: 32 rows of 8 threads, four values each
constexpr int TILE_SMEM = 2 * KEYS * (KEYS + 1) * sizeof(float);
constexpr int ROWS_PER_BLOCK = 8;   // finish_kernel: a warp a key row

// The parts of a call's f32 workspace, in floats, each on a 16-byte
// boundary: S and dP (b, L, n, np), P^T and (dS scale)^T (b, L, np, np), the
// key scales (b, L, np), V^T (b, L, d, np) in the inputs' type (`item` bytes
// an element), dV and dK (b, L, n, d).
struct Workspace {
  long long s, dp, pt, dst, ks, vt, dv, dk, total;
};

inline Workspace workspace(int b, int n, int L, int dim, int item) {
  const long long pairs = (long long)b * L, np = padded_keys(n);
  Workspace w;
  w.s = 0;
  w.dp = w.s + round4(pairs * n * np);
  w.pt = w.dp + round4(pairs * n * np);
  w.dst = w.pt + round4(pairs * np * np);
  w.ks = w.dst + round4(pairs * np * np);
  w.vt = w.ks + round4(pairs * np);
  w.dv = w.vt + round4((pairs * dim * np * item + 3) / 4);
  w.dk = w.dv + round4(pairs * n * dim);
  w.total = w.dk + round4(pairs * n * dim);
  return w;
}

// Grid (row tiles x key tiles, b * L).  dP[b, l, row0 :, col0 :] = dO V^T of
// queries row0 + [0, 64) and keys col0 + [0, 128), raw; dO (b, n, L, d)
// contiguous.
template <typename T>
__global__ void __launch_bounds__(tl::THREADS, 2)
dp_kernel(const T* __restrict__ go, const T* __restrict__ vt, float* __restrict__ dp, int n,
          int L, int dim, int np) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int pair = blockIdx.y, b = pair / L, l = pair % L;
  const int per_row = (np + tl::BN - 1) / tl::BN;
  const int row0 = blockIdx.x / per_row * tl::BM, col0 = blockIdx.x % per_row * tl::BN;
  const int nw = min(tl::BN, np - col0);
  const long long sg = (long long)L * dim;   // dO's row stride
  float acc[2][4][4];
  tl::tile_product<T, T, kExact, kExact>(acc, go + ((long long)b * n + row0) * sg + (long long)l * dim,
                                         sg, n - row0, vt + (long long)pair * dim * np + col0, np,
                                         nw, dim, reinterpret_cast<unsigned char*>(smem4));
  const int col = tl::col_in_tile();
  if (col >= nw) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + tl::row_in_tile(q);
    if (row >= n) continue;
    float v[8];
    tl::row_of(acc, q, v);
    glom::store8(dp + ((long long)pair * n + row) * np + col0 + col, v);
  }
}

// Grid ((np / 32)^2, b * L): queries i0 + [0, 32), keys j0 + [0, 32) of one
// pair.  Thread t forms row t / 8 (a query), keys 4 (t % 8) + [0, 4), and
// stores row t / 8 of the transposed tile (a key), queries 4 (t % 8) + [0, 4).
__global__ void __launch_bounds__(TILE_THREADS)
ds_kernel(const float* __restrict__ s, const float* __restrict__ dp, const float* __restrict__ ks,
          const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ pt,
          float* __restrict__ dst, float* __restrict__ ds_out, int n, int np, float scale,
          int attend_self) {
  extern __shared__ float4 smem4[];
  float* tp = reinterpret_cast<float*>(smem4);   // [KEYS][KEYS + 1]  P
  float* td = tp + KEYS * (KEYS + 1);            // [KEYS][KEYS + 1]  dS scale
  const int pair = blockIdx.y, per_row = np / KEYS;
  const int i0 = blockIdx.x / per_row * KEYS, j0 = blockIdx.x % per_row * KEYS;
  const int r = threadIdx.x >> 3, q = threadIdx.x & 7;
  const int i = i0 + r, j = j0 + 4 * q;
  float p[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < n) {
    const long long row = (long long)pair * n + i;
    const float4 sv = *reinterpret_cast<const float4*>(s + row * np + j);
    const float4 gv = *reinterpret_cast<const float4*>(dp + row * np + j);
    const float4 kv = *reinterpret_cast<const float4*>(ks + (long long)pair * np + j);
    const float sa[4] = {sv.x, sv.y, sv.z, sv.w}, ga[4] = {gv.x, gv.y, gv.z, gv.w};
    const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
    const float ls = lse[row], dl = delta[row];
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = expf(sa[e] - ls);
      // the diagonal logit is a constant under the soft self-mask: no gradient
      d[e] = !attend_self && i == j + e ? 0.f : p[e] * (ga[e] - dl);
      out[e] = d[e] * ka[e];
    }
    if (ds_out != nullptr) glom::store4(ds_out + row * np + j, out);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    tp[r * (KEYS + 1) + 4 * q + e] = p[e];
    td[r * (KEYS + 1) + 4 * q + e] = d[e] * scale;
  }
  __syncthreads();   // the tile is written
  const long long o = ((long long)pair * np + j0 + r) * np + i0 + 4 * q;
  const float* cp = tp + 4 * q * (KEYS + 1) + r;
  const float* cd = td + 4 * q * (KEYS + 1) + r;
  const float vp[4] = {cp[0], cp[KEYS + 1], cp[2 * (KEYS + 1)], cp[3 * (KEYS + 1)]};
  const float vd[4] = {cd[0], cd[KEYS + 1], cd[2 * (KEYS + 1)], cd[3 * (KEYS + 1)]};
  glom::store4(pt + o, vp);
  glom::store4(dst + o, vd);
}

// Grid (key tiles x d tiles, b * L, 2): z = 0 dV[b, l, j0 :, n0 :] = P^T dO,
// z = 1 dK[b, l, j0 :, n0 :] = (dS scale)^T Q, summed over the queries.
template <typename T>
__global__ void __launch_bounds__(tl::THREADS, 2)
dvk_kernel(const float* __restrict__ pt, const float* __restrict__ dst, const T* __restrict__ lv,
           long long sb, long long sn, long long sl, const T* __restrict__ go,
           float* __restrict__ dv, float* __restrict__ dk, int n, int L, int dim, int np) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int pair = blockIdx.y, b = pair / L, l = pair % L;
  const int per_row = dim / tl::BN;
  const int j0 = blockIdx.x / per_row * tl::BM, n0 = blockIdx.x % per_row * tl::BN;
  const bool key = blockIdx.z == 1;
  const float* a = (key ? dst : pt) + ((long long)pair * np + j0) * np;
  const T* bsrc = key ? lv + b * sb + l * sl + n0
                      : go + (long long)b * n * L * dim + (long long)l * dim + n0;
  const long long ldb = key ? sn : (long long)L * dim;
  float acc[2][4][4];
  tl::tile_product<float, T, false, kExact>(acc, a, np, n - j0, bsrc, ldb, tl::BN, np,
                                            reinterpret_cast<unsigned char*>(smem4), n);
  float* out = key ? dk : dv;
  const int col = n0 + tl::col_in_tile();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = j0 + tl::row_in_tile(q);
    if (row >= n) continue;
    float v[8];
    tl::row_of(acc, q, v);
    glom::store8(out + ((long long)pair * n + row) * dim + col, v);
  }
}

// A warp a key row r of (b * L * n): dkv[b, j, l] = normalize_vjp(v_j,
// dK_j) + dV_j in T.
template <typename T>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
finish_kernel(const T* __restrict__ lv, long long sb, long long sn, long long sl,
              const float* __restrict__ dv, const float* __restrict__ dk, T* __restrict__ dkv,
              long long rows, int n, int L, int dim) {
  using V = typename glom::Vec4<T>::type;
  const long long r = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= rows) return;   // warp-uniform
  const int lane = threadIdx.x & 31;
  const int pair = static_cast<int>(r / n), j = static_cast<int>(r % n);
  const int b = pair / L, l = pair % L;
  const T* v = lv + b * sb + l * sl + (long long)j * sn;
  const float* k = dk + r * dim;
  const float* w = dv + r * dim;
  float ss = 0.f, dot = 0.f;
  for (int c = 4 * lane; c < dim; c += 128) {
    const float4 x = glom::to_f32x4(*reinterpret_cast<const V*>(v + c));
    const float4 y = *reinterpret_cast<const float4*>(k + c);
    ss = fmaf(x.x, x.x, ss), ss = fmaf(x.y, x.y, ss), ss = fmaf(x.z, x.z, ss), ss = fmaf(x.w, x.w, ss);
    dot = fmaf(x.x, y.x, dot), dot = fmaf(x.y, y.y, dot), dot = fmaf(x.z, y.z, dot),
    dot = fmaf(x.w, y.w, dot);
  }
  ss = glom::warp_sum(ss);
  dot = glom::warp_sum(dot);
  const float nrm = sqrtf(ss);
  const bool big = nrm > NORM_EPS;
  const float inv = 1.f / (big ? nrm : NORM_EPS);
  const float coef = big ? dot * inv * inv * inv : 0.f;
  T* o = dkv + (((long long)b * n + j) * L + l) * dim;
  for (int c = 4 * lane; c < dim; c += 128) {
    const float4 x = glom::to_f32x4(*reinterpret_cast<const V*>(v + c));
    const float4 y = *reinterpret_cast<const float4*>(k + c);
    const float4 z = *reinterpret_cast<const float4*>(w + c);
    const float out[4] = {y.x * inv - x.x * coef + z.x, y.y * inv - x.y * coef + z.y,
                          y.z * inv - x.z * coef + z.z, y.w * inv - x.w * coef + z.w};
    glom::store4(o + c, out);
  }
}

template <typename T>
cudaError_t launch_dkv(const void* levels, long long sb, long long sn, long long sl,
                       const void* go, const float* lse, const float* delta, const int8_t* mask,
                       void* out, float* ds_out, void* ws, int b, int n, int L, int dim,
                       float scale, int attend_self, cudaStream_t stream) {
  const T* lv = static_cast<const T*>(levels);
  const T* g = static_cast<const T*>(go);
  const int np = padded_keys(n), pairs = b * L;
  const Workspace w = workspace(b, n, L, dim, sizeof(T));
  float* f = static_cast<float*>(ws);
  T* vt = reinterpret_cast<T*>(f + w.vt);
  const size_t smem_s = tl::smem_bytes<T, T>(), smem_kv = tl::smem_bytes<float, T>();
  cudaError_t err = glom::allow_smem(logits_kernel<T>, smem_s);
  if (err == cudaSuccess) err = glom::allow_smem(dp_kernel<T>, smem_s);
  if (err == cudaSuccess) err = glom::allow_smem(dvk_kernel<T>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_k(np / KEYS, pairs);
  key_prep_kernel<T><<<grid_k, wide::PREP_THREADS, wide::PREP_SMEM, stream>>>(lv, sb, sn, sl, n, L, dim, np, scale, vt, f + w.ks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int row_tiles = (n + tl::BM - 1) / tl::BM;
  const dim3 grid_s(row_tiles * ((np + tl::BN - 1) / tl::BN), pairs);
  logits_kernel<T><<<grid_s, tl::THREADS, smem_s, stream>>>(lv, sb, sn, sl, vt, f + w.ks, mask, f + w.s, n, L, dim, np, attend_self);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dp_kernel<T><<<grid_s, tl::THREADS, smem_s, stream>>>(g, vt, f + w.dp, n, L, dim, np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_t((np / KEYS) * (np / KEYS), pairs);
  ds_kernel<<<grid_t, TILE_THREADS, TILE_SMEM, stream>>>(f + w.s, f + w.dp, f + w.ks, lse, delta, f + w.pt, f + w.dst, ds_out, n, np, scale, attend_self);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(row_tiles * (dim / tl::BN), pairs, 2);
  dvk_kernel<T><<<grid_kv, tl::THREADS, smem_kv, stream>>>(f + w.pt, f + w.dst, lv, sb, sn, sl, g, f + w.dv, f + w.dk, n, L, dim, np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)pairs * n;
  const unsigned row_blocks = static_cast<unsigned>((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  finish_kernel<T><<<row_blocks, 32 * ROWS_PER_BLOCK, 0, stream>>>(lv, sb, sn, sl, f + w.dv, f + w.dk, static_cast<T*>(out), rows, n, L, dim);
  return cudaGetLastError();
}

}  // namespace wide_bwd
}  // namespace
}  // namespace cons
}  // namespace glom
