// Consensus attention backward, written by hand for Hopper (sm_90a): two
// kernels, dKV and dQ, the backward of consensus.cu.
//
// Replaces: glom_tpu/kernels/consensus_pallas.py::_backward_flash, its two
// TPU kernels _bwd_dkv_kernel (K6) and _bwd_dq_kernel (K7), which share
// _sim_block.  For each batch b and level l, with Q = V = X = levels[b, :, l]
// and K = X / max(||X||, 1e-12) row by row, the logits S are recomputed as
// the forward computes them (scale d^-1/2, the soft self-mask -5e-4 on the
// diagonal unless attend_self, -FLT_MAX on masked pairs) and
//     P  = exp(S - lse)                  (lse: the forward's row logsumexp)
//     dS = P * (dO V^T - delta)          (delta_i = dO_i . O_i, from the wrapper)
//          and 0 on the diagonal under the soft self-mask
//     K6: dKV_j = normalize_vjp(sum_i dS_ij Q_i scale) + sum_i P_ij dO_i
//     K7: dQ_i  = sum_j dS_ij K_j scale
// dLevels = dQ + dKV (added by the wrapper).  levels and dO are f32 or bf16;
// accumulation is f32; dQ and dKV are written in the levels' type.
//
// What bounds them: operations.  At the flagship shapes (b=8, L=6, n=256,
// d=512) K6 does 8*n*n*d FLOPs a (b, l) (S, dO V^T, P^T dO, dS^T Q) and K7 6
// (S, dO V^T, dS K): 12.9 and 9.7 GFLOP.  The plain version writes the
// (b, L, n, n) probabilities and their gradient to device memory.
//
// What the design does about it:
//  * the products run on the tensor cores through tile_mma.cuh (mma.sync,
//    3xTF32 for f32 operands, one pass for operands that came from bf16),
//    and the (n, n) tiles never leave shared memory;
//  * K6: a block owns 32 keys of one (b, l), keeps them in shared memory,
//    and walks the queries in blocks of 32: S and dO V^T (two 16 x 8 tiles
//    a warp over all of d), then P and dS in shared memory, then P^T dO and
//    dS^T Q added into two (32, d) accumulators in the 8 warps' registers.
//    At the end each key row's dK goes through the L2-normalize VJP
//    (dK / |v| - v (v . dK) / |v|^3, or dK / eps for |v| <= eps) and dV is
//    added;
//  * K7: a block owns 32 queries of one (b, l) and walks the keys in blocks
//    of 32, as the forward does, adding dS K scale into a (32, d)
//    accumulator.  The key scale d^-1/2 / max(|v_j|, eps) is folded into dS;
//  * every sum stays in one block, in a fixed order: no workspace and no
//    atomics, so two runs give the same bits;
//  * masked pairs carry -FLT_MAX and give P = 0; queries and keys past n
//    (the ragged edge) are zero in shared memory and given P = dS = 0;
//  * three 32-row f32 tiles (keys, queries, dO) are 198 KB at d=512, so a
//    block takes about 209 KB of shared memory and one block runs on an SM.
//
// Layout: levels is read through its strides (last dimension contiguous);
// dO, dQ and dKV are (b, n, L, d) contiguous; lse and delta (b, L, n) f32.
// d must be a multiple of 128, at most 512.

#include <type_traits>

#include "common.cuh"
#include "consensus_row.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int BQ = 32;         // queries per block (K7) or per step (K6)
constexpr int BK = glom::KEY_BLOCK;   // keys per step (K7) or per block (K6)
constexpr int THREADS = 256;   // 8 warps
using glom::NORM_EPS;
using glom::SELF_LOGIT;

template <int D>
struct Layout {
  static constexpr int kRow = D + 4;    // query, dO and key tiles (32, D)
  static constexpr int kP = BK + 4;     // (BQ, BK) logit / probability / dS tiles
  static constexpr size_t kBytes =
      sizeof(float) * (3 * 32 * kRow + 2 * BQ * kP + 3 * BK + 2 * BQ + 8 * BK);
};

// S = Q V^T (warps 0-3) and dP = dO V^T (warps 4-7) for a (BQ, BK) tile:
// two 16 x 8 tiles a warp over all of D, into ps and dps.
template <int D, bool kExact>
__device__ __forceinline__ void logits_and_dp(const float* qs, const float* gs, const float* vs,
                                              float* ps, float* dps) {
  using S = Layout<D>;
  const int warp = threadIdx.x >> 5;
  const bool second = warp >= 4;
  const int tm = (warp >> 1) & 1, tn = (warp & 1) * 2;
  float t[1][2][4] = {{{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}}};
  // B(k, key) = vs[key * kRow + k]
  glom::warp_mma_long<1, 2, kExact, kExact>(t, (second ? gs : qs) + tm * 16 * S::kRow, S::kRow, 1,
                                            vs + tn * 8 * S::kRow, 1, S::kRow, D);
  float* dst = (second ? dps : ps) + tm * 16 * S::kP + tn * 8;
  glom::store_tile(dst, S::kP, t[0][0]);
  glom::store_tile(dst + 8, S::kP, t[0][1]);
}

// P and dS of query i, key j from the raw product s = q_i . v_j and dp =
// dO_i . v_j; both 0 outside [0, n).
__device__ __forceinline__ void prob_and_ds(float s, float dp, float kscale, float lse,
                                            float delta, int i, int j, int n,
                                            const int8_t* __restrict__ mask, int attend_self,
                                            float& p, float& ds) {
  p = 0.f;
  ds = 0.f;
  if (i >= n || j >= n) return;
  float v = s * kscale;
  const bool self_masked = !attend_self && i == j;
  if (self_masked) v = SELF_LOGIT;
  if (mask != nullptr && mask[(long long)i * n + j] != 0) v = -FLT_MAX;
  p = expf(v - lse);
  // the diagonal logit is a constant under the soft self-mask: no gradient
  ds = self_masked ? 0.f : p * (dp - delta);
}

// K7.  Grid (query blocks, b * L).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
consensus_bwd_dq_kernel(const T* __restrict__ lv, long long sb, long long sn, long long sl,
                        const T* __restrict__ go, const float* __restrict__ lse,
                        const float* __restrict__ delta, const int8_t* __restrict__ mask,
                        T* __restrict__ dq, int n, int L, float scale, int attend_self) {
  using S = Layout<D>;
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr int NT = D / 64;   // n8 tiles in a warp's D/8 output columns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][kRow]  queries
  float* gs = qs + BQ * S::kRow;                 // [BQ][kRow]  dO
  float* vs = gs + BQ * S::kRow;                 // [BK][kRow]  this key block
  float* ps = vs + BK * S::kRow;                 // [BQ][kP]    S, then dS * kscale
  float* dps = ps + BQ * S::kP;                  // [BQ][kP]    dO V^T
  float* kscale = dps + BQ * S::kP;              // [BK]
  float* lse_s = kscale + 3 * BK;                // [BQ]
  float* dl_s = lse_s + BQ;                      // [BQ]

  const int b = blockIdx.y / L, l = blockIdx.y % L;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5;
  const T* base = lv + b * sb + l * sl;
  const long long grow = (long long)L * D;   // dO's row stride
  const T* gbase = go + (long long)b * n * grow + (long long)l * D;

  glom::load_tile<BQ, D, THREADS>(qs, S::kRow, base, sn, q0, n);
  glom::load_tile<BQ, D, THREADS>(gs, S::kRow, gbase, grow, q0, n);
  if (tid < BQ) {
    const long long row = ((long long)b * L + l) * n + q0 + tid;
    lse_s[tid] = q0 + tid < n ? lse[row] : 0.f;
    dl_s[tid] = q0 + tid < n ? delta[row] : 0.f;
  }

  const int n2 = warp * (D / 8);
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int j0 = 0; j0 < n; j0 += BK) {
    __syncthreads();   // every warp is done with the previous key block (and Q, dO are loaded)
    glom::load_tile<BK, D, THREADS>(vs, S::kRow, base, sn, j0, n);
    __syncthreads();
    glom::key_scales<D>(vs, S::kRow, kscale, nullptr, scale);
    logits_and_dp<D, kExact>(qs, gs, vs, ps, dps);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += THREADS) {
      const int r = e / BK, c = e - r * BK;
      float p, ds;
      prob_and_ds(ps[r * S::kP + c], dps[r * S::kP + c], kscale[c], lse_s[r], dl_s[r], q0 + r,
                  j0 + c, n, mask, attend_self, p, ds);
      ps[r * S::kP + c] = ds * kscale[c];   // dS K scale = (dS kscale_j) V_j
    }
    __syncthreads();
    glom::warp_mma<2, NT, BK, false, kExact>(acc, ps, S::kP, 1, vs + n2, S::kRow, 1);
  }

  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = q0 + mt * 16 + gid + 8 * half;
      if (i >= n) continue;
      T* o = dq + (((long long)b * n + i) * L + l) * D + n2 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        glom::store2(o + nt * 8, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
}

// K6.  Grid (key blocks, b * L).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
consensus_bwd_dkv_kernel(const T* __restrict__ lv, long long sb, long long sn, long long sl,
                         const T* __restrict__ go, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int8_t* __restrict__ mask,
                         T* __restrict__ dkv, int n, int L, float scale, int attend_self) {
  using S = Layout<D>;
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr int NT = D / 64;
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);   // [BK][kRow]  this block's keys
  float* qs = vs + BK * S::kRow;                 // [BQ][kRow]  a query block
  float* gs = qs + BQ * S::kRow;                 // [BQ][kRow]  its dO
  float* ps = gs + BQ * S::kRow;                 // [BQ][kP]    S, then P
  float* dps = ps + BQ * S::kP;                  // [BQ][kP]    dO V^T, then dS * scale
  float* kscale = dps + BQ * S::kP;              // [BK]
  float* norm = kscale + BK;                     // [BK]  |v_j|
  float* dots = norm + BK;                       // [BK]  v_j . dK_j
  float* lse_s = dots + BK;                      // [BQ]
  float* dl_s = lse_s + BQ;                      // [BQ]
  float* red = dl_s + BQ;                        // [8][BK]  per-warp partial dots

  const int b = blockIdx.y / L, l = blockIdx.y % L;
  const int j0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5;
  const T* base = lv + b * sb + l * sl;
  const long long grow = (long long)L * D;
  const T* gbase = go + (long long)b * n * grow + (long long)l * D;

  glom::load_tile<BK, D, THREADS>(vs, S::kRow, base, sn, j0, n);
  __syncthreads();
  glom::key_scales<D>(vs, S::kRow, kscale, norm, scale);

  const int n2 = warp * (D / 8);
  float av[2][NT][4], ak[2][NT][4];   // dV and dK: the warp's 32 keys x D/8 columns
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[mt][nt][e] = ak[mt][nt][e] = 0.f;

  for (int i0 = 0; i0 < n; i0 += BQ) {
    __syncthreads();   // every warp is done with the previous query block
    glom::load_tile<BQ, D, THREADS>(qs, S::kRow, base, sn, i0, n);
    glom::load_tile<BQ, D, THREADS>(gs, S::kRow, gbase, grow, i0, n);
    if (tid < BQ) {
      const long long row = ((long long)b * L + l) * n + i0 + tid;
      lse_s[tid] = i0 + tid < n ? lse[row] : 0.f;
      dl_s[tid] = i0 + tid < n ? delta[row] : 0.f;
    }
    __syncthreads();
    logits_and_dp<D, kExact>(qs, gs, vs, ps, dps);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += THREADS) {
      const int r = e / BK, c = e - r * BK;
      float p, ds;
      prob_and_ds(ps[r * S::kP + c], dps[r * S::kP + c], kscale[c], lse_s[r], dl_s[r], i0 + r,
                  j0 + c, n, mask, attend_self, p, ds);
      ps[r * S::kP + c] = p;
      dps[r * S::kP + c] = ds * scale;
    }
    __syncthreads();
    // dV += P^T dO and dK += (dS scale)^T Q: A(key, i) = tile[i * kP + key]
    glom::warp_mma<2, NT, BQ, false, kExact>(av, ps, 1, S::kP, gs + n2, S::kRow, 1);
    glom::warp_mma<2, NT, BQ, false, kExact>(ak, dps, 1, S::kP, qs + n2, S::kRow, 1);
  }

  // the L2-normalize VJP needs v_j . dK_j: a thread's partial sums over its
  // columns, then the quad (tig) and the 8 warps, in a fixed order
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + gid + 8 * half;
      const float* vr = vs + r * S::kRow + n2 + 2 * tig;
      float part = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        part += vr[nt * 8] * ak[mt][nt][2 * half] + vr[nt * 8 + 1] * ak[mt][nt][2 * half + 1];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (tig == 0) red[warp * BK + r] = part;
    }
  __syncthreads();
  if (tid < BK) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * BK + tid];
    dots[tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + gid + 8 * half;
      const int j = j0 + r;
      if (j >= n) continue;
      const float nrm = norm[r];
      const bool big = nrm > NORM_EPS;
      const float inv = 1.f / (big ? nrm : NORM_EPS);
      const float coef = big ? dots[r] * inv * inv * inv : 0.f;
      const float* vr = vs + r * S::kRow + n2 + 2 * tig;
      T* o = dkv + (((long long)b * n + j) * L + l) * D + n2 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float k0 = ak[mt][nt][2 * half] * inv - vr[nt * 8] * coef;
        const float k1 = ak[mt][nt][2 * half + 1] * inv - vr[nt * 8 + 1] * coef;
        glom::store2(o + nt * 8, k0 + av[mt][nt][2 * half], k1 + av[mt][nt][2 * half + 1]);
      }
    }
}

template <typename T, int D>
cudaError_t launch(bool dkv, const void* lv, long long sb, long long sn, long long sl,
                   const void* go, const float* lse, const float* delta, const int8_t* mask,
                   void* out, int b, int n, int L, int attend_self, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  const auto kernel = dkv ? consensus_bwd_dkv_kernel<T, D> : consensus_bwd_dq_kernel<T, D>;
  cudaError_t err = glom::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + 31) / 32, b * L);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(lv), sb, sn, sl,
                                          static_cast<const T*>(go), lse, delta, mask,
                                          static_cast<T*>(out), n, L, scale, attend_self);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, int dim, const void* lv, long long sb, long long sn, long long sl,
                     const void* go, const float* lse, const float* delta, const int8_t* mask,
                     void* out, int b, int n, int L, int attend_self, cudaStream_t s) {
  switch (dim) {
    case 128: return launch<T, 128>(dkv, lv, sb, sn, sl, go, lse, delta, mask, out, b, n, L, attend_self, s);
    case 256: return launch<T, 256>(dkv, lv, sb, sn, sl, go, lse, delta, mask, out, b, n, L, attend_self, s);
    case 384: return launch<T, 384>(dkv, lv, sb, sn, sl, go, lse, delta, mask, out, b, n, L, attend_self, s);
    case 512: return launch<T, 512>(dkv, lv, sb, sn, sl, go, lse, delta, mask, out, b, n, L, attend_self, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, const void* levels, long long sb, long long sn, long long sl, const void* go,
        const void* lse, const void* delta, const void* mask, void* out, int b, int n, int L,
        int dim, int attend_self, int dtype, void* stream) {
  if (dim % 128 != 0 || dim < 128 || dim > 512 || b < 1 || n < 1 || L < 1 ||
      (long long)b * L > 65535)
    return cudaErrorInvalidValue;
  const int8_t* m = static_cast<const int8_t*>(mask);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return dispatch<float>(dkv, dim, levels, sb, sn, sl, go, ls, dl, m, out, b, n, L, attend_self, s);
  if (dtype == glom::kBF16)
    return dispatch<__nv_bfloat16>(dkv, dim, levels, sb, sn, sl, go, ls, dl, m, out, b, n, L, attend_self, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// K6.  levels (b, n, L, dim) read through strides sb, sn, sl (elements; the
// last dimension contiguous); go = dO (b, n, L, dim) contiguous, levels'
// dtype; lse and delta (b, L, n) f32; mask (n, n) int8 or bool, contiguous,
// or null; out = dKV (b, n, L, dim) contiguous, levels' dtype.  Returns the
// launch's cudaError_t.
extern "C" int glom_consensus_bwd_dkv(const void* levels, long long sb, long long sn, long long sl,
                                      const void* go, const void* lse, const void* delta,
                                      const void* mask, void* out, int b, int n, int L, int dim,
                                      int attend_self, int dtype, void* stream) {
  return run(true, levels, sb, sn, sl, go, lse, delta, mask, out, b, n, L, dim, attend_self,
             dtype, stream);
}

// K7.  As K6's arguments; out = dQ.
extern "C" int glom_consensus_bwd_dq(const void* levels, long long sb, long long sn, long long sl,
                                     const void* go, const void* lse, const void* delta,
                                     const void* mask, void* out, int b, int n, int L, int dim,
                                     int attend_self, int dtype, void* stream) {
  return run(false, levels, sb, sn, sl, go, lse, delta, mask, out, b, n, L, dim, attend_self,
             dtype, stream);
}
