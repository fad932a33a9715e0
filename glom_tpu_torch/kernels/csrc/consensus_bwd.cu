// Consensus attention backward, written by hand for Hopper (sm_90a): two
// kernels, dKV (K6) and dQ (K7), the backward of consensus.cu.
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
//     K7: dQ_i  = sum_j dS_ij K_j scale = sum_j dS'_ij V_j
// with dS'_ij = dS_ij kscale_j and kscale_j = d^-1/2 / max(|v_j|, 1e-12).
// dLevels = dQ + dKV (added by the wrapper).  levels and dO are f32 or bf16;
// accumulation is f32; dQ and dKV are written in the levels' type.
//
// What bounds them: operations.  A unit of work is one (n, n, d) product,
// 2 n^2 d FLOPs a (b, l).  The TPU kernels do 7 units: K6 four (S, dO V^T,
// P^T dO, dS^T Q) and K7 three (S and dO V^T again, dS K).  Here K6 forms
// dS' once, where it forms dS, and stores it (f32, (b, L, n, npad), npad =
// n rounded up to 32, zero for masked pairs, for the diagonal under the
// soft self-mask and past n: 12.6 MB at the flagship's b=8), and K7 is one
// product of that dS' and the levels: 5 units.  At the flagship shapes (b=8,
// L=6, n=256, d=512) that is 12.9 GFLOP in K6 and 3.2 in K7, which run on
// the tensor cores as 3xTF32 in f32 (an f32 operand split into tf32 hi +
// lo, three mma passes; common.cuh).
//
// K6.  A block owns 32 keys of one (b, l) for its whole life and walks the
// queries in steps of 16; 8 warps, one block an SM:
//  * shared memory: the key block (64 KB at d=512 f32), two ring stages of
//    the step's queries and dO (2 x 64 KB), the warps' partial logits (32
//    KB): 230,784 bytes of the 232,448 a block may have.  Two stages of 32
//    queries would need 256 KB, so the step is 16 queries, one mma m-tile.
//    Every tile is copied by 16-byte cp.async in the inputs' type (bf16
//    stays bf16, half the bytes), the next step's while this step computes,
//    rows unpadded with their 16-byte pieces XOR-permuted by the row (swz),
//    so the fragment loads of both phases below hit distinct banks;
//  * S and dP: warp w takes the depth slice [w d/8, (w+1) d/8) and forms
//    both (16, 32) tiles over it; each 16-byte load of a key row gives a
//    lane the B values of two k8 steps (the mma depth is permuted the same
//    way in A and B, as tile_gemm.cuh does), and each split key fragment
//    serves both S and dP.  The partials are 8 k8 steps deep at d=512; the
//    eight meet in shared memory in fragment order and are summed with f32
//    adds in a fixed order, as K4 does;
//  * P and dS: warp w sums 2 value slots of S and the matching 2 of dP (a
//    row and two neighbouring keys a lane), forms P, dS and dS' there,
//    stores dS' (an 8-byte store; the mask read once a pair), and writes P
//    and dS scale back over its own slots of the first partial, so one
//    barrier publishes them.  Three barriers a step: the ring stage, the
//    partials, P and dS;
//  * dV += P^T dO, then dK += (dS scale)^T Q (add_step; one after the
//    other, so ptxas keeps the 128 accumulators a thread at d=512 with
//    little spilling): the (32, d) outputs split into (16-key m-tile,
//    32-column quad) units, d/16 of them, d/128 a warp (d=512: both m-tiles,
//    two quads).  A quad's column 4 g + nt is mma column g of its n-tile nt,
//    so one 16-byte load of a dO or Q row gives a lane its B values of four
//    n-tiles.  Each step's product (16 queries deep) is formed in a zeroed
//    fragment and added with an f32 add, so the sums over n do not drift
//    toward zero (the tensor cores round their accumulation toward zero);
//  * at the end each key row's dK goes through the L2-normalize VJP
//    (dK / |v| - v (v . dK) / |v|^3, or dK / eps for |v| <= eps), v . dK
//    summed over the warps in a fixed order, and dV is added.
// K7.  dQ = dS' V per (b, l) is tile_gemm.cuh's tiled product (K1's): 64 x
// 128 output tiles, the keys in slabs of 32 through a three-stage cp.async
// ring, each slab folded with an f32 add, two blocks an SM.  A is dS' (f32,
// with its lo pass in bf16 too), B the levels read through their strides,
// with the keys past n zero; K7 recomputes neither S nor dP.
// Deterministic: every sum in a fixed order, no atomics.
//
// Past d=512 the key block and ring above do not fit a block's shared
// memory: K6 is then consensus_bwd_wide.cuh's design (six launches on
// tile_gemm.cuh's product, through an f32 workspace the caller allocates,
// glom_consensus_bwd_workspace), and K7 is the same tiled product as below.
//
// Layout: levels is read through its strides (last dimension contiguous,
// every row on a 16-byte boundary); dO, dQ and dKV are (b, n, L, d)
// contiguous; lse and delta (b, L, n) f32; dS' (b, L, n, npad) f32.  d must
// be a multiple of 128.

#include <type_traits>

#include "common.cuh"
#include "consensus_bwd_wide.cuh"
#include "consensus_row.cuh"
#include "tile_gemm.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int KB = glom::KEY_BLOCK;   // keys a K6 block owns
constexpr int QS = 16;                // queries a K6 step
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int XCHG = 32 * 32;         // floats of a warp's partial S and dP: 32 values x 32 lanes
using glom::NORM_EPS;
using glom::SELF_LOGIT;

template <typename T, int D>
struct Layout {
  static constexpr int kKeys = KB * D;   // elements of T: the key block
  static constexpr int kTile = QS * D;   // a step's queries, or its dO
  // the key block, two stages of queries and dO, the warps' partials, the
  // warps' parts of v . dK, the key scales, norms and v . dK
  static constexpr size_t kBytes =
      sizeof(T) * (kKeys + 4 * kTile) + sizeof(float) * (WARPS * XCHG + WARPS * KB + 3 * KB);
  static_assert(kBytes <= 232448, "a block has at most 232,448 bytes of shared memory");
};

// Where column c of row r lies in its unpadded shared row: the 16-byte
// pieces XOR-permuted so that a quarter warp's 16-byte loads (f32; a half
// warp's 8-byte loads in bf16) hit distinct banks, both for two rows of
// four pieces (S and dP) and for four rows of two pieces (dV and dK).
template <typename T>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (sizeof(T) == 4) return c ^ (((r & 1) << 4) | ((r & 2) << 2));
  else return c ^ ((r & 3) << 4);
}

// Start the copy of rows [row0, row0 + ROWS) (src, rows `stride` apart)
// into a shared tile of rows of D; rows past n are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src, long long stride,
                                          int row0, int n) {
  constexpr int E = 16 / sizeof(T), PER_ROW = D / E;
  static_assert(ROWS * PER_ROW % THREADS == 0, "a tile splits evenly into the block's copies");
#pragma unroll
  for (int u = 0; u < ROWS * PER_ROW / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS, r = i / PER_ROW, c = (i % PER_ROW) * E;
    const bool in = row0 + r < n;
    glom::cp_async16_zfill(dst + r * D + swz<T>(r, c),
                           src + (long long)(in ? row0 + r : 0) * stride + c, in);
  }
}

// Four consecutive columns [c, c + 4) of row r of a shared tile, as f32.
template <typename T, int D>
__device__ __forceinline__ float4 row4(const T* tile, int r, int c) {
  return glom::ld4(tile + r * D + swz<T>(r, c));
}

// v = hi + lo for an operand of S or dP: the rounded split, or the value
// itself where it came from bf16.  Not the truncated split: K7's dQ is a
// sum of dS' that cancels, and dS = P (dP - delta) cancels too, so the bit
// the truncated split loses in S and dP reached dQ (1.3x the error against
// float64 on the emulator at n=256, d=512).
template <bool kExact>
__device__ __forceinline__ void split_s(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExact) hi = __float_as_uint(v), lo = 0u;
  else glom::split_tf32(v, hi, lo);
}

// c += a b in three passes (lo hi, hi lo, hi hi), or one where both are exact.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  if constexpr (!kExactA) glom::mma_tf32(c, alo, bhi);
  if constexpr (!kExactB) glom::mma_tf32(c, ahi, blo);
  glom::mma_tf32(c, ahi, bhi);
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

// Each of the 8 warps takes 4 of the block's 32 keys: norm[j] = |v_j| and
// kscale[j] = scale / max(|v_j|, eps), from the key rows in shared memory.
template <typename T, int D>
__device__ __forceinline__ void key_norms(const T* keys, float* kscale, float* norm, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < KB / WARPS; ++e) {
    const int j = warp * (KB / WARPS) + e;
    float ss = 0.f;
#pragma unroll
    for (int c = 4 * lane; c < D; c += 128) {   // a permutation of the row
      const float4 v = glom::ld4(keys + j * D + c);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    ss = glom::warp_sum(ss);
    if (lane == 0) {
      const float nrm = sqrtf(ss);
      kscale[j] = scale / fmaxf(nrm, NORM_EPS);
      norm[j] = nrm;
    }
  }
}

// (query q, key r) of a step's P (x = the first partial) or dS scale (16
// value slots on) as the warps that formed them wrote them: the S tile's
// fragment order, slot (r / 8) 4 + 2 (q / 8) + r % 2, lane (q % 8) 4 + (r % 8) / 2.
__device__ __forceinline__ int at(int q, int r) {
  return (((r >> 3) << 2) + ((q >> 3) << 1) + (r & 1)) * 32 + ((q & 7) << 2) + ((r & 7) >> 1);
}

// acc += A^T B over a step's 16 queries (two k8 steps) for the warp's
// m-tiles mt0 .. and quads qw0 ..: A(q, key) at x[at(q, key)] (P or dS
// scale), B(q, column) the step's dO or query tile.  A quad's column 4 g +
// nt is mma column g of its n-tile nt, so one 16-byte load of a row gives a
// lane its B values of four n-tiles.  Each tile's product is formed in a
// zeroed fragment and added to acc with an f32 add.
template <typename T, int D, int MW, int QW, bool kExact>
__device__ __forceinline__ void add_step(float (&acc)[MW][QW][4][4], const float* x, const T* tile,
                                         int mt0, int qw0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    const int col = 32 * (qw0 + qi) + 4 * gid;
    uint32_t bhi[2][4][2], blo[2][4][2];   // [k8 step][n-tile]: {B[t][g], B[t+4][g]}
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = row4<T, D>(tile, 8 * s + tig + 4 * h, col);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if constexpr (kExact) bhi[s][nt][h] = __float_as_uint(vv[nt]), blo[s][nt][h] = 0u;
          else glom::split_tf32(vv[nt], bhi[s][nt][h], blo[s][nt][h]);
        }
      }
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      const int r = 16 * (mt0 + mi) + gid;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e)   // {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}
          glom::split_tf32(x[at(8 * s + tig + 4 * (e >> 1), r + 8 * (e & 1))], ahi[s][e], alo[s][e]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 2; ++s) mma3<false, kExact>(t, ahi[s], alo[s], bhi[s][nt], blo[s][nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][qi][nt][e] += t[e];
      }
    }
  }
}

// K6.  Grid (key blocks, b * L).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
consensus_bwd_dkv_kernel(const T* __restrict__ lv, long long sb, long long sn, long long sl,
                         const T* __restrict__ go, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int8_t* __restrict__ mask,
                         T* __restrict__ dkv, float* __restrict__ ds_out, int n, int npad, int L,
                         float scale, int attend_self) {
  using S = Layout<T, D>;
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr int DS = D / WARPS;                       // a warp's depth slice of S and dP
  constexpr int MW = (D / 128) % 2 == 0 ? 2 : 1;      // key m-tiles a warp owns in dV, dK
  constexpr int QW = D / 128 / MW;                    // 32-column quads a warp owns
  extern __shared__ float4 smem4[];
  T* keys = reinterpret_cast<T*>(smem4);              // [KB][D]
  T* ring = keys + S::kKeys;                          // stage s: queries, then dO, [QS][D] each
  float* xchg = reinterpret_cast<float*>(ring + 4 * S::kTile);   // [warp][32 values][32 lanes]
  float* red = xchg + WARPS * XCHG;                   // [warp][KB]  parts of v . dK
  float* kscale = red + WARPS * KB;                   // [KB]
  float* norm = kscale + KB;                          // [KB]  |v_j|
  float* dots = norm + KB;                            // [KB]  v_j . dK_j

  const int pair = blockIdx.y, b = pair / L, l = pair % L;
  const int j0 = blockIdx.x * KB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const T* base = lv + b * sb + l * sl;
  const long long grow = (long long)L * D;   // dO's row stride
  const T* gbase = go + (long long)b * n * grow + (long long)l * D;
  const long long srow = (long long)pair * n;   // the pair's first row of lse, delta and dS'

  copy_rows<T, D, KB>(keys, base, sn, j0, n);
  copy_rows<T, D, QS>(ring, base, sn, 0, n);
  copy_rows<T, D, QS>(ring + S::kTile, gbase, grow, 0, n);
  glom::cp_async_commit();

  // the warp's share of dV and dK: m-tiles mt0 .. mt0 + MW - 1, quads qw0 ..
  const int mt0 = MW == 2 ? 0 : (warp & 1);
  const int qw0 = MW == 2 ? warp * QW : (warp >> 1) * QW;
  float av[MW][QW][4][4], ak[MW][QW][4][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    glom::zero_tiles(av[mi]);
    glom::zero_tiles(ak[mi]);
  }

  const int steps = (n + QS - 1) / QS;
  for (int it = 0; it < steps; ++it) {
    const int i0 = it * QS;
    glom::cp_async_wait_all();
    __syncthreads();   // this step's tiles (at step 0 the keys too) landed; every warp is done with the last step
    if (it + 1 < steps) {
      T* next = ring + ((it + 1) & 1) * 2 * S::kTile;
      copy_rows<T, D, QS>(next, base, sn, i0 + QS, n);
      copy_rows<T, D, QS>(next + S::kTile, gbase, grow, i0 + QS, n);
      glom::cp_async_commit();
    }
    if (it == 0) key_norms<T, D>(keys, kscale, norm, scale);   // read after the next barrier
    const T* qs = ring + (it & 1) * 2 * S::kTile;
    const T* gs = qs + S::kTile;

    // the warp's partial S (sp[0]) and dP (sp[1]) over its depth slice:
    // mma depth t and t + 4 of k8 step s2 of a 16-deep piece are depth
    // 4 t + 2 s2 and + 1, in A and in B
    float sp[2][4][4];
    glom::zero_tiles(sp);
#pragma unroll
    for (int k0 = 0; k0 < DS; k0 += 16) {
      const int c = warp * DS + k0 + 4 * tig;
      float qv[2][4], gv[2][4];   // rows gid and gid + 8, depths c .. c + 3
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 q = row4<T, D>(qs, gid + 8 * h, c), g = row4<T, D>(gs, gid + 8 * h, c);
        qv[h][0] = q.x, qv[h][1] = q.y, qv[h][2] = q.z, qv[h][3] = q.w;
        gv[h][0] = g.x, gv[h][1] = g.y, gv[h][2] = g.z, gv[h][3] = g.w;
      }
      uint32_t qhi[2][4], qlo[2][4], ghi[2][4], glo[2][4];
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}
          split_s<kExact>(qv[e & 1][2 * s2 + (e >> 1)], qhi[s2][e], qlo[s2][e]);
          split_s<kExact>(gv[e & 1][2 * s2 + (e >> 1)], ghi[s2][e], glo[s2][e]);
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 v = row4<T, D>(keys, 8 * nt + gid, c);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          uint32_t bhi[2], blo[2];   // {B[t][g], B[t+4][g]}: one split for S and dP
          split_s<kExact>(vv[2 * s2], bhi[0], blo[0]);
          split_s<kExact>(vv[2 * s2 + 1], bhi[1], blo[1]);
          mma3<kExact, kExact>(sp[0][nt], qhi[s2], qlo[s2], bhi, blo);
          mma3<kExact, kExact>(sp[1][nt], ghi[s2], glo[s2], bhi, blo);
        }
      }
    }
    float* mine = xchg + warp * XCHG;
#pragma unroll
    for (int v = 0; v < 32; ++v) mine[v * 32 + lane] = sp[v / 16][(v / 4) % 4][v % 4];
    __syncthreads();   // the partials are written

    // warp w: S value slots 2w, 2w + 1 and the matching dP slots, summed
    // over the eight partials in order: a lane's row gid + 8 (w % 2) of the
    // step and keys 8 (w / 2) + 2 tig, + 1 of the block
    {
      float s[2], dp[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* x = xchg + (2 * warp + u) * 32 + lane;
        const float* y = x + 16 * 32;
        float sx = x[0], sy = y[0];
#pragma unroll
        for (int z = 1; z < WARPS; ++z) sx += x[z * XCHG], sy += y[z * XCHG];
        s[u] = sx, dp[u] = sy;
      }
      const int i = i0 + gid + 8 * (warp & 1);
      const int jl = 8 * (warp >> 1) + 2 * tig, j = j0 + jl;
      float p[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
      if (i < n) {
        const float ls = lse[srow + i], dl = delta[srow + i];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          prob_and_ds(s[u], dp[u], kscale[jl + u], ls, dl, i, j + u, n, mask, attend_self, p[u],
                      ds[u]);
        if (ds_out != nullptr)
          glom::store2(ds_out + (srow + i) * npad + j, ds[0] * kscale[jl], ds[1] * kscale[jl + 1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        xchg[(2 * warp + u) * 32 + lane] = p[u];
        xchg[(16 + 2 * warp + u) * 32 + lane] = ds[u] * scale;
      }
    }
    __syncthreads();   // P and dS scale are written

    // dV += P^T dO, then dK += (dS scale)^T Q, over the step's 16 queries
    add_step<T, D, MW, QW, kExact>(av, xchg, gs, mt0, qw0);
    add_step<T, D, MW, QW, kExact>(ak, xchg + 16 * 32, qs, mt0, qw0);
  }

  // the L2-normalize VJP needs v_j . dK_j: a lane's part over its columns,
  // then the quad (tig), then the warps, each in a fixed order.  acc[..][nt][e]
  // holds key 16 mt + gid + 8 (e / 2) at column 32 quad + 4 (2 tig + e % 2) + nt
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * (mt0 + mi) + gid + 8 * half;
      float part = 0.f;
#pragma unroll
      for (int qi = 0; qi < QW; ++qi)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const float4 v = row4<T, D>(keys, r, 32 * (qw0 + qi) + 8 * tig + 4 * e1);
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) part += vv[nt] * ak[mi][qi][nt][2 * half + e1];
        }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (tig == 0) {
        red[warp * KB + r] = part;
        if (MW == 1) red[warp * KB + (r ^ 16)] = 0.f;   // the m-tile this warp does not own
      }
    }
  __syncthreads();
  if (threadIdx.x < KB) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * KB + threadIdx.x];
    dots[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * (mt0 + mi) + gid + 8 * half;
      const int j = j0 + r;
      if (j >= n) continue;
      const float nrm = norm[r];
      const bool big = nrm > NORM_EPS;
      const float inv = 1.f / (big ? nrm : NORM_EPS);
      const float coef = big ? dots[r] * inv * inv * inv : 0.f;
      T* o = dkv + (((long long)b * n + j) * L + l) * D;
#pragma unroll
      for (int qi = 0; qi < QW; ++qi)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int c = 32 * (qw0 + qi) + 8 * tig + 4 * e1;
          const float4 v = row4<T, D>(keys, r, c);
          const float vv[4] = {v.x, v.y, v.z, v.w};
          float out[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int e = 2 * half + e1;
            out[nt] = ak[mi][qi][nt][e] * inv - vv[nt] * coef + av[mi][qi][nt][e];
          }
          glom::store4(o + c, out);
        }
    }
}

// K7.  Grid (row tiles x d tiles, b * L): dq[b, row0 :, l, n0 :] =
// dS'[b, l][row0 :, :] levels[b, :, l, n0 :], a tiled product over the keys.
template <typename T>
__global__ void __launch_bounds__(glom::tile::THREADS, 2)
consensus_bwd_dq_kernel(const float* __restrict__ ds, const T* __restrict__ lv, long long sb,
                        long long sn, long long sl, T* __restrict__ dq, int n, int npad, int L,
                        int dim) {
  using namespace glom::tile;
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int pair = blockIdx.y, b = pair / L, l = pair % L;
  const int per_row = dim / BN;
  const int row0 = blockIdx.x / per_row * BM, n0 = blockIdx.x % per_row * BN;
  float acc[2][4][4];
  tile_product<float, T, false, kExact>(acc, ds + ((long long)pair * n + row0) * npad, npad,
                                        n - row0, lv + b * sb + l * sl + n0, sn, BN, npad,
                                        reinterpret_cast<unsigned char*>(smem4), n);
  const int col = n0 + col_in_tile();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + row_in_tile(q);
    if (row >= n) continue;
    float v[8];
    row_of(acc, q, v);
    glom::store8(dq + (((long long)b * n + row) * L + l) * dim + col, v);
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const T* lv, long long sb, long long sn, long long sl, const T* go,
                       const float* lse, const float* delta, const int8_t* mask, T* out, float* ds,
                       int b, int n, int npad, int L, float scale, int attend_self,
                       cudaStream_t stream) {
  const size_t smem = Layout<T, D>::kBytes;
  cudaError_t err = glom::allow_smem(consensus_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  consensus_bwd_dkv_kernel<T, D><<<dim3(npad / KB, b * L), THREADS, smem, stream>>>(
      lv, sb, sn, sl, go, lse, delta, mask, out, ds, n, npad, L, scale, attend_self);
  return cudaGetLastError();
}

// K6's template instantiations take d up to this; a wider d runs
// consensus_bwd_wide.cuh's design.
constexpr int NARROW_MAX_DIM = 512;

template <typename T>
cudaError_t dispatch_dkv(int dim, const void* lv, long long sb, long long sn, long long sl,
                         const void* go, const float* lse, const float* delta, const int8_t* mask,
                         void* out, float* ds, void* ws, int b, int n, int npad, int L,
                         float scale, int attend_self, cudaStream_t s) {
  const T* x = static_cast<const T*>(lv);
  const T* g = static_cast<const T*>(go);
  T* o = static_cast<T*>(out);
  switch (dim) {
    case 128: return launch_dkv<T, 128>(x, sb, sn, sl, g, lse, delta, mask, o, ds, b, n, npad, L, scale, attend_self, s);
    case 256: return launch_dkv<T, 256>(x, sb, sn, sl, g, lse, delta, mask, o, ds, b, n, npad, L, scale, attend_self, s);
    case 384: return launch_dkv<T, 384>(x, sb, sn, sl, g, lse, delta, mask, o, ds, b, n, npad, L, scale, attend_self, s);
    case 512: return launch_dkv<T, 512>(x, sb, sn, sl, g, lse, delta, mask, o, ds, b, n, npad, L, scale, attend_self, s);
    default:
      if (dim <= NARROW_MAX_DIM || ws == nullptr) return cudaErrorInvalidValue;
      return glom::cons::wide_bwd::launch_dkv<T>(lv, sb, sn, sl, go, lse, delta, mask, out, ds, ws,
                                                 b, n, L, dim, scale, attend_self, s);
  }
}

template <typename T>
cudaError_t launch_dq(const float* ds, const void* lv, long long sb, long long sn, long long sl,
                      void* out, int b, int n, int npad, int L, int dim, cudaStream_t stream) {
  using namespace glom::tile;
  const size_t smem = smem_bytes<float, T>();
  cudaError_t err = glom::allow_smem(consensus_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM * (dim / BN), b * L);
  consensus_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      ds, static_cast<const T*>(lv), sb, sn, sl, static_cast<T*>(out), n, npad, L, dim);
  return cudaGetLastError();
}

// The shapes and layouts both kernels take: levels' rows (and the base) on
// a 16-byte boundary.
bool valid(const void* levels, long long sb, long long sn, long long sl, int b, int n, int L,
           int dim, int dtype) {
  const long long item = dtype == glom::kF32 ? 4 : 2;
  return (dtype == glom::kF32 || dtype == glom::kBF16) && dim % 128 == 0 && dim >= 128 &&
         b >= 1 && n >= 1 && L >= 1 && (long long)b * L <= 65535 &&
         glom::aligned16(levels) && (sb * item) % 16 == 0 && (sn * item) % 16 == 0 &&
         (sl * item) % 16 == 0;
}

int pad_keys(int n) { return (n + KB - 1) / KB * KB; }

}  // namespace

// The f32 workspace glom_consensus_bwd_dkv needs, in floats: none up to
// d=512; above it consensus_bwd_wide.cuh's S, dP, P^T, (dS scale)^T, key
// scales, V^T, dV and dK.  -1 on bad arguments.
extern "C" long long glom_consensus_bwd_workspace(int b, int n, int L, int dim, int dtype) {
  if (dtype != glom::kF32 && dtype != glom::kBF16) return -1;
  if (dim % 128 != 0 || dim < 128 || b < 1 || n < 1 || L < 1 || (long long)b * L > 65535)
    return -1;
  if (dim <= NARROW_MAX_DIM) return 0;
  return glom::cons::wide_bwd::workspace(b, n, L, dim, dtype == glom::kF32 ? 4 : 2).total;
}

// K6.  levels (b, n, L, dim) read through strides sb, sn, sl (elements; the
// last dimension contiguous, every row on a 16-byte boundary); width: the
// model's width, 1 to dim, whose d^-1/2 scales the logits (as
// glom_consensus's); go = dO (b,
// n, L, dim) contiguous, levels' dtype; lse and delta (b, L, n) f32; mask
// (n, n) int8 or bool, contiguous, or null; out = dKV (b, n, L, dim)
// contiguous, levels' dtype; ds: null, or the dS' K7 reads, f32 (b, L, n,
// npad) with npad = n rounded up to 32, every element written; ws: the f32
// workspace of glom_consensus_bwd_workspace's size (null where that is 0).
// go, out, ds and ws 16-byte aligned.  Returns the launches' cudaError_t.
extern "C" int glom_consensus_bwd_dkv(const void* levels, long long sb, long long sn, long long sl,
                                      const void* go, const void* lse, const void* delta,
                                      const void* mask, void* out, void* ds, void* ws, int b,
                                      int n, int L, int dim, int width, int attend_self,
                                      int dtype, void* stream) {
  if (!valid(levels, sb, sn, sl, b, n, L, dim, dtype) || width < 1 || width > dim ||
      !glom::aligned16(go) ||
      !glom::aligned16(out) || !glom::aligned16(ds) || !glom::aligned16(ws) ||
      (dim > NARROW_MAX_DIM && ws == nullptr))
    return cudaErrorInvalidValue;
  const int8_t* m = static_cast<const int8_t*>(mask);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* d = static_cast<float*>(ds);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = glom::logit_scale(width);
  if (dtype == glom::kF32)
    return dispatch_dkv<float>(dim, levels, sb, sn, sl, go, ls, dl, m, out, d, ws, b, n,
                               pad_keys(n), L, scale, attend_self, s);
  return dispatch_dkv<__nv_bfloat16>(dim, levels, sb, sn, sl, go, ls, dl, m, out, d, ws, b, n,
                                     pad_keys(n), L, scale, attend_self, s);
}

// K7.  levels as K6's; ds = the dS' K6 stored for the same levels, f32 (b,
// L, n, npad); out = dQ (b, n, L, dim) contiguous, levels' dtype.  ds and out
// 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int glom_consensus_bwd_dq(const void* levels, long long sb, long long sn, long long sl,
                                     const void* ds, void* out, int b, int n, int L, int dim,
                                     int dtype, void* stream) {
  if (!valid(levels, sb, sn, sl, b, n, L, dim, dtype) || ds == nullptr ||
      !glom::aligned16(ds) || !glom::aligned16(out))
    return cudaErrorInvalidValue;
  const float* d = static_cast<const float*>(ds);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return launch_dq<float>(d, levels, sb, sn, sl, out, b, n, pad_keys(n), L, dim, s);
  return launch_dq<__nv_bfloat16>(d, levels, sb, sn, sl, out, b, n, pad_keys(n), L, dim, s);
}
