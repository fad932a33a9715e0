// Consensus attention forward on the tensor cores, written by hand for
// Hopper (sm_90a): the kernel of K4 (consensus.cu, which replaces
// glom_tpu/kernels/consensus_pallas.py::_forward and ::_forward_blocked)
// and of K8's consensus stage (fused_update.cu).  TO is the output's type:
// K4 stores in the inputs' type, K8 in f32, which its update adds before
// its one rounding.
//
// For each batch b, level l and query row i of levels (b, n, L, d), with
// Q = V = levels[b, :, l] and K = V / max(||V||, 1e-12) row by row:
//     s_ij = (q_i . k_j) * d^-1/2
//     s_ii = -5e-4 unless attend_self          (the soft self-mask)
//     s_ij = -FLT_MAX where mask[i, j] != 0    (the hard locality mask)
//     out_i = softmax_j(s_i) @ V,  lse_i = logsumexp_j(s_ij)
// f32 or bf16 inputs, f32 accumulation; lse is f32 (b, L, n), the residual
// the backward kernels read.
//
// What bounds it on the H100: operations.  A (b, l) pair does 4 n^2 d FLOPs
// on n d inputs, about 250 FLOPs a byte of f32 input at n=256, d=512, and
// the (n, n) logits never leave the chip.  f32 runs on the tensor cores as
// 3xTF32 (an f32 operand is hi + lo in tf32, a product three mma passes), so
// its bound is 3 * 4 n^2 d / 495 TFLOP/s; bf16 runs at the bf16 rate.
//
// The first design (64 query rows and 8 warps a block, scalar loads of each
// key block between barriers, the logits through shared memory for a softmax
// one warp per 8 rows, five barriers a key block, every operand split into
// tf32 parts on every use, bf16 at the tf32 rate) ran at a sixth of the
// tensor cores' rate and took twice the time of scaled_dot_product_attention
// at b=8.  This design:
//  * a block owns 32 query rows of one (b, l), 8 warps, and warp w owns
//    columns [w d/8, (w+1) d/8) of d for all 32 rows (two m-tiles): its
//    (32, d/8) output accumulator stays in registers over the key stream.
//    Each split V fragment serves both m-tiles, so a warp splits half the V
//    values per mma that a 16-row warp would;
//  * the keys stream 32 at a time through a two-stage ring filled with
//    16-byte cp.async copies in the inputs' type (bf16 stays bf16 in shared
//    memory, half the bytes; rows past n are zero-filled), so the next key
//    block's copy overlaps this block's products.  The query tile sits in a
//    third region for the whole stream;
//  * S = Q V^T: each warp forms the (32, 32) logits over its slice of d, and
//    the keys' squared norms over the slice from the same fragments (no pass
//    of its own over the keys).  The eight partials meet in shared memory in
//    fragment order: warp w adds value slots [4w, 4w+4) of all eight in a
//    fixed order into warp 0's part (and warp 0 the key scales), then every
//    warp reads the whole logits back.  Three barriers a key block: the ring
//    stage, the partials, the sums;
//  * the softmax is in registers (a quad of lanes owns a row: max and sum by
//    two shuffles; exp by __expf), and the probabilities are P V's A operand
//    as they are: the accumulator's (g, 2t | 2t+1) layout is read as the A
//    fragment's (g, t | t+4) by taking V's rows in the order 0, 2, 4, 6, 1,
//    3, 5, 7 inside each group of 8 keys.  P never goes to shared memory;
//  * f32: mma.sync m16n8k8 tf32, 3xTF32, the passes hi*lo, lo*hi, hi*hi over
//    independent accumulators in turn.  Q's and V's fragments for S come by
//    ldmatrix; S's operands are split in two ALU operations
//    (split_tf32_trunc: the mma ignores a tf32 operand's low 13 bits), P V's
//    in three (split_tf32, rounded: the truncated split there moved one
//    gradient of the flagship train step from 6.7e-5 to 1.1e-4 of its size).
//    Per 3 mma: 1 split of Q and 1 of V in S, 1 of V in P V (the first
//    design: 4 + 4 splits per 3, of 3 operations each).  bf16: mma.sync
//    m16n8k16 bf16 with f32 accumulation; S in one pass on the exact inputs;
//    P split into bf16 hi + lo, two passes; V's fragments for P V by
//    ldmatrix.trans.  Per key block and warp: 384 tf32 mma in f32, 96 bf16
//    mma in bf16 (the first design: 384 tf32 mma in both);
//  * 32-row tiles: 384 at b=8, n=256 (2.9 waves of one block an SM on 132
//    SMs; 64-row tiles gave 192 = 1.45 waves).  Where a call has too few
//    tiles the keys are split over `splits` blocks (glom_consensus_splits);
//    each writes its unnormalized sums and its rows' (max, sum) to an f32
//    workspace, and a second, elementwise kernel combines them in a fixed
//    order.  With one split the block writes out and lse itself;
//  * the edge rules are consensus_row.cuh's (keys past the block's share
//    -inf, masked pairs -FLT_MAX, the soft self-mask, kscale from the key's
//    norm); every key block holds at least one of its split's keys, so the
//    running max is finite after the first block;
//  * rows in shared memory are padded by 16 bytes, so the ldmatrix rows of
//    S and the column loads of P V (keys 2t and 2t + 1) hit 32 banks;
//  * levels is read through its strides (each row on a 16-byte boundary, the
//    last dimension contiguous), so no transpose to (b, L, n, d) is needed;
//    out is (b, n, L, d) contiguous.
// d must be a multiple of 128, at most 512.  Deterministic: every sum in a
// fixed order, no atomics.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "consensus_row.cuh"

// Internal linkage: K4's library and K8's each hold their own instances.
// With external linkage the function-local cache of blocks_per_sm would be
// one object across both loaded libraries (the dynamic linker unifies such
// statics), and the second library's kernel would never be opted into its
// shared memory.
namespace glom {
namespace cons {
namespace {

constexpr int BQ = 32;                 // query rows per block
constexpr int BK = glom::KEY_BLOCK;    // keys per streamed block
constexpr int WARPS = 8;               // a warp per slice of d, each over all BQ rows
constexpr int THREADS = 32 * WARPS;
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_SPLITS = 8;
// A split's partial sums cost a block about this many key blocks' time to
// write and combine.
constexpr double SPLIT_COST = 1.5;
static_assert(BQ == BK, "the query tile and a key block have one layout");

template <typename T, int D>
struct Layout {
  static constexpr int kRow = D + 16 / sizeof(T);   // rows of the tiles, elements of T
  static constexpr int kTile = BK * kRow;           // a key block or the query tile
  static constexpr int kPart = BQ * BK;             // floats: a warp's partial logits
  // two ring stages and the queries; the partial logits; the partial squared
  // key norms; the key scales (232,064 bytes at d=512 f32, of the 232,448 a
  // block may have)
  static constexpr size_t kBytes =
      sizeof(T) * 3 * kTile + sizeof(float) * (WARPS * kPart + WARPS * BK + BK);
};

// Copy rows [row0, row0 + BK) of levels[b, :, l] (base, rows sn apart) into a
// tile with cp.async, and commit the group; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ base, long long sn,
                                          int row0, int n) {
  constexpr int E = 16 / sizeof(T);
  constexpr int PER_ROW = D / E;
  static_assert(BK * PER_ROW % THREADS == 0, "a tile splits evenly into the block's copies");
#pragma unroll
  for (int u = 0; u < BK * PER_ROW / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS, r = i / PER_ROW, q = i - r * PER_ROW;
    const bool in = row0 + r < n;
    glom::cp_async16_zfill(dst + r * Layout<T, D>::kRow + q * E,
                           base + (long long)(in ? row0 + r : 0) * sn + q * E, in);
  }
  glom::cp_async_commit();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Grid (ceil(n / BQ), b * L, splits).  Warp w owns columns [w D / 8,
// (w + 1) D / 8) of d for all BQ rows: two m-tiles of 16.
template <typename T, int D, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
consensus_kernel(const T* __restrict__ lv, long long sb, long long sn, long long sl,
                 const int8_t* __restrict__ mask, TO* __restrict__ out,
                 float* __restrict__ lse, float* __restrict__ ws_out,
                 float2* __restrict__ ws_stats, int n, int L, float scale, int attend_self,
                 int per_split) {
  using S = Layout<T, D>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int DS = D / WARPS;      // the warp's slice of d
  constexpr int NO = DS / 8;         // n8 tiles of the warp's output columns
  constexpr int KS = kF32 ? 8 : 16;  // depth of an mma
  constexpr int KQ = DS / KS;        // S's k-steps over the slice
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);                 // 2 stages of BK key rows
  const T* qs = ring + 2 * S::kTile;                     // the BQ query rows
  float* xchg = reinterpret_cast<float*>(ring + 3 * S::kTile);   // [warp][32 values][32 lanes]
  float* ksq = xchg + WARPS * S::kPart;                          // [warp][BK] partial squared norms
  float* kscale = ksq + WARPS * BK;                              // [BK]

  const int b = blockIdx.y / L, l = blockIdx.y % L;
  const int q0 = blockIdx.x * BQ;
  const int j_begin = blockIdx.z * per_split * BK;
  const int j_end = min(n, j_begin + per_split * BK);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = warp * DS;
  const T* base = lv + b * sb + l * sl;

  copy_rows<T, D>(ring + 2 * S::kTile, base, sn, q0, n);
  copy_rows<T, D>(ring, base, sn, j_begin, n);

  // ldmatrix row addresses: Q's A fragments (16 x KS), V's B fragments for
  // S (two n-tiles of keys x KS), V's for P V in bf16 (16 keys x two n-tiles)
  const T* qa = qs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * S::kRow + c0 + (lane >> 4) * (KS / 2);
  const int vb = ((lane & 7) + ((lane >> 4) << 3)) * S::kRow + c0 + ((lane >> 3) & 1) * (KS / 2);
  const int vt = ((lane & 7) + (((lane >> 3) & 1) << 3)) * S::kRow + c0 + ((lane >> 4) << 3);

  float o[2][NO][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
  // the running max and sum of rows gid + 8 h of m-tile mt: index 2 mt + h
  float row_max[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float row_sum[4] = {0.f, 0.f, 0.f, 0.f};

  for (int j0 = j_begin, it = 0; j0 < j_end; j0 += BK, ++it) {
    glom::cp_async_wait_all();
    __syncthreads();   // key block `it` (and the queries) landed; every warp is done with block it-1
    if (j0 + BK < j_end) copy_rows<T, D>(ring + ((it + 1) & 1) * S::kTile, base, sn, j0 + BK, n);
    const T* vs = ring + (it & 1) * S::kTile;

    // the warp's partial S over its slice of d (32 rows x 32 keys), and the
    // keys' squared norms over the slice
    float s[2][4][4], ssq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      // bv[np] = {b0, b1} of n-tile 2 np, then of n-tile 2 np + 1
      uint32_t a[2][4], bv[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) glom::ldmatrix_x4(a[mt], qa + mt * 16 * S::kRow + kk * KS);
#pragma unroll
      for (int np = 0; np < 2; ++np) glom::ldmatrix_x4(bv[np], vs + vb + np * 16 * S::kRow + kk * KS);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t w = bv[q / 4][q % 4];
        if constexpr (kF32) {
          const float v = __uint_as_float(w);
          ssq[q / 2] = fmaf(v, v, ssq[q / 2]);
        } else {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
          ssq[q / 2] = fmaf(v.x, v.x, fmaf(v.y, v.y, ssq[q / 2]));
        }
      }
      if constexpr (kF32) {
        uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) glom::split_tf32_trunc(__uint_as_float(a[mt][e]), ahi[mt][e], alo[mt][e]);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          glom::split_tf32_trunc(__uint_as_float(bv[q / 4][q % 4]), bhi[q / 2][q % 2], blo[q / 2][q % 2]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) glom::mma_tf32(s[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) glom::mma_tf32(s[mt][nt], ahi[mt], blo[nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) glom::mma_tf32(s[mt][nt], ahi[mt], bhi[nt]);
      } else {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            glom::mma_bf16(s[mt][nt], a[mt], bv[nt / 2][2 * (nt % 2)], bv[nt / 2][2 * (nt % 2) + 1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      ssq[nt] += __shfl_xor_sync(0xffffffffu, ssq[nt], 1);
      ssq[nt] += __shfl_xor_sync(0xffffffffu, ssq[nt], 2);
    }
    if (tig == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) ksq[warp * BK + nt * 8 + gid] = ssq[nt];
    }
    // the slices' partials meet in fragment order: value v of a lane is
    // s[v / 16][(v / 4) % 4][v % 4]
    float* mine = xchg + warp * S::kPart;
#pragma unroll
    for (int v = 0; v < 32; ++v) mine[v * 32 + lane] = s[v / 16][(v / 4) % 4][v % 4];
    __syncthreads();   // the partial logits and norms are written
    // warp w adds the eight partials of value slots [4 w, 4 w + 4) into
    // warp 0's part; warp 0's lanes also finish the key scales
    {
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* x = xchg + (4 * warp + u) * 32 + lane;
        float acc = x[0];
#pragma unroll
        for (int z = 1; z < WARPS; ++z) acc += x[z * S::kPart];
        r[u] = acc;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) xchg[(4 * warp + u) * 32 + lane] = r[u];
      if (warp == 0) {
        float ss = ksq[lane];
#pragma unroll
        for (int z = 1; z < WARPS; ++z) ss += ksq[z * BK + lane];
        kscale[lane] = glom::key_scale_from_sq(ss, scale);
      }
    }
    __syncthreads();   // the whole logits and the key scales are written
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int mt = v / 16, nt = (v / 4) % 4, e = v % 4;
      const int r = mt * 16 + gid + (e >> 1) * 8, c = nt * 8 + 2 * tig + (e & 1);
      s[mt][nt][e] = glom::consensus_logit(xchg[v * 32 + lane], kscale[c], q0 + r, j0 + c, n,
                                           j_end, mask, attend_self);
    }
    // the online softmax in registers: a quad of lanes holds a row
    float corr[4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * mt + h;
        float mx = row_max[k];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mx = fmaxf(mx, fmaxf(s[mt][nt][2 * h], s[mt][nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          s[mt][nt][2 * h] = __expf(s[mt][nt][2 * h] - mx);
          s[mt][nt][2 * h + 1] = __expf(s[mt][nt][2 * h + 1] - mx);
          sum += s[mt][nt][2 * h] + s[mt][nt][2 * h + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        corr[k] = __expf(row_max[k] - mx);
        row_sum[k] = row_sum[k] * corr[k] + sum;
        row_max[k] = mx;
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        o[mt][nt][0] *= corr[2 * mt];
        o[mt][nt][1] *= corr[2 * mt];
        o[mt][nt][2] *= corr[2 * mt + 1];
        o[mt][nt][3] *= corr[2 * mt + 1];
      }

    // out += P V over the warp's columns
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // the A fragment's k = t, t + 4 are keys 2t, 2t + 1 of the group of 8
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          glom::split_tf32(s[mt][kk][0], ahi[mt][0], alo[mt][0]);
          glom::split_tf32(s[mt][kk][2], ahi[mt][1], alo[mt][1]);
          glom::split_tf32(s[mt][kk][1], ahi[mt][2], alo[mt][2]);
          glom::split_tf32(s[mt][kk][3], ahi[mt][3], alo[mt][3]);
        }
        const float* v0 = reinterpret_cast<const float*>(vs) + (kk * 8 + 2 * tig) * S::kRow + c0 + gid;
#pragma unroll
        for (int g0 = 0; g0 < NO; g0 += 2) {
          uint32_t bhi[2][2], blo[2][2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            glom::split_tf32(v0[(g0 + q) * 8], bhi[q][0], blo[q][0]);
            glom::split_tf32(v0[S::kRow + (g0 + q) * 8], bhi[q][1], blo[q][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int q = 0; q < 2; ++q) glom::mma_tf32(o[mt][g0 + q], alo[mt], bhi[q]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int q = 0; q < 2; ++q) glom::mma_tf32(o[mt][g0 + q], ahi[mt], blo[q]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int q = 0; q < 2; ++q) glom::mma_tf32(o[mt][g0 + q], ahi[mt], bhi[q]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // P = hi + lo in bf16: two passes on the exact V
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[mt][2 * kk + (e >> 1)][2 * (e & 1)];
            const float y = s[mt][2 * kk + (e >> 1)][2 * (e & 1) + 1];
            ahi[mt][e] = pack_bf16(x, y);
            const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ahi[mt][e]));
            alo[mt][e] = pack_bf16(x - h.x, y - h.y);
          }
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bv[4];
          glom::ldmatrix_x4_trans(bv, vs + vt + kk * 16 * S::kRow + np * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            glom::mma_bf16(o[mt][2 * np], alo[mt], bv[0], bv[1]);
            glom::mma_bf16(o[mt][2 * np + 1], alo[mt], bv[2], bv[3]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            glom::mma_bf16(o[mt][2 * np], ahi[mt], bv[0], bv[1]);
            glom::mma_bf16(o[mt][2 * np + 1], ahi[mt], bv[2], bv[3]);
          }
        }
      }
    }
  }

  // One split writes the result; several write their unnormalized sums and
  // (max, sum) for combine_splits_kernel.
  const long long split_elems = (long long)gridDim.y * n * D;   // b * n * L * D
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * mt + h;
      const int i = q0 + mt * 16 + gid + 8 * h;
      if (i >= n) continue;
      const long long o_row = (((long long)b * n + i) * L + l) * D + c0 + 2 * tig;
      const float rden = ws_out == nullptr ? 1.f / row_sum[k] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        const float v0 = o[mt][nt][2 * h] * rden, v1 = o[mt][nt][2 * h + 1] * rden;
        if (ws_out == nullptr) glom::store2(out + o_row + nt * 8, v0, v1);
        else glom::store2(ws_out + blockIdx.z * split_elems + o_row + nt * 8, v0, v1);
      }
      if (warp == 0 && tig == 0) {
        const long long row = ((long long)b * L + l) * n + i;
        if (ws_out == nullptr) lse[row] = row_max[k] + logf(row_sum[k]);
        else ws_stats[blockIdx.z * ((long long)gridDim.y * n) + row] = make_float2(row_max[k], row_sum[k]);
      }
    }
}

// Combine the splits' partial results: for a row with per-split (m_z, s_z)
// and unnormalized sums o_z, M = max m_z, w_z = exp(m_z - M),
// out = sum w_z o_z / sum w_z s_z and lse = M + log(sum w_z s_z).  Four
// elements of out a thread, splits in a fixed order.
template <typename TO>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_splits_kernel(const float* __restrict__ ws_out, const float2* __restrict__ ws_stats,
                      TO* __restrict__ out, float* __restrict__ lse, long long total, int n,
                      int L, int dim, int splits) {
  const long long e = 4 * ((long long)blockIdx.x * COMBINE_THREADS + threadIdx.x);
  if (e >= total) return;
  const long long rl = e / dim;                 // ((b * n) + i) * L + l
  const int l = static_cast<int>(rl % L);
  const long long bi = rl / L;                  // b * n + i
  const long long row = (bi / n * L + l) * n + bi % n;   // (b * L + l) * n + i
  const long long rows = total / dim;           // b * n * L
  float m = -INFINITY;
  for (int z = 0; z < splits; ++z) m = fmaxf(m, ws_stats[z * rows + row].x);
  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float2 st = ws_stats[z * rows + row];
    const float w = expf(st.x - m);
    const float4 v = *reinterpret_cast<const float4*>(ws_out + z * total + e);
    sum += w * st.y;
    acc.x += w * v.x; acc.y += w * v.y; acc.z += w * v.z; acc.w += w * v.w;
  }
  const float rden = 1.f / sum;
  glom::store2(out + e, acc.x * rden, acc.y * rden);
  glom::store2(out + e + 2, acc.z * rden, acc.w * rden);
  if (e % dim == 0) lse[row] = m + logf(sum);
}

// How many blocks of the kernel for (T, D) an SM runs at once, after
// opting it into its shared memory: asked once per device, since the
// attribute and the answer do not change and asking costs host time.
template <typename T, int D, typename TO>
int blocks_per_sm() {
  static int known[64];   // per device: 0 not asked yet, else blocks + 1
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return -1;
  if (known[device] == 0) {
    const size_t smem = Layout<T, D>::kBytes;
    int blocks = 0;
    if (glom::allow_smem(consensus_kernel<T, D, TO>, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, consensus_kernel<T, D, TO>, THREADS,
                                                      smem) != cudaSuccess)
      return -1;
    known[device] = blocks + 1;
  }
  return known[device] - 1;
}

template <typename T, int D, typename TO>
cudaError_t launch(const void* lv, long long sb, long long sn, long long sl,
                   const int8_t* mask, void* out, float* lse, void* ws, int b, int n, int L,
                   int attend_self, int splits, cudaStream_t stream) {
  if (blocks_per_sm<T, D, TO>() < 1) return cudaErrorInvalidConfiguration;
  const int kblocks = (n + BK - 1) / BK;
  const int per_split = (kblocks + splits - 1) / splits;
  splits = (kblocks + per_split - 1) / per_split;   // no empty split
  const long long total = (long long)b * n * L * D;
  float* ws_out = splits > 1 ? static_cast<float*>(ws) : nullptr;
  float2* ws_stats = splits > 1 ? reinterpret_cast<float2*>(ws_out + splits * total) : nullptr;
  const dim3 grid((n + BQ - 1) / BQ, b * L, splits);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  consensus_kernel<T, D, TO><<<grid, THREADS, Layout<T, D>::kBytes, stream>>>(
      static_cast<const T*>(lv), sb, sn, sl, mask, static_cast<TO*>(out), lse, ws_out, ws_stats,
      n, L, scale, attend_self, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws_out == nullptr) return err;
  const long long blocks = (total / 4 + COMBINE_THREADS - 1) / COMBINE_THREADS;
  combine_splits_kernel<TO><<<static_cast<unsigned>(blocks), COMBINE_THREADS, 0, stream>>>(
      ws_out, ws_stats, static_cast<TO*>(out), lse, total, n, L, D, splits);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t dispatch(int dim, const void* lv, long long sb, long long sn, long long sl,
                     const int8_t* mask, void* out, float* lse, void* ws, int b, int n, int L,
                     int attend_self, int splits, cudaStream_t stream) {
  switch (dim) {
    case 128: return launch<T, 128, TO>(lv, sb, sn, sl, mask, out, lse, ws, b, n, L, attend_self, splits, stream);
    case 256: return launch<T, 256, TO>(lv, sb, sn, sl, mask, out, lse, ws, b, n, L, attend_self, splits, stream);
    case 384: return launch<T, 384, TO>(lv, sb, sn, sl, mask, out, lse, ws, b, n, L, attend_self, splits, stream);
    case 512: return launch<T, 512, TO>(lv, sb, sn, sl, mask, out, lse, ws, b, n, L, attend_self, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}


}  // namespace
}  // namespace cons
}  // namespace glom
