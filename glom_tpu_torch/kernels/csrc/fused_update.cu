// One whole GLOM level update in one launch, written by hand for Hopper
// (sm_90a).
//
// Replaces: glom_tpu/kernels/fused_update_pallas.py::_forward (the TPU
// kernel body `_kernel`).  For each batch b, level l and patch i of levels
// (b, n, L, d), with tokens = bottom[b, :, 0] and pos = pos[0, :, 0]:
//     bu   = BU_l(tokens_i if l == 0 else levels[b, i, l-1])
//     td   = TD_l(levels[b, i, l+1] + pos_i) if l < L-1 else 0
//     cons = consensus(levels[b, :, l])_i
//     out[b, i, l] = (((levels[b, i, l] + bu) + td) + cons) / (3 if l == L-1 else 4)
// BU_l and TD_l are group l of the two grouped feed-forward nets (two layers,
// exact-erf GELU, b1 added before it and b2 after the sum over the hidden, as
// grouped_ff.cu); consensus is consensus.cu's row (keys the L2-normalised
// levels, scale d^-1/2, soft self-mask, locality mask).  The top level adds
// its zero top-down term instead of skipping it, as the unfused composition
// does, so -0.0 comes out as it does there.  f32 or bf16 inputs (all one
// type); as in the TPU kernel every input is widened to f32, everything is
// computed in f32 (the level l+1 + pos sum included), and out is rounded to
// the inputs' type once, at its store.
//
// What bounds it: operations.  At the flagship shapes (b=8, n=256, L=6,
// d=512, h=2048) an update does 4*d*h FLOPs a row for each of the 11 nets'
// groups and 4*n*d a row of each level for consensus: 100.9 GFLOP on about
// 150 MB of inputs and outputs, 670 FLOPs a byte.  The unfused path runs
// three kernels and writes the (b, n, L, d) bottom-up, top-down and
// consensus terms to device memory, pads one, and reads them back for the
// sum.
//
// What the design does about it:
//  * one block owns 32 patches of one (b, l) and computes the three terms
//    one after the other over ONE (32, d) f32 accumulator in the registers of
//    its 8 warps (each warp 32 rows x d/8 columns): bottom-up over the whole
//    hidden, then top-down, then the consensus row.  The TPU kernel's three
//    (bn, d) accumulators do not fit side by side in a block's registers.
//    The running sum is parked in shared memory between the phases, in the
//    order of the TPU kernel's final line: q + bu, then + td, then + cons;
//    nothing but the inputs and out crosses device memory;
//  * the products run on the tensor cores through tile_mma.cuh (mma.sync,
//    3xTF32 for f32 operands, one pass for operands that came from bf16; each
//    depth-16 product of the second layer and of P V added to the
//    accumulator with an f32 add, which rounds to nearest);
//  * a net's phase is grouped_ff.cu's loop on a 32-row tile: the hidden in
//    chunks of 64, the weights streamed as slabs (128 rows of w1's chunk
//    columns, or 16 rows of w2) through a two-stage ring filled with
//    cp.async in the inputs' type, so the next slab's copy overlaps this
//    slab's products and one barrier comes per slab.  gelu(x @ w1 + b1) of a
//    chunk goes to shared memory (each warp a 16 x 16 tile over the whole
//    depth), then its product with w2's chunk rows into the accumulator.
//    The hidden never leaves the chip;
//  * a (256, 512) f32 K/V row is 512 KB, so the consensus phase streams the
//    keys 32 at a time with the online softmax and the edge rules of
//    consensus_row.cuh, which consensus.cu shares;
//  * the index maps of the TPU kernel are pointer arithmetic here: levels is
//    read through its strides ((b, n, L, d), no transpose), the bottom-up
//    input is the tokens at l = 0 and level l-1 above, the top-down input
//    level l+1 plus pos (added in f32 and never rounded, as the TPU kernel
//    adds it), and the top level runs no top-down net at all;
//  * the x tile, the parked sum, the hidden chunk and the ring take about
//    214 KB of shared memory at d=512 f32, so one block runs on an SM.  A
//    call has L * b * ceil(n / 32) tiles: 384 at b=8, three waves on 132
//    SMs, but 48 at b=1.  A tile's work is therefore split over `splits`
//    blocks where that fills the card (the wrapper picks the count): split z
//    takes its share of both nets' hidden chunks and of the key blocks and
//    writes its three partial terms, and its rows' softmax (max, sum), to an
//    f32 workspace; a second, elementwise kernel adds the partials in a
//    fixed order, so the result does not depend on timing, and forms the
//    final sum in the same order.  With one split the block writes out
//    itself.  wgmma and TMA are later work.
//
// Layout: levels, bottom and pos are read through strides (elements; the
// last dimension contiguous, every row on a 4-element boundary); the weights
// (bottom_up: L groups, top_down: L-1) and out (b, n, L, d) are contiguous,
// w1 and w2 on a 16-byte boundary (cp.async).  d must be a multiple of 128,
// at most 512; h a multiple of 64.

#include <type_traits>

#include "common.cuh"
#include "consensus_row.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int BM = 32;         // patches (rows) per block
constexpr int HC = 64;         // hidden units per chunk
constexpr int KS = 128;        // rows (of d) of a w1 slab
constexpr int VS = 16;         // rows (of the chunk) of a w2 slab
constexpr int BK = glom::KEY_BLOCK;
constexpr int THREADS = 256;   // 8 warps
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_SPLITS = 8;

template <typename T, int D>
struct Layout {
  static constexpr int kRow = D + 4;     // x / query tile, parked sum, key tile (32, D), f32
  static constexpr int kH = HC + 4;      // gelu(hidden chunk) (BM, HC), f32
  static constexpr int kW1 = HC + 8;     // w1 slab (KS, HC), elements of T
  static constexpr int kW2 = D + 8;      // w2 slab (VS, D), elements of T
  static constexpr int kP = BK + 4;      // logits, then probabilities (BM, BK), f32
  // one stage of the weight ring holds a w1 slab or a w2 slab (elements of T)
  static constexpr int kStage = KS * kW1 > VS * kW2 ? KS * kW1 : VS * kW2;
  // the nets' phases and the consensus phase share one region (bytes)
  static constexpr size_t kFF = sizeof(float) * BM * kH + sizeof(T) * 2 * kStage;
  static constexpr size_t kCons = sizeof(float) * (BK * kRow + BM * kP + BK + 3 * BM);
  static constexpr size_t kBytes = sizeof(float) * 2 * BM * kRow + (kFF > kCons ? kFF : kCons);
};

__device__ __forceinline__ float gelu(float z) {
  return z * (0.5f * (1.0f + erff(z * 0.70710678118654752440f)));
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Start the copy of slab s of the block's weight stream into its ring stage.
// The stream is, for each hidden chunk c0, c0 + 1, ..., D / KS slabs of w1's
// chunk columns, then HC / VS slabs of w2's chunk rows.
template <typename T, int D>
__device__ __forceinline__ void issue_slab(int s, int c0, T* ring, const T* __restrict__ w1g,
                                           const T* __restrict__ w2g, int hidden) {
  using S = Layout<T, D>;
  constexpr int N1 = D / KS, N2 = HC / VS;
  constexpr int E = 16 / sizeof(T);   // elements a 16-byte copy moves
  const int c = c0 + s / (N1 + N2), j = s % (N1 + N2);
  T* dst = ring + (s & 1) * S::kStage;
  if (j < N1) {
    const T* src = w1g + (long long)(j * KS) * hidden + c * HC;
    constexpr int PER_ROW = HC / E;
    for (int i = threadIdx.x; i < KS * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, q = i - r * PER_ROW;
      glom::cp_async16(dst + r * S::kW1 + q * E, src + (long long)r * hidden + q * E);
    }
  } else {
    const T* src = w2g + (long long)(c * HC + (j - N1) * VS) * D;
    constexpr int PER_ROW = D / E;
    for (int i = threadIdx.x; i < VS * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, q = i - r * PER_ROW;
      glom::cp_async16(dst + r * S::kW2 + q * E, src + (long long)r * D + q * E);
    }
  }
  glom::cp_async_commit();
}

// acc = gelu(xs @ w1 + b1) @ w2 for the (BM, D) tile in xs and one group's
// weights, summed over hidden chunks [c0, c0 + chunks); b2 is the caller's.
// `scratch` is the shared region of Layout::kFF bytes.
template <typename T, int D>
__device__ __forceinline__ void ff_term(float (&acc)[2][D / 64][4], const float* xs,
                                        float* scratch, const T* __restrict__ w1g,
                                        const T* __restrict__ b1g, const T* __restrict__ w2g,
                                        int hidden, int c0, int chunks) {
  using S = Layout<T, D>;
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr int NT = D / 64;
  constexpr int N1 = D / KS, N2 = HC / VS;
  float* hs = scratch;                                   // [BM][kH]  gelu(hidden chunk)
  T* ring = reinterpret_cast<T*>(hs + BM * S::kH);       // 2 stages of weight slabs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;             // mma fragment coordinates
  // x @ w1: the warp's 16 rows x 16 hidden columns of the chunk
  const int m1 = (warp & 1) * 16, n1 = (warp >> 1) * 16;
  // hidden @ w2: the warp's 32 rows x D/8 output columns
  const int n2 = warp * (D / 8);
  const int steps = chunks * (N1 + N2);
  float pre[1][2][4];
  zero<NT>(acc);
  __syncthreads();   // every warp is done with the region's earlier use
  if (steps > 0) issue_slab<T, D>(0, c0, ring, w1g, w2g, hidden);
  for (int s = 0; s < steps; ++s) {
    glom::cp_async_wait_all();
    __syncthreads();   // slab s has landed, every warp is done with slab s-1, and xs is written
    if (s + 1 < steps) issue_slab<T, D>(s + 1, c0, ring, w1g, w2g, hidden);
    const int c = c0 + s / (N1 + N2), j = s % (N1 + N2);
    const T* wsl = ring + (s & 1) * S::kStage;
    if (j < N1) {
      if (j == 0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pre[0][nt][e] = 0.f;
      }
      glom::warp_mma_long<1, 2, kExact, kExact>(pre, xs + m1 * S::kRow + j * KS, S::kRow, 1,
                                                wsl + n1, S::kW1, 1, KS);
      if (j == N1 - 1) {
        // the chunk's hidden: bias and GELU, into shared memory for hidden @ w2
        // (the next step's barrier publishes it to the other warps)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = n1 + nt * 8 + 2 * tig;
          const float bias0 = glom::to_f32(b1g[c * HC + col]);
          const float bias1 = glom::to_f32(b1g[c * HC + col + 1]);
          float* h0 = hs + (m1 + gid) * S::kH + col;
          h0[0] = gelu(pre[0][nt][0] + bias0);
          h0[1] = gelu(pre[0][nt][1] + bias1);
          h0[8 * S::kH] = gelu(pre[0][nt][2] + bias0);
          h0[8 * S::kH + 1] = gelu(pre[0][nt][3] + bias1);
        }
      }
    } else {
      // VS rows of the chunk: hidden[:, k : k + VS] @ w2[chunk rows k.., :]
      const int k = (j - N1) * VS;
      glom::warp_mma<2, NT, VS, false, kExact>(acc, hs + k, S::kH, 1, wsl + n2, S::kW2, 1);
    }
  }
}

// acc = softmax(q k^T) v for the (BM, D) queries in qs against keys [j_begin,
// j_end) of levels[b, :, l] (base, rows sn apart), unnormalized: row r's sums are over
// exp(logit - row_max[r]) and row_sum[r] is their total.  `scratch` is the
// shared region of Layout::kCons bytes; row_sum points into it.
template <typename T, int D>
__device__ __forceinline__ void consensus_term(float (&acc)[2][D / 64][4], const float* qs,
                                               float* scratch, const T* __restrict__ base,
                                               long long sn, const int8_t* __restrict__ mask,
                                               int q0, int n, int j_begin, int j_end,
                                               float scale, int attend_self, float*& row_max,
                                               float*& row_sum) {
  using S = Layout<T, D>;
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr int NT = D / 64;
  float* vs = scratch;                   // [BK][kRow]  this key block
  float* ps = vs + BK * S::kRow;         // [BM][kP]    logits, then probabilities
  float* kscale = ps + BM * S::kP;       // [BK]
  float* corr = kscale + BK;             // [BM]
  row_max = corr + BM;                   // [BM]
  row_sum = row_max + BM;                // [BM]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2;
  const int tm = warp & 1, tn = warp >> 1;   // the warp's 16 x 8 tile of the (32, 32) logits
  const int n2 = warp * (D / 8);
  zero<NT>(acc);
  __syncthreads();   // every warp is done with the region's earlier use
  if (tid < BM) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.f;
  }
  for (int j0 = j_begin; j0 < j_end; j0 += BK) {
    __syncthreads();   // every warp is done with the previous key block (and qs is written)
    glom::load_tile<BK, D, THREADS>(vs, S::kRow, base, sn, j0, n);
    __syncthreads();
    glom::key_scales<D>(vs, S::kRow, kscale, nullptr, scale);
    {
      // B(k, key) = vs[key * kRow + k]
      float t[1][1][4] = {{{0.f, 0.f, 0.f, 0.f}}};
      glom::warp_mma_long<1, 1, kExact, kExact>(t, qs + tm * 16 * S::kRow, S::kRow, 1,
                                                vs + tn * 8 * S::kRow, 1, S::kRow, D);
      glom::store_tile(ps + tm * 16 * S::kP + tn * 8, S::kP, t[0][0]);
    }
    __syncthreads();
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e - r * BK;
      ps[r * S::kP + c] = glom::consensus_logit(ps[r * S::kP + c], kscale[c], q0 + r, j0 + c, n,
                                                j_end, mask, attend_self);
    }
    __syncthreads();
    glom::softmax_update<BM>(ps, S::kP, row_max, row_sum, corr);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float c0 = corr[mt * 16 + gid], c1 = corr[mt * 16 + gid + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[mt][nt][0] *= c0;
        acc[mt][nt][1] *= c0;
        acc[mt][nt][2] *= c1;
        acc[mt][nt][3] *= c1;
      }
    }
    glom::warp_mma<2, NT, BK, false, kExact>(acc, ps, S::kP, 1, vs + n2, S::kRow, 1);
  }
}

// A call's arguments, as the kernels read them.
template <typename T>
struct Args {
  const T* lv;          // levels (b, n, L, D) through strides sb, sn, sl
  long long sb, sn, sl;
  const T* tok;         // bottom (b, n, 1, D) through tsb, tsn
  long long tsb, tsn;
  const T* pos;         // pos (1, n, 1, D) through psn
  long long psn;
  const T* w[8];        // bottom-up w1, b1, w2, b2; top-down w1, b1, w2, b2
  const int8_t* mask;   // (n, n) or null
  T* out;               // (b, n, L, D)
  // with splits > 1: per split the (b, n, L, D) partial bottom-up, top-down
  // and consensus sums, then per split a (max, sum) per row; else null
  float* ws;
  int n, L, hidden, attend_self, splits;
  float scale;
};

// Grid (ceil(n / BM), b * L, splits).  Split z takes hidden chunks
// [z * cps, (z + 1) * cps) of both nets and key blocks [z * kps, (z + 1) * kps).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) fused_update_kernel(const Args<T> a) {
  using S = Layout<T, D>;
  constexpr int NT = D / 64;   // n8 tiles in a warp's D/8 output columns
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [BM][kRow]  a net's input, then the queries
  float* ss = xs + BM * S::kRow;                 // [BM][kRow]  the parked running sum
  float* scratch = ss + BM * S::kRow;            // a net's chunk and ring, or a key block

  const int n = a.n, L = a.L, hidden = a.hidden;
  const int b = blockIdx.y / L, l = blockIdx.y % L;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int n2 = warp * (D / 8);
  const T* row_l = a.lv + b * a.sb + l * a.sl;   // levels[b, :, l], rows sn apart
  // this block's share of the hidden chunks and of the keys
  const int all_chunks = hidden / HC, all_kblocks = (n + BK - 1) / BK;
  const int cps = (all_chunks + a.splits - 1) / a.splits;
  const int kps = (all_kblocks + a.splits - 1) / a.splits;
  const int c0 = blockIdx.z * cps, chunks = max(0, min(cps, all_chunks - c0));
  const int j_begin = blockIdx.z * kps * BK, j_end = min(n, j_begin + kps * BK);
  // one split keeps the running sum on-chip; several write partial terms
  const long long total = (long long)gridDim.y * n * D;   // b * n * L * D
  float* part = a.ws == nullptr ? nullptr : a.ws + (long long)blockIdx.z * 3 * total;
  float acc[2][NT][4];

  // bottom-up: group l reads the tokens at the bottom, level l-1 above
  if (l == 0) glom::load_tile<BM, D, THREADS>(xs, S::kRow, a.tok + b * a.tsb, a.tsn, q0, n);
  else glom::load_tile<BM, D, THREADS>(xs, S::kRow, row_l - a.sl, a.sn, q0, n);
  ff_term<T, D>(acc, xs, scratch, a.w[0] + (long long)l * D * hidden,
                a.w[1] + (long long)l * hidden, a.w[2] + (long long)l * hidden * D, hidden, c0,
                chunks);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + gid + 8 * hf;
      const int i = min(q0 + r, n - 1);   // a row past n is never written out
      const long long o = (((long long)b * n + i) * L + l) * D;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n2 + nt * 8 + 2 * tig;
        if (part != nullptr) {
          if (q0 + r < n) glom::store2(part + o + col, acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float q = glom::to_f32(row_l[i * a.sn + col + e]);
          const float bu = acc[mt][nt][2 * hf + e] + glom::to_f32(a.w[3][l * D + col + e]);
          ss[r * S::kRow + col + e] = q + bu;
        }
      }
    }

  // top-down: group l reads level l+1 plus pos; the top level has none
  const bool has_td = l < L - 1;
  if (has_td) {
    // xs was last read before the bottom-up phase's closing barriers
    glom::load_tile<BM, D, THREADS>(xs, S::kRow, row_l + a.sl, a.sn, q0, n);
    __syncthreads();
    for (int i = tid; i < BM * D; i += THREADS) {
      const int r = i / D, k = i - r * D;
      if (q0 + r < n) {
        xs[r * S::kRow + k] += glom::to_f32(a.pos[(q0 + r) * a.psn + k]);   // in f32, not rounded
      }
    }
    ff_term<T, D>(acc, xs, scratch, a.w[4] + (long long)l * D * hidden,
                  a.w[5] + (long long)l * hidden, a.w[6] + (long long)l * hidden * D, hidden, c0,
                  chunks);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + gid + 8 * hf;
      const long long o = (((long long)b * n + q0 + r) * L + l) * D;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n2 + nt * 8 + 2 * tig;
        if (part != nullptr) {   // the combine kernel adds the top level's zero
          if (has_td && q0 + r < n)
            glom::store2(part + total + o + col, acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // the top level adds a zero, as the unfused composition's pad does
          const float td =
              has_td ? acc[mt][nt][2 * hf + e] + glom::to_f32(a.w[7][l * D + col + e]) : 0.f;
          ss[r * S::kRow + col + e] += td;
        }
      }
    }

  // consensus over levels[b, :, l]
  glom::load_tile<BM, D, THREADS>(xs, S::kRow, row_l, a.sn, q0, n);
  float *row_max, *row_sum;
  consensus_term<T, D>(acc, xs, scratch, row_l, a.sn, a.mask, q0, n, j_begin, j_end, a.scale,
                       a.attend_self, row_max, row_sum);
  const float div = l == L - 1 ? 3.f : 4.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + gid + 8 * hf;
      const int i = q0 + r;
      if (i >= n) continue;
      const long long o = (((long long)b * n + i) * L + l) * D + n2 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (part != nullptr) {   // unnormalized: the combine kernel weighs the splits
          glom::store2(part + 2 * total + o + nt * 8, acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
          continue;
        }
        const float rden = 1.f / row_sum[r];
        const float* s = ss + r * S::kRow + n2 + nt * 8 + 2 * tig;
        glom::store2(a.out + o + nt * 8, (s[0] + acc[mt][nt][2 * hf] * rden) / div,
                     (s[1] + acc[mt][nt][2 * hf + 1] * rden) / div);
      }
    }
  if (part != nullptr && tid < BM && q0 + tid < n) {
    const long long rows = total / D;   // b * n * L
    float2* stats = reinterpret_cast<float2*>(a.ws + (long long)a.splits * 3 * total);
    stats[blockIdx.z * rows + ((long long)b * n + q0 + tid) * L + l] =
        make_float2(row_max[tid], row_sum[tid]);
  }
}

// Combine the splits' partial terms, four elements of out a thread, splits
// in a fixed order: bu = sum_z bu_z + b2, td = sum_z td_z + b2 (0 at the top
// level), and for a row with per-split (m_z, s_z) and unnormalized sums o_z,
// M = max m_z, w_z = exp(m_z - M), cons = sum w_z o_z / sum w_z s_z (a split
// with no key has m_z = -inf and weighs 0); then the kernel's final line.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS) combine_splits_kernel(const Args<T> a, int dim,
                                                                          long long total) {
  const long long e = 4 * ((long long)blockIdx.x * COMBINE_THREADS + threadIdx.x);
  if (e >= total) return;
  const int n = a.n, L = a.L;
  const long long rl = e / dim;                  // (b * n + i) * L + l
  const int col = static_cast<int>(e - rl * dim), l = static_cast<int>(rl % L);
  const long long bi = rl / L;                   // b * n + i
  const long long rows = total / dim;
  const float2* stats = reinterpret_cast<const float2*>(a.ws + (long long)a.splits * 3 * total);
  const bool has_td = l < L - 1;
  float m = -INFINITY;
  for (int z = 0; z < a.splits; ++z) m = fmaxf(m, stats[z * rows + rl].x);
  float bu[4] = {0.f, 0.f, 0.f, 0.f}, td[4] = {0.f, 0.f, 0.f, 0.f}, cons[4] = {0.f, 0.f, 0.f, 0.f};
  float sum = 0.f;
  for (int z = 0; z < a.splits; ++z) {
    const float* part = a.ws + (long long)z * 3 * total + e;
    const float4 u = *reinterpret_cast<const float4*>(part);
    const float4 c = *reinterpret_cast<const float4*>(part + 2 * total);
    const float2 st = stats[z * rows + rl];
    const float w = expf(st.x - m);
    sum += w * st.y;
    bu[0] += u.x; bu[1] += u.y; bu[2] += u.z; bu[3] += u.w;
    cons[0] += w * c.x; cons[1] += w * c.y; cons[2] += w * c.z; cons[3] += w * c.w;
    if (has_td) {
      const float4 t = *reinterpret_cast<const float4*>(part + total);
      td[0] += t.x; td[1] += t.y; td[2] += t.z; td[3] += t.w;
    }
  }
  const T* q = a.lv + (bi / n) * a.sb + (bi % n) * a.sn + l * a.sl + col;
  const float rden = 1.f / sum, div = l == L - 1 ? 3.f : 4.f;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float b_k = bu[k] + glom::to_f32(a.w[3][l * dim + col + k]);
    const float t_k = has_td ? td[k] + glom::to_f32(a.w[7][l * dim + col + k]) : 0.f;
    o[k] = (((glom::to_f32(q[k]) + b_k) + t_k) + cons[k] * rden) / div;
  }
  glom::store2(a.out + e, o[0], o[1]);
  glom::store2(a.out + e + 2, o[2], o[3]);
}

template <typename T, int D>
cudaError_t launch(const Args<T>& a, int b, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::kBytes;
  cudaError_t err = glom::allow_smem(fused_update_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + BM - 1) / BM, b * a.L, a.splits);
  fused_update_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ws == nullptr) return err;
  const long long total = (long long)b * a.n * a.L * D;
  const long long blocks = (total / 4 + COMBINE_THREADS - 1) / COMBINE_THREADS;
  combine_splits_kernel<T><<<static_cast<unsigned>(blocks), COMBINE_THREADS, 0, stream>>>(a, D, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dim, const Args<T>& a, int b, cudaStream_t s) {
  switch (dim) {
    case 128: return launch<T, 128>(a, b, s);
    case 256: return launch<T, 256>(a, b, s);
    case 384: return launch<T, 384>(a, b, s);
    case 512: return launch<T, 512>(a, b, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(int dim, const void* lv, long long sb, long long sn, long long sl, const void* tok,
                long long tsb, long long tsn, const void* pos, long long psn,
                const void* const* w, const void* mask, void* out, void* ws, int b, int n, int L,
                int hidden, int attend_self, int splits, cudaStream_t s) {
  Args<T> a;
  a.lv = static_cast<const T*>(lv); a.sb = sb; a.sn = sn; a.sl = sl;
  a.tok = static_cast<const T*>(tok); a.tsb = tsb; a.tsn = tsn;
  a.pos = static_cast<const T*>(pos); a.psn = psn;
  for (int i = 0; i < 8; ++i) a.w[i] = static_cast<const T*>(w[i]);
  a.mask = static_cast<const int8_t*>(mask);
  a.out = static_cast<T*>(out);
  a.ws = splits > 1 ? static_cast<float*>(ws) : nullptr;
  a.n = n; a.L = L; a.hidden = hidden; a.attend_self = attend_self; a.splits = splits;
  a.scale = 1.0f / sqrtf(static_cast<float>(dim));
  return dispatch<T>(dim, a, b, s);
}

}  // namespace

// levels (b, n, L, dim) read through strides sb, sn, sl; bottom (b, n, 1, dim)
// through tsb, tsn; pos (1, n, 1, dim) through psn (elements; last dimension
// contiguous, every row on a 4-element boundary).  bw1 (L, dim, hidden), bb1
// (L, hidden), bw2 (L, hidden, dim), bb2 (L, dim): the bottom-up net; tw1,
// tb1, tw2, tb2: the top-down net, L-1 groups; contiguous, the weights on a
// 16-byte boundary.  mask (n, n) int8 or bool, contiguous, or null; out
// (b, n, L, dim) contiguous.  All of one dtype.  splits: how many blocks
// share a tile's hidden chunks and keys, 1 to 8; with more than one, ws is an
// f32 workspace of splits * b * n * L * (3 * dim + 2) elements, 16-byte
// aligned.  Returns the launches' cudaError_t.
extern "C" int glom_fused_update(const void* levels, long long sb, long long sn, long long sl,
                                 const void* bottom, long long tsb, long long tsn,
                                 const void* pos, long long psn, const void* bw1,
                                 const void* bb1, const void* bw2, const void* bb2,
                                 const void* tw1, const void* tb1, const void* tw2,
                                 const void* tb2, const void* mask, void* out, void* ws, int b,
                                 int n, int L, int dim, int hidden, int attend_self, int splits,
                                 int dtype, void* stream) {
  if (dim % 128 != 0 || dim < 128 || dim > 512 || hidden % HC != 0 || hidden < HC || b < 1 ||
      n < 1 || L < 2 || (long long)b * L > 65535 || splits < 1 || splits > MAX_SPLITS ||
      (splits > 1 && ws == nullptr) || reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return cudaErrorInvalidValue;
  const void* const w[8] = {bw1, bb1, bw2, bb2, tw1, tb1, tw2, tb2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return run<float>(dim, levels, sb, sn, sl, bottom, tsb, tsn, pos, psn, w, mask, out, ws, b, n, L, hidden, attend_self, splits, s);
  if (dtype == glom::kBF16)
    return run<__nv_bfloat16>(dim, levels, sb, sn, sl, bottom, tsb, tsn, pos, psn, w, mask, out, ws, b, n, L, hidden, attend_self, splits, s);
  return cudaErrorInvalidValue;
}
