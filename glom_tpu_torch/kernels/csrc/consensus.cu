// Consensus attention forward, written by hand for Hopper (sm_90a).
//
// Replaces: glom_tpu/kernels/consensus_pallas.py::_forward (K/V resident,
// `_kernel` -> `attend_oneshot`) AND ::_forward_blocked (K/V streamed with
// an online softmax, `_kernel_blocked`).  For each batch b, level l and
// query row i of levels (b, n, L, d), with Q = V = levels[b, :, l] and
// K = V / max(||V||, 1e-12) row by row:
//     s_ij = (q_i . k_j) * d^-1/2
//     s_ii = -5e-4 unless attend_self          (the soft self-mask)
//     s_ij = -FLT_MAX where mask[i, j] != 0    (the hard locality mask)
//     out_i = softmax_j(s_i) @ V,  lse_i = logsumexp_j(s_ij)
// f32 or bf16 inputs, f32 accumulation; lse is f32 (b, L, n), the residual
// the backward kernels will read.
//
// What bounds it: operations.  A (b, l) pair does 4*n*n*d FLOPs on n*d
// inputs; at n=256, d=512 that is about 250 FLOPs per byte of f32 input.
// The plain version writes the (b, L, n, n) logits and probabilities to
// device memory and reads them back.
//
// What the design does about it:
//  * one kernel for both TPU kernels.  A (256, 512) f32 K/V row is 512 KB,
//    more than a block's 227 KB of shared memory, so K4's resident layout
//    cannot carry over: K/V is always streamed, 32 keys at a time, with
//    K5's online softmax, and the (n, n) logits never exist in memory.
//  * both products run on the tensor cores (mma.sync m16n8k8, tf32, f32
//    accumulators) with the 3xTF32 split of grouped_ff.cu: an f32 operand
//    is hi + lo in tf32, and a product is three passes, so f32 calls keep
//    f32 accuracy.  bf16 levels are exact in tf32: Q K^T takes one pass and
//    P V (P is f32) two.
//  * one block owns 64 query rows of one (b, l).  The queries stay in
//    shared memory (f32) for the whole key stream, and the (64, d) f32
//    output accumulator lives in the registers of the 8 warps (each warp 32
//    rows x d/4 columns).  For each block of 32 keys the block loads V
//    once, computes the 32 key norms (a warp reduction each), computes
//    S = Q V^T (each warp 16 rows x 16 keys over all of d), scales each key's
//    column by its inverse norm and d^-1/2 and applies the masks into a
//    shared (64, 32) tile, runs the online-softmax update one warp per 8
//    rows, rescales the accumulator rows, and adds P V.
//  * a block needs about 204 KB of shared memory at d=512, so one block
//    runs on an SM, and a call has few query tiles at small batch (24 at
//    b=1, n=256).  The keys are therefore split over `splits` blocks per
//    tile where that fills the card (glom_consensus_splits); each writes
//    its unnormalized sums and its rows' (max, sum) to an f32 workspace,
//    and a second, elementwise kernel combines them in a fixed order.  With
//    one split the block writes out and lse itself.
//  * masked pairs get -FLT_MAX, never -inf: a key block that is masked
//    whole for a row then adds exp(0) = 1 terms that a later block's
//    correction factor exp(-FLT_MAX - m) = 0 removes.  Keys past n (the
//    ragged edge; n need not be a multiple of anything) get -inf and weigh
//    exactly 0.  Every key block holds at least one of its split's keys, so
//    the running max is finite after the first block.
//  * rows are padded by 4 floats, so the S products' fragment loads hit 32
//    distinct banks (the P V loads of V meet 2-way conflicts).
//  * levels is read through its strides (last dimension contiguous), so no
//    transpose to (b, L, n, d) is needed; out is (b, n, L, d) contiguous.
// d must be a multiple of 128, at most 512.

#include <type_traits>

#include "common.cuh"
#include "consensus_row.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = glom::KEY_BLOCK;   // keys per streamed block
constexpr int THREADS = 256;   // 8 warps
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_SPLITS = 8;
// A split's partial sums cost a block about this many key blocks' time to
// write and combine (H100, d=512: at b=8, n=256 two splits gained nothing
// in f32 and lost in bf16, against the 4 key blocks a block they save).
constexpr double SPLIT_COST = 1.5;

template <int D>
struct Layout {
  static constexpr int kStride = D + 4;    // q and v tile rows (floats)
  static constexpr int kPStride = BK + 4;  // logit / probability tile rows
  static constexpr size_t kBytes =
      sizeof(float) * (BQ * kStride + BK * kStride + BQ * kPStride + BK + 3 * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
consensus_kernel(const T* __restrict__ lv, long long sb, long long sn, long long sl,
                 const int8_t* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ lse, float* __restrict__ ws_out,
                 float2* __restrict__ ws_stats, int n, int L, float scale, int attend_self,
                 int per_split) {
  using S = Layout<D>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NT = D / 32;   // n8 tiles in a warp's d/4 output columns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][kStride]   queries, f32
  float* vs = qs + BQ * S::kStride;             // [BK][kStride]   this key block's V
  float* ps = vs + BK * S::kStride;             // [BQ][kPStride]  logits, then probabilities
  float* kscale = ps + BQ * S::kPStride;        // [BK]  d^-1/2 / max(||v_j||, eps)
  float* corr = kscale + BK;                    // [BQ]  this key block's rescale of a row
  float* row_max = corr + BQ;                   // [BQ]  running max of a row's logits
  float* row_sum = row_max + BQ;                // [BQ]  running sum of exp(logit - max)

  const int b = blockIdx.y / L, l = blockIdx.y % L;
  const int q0 = blockIdx.x * BQ;
  // this block's share of the keys: [j_begin, j_end)
  const int j_begin = blockIdx.z * per_split * BK;
  const int j_end = min(n, j_begin + per_split * BK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const T* base = lv + b * sb + l * sl;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, k = i - r * D;
    qs[r * S::kStride + k] = (q0 + r < n) ? glom::to_f32(base[(q0 + r) * sn + k]) : 0.f;
  }
  if (tid < BQ) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.f;
  }

  // S = Q V^T: the warp's 16 query rows x 16 keys
  const int m1 = (warp & 3) * 16, n1 = (warp >> 2) * 16;
  // out += P V: the warp's 32 query rows x d/4 columns
  const int m2 = (warp & 1) * 32, n2 = (warp >> 1) * (D / 4);
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += BK) {
    __syncthreads();   // every warp is done with the previous key block (and Q is loaded)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, k = i - r * D;
      vs[r * S::kStride + k] = (j0 + r < j_end) ? glom::to_f32(base[(j0 + r) * sn + k]) : 0.f;
    }
    __syncthreads();
    glom::key_scales<D>(vs, S::kStride, kscale, nullptr, scale);   // 4 keys a warp

    float s[2][4], s_lo[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s_lo[nt][e] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; k += 8) {
      const float* ap = qs + (m1 + gid) * S::kStride + k + tig;
      const float av[4] = {ap[0], ap[8 * S::kStride], ap[4], ap[8 * S::kStride + 4]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kF32) glom::split_tf32(av[e], ahi[e], alo[e]);
        else ahi[e] = __float_as_uint(av[e]);   // a bf16 value is exact in tf32
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // B = V^T: B[k][key] = V[key][k]
        const float* bp = vs + (n1 + nt * 8 + gid) * S::kStride + k + tig;
        uint32_t bhi[2], blo[2];
        if constexpr (kF32) {
          glom::split_tf32(bp[0], bhi[0], blo[0]);
          glom::split_tf32(bp[4], bhi[1], blo[1]);
          glom::mma_tf32(s_lo[nt], alo, bhi);
          glom::mma_tf32(s_lo[nt], ahi, blo);
        } else {
          bhi[0] = __float_as_uint(bp[0]);
          bhi[1] = __float_as_uint(bp[4]);
        }
        glom::mma_tf32(s[nt], ahi, bhi);
      }
    }
    __syncthreads();   // kscale is written
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m1 + gid + (e >> 1) * 8, c = n1 + nt * 8 + 2 * tig + (e & 1);
        ps[r * S::kPStride + c] = glom::consensus_logit(
            s[nt][e] + s_lo[nt][e], kscale[c], q0 + r, j0 + c, n, j_end, mask, attend_self);
      }
    }
    __syncthreads();
    // the online-softmax update, one warp per 8 rows, one lane per key
    glom::softmax_update<BQ>(ps, S::kPStride, row_max, row_sum, corr);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float c0 = corr[m2 + mt * 16 + gid], c1 = corr[m2 + mt * 16 + gid + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[mt][nt][0] *= c0;
        acc[mt][nt][1] *= c0;
        acc[mt][nt][2] *= c1;
        acc[mt][nt][3] *= c1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = ps + (m2 + mt * 16 + gid) * S::kPStride + kk + tig;
        glom::split_tf32(ap[0], ahi[mt][0], alo[mt][0]);
        glom::split_tf32(ap[8 * S::kPStride], ahi[mt][1], alo[mt][1]);
        glom::split_tf32(ap[4], ahi[mt][2], alo[mt][2]);
        glom::split_tf32(ap[8 * S::kPStride + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* bp = vs + (kk + tig) * S::kStride + n2 + nt * 8 + gid;
        uint32_t bhi[2], blo[2];
        if constexpr (kF32) {
          glom::split_tf32(bp[0], bhi[0], blo[0]);
          glom::split_tf32(bp[4 * S::kStride], bhi[1], blo[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) glom::mma_tf32(acc[mt][nt], ahi[mt], blo);
        } else {
          bhi[0] = __float_as_uint(bp[0]);
          bhi[1] = __float_as_uint(bp[4 * S::kStride]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          glom::mma_tf32(acc[mt][nt], alo[mt], bhi);
          glom::mma_tf32(acc[mt][nt], ahi[mt], bhi);
        }
      }
    }
  }

  // row_sum / row_max are final: the last key block's __syncthreads ordered
  // their writes before the P V products above.  One split writes the
  // result; several write their unnormalized sums and (max, sum) for
  // combine_splits_kernel.
  const long long split_elems = (long long)gridDim.y * n * D;   // b * n * L * D
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m2 + mt * 16 + gid + 8 * half;
      const int i = q0 + r;
      if (i >= n) continue;
      const long long o = (((long long)b * n + i) * L + l) * D + n2 + 2 * tig;
      const float rden = ws_out == nullptr ? 1.f / row_sum[r] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float v0 = acc[mt][nt][2 * half] * rden, v1 = acc[mt][nt][2 * half + 1] * rden;
        if (ws_out == nullptr) glom::store2(out + o + nt * 8, v0, v1);
        else glom::store2(ws_out + blockIdx.z * split_elems + o + nt * 8, v0, v1);
      }
    }
  }
  if (tid < BQ && q0 + tid < n) {
    const long long row = ((long long)b * L + l) * n + q0 + tid;
    if (ws_out == nullptr) lse[row] = row_max[tid] + logf(row_sum[tid]);
    else ws_stats[blockIdx.z * ((long long)gridDim.y * n) + row] = make_float2(row_max[tid], row_sum[tid]);
  }
}

// Combine the splits' partial results: for a row with per-split (m_z, s_z)
// and unnormalized sums o_z, M = max m_z, w_z = exp(m_z - M),
// out = sum w_z o_z / sum w_z s_z and lse = M + log(sum w_z s_z).  Four
// elements of out a thread, splits in a fixed order.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_splits_kernel(const float* __restrict__ ws_out, const float2* __restrict__ ws_stats,
                      T* __restrict__ out, float* __restrict__ lse, long long total, int n,
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

template <typename T, int D>
cudaError_t launch(const void* lv, long long sb, long long sn, long long sl,
                   const int8_t* mask, void* out, float* lse, void* ws, int b, int n, int L,
                   int attend_self, int splits, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = glom::allow_smem(consensus_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const int kblocks = (n + BK - 1) / BK;
  const int per_split = (kblocks + splits - 1) / splits;
  splits = (kblocks + per_split - 1) / per_split;   // no empty split
  const long long total = (long long)b * n * L * D;
  float* ws_out = splits > 1 ? static_cast<float*>(ws) : nullptr;
  float2* ws_stats = splits > 1 ? reinterpret_cast<float2*>(ws_out + splits * total) : nullptr;
  const dim3 grid((n + BQ - 1) / BQ, b * L, splits);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  consensus_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(lv), sb, sn, sl, mask, static_cast<T*>(out), lse, ws_out, ws_stats,
      n, L, scale, attend_self, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws_out == nullptr) return err;
  const long long blocks = (total / 4 + COMBINE_THREADS - 1) / COMBINE_THREADS;
  combine_splits_kernel<T><<<static_cast<unsigned>(blocks), COMBINE_THREADS, 0, stream>>>(
      ws_out, ws_stats, static_cast<T*>(out), lse, total, n, L, D, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dim, const void* lv, long long sb, long long sn, long long sl,
                     const int8_t* mask, void* out, float* lse, void* ws, int b, int n, int L,
                     int attend_self, int splits, cudaStream_t stream) {
  switch (dim) {
    case 128: return launch<T, 128>(lv, sb, sn, sl, mask, out, lse, ws, b, n, L, attend_self, splits, stream);
    case 256: return launch<T, 256>(lv, sb, sn, sl, mask, out, lse, ws, b, n, L, attend_self, splits, stream);
    case 384: return launch<T, 384>(lv, sb, sn, sl, mask, out, lse, ws, b, n, L, attend_self, splits, stream);
    case 512: return launch<T, 512>(lv, sb, sn, sl, mask, out, lse, ws, b, n, L, attend_self, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

// How many blocks of the kernel for (T, D) an SM runs at once.
template <typename T, int D>
int blocks_per_sm() {
  const size_t smem = Layout<D>::kBytes;
  int blocks = 0;
  if (glom::allow_smem(consensus_kernel<T, D>, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, consensus_kernel<T, D>, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <typename T>
int occupancy(int dim) {
  switch (dim) {
    case 128: return blocks_per_sm<T, 128>();
    case 256: return blocks_per_sm<T, 256>();
    case 384: return blocks_per_sm<T, 384>();
    case 512: return blocks_per_sm<T, 512>();
    default: return -1;
  }
}

bool valid(int b, int n, int L, int dim) {
  return dim % 128 == 0 && dim >= 128 && dim <= 512 && b >= 1 && n >= 1 && L >= 1 &&
         (long long)b * L <= 65535;
}

}  // namespace

// The number of key splits a call should use: the count that runs the
// call's (query tile, split) blocks on the current device's SMs in the
// least time, counted in key-block times: waves x (key blocks a block, plus
// SPLIT_COST for writing and combining a split's partial sums), the fewest
// splits on a tie.  A split covers at least 2 key blocks, and there are at
// most 8.  With splits > 1
// the caller passes an f32 workspace of splits * b * n * L * (dim + 2)
// elements.  Returns -1 on bad arguments or a CUDA error.
extern "C" int glom_consensus_splits(int b, int n, int L, int dim, int dtype) {
  if (!valid(b, n, L, dim)) return -1;
  const int per_sm = dtype == glom::kF32 ? occupancy<float>(dim)
                     : dtype == glom::kBF16 ? occupancy<__nv_bfloat16>(dim) : -1;
  int device = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const long long slots = (long long)sms * per_sm;
  const long long tiles = (long long)((n + BQ - 1) / BQ) * b * L;
  const int kblocks = (n + BK - 1) / BK;
  int min_per_split = (kblocks + MAX_SPLITS - 1) / MAX_SPLITS;
  if (min_per_split < 2) min_per_split = kblocks < 2 ? kblocks : 2;
  int best = 1;
  double best_cost = -1.0;
  for (int per_split = kblocks; per_split >= min_per_split; --per_split) {
    const int splits = (kblocks + per_split - 1) / per_split;
    const long long waves = (tiles * splits + slots - 1) / slots;
    const double cost = waves * (per_split + (splits > 1 ? SPLIT_COST : 0.0));
    if (best_cost < 0 || cost < best_cost) best = splits, best_cost = cost;
  }
  return best;
}

// levels (b, n, L, dim) read through strides sb, sn, sl (elements; the last
// dimension contiguous); mask (n, n) int8 or bool, contiguous, or null;
// out (b, n, L, dim) contiguous, levels' dtype; lse (b, L, n) f32; ws: with
// splits > 1, the f32 workspace glom_consensus_splits describes, 16-byte
// aligned.  Returns the launches' cudaError_t.
extern "C" int glom_consensus(const void* levels, long long sb, long long sn, long long sl,
                              const void* mask, void* out, void* lse, void* ws, int b, int n,
                              int L, int dim, int attend_self, int splits, int dtype,
                              void* stream) {
  if (!valid(b, n, L, dim) || splits < 1 || (splits > 1 && ws == nullptr) ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int8_t* m = static_cast<const int8_t*>(mask);
  float* ls = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return dispatch<float>(dim, levels, sb, sn, sl, m, out, ls, ws, b, n, L, attend_self, splits, s);
  if (dtype == glom::kBF16)
    return dispatch<__nv_bfloat16>(dim, levels, sb, sn, sl, m, out, ls, ws, b, n, L, attend_self, splits, s);
  return cudaErrorInvalidValue;
}
