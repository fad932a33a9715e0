// The pieces of one consensus-attention row that every kernel computing it
// shares: consensus.cu (the forward), consensus_bwd.cu (K6, K7) and
// fused_update.cu (the whole level update).  They fix the edge rules in one
// place:
//   * keys are the L2-normalised levels, eps 1e-12, and the logits carry
//     d^-1/2: both fold into one factor per key, kscale_j;
//   * the soft self-mask is the logit -5e-4 on the diagonal unless
//     attend_self; a masked pair gets -FLT_MAX (never -inf, so a key block
//     masked whole for a row stays finite); a key past the end gets -inf and
//     weighs exactly 0;
//   * the online softmax keeps a running (max, sum) per row and hands the
//     caller the factor that rescales what it has accumulated so far.
// Blocks of 256 threads (8 warps) and key blocks of 32, one lane a key.
#pragma once

#include <float.h>
#include <math.h>

#include "common.cuh"

namespace glom {

constexpr int KEY_BLOCK = 32;            // keys per streamed block
constexpr float SELF_LOGIT = -5e-4f;
constexpr float NORM_EPS = 1e-12f;

// Each of the 8 warps takes 4 of the 32 keys in vs (rows of `stride`
// floats, D wide): kscale[j] = scale / max(|v_j|, eps) and, when norm is not
// null, norm[j] = |v_j|.
template <int D>
__device__ __forceinline__ void key_scales(const float* vs, int stride, float* kscale,
                                           float* norm, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < KEY_BLOCK / 8; ++e) {
    const int j = warp * (KEY_BLOCK / 8) + e;
    const float* vr = vs + j * stride;
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < D / 128; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(&vr[c * 128 + lane * 4]);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    ss = warp_sum(ss);
    if (lane == 0) {
      const float nrm = sqrtf(ss);
      kscale[j] = scale / fmaxf(nrm, NORM_EPS);
      if (norm != nullptr) norm[j] = nrm;
    }
  }
}

// kscale from a key's squared norm ss: scale / max(sqrt(ss), eps), as
// key_scales computes it, by one reciprocal square root (about 2 ulp).
__device__ __forceinline__ float key_scale_from_sq(float ss, float scale) {
  return scale * rsqrtf(fmaxf(ss, NORM_EPS * NORM_EPS));
}

// The logit of query i and key j from the raw product q_i . v_j; keys at
// j_end and beyond are not this block's.
__device__ __forceinline__ float consensus_logit(float raw, float kscale, int i, int j, int n,
                                                 int j_end, const int8_t* __restrict__ mask,
                                                 int attend_self) {
  float v = raw * kscale;
  if (!attend_self && i == j) v = SELF_LOGIT;
  if (mask != nullptr && i < n && j < n && mask[(long long)i * n + j] != 0) v = -FLT_MAX;
  if (j >= j_end) v = -INFINITY;
  return v;
}

// One online-softmax step over a (ROWS, 32) tile of logits in ps (rows of
// `stride` floats): the logits become exp(logit - new max), row_max and
// row_sum are brought up to date, and corr[r] is the factor exp(old max -
// new max) that rescales row r's earlier sums.  One warp per ROWS / 8 rows.
template <int ROWS>
__device__ __forceinline__ void softmax_update(float* ps, int stride, float* row_max,
                                               float* row_sum, float* corr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < ROWS / 8; ++e) {
    const int r = warp * (ROWS / 8) + e;
    const float v = ps[r * stride + lane];
    const float m_old = row_max[r];
    const float m_new = fmaxf(m_old, warp_max(v));
    const float p = expf(v - m_new);
    const float sum = warp_sum(p);
    ps[r * stride + lane] = p;
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      corr[r] = c;
      row_sum[r] = row_sum[r] * c + sum;
      row_max[r] = m_new;
    }
  }
}

}  // namespace glom
