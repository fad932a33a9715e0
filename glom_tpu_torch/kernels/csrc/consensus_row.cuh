// The pieces of one consensus-attention row that every kernel computing it
// shares: consensus_fwd.cuh (the forward, K4's and K8's) and consensus_bwd.cu
// (K6, K7).  They fix the edge rules in one place:
//   * keys are the L2-normalised levels, eps 1e-12, and the logits carry
//     d^-1/2: both fold into one factor per key, kscale_j;
//   * the soft self-mask is the logit -5e-4 on the diagonal unless
//     attend_self; a masked pair gets -FLT_MAX (never -inf, so a key block
//     masked whole for a row stays finite); a key past the end gets -inf and
//     weighs exactly 0.
// Blocks of 256 threads (8 warps) and key blocks of 32, one lane a key.
#pragma once

#include <float.h>
#include <math.h>

#include "common.cuh"

namespace glom {

constexpr int KEY_BLOCK = 32;            // keys per streamed block
constexpr float SELF_LOGIT = -5e-4f;
constexpr float NORM_EPS = 1e-12f;

// kscale from a key's squared norm ss: scale / max(sqrt(ss), eps), as
// consensus_bwd.cu's key_norms computes it, by one reciprocal square root
// (about 2 ulp).
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

}  // namespace glom
