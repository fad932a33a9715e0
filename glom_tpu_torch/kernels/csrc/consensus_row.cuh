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

}  // namespace glom
