// Consensus attention forward (K4), written by hand for Hopper (sm_90a).
//
// Replaces: glom_tpu/kernels/consensus_pallas.py::_forward (K4: K/V resident,
// `_kernel` -> `attend_oneshot`) AND ::_forward_blocked (K5: K/V streamed
// with an online softmax, `_kernel_blocked`).  The kernel, its design and
// its split combine are consensus_fwd.cuh's, which K8's consensus stage
// (fused_update.cu) shares; this file holds K4's C entry points and its
// split planner.  The output is in the inputs' type.

#include "common.cuh"
#include "consensus_fwd.cuh"

namespace {

using namespace glom::cons;

template <typename T>
int occupancy(int dim) {
  switch (dim) {
    case 128: return blocks_per_sm<T, 128, T>();
    case 256: return blocks_per_sm<T, 256, T>();
    case 384: return blocks_per_sm<T, 384, T>();
    case 512: return blocks_per_sm<T, 512, T>();
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
// dimension contiguous, every row on a 16-byte boundary); mask (n, n) int8 or bool, contiguous, or null;
// out (b, n, L, dim) contiguous, levels' dtype; lse (b, L, n) f32; ws: with
// splits > 1, the f32 workspace glom_consensus_splits describes, 16-byte
// aligned.  Returns the launches' cudaError_t.
extern "C" int glom_consensus(const void* levels, long long sb, long long sn, long long sl,
                              const void* mask, void* out, void* lse, void* ws, int b, int n,
                              int L, int dim, int attend_self, int splits, int dtype,
                              void* stream) {
  if (!valid(b, n, L, dim) || splits < 1 || (splits > 1 && ws == nullptr) ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0 || reinterpret_cast<uintptr_t>(levels) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int8_t* m = static_cast<const int8_t*>(mask);
  float* ls = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == glom::kF32)
    return dispatch<float, float>(dim, levels, sb, sn, sl, m, out, ls, ws, b, n, L, attend_self, splits, s);
  if (dtype == glom::kBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(dim, levels, sb, sn, sl, m, out, ls, ws, b, n, L, attend_self, splits, s);
  return cudaErrorInvalidValue;
}
