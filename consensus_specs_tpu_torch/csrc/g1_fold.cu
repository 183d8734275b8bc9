// The sequential G1 fold of one mesh slot's shard: (K, 3, 15) int64
// projective points -> their sum (3, 15), from the point at infinity
// (0 : 1 : 0), by the complete addition; one launch a slot's fold, limb
// for limb ops/mesh_reduce._local_fold_plain.
//
// Replaces consensus_specs_tpu/ops/mesh_reduce.py:76 `_local_fold`, a
// lax.scan (:86) of g1_complete_add whose every Fq product is the Pallas
// kernel consensus_specs_tpu/ops/pallas_fq.py:129 `_mont_mul_kernel` (one
// device program a slot on the TPU). inf + P_0 is computed, not skipped,
// as the scan computes it.
//
// What bounds it on an H100: K dependent complete additions (14
// Montgomery products and 5 subtractions each, whose compresses are
// products too: 19); the accumulator's loop-carried chain through them,
// 5 dependent products an addition (X3 through X1 X2, the compress of
// t0 + t2, 3b Y3, t4 Y3 and the last subtraction's compress), is its
// latency floor (traced by chip_smoke._chain_depth). One slot's fold
// occupies one thread of one SM; the mesh's slots launch on their own
// streams.
//
// The design (tower.cuh tw_g1_add): one thread adds point after point, the
// accumulator in its registers, each point read once.
// Simple first: the addition's independent products on several lanes, or
// a tree over many lanes (which would change the operand order and so the
// limbs), are later work.
#include <cuda_runtime.h>

#include "tower.cuh"

#define G1_POINT (3 * FQ_LIMBS)

__global__ void g1_fold_kernel(const long long* __restrict__ points,
                               long long* __restrict__ out, long long k_len) {
  if (threadIdx.x != 0) return;
  TwG1 acc = {tw_zero(), tw_load(TW_ONE), tw_zero()};  // (0 : 1 : 0)
  for (long long i = 0; i < k_len; ++i) {
    const long long* p = points + i * G1_POINT;
    acc = tw_g1_add(acc, {tw_load64(p), tw_load64(p + FQ_LIMBS),
                          tw_load64(p + 2 * FQ_LIMBS)});
  }
  for (int k = 0; k < FQ_LIMBS; ++k) {
    out[k] = (long long)acc.x.v[k];
    out[FQ_LIMBS + k] = (long long)acc.y.v[k];
    out[2 * FQ_LIMBS + k] = (long long)acc.z.v[k];
  }
}

// Launches on `stream`: points (k_len, 3, 15), out (3, 15), int64.
// Returns the launch's cudaGetLastError() (0 = ok).
extern "C" int g1_fold_launch(const long long* points, long long* out,
                              long long k_len, void* stream) {
  if (k_len < 0) return (int)cudaErrorInvalidValue;
  g1_fold_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(points, out, k_len);
  return (int)cudaGetLastError();
}
