// Fq12 products across rows of (…, 12, 15) int64 loose limbs, limb for
// limb the port's torch loops: (K, M, 12, 15) -> (M, 12, 15), one block a
// column m folding its K values in order, acc = acc * f_k, from one (acc =
// one, and one * f_0 is taken, as ops/mesh_rlc._local_fold_plain takes it)
// or from the first value (ops/pairing's list-order product of the pairs'
// Miller outputs, _fq12_product_plain). One launch a fold.
//
// rlc_combine's pairwise tree is this fold too, from the first value with
// K = 2 over the pairs of a level (in[0, m] = acc[2m], in[1, m] =
// acc[2m + 1], an odd tail carried up unmultiplied by the wrapper
// ops/cuda_tower.fq12_fold_level; ops/pairing._fq12_tree_level_plain):
// ceil(log2 N) launches, one a level.
//
// Replaces two device loops of the JAX package over the Pallas product
// consensus_specs_tpu/ops/pallas_fq.py:129 `_mont_mul_kernel`:
//   consensus_specs_tpu/ops/mesh_rlc.py:43 `_local_fold` (a lax.scan at
//     :54, one per mesh slot over its shard of chunk products);
//   consensus_specs_tpu/ops/pairing.py:190 `rlc_combine`'s pairwise tree
//     (:213-219), and pairing_product_is_one's product of the pairs'
//     Miller outputs (:220-222).
//
// What bounds it on an H100: a fold is K dependent Fq12 products; an Fq12
// product is two Montgomery products deep on the function's data
// dependencies (the 144 products, then the compress of a fold batch's
// subtrahend; the second batch does not wait for the first's compress), so
// the latency floor is the plain fold's traced dependent products
// (chip_smoke._chain_depth) x 16 REDC digit steps; a level is one product
// a block, ceil(N / 2) blocks. At the path's shapes (2 to 64 values) both
// sit on the floor's side of the operations bound.
//
// The design: tower.cuh's block-wide product, one block of TW_THREADS a
// column, operands in shared memory.
#include <cuda_runtime.h>

#include "tower.cuh"

__global__ void __launch_bounds__(TW_THREADS)
    fq12_fold_kernel(const long long* __restrict__ in,
                     long long* __restrict__ out, int k_len, long long m_len,
                     int from_one) {
  __shared__ unsigned int acc[TW_FQ12], f[TW_FQ12];
  __shared__ TwFq12Work work;
  const long long m = blockIdx.x;
  int k0 = 0;
  if (from_one) {
    tw_fq12_set_one(acc);
  } else {
    tw_fq12_load(acc, in + m * TW_FQ12);
    k0 = 1;
  }
  for (int k = k0; k < k_len; ++k) {
    tw_fq12_load(f, in + (k * m_len + m) * TW_FQ12);
    __syncthreads();
    tw_fq12_mul(acc, acc, f, work);
  }
  tw_fq12_store(out + m * TW_FQ12, acc);
}

// Launches on `stream`: in (k_len, m_len, 12, 15), out (m_len, 12, 15),
// k_len >= 1 from the first value (>= 0 from one). Returns the launch's
// cudaGetLastError() (0 = ok).
extern "C" int fq12_fold_launch(const long long* in, long long* out,
                                int k_len, long long m_len, int from_one,
                                void* stream) {
  if (m_len <= 0) return 0;
  if (!from_one && k_len < 1) return (int)cudaErrorInvalidValue;
  fq12_fold_kernel<<<(unsigned int)m_len, TW_THREADS, 0,
                     (cudaStream_t)stream>>>(in, out, k_len, m_len,
                                             from_one);
  return (int)cudaGetLastError();
}
