// The optimal-ate Miller loop f_{|x|}(Q, P), conjugated, over R rows of
// (Q, P) pairs: one launch a loop, every row in parallel, limb for limb
// ops/pairing.miller_loop_plain.
//
// Replaces consensus_specs_tpu/ops/pairing.py:93 `miller_loop`, a
// lax.scan (:121) over the 63 bits of |x| after its top one whose every
// Fq product is the Pallas kernel consensus_specs_tpu/ops/pallas_fq.py:129
// `_mont_mul_kernel` (one device program on the TPU).
//
// Each of the 63 iterations: f = f^2; the doubling step (line and 2T from
// T); f = f * line; on a set bit (5 of the 63) the addition step (line2
// and T + Q); f = f * line2, where line2 is one on a clear bit and the
// product by one is still taken, as the scan takes it (a product by one
// is not a no-op on limbs). The scan also computes the addition step on a
// clear bit and selects its T away; that step is skipped here, as the
// plain loop skips it. Then the conjugation (x < 0).
//
// What bounds it on an H100: the loop is 189 Fq12 products on f (63 x 3,
// each two Montgomery products deep) and 68 line steps (63 doublings, 5
// additions) on the twist point T; each line feeds an f product, so the
// longest dependent path runs through both (537 Montgomery products deep,
// traced on ops/pairing.miller_loop_plain by chip_smoke._chain_depth,
// against 378 on f alone). Its latency floor is that path x 16 REDC digit
// steps. At the path's 8 to 128 rows the card is nearly empty.
//
// The design (tower.cuh): one block of TW_THREADS threads a row; f, the
// line and the product's workspace in shared memory; the line steps on
// thread 0, T and the operands in its registers, serial (simple first: the
// steps' products are the kernel's longest serial run; spreading them over
// lanes, or running the T chain ahead of the f chain, is later work).
#include <cuda_runtime.h>

#include "tower.cuh"

#define ML_MAX_WORDS 2

struct MlBits {
  unsigned int words[ML_MAX_WORDS];  // |x|'s bits after the top one
  int n_bits;
};

__global__ void __launch_bounds__(TW_THREADS)
    miller_loop_kernel(const long long* __restrict__ qx,
                       const long long* __restrict__ qy,
                       const long long* __restrict__ px,
                       const long long* __restrict__ py,
                       long long* __restrict__ out, MlBits e) {
  __shared__ unsigned int f[TW_FQ12], line[TW_FQ12], one[TW_FQ12];
  __shared__ TwFq12Work work;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  // thread 0's operands and its twist point T = (qx, qy, 1 + 0u)
  const TwFq2 Qx = tw2_load64(qx + row * TW_FQ2);
  const TwFq2 Qy = tw2_load64(qy + row * TW_FQ2);
  const TwFq xp = tw_load64(px + row * FQ_LIMBS);
  const TwFq yp = tw_load64(py + row * FQ_LIMBS);
  TwG2 T = {Qx, Qy, {tw_load(TW_ONE), tw_zero()}};
  tw_fq12_set_one(f);
  tw_fq12_set_one(one);
  __syncthreads();
  for (int t = 0; t < e.n_bits; ++t) {
    tw_fq12_mul(f, f, f, work);
    if (tid == 0) tw_dbl_step(T, xp, yp, line);
    __syncthreads();
    tw_fq12_mul(f, f, line, work);
    if (tw_bit(e.words, t)) {
      if (tid == 0) tw_add_step(T, Qx, Qy, xp, yp, line);
      __syncthreads();
      tw_fq12_mul(f, f, line, work);
    } else {
      tw_fq12_mul(f, f, one, work);
    }
  }
  tw_fq12_conjugate(line, f);
  tw_fq12_store(out + row * TW_FQ12, line);
}

// Launches on `stream`: qx, qy (rows, 2, 15), px, py (rows, 15), out (rows,
// 12, 15), all int64; `words` a host array of the loop's n_bits bits
// (|x| after its top one, first-processed first). Returns the launch's
// cudaGetLastError() (0 = ok).
extern "C" int miller_loop_launch(const long long* qx, const long long* qy,
                                  const long long* px, const long long* py,
                                  long long* out, long long rows,
                                  const unsigned int* words, int n_bits,
                                  void* stream) {
  if (n_bits < 0 || n_bits > ML_MAX_WORDS * 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return 0;
  MlBits e;
  for (int w = 0; w < ML_MAX_WORDS; ++w) {
    e.words[w] = w * 32 < n_bits ? words[w] : 0u;
  }
  e.n_bits = n_bits;
  miller_loop_kernel<<<(unsigned int)rows, TW_THREADS, 0,
                       (cudaStream_t)stream>>>(qx, qy, px, py, out, e);
  return (int)cudaGetLastError();
}
