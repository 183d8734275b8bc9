// (k)Q for affine points Q of G1 (rows of (15,) limbs) or of G2 (rows of
// (2, 15)) by double-and-add over a static msb-first bit list: one launch
// a call, every row in parallel, limb for limb
// ops/curve.scalar_mul_fixed_plain.
//
// Replaces consensus_specs_tpu/ops/curve.py:130 `scalar_mul_fixed`, a
// lax.scan (:151) over the bits whose every Fq product is the Pallas
// kernel consensus_specs_tpu/ops/pallas_fq.py:129 `_mont_mul_kernel` (one
// device program on the TPU). Its callers are the subgroup checks r * P
// of the standalone curve arithmetic.
//
// Each bit: acc = double(acc); at a set bit, the mixed addition. The scan
// computes the addition at every bit and selects it away at a clear one,
// and inside the addition computes all four branches and selects one;
// here only what the selects keep is made (tower.cuh tw_jac_add_mixed),
// as the plain loop skips the clear bits' additions, so the limbs are the
// scan's. Every bit is processed, the first one too: from the point at
// infinity (0, 0, 0) it doubles infinity, then takes (qx, qy, 1).
//
// What bounds it on an H100: per row a serial chain of Montgomery
// products, 12 a doubling and 20 an addition on G1 (35 and 67 on G2,
// compresses and zero tests included; ops/cuda_tower.MONTS); the r-bit
// subgroup check is 255 doublings and 134 additions. The rows are
// independent; at the smoke's 64 rows the card is nearly empty, so the
// latency of the chain bounds it (chip_smoke._chain_depth).
//
// The design: one thread a row, 32 rows a block; acc and Q in the
// thread's registers (G2's spill to local memory), the products one after
// the other (simple first: a product's limbs spread over lanes, or the
// doubling's independent products overlapped, are later work).
#include <cuda_runtime.h>

#include "tower.cuh"

#define SM_THREADS 32
#define SM_MAX_WORDS 16  // 512 bits

struct SmBits {
  unsigned int words[SM_MAX_WORDS];  // every bit, first-processed first
  int n_bits;
};

__device__ __forceinline__ TwFq sm_load(const long long* src, const TwFq&) {
  return tw_load64(src);
}
__device__ __forceinline__ TwFq2 sm_load(const long long* src,
                                         const TwFq2&) {
  return tw2_load64(src);
}
__device__ __forceinline__ void sm_store(long long* dst, const TwFq& a) {
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) dst[k] = (long long)a.v[k];
}
__device__ __forceinline__ void sm_store(long long* dst, const TwFq2& a) {
  sm_store(dst, a.c0);
  sm_store(dst + FQ_LIMBS, a.c1);
}

template <class F>
__global__ void __launch_bounds__(SM_THREADS)
    scalar_mul_kernel(const long long* __restrict__ qx,
                      const long long* __restrict__ qy,
                      long long* __restrict__ ox, long long* __restrict__ oy,
                      long long* __restrict__ oz, long long rows, SmBits e) {
  const long long row = (long long)blockIdx.x * SM_THREADS + threadIdx.x;
  if (row >= rows) return;
  constexpr int W = sizeof(F) / sizeof(unsigned int);  // limbs a coordinate
  const F zero = cv_zero(F());
  const F Qx = sm_load(qx + row * W, zero);
  const F Qy = sm_load(qy + row * W, zero);
  TwJac<F> acc = {zero, zero, zero};
  // `again`: the addition's p == Q branch, double(acc), is the next pass
  // of the loop's one doubling, before bit t + 1
  bool again = false;
  for (int t = 0; t < e.n_bits;) {
    acc = tw_jac_double(acc);
    if (again) {
      again = false;
    } else if (tw_bit(e.words, t) &&
               tw_jac_add_mixed(acc, Qx, Qy) == TW_ADD_DOUBLE) {
      again = true;
      continue;
    }
    ++t;
  }
  sm_store(ox + row * W, acc.x);
  sm_store(oy + row * W, acc.y);
  sm_store(oz + row * W, acc.z);
}

// Launches on `stream`: qx, qy, ox, oy, oz (rows, 15) for G1 (g2 = 0) or
// (rows, 2, 15) for G2, all int64; `words` a host array of the n_bits
// bits, first-processed first, 32 to a word. Returns the launch's
// cudaGetLastError() (0 = ok), cudaErrorInvalidValue for no bits or more
// than SM_MAX_WORDS words of them.
extern "C" int scalar_mul_launch(const long long* qx, const long long* qy,
                                 long long* ox, long long* oy, long long* oz,
                                 long long rows, int g2,
                                 const unsigned int* words, int n_bits,
                                 void* stream) {
  if (n_bits <= 0 || n_bits > SM_MAX_WORDS * 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return 0;
  SmBits e;
  for (int w = 0; w < SM_MAX_WORDS; ++w) {
    e.words[w] = w * 32 < n_bits ? words[w] : 0u;
  }
  e.n_bits = n_bits;
  const unsigned int blocks = (unsigned int)((rows + SM_THREADS - 1) /
                                             SM_THREADS);
  if (g2) {
    scalar_mul_kernel<TwFq2><<<blocks, SM_THREADS, 0, (cudaStream_t)stream>>>(
        qx, qy, ox, oy, oz, rows, e);
  } else {
    scalar_mul_kernel<TwFq><<<blocks, SM_THREADS, 0, (cudaStream_t)stream>>>(
        qx, qy, ox, oy, oz, rows, e);
  }
  return (int)cudaGetLastError();
}
