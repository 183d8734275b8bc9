// Batched Montgomery multiply a * b * 2^-420 (mod p) over (M, 15) int64
// limb arrays: one thread per product.
//
// Replaces the TPU kernel consensus_specs_tpu/ops/pallas_fq.py
// `_mont_mul_kernel` (math in `mont_rows`), which tiles (32, 256) uint32
// blocks of 14-bit limb rows in VMEM. Here each thread keeps its whole
// product in registers: 30 64-bit column accumulators, no shared memory.
//
// What bounds it on an H100: each product reads 240 bytes and writes 120,
// and does ~465 32x32->64 integer multiply-adds; at 3.35 TB/s and the
// card's int32 multiply-add issue rate that is bytes first, so the
// design's only concern is to read and write each limb once (the row of
// 15 limbs a thread loads is contiguous).
#include <cuda_runtime.h>

#include "mont.cuh"

__global__ void mont_mul_kernel(const long long* __restrict__ a,
                                const long long* __restrict__ b,
                                long long* __restrict__ out, long long m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  unsigned int x[FQ_LIMBS], y[FQ_LIMBS], r[FQ_LIMBS];
  fq_load(a + i * FQ_LIMBS, x);
  fq_load(b + i * FQ_LIMBS, y);
  fq_mont_mul(x, y, r);
  fq_store(r, out + i * FQ_LIMBS);
}

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
extern "C" int mont_mul_launch(const long long* a, const long long* b,
                               long long* out, long long m, void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  long long blocks = (m + threads - 1) / threads;
  mont_mul_kernel<<<(unsigned int)blocks, threads, 0,
                    (cudaStream_t)stream>>>(a, b, out, m);
  return (int)cudaGetLastError();
}
