// Batched Montgomery multiply a * b * 2^-420 (mod p) over (M, 15) int64
// limb arrays.
//
// Replaces the TPU kernel consensus_specs_tpu/ops/pallas_fq.py
// `_mont_mul_kernel` (math in `mont_rows`), which tiles (32, 256) uint32
// blocks of 14-bit limb rows in VMEM.
//
// What bounds it on an H100: each product reads 240 bytes and writes 120,
// and does ~465 32x32->64 multiply-adds; at 3.35 TB/s and the card's
// int32 multiply-add rate that is bytes first, operations close behind.
//
// What the design does about it:
// - A block takes a chunk of MM_CHUNK contiguous products: one contiguous
//   run of MM_CHUNK * 120 bytes per operand, copied into shared memory with
//   16-byte cp.async (every thread on neighbouring 16 bytes, so the loads
//   coalesce; an odd number of int64 words ends in one 8-byte copy). Each
//   thread then reads its limbs from shared memory, and the results go
//   back through shared memory (into the chunk's `a` buffer, free by then)
//   as one coalesced 16-byte store stream.
// - The grid is persistent (as many blocks as fit on the SMs, a
//   grid-stride loop over chunks) with two stages: the next chunk's copy is
//   in flight while this chunk's products run. The ragged last chunk is
//   masked.
// - One thread a product (mont.cuh fq_mont_mul). The step kernel's split
//   product (fq_mont_mul_split, 4 threads a product) measured slower here
//   on an H100: ~13.4 us against ~11.5 at 65,536 products. This grid fills
//   the card, so the product's instruction count matters more than its
//   latency, and the split product spends extra instructions on shuffles.
#include <cuda_runtime.h>

#include "mont.cuh"

#define MM_CHUNK 128                        // products a chunk
#define MM_WORDS (MM_CHUNK * FQ_LIMBS)      // int64 words of one operand
#define MM_SMEM (2 * 2 * MM_WORDS * 8)      // 2 stages x (a, b): 61,440 B

// copy n_words int64 words (src, dst 16-byte aligned) into shared memory
__device__ __forceinline__ void mm_stage(long long* dst, const long long* src,
                                         int n_words) {
  const int pieces = n_words / 2;
  for (int k = threadIdx.x; k < pieces; k += blockDim.x) {
    cp_async16(dst + 2 * k, src + 2 * k);
  }
  if ((n_words & 1) && threadIdx.x == 0) {
    cp_async8(dst + n_words - 1, src + n_words - 1);
  }
}

__global__ void __launch_bounds__(MM_CHUNK)
    mont_mul_kernel(const long long* __restrict__ a,
                    const long long* __restrict__ b,
                    long long* __restrict__ out, long long m) {
  extern __shared__ __align__(16) long long mm_smem[];
  const long long n_chunks = (m + MM_CHUNK - 1) / MM_CHUNK;
  long long c = blockIdx.x;
  if (c >= n_chunks) return;  // uniform over the block

  auto words_of = [&](long long chunk) {
    const long long left = m - chunk * MM_CHUNK;
    return (int)((left < MM_CHUNK ? left : MM_CHUNK) * FQ_LIMBS);
  };
  auto stage_a = [&](int s) { return mm_smem + (2 * s) * MM_WORDS; };
  auto stage_b = [&](int s) { return mm_smem + (2 * s + 1) * MM_WORDS; };

  mm_stage(stage_a(0), a + c * MM_WORDS, words_of(c));
  mm_stage(stage_b(0), b + c * MM_WORDS, words_of(c));
  cp_async_commit();
  for (int it = 0; c < n_chunks; ++it, c += gridDim.x) {
    const int s = it & 1;
    const long long next = c + gridDim.x;
    if (next < n_chunks) {
      mm_stage(stage_a(s ^ 1), a + next * MM_WORDS, words_of(next));
      mm_stage(stage_b(s ^ 1), b + next * MM_WORDS, words_of(next));
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's group has landed
    __syncthreads();

    const int n_words = words_of(c);
    const int n = n_words / FQ_LIMBS;
    long long* sa = stage_a(s);
    const long long* sb = stage_b(s);
    unsigned int x[FQ_LIMBS], y[FQ_LIMBS], r[FQ_LIMBS];
    const int prod = threadIdx.x;  // products past the ragged end: none
    if (prod < n) {
      fq_load(sa + prod * FQ_LIMBS, x);
      fq_load(sb + prod * FQ_LIMBS, y);
      fq_mont_mul(x, y, r);
    }
    __syncthreads();  // every read of sa is done
    if (prod < n) fq_store(r, sa + prod * FQ_LIMBS);
    __syncthreads();

    long long* dst = out + c * MM_WORDS;
    const int pieces = n_words / 2;
    for (int k = threadIdx.x; k < pieces; k += blockDim.x) {
      reinterpret_cast<longlong2*>(dst)[k] =
          reinterpret_cast<const longlong2*>(sa)[k];
    }
    if ((n_words & 1) && threadIdx.x == 0) dst[n_words - 1] = sa[n_words - 1];
    __syncthreads();  // sa is the stage the next-but-one copy refills
  }
}

// Launches on `stream` (a, b, out 16-byte aligned). Returns the launch's
// cudaGetLastError() (0 = ok).
extern "C" int mont_mul_launch(const long long* a, const long long* b,
                               long long* out, long long m, void* stream) {
  static int grid_cap = 0;  // resident blocks on the whole card
  if (m <= 0) return 0;
  if (grid_cap == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        mont_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MM_SMEM);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mont_mul_kernel, MM_CHUNK, MM_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap = sms * per_sm;
  }
  const long long n_chunks = (m + MM_CHUNK - 1) / MM_CHUNK;
  const int grid = (int)(n_chunks < grid_cap ? n_chunks : grid_cap);
  mont_mul_kernel<<<grid, MM_CHUNK, MM_SMEM, (cudaStream_t)stream>>>(a, b,
                                                                     out, m);
  return (int)cudaGetLastError();
}
