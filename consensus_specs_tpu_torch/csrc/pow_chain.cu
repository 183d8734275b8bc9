// a^e (mod p) for a fixed exponent e over (R, 15) int64 loose limb rows:
// one launch a chain, limb for limb ops/fq.pow_fixed_steps(a, bits).
//
// Replaces the TPU program consensus_specs_tpu/ops/fq.py:245 `pow_fixed`,
// a lax.scan of square-and-multiply whose every product is the Pallas
// kernel consensus_specs_tpu/ops/pallas_fq.py:129 `_mont_mul_kernel`; on
// the TPU the whole scan runs inside one device program (the codec's
// decode, square-root, SSWU, batch-inversion and projective-to-affine
// programs).
//
// What each row does: load the base once, keep the base and the
// accumulator in registers for the whole chain, square for every bit after
// the top one and multiply by the base only where the bit is 1, store
// once. Skipping a product whose result the scan drops keeps the limbs
// exact: 606 products for the square-root exponent (p+1)/4 and 608 for
// p-2, against the scan's 756 and 760.
//
// The exponent is a kernel parameter (PcExponent, by value): the bits
// after the top one, first-processed first, packed 32 to a word, with a
// cap of PC_MAX_BITS that covers every Fq exponent of the port (<= 381
// bits). No upload, no per-shape state.
//
// What bounds it on an H100: each row reads and writes 120 bytes and does
// products x 930 32-bit IMADs (465 wide multiply-adds a product), all of
// them dependent from one product to the next. Throughput bound at 512
// rows: 606 x 512 x 930 IMADs over the card's INT32 rate, 0.0173 ms. The
// 1-row chain takes 0.453 ms, 0.75 us a dependent product; that is this
// kernel's own time, not a floor: a floor counted from the product's
// dependent shuffles and IMADs is not made yet. At the codec's 1-512 rows
// the time stays at the 1-row time: the card is nearly empty and the time
// is that of one long dependent loop. TMA, wgmma and shared memory buy
// nothing here: a row touches 240 bytes once, and the limbs are 28-bit
// integers that the tensor cores do not multiply exactly.
//
// The product is mont.cuh's fq_mont_mul_split, 4 lanes of a warp a row
// (each lane holds 4 limbs; the 16th slot, lane 3's slot 3, is zeroed
// after each product: it holds the carry out of limb 14, which
// fq_mont_mul and the plain version drop). Blocks are one warp, so the
// rows spread over the SMs instead of sharing one SM's schedulers. Why 4
// lanes and not fq_mont_mul's one thread a row: a variant of this kernel
// with that product, timed beside this one in one call on an H100 80GB
// HBM3 at 700 W (square-root chain, ms a launch, one thread / 4 lanes):
// 1 row 0.851 / 0.453, 64 rows 0.851 / 0.453, 128 0.851 / 0.454, 512
// 0.851 / 0.454, 2,048 0.851 / 0.454, 8,192 0.853 / 0.622 (the inversion
// chain within 0.5% of these). The split product's shorter dependent path
// wins at every row count measured, so that variant was removed.
// ptxas: 34 registers, no spills, no stack.
#include <cuda_runtime.h>

#include "mont.cuh"

#define PC_MAX_BITS 512                // exponent bits after the top one
#define PC_WORDS (PC_MAX_BITS / 32)
#define PC_BLOCK 32                    // threads a block: one warp

struct PcExponent {
  unsigned int words[PC_WORDS];  // bit i in words[i / 32], bit i % 32
  int n_bits;
};

// 4 lanes a row; every lane of a launched warp runs the whole chain (the
// products shuffle over the full warp), lanes past the last row on zeros
__global__ void __launch_bounds__(PC_BLOCK)
    pow_chain_split_kernel(const long long* __restrict__ a,
                           long long* __restrict__ out, long long rows,
                           PcExponent e) {
  const long long row =
      ((long long)blockIdx.x * PC_BLOCK + threadIdx.x) / FQ_SPLIT;
  const int q = threadIdx.x % FQ_SPLIT;
  const bool live = row < rows;
  unsigned int p[FQ_SLOTS], base[FQ_SLOTS], acc[FQ_SLOTS], sq[FQ_SLOTS];
  fq_split_p(q, p);
#pragma unroll
  for (int r = 0; r < FQ_SLOTS; ++r) {
    const int k = q * FQ_SLOTS + r;
    base[r] = live && k < FQ_LIMBS ? (unsigned int)a[row * FQ_LIMBS + k]
                                   : 0u;
    acc[r] = base[r];
  }
  const bool top = q == FQ_SPLIT - 1;
  for (int w = 0; w * 32 < e.n_bits; ++w) {
    const unsigned int word = e.words[w];
    const int n = e.n_bits - w * 32 < 32 ? e.n_bits - w * 32 : 32;
    for (int i = 0; i < n; ++i) {
      fq_mont_mul_split(acc, acc, p, q, sq);
      if (top) sq[FQ_SLOTS - 1] = 0u;
      if ((word >> i) & 1u) {
        fq_mont_mul_split(sq, base, p, q, acc);
        if (top) acc[FQ_SLOTS - 1] = 0u;
      } else {
#pragma unroll
        for (int r = 0; r < FQ_SLOTS; ++r) acc[r] = sq[r];
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < FQ_SLOTS; ++r) {
    const int k = q * FQ_SLOTS + r;
    if (k < FQ_LIMBS) out[row * FQ_LIMBS + k] = (long long)acc[r];
  }
}

// Launches on `stream`: a, out (rows, 15) int64, 8-byte aligned; `words`
// a host array of the exponent's bits after the top one (n_bits of them,
// first-processed first, 32 to a word). Returns the launch's
// cudaGetLastError() (0 = ok), cudaErrorInvalidValue for an exponent past
// PC_MAX_BITS.
extern "C" int pow_chain_launch(const long long* a, long long* out,
                                long long rows, const unsigned int* words,
                                int n_bits, void* stream) {
  if (n_bits < 0 || n_bits > PC_MAX_BITS) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  PcExponent e;
  for (int w = 0; w < PC_WORDS; ++w) {
    e.words[w] = w * 32 < n_bits ? words[w] : 0u;
  }
  e.n_bits = n_bits;
  const long long threads = rows * FQ_SPLIT;
  const long long grid = (threads + PC_BLOCK - 1) / PC_BLOCK;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pow_chain_split_kernel<<<(unsigned int)grid, PC_BLOCK, 0,
                           (cudaStream_t)stream>>>(a, out, rows, e);
  return (int)cudaGetLastError();
}
