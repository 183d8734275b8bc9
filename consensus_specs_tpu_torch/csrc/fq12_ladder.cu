// Fq12 square-and-multiply ladders over (N, 12, 15) int64 loose limb rows:
// one launch a ladder, every row in parallel, limb for limb the port's
// torch loops.
//
// Replaces two device loops of the JAX package over the Pallas product
// consensus_specs_tpu/ops/pallas_fq.py:129 `_mont_mul_kernel` (each a
// lax.scan, one device program on the TPU):
//   consensus_specs_tpu/ops/pairing.py:190 `rlc_combine`'s ladder (scan at
//     :211): RUNTIME bits, a row's own; acc starts at one, and at EVERY bit
//     acc = acc^2 * select(bit, f, one), the product by one taken on a
//     clear bit as the scan takes it (ops/pairing.rlc_combine_plain);
//   consensus_specs_tpu/ops/pairing.py:126 `_pow_fixed` (scan at :137):
//     STATIC bits, one exponent for every row (final_exp_is_one's x-chains,
//     final_exp_is_one_full's 4,314-bit exponent); acc starts at f, and
//     after the top bit acc = acc^2, times f on a set bit only: the scan
//     selects acc on a clear bit, so that product is dropped there, as
//     the chain kernel (pow_chain.cu) drops it (ops/pairing._pow_fixed_plain).
//
// What bounds it on an H100: the ladder is a chain of dependent Fq12
// products (256 for a 128-bit RLC scalar, 68-69 for an x-chain), each two
// Montgomery products deep on the function's data dependencies (the 144
// products, then the compress of a fold batch's subtrahend; the second
// batch does not wait for the first's compress). At the path's 1-64 rows
// the card is nearly empty and a row's chain sets the time: its latency
// floor is the plain ladder's traced dependent products
// (chip_smoke._chain_depth) x 16 REDC digit steps at cuda_fq.chain_probe's
// clocks. The operations bound (each Fq12 product 155 Montgomery
// products, 144 and a compress for each of the 11 folded degrees, of 465
// wide multiply-adds each) is the larger at 64 rows of 128 bits, the
// floor at an x-chain's.
//
// The design (tower.cuh): one block of TW_THREADS threads a row; the
// base, the accumulator and the product's workspace in shared memory for
// the whole ladder; 144 threads a product, 23 a column sum and carry, 6
// then 5 the fold. Simple first: pow_chain.cu's lead-lane product and
// clusters are later work.
#include <cuda_runtime.h>

#include "tower.cuh"

__global__ void __launch_bounds__(TW_THREADS)
    fq12_ladder_kernel(const long long* __restrict__ fs,
                       long long* __restrict__ out,
                       const unsigned int* __restrict__ row_words,
                       int row_stride, int n_bits, TwBits e) {
  __shared__ unsigned int base[TW_FQ12], acc[TW_FQ12], sel[TW_FQ12];
  __shared__ TwFq12Work work;
  const long long row = blockIdx.x;
  tw_fq12_load(base, fs + row * TW_FQ12);
  if (row_words != nullptr) {
    // runtime bits: acc = one, square and multiply at every bit
    const unsigned int* words = row_words + row * row_stride;
    tw_fq12_set_one(acc);
    tw_fq12_set_one(sel);
    __syncthreads();
    for (int t = 0; t < n_bits; ++t) {
      tw_fq12_mul(acc, acc, acc, work);
      tw_fq12_mul(acc, acc, tw_bit(words, t) ? base : sel, work);
    }
  } else {
    // static bits after the top one: square, and multiply on a set bit
    for (int k = threadIdx.x; k < TW_FQ12; k += blockDim.x) {
      acc[k] = (unsigned int)fs[row * TW_FQ12 + k];
    }
    __syncthreads();
    for (int t = 0; t < e.n_bits; ++t) {
      tw_fq12_mul(acc, acc, acc, work);
      if (tw_bit(e.words, t)) tw_fq12_mul(acc, acc, base, work);
    }
  }
  tw_fq12_store(out + row * TW_FQ12, acc);
}

// Launches on `stream`: fs, out (rows, 12, 15) int64. With `row_words`
// (device, rows x row_stride uint32) each row's n_bits runtime bits,
// first-processed first, 32 to a word; without it (nullptr) the static
// exponent `words` (a host array of n_bits bits after the top one).
// Returns the launch's cudaGetLastError() (0 = ok), cudaErrorInvalidValue
// for a static exponent past TW_MAX_WORDS words.
extern "C" int fq12_ladder_launch(const long long* fs, long long* out,
                                  long long rows,
                                  const unsigned int* row_words,
                                  int row_stride, const unsigned int* words,
                                  int n_bits, void* stream) {
  if (n_bits < 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  TwBits e;
  e.n_bits = 0;
  for (int w = 0; w < TW_MAX_WORDS; ++w) e.words[w] = 0u;
  if (row_words == nullptr) {
    if (n_bits > TW_MAX_WORDS * 32) return (int)cudaErrorInvalidValue;
    for (int w = 0; w * 32 < n_bits; ++w) e.words[w] = words[w];
    e.n_bits = n_bits;
  }
  fq12_ladder_kernel<<<(unsigned int)rows, TW_THREADS, 0,
                       (cudaStream_t)stream>>>(fs, out, row_words,
                                               row_stride, n_bits, e);
  return (int)cudaGetLastError();
}
