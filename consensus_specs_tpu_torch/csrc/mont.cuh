// BLS12-381 base-field arithmetic shared by the port's two CUDA kernels
// (mont_mul.cu, vm_step.cu): the Montgomery multiply, one thread a product
// (mont_mul.cu) and split over 4 threads (the step kernel's MUL unit),
// the add / borrowless-subtract of the VM's LIN unit, and the cp.async
// helpers.
//
// Representation: 15 limbs of 28 bits, R = 2^420, loose residues (limbs
// < 2^28) — the layout of the JAX package's ops/fq.py. The Pallas kernels
// split every limb into two 14-bit halves only because the TPU's vector
// unit has no 64-bit multiply; Hopper multiplies 32x32 -> 64 natively
// (IMAD.WIDE), so the limbs stay 28 bits wide and the column sums live in
// 64-bit registers.
//
// Limb-exactness: fq_mont_mul runs the same schedule as fq.mont_mul_u64
// (schoolbook columns, 15 reduction rounds, one carry pass, no final
// subtract). Any REDC with R = 2^420 and m < R yields the same integer
// (a*b + m*p) / R, hence the same normalized limbs.
//
// Overflow audit: schoolbook columns take <= 15 products < 2^56 (< 2^60);
// the reduction adds one m*p_j (< 2^56) per round plus single-limb carries,
// so every column stays < 2^62.
#pragma once

#define FQ_LIMBS 15
#define FQ_LIMB_BITS 28
#define FQ_MASK 0xFFFFFFFu

// p in 28-bit limbs, little-endian
static __constant__ unsigned int FQ_P[FQ_LIMBS] = {
    0xfffaaab, 0xfefffff, 0x3ffffb9, 0xfffeb15, 0x6241eab,
    0xa0f6b0f, 0xf6730d2, 0xf38512b, 0x4774b84, 0x4bacd76,
    0xba7b643, 0xe69a4b1, 0x1ea397f, 0x1a011, 0x0};

// MP + 1, the additive shift of the borrowless subtract (MP = the
// smallest multiple of p above 2^402)
static __constant__ unsigned int FQ_MP1[FQ_LIMBS] = {
    0xfc52049, 0x27fff2d, 0x53b5d8f, 0x85311ed, 0x62e60ec,
    0x48011de, 0x176b3a9, 0x3a7850a, 0x23aacc5, 0x7ae9960,
    0xe1b8c7d, 0xdf904af, 0x5ac9be5, 0x124db, 0x400};

// -p^-1 mod 2^28
#define FQ_N0 0xffcfffdu

// a * b * 2^-420 (mod p); loose in, loose out (< a*b/R + p)
__device__ __forceinline__ void fq_mont_mul(const unsigned int* a,
                                            const unsigned int* b,
                                            unsigned int* out) {
  unsigned long long t[2 * FQ_LIMBS];
#pragma unroll
  for (int k = 0; k < 2 * FQ_LIMBS; ++k) t[k] = 0ull;
#pragma unroll
  for (int i = 0; i < FQ_LIMBS; ++i) {
#pragma unroll
    for (int j = 0; j < FQ_LIMBS; ++j) {
      t[i + j] += (unsigned long long)a[i] * b[j];
    }
  }
#pragma unroll
  for (int i = 0; i < FQ_LIMBS; ++i) {
    // the low 28 bits of a product depend only on the operands' low bits
    unsigned int m = ((unsigned int)t[i] * FQ_N0) & FQ_MASK;
    unsigned long long carry =
        (t[i] + (unsigned long long)m * FQ_P[0]) >> FQ_LIMB_BITS;
    t[i + 1] += (unsigned long long)m * FQ_P[1] + carry;
#pragma unroll
    for (int j = 2; j < FQ_LIMBS; ++j) {
      t[i + j] += (unsigned long long)m * FQ_P[j];
    }
  }
  unsigned long long c = 0ull;
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) {
    unsigned long long cur = t[FQ_LIMBS + k] + c;
    out[k] = (unsigned int)(cur & FQ_MASK);
    c = cur >> FQ_LIMB_BITS;
  }
}

// ---------------------------------------------------------------------------
// The split Montgomery product: FQ_SPLIT = 4 neighbouring threads of one
// warp share a product, thread q holding limbs 4q .. 4q + 3 of a,
// b and p (slot 15 is zero padding). It is the operand-scanning form of the
// same REDC: round i adds a_i * b (a_i shuffled from its owner), takes
// m_i from the low 28 bits of column 0 on thread 0 and shuffles it to the
// group, adds m_i * p, and shifts the accumulator down one limb: thread q
// receives the low 28 bits of thread q+1's lowest slot (a 32-bit shuffle)
// and every thread adds the rest of its own lowest slot, shifted, into its
// new lowest slot (on thread 0 that is column 0's REDC carry). Moving
// c * 2^28 from a column to the next leaves the integer and every column's
// low 28 bits as they were, so m_i and the result are fq_mont_mul's: after
// 15 rounds the group's slots hold the integer of its columns 15 .. 29,
// carried to the same limbs by a local carry pass plus 3 shuffled carry
// rounds.
//
// Why 4 threads: each thread does 8 multiply-adds a round against 3
// shuffles, a thread's 4 limbs are one 16-byte load, and 96 MUL lanes fill
// 12 warps (384 threads) beside the 192 LIN threads: 576 threads a block,
// inside 1024 with 64 registers a thread. In the step kernel on an H100,
// on the verify path's streams, 4 threads measured faster than 2 and 8
// (PERF.md): with 8 the shuffles match the multiply-adds one for one, with
// 2 the 6 warps of products leave the SM's partitions idle.
//
// Overflow audit: every slot is one column of t (< 2^62, as above).
//
// ops/cuda_step.mont_mul_split_emulated is this schedule in numpy, held to
// the plain version and the JAX package on the CPU.
#define FQ_SPLIT 4  // threads a product
#define FQ_SLOTS 4  // limbs a thread: FQ_SPLIT * FQ_SLOTS = 16 >= FQ_LIMBS
#define FQ_FULL_WARP 0xffffffffu

// this thread's slice of p, read once per kernel (the index differs across
// the warp, which the constant cache serializes)
__device__ __forceinline__ void fq_split_p(int q, unsigned int* p) {
#pragma unroll
  for (int r = 0; r < FQ_SLOTS; ++r) {
    const int k = q * FQ_SLOTS + r;
    p[r] = k < FQ_LIMBS ? FQ_P[k] : 0u;
  }
}

// a * b * 2^-420 (mod p) over the group of FQ_SPLIT threads; every thread
// of the warp must call it (the shuffles name the whole warp)
__device__ __forceinline__ void fq_mont_mul_split(const unsigned int* a,
                                                  const unsigned int* b,
                                                  const unsigned int* p,
                                                  int q, unsigned int* out) {
  unsigned long long acc[FQ_SLOTS];
#pragma unroll
  for (int r = 0; r < FQ_SLOTS; ++r) acc[r] = 0ull;
#pragma unroll
  for (int i = 0; i < FQ_LIMBS; ++i) {
    const unsigned int ai =
        __shfl_sync(FQ_FULL_WARP, a[i % FQ_SLOTS], i / FQ_SLOTS, FQ_SPLIT);
#pragma unroll
    for (int r = 0; r < FQ_SLOTS; ++r) acc[r] += (unsigned long long)ai * b[r];
    const unsigned int m = __shfl_sync(
        FQ_FULL_WARP, ((unsigned int)acc[0] * FQ_N0) & FQ_MASK, 0, FQ_SPLIT);
#pragma unroll
    for (int r = 0; r < FQ_SLOTS; ++r) acc[r] += (unsigned long long)m * p[r];
    // each thread's slot 0 hands its low 28 bits to the thread below (the
    // same column there) and carries the rest into its own next column; on
    // thread 0, column 0 is now a multiple of 2^28 and this is the REDC
    // carry
    const unsigned long long hi = acc[0] >> FQ_LIMB_BITS;
    unsigned int next = __shfl_down_sync(
        FQ_FULL_WARP, (unsigned int)acc[0] & FQ_MASK, 1, FQ_SPLIT);
    if (q == FQ_SPLIT - 1) next = 0u;
#pragma unroll
    for (int r = 0; r < FQ_SLOTS - 1; ++r) acc[r] = acc[r + 1];
    acc[FQ_SLOTS - 1] = next;
    acc[0] += hi;
  }
  unsigned long long c = 0ull;
#pragma unroll
  for (int r = 0; r < FQ_SLOTS; ++r) {
    const unsigned long long cur = acc[r] + c;
    out[r] = (unsigned int)(cur & FQ_MASK);
    c = cur >> FQ_LIMB_BITS;
  }
  // round s settles thread s's limbs; the top thread's carry is dropped
#pragma unroll
  for (int s = 1; s < FQ_SPLIT; ++s) {
    unsigned long long cin = __shfl_up_sync(FQ_FULL_WARP, c, 1, FQ_SPLIT);
    if (q == 0) cin = 0ull;
#pragma unroll
    for (int r = 0; r < FQ_SLOTS; ++r) {
      cin += out[r];
      out[r] = (unsigned int)(cin & FQ_MASK);
      cin >>= FQ_LIMB_BITS;
    }
    c = cin;
  }
}

// ---------------------------------------------------------------------------
// cp.async: copies into shared memory that run beside the thread's work;
// cp_async_wait_all() then a barrier makes them visible to the block.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

// 16 bytes, through L2 only (streamed data)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `n` committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// LIN unit: a + (sub ? (MP + 1) + (MASK - b) : b), carried, the overflow
// limb dropped (the value mod 2^420, as fq._carry_limbs(.., 16)[:15]).
// Every partial sum stays below 3 * 2^28 + 3 < 2^32.
__device__ __forceinline__ void fq_lin(const unsigned int* a,
                                       const unsigned int* b, bool sub,
                                       unsigned int* out) {
  unsigned int c = 0u;
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) {
    unsigned int rhs = sub ? FQ_MP1[k] + (FQ_MASK - b[k]) : b[k];
    unsigned int cur = a[k] + rhs + c;
    out[k] = cur & FQ_MASK;
    c = cur >> FQ_LIMB_BITS;
  }
}

__device__ __forceinline__ void fq_load(const long long* src,
                                        unsigned int* dst) {
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) dst[k] = (unsigned int)src[k];
}

__device__ __forceinline__ void fq_store(const unsigned int* src,
                                         long long* dst) {
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) dst[k] = (long long)src[k];
}
