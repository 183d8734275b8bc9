// BLS12-381 base-field arithmetic shared by the port's two CUDA kernels
// (mont_mul.cu, vm_step.cu): the Montgomery multiply of the VM's MUL unit
// and the add / borrowless-subtract of its LIN unit.
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
