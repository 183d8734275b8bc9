// The tower field's device arithmetic, shared by the five tower kernels
// (fq12_ladder.cu, fq12_fold.cu, miller_loop.cu, g1_fold.cu,
// scalar_mul.cu): the port's
// torch functions (ops/fq.py, ops/towers.py, ops/curve.py, ops/pairing.py,
// ops/mesh_reduce.py) operation for operation, so every value a kernel
// computes has the limbs its torch function gives, which are the JAX
// package's.
//
// Limbs: 15 of 28 bits, R = 2^420, loose Montgomery residues, as mont.cuh.
// Every value is carried (limbs < 2^28) between operations.
//
// The base-field operations, on values (TwFq: 15 limbs; each result is a
// value's unique carried limbs, so the order of independent operations is
// free; only each value's own chain of operations is mirrored):
//   tw_add(a, b)  = fq.add: (a + b) mod 2^420, carried (mont.cuh fq_lin);
//   tw_sub(a, b)  = fq.sub: b first COMPRESSED (a Montgomery product by
//                   ONE_MONT, the representation of 1, which can change
//                   its limbs), then (a + MP - b') mod 2^420, carried:
//                   fq_lin(a, compress(b), sub). fq_lin alone is the VM's
//                   LIN unit, whose operands never need the compress;
//   tw_neg(a)     = fq.neg: sub(0, a);
//   tw_mul(a, b)  = fq.mont_mul (mont.cuh fq_mont_mul);
//   tw_canonical(a) = fq.canonical: a product by ONE_MONT, then one
//                   conditional subtraction of p; tw_is_zero(a) =
//                   fq.is_zero, a value's test mod p (its limbs may be
//                   a non-zero multiple of p: doubling the point at
//                   infinity leaves such X and Y).
// A product by ONE_MONT is not a no-op on limbs: the compress changes a
// value's representative, so every product by an identity that the torch
// code takes (one * f, f * line2 on a clear bit) is taken here too.
//
// The Fq12 product tw_fq12_mul is a block-wide operation (every thread of
// the block calls it; TW_THREADS threads): 144 threads each make one
// Montgomery product into shared memory, 23 threads sum the product
// columns of degree k = i + j raw (at most 12 terms < 2^28, in 64 bits)
// and carry them (towers.fq12_mul's one _carry_limbs), then the w^12 =
// 2w^6 - 2 fold in the torch function's two batches: degrees 22..17 on 6
// threads, then 16..12 on 5 (each c2 = add(c, c), column k - 6 += c2,
// column k - 12 -= c2; the JAX package's degree-by-degree order, since a
// batch's reads and writes are disjoint).
//
// The Fq2 and curve steps (tw2_*, tw_dbl_step, tw_add_step, tw_g1_add)
// run on one thread: simple and right first; their latency is the
// kernels' largest term (PERF.md). They work on values (structs in
// registers or the compiler's local memory); the one function not inlined
// is the serial Montgomery product tw_mul, its operands and result passed
// by value. So a kernel holds one or two copies of the unrolled product
// instead of a copy a call site (with every product inlined, the Miller
// loop and G1 fold kernels took minutes to build), and no pointer into a
// caller's local arrays crosses a call: the first build of this file,
// whose non-inlined Fq2 functions took such pointers, gave wrong limbs on
// sm_90a in the Miller loop's lines, where a host build of the same code
// gave the right ones.
#pragma once

#include "mont.cuh"

#define TW_THREADS 160       // 5 warps: 144 product threads + 16 idle
#define TW_FQ12 (12 * FQ_LIMBS)
#define TW_FQ2 (2 * FQ_LIMBS)
#define TW_MAX_WORDS 136     // static exponent bits after the top one / 32

// 1 in Montgomery form, R mod p (ops/fq.py ONE_MONT)
static __constant__ unsigned int TW_ONE[FQ_LIMBS] = {
    0xe9f9aec, 0x7080ea8, 0x8fe4797, 0xd66716d, 0x63926e7,
    0x96fb088, 0x5aca5f4, 0x7416d1f, 0xca6d4cf, 0xb6168db,
    0xb0ee4b5, 0x5566daa, 0x974403d, 0x14820, 0x0};

// 3b = 12 in Montgomery form (ops/mesh_reduce.py _B3)
static __constant__ unsigned int TW_B3[FQ_LIMBS] = {
    0xf7e430d, 0x4f0afea, 0x7eb5d8f, 0xce0d63, 0x368bed2,
    0x6b182da, 0x977100f, 0xe1642ec, 0xfa0520c, 0xdffb124,
    0xbcd5026, 0xe5659c0, 0x36fd60, 0xc0ed, 0x0};

// a static exponent's bits after the top one, first-processed first, 32
// to a word (ops/cuda_fq._chain_words), passed by value
struct TwBits {
  unsigned int words[TW_MAX_WORDS];
  int n_bits;
};

__device__ __forceinline__ bool tw_bit(const unsigned int* words, int t) {
  return (words[t >> 5] >> (t & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// Fq on one thread, by value

struct TwFq {
  unsigned int v[FQ_LIMBS];
};

__device__ __forceinline__ TwFq tw_load(const unsigned int* src) {
  TwFq r;
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) r.v[k] = src[k];
  return r;
}

__device__ __forceinline__ TwFq tw_load64(const long long* src) {
  TwFq r;
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) r.v[k] = (unsigned int)src[k];
  return r;
}

__device__ __forceinline__ void tw_store(unsigned int* dst, const TwFq& a) {
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) dst[k] = a.v[k];
}

__device__ __forceinline__ TwFq tw_zero() {
  TwFq r;
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) r.v[k] = 0u;
  return r;
}

// the serial code's one Montgomery product, not inlined
__device__ __noinline__ TwFq tw_mul(TwFq a, TwFq b) {
  TwFq r;
  fq_mont_mul(a.v, b.v, r.v);
  return r;
}

__device__ __forceinline__ TwFq tw_add(const TwFq& a, const TwFq& b) {
  TwFq r;
  fq_lin(a.v, b.v, false, r.v);
  return r;
}

// fq.sub: the subtrahend compressed first (a product by ONE_MONT)
__device__ __forceinline__ TwFq tw_sub(const TwFq& a, const TwFq& b) {
  const TwFq c = tw_mul(b, tw_load(TW_ONE));
  TwFq r;
  fq_lin(a.v, c.v, true, r.v);
  return r;
}

__device__ __forceinline__ TwFq tw_neg(const TwFq& a) {
  return tw_sub(tw_zero(), a);
}

// a >= p on carried limbs, the most significant limb first (fq._geq_p)
__device__ __forceinline__ bool tw_geq_p(const TwFq& a) {
  bool ge = true, gt = false;
#pragma unroll
  for (int k = FQ_LIMBS - 1; k >= 0; --k) {
    gt = gt || (ge && a.v[k] > FQ_P[k]);
    ge = ge && a.v[k] == FQ_P[k];
  }
  return gt || ge;
}

// a - p with borrows, on the carried limbs of a value >= p (fq._sub_p):
// each limb's a + 2^28 - p_k - borrow lies in [0, 2^29)
__device__ __forceinline__ TwFq tw_sub_p(const TwFq& a) {
  TwFq r;
  unsigned int borrow = 0u;
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) {
    const unsigned int cur = a.v[k] + (1u << FQ_LIMB_BITS) - FQ_P[k] - borrow;
    r.v[k] = cur & FQ_MASK;
    borrow = 1u - (cur >> FQ_LIMB_BITS);
  }
  return r;
}

// fq.canonical: the representative in [0, p)
__device__ __forceinline__ TwFq tw_canonical(const TwFq& a) {
  const TwFq r = tw_mul(a, tw_load(TW_ONE));
  return tw_geq_p(r) ? tw_sub_p(r) : r;
}

// fq.is_zero: a == 0 mod p
__device__ __forceinline__ bool tw_is_zero(const TwFq& a) {
  const TwFq c = tw_canonical(a);
  unsigned int any = 0u;
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) any |= c.v[k];
  return any == 0u;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1) on one thread (ops/towers.py fq2_*)

struct TwFq2 {
  TwFq c0, c1;
};

__device__ __forceinline__ TwFq2 tw2_load64(const long long* src) {
  return {tw_load64(src), tw_load64(src + FQ_LIMBS)};
}

__device__ __forceinline__ TwFq2 tw2_add(const TwFq2& a, const TwFq2& b) {
  return {tw_add(a.c0, b.c0), tw_add(a.c1, b.c1)};
}

__device__ __forceinline__ TwFq2 tw2_sub(const TwFq2& a, const TwFq2& b) {
  return {tw_sub(a.c0, b.c0), tw_sub(a.c1, b.c1)};
}

__device__ __forceinline__ TwFq2 tw2_neg(const TwFq2& a) {
  return {tw_neg(a.c0), tw_neg(a.c1)};
}

// t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
// (sub(t0, t1), sub(t2, add(t0, t1)))
__device__ __forceinline__ TwFq2 tw2_mul(const TwFq2& a, const TwFq2& b) {
  const TwFq t0 = tw_mul(a.c0, b.c0);
  const TwFq t1 = tw_mul(a.c1, b.c1);
  const TwFq t2 = tw_mul(tw_add(a.c0, a.c1), tw_add(b.c0, b.c1));
  return {tw_sub(t0, t1), tw_sub(t2, tw_add(t0, t1))};
}

// (mul(add(a0, a1), sub(a0, a1)), add(a0 a1, a0 a1))
__device__ __forceinline__ TwFq2 tw2_square(const TwFq2& a) {
  const TwFq c1 = tw_mul(a.c0, a.c1);
  return {tw_mul(tw_add(a.c0, a.c1), tw_sub(a.c0, a.c1)), tw_add(c1, c1)};
}

// towers.fq2_is_zero: both coefficients canonicalized (two products,
// both made), then tested
__device__ __forceinline__ bool tw2_is_zero(const TwFq2& a) {
  const bool z0 = tw_is_zero(a.c0);
  const bool z1 = tw_is_zero(a.c1);
  return z0 && z1;
}

// an Fq2 by an Fq scalar: both coefficients times s
__device__ __forceinline__ TwFq2 tw2_mul_scalar(const TwFq2& a,
                                                const TwFq& s) {
  return {tw_mul(a.c0, s), tw_mul(a.c1, s)};
}

// xi = 1 + u (towers.fq2_const(1, 1))
__device__ __forceinline__ TwFq2 tw2_xi() {
  return {tw_load(TW_ONE), tw_load(TW_ONE)};
}

// towers.fq12_from_tower_components(c00, c11w, c12w) into a flat Fq12 in
// shared memory: an Fq2 a + b u at w^k (k = 0, 3, 5) lands as
// add(0, sub(a, b)) at w^k and add(0, b) at w^(k + 6); the other
// coefficients are 0
__device__ __forceinline__ void tw_fq12_from_components(unsigned int* f,
                                                        const TwFq2& c00,
                                                        const TwFq2& c11w,
                                                        const TwFq2& c12w) {
  const TwFq z = tw_zero();
  for (int k = 0; k < 12; ++k) tw_store(f + k * FQ_LIMBS, z);
  tw_store(f + 0 * FQ_LIMBS, tw_add(z, tw_sub(c00.c0, c00.c1)));
  tw_store(f + 6 * FQ_LIMBS, tw_add(z, c00.c1));
  tw_store(f + 3 * FQ_LIMBS, tw_add(z, tw_sub(c11w.c0, c11w.c1)));
  tw_store(f + 9 * FQ_LIMBS, tw_add(z, c11w.c1));
  tw_store(f + 5 * FQ_LIMBS, tw_add(z, tw_sub(c12w.c0, c12w.c1)));
  tw_store(f + 11 * FQ_LIMBS, tw_add(z, c12w.c1));
}

// ---------------------------------------------------------------------------
// The Miller loop's steps (ops/pairing.py _dbl_step, _add_step, and
// ops/curve.py double over Fq2), on one thread: T is (X, Y, Z) in
// Jacobian coordinates on the twist, (xp, yp) an affine G1 point; the line
// from the old T is written as a flat Fq12 to shared memory, and T is
// updated.

struct TwG2 {
  TwFq2 x, y, z;
};

__device__ __forceinline__ void tw_dbl_step(TwG2& T, const TwFq& xp,
                                            const TwFq& yp,
                                            unsigned int* line) {
  const TwFq2 X2 = tw2_square(T.x);
  const TwFq2 A3 = tw2_add(tw2_add(X2, X2), X2);  // 3X^2
  const TwFq2 Y2 = tw2_square(T.y);
  const TwFq2 Z2 = tw2_square(T.z);
  const TwFq2 Z3 = tw2_mul(Z2, T.z);
  TwFq2 YZ3 = tw2_mul(T.y, Z3);
  YZ3 = tw2_add(YZ3, YZ3);  // 2YZ^3
  // c_1 = -(2YZ^3 xi) yp; c_v2w = (3X^2 Z^2) xp; c_vw = 2Y^2 - 3X^2 X
  const TwFq2 c1 = tw2_mul_scalar(tw2_neg(tw2_mul(YZ3, tw2_xi())), yp);
  const TwFq2 cv2w = tw2_mul_scalar(tw2_mul(A3, Z2), xp);
  const TwFq2 cvw = tw2_sub(tw2_add(Y2, Y2), tw2_mul(A3, T.x));
  tw_fq12_from_components(line, c1, cvw, cv2w);

  // T = double(T) (ops/curve.py double, a = 0)
  const TwFq2 A = tw2_square(T.x);
  const TwFq2 B = tw2_square(T.y);
  const TwFq2 C = tw2_square(B);
  const TwFq2 t = tw2_sub(tw2_sub(tw2_square(tw2_add(T.x, B)), A), C);
  const TwFq2 D = tw2_add(t, t);
  const TwFq2 E = tw2_add(tw2_add(A, A), A);
  const TwFq2 X3 = tw2_sub(tw2_square(E), tw2_add(D, D));
  const TwFq2 cc = tw2_add(C, C);
  const TwFq2 c4 = tw2_add(cc, cc);
  const TwFq2 C8 = tw2_add(c4, c4);
  const TwFq2 Y3 = tw2_sub(tw2_mul(E, tw2_sub(D, X3)), C8);
  const TwFq2 YZ = tw2_mul(T.y, T.z);
  T.z = tw2_add(YZ, YZ);
  T.x = X3;
  T.y = Y3;
}

__device__ __forceinline__ void tw_add_step(TwG2& T, const TwFq2& qx,
                                            const TwFq2& qy, const TwFq& xp,
                                            const TwFq& yp,
                                            unsigned int* line) {
  const TwFq2 Z2 = tw2_square(T.z);
  const TwFq2 Z3 = tw2_mul(Z2, T.z);
  const TwFq2 U2 = tw2_mul(qx, Z2);
  const TwFq2 S2 = tw2_mul(qy, Z3);
  const TwFq2 H = tw2_sub(U2, T.x);
  const TwFq2 Rr = tw2_sub(S2, T.y);
  const TwFq2 HZ = tw2_mul(H, T.z);
  // c_1 = -(HZ xi) yp; c_v2w = R xp; c_vw = qy HZ - R qx
  const TwFq2 c1 = tw2_mul_scalar(tw2_neg(tw2_mul(HZ, tw2_xi())), yp);
  const TwFq2 cv2w = tw2_mul_scalar(Rr, xp);
  const TwFq2 cvw = tw2_sub(tw2_mul(qy, HZ), tw2_mul(Rr, qx));
  tw_fq12_from_components(line, c1, cvw, cv2w);

  // the mixed addition's generic path (T == +-Q cannot occur mid-loop)
  const TwFq2 H2 = tw2_square(H);
  const TwFq2 H3 = tw2_mul(H2, H);
  const TwFq2 V = tw2_mul(T.x, H2);
  const TwFq2 X3 = tw2_sub(tw2_sub(tw2_square(Rr), H3), tw2_add(V, V));
  const TwFq2 Y3 = tw2_sub(tw2_mul(Rr, tw2_sub(V, X3)), tw2_mul(T.y, H3));
  T.x = X3;
  T.y = Y3;
  T.z = HZ;
}

// ---------------------------------------------------------------------------
// G1 complete projective addition (ops/mesh_reduce.py g1_complete_add,
// Renes-Costello-Batina algorithm 7, a = 0, b = 4) on one thread

struct TwG1 {
  TwFq x, y, z;
};

__device__ __forceinline__ TwG1 tw_g1_add(const TwG1& p1, const TwG1& p2) {
  const TwFq b3 = tw_load(TW_B3);
  TwFq t0 = tw_mul(p1.x, p2.x);
  TwFq t1 = tw_mul(p1.y, p2.y);
  TwFq t2 = tw_mul(p1.z, p2.z);
  TwFq t3 = tw_mul(tw_add(p1.x, p1.y), tw_add(p2.x, p2.y));
  t3 = tw_sub(t3, tw_add(t0, t1));
  TwFq t4 = tw_mul(tw_add(p1.y, p1.z), tw_add(p2.y, p2.z));
  t4 = tw_sub(t4, tw_add(t1, t2));
  TwFq X3 = tw_mul(tw_add(p1.x, p1.z), tw_add(p2.x, p2.z));
  TwFq Y3 = tw_sub(X3, tw_add(t0, t2));
  X3 = tw_add(t0, t0);
  t0 = tw_add(X3, t0);
  t2 = tw_mul(b3, t2);
  TwFq Z3 = tw_add(t1, t2);
  t1 = tw_sub(t1, t2);
  Y3 = tw_mul(b3, Y3);
  X3 = tw_mul(t4, Y3);
  t2 = tw_mul(t3, t1);
  X3 = tw_sub(t2, X3);
  Y3 = tw_mul(Y3, t0);
  t1 = tw_mul(t1, Z3);
  Y3 = tw_add(t1, Y3);
  t0 = tw_mul(t0, t3);
  Z3 = tw_mul(Z3, t4);
  Z3 = tw_add(Z3, t0);
  return {X3, Y3, Z3};
}

// ---------------------------------------------------------------------------
// Jacobian curve arithmetic over Fq (G1) and Fq2 (G2) on one thread
// (ops/curve.py double and add_mixed). The cv_* overloads name one
// field's operations (curve.FQ_OPS, curve.FQ2_OPS), so one template
// serves both groups; the second argument of cv_one and cv_zero only
// picks the field.

__device__ __forceinline__ TwFq cv_add(const TwFq& a, const TwFq& b) {
  return tw_add(a, b);
}
__device__ __forceinline__ TwFq2 cv_add(const TwFq2& a, const TwFq2& b) {
  return tw2_add(a, b);
}
__device__ __forceinline__ TwFq cv_sub(const TwFq& a, const TwFq& b) {
  return tw_sub(a, b);
}
__device__ __forceinline__ TwFq2 cv_sub(const TwFq2& a, const TwFq2& b) {
  return tw2_sub(a, b);
}
__device__ __forceinline__ TwFq cv_mul(const TwFq& a, const TwFq& b) {
  return tw_mul(a, b);
}
__device__ __forceinline__ TwFq2 cv_mul(const TwFq2& a, const TwFq2& b) {
  return tw2_mul(a, b);
}
__device__ __forceinline__ TwFq cv_sq(const TwFq& a) { return tw_mul(a, a); }
__device__ __forceinline__ TwFq2 cv_sq(const TwFq2& a) {
  return tw2_square(a);
}
__device__ __forceinline__ bool cv_is_zero(const TwFq& a) {
  return tw_is_zero(a);
}
__device__ __forceinline__ bool cv_is_zero(const TwFq2& a) {
  return tw2_is_zero(a);
}
__device__ __forceinline__ TwFq cv_one(const TwFq&) {
  return tw_load(TW_ONE);
}
__device__ __forceinline__ TwFq2 cv_one(const TwFq2&) {
  return {tw_load(TW_ONE), tw_zero()};
}
__device__ __forceinline__ TwFq cv_zero(const TwFq&) { return tw_zero(); }
__device__ __forceinline__ TwFq2 cv_zero(const TwFq2&) {
  return {tw_zero(), tw_zero()};
}

template <class F>
struct TwJac {
  F x, y, z;
};

// curve.double (a = 0). A point with Y == 0, or at infinity, doubles to
// Z == 0 (Z3 = 2YZ); infinity's X and Y become non-zero multiples of p.
// 8C is (2C + 2C) + (2C + 2C), whose limbs are curve.py's sum of eight
// (a sum is exact mod 2^420, so its grouping leaves the limbs alone).
template <class F>
__device__ __forceinline__ TwJac<F> tw_jac_double(const TwJac<F>& p) {
  const F A = cv_sq(p.x);
  const F B = cv_sq(p.y);
  const F C = cv_sq(B);
  const F t = cv_add(p.x, B);
  const F t2 = cv_sub(cv_sub(cv_sq(t), A), C);
  const F D = cv_add(t2, t2);
  const F E = cv_add(cv_add(A, A), A);
  const F Fv = cv_sq(E);
  const F X3 = cv_sub(Fv, cv_add(D, D));
  const F c2 = cv_add(C, C);
  const F C8 = cv_add(cv_add(c2, c2), cv_add(c2, c2));
  const F Y3 = cv_sub(cv_mul(E, cv_sub(D, X3)), C8);
  const F YZ = cv_mul(p.y, p.z);
  return {X3, Y3, cv_add(YZ, YZ)};
}

// curve.add_mixed(p, (qx, qy)), only the branch its selects keep made, in
// their priority order: p at infinity -> (qx, qy, 1); H == 0 and R == 0
// (p == Q) -> double(p), left to the caller (TW_ADD_DOUBLE: the doubling
// keeps one call site in a kernel); H == 0 (p == -Q) -> all-zero limbs;
// else the generic formula. Every zero test is mod p, as the selects'.
#define TW_ADD_DONE 0
#define TW_ADD_DOUBLE 1

template <class F>
__device__ __forceinline__ int tw_jac_add_mixed(TwJac<F>& p, const F& qx,
                                                const F& qy) {
  if (cv_is_zero(p.z)) {
    p = {qx, qy, cv_one(qx)};
    return TW_ADD_DONE;
  }
  const F Z2 = cv_sq(p.z);
  const F Z3 = cv_mul(Z2, p.z);
  const F U2 = cv_mul(qx, Z2);
  const F S2 = cv_mul(qy, Z3);
  const F H = cv_sub(U2, p.x);
  const F R = cv_sub(S2, p.y);
  const bool h_zero = cv_is_zero(H);
  const bool r_zero = cv_is_zero(R);
  if (h_zero) {
    if (r_zero) return TW_ADD_DOUBLE;
    p = {cv_zero(qx), cv_zero(qx), cv_zero(qx)};
    return TW_ADD_DONE;
  }
  const F H2 = cv_sq(H);
  const F H3 = cv_mul(H2, H);
  const F V = cv_mul(p.x, H2);
  const F R2 = cv_sq(R);
  const F X3 = cv_sub(cv_sub(R2, H3), cv_add(V, V));
  const F Y3 = cv_sub(cv_mul(R, cv_sub(V, X3)), cv_mul(p.y, H3));
  p = {X3, Y3, cv_mul(p.z, H)};
  return TW_ADD_DONE;
}

// ---------------------------------------------------------------------------
// Block-wide Fq12 values in shared memory

struct TwFq12Work {
  unsigned int prod[144 * FQ_LIMBS];  // a_i b_j at i * 12 + j
  unsigned int cols[23 * FQ_LIMBS];   // the carried columns, then folded
};

__device__ __forceinline__ void tw_fq12_set_one(unsigned int* f) {
  for (int k = threadIdx.x; k < TW_FQ12; k += blockDim.x) {
    f[k] = k < FQ_LIMBS ? TW_ONE[k] : 0u;
  }
}

__device__ __forceinline__ void tw_fq12_load(unsigned int* f,
                                             const long long* src) {
  for (int k = threadIdx.x; k < TW_FQ12; k += blockDim.x) {
    f[k] = (unsigned int)src[k];
  }
}

__device__ __forceinline__ void tw_fq12_store(long long* dst,
                                              const unsigned int* f) {
  for (int k = threadIdx.x; k < TW_FQ12; k += blockDim.x) {
    dst[k] = (long long)f[k];
  }
}

// out = a * b (towers.fq12_mul); every thread of the block calls it, with
// the block synchronized on entry (a and b written). out may alias a or b;
// the block is synchronized on return.
__device__ void tw_fq12_mul(unsigned int* out, const unsigned int* a,
                            const unsigned int* b, TwFq12Work& w) {
  const int tid = threadIdx.x;
  if (tid < 144) {  // the unrolled product, inlined: one call site
    unsigned int x[FQ_LIMBS], y[FQ_LIMBS], r[FQ_LIMBS];
#pragma unroll
    for (int k = 0; k < FQ_LIMBS; ++k) {
      x[k] = a[(tid / 12) * FQ_LIMBS + k];
      y[k] = b[(tid % 12) * FQ_LIMBS + k];
    }
    fq_mont_mul(x, y, r);
#pragma unroll
    for (int k = 0; k < FQ_LIMBS; ++k) w.prod[tid * FQ_LIMBS + k] = r[k];
  }
  __syncthreads();
  if (tid < 23) {  // column k: the raw sum of a_i b_(k-i), carried
    const int k = tid;
    unsigned long long s[FQ_LIMBS];
#pragma unroll
    for (int l = 0; l < FQ_LIMBS; ++l) s[l] = 0ull;
    const int lo = k < 12 ? 0 : k - 11, hi = k < 12 ? k : 11;
    for (int i = lo; i <= hi; ++i) {
      const unsigned int* p = w.prod + (i * 12 + (k - i)) * FQ_LIMBS;
#pragma unroll
      for (int l = 0; l < FQ_LIMBS; ++l) s[l] += p[l];
    }
    unsigned long long c = 0ull;
#pragma unroll
    for (int l = 0; l < FQ_LIMBS; ++l) {
      const unsigned long long cur = s[l] + c;
      w.cols[k * FQ_LIMBS + l] = (unsigned int)(cur & FQ_MASK);
      c = cur >> FQ_LIMB_BITS;
    }
  }
  __syncthreads();
  // the fold: degrees 22..17, then 16..12
  for (int batch = 0; batch < 2; ++batch) {
    const int n = batch == 0 ? 6 : 5;
    if (tid < n) {
      const int k = (batch == 0 ? 17 : 12) + tid;
      unsigned int* lo = w.cols + (k - 12) * FQ_LIMBS;
      unsigned int* mid = w.cols + (k - 6) * FQ_LIMBS;
      const TwFq c = tw_load(w.cols + k * FQ_LIMBS);
      const TwFq c2 = tw_add(c, c);
      tw_store(mid, tw_add(tw_load(mid), c2));
      tw_store(lo, tw_sub(tw_load(lo), c2));
    }
    __syncthreads();
  }
  for (int k = tid; k < TW_FQ12; k += blockDim.x) out[k] = w.cols[k];
  __syncthreads();
}

// out = x^(p^6) (towers.fq12_conjugate): the odd-degree coefficients
// negated; block-wide, synchronized on entry and on return
__device__ void tw_fq12_conjugate(unsigned int* out, const unsigned int* a) {
  const int tid = threadIdx.x;
  if (tid < 12) {
    const TwFq x = tw_load(a + tid * FQ_LIMBS);
    tw_store(out + tid * FQ_LIMBS, (tid & 1) ? tw_neg(x) : x);
  }
  __syncthreads();
}
