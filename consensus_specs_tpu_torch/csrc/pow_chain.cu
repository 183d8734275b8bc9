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
// What bounds it on an H100. Each row moves 240 bytes and does products x
// 465 wide multiply-adds (the throughput bound: 0.0173 ms for 512 rows of
// the square root), all dependent from one product to the next, so at the
// codec's 1-512 rows the card is nearly empty and a chain is one long
// dependent loop. Its latency floor (chip_smoke._chain_floor_ms) counts 16
// REDC digit steps a product (m_0 .. m_14 and the carry into the first
// output limb), each the clocks the probe below times for the step from m_i
// to m_{i+1} (wide multiply-add, shift, add, * n0, mask): 28.3 clocks on an
// H100 80GB HBM3 at 700 W and 1,980 MHz, so 0.1387 ms for the square root's
// 606 products and 0.1392 ms for the inversion's 608. The probe also times
// a dependent shuffle (24.0 clocks) and a dependent wide multiply-add (9.4).
// What holds the chain is issue, not latency: an issue probe (a variant of
// this file run by tools/torch_kernel_compare.py pow_chain) gives one
// warp's independent IMAD.WIDE 7.5 clocks (IMAD 2.3, IMAD.HI 6.4), so a
// product whose lanes each issue ~64 of them cannot take less than ~480
// clocks, above the floor's 453.
//
// The design (pc_mont_mul_lead below): the split REDC of mont.cuh over
// SPLIT lanes, lane 0 running the m chain from its own column with no
// shuffle on it, the other lanes a round behind with m shuffled to them, a
// carry pass of one shuffle and two ballots. 8 lanes a row (2 limbs a lane,
// ~64 wide multiply-adds a lane a product) up to PC_LATENCY_ROWS rows:
// 2,048 rows x 8 lanes is 512 warps, one per SM partition of the card's
// 528; above it 4 lanes a row (4 limbs, ~128 a lane), which needs half the
// warps. The threshold, timed in one call with this file's kernel forced
// to each lane count at every row count (square root; inversion within
// 0.002 ms):
//   rows      1-2,048         2,560   3,072   4,096   8,192
//   8 lanes   0.3018-0.3028   0.4410  0.4413  0.4425  0.8360
//   4 lanes   0.3849-0.3853   0.3856  0.3856  0.3857  0.6009
// Each variant below ran in one call of tools/torch_kernel_compare.py
// pow_chain beside the kernel's earlier product, mont.cuh's
// fq_mont_mul_split chained (0.4535-0.4570 ms across those calls; NVIDIA
// H100 80GB HBM3, 700.00 W; square-root chain, ms a launch at 1-2,048 rows
// / 4,096 / 8,192):
//   fq_mont_mul_split (4 lanes, m shuffled every round)
//      0.4536 / 0.4545 / 0.6222
//   m shuffled every round, a gathered once, 4 lanes  0.4336 / - / 0.5984
//   lead lane, 4 lanes, shuffled carry rounds         0.4193 / - / 0.6578
//   lead lane, 4 lanes, this carry pass               0.3865 / 0.3874 / 0.6148
//   lead lane, 8 lanes, shuffled carry rounds         0.4804 / - / 1.0721
//   lead lane, 8 lanes, this carry pass               0.3910 / - / 0.9279
//   lead lane, 8 lanes, slot 0 handed down early      0.3311 / 0.4612 / 0.8498
//   kept: as above, handed down before the received word is added, the
//      mask and the top lane's drop in one LOP3; 4 lanes above 2,048 rows
//      0.2997 / 0.3828 / 0.5964   (the inversion 0.3006 / 0.3840 / 0.5984)
// Dropped after timing: the a-limbs gathered a round at a time instead of
// before round 0 (0.3034 against 0.3019 in one call), the carry lookahead
// skipped when no lane carries (0.3005 against 0.2996), the a-terms on the
// FP64 pipe (b in 14-bit halves, each half's sum exact in a double based
// at 2^52: 0.3081 against 0.3019, 0.7575 against 0.6010 at 8,192; the
// folding back costs more integer ops than the FMA pipe saves). Without
// the carry pass the kept kernel takes 0.2622 ms, without the m chain's
// dependence 0.2766, without the rounds' shuffles 0.2979, without the
// gather 0.2955: the FMA pipe's issue, not a latency, sets the time. Not
// built: 56-bit digits (the chain is not what binds) and a squaring
// product (its
// triangle of terms does not map onto lanes that shift one column a round
// in step, so no lane issues fewer multiply-adds). TMA, wgmma and shared
// memory buy nothing here: a row touches 240 bytes once, and the limbs are
// 28-bit integers that the tensor cores do not multiply exactly.
// ptxas: 44 registers (8 lanes), 64 (4 lanes), 18 (probe); no spills.
#include <cuda_runtime.h>

#include "mont.cuh"

#define PC_MAX_BITS 512                // exponent bits after the top one
#define PC_WORDS (PC_MAX_BITS / 32)
#define PC_BLOCK 32                    // threads a block: one warp
// rows up to which a row takes PC_LATENCY_SPLIT lanes, PC_THROUGHPUT_SPLIT
// above: 8 lanes win at 1-2,048 rows (0.302 against 0.385 ms), 4 lanes from
// 2,560 (0.386 against 0.441; the table above)
#define PC_LATENCY_ROWS 2048
#define PC_LATENCY_SPLIT 8
#define PC_THROUGHPUT_SPLIT 4

struct PcExponent {
  unsigned int words[PC_WORDS];  // bit i in words[i / 32], bit i % 32
  int n_bits;
};

// ---------------------------------------------------------------------------
// The carry pass of a lead-lane product: lane q's SLOTS 64-bit columns
// (15 + SLOTS q + r) -> its normalized limbs. Each column splits into its
// low, middle and high 28-bit pieces, summed into limbs below 2^30 and
// carried within the lane; the lane's carry out (< 2^35, as a low word for
// the next lane's limb 0 and a high one for its limb 1) moves one lane up
// by one shuffle, after which each lane's carry out is 0 or 1. Those carries
// ripple only through lanes whose limbs are all 2^28 - 1: every lane's
// generate bit (carry out 1) and propagate bit (all limbs 2^28 - 1) go into
// two ballots, and the row's carry into each lane is the bit of
// ((G | P) + G) ^ (G | P) ^ G at its place (a carry-lookahead add; a lane
// never both generates and propagates). The top lane's carry out is
// dropped, as fq_mont_mul drops it.
//
// Overflow audit: a column < 2^62 has a high piece < 2^6, so a limb sum is
// below 2^28 + 2^28 + 2^6 + 2 and every carry fits 32 bits.
template <int SPLIT, int SLOTS>
__device__ __forceinline__ void pc_carry(const unsigned long long* acc, int q,
                                         unsigned int* out) {
  unsigned int lo[SLOTS], mid[SLOTS], hi[SLOTS];
#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    lo[r] = (unsigned int)acc[r] & FQ_MASK;
    mid[r] = (unsigned int)(acc[r] >> FQ_LIMB_BITS) & FQ_MASK;
    hi[r] = (unsigned int)(acc[r] >> (2 * FQ_LIMB_BITS));
  }
  unsigned int t = 0u;
#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    unsigned int v = lo[r] + t;
    if (r >= 1) v += mid[r - 1];
    if (r >= 2) v += hi[r - 2];
    out[r] = v & FQ_MASK;
    t = v >> FQ_LIMB_BITS;
  }
  const unsigned int c_lo = t + mid[SLOTS - 1] + hi[SLOTS - 2];
  unsigned int in_lo = __shfl_up_sync(FQ_FULL_WARP, c_lo, 1, SPLIT);
  unsigned int in_hi = __shfl_up_sync(FQ_FULL_WARP, hi[SLOTS - 1], 1, SPLIT);
  if (q == 0) in_lo = in_hi = 0u;
  unsigned int v = out[0] + in_lo;
  out[0] = v & FQ_MASK;
  unsigned int c = (v >> FQ_LIMB_BITS) + in_hi;
  bool all_ones = out[0] == FQ_MASK;
#pragma unroll
  for (int r = 1; r < SLOTS; ++r) {
    v = out[r] + c;
    out[r] = v & FQ_MASK;
    c = v >> FQ_LIMB_BITS;
    all_ones = all_ones && out[r] == FQ_MASK;
  }
  const unsigned int lane = threadIdx.x & 31u;
  const unsigned int first = lane & ~(unsigned int)(SPLIT - 1);
  const unsigned int row_bits = (1u << SPLIT) - 1u;
  const unsigned int g =
      (__ballot_sync(FQ_FULL_WARP, c != 0u) >> first) & row_bits;
  const unsigned int gp =
      ((__ballot_sync(FQ_FULL_WARP, all_ones) >> first) & row_bits) | g;
  c = (((gp + g) ^ gp ^ g) >> (lane - first)) & 1u;
#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    v = out[r] + c;
    out[r] = v & FQ_MASK;
    c = v >> FQ_LIMB_BITS;
  }
}

// ---------------------------------------------------------------------------
// The lead-lane product: a * b * 2^-420 (mod p) over a group of SPLIT lanes,
// lane q holding limbs SLOTS q .. SLOTS q + SLOTS - 1 of b and p (slot 15
// zero) and the whole of a (af, the same 15 limbs in every lane). It is
// mont.cuh's operand-scanning REDC (fq_mont_mul's columns and m_i), with
// the lanes skewed in time so that no shuffle lies on the chain of m_i:
//
// - lane 0 leads: in round i (0..14) it adds a_i * b and m_i * p to its
//   slots (columns i .. i + SLOTS - 1), m_i computed from its own column i,
//   and shifts one column down (the REDC's division by 2^28);
// - lanes 1.. trail by one round: in round i (1..15) they do digit i-1,
//   with m_{i-1} shuffled from lane 0 in round i-1 and a_{i-1} from af;
//   their slots hold columns (i-1) + SLOTS q + r;
// - each round every lane hands the low 28 bits of its slot 0 to the lane
//   below (__shfl_down_sync) and keeps the rest as its next column's carry,
//   as fq_mont_mul_split does. Under the skew lane 1's column lands in lane
//   0's slot SLOTS-2 and lane q+1's in lane q's slot SLOTS-1, added in the
//   next round;
// - the next round's a-terms go into their slots before m's terms, so the
//   chain of a round on lane 0 is: column i's low word * n0, mask, the wide
//   multiply-add m * p_0 + column i, its shift by 28, the add into column
//   i+1;
// - with 2 slots (8 lanes) a trailing lane's slot 0 is final once
//   m_{i-1} * p_0 is in, so it is handed down at the start of the round
//   (its low word needs one 32-bit multiply-add) and arrives before lane 0
//   needs it a round later. It is read before the word received last round
//   is added, so that no round's shuffle waits on the one before.
//
// After round 15 lane q holds columns 15 + SLOTS q + r and pc_carry gives
// fq_mont_mul's limbs; the top lane's slot 15 (the carry out of limb 14,
// dropped by fq_mont_mul and the plain version) is zeroed by the caller.
//
// Overflow audit: every slot holds a part of one column of fq_mont_mul's
// t (its a-terms, m-terms, the carry from the lane's own previous column
// and low words handed down), all nonnegative, so a slot never exceeds its
// column: < 2^62 (mont.cuh).
//
// Every lane of the warp must call it (the shuffles name the whole warp).
template <int SPLIT>
__device__ __forceinline__ void pc_mont_mul_lead(const unsigned int* af,
                                                 const unsigned int* b,
                                                 const unsigned int* p,
                                                 int q, unsigned int* out) {
  constexpr int SLOTS = 16 / SPLIT;
  constexpr bool early = SLOTS == 2;
  const bool lead = q == 0;
  const unsigned int n0 = lead ? FQ_N0 : 0u;            // m on lane 0 only
  const unsigned int keep = lead ? 0u : 0xffffffffu;    // shuffled m elsewhere
  // the received low word's slot: lane 0's SLOTS-2, the others' SLOTS-1;
  // the top lane receives its own word (the shuffle's width) and drops it
  const unsigned int to_lead = lead ? FQ_MASK : 0u;
  const unsigned int to_top = lead || q == SPLIT - 1 ? 0u : FQ_MASK;
  unsigned long long acc[SLOTS];
  {
    const unsigned int a0 = lead ? af[0] : 0u;
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) acc[r] = (unsigned long long)a0 * b[r];
  }
  unsigned int mraw = 0u, inc = 0u;
#pragma unroll
  for (int i = 0; i <= FQ_LIMBS; ++i) {
    unsigned int nxt = 0u;
    if (early) {
      nxt = __shfl_down_sync(FQ_FULL_WARP, (unsigned int)acc[0] + mraw * p[0],
                             1, SPLIT);
    }
    if (i > 0) {
      acc[SLOTS - 2] += inc & to_lead;
      acc[SLOTS - 1] += inc & to_top;
    }
    const unsigned int mprev = mraw & keep;
    const unsigned int m =
        i < FQ_LIMBS ? ((((unsigned int)acc[0] * n0) & FQ_MASK) | mprev)
                     : mprev;
    unsigned long long top = 0ull;
    if (i < FQ_LIMBS) {  // the next round's a-terms, in their slots after
                         // the shift
      const unsigned int an =
          lead ? (i + 1 < FQ_LIMBS ? af[i + 1] : 0u) : af[i];
#pragma unroll
      for (int r = 1; r < SLOTS; ++r)
        acc[r] += (unsigned long long)an * b[r - 1];
      top = (unsigned long long)an * b[SLOTS - 1];
    }
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) acc[r] += (unsigned long long)m * p[r];
    if (i < FQ_LIMBS) mraw = __shfl_sync(FQ_FULL_WARP, m, 0, SPLIT);
    if (!early) {
      nxt = __shfl_down_sync(FQ_FULL_WARP, (unsigned int)acc[0], 1, SPLIT);
    }
    inc = nxt;
    const unsigned long long hi = acc[0] >> FQ_LIMB_BITS;
    if (i < FQ_LIMBS || !lead) {  // round 15: lane 0 keeps its columns
#pragma unroll
      for (int r = 0; r < SLOTS - 1; ++r) acc[r] = acc[r + 1];
      acc[0] += hi;
      acc[SLOTS - 1] = i < FQ_LIMBS ? top : 0ull;
    }
  }
  acc[SLOTS - 1] += inc & (to_lead | to_top);
  pc_carry<SPLIT, SLOTS>(acc, q, out);
}

// SPLIT lanes a row; every lane of a launched warp runs the whole chain (the
// products shuffle over the full warp), lanes past the last row on zeros.
// A square takes a = the accumulator (gathered into every lane), a product
// by the base a = the base (kept whole in every lane); b is the
// accumulator's own limbs either way (a * b == b * a: the same REDC).
template <int SPLIT>
__global__ void __launch_bounds__(PC_BLOCK)
    pow_chain_lead_kernel(const long long* __restrict__ a,
                          long long* __restrict__ out, long long rows,
                          PcExponent e) {
  constexpr int SLOTS = 16 / SPLIT;
  const long long row =
      ((long long)blockIdx.x * PC_BLOCK + threadIdx.x) / SPLIT;
  const int q = threadIdx.x % SPLIT;
  const bool live = row < rows;
  unsigned int p[SLOTS], base[FQ_LIMBS], acc[SLOTS], af[FQ_LIMBS];
#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    const int k = q * SLOTS + r;
    p[r] = k < FQ_LIMBS ? FQ_P[k] : 0u;
    acc[r] = live && k < FQ_LIMBS ? (unsigned int)a[row * FQ_LIMBS + k] : 0u;
  }
#pragma unroll
  for (int k = 0; k < FQ_LIMBS; ++k) {
    base[k] = live ? (unsigned int)a[row * FQ_LIMBS + k] : 0u;
  }
  const bool top = q == SPLIT - 1;
  for (int w = 0; w * 32 < e.n_bits; ++w) {
    const unsigned int word = e.words[w];
    const int n = e.n_bits - w * 32 < 32 ? e.n_bits - w * 32 : 32;
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int k = 0; k < FQ_LIMBS; ++k) {
        af[k] = __shfl_sync(FQ_FULL_WARP, acc[k % SLOTS], k / SLOTS, SPLIT);
      }
      pc_mont_mul_lead<SPLIT>(af, acc, p, q, acc);
      if (top) acc[SLOTS - 1] = 0u;
      if ((word >> i) & 1u) {
        pc_mont_mul_lead<SPLIT>(base, acc, p, q, acc);
        if (top) acc[SLOTS - 1] = 0u;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    const int k = q * SLOTS + r;
    if (k < FQ_LIMBS) out[row * FQ_LIMBS + k] = (long long)acc[r];
  }
}

template <int SPLIT>
static int pc_launch(const long long* a, long long* out, long long rows,
                     const PcExponent& e, cudaStream_t stream) {
  const long long grid = (rows * SPLIT + PC_BLOCK - 1) / PC_BLOCK;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pow_chain_lead_kernel<SPLIT>
      <<<(unsigned int)grid, PC_BLOCK, 0, stream>>>(a, out, rows, e);
  return (int)cudaGetLastError();
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
  return rows <= PC_LATENCY_ROWS
             ? pc_launch<PC_LATENCY_SPLIT>(a, out, rows, e,
                                           (cudaStream_t)stream)
             : pc_launch<PC_THROUGHPUT_SPLIT>(a, out, rows, e,
                                              (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// The latency probe: on one warp, clock64() around PC_PROBE_CHAINS chains of
// n dependent steps each, whose clocks a step bound the chain from below:
//   0  u64 += u32 * u32 (one IMAD.WIDE.U32, its result the next operand);
//   1  __shfl_xor_sync of a 32-bit word;
//   2  the REDC digit step from m_i to m_{i+1}: m * p_0 + column (wide),
//      >> 28, + the next column, * n0, & mask.
// out[k] = the chain's clocks (lane 0's), out[PC_PROBE_CHAINS] a checksum
// that keeps the chains live. `zero` must be 0 (a value the compiler
// cannot fold).
#define PC_PROBE_CHAINS 3

__device__ __forceinline__ long long pc_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ void pc_sink(unsigned long long x) {
  asm volatile("" ::"l"(x) : "memory");
}

__global__ void pow_chain_probe_kernel(long long* out, int n,
                                       unsigned int zero) {
  const unsigned int lane = threadIdx.x;
  unsigned long long sum = 0ull;
  long long t0, t1;
  {  // 0: dependent wide multiply-adds
    unsigned long long x = lane + 3u + zero;
    const unsigned int y = 0x9e3779b9u + zero;
    t0 = pc_clock();
    x += (unsigned long long)t0 & zero;
#pragma unroll 32
    for (int k = 0; k < n; ++k) x = (unsigned long long)(unsigned int)x * y + x;
    pc_sink(x);
    t1 = pc_clock();
    if (lane == 0) out[0] = t1 - t0;
    sum += x;
  }
  {  // 1: dependent shuffles
    unsigned int x = lane * 7u + zero;
    t0 = pc_clock();
    x += (unsigned int)t0 & zero;
#pragma unroll 32
    for (int k = 0; k < n; ++k) x = __shfl_xor_sync(FQ_FULL_WARP, x, 1);
    pc_sink(x);
    t1 = pc_clock();
    if (lane == 0) out[1] = t1 - t0;
    sum += x;
  }
  {  // 2: the REDC digit step
    unsigned int m = (lane * 0x01234567u + zero) & FQ_MASK;
    const unsigned long long col = 0x0123456789abcdefull + zero;
    const unsigned long long col2 = 0x0fedcba987654321ull + zero;
    t0 = pc_clock();
    m += (unsigned int)t0 & zero;
#pragma unroll 32
    for (int k = 0; k < n; ++k) {
      const unsigned long long t = (unsigned long long)m * 0xfffaaabu + col;
      const unsigned int c = (unsigned int)(t >> FQ_LIMB_BITS) +
                             (unsigned int)col2;
      m = (c * FQ_N0) & FQ_MASK;
    }
    pc_sink(m);
    t1 = pc_clock();
    if (lane == 0) out[2] = t1 - t0;
    sum += m;
  }
  if (lane == 0) out[PC_PROBE_CHAINS] = (long long)sum;
}

// One warp on `stream`: out holds PC_PROBE_CHAINS + 1 int64 (device).
// Returns cudaGetLastError() (0 = ok).
extern "C" int pow_chain_probe_launch(long long* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  pow_chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(out, n, 0u);
  return (int)cudaGetLastError();
}
