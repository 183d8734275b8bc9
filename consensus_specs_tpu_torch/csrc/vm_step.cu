// The field VM's step loop as one persistent kernel: every step of an
// instruction stream, both ALU units, on the int64 register file
// (rows, n_regs, 15), updated in place. One launch per call.
//
// Replaces the TPU kernel consensus_specs_tpu/ops/pallas_step.py
// `_step_kernel` (with the gathers and scatters around it in
// vm._vm_step14, and the step loop of vm.execute around that). The Pallas
// kernel receives pre-gathered (32, M) tiles of 14-bit limbs; here each
// lane loads its own operands.
//
// What bounds it on an H100: a program is a chain of dependent steps
// (PROG A 2,816, PROG B 9,728 on the verify path), and each step moves
// only ~80 KB of registers a row and does <= 96 Montgomery products, so
// bytes (the register file in and out once, plus the 3,648-byte
// instruction row a step) and operations over the whole card would allow
// well under 0.1 us a step. What sets the pace is latency and the one SM a
// row runs on: a step cannot start before the previous one's results are
// stored, its operands are an L2 round trip away, and its 96 products run
// on one SM's integer units, each a chain of 15 dependent rounds.
//
// What the design does about it:
// - One block per batch row loops over all steps, so the launch cost is
//   paid once per call, not once per step. Rows share nothing, so block
//   barriers stand in for the kernel boundary: no grid-wide sync and no
//   cooperative launch.
// - The register file stays in device memory and lives in L2 (the verify
//   path's files are 6.35 MB and 1.73 MB, against 50 MB of L2; one row is
//   ~400 KB, over the 227 KB of shared memory a block may have). The steps
//   run on a compact copy of the row (below). One block owns a row, so one
//   SM touches it, and a load after __syncthreads() sees the block's own
//   earlier stores: neither copy is const __restrict__ or read through
//   ld.global.nc. A cluster holding the row in distributed shared memory
//   was not taken: 3/4 of the reads would be remote at near-L2 latency,
//   and a cluster barrier per phase costs more than a block barrier.
// - Two barriers a step. Every lane loads its operands from the compact
//   row straight into registers, computes, and stamps its destination with
//   (step, slot) by atomicMax in a shared table of one int32 per register;
//   barrier; every lane whose slot holds its destination's stamp stores
//   its result; barrier, which is also the fence before the next step's
//   loads. So every operand is read before any result of the step is
//   written (the JAX step gathers all operands first), and a register that
//   two lanes of a step write ends as the later slot's result (MUL lanes,
//   then LIN lanes: the JAX step scatters MUL then LIN results). Idle lanes
//   read register 0 (always zero) and write their own trash register, as
//   the assembler laid them out. Gathering the operands into shared memory
//   first, or copying the next step's operands there while this step's
//   products run, measured slower on the H100 (PERF.md): the copies and
//   the products' shuffles queue for the same SM.
// - A LIN lane's result (64 bytes, one thread's) goes out through its
//   warp's slots in shared memory, so that 4 neighbouring threads store
//   the 4 pieces of one register; stored by its own thread, a warp's
//   store touched 32 registers, and a step took ~0.3 us longer on the H100.
// - Each Montgomery product is split over FQ_SPLIT = 4 threads of a warp
//   (mont.cuh fq_mont_mul_split), each loading its 4 limbs of both
//   operands as one 16-byte piece, so neighbouring threads load
//   neighbouring pieces of one register; 12 warps of MUL lanes instead of 3
//   fill the SM's four partitions. LIN lanes stay one thread each.
// - Instruction rows (3,648 bytes a step at the verify path's widths) are
//   copied into shared memory with cp.async two steps ahead. Every row's
//   block reads the same stream, so after the first it comes from L2.
#include <cuda_runtime.h>

#include "mont.cuh"

#define VM_MAX_THREADS 1024
#define VM_MAX_SMEM 232448  // bytes of shared memory a block may use
#define VM_STAGES 4         // instruction rows: s, s + 1, s + 2 in flight
#define VM_SLOT_BITS 11     // result slots < 2048 (w_mul + w_lin <= 1280)
#define VM_MAX_STEPS (1 << (31 - VM_SLOT_BITS))

// 4-byte words of one step's instruction row in the shared stage:
// msa, msb, msd (w_mul each), lsa, lsb, lsd (w_lin each), lsub (w_lin
// bytes, w_lin % 4 == 0)
__host__ __device__ __forceinline__ int vm_stage_words(int w_mul, int w_lin) {
  return 3 * w_mul + 3 * w_lin + w_lin / 4;
}

__host__ __device__ __forceinline__ int vm_mul_threads(int w_mul) {
  return (w_mul * FQ_SPLIT + 31) / 32 * 32;  // whole warps: shuffles
}

// The steps run on a compact copy of the block's row (the wrapper's
// scratch): 16 uint32 limbs a register (limb 15 zero), 64 bytes, aligned
// to two 32-byte sectors. The kernel converts the int64 row into it
// first and writes it back last. A step then moves each register in
// aligned 16-byte pieces: half the bytes and sectors of the int64 row,
// where a 120-byte register straddles 4 or 5 sectors. The stores are
// written in PTX (vm_store16): from plain uint4 stores ptxas made four
// 4-byte stores of some pieces, which cost ~0.4 us a step on the H100.
#define VM_REG 16  // uint32 limbs of a register in the compact row

// Phase timing, for tools/torch_vm_step_phases.py only: built with
// -DVM_PROFILE, thread 0 of block 0 adds the SM clocks each phase of each
// step took (load and compute, store; both end at a barrier) into
// vm_profile[1..2].
#ifdef VM_PROFILE
__device__ unsigned long long vm_profile[3];
#define VM_STAMP(i)                            \
  if (threadIdx.x == 0 && blockIdx.x == 0) {   \
    const long long now = clock64();           \
    if (i) vm_profile[i] += now - vm_last;     \
    vm_last = now;                             \
  }
#else
#define VM_STAMP(i)
#endif

// Shared memory of a block, in order: VM_STAGES instruction rows; the
// LIN lanes' results on their way to the compact row, VM_SLOT words a
// lane (20, not 16: a warp's lanes that each write their own slot 16 bytes
// at a time then cover all 32 banks), and the register each stores (-1:
// none); one int32 stamp per register of the row.
#define VM_SLOT 20
__host__ __device__ __forceinline__ int vm_lin_offset(int w_mul, int w_lin) {
  return (VM_STAGES * 4 * vm_stage_words(w_mul, w_lin) + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int vm_stamps_offset(int w_mul,
                                                         int w_lin) {
  return vm_lin_offset(w_mul, w_lin) + 4 * (VM_SLOT + 1) * w_lin;
}

__host__ __device__ __forceinline__ long long vm_smem_bytes(int w_mul,
                                                           int w_lin,
                                                           int n_regs) {
  return vm_stamps_offset(w_mul, w_lin) + 4LL * n_regs;
}

__device__ __forceinline__ void vm_stage_step(
    unsigned int* buf, long long step, const int* msa, const int* msb,
    const int* msd, const int* lsa, const int* lsb, const unsigned char* lsub,
    const int* lsd, int w_mul, int w_lin) {
  const long long om = step * w_mul;
  const long long ol = step * w_lin;
  for (int j = threadIdx.x; j < w_mul; j += blockDim.x) {
    cp_async4(buf + j, msa + om + j);
    cp_async4(buf + w_mul + j, msb + om + j);
    cp_async4(buf + 2 * w_mul + j, msd + om + j);
  }
  unsigned int* lin = buf + 3 * w_mul;
  for (int j = threadIdx.x; j < w_lin; j += blockDim.x) {
    cp_async4(lin + j, lsa + ol + j);
    cp_async4(lin + w_lin + j, lsb + ol + j);
    cp_async4(lin + 2 * w_lin + j, lsd + ol + j);
  }
  const unsigned int* sub = (const unsigned int*)(lsub + ol);
  for (int j = threadIdx.x; j < w_lin / 4; j += blockDim.x) {
    cp_async4(lin + 3 * w_lin + j, sub + j);
  }
}

// a 16-byte piece of a register (4 limbs) into a register array
__device__ __forceinline__ void vm_unpack(uint4 v, unsigned int* dst) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// 4 limbs to a 16-byte piece of the compact row, as one st.global.v4
__device__ __forceinline__ void vm_store16(unsigned int* dst, uint4 v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                   __cvta_generic_to_global(dst)),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Step s, in two barriers (see the note at the top). The instruction row
// of step s + 2 is copied while step s runs; the row of step s + 1, copied
// during step s - 1, is waited for before the second barrier.
__global__ void __launch_bounds__(VM_MAX_THREADS)
    vm_steps_kernel(long long* regs, unsigned int* compact, int n_regs,
                    const int* msa, const int* msb, const int* msd,
                    const int* lsa, const int* lsb, const unsigned char* lsub,
                    const int* lsd, int w_mul, int w_lin, int n_steps) {
  extern __shared__ __align__(16) unsigned char vm_smem[];
  unsigned int* stage = (unsigned int*)vm_smem;
  unsigned int* lres = (unsigned int*)(vm_smem + vm_lin_offset(w_mul, w_lin));
  int* lkeep = (int*)(lres + VM_SLOT * w_lin);
  int* fwd = (int*)(vm_smem + vm_stamps_offset(w_mul, w_lin));
  const int words = vm_stage_words(w_mul, w_lin);
  long long* row = regs + (long long)blockIdx.x * n_regs * FQ_LIMBS;
  unsigned int* crow = compact + (long long)blockIdx.x * n_regs * VM_REG;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int mul_threads = vm_mul_threads(w_mul);
  const bool is_mul = t < mul_threads;  // whole warps
  const int q = t % FQ_SPLIT;
  const int lane = is_mul ? t / FQ_SPLIT : t - mul_threads;
  unsigned int p[FQ_SLOTS];
  fq_split_p(q, p);

  for (int f = t; f < n_regs * VM_REG; f += nt) {
    const int reg = f / VM_REG;
    const int k = f % VM_REG;
    crow[f] = k < FQ_LIMBS ? (unsigned int)row[reg * FQ_LIMBS + k] : 0u;
  }
  for (int j = t; j < n_regs; j += nt) fwd[j] = -1;
  for (int j = 0; j < 2 && j < n_steps; ++j) {
    vm_stage_step(stage + j * words, j, msa, msb, msd, lsa, lsb, lsub, lsd,
                  w_mul, w_lin);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#ifdef VM_PROFILE
  long long vm_last = 0;
#endif
  for (int s = 0; s < n_steps; ++s) {
    const unsigned int* cur = stage + (s % VM_STAGES) * words;
    VM_STAMP(0);
    if (s + 2 < n_steps) {
      vm_stage_step(stage + ((s + 2) % VM_STAGES) * words, s + 2, msa, msb,
                    msd, lsa, lsb, lsub, lsd, w_mul, w_lin);
    }
    cp_async_commit();

    // load, compute, stamp
    unsigned int r[16];
    int dst, stamp;
    if (is_mul) {
      const int l = lane < w_mul ? lane : 0;  // padding threads: lane 0
      // limbs 4q .. 4q + 3 of each operand; limb 15 is zero
      const uint4* a = (const uint4*)(crow + (long long)cur[l] * VM_REG);
      const uint4* b =
          (const uint4*)(crow + (long long)cur[w_mul + l] * VM_REG);
      unsigned int x[FQ_SLOTS], y[FQ_SLOTS];
      vm_unpack(a[q], x);
      vm_unpack(b[q], y);
      fq_mont_mul_split(x, y, p, q, r);
      if (q == FQ_SPLIT - 1) r[FQ_SLOTS - 1] = 0u;  // limb 15
      dst = (int)cur[2 * w_mul + l];
      stamp = (s << VM_SLOT_BITS) | l;
      if (lane < w_mul && q == 0) atomicMax(fwd + dst, stamp);
    } else {
      const unsigned int* lin = cur + 3 * w_mul;
      const bool sub = ((const unsigned char*)(lin + 3 * w_lin))[lane] != 0;
      unsigned int x[16], y[16];
      const uint4* a = (const uint4*)(crow + (long long)lin[lane] * VM_REG);
      const uint4* b =
          (const uint4*)(crow + (long long)lin[w_lin + lane] * VM_REG);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vm_unpack(a[j], x + 4 * j);
        vm_unpack(b[j], y + 4 * j);
      }
      fq_lin(x, y, sub, r);
      r[FQ_LIMBS] = 0u;
      dst = (int)lin[2 * w_lin + lane];
      stamp = (s << VM_SLOT_BITS) | (w_mul + lane);
      atomicMax(fwd + dst, stamp);
    }
    __syncthreads();  // every load of step s is done; the stamps are final
    VM_STAMP(1);

    // store the lanes that hold their destination's stamp
    if (is_mul) {
      if (lane < w_mul && fwd[dst] == stamp) {
        vm_store16(crow + (long long)dst * VM_REG + 4 * q,
                   make_uint4(r[0], r[1], r[2], r[3]));
      }
    } else {
      // a LIN lane's 64 bytes go out through its warp's slots in shared
      // memory, so that 4 neighbouring threads store the 4 pieces of one
      // register: a warp's store then covers 8 whole registers, not 32
      // pieces of 32 registers
      unsigned int* mine = lres + lane * VM_SLOT;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *(uint4*)(mine + 4 * j) =
            make_uint4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
      }
      lkeep[lane] = fwd[dst] == stamp ? dst : -1;
      const int first = lane & ~31;  // the warp's first LIN lane
      const int n_w = min(32, w_lin - first);
      __syncwarp(n_w == 32 ? 0xffffffffu : (1u << n_w) - 1u);
      const int piece = 4 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the warp's lane whose piece this thread stores
        const int g = first + (lane & 31) / 4 + j * (n_w / 4);
        if (lkeep[g] >= 0) {
          vm_store16(crow + (long long)lkeep[g] * VM_REG + piece,
                     *(const uint4*)(lres + g * VM_SLOT + piece));
        }
      }
    }
    cp_async_wait<1>();  // the row of step s + 1
    __syncthreads();
    VM_STAMP(2);
  }

  for (int f = t; f < n_regs * FQ_LIMBS; f += nt) {
    const int reg = f / FQ_LIMBS;
    row[f] = (long long)crow[reg * VM_REG + f - reg * FQ_LIMBS];
  }
}

// The block width vm_run_steps launches for these widths (0 = a call the
// kernel cannot take: over 1024 threads or the shared memory a block may
// use, w_lin not a multiple of 4, or too many steps for the stamps).
extern "C" int vm_block_threads(int w_mul, int w_lin, int n_regs,
                                int n_steps) {
  if (w_mul < 0 || w_lin < 0 || w_lin % 4 != 0 || n_regs < 1) return 0;
  if (n_steps < 0 || n_steps >= VM_MAX_STEPS) return 0;
  const int threads = vm_mul_threads(w_mul) + w_lin;
  if (threads == 0 || threads > VM_MAX_THREADS) return 0;
  return vm_smem_bytes(w_mul, w_lin, n_regs) > VM_MAX_SMEM ? 0 : threads;
}

// uint32 words of the scratch vm_run_steps takes: the compact copy of
// `rows` rows of `n_regs` registers
extern "C" long long vm_scratch_words(int rows, int n_regs) {
  return (long long)rows * n_regs * VM_REG;
}

// Runs steps [0, n_steps) of an instruction stream whose per-step rows
// are w_mul (msa, msb, msd) and w_lin (lsa, lsb, lsub, lsd) wide, in one
// launch of one block per row on `stream`. `compact` is scratch of
// vm_scratch_words(rows, n_regs) uint32, 16-byte aligned. Returns
// cudaGetLastError() of the launch (0 = accepted).
extern "C" int vm_run_steps(long long* regs, unsigned int* compact, int rows,
                            int n_regs, const int* msa, const int* msb,
                            const int* msd,
                            const int* lsa, const int* lsb,
                            const unsigned char* lsub, const int* lsd,
                            int w_mul, int w_lin, int n_steps, void* stream) {
  const int threads = vm_block_threads(w_mul, w_lin, n_regs, n_steps);
  if (threads == 0 || rows <= 0 || n_steps <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)vm_smem_bytes(w_mul, w_lin, n_regs);
  cudaError_t e = cudaFuncSetAttribute(
      vm_steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  vm_steps_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      regs, compact, n_regs, msa, msb, msd, lsa, lsb, lsub, lsd, w_mul, w_lin,
      n_steps);
  return (int)cudaGetLastError();
}

#ifdef VM_PROFILE
// Copies the phase clocks out (vm_profile[0..2]) and zeroes them.
extern "C" int vm_profile_read(unsigned long long* out) {
  const unsigned long long zero[3] = {0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(out, vm_profile, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(vm_profile, zero, sizeof(zero));
}
#endif
