// One VM step per launch: both ALU units of the field VM on the int64
// register file (rows, n_regs, 15), updated in place.
//
// Replaces the TPU kernel consensus_specs_tpu/ops/pallas_step.py
// `_step_kernel` (with the gathers and scatters around it in
// vm._vm_step14). The Pallas kernel receives pre-gathered (32, M) tiles of
// 14-bit limbs; here the kernel gathers its own operands: one block per
// batch row, one thread per lane (w_mul MUL lanes, then w_lin LIN lanes),
// and the step's instruction row is read from device memory.
//
// Read-before-write: the JAX step gathers every operand before it scatters
// any result, and a step may read a register that the same step writes.
// So every lane computes into registers, the block synchronizes, the MUL
// lanes write, the block synchronizes again, and the LIN lanes write (the
// JAX step scatters the MUL results first, then the LIN results). Rows
// are independent, so no grid-wide synchronization is needed. Idle lanes
// read register 0 (always zero) and write their own trash register, as
// the assembler laid them out.
//
// What bounds it on an H100: per row and step it moves the operand
// registers (<= 4 x 192 reads, 288 writes of 120 bytes) and does <= 96
// Montgomery products of ~465 integer multiply-adds each: bytes first.
// At the verify path's shapes (8 rows) the real limit is the per-launch
// latency of thousands of dependent small launches; vm_run_steps issues
// them all from one C loop so no Python dispatch sits between steps.
#include <cuda_runtime.h>

#include "mont.cuh"

__global__ void vm_step_kernel(long long* __restrict__ regs, int n_regs,
                               const int* __restrict__ msa,
                               const int* __restrict__ msb,
                               const int* __restrict__ msd,
                               const int* __restrict__ lsa,
                               const int* __restrict__ lsb,
                               const unsigned char* __restrict__ lsub,
                               const int* __restrict__ lsd, int w_mul,
                               int w_lin) {
  long long* row = regs + (long long)blockIdx.x * n_regs * FQ_LIMBS;
  const int t = threadIdx.x;
  const bool is_mul = t < w_mul;
  unsigned int x[FQ_LIMBS], y[FQ_LIMBS], r[FQ_LIMBS];
  int dst = -1;
  if (is_mul) {
    fq_load(row + (long long)msa[t] * FQ_LIMBS, x);
    fq_load(row + (long long)msb[t] * FQ_LIMBS, y);
    fq_mont_mul(x, y, r);
    dst = msd[t];
  } else if (t < w_mul + w_lin) {
    const int l = t - w_mul;
    fq_load(row + (long long)lsa[l] * FQ_LIMBS, x);
    fq_load(row + (long long)lsb[l] * FQ_LIMBS, y);
    fq_lin(x, y, lsub[l] != 0, r);
    dst = lsd[l];
  }
  __syncthreads();
  if (is_mul) fq_store(r, row + (long long)dst * FQ_LIMBS);
  __syncthreads();
  if (!is_mul && dst >= 0) fq_store(r, row + (long long)dst * FQ_LIMBS);
}

// Runs steps [0, n_steps) of an instruction stream whose per-step rows
// are w_mul (msa, msb, msd) and w_lin (lsa, lsb, lsub, lsd) wide: one
// launch per step, in order, on `stream`. Returns the first nonzero
// cudaGetLastError() (0 = every launch was accepted).
extern "C" int vm_run_steps(long long* regs, int rows, int n_regs,
                            const int* msa, const int* msb, const int* msd,
                            const int* lsa, const int* lsb,
                            const unsigned char* lsub, const int* lsd,
                            int w_mul, int w_lin, int n_steps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = w_mul + w_lin;
  for (int k = 0; k < n_steps; ++k) {
    const long long om = (long long)k * w_mul;
    const long long ol = (long long)k * w_lin;
    vm_step_kernel<<<rows, threads, 0, s>>>(regs, n_regs, msa + om, msb + om,
                                            msd + om, lsa + ol, lsb + ol,
                                            lsub + ol, lsd + ol, w_mul, w_lin);
    int e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  return 0;
}
