#!/usr/bin/env python3
"""Where a step of the port's step kernel goes, on one NVIDIA GPU.

    python3 tools/torch_vm_step_phases.py

Builds a profiling copy of consensus_specs_tpu_torch/csrc/vm_step.cu (with
-DVM_PROFILE), runs the verify path's two instruction streams
(chip_smoke.MAIN_STREAMS: PROG A miller_product k160 fold 8 on 8 rows,
PROG B hard_part fold 32 on 2 rows) once each on random canonical inputs,
and prints one JSON line per stream: the call's time (CUDA events), and
the SM clocks a step spent in each phase (PHASES: the loads and the
compute, then the stores and the wait for the next instruction row, each
ending at a barrier) as thread 0 of block 0 saw them. The profiling
build's timings include the clock reads; the kernel's own times are
chip_smoke.py's.
"""
import ctypes
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the phases of a step that vm_step.cu's VM_PROFILE build times, in order
PHASES = ("load_and_compute", "store")


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_vm_step_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from consensus_specs_tpu_torch.ops import (bls_backend, cuda_build,
                                              cuda_step, vm)

    dev = torch.device("cuda")
    print(cs._nvidia_smi("name,power.limit"), flush=True)
    out = os.path.join(cuda_build.BUILD_DIR, "libvm_step_profile.so")
    cuda_build.compile_sources({"profile": (
        os.path.join(cuda_build.CSRC_DIR, "vm_step.cu"), out,
        ("-DVM_PROFILE",))})
    lib = cuda_step.bind(ctypes.CDLL(out))
    read = lib.vm_profile_read
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p]
    clocks = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    rng = np.random.default_rng(cs.SEED)
    for label, kind, k, fold, rows in cs.MAIN_STREAMS:
        prog, _ = bls_backend._program(kind, k, fold)
        instr = prog.device_instr(dev)
        stacked = cs._canonical_limbs(rng, (rows, len(prog.input_names)))
        work = vm._init_regs(prog, stacked.astype(np.uint64), dev)
        cuda_step.launch(lib, work, instr)  # warm-up
        torch.cuda.synchronize()
        read(clocks)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cuda_step.launch(lib, work, instr)
        end.record()
        end.synchronize()
        rc = read(clocks)
        if rc != 0:
            raise RuntimeError(f"profile read failed: cudaError {rc}")
        per_step = [clocks[i + 1] / prog.n_steps for i in range(len(PHASES))]
        ms = start.elapsed_time(end)
        print(json.dumps({
            "stream": label, "kind": kind, "rows": rows,
            "steps": prog.n_steps, "ms": ms,
            "us_per_step": ms * 1e3 / prog.n_steps,
            "clocks_per_step": {**dict(zip(PHASES, per_step)),
                                "sum": sum(per_step)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
