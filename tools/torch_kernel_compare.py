#!/usr/bin/env python3
"""Time builds of one of the port's CUDA kernels against each other, on one
NVIDIA GPU.

    python3 tools/torch_kernel_compare.py KERNEL NAME:SOURCE ...

KERNEL is ``vm_step`` or ``mont_mul``. Each NAME:SOURCE names a build: a
CUDA source with the C interface of consensus_specs_tpu_torch/csrc/
KERNEL.cu, as a path from the repository's root (a variant of the kernel
in a file of its own, or an earlier commit's source unpacked into a
gitignored directory). All are compiled at once, one nvcc each. Every
build runs the same inputs and is timed in turns, first to last and back,
with chip_smoke.py's own timer (the best of each):

  vm_step   the verify path's two instruction streams
            (chip_smoke.MAIN_STREAMS) on random canonical inputs, each
            whole stream in one launch, held limb for limb against the
            first build;
  mont_mul  65,536 products of random loose residues, 200 calls a timing
            (as chip_smoke.py's phase_mont_mul), held limb for limb against
            the plain version.

Prints the card's name and power limit, one JSON line per build (ptxas
registers and spill bytes) and one per workload (max |err| and ms of each
build; for vm_step also us a step). For example, the step kernel against a
variant of it:

    python3 tools/torch_kernel_compare.py vm_step \\
        now:consensus_specs_tpu_torch/csrc/vm_step.cu other:path/to/variant.cu
"""
import ctypes
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONT_MUL_PRODUCTS = 65536
MONT_MUL_REPS = 200


def _compile(cs, kernel, argv):
    """One nvcc per build, started together; {name: CDLL}."""
    from consensus_specs_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "compare")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for arg in argv:
        name, path = arg.split(":", 1)
        jobs[name] = (os.path.join(HERE, path),
                      os.path.join(out_dir, f"lib{kernel}_{name}.so"), ())
    reports = cuda_build.compile_sources(jobs)
    for name, (src, _, _) in jobs.items():
        print(json.dumps({"build": name, "source": os.path.relpath(src, HERE),
                          "ptxas": cs._ptxas_summary(reports[name])}),
              flush=True)
    return {name: ctypes.CDLL(out) for name, (_, out, _) in jobs.items()}


def _in_turns(cs, torch, calls, reps):
    """{name: best ms a call} over turns first to last, then back."""
    times = {}
    for name in list(calls) + list(calls)[::-1]:
        times.setdefault(name, []).append(cs._cuda_ms(torch, calls[name], reps))
    return {name: min(t) for name, t in times.items()}


def _vm_step(cs, torch, dev, rng, libs):
    from consensus_specs_tpu_torch.ops import bls_backend, cuda_step, vm

    libs = {name: cuda_step.bind(lib) for name, lib in libs.items()}
    first = next(iter(libs))
    for label, kind, k, fold, rows in cs.MAIN_STREAMS:
        prog, _ = bls_backend._program(kind, k, fold)
        instr = prog.device_instr(dev)
        stacked = cs._canonical_limbs(rng, (rows, len(prog.input_names)))
        regs0 = vm._init_regs(prog, stacked.astype(np.uint64), dev)
        outs = {}
        for name, lib in libs.items():
            outs[name] = regs0.clone()
            cuda_step.launch(lib, outs[name], instr)
        torch.cuda.synchronize()
        err = {name: int((out - outs[first]).abs().max().item())
               for name, out in outs.items()}
        ms = _in_turns(cs, torch, {
            name: (lambda lib=lib, work=outs[name]:
                   cuda_step.launch(lib, work, instr))
            for name, lib in libs.items()}, 2)
        print(json.dumps({
            "kernel": "vm_step", "stream": label, "kind": kind, "rows": rows,
            "steps": prog.n_steps, "max_abs_err_vs_first": err, "ms": ms,
            "us_per_step": {n: t * 1e3 / prog.n_steps for n, t in ms.items()},
        }), flush=True)


def _mont_mul(cs, torch, dev, rng, libs):
    from consensus_specs_tpu_torch.ops import cuda_fq, fq

    libs = {name: cuda_fq.bind(lib) for name, lib in libs.items()}
    m = MONT_MUL_PRODUCTS
    a = torch.from_numpy(cs._rand_loose_limbs(rng, (m,))).to(dev)
    b = torch.from_numpy(cs._rand_loose_limbs(rng, (m,))).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib, out):
        rc = lib.mont_mul_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 m, stream)
        if rc != 0:
            raise RuntimeError(f"mont_mul launch failed: cudaError {rc}")

    outs = {}
    for name, lib in libs.items():
        outs[name] = torch.empty_like(a)
        call(lib, outs[name])
    want = fq.mont_mul_plain(a, b)
    torch.cuda.synchronize()
    err = {name: int((out - want).abs().max().item())
           for name, out in outs.items()}
    ms = _in_turns(cs, torch, {
        name: (lambda lib=lib, out=outs[name]: call(lib, out))
        for name, lib in libs.items()}, MONT_MUL_REPS)
    print(json.dumps({"kernel": "mont_mul", "products": m,
                      "max_abs_err_vs_plain": err, "ms": ms}), flush=True)


WORKLOADS = {"vm_step": _vm_step, "mont_mul": _mont_mul}


def main(argv):
    import torch

    if len(argv) < 2 or argv[0] not in WORKLOADS:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    dev = torch.device("cuda")
    print(cs._nvidia_smi("name,power.limit"), flush=True)
    libs = _compile(cs, argv[0], argv[1:])
    WORKLOADS[argv[0]](cs, torch, dev, np.random.default_rng(cs.SEED), libs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
