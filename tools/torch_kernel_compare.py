#!/usr/bin/env python3
"""Time builds of one of the port's CUDA kernels against each other, on one
NVIDIA GPU.

    python3 tools/torch_kernel_compare.py KERNEL NAME:SOURCE ...

KERNEL is ``vm_step``, ``mont_mul``, ``pow_chain`` or one of the tower
kernels, ``fq12_ladder``, ``fq12_fold``, ``miller_loop``, ``g1_fold`` and
``scalar_mul``.
Each NAME:SOURCE
names a build: a CUDA source with the C interface of
consensus_specs_tpu_torch/csrc/KERNEL.cu, as a path from the repository's
root (a variant of the kernel in a file of its own, or an earlier commit's
source unpacked into a gitignored directory). All are compiled at once,
one nvcc each. Every build runs the same inputs and is timed in turns,
first to last and back, with chip_smoke.py's own timer (the best of
each):

  vm_step   the verify path's two instruction streams
            (chip_smoke.MAIN_STREAMS) on random canonical inputs, each
            whole stream in one launch, held limb for limb against the
            first build;
  mont_mul  65,536 products of random loose residues, 200 calls a timing
            (as chip_smoke.py's phase_mont_mul), held limb for limb against
            the plain version;
  pow_chain both exponents of the codec's chains (the square root, the
            inversion) at chip_smoke.CHAIN_ROWS + CHAIN_WIDE_ROWS and
            CHAIN_EXTRA_ROWS, each build held limb for limb against the
            plain chain (every product fq.mont_mul_plain, on the card), 20
            calls a timing; the 1-row lines add the port's own build's
            latency probe, the SM clock under load and the latency floor.
            A build that also exports ``pow_chain_issue_probe_launch``
            (out, n, stream) -- a variant carrying an issue probe: clock64
            around n steps of ISSUE_PROBE_INDEPENDENT independent
            IMAD.WIDE, IMAD and IMAD.HI on one warp, out[k] the clocks of
            chain k, out[3] a checksum -- gets a line of the clocks one
            warp's issue gives each;
  the tower kernels (ops/cuda_tower.py), each build through the port's
            wrapper at the main path's shapes, held limb for limb against
            the plain version (on the card), 3 calls a timing:
            fq12_ladder the tower combine's 64 rows x 128 runtime bits and
                        an x-chain (static |x|) on 64 rows;
            fq12_fold   a slot's 16 chunk products from one, the pairing
                        product's 2 x 64 from the first, a tree level of 64;
            miller_loop the twins' stacked 128 rows and 8 rows;
            g1_fold     a mesh slot's 512-point shard (P2's 2,048 keys on
                        4 slots);
            scalar_mul  the twins' subgroup checks over r's bits, 64 G1
                        and 64 G2 points of the subgroup.

Prints the card's name and power limit, one JSON line per build (ptxas
registers and spill bytes) and one per workload (max |err| and ms of each
build; for vm_step also us a step). For example, the step kernel against a
variant of it:

    python3 tools/torch_kernel_compare.py vm_step \\
        now:consensus_specs_tpu_torch/csrc/vm_step.cu other:path/to/variant.cu

or the chain kernel against an earlier commit's, unpacked first:

    mkdir -p _archive/old
    git show REV:consensus_specs_tpu_torch/csrc/pow_chain.cu \\
        > _archive/old/pow_chain.cu
    python3 tools/torch_kernel_compare.py pow_chain \\
        now:consensus_specs_tpu_torch/csrc/pow_chain.cu \\
        old:_archive/old/pow_chain.cu
"""
import ctypes
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONT_MUL_PRODUCTS = 65536
MONT_MUL_REPS = 200
# the chain workload's row counts beside chip_smoke's: past the codec's
# widest and below the widest timed there, where a kernel's row threshold
# falls (2,560: the main path's widest decode, one chain for a 2,560-key
# aggregate's fresh pubkeys)
CHAIN_EXTRA_ROWS = (2560, 3072, 4096)
# independent multiply-adds a step of each chain of an issue probe
ISSUE_PROBE_INDEPENDENT = 8
ISSUE_PROBE_CHAINS = ("wide_mac", "imad", "imad_hi")


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


def _pow_chain(cs, torch, dev, rng, libs):
    from consensus_specs_tpu_torch.ops import codec, cuda_fq, fq

    libs = {name: cuda_fq.bind_chain(lib) for name, lib in libs.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, lib in libs.items():
        if not hasattr(lib, "pow_chain_issue_probe_launch"):
            continue
        steps = 4096
        out = torch.zeros(len(ISSUE_PROBE_CHAINS) + 1, dtype=torch.int64,
                          device=dev)
        rc = lib.pow_chain_issue_probe_launch(
            ctypes.c_void_p(out.data_ptr()), steps, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{name}: issue probe failed: cudaError {rc}")
        clocks = out[:len(ISSUE_PROBE_CHAINS)].tolist()
        print(json.dumps({"kernel": "pow_chain", "build": name,
                          "issue_clocks": {
                              chain: c / (steps * ISSUE_PROBE_INDEPENDENT)
                              for chain, c in zip(ISSUE_PROBE_CHAINS,
                                                  clocks)}}), flush=True)
    # the port's own build: its latency probe, and the SM clock under load
    probe = cuda_fq.chain_probe(dev)
    for label, bits in (("sqrt", codec._SQRT_BITS),
                        ("inv", fq._P_MINUS_2_BITS)):
        words = cuda_fq._chain_words(tuple(bits))
        products = len(bits) - 1 + sum(bits[1:])
        for rows in sorted(set(cs.CHAIN_ROWS + cs.CHAIN_WIDE_ROWS
                               + CHAIN_EXTRA_ROWS)):
            a = torch.from_numpy(cs._canonical_limbs(rng, (rows,))).to(dev)

            def call(lib, out):
                rc = lib.pow_chain_launch(a.data_ptr(), out.data_ptr(), rows,
                                          ctypes.addressof(words),
                                          len(bits) - 1, stream)
                if rc != 0:
                    raise RuntimeError(
                        f"pow_chain launch failed: cudaError {rc}")

            outs = {}
            for name, lib in libs.items():
                outs[name] = torch.empty_like(a)
                call(lib, outs[name])
            with cs._patched(cuda_fq, "mont_mul",
                             lambda real: fq.mont_mul_plain):
                want = fq.pow_fixed_steps(a, bits)
            torch.cuda.synchronize()
            err = {name: int((out - want).abs().max().item())
                   for name, out in outs.items()}
            ms = _in_turns(cs, torch, {
                name: (lambda lib=lib, out=outs[name]: call(lib, out))
                for name, lib in libs.items()}, 20)
            line = {"kernel": "pow_chain", "chain": label, "rows": rows,
                    "products": products, "max_abs_err_vs_plain": err,
                    "ms": ms}
            if rows == 1:
                first = next(iter(libs))
                mhz = cs._sm_clock_mhz_under(
                    torch, lambda: call(libs[first], outs[first]), ms[first])
                line.update(sm_clock_mhz=mhz, probe_clocks=probe,
                            latency_floor_ms=cs._chain_floor_ms(
                                products, probe["digit"], mhz))
            print(json.dumps(line), flush=True)


def _tower_cases(cs, torch, dev, rng, kernel):
    """[(label, the wrapper's call, its plain version's call)] at the main
    path's shapes."""
    from consensus_specs_tpu_torch.ops import (cuda_tower, curve, fq,
                                               mesh_reduce, mesh_rlc, pairing)
    from consensus_specs_tpu_torch.utils import bls12_381 as O

    fs = torch.from_numpy(cs._rand_loose_limbs(rng, (64, 12), bits=382)
                          ).to(dev)
    if kernel == "fq12_ladder":
        bits = torch.from_numpy(rng.random((64, 128)) < 0.5).to(dev)
        x = pairing._ABS_X_BITS
        return [("runtime bits 64x128",
                 lambda: cuda_tower.fq12_ladder(fs, bits),
                 lambda: pairing._rlc_ladder_plain(fs, bits)),
                ("|x| chain, 64 rows", lambda: cuda_tower.fq12_pow(fs, x),
                 lambda: pairing._pow_fixed_plain(fs, x))]
    if kernel == "fq12_fold":
        seq, pair = fs[:16, None], fs.view(2, 32, 12, 15)
        return [("from one, 16 x 1", lambda: cuda_tower.fq12_fold(seq, True),
                 lambda: mesh_rlc._local_fold_plain(seq)),
                ("from the first, 2 x 32",
                 lambda: cuda_tower.fq12_fold(pair, False),
                 lambda: pairing._fq12_product_plain(pair)),
                ("level 64", lambda: cuda_tower.fq12_fold_level(fs),
                 lambda: pairing._fq12_tree_level_plain(fs))]
    if kernel == "miller_loop":
        _, limbs, _ = cs._twins_inputs(64, set(), cs.TWINS_SEED)
        t = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
             for k, v in limbs.items()}
        qpx = [torch.stack([t[f"{c}1"], t[f"{c}2"]])
               for c in ("qx", "qy", "px", "py")]
        few = [x[0, :8] for x in qpx]
        ate = pairing._ATE_BITS
        return [("128 rows", lambda: cuda_tower.miller_loop(*qpx, ate),
                 lambda: pairing.miller_loop_plain(*qpx)),
                ("8 rows", lambda: cuda_tower.miller_loop(*few, ate),
                 lambda: pairing.miller_loop_plain(*few))]
    if kernel == "scalar_mul":
        _, limbs, _ = cs._twins_inputs(64, set(), cs.TWINS_SEED)
        t = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
             for k, v in limbs.items()}
        r_bits = curve.subgroup_check_bits()
        return [(f"{g.upper()} r bits, 64 rows",
                 lambda x=x, y=y, F=F: cuda_tower.scalar_mul(
                     t[x], t[y], r_bits, g2=F is curve.FQ2_OPS),
                 lambda x=x, y=y, F=F: cs._limbs_of(
                     curve.scalar_mul_fixed_plain(F, t[x], t[y], r_bits)))
                for g, x, y, F in (("g1", "px1", "py1", curve.FQ_OPS),
                                   ("g2", "qx2", "qy2", curve.FQ2_OPS))]
    pts = np.zeros((512, 3, fq.NUM_LIMBS), dtype=np.uint64)
    for i in range(512):
        k = int(rng.integers(1, 1 << 62))
        x, y = O.ec_to_affine(O.ec_mul(O.G1_GEN, k))
        pts[i] = [fq.to_mont_int(x.n), fq.to_mont_int(y.n), fq.to_mont_int(1)]
    pts = fq.limbs_from_numpy(pts, dev)
    return [("512 points", lambda: cuda_tower.g1_fold(pts),
             lambda: mesh_reduce._local_fold_plain(pts))]


def _tower(cs, torch, dev, rng, libs, kernel):
    from consensus_specs_tpu_torch.ops import cuda_tower

    libs = {name: cuda_tower.bind(kernel, lib) for name, lib in libs.items()}

    def through(lib, call):
        cuda_tower._LIBS[kernel] = lib  # the wrapper launches this build
        return call()

    for label, call, plain in _tower_cases(cs, torch, dev, rng, kernel):
        want = plain()
        outs = {name: cs._limbs_of(through(lib, call))
                for name, lib in libs.items()}
        torch.cuda.synchronize()
        err = {name: int((out - want).abs().max().item())
               for name, out in outs.items()}
        ms = _in_turns(cs, torch, {
            name: (lambda lib=lib: through(lib, call))
            for name, lib in libs.items()}, 3)
        print(json.dumps({"kernel": kernel, "shape": label,
                          "max_abs_err_vs_plain": err, "ms": ms}),
              flush=True)


WORKLOADS = {"vm_step": _vm_step, "mont_mul": _mont_mul,
             "pow_chain": _pow_chain,
             **{k: (lambda cs, torch, dev, rng, libs, k=k:
                    _tower(cs, torch, dev, rng, libs, k))
                for k in ("fq12_ladder", "fq12_fold", "miller_loop",
                          "g1_fold", "scalar_mul")}}


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
