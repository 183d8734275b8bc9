#!/usr/bin/env python3
"""Time the port's plain Montgomery product, ``fq.mont_mul_plain``, at a
range of batch sizes.

    python3 tools/torch_plain_mul_time.py [--device cpu|cuda]
        [--root DIR ...] [--sizes N,N,...]

Each ``--root`` is a checkout of the repository (default: this one; an
earlier commit unpacked into a gitignored directory times that commit's
version). Every root's module runs the same random loose inputs, held
limb for limb against the first root's, and is timed in turns, first to
last and back, the best of each. On the CPU one intra-op thread is used,
as the tests use. Prints the host's CPU or the card's name and power
limit, then one JSON line a size: products, ms of each root.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 96, 288, 768, 1536, 6144, 65536)


def _load(root):
    """fq of the checkout at ``root``, imported apart from any other's."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "consensus_specs_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        return importlib.import_module("consensus_specs_tpu_torch.ops.fq")
    finally:
        sys.path.remove(root)


def _timer(torch, device):
    def ms(fn, reps):
        fn()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    return ms


def _where(torch, device):
    if device == "cuda":
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        return out.stdout.strip()
    with open("/proc/cpuinfo") as f:
        model = next((ln.split(":", 1)[1].strip() for ln in f
                      if ln.startswith("model name")), "cpu")
    return f"{model}, {torch.get_num_threads()} thread"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    args = ap.parse_args(argv)
    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    mods = [_load(r) for r in roots]
    ms = _timer(torch, args.device)
    print(_where(torch, args.device), flush=True)
    rng = np.random.default_rng(20261018)
    for n in (int(x) for x in args.sizes.split(",")):
        a, b = (torch.from_numpy(rng.integers(0, 1 << 28, (n, 15))
                                 .astype(np.int64)).to(args.device)
                for _ in range(2))
        want = mods[0].mont_mul_plain(a, b)
        for fq in mods[1:]:
            if not torch.equal(fq.mont_mul_plain(a, b), want):
                raise SystemExit(f"{n} products: the roots' limbs differ")
        reps = max(3, min(200, 20000 // n))
        best = [float("inf")] * len(mods)
        for order in (range(len(mods)), reversed(range(len(mods)))):
            for i in order:
                best[i] = min(best[i], ms(
                    lambda f=mods[i].mont_mul_plain: f(a, b), reps))
        print(json.dumps({"products": n, "ms": dict(zip(roots, best))}),
              flush=True)


if __name__ == "__main__":
    main()
